"""Continual train-to-serve plane (the port of `deeplearning4j_tpu/continual/`):
close the loop between durable ingestion (`streaming/`), guarded resumable
fine-tuning (`fault/`) and atomic hot-swap serving (`serving/`).

The `ContinualTrainer` consumes a topic from the committed consumer-group
offset, fine-tunes the current servable on fresh windows under a
TrainingGuard on the registry's device, gates every candidate against a
held-out eval set, and only on a gate pass exposes the candidate to a
deterministic slice of live traffic as a canary whose per-arm metrics
(latency SLO breaches, error rate, score drift) drive promotion or
rollback. Every transition is an atomic journaled record
(`ContinualJournal`), so a crash at ANY boundary restarts into a consistent
state that never serves an ungated candidate.
"""
from .canary import CanaryPolicy
from .journal import ContinualJournal, JournalCorruptError
from .trainer import ContinualTrainer

__all__ = ["ContinualTrainer", "ContinualJournal", "JournalCorruptError",
           "CanaryPolicy"]
