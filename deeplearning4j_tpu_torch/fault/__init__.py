"""Fault tolerance of the port: crash-safe checkpoints, auto-resume,
training guards, and a deterministic fault-injection harness (the port of
`deeplearning4j_tpu/fault/`).

  * `atomic`    — temp-file + fsync + atomic-rename writes, sha256
                  manifests, directory COMMIT markers. Used by
                  `util/serializer.py`.
  * `resume`    — `CheckpointManager` (retained, verified zip checkpoints)
                  and `FitCheckpointer` (interval saves, resume
                  bookkeeping, SIGTERM snapshot) behind the
                  `checkpoint_dir= / checkpoint_every= / resume=` options
                  of `fit` on both model kinds. The zip is the JAX
                  package's: a checkpoint directory resumes in either.
  * `guard`     — `TrainingGuard`: isfinite check on every step's (or
                  window's) loss with warn/skip_batch/rollback/halt
                  policies, plus bounded-backoff retry for transient
                  iterator errors.
  * `injection` — `FaultyIterator` + `crash_at_write` crash points, plus
                  the process-level injectors (`kill_at_step`,
                  `hang_at_step`, `sigterm_at_step`,
                  `install_faults_from_env`).

Everything emits telemetry through the registry
(`dl4j_fault_nonfinite_steps_total`, `dl4j_fault_retries_total`,
`dl4j_fault_rollbacks_total`, `dl4j_checkpoint_{save,restore}_seconds`).
"""
from .atomic import (COMMIT_MARKER, CorruptCheckpointError, atomic_replace,
                     read_commit_marker, sha256_hex, write_commit_marker)
from .guard import GuardPolicy, NonFiniteScoreError, TrainingGuard
from .injection import (FaultyIterator, SimulatedCrash, clear_crash_hooks,
                        crash_at_write, hang_at_step,
                        install_faults_from_env, kill_at_step,
                        sigterm_at_step)
from .resume import (CheckpointManager, FitCheckpointer,
                     maybe_fit_checkpointer, sharded_fit_checkpointer)

__all__ = [
    "COMMIT_MARKER", "CorruptCheckpointError", "atomic_replace",
    "read_commit_marker", "sha256_hex", "write_commit_marker",
    "GuardPolicy", "NonFiniteScoreError", "TrainingGuard",
    "FaultyIterator", "SimulatedCrash", "crash_at_write",
    "kill_at_step", "hang_at_step", "sigterm_at_step",
    "install_faults_from_env", "clear_crash_hooks",
    "CheckpointManager", "FitCheckpointer", "maybe_fit_checkpointer",
    "sharded_fit_checkpointer",
]
