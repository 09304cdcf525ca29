"""Fault-subsystem telemetry: thin helpers over the telemetry registry
(the port of `deeplearning4j_tpu/fault/metrics.py`).

All helpers are no-ops (one global read) when no telemetry session is
active, matching the hot-path contract in telemetry/runtime.py.

Families:
  dl4j_fault_nonfinite_steps_total{policy}   non-finite loss steps seen
  dl4j_fault_retries_total{kind}             transient-error retries
  dl4j_fault_rollbacks_total{policy}         guard restores (skip/rollback)
  dl4j_checkpoint_save_seconds{kind}         save wall time (zip|sharded)
  dl4j_checkpoint_restore_seconds{kind}      restore wall time
  dl4j_elastic_worker_losses_total           stale-lease worker losses seen
  dl4j_elastic_rejoins_total                 workers (re)joining the fleet
  dl4j_elastic_resizes_total                 mesh re-formations (loss/join)
  dl4j_elastic_drains_total                  cross-process SIGTERM drains
  dl4j_elastic_snapshot_seconds              coordinated snapshot wall time
"""
from __future__ import annotations

import contextlib

from ..telemetry.runtime import active as _tel_active

__all__ = ["count_nonfinite", "count_retry", "count_rollback",
           "checkpoint_timer", "count_elastic", "elastic_snapshot_timer"]

#: the elastic event vocabulary (the elastic trainer's supervision loop)
ELASTIC_EVENTS = ("worker_losses", "rejoins", "resizes", "drains")

_ELASTIC_HELP = {
    "worker_losses": "workers declared lost (stale heartbeat lease)",
    "rejoins": "workers that (re)joined the fleet",
    "resizes": "elastic mesh re-formations after worker loss/join",
    "drains": "cross-process SIGTERM-window drains",
}


def count_nonfinite(policy: str, n: int = 1):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_fault_nonfinite_steps_total",
            "training steps whose loss was NaN/Inf",
            labels=("policy",)).inc(n, policy=policy)


def count_retry(kind: str = "iterator"):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_fault_retries_total",
            "transient-error retries (bounded exponential backoff)",
            labels=("kind",)).inc(kind=kind)


def count_rollback(policy: str):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_fault_rollbacks_total",
            "guard-initiated state restores",
            labels=("policy",)).inc(policy=policy)


def checkpoint_timer(op: str, kind: str):
    """Context manager timing a checkpoint `op` ("save"|"restore") of
    `kind` ("zip"|"sharded") into the active registry; null when
    telemetry is disabled."""
    tel = _tel_active()
    if tel is None:
        return contextlib.nullcontext()
    return tel.registry.timer(
        f"dl4j_checkpoint_{op}_seconds",
        f"checkpoint {op} wall seconds", labels=("kind",)).time(kind=kind)


def count_elastic(event: str, n: int = 1):
    """Count an elastic supervision event; `event` is one of
    ELASTIC_EVENTS (each its own label-less counter family,
    ``dl4j_elastic_<event>_total``)."""
    if event not in _ELASTIC_HELP:
        raise ValueError(
            f"unknown elastic event {event!r}; one of {ELASTIC_EVENTS}")
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            f"dl4j_elastic_{event}_total", _ELASTIC_HELP[event]).inc(n)


def elastic_snapshot_timer():
    """Context manager timing one coordinated (two-phase-commit) snapshot
    into ``dl4j_elastic_snapshot_seconds``; null when telemetry is
    disabled."""
    tel = _tel_active()
    if tel is None:
        return contextlib.nullcontext()
    return tel.registry.timer(
        "dl4j_elastic_snapshot_seconds",
        "coordinated elastic snapshot wall seconds").time()
