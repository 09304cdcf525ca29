"""Fault-subsystem telemetry: thin helpers over the telemetry registry
(the port of `deeplearning4j_tpu/fault/metrics.py`; its elastic counters
come with the parallel stack, ROADMAP A11).

All helpers are no-ops (one global read) when no telemetry session is
active, matching the hot-path contract in telemetry/runtime.py.

Families:
  dl4j_fault_nonfinite_steps_total{policy}   non-finite loss steps seen
  dl4j_fault_retries_total{kind}             transient-error retries
  dl4j_fault_rollbacks_total{policy}         guard restores (skip/rollback)
  dl4j_checkpoint_save_seconds{kind}         save wall time (zip)
  dl4j_checkpoint_restore_seconds{kind}      restore wall time
"""
from __future__ import annotations

import contextlib

from ..telemetry.runtime import active as _tel_active

__all__ = ["count_nonfinite", "count_retry", "count_rollback",
           "checkpoint_timer"]


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
    `kind` ("zip") into the active registry; null when telemetry is
    disabled."""
    tel = _tel_active()
    if tel is None:
        return contextlib.nullcontext()
    return tel.registry.timer(
        f"dl4j_checkpoint_{op}_seconds",
        f"checkpoint {op} wall seconds", labels=("kind",)).time(kind=kind)
