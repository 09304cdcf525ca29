"""Continual-plane telemetry: thin helpers over the telemetry registry (the
port of `deeplearning4j_tpu/continual/metrics.py`; `telemetry/runtime.py`
`continual_summary` reads these families).

All helpers are no-ops (one global read) when no telemetry session is
active, matching the hot-path contract in telemetry/runtime.py (and the
fault/metrics.py idiom).

Families:
  dl4j_continual_windows_total{result}     fresh windows by outcome
                                           (trained|skipped)
  dl4j_continual_gate_total{result}        held-out gate runs (pass|fail)
  dl4j_continual_rollbacks_total{reason}   candidates discarded, by why
                                           (gate_fail, errors, slo_breach,
                                           latency, score_drift, timeout,
                                           compile_failed, crash_recovery,
                                           empty_window)
  dl4j_continual_promotions_total          candidates promoted to stable
  dl4j_continual_promotion_latency_seconds window consumed -> promoted
  dl4j_continual_canary_requests_total{model,arm}
                                           lives in serving/registry.py —
                                           both server arms feed it via
                                           observe_canary()
"""
from __future__ import annotations

from ..telemetry.runtime import active as _tel_active

__all__ = ["count_window", "count_gate", "count_rollback",
           "count_promotion", "observe_promotion_latency"]


def count_window(result: str, n: int = 1):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_continual_windows_total",
            "fresh training windows consumed, by outcome",
            labels=("result",)).inc(n, result=result)


def count_gate(result: str):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_continual_gate_total",
            "held-out eval gate runs on fine-tuned candidates",
            labels=("result",)).inc(result=result)


def count_rollback(reason: str):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_continual_rollbacks_total",
            "candidates discarded instead of promoted, by reason",
            labels=("reason",)).inc(reason=reason)


def count_promotion():
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_continual_promotions_total",
            "candidates promoted to the stable servable").inc()


def observe_promotion_latency(seconds: float):
    tel = _tel_active()
    if tel is not None:
        tel.registry.histogram(
            "dl4j_continual_promotion_latency_seconds",
            "window consumed -> candidate promoted wall seconds"
        ).observe(seconds)
