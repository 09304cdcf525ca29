"""Promotion/rollback policy over live canary observations (the port's own
copy of `deeplearning4j_tpu/continual/canary.py`).

Pure decision logic — no registry or server imports, so the serving
plane can stay import-free of the continual plane. The inputs are the
`CanaryState.stats()` dict the registry maintains (per-arm requests,
errors, latency, SLO breaches) plus the gate-time score drift; the
output is a decision the ContinualTrainer journals BEFORE applying.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["CanaryPolicy"]


class CanaryPolicy:
    """Decide promote / rollback / keep-waiting from canary arm stats.

    min_requests:       canary-arm requests before any decision — one
                        early unlucky request must not decide a rollout.
    max_error_rate:     canary error rate above this rolls back
                        ("errors"). Default 0: any candidate-arm error is
                        disqualifying.
    max_breach_rate:    canary SLO-breach rate above this — AND above the
                        stable arm's concurrent breach rate (a global
                        slowdown hitting both arms is not the
                        candidate's fault) — rolls back ("slo_breach").
    max_latency_ratio:  canary mean latency above this multiple of the
                        stable arm's rolls back ("latency").
    max_score_drift:    gate-score regression (candidate minus stable,
                        lower is better) above this rolls back
                        ("score_drift"); None disables.

    decide() returns ("promote", None), ("rollback", reason), or None
    while the canary still needs traffic.
    """

    def __init__(self, min_requests: int = 20,
                 max_error_rate: float = 0.0,
                 max_breach_rate: float = 0.25,
                 max_latency_ratio: float = 3.0,
                 max_score_drift: Optional[float] = None):
        self.min_requests = max(1, int(min_requests))
        self.max_error_rate = float(max_error_rate)
        self.max_breach_rate = float(max_breach_rate)
        self.max_latency_ratio = float(max_latency_ratio)
        self.max_score_drift = (None if max_score_drift is None
                                else float(max_score_drift))

    def decide(self, stats: Dict, score_drift: Optional[float] = None
               ) -> Optional[Tuple[str, Optional[str]]]:
        if (self.max_score_drift is not None and score_drift is not None
                and score_drift > self.max_score_drift):
            return ("rollback", "score_drift")
        arms = stats.get("arms", {})
        c = arms.get("canary", {})
        s = arms.get("stable", {})
        c_req = int(c.get("requests", 0))
        if c_req < self.min_requests:
            return None
        if c.get("errors", 0) / c_req > self.max_error_rate:
            return ("rollback", "errors")
        breach_rate = c.get("breaches", 0) / c_req
        stable_breach = (s.get("breaches", 0) / s["requests"]
                         if s.get("requests") else 0.0)
        if breach_rate > self.max_breach_rate and breach_rate > stable_breach:
            return ("rollback", "slo_breach")
        if s.get("requests") and s.get("latency_mean", 0.0) > 0.0:
            ratio = c.get("latency_mean", 0.0) / s["latency_mean"]
            if ratio > self.max_latency_ratio:
                return ("rollback", "latency")
        return ("promote", None)
