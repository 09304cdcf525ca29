"""Per-request trace propagation and the SLO surface (the port of
`deeplearning4j_tpu/telemetry/trace_context.py`; host code only).

`TraceContext` is the Dapper-style correlation object created once per
HTTP request in `serving/server.py` and carried on `_Pending` through
the DynamicBatcher and on `_Seq` through the decode scheduler/engine.
Every hop emits a child span into the ACTIVE session's bounded `Tracer`
(looked up lazily, so a context outlives enable/disable churn) with
`trace_id` / `span_id` / `parent_id` in its args — one request renders
as one connected track in Perfetto, and the parent-child links are what
the acceptance test walks.

Costs when tracing is off: a context is still created (the
`X-DL4J-Trace` header must always exist for client-side correlation)
but emission is one module-global read + an early return. The serving
hot paths take `ctx=None` and skip even that.

`SloSurface` is the declared-target half: per-tier latency histograms
(`dl4j_slo_latency_seconds{tier}`), breach counters and a burn-rate
gauge (`dl4j_slo_burn_rate{tier}` = breach_fraction / error_budget — a
value >= 1.0 means the tier is consuming its error budget faster than
it accrues). Tiers arrive on the `X-DL4J-SLO-Tier` request header;
undeclared tiers still get latency histograms but no burn accounting
(there is no target to breach).
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

from . import runtime

__all__ = ["TraceContext", "SloSurface", "DEFAULT_SLO_TARGETS",
           "DEFAULT_TIER"]

DEFAULT_TIER = "standard"

# declared targets: seconds of end-to-end request latency per tier
DEFAULT_SLO_TARGETS = {
    "interactive": 0.25,
    "standard": 2.0,
    "batch": 30.0,
}


def _active_tracer():
    sess = runtime.active()
    return sess.tracer if sess is not None else None


class _CtxSpan:
    """Context manager emitting one child span of a TraceContext."""

    __slots__ = ("_ctx", "_name", "_args", "_parent", "_t0", "span_id")

    def __init__(self, ctx, name, parent, args):
        self._ctx = ctx
        self._name = name
        self._parent = parent
        self._args = args
        self.span_id = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.span_id = self._ctx.emit(
            self._name, self._t0, time.perf_counter(),
            parent=self._parent, **(self._args or {}))
        return False


class TraceContext:
    """One request's correlation ids + SLO tier.

    The ROOT span (span_id `<trace_id>.0`) is allocated eagerly so child
    spans emitted mid-flight can reference it before the root itself is
    emitted (the HTTP layer emits the root in `_reply`, after the
    request's work but before the response bytes leave the socket)."""

    __slots__ = ("trace_id", "span_id", "tier", "t_start", "_ids")

    def __init__(self, trace_id: Optional[str] = None, *,
                 tier: str = DEFAULT_TIER):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.tier = tier or DEFAULT_TIER
        self.t_start = time.perf_counter()
        # next(count) is GIL-atomic: span ids stay unique when the HTTP
        # thread, the batcher worker and the decode worker all emit
        self._ids = itertools.count(1)
        self.span_id = f"{self.trace_id}.0"

    @classmethod
    def begin(cls, tier: str = DEFAULT_TIER,
              trace_id: Optional[str] = None) -> "TraceContext":
        return cls(trace_id, tier=tier)

    # -- emission --------------------------------------------------------
    def emit(self, name: str, t_start: float, t_end: float, *,
             parent: Optional[str] = None, **args) -> str:
        """Emit a complete child span with explicit timestamps (the
        queue-wait idiom: the enqueue time was captured on another
        thread). Returns the new span id; `parent` defaults to the root
        span."""
        sid = f"{self.trace_id}.{next(self._ids)}"
        tr = _active_tracer()
        if tr is not None:
            a = dict(args)
            a["trace_id"] = self.trace_id
            a["span_id"] = sid
            a["parent_id"] = self.span_id if parent is None else parent
            tr._complete(name, t_start, t_end, a)
        return sid

    def span(self, name: str, *, parent: Optional[str] = None,
             **args) -> _CtxSpan:
        """Context manager emitting a child span around the block."""
        return _CtxSpan(self, name, parent, args or None)

    def emit_root(self, name: str, **args):
        """Emit the root span covering the whole request (t_start ->
        now). Its parent_id is None — the trace's anchor."""
        tr = _active_tracer()
        if tr is None:
            return
        a = dict(args)
        a["trace_id"] = self.trace_id
        a["span_id"] = self.span_id
        a["parent_id"] = None
        a["tier"] = self.tier
        tr._complete(name, self.t_start, time.perf_counter(), a)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start


class SloSurface:
    """Declared latency targets -> Prometheus SLO families.

    observe() is called once per request from the HTTP reply path:
    histogram observation always; breach/burn accounting only for
    declared tiers. Burn rate = (breached / total) / error_budget, the
    multi-window-free instantaneous form — 1.0 means breaches exactly
    consume the budget, >1.0 means the SLO is burning down."""

    def __init__(self, registry, targets: Optional[Dict[str, float]] = None,
                 error_budget: float = 0.01):
        self.targets = dict(DEFAULT_SLO_TARGETS if targets is None
                            else targets)
        self.error_budget = max(1e-9, float(error_budget))
        self._lock = threading.Lock()
        self._counts: Dict[str, Tuple[int, int]] = {}  # tier->(total, bad)
        self._latency = registry.histogram(
            "dl4j_slo_latency_seconds",
            "end-to-end request latency by declared SLO tier",
            labels=("tier",))
        self._breaches = registry.counter(
            "dl4j_slo_breaches_total",
            "requests that exceeded their tier's declared latency target",
            labels=("tier",))
        self._burn = registry.gauge(
            "dl4j_slo_burn_rate",
            "breach fraction / error budget per tier (>=1 burns budget)",
            labels=("tier",))

    def declare(self, tier: str, target_seconds: float):
        self.targets[str(tier)] = float(target_seconds)

    def observe(self, tier: str, seconds: float):
        tier = tier or DEFAULT_TIER
        self._latency.observe(seconds, tier=tier)
        target = self.targets.get(tier)
        if target is None:
            return
        breach = seconds > target
        with self._lock:
            total, bad = self._counts.get(tier, (0, 0))
            total += 1
            if breach:
                bad += 1
            self._counts[tier] = (total, bad)
        if breach:
            self._breaches.inc(tier=tier)
        self._burn.set((bad / total) / self.error_budget, tier=tier)

    def burn_rate(self, tier: str) -> float:
        with self._lock:
            total, bad = self._counts.get(tier, (0, 0))
        if total == 0:
            return 0.0
        return (bad / total) / self.error_budget

    def summary(self) -> Dict:
        with self._lock:
            counts = dict(self._counts)
        return {tier: {"target_s": self.targets.get(tier),
                       "requests": total, "breaches": bad,
                       "burn_rate": round((bad / total) / self.error_budget,
                                          4) if total else 0.0}
                for tier, (total, bad) in sorted(counts.items())}
