"""Process-wide telemetry session + the hot-path hooks the models consult:
the port of `deeplearning4j_tpu/telemetry/runtime.py`.

The instrumented paths (`MultiLayerNetwork._fit_batch`,
`ComputationGraph._fit_batch`, the window loop of `nn/superstep.py`,
`fit_scan_arrays`) each do:

    tel = runtime.active()
    span = tel.span if tel is not None else runtime.null_span
    with span("host/batch_prep"): ...

so a disabled session costs one module-global read and a shared no-op
context manager per step — cheap enough to leave compiled in everywhere.

`TelemetrySession.span` records BOTH a Chrome trace event and an
aggregate `dl4j_span_seconds{span=...}` histogram observation: the trace
answers "what happened around step 4017", the registry answers "where did
the epoch's wall time go" even after the trace buffer wraps.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from .compile_watch import CompileWatcher
from .registry import MetricsRegistry
from .resources import ResourceWatermarks
from .tracing import Tracer

__all__ = ["TelemetrySession", "active", "enable", "disable", "enabled",
           "null_span"]


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def null_span(name=None, **args) -> _NullCtx:
    """Shared no-op span (telemetry disabled)."""
    return _NULL


class _TimedSpan:
    __slots__ = ("_sess", "_name", "_args", "_t0")

    def __init__(self, sess, name, args):
        self._sess = sess
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        s = self._sess
        s.tracer._complete(self._name, self._t0, t1, self._args)
        s.span_seconds.observe(t1 - self._t0, span=self._name)
        return False


class TelemetrySession:
    """Bundles the four telemetry pieces behind one object.

    sync_per_step: when True the instrumented paths synchronise the card
    after each step so the "device/sync" span attributes device time per
    iteration (one extra host sync per step). On a window of replayed CUDA
    graphs the sync goes between replays, never inside a capture. When
    False (default) the host runs ahead and device time accumulates in
    whichever call naturally blocks (the window's score copy, listener
    score reads).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 sync_per_step: bool = False,
                 storm_threshold: int = 3,
                 report_window: int = 10):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self.compiles = CompileWatcher(self.registry, self.tracer,
                                       storm_threshold=storm_threshold)
        self.watermarks = ResourceWatermarks(self.registry)
        self.sync_per_step = bool(sync_per_step)
        self.report_window = max(1, int(report_window))
        self.span_seconds = self.registry.timer(
            "dl4j_span_seconds", "wall seconds per runtime span",
            labels=("span",))

    def span(self, name: str, **args) -> _TimedSpan:
        return _TimedSpan(self, name, args or None)

    # -- artifacts ------------------------------------------------------
    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    def export_prometheus(self, path) -> str:
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            f.write(self.registry.prometheus_text())
        return str(path)

    def export_chrome_trace(self, path) -> str:
        return self.tracer.export_chrome_trace(path)

    def export_jsonl(self, path, extra=None):
        self.registry.export_jsonl(path, extra=extra)

    def span_totals(self) -> Dict[str, float]:
        """{span name: total wall seconds} from the aggregate histogram."""
        return {k[0]: v for k, v in self.span_seconds.sums().items()}

    def pipeline_summary(self) -> Dict:
        """Input-pipeline metrics (datasets/pipeline.py): pad_fraction
        (weight-zero padding rows / all rows), prefetch wait (consumer
        stall on the device-prefetch queue — ~0 means transfer fully
        overlapped compute), time-bucket hit counts. Empty dict when no
        pipeline stage ran under this session."""
        out: Dict = {}
        rows = self.registry.get("dl4j_pipeline_rows_total")
        if rows is not None:
            real = rows.value(kind="real")
            pad = rows.value(kind="pad")
            if real + pad:
                out["rows"] = int(real + pad)
                out["pad_fraction"] = round(pad / (real + pad), 4)
        wait = self.registry.get("dl4j_pipeline_prefetch_wait_seconds")
        if wait is not None and wait.count():
            out["prefetch_waits"] = wait.count()
            out["prefetch_wait_s"] = round(wait.sum(), 4)
        buckets = self.registry.get("dl4j_pipeline_bucket_hits_total")
        if buckets is not None and buckets.values():
            out["bucket_hits"] = {k[0]: int(v)
                                  for k, v in sorted(buckets.values().items())}
        return out

    def dp_summary(self) -> Dict:
        """Data-parallel collective-traffic metrics (filled by the parallel
        stack, ROADMAP A11). Empty dict when none ran under this
        session."""
        out: Dict = {}
        c = self.registry.get("dl4j_collective_bytes_total")
        if c is not None and c.values():
            out["collective_bytes"] = {
                k[0]: int(v) for k, v in sorted(c.values().items())}
        f = self.registry.get("dl4j_dp_bucket_flushes_total")
        if f is not None:
            n = sum(f.values().values())
            if n:
                out["bucket_flushes"] = int(n)
        return out

    def fault_summary(self) -> Dict:
        """Fault-tolerance metrics (fault/): checkpoint save/restore
        counts + wall seconds per kind (zip), non-finite steps
        seen, data-source retries and guard rollbacks. Empty dict when no
        fault-path code ran under this session."""
        out: Dict = {}
        for op in ("save", "restore"):
            t = self.registry.get(f"dl4j_checkpoint_{op}_seconds")
            if t is not None and t.sums():
                out[f"checkpoint_{op}s"] = {
                    k[0]: t.count(kind=k[0]) for k in sorted(t.sums())}
                out[f"checkpoint_{op}_s"] = {
                    k[0]: round(v, 4) for k, v in sorted(t.sums().items())}
        for name, key in (
                ("dl4j_fault_nonfinite_steps_total", "nonfinite_steps"),
                ("dl4j_fault_retries_total", "retries"),
                ("dl4j_fault_rollbacks_total", "rollbacks")):
            c = self.registry.get(name)
            if c is not None and c.values():
                out[key] = int(sum(c.values().values()))
        return out

    def elastic_summary(self) -> Dict:
        """Elastic-training metrics (filled by the elastic loop, ROADMAP
        A11). Empty dict when none ran under this session."""
        out: Dict = {}
        for event in ("worker_losses", "rejoins", "resizes", "drains"):
            c = self.registry.get(f"dl4j_elastic_{event}_total")
            if c is not None and c.values():
                n = int(sum(c.values().values()))
                if n:
                    out[event] = n
        t = self.registry.get("dl4j_elastic_snapshot_seconds")
        if t is not None and t.count():
            out["snapshots"] = t.count()
            out["snapshot_s"] = round(t.sum(), 4)
        return out

    def continual_summary(self) -> Dict:
        """Continual train-to-serve metrics (filled by the continual
        plane, ROADMAP A10). Empty dict when none ran under this
        session."""
        out: Dict = {}
        for name, key in (("dl4j_continual_windows_total", "windows"),
                          ("dl4j_continual_gate_total", "gate"),
                          ("dl4j_continual_rollbacks_total", "rollbacks")):
            c = self.registry.get(name)
            if c is not None and c.values():
                out[key] = {k[0]: int(v)
                            for k, v in sorted(c.values().items())}
        c = self.registry.get("dl4j_continual_canary_requests_total")
        if c is not None and c.values():
            arms: Dict = {}
            for (model, arm), v in c.values().items():
                arms[arm] = arms.get(arm, 0) + int(v)
            out["canary_requests"] = dict(sorted(arms.items()))
        c = self.registry.get("dl4j_continual_promotions_total")
        if c is not None and c.values():
            out["promotions"] = int(sum(c.values().values()))
        t = self.registry.get("dl4j_continual_promotion_latency_seconds")
        if t is not None and t.count():
            out["promotion_latency_s"] = round(t.sum() / t.count(), 4)
        return out

    def summary(self) -> Dict:
        """The session in one compact dict."""
        rep = self.compiles.report()
        self.watermarks.sample()
        out = {
            "graph_captures": self.compiles.total(),
            "compiles": {k: v["count"] for k, v in rep.items()},
            "compile_wall_s": round(sum(v["wall_s"] for v in rep.values()),
                                    3),
            "span_seconds": {k: round(v, 4)
                             for k, v in sorted(self.span_totals().items())},
            "peak_rss_mb": round(self.watermarks.peak_rss_mb(), 1),
            "trace_events": len(self.tracer),
        }
        pipe = self.pipeline_summary()
        if pipe:
            out["pipeline"] = pipe
        dp = self.dp_summary()
        if dp:
            out["dp"] = dp
        fault = self.fault_summary()
        if fault:
            out["fault"] = fault
        elastic = self.elastic_summary()
        if elastic:
            out["elastic"] = elastic
        continual = self.continual_summary()
        if continual:
            out["continual"] = continual
        return out


_active: Optional[TelemetrySession] = None


def active() -> Optional[TelemetrySession]:
    return _active


def enable(session: Optional[TelemetrySession] = None, **kw
           ) -> TelemetrySession:
    """Install `session` (or a new one built from **kw) as the process-wide
    session. With no arguments and a session already active, this is
    idempotent and returns the active session."""
    global _active
    if session is None:
        if _active is not None and not kw:
            return _active
        session = TelemetrySession(**kw)
    _active = session
    return session


def disable() -> Optional[TelemetrySession]:
    """Deactivate and return the previous session (its artifacts remain
    exportable)."""
    global _active
    prev = _active
    _active = None
    return prev


@contextlib.contextmanager
def enabled(session: Optional[TelemetrySession] = None, **kw):
    """Scoped activation; restores the previous session on exit."""
    global _active
    prev = _active
    sess = session if session is not None else TelemetrySession(**kw)
    _active = sess
    try:
        yield sess
    finally:
        _active = prev
