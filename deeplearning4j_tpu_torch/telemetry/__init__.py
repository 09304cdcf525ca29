"""Runtime observability of the port: metrics registry, step tracing,
capture watching, resource watermarks, request tracing (the port of
`deeplearning4j_tpu/telemetry/`).

  * `MetricsRegistry` (registry.py): thread-safe counters / gauges /
    histograms / timers with Prometheus-text and JSONL exporters.
  * `Tracer` (tracing.py): spans in Chrome trace-event JSON, loadable in
    Perfetto / chrome://tracing.
  * `CompileWatcher` (compile_watch.py): counts the CUDA-graph captures
    (the port's compiles) per entry point and batch signature and warns on
    a storm of them.
  * `ResourceWatermarks` (resources.py): host RSS and the card's
    allocated bytes, current and peak.
  * `FlightRecorder` (recorder.py): an always-on ring of structured
    events that `fault/guard.py` dumps when it trips.
  * `TraceContext` / `SloSurface` (trace_context.py): one request's
    correlation ids and spans through the serving planes, and the
    per-tier latency targets with their burn rates.
  * `obs_bench.py`: the tracing and recorder overhead, in paired windows.

`TelemetrySession` (runtime.py) bundles them; `telemetry.enable()` installs
the process-wide session the instrumented hot paths consult.
`TelemetryListener` (listener.py) wires per-iteration metrics into the
listener chain.
"""
from .compile_watch import (CompileWatcher, RecompilationStormWarning,
                            watch_compiles)
from .listener import TelemetryListener
from .recorder import FlightRecorder, flight_recorder, install
from .registry import (Counter, Gauge, Histogram, MetricsRegistry, Timer)
from .resources import ResourceWatermarks
from .runtime import (TelemetrySession, active, disable, enable, enabled,
                      null_span)
from .trace_context import (DEFAULT_SLO_TARGETS, DEFAULT_TIER, SloSurface,
                            TraceContext)
from .tracing import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "Timer", "MetricsRegistry",
    "Tracer", "CompileWatcher", "watch_compiles",
    "RecompilationStormWarning", "ResourceWatermarks",
    "TelemetrySession", "TelemetryListener",
    "FlightRecorder", "flight_recorder", "install",
    "active", "enable", "disable", "enabled", "null_span",
    "TraceContext", "SloSurface", "DEFAULT_SLO_TARGETS", "DEFAULT_TIER",
]
