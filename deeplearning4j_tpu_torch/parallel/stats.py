"""Per-phase distributed-training stats + profiler hooks (the port of
`deeplearning4j_tpu/parallel/stats.py`).

Parity with the reference's Spark timing instrumentation:
`dl4j-spark/.../api/stats/SparkTrainingStats.java` (keyed phase timings),
`impl/paramavg/stats/ParameterAveragingTrainingMasterStats.java` (broadcast /
fit / aggregate phases as EventStats) and `stats/StatsUtils.java` (HTML
timeline export). The phases are: host data prep, device step
(compute and collectives), and parameter averaging — plus a
`torch.profiler` trace hook for the kernel-level view (the role
NTP-aligned EventStats played across Spark executors is covered by the
profiler's own timeline).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

__all__ = ["TrainingStats", "profiler_trace"]


class _Event:
    __slots__ = ("key", "start", "duration_ms", "epoch_ms")

    def __init__(self, key: str, start: float, duration_ms: float,
                 epoch_ms: Optional[int] = None):
        self.key = key
        self.start = start
        self.duration_ms = duration_ms
        # offset-corrected wall-clock stamp (cross-host comparable when a
        # CoordinatorTimeSource is attached — NTPTimeSource role)
        self.epoch_ms = epoch_ms


class TrainingStats:
    """Keyed phase timings (`SparkTrainingStats` analog). Phases are timed
    with `with stats.time("step"):` blocks; values are wall-clock ms.
    NOTE: timing a phase that only *dispatches* async device work measures
    dispatch unless the caller synchronizes — ParallelTrainer's
    collect_stats mode blocks on the score each step for honest numbers.

    `time_source` (parallel/timesource.py — the reference's
    `NTPTimeSource`/`TimeSourceProvider` tier) stamps every event with an
    offset-corrected epoch time so multi-host phase stats merge onto one
    timeline; default = local system clock."""

    def __init__(self, time_source=None):
        if time_source is None:
            # env-selected provider (TimeSourceProvider role):
            # DL4J_TPU_TIMESOURCE=coordinator gives corrected stamps
            from .timesource import get_time_source
            time_source = get_time_source()
        self.time_source = time_source
        self._events: List[_Event] = []
        self._t0 = time.time()

    @contextlib.contextmanager
    def time(self, key: str):
        start = time.time()
        stamp = self.time_source.current_time_millis()
        try:
            yield
        finally:
            self._events.append(
                _Event(key, start - self._t0, (time.time() - start) * 1e3,
                       stamp))

    def add(self, key: str, duration_ms: float):
        # stamp the phase START (matching time()): recording time minus
        # duration, so merged timelines are not skewed by event length
        self._events.append(
            _Event(key, time.time() - self._t0, float(duration_ms),
                   int(self.time_source.current_time_millis()
                       - duration_ms)))

    def events(self) -> List[Dict]:
        """Cross-host mergeable event records (EventStats analog)."""
        return [{"key": e.key, "epoch_ms": e.epoch_ms,
                 "duration_ms": e.duration_ms} for e in self._events]

    def reset(self):
        """Drop recorded events (fresh measurement window)."""
        self._events = []
        self._t0 = time.time()

    def totals(self) -> Dict[str, float]:
        """{phase: total seconds} over the recorded window."""
        out: Dict[str, float] = {}
        for e in self._events:
            out[e.key] = out.get(e.key, 0.0) + e.duration_ms / 1e3
        return out

    # -- SparkTrainingStats surface --------------------------------------
    def get_keys(self) -> List[str]:
        seen = []
        for e in self._events:
            if e.key not in seen:
                seen.append(e.key)
        return seen

    def get_values_for_key(self, key: str) -> List[float]:
        return [e.duration_ms for e in self._events if e.key == key]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for key in self.get_keys():
            vs = self.get_values_for_key(key)
            out[key] = {"count": len(vs), "total_ms": sum(vs),
                        "mean_ms": sum(vs) / len(vs),
                        "max_ms": max(vs)}
        return out

    def as_json(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def export_html(self, path: str):
        """Single-file timeline (`StatsUtils.exportStatsAsHtml` analog)."""
        keys = self.get_keys()
        colors = ["#c33", "#36c", "#393", "#939", "#c93", "#399"]
        rows = []
        span = max((e.start + e.duration_ms / 1e3 for e in self._events),
                   default=1.0) or 1.0
        for e in self._events:
            lane = keys.index(e.key)
            left = 100.0 * e.start / span
            width = max(0.2, 100.0 * (e.duration_ms / 1e3) / span)
            rows.append(
                f'<div class="ev" style="top:{28 * lane + 40}px;'
                f'left:{left:.2f}%;width:{width:.2f}%;background:'
                f'{colors[lane % len(colors)]}" title="{e.key} '
                f'{e.duration_ms:.2f} ms"></div>')
        labels = "".join(
            f'<div style="position:absolute;top:{28 * i + 40}px;left:4px;'
            f'font-size:11px">{k}</div>' for i, k in enumerate(keys))
        html = ("<!DOCTYPE html><html><head><style>"
                ".ev{position:absolute;height:20px;opacity:.85;"
                "border-radius:2px}</style></head><body>"
                "<h3>Training phase timeline</h3>"
                f'<div style="position:relative;height:{28 * len(keys) + 60}px;'
                'border:1px solid #ccc;margin-left:120px">'
                + "".join(rows) + "</div>"
                + f'<div style="position:absolute;top:0;left:0">{labels}</div>'
                + f"<pre>{self.as_json()}</pre></body></html>")
        with open(path, "w") as f:
            f.write(html)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """`torch.profiler` trace context: host and device activities (CUDA
    where there is a GPU) for the block, written to `log_dir` as a Chrome
    trace (`trace.json`, TensorBoard's `trace_viewer` reads it). Yields the
    profiler, whose `key_averages()` the caller may read."""
    import os

    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
