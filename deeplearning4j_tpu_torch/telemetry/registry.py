"""Thread-safe metrics registry with Prometheus-text and JSONL exporters:
the port's copy of `deeplearning4j_tpu/telemetry/registry.py`.

Zero dependencies (stdlib only) so it can run in any process — bench
subprocesses, the UI server, multi-host workers. Metric families follow
Prometheus conventions: a family has a name, help text, a fixed label-name
tuple, and one value series per label-value combination.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram", "Timer"]

# Prometheus default-ish latency buckets (seconds), extended down to 50us
# because the steps of small models land there.
DEFAULT_BUCKETS = (5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                   2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"          # Prometheus text-format literals: a diverged
    if math.isinf(f):         # run's NaN score must export, not crash
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(names: Sequence[str], values: Tuple[str, ...],
               extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base family: values keyed by a label-value tuple."""

    TYPE = "untyped"

    def __init__(self, name: str, help_: str, labels: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = lock
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def values(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)

    def _render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            yield (f"{self.name}"
                   f"{_label_str(self.label_names, key)} {_fmt_value(v)}")

    def _snapshot(self):
        with self._lock:
            return {",".join(k) or "": v for k, v in self._values.items()}


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, n: float = 1, **labels):
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, v: float, **labels):
        with self._lock:
            self._values[self._key(labels)] = float(v)

    def set_max(self, v: float, **labels):
        """Watermark helper: keep the running maximum."""
        key = self._key(labels)
        with self._lock:
            cur = self._values.get(key)
            if cur is None or v > cur:
                self._values[key] = float(v)

    def inc(self, n: float = 1, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_, labels, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labels, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._bucket_counts: Dict[Tuple[str, ...], list] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._counts: Dict[Tuple[str, ...], int] = {}

    def observe(self, v: float, **labels):
        v = float(v)
        key = self._key(labels)
        with self._lock:
            counts = self._bucket_counts.get(key)
            if counts is None:
                counts = self._bucket_counts[key] = [0] * len(self.buckets)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            self._counts[key] = self._counts.get(key, 0) + 1

    def time(self, **labels):
        """Context manager observing the elapsed wall time in seconds."""
        return _TimerCtx(self, labels)

    def count(self, **labels) -> int:
        with self._lock:
            return self._counts.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def sums(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._sums)

    def _render(self):
        with self._lock:
            keys = sorted(self._counts)
            rows = []
            for key in keys:
                counts = self._bucket_counts[key]
                for b, c in zip(self.buckets, counts):
                    le = 'le="%g"' % b
                    rows.append(f"{self.name}_bucket"
                                f"{_label_str(self.label_names, key, le)}"
                                f" {c}")
                le_inf = 'le="+Inf"'
                rows.append(f"{self.name}_bucket"
                            f"{_label_str(self.label_names, key, le_inf)}"
                            f" {self._counts[key]}")
                rows.append(f"{self.name}_sum"
                            f"{_label_str(self.label_names, key)}"
                            f" {_fmt_value(self._sums[key])}")
                rows.append(f"{self.name}_count"
                            f"{_label_str(self.label_names, key)}"
                            f" {self._counts[key]}")
        return rows

    def _snapshot(self):
        with self._lock:
            return {",".join(k) or "": {
                "count": self._counts[k],
                "sum": self._sums[k],
                "buckets": {f"{b:g}": c for b, c in
                            zip(self.buckets, self._bucket_counts[k])},
            } for k in sorted(self._counts)}


class _TimerCtx:
    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist, labels):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0, **self._labels)
        return False


class Timer(Histogram):
    """A histogram of wall-clock seconds with a `.time()` context manager —
    registered as its own family type for discoverability; exported as a
    Prometheus histogram."""
    TYPE = "histogram"


class MetricsRegistry:
    """Get-or-create metric families; all mutation under one re-entrant
    lock (listener threads, prefetch threads and exporters may race)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) and not (
                        isinstance(m, Histogram) and issubclass(cls, Histogram)):
                    raise ValueError(
                        f"metric '{name}' already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
                if tuple(labels) != m.label_names:
                    raise ValueError(
                        f"metric '{name}' already registered with labels "
                        f"{m.label_names}, requested {tuple(labels)}")
                return m
            m = cls(name, help_, labels, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets)

    def timer(self, name: str, help_: str = "",
              labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Timer:
        return self._get_or_create(Timer, name, help_, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def families(self):
        with self._lock:
            return list(self._metrics.values())

    # -- exporters ------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (text/plain; version=0.0.4)."""
        out = []
        for m in sorted(self.families(), key=lambda m: m.name):
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.TYPE}")
            out.extend(m._render())
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-able {name: {type, help, values}}."""
        return {m.name: {"type": m.TYPE, "help": m.help,
                         "labels": list(m.label_names),
                         "values": m._snapshot()}
                for m in self.families()}

    def export_jsonl(self, path, extra: Optional[Dict] = None):
        """Append one JSON line (timestamped snapshot) — the tail-able
        flight-recorder format; one line per report window."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a", encoding="utf-8", newline="\n") as f:
            f.write(json.dumps(rec) + "\n")
