"""Capture watcher: count the "compiles" of each training entry point and
batch signature, record their wall time, warn on a storm. The port of
`deeplearning4j_tpu/telemetry/compile_watch.py`, under the same names.

What a compile is in the port. JAX traces and compiles a jitted function
once per argument signature. The port has no tracer; what costs the same
kind of one-off time per signature is the capture of a CUDA graph: a
window of `fit(superstep=K)` or `grad_accumulation=M` runs on the card as
replays of one captured optimizer step, and a new batch signature (shapes,
dtypes, which masks are present) means a new warm-up step and a new
capture. So a compile here is

  * on the card, one CUDA-graph capture of an entry point for one batch
    signature (`CompileWatcher.record_capture`, called by
    `nn/superstep.CapturedStep`, with the warm-up and capture's wall time);
  * for an eager entry point (the per-batch step, the CPU's window step),
    the first call with a batch signature it has not seen
    (`watch_compiles`): the call where the card would capture, so the
    counts, and a storm of ragged shapes, read the same on both devices;
  * for the serving registry, one runner built per (model, signature,
    bucket) and kept across same-architecture swaps (`record_aot`); the
    decode plane's CUDA graphs, one per (version, arena, bucket), are
    captures.

`watch_compiles(fn, name)` wraps a callable; with no active telemetry
session the wrapper is one global read and the call.
"""
from __future__ import annotations

import threading
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["CompileWatcher", "watch_compiles", "RecompilationStormWarning",
           "roster", "roster_names"]

# Every watch_compiles-registered entry point: name -> weak reference to
# the wrapped callable (a wrapped step dies with its model).
_ROSTER: Dict[str, "weakref.ref"] = {}
_ROSTER_LOCK = threading.Lock()


def roster() -> List[Tuple[str, Callable]]:
    """Live (name, callable) pairs currently registered, sorted by name.
    Entries whose callable was garbage-collected are pruned."""
    out = []
    with _ROSTER_LOCK:
        dead = []
        for name, ref in _ROSTER.items():
            fn = ref()
            if fn is None:
                dead.append(name)
            else:
                out.append((name, fn))
        for name in dead:
            del _ROSTER[name]
    return sorted(out, key=lambda p: p[0])


def roster_names() -> List[str]:
    return [name for name, _ in roster()]


class RecompilationStormWarning(RuntimeWarning):
    """More captures (compiles) of one entry point than shape-stable
    training can explain: look for batch-shape churn."""


def _leaf(a):
    shape = getattr(a, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(a, "dtype", "")))
    if isinstance(a, (int, float, bool, str, bytes, type(None))):
        return a
    return type(a).__name__


def _flatten(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.append(("key", k))
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        out.append(("seq", len(tree)))
        for v in tree:
            _flatten(v, out)
    else:
        out.append(_leaf(tree))
    return out


def _signature(args, kwargs):
    """The call's signature: every tensor or array leaf as (shape, dtype),
    scalars as they are, the nesting kept."""
    return tuple(_flatten((args, kwargs), []))


class CompileWatcher:
    def __init__(self, registry=None, tracer=None, storm_threshold: int = 3):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._time: Dict[str, float] = {}
        self._warned = set()
        self._sigs: Dict[str, set] = {}
        self.storm_threshold = max(1, int(storm_threshold))
        self.tracer = tracer
        self._compilations = self._compile_s = None
        if registry is not None:
            self._compilations = registry.counter(
                "dl4j_graph_captures_total",
                "CUDA-graph captures (first calls of a new batch signature "
                "on eager entry points) per entry point",
                labels=("function",))
            self._compile_s = registry.histogram(
                "dl4j_graph_capture_seconds",
                "wall seconds of a capture (warm-up + capture), or of the "
                "first eager call of a signature",
                labels=("function",))

    def call(self, name: str, fn: Callable, args, kwargs):
        """Invoke `fn`; a signature `name` has not seen counts one
        compile, timed by this call's wall time."""
        with self._lock:
            sigs = self._sigs.setdefault(name, set())
            sig = _signature(args, kwargs)
            fresh = sig not in sigs
            sigs.add(sig)
        if not fresh:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._record(name, 1, time.perf_counter() - t0)
        return out

    def record_aot(self, name: str, wall_s: float, n: int = 1):
        """Record a compile made ahead of its calls (`name` built once for a
        signature, as the serving registry builds a runner per bucket), of
        `wall_s` seconds."""
        self._record(name, n, wall_s)

    def record_capture(self, name: str, wall_s: float, n: int = 1):
        """Record a CUDA-graph capture of `name` (its warm-up step and the
        capture, `wall_s` seconds)."""
        self._record(name, n, wall_s)

    def _record(self, name: str, n: int, wall_s: float):
        with self._lock:
            total = self._counts.get(name, 0) + n
            self._counts[name] = total
            self._time[name] = self._time.get(name, 0.0) + wall_s
            storm = (total > self.storm_threshold
                     and name not in self._warned)
            if storm:
                self._warned.add(name)
        if self._compilations is not None:
            self._compilations.inc(n, function=name)
            self._compile_s.observe(wall_s, function=name)
        if self.tracer is not None:
            self.tracer.instant(f"graph/capture:{name}", count=total,
                                wall_s=round(wall_s, 4))
        if storm:
            warnings.warn(
                f"recompilation storm: '{name}' has been captured {total} "
                f"times (> {self.storm_threshold}). Every distinct batch "
                "signature captures the whole step anew — pad batches to a "
                "fixed size (fit(..., pad_ragged=True) / "
                "datasets.pipeline.PadToBatchIterator) or drop the ragged "
                "tail (ArrayDataSetIterator(drop_last=True))",
                RecompilationStormWarning, stacklevel=3)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def report(self) -> Dict[str, Dict]:
        """{entry point: {count, wall_s}}."""
        with self._lock:
            return {k: {"count": self._counts[k],
                        "wall_s": round(self._time.get(k, 0.0), 4)}
                    for k in sorted(self._counts)}


def watch_compiles(fn: Callable, name: str) -> Callable:
    """Wrap a callable so the ACTIVE telemetry session (if any) counts
    its first call per batch signature. Disabled cost: one global read per
    call. Wrapping also registers `name` in the module roster (the latest
    wrap wins)."""
    from . import runtime

    try:
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
    except TypeError:       # non-weakrefable callable: skip the roster
        ref = None
    if ref is not None:
        with _ROSTER_LOCK:
            _ROSTER[name] = ref

    def watched(*args, **kwargs):
        tel = runtime.active()
        if tel is None:
            return fn(*args, **kwargs)
        return tel.compiles.call(name, fn, args, kwargs)

    watched.__name__ = getattr(fn, "__name__", name)
    watched.__wrapped__ = fn
    return watched
