"""Step tracing in Chrome trace-event JSON (Perfetto / chrome://tracing):
the port's copy of `deeplearning4j_tpu/telemetry/tracing.py`.

Complete ("X") events with microsecond timestamps relative to tracer
creation. The buffer is bounded: when full, new events are dropped and
counted (`dropped_events`) instead of growing without limit — always-on
tracing must not become the memory leak it exists to catch.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer"]


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self._name, self._t0, time.perf_counter(),
                               self._args)
        return False


# counter tracks get synthetic tids from this base so each counter name
# renders as its own named row instead of all interleaving on tid 0
# (which also carries the process_name metadata). Real thread idents are
# pthread pointers (Linux) or small handles (Windows); a dedicated
# 2^31-aligned range collides with neither in practice.
_COUNTER_TID_BASE = 0x80000000


class Tracer:
    def __init__(self, max_events: int = 200_000,
                 process_name: str = "deeplearning4j_tpu_torch"):
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._max_events = int(max_events)
        self.dropped_events = 0
        self._pid = os.getpid()
        self._counter_tids: Dict[str, int] = {}
        self._append({"ph": "M", "name": "process_name", "pid": self._pid,
                      "tid": 0, "args": {"name": process_name}})

    def _append(self, ev: Dict):
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped_events += 1
                return
            self._events.append(ev)

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _complete(self, name, t_start, t_end, args):
        ev = {"ph": "X", "name": name, "cat": "runtime",
              "ts": round(self._us(t_start), 3),
              "dur": round((t_end - t_start) * 1e6, 3),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def span(self, name: str, **args) -> _Span:
        """Context manager recording a complete event around the block."""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args):
        ev = {"ph": "i", "name": name, "cat": "runtime", "s": "t",
              "ts": round(self._us(time.perf_counter()), 3),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def _counter_tid(self, name: str) -> int:
        """Stable synthetic tid per counter name, with a one-time
        thread_name metadata event naming the row."""
        tid = self._counter_tids.get(name)   # GIL-atomic fast path
        if tid is not None:
            return tid
        with self._lock:
            tid = self._counter_tids.get(name)
            if tid is None:
                tid = _COUNTER_TID_BASE + len(self._counter_tids)
                self._counter_tids[name] = tid
                meta = True
            else:
                meta = False
        if meta:
            self._append({"ph": "M", "name": "thread_name",
                          "pid": self._pid, "tid": tid,
                          "args": {"name": f"counter:{name}"}})
        return tid

    def counter(self, name: str, **series):
        """Chrome counter-track event (rendered as a stacked area chart)
        on its own named row — KV-pool and queue-depth counters no
        longer interleave on tid 0."""
        self._append({"ph": "C", "name": name, "cat": "runtime",
                      "ts": round(self._us(time.perf_counter()), 3),
                      "pid": self._pid, "tid": self._counter_tid(name),
                      "args": series})

    def __len__(self):
        with self._lock:
            return len(self._events)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped_events}}

    def export_chrome_trace(self, path) -> str:
        """Write the trace JSON; open the file in Perfetto
        (https://ui.perfetto.dev) or chrome://tracing."""
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            json.dump(self.chrome_trace(), f)
        return str(path)
