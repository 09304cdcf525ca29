"""Flight recorder: an always-on, lock-free ring buffer of structured
events — the black box that turns a dead run into a readable timeline
(the port's copy of `deeplearning4j_tpu/telemetry/recorder.py`).

The training/serving planes record a few events per step (step scores at
their sanctioned host-sync points, collective-sequence digests, KV-pool
pressure, swap/eviction decisions); `fault/guard.py` dumps the ring
atomically the moment a non-finite step trips skip/rollback/halt, and
the serving plane exposes the same view at `/debug/flightrecord`.

Write-path concurrency contract:
`record()` takes NO lock. `next(itertools.count())` is a GIL-atomic
sequence reservation, and the slot write is a single list-item
assignment of one fully-built tuple — a reader sees either the old
tuple or the new one, never a torn event. Two writers that race the
same slot (one full lap apart) leave whichever tuple landed last; the
loser is simply one more dropped-by-wraparound event, exactly what a
bounded ring promises. Total-written is derived from the max sequence
number actually present (not a racy `+= 1`), so drop accounting stays
exact without synchronization.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "flight_recorder", "install"]


class FlightRecorder:
    """Bounded ring of (seq, ts, thread, kind, fields) tuples."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = max(1, int(capacity))
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._ids = itertools.count()
        self.enabled = bool(enabled)
        self.last_dump: Optional[Dict] = None

    # -- hot path (no locks, no allocation beyond the event itself) -----
    def record(self, kind: str, **fields):
        if not self.enabled:
            return
        i = next(self._ids)          # GIL-atomic slot reservation
        self._buf[i % self.capacity] = (
            i, time.time(), threading.current_thread().name, kind, fields)

    # -- read side -------------------------------------------------------
    def snapshot(self, last: Optional[int] = None) -> List[Dict]:
        """Events currently in the ring, oldest first. `last` keeps only
        the newest N. list() copies the slot references in one pass;
        each slot is a complete tuple or None, never partial."""
        live = [e for e in list(self._buf) if e is not None]
        live.sort(key=lambda e: e[0])
        if last is not None:
            live = live[-int(last):]
        out = []
        for seq, ts, thread, kind, fields in live:
            ev = dict(fields)
            ev["seq"] = seq
            ev["ts"] = round(ts, 6)
            ev["thread"] = thread
            ev["kind"] = kind
            out.append(ev)
        return out

    def total_written(self) -> int:
        live = [e for e in list(self._buf) if e is not None]
        return (max(e[0] for e in live) + 1) if live else 0

    def dropped(self) -> int:
        return max(0, self.total_written() - self.capacity)

    def dump(self, reason: str, path=None,
             extra: Optional[Dict] = None) -> Dict:
        """Freeze the ring into a dump document, remember it as
        `last_dump` (what /debug/flightrecord serves) and optionally
        write it atomically (tmp + rename — a crash mid-dump never
        leaves a truncated file)."""
        doc = {"reason": reason, "ts": round(time.time(), 6),
               "capacity": self.capacity,
               "total_events": self.total_written(),
               "dropped_by_wraparound": self.dropped(),
               "events": self.snapshot()}
        if extra:
            doc.update(extra)
        self.last_dump = doc
        if path is not None:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8", newline="\n") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            doc["path"] = str(path)
        return doc


_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder the instrumented planes feed."""
    return _recorder


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide recorder (tests isolate through this);
    returns the previous one. Module-global rebinding is GIL-atomic."""
    global _recorder
    prev = _recorder
    _recorder = recorder
    return prev
