"""File-backed replayable topic: a broker's semantics without a broker (the
port of `deeplearning4j_tpu/streaming/topic.py`; framework-free, so this is
the port's own copy of it).

  * `FileTopic` — segmented append-only log; records are length-prefixed
    blobs; logical offsets (record indices) like Kafka's. A torn tail left
    by a crash is skipped by readers and truncated by the NEXT WRITER
    before it appends (Kafka's log recovery on the partition leader), with
    a warning and the `dl4j_topic_torn_records_total` counter, so a crashed
    producer never poisons later consumers.
  * `TopicPublisher` — `publish(array)` appends (fsync optional).
  * `TopicConsumer` — `take(timeout)` / `seek(offset)` / `commit()`;
    committed offsets persist per consumer GROUP (atomic file replace), so
    a crashed consumer resumes where it committed.

Records are `NDArraySerde`'s `.npy` bytes and the on-disk layout is the JAX
package's, byte for byte: a topic written by either package reads in the
other.
"""
from __future__ import annotations

import json
import logging
import os
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from . import NDArraySerde
from ..telemetry.runtime import active as _tel_active

__all__ = ["FileTopic", "TopicPublisher", "TopicConsumer"]

_LEN = struct.Struct(">Q")
_SEG_PREFIX = "segment_"
_SEG_SUFFIX = ".log"

_log = logging.getLogger(__name__)


def _count_torn(topic: str, n: int = 1):
    tel = _tel_active()
    if tel is not None:
        tel.registry.counter(
            "dl4j_topic_torn_records_total",
            "torn tail records truncated during topic log recovery",
            labels=("topic",)).inc(n, topic=topic)


class FileTopic:
    """Append-only segmented log with logical offsets.

    Layout: `<root>/<name>/segment_<base-offset>.log` holds records
    `[8-byte big-endian length][payload]` starting at logical offset
    `<base-offset>`; `<root>/<name>/offsets/<group>.json` holds committed
    consumer-group offsets.

    Any number of readers, ONE writer at a time. `append` re-syncs its
    offset cursor against the last segment's length on disk first, so a
    sequential hand-off between writers (a crash and restart, or another
    process that appended since this object opened) assigns the right
    offsets; two writers appending at the same time can mint duplicate
    offsets. Run one producer per topic."""

    def __init__(self, root: str, name: str = "ndarrays",
                 segment_bytes: int = 16 << 20, fsync: bool = False):
        self.dir = os.path.join(str(root), name)
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(os.path.join(self.dir, "offsets"), exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync = fsync
        # path -> byte offset of each valid record, so read(offset) seeks
        # straight to it
        self._index: dict = {}
        # path -> byte length the index covers; another size on disk means
        # another writer appended (or a write was torn)
        self._indexed_bytes: dict = {}
        self._reindex()   # read-only: opening a topic never truncates

    # -- log structure ---------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        """[(base_offset, path)] sorted by base offset."""
        out = []
        for n in os.listdir(self.dir):
            if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX):
                base = int(n[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
                out.append((base, os.path.join(self.dir, n)))
        return sorted(out)

    @staticmethod
    def _scan(path: str) -> Tuple[List[int], int]:
        """(record_byte_offsets, valid_byte_length); stops at a torn
        tail."""
        offs: List[int] = []
        pos = 0
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while pos + _LEN.size <= size:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    break
                (ln,) = _LEN.unpack(head)
                if pos + _LEN.size + ln > size:
                    break   # torn record (crash mid-append)
                f.seek(ln, os.SEEK_CUR)
                offs.append(pos)
                pos += _LEN.size + ln
        return offs, pos

    def _reindex(self):
        """Index the last segment up to its valid prefix and compute the end
        offset. Read-only: a torn tail is ignored, never truncated (a live
        writer may still be appending those bytes). Returns (path, valid,
        size) of the last segment, or None for an empty log."""
        segs = self._segments()
        if not segs:
            self._end = 0
            return None
        base, path = segs[-1]
        offs, valid = self._scan(path)
        self._index[path] = offs
        self._indexed_bytes[path] = valid
        self._end = base + len(offs)
        return path, valid, os.path.getsize(path)

    def _recover(self):
        """Writer-side log recovery: truncate a torn tail in the last segment
        so the next append lands on a record boundary. Only the append path
        calls this."""
        last = self._reindex()
        if last is None:
            return
        path, valid, size = last
        if valid < size:
            with open(path, "r+b") as f:
                f.truncate(valid)
            _log.warning(
                "topic %s: truncated torn tail record in %s "
                "(%d bytes past last valid record at %d)",
                os.path.basename(self.dir), os.path.basename(path),
                size - valid, valid)
            _count_torn(os.path.basename(self.dir))

    # -- producer side ---------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Append one record; returns its logical offset. Durable against
        torn writes (recovery truncates); `fsync=True` makes it durable
        against power loss too."""
        segs = self._segments()
        if segs:
            # re-sync the cursor if the last segment grew (or was torn)
            # behind this object's back
            last = segs[-1][1]
            if self._indexed_bytes.get(last) != os.path.getsize(last):
                self._recover()
                segs = self._segments()
        if segs and os.path.getsize(segs[-1][1]) < self.segment_bytes:
            path = segs[-1][1]
        else:
            path = os.path.join(
                self.dir, f"{_SEG_PREFIX}{self._end:020d}{_SEG_SUFFIX}")
        byte_off = os.path.getsize(path) if os.path.exists(path) else 0
        with open(path, "ab") as f:
            f.write(_LEN.pack(len(payload)) + payload)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self._index.setdefault(path, []).append(byte_off)
        self._indexed_bytes[path] = byte_off + _LEN.size + len(payload)
        off = self._end
        self._end += 1
        return off

    # -- consumer side ---------------------------------------------------
    def end_offset(self) -> int:
        """One past the last record this object has seen; a read past it
        rescans, so appends by other processes still show."""
        return self._end

    def begin_offset(self) -> int:
        segs = self._segments()
        return segs[0][0] if segs else 0

    def read(self, offset: int) -> Optional[bytes]:
        """Record at logical `offset`, or None past the end."""
        if offset >= self._end:
            self._reindex()   # another process may have appended
            if offset >= self._end:
                return None
        seg = None
        for base, path in self._segments():
            if base <= offset:
                seg = (base, path)
            else:
                break
        if seg is None:
            raise KeyError(f"offset {offset} below log start "
                           f"{self.begin_offset()}")
        base, path = seg
        offs = self._index.get(path)
        if offs is None or offset - base >= len(offs):
            offs, valid = self._scan(path)
            self._index[path] = offs
            self._indexed_bytes[path] = valid
            if offset - base >= len(offs):
                return None
        with open(path, "rb") as f:
            f.seek(offs[offset - base])
            head = f.read(_LEN.size)
            if len(head) < _LEN.size:
                return None
            (ln,) = _LEN.unpack(head)
            data = f.read(ln)
            return data if len(data) == ln else None

    # -- committed group offsets ----------------------------------------
    def _offsets_path(self, group: str) -> str:
        return os.path.join(self.dir, "offsets", f"{group}.json")

    def committed(self, group: str) -> int:
        try:
            with open(self._offsets_path(group)) as f:
                return int(json.load(f)["offset"])
        except (OSError, ValueError, KeyError):
            return self.begin_offset()

    def commit(self, group: str, offset: int):
        p = self._offsets_path(group)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"offset": int(offset)}, f)
        os.replace(tmp, p)   # atomic: a crash never corrupts the offset


class TopicPublisher:
    """Durable counterpart of `NDArrayPublisher`: publish(array) appends
    to the topic log."""

    def __init__(self, topic: FileTopic):
        self.topic = topic

    def publish(self, arr: np.ndarray) -> int:
        return self.topic.append(NDArraySerde.to_bytes(arr))

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TopicConsumer:
    """Durable counterpart of `NDArrayConsumer`: take() reads the next
    record from this group's position; commit() persists it. A consumer
    restarted after a crash resumes from the last committed offset:
    records consumed but not committed are delivered again (at least
    once)."""

    def __init__(self, topic: FileTopic, group: str = "default",
                 from_beginning: bool = False):
        self.topic = topic
        self.group = group
        self.position = (topic.begin_offset() if from_beginning
                         else topic.committed(group))

    def seek(self, offset: int):
        self.position = int(offset)

    def take(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            data = self.topic.read(self.position)
            if data is not None:
                self.position += 1
                return NDArraySerde.from_bytes(data)
            if deadline is None or time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def commit(self):
        self.topic.commit(self.group, self.position)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
