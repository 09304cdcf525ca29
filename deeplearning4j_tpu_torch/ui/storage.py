"""StatsStorage SPI + implementations: the port's copy of
`deeplearning4j_tpu/ui/storage.py` (stdlib only). A stats file written by
either package reads back in the other.

Parity with `deeplearning4j-core/.../api/storage/StatsStorage.java` (the SPI
the UI plugs into: sessions → type → worker → time-ordered updates, plus
change listeners) and the impls in `deeplearning4j-ui-model/.../ui/storage/`
(InMemoryStatsStorage, FileStatsStorage). The reference persists SBE binary;
here a report is a JSON-able dict and FileStatsStorage appends JSON lines.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "SqliteStatsStorage", "StatsStorageEvent", "StatsStorageListener"]


class StatsStorageEvent:
    NEW_SESSION = "new_session"
    NEW_WORKER = "new_worker"
    POST_UPDATE = "post_update"

    def __init__(self, kind: str, session_id: str, type_id: str,
                 worker_id: str, timestamp: float):
        self.kind = kind
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = timestamp


StatsStorageListener = Callable[[StatsStorageEvent], None]


class StatsStorage:
    """SPI: (session, type, worker) → time-ordered updates."""

    def put_update(self, session_id: str, type_id: str, worker_id: str,
                   timestamp: float, report: Dict) -> None:
        raise NotImplementedError

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_type_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str, type_id: str) -> List[str]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str, type_id: str,
                        worker_id: str) -> List[Tuple[float, Dict]]:
        raise NotImplementedError

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str, timestamp: float
                              ) -> List[Tuple[float, Dict]]:
        return [(t, r) for t, r in
                self.get_all_updates(session_id, type_id, worker_id)
                if t > timestamp]

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[Tuple[float, Dict]]:
        ups = self.get_all_updates(session_id, type_id, worker_id)
        return ups[-1] if ups else None

    # -- change notification (UI polling uses this) ---------------------
    def register_listener(self, listener: StatsStorageListener) -> None:
        self._listeners().append(listener)

    def deregister_listener(self, listener: StatsStorageListener) -> None:
        try:
            self._listeners().remove(listener)
        except ValueError:
            pass

    def _listeners(self) -> List[StatsStorageListener]:
        if not hasattr(self, "_listener_list"):
            self._listener_list: List[StatsStorageListener] = []
        return self._listener_list

    def _notify(self, event: StatsStorageEvent) -> None:
        for listener in list(self._listeners()):
            listener(event)


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._lock = threading.Lock()
        # {session: {type: {worker: [(ts, report), ...]}}}
        self._data: Dict[str, Dict[str, Dict[str, List[Tuple[float, Dict]]]]] = {}

    def put_update(self, session_id, type_id, worker_id, timestamp, report):
        with self._lock:
            new_session = session_id not in self._data
            sess = self._data.setdefault(session_id, {})
            typ = sess.setdefault(type_id, {})
            new_worker = worker_id not in typ
            typ.setdefault(worker_id, []).append((timestamp, dict(report)))
        if new_session:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_SESSION,
                                           session_id, type_id, worker_id,
                                           timestamp))
        if new_worker:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_WORKER,
                                           session_id, type_id, worker_id,
                                           timestamp))
        self._notify(StatsStorageEvent(StatsStorageEvent.POST_UPDATE,
                                       session_id, type_id, worker_id,
                                       timestamp))

    def list_session_ids(self):
        with self._lock:
            return list(self._data)

    def list_type_ids(self, session_id):
        with self._lock:
            return list(self._data.get(session_id, {}))

    def list_worker_ids(self, session_id, type_id):
        with self._lock:
            return list(self._data.get(session_id, {}).get(type_id, {}))

    def get_all_updates(self, session_id, type_id, worker_id):
        with self._lock:
            return list(self._data.get(session_id, {}).get(type_id, {})
                        .get(worker_id, []))


class FileStatsStorage(InMemoryStatsStorage):
    """JSON-lines persistence: every update appends one line
    {"session":..,"type":..,"worker":..,"ts":..,"report":{...}}; the
    constructor replays an existing file (round-trip-able storage, the role
    of the reference's FileStatsStorage/MapDBStatsStorage)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._file_lock = threading.Lock()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    super().put_update(rec["session"], rec["type"],
                                       rec["worker"], rec["ts"],
                                       rec["report"])

    def put_update(self, session_id, type_id, worker_id, timestamp, report):
        rec = {"session": session_id, "type": type_id, "worker": worker_id,
               "ts": timestamp, "report": report}
        with self._file_lock, open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        super().put_update(session_id, type_id, worker_id, timestamp, report)


class SqliteStatsStorage(StatsStorage):
    """SQLite-backed storage (reference `sqlite/J7FileStatsStorage.java` /
    `mapdb/MapDBStatsStorage.java` role): durable, queryable from other
    processes, safe for concurrent writers through SQLite's own locking.
    Reports are stored as JSON text in an indexed (session, type, worker,
    ts) table."""

    def __init__(self, path: str):
        import sqlite3

        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS updates ("
                " session TEXT NOT NULL, type TEXT NOT NULL,"
                " worker TEXT NOT NULL, ts REAL NOT NULL,"
                " report TEXT NOT NULL)")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_updates ON updates"
                " (session, type, worker, ts)")
            self._conn.commit()

    def close(self):
        with self._lock:
            self._conn.close()

    def put_update(self, session_id, type_id, worker_id, timestamp, report):
        with self._lock:
            new_session = not self._conn.execute(
                "SELECT 1 FROM updates WHERE session=? LIMIT 1",
                (session_id,)).fetchone()
            new_worker = not self._conn.execute(
                "SELECT 1 FROM updates WHERE session=? AND type=? AND "
                "worker=? LIMIT 1",
                (session_id, type_id, worker_id)).fetchone()
            self._conn.execute(
                "INSERT INTO updates VALUES (?,?,?,?,?)",
                (session_id, type_id, worker_id, float(timestamp),
                 json.dumps(report)))
            self._conn.commit()
        if new_session:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_SESSION,
                                           session_id, type_id, worker_id,
                                           timestamp))
        if new_worker:
            self._notify(StatsStorageEvent(StatsStorageEvent.NEW_WORKER,
                                           session_id, type_id, worker_id,
                                           timestamp))
        self._notify(StatsStorageEvent(StatsStorageEvent.POST_UPDATE,
                                       session_id, type_id, worker_id,
                                       timestamp))

    def list_session_ids(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT session FROM updates ORDER BY rowid")
            return [r[0] for r in rows]

    def list_type_ids(self, session_id):
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT type FROM updates WHERE session=?",
                (session_id,))
            return [r[0] for r in rows]

    def list_worker_ids(self, session_id, type_id):
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT worker FROM updates WHERE session=? AND "
                "type=?", (session_id, type_id))
            return [r[0] for r in rows]

    def get_all_updates(self, session_id, type_id, worker_id):
        with self._lock:
            rows = self._conn.execute(
                "SELECT ts, report FROM updates WHERE session=? AND type=?"
                " AND worker=? ORDER BY ts, rowid",
                (session_id, type_id, worker_id))
            return [(t, json.loads(r)) for t, r in rows]
