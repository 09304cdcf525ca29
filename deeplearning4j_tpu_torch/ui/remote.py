"""Remote stats routing — multi-host observability; the port of
`deeplearning4j_tpu/ui/remote.py` (stdlib only).

Reference analogs: `RemoteUIStatsStorageRouter`
(`deeplearning4j-core/.../impl/RemoteUIStatsStorageRouter.java` — HTTP
POSTs stats to a remote UI) and the receiving `RemoteReceiverModule`
(`deeplearning4j-play/.../module/remote/RemoteReceiverModule.java`). In a
multi-host job each worker host attaches this router to its StatsListener
and the coordinator (or a laptop) runs
`UIServer(...).enable_remote_listener()`; training stats flow over plain
HTTP, off the interconnect the collectives use.

Includes the reference router's bounded retry queue: transient connection
failures buffer updates and retry on the next put rather than dropping or
blocking training.
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.request
from collections import deque
from typing import Deque, Dict, Tuple

from .storage import StatsStorage

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["RemoteUIStatsStorageRouter"]


class RemoteUIStatsStorageRouter(StatsStorage):
    """StatsStorage front half only: put_update POSTs to the remote UI.
    Query methods are unsupported (the storage lives on the receiver)."""

    def __init__(self, url: str, retry_queue_size: int = 512,
                 timeout: float = 5.0):
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self._retry: Deque[Dict] = deque(maxlen=retry_queue_size)
        self._lock = threading.Lock()
        self._drain_lock = threading.Lock()  # one drainer at a time

    def _post(self, payload: Dict) -> bool:
        req = urllib.request.Request(
            self.url, json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except Exception as e:
            log.debug("remote stats post failed: %s", e)
            return False

    def put_update(self, session_id, type_id, worker_id, timestamp, report):
        payload = {"session": session_id, "type": type_id,
                   "worker": worker_id, "ts": timestamp, "report": report}
        # enqueue-then-drain-from-head: updates always deliver in order
        # (the dashboard's 'latest' stays monotonic), and a black-holed UI
        # host costs the training loop ONE timeout per iteration, not
        # (pending+1) timeouts — the drain stops at the first failure.
        with self._lock:
            self._retry.append(payload)
        self._try_drain()

    def _try_drain(self):
        """Drain the retry queue from the head, serialized by a TRY-lock
        (two drainers could read the same head and POST it twice) — a
        caller never BLOCKS on the drain lock: stalling a training
        thread behind someone else's slow POST for a full HTTP timeout
        is exactly what graftlint's blocking-call-under-lock flags. A
        failed try-acquire means an active drainer exists; it delivers
        late enqueues via its inner loop, and the post-release re-check
        below closes the remaining window (an append landing between
        the drainer's final empty-check and its release)."""
        while True:
            if not self._drain_lock.acquire(blocking=False):
                return
            try:
                while True:
                    with self._lock:
                        if not self._retry:
                            break
                        head = self._retry[0]
                    if not self._post(head):
                        return      # head retried on the next cycle
                    with self._lock:
                        if self._retry and self._retry[0] is head:
                            self._retry.popleft()
            finally:
                self._drain_lock.release()
            # re-check AFTER releasing: a payload enqueued during the
            # final empty-check window must not strand until the next
            # put_update (it may be the run's last stats report)
            with self._lock:
                if not self._retry:
                    return

    @property
    def pending(self) -> int:
        return len(self._retry)

    # query half lives on the receiver
    def list_session_ids(self):
        raise NotImplementedError("router is write-only; query the UI host")

    def list_type_ids(self, session_id):
        raise NotImplementedError("router is write-only; query the UI host")

    def list_worker_ids(self, session_id, type_id):
        raise NotImplementedError("router is write-only; query the UI host")

    def get_all_updates(self, session_id, type_id, worker_id):
        raise NotImplementedError("router is write-only; query the UI host")
