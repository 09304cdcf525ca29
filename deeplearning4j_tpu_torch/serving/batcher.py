"""Dynamic request batching (the port of
`deeplearning4j_tpu/serving/batcher.py`, without its metrics and tracing
hooks, which arrive with a later slice).

A request enqueues its rows and blocks on an event; the single worker thread
drains the queue when either enough rows have accumulated to fill
`max_batch`, or the oldest queued request has waited `max_wait_us`. The
drained rows are stacked, padded with zero rows up to the smallest bucket
that fits, run through one forward, and scattered back to their waiters.
Shape validation happens on the caller's thread, so a malformed request
fails alone; a failure inside a batched forward fails exactly that batch.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .registry import ServingError, pad_rows

__all__ = ["DynamicBatcher", "BatcherClosedError", "FlushEma"]


class FlushEma:
    """Per-bucket EMA of flush wall seconds. Unsampled buckets are
    estimated by linear scaling from the smallest sampled bucket above
    (floored by the largest sampled bucket below), a deliberately
    pessimistic guess that real samples soon replace."""

    __slots__ = ("_ema",)

    def __init__(self):
        self._ema: dict = {}   # bucket -> EMA flush seconds

    def observe(self, bucket: int, dt: float):
        prev = self._ema.get(bucket)
        self._ema[bucket] = dt if prev is None else 0.5 * prev + 0.5 * dt

    def estimate(self, bucket: int) -> Optional[float]:
        t = self._ema.get(bucket)
        if t is not None:
            return t
        if not self._ema:
            return None
        larger = [b for b in self._ema if b > bucket]
        if larger:
            b0 = min(larger)
            est = self._ema[b0] * bucket / b0
            smaller = [b for b in self._ema if b < bucket]
            if smaller:
                est = max(est, self._ema[max(smaller)])
            return est
        b0 = max(self._ema)
        return self._ema[b0] * bucket / b0

    def pick_rows(self, avail: int, buckets: Tuple[int, ...],
                  cap: int) -> int:
        """Rows for a flush of `avail` queued rows: all of them padded up to
        the next bucket, or only the largest full bucket's worth, whichever
        gives more rows per second under the EMAs."""
        cap = min(cap, buckets[-1])
        if avail >= cap:
            return cap
        up = next((b for b in buckets if b >= avail), buckets[-1])
        full = [b for b in buckets if b <= avail]
        if not full or full[-1] == up:
            return avail
        fb = max(full)
        t_up, t_fb = self.estimate(up), self.estimate(fb)
        if not t_up or not t_fb:
            return avail
        return avail if avail / t_up >= fb / t_fb else fb


class BatcherClosedError(RuntimeError):
    """submit() after stop() — the serving plane is shutting down."""


class _Pending:
    __slots__ = ("x", "rows", "event", "result", "version", "error",
                 "enqueued_at")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.rows = int(x.shape[0])
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.version: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.perf_counter()


class DynamicBatcher:
    """Coalesces concurrent `submit()` calls into bucket-shaped batches.

    runner(x_padded, bucket) -> (outputs, version): one forward over a
        `[bucket, ...]` batch.
    bucket_for(rows) -> bucket: smallest bucket holding `rows`.
    max_batch: row budget per flush.
    max_wait_us: the oldest request never waits longer than this for
        co-batching before the worker flushes a partial batch.
    """

    def __init__(self, runner: Callable, bucket_for: Callable[[int], int],
                 max_batch: int, max_wait_us: int = 2000,
                 name: str = "model",
                 buckets: Optional[Tuple[int, ...]] = None):
        self._runner = runner
        self._bucket_for = bucket_for
        self.max_batch = int(max_batch)
        self.max_wait_s = max(0.0, float(max_wait_us) / 1e6)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self._flush_ema = FlushEma()
        self.name = name
        self.flushes = 0
        self._stop_lock = threading.Lock()
        # clients only append (atomic under the GIL) and the worker is the
        # only consumer, so enqueue takes no lock
        self._queue: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stopped = False
        self._worker = threading.Thread(
            target=self._loop, name=f"dl4j-torch-serving-batcher-{name}",
            daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------
    def submit(self, x: np.ndarray, timeout: float = 30.0
               ) -> Tuple[np.ndarray, int]:
        """Block until this request's rows come back from a batched
        forward. Returns `(outputs, version)`."""
        if int(x.shape[0]) > self.max_batch:
            raise ServingError(
                f"request of {int(x.shape[0])} rows exceeds max_batch "
                f"{self.max_batch} for '{self.name}'")
        if self._stopped:
            raise BatcherClosedError(f"batcher for '{self.name}' is stopped")
        p = _Pending(x)
        self._queue.append(p)
        self._wake.set()
        if self._stopped and not p.event.is_set():
            # raced a concurrent stop(): reclaim the request instead of
            # waiting out the timeout
            try:
                self._queue.remove(p)
                raise BatcherClosedError(
                    f"batcher for '{self.name}' is stopped")
            except ValueError:
                pass          # the drain took it; wait for its result
        if not p.event.wait(timeout):
            try:
                self._queue.remove(p)
            except ValueError:
                pass
            raise TimeoutError(
                f"batched predict on '{self.name}' timed out after "
                f"{timeout:.1f}s")
        if p.error is not None:
            raise p.error
        return p.result, p.version

    def stop(self, drain: bool = True):
        """Stop the worker; with `drain`, queued requests are flushed
        first. Idempotent."""
        with self._stop_lock:
            if self._stopped:
                return
            if not drain:
                self._fail_queued()
            self._stopped = True
        self._wake.set()
        self._worker.join(timeout=10.0)
        self._fail_queued()

    def _fail_queued(self):
        while True:
            try:
                p = self._queue.popleft()
            except IndexError:
                return
            p.error = BatcherClosedError(f"batcher for '{self.name}' stopped")
            p.event.set()

    # -- worker side -----------------------------------------------------
    def _flush_budget(self, avail: int) -> int:
        if self.buckets is None:
            return self.max_batch
        return self._flush_ema.pick_rows(avail, self.buckets, self.max_batch)

    def _queued_rows(self) -> int:
        # iterating races concurrent appends; retry, then undercount
        for _ in range(3):
            try:
                return sum(p.rows for p in self._queue)
            except RuntimeError:
                continue
        return len(self._queue)

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Wait for work, then for a full batch or the oldest request's
        deadline; dequeue FIFO without splitting a request. None when
        stopped and drained."""
        queue, wake = self._queue, self._wake
        while not queue:
            if self._stopped:
                return None
            wake.wait(timeout=0.05)
            wake.clear()
        deadline = queue[0].enqueued_at + self.max_wait_s
        avail = self._queued_rows()
        while avail < self.max_batch and not self._stopped:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            wake.wait(timeout=remaining)
            wake.clear()
            avail = self._queued_rows()
        budget = self._flush_budget(min(avail, self.max_batch))
        taken, rows = [], 0
        while queue and rows + queue[0].rows <= budget:
            p = queue.popleft()
            rows += p.rows
            taken.append(p)
        if not taken and queue:
            taken.append(queue.popleft())
        return taken

    def _flush(self, taken: List[_Pending]):
        rows = sum(p.rows for p in taken)
        scattered = 0
        try:
            x = (taken[0].x if len(taken) == 1
                 else np.concatenate([p.x for p in taken], axis=0))
            bucket = self._bucket_for(rows)
            t0 = time.perf_counter()
            out, version = self._runner(pad_rows(x, bucket - rows), bucket)
            self._flush_ema.observe(bucket, time.perf_counter() - t0)
            self.flushes += 1
            lo = 0
            for p in taken:
                p.result = out[lo:lo + p.rows]
                p.version = version
                lo += p.rows
                scattered += 1
                p.event.set()
        except BaseException as e:   # fail this batch, keep serving
            for p in taken[scattered:]:
                p.error = e
                p.event.set()

    def _loop(self):
        while True:
            try:
                taken = self._take_batch()
            except (IndexError, RuntimeError):
                # a timed-out client's remove() raced the head peek; the
                # worker must never die
                continue
            if taken is None:
                return
            if taken:
                self._flush(taken)
