"""Legacy remote iteration listeners — the WebReporter tier; the port of
`deeplearning4j_tpu/ui/legacy_listeners.py`.

Reference: `deeplearning4j-ui-remote-iterationlisteners/.../ui/
WebReporter.java` (static POST-to-UI-host rate-limited reporter) with
`flow/RemoteFlowIterationListener.java`,
`weights/RemoteHistogramIterationListener.java` and
`weights/RemoteConvolutionalIterationListener.java` — per-iteration
listeners that push a rendered payload directly to a remote endpoint
instead of going through a StatsStorage.

The modern path here (as in the reference's successor UI) is
`StatsListener` -> `RemoteUIStatsStorageRouter` -> `/remote`; these
classes keep the legacy capability: direct per-iteration POST of a typed
payload (flow topology snapshot / parameter histograms / conv
activations) to an arbitrary HTTP endpoint, with WebReporter's
queue-and-rate-limit behavior.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..optimize.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["WebReporter", "RemoteFlowIterationListener",
           "RemoteHistogramIterationListener"]


class WebReporter:
    """POST JSON payloads to a UI host from a BACKGROUND worker thread
    with a bounded queue (WebReporter.java's LinkedBlockingQueue + posting
    thread): a slow or black-holed UI host never stalls the training loop
    — `report()` only enqueues. Rate-limited to at most one post per
    `min_interval` seconds; failed heads are retried on the next cycle."""

    def __init__(self, url: str, timeout: float = 5.0,
                 queue_size: int = 128, min_interval: float = 0.0):
        self.url = url
        self.timeout = timeout
        self.min_interval = float(min_interval)
        self._queue = deque(maxlen=queue_size)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dl4jtpu-webreporter")
        self._worker.start()

    def _post(self, payload: Dict) -> bool:
        req = urllib.request.Request(
            self.url, json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except Exception as e:
            log.debug("legacy web report failed: %s", e)
            return False

    def _run(self):
        while not self._stop:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            while not self._stop:
                with self._lock:
                    head = self._queue[0] if self._queue else None
                if head is None:
                    break
                if self.min_interval:
                    time.sleep(self.min_interval)
                if not self._post(head):
                    break  # retry the head on the next wake/poll cycle
                with self._lock:
                    if self._queue and self._queue[0] is head:
                        self._queue.popleft()

    def report(self, payload: Dict):
        with self._lock:
            self._queue.append(payload)
        self._wake.set()

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for the queue to drain (tests / shutdown)."""
        deadline = time.time() + timeout
        self._wake.set()
        while time.time() < deadline:
            with self._lock:
                if not self._queue:
                    return True
            time.sleep(0.02)
        return False

    def close(self):
        self._stop = True
        self._wake.set()

    @property
    def pending(self) -> int:
        return len(self._queue)


class RemoteFlowIterationListener(TrainingListener):
    """Per-iteration network-topology + score snapshot POSTed to a remote
    endpoint (RemoteFlowIterationListener.java capability)."""

    def __init__(self, url: str, frequency: int = 1,
                 reporter: Optional[WebReporter] = None):
        self.reporter = reporter or WebReporter(url)
        self.frequency = max(1, int(frequency))

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        from .stats import model_topology

        self.reporter.report({
            "type": "flow",
            "iteration": int(iteration),
            "score": float(model.score()),
            "model": model_topology(model),
        })


class RemoteHistogramIterationListener(TrainingListener):
    """Per-iteration parameter histograms POSTed to a remote endpoint
    (RemoteHistogramIterationListener.java capability)."""

    collects_param_stats = True

    def __init__(self, url: str, frequency: int = 1, bins: int = 20,
                 reporter: Optional[WebReporter] = None):
        self.reporter = reporter or WebReporter(url)
        self.frequency = max(1, int(frequency))
        self.bins = int(bins)

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        from .stats import _flatten_params

        hists = {}
        for k, v in _flatten_params(model).items():
            counts, edges = np.histogram(v.ravel(), bins=self.bins)
            hists[k] = {"counts": counts.tolist(),
                        "min": float(edges[0]), "max": float(edges[-1])}
        self.reporter.report({
            "type": "histogram",
            "iteration": int(iteration),
            "score": float(model.score()),
            "histograms": hists,
        })
