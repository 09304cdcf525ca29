"""TelemetryListener: wires per-iteration runtime metrics into the
existing listener chain (ScoreIterationListener and the other listeners
keep working unchanged beside it); the port's copy of
`deeplearning4j_tpu/telemetry/listener.py`.

It never reads `model.params`, so it is faithful on the windowed replay
paths (`fit(superstep=K)`, `fit_scan_arrays`; no `warn_scan_replay`
warning) and never forces a device->host parameter pull.
"""
from __future__ import annotations

import time
from typing import Optional

from ..optimize.listeners import TrainingListener
from . import runtime

__all__ = ["TelemetryListener"]


class TelemetryListener(TrainingListener):
    TYPE_ID = "TelemetryListener"

    def __init__(self, session: Optional["runtime.TelemetrySession"] = None,
                 report_window: Optional[int] = None):
        """With no `session`, joins the active process-wide session or
        enables a fresh one (attaching the listener is the one-line way to
        turn telemetry on). `report_window`: iterations between resource
        watermark samples + JSONL-friendly registry snapshots."""
        self.session = session if session is not None else runtime.enable()
        self.report_window = max(1, int(report_window
                                        or self.session.report_window))
        reg = self.session.registry
        self._iters = reg.counter(
            "dl4j_iterations_total", "training iterations completed")
        self._samples = reg.counter(
            "dl4j_samples_total", "training examples consumed")
        self._epochs = reg.counter(
            "dl4j_epochs_total", "training epochs completed")
        self._score = reg.gauge("dl4j_score", "last minibatch score")
        self._step_t = reg.timer(
            "dl4j_step_seconds", "host wall seconds between iterations")
        self._recompiles = reg.gauge(
            "dl4j_model_batch_signatures",
            "distinct batch signatures seen by the model's train step")
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last is not None:
            self._step_t.observe(now - self._last)
        self._last = now
        self._iters.inc()
        self._samples.inc(max(0, int(getattr(model, "last_batch_size", 0))))
        rc = getattr(model, "recompile_count", None)
        if rc is not None:
            self._recompiles.set(int(rc))
        if iteration % self.report_window == 0:
            # the score gauge is read HERE, on the report window, not per
            # step: on the PER-BATCH path model.score() reads the step's
            # device score (a device->host sync), and doing that every
            # iteration would serialize the host with the card. On the
            # window replay paths the fit loop has already copied the
            # window's scores to the host and hands this hook HOST
            # scalars in model._score, so the read costs no sync.
            try:
                self._score.set(float(model.score()))
            except (TypeError, ValueError):
                pass
            self.session.watermarks.sample()

    def on_epoch_start(self, model):
        self.session.tracer.instant(
            "epoch_start", epoch=int(getattr(model, "epoch_count", 0)))

    def on_epoch_end(self, model):
        self._epochs.inc()
        self.session.tracer.instant(
            "epoch_end", epoch=int(getattr(model, "epoch_count", 0)))
        self.session.watermarks.sample()
