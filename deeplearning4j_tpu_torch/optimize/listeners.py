"""Training listeners: the port of `deeplearning4j_tpu/optimize/listeners.py`
(ScoreIterationListener, PerformanceListener, CollectScoresIterationListener,
ParamAndGradientIterationListener, ComposableIterationListener and the two
base classes).

Listeners run on the host between training steps; they see the model, the
iteration number and the score. Reading the score (`model.score()`) or the
parameters copies from the device, which waits for the step to finish.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np

from ..nn.trees import flat_leaves

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = [
    "IterationListener", "TrainingListener", "ScoreIterationListener",
    "PerformanceListener", "CollectScoresIterationListener",
    "ComposableIterationListener", "ParamAndGradientIterationListener",
]


class IterationListener:
    """Per-iteration hook (reference `optimize/api/IterationListener.java`)."""

    invoked = False

    def iteration_done(self, model, iteration: int):
        pass


class TrainingListener(IterationListener):
    """Adds epoch/forward/backward hooks (reference `optimize/api/TrainingListener.java`)."""

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_backward_pass(self, model):
        pass

    def on_gradient_calculation(self, model):
        pass


class ScoreIterationListener(IterationListener):
    """Logs score every N iterations (`optimize/listeners/ScoreIterationListener.java`)."""

    def __init__(self, print_iterations: int = 10, printer: Optional[Callable] = None):
        self.print_iterations = max(1, int(print_iterations))
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration: int):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener(IterationListener):
    """Samples/sec and batches/sec, one record per `frequency` iterations.
    The first window counts the first batch, which builds the kernels, and
    is marked `warmup`. With `report_score` a report reads the score, which
    waits for the step on the device."""

    def __init__(self, frequency: int = 1, report_score: bool = False,
                 printer: Optional[Callable] = None):
        self.frequency = max(1, int(frequency))
        self.report_score = report_score
        self.printer = printer or (lambda s: log.info(s))
        # the window opens when the listener is attached: the first batch
        # is counted, and its record carries warmup=True
        self._last_time = time.perf_counter()
        self._samples = 0
        self._batches = 0
        self._first_window = True
        self.history: List[dict] = []

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        batch = getattr(model, "last_batch_size", 0)
        self._samples += batch
        self._batches += 1
        if self._batches >= self.frequency:
            # clamp: back-to-back replayed iterations (fit_scan listener
            # replay) can land in the same perf_counter tick — a rate from
            # a clamped dt is inflated but finite, never NaN
            dt = max(now - self._last_time, 1e-9)
            rec = {
                "iteration": iteration,
                "samples_per_sec": self._samples / dt,
                "batches_per_sec": self._batches / dt,
            }
            if self._first_window:
                rec["warmup"] = True
                self._first_window = False
            if self.report_score:
                rec["score"] = float(model.score())
            self.history.append(rec)
            self.printer(
                f"iteration {iteration}: {rec['samples_per_sec']:.1f} samples/sec, "
                f"{rec['batches_per_sec']:.2f} batches/sec"
                + (" (warmup window)" if rec.get("warmup") else ""))
            self._last_time = now
            self._samples = 0
            self._batches = 0


class CollectScoresIterationListener(IterationListener):
    """Collects (iteration, score) pairs (`optimize/listeners/CollectScoresIterationListener.java`)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(model.score())))

    def export_scores(self, path, delimiter=","):
        # explicit encoding + newline: without them Windows writes CRLF and
        # the platform codec garbles non-ASCII paths/headers on re-import
        with open(path, "w", encoding="utf-8", newline="\n") as f:
            f.write(f"iteration{delimiter}score\n")
            for it, s in self.scores:
                f.write(f"{it}{delimiter}{s}\n")

    @staticmethod
    def load_scores(path, delimiter=",") -> List[tuple]:
        """Round-trip reader for `export_scores` output."""
        out: List[tuple] = []
        with open(path, "r", encoding="utf-8", newline="") as f:
            header = f.readline()
            if not header.startswith("iteration"):
                raise ValueError(f"not an export_scores file: {path}")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                it, s = line.split(delimiter, 1)
                out.append((int(it), float(s)))
        return out


class ParamAndGradientIterationListener(IterationListener):
    """Per-iteration parameter/gradient statistics
    (`optimize/listeners/ParamAndGradientIterationListener.java`). Pulls device
    arrays to host — use sparingly."""

    collects_param_stats = True

    def __init__(self, frequency: int = 1, printer: Optional[Callable] = None):
        self.frequency = max(1, int(frequency))
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        leaves = flat_leaves(model.params)
        if not leaves:
            return
        flat = np.concatenate([l.detach().float().cpu().numpy().ravel()
                               for l in leaves])
        self.printer(
            f"iter {iteration}: |params| mean abs {np.abs(flat).mean():.3e}, "
            f"l2 {np.linalg.norm(flat):.3e}")


def warn_scan_replay(listeners):
    """A windowed fit (`fit(superstep=K)`, `grad_accumulation`,
    `fit_scan`, `fit_scan_arrays`) replays listeners at the window's edge
    with per-step scores only, so every iteration_done sees the window's
    final parameters. Warn when attached listeners snapshot parameters per
    iteration."""
    def flatten(ls):
        for l in ls:
            yield l
            # ComposableIterationListener (and anything list-like) wraps
            # children in a `listeners` attribute
            yield from flatten(getattr(l, "listeners", ()))

    bad = sorted({type(l).__name__ for l in flatten(listeners)
                  if getattr(l, "collects_param_stats", False)})
    if bad:
        import warnings
        warnings.warn(
            f"listeners {bad} collect per-iteration parameter stats, but "
            "a windowed fit replays iteration_done after the window: "
            "scores are per-step, param/update stats are end-of-window "
            "snapshots. Use fit() for faithful per-iteration histograms.",
            stacklevel=3)


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int):
        for l in self.listeners:
            l.iteration_done(model, iteration)
