"""TrainingGuard — non-finite-step detection + transient-error retry (the
port of `deeplearning4j_tpu/fault/guard.py`).

One bad batch (a NaN in the data, an overflowing loss) silently poisons
params forever: every subsequent step multiplies NaNs through the whole
tree, and the first visible symptom is an evaluation that returns garbage
hours later. The guard checks `isfinite(loss)` after every step — the loss
is the one scalar the train step already returns, so the only added cost
is the host sync that reads it (opt-in, like `collect_stats`) — and applies
a policy:

  warn        log + count; keep the (possibly poisoned) step.
  skip_batch  restore the pre-batch snapshot (params/state/updater/
              dropout generators/counters) and continue — the offending
              batch simply never happened. Costs one device-side copy of
              the model trees per step (a window replayed as a CUDA graph
              updates the model's tensors in place, so the snapshot is a
              clone taken before the replay).
  rollback    restore the last *known-good* snapshot, refreshed every
              `refresh_every` finite steps — reaches further back than
              skip_batch for losses that go bad a few steps after the
              params do.
  halt        raise NonFiniteScoreError immediately.

Plus `next_batch`: bounded exponential-backoff retry around
`iterator.next()` for transient data-source errors (flaky network reader,
NFS hiccup). SimulatedCrash/KeyboardInterrupt are BaseExceptions and are
never retried.
"""
from __future__ import annotations

import logging
import math
import os
import time

from . import metrics as _m
from ..telemetry.recorder import flight_recorder

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["GuardPolicy", "NonFiniteScoreError", "TrainingGuard"]


class GuardPolicy:
    WARN = "warn"
    SKIP_BATCH = "skip_batch"
    ROLLBACK = "rollback"
    HALT = "halt"

    ALL = (WARN, SKIP_BATCH, ROLLBACK, HALT)


class NonFiniteScoreError(RuntimeError):
    """Loss went NaN/Inf under the `halt` policy (or the guard gave up
    after `max_consecutive` non-finite steps in a row)."""


def _copy_val(v):
    """Deep copy for snapshot entries: tensors (in nested tuples, lists and
    dicts) are cloned on their device, torch generators copied with their
    state; python scalars pass through."""
    import torch
    if v is None or isinstance(v, (int, float, bool, str)):
        return v
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, torch.Generator):
        twin = torch.Generator(device=v.device)
        twin.set_state(v.get_state())
        return twin
    if isinstance(v, dict):
        return {k: _copy_val(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_copy_val(x) for x in v)
    return v


def _restore_val(cur, v):
    """The value to put back for a snapshot entry `v`: a generator takes the
    snapshot's state in place (a captured CUDA graph holds the generator
    it was captured with), anything else a fresh copy."""
    import torch
    if isinstance(cur, torch.Generator) and isinstance(v, torch.Generator):
        cur.set_state(v.get_state())
        return cur
    if (isinstance(cur, list) and isinstance(v, list) and len(cur) == len(v)
            and all(isinstance(g, torch.Generator) for g in cur + v)):
        return [_restore_val(c, x) for c, x in zip(cur, v)]
    return _copy_val(v)


class TrainingGuard:
    """Wraps the per-batch fit step of any model-like (MultiLayerNetwork,
    ComputationGraph — anything declaring `_fault_state_attrs`) with
    non-finite detection + snapshot/restore.

    Stateless across fits except the known-good snapshot and counters, so
    one guard can follow a model through several `fit` calls.
    """

    def __init__(self, policy: str = GuardPolicy.WARN, *,
                 refresh_every: int = 10, max_consecutive: int = 25,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, flight_dump_dir=None):
        if policy not in GuardPolicy.ALL:
            raise ValueError(f"unknown guard policy {policy!r}; choose from "
                             f"{GuardPolicy.ALL}")
        self.policy = policy
        # where the flight-recorder dump lands when the guard trips; None
        # keeps it in-memory only (recorder.last_dump / the HTTP debug
        # endpoint)
        self.flight_dump_dir = flight_dump_dir
        self.last_flight_dump = None
        self.refresh_every = max(1, int(refresh_every))
        self.max_consecutive = int(max_consecutive)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.nonfinite_steps = 0        # total seen (mirrors telemetry)
        self.skipped_batches = 0
        self._consecutive = 0
        self._good_streak = 0
        self._known_good = None

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    @staticmethod
    def _state_attrs(model):
        attrs = getattr(model, "_fault_state_attrs", None)
        if attrs is None:
            raise TypeError(
                f"{type(model).__name__} does not declare _fault_state_attrs"
                " — TrainingGuard cannot snapshot it")
        return attrs

    def _snapshot(self, model):
        return {a: _copy_val(getattr(model, a, None))
                for a in self._state_attrs(model)}

    def _restore(self, model, snap):
        for a, v in snap.items():
            setattr(model, a, _restore_val(getattr(model, a, None), v))
        # rollback rewinds counters like iteration_count, so any derived
        # state keyed on them would otherwise serve pre-rollback values at
        # a reused key; the model-like drops it (or, for the generators, copies
        # the restored states into its own)
        hook = getattr(model, "_fault_restored", None)
        if hook is not None:
            hook()

    # ------------------------------------------------------------------
    # per-batch stepping
    # ------------------------------------------------------------------
    @property
    def _needs_snapshot(self) -> bool:
        return self.policy in (GuardPolicy.SKIP_BATCH, GuardPolicy.ROLLBACK)

    def run_step(self, model, step_fn) -> bool:
        """Execute one training step (`step_fn()` mutates `model`) under
        the guard. Returns True if the step was kept, False if it was
        undone (skip_batch/rollback)."""
        snap = self._snapshot(model) if self._needs_snapshot else None
        if self.policy == GuardPolicy.ROLLBACK and self._known_good is None:
            self._known_good = snap
        step_fn()
        score = float(model._score)
        rec = flight_recorder()
        if rec.enabled:
            # the score is ALREADY host-materialized here (the guard's
            # sanctioned sync point) — recording it adds no device sync
            rec.record("train/step", score=score,
                       iteration=getattr(model, "iteration_count", None),
                       finite=math.isfinite(score))
        if math.isfinite(score):
            self._consecutive = 0
            self._good_streak += 1
            if (self.policy == GuardPolicy.ROLLBACK
                    and self._good_streak >= self.refresh_every):
                self._known_good = self._snapshot(model)
                self._good_streak = 0
            return True
        return self._handle_nonfinite(model, snap, score)

    def check_scores(self, model, scores, snap) -> bool:
        """Window-granular check for the window paths: `scores` is the
        host array of per-step losses a window (or a `fit_scan_arrays`
        epoch) produced, `snap` the pre-window snapshot (or None for
        warn/halt). Returns True to keep the window. Rollback works at
        window granularity here: the known-good snapshot refreshes every
        `refresh_every` finite windows, and a non-finite window with no
        known-good yet falls back to the pre-window snapshot."""
        import numpy as np
        host = np.asarray(scores, dtype=np.float64)
        bad = int((~np.isfinite(host)).sum())
        rec = flight_recorder()
        if rec.enabled and host.size:
            finite = host[np.isfinite(host)]
            rec.record("train/window_scores", n=int(host.size),
                       nonfinite=bad,
                       last=float(host[-1]),
                       lo=float(finite.min()) if finite.size else None,
                       hi=float(finite.max()) if finite.size else None)
        if bad == 0:
            self._consecutive = 0
            self._good_streak += 1
            if (self.policy == GuardPolicy.ROLLBACK
                    and self._good_streak >= self.refresh_every):
                self._known_good = self._snapshot(model)
                self._good_streak = 0
            return True
        if self.policy == GuardPolicy.ROLLBACK and self._known_good is None:
            self._known_good = snap
        return self._handle_nonfinite(model, snap, float("nan"), n=bad)

    def _dump_flightrecord(self, model, score, action: str):
        """Atomically freeze the flight-recorder ring the moment the guard
        trips, so the dump holds the failing step plus the events leading
        up to it (step scores, window scores). Stored on
        `recorder.last_dump` and, when `flight_dump_dir` is set, written
        to a timestamped JSON file."""
        rec = flight_recorder()
        if not rec.enabled:
            return None
        path = None
        if self.flight_dump_dir is not None:
            os.makedirs(self.flight_dump_dir, exist_ok=True)
            path = os.path.join(
                self.flight_dump_dir,
                f"flightrecord-{action}-{int(time.time() * 1000)}.json")
        doc = rec.dump(reason=f"guard/{action}", path=path, extra={
            "policy": self.policy,
            "score": score,
            "iteration": getattr(model, "iteration_count", None),
            "nonfinite_steps": self.nonfinite_steps,
            "consecutive": self._consecutive,
        })
        self.last_flight_dump = doc
        return doc

    def _handle_nonfinite(self, model, snap, score, n: int = 1) -> bool:
        self.nonfinite_steps += n
        _m.count_nonfinite(self.policy, n)
        self._consecutive += 1
        self._good_streak = 0
        if self._consecutive > self.max_consecutive:
            self._dump_flightrecord(model, score, "circuit_breaker")
            raise NonFiniteScoreError(
                f"{self._consecutive} consecutive non-finite training steps "
                f"under policy={self.policy!r} — data or learning rate is "
                "systematically bad, refusing to spin")
        if self.policy == GuardPolicy.HALT:
            self._dump_flightrecord(model, score, "halt")
            raise NonFiniteScoreError(
                f"training loss went non-finite ({score}) at iteration "
                f"{getattr(model, 'iteration_count', '?')} (policy=halt)")
        if self.policy == GuardPolicy.WARN:
            log.warning(
                "non-finite training loss (%s) at iteration %s kept under "
                "policy=warn — params may now be poisoned; consider "
                "skip_batch/rollback", score,
                getattr(model, "iteration_count", "?"))
            return True
        if self.policy == GuardPolicy.SKIP_BATCH:
            self._dump_flightrecord(model, score, "skip_batch")
            self._restore(model, snap)
            self.skipped_batches += 1
            _m.count_rollback(self.policy)
            log.warning(
                "non-finite training loss (%s) — batch skipped, state "
                "restored to pre-batch snapshot (policy=skip_batch)", score)
            return False
        # ROLLBACK
        self._dump_flightrecord(model, score, "rollback")
        self._restore(model, self._known_good)
        self.skipped_batches += 1
        _m.count_rollback(self.policy)
        log.warning(
            "non-finite training loss (%s) — rolled back to last known-good "
            "snapshot at iteration %s (policy=rollback)", score,
            getattr(model, "iteration_count", "?"))
        return False

    def note_skipped_micros(self, model, n: int):
        """Accumulated-step skip accounting (nn/superstep.py): under
        policy=skip_batch with grad_accumulation>1 a non-finite MICROBATCH
        loss is neutralized inside the step — its gradient zeroed, the
        accumulated mean renormalized over the finite microbatches — so
        the optimizer step itself survives and no snapshot restore runs.
        This only records that `n` microbatch contributions were dropped
        (counters + telemetry + one warning); the consecutive-step circuit
        breaker is untouched because the STEP was finite."""
        n = int(n)
        if n <= 0:
            return
        self.nonfinite_steps += n
        self.skipped_batches += n
        _m.count_nonfinite(self.policy, n)
        log.warning(
            "%d non-finite microbatch loss(es) near iteration %s — "
            "gradient contribution(s) zeroed, accumulated step "
            "renormalized over the finite microbatches "
            "(policy=skip_batch, grad_accumulation)", n,
            getattr(model, "iteration_count", "?"))

    # ------------------------------------------------------------------
    # transient-error retry around the data source
    # ------------------------------------------------------------------
    def next_batch(self, iterator):
        """iterator.next() with bounded exponential-backoff retry on
        transient errors. StopIteration propagates (not a fault);
        BaseExceptions (SimulatedCrash, KeyboardInterrupt) are never
        retried."""
        attempt = 0
        while True:
            try:
                return iterator.next()
            except StopIteration:
                raise
            except Exception as e:
                attempt += 1
                _m.count_retry("iterator")
                if attempt > self.max_retries:
                    log.error(
                        "data source still failing after %d retries: %s",
                        self.max_retries, e)
                    raise
                delay = min(self.backoff_s * (2 ** (attempt - 1)),
                            self.backoff_max_s)
                log.warning(
                    "transient data-source error (%s: %s) — retry %d/%d "
                    "in %.3fs", type(e).__name__, e, attempt,
                    self.max_retries, delay)
                time.sleep(delay)
