"""Auto-resume plumbing: checkpoint stores + the fit-loop checkpointer (the
port of `deeplearning4j_tpu/fault/resume.py`, on the port's zip).

`CheckpointManager` keeps a directory of crash-safe ModelSerializer zips
(`ckpt_<iteration>.zip`); a file's existence IS its commit (the atomic
rename in util/serializer.py), so `restore_latest` only ever sees complete
files, and still verifies the sha256 manifest and falls back to the next
older checkpoint if one fails.

`FitCheckpointer` is the piece the fit loops talk to: interval saves keyed
on iteration count, resume bookkeeping (how many epochs completed, how
many batches into the current epoch, which shuffle-epoch the iterator must
replay), and a SIGTERM handler that snapshots before exit so a preemption
behaves like a planned checkpoint. Resume restores params, optimizer
state, layer state, iteration/epoch counters AND the states of the
model's dropout generators, so a resumed fit replays the identical batch
order and dropout draws — the resumed run matches an uninterrupted one.

The zip is the JAX package's, so a checkpoint directory written by either
package resumes in the other (a generator state, or JAX's PRNG key, is
restored only by the package and device kind that wrote it: dropout
streams do not cross). The sharded store of the parallel trainer comes
with ROADMAP A11.
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import zipfile
from typing import Dict, List, Optional, Tuple

from .atomic import CorruptCheckpointError

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["CheckpointManager", "FitCheckpointer", "maybe_fit_checkpointer",
           "sharded_fit_checkpointer"]

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.zip$")


class CheckpointManager:
    """Directory of crash-safe single-host checkpoints with retention.

    Retention keeps the newest `keep` checkpoints plus (with `keep_best`)
    the one with the best (lowest) recorded score — the reference's
    "best model" idea applied at the checkpoint layer, so a long run can
    always get back both "latest" and "best so far"."""

    def __init__(self, directory: str, keep: int = 3, keep_best: bool = True):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        self.keep_best = bool(keep_best)
        os.makedirs(self.directory, exist_ok=True)
        self._scores: Dict[str, Optional[float]] = {}

    def _path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"ckpt_{iteration:09d}.zip")

    def entries(self) -> List[Tuple[int, str]]:
        """(iteration, path) ascending — non-matching names (stray files,
        in-flight temp files) are ignored, never crashed on."""
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    # ------------------------------------------------------------------
    def save(self, model, score: Optional[float] = None,
             extra: Optional[Dict] = None) -> str:
        from ..util.serializer import ModelSerializer

        path = self._path(model.iteration_count)
        meta = dict(extra or {})
        if score is not None:
            meta["score"] = float(score)
        ModelSerializer.write_model(model, path, extra_meta=meta)
        self._scores[os.path.basename(path)] = score
        self._gc()
        return path

    def restore_latest(self, model) -> Optional[Dict]:
        """Restore the newest verifiable checkpoint into `model` (params,
        state, updater state, counters, RNG). Corrupt/unverifiable files
        are skipped with a warning — the last good one wins. Returns its
        metadata dict, or None when no usable checkpoint exists."""
        from ..util.serializer import ModelSerializer

        for it, path in reversed(self.entries()):
            try:
                meta = ModelSerializer.restore_into(model, path)
                log.info("resumed from checkpoint %s (iteration %d)",
                         path, it)
                return meta
            except (CorruptCheckpointError, OSError, KeyError,
                    ValueError, zipfile.BadZipFile) as e:
                log.warning("checkpoint %s unusable (%s: %s) — falling "
                            "back to an older one", path,
                            type(e).__name__, e)
        return None

    def _score_of(self, path: str) -> Optional[float]:
        name = os.path.basename(path)
        if name in self._scores:
            return self._scores[name]
        score = None
        try:
            with zipfile.ZipFile(path) as z:
                meta = json.loads(z.read("metadata.json").decode())
            s = meta.get("score")
            score = float(s) if s is not None else None
        except Exception:
            pass
        self._scores[name] = score
        return score

    def _gc(self):
        entries = self.entries()
        keep_paths = {p for _, p in entries[-self.keep:]}
        if self.keep_best:
            scored = [(self._score_of(p), p) for _, p in entries]
            scored = [(s, p) for s, p in scored
                      if s is not None and math.isfinite(s)]
            if scored:
                keep_paths.add(min(scored)[1])
        for _, p in entries:
            if p not in keep_paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass
                self._scores.pop(os.path.basename(p), None)
        # sweep temp files from crashed writes (single-writer directory)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp") and name.startswith("."):
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass


# ----------------------------------------------------------------------
# stores: the two backends FitCheckpointer can save through
# ----------------------------------------------------------------------

class _ZipModelStore:
    """Single-host store: the model itself through CheckpointManager."""

    kind = "zip"

    def __init__(self, model, directory: str, keep: int = 3):
        self.model = model
        self.manager = CheckpointManager(directory, keep=keep)

    def iteration(self) -> int:
        return self.model.iteration_count

    def _score(self) -> Optional[float]:
        try:
            s = float(self.model._score)
            return s if math.isfinite(s) else None
        except Exception:
            return None

    def save(self, extra: Dict):
        self.manager.save(self.model, score=self._score(), extra=extra)

    def restore(self) -> Optional[Dict]:
        return self.manager.restore_latest(self.model)


def _sharded_not_in_port():
    return NotImplementedError(
        "the sharded checkpoint store of the parallel trainer is not in "
        "the PyTorch port yet (ROADMAP A11)")


class _ShardedTrainerStore:
    """Mesh store of the parallel trainer (ROADMAP A11)."""

    kind = "sharded"

    def __init__(self, trainer, directory: str, keep: int = 3):
        raise _sharded_not_in_port()


# ----------------------------------------------------------------------
# the fit-loop checkpointer
# ----------------------------------------------------------------------

class FitCheckpointer:
    """Interval checkpointing + resume bookkeeping for one fit() call.

    The fit loop drives it:
        skip, done = ckpt.resume_into(iterator)     # before the epoch loop
        ...for each trained batch:  ckpt.on_batch()
        ...after each epoch:        ckpt.on_epoch()
        ...after the last epoch:    ckpt.on_fit_end()
    wrapped in `with ckpt.sigterm_snapshot(): ...` so a preemption SIGTERM
    saves a snapshot before the process exits.

    Saved metadata records (epoch_in_fit, batches_into_epoch): resume
    skips the already-trained prefix of the current epoch after
    positioning the iterator's shuffle epoch (`set_epoch`), so the
    resumed run consumes exactly the batches the uninterrupted run would
    have."""

    def __init__(self, store, every: int = 0, resume: bool = False,
                 context: Optional[Dict] = None):
        self.store = store
        self.every = max(0, int(every))
        self.resume = bool(resume)
        # fit-call context recorded into every save's metadata — knobs
        # that are part of the TRAINING MATH (grad_accumulation) so a
        # resume with different values can warn instead of silently
        # diverging from the uninterrupted run
        self.context = dict(context or {})
        self._epoch_in_fit = 0
        self._batches = 0
        self._last_saved_iter = store.iteration()
        self._sigterm_pending = False
        self._sigterm_prev = None

    # ------------------------------------------------------------------
    def resume_into(self, iterator=None) -> Tuple[int, int]:
        """Restore the newest checkpoint (when `resume=True`). Returns
        (batches_to_skip, epochs_already_done); (0, 0) when starting
        fresh."""
        if not self.resume:
            return 0, 0
        meta = self.store.restore()
        if meta is None:
            return 0, 0
        stored_m = meta.get("grad_accumulation")
        cur_m = self.context.get("grad_accumulation")
        if (stored_m is not None and cur_m is not None
                and int(stored_m) != int(cur_m)):
            log.warning(
                "resuming with grad_accumulation=%s but the checkpoint "
                "was written with grad_accumulation=%s — accumulation is "
                "part of the training MATH (unlike superstep grouping), "
                "so the resumed run will not match the uninterrupted one",
                cur_m, stored_m)
        # precision/remat policy mismatches: compute_dtype
        # changes the training math; remat/remat_policy only the
        # memory/recompute profile (numerics no-ops) — warn accordingly
        stored_cdt = meta.get("compute_dtype")
        cur_cdt = self.context.get("compute_dtype")
        if ("compute_dtype" in meta and "compute_dtype" in self.context
                and stored_cdt != cur_cdt):
            log.warning(
                "resuming with compute_dtype=%s but the checkpoint was "
                "written with compute_dtype=%s — the compute precision is "
                "part of the training MATH, so the resumed run will not "
                "match the uninterrupted one", cur_cdt, stored_cdt)
        for key in ("remat", "remat_policy"):
            if key in meta and key in self.context \
                    and meta.get(key) != self.context.get(key):
                log.warning(
                    "resuming with %s=%s but the checkpoint was written "
                    "with %s=%s — rematerialization is a numerics no-op "
                    "(memory/recompute profile only), training math is "
                    "unchanged", key, self.context.get(key), key,
                    meta.get(key))
        done = int(meta.get("epoch_in_fit", 0))
        skip = int(meta.get("batches_into_epoch", 0))
        self._epoch_in_fit = done
        self._batches = skip
        self._last_saved_iter = self.store.iteration()
        if iterator is not None and (done or skip):
            if hasattr(iterator, "set_epoch"):
                iterator.set_epoch(done)
            elif getattr(iterator, "shuffle", False):
                log.warning(
                    "resuming a shuffled iterator (%s) without set_epoch() "
                    "support — the replayed epoch may use a different "
                    "permutation than the interrupted run",
                    type(iterator).__name__)
        return skip, done

    # ------------------------------------------------------------------
    def save(self, reason: str = "interval"):
        extra = dict(self.context)
        extra.update({"epoch_in_fit": self._epoch_in_fit,
                      "batches_into_epoch": self._batches,
                      "reason": reason})
        self.store.save(extra)
        self._last_saved_iter = self.store.iteration()

    def maybe_save(self):
        """Interval save keyed on the store's iteration count."""
        if (self.every
                and self.store.iteration() - self._last_saved_iter
                >= self.every):
            self.save()

    def on_batch(self):
        self.on_batches(1)

    def on_batches(self, n: int):
        """Advance the batch cursor by a whole superstep window (n trained
        batches) and act at the window EDGE: any deferred SIGTERM snapshot
        and any due interval save fire here — the first boundary where the
        model's state and the recorded `batches_into_epoch` agree. A
        `checkpoint_every=` cadence therefore rounds up to superstep
        edges; resume composes with any window length because window
        grouping never changes the per-batch math (see nn/superstep.py)."""
        self._batches += int(n)
        self._flush_sigterm()
        self.maybe_save()

    def on_epoch(self):
        self._epoch_in_fit += 1
        self._batches = 0
        self._flush_sigterm()

    def on_fit_end(self):
        self.save(reason="fit_end")

    # ------------------------------------------------------------------
    def _flush_sigterm(self):
        """Act on a deferred SIGTERM at a consistent batch/epoch boundary:
        snapshot, then honor the previous disposition (ignore, chain, or
        exit 143)."""
        import signal

        if not self._sigterm_pending:
            return
        self._sigterm_pending = False
        prev = self._sigterm_prev
        log.warning("SIGTERM received — snapshotting checkpoint at the "
                    "batch boundary before exit")
        self.save(reason="sigterm")
        if prev is signal.SIG_IGN:
            return   # the app chose to ignore SIGTERM; honor that
        if callable(prev) and prev is not signal.SIG_DFL:
            prev(signal.SIGTERM, None)
            return
        raise SystemExit(143)

    @contextlib.contextmanager
    def sigterm_snapshot(self):
        """Install a SIGTERM handler that checkpoints before exiting —
        cluster preemptions (k8s, borg, spot VMs) send SIGTERM with a
        grace window; the snapshot turns them into planned resume points.
        The handler only sets a flag; the save happens at the next
        batch/epoch boundary (or at fit exit), so a signal landing
        mid-train-step can never snapshot torn half-updated state.
        Main-thread only (signal module restriction); elsewhere a no-op."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            yield
            return
        prev = signal.getsignal(signal.SIGTERM)
        self._sigterm_prev = prev

        def handler(signum, frame):
            log.warning("SIGTERM received — checkpoint snapshot deferred "
                        "to the next batch boundary")
            self._sigterm_pending = True

        signal.signal(signal.SIGTERM, handler)
        try:
            yield
            # a signal after the last boundary still gets its snapshot
            self._flush_sigterm()
        finally:
            self._sigterm_pending = False
            signal.signal(signal.SIGTERM, prev)


def maybe_fit_checkpointer(model, checkpoint_dir: Optional[str],
                           checkpoint_every: int, resume: bool,
                           keep: int = 3, context: Optional[Dict] = None
                           ) -> Optional[FitCheckpointer]:
    """Build the zip-backed checkpointer for a model fit, or None when
    checkpointing is off. Actionable error on inconsistent knobs."""
    if checkpoint_dir is None:
        if resume or checkpoint_every:
            raise ValueError(
                "resume=True / checkpoint_every need checkpoint_dir= "
                "(the directory checkpoints live in)")
        return None
    return FitCheckpointer(_ZipModelStore(model, checkpoint_dir, keep=keep),
                           every=checkpoint_every, resume=resume,
                           context=context)


def sharded_fit_checkpointer(trainer, checkpoint_dir: Optional[str],
                             checkpoint_every: int, resume: bool,
                             keep: int = 3, context: Optional[Dict] = None
                             ) -> Optional[FitCheckpointer]:
    """Sharded checkpointer for parallel-trainer fits (ROADMAP A11)."""
    raise _sharded_not_in_port()
