"""Windows of training steps: `fit(superstep=K)`, gradient accumulation,
and the CUDA graphs that run them on the card. The port of
`deeplearning4j_tpu/nn/superstep.py`.

JAX runs a window of K batches as one jitted `lax.scan` of the train step,
so the host dispatches once per K batches. The port's analog is a CUDA
graph: on the card, one optimizer step is captured once per batch
signature (`CapturedStep`) and a window is K replays of it, each reading
its batch from static input buffers, its step-dependent scalars (Adam's
bias-corrected step size, the scheduled lr, the bias-lr rescale; see
`nn/updaters.py`) from a static row of a per-window table, and writing
its parameters, updater state and layer state back into the static
carries it read them from. The host enqueues the K replays and reads the
window's K scores once, at the window's edge. One capture serves every
window length, so `"epoch"` costs no larger graph.

On the CPU a window runs the same step eagerly K times: the plain version,
which the tier-1 tests hold against JAX. On the card a window runs as
replays and nothing else: if the step cannot be captured, `fit` raises
`CaptureError` naming what failed, and never falls back to an eager loop.
The per-batch paths are JAX's own: `superstep=1` (one eager step a batch,
with the same tensor scalars as a replay), TBPTT under `fit`, and the
line-search optimizers.

Per-batch semantics are kept as JAX keeps them:

  * **Bit-exactness.** A replay runs the kernels of the eager step on the
    same inputs, and the dropout generators are registered with the graph,
    so each replay advances their Philox offsets exactly as an eager step
    does: `superstep=K` gives the bits of `superstep=1` for any grouping.
  * **Ragged tails.** Windows never mix batch signatures: a ragged final
    batch (or a `time_buckets` change) closes the window and opens the
    next one, with a capture of its own. `pad_ragged=True` keeps the epoch
    to one signature.
  * **Listeners** replay at the window's edge with the window's scores
    already on the host: every `iteration_done` sees a host scalar in
    `model._score` (and parameters as they are at the end of the window:
    the `warn_scan_replay` caveat).
  * **TrainingGuard** checks the window's K scores at its edge;
    skip_batch / rollback restore the pre-window snapshot, a clone taken
    before the replays (the replays update the model's tensors in place).
  * **Checkpoints / SIGTERM** fire at window edges
    (`FitCheckpointer.on_batches`). Resume composes with any K.

Gradient accumulation (`grad_accumulation=M`): M consecutive iterator
microbatches per optimizer step — forward and backward per microbatch,
gradients summed in float32 accumulators, one update on their mean. A
window holds K·M microbatches. On the card two graphs are captured per
signature, a microbatch step (gradients into the accumulators) and the
update, replayed M times and once per optimizer step; a ragged group of
m < M microbatches replays the first m times, so it needs no capture of
its own.

The host reads the model's tensors (listeners, checkpoints,
`params_flat`) only at window edges, after the window's scores have come
to the host, which synchronises the card.
"""
from __future__ import annotations

import contextlib
import gc
import logging
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from .trees import flatten_tree, tree_map
from ..telemetry.recorder import flight_recorder
from ..telemetry.runtime import active as _tel_active, null_span as _null_span

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["AUTO_WINDOW_BYTES", "AUTO_MAX_K", "AUTO_ADAPT_MAX_K",
           "AUTO_DISPATCH_SHARE", "EPOCH", "auto_superstep_k",
           "validate_superstep", "validate_grad_accumulation",
           "accum_skip_nonfinite", "build_superstep",
           "build_accum_superstep", "dispatch_accum_groups",
           "split_accum_groups", "steps_in", "OverlapAutoK",
           "SuperstepRunner", "CapturedStep", "CaptureError",
           "run_window", "run_tbptt_window"]

#: `superstep="auto"` sizes the window so its staged footprint stays near
#: this budget
AUTO_WINDOW_BYTES = 64 << 20
AUTO_MAX_K = 32
#: overlap-aware `superstep="auto"` may grow K past the byte-budget seed
#: while the measured dispatch share stays above target, up to this
AUTO_ADAPT_MAX_K = 256
#: byte ceiling of a grown window (two windows are staged at once under
#: the pipelined loop)
AUTO_ADAPT_WINDOW_BYTES = AUTO_WINDOW_BYTES * 8
#: target host-dispatch share of the window period for the overlap-aware
#: auto-K: above it, K doubles
AUTO_DISPATCH_SHARE = 0.10
#: `superstep="epoch"`: the window is bounded only by the epoch (and by
#: signature changes)
EPOCH = "epoch"


class CaptureError(RuntimeError):
    """A training step could not be captured as a CUDA graph. The card
    runs windows as graph replays only, so `fit` raises this rather than
    fall back to an eager loop."""


def auto_superstep_k(batch_bytes: int,
                     target_bytes: int = AUTO_WINDOW_BYTES,
                     max_k: int = AUTO_MAX_K) -> int:
    """Window length for `superstep="auto"`: as many batches as fit the
    byte budget, clamped to [1, max_k]."""
    if batch_bytes <= 0:
        return int(max_k)
    return max(1, min(int(max_k), int(target_bytes // batch_bytes)))


def validate_superstep(superstep):
    """Normalize the `superstep=` knob: a positive int, "auto", or
    "epoch". Returns the normalized value (ints coerced)."""
    if superstep in ("auto", EPOCH):
        return superstep
    try:
        k = int(superstep)
    except (TypeError, ValueError):
        k = 0
    if k < 1 or (not isinstance(superstep, (int, np.integer))):
        raise ValueError(
            f"superstep={superstep!r} — expected a positive int (window "
            "length in batches; 1 = per-batch dispatch), 'auto' (size the "
            "window from batch bytes) or 'epoch' (one window per epoch)")
    return k


def validate_grad_accumulation(m):
    """Normalize the `grad_accumulation=` knob: a positive int (number of
    microbatches accumulated per optimizer step; 1 = classic one batch =
    one step)."""
    try:
        mi = int(m)
    except (TypeError, ValueError):
        mi = 0
    if mi < 1 or (not isinstance(m, (int, np.integer))):
        raise ValueError(
            f"grad_accumulation={m!r} — expected a positive int: the number "
            "of consecutive iterator microbatches whose gradients accumulate "
            "into one optimizer step (1 = no accumulation)")
    return mi


def accum_skip_nonfinite(guard, m) -> bool:
    """True when the accumulated step must neutralize non-finite
    microbatches inside the step: under `GuardPolicy.SKIP_BATCH` a bad
    microbatch loss zeroes only that microbatch's gradient and the mean
    renormalizes over the finite ones. Other policies keep the per-step
    semantics: the NaN propagates into the step score and the guard
    handles the whole step."""
    return (m > 1 and guard is not None
            and getattr(guard, "policy", None) == "skip_batch")


def steps_in(n_micro: int, m: int) -> int:
    """Optimizer steps a window of `n_micro` microbatches trains under
    grad_accumulation=m: full M-groups plus one renormalized step for any
    remainder."""
    q, r = divmod(int(n_micro), int(m))
    return q + (1 if r else 0)


def split_accum_groups(staged, n_micro: int, m: int):
    """Split a staged window (a list of `n_micro` batches) into
    accumulation groups: q full groups of M, plus a remainder group of
    r < M microbatches (an epoch tail, or a signature change that closed
    the group early) that trains as ONE optimizer step renormalized over
    its r microbatches. Returns [(groups, n_steps, m_eff), ...], `groups`
    a list of lists of batches."""
    q, r = divmod(int(n_micro), int(m))
    parts = []
    if q:
        parts.append(([staged[i * m:(i + 1) * m] for i in range(q)], q, m))
    if r:
        parts.append(([staged[q * m:n_micro]], 1, r))
    return parts


def dispatch_accum_groups(staged, n_micro: int, m: int, step0: int,
                          run_group):
    """Drive a staged window through the accumulated step one part at a
    time (see `split_accum_groups`): `run_group(groups, step0)` trains the
    part's optimizer steps and returns their (scores[q], micro_scores[q,
    m']) tensors. Returns the parts in step order."""
    parts, step = [], int(step0)
    for groups, q, _m_eff in split_accum_groups(staged, n_micro, m):
        parts.append(run_group(groups, step))
        step += q
    return parts


# ----------------------------------------------------------------------
# The plain versions: one window of eager steps
# ----------------------------------------------------------------------
def build_superstep(step_fn):
    """The plain superstep: `step_fn(params, state, opt, step, batch) ->
    (params, state, opt, score)` K times over a window (a list of
    batches), the step counter advancing per batch. Returns
    `superstep(params, state, opt, step0, window) -> (params, state, opt,
    scores[K])`. The model's dropout generators advance inside `step_fn`,
    in batch order, exactly as the per-batch loop draws them."""
    def superstep(params, state, opt_state, step0, window):
        scores = []
        for i, batch in enumerate(window):
            params, state, opt_state, score = step_fn(
                params, state, opt_state, int(step0) + i, batch)
            scores.append(score.reshape(()).float())
        return params, state, opt_state, torch.stack(scores)

    return superstep


def build_accum_superstep(grad_fn, update_fn, skip_nonfinite: bool = False):
    """The plain ACCUMULATED superstep: for each group of M microbatches,
    `grad_fn(params, state, batch) -> (score, new_state, grads)` per
    microbatch with the gradients summed in float32, then
    `update_fn(params, grads_mean, opt, step) -> (params, opt)` once.

    Semantics (JAX's):
      * the update sees the float32 sum divided by the count, cast back to
        each parameter's dtype; any (K, M) regrouping of the same
        microbatch sequence gives identical bits;
      * the dropout generators advance per microbatch, the step counter
        per optimizer step;
      * with `skip_nonfinite`, a non-finite microbatch loss contributes a
        zero gradient and leaves the layer state as it was, and drops out
        of the denominator; the step score averages the finite
        microbatches (NaN when none was finite).

    Returns `superstep(params, state, opt, step0, groups) -> (params,
    state, opt, scores[K], micro_scores[K, M])`."""
    def superstep(params, state, opt_state, step0, groups):
        scores, micro = [], []
        for k, group in enumerate(groups):
            acc = n_ok = ssum = None
            mscores = []
            for batch in group:
                score, new_state, grads = grad_fn(params, state, batch)
                acc, n_ok, ssum, state = accumulate(
                    acc, n_ok, ssum, state, score, new_state, grads,
                    skip_nonfinite)
                mscores.append(score.reshape(()).float())
            params, opt_state, score = finish_accumulation(
                update_fn, params, opt_state, acc, n_ok, ssum,
                int(step0) + k)
            scores.append(score)
            micro.append(torch.stack(mscores))
        return (params, state, opt_state, torch.stack(scores),
                torch.stack(micro))

    return superstep


def accumulate(acc, n_ok, ssum, state, score, new_state, grads,
               skip_nonfinite):
    """One microbatch into the float32 accumulators (None: the first).
    Returns (acc, n_ok, ssum, state)."""
    f32 = torch.float32
    score = score.reshape(()).float()
    if acc is None:
        acc = tree_map(lambda g: torch.zeros(g.shape, dtype=f32,
                                             device=g.device), grads)
        n_ok = torch.zeros((), dtype=f32, device=score.device)
        ssum = torch.zeros((), dtype=f32, device=score.device)
    if skip_nonfinite:
        # select, never multiply: 0 * NaN is NaN
        ok = torch.isfinite(score)
        acc = tree_map(lambda a, g: a + torch.where(
            ok, g.to(f32), torch.zeros((), dtype=f32, device=g.device)),
            acc, grads)
        state = tree_map(lambda o, n: torch.where(ok, n, o), state,
                         new_state)
        n_ok = n_ok + ok.to(f32)
        ssum = ssum + torch.where(ok, score, torch.zeros_like(score))
    else:
        acc = tree_map(lambda a, g: a + g.to(f32), acc, grads)
        state = new_state
        n_ok = n_ok + 1.0
        ssum = ssum + score
    return acc, n_ok, ssum, state


def finish_accumulation(update_fn, params, opt_state, acc, n_ok, ssum, step):
    """The update on the accumulated mean; returns (params, opt, step
    score), the score NaN when no microbatch was finite."""
    denom = torch.clamp(n_ok, min=1.0)
    gmean = tree_map(lambda a, p: (a / denom).to(p.dtype), acc, params)
    params, opt_state = update_fn(params, gmean, opt_state, step)
    score = torch.where(n_ok > 0, ssum / denom,
                        torch.full((), float("nan"), device=ssum.device))
    return params, opt_state, score


# ----------------------------------------------------------------------
# The card: one optimizer step captured as a CUDA graph
# ----------------------------------------------------------------------
def _cuda_graph():
    return torch.cuda.CUDAGraph()


def _captures(model) -> bool:
    """Whether the model's windows run as captured graphs: on a CUDA
    device, always."""
    return model.device.type == "cuda"


@contextlib.contextmanager
def _sync_errors():
    """Raise on any synchronizing CUDA call inside (a probe of the step
    before its capture: a host sync is what capture cannot hold)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Graph:
    """One CUDA graph of `commit(compute())`. `compute` reads only tensors
    that exist before the capture (the statics) and returns new ones;
    `commit` copies what must persist into statics. The warm-up runs
    `compute` alone on a side stream (so nothing persists); the dropout
    generators' states are put back after it and registered with the
    graph. The warm-up's and the capture's kernel launches go to a
    `kernels.tally()` instead of the counters, and the capture's are added
    to the counters at every replay.

    What the capture claims is the process (the training step: its
    backward launches on autograd's device thread), or, with
    `thread_local=True`, this thread alone (the decode plane captures a new
    version's ticks while other threads serve the old one). The scope sets
    the tally's, the capture's error mode, and where a host sync inside
    `compute` is caught: by `_sync_errors` in the warm-up, which is
    process-wide, or by the capture itself. `mempool` shares one memory
    pool between graphs that replay one after another."""

    def __init__(self, name, compute, commit, device, generators=(),
                 thread_local=False, mempool=None):
        from .. import kernels
        self.name = name
        gens = list(generators)
        states = [g.get_state() for g in gens]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        probe = contextlib.nullcontext() if thread_local else _sync_errors()
        # no cyclic collection while capturing: a collected model's graphs
        # would be destroyed mid-capture, which invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            try:
                with kernels.tally(all_threads=not thread_local), \
                        torch.cuda.stream(side):
                    with probe:
                        outs = compute()
                    del outs
                cur.wait_stream(side)
                side.synchronize()
            except Exception as e:
                raise CaptureError(
                    f"{name}: the step cannot be captured as a CUDA graph; "
                    f"its warm-up failed at: {type(e).__name__}: {e}") from e
            finally:
                for g, s in zip(gens, states):
                    g.set_state(s)
            self.graph = _cuda_graph()
            try:
                for g in gens:
                    self.graph.register_generator_state(g)
                with kernels.tally(all_threads=not thread_local) as launched:
                    with torch.cuda.graph(
                            self.graph, pool=mempool,
                            capture_error_mode=("thread_local" if thread_local
                                                else "global")):
                        commit(compute())
            except Exception as e:
                raise CaptureError(
                    f"{name}: capturing the step as a CUDA graph failed at: "
                    f"{type(e).__name__}: {e}") from e
            self.launches = kernels.tally_delta(launched)
        finally:
            if collecting:
                gc.enable()

    def replay(self):
        from .. import kernels
        self.graph.replay()
        kernels.add_counts(self.launches)


class CapturedStep:
    """One optimizer step (or, with `accumulate`, a microbatch's gradient
    step and the update) captured as CUDA graphs for one batch signature.

    `model` exposes the pure halves of its training step:
    `_grad_fn(params, state, batch, carries) -> (score, new_state, grads,
    new_carries)`, `_update_fn(params, grads, opt, sc) -> (params, opt)`
    with `sc` the step's scalar row, `_dropout_generators()`, and
    `_carry_trees()` / `_set_carry_trees(params, state, opt)`.

    The statics: the batch's tensors, the scalar row, the carries (a
    clone of the model's parameters, layer state and updater state, which
    the model is then bound to: the replays update them in place), the
    recurrent carries of a TBPTT chunk step (`rnn_carries`), the float32
    accumulators, and the step's score."""

    def __init__(self, model, name, batch, n_scalars, *, rnn_carries=None,
                 accumulate=False, skip_nonfinite=False):
        dev = model.device
        # the model holds its captures: a weak reference back keeps the
        # pair out of a reference cycle, so its graphs are freed with it
        self._model = weakref.ref(model)
        self.name = name
        self.generators = list(model._dropout_generators())
        in_leaves, self._rebuild_batch = flatten_tree(batch)
        self.static_in = [None if a is None else a.detach().clone()
                          for a in in_leaves]
        self.static_sc = torch.zeros(max(1, n_scalars), dtype=torch.float32,
                                     device=dev)
        trees = model._carry_trees()
        leaves, self._rebuild_trees = flatten_tree(trees)
        for v in leaves:
            if not isinstance(v, torch.Tensor):
                raise CaptureError(
                    f"{name}: a parameter, layer-state or updater-state "
                    f"leaf is a {type(v).__name__}, not a tensor; the step "
                    "cannot be captured")
        self.carries = [v.detach().clone() for v in leaves]
        self.rnn = (None if rnn_carries is None else
                    flatten_tree(rnn_carries))
        self.rnn_static = (None if self.rnn is None else
                           [None if c is None else c.detach().clone()
                            for c in self.rnn[0]])
        self.score = torch.zeros((), dtype=torch.float32, device=dev)
        self.accumulate = bool(accumulate)
        self.bind()
        t0 = time.perf_counter()
        if not self.accumulate:
            self.graphs = [_Graph(name, self._compute_step,
                                  self._commit_step, dev, self.generators)]
        else:
            self.skip_nonfinite = bool(skip_nonfinite)
            # the gradients have the parameters' tree and shapes, or the
            # model's own template's (a ZERO2 trainer reduces them to its
            # shard)
            hook = getattr(model, "_grad_template", None)
            tmpl = hook() if hook is not None else None
            p_leaves, self._rebuild_grads = flatten_tree(
                self._trees()[0] if tmpl is None else tmpl)
            self.acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                        for p in p_leaves]
            self.n_ok = torch.zeros((), dtype=torch.float32, device=dev)
            self.ssum = torch.zeros((), dtype=torch.float32, device=dev)
            self.step_score = torch.zeros((), dtype=torch.float32,
                                          device=dev)
            self.graphs = [
                _Graph(name + "/micro", self._compute_micro,
                       self._commit_micro, dev, self.generators),
                _Graph(name + "/update", self._compute_update,
                       self._commit_update, dev, self.generators)]
        self.capture_s = time.perf_counter() - t0
        tel = _tel_active()
        if tel is not None:
            tel.compiles.record_capture(name, self.capture_s)

    @property
    def model(self):
        return self._model()

    # -- binding the model to the statics --------------------------------
    def bind(self):
        """Make the model's parameters, layer state and updater state the
        graph's carries: copy in whatever the model holds now where it is
        not already the carry (a first window, a rollback, a resume, an
        eager step in between), then point the model at the carries."""
        leaves, _ = flatten_tree(self.model._carry_trees())
        with torch.no_grad():
            for c, v in zip(self.carries, leaves):
                if v is not c:
                    c.copy_(v)
        self.model._set_carry_trees(*self._rebuild_trees(self.carries))

    def _trees(self):
        return self._rebuild_trees(self.carries)

    def _batch(self):
        return self._rebuild_batch(self.static_in)

    def _rnn_in(self):
        return None if self.rnn is None else self.rnn[1](self.rnn_static)

    # -- the plain step -----------------------------------------------------
    def _compute_step(self):
        params, state, opt = self._trees()
        score, new_state, grads, new_rnn = self.model._grad_fn(
            params, state, self._batch(), self._rnn_in())
        new_params, new_opt = self.model._update_fn(params, grads, opt,
                                                    self.static_sc)
        return (flatten_tree((new_params, new_state, new_opt))[0], score,
                None if new_rnn is None else flatten_tree(new_rnn)[0])

    def _commit_step(self, outs):
        new, score, new_rnn = outs
        for c, v in zip(self.carries, new):
            if v is not c:
                c.copy_(v)
        self.score.copy_(score.reshape(()).float())
        if new_rnn is not None:
            for c, v in zip(self.rnn_static, new_rnn):
                if c is not None:
                    c.copy_(v)

    # -- the accumulated step: microbatch, then update ----------------------
    def _compute_micro(self):
        params, state, _ = self._trees()
        score, new_state, grads, _ = self.model._grad_fn(
            params, state, self._batch(), None)
        acc, n_ok, ssum, state = accumulate(
            self._rebuild_grads(self.acc), self.n_ok, self.ssum, state,
            score, new_state, grads, self.skip_nonfinite)
        return flatten_tree(acc)[0], n_ok, ssum, state, score

    def _commit_micro(self, outs):
        acc, n_ok, ssum, state, score = outs
        for c, v in zip(self.acc, acc):
            c.copy_(v)
        self.n_ok.copy_(n_ok)
        self.ssum.copy_(ssum)
        params, old_state, opt = self._trees()
        n_p = len(flatten_tree(params)[0])
        for c, v in zip(self.carries[n_p:], flatten_tree(state)[0]):
            if v is not c:
                c.copy_(v)
        self.score.copy_(score.reshape(()).float())

    def _compute_update(self):
        params, _, opt = self._trees()
        update = lambda p, g, o, _step: self.model._update_fn(
            p, g, o, self.static_sc)
        new_params, new_opt, score = finish_accumulation(
            update, params, opt, self._rebuild_grads(self.acc), self.n_ok,
            self.ssum, None)
        return flatten_tree(new_params)[0], flatten_tree(new_opt)[0], score

    def _commit_update(self, outs):
        new_p, new_o, score = outs
        params, state, opt = self._trees()
        n_p = len(flatten_tree(params)[0])
        n_s = len(flatten_tree(state)[0])
        for c, v in zip(self.carries[:n_p], new_p):
            if v is not c:
                c.copy_(v)
        for c, v in zip(self.carries[n_p + n_s:], new_o):
            if v is not c:
                c.copy_(v)
        self.step_score.copy_(score)
        for a in self.acc:
            a.zero_()
        self.n_ok.zero_()
        self.ssum.zero_()

    # -- replays ------------------------------------------------------------
    def _load(self, batch, sc_row):
        leaves, _ = flatten_tree(batch)
        for s, a in zip(self.static_in, leaves):
            if s is not None:
                s.copy_(a, non_blocking=True)
        if sc_row is not None:
            self.static_sc[:sc_row.numel()].copy_(sc_row, non_blocking=True)

    def _sync_per_step(self):
        tel = _tel_active()
        if tel is not None and tel.sync_per_step:
            # between replays, never inside a capture
            torch.cuda.current_stream(self.model.device).synchronize()

    def step(self, batch, sc_row, rnn_carries=None):
        """One optimizer step: load the batch and the scalar row, replay.
        With `rnn_carries` (a TBPTT chunk) they are loaded too, and the
        new ones are left in `rnn_static`. Returns the static score."""
        self._load(batch, sc_row)
        if rnn_carries is not None:
            for s, a in zip(self.rnn_static, flatten_tree(rnn_carries)[0]):
                if s is not None:
                    s.copy_(a, non_blocking=True)
        self.graphs[0].replay()
        self._sync_per_step()
        return self.score

    def micro(self, batch):
        """One microbatch into the accumulators; returns its score."""
        self._load(batch, None)
        self.graphs[0].replay()
        self._sync_per_step()
        return self.score

    def update(self, sc_row):
        """The update on the accumulated mean; returns the step score."""
        self.static_sc[:sc_row.numel()].copy_(sc_row, non_blocking=True)
        self.graphs[1].replay()
        self._sync_per_step()
        return self.step_score


# ----------------------------------------------------------------------
# Overlap-aware auto-K
# ----------------------------------------------------------------------
class OverlapAutoK:
    """Overlap-aware `superstep="auto"` sizing: the byte budget only seeds
    K; from there K adapts to the MEASURED dispatch/compute ratio. Each
    full window reports (host seconds spent enqueuing it, wall seconds of
    the whole window period); EMAs smooth noise, and while the dispatch
    share of the period exceeds `target_share` K doubles, up to `max_k`.
    K never shrinks. Window grouping never changes the math."""

    def __init__(self, k0: int, max_k: int = AUTO_ADAPT_MAX_K,
                 target_share: float = AUTO_DISPATCH_SHARE):
        self.k = max(1, int(k0))
        self.max_k = max(self.k, int(max_k))
        self.target_share = float(target_share)
        self._disp = 0.0
        self._period = 0.0

    def observe(self, dispatch_s: float, period_s: float) -> int:
        """Feed one full window's timings; returns the (possibly grown)
        K for the next window."""
        if period_s <= 0.0:
            return self.k
        if self._period == 0.0:
            self._disp, self._period = dispatch_s, period_s
        else:
            self._disp = 0.5 * dispatch_s + 0.5 * self._disp
            self._period = 0.5 * period_s + 0.5 * self._period
        if (self.k < self.max_k
                and self._disp / self._period > self.target_share):
            self.k = min(self.max_k, self.k * 2)
        return self.k


# ----------------------------------------------------------------------
# The windowed fit loop
# ----------------------------------------------------------------------
class SuperstepRunner:
    """The windowed inner fit loop, shared by MultiLayerNetwork.fit and
    ComputationGraph.fit.

    The model-specific pieces live in an *adapter* with five hooks:

      signature(ds)    hashable batch signature (windows never mix
                       signatures), or None to consume the batch without
                       training it
      batch_nbytes(ds) bytes of one batch (`superstep="auto"` sizing)
      stage(window)    the window's batches as tensors on the model's
                       device (datasets/pipeline.stage_window)
      dispatch(staged, n, step0)
                       train the window, rebinding or updating the
                       model's trees; returns the device scores WITHOUT
                       syncing: a [n] tensor for grad_accumulation=1,
                       else a list of (scores[q], micro_scores[q, m])
                       parts (see split_accum_groups)
      on_window_end(window)
                       per-window bookkeeping (last_input /
                       last_batch_size, signature tracking) — runs only
                       for KEPT windows, before the listener replay

    With `grad_accumulation=M` the window holds K·M MICROBATCHES (K
    optimizer steps); listeners / guard / counters operate per optimizer
    step while the checkpoint batch cursor counts iterator microbatches,
    so window edges are always optimizer-step boundaries.

    One runner drives one fit() call; `skip()` positions the resume
    cursor before the first epoch.
    """

    def __init__(self, model, adapter, superstep, *, guard=None, ckpt=None,
                 grad_accumulation: int = 1):
        self.model = model
        self.adapter = adapter
        self.superstep = validate_superstep(superstep)
        self.guard = guard
        self.ckpt = ckpt
        self._m = validate_grad_accumulation(grad_accumulation)
        self._skip_nonfinite = accum_skip_nonfinite(guard, self._m)
        self._autok: Optional[OverlapAutoK] = None
        self._k: Optional[int] = (self.superstep
                                  if isinstance(self.superstep, int) else None)
        self._skip = 0
        self._pending = None   # drawn batch belonging to the next window
        self._untrained = 0    # consumed untrainable batches awaiting a
                               # window-edge cursor advance
        self._staged_memo = None   # single-slot (ids, staged, window refs)
        # Pipelining (stage window i+1 while window i computes, sync i's
        # scores after i+1 is enqueued) is only safe when nothing on the
        # host consumes model state at window boundaries: a guard may roll
        # the window back, a checkpointer may save mid-loop.
        self._pipelined = guard is None and ckpt is None

    def skip(self, n: int):
        """Resume bookkeeping: draw and discard the first `n` batches (the
        prefix the interrupted run already trained) before windowing."""
        self._skip = max(0, int(n))

    # ------------------------------------------------------------------
    def _resolve_k(self, ds):
        if self._k is not None:
            return
        if self.superstep == "auto":
            nbytes = self.adapter.batch_nbytes(ds)
            micros = auto_superstep_k(nbytes)
            self._k = max(1, micros // self._m)
            byte_cap = max(self._k, int(
                AUTO_ADAPT_WINDOW_BYTES // max(1, nbytes * self._m)))
            self._autok = OverlapAutoK(
                self._k, max_k=min(AUTO_ADAPT_MAX_K, byte_cap))
            log.info("superstep='auto' seeded at K=%d optimizer steps "
                     "(batch ~%.2f MB x M=%d, window budget %d MB, "
                     "adaptive cap K<=%d); overlap-aware adaptation "
                     "active", self._k, nbytes / 1e6, self._m,
                     AUTO_WINDOW_BYTES >> 20, self._autok.max_k)
        else:   # EPOCH: bounded only by the epoch / signature changes
            self._k = 1 << 30

    def _steps_in(self, n_micro: int) -> int:
        return steps_in(n_micro, self._m)

    def _observe_auto(self, window, dispatch_s: float, period_s: float):
        """Feed a FULL window's measured timings to the overlap-aware
        auto-K policy, and every window's anatomy to the flight
        recorder."""
        rec = flight_recorder()
        if rec.enabled:
            rec.record("train/window", micro=len(window),
                       n_steps=self._steps_in(len(window)),
                       dispatch_s=round(dispatch_s, 6),
                       period_s=round(period_s, 6),
                       dispatch_share=round(
                           dispatch_s / period_s, 4) if period_s > 0 else None)
        if self._autok is None or len(window) != self._k * self._m:
            return
        new_k = self._autok.observe(dispatch_s, period_s)
        if new_k != self._k:
            log.info(
                "superstep='auto' growing K %d -> %d (measured dispatch "
                "share %.1f%% of window period, target %.0f%%)", self._k,
                new_k, 100.0 * self._autok._disp / self._autok._period,
                100.0 * self._autok.target_share)
            self._k = new_k

    def _collect(self, data):
        """Next window: up to K consecutive batches sharing one signature.
        A signature change (ragged tail, time-bucket switch) closes the
        window; the odd batch opens the next one."""
        guard = self.guard
        window, sig0 = [], None
        while True:
            if self._pending is not None:
                ds, self._pending = self._pending, None
            elif data.has_next():
                ds = (guard.next_batch(data) if guard is not None
                      else data.next())
            else:
                break
            if self._skip:
                self._skip -= 1
                continue
            sig = self.adapter.signature(ds)
            if sig is None:
                self._untrained += 1
                continue
            if sig0 is None:
                self._resolve_k(ds)
                sig0 = sig
            elif sig != sig0:
                self._pending = ds
                break
            window.append(ds)
            if len(window) >= self._k * self._m:
                break
        return window

    def _stage(self, window):
        """Stage a window, with a SINGLE-SLOT identity memo: the
        whole-epoch window (the fit_scan alias) presents the same batch
        objects every epoch and is staged once."""
        if not window:
            return None
        key = tuple(id(ds) for ds in window)
        memo = self._staged_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        staged = self.adapter.stage(window)
        self._staged_memo = (key, staged, window)
        return staged

    # ------------------------------------------------------------------
    def run_epoch(self, data):
        tel = _tel_active()
        span = tel.span if tel is not None else _null_span
        if self._pipelined:
            self._run_pipelined(data, span)
        else:
            self._run_sequential(data, span)
        if self._untrained and self.ckpt is not None:
            self.ckpt.on_batches(self._untrained)
            self._untrained = 0

    def _run_sequential(self, data, span):
        """Guard/checkpoint mode: each window is finalized (scores synced,
        guard verdict applied, checkpoint cursor advanced) before the next
        window is enqueued."""
        while True:
            t_win = time.perf_counter()
            with span("host/batch_prep", kind="superstep_window"):
                window = self._collect(data)
                staged = self._stage(window)
            if not window:
                return
            snap = self._pre_window_snapshot()
            t_d = time.perf_counter()
            with span("device/dispatch", kind="superstep"):
                scores = self.adapter.dispatch(staged, len(window),
                                               self.model.iteration_count)
            t_d = time.perf_counter() - t_d
            self._finalize(window, scores, snap, span)
            self._observe_auto(window, t_d, time.perf_counter() - t_win)

    def _run_pipelined(self, data, span):
        """No guard, no checkpointer: window i+1 is collected and staged
        while window i's replays run on the card. With no listeners, window
        i's finalize (score sync) waits until window i+1 is enqueued; with
        listeners it runs first, so every replay observes the parameters
        at the end of its own window."""
        lag = not (getattr(self.model, "listeners", None) or [])
        step0 = self.model.iteration_count
        inflight = None   # (window, scores) — one window of lag
        with span("host/batch_prep", kind="superstep_window"):
            window = self._collect(data)
            staged = self._stage(window)
        t_prev = time.perf_counter()
        while window:
            t_d = time.perf_counter()
            with span("device/dispatch", kind="superstep"):
                scores = self.adapter.dispatch(staged, len(window), step0)
            t_d = time.perf_counter() - t_d
            step0 += self._steps_in(len(window))
            cur = (window, scores)
            with span("host/batch_prep", kind="superstep_window"):
                window = self._collect(data)
                staged = self._stage(window)
            if lag:
                if inflight is not None:
                    self._finalize(inflight[0], inflight[1], None, span)
                inflight = cur
            else:
                self._finalize(cur[0], cur[1], None, span)
            now = time.perf_counter()
            self._observe_auto(cur[0], t_d, now - t_prev)
            t_prev = now
        if inflight is not None:
            self._finalize(inflight[0], inflight[1], None, span)

    # ------------------------------------------------------------------
    def _pre_window_snapshot(self):
        g = self.guard
        if g is None or not g._needs_snapshot:
            return None
        # a clone BEFORE the replays: they update the model's tensors in
        # place
        return g._snapshot(self.model)

    def _finalize(self, window, scores_dev, snap, span):
        model = self.model
        n_micro = len(window)
        with span("device/sync", kind="superstep_scores"):
            if self._m == 1:
                host_scores = scores_dev.cpu().numpy()
                micro_scores = None
            else:
                host_scores = np.concatenate(
                    [s.cpu().numpy().reshape(-1) for s, _ in scores_dev])
                micro_scores = [ms.cpu().numpy() for _, ms in scores_dev]
        n_steps = len(host_scores)
        kept = True
        rec = flight_recorder()
        if rec.enabled and self.guard is None and n_steps:
            finite = host_scores[np.isfinite(host_scores)]
            rec.record("train/window_scores", n=n_steps,
                       nonfinite=int(n_steps - finite.size),
                       last=float(host_scores[-1]),
                       lo=float(finite.min()) if finite.size else None,
                       hi=float(finite.max()) if finite.size else None)
        if self.guard is not None:
            # a bad window is discarded WHOLE, restoring the pre-window
            # snapshot. Under skip_nonfinite the accumulated step already
            # neutralized bad MICROBATCHES (finite step score), so only
            # fully-poisoned steps reach this policy.
            kept = self.guard.check_scores(model, host_scores, snap)
            if kept and micro_scores is not None and self._skip_nonfinite:
                bad = int(sum((~np.isfinite(ms)).sum()
                              for ms in micro_scores))
                if bad:
                    note = getattr(self.guard, "note_skipped_micros", None)
                    if note is not None:
                        note(model, bad)
        if kept:
            self.adapter.on_window_end(window)
            listeners = getattr(model, "listeners", None) or []
            if listeners:
                # one iteration_done per OPTIMIZER step, each with a host
                # scalar in model._score
                for i in range(n_steps):
                    model._score = host_scores[i]
                    model.iteration_count += 1
                    for listener in listeners:
                        listener.iteration_done(model, model.iteration_count)
            else:
                model._score = host_scores[-1]
                model.iteration_count += n_steps
        if self.ckpt is not None:
            # the cursor counts MICROBATCHES, for kept and discarded
            # windows alike, plus untrainable batches consumed meanwhile
            self.ckpt.on_batches(n_micro + self._untrained)
            self._untrained = 0


# ----------------------------------------------------------------------
# The adapter's dispatch, shared by both model kinds
# ----------------------------------------------------------------------
def _scalar_rows(model, steps) -> torch.Tensor:
    """[len(steps), n] float32 table of the steps' host scalars, on the
    model's device (one copy from pinned memory)."""
    rows = [model._step_scalars(s) for s in steps]
    n = max(1, max((len(r) for r in rows), default=0))
    table = np.zeros((len(rows), n), np.float32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    t = torch.from_numpy(table)
    if model.device.type == "cuda":
        return t.pin_memory().to(model.device, non_blocking=True)
    return t


#: the watched entry point of each kind of window step (JAX's names)
_ENTRY = {"step": "superstep", "accum": "accum_superstep",
          "tbptt": "scan_epoch", "scan": "scan_epoch"}


def _step_key(model, batch, kind, skip_nonfinite=False, rnn=None):
    """The cache key of a window step: its kind, the batch signature
    (shapes, dtypes, absent leaves), the recurrent carries' signature and
    the generators' identities (a model given new generators captures
    anew)."""
    sig = lambda tree: tuple(
        None if a is None else (tuple(a.shape), str(a.dtype))
        for a in flatten_tree(tree)[0])
    gens = tuple(id(g) for g in model._dropout_generators())
    return (kind, bool(skip_nonfinite), sig(batch),
            None if rnn is None else sig(rnn), gens)


def _capture_for(model, batch, kind, skip_nonfinite=False, rnn=None):
    """The model's CapturedStep for this batch signature (captured on
    first use, which the telemetry session counts as a compile)."""
    key = _step_key(model, batch, kind, skip_nonfinite, rnn)
    cache = model.__dict__.setdefault("_captured_steps", {})
    cap = cache.get(key)
    if cap is None:
        name = f"{model._entry_name}/{_ENTRY[kind]}"
        n_sc = len(model._step_scalars(model.iteration_count))
        cap = cache[key] = CapturedStep(
            model, name, batch, n_sc, rnn_carries=rnn,
            accumulate=(kind == "accum"), skip_nonfinite=skip_nonfinite)
    else:
        cap.bind()
    return cap


@contextlib.contextmanager
def _eager_signature(model, batch, kind, skip_nonfinite=False, rnn=None):
    """Count the first eager window of a signature as a compile (the
    window where the card would capture), timed by that window."""
    key = _step_key(model, batch, kind, skip_nonfinite, rnn)
    seen = model.__dict__.setdefault("_eager_steps", set())
    fresh = key not in seen
    seen.add(key)
    t0 = time.perf_counter()
    yield
    tel = _tel_active()
    if fresh and tel is not None:
        tel.compiles.record_capture(f"{model._entry_name}/{_ENTRY[kind]}",
                                    time.perf_counter() - t0)


def run_window(model, batches, step0, m=1, skip_nonfinite=False,
               kind="step"):
    """Train `batches` (a list of batch trees on the model's device) as
    one window: optimizer steps of one batch each (m=1), or of m
    microbatches. On the card the steps replay the model's CapturedStep;
    on the CPU they run eagerly. `kind` "scan" names the step as
    `fit_scan_arrays`' epoch. Returns the device scores as the adapter's
    dispatch contract wants them."""
    n = len(batches)
    if not _captures(model):
        if m == 1:
            with _eager_signature(model, batches[0], kind):
                run = build_superstep(model._eager_step)
                p, s, o, scores = run(*model._carry_trees(), step0, batches)
                model._set_carry_trees(p, s, o)
            return scores

        def run_group(groups, step):
            fn = build_accum_superstep(
                lambda p, st, b: model._grad_fn(p, st, b, None)[:3],
                model._eager_update, skip_nonfinite)
            p, s, o, scores, micro = fn(*model._carry_trees(), step, groups)
            model._set_carry_trees(p, s, o)
            return scores, micro
        with _eager_signature(model, batches[0], "accum", skip_nonfinite):
            return dispatch_accum_groups(batches, n, m, step0, run_group)
    if m == 1:
        cap = _capture_for(model, batches[0], kind)
        table = _scalar_rows(model, range(step0, step0 + n))
        scores = torch.empty(n, dtype=torch.float32, device=model.device)
        for i, b in enumerate(batches):
            scores[i].copy_(cap.step(b, table[i]))
        return scores
    cap = _capture_for(model, batches[0], "accum", skip_nonfinite)

    def run_group(groups, step):
        table = _scalar_rows(model, range(step, step + len(groups)))
        scores = torch.empty(len(groups), dtype=torch.float32,
                             device=model.device)
        micro = torch.empty(len(groups), len(groups[0]), dtype=torch.float32,
                            device=model.device)
        for k, group in enumerate(groups):
            for j, b in enumerate(group):
                micro[k, j].copy_(cap.micro(b))
            scores[k].copy_(cap.update(table[k]))
        return scores, micro
    return dispatch_accum_groups(batches, n, m, step0, run_group)


def run_tbptt_window(model, chunks, firsts, step0):
    """Train a TBPTT epoch of `chunks` (batch trees of one chunk length)
    as one window: the recurrent carries flow from chunk to chunk and
    start from zeros where `firsts` marks a series' first chunk. On the
    card the chunk steps replay the model's captured chunk step (the
    carries among its statics); on the CPU they run eagerly. Returns the
    [n] device scores."""
    n = len(chunks)
    x0 = chunks[0][0]
    zeros = lambda: model._zero_carries(int(x0.shape[0]), x0.dtype)
    if not _captures(model):
        scores, carries = [], None
        with _eager_signature(model, chunks[0], "tbptt", rnn=zeros()):
            for i, chunk in enumerate(chunks):
                if firsts[i]:
                    carries = zeros()
                params, state, opt = model._carry_trees()
                score, new_state, grads, carries = model._grad_fn(
                    params, state, chunk, carries)
                new_params, new_opt = model._eager_update(
                    params, grads, opt, step0 + i)
                model._set_carry_trees(new_params, new_state, new_opt)
                scores.append(score.reshape(()).float())
        return torch.stack(scores)
    cap = _capture_for(model, chunks[0], "tbptt", rnn=zeros())
    table = _scalar_rows(model, range(step0, step0 + n))
    scores = torch.empty(n, dtype=torch.float32, device=model.device)
    for i, chunk in enumerate(chunks):
        scores[i].copy_(cap.step(chunk, table[i],
                                 zeros() if firsts[i] else None))
    return scores
