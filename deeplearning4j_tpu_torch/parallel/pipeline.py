"""Pipeline parallelism (the port of `deeplearning4j_tpu/parallel/pipeline.py`).

Two generations, as in JAX:

**The 1F1B pipeline over the mesh's "pipe" axis** (`PipelinePlan`,
`make_pp_step`; the `PP` and `ZERO1_TP_PP` strategies of
`ParallelTrainer`). JAX stacks the model's homogeneous layer run on a
leading stage axis sharded over "pipe" and ticks activations through one
scan whose buffer shift lowers to collective-permutes. The port runs one
rank per stage: rank s holds the v layers of stage s (the run split in S
equal parts, as JAX's stack slices it), and the ticks' permutes become
point-to-point sends and receives on the pipe group, posted as one batch a
tick (`collectives.exchange`) in the non-interleaved 1F1B order: stage s
runs S - s - 1 warm-up forwards, then alternates one forward and one
backward, then drains its backwards. The layers before the run (the head:
the embedding of an LM) run on stage 0, the layers after it and the loss
(the tail) on stage S - 1; their gradients are all-reduced over the pipe
group so every stage keeps the same replica of them. The label mask and
the ragged-tail renormalisation go through the last stage's loss, the
regularization through each stage's own layers.

**The host-driven GPipe of one process** (`PipelinedNetworkTrainer`,
`PipelinedGraphTrainer`; the `PIPELINE` strategy). Contiguous layer
ranges (balanced by parameter count, or explicit `boundaries`) become
stages pinned to devices; a step forwards every microbatch stage by stage
(autograd keeps each boundary), then backwards them, and each stage's
layers update with their own updaters. Gradients average over the
microbatches: the full-batch gradient for mean losses.

Restriction (JAX's): the 1F1B stages share one program — identical layer
structure and an [.., F] -> [.., F] activation — and feed-forward layers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .collectives import all_reduce_, broadcast_, exchange
from .mesh import MeshAxes
from ..datasets.iterators import DataSet, MultiDataSet
from ..nn.trees import flat_leaves, flatten_tree, tree_map

__all__ = ["pipeline_forward", "PipelinedDenseStack",
           "PipelinedNetworkTrainer", "PipelinedGraphTrainer",
           "PipelinePlan", "make_pp_step", "make_pp_accum_superstep"]


# ===========================================================================
# 1F1B over the pipe axis
# ===========================================================================
def _conf_eq(a, b) -> bool:
    """Layer-conf equality for stage homogeneity (JAX's): dataclass fields,
    updaters compared by type and attributes."""
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "updater":
            if va is None and vb is None:
                continue
            if va is None or vb is None or type(va) is not type(vb) \
                    or vars(va) != vars(vb):
                return False
            continue
        if va != vb:
            return False
    return True


def _tree_sig(tree):
    leaves, _ = flatten_tree(tree)
    keys = (sorted(tree) if isinstance(tree, dict) else None)
    return (keys, tuple((tuple(a.shape), str(a.dtype)) if isinstance(
        a, torch.Tensor) else repr(a) for a in leaves))


class PipelinePlan:
    """The static stage partition of a MultiLayerNetwork over the pipe
    axis of `mesh` (JAX's rules and messages): the longest contiguous run
    of identical layers [lo, hi), split into S stages of v layers; this
    rank's `local_layers` are the head (layers before the run), its
    stage's v layers and the tail (the trainer composes TP and ZeRO over
    that local form); `microbatches` is M of the 1F1B schedule (each
    rank's rows split in M)."""

    def __init__(self, model, mesh, pipe_axis: str = MeshAxes.PIPE,
                 microbatches: int = 1):
        from ..nn.layers.feedforward import BaseOutputLayerConf

        if isinstance(model.params, dict):
            raise ValueError(
                "the mesh-native pipeline strategies stack a MultiLayer"
                "Network's homogeneous layer run; ComputationGraph models "
                "are not supported — use strategy='pipeline' (host-driven "
                "GPipe) or a chain model")
        if model.params is None:
            model.init()
        layers = model.layers
        n = len(layers)
        if n < 2 or not isinstance(layers[-1], BaseOutputLayerConf):
            raise ValueError("last layer must be an output/loss layer")
        for i, layer in enumerate(layers):
            if getattr(layer, "is_recurrent", False):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) is recurrent — "
                    "the 1F1B step supports feed-forward models only")
            if hasattr(layer, "aux_score"):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) carries an "
                    "auxiliary loss (aux_score) the pipelined loss does "
                    "not propagate; use a SYNC strategy for MoE models")
        self.model = model
        self.mesh = mesh
        S = mesh.axis_size(pipe_axis)
        if S < 2:
            raise ValueError(
                f"pipeline needs a pipe axis of size >= 2, got {S} — "
                "build the mesh with mesh_shape=(d, m, p)")
        self.n_stages = S
        sigs = [(layers[i], _tree_sig(model.params[i]),
                 _tree_sig(model.state[i])) for i in range(n - 1)]
        best = (0, 0)
        i = 0
        while i < n - 1:
            j = i + 1
            while j < n - 1 and _conf_eq(sigs[j][0], sigs[i][0]) \
                    and sigs[j][1] == sigs[i][1] and sigs[j][2] == sigs[i][2]:
                j += 1
            if j - i > best[0]:
                best = (j - i, i)
            i = j
        L, lo = best
        if L < S:
            raise ValueError(
                f"model has no homogeneous layer run of >= {S} identical "
                f"layers to stage over the pipe axis (longest run: {L}). "
                "Pipeline the repeated block depth (e.g. TransformerBlock "
                "x depth) or shrink the pipe axis")
        if L % S:
            raise ValueError(
                f"homogeneous run of {L} layers does not divide into "
                f"{S} pipeline stages — use a depth divisible by the "
                f"pipe-axis size (e.g. {(L // S) * S} or {(L // S + 1) * S} "
                "layers)")
        self.lo, self.hi = lo, lo + L
        self.slots = L // S
        for i in range(self.lo + 1, self.hi):
            if i in model.conf.preprocessors:
                raise ValueError(
                    f"preprocessor at layer {i} sits inside the pipelined "
                    f"stage run [{self.lo}, {self.hi}) — stages must "
                    "share one program; move it outside the homogeneous "
                    "run or use strategy='pipeline'")
        self.stage = mesh.axis_index(pipe_axis)
        self.group = mesh.axis_group(pipe_axis)
        self.pipe_ranks = mesh.axis_ranks(pipe_axis)
        v = self.slots
        self.stage_idx = [self.lo + self.stage * v + r for r in range(v)]
        self.local_idx = (list(range(self.lo)) + self.stage_idx
                          + list(range(self.hi, n)))
        self.local_layers = [layers[i] for i in self.local_idx]
        self.n_head = self.lo
        self.microbatches = max(1, int(microbatches))

    # -- the local form ------------------------------------------------------
    def to_local(self, per_layer):
        """A per-layer tuple (params, state or updater state) -> this
        rank's local tuple: head, its stage's layers, tail."""
        return tuple(per_layer[i] for i in self.local_idx)

    def from_local(self, local):
        """This rank's local tuple -> the whole per-layer tuple: each
        stage's layers broadcast from the stage's rank (every pipe rank
        calls)."""
        n = len(self.model.layers)
        out = [None] * n
        v, lo = self.slots, self.lo
        for k, i in enumerate(self.local_idx):
            out[i] = local[k]
        for t in range(self.n_stages):
            for r in range(v):
                i = lo + t * v + r
                src = local[self.n_head + r] if t == self.stage else \
                    tree_map(torch.empty_like, local[self.n_head + r])
                out[i] = tree_map(
                    lambda a: broadcast_(a.detach().clone().contiguous(),
                                         self.pipe_ranks[t], self.group)
                    if isinstance(a, torch.Tensor) else a, src)
        return tuple(out)

    def _is_shared(self, k: int) -> bool:
        """Whether local layer k is the head or the tail (every stage
        keeps a replica)."""
        return k < self.n_head or k >= self.n_head + self.slots

    def reg_score(self, local_params):
        """This rank's part of the l1/l2 penalty: its stage's layers, plus
        the head on stage 0 and the tail on the last stage."""
        total = 0.0
        first, last = self.stage == 0, self.stage == self.n_stages - 1
        for k, (layer, p) in enumerate(zip(self.local_layers, local_params)):
            if not p:
                continue
            if k < self.n_head and not first:
                continue
            if k >= self.n_head + self.slots and not last:
                continue
            total = total + layer.reg_score(p)
        return total

    # -- the 1F1B step ---------------------------------------------------------
    def grad(self, params, state, batch):
        """(score, new local state, local gradients) of this rank's rows
        through the 1F1B schedule of `microbatches` microbatches. The
        score is the mean of the microbatches' (loss + reg / live rows),
        the same on every pipe rank; the gradients are the score's."""
        from ..nn.conf.base import cast_floating
        from ..nn.layers.feedforward import BaseOutputLayerConf

        x, y, fm, lm = batch
        if fm is not None:
            raise ValueError(
                "the 1F1B step threads the weight-zero LABEL mask through "
                "the last-stage loss, but features masks (time_buckets "
                "padding) are not supported — drop time_buckets or use a "
                "SYNC strategy")
        m = self.model
        layers = self.local_layers
        S, s, M = self.n_stages, self.stage, self.microbatches
        first, last = s == 0, s == S - 1
        rows = int(x.shape[0])
        if rows % M:
            raise ValueError(f"{rows} rows do not split into {M} "
                             "microbatches")
        xs, ys = x.chunk(M), y.chunk(M)
        lms = [None] * M if lm is None else list(lm.chunk(M))
        cdt = m._compute_dtype
        gen = m._train_generator()
        preproc = m.conf.preprocessors
        dev = x.device
        live = [tree_map(lambda a, f=layer.frozen: a.detach()
                         .requires_grad_(not f and a.is_floating_point()), p)
                for layer, p in zip(layers, params)]
        new_state = list(state)
        nh, v = self.n_head, self.slots

        def run(k_range, h):
            for k in k_range:
                i = self.local_idx[k]
                if i in preproc:
                    h = preproc[i].apply(h)
                p_k = live[k]
                if cdt is not None and not isinstance(layers[k],
                                                      BaseOutputLayerConf):
                    p_k = cast_floating(p_k, cdt)
                h, new_state[k] = layers[k].apply(
                    p_k, new_state[k], h, train=True, generator=gen,
                    mask=None)
            return h

        def live_rows(lmi, n):
            if lmi is None:
                return float(n)
            lv = lmi.to(torch.float32).reshape(lmi.shape[0], -1).amax(dim=1)
            return torch.clamp(lv.sum(), min=1.0)

        shape, act_dtype = self._act_shape(xs[0], live, run)
        saved = {}
        losses = []
        prev = None if first else self.pipe_ranks[s - 1]
        nxt = None if last else self.pipe_ranks[s + 1]

        def buffer():
            return torch.empty(shape, dtype=act_dtype, device=dev)

        def forward(i, h_in):
            """Microbatch i through this stage (the head first on stage 0,
            the tail and the loss after on the last); keeps what its
            backward needs, returns the activation to send on."""
            if first:
                h = xs[i]
                if cdt is not None and h.is_floating_point():
                    h = h.to(cdt)
                h = run(range(nh), h)
                if self.lo in preproc:
                    h = preproc[self.lo].apply(h)
            else:
                h = h_in.requires_grad_(True)
            out = run(range(nh, nh + v), h)
            if last:
                h2 = run(range(nh + v, len(layers) - 1), out)
                n_out = self.local_idx[-1]
                if n_out in preproc:
                    h2 = preproc[n_out].apply(h2)
                loss = layers[-1].loss_score(
                    live[-1], new_state[-1], h2, ys[i], train=True,
                    generator=gen, mask=lms[i])
                losses.append(loss.detach())
                saved[i] = (h_in, loss / M)
                return None
            saved[i] = (h_in, out)
            return out.detach()

        def backward(i, g_out):
            """Microbatch i's backward through this stage; returns the
            gradient of its input activation (None on stage 0)."""
            h_in, out = saved.pop(i)
            if last:
                torch.autograd.backward(out)
            else:
                torch.autograd.backward(out, g_out)
            if first:
                return None
            return torch.zeros_like(h_in) if h_in.grad is None \
                else h_in.grad

        def tick(send_next=None, send_prev=None, recv_next=False,
                 recv_prev=False):
            """One batch of this tick's sends and receives: activations
            forward to s + 1, gradients back to s - 1."""
            sends, recvs, got = [], [], [None, None]
            if send_next is not None and nxt is not None:
                sends.append((send_next, nxt))
            if send_prev is not None and prev is not None:
                sends.append((send_prev, prev))
            if recv_next and nxt is not None:
                got[0] = buffer()
                recvs.append((got[0], nxt))
            if recv_prev and prev is not None:
                got[1] = buffer()
                recvs.append((got[1], prev))
            exchange(sends, recvs, group=self.group)
            return got

        # Megatron's non-interleaved 1F1B: S - s - 1 warm-up forwards, then
        # one forward / one backward (each pair of transfers posted as one
        # batch, so no stage waits on a peer that waits on it), then drain
        warm = min(S - s - 1, M)
        rem = M - warm
        with torch.enable_grad():
            for i in range(warm):
                h_in = tick(recv_prev=True)[1]
                tick(send_next=forward(i, h_in))
            h_in = tick(recv_prev=True)[1] if rem else None
            for j in range(rem):
                out = forward(warm + j, h_in)
                g_out = tick(send_next=out, recv_next=True)[0]
                g_in = backward(j, g_out)
                h_in = tick(send_prev=g_in,
                            recv_prev=j < rem - 1)[1]
            for j in range(rem, M):
                g_out = tick(recv_next=True)[0]
                tick(send_prev=backward(j, g_out))
            # l1/l2: each stage's own layers (head on stage 0, tail on the
            # last), 1 / live rows a microbatch, averaged over M
            coef = sum(1.0 / live_rows(lms[i], xs[i].shape[0])
                       for i in range(M)) / M
            reg = self.reg_score(live)
            if isinstance(reg, torch.Tensor):
                if reg.requires_grad:
                    torch.autograd.backward(reg * coef)
                reg_part = (reg * coef).detach().float()
            else:
                reg_part = torch.zeros((), device=dev)
        sign = 1.0 if m.conf.conf.minimize else -1.0
        grads = []
        for p in live:
            grads.append(tree_map(
                lambda a: (torch.zeros_like(a) if a.grad is None
                           else a.grad * sign)
                if isinstance(a, torch.Tensor) else a, p))
        # the score: the last stage's mean loss, every stage's reg part
        score = reg_part.reshape(())
        if last:
            score = score + torch.stack(losses).float().mean()
        score = all_reduce_(score.reshape(1).clone(), self.group).reshape(())
        # head / tail: one replica on every stage (the owner's gradient
        # and state, the others' zeros)
        for k in range(len(layers)):
            if not self._is_shared(k):
                continue
            owner = 0 if k < nh else S - 1
            grads[k] = tree_map(lambda g: all_reduce_(
                g if s == owner else torch.zeros_like(g), self.group)
                if isinstance(g, torch.Tensor) else g, grads[k])
            new_state[k] = tree_map(lambda a: broadcast_(
                a.detach().clone().contiguous(), self.pipe_ranks[owner],
                self.group) if isinstance(a, torch.Tensor) else a,
                new_state[k])
        new_state = [tree_map(lambda a: a.detach() if isinstance(
            a, torch.Tensor) else a, st) for st in new_state]
        return score.detach(), tuple(new_state), grads

    def _act_shape(self, x0, params, run):
        """(shape, dtype) of the activation entering a stage for a
        microbatch like x0: the head's output, computed without a graph
        (stage 0 sends it along so every stage knows it)."""
        key = (tuple(x0.shape), str(x0.dtype))
        cache = self.__dict__.setdefault("_shapes", {})
        if key in cache:
            return cache[key]
        m = self.model
        cdt = m._compute_dtype
        meta = torch.zeros(8, dtype=torch.int64, device=x0.device)
        if self.stage == 0:
            with torch.no_grad():
                gen = m._train_generator()
                state = None if gen is None else gen.get_state()
                h = x0.to(cdt) if (cdt is not None
                                   and x0.is_floating_point()) else x0
                h = run(range(self.n_head), h)
                if self.lo in m.conf.preprocessors:
                    h = m.conf.preprocessors[self.lo].apply(h)
                if gen is not None:
                    gen.set_state(state)
            meta[0] = h.dim()
            meta[1:1 + h.dim()] = torch.tensor(h.shape)
            meta[7] = _DTYPE_CODES.index(h.dtype)
        broadcast_(meta, self.pipe_ranks[0], self.group)
        meta = meta.tolist()
        out = (tuple(meta[1:1 + meta[0]]), _DTYPE_CODES[meta[7]])
        cache[key] = out
        return out


_DTYPE_CODES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


def _pp_info(plan: PipelinePlan, zero_plan=None):
    info = {"n_stages": plan.n_stages, "slots": plan.slots,
            "stage_run": (plan.lo, plan.hi),
            "microbatches": plan.microbatches,
            "remat": {"policy": getattr(plan.model.layers[plan.lo],
                                        "remat_policy", None),
                      "compute_dtype": plan.model.conf.conf.compute_dtype}}
    if zero_plan is not None:
        info["zero"] = dict(zero_plan.info)
    return info


def make_pp_step(model, plan: PipelinePlan, *, zero_plan=None):
    """The per-batch 1F1B train step on this rank's local trees:
    `step(params, state, opt, step_i, batch) -> (params, state, opt,
    score)`, the gradient of this rank's rows (the caller reduces over the
    data axis first when there is one: `ParallelTrainer` does). Returns
    (step, info)."""
    def step(params, state, opt_state, step_i, batch):
        score, new_state, grads = plan.grad(params, state, batch)
        if zero_plan is not None:
            grads = zero_plan.reduce(grads)
            new_p, new_o = zero_plan.update(params, grads, opt_state,
                                            step=step_i)
        else:
            detached = [tree_map(torch.Tensor.detach, p) for p in params]
            new_p, new_o = model.apply_layer_updates(
                plan.local_layers, detached, grads, list(opt_state), step_i)
        return tuple(new_p), new_state, tuple(new_o), score
    return step, _pp_info(plan, zero_plan)


def make_pp_accum_superstep(model, plan: PipelinePlan, *, zero_plan=None):
    """The accumulated 1F1B superstep: the pipeline's microbatches are the
    accumulation microbatches. `superstep(params, state, opt, step0,
    groups)` runs one optimizer step a group of M batches (the group's
    rows concatenated and split again by the schedule), returning
    (params, state, opt, scores[K]). Returns (fn, info)."""
    step, info = make_pp_step(model, plan, zero_plan=zero_plan)

    def superstep(params, state, opt_state, step0, groups):
        scores = []
        for k, group in enumerate(groups):
            plan.microbatches = len(group)
            batch = tuple(None if group[0][j] is None else torch.cat(
                [b[j] for b in group]) for j in range(4))
            params, state, opt_state, score = step(params, state, opt_state,
                                                   step0 + k, batch)
            scores.append(score)
        return params, state, opt_state, torch.stack(scores)
    return superstep, info


# ===========================================================================
# the host-driven GPipe of one process
# ===========================================================================
def pipeline_forward(stage_fn: Callable, stage_params: Sequence,
                     x_microbatches: torch.Tensor,
                     devices: Optional[Sequence] = None) -> torch.Tensor:
    """The GPipe forward of one process: microbatch t enters stage 0 at
    tick t, and at every tick each stage runs the microbatch it holds,
    then hands it to the next stage's device. stage_fn(params, x) -> y
    with y shaped like x; x_microbatches [M, mb, F]. Returns [M, mb, F],
    the outputs of the last stage."""
    S = len(stage_params)
    M = x_microbatches.shape[0]
    devices = list(devices) if devices is not None else \
        [x_microbatches.device] * S
    buf: List[Optional[torch.Tensor]] = [None] * S
    out = [None] * M
    for t in range(M + S - 1):
        for s in range(S - 1, -1, -1):       # drain back to front
            mi = t - s
            if not 0 <= mi < M:
                continue
            x = x_microbatches[mi] if s == 0 else buf[s - 1]
            y = stage_fn(stage_params[s], x.to(devices[s]))
            if s == S - 1:
                out[mi] = y
            else:
                buf[s] = y
    return torch.stack([o.to(x_microbatches.device) for o in out])


class PipelinedDenseStack:
    """S identical Dense(F -> F, activation) stages (JAX's template of a
    pipelined homogeneous block): `pipelined_forward` against
    `reference_forward`. Its parameters live on `device` (default: the
    card, `util.platform.resolve_device`)."""

    def __init__(self, features: int, n_stages: int, activation: str = "tanh",
                 seed: int = 0, devices=None, device=None):
        from ..nn.activations import get as act_get
        from ..util.platform import resolve_device
        device = resolve_device(device)
        self.features = features
        self.n_stages = n_stages
        self._act = act_get(activation)
        g = torch.Generator().manual_seed(seed)
        scale = 1.0 / np.sqrt(features)
        self.params = {
            "W": torch.randn((n_stages, features, features), generator=g)
            * scale,
            "b": torch.zeros((n_stages, features))}
        self.params = {k: v.to(device) for k, v in self.params.items()}
        self.devices = devices

    def _stage_fn(self, p, x):
        return self._act(x @ p["W"] + p["b"])

    def _stage(self, s):
        return {k: v[s] for k, v in self.params.items()}

    def reference_forward(self, x):
        for s in range(self.n_stages):
            x = self._stage_fn(self._stage(s), x)
        return x

    def pipelined_forward(self, x, n_microbatches: Optional[int] = None):
        M = n_microbatches or self.n_stages
        B = x.shape[0]
        if B % M:
            raise ValueError("batch must divide into microbatches")
        xm = x.reshape(M, B // M, self.features)
        out = pipeline_forward(
            self._stage_fn, [self._stage(s) for s in range(self.n_stages)],
            xm, self.devices)
        return out.reshape(B, self.features)


def _default_devices(n_stages: int, device=None) -> list:
    """The stage devices: the cards in turn for a CUDA device without an
    index, else `device` for every stage (stages may share a card)."""
    from ..util.platform import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n = max(1, torch.cuda.device_count())
        return [torch.device("cuda", s % n) for s in range(n_stages)]
    return [dev] * n_stages


class PipelinedNetworkTrainer:
    """GPipe-schedule pipeline training of a MultiLayerNetwork in one
    process (JAX's): contiguous layer ranges, balanced by parameter count
    (`_balance`) or given as `boundaries` (boundaries[s] = the first layer
    of stage s + 1), pinned to `devices` (default: the cards in turn, or
    the model's device; all stages may share one card). A step forwards
    all microbatches stage by stage, then backwards them (autograd keeps
    each stage boundary), averages the gradients over the microbatches,
    adds each stage's l1/l2 over the live rows and updates each stage's
    layers. Features masks are refused; the label mask goes to the loss."""

    def __init__(self, model, mesh=None, axis: str = MeshAxes.PIPE,
                 n_microbatches: Optional[int] = None,
                 boundaries: Optional[list] = None,
                 n_stages: Optional[int] = None, devices=None):
        from ..nn.layers.feedforward import BaseOutputLayerConf

        if model.params is None:
            model.init()
        self.model = model
        if n_stages is None:
            n_stages = (int(mesh.shape.get(axis, 1)) if mesh is not None
                        else len(devices) if devices is not None else 2)
        self.n_stages = int(n_stages)
        self.n_microbatches = n_microbatches or self.n_stages
        self._check(model, BaseOutputLayerConf)
        self.boundaries = (list(boundaries) if boundaries is not None
                           else self._balance(self._n_units()))
        self.devices = (list(devices) if devices is not None
                        else [model.device] * self.n_stages)
        self.iteration_count = 0
        self._score = float("nan")
        self.place()

    def _check(self, model, out_cls):
        n_layers = len(model.layers)
        if self.n_stages > n_layers:
            raise ValueError(f"{self.n_stages} stages > {n_layers} layers")
        if not isinstance(model.layers[-1], out_cls):
            raise ValueError("last layer must be an output layer")

    def _n_units(self) -> int:
        return len(self.model.layers)

    def _unit_sizes(self) -> list:
        return [sum(int(np.prod(v.shape)) for v in flat_leaves(p)) or 1
                for p in self.model.params]

    # -- stage partitioning (JAX's greedy threshold) ----------------------
    def _balance(self, n_layers: int) -> list:
        sizes = self._unit_sizes()
        total = sum(sizes)
        target = total / self.n_stages
        bounds, acc, need = [], 0.0, 1
        for i, sz in enumerate(sizes):
            remaining_layers = len(sizes) - i
            remaining_stages = self.n_stages - need + 1
            if (acc + sz / 2 >= target * need
                    and need < self.n_stages
                    and remaining_layers > remaining_stages - 1):
                bounds.append(i)
                need += 1
            acc += sz
        while len(bounds) < self.n_stages - 1:
            for i in range(n_layers - 1, 0, -1):
                if i not in bounds:
                    bounds.append(i)
                    break
            bounds.sort()
        return bounds[:self.n_stages - 1]

    def _stage_range(self, s: int):
        lo = 0 if s == 0 else self.boundaries[s - 1]
        hi = (self._n_units() if s == self.n_stages - 1
              else self.boundaries[s])
        return lo, hi

    def stage_of(self, i: int) -> int:
        return next(s for s in range(self.n_stages)
                    if self._stage_range(s)[0] <= i < self._stage_range(s)[1])

    def place(self):
        """Each layer's params, state and updater state on its stage's
        device (the trainer's `_prepare`: a restore re-places here)."""
        m = self.model
        to = lambda t, d: tree_map(lambda a: a.to(d) if isinstance(
            a, torch.Tensor) else a, t)
        dev = [self.devices[self.stage_of(i)] for i in range(len(m.layers))]
        m.params = tuple(to(p, d) for p, d in zip(m.params, dev))
        m.state = tuple(to(p, d) for p, d in zip(m.state, dev))
        m.updater_state = tuple(to(p, d)
                                for p, d in zip(m.updater_state, dev))

    # -- the step ----------------------------------------------------------
    def fit(self, data, epochs: int = 1):
        if isinstance(data, (DataSet, MultiDataSet)):
            self._fit_batch(data)
            return self
        for _ in range(epochs):
            data.reset()
            while data.has_next():
                self._fit_batch(data.next())
        return self

    def _fit_batch(self, ds):
        from ..nn.conf.base import cast_floating
        from ..nn.layers.feedforward import BaseOutputLayerConf

        if ds.features_mask is not None:
            raise ValueError(
                "pipeline trainer does not support features masks "
                "(time_buckets padding); the weight-zero LABELS mask "
                "(pad_ragged) threads through the last-stage loss")
        m = self.model
        d0 = self.devices[0]
        x = torch.as_tensor(np.asarray(ds.features)).to(d0)
        y = torch.as_tensor(np.asarray(ds.labels))
        lmask = (None if ds.labels_mask is None
                 else torch.as_tensor(np.asarray(ds.labels_mask)))
        B, M, S = int(x.shape[0]), self.n_microbatches, self.n_stages
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        if lmask is None:
            b_live = float(B)
        else:
            live = lmask.to(torch.float32).reshape(B, -1).amax(dim=1)
            b_live = max(1.0, float(live.sum()))
        cdt = m._compute_dtype
        gen = m._train_generator()
        layers = m.layers
        n = len(layers)
        params = [tree_map(lambda a, f=layer.frozen: a.detach()
                           .requires_grad_(not f and a.is_floating_point()),
                           p) for layer, p in zip(layers, m.params)]
        new_state = list(m.state)
        preproc = m.conf.preprocessors
        dlast = self.devices[S - 1]
        losses = []
        # forward phase: every microbatch through every stage
        outs = []
        with torch.enable_grad():
            for xm, ym, lmm in zip(x.chunk(M), y.chunk(M),
                                   [None] * M if lmask is None
                                   else lmask.chunk(M)):
                h = xm.to(cdt) if (cdt is not None
                                   and xm.is_floating_point()) else xm
                for s in range(S):
                    lo, hi = self._stage_range(s)
                    h = h.to(self.devices[s])
                    for i in range(lo, min(hi, n - 1)):
                        if i in preproc:
                            h = preproc[i].apply(h)
                        p_i = params[i]
                        if cdt is not None and not isinstance(
                                layers[i], BaseOutputLayerConf):
                            p_i = cast_floating(p_i, cdt)
                        h, new_state[i] = layers[i].apply(
                            p_i, new_state[i], h, train=True, generator=gen,
                            mask=None)
                if n - 1 in preproc:
                    h = preproc[n - 1].apply(h)
                loss = layers[-1].loss_score(
                    params[-1], new_state[-1], h, ym.to(dlast), train=True,
                    generator=gen,
                    mask=None if lmm is None else lmm.to(dlast))
                outs.append(loss)
            # backward phase: the microbatches in turn, gradients summed
            for loss in outs:
                torch.autograd.backward(loss / M)
            reg_total = 0.0
            for layer, p in zip(layers, params):
                if p:
                    r = layer.reg_score(p)
                    if isinstance(r, torch.Tensor) and r.requires_grad:
                        torch.autograd.backward(r / b_live)
                    reg_total += float(r.detach()) if isinstance(
                        r, torch.Tensor) else float(r)
        losses = [float(l.detach()) for l in outs]
        sign = 1.0 if m.conf.conf.minimize else -1.0
        grads = [tree_map(lambda a: (torch.zeros_like(a) if a.grad is None
                                     else a.grad * sign)
                          if isinstance(a, torch.Tensor) else a, p)
                 for p in params]
        detached = [tree_map(torch.Tensor.detach, p) for p in params]
        new_p, new_o = [], []
        for s in range(S):
            lo, hi = self._stage_range(s)
            p_s, o_s = m.apply_layer_updates(
                layers[lo:hi], detached[lo:hi], grads[lo:hi],
                list(m.updater_state[lo:hi]), self.iteration_count)
            new_p.extend(p_s)
            new_o.extend(o_s)
        m.params, m.updater_state = tuple(new_p), tuple(new_o)
        m.state = tuple(tree_map(lambda a: a.detach() if isinstance(
            a, torch.Tensor) else a, st) for st in new_state)
        self._score = float(np.mean(losses) + reg_total / b_live)
        self.iteration_count += 1
        m.iteration_count = self.iteration_count

    def score(self) -> float:
        return float(self._score)

    def sync_back(self):
        """The model's trees on its own device again."""
        m = self.model
        dev = m.device
        to = lambda t: tree_map(lambda a: a.to(dev) if isinstance(
            a, torch.Tensor) else a, t)
        m.params = tuple(to(p) for p in m.params)
        m.state = tuple(to(p) for p in m.state)
        m.updater_state = tuple(to(p) for p in m.updater_state)
        return m


class PipelinedGraphTrainer(PipelinedNetworkTrainer):
    """GPipe-schedule pipeline training of a ComputationGraph in one
    process (JAX's): stages are contiguous ranges of the topological
    order cut only where exactly one value crosses the cut (a clean cut:
    every value produced before the position and consumed at or after it
    is that one value), balanced by parameter count among the clean cuts.
    A step runs the graph's own loss on each microbatch with each vertex's
    parameters on its stage's device, forwards first, then backwards, and
    updates each vertex with its updater."""

    def _check(self, model, out_cls):
        self._order = [n for n in model.conf.topological_order
                       if n in model.conf.vertices]
        if self.n_stages > len(self._order):
            raise ValueError(f"{self.n_stages} stages > "
                             f"{len(self._order)} vertices")
        cuts = self.clean_cuts()
        if len(cuts) < self.n_stages - 1:
            raise ValueError(
                f"the graph has {len(cuts)} clean cut(s) (a position "
                "where exactly one value crosses), too few for "
                f"{self.n_stages} stages")

    def clean_cuts(self) -> list:
        """Positions p of the topological order where exactly one value
        produced before p is consumed at or after p."""
        m = self.model
        order = self._order
        pos = {name: i for i, name in enumerate(order)}
        cuts = []
        for p in range(1, len(order)):
            live = set()
            for name in order[p:]:
                for src in m.conf.vertex_inputs[name]:
                    if src in pos and pos[src] < p:
                        live.add(src)
            if len(live) == 1:
                cuts.append(p)
        return cuts

    def _n_units(self) -> int:
        return len(self._order)

    def _unit_sizes(self) -> list:
        return [sum(int(np.prod(v.shape)) for v in flat_leaves(
            self.model.params.get(name, {}))) or 1 for name in self._order]

    def _balance(self, n_layers: int) -> list:
        want = super()._balance(n_layers)
        cuts = self.clean_cuts()
        out = []
        for b in want:      # each boundary snapped to the nearest clean cut
            c = min((c for c in cuts if c not in out),
                    key=lambda c: (abs(c - b), c))
            out.append(c)
        return sorted(out)

    def stage_of_vertex(self, name: str) -> int:
        return self.stage_of(self._order.index(name))

    def place(self):
        m = self.model
        to = lambda t, d: tree_map(lambda a: a.to(d) if isinstance(
            a, torch.Tensor) else a, t)
        dev = {name: self.devices[self.stage_of_vertex(name)]
               for name in self._order}
        m.params = {k: to(v, dev[k]) for k, v in m.params.items()}
        m.state = {k: to(v, dev[k]) for k, v in m.state.items()}
        m.updater_state = {k: to(v, dev[k])
                           for k, v in m.updater_state.items()}

    def _fit_batch(self, ds):
        m = self.model
        inputs = m._to_inputs(ds)
        x, y, fm, lm = inputs
        if fm and any(v is not None for v in fm.values()):
            raise ValueError("pipeline trainer does not support features "
                             "masks")
        first = next(iter(x.values()))
        B, M = int(first.shape[0]), self.n_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        chunk = lambda d: None if d is None else {
            k: (None if v is None else v.chunk(M)) for k, v in d.items()}
        xc, yc, lc = chunk(x), chunk(y), chunk(lm)
        total = None
        scores = []
        for i in range(M):
            pick = lambda c: None if c is None else {
                k: (None if v is None else v[i]) for k, v in c.items()}
            score, new_state, grads, _ = m._grad_fn(
                m.params, m.state, (pick(xc), pick(yc), None, pick(lc)))
            scores.append(float(score))
            total = grads if total is None else tree_map(
                lambda a, b: a + b, total, grads)
            m.state = new_state
        grads = tree_map(lambda a: a / M, total)
        new_p, new_o = m.apply_updates(m.params, grads, m.updater_state,
                                       self.iteration_count)
        m.params, m.updater_state = new_p, new_o
        self._score = float(np.mean(scores))
        self.iteration_count += 1
        m.iteration_count = self.iteration_count

    def sync_back(self):
        m = self.model
        dev = m.device
        to = lambda t: tree_map(lambda a: a.to(dev) if isinstance(
            a, torch.Tensor) else a, t)
        m.params = {k: to(v) for k, v in m.params.items()}
        m.state = {k: to(v) for k, v in m.state.items()}
        m.updater_state = {k: to(v) for k, v in m.updater_state.items()}
        return m
