"""ZeRO-style sharded data parallelism, stages 1 and 2, and the FSDP step
(the port of `deeplearning4j_tpu/parallel/zero.py`).

JAX expresses ZeRO GSPMD-natively: sharding constraints on the moments and
the updated parameters, and XLA inserts the collectives. The port issues
them by hand from `torch.distributed` primitives, one rank per device:

  reduce-scatter grads -> each rank updates only ITS shard of the moments
  and params            -> all-gather of the updated params

Layout. A parameter leaf is "sharded" when JAX would shard it: it has an
axis the data-axis size divides (`_fsdp_spec_for`); every other leaf is
replicated, reduced with an all-reduce and updated in full on every rank
(its update cost is noise). Rank r's shard of a sharded leaf is the r-th
of N equal chunks of its flattened elements (N divides the size because
it divides an axis). A gradient bucket (`assign_buckets`, the same greedy
pack of the same sizes in backward-production order as JAX's) is one
collective: its sharded leaves are laid out rank-major, so one
`reduce_scatter_tensor` hands each rank the chunks of every leaf in the
bucket, and one `all_gather_into_tensor` gives the updated chunks back.

Stages:
  * ZERO1 — the gradients are all-reduced in full (per-tensor gradient
    normalization reads whole tensors), the update runs on the rank's
    chunks with the rank's moment chunks, the params are all-gathered.
  * ZERO2 — the gradients are reduce-scattered bucket by bucket, so no
    rank holds the reduced gradient tree; `reduce_dtype` ("bfloat16")
    narrows the wire of that reduction, the update stays in the
    gradient's dtype (fp32 masters).
  * FSDP — ZERO2's reduction and update, and the params stay sharded
    between steps: the step all-gathers them before the forward.

The updater state of a sharded leaf lives as its chunk (`to_plan_opt`,
`from_plan_opt` convert with the model's tree form, gathering the chunks).
Updaters must be elementwise (`_check_updaters`). A per-layer or
per-tensor gradient normalization under ZERO2 / FSDP takes its norms from
the chunks, each chunk's sum of squares all-reduced over the ranks.

The static accounting (`_ZeroPlan.info`: bytes by collective, bucket
count, accumulator and per-device footprints) is JAX's formula on the same
layout, so telemetry counters and the collective-sequence hash agree
across the packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import MeshAxes
from .sharding import (PartitionSpec as P, _fsdp_spec_for,
                       batch_norm_layers, model_updater_pairs)
from ..nn.trees import flat_leaves, flatten_tree, tree_map

__all__ = ["ZeroConfig", "assign_buckets", "collective_overlap_fraction",
           "make_zero_accum_superstep", "make_zero_step",
           "zero_grad_specs", "zero_opt_shardings"]

DEFAULT_BUCKET_MB = 4.0


@dataclass(frozen=True)
class ZeroConfig:
    """Knobs for the ZeRO step (JAX's).

    stage         1 (shard optimizer state) or 2 (+ shard reduced grads).
    bucket_mb     gradient-bucket size bound in MiB (stage 2).
    reduce_dtype  optional wire dtype for the stage-2 gradient reduction
                  (e.g. "bfloat16"); the update runs in the gradient dtype.

    JAX's `ordered_flush` is not here: the port issues its collectives in
    program order, so buckets always flush in production order.
    """

    stage: int = 1
    bucket_mb: float = DEFAULT_BUCKET_MB
    reduce_dtype: Optional[str] = None


# the collectives: the port's collective layer (`collectives.py`), which
# stages CUDA tensors through the host for gloo where gloo needs it
from .collectives import all_gather_, all_reduce_, reduce_scatter_  # noqa: E402,F401


# ----------------------------------------------------------------------
# the static layout
# ----------------------------------------------------------------------
def zero_grad_specs(params, mesh, data_axis: str = MeshAxes.DATA,
                    base=None):
    """Per-leaf PartitionSpec tree: each gradient / moment tensor sharded
    over `data` on its largest divisible dimension, the rest replicated
    (JAX's). With a tensor-parallel `base` (a spec tree of the params'
    model-axis layout) a leaf keeps its base entries and takes `data` on
    the largest other divisible axis of its model shard: moments over
    (model, data)."""
    if base is None:
        return tree_map(lambda a: _fsdp_spec_for(tuple(a.shape), data_axis,
                                                 mesh), params)
    size = int(mesh.shape[data_axis])

    def one(a, b):
        spec = list(b) + [None] * (a.dim() - len(b))
        shape = [d // int(mesh.shape[e]) if e is not None else d
                 for d, e in zip(a.shape, spec)]
        for ax in sorted(range(a.dim()), key=lambda i: -shape[i]):
            if spec[ax] is None and shape[ax] % size == 0 \
                    and shape[ax] >= size:
                spec[ax] = data_axis
                return P(*spec)
        return P(*spec)
    return tree_map(one, params, base)


def zero_opt_shardings(opt_state, params, mesh,
                       data_axis: str = MeshAxes.DATA, base=None):
    """The PartitionSpec tree of the optimizer state: each moment leaf
    takes its parameter's ZeRO spec, other leaves replicated."""
    specs = zero_grad_specs(params, mesh, data_axis, base=base)
    return _per_moment(opt_state, lambda m, spec: spec, specs,
                       other=lambda _: P())


def _per_moment(opt_state, fn, *param_trees, other=lambda x: x):
    """`fn(moment, *param leaves)` over the moment leaves of a model's
    updater state (one dict a layer or vertex, each state name's subtree
    shaped like the layer's parameter dict), `other(leaf)` elsewhere.
    `param_trees` are parameter-shaped trees of the whole model."""
    def layer(os, *per):
        if not isinstance(os, dict):
            return tree_map(other, os)
        out = {}
        for k, sub in os.items():
            try:
                out[k] = tree_map(fn, sub, *per)
            except (KeyError, TypeError, IndexError):
                out[k] = tree_map(other, sub)
        return out
    if isinstance(opt_state, dict):
        return {name: layer(os, *(t[name] for t in param_trees))
                for name, os in opt_state.items()}
    return type(opt_state)(layer(os, *per) for os, *per in
                           zip(opt_state, *param_trees))


def assign_buckets(sizes: Sequence[int], bucket_bytes: int
                   ) -> List[List[int]]:
    """Greedy, order-preserving pack of leaf indices into size-bounded
    buckets (JAX's). `sizes` must already be in gradient PRODUCTION order
    (the caller reverses the forward layer order). A leaf larger than the
    bound gets a bucket of its own; every index lands in exactly one
    bucket."""
    cap = max(1, int(bucket_bytes))
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_b = 0
    for i, b in enumerate(sizes):
        b = int(b)
        if cur and cur_b + b > cap:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += b
    if cur:
        buckets.append(cur)
    return buckets


def _check_updaters(model):
    """ZeRO partitions the update elementwise over the data axis; an
    updater whose state transform is NOT elementwise would need whole
    tensors — refuse it up front."""
    for layer, p in model_updater_pairs(model):
        if not p or getattr(layer, "frozen", False):
            continue
        upd = model._layer_updater(layer)
        if not getattr(upd, "elementwise_state", True):
            raise ValueError(
                f"updater {type(upd).__name__} declares "
                "elementwise_state=False — its update cannot be sharded "
                "over the data axis; use ShardingStrategy.REPLICATED for "
                "this model")


class _Leaf:
    __slots__ = ("index", "shape", "numel", "itemsize", "dtype",
                 "sharded", "chunk", "bucket", "offset")


class _ZeroPlan:
    """The static ZeRO layout and the collectives that run it, shared by
    the per-batch step (`make_zero_step`), the accumulated superstep
    (`make_zero_accum_superstep`) and the trainer. `stage` 3 is the FSDP
    step (stage 2's reduction, params sharded between steps); it publishes
    no accounting, as JAX's FSDP does not."""

    def __init__(self, model, mesh, data_axis: str, config: ZeroConfig,
                 base_specs=None, model_axis: Optional[str] = None,
                 params=None, opt_state=None, fsdp: bool = False,
                 layers=None):
        if params is None:
            params = model.params
        if opt_state is None:
            opt_state = model.updater_state
        if config.stage not in (1, 2):
            raise ValueError(
                f"ZeRO stage must be 1 or 2, got {config.stage}")
        if config.stage == 1 and config.reduce_dtype is not None:
            raise ValueError(
                "reduce_dtype (zero_reduce_dtype=) only applies to ZERO2 "
                "— stage 1 reduces gradients in their own dtype; use "
                "ShardingStrategy.ZERO2 or drop the knob")
        # `params` may be a tensor-parallel rank's shards (ZERO1_TP: the
        # moments then shard over (model, data)); the shards' shapes carry
        # the layout, `base_specs` says the caller composes with TP
        if base_specs is not None and config.stage >= 2:
            raise ValueError(
                "ZeRO stage 2 does not compose with tensor-parallel base "
                "specs yet — use stage 1 (ShardingStrategy.ZERO1_TP)")
        self.fsdp = bool(fsdp)
        self.layers = layers
        self.stage = 2 if self.fsdp else config.stage
        _check_updaters(model)
        self.config = config
        self.model = model
        self.mesh = mesh
        self.n = int(mesh.shape[data_axis])
        # the data group: the mesh's own when the data axis spans it
        self.group = (mesh.group if self.n == int(np.prod(list(
            mesh.shape.values()))) else mesh.axis_group(data_axis))
        self.r = int(mesh.coords()[data_axis])
        self.wire_dtype = (None if config.reduce_dtype is None
                           else getattr(torch, str(config.reduce_dtype)))

        leaves, self._rebuild = flatten_tree(params)
        self.leaves: List[_Leaf] = []
        for i, a in enumerate(leaves):
            lf = _Leaf()
            lf.index, lf.shape = i, tuple(a.shape)
            lf.numel, lf.itemsize, lf.dtype = a.numel(), a.element_size(), \
                a.dtype
            spec = _fsdp_spec_for(lf.shape, data_axis, mesh)
            lf.sharded = any(e is not None for e in spec)
            lf.chunk = lf.numel // self.n if lf.sharded else lf.numel
            self.leaves.append(lf)
        counts = [lf.numel for lf in self.leaves]
        itemsize = [lf.itemsize for lf in self.leaves]
        red_itemsize = (torch.empty((), dtype=self.wire_dtype).element_size()
                        if self.wire_dtype is not None else None)
        order = list(range(len(leaves)))[::-1]
        wire = lambda i: counts[i] * (red_itemsize or itemsize[i])
        self.buckets = [[order[j] for j in b] for b in assign_buckets(
            [wire(i) for i in order], int(config.bucket_mb * (1 << 20)))]
        for bi, bucket in enumerate(self.buckets):
            off = 0
            for i in bucket:
                lf = self.leaves[i]
                lf.bucket = bi
                if lf.sharded:
                    lf.offset, off = off, off + lf.chunk
        self.sharded_set = {lf.index for lf in self.leaves if lf.sharded}
        # a per-layer tree of flags: which of the layer's leaves shard
        flags = [lf.sharded for lf in self.leaves]
        self.flag_tree = self._rebuild(flags)

        # ---- JAX's static accounting on the same layout ------------------
        sharded_idx = sorted(self.sharded_set)
        rs_bytes = sum(wire(i) for i in sharded_idx)
        full_bytes = sum(wire(i) for i in range(len(leaves)))
        ag_bytes = sum(counts[i] * itemsize[i] for i in sharded_idx)
        n_dev = self.n
        acc_sharded = sum(
            (-(-counts[i] // n_dev) if i in self.sharded_set else counts[i])
            * 4 for i in range(len(leaves)))
        acc_repl = sum(counts[i] * 4 for i in range(len(leaves)))
        param_local = sum(counts[i] * itemsize[i] for i in range(len(leaves)))
        moment_local = sum(
            counts[i] // (n_dev if i in self.sharded_set else 1)
            * itemsize[i] for i in range(len(leaves)))
        self.info = {
            "stage": config.stage,
            "n_buckets": len(self.buckets) if config.stage >= 2 else 0,
            "sharded_leaves": len(sharded_idx),
            "replicated_leaves": len(leaves) - len(sharded_idx),
            "devices": n_dev,
            "mesh_axes": {"data": n_dev,
                          "model": int(mesh.shape.get(model_axis or
                                                      "model", 1))},
            "collective_axis": data_axis,
            "accum_bytes": {"sharded": acc_sharded, "replicated": acc_repl},
            "per_device_bytes": {"params": param_local,
                                 "moments_per_state": moment_local},
            "bytes": ({"reduce_scatter": rs_bytes,
                       "all_reduce": full_bytes - rs_bytes,
                       "all_gather": ag_bytes}
                      if config.stage >= 2 else
                      {"reduce_scatter": 0,
                       "all_reduce": sum(counts[i] * itemsize[i]
                                         for i in range(len(leaves))),
                       "all_gather": ag_bytes}),
        }

    # -- chunks ----------------------------------------------------------
    def _chunk(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(self.n, -1)[self.r]

    def shard_tree(self, tree, flags=None):
        """A parameter-shaped tree with its sharded leaves cut to this
        rank's chunk."""
        flags = self.flag_tree if flags is None else flags
        return tree_map(lambda a, f: self._chunk(a).clone() if f else a,
                        tree, flags)

    def to_plan_opt(self, opt_state):
        """The model's updater state in the plan's form (moment chunks)."""
        return _per_moment(opt_state, lambda m, f: (
            self._chunk(m).clone() if f else m), self.flag_tree)

    def _gather_leaf(self, chunk: torch.Tensor, shape) -> torch.Tensor:
        out = torch.empty(self.n * chunk.numel(), dtype=chunk.dtype,
                          device=chunk.device)
        all_gather_(out, chunk.contiguous().reshape(-1), self.group)
        return out.reshape(shape)

    def from_plan_opt(self, opt_form, params_full):
        """The full updater state from the plan's form (all-gathers every
        moment chunk)."""
        return _per_moment(
            opt_form, lambda m, f, p: (self._gather_leaf(m, p.shape) if f
                                       else m), self.flag_tree, params_full)

    def gather_params(self, params_form):
        """The full parameter tree from its sharded form (FSDP's between
        steps, ZERO1 / ZERO2's after the update), one all-gather a
        bucket."""
        leaves, _ = flatten_tree(params_form)
        out = list(leaves)
        for bucket in self.buckets:
            sh = [i for i in bucket if self.leaves[i].sharded]
            if not sh:
                continue
            flat = torch.cat([leaves[i].reshape(-1) for i in sh])
            full = torch.empty(self.n * flat.numel(), dtype=flat.dtype,
                               device=flat.device)
            all_gather_(full, flat, self.group)
            full = full.reshape(self.n, -1)
            for i in sh:
                lf = self.leaves[i]
                out[i] = full[:, lf.offset:lf.offset + lf.chunk].reshape(
                    lf.shape)
        return self._rebuild(out)

    # -- the gradient reduction ----------------------------------------
    def reduce(self, grads):
        """The summed gradient in the plan's form: stage 1 all-reduces
        every leaf (one coalesced collective, full leaves back); stage 2
        reduce-scatters each bucket's sharded leaves (their chunks back)
        and all-reduces its replicated ones, in the wire dtype."""
        flat, _ = flatten_tree(grads)
        dtypes = [g.dtype for g in flat]
        if self.wire_dtype is not None:
            flat = [g.to(self.wire_dtype) for g in flat]
        out = list(flat)
        if self.stage == 1:
            buf = torch.cat([g.reshape(-1) for g in flat])
            all_reduce_(buf, self.group)
            pos = 0
            for i, g in enumerate(flat):
                out[i] = buf[pos:pos + g.numel()].reshape(g.shape)
                pos += g.numel()
        else:
            for bucket in self.buckets:
                sh = [i for i in bucket if self.leaves[i].sharded]
                rep = [i for i in bucket if not self.leaves[i].sharded]
                if sh:
                    inp = torch.cat([flat[i].reshape(self.n, -1)
                                     for i in sh], dim=1).reshape(-1)
                    got = torch.empty(inp.numel() // self.n,
                                      dtype=inp.dtype, device=inp.device)
                    reduce_scatter_(got, inp, self.group)
                    for i in sh:
                        lf = self.leaves[i]
                        out[i] = got[lf.offset:lf.offset + lf.chunk]
                if rep:
                    buf = torch.cat([flat[i].reshape(-1) for i in rep])
                    all_reduce_(buf, self.group)
                    pos = 0
                    for i in rep:
                        out[i] = buf[pos:pos + flat[i].numel()].reshape(
                            flat[i].shape)
                        pos += flat[i].numel()
        if self.wire_dtype is not None:
            out = [g.to(dt) for g, dt in zip(out, dtypes)]
        return self._rebuild(out)

    def grad_template(self, params_form):
        """A tree shaped like the reduced gradients (the float32
        accumulators of an accumulated step take its shapes)."""
        return tree_map(
            lambda a, f: (a if (not f or self.stage == 1 or self.fsdp)
                          else self._chunk(a)), params_form, self.flag_tree)

    # -- the update on this rank's shard -----------------------------------
    def update(self, params_form, grads_form, opt_form, step=None,
               scalars=None):
        """The update of the plan's forms: gradient normalization on whole
        gradients (stage 1), each trainable layer's updater on its chunks
        (the replicated leaves whole), then the all-gather of the new
        chunks (ZERO1 / ZERO2; FSDP keeps them). `scalars` is the step's
        scalar row (a replay's) or None (the host computes them from
        `step`), as the model's own update takes them."""
        from ..nn.gradnorm import apply_gradient_normalization
        from ..nn.multilayer import _n_scalars, _rescale_bias_updates, \
            layer_scalars

        model = self.model
        graph = isinstance(params_form, dict)
        names = list(params_form) if graph else range(len(params_form))
        layers = (model.conf.vertices if graph
                  else self.layers or model.layers)
        new_p, new_o, off = {}, {}, 0
        for key in names:
            layer = layers[key]
            p, g, os = params_form[key], grads_form[key], opt_form[key]
            flags = self.flag_tree[key]
            if not p or layer.frozen:
                new_p[key], new_o[key] = p, os
                continue
            if self.stage == 1:
                g = apply_gradient_normalization(
                    layer.gradient_normalization,
                    layer.gradient_normalization_threshold or 1.0, g)
                g = tree_map(lambda a, f: self._chunk(a) if f else a,
                             g, flags)
            else:
                g = apply_gradient_normalization(
                    layer.gradient_normalization,
                    layer.gradient_normalization_threshold or 1.0, g,
                    self._chunk_sumsq(g, flags))
            if not self.fsdp:
                p = tree_map(lambda a, f: self._chunk(a) if f else a,
                             p, flags)
            p = tree_map(torch.Tensor.detach, p)
            upd = model._layer_updater(layer)
            if scalars is None:
                sc = layer_scalars(model, layer, step)
            else:
                n = _n_scalars(model, layer)
                sc = tuple(scalars[off + j] for j in range(n))
                off += n
            n_upd = len(sc) - (layer.bias_learning_rate is not None)
            updates, os = upd.apply(g, os, sc[:n_upd])
            if layer.bias_learning_rate is not None:
                updates = _rescale_bias_updates(updates, sc[-1])
            new_p[key] = tree_map(lambda a, u: a - u, p, updates)
            new_o[key] = os
        if graph:
            params_out, opt_out = new_p, new_o
        else:
            params_out = tuple(new_p[i] for i in names)
            opt_out = tuple(new_o[i] for i in names)
        if self.fsdp:
            return params_out, opt_out
        # ZERO1 / ZERO2's trailing all-gather: every rank's updated chunks
        # back into whole, replicated parameters
        return self.gather_params(params_out), opt_out

    def _chunk_sumsq(self, grads, flags):
        """A leaf's whole-tensor sum of squares for a gradient tree whose
        sharded leaves are this rank's chunks: a chunk's partial sum is
        all-reduced over the ranks (stage 2's per-layer normalization)."""
        chunks = {id(a) for a, f in zip(flat_leaves(grads),
                                        flat_leaves(flags)) if f}

        def sumsq(a):
            s = (a * a).sum()
            if id(a) in chunks:
                s = all_reduce_(s.reshape(1), self.group).reshape(())
            return s
        return sumsq

    def expected_constraints(self, accum: bool = False) -> int:
        """JAX's count of sharding-constraint sites in one trace of the
        step, on this layout (reported in `info` for parity; the port has
        no constraints to count: its collectives are explicit)."""
        n_sharded = len(self.sharded_set)
        n_opt = len(flat_leaves(self.model.updater_state))
        stage2 = self.config.stage >= 2
        count = n_sharded + n_opt
        if stage2:
            count += n_sharded
        if accum and stage2:
            count += 3 * n_sharded
        return count


def _batch_group(model, mesh, data_axis):
    """The batch-statistics block of a ZeRO step: a BatchNormalization
    normalises by the global batch's statistics past one data rank (the
    caller pre-weights each rank's loss, so the ranks' gradients meet as
    they are)."""
    from .collectives import batch_statistics_group
    n = int(mesh.shape[data_axis])
    if n > 1 and batch_norm_layers(model):
        return lambda: batch_statistics_group(mesh.axis_group(data_axis), n)
    import contextlib
    return contextlib.nullcontext


def make_zero_step(model, mesh, *, data_axis: str = MeshAxes.DATA,
                   config: ZeroConfig = ZeroConfig(), base_specs=None,
                   model_axis: Optional[str] = None
                   ) -> Tuple[Any, Dict[str, Any]]:
    """The ZeRO train step for `model` on this rank: `step(params, state,
    opt, step_i, batch) -> (params, state, opt, score)`, with `params`
    whole and `opt` in the plan's form (`_ZeroPlan.to_plan_opt`), `batch`
    this rank's rows. The gradient is the rank's local gradient summed
    over the data axis, so each rank's loss must be pre-weighted by its
    share of the global batch (the trainer's `_global_grad` does that).
    Returns (step, info)."""
    bn = _batch_group(model, mesh, data_axis)
    plan = _ZeroPlan(model, mesh, data_axis, config, base_specs=base_specs,
                     model_axis=model_axis)
    plan.info["expected_constraints"] = plan.expected_constraints()

    def step(params, state, opt_state, step_i, batch):
        with bn():
            score, new_state, grads, _ = model._grad_fn(params, state,
                                                        batch)
        grads = plan.reduce(grads)
        new_params, new_opt = plan.update(params, grads, opt_state,
                                          step=step_i)
        return new_params, new_state, new_opt, score

    step.plan = plan
    return step, plan.info


def make_zero_accum_superstep(model, mesh, *,
                              data_axis: str = MeshAxes.DATA,
                              config: ZeroConfig = ZeroConfig(),
                              skip_nonfinite: bool = False,
                              base_specs=None,
                              model_axis: Optional[str] = None
                              ) -> Tuple[Any, Dict[str, Any]]:
    """The ZeRO ACCUMULATED superstep: for each optimizer step, every
    microbatch's gradient is reduced as it is produced (ZERO2:
    reduce-scattered, so the float32 accumulator holds only this rank's
    chunks, ~1/N of the tree) and summed; the update then runs once on the
    mean, followed by ONE all-gather. Signature as
    `nn/superstep.build_accum_superstep`'s: `superstep(params, state, opt,
    step0, groups) -> (params, state, opt, scores[K], micro[K, M])`."""
    from ..nn.superstep import build_accum_superstep

    bn = _batch_group(model, mesh, data_axis)
    plan = _ZeroPlan(model, mesh, data_axis, config, base_specs=base_specs,
                     model_axis=model_axis)
    plan.info["expected_constraints"] = plan.expected_constraints(
        accum=True)

    def grad_fn(params, state, batch):
        with bn():
            score, new_state, grads, _ = model._grad_fn(params, state,
                                                        batch)
        return score, new_state, plan.reduce(grads)

    def update_fn(params, gmean, opt, step):
        return plan.update(params, gmean, opt, step=step)

    fn = build_accum_superstep(grad_fn, update_fn, skip_nonfinite)
    fn.plan = plan
    return fn, plan.info


def collective_overlap_fraction(info: Dict[str, Any], m: int) -> float:
    """Structural collective/compute overlap for the telemetry gauge
    ``dl4j_collective_overlap_fraction`` (JAX's formula): with M
    accumulation microbatches and B buckets a backward, every flush but
    the last still has backward work behind it, 1 - 1/(M·B); stage 1
    defers its reduction to the step end: 0.0. Schedule accounting, not a
    wall-clock measurement."""
    if int(info.get("stage", 1)) < 2 or not info.get("n_buckets"):
        return 0.0
    flushes = max(1, int(m)) * int(info["n_buckets"])
    return round(1.0 - 1.0 / flushes, 4)
