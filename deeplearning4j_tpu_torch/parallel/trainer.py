"""Training over `torch.distributed`: the port of
`deeplearning4j_tpu/parallel/trainer.py`. It stands in for the reference's
ParallelWrapper, Spark parameter averaging and parameter server, as JAX's
trainer does.

JAX runs one jitted SPMD step over a device mesh: the batch sharded over
"data", XLA inserting the gradient reduction. The port runs one rank per
device (`parallel/mesh.py`), each rank on its rows of the global batch,
and issues the collectives itself from `torch.distributed` primitives (no
DDP or FSDP wrapper: the parameters live in the port's own trees,
`nn/trees.py`, and the bucket plan, the collective accounting and the
ZeRO counters are JAX's, which a wrapper would hide):

  * SYNC / REPLICATED — every rank computes its rows' gradient, weighted by
    its share of the global loss's denominator, and one all-reduce sums
    the ranks' contributions: the gradient of the global batch's loss, as
    JAX's SPMD step computes it. The update then runs on every rank.
  * SYNC / ZERO1, ZERO2, FSDP — `parallel/zero.py`'s plan: all-reduce or
    bucketed reduce-scatter, the update on this rank's chunks, all-gather.
  * SYNC / TENSOR_PARALLEL, ZERO1_TP — Megatron over the mesh's "model"
    axis (`parallel/tp.py`): params model-sharded between steps, the
    gradient all-reduced over the data group; ZERO1_TP further chunks the
    moments over "data" (a stage-1 `_ZeroPlan` over the shards).
  * SYNC / PP, ZERO1_TP_PP — the 1F1B pipeline over "pipe"
    (`parallel/pipeline.py` `PipelinePlan`), composed with TP and ZeRO-1.
  * SYNC / PIPELINE — the host-driven GPipe of one process
    (`PipelinedNetworkTrainer`, `PipelinedGraphTrainer`), one stage per
    rank of the mesh's "pipe" axis (else its data axis), as JAX's; each
    rank runs every stage. Other stage splits build those trainers
    directly.
  * AVERAGING — every rank trains its own replica on its rows (local SGD)
    and every `averaging_frequency` steps the replicas' parameters (and,
    with `average_updaters`, their updater states) are averaged by an
    all-reduce (ParallelWrapper's `averagingFrequency`).

On the card `fit(superstep=K)` replays the trainer's step, collectives
included, from one captured CUDA graph (`nn/superstep.py`); the NCCL
communicator is made by an eager collective before any capture. A step
that cannot be captured (gloo's collectives, the pipeline's host-driven
schedule) raises `CaptureError`.

The model's layer state (an MoE layer's auxiliary loss) is averaged over
the data ranks after each SYNC step so the replicas stay equal. A
training BatchNormalization under SYNC over more than one data rank takes
the statistics of the global batch, as JAX's GSPMD step does
(`kernels/bn_split.py`: the split BN+ReLU kernels around an all-gather of
the ranks' (count, mean, M2)).

Evaluation, scoring and per-example scoring run in lockstep across the
data ranks: each rank takes its contiguous share of every batch, and the
results are merged (`distributed.allreduce_evaluation`,
`allgather_rows`) so every rank returns the same value.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch

from .mesh import MeshAxes, make_mesh
from .collectives import batch_statistics_group
from .sharding import ShardingStrategy, batch_norm_layers, broadcast_model
from .zero import (DEFAULT_BUCKET_MB, ZeroConfig, _ZeroPlan, all_reduce_,
                   collective_overlap_fraction)
from ..datasets.iterators import DataSet, MultiDataSet
from ..nn.trees import flat_leaves, flatten_tree, tree_map
from ..telemetry.runtime import active as _tel_active, null_span as _null_span

__all__ = ["ParallelTrainer", "ParallelWrapper", "TrainingMode",
           "configure_flash_attention"]

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingMode:
    SYNC = "sync"              # per-step gradient all-reduce
    AVERAGING = "averaging"    # local SGD, average params every N iterations


#: supported mode × strategy combinations (JAX's table)
_MODE_STRATEGIES = {
    TrainingMode.SYNC: (
        ShardingStrategy.REPLICATED, ShardingStrategy.TENSOR_PARALLEL,
        ShardingStrategy.FSDP, ShardingStrategy.ZERO1,
        ShardingStrategy.ZERO2, ShardingStrategy.ZERO1_TP,
        ShardingStrategy.PIPELINE, ShardingStrategy.PP,
        ShardingStrategy.ZERO1_TP_PP),
    TrainingMode.AVERAGING: (ShardingStrategy.REPLICATED,),
}

#: the 1F1B strategies (parallel/pipeline.py)
_PP_STRATEGIES = (ShardingStrategy.PP, ShardingStrategy.ZERO1_TP_PP)
#: strategies whose params live model-sharded between steps
_TP_STRATEGIES = (ShardingStrategy.TENSOR_PARALLEL, ShardingStrategy.ZERO1_TP)

#: strategies that compose with a (data, model) mesh of model axis > 1
_MESH2D_STRATEGIES = (ShardingStrategy.REPLICATED,
                      ShardingStrategy.TENSOR_PARALLEL,
                      ShardingStrategy.ZERO1_TP,
                      ShardingStrategy.ZERO1_TP_PP)

_MESH2D_HINTS = {
    ShardingStrategy.ZERO1: (
        "zero1 shards moments over 'data' only and would leave the model "
        "axis training redundant replicas — use strategy='zero1_tp' to "
        "shard params over 'model' AND moments over 'data'"),
    ShardingStrategy.ZERO2: (
        "zero2's bucketed reduce-scatter packs full-size gradient leaves "
        "and is not generalized to model-sharded gradients yet — use "
        "strategy='zero1_tp' (ZeRO-1 × tensor parallel)"),
    ShardingStrategy.FSDP: (
        "fsdp shards params over 'data'; composing it with a model axis "
        "is not supported — use strategy='zero1_tp'"),
    ShardingStrategy.PIPELINE: (
        "the pipeline trainer stages over its own 'pipe' axis — build "
        "the mesh with {'pipe': n} instead of a model axis"),
}


def _validate_mode_strategy(mode: str, strategy: str, mesh=None,
                            model_axis: str = MeshAxes.MODEL,
                            data_axis: str = MeshAxes.DATA,
                            pipe_axis: str = MeshAxes.PIPE) -> None:
    """One actionable error for every unsupported (mode, strategy, mesh)
    combination, before any model work (JAX's messages)."""
    pairs = "; ".join(
        f"{m}: {', '.join(s)}" for m, s in sorted(_MODE_STRATEGIES.items()))
    if mode not in _MODE_STRATEGIES:
        raise ValueError(
            f"unknown training mode '{mode}'. Supported mode -> "
            f"strategies: {pairs}")
    if strategy not in _MODE_STRATEGIES[TrainingMode.SYNC]:
        raise ValueError(
            f"unknown sharding strategy '{strategy}'. Supported mode -> "
            f"strategies: {pairs}")
    if strategy not in _MODE_STRATEGIES[mode]:
        hint = ""
        if mode == TrainingMode.AVERAGING:
            hint = (" — parameter averaging needs every device to hold an "
                    "independent FULL replica; use TrainingMode.SYNC for "
                    "sharded strategies (tensor_parallel/fsdp/zero1/zero2/"
                    "zero1_tp/pipeline)")
        raise ValueError(
            f"mode={mode} does not support strategy='{strategy}'{hint}. "
            f"Supported mode -> strategies: {pairs}")
    if mesh is None:
        return
    axes = dict(mesh.shape)
    model_size = int(axes.get(model_axis, 1))
    pipe_size = int(axes.get(pipe_axis, 1))
    if strategy in _TP_STRATEGIES and model_axis not in mesh.axis_names:
        raise ValueError(
            f"strategy='{strategy}' shards params over a '{model_axis}' "
            f"mesh axis, but the mesh only carries {mesh.axis_names}. "
            "Build a 2-D mesh: ParallelTrainer(model, mesh_shape=(d, m)) "
            "or mesh=make_mesh({'data': d, 'model': m})")
    if strategy in _PP_STRATEGIES:
        if pipe_axis not in mesh.axis_names or pipe_size < 2:
            raise ValueError(
                f"strategy='{strategy}' stages the model over a "
                f"'{pipe_axis}' mesh axis of size >= 2, but the mesh "
                f"carries {dict(axes)}. Build a 3-D mesh: "
                "ParallelTrainer(model, mesh_shape=(d, m, p))")
        if strategy == ShardingStrategy.PP \
                and (int(axes.get(data_axis, 1)) > 1 or model_size > 1):
            raise ValueError(
                f"strategy='pp' is the pure pipeline (data=model=1); the "
                f"mesh carries {dict(axes)} — use strategy='zero1_tp_pp' "
                "to compose data/model axes with the pipeline")
    elif pipe_size > 1 and strategy != ShardingStrategy.PIPELINE:
        raise ValueError(
            f"the mesh carries a '{pipe_axis}' axis of size {pipe_size}, "
            f"but strategy='{strategy}' does not stage over it — use "
            "strategy='pp' or 'zero1_tp_pp' (mesh-native 1F1B), "
            "strategy='pipeline' (host-driven GPipe), or drop the pipe "
            "axis")
    if model_size > 1:
        if mode == TrainingMode.AVERAGING:
            raise ValueError(
                f"mode={mode} does not support a 2-D mesh (model axis "
                f"size {model_size}) — parameter averaging keeps one "
                "independent replica per DATA device; use "
                "TrainingMode.SYNC with strategy='tensor_parallel' or "
                "'zero1_tp' on 2-D meshes")
        if strategy not in _MESH2D_STRATEGIES:
            raise ValueError(
                f"strategy='{strategy}' does not support a 2-D mesh "
                f"(model axis size {model_size}): "
                f"{_MESH2D_HINTS[strategy]}. Supported 2-D strategies: "
                f"{', '.join(_MESH2D_STRATEGIES)}")


def configure_flash_attention(model, mesh, strategy,
                              model_axis: str = MeshAxes.MODEL,
                              data_axis: str = MeshAxes.DATA, force=None):
    """The attention implementation of the trainer's TransformerBlocks
    (JAX's probe, its choice and its log line). Under TENSOR_PARALLEL and
    ZERO1_TP the mode is "spmd" (`flash_attention_spmd`): each rank runs
    kernels 1-3 on its local [B/d, T, H/m, Dh] block, heads sharded by the
    Megatron roles, no collective inside attention. Elsewhere each rank
    runs the kernel on its rows ("kernel"). The port has no einsum
    fallback: a CUDA tensor always takes the kernel, a CPU tensor its
    plain version, so `force=False` (JAX's einsum) raises. Returns (mode,
    reason); (None, reason) when the model has no attention layers."""
    from ..nn.layers.transformer import TransformerBlock

    layers = (model.conf.vertices.values()
              if isinstance(model.params, dict)
              else getattr(model, "layers", ()) or ())
    blocks = [c for c in layers if isinstance(c, TransformerBlock)]
    if not blocks:
        return None, "no attention layers"
    if force is False:
        raise ValueError(
            "the port's TransformerBlock has no einsum switch: each rank "
            "runs the attention kernel on its rows")
    if force == "spmd" or (force is None and strategy in _TP_STRATEGIES):
        mode = "spmd"
        reason = ("kernels 1-3 per rank on its local [B/d, T, H/m, Dh] "
                  f"block over ('{data_axis}', '{model_axis}') — zero "
                  "collectives in the kernel region"
                  + (" (forced)" if force == "spmd" else ""))
    elif force is not None:
        raise ValueError(f"unknown flash mode {force!r} (None, 'spmd')")
    else:
        mode = "kernel"
        reason = (f"kernel 1 per rank on its rows ({len(blocks)} block(s), "
                  f"strategy={strategy})")
    log.info("flash attention [%d layer(s), strategy=%s]: %s", len(blocks),
             strategy, reason)
    return mode, reason


def _first_ranks(axes):
    """The first prod(axes) ranks of the world when the mesh is smaller
    than it (JAX takes the first devices), else None (every rank)."""
    import torch.distributed as dist
    total = int(np.prod(list(axes.values())))
    if dist.is_available() and dist.is_initialized() \
            and 0 < total < dist.get_world_size():
        return list(range(total))
    return None


def _none_rows(sl):
    return lambda a: None if a is None else a[sl]


class ParallelTrainer:
    """fit(iterator) over the ranks of a mesh.

    Builder-style kwargs mirror ParallelWrapper's: averaging_frequency,
    average_updaters, and the ZeRO knobs. The entry point runs on the
    card: the mesh's device is the rank's GPU unless the caller builds the
    mesh with `device="cpu"` (or passes `device="cpu"` here)."""

    # TrainingGuard snapshot scope: the rank's trees (in the plan's form),
    # the dropout generators (restored in place), counters
    _fault_state_attrs = ("_params", "_state", "_opt", "_gens",
                          "iteration_count", "_score")
    # the protocol of nn/superstep.py's windows and captures
    _entry_name = "parallel"

    def __init__(self, model, mesh=None, mode: str = TrainingMode.SYNC,
                 strategy: str = ShardingStrategy.REPLICATED,
                 averaging_frequency: int = 5,
                 average_updaters: bool = True,
                 data_axis: str = MeshAxes.DATA,
                 model_axis: str = MeshAxes.MODEL,
                 collect_stats: bool = False,
                 zero_bucket_mb: Optional[float] = None,
                 zero_reduce_dtype: Optional[str] = None,
                 mesh_shape: Optional[tuple] = None,
                 flash=None, device=None):
        if mesh_shape is not None:
            if mesh is not None:
                raise ValueError(
                    "pass mesh= OR mesh_shape=(d, m[, p]), not both")
            if len(mesh_shape) not in (2, 3):
                raise ValueError(
                    "mesh_shape must be (data, model) or (data, model, "
                    f"pipe), got {mesh_shape!r}")
            names = (data_axis, model_axis, MeshAxes.PIPE)
            axes = {n: int(v) for n, v in zip(names, mesh_shape)}
            mesh = make_mesh(axes, devices=_first_ranks(axes),
                             device=device)
        if mesh is None:
            mesh = make_mesh(device=device)
        _validate_mode_strategy(mode, strategy, mesh, model_axis, data_axis)
        if (strategy not in (ShardingStrategy.ZERO1, ShardingStrategy.ZERO2)
                and (zero_bucket_mb is not None
                     or zero_reduce_dtype is not None)):
            raise ValueError(
                "zero_bucket_mb/zero_reduce_dtype only apply to the ZeRO "
                f"strategies (zero1/zero2); strategy='{strategy}' ignores "
                "them — drop the knobs or switch strategy")
        if model.params is None:
            model.init()
        self.flash_mode, _ = configure_flash_attention(
            model, mesh, strategy, model_axis, data_axis, force=flash)
        self.model = model
        self.mesh = mesh
        self.mode = mode
        self.strategy = strategy
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updaters = average_updaters
        self.stats = None
        if collect_stats:
            from .stats import TrainingStats
            self.stats = TrainingStats()
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.zero_bucket_mb = (None if zero_bucket_mb is None
                               else float(zero_bucket_mb))
        self.zero_reduce_dtype = zero_reduce_dtype
        self._zero_info = None
        self._plan = None
        self._tp = None
        self._pp = None
        self._eval_cache = None
        if strategy == ShardingStrategy.PIPELINE:
            # stage-partitioned training in this process: the host-driven
            # GPipe trainer over the stage devices
            from .pipeline import (PipelinedGraphTrainer,
                                   PipelinedNetworkTrainer,
                                   _default_devices)
            cls = (PipelinedGraphTrainer if isinstance(model.params, dict)
                   else PipelinedNetworkTrainer)
            axis = (MeshAxes.PIPE if MeshAxes.PIPE in mesh.axis_names
                    else data_axis)
            stages = int(mesh.shape[axis])
            self._pipe = cls(model, n_stages=stages,
                             devices=_default_devices(stages, mesh.device))
            self.n_data = 1
            self._rank = 0
            self._bn_global = False
            self.iteration_count = 0
            self._score = float("nan")
            self._data_group = None
            return
        self._pipe = None
        self.n_data = int(mesh.shape[data_axis])
        self._rank = int(mesh.coords()[data_axis])
        # a training BatchNormalization takes the global batch's
        # statistics (kernels/bn_split.py) past one data rank
        self._bn_global = (mode == TrainingMode.SYNC and self.n_data > 1
                           and bool(batch_norm_layers(model)))
        self._data_group = mesh.axis_group(data_axis)
        self._prepare()

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def group(self):
        """The data group: the ranks that split the batch (and reduce the
        gradient) with this one."""
        return self._data_group

    @property
    def _dtype(self):
        return self.model._dtype

    @property
    def _gens(self):
        return list(self.model._dropout_generators())

    @_gens.setter
    def _gens(self, value):
        # a guard restore sets the generators' states in place
        pass

    def _fault_restored(self):
        """TrainingGuard rollback hook: drop the per-step eval caches (the
        restore rewinds iteration_count, so a cache keyed on it could serve
        pre-rollback params at a reused key)."""
        self._eval_cache = None

    # ------------------------------------------------------------------
    def _prepare(self):
        """Place the model on this rank (rank 0's values broadcast to
        every rank) and build the strategy's trees and plan. A checkpoint
        restore and `load_elastic_state` re-prepare through here."""
        m = self.model
        if self._pipe is not None:
            self._pipe.place()
            self.iteration_count = self._pipe.iteration_count = \
                int(m.iteration_count)
            self._score = float("nan")
            return
        if m.device != self.mesh.device:
            m.to(self.mesh.device)
        broadcast_model(m, self.mesh)
        self._plan = None
        self._tp = None
        self._pp = None
        self._zero_info = None
        self._params, self._state = m.params, m.state
        self._opt = m.updater_state
        layers = None
        sync = self.mode == TrainingMode.SYNC
        if sync and self.strategy in _PP_STRATEGIES:
            from .pipeline import PipelinePlan
            pp = PipelinePlan(m, self.mesh)
            self._pp = pp
            layers = pp.local_layers
            self._params = pp.to_local(m.params)
            self._state = pp.to_local(m.state)
            self._opt = pp.to_local(m.updater_state)
        if sync and (self.strategy in _TP_STRATEGIES
                     or self.strategy == ShardingStrategy.ZERO1_TP_PP):
            from .tp import TPPlan
            tp = TPPlan(m, self.mesh, self.model_axis, params=self._params,
                        layers=layers)
            self._tp = tp
            self._params = tp.shard_tree(self._params)
            self._opt = tp.shard_opt(self._opt)
        if sync and self.strategy in (
                ShardingStrategy.ZERO1, ShardingStrategy.ZERO2,
                ShardingStrategy.FSDP, ShardingStrategy.ZERO1_TP,
                ShardingStrategy.ZERO1_TP_PP):
            fsdp = self.strategy == ShardingStrategy.FSDP
            stage2 = self.strategy in (ShardingStrategy.ZERO2,
                                       ShardingStrategy.FSDP)
            cfg = ZeroConfig(
                stage=2 if stage2 else 1,
                bucket_mb=(DEFAULT_BUCKET_MB if self.zero_bucket_mb is None
                           else self.zero_bucket_mb),
                reduce_dtype=self.zero_reduce_dtype)
            plan = _ZeroPlan(m, self.mesh, self.data_axis, cfg, fsdp=fsdp,
                             params=self._params, opt_state=self._opt,
                             layers=layers,
                             model_axis=(self.model_axis if self._tp
                                         is not None else None))
            self._plan = plan
            if fsdp:
                self._params = plan.shard_tree(self._params)
            else:
                self._zero_info = dict(plan.info)
                self._zero_info["expected_constraints"] = \
                    plan.expected_constraints()
            self._opt = plan.to_plan_opt(self._opt)
        self._layers = layers
        self.iteration_count = 0
        self._score = float("nan")
        self._eval_cache = None
        self.__dict__.pop("_captured_steps", None)
        self.__dict__.pop("_eager_steps", None)
        if self.mesh.distributed and self.device.type == "cuda":
            # NCCL makes its communicator at the first collective, with
            # host syncs no CUDA-graph capture can hold: make it now, for
            # every axis group the step uses
            for axis in self.mesh.axis_names:
                warm = torch.zeros(1, device=self.device)
                all_reduce_(warm, self.mesh.axis_group(axis))
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------------
    # the step: the protocol nn/superstep.py's windows and captures use
    # ------------------------------------------------------------------
    def _carry_trees(self):
        return self._params, self._state, self._opt

    def _set_carry_trees(self, params, state, opt_state):
        self._params = tuple(params) if isinstance(params, list) else params
        self._state = tuple(state) if isinstance(state, list) else state
        self._opt = (tuple(opt_state) if isinstance(opt_state, list)
                     else opt_state)

    def _dropout_generators(self):
        return self.model._dropout_generators()

    def _step_scalars(self, step):
        if self._layers is None:
            return self.model._step_scalars(step)
        # the pipeline's local layers: head, this stage's, tail
        from ..nn.multilayer import layer_scalars
        out = []
        for layer, p in zip(self._layers, self._params):
            if p and not layer.frozen:
                out.extend(layer_scalars(self.model, layer, step))
        return out

    def _grad_template(self):
        """The reduced gradients' tree (ZERO2's chunks), for the float32
        accumulators of a captured accumulated step."""
        if self._plan is None:
            return None
        return self._plan.grad_template(self._params)

    def _grad_fn(self, params, state, batch, carries=None):
        """(global score, averaged layer state, reduced gradients, None) of
        this rank's rows: the model's own gradient (the pipeline's, with
        the 1F1B schedule), weighted by the rank's share of the global
        loss, then the strategy's reduction."""
        model = self.model
        if self.mode == TrainingMode.AVERAGING:
            return model._grad_fn(params, state, batch, carries)
        full = (self._plan.gather_params(params)
                if self._plan is not None and self._plan.fsdp else params)
        fwd = full if self._tp is None else self._tp.forward_tree(full)
        share = self._share(batch) if self.n_data > 1 else None
        bn = (batch_statistics_group(self.group, self.n_data,
                                     weight=share[0])
              if self._bn_global else contextlib.nullcontext())
        from .tp import tp_region
        with tp_region(None if self._tp is None else self._tp.ctx), bn:
            if self._pp is not None:
                score, new_state, grads = self._pp.grad(fwd, state, batch)
            else:
                score, new_state, grads, _ = model._grad_fn(fwd, state,
                                                            batch)
        if share is not None:
            grads, score = self._global_share(fwd, share, score, grads)
            score = all_reduce_(score.reshape(1).float(),
                                self.group).reshape(())
            new_state = self._mean_state(new_state)
        if self._tp is not None:
            grads = self._tp.local_grads(grads)
        if self._plan is not None:
            grads = self._plan.reduce(grads)
        else:
            grads = _all_reduce_tree(grads, self.group)
        return score, new_state, grads, None

    def _share(self, batch):
        """(w_r, d_r, the global live rows, the local l1/l2 denominator):
        this rank's share of the global loss, w_r = D_r / D."""
        d_r, live_r, n_r = self._shares(batch)
        tot = all_reduce_(torch.stack([d_r, live_r]), self.group)
        d_g, n_g = tot[0], torch.clamp(tot[1], min=1.0)
        return d_r / torch.clamp(d_g, min=1.0), d_r, n_g, n_r

    def _global_share(self, params, share, score, grads):
        """This rank's part of the global batch's gradient and score: the
        loss is a mean over the global denominator (rows, or live mask
        entries) plus l1/l2 over the global live rows, so rank r's mean
        is weighted by w_r = D_r / D and its l1/l2 term moved from 1/n_r
        to 1/(N·n) of the global rows n."""
        w, _, n_g, n_r = share
        grads = tree_map(lambda g: g * w.to(g.dtype), grads)
        score = score.float() * w
        reg = self._reg_and_grad(params)
        if reg is not None:
            r, dr = reg
            c = 1.0 / (self.n_data * n_g) - w / n_r
            grads = tree_map(lambda g, d: g + (c * d).to(g.dtype), grads, dr)
            score = score + c * r
        return grads, score

    def _shares(self, batch):
        """(loss denominator, live rows, the l1/l2 denominator) of this
        rank's rows, as 0-dim float32 tensors on the device: the counts the
        model's loss divides by (`nn/losses._apply_mask`, `_loss_fn`)."""
        x, y, fm, lm = batch
        if isinstance(y, dict):              # a graph: its first output
            name = next(iter(y))
            y, lm = y[name], (lm or {}).get(name)
            x = next(iter(x.values()))
            fm = next(iter((fm or {}).values()), None)
        dev = y.device
        per_shape = tuple(y.shape[:-1]) if y.dim() > 1 else tuple(y.shape)
        mask = lm
        if mask is None and fm is not None \
                and tuple(fm.shape[:fm.dim()]) == per_shape[:fm.dim()]:
            mask = fm
        rows = float(x.shape[0])
        if mask is None:
            # fills, not host copies: the step may be under capture
            d = torch.full((), float(np.prod(per_shape)), device=dev)
            live = torch.full((), rows, device=dev)
            return d, live, live
        m = mask.to(torch.float32)
        if m.dim() > len(per_shape):
            m = m.reshape(m.shape[:len(per_shape)])
        rest = float(np.prod(per_shape[m.dim():]))
        d = m.sum() * rest
        live = (m.reshape(m.shape[0], -1).amax(dim=1) > 0).to(
            torch.float32).sum()
        return d, live, torch.clamp(live, min=1.0)

    def _reg_and_grad(self, params):
        """(l1/l2 penalty, its gradient tree) at `params`, or None when the
        model has none."""
        model = self.model
        pairs = (params.items() if isinstance(params, dict)
                 else enumerate(params))
        layers = (model.conf.vertices if isinstance(params, dict)
                  else self._layers or model.layers)
        if not any((getattr(layers[k], "l1", 0) or 0)
                   or (getattr(layers[k], "l2", 0) or 0)
                   or (getattr(layers[k], "l1_bias", 0) or 0)
                   or (getattr(layers[k], "l2_bias", 0) or 0)
                   for k, p in pairs if p):
            return None
        live = tree_map(lambda v: v.detach().requires_grad_(True), params)
        leaves = flat_leaves(live)
        with torch.enable_grad():
            r = (self._pp.reg_score(live) if self._pp is not None
                 else model._reg_score(live))
            if not isinstance(r, torch.Tensor):
                return None
            found = torch.autograd.grad(r, leaves, allow_unused=True)
        dr = [torch.zeros_like(v) if d is None else d
              for v, d in zip(leaves, found)]
        sign = 1.0 if model.conf.conf.minimize else -1.0
        _, rebuild = flatten_tree(live)
        return r.detach().float(), rebuild([d * sign for d in dr])

    def _mean_state(self, state):
        """Layer state averaged over the ranks (floating leaves), so the
        replicas keep one value of it."""
        leaves, rebuild = flatten_tree(state)
        fl = [i for i, a in enumerate(leaves)
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
        if not fl:
            return state
        buf = torch.cat([leaves[i].reshape(-1).float() for i in fl])
        all_reduce_(buf, self.group)
        buf = buf / self.n_data
        out, pos = list(leaves), 0
        for i in fl:
            a = leaves[i]
            out[i] = buf[pos:pos + a.numel()].reshape(a.shape).to(a.dtype)
            pos += a.numel()
        return rebuild(out)

    def _update_fn(self, params, grads, opt_state, scalars):
        """The update with a replayed step's scalar row."""
        if self._plan is None:
            if self._layers is None:
                return self.model._update_fn(params, grads, opt_state,
                                             scalars)
            detached = tuple(tree_map(torch.Tensor.detach, p)
                             for p in params)
            p, o = self.model.apply_layer_updates(
                self._layers, detached, grads, opt_state, None, scalars)
            return tuple(p), tuple(o)
        return self._plan.update(params, grads, opt_state, scalars=scalars)

    def _eager_update(self, params, grads, opt_state, step):
        if self._plan is None and self._layers is None:
            return self.model._eager_update(params, grads, opt_state, step)
        scalars = None
        if self.device.type == "cuda":
            from ..nn.superstep import _scalar_rows
            scalars = (_scalar_rows(self.model, [step])[0]
                       if self._layers is None else torch.tensor(
                           self._step_scalars(step), dtype=torch.float32,
                           device=self.device))
        if self._plan is None:
            if scalars is None:
                detached = tuple(tree_map(torch.Tensor.detach, p)
                                 for p in params)
                p, o = self.model.apply_layer_updates(
                    self._layers, detached, grads, opt_state, step, None)
                return tuple(p), tuple(o)
            return self._update_fn(params, grads, opt_state, scalars)
        return self._plan.update(params, grads, opt_state, step=step,
                                 scalars=scalars)

    def _eager_step(self, params, state, opt_state, step, batch):
        score, new_state, grads, _ = self._grad_fn(params, state, batch)
        new_params, new_opt = self._eager_update(params, grads, opt_state,
                                                 step)
        return new_params, new_state, new_opt, score

    # ------------------------------------------------------------------
    # batches: this rank's rows
    # ------------------------------------------------------------------
    def _to_batch(self, ds):
        """The batch tree of `ds` as tensors on the rank's device: (x, y,
        fmask, lmask) for a MultiLayerNetwork, four dicts for a
        ComputationGraph (which takes DataSet or MultiDataSet)."""
        if isinstance(self.model.params, dict):
            return self.model._to_inputs(ds)
        return self.model._batch(ds)

    def _local_batch(self, ds):
        """This rank's rows of a global batch (trimmed to the data axis's
        multiple, the remainder dropped as JAX drops it), or the batch
        itself when it is a LocalShardDataSet (the export plane's shard of
        this rank); None when the batch trims to no rows."""
        tree = self._to_batch(ds)
        if getattr(ds, "is_local_shard", False):
            return tree
        rows = int(_first(tree[0]).shape[0])
        keep = (rows // self.n_data) * self.n_data
        if keep == 0:
            return None
        per = keep // self.n_data
        sl = slice(self._rank * per, (self._rank + 1) * per)
        if per * self.n_data == rows and self.n_data == 1:
            return tree
        return tree_map(_none_rows(sl), tree)

    # ------------------------------------------------------------------
    def fit(self, data, epochs: int = 1, *, superstep=1,
            grad_accumulation: int = 1, prefetch: bool = False,
            pad_ragged: bool = False, time_buckets=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, guard=None):
        """fit(DataSet | MultiDataSet | iterator), JAX's contract: every
        rank passes the same global batches (or its own shard files).

        `superstep=K` windows K batches (on the card, K replays of the
        captured step, collectives included); REPLICATED windows are
        bit-identical to per-batch, and so are the ZeRO strategies' in the
        port (its collectives run in the same order either way).
        AVERAGING and `collect_stats` train per batch (a log line says so).
        `grad_accumulation=M` sums M microbatches' reduced gradients into
        float32 accumulators (ZERO2: this rank's chunks only) and updates
        once; AVERAGING and `collect_stats` reject M > 1. `pad_ragged`,
        `prefetch`, `time_buckets`, the checkpoint options (the sharded
        store, `parallel/checkpoint.py`) and `guard` are the model fit's."""
        from ..nn.superstep import validate_grad_accumulation
        accum_m = validate_grad_accumulation(grad_accumulation)
        if self._pipe is not None:
            # the host-driven GPipe trains per batch, its microbatches
            # inside the step
            self._pipe.fit(data, epochs)
            self.iteration_count = self._pipe.iteration_count
            self._score = self._pipe.score()
            self._sync_back()
            return self
        if isinstance(data, (DataSet, MultiDataSet)):
            if checkpoint_dir is not None or resume:
                raise ValueError(
                    "checkpoint_dir/resume need an iterator fit (the "
                    "checkpoint records epoch/batch progress)")
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} needs an iterator fit "
                    "(M consecutive microbatches form one optimizer step)")
            if superstep != 1:
                log.info("superstep=%r ignored for a single-DataSet fit (one "
                         "batch is one step); pass an iterator to window "
                         "batches", superstep)
            if guard is not None:
                guard.run_step(self, lambda: self._fit_batch(data))
            else:
                self._fit_batch(data)
            self._sync_back()
            return self
        from ..datasets.pipeline import build_pipeline
        from ..fault.resume import sharded_fit_checkpointer
        ckpt = sharded_fit_checkpointer(
            self, checkpoint_dir, checkpoint_every, resume,
            context={"grad_accumulation": accum_m,
                     **self.model._precision_remat_context()})
        skip, done_epochs = (0, 0) if ckpt is None else ckpt.resume_into(data)
        data, close = build_pipeline(data, pad_ragged=pad_ragged,
                                     prefetch=prefetch,
                                     time_buckets=time_buckets,
                                     device=self.device, dtype=self._dtype)
        runner = self._make_superstep_runner(superstep, guard, ckpt, accum_m)
        self._set_overlap_gauge(accum_m)
        if runner is not None:
            runner.skip(skip)
            skip = 0
        sigterm = (ckpt.sigterm_snapshot() if ckpt is not None
                   else _null_span())
        try:
            with sigterm:
                for _ in range(max(0, epochs - done_epochs)):
                    data.reset()
                    if runner is not None:
                        runner.run_epoch(data)
                    else:
                        while data.has_next():
                            ds = (guard.next_batch(data) if guard is not None
                                  else data.next())
                            if skip:
                                skip -= 1   # resume: prefix already trained
                                continue
                            if guard is not None:
                                guard.run_step(self,
                                               lambda b=ds: self._fit_batch(b))
                            else:
                                self._fit_batch(ds)
                            if ckpt is not None:
                                ckpt.on_batch()
                    if ckpt is not None:
                        ckpt.on_epoch()
                if ckpt is not None:
                    ckpt.on_fit_end()
        finally:
            close()
        self._sync_back()
        return self

    def _make_superstep_runner(self, superstep, guard, ckpt, accum_m=1):
        """SuperstepRunner over the trainer's step, or None for per-batch
        dispatch (superstep=1 with grad_accumulation=1, AVERAGING,
        collect_stats — the latter two REJECT accumulation instead of
        silently changing the effective batch)."""
        from ..nn.superstep import (SuperstepRunner, accum_skip_nonfinite,
                                    validate_superstep)

        k = validate_superstep(superstep)
        if k == 1 and accum_m == 1:
            return None
        reason = None
        if self.mode == TrainingMode.AVERAGING:
            reason = (f"mode={self.mode}/strategy={self.strategy} trains "
                      "per batch (host-driven averaging schedule)")
        elif self.stats is not None:
            reason = "collect_stats times phases per batch by contract"
        if reason is not None:
            if accum_m != 1:
                raise ValueError(
                    f"grad_accumulation={accum_m} is not supported here: "
                    f"{reason}")
            log.info("superstep=%r falls back to per-batch dispatch: %s",
                     superstep, reason)
            return None
        adapter = _TrainerSuperstepAdapter(
            self, m=accum_m,
            skip_nonfinite=accum_skip_nonfinite(guard, accum_m))
        return SuperstepRunner(self, adapter, k, guard=guard, ckpt=ckpt,
                               grad_accumulation=accum_m)

    def _set_overlap_gauge(self, accum_m: int):
        """Publish the structural collective/compute overlap of this
        fit's schedule to `dl4j_collective_overlap_fraction`."""
        tel = _tel_active()
        if tel is None or self._zero_info is None:
            return
        tel.registry.gauge(
            "dl4j_collective_overlap_fraction",
            "fraction of per-step reduce-scatter payload issued with "
            "independent backward compute still in flight (structural, "
            "from the schedule)").set(
            collective_overlap_fraction(self._zero_info, accum_m))

    def _fit_batch(self, ds):
        tel = _tel_active()
        span = tel.span if tel is not None else _null_span
        phase = (self.stats.time if self.stats is not None
                 else (lambda key: contextlib.nullcontext()))
        with phase("data"), span("host/batch_prep"):
            batch = self._local_batch(ds)
        if batch is None:
            return
        if not isinstance(self.model.params, dict):
            self.model._check_input_width(batch[0])
        step = self.iteration_count
        with phase("step"):
            with span("device/dispatch",
                      kind=("sync_step" if self.mode == TrainingMode.SYNC
                            else "local_step")):
                if self.mode == TrainingMode.SYNC:
                    p, s, o, score = self._eager_step(
                        self._params, self._state, self._opt, step, batch)
                else:
                    p, s, o, score = self.model._eager_step(
                        self._params, self._state, self._opt, step, batch)
                    score = self._mean_scalar(score)
                self._set_carry_trees(p, s, o)
            self._score = score
            if self._zero_info is not None:
                if tel is not None:
                    self._record_zero_metrics(tel)
                else:
                    self._feed_collective_hasher()
            if self.stats is not None or (tel is not None
                                          and tel.sync_per_step):
                with span("device/sync"):
                    float(score)
        if self.mode == TrainingMode.AVERAGING and \
                (self.iteration_count + 1) % self.averaging_frequency == 0:
            with phase("average"), span("device/average"):
                self._average()
        self.iteration_count += 1
        self.model.last_batch_size = int(_first(batch[0]).shape[0])
        if tel is not None and self.iteration_count % tel.report_window == 0:
            tel.watermarks.sample()

    def _mean_scalar(self, score):
        """The replicas' mean of a per-rank scalar (AVERAGING's score)."""
        if self.n_data == 1 or not self.mesh.distributed:
            return score
        s = all_reduce_(score.reshape(1).float(), self.group)
        return (s / self.n_data).reshape(())

    def _average(self):
        """Average the replicas' parameters (and, with average_updaters,
        their updater states) over the ranks."""
        self._params = _mean_tree(self._params, self.n_data, self.group)
        if self.average_updaters:
            self._opt = _mean_tree(self._opt, self.n_data, self.group)

    # ------------------------------------------------------------------
    # collective accounting (JAX's counters and flight-recorder events)
    # ------------------------------------------------------------------
    def _record_zero_metrics(self, tel, n_micro: int = 1, n_steps: int = 1,
                             micro_m: Optional[int] = None):
        """ZeRO collective-traffic counters from the plan's static
        accounting: `dl4j_collective_bytes_total{op}` (the reduce-scatter
        once per microbatch, the all-reduce / all-gather once per optimizer
        step) and `dl4j_dp_bucket_flushes_total`."""
        cached = getattr(self, "_zero_metrics", None)
        if cached is None or cached[0] is not tel:
            reg = tel.registry
            cached = (tel,
                      reg.counter("dl4j_collective_bytes_total",
                                  "logical payload bytes moved by "
                                  "data-parallel collectives",
                                  labels=("op",)),
                      reg.counter("dl4j_dp_bucket_flushes_total",
                                  "gradient bucket reduce-scatter flushes"))
            self._zero_metrics = cached
        _, c_bytes, c_flush = cached
        info = self._zero_info
        for op, b in info["bytes"].items():
            if b:
                mult = n_micro if op == "reduce_scatter" else n_steps
                c_bytes.inc(b * mult, op=op)
        if info["n_buckets"] and n_micro:
            c_flush.inc(info["n_buckets"] * n_micro)
        self._feed_collective_hasher(n_micro, n_steps, micro_m=micro_m)

    def collective_accounting(self):
        """The step's declared static collective accounting (a copy of the
        ZeRO plan's info: bytes by op, bucket count); None for strategies
        that publish none (replicated / FSDP / averaging)."""
        return dict(self._zero_info) if self._zero_info else None

    def _feed_collective_hasher(self, n_micro: int = 1, n_steps: int = 1,
                                micro_m: Optional[int] = None):
        """One flight-recorder event per optimizer step carrying the
        digest of the plan's collective schedule (the declared bytes by op
        and the bucket count), so dumps from different ranks show a
        diverged plan. Host-side hashing only."""
        from ..telemetry.recorder import flight_recorder

        rec = flight_recorder()
        if self._zero_info is None or not rec.enabled:
            return
        info = self._zero_info
        n_micro = max(1, int(n_micro))
        if micro_m is not None:
            m = max(1, int(micro_m))
            counts = [m] * (n_micro // m)
            if n_micro % m:
                counts.append(n_micro % m)
        else:
            n_steps = max(1, int(n_steps))
            m = -(-n_micro // n_steps)
            counts = [m] * (n_steps - 1) + [n_micro - m * (n_steps - 1)]
        plan = getattr(self, "_collective_plan_digest", None)
        if plan is None:
            import hashlib
            basis = repr((sorted(info["bytes"].items()), info["n_buckets"]))
            plan = hashlib.sha256(basis.encode()).hexdigest()[:16]
            self._collective_plan_digest = plan
        for count in counts:
            rec.record("train/collectives", digest=plan, micro=count,
                       n_buckets=info["n_buckets"])

    # ------------------------------------------------------------------
    # the evaluation / scoring plane
    # ------------------------------------------------------------------
    def score(self, data=None) -> float:
        """No argument: the last minibatch's training score (the global
        batch's). With a DataSet / MultiDataSet: the model's score of that
        batch. With an iterator: the example-weighted mean of its batches'
        scores (`DataSetLossCalculator`'s average). Across ranks every
        batch is scored on the ranks' row shares and merged in lockstep (a
        rank out of batches takes part with an empty share), so every
        rank returns the same value."""
        if data is None:
            return float(self._score)
        total = count = 0.0
        for s, n in self._batch_scores(data):
            total += s * n
            count += n
        if count == 0:
            return float("nan")
        return float(total / count)

    def _batch_scores(self, data):
        """(global score, rows) of every batch of `data`, in lockstep."""
        params, state = self._eval_params_state()
        multi = self.mesh.distributed and self.n_data > 1
        if not multi:
            for ds in self._eval_batches(data):
                yield (float(self._score_batch(params, state, ds)),
                       ds.num_examples())
            return
        reg = self._reg_value(params)
        for ds in self._lockstep_batches(data):
            sub = None if ds is None else self._local_rows(ds)
            part = np.zeros(2)
            if sub is not None:
                n = sub.num_examples()
                s = float(self._score_batch(params, state, sub))
                # the rank's reg/n share is stripped and re-added once:
                # the (rank-identical) l1/l2 counts once globally
                part = np.asarray([(s - reg / n) * n, float(n)])
            tot = self._sum_host(part)
            if tot[1] > 0:
                n_global = max(float(tot[1]), 1.0)
                yield float((tot[0] + reg) / n_global), float(tot[1])

    def _sum_host(self, arr):
        t = torch.as_tensor(np.asarray(arr, np.float64))
        from .distributed import _wire_device
        t = t.to(_wire_device(self.group))
        all_reduce_(t, self.group)
        return t.cpu().numpy()

    def _reg_value(self, params) -> float:
        return float(self.model._reg_score(params))

    def _score_batch(self, params, state, ds):
        """The model's eval-mode score of one whole batch at `params`."""
        x, y, fm, lm = self._to_batch(ds)
        with torch.no_grad():
            if isinstance(params, dict):
                s, _ = self.model._loss_fn(params, state, x, y, None, fm,
                                           lm, train=False)
            else:
                s, _ = self.model._loss_fn(params, state, x, y, None,
                                           fmask=fm, lmask=lm, train=False)
        return s

    def _eval_params_state(self):
        """(params, state) every rank evaluates with: the live trees
        (REPLICATED / ZeRO); FSDP's gathered; AVERAGING's replica mean and
        rank 0's layer state, derived once a trained step (cached on
        iteration_count)."""
        if self._pipe is not None:
            return self.model.params, self.model.state
        sharded = self._tp is not None or self._pp is not None
        if self.mode == TrainingMode.SYNC and self._plan is None \
                and not sharded:
            return self._params, self._state
        if self.mode == TrainingMode.SYNC and not sharded \
                and not self._plan.fsdp:
            return self._params, self._state
        cached = self._eval_cache
        if cached is not None and cached[0] == self.iteration_count:
            return cached[1], cached[2]
        if self.mode == TrainingMode.SYNC and sharded:
            params, state = self._plan_params(), self._state
            if self._pp is not None:
                params = self._pp.from_local(params)
                state = self._pp.from_local(state)
        elif self.mode == TrainingMode.SYNC:
            params, state = self._plan.gather_params(self._params), \
                self._state
        else:
            params = _mean_tree(self._params, self.n_data, self.group)
            state = _broadcast_tree(self._state, self.mesh)
        self._eval_cache = (self.iteration_count, params, state)
        return params, state

    def _eval_batches(self, data):
        """Yield DataSet/MultiDataSet batches from a dataset or iterator."""
        if isinstance(data, (DataSet, MultiDataSet)):
            yield data
            return
        data.reset()
        while data.has_next():
            yield data.next()

    def _lockstep_batches(self, data):
        """Batch loop for paths with per-batch collectives: every round
        the ranks agree (one tiny all-reduce) whether ANY of them still has
        a batch; exhausted ranks take part with None until all are done,
        so unequal per-rank batch counts never desynchronize the
        collectives."""
        it = self._eval_batches(data)
        while True:
            ds = next(it, None)
            have = self._sum_host([0.0 if ds is None else 1.0])
            if float(have[0]) == 0.0:
                return
            yield ds

    def _local_rows(self, ds):
        """This rank's row share of an evaluation batch: a LocalShardDataSet
        as it is; a replicated batch split into contiguous even slices
        [(i·n)//p, ((i+1)·n)//p) so the union over ranks covers every row
        once, in rank order. None for an empty share."""
        if getattr(ds, "is_local_shard", False):
            return ds
        n = ds.num_examples()
        p, i = self.n_data, self._rank
        lo, hi = (i * n) // p, ((i + 1) * n) // p
        if lo == hi:
            return None
        cut = lambda a: None if a is None else a[lo:hi]
        if isinstance(ds, MultiDataSet):
            cl = lambda xs: None if xs is None else [cut(a) for a in xs]
            return MultiDataSet(features=cl(ds.features),
                                labels=cl(ds.labels),
                                features_masks=cl(ds.features_masks),
                                labels_masks=cl(ds.labels_masks))
        return DataSet(cut(ds.features), cut(ds.labels),
                       cut(ds.features_mask), cut(ds.labels_mask))

    def _label_pairs(self, ds, outs):
        """[(labels, out, labels_mask), ...] per network output, host-side."""
        if not isinstance(self.model.params, dict):
            return [(np.asarray(ds.labels), outs, ds.labels_mask)]
        if isinstance(ds, DataSet):
            return [(np.asarray(ds.labels), outs[0], ds.labels_mask)]
        lmasks = ds.labels_masks or [None] * len(ds.labels)
        return [(np.asarray(l), o, m)
                for l, o, m in zip(ds.labels, outs, lmasks)]

    def _predict(self, params, state, ds):
        x, _, fm, _ = self._to_batch(ds)
        out = self.model.predict_fn(params, state, x, fm)
        if isinstance(out, (tuple, list)):
            return [o.detach().float().cpu().numpy() for o in out]
        return out.detach().float().cpu().numpy()

    def evaluate(self, data, labels_list=None, top_n: int = 1):
        """Distributed evaluation (`SparkDl4jMultiLayer.evaluate(RDD)`
        analog): each rank evaluates its row share of every batch, and the
        counts are all-reduced into one Evaluation, identical on every
        rank (this rank's per-example records stay on it)."""
        from ..eval import Evaluation

        ev = Evaluation(labels=labels_list, top_n=top_n)
        params, state = self._eval_params_state()
        multi = self.mesh.distributed and self.n_data > 1
        for ds in self._eval_batches(data):
            if multi:
                ds = self._local_rows(ds)
                if ds is None:
                    continue
            out = self._predict(params, state, ds)
            for labels, o, lmask in self._label_pairs(ds, out):
                o = np.asarray(o)[:labels.shape[0]]
                ev.eval(labels, o,
                        mask=None if lmask is None else np.asarray(lmask))
        if multi:
            from .distributed import allreduce_evaluation
            ev = allreduce_evaluation(ev, self.group)
            ev.label_names = list(labels_list) if labels_list else None
        return ev

    def score_examples(self, data, add_regularization_terms: bool = True
                       ) -> np.ndarray:
        """Per-example scores (`ScoreExamplesFunction.java` analog): each
        rank scores its row share, and the rows are gathered in rank order
        per batch, so every rank returns the same array, one row per
        example, in example order."""
        params, state = self._eval_params_state()
        multi = self.mesh.distributed and self.n_data > 1
        outs = []
        if multi:
            from .distributed import allgather_rows
            for ds in self._lockstep_batches(data):
                sub = None if ds is None else self._local_rows(ds)
                local = (np.zeros(0, np.float32) if sub is None else
                         self._local_score_examples(
                             params, state, sub, add_regularization_terms))
                outs.append(allgather_rows(local, self.group))
        else:
            for ds in self._eval_batches(data):
                outs.append(self._local_score_examples(
                    params, state, ds, add_regularization_terms))
        return (np.concatenate(outs) if outs else np.zeros(0, np.float32))

    def _local_score_examples(self, params, state, ds, add_reg):
        """The model's own per-example scoring, at `params`."""
        return _with_trees(self.model, params, state,
                           lambda: self.model.score_examples(ds, add_reg))

    def reconstruction_log_probability(self, data, num_samples: int = 5,
                                       seed: int = 0) -> np.ndarray:
        """VAE reconstruction log-probability through the same plane
        (`BaseVaeReconstructionProbWithKeyFunctionAdapter.java` analog).
        A model without a leading VariationalAutoencoder layer — a
        ComputationGraph included — raises ValueError."""
        from ..nn.layers.generative import VariationalAutoencoder

        layers = getattr(self.model, "layers", None)
        if not layers or not isinstance(layers[0], VariationalAutoencoder):
            raise ValueError("reconstruction_log_probability requires the "
                             "first layer to be a VariationalAutoencoder")
        params, state = self._eval_params_state()
        multi = self.mesh.distributed and self.n_data > 1
        outs = []
        fn = lambda ds: _with_trees(
            self.model, params, state,
            lambda: self.model.reconstruction_log_probability(
                ds.features, num_samples=num_samples, seed=seed))
        if multi:
            from .distributed import allgather_rows
            for ds in self._lockstep_batches(data):
                sub = None if ds is None else self._local_rows(ds)
                local = np.zeros(0, np.float32) if sub is None else fn(sub)
                outs.append(allgather_rows(local, self.group))
        else:
            for ds in self._eval_batches(data):
                outs.append(fn(ds))
        return (np.concatenate(outs) if outs else np.zeros(0, np.float32))

    # ------------------------------------------------------------------
    # the model view
    # ------------------------------------------------------------------
    def _plan_params(self):
        """The whole parameter tree in the model's form (the pipeline's
        local form under PP) from the sharded one."""
        params = self._params
        if self._plan is not None and self._plan.fsdp:
            params = self._plan.gather_params(params)
        if self._tp is not None:
            params = self._tp.gather_tree(params)
        return params

    def _full_opt(self):
        if self._pipe is not None:
            return self.model.updater_state
        if self._plan is None and self._tp is None and self._pp is None:
            if self.mode == TrainingMode.AVERAGING:
                return _mean_tree(self._opt, self.n_data, self.group)
            return self._opt
        opt = self._opt
        if self._plan is not None:
            form = (self._params if not self._plan.fsdp
                    else self._plan.gather_params(self._params))
            opt = self._plan.from_plan_opt(opt, form)
        if self._tp is not None:
            opt = self._tp.gather_opt(opt)
        if self._pp is not None:
            opt = self._pp.from_local(opt)
        return opt

    def publish_view(self):
        """Bind the current trained trees into the wrapped model without
        perturbing training (AVERAGING's replicas stay as they are; the
        view is their mean). Every rank must call it: the sharded
        strategies gather. Returns the wrapped model."""
        if self._pipe is not None:
            self._pipe.sync_back()
            self.model.iteration_count = self.iteration_count
            return self.model
        params, state = self._eval_params_state()
        self.model.params = params
        self.model.state = state
        self.model.updater_state = self._full_opt()
        self.model.iteration_count = self.iteration_count
        return self.model

    def elastic_state(self):
        """The logical, mesh-shape-independent training state: the
        model-level {params, state, updater_state} trees and the metadata a
        restore needs to continue exactly (iteration count, the dropout
        generators' states)."""
        model = self.publish_view()
        tree = {"params": model.params, "state": model.state,
                "updater_state": model.updater_state}
        meta = {"iteration_count": int(self.iteration_count),
                "epoch_count": int(getattr(model, "epoch_count", 0)),
                "strategy": self.strategy,
                "mesh_axes": {k: int(v) for k, v in self.mesh.shape.items()},
                "generator_states": _generator_states(model)}
        return tree, meta

    def load_elastic_state(self, tree, meta):
        """Re-land a logical state captured by `elastic_state` (possibly
        under another strategy or rank count) on this trainer: install the
        trees, re-prepare, reinstate the counters and generators."""
        m = self.model
        dev = self.mesh.device
        to = lambda t: tree_map(lambda a: torch.as_tensor(a).to(dev), t)
        m.params = to(tree["params"])
        m.state = to(tree["state"])
        m.updater_state = to(tree["updater_state"])
        m.iteration_count = int(meta.get("iteration_count", 0))
        m.epoch_count = int(meta.get("epoch_count", 0))
        self._prepare()
        self.iteration_count = m.iteration_count
        _set_generator_states(m, meta.get("generator_states"))
        return self

    def _sync_back(self):
        """Write the trained trees back into the wrapped model (AVERAGING
        averages the replicas first, as JAX's does)."""
        if self.mode == TrainingMode.AVERAGING:
            self._average()
            self._state = _broadcast_tree(self._state, self.mesh)
            self._eval_cache = None
        self.publish_view()


class _TrainerSuperstepAdapter:
    """SuperstepRunner hooks for ParallelTrainer (see nn/superstep.py):
    each batch becomes this rank's rows (trimmed to the data axis's
    multiple as the per-batch step trims it; a batch that trims to no rows
    is consumed untrained), and windows run through `run_window` on the
    trainer's step."""

    def __init__(self, trainer: ParallelTrainer, m: int = 1,
                 skip_nonfinite: bool = False):
        self.trainer = trainer
        self.m = int(m)
        self.skip_nonfinite = bool(skip_nonfinite)
        self._memo = {}

    def _local(self, ds):
        key = id(ds)
        if key not in self._memo:
            self._memo[key] = self.trainer._local_batch(ds)
        return self._memo[key]

    def signature(self, ds):
        batch = self._local(ds)
        if batch is None:
            self._memo.pop(id(ds), None)
            return None
        return tuple(None if a is None else (tuple(a.shape), str(a.dtype))
                     for a in flatten_tree(batch)[0])

    def batch_nbytes(self, ds):
        from ..datasets.pipeline import batch_nbytes
        batch = self._local(ds)
        return 0 if batch is None else batch_nbytes(flatten_tree(batch)[0])

    def stage(self, window):
        return [self._memo.pop(id(ds), None) or self.trainer._local_batch(ds)
                for ds in window]

    def dispatch(self, staged, n, step0):
        from ..nn.superstep import run_window
        return run_window(self.trainer, staged, step0, self.m,
                          self.skip_nonfinite)

    def on_window_end(self, window):
        from ..nn.superstep import steps_in

        tr = self.trainer
        n = len(window)
        n_steps = steps_in(n, self.m)
        last = window[-1]
        rows = int(last.num_examples())
        tr.model.last_batch_size = (rows if getattr(last, "is_local_shard",
                                                    False)
                                    else rows // tr.n_data)
        tel = _tel_active()
        if tel is None:
            tr._feed_collective_hasher(n_micro=n, n_steps=n_steps,
                                       micro_m=self.m)
            return
        if tr._zero_info is not None:
            tr._record_zero_metrics(tel, n_micro=n, n_steps=n_steps,
                                    micro_m=self.m)
        w = tel.report_window
        if (tr.iteration_count + n_steps) // w > tr.iteration_count // w:
            tel.watermarks.sample()


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _first(x):
    return next(iter(x.values())) if isinstance(x, dict) else x


def _all_reduce_tree(tree, group):
    """The tree summed over the group: one coalesced all-reduce a dtype."""
    leaves, rebuild = flatten_tree(tree)
    out = list(leaves)
    by_dtype = {}
    for i, a in enumerate(leaves):
        if isinstance(a, torch.Tensor):
            by_dtype.setdefault(a.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        all_reduce_(buf, group)
        pos = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[pos:pos + n].reshape(leaves[i].shape)
            pos += n
    return rebuild(out)


def _mean_tree(tree, n: int, group):
    """The tree's floating leaves averaged over the group's n ranks."""
    if n == 1:
        return tree
    summed = _all_reduce_tree(tree, group)
    return tree_map(lambda a: a / n if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a, summed)


def _broadcast_tree(tree, mesh, src: int = 0):
    """Rank `src`'s values of the tree on every rank (copies)."""
    if not mesh.distributed or mesh.size == 1:
        return tree
    from .collectives import broadcast_

    def one(a):
        if not isinstance(a, torch.Tensor):
            return a
        b = a.detach().clone().contiguous()
        broadcast_(b, mesh.ranks[src], mesh.group)
        return b
    return tree_map(one, tree)


def _with_trees(model, params, state, fn):
    """`fn()` with the model's parameters and layer state bound to the
    given trees for the call."""
    old = model.params, model.state
    model.params, model.state = params, state
    try:
        return fn()
    finally:
        model.params, model.state = old


def _generator_states(model):
    return [g.get_state().tolist() for g in model._dropout_generators()]


def _set_generator_states(model, states):
    if not states:
        return
    for g, s in zip(model._dropout_generators(), states):
        g.set_state(torch.tensor(s, dtype=torch.uint8))


# DL4J-familiar alias
ParallelWrapper = ParallelTrainer
