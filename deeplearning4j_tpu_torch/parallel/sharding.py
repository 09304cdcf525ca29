"""Parameter sharding rules (the port of
`deeplearning4j_tpu/parallel/sharding.py`).

A `PartitionSpec` here is what it is in JAX: one entry per tensor axis,
the mesh axis the tensor is split over there, or None. JAX hands the specs
to `jax.jit` and XLA inserts the collectives; the port's trainer reads
them to decide which leaves its ZeRO / FSDP plan shards
(`parallel/zero.py`), and issues the collectives itself.

Strategies: REPLICATED (pure data parallelism), FSDP (each tensor
sharded over "data" on its largest divisible axis, gathered before use),
ZERO1 / ZERO2 (params replicated, optimizer state, and for stage 2 the
reduced gradients, sharded over "data"), TENSOR_PARALLEL (Megatron over
"model": layers with a declared role pin their axis, `tp_shard_axis`;
the generic rule shards expert tensors on axis 0 and everything else on
its last axis when the model axis divides it; `parallel/tp.py` runs it),
ZERO1_TP (TENSOR_PARALLEL's params, moments further sharded over
"data"), PIPELINE (host-driven GPipe, `pipeline.py`), PP and ZERO1_TP_PP
(the 1F1B pipeline over "pipe", `pipeline.py`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import MeshAxes
from ..nn.trees import tree_map

__all__ = ["PartitionSpec", "param_specs", "shard_model",
           "ShardingStrategy", "model_layer_hints", "batch_norm_layers"]


class PartitionSpec(tuple):
    """JAX's PartitionSpec: `PartitionSpec(None, "data")` splits a 2-D
    tensor's second axis over the data axis; `PartitionSpec()` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class ShardingStrategy:
    REPLICATED = "replicated"
    TENSOR_PARALLEL = "tensor_parallel"
    FSDP = "fsdp"
    PIPELINE = "pipeline"
    ZERO1 = "zero1"
    ZERO2 = "zero2"
    ZERO1_TP = "zero1_tp"
    PP = "pp"
    ZERO1_TP_PP = "zero1_tp_pp"

    #: strategies under which every rank holds the full params between
    #: steps (evaluation / scoring may read them locally)
    PARAMS_REPLICATED = (REPLICATED, ZERO1, ZERO2)

    #: the model-parallel strategies
    MODEL_PARALLEL = (TENSOR_PARALLEL, ZERO1_TP, PIPELINE, PP, ZERO1_TP_PP)


def batch_norm_layers(model):
    """The names of the model's BatchNormalization layers (frozen ones
    too): under SYNC over more than one data rank they take the global
    batch's statistics (`kernels/bn_split.py`), as JAX's GSPMD step
    does."""
    from ..nn.layers.normalization import BatchNormalization
    named = (model.conf.vertices.items() if isinstance(model.params, dict)
             else enumerate(model.layers))
    return [str(k) for k, layer in named
            if isinstance(layer, BatchNormalization)]


def _tp_spec_for(key: str, shape, axis: str, mesh, layer=None
                 ) -> PartitionSpec:
    """Model-axis sharding of one parameter tensor (JAX's rule): a layer
    that declares its Megatron role via `tp_shard_axis` pins the axis (or
    "replicated"); otherwise expert tensors (`expert_*`, leading axis the
    expert count) shard on axis 0 and everything else on its last axis,
    when the model axis divides it."""
    size = int(mesh.shape.get(axis, 1))
    nd = len(shape)
    if nd == 0:
        return P()
    role = None
    if layer is not None and hasattr(layer, "tp_shard_axis"):
        role = layer.tp_shard_axis(key, shape)
    if role == "replicated":
        return P()
    if role is not None:
        ax = role % nd
        if shape[ax] % size == 0 and shape[ax] >= size:
            spec = [None] * nd
            spec[ax] = axis
            return P(*spec)
        return P()
    if key.startswith("expert_") and shape[0] % size == 0 \
            and shape[0] >= size:
        return P(*([axis] + [None] * (nd - 1)))
    if shape[-1] % size == 0 and shape[-1] >= size:
        return P(*([None] * (nd - 1) + [axis]))
    return P()


def _fsdp_spec_for(shape, axis: str, mesh) -> PartitionSpec:
    """JAX's FSDP rule: the largest axis the mesh axis divides (and is no
    smaller than) takes it; a tensor with none stays replicated."""
    size = mesh.shape[axis]
    if not shape:
        return P()
    order = np.argsort(shape)[::-1]
    for ax in order:
        if shape[ax] % size == 0 and shape[ax] >= size:
            spec = [None] * len(shape)
            spec[ax] = axis
            return P(*spec)
    return P()


def model_layer_hints(model):
    """The per-leaf layer-hint source `param_specs(layers=...)` takes: the
    layer sequence of a MultiLayerNetwork, the vertex-name -> conf mapping
    of a ComputationGraph."""
    if isinstance(getattr(model, "params", None), dict):
        return dict(model.conf.vertices)
    return getattr(model, "layers", None)


def model_updater_pairs(model):
    """[(layer or vertex conf, its parameter tree)] of either model kind."""
    if isinstance(model.params, dict):
        return [(model.conf.vertices[name], p)
                for name, p in model.params.items()]
    return list(zip(model.layers, model.params))


def param_specs(params, strategy: str, mesh,
                model_axis: str = MeshAxes.MODEL,
                data_axis: str = MeshAxes.DATA, layers=None):
    """PartitionSpec tree matching `params` (a MultiLayerNetwork tuple of
    dicts or a ComputationGraph dict of dicts)."""
    if strategy in ShardingStrategy.PARAMS_REPLICATED:
        return tree_map(lambda a: P(), params)
    if strategy == ShardingStrategy.FSDP:
        return tree_map(lambda a: _fsdp_spec_for(tuple(a.shape), data_axis,
                                                 mesh), params)
    if strategy in (ShardingStrategy.TENSOR_PARALLEL,
                    ShardingStrategy.ZERO1_TP):
        if layers is not None:
            size = int(mesh.shape.get(model_axis, 1))
            items = layers.values() if isinstance(layers, dict) else layers
            for hint in items:
                validate = getattr(hint, "tp_validate", None)
                if validate is not None:
                    validate(size)
        def layer_specs(p, layer):
            # JAX keys a leaf by its last path key (a BiLSTM's fwd/W is "W")
            if isinstance(p, dict):
                return {n: (layer_specs(a, layer) if isinstance(a, dict)
                            else _tp_spec_for(n, tuple(a.shape), model_axis,
                                              mesh, layer))
                        for n, a in p.items()}
            return tree_map(lambda a: P(), p)
        keys = params.keys() if isinstance(params, dict) \
            else range(len(params))
        out = {k: layer_specs(params[k],
                              None if layers is None else layers[k])
               for k in keys}
        return out if isinstance(params, dict) else tuple(out[k]
                                                           for k in keys)
    # the pipeline strategies' layouts are their plans' (pipeline.py)
    raise ValueError(f"Unknown sharding strategy '{strategy}'")


def shard_model(model, mesh, strategy: str = ShardingStrategy.REPLICATED,
                model_axis: str = MeshAxes.MODEL,
                data_axis: str = MeshAxes.DATA
                ) -> Tuple[object, PartitionSpec, object]:
    """Place a model on this rank of the mesh: move it to the rank's
    device and broadcast rank 0's parameters, layer state and updater
    state, so every rank starts from the same values. Returns the spec
    trees (params, state, updater state) of the strategy; the trainer
    shards the FSDP / ZeRO leaves by them (`parallel/zero.py`)."""
    from .zero import zero_opt_shardings

    specs = param_specs(model.params, strategy, mesh, model_axis,
                        data_axis, layers=model_layer_hints(model))
    if model.device != mesh.device:
        model.to(mesh.device)
    broadcast_model(model, mesh)
    if strategy in (ShardingStrategy.ZERO1, ShardingStrategy.ZERO2,
                    ShardingStrategy.FSDP):
        opt = zero_opt_shardings(model.updater_state, model.params, mesh,
                                 data_axis)
    else:
        opt = tree_map(lambda a: P(), model.updater_state)
    return specs, P(), opt


def broadcast_model(model, mesh, src: int = 0):
    """Rank `src`'s parameters, layer state and updater state on every
    rank of the mesh (one broadcast a tensor, in place)."""
    from .collectives import broadcast_

    if not mesh.distributed or mesh.size == 1:
        return
    from ..nn.trees import flat_leaves
    root = mesh.ranks[src]
    for tree in (model.params, model.state, model.updater_state):
        for t in flat_leaves(tree):
            if isinstance(t, torch.Tensor):
                broadcast_(t.data, root, mesh.group)
