"""Megatron tensor parallelism over the mesh's "model" axis (the port of
what JAX's GSPMD derives from `parallel/sharding.py`'s specs).

JAX shards each parameter by its PartitionSpec and lets XLA insert the
collectives. The port runs one rank per device, so each rank holds its
shard between steps and the layers that know their Megatron role compute
with it and issue the collectives themselves:

  * `TransformerBlock`: column-parallel W_q / W_k / W_v / W_ffn_in (and
    their biases), row-parallel W_o / W_ffn_out: each rank attends over
    its H/m heads (kernels 1-3 on its local [B/d, T, H/m, Dh] block, no
    collective inside attention), then one all-reduce after attention and
    one after the FFN. b_o, b_ffn_out and the layer norms are replicated,
    each bias added once, after the reduce. The row-parallel partial
    products are cast to float32 before the all-reduce (a bf16 partial
    sum would round m times; XLA keeps the excess precision in its fused
    chain too).
  * `EmbeddingSequenceLayer`: the token table is vocab-sharded; a rank
    looks up the ids in its rows, zeros the others, and the ranks'
    lookups are all-reduced.

Every other sharded leaf (JAX's generic rule: expert tensors on axis 0,
otherwise the last axis when the model axis divides it; Dense, conv, LSTM
gate blocks, MoE experts, the positional table) keeps its shard between
steps, is all-gathered over the model group before the forward and its
gradient cut back to the shard after: the numbers of GSPMD's replicated
compute, with 1/m of those parameters and their moments at rest.

Inside `tp_region(ctx)` the layers see the model group; `copy_to_tp`
(identity forward, all-reduce of the gradient) and `reduce_from_tp`
(all-reduce forward, identity backward) are Megatron's f and g.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .collectives import all_gather_list, all_reduce_
from .sharding import _tp_spec_for

__all__ = ["TPContext", "tp_region", "tp_active", "copy_to_tp",
           "reduce_from_tp", "TPPlan"]


class TPContext:
    """The model group of this rank: `size` ranks, this one at `index`."""

    def __init__(self, group, size: int, index: int):
        self.group = group
        self.size = int(size)
        self.index = int(index)


_active: Optional[TPContext] = None


@contextlib.contextmanager
def tp_region(ctx: Optional[TPContext]):
    """Inside the block the layers with a Megatron role compute on their
    shards over `ctx`'s group."""
    global _active
    prev = _active
    _active = ctx if ctx is not None and ctx.size > 1 else None
    try:
        yield _active
    finally:
        _active = prev


def tp_active() -> Optional[TPContext]:
    return _active


def _reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group in float32, returned in x's dtype."""
    y = x.to(torch.float32).contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    all_reduce_(y, group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_f32(g, ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _reduce_f32(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer (its gradient
    is all-reduced over the model group)."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial outputs of a
    row-parallel layer, in float32 (returned in float32)."""
    return _ReduceFromTP.apply(x.to(torch.float32), tp)


# ----------------------------------------------------------------------
# the plan: which leaves shard where, and which the layer computes with
# ----------------------------------------------------------------------
def _leaf_paths(tree, path=()):
    """[(key path, tensor)] of a layer's (possibly nested) parameter
    dict."""
    if isinstance(tree, dict):
        return [x for n, a in tree.items()
                for x in _leaf_paths(a, path + (n,))]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def _spec_axis(spec) -> Optional[int]:
    for i, e in enumerate(spec):
        if e is not None:
            return i
    return None


class TPPlan:
    """The Megatron layout of a model's parameter tree over the model
    group of `mesh`: per leaf the sharded axis (JAX's `_tp_spec_for`,
    layer roles first) and whether its layer computes with the shard
    (`tp_local_keys`) or takes it gathered. `params` / `layers` default
    to the model's (the pipeline passes its stage's)."""

    def __init__(self, model, mesh, model_axis: str = "model",
                 params=None, layers=None):
        self.model = model
        self.mesh = mesh
        self.size = mesh.axis_size(model_axis)
        self.index = mesh.axis_index(model_axis)
        self.group = mesh.axis_group(model_axis)
        self.ctx = TPContext(self.group, self.size, self.index)
        params = model.params if params is None else params
        graph = isinstance(params, dict)
        if layers is None:
            layers = (model.conf.vertices if graph else model.layers)
        for layer in (layers.values() if isinstance(layers, dict)
                      else layers):
            validate = getattr(layer, "tp_validate", None)
            if validate is not None:
                validate(self.size)
        keys = params.keys() if graph else range(len(params))
        # per layer, per leaf path (nested dicts: a BiLSTM's fwd/W, keyed
        # by its last key as JAX's rule is): (sharded axis, local)
        self.leaf = {}
        for k in keys:
            own = set(getattr(layers[k], "tp_local_keys", ()))
            self.leaf[k] = {}
            for path, a in _leaf_paths(params[k]):
                spec = _tp_spec_for(path[-1], tuple(a.shape), model_axis,
                                    mesh, layer=layers[k])
                ax = _spec_axis(spec)
                self.leaf[k][path] = (ax, ax is not None and path[-1] in own)
        self.graph = graph
        self.template = params

    # -- per-leaf maps ----------------------------------------------------
    def _map(self, tree, fn):
        """fn(a, axis, local) over the tree's tensor leaves."""
        keys = tree.keys() if self.graph else range(len(tree))

        def walk(t, k, path):
            if isinstance(t, dict):
                return {n: walk(a, k, path + (n,)) for n, a in t.items()}
            if isinstance(t, torch.Tensor):
                ax, lo = self.leaf[k].get(path, (None, False))
                return fn(t, ax, lo)
            return t
        out = {k: walk(tree[k], k, ()) for k in keys}
        return out if self.graph else tuple(out[k] for k in keys)

    def _chunk(self, a, ax):
        return a.chunk(self.size, dim=ax)[self.index].contiguous()

    def _gather(self, a, ax):
        return torch.cat(all_gather_list(a.contiguous(), self.group),
                         dim=ax)

    def shard_tree(self, tree):
        """A parameter-shaped tree cut to this rank's shards."""
        return self._map(tree, lambda a, ax, lo: (
            a if ax is None else self._chunk(a, ax).clone()))

    def gather_tree(self, tree):
        """The whole parameter-shaped tree from its shards."""
        return self._map(tree, lambda a, ax, lo: (
            a if ax is None else self._gather(a, ax)))

    def forward_tree(self, tree):
        """The tree the forward takes: the role leaves as their shards,
        every other sharded leaf gathered."""
        return self._map(tree, lambda a, ax, lo: (
            a if ax is None or lo else self._gather(a, ax)))

    def local_grads(self, grads):
        """The forward tree's gradients cut back to the shards (a gathered
        leaf's gradient is the same on every model rank: its slice)."""
        return self._map(grads, lambda g, ax, lo: (
            g if ax is None or lo else self._chunk(g, ax)))

    # -- the updater state: each moment as its parameter ------------------
    def shard_opt(self, opt_state):
        from .zero import _per_moment
        flags = self._map(self.template, lambda a, ax, lo: ax)
        return _per_moment(opt_state, lambda m, ax: (
            m if ax is None or m.dim() == 0 else self._chunk(m, ax).clone()),
            flags)

    def gather_opt(self, opt_state):
        from .zero import _per_moment
        flags = self._map(self.template, lambda a, ax, lo: ax)
        return _per_moment(opt_state, lambda m, ax: (
            m if ax is None or m.dim() == 0 else self._gather(m, ax)),
            flags)
