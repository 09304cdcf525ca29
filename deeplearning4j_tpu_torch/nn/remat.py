"""Selective rematerialization: the port of `deeplearning4j_tpu/nn/remat.py`
onto `torch.utils.checkpoint`.

`remat` (the network configuration) decides where checkpoint boundaries go
(None / "layer" / "blocks" / "full"); `remat_policy` (the configuration or
a layer) decides what each boundary saves for the backward:

  name             saves (the rest is recomputed in the backward)
  ----             -----
  None             nothing: a plain non-reentrant checkpoint
  "nothing"        the same, stated explicitly
  "dots"           the outputs of every matrix product (mm, addmm, bmm,
                   baddbmm): a selective-checkpoint context
  "dots_no_batch"  the outputs of products without a batch dimension (mm,
                   addmm) only
  "everything"     every residual autograd keeps: the call runs without a
                   checkpoint, which is that memory profile exactly

Every policy leaves the numbers alone: the recomputation runs the same
operations on the same inputs, so scores and gradients are bit-equal to
the run without remat. A dropout generator passed to `checkpoint_call` is
rewound for the recomputation, so it draws the same mask. On the card a
recomputed GravesLSTM launches its residual-saving sequence kernel again.

`saved_bytes` is the activation-byte accounting: what one boundary keeps
between its forward and the backward under a policy.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import checkpoint as _ckpt
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["REMAT_POLICIES", "resolve_policy", "checkpoint_call",
           "saved_bytes"]

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset({_aten.mm, _aten.addmm})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm, _aten.baddbmm}

#: policy name -> the operator packets a boundary saves (None: every
#: residual, the call is not checkpointed; empty: nothing is saved)
REMAT_POLICIES = {
    "nothing": frozenset(),
    "dots": _DOTS,
    "dots_no_batch": _NO_BATCH_DOTS,
    "everything": None,
}


def resolve_policy(name: Optional[str]):
    """Policy name -> the operators its boundaries save (None stays None:
    save nothing). Raises with the valid names on a typo: a policy ignored
    in silence would change the memory profile the user asked for."""
    if name is None:
        return None
    try:
        return REMAT_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown remat_policy '{name}'. Valid policies: "
            f"{', '.join(sorted(REMAT_POLICIES))} (or None to save "
            "nothing)") from None


def _context_fn(saved_ops):
    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in saved_ops:
            return _ckpt.CheckpointPolicy.MUST_SAVE
        return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return lambda: _ckpt.create_selective_checkpoint_contexts(policy)


def as_generators(obj) -> list:
    """The generators in `obj`: one generator, a sequence of them (Nones
    skipped), or None (no generators)."""
    if obj is None:
        return []
    if isinstance(obj, torch.Generator):
        return [obj]
    return [g for g in obj if g is not None]


def checkpoint_call(fn: Callable, policy: Optional[str], *args,
                    generator=None):
    """`fn(*args)` behind a checkpoint boundary that saves what `policy`
    names. `generator` (the dropout generator `fn` draws from, or a
    sequence of them, or None) is set back to its state at the call for
    the recomputation, and left where the first forward left it."""
    saved_ops = resolve_policy(policy)
    if policy == "everything":
        return fn(*args)
    gens = as_generators(generator)
    start = [g.get_state() for g in gens]
    calls = [0]

    def body(*a):
        calls[0] += 1
        if not gens or calls[0] == 1:
            return fn(*a)
        after = [g.get_state() for g in gens]     # the recomputation
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    kw = {} if not saved_ops else {"context_fn": _context_fn(saved_ops)}
    return _ckpt.checkpoint(body, *args, use_reentrant=False,
                            preserve_rng_state=False, **kw)


class _Outputs(TorchDispatchMode):
    """Records every operator's tensor outputs during a forward."""

    def __init__(self):
        super().__init__()
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.outputs.append((func.overloadpacket, t))
        return out


def saved_bytes(fn: Callable, *args, policy: Optional[str] = None) -> int:
    """Bytes of the intermediate tensors one checkpoint boundary around
    `fn(*args)` keeps for the backward under `policy` (0: everything is
    recomputed from the boundary's inputs). The boundary's own arguments
    are alive either way and are not counted. Tensors in `args` are
    replaced by zeros of their shape and dtype (floating ones require
    grad). "everything" counts what autograd saves, through
    `torch.autograd.graph.saved_tensors_hooks`; "dots" and
    "dots_no_batch" count the outputs of the products they save."""
    saved_ops = resolve_policy(policy)
    if policy is None or saved_ops == frozenset():
        return 0
    concrete = [torch.zeros(a.shape, dtype=a.dtype, device=a.device)
                .requires_grad_(a.is_floating_point())
                if isinstance(a, torch.Tensor) else a for a in args]
    arg_storages = {a.untyped_storage().data_ptr() for a in concrete
                    if isinstance(a, torch.Tensor)}
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.enable_grad(), _Outputs() as rec, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*concrete)
    if saved_ops is None:
        kept = packed
    else:
        kept = [t for op, t in rec.outputs if op in saved_ops]
    total, seen = 0, set(arg_storages)
    for t in kept:
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            continue
        seen.add(ptr)
        total += t.untyped_storage().nbytes()
    return total
