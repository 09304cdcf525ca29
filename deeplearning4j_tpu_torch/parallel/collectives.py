"""The port's collective layer: the `torch.distributed` calls every
strategy issues, in one place.

NCCL carries CUDA tensors itself, gloo carries CPU tensors. Ranks that
share one card cannot use NCCL (it refuses two ranks on a device), so they
run gloo with their tensors on the card, and this layer stages every
collective of a CUDA tensor through pinned host memory explicitly,
counting each copy (`host_copies()`): the H100 machine's torch build
(2.11+cu128) has no CUDA transport in gloo (an all-reduce of a CUDA tensor
handed to gloo kills the process with gloo's "writev: Bad address"). The
compute stays on the card; only the wire goes through the host.

With no process group (a world of one rank) every call is the identity.

`batch_statistics_group(group, ...)` marks the block in which a training
BatchNormalization takes its statistics over the rows of every rank of
`group` (the global batch, as JAX's GSPMD step does), through
`kernels/bn_split.py`.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["all_reduce_", "all_gather_", "all_gather_list",
           "reduce_scatter_", "broadcast_", "exchange", "group_size",
           "host_copies", "reset_host_copies",
           "batch_statistics_group", "active_batch_group", "BatchGroup"]

# torch 2.13 deprecates both calls in favour of `*_single`, which older
# releases lack; these two are in every release the port runs on
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(reduce_scatter_tensor|"
            r"all_gather_into_tensor)` is deprecated")

_lock = threading.Lock()
_copies = {"to_host": 0, "to_device": 0, "bytes": 0}


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def group_size(group=None) -> int:
    dist = _dist()
    return 1 if dist is None else int(dist.get_world_size(group))


def host_copies() -> dict:
    """{"to_host": n, "to_device": n, "bytes": b}: the explicit staging
    copies of CUDA tensors through the host for gloo since the last
    reset."""
    with _lock:
        return dict(_copies)


def reset_host_copies():
    with _lock:
        _copies.update(to_host=0, to_device=0, bytes=0)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` must go through the host for `group`'s backend."""
    if not t.is_cuda:
        return False
    dist = _dist()
    return str(dist.get_backend(group)) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        # the host's half of the collective would run once, at capture:
        # a replay would skip it
        raise RuntimeError(
            "a gloo collective of a CUDA tensor goes through the host and "
            "cannot be captured in a CUDA graph; train at superstep 1")
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    with _lock:
        _copies["to_host"] += 1
        _copies["bytes"] += t.numel() * t.element_size()
    return h


def _to_device(dst: torch.Tensor, h: torch.Tensor):
    dst.copy_(h)
    with _lock:
        _copies["to_device"] += 1
        _copies["bytes"] += h.numel() * h.element_size()


def all_reduce_(t: torch.Tensor, group=None):
    """Sum over the group, in place."""
    dist = _dist()
    if dist is None:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        _to_device(t, h)
        return t
    dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None):
    """Rank `src`'s (a global rank) value of `t` on every rank, in
    place."""
    dist = _dist()
    if dist is None:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.broadcast(h, src=src, group=group)
        _to_device(t, h)
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather_(out: torch.Tensor, inp: torch.Tensor, group=None):
    """`out` = the ranks' `inp`, concatenated in rank order."""
    dist = _dist()
    if dist is None:
        out.copy_(inp)
        return out
    if _staged(inp, group):
        ho = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(ho, _to_host(inp.contiguous()),
                                    group=group)
        _to_device(out, ho)
        return out
    dist.all_gather_into_tensor(out, inp, group=group)
    return out


def all_gather_list(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """[rank 0's t, rank 1's t, ...] of the group (one all-gather)."""
    n = group_size(group)
    if n == 1 or _dist() is None:
        return [t]
    flat = t.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=t.dtype, device=t.device)
    all_gather_(out, flat, group)
    return list(out.reshape((n,) + tuple(t.shape)).unbind(0))


def reduce_scatter_(out: torch.Tensor, inp: torch.Tensor, group=None):
    """`out` = this rank's block of the sum over the group of `inp`."""
    dist = _dist()
    if dist is None:
        out.copy_(inp)
        return out
    if _staged(inp, group):
        ho = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(ho, _to_host(inp.contiguous()),
                                   group=group)
        _to_device(out, ho)
        return out
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]] = (),
             recvs: Sequence[Tuple[torch.Tensor, int]] = (), group=None):
    """One batch of point-to-point sends and receives (peers are global
    ranks), posted together and waited on together: the tick of a
    pipeline schedule. Received tensors are written in place."""
    dist = _dist()
    if dist is None or (not sends and not recvs):
        return
    ops, landing = [], []
    for t, peer in sends:
        t = t.contiguous()
        if _staged(t, group):
            t = _to_host(t)
        ops.append(dist.P2POp(dist.isend, t, peer, group))
    for t, peer in recvs:
        buf = t
        if _staged(t, group):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            landing.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for t, buf in landing:
        _to_device(t, buf)


# ----------------------------------------------------------------------
# the batch-statistics group of a training BatchNormalization
# ----------------------------------------------------------------------
class BatchGroup:
    """The ranks whose rows make one global batch. `weight` is this
    rank's share of the global loss (a 0-dim tensor, D_r / D) when its
    loss is its own rows' mean, or None when the loss is already its
    share of the global one: the backward's global sums take every
    rank's gradient at the same scale."""

    def __init__(self, group, n: int, weight: Optional[torch.Tensor] = None):
        self.group = group
        self.n = int(n)
        self.weight = weight


_active: Optional[BatchGroup] = None


@contextlib.contextmanager
def batch_statistics_group(group, n: int,
                           weight: Optional[torch.Tensor] = None):
    """Inside the block (the forward and its backward, which autograd may
    run on another thread), a training BatchNormalization normalises by
    the statistics of the global batch of `group`'s n ranks."""
    global _active
    prev = _active
    _active = BatchGroup(group, n, weight) if n > 1 else None
    try:
        yield _active
    finally:
        _active = prev


def active_batch_group() -> Optional[BatchGroup]:
    return _active
