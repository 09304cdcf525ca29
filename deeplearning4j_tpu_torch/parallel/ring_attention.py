"""Ring attention: sequence parallelism over a mesh axis (the port of
`deeplearning4j_tpu/parallel/ring_attention.py`).

Each rank of the sequence group holds one block of the sequence's
queries, keys and values. Its key/value block travels round the ring by
point-to-point sends (`collectives.exchange`, one hop a step), and every
rank folds each block that arrives into a streaming softmax (running max,
denominator and output, flash-attention style), so after n steps each
query block has attended over the whole sequence: exact attention over a
sequence no rank holds whole. `causal` masks by global position: the block
resident at step i came from rank (me - i) mod n.

The backward is a second ring: the key/value blocks travel again with
their gradient accumulators, each rank adding its queries' share, and
after n hops each accumulator is home with every rank's contribution (the
logsumexp of the forward is kept, as the flash backward keeps it).

Plain PyTorch, as JAX's is jnp: no attention kernel takes a block of keys
at a global offset. Tensors are [B, T, F] (one head, JAX's layout) or
[B, T, H, Dh].
"""
from __future__ import annotations

import math

import torch

from .collectives import all_gather_list, exchange
from .mesh import MeshAxes

__all__ = ["blockwise_attention", "ring_self_attention",
           "ring_attention_sharded", "local_attention_reference"]


def _heads_first(x):
    """[B, T, H, Dh] -> [B*H, T, Dh]; [B, T, F] as it is."""
    if x.dim() == 4:
        B, T, H, D = x.shape
        return x.permute(0, 2, 1, 3).reshape(B * H, T, D)
    return x


def _heads_back(x, like):
    if like.dim() == 4:
        B, T, H, D = like.shape
        return x.reshape(B, H, T, D).permute(0, 2, 1, 3)
    return x


def local_attention_reference(q, k, v, causal: bool = False):
    """Plain softmax attention (the oracle): [B, T, F] or [B, T, H, Dh],
    float32 sums."""
    qh, kh, vh = (_heads_first(a).float() for a in (q, k, v))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    logits = torch.einsum("bqd,bkd->bqk", qh, kh) * scale
    if causal:
        T, S = logits.shape[-2:]
        keep = torch.arange(S, device=q.device)[None, :] <= \
            torch.arange(T, device=q.device)[:, None]
        logits = logits.masked_fill(~keep, float("-inf"))
    out = torch.einsum("bqk,bkd->bqd", torch.softmax(logits, dim=-1), vh)
    return _heads_back(out, q).to(q.dtype)


def _fold(q, k_blk, v_blk, m, l, o, scale, mask=None):
    """Fold one K/V block into the streaming-softmax accumulators (m, l
    [BH, T, 1], o [BH, T, D])."""
    logits = torch.einsum("bqd,bkd->bqk", q, k_blk) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(logits - m_safe)
    corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                       torch.exp(m - m_safe))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    o_new = o * corr + torch.einsum("bqk,bkd->bqd", p, v_blk)
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, block_size: int = 128,
                        causal: bool = False):
    """Single-device blockwise attention: the ring's math with the hops
    replaced by a loop over local key blocks."""
    qh, kh, vh = (_heads_first(a).float() for a in (q, k, v))
    BH, T, D = qh.shape
    S = kh.shape[1]
    scale = 1.0 / math.sqrt(D)
    m = torch.full((BH, T, 1), float("-inf"), device=q.device)
    l = torch.zeros((BH, T, 1), device=q.device)
    o = torch.zeros((BH, T, D), device=q.device)
    qi = torch.arange(T, device=q.device)[:, None]
    for lo in range(0, S, block_size):
        hi = min(S, lo + block_size)
        mask = None
        if causal:
            mask = (torch.arange(lo, hi, device=q.device)[None, :] <= qi)[None]
        m, l, o = _fold(qh, kh[:, lo:hi], vh[:, lo:hi], m, l, o, scale, mask)
    return _heads_back(o / torch.clamp(l, min=1e-30), q).to(q.dtype)


def _ring_peers(mesh, axis):
    ranks = mesh.axis_ranks(axis)
    n = len(ranks)
    me = mesh.axis_index(axis)
    return ranks, n, me, ranks[(me + 1) % n], ranks[(me - 1) % n]


def _hop(tensors, nxt, prv, group):
    """Every tensor to the next rank of the ring, the previous rank's in
    its place (one batch of sends and receives)."""
    got = [torch.empty_like(t) for t in tensors]
    exchange([(t, nxt) for t in tensors], [(g, prv) for g in got],
             group=group)
    return got


def _causal_mask(me, src, T, S, device):
    q_pos = me * T + torch.arange(T, device=device)[:, None]
    kv_pos = src * S + torch.arange(S, device=device)[None, :]
    return (kv_pos <= q_pos)[None]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal):
        group = mesh.axis_group(axis)
        ranks, n, me, nxt, prv = _ring_peers(mesh, axis)
        qh, kh, vh = (_heads_first(a).float().contiguous()
                      for a in (q, k, v))
        BH, T, D = qh.shape
        S = kh.shape[1]
        scale = 1.0 / math.sqrt(D)
        m = torch.full((BH, T, 1), float("-inf"), device=q.device)
        l = torch.zeros((BH, T, 1), device=q.device)
        o = torch.zeros((BH, T, D), device=q.device)
        kb, vb = kh, vh
        for i in range(n):
            mask = (_causal_mask(me, (me - i) % n, T, S, q.device)
                    if causal else None)
            m, l, o = _fold(qh, kb, vb, m, l, o, scale, mask)
            if i < n - 1:
                kb, vb = _hop([kb, vb], nxt, prv, group)
        lc = torch.clamp(l, min=1e-30)
        out = o / lc
        lse = torch.where(torch.isneginf(m), torch.zeros_like(m), m) + \
            torch.log(lc)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.mesh, ctx.axis, ctx.causal = mesh, axis, causal
        ctx.like = (tuple(q.shape), q.dim(), q.dtype)
        return _heads_back(out, q).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, out, lse = ctx.saved_tensors
        mesh, axis, causal = ctx.mesh, ctx.axis, ctx.causal
        group = mesh.axis_group(axis)
        ranks, n, me, nxt, prv = _ring_peers(mesh, axis)
        shape, dim, dtype = ctx.like
        like = torch.empty(shape, device="meta")
        do = _heads_first(g).float()
        BH, T, D = qh.shape
        S = kh.shape[1]
        scale = 1.0 / math.sqrt(D)
        delta = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qh)
        kb, vb = kh, vh
        dkb, dvb = torch.zeros_like(kh), torch.zeros_like(vh)
        for i in range(n):
            logits = torch.einsum("bqd,bkd->bqk", qh, kb) * scale
            p = torch.exp(logits - lse)
            if causal:
                mask = _causal_mask(me, (me - i) % n, T, S, qh.device)
                p = p.masked_fill(~mask, 0.0)
            dvb = dvb + torch.einsum("bqk,bqd->bkd", p, do)
            dp = torch.einsum("bqd,bkd->bqk", do, vb)
            ds = p * (dp - delta) * scale
            dq = dq + torch.einsum("bqk,bkd->bqd", ds, kb)
            dkb = dkb + torch.einsum("bqk,bqd->bkd", ds, qh)
            # the block and its gradient accumulators move on together;
            # after n hops each accumulator is back with its block's owner
            kb, vb, dkb, dvb = _hop([kb, vb, dkb, dvb], nxt, prv, group)
        back = lambda t: _heads_back(t, like).to(dtype)
        return back(dq), back(dkb), back(dvb), None, None, None


def ring_self_attention(q, k, v, mesh, axis: str = MeshAxes.SEQ,
                        causal: bool = False):
    """Ring attention of this rank's sequence block over `mesh`'s `axis`
    group: q, k, v are this rank's [B, T/n, F] (or [B, T/n, H, Dh]) rows of
    the sequence, in rank order; returns this rank's output rows.
    Differentiable (the backward is a second ring)."""
    if mesh.axis_size(axis) == 1 or not mesh.distributed:
        return local_attention_reference(q, k, v, causal)
    return _Ring.apply(q, k, v, mesh, axis, causal)


def ring_attention_sharded(q, k, v, mesh, axis: str = MeshAxes.SEQ,
                           causal: bool = False):
    """Host-level entry (every rank passes the whole [B, T, ...] tensors):
    each rank takes its block of the sequence, the ring runs, and the
    blocks are gathered back in rank order."""
    n = mesh.axis_size(axis)
    if n == 1 or not mesh.distributed:
        return local_attention_reference(q, k, v, causal)
    me = mesh.axis_index(axis)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} does not split over {n} "
                         "ranks")
    sl = slice(me * (T // n), (me + 1) * (T // n))
    out = ring_self_attention(q[:, sl], k[:, sl], v[:, sl], mesh, axis,
                              causal)
    parts = all_gather_list(out.detach().contiguous(),
                            mesh.axis_group(axis))
    return torch.cat(parts, dim=1)
