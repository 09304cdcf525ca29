"""Embedding lookup table and the batched training steps: the port of
`deeplearning4j_tpu/nlp/embeddings.py`, under the same names.

Parity with `models/embeddings/`:
  * InMemoryLookupTable (`inmemory/InMemoryLookupTable.java:55`): syn0
    (input vectors), syn1 (HS output weights), syn1neg (negative-sampling
    output weights), the unigram^0.75 negative-sampling distribution;
  * the learning algorithms (`learning/impl/elements/SkipGram.java:31`,
    CBOW): hierarchical softmax and negative sampling;
  * BasicModelUtils (`reader/impl/BasicModelUtils.java`): wordsNearest and
    similarity.

Training is batched as in the JAX package: dense [B] center / context index
tensors, a summed loss and plain SGD on the tables. What differs:

  * Randomness is drawn outside the steps, from an explicit
    `torch.Generator` seeded from the model's seed: the pair steps take
    their negatives as an argument, the SGNS corpus runner its shuffled
    center positions and reduced-window draws. A test can hand either
    JAX's draws.
  * An epoch is a loop of steps over per-step input rows. On a CUDA device
    the step is captured once per signature as a CUDA graph
    (`nn/superstep._Graph`) over static buffers that hold the whole
    epoch's rows; a device-side step counter picks the row and the graph
    advances it, so each step is one replay. A step that cannot be
    captured raises `CaptureError`; there is no eager loop on the card.
  * The SGNS step gathers the positive logits and writes the sparse part
    of the dense cotangent with `gather` / `scatter_` where the JAX
    package uses 2W iota compares (TPU scatters serialize), and sums the
    center rows' gradient per row with a stable sort and one segment
    reduction (`_row_sums`: deterministic on the card) where JAX
    multiplies by a one-hot matrix.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..util.platform import DeviceLike, resolve_device
from .vocab import Huffman, VocabCache

__all__ = ["InMemoryLookupTable", "NegativeSampler", "make_skipgram_step",
           "make_cbow_step", "make_epoch_runner", "pad_scan_length",
           "WordVectorsModel"]


def pad_scan_length(T: int) -> int:
    """JAX's scan-length bucket: next power of two below 64, else the next
    multiple of 64. The port runs no padded steps (JAX's padded steps have
    lr 0 and are exact no-ops); an epoch's static buffers on the card are
    sized to this bucket, so token-count jitter between subsampled epochs
    re-captures nothing."""
    if T >= 64:
        return -(-T // 64) * 64
    p = 1
    while p < T:
        p *= 2
    return p


class NegativeSampler:
    """Unigram^0.75 distribution (the reference's negative-sampling table,
    InMemoryLookupTable.makeTable), sampled by inverse CDF (uniform draw +
    binary search over the cumulative distribution) on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, counts: np.ndarray, power: float = 0.75,
                 device: DeviceLike = None):
        p = np.asarray(counts, np.float64) ** power
        p = p / p.sum()
        dev = resolve_device(device)
        self.probs = torch.as_tensor(p, dtype=torch.float32, device=dev)
        self.cdf = torch.as_tensor(np.cumsum(p), dtype=torch.float32,
                                   device=dev)

    def sample(self, generator: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=generator,
                       dtype=torch.float32, device=self.cdf.device)
        idx = torch.searchsorted(self.cdf, u, right=True)
        return idx.clamp_(0, self.cdf.shape[0] - 1)


class InMemoryLookupTable:
    def __init__(self, vocab: VocabCache, vector_length: int,
                 seed: int = 12345, use_hs: bool = False,
                 negative: int = 5, device: DeviceLike = None):
        dev = resolve_device(device)
        V, D = vocab.num_words(), int(vector_length)
        g = torch.Generator(device=dev).manual_seed(int(seed))
        # reference init: U(-0.5/D, 0.5/D) for syn0; zeros for syn1/syn1neg
        syn0 = torch.empty((V, D), dtype=torch.float32, device=dev)
        syn0.uniform_(-0.5 / D, 0.5 / D, generator=g)
        self._setup(vocab, syn0, use_hs, negative)
        self.syn1 = self._zeros() if use_hs else None
        self.syn1neg = self._zeros() if self.negative > 0 else None

    def _zeros(self):
        return torch.zeros_like(self.syn0)

    def _setup(self, vocab, syn0, use_hs, negative, hs=None):
        self.vocab = vocab
        self.device = syn0.device
        self.syn0 = syn0
        self.vector_length = int(syn0.shape[1])
        self.use_hs = bool(use_hs)
        self.negative = int(negative)
        self.sampler = (NegativeSampler(vocab.counts_array(),
                                        device=self.device)
                        if self.negative > 0 else None)
        if self.use_hs:
            if hs is None:
                h = Huffman(vocab)
                h.build()
                hs = h.codes_arrays()
            codes, points, mask = hs
            self.hs_codes = torch.as_tensor(np.array(codes, np.float32),
                                            device=self.device)
            self.hs_points = torch.as_tensor(np.array(points, np.int64),
                                             device=self.device)
            self.hs_mask = torch.as_tensor(np.array(mask, np.float32),
                                           device=self.device)

    @classmethod
    def from_arrays(cls, vocab: VocabCache, syn0, syn1=None, syn1neg=None,
                    *, use_hs: bool = False, negative: int = 5, hs=None,
                    device: DeviceLike = None) -> "InMemoryLookupTable":
        """A table holding the given arrays (numpy or tensors; the JAX
        package's `syn0` / `syn1` / `syn1neg` as numpy) instead of a seeded
        init, on `device`. `hs` is (codes, points, mask) as
        `Huffman.codes_arrays` gives them; with `use_hs` and no `hs` the
        Huffman tree is built from `vocab`, as the JAX table does."""
        dev = resolve_device(device)

        def put(a):
            return None if a is None else torch.as_tensor(
                np.array(a) if not torch.is_tensor(a) else a,
                dtype=torch.float32, device=dev).clone()

        self = cls.__new__(cls)
        self._setup(vocab, put(syn0), use_hs, negative, hs)
        self.syn1 = put(syn1) if use_hs else None
        if self.use_hs and self.syn1 is None:
            self.syn1 = self._zeros()
        self.syn1neg = put(syn1neg) if self.negative > 0 else None
        if self.negative > 0 and self.syn1neg is None:
            self.syn1neg = self._zeros()
        return self

    # ------------------------------------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return self.syn0[i].detach().cpu().numpy().copy()

    def vectors_matrix(self) -> np.ndarray:
        return self.syn0.detach().cpu().numpy().copy()

    def set_vectors_matrix(self, m):
        self.syn0 = torch.as_tensor(np.asarray(m) if not torch.is_tensor(m)
                                    else m, dtype=torch.float32,
                                    device=self.device)


# ---------------------------------------------------------------------------
# Batched training steps
# ---------------------------------------------------------------------------

def _ns_loss(syn0, syn1neg, centers, contexts, negatives):
    vc = syn0[centers]                    # [B, D]
    up = syn1neg[contexts]                # [B, D]
    un = syn1neg[negatives]               # [B, K, D]
    pos = F.logsigmoid(torch.sum(vc * up, dim=-1))
    neg = torch.sum(F.logsigmoid(-torch.einsum("bd,bkd->bk", vc, un)),
                    dim=-1)
    # SUM over the batch: each pair contributes a full-lr update, matching
    # the reference's per-pair SGD semantics
    return -torch.sum(pos + neg)


def _hs_loss(syn0, syn1, centers, contexts, codes, points, mask):
    """Predict `contexts` from `centers` via the context's Huffman path."""
    vc = syn0[centers]                    # [B, D]
    c = codes[contexts]                   # [B, L]
    p = points[contexts]                  # [B, L]
    m = mask[contexts]                    # [B, L]
    w = syn1[p]                           # [B, L, D]
    dots = torch.einsum("bd,bld->bl", vc, w)
    # label 1 - code (word2vec convention): logsigmoid((1-2c)*dot)
    lp = F.logsigmoid((1.0 - 2.0 * c) * dots) * m
    return -torch.sum(lp)


class _PairStep:
    """A pair-path SGD step: `grads(syn0, syn1, syn1neg, centers, contexts,
    negatives)` gives the summed loss and its gradients (autograd, as JAX's
    `jax.value_and_grad`); calling the step applies them as JAX's step
    does, `new = old - lr * grad`, and returns the loss over the batch
    rows. Absent tables (`syn1` without HS, `syn1neg` without negatives)
    pass through."""

    def __init__(self, table: InMemoryLookupTable, loss_fn):
        self.K = table.negative
        self.use_hs = table.use_hs
        self.table = table
        self._loss_fn = loss_fn

    def names(self) -> List[str]:
        return (["syn0"] + (["syn1neg"] if self.K > 0 else [])
                + (["syn1"] if self.use_hs else []))

    def grads(self, syn0, syn1, syn1neg, centers, contexts, negatives):
        tabs = {"syn0": syn0, "syn1": syn1, "syn1neg": syn1neg}
        leaves = {k: tabs[k].detach().requires_grad_(True)
                  for k in self.names()}
        with torch.enable_grad():
            loss = self._loss_fn(leaves, centers, contexts, negatives)
            gs = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, gs))

    def __call__(self, syn0, syn1, syn1neg, centers, contexts, lr,
                 negatives=None):
        loss, g = self.grads(syn0, syn1, syn1neg, centers, contexts,
                             negatives)
        new0 = syn0 - lr * g["syn0"]
        new1 = syn1 - lr * g["syn1"] if self.use_hs else syn1
        new1n = syn1neg - lr * g["syn1neg"] if self.K > 0 else syn1neg
        return new0, new1, new1n, loss / centers.shape[0]


def make_skipgram_step(table: InMemoryLookupTable) -> _PairStep:
    """step(syn0, syn1, syn1neg, centers, contexts, lr, negatives) ->
    (syn0, syn1, syn1neg, loss). Uses HS and/or NS per the table (reference
    SkipGram.learnSequence:156 handles both); `negatives` [B, K] (drawn by
    the caller) when the table samples negatives."""
    t = table

    def loss_fn(tr, centers, contexts, negatives):
        total = 0.0
        if t.negative > 0:
            total = total + _ns_loss(tr["syn0"], tr["syn1neg"], centers,
                                     contexts, negatives)
        if t.use_hs:
            total = total + _hs_loss(tr["syn0"], tr["syn1"], centers,
                                     contexts, t.hs_codes, t.hs_points,
                                     t.hs_mask)
        return total

    return _PairStep(table, loss_fn)


def make_cbow_step(table: InMemoryLookupTable, window: int) -> _PairStep:
    """CBOW: mean of context-window vectors predicts the center word.
    contexts: [B, 2*window] padded with -1."""
    t = table

    def mean_ctx(syn0, contexts):
        m = (contexts >= 0).to(syn0.dtype)
        safe = contexts.clamp(min=0)
        vecs = syn0[safe] * m[..., None]
        return torch.sum(vecs, dim=1) / torch.clamp(
            torch.sum(m, dim=1, keepdim=True), min=1.0)

    def loss_fn(tr, centers, contexts, negatives):
        h = mean_ctx(tr["syn0"], contexts)            # [B, D]
        total = 0.0
        if t.negative > 0:
            up = tr["syn1neg"][centers]
            un = tr["syn1neg"][negatives]
            pos = F.logsigmoid(torch.sum(h * up, dim=-1))
            neg = torch.sum(F.logsigmoid(
                -torch.einsum("bd,bkd->bk", h, un)), dim=-1)
            total = total - torch.sum(pos + neg)
        if t.use_hs:
            c = t.hs_codes[centers]
            p = t.hs_points[centers]
            m = t.hs_mask[centers]
            w = tr["syn1"][p]
            dots = torch.einsum("bd,bld->bl", h, w)
            lp = F.logsigmoid((1.0 - 2.0 * c) * dots) * m
            total = total - torch.sum(lp)
        return total

    return _PairStep(table, loss_fn)


# ---------------------------------------------------------------------------
# The SGNS expected-negative step
# ---------------------------------------------------------------------------

def _mm_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices with a float32 result: f32 accumulation
    and no rounding to bf16 on the way out (JAX's
    `preferred_element_type=float32`). On the card `torch.mm`'s
    `out_dtype`; elsewhere the f32 product of the bf16 values, which holds
    every bf16 x bf16 product exactly."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _mm_low(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two bf16 matrices, accumulated in f32 and rounded once to
    bf16 (JAX's `preferred_element_type=float32` then `.astype(bf16)`)."""
    if a.is_cuda:
        return torch.mm(a, b)
    return _mm_acc(a, b).to(a.dtype)


def _sgns_expected_step_scatter(vc, s1n, ctx, vm, nvalid, pn, K):
    """The scatter formulation of the expected-NS gradients, the numerical
    oracle of `_sgns_expected_step` (JAX's
    `_sgns_expected_step_scatter`):

      dL/dl = K*nvalid[:,None]*pn[None,:]*sig(l)        (dense)
              - sig(-l[gathered])*vm at (b, ctx_bj)     (sparse)
      gvc   = dL/dl @ s1n;    gs1n = (dL/dl).T @ vc
    """
    logits = vc @ s1n.t()                                   # [B, V]
    sg = torch.sigmoid(logits)
    gl = torch.gather(logits, 1, ctx)                       # [B, 2W]
    pos_l = torch.sum(F.logsigmoid(gl) * vm)
    neg_l = torch.sum(K * nvalid * (F.logsigmoid(-logits) @ pn))
    loss = -(pos_l + neg_l)
    w_pos = torch.sigmoid(-gl) * vm                         # [B, 2W]
    gvc = (K * nvalid)[:, None] * ((sg * pn[None, :]) @ s1n) \
        - torch.einsum("bw,bwd->bd", w_pos, s1n[ctx])
    gs1n = (K * pn)[:, None] * ((sg * nvalid[:, None]).t() @ vc)
    upd = (w_pos[:, :, None] * vc[:, None, :]).reshape(-1, vc.shape[1])
    gs1n = gs1n.index_add(0, ctx.reshape(-1), -upd)
    return loss, gvc, gs1n


def _sgns_expected_step(vc, s1n, ctx, vm, nvalid, pn, K):
    """Expected-NS gradients (JAX's `_sgns_expected_step`, same math as the
    scatter oracle above): the full dense cotangent

        A = dL/dl = K*nvalid[:,None]*pn[None,:]*sig(l) - M,
        M[b, v]  = sum_j w_pos[b, j] * [ctx[b, j] == v]

    then gvc = A @ s1n and gs1n = A.T @ vc, one product each.

    Precision follows JAX's: with float32 tables the [B, V] logits and A
    are bf16, the products accumulate in f32 and the two gradient products
    keep their f32 results (`_mm_acc`); with float64 tables everything is
    float64. The positive logits are gathered from the logits (JAX selects
    them with 2W iota compares: the same values). M is written with one
    `scatter_` of the final value per (b, ctx[b, j]): each entry is A's
    dense value less the summed weights of every j with that context (a
    window holding a word twice sums its weights, as JAX's sequential
    subtractions do), so duplicate indices write equal values and the
    result does not depend on the order of the writes."""
    fast = vc.dtype == torch.float32
    K = float(K)
    if fast:
        ldt, acc = torch.bfloat16, torch.float32
        vcl, s1l = vc.to(ldt), s1n.to(ldt)
        logits = _mm_low(vcl, s1l.t())                      # [B, V] bf16
    else:
        ldt = acc = vc.dtype
        vcl, s1l = vc, s1n
        logits = vc @ s1n.t()
    sg = torch.sigmoid(logits)
    lneg = F.logsigmoid(-logits)
    if fast:
        neg_vec = _mm_acc(lneg, pn.to(ldt)[:, None])[:, 0]   # [B] f32
    else:
        neg_vec = lneg @ pn.to(ldt)
    coef = K * nvalid
    neg_l = torch.sum(coef * neg_vec)
    if fast:
        # coef * (pn * sg) in f32 (sg's bf16 values promoted exactly),
        # rounded to bf16 as it is written
        a = torch.empty_like(logits)
        torch.mul(torch.mul(sg, pn), coef[:, None], out=a)
    else:
        a = coef[:, None] * (pn[None, :] * sg)
    gl = torch.gather(logits, 1, ctx).to(acc)               # [B, 2W]
    pos_l = torch.sum(F.logsigmoid(gl) * vm)
    w = (torch.sigmoid(-gl) * vm).to(ldt).to(acc)           # [B, 2W]
    same = (ctx[:, :, None] == ctx[:, None, :]).to(acc)     # [B, 2W, 2W]
    wsum = torch.einsum("bjk,bk->bj", same, w)
    a.scatter_(1, ctx, (torch.gather(a, 1, ctx).to(acc) - wsum).to(ldt))
    loss = -(pos_l + neg_l)
    if fast:
        gvc = _mm_acc(a, s1l)
        gs1n = _mm_acc(a.t(), vcl)
    else:
        gvc = a @ s1n
        gs1n = a.t() @ vc
    return loss, gvc, gs1n


def _row_sums(index: torch.Tensor, rows: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """[n_rows, D]: row i the sum of the `rows` whose `index` is i (zero
    where none is), duplicates summed in their order. A stable sort, the
    segment bounds by binary search and one segment reduction: the same
    sums as `index_put_(accumulate=True)` into zeros, deterministic on the
    card (no atomics) and free of host syncs (it can be captured)."""
    keys, order = torch.sort(index, stable=True)
    bounds = torch.searchsorted(keys, torch.arange(
        n_rows + 1, dtype=keys.dtype, device=keys.device))
    return torch.segment_reduce(rows[order], "sum", offsets=bounds, axis=0,
                                unsafe=True, initial=0.0)


# ---------------------------------------------------------------------------
# Epochs: eager on the CPU, CUDA-graph replays on the card
# ---------------------------------------------------------------------------

def _captures(device: torch.device) -> bool:
    """Whether epochs on `device` run as CUDA-graph replays: on a CUDA
    device, always."""
    return device.type == "cuda"


class _Epochs:
    """Runs `commit(compute(row, consts))` over T rows of per-step inputs.

    `compute(row, consts)` reads the step's row (a dict of tensors), the
    epoch's constants (a dict of 1-D tensors of one length n, with "n" the
    length as a 0-dim tensor; only their first n entries may be read) and
    tables that exist before the call, and returns its outputs with the
    step's loss first; `commit(outs)` applies them to the tables in place.
    On the CPU the rows are slices of the epoch's tensors and the loop is
    eager. On a CUDA device the step is captured once per signature: the
    epoch's rows and constants are staged into static buffers, a device
    step counter selects the row, and the graph adds the loss to an
    accumulator and advances the counter, so each step is one `replay()`.
    The rows' capacity is `pad_scan_length(T)`, the constants' n plus a
    sixteenth (re-captured when an epoch outgrows either). `captures` /
    `replays` count both; a step that cannot be captured raises
    `nn.superstep.CaptureError`."""

    def __init__(self, name: str):
        self.name = name
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[tuple, dict] = {}

    def __call__(self, compute, commit, rows: Dict[str, torch.Tensor],
                 T: int, key: tuple = (),
                 consts: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        consts = consts or {}
        n = len(next(iter(consts.values()))) if consts else 0
        dev = next(iter(rows.values())).device
        if not _captures(dev):
            c = dict(consts, n=torch.tensor(n, device=dev))
            total = None
            for t in range(T):
                outs = compute({k: v[t] for k, v in rows.items()}, c)
                commit(outs)
                total = outs[0] if total is None else total + outs[0]
            return total / T
        sig = (key, tuple((k, tuple(v.shape[1:]), v.dtype)
                          for k, v in sorted(rows.items())),
               tuple((k, v.dtype) for k, v in sorted(consts.items())))
        ent = self._graphs.get(sig)
        if ent is None or ent["cap"] < T or ent["cap_n"] < n:
            self._graphs.pop(sig, None)
            ent = self._capture(compute, commit, rows, T, consts, n, dev)
            self._graphs[sig] = ent
        for k, v in rows.items():
            ent["rows"][k][:T].copy_(v[:T])
        for k, v in consts.items():
            ent["consts"][k][:n].copy_(v)
        ent["consts"]["n"].fill_(n)
        ent["t"].zero_()
        ent["loss"].zero_()
        for _ in range(T):
            ent["graph"].replay()
        self.replays += T
        return ent["loss"] / T

    def _capture(self, compute, commit, rows, T, consts, n, dev):
        from ..nn.superstep import _Graph
        from ..telemetry import runtime
        cap = pad_scan_length(T)
        cap_n = n + n // 16 + 1 if consts else 0
        statics = {k: torch.zeros((cap,) + tuple(v.shape[1:]),
                                  dtype=v.dtype, device=dev)
                   for k, v in rows.items()}
        cstat = {k: torch.zeros(cap_n, dtype=v.dtype, device=dev)
                 for k, v in consts.items()}
        cstat["n"] = torch.tensor(n, dtype=torch.int64, device=dev)
        t_idx = torch.zeros(1, dtype=torch.int64, device=dev)
        loss = torch.zeros((), dtype=torch.float64, device=dev)

        def g_compute():
            return compute({k: torch.index_select(s, 0, t_idx).squeeze(0)
                            for k, s in statics.items()}, cstat)

        def g_commit(outs):
            commit(outs)
            loss.add_(outs[0])
            t_idx.add_(1)

        t0 = time.perf_counter()
        graph = _Graph(self.name, g_compute, g_commit, dev)
        self.captures += 1
        sess = runtime.active()
        if sess is not None:
            sess.compiles.record_capture(self.name,
                                         time.perf_counter() - t0)
        return {"graph": graph, "rows": statics, "consts": cstat,
                "t": t_idx, "loss": loss, "cap": cap, "cap_n": cap_n}


def make_epoch_runner(step: _PairStep, reduce: Optional[Callable] = None,
                      name: str = "word2vec/epoch"):
    """run_epoch(syn0, syn1, syn1neg, centers, contexts, lrs, negatives) ->
    (syn0, syn1, syn1neg, mean_loss): T batched SGD steps of `step`, the
    tables updated in place. centers: [T, B]; contexts: [T, B] or
    [T, B, C]; lrs: [T]; negatives: [T, B, K] or None. `reduce(tensors)`
    sums a step's loss and gradients over data-parallel ranks in place.
    The runner's `epochs` counts its captures and replays (as `name`)."""
    epochs = _Epochs(name)
    names = step.names()

    def run_epoch(syn0, syn1, syn1neg, centers, contexts, lrs,
                  negatives=None):
        tabs = {"syn0": syn0, "syn1": syn1, "syn1neg": syn1neg}

        def compute(r, _):
            loss, g = step.grads(syn0, syn1, syn1neg, r["c"], r["x"],
                                 r.get("neg"))
            return (loss, r["lr"]) + tuple(g[k] for k in names)

        def commit(outs):
            loss, lr, gs = outs[0], outs[1], outs[2:]
            if reduce is not None:
                reduce([loss] + list(gs))
            for k, gk in zip(names, gs):
                tabs[k].sub_(lr * gk)

        rows = {"c": centers, "x": contexts, "lr": lrs}
        if negatives is not None:
            rows["neg"] = negatives
        B = centers.shape[1]
        # the reported loss is per batch row, as JAX's step returns it
        loss = epochs(compute, commit, rows, int(centers.shape[0]),
                      key=tuple(tabs[k].data_ptr() for k in names))
        return syn0, syn1, syn1neg, loss / B

    run_epoch.epochs = epochs
    return run_epoch


def make_skipgram_corpus_runner(table: InMemoryLookupTable, window: int,
                                reduce: Optional[Callable] = None):
    """The SGNS epoch over a corpus on the device (JAX's
    `make_skipgram_corpus_runner`): each step takes a batch of center
    POSITIONS, gathers its own context windows (reduced window b ~ U[1, W]
    per center, masked at the corpus ends and at sentence boundaries: the
    same pair set as `SkipGram.java`'s window loop), computes the expected
    negative-sampling loss over the full vocabulary
    (`_sgns_expected_step`) and applies the batched SGD update. The
    context windows are `corpus[pos + off]` gathered per step (JAX keeps
    two [n, 2W] window tables).

    Returns run(syn0, syn1neg, corpus, sid, positions, windows, lrs) ->
    (syn0, syn1neg, mean_loss), the tables updated in place; positions and
    windows [T, B] int64 (windows: each center's reduced window b), lrs
    [T]. `reduce(tensors)` sums a step's loss and gradients over
    data-parallel ranks in place. `run.epochs` counts captures and
    replays."""
    K = table.negative
    if K <= 0:
        raise ValueError("corpus runner is NS-only; HS uses the pair path")
    pn = table.sampler.probs
    W = int(window)
    offs = torch.tensor(list(range(-W, 0)) + list(range(1, W + 1)),
                        dtype=torch.int64, device=pn.device)
    reach = offs.abs()
    epochs = _Epochs("word2vec/sgns_epoch")

    def run(syn0, syn1neg, corpus, sid, positions, windows, lrs):
        def compute(r, c):
            pos, b, n = r["pos"], r["b"], c["n"]
            corp, sids = c["corpus"], c["sid"]
            j = pos[:, None] + offs[None, :]                 # [B, 2W]
            jc = torch.minimum(j.clamp(min=0), n - 1)
            valid = ((j >= 0) & (j < n)
                     & (reach[None, :] <= b[:, None])
                     & (sids[jc] == sids[pos][:, None]))
            centers = corp[pos]                              # [B]
            ctx = corp[jc]                                   # [B, 2W]
            vm = valid.to(torch.float32)
            nvalid = torch.sum(vm, dim=1)
            loss, gvc, gs1n = _sgns_expected_step(
                syn0[centers], syn1neg, ctx, vm, nvalid, pn, K)
            # the center rows' gradient summed per row (duplicate centers
            # sum, as JAX's one-hot product does), then one scaled update
            d0 = _row_sums(centers, gvc.to(syn0.dtype), syn0.shape[0])
            return loss, r["lr"], d0, gs1n.to(syn1neg.dtype)

        def commit(outs):
            loss, lr, d0, gs1n = outs
            if reduce is not None:
                reduce([loss, d0, gs1n])
            syn0.sub_(lr * d0)
            syn1neg.sub_(lr * gs1n)

        rows = {"pos": positions, "b": windows, "lr": lrs}
        loss = epochs(compute, commit, rows, int(positions.shape[0]),
                      key=(syn0.data_ptr(), syn1neg.data_ptr()),
                      consts={"corpus": corpus, "sid": sid})
        return syn0, syn1neg, loss

    run.epochs = epochs
    return run


# ---------------------------------------------------------------------------
# Query-side API (BasicModelUtils parity)
# ---------------------------------------------------------------------------

class WordVectorsModel:
    """similarity / wordsNearest over a lookup table (reference
    `reader/impl/BasicModelUtils.java`)."""

    def __init__(self, vocab: VocabCache, table: InMemoryLookupTable):
        self.vocab = vocab
        self.lookup_table = table

    def has_word(self, w: str) -> bool:
        return self.vocab.contains_word(w)

    def word_vector(self, w: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(w)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        d = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(np.dot(va, vb) / d) if d else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.word_vector(word_or_vec)
            exclude = list(exclude) + [word_or_vec]
            if vec is None:
                return []
        else:
            vec = np.asarray(word_or_vec)
        m = self.lookup_table.vectors_matrix()
        norms = np.linalg.norm(m, axis=1) * (np.linalg.norm(vec) + 1e-12)
        sims = m @ vec / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w in exclude:
                continue
            vw = self.vocab.element_at_index(int(i))
            if vw is not None and vw.is_label:
                continue
            out.append(w)
            if len(out) >= top_n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str], top_n: int = 10):
        """king - man + woman style analogy queries."""
        vec = np.zeros(self.lookup_table.vector_length, np.float32)
        for w in positive:
            v = self.word_vector(w)
            if v is not None:
                vec += v
        for w in negative:
            v = self.word_vector(w)
            if v is not None:
                vec -= v
        return self.words_nearest(vec, top_n,
                                  exclude=list(positive) + list(negative))
