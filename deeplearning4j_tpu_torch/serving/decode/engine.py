"""The KV-cache generation forward: the prefill and decode-tick steps over
the transformer stack's decode mode (the port of
`deeplearning4j_tpu/serving/decode/engine.py`).

Two steps per servable, built once per (model signature, phase, bucket)
through the registry's shared runner cache (`ModelRegistry.compile_cached`,
keys ("decode", sig, phase, bucket)), so a same-architecture hot-swap reuses
them as JAX reuses its executables:

  prefill(data, cache, tokens [1, Tp], length, tables [1, W], spec)
      -> next-token logits [1, V]
    The whole right-padded prompt runs as one causal forward while every
    layer's K/V projections scatter into the paged arena through the
    sequence's block table. The prompt attends through kernel 1
    (`flash_attention_heads(q, k, v, causal=True)`, the primal: one launch
    per block on the card, its plain version on the CPU) over the local,
    exact projections, so an int8 cache only affects later ticks. JAX runs
    `attention_reference` here with the prompt length as `kv_length`; for
    every row t < length the causal mask already confines the keys to
    j <= t < length, so the rows that are ever read are the same. Only the
    K/V that pad rows t >= length write differ, and no tick reads such a
    slot before a tick at that position has overwritten it.

  decode(data, cache, tokens [B], positions [B], tables [B, W], spec)
      -> logits [B, V]
    One token per row: embed at its absolute position, scatter its K/V into
    the arena, gather the row's whole cache view through its table, attend
    with causal offsets and the row's valid length (the plain masked
    attention, as JAX's tick runs `attention_reference`), project logits.

The arena is updated in place by tensor indexing (JAX donates it). Rows are
independent throughout, so joining and leaving the decode batch between
ticks leaves the other rows' bits alone within a bucket.

On the card a tick is one CUDA graph per (pool, version, decode bucket):
static inputs (token, position and block-table rows in one int64 buffer),
the pool's arena, the version's parameter snapshot and a logits buffer baked
in. `prepare()` captures them, and warms the prefill of every prompt bucket
(eager: the prefill launches kernel 1 directly), when generation is enabled
and before a new version goes live (the registry's version listeners), so
no request waits on a capture. A graph holds its weights' addresses, so,
unlike JAX's executables, it is captured anew for each version. A capture
that fails raises `AotCompileError`; the card never runs a tick eagerly in
its place. On the CPU the steps run eagerly.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..registry import AotCompileError, ServingError, _abstract_sig
from .cache import BlockPool, KvCacheSpec, pack_kv, unpack_kv

__all__ = ["DecodeEngine", "build_prefill_fn", "build_decode_fn",
           "split_decode_layers"]


def split_decode_layers(model):
    """(embedding, [blocks...], head) of a generate-capable stack, or
    ServingError. The decode plane supports exactly the GPT shape:
    EmbeddingSequenceLayer -> TransformerBlock* -> an output layer with
    `preout` (logits before the softmax activation)."""
    from ...nn.layers.transformer import (EmbeddingSequenceLayer,
                                          TransformerBlock)

    layers = getattr(model, "layers", None)
    if not layers or len(layers) < 3 \
            or not isinstance(layers[0], EmbeddingSequenceLayer) \
            or not all(isinstance(b, TransformerBlock)
                       for b in layers[1:-1]) \
            or not hasattr(layers[-1], "preout"):
        raise ServingError(
            "generation needs an EmbeddingSequenceLayer -> "
            "TransformerBlock* -> output-layer stack; got "
            f"{[type(l).__name__ for l in (layers or [])]}")
    if getattr(model.conf, "preprocessors", None):
        raise ServingError(
            "generation does not support input preprocessors between "
            "decode layers")
    return layers[0], list(layers[1:-1]), layers[-1]


def _scatter(spec, cache, values, blk, off, channel):
    """Write K or V `values` (leading index shape == blk / off's) into the
    arena at (blk, off, channel), quantizing for an int8 cache."""
    vals, scales = pack_kv(spec, values)
    kv = cache["kv"]
    kv[blk, off, channel] = vals.to(kv.dtype)
    if scales is not None:
        cache["scale"][blk, off, channel] = scales


def _gather(spec, cache, tables, channel):
    """Sequence-major cache view [B, W * block_len, H, Dh] of one channel,
    dequantized: each row reads its own blocks through its table (dead
    table slots point at the trash block and are always length-masked)."""
    b = tables.shape[0]
    view = cache["kv"][:, :, channel][tables]        # [B, W, bl, H, Dh]
    view = view.reshape(b, -1, spec.n_heads, spec.d_head)
    if "scale" not in cache:
        return view
    scale = cache["scale"][:, :, channel][tables].reshape(b, -1)
    return unpack_kv(spec, view, scale)


def build_prefill_fn(model, snapshot):
    """The prefill step (module docstring). Closed over the layer configs
    and the snapshot's structure only: the parameter data, the cache and
    its spec are arguments, so one step serves every same-signature
    version and pool."""
    from ...kernels.attention import flash_attention_heads

    emb, blocks, head = split_decode_layers(model)

    def prefill(data, cache, tokens, length: int, tables, spec):
        params = snapshot.rebuild(data)
        b, tp = tokens.shape
        tidx = torch.arange(tp, device=tokens.device)
        pos = tidx.expand(b, tp)
        x = emb.decode_embed(params[0], tokens, pos)
        # right-padded prompt slots scatter too (table slots past the
        # allocation point at the trash block), so a reused block is
        # overwritten as a fresh one would be
        blk = tables[:, tidx // spec.block_len]
        off = (tidx % spec.block_len).expand(b, tp)
        for i, layer in enumerate(blocks):
            q, k, v = layer.decode_qkv(params[1 + i], x)
            _scatter(spec, cache, k, blk, off, 2 * i)
            _scatter(spec, cache, v, blk, off, 2 * i + 1)
            a = flash_attention_heads(q, k, v, causal=True)
            x = layer.decode_finish(params[1 + i], x, a)
        last = x[:, length - 1:length]
        return head.preout(params[-1], {}, last)[:, 0].to(torch.float32)

    return prefill


def build_decode_fn(model, snapshot):
    """The one-token decode tick (module docstring)."""
    emb, blocks, head = split_decode_layers(model)

    def decode(data, cache, tokens, positions, tables, spec):
        params = snapshot.rebuild(data)
        b = tokens.shape[0]
        lengths = positions + 1          # pad rows: position 0 -> length 1
        x = emb.decode_embed(params[0], tokens[:, None], positions[:, None])
        rows = torch.arange(b, device=tokens.device)
        blk = tables[rows, positions // spec.block_len]
        off = positions % spec.block_len
        for i, layer in enumerate(blocks):
            q, k, v = layer.decode_qkv(params[1 + i], x)
            _scatter(spec, cache, k[:, 0], blk, off, 2 * i)
            _scatter(spec, cache, v[:, 0], blk, off, 2 * i + 1)
            k_all = _gather(spec, cache, tables, 2 * i)
            v_all = _gather(spec, cache, tables, 2 * i + 1)
            a = layer.decode_attend(q, k_all, v_all, positions[:, None],
                                    lengths)
            x = layer.decode_finish(params[1 + i], x, a)
        return head.preout(params[-1], {}, x)[:, 0].to(torch.float32)

    return decode


def _pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


class _TickGraph:
    """One captured decode tick: its static input rows [bucket, 2 + W]
    (token, position, block table), its logits buffer, and the version whose
    parameters it reads (kept alive with it)."""

    def __init__(self, engine, v, pool, bucket):
        from ...nn.superstep import _Graph
        spec = engine.spec
        dev = pool.device
        self.version = v
        self.inputs = torch.zeros((bucket, 2 + spec.table_width),
                                  dtype=torch.int64, device=dev)
        step = engine.decode_exec(v, bucket)
        inp, cache, data = self.inputs, pool.cache, v.snapshot.data

        def compute():
            with torch.no_grad():
                return step(data, cache, inp[:, 0], inp[:, 1], inp[:, 2:],
                            spec)

        def commit(out):
            self.logits = out

        with pool.graph_lock:
            if pool.graph_pool is None:
                pool.graph_pool = torch.cuda.graph_pool_handle()
        self._graph = _Graph(f"serving/decode:{engine.name}:pool"
                             f"{pool.serial}/tick-b{bucket}",
                             compute, commit, dev, (), thread_local=True,
                             mempool=pool.graph_pool)

    def replay(self, rows: np.ndarray) -> torch.Tensor:
        self.inputs.copy_(torch.from_numpy(rows))
        self._graph.replay()
        return self.logits


class DecodeEngine:
    """Step frontend for one servable's generation plane.

    Owns the static cache geometry (`spec`) and the bucket ladders; the step
    functions live in the registry's per-model cache, so swaps and the
    compile accounting behave as the stateless runners do. The scheduler
    calls `run_prefill` / `run_tick` with host data."""

    def __init__(self, registry, name: str, *, block_len: int = 16,
                 num_blocks: Optional[int] = None, kv_dtype: str = "fp32",
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 prompt_buckets: Optional[Sequence[int]] = None):
        self.registry = registry
        self.name = name
        self.device = registry.device
        v = registry.get(name)
        if v.model is None:
            raise ServingError(
                f"{name}: servable holds no live model object — "
                "generation needs the layer stack")
        emb, blocks, head = split_decode_layers(v.model)
        d = emb.n_out
        heads = blocks[0].n_heads
        if any(blk.n_heads != heads for blk in blocks):
            raise ServingError(f"{name}: blocks disagree on n_heads")
        max_context = int(v.model.params[0]["P"].shape[0])
        self.decode_buckets = tuple(sorted(int(b) for b in decode_buckets))
        if num_blocks is None:
            # full residency for a max-bucket batch of max-context
            # sequences, plus the reserved trash block
            per_seq = -(-max_context // block_len)
            num_blocks = 1 + per_seq * self.decode_buckets[-1]
        self.spec = KvCacheSpec(
            n_layers=len(blocks), n_heads=heads, d_head=d // heads,
            block_len=int(block_len), num_blocks=int(num_blocks),
            max_context=max_context, kv_dtype=kv_dtype)
        self.prompt_buckets = (tuple(sorted(int(b) for b in prompt_buckets))
                               if prompt_buckets else
                               _pow2_buckets(min(8, max_context),
                                             max_context))
        if self.prompt_buckets[-1] > max_context:
            raise ServingError(
                f"{name}: prompt bucket {self.prompt_buckets[-1]} exceeds "
                f"the positional table ({max_context})")
        self.captures = 0           # tick graphs captured
        self.lazy_captures = 0      # of them, captured on a tick's call

    # -- geometry --------------------------------------------------------
    @property
    def max_context(self) -> int:
        return self.spec.max_context

    @property
    def uses_graphs(self) -> bool:
        """Whether ticks run as captured CUDA graphs (on the card)."""
        return self.device.type == "cuda"

    def new_pool(self, metrics=None) -> BlockPool:
        return BlockPool(self.spec, self.device, metrics=metrics,
                         name=self.name)

    def prompt_bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ServingError(
            f"{self.name}: prompt of {n} tokens exceeds the context "
            f"window {self.max_context}")

    def decode_bucket_for(self, rows: int) -> int:
        for b in self.decode_buckets:
            if rows <= b:
                return b
        raise ServingError(
            f"{self.name}: decode batch {rows} exceeds bucket "
            f"{self.decode_buckets[-1]}")

    # -- steps -------------------------------------------------------------
    def _check_version(self, v):
        # a hot-swap to another architecture would change the cache
        # geometry under live sequences: fail loudly instead
        emb, blocks, _ = split_decode_layers(v.model)
        if (len(blocks) != self.spec.n_layers
                or blocks[0].n_heads != self.spec.n_heads
                or emb.n_out != self.spec.n_heads * self.spec.d_head):
            raise ServingError(
                f"{self.name}: swapped architecture no longer matches the "
                "generation cache geometry; re-enable generation")
        return v

    def prefill_exec(self, v, t_bucket: int):
        sig = _abstract_sig(v.snapshot, v.state, v.precision)
        return self.registry.compile_cached(
            self.name, ("decode", sig, "prefill", t_bucket),
            lambda: build_prefill_fn(v.model, v.snapshot),
            f"prefill-t{t_bucket}")

    def decode_exec(self, v, bucket: int):
        sig = _abstract_sig(v.snapshot, v.state, v.precision)
        return self.registry.compile_cached(
            self.name, ("decode", sig, "tick", bucket),
            lambda: build_decode_fn(v.model, v.snapshot),
            f"decode-b{bucket}")

    # -- CUDA graphs -------------------------------------------------------
    def prepare(self, v, pool: BlockPool):
        """Before `v` serves from `pool` on the card: capture its tick for
        every decode bucket and warm its prefill for every prompt bucket
        (the warm-up's launches kept off the counters). Raises
        AotCompileError on a failed capture or warm-up. A no-op on the CPU,
        where the steps run eagerly and are built on first use."""
        if not self.uses_graphs:
            return
        from ... import kernels
        self._check_version(v)
        for tb in self.prompt_buckets:
            try:
                with kernels.tally():
                    self._prefill(v, pool, [0], tb, [0])
            except Exception as e:
                raise AotCompileError(self.name, f"prefill-t{tb}", e) from e
        for b in self.decode_buckets:
            self._tick_graph(v, pool, b)

    def _tick_graph(self, v, pool: BlockPool, bucket: int,
                    lazy: bool = False) -> _TickGraph:
        key = (id(v), "tick", bucket)
        with pool.graph_lock:
            g = pool.graphs.get(key)
        if g is not None:
            return g
        t0 = time.perf_counter()
        try:
            g = _TickGraph(self, v, pool, bucket)
        except Exception as e:
            raise AotCompileError(self.name, f"tick-b{bucket}", e) from e
        with pool.graph_lock:
            kept = pool.graphs.setdefault(key, g)
            if kept is not g:       # another thread captured it meanwhile
                return kept
            self.captures += 1
            self.lazy_captures += int(lazy)
        from ...telemetry import runtime
        tel = runtime.active()
        if tel is not None:
            tel.compiles.record_capture(
                f"serving/decode:{self.name}:pool{pool.serial}"
                f"/tick-b{bucket}", time.perf_counter() - t0)
        return g

    def release_graphs(self, pool: BlockPool, live):
        """Drop `pool`'s graphs of the versions that `live` replaced (those
        flipped in before it; a version still being prepared for its flip
        has no number yet and keeps its graphs). Under the pool's graph
        lock: a registry listener may be capturing the next version's
        graphs into the same pool meanwhile."""
        with pool.graph_lock:
            for key in [k for k in pool.graphs
                        if pool.graphs[k].version is not live
                        and 0 < pool.graphs[k].version.version
                        < live.version]:
                del pool.graphs[key]

    # -- host-facing phases ----------------------------------------------
    def _pad_table(self, table: Sequence[int]) -> List[int]:
        w = self.spec.table_width
        if len(table) > w:
            raise ServingError(f"{self.name}: block table of {len(table)} "
                               f"exceeds width {w}")
        return list(table) + [0] * (w - len(table))

    def _prefill(self, v, pool, prompt, tb, table) -> torch.Tensor:
        n = len(prompt)
        tokens = torch.zeros((1, tb), dtype=torch.int64)
        tokens[0, :n] = torch.as_tensor(prompt, dtype=torch.int64)
        tables = torch.as_tensor([self._pad_table(table)], dtype=torch.int64)
        step = self.prefill_exec(v, tb)
        with torch.no_grad():
            return step(v.snapshot.data, pool.cache,
                        tokens.to(self.device), n, tables.to(self.device),
                        self.spec)

    def run_prefill(self, v, pool: BlockPool, prompt: Sequence[int],
                    table: Sequence[int], ctx=None) -> np.ndarray:
        """Write `prompt`'s K/V through `table`, return the next-token
        logits [V]. Batch 1, one step per prompt bucket. `ctx` is an
        optional TraceContext: bucket_select and prefill child spans."""
        self._check_version(v)
        n = len(prompt)
        t_sel = time.perf_counter()
        tb = self.prompt_bucket_for(n)
        if ctx is not None:
            ctx.emit("bucket_select", t_sel, time.perf_counter(),
                     model=self.name, phase="prefill", bucket=tb, tokens=n)
        t0 = time.perf_counter()
        logits = self._prefill(v, pool, prompt, tb, table)
        out = logits[0].cpu().numpy()   # host sync: the span covers the work
        if ctx is not None:
            ctx.emit("prefill", t0, time.perf_counter(),
                     model=self.name, bucket=tb, tokens=n)
        return out

    def run_tick(self, v, pool: BlockPool, tokens: Sequence[int],
                 positions: Sequence[int], tables: Sequence[Sequence[int]],
                 bucket: int, ctxs=None) -> np.ndarray:
        """One decode tick over `len(tokens)` live rows padded up to
        `bucket` (pad rows park at the trash block, length 1; their logits
        are dropped). Returns logits [rows, V]. `ctxs` is an optional
        per-row TraceContext list: each traced row gets a decode_tick
        child span for this shared step."""
        self._check_version(v)
        rows = len(tokens)
        if rows > bucket:
            raise ServingError(f"{rows} rows > decode bucket {bucket}")
        inp = np.zeros((bucket, 2 + self.spec.table_width), np.int64)
        inp[:rows, 0] = np.asarray(tokens, np.int64)
        inp[:rows, 1] = np.asarray(positions, np.int64)
        for i, t in enumerate(tables):
            inp[i, 2:] = self._pad_table(t)
        t0 = time.perf_counter()
        if self.uses_graphs:
            logits = self._tick_graph(v, pool, bucket, lazy=True).replay(inp)
        else:
            step = self.decode_exec(v, bucket)
            x = torch.from_numpy(inp)
            with torch.no_grad():
                logits = step(v.snapshot.data, pool.cache, x[:, 0], x[:, 1],
                              x[:, 2:], self.spec)
        out = logits[:rows].cpu().numpy()   # host sync
        if ctxs:
            t1 = time.perf_counter()
            for i, c in enumerate(ctxs[:rows]):
                if c is not None:
                    c.emit("decode_tick", t0, t1, model=self.name,
                           bucket=bucket, rows=rows,
                           position=int(positions[i]))
        return out
