"""Paged KV-cache arena and block-pool allocator (vLLM's PagedAttention,
Kwon et al., SOSP 2023), the port of
`deeplearning4j_tpu/serving/decode/cache.py`.

One preallocated arena per pool holds every concurrent sequence's keys and
values, on the serving device:

    arena  [num_blocks, block_len, 2*L, H, Dh]

where channel ``2l`` is layer l's keys and ``2l+1`` its values. A sequence
owns an ordered list of block ids (its block table); cache slot ``t`` of a
sequence lives at ``(table[t // block_len], t % block_len)``. The decode
steps scatter new K/V by block index and gather a sequence's cache view
through its table, both by tensor indexing, and update the arena in place
(JAX donates it to its compiled steps, to the same end).

Block 0 is reserved (the "trash" block): padded batch slots and overflow
prompt positions write there and their reads are always masked by the
row's valid length. Allocation never hands out block 0.

int8 KV (``kv_dtype="int8"``): the arena is int8 beside a float32 scale
arena ``[num_blocks, block_len, 2*L]`` — per-tensor symmetric quantization
(scale = absmax / 127) of each cached (position, layer, K|V) vector,
quantized at scatter time and dequantized inside the gather.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List

import torch

__all__ = ["KvCacheSpec", "BlockPool", "OutOfBlocksError", "make_cache",
           "pack_kv", "unpack_kv"]


_POOL_IDS = itertools.count(1)


class OutOfBlocksError(RuntimeError):
    """Allocation against an exhausted pool — the scheduler's cue to evict
    (preempt) a running sequence."""


@dataclass(frozen=True)
class KvCacheSpec:
    """Static shape contract of one servable's paged cache."""

    n_layers: int          # transformer blocks L (arena channels = 2L)
    n_heads: int
    d_head: int
    block_len: int         # cache slots per block
    num_blocks: int        # arena height, including the reserved block 0
    max_context: int       # hard cap (the positional table length)
    kv_dtype: str = "fp32"   # "fp32" | "int8"

    def __post_init__(self):
        if self.kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_dtype must be fp32|int8, got "
                             f"{self.kv_dtype!r}")
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved trash block)")
        if self.block_len < 1 or self.max_context < 1:
            raise ValueError("block_len and max_context must be >= 1")

    @property
    def table_width(self) -> int:
        """Block-table columns per sequence: enough for max_context."""
        return -(-self.max_context // self.block_len)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of `n_tokens` cache slots occupies."""
        return -(-max(1, n_tokens) // self.block_len)

    def arena_nbytes(self) -> int:
        slots = self.num_blocks * self.block_len * 2 * self.n_layers
        per = self.n_heads * self.d_head
        if self.kv_dtype == "int8":
            return slots * per + slots * 4      # int8 data + f32 scales
        return slots * per * 4


def make_cache(spec: KvCacheSpec, device) -> Dict[str, torch.Tensor]:
    """A fresh zeroed cache on `device`: {"kv": arena}, and for int8 the
    per-slot scale arena {"scale": ones}."""
    shape = (spec.num_blocks, spec.block_len, 2 * spec.n_layers,
             spec.n_heads, spec.d_head)
    if spec.kv_dtype == "int8":
        return {"kv": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale": torch.ones(shape[:3], dtype=torch.float32,
                                    device=device)}
    return {"kv": torch.zeros(shape, dtype=torch.float32, device=device)}


def pack_kv(spec: KvCacheSpec, x):
    """K or V slices [..., H, Dh] prepared for a cache scatter: (values,
    scales or None). int8 quantizes each leading-index vector (per-tensor
    symmetric over the trailing [H, Dh])."""
    if spec.kv_dtype != "int8":
        return x, None
    absmax = x.abs().amax(dim=(-2, -1))
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale.float()


def unpack_kv(spec: KvCacheSpec, q, scale):
    """Dequantize a gathered cache view (the inverse of `pack_kv`)."""
    if spec.kv_dtype != "int8":
        return q
    return q.float() * scale[..., None, None]


class BlockPool:
    """Host-side free-list allocator over the arena's block ids.

    The pool owns the device cache (`cache`, updated in place by the decode
    steps) and the CUDA graphs captured against it (`graphs`, filled by the
    engine on the card: a graph bakes in the arena's address), so
    eviction, reuse and accounting share one lock. Thread-safe; the
    scheduler's worker is the only one that runs steps on it."""

    def __init__(self, spec: KvCacheSpec, device, metrics=None,
                 name: str = "model"):
        self.spec = spec
        self.name = name
        self.serial = next(_POOL_IDS)   # names its captures
        self.device = torch.device(device)
        self.cache = make_cache(spec, self.device)
        self.graphs: Dict[tuple, object] = {}   # (version, phase, bucket)
        self.graph_pool = None                  # their shared memory pool
        # guards `graphs` and `graph_pool`: a swap's listener captures the
        # next version's graphs while the worker drops an older version's
        self.graph_lock = threading.Lock()
        self._lock = threading.Lock()
        # LIFO free list: a just-freed block is reused first — also what
        # makes the reuse-after-release test deterministic about which
        # blocks recycle
        self._free: List[int] = list(range(spec.num_blocks - 1, 0, -1))
        self._blocks_g = None
        if metrics is not None:
            self._blocks_g = metrics.gauge(
                "dl4j_decode_kv_blocks",
                "paged KV arena blocks by state (block 0 reserved)",
                labels=("model", "state"))
            self._report()

    def _report(self):
        if self._blocks_g is not None:
            free = len(self._free)
            self._blocks_g.set(free, model=self.name, state="free")
            self._blocks_g.set(self.spec.usable_blocks - free,
                               model=self.name, state="used")

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_blocks(self) -> int:
        return self.spec.usable_blocks - self.free_blocks()

    def alloc(self, n: int) -> List[int]:
        """Take `n` blocks or raise OutOfBlocksError (all or nothing: a
        partial grab under pressure would deadlock two growing sequences
        against each other)."""
        with self._lock:
            if n > len(self._free):
                raise OutOfBlocksError(
                    f"{self.name}: need {n} KV blocks, {len(self._free)} "
                    f"free of {self.spec.usable_blocks}")
            taken = [self._free.pop() for _ in range(n)]
            self._report()
            return taken

    def release(self, blocks: List[int]):
        with self._lock:
            for b in blocks:
                if not 0 < b < self.spec.num_blocks:
                    raise ValueError(f"bad KV block id {b}")
            self._free.extend(reversed(blocks))
            self._report()
