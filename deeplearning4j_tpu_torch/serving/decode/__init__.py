"""Autoregressive decode plane: KV-cache generation beside the stateless
serving plane (the port of `deeplearning4j_tpu/serving/decode/`).

  * `cache`     — the paged KV-block arena on the device and the host-side
                  block-pool allocator (PagedAttention-style block tables).
  * `engine`    — the KV-cache forward: the prefill (through kernel 1) and
                  the decode tick (a CUDA graph per version and bucket on
                  the card) over TransformerBlock's decode mode.
  * `scheduler` — Orca-style token-granularity continuous batching:
                  sequences join and leave the decode batch between ticks.
  * `bench`     — the closed-loop continuous-vs-static generation bench.
"""
from .cache import BlockPool, KvCacheSpec, OutOfBlocksError
from .engine import DecodeEngine
from .scheduler import GenerationError, GenerationScheduler

__all__ = ["BlockPool", "KvCacheSpec", "OutOfBlocksError", "DecodeEngine",
           "GenerationScheduler", "GenerationError"]
