"""Inference plane of the port (of `deeplearning4j_tpu/serving/`).

Four pieces, layered:
  * `ModelRegistry` (registry.py) — named, versioned servable models with
    atomic hot-swap from verified checkpoint sources, warmed batch buckets,
    `fp32` / `bf16` / `int8` snapshots and canary routing.
  * int8 weight-only quantization and the bf16 cast (quantize.py).
  * `DynamicBatcher` (batcher.py) — coalesces concurrent requests into
    padded bucket-shaped batches.
  * `InferenceServer` (server.py) — the HTTP front end (`/v1/models`,
    `/predict`, `/swap`, `/generate`, `/canary`, `/healthz`, `/metrics`,
    `/debug/flightrecord`), with the decode plane (`decode/`) behind
    `/generate`.

`serving/bench.py` drives concurrent closed-loop clients through the data
plane (batched against direct, a swap under load); `decode/bench.py`
compares continuous with static batching of generation.
"""
from .batcher import BatcherClosedError, DynamicBatcher
from .bench import run_serving_bench
from .quantize import QuantizedTree, cast_tree, quantize_tree
from .registry import (AotCompileError, CanaryState, DEFAULT_BUCKETS,
                       ModelRegistry, PRECISIONS, ServableVersion,
                       ServingError, UnknownModelError, load_source)
from .server import ClientError, InferenceServer

__all__ = [
    "ModelRegistry", "ServableVersion", "ServingError", "UnknownModelError",
    "AotCompileError", "CanaryState",
    "DEFAULT_BUCKETS", "PRECISIONS", "load_source",
    "DynamicBatcher", "BatcherClosedError",
    "InferenceServer", "ClientError",
    "QuantizedTree", "quantize_tree", "cast_tree",
    "run_serving_bench",
]
