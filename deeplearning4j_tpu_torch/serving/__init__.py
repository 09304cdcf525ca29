"""Inference plane of the port: `ModelRegistry` (versioned atomic
hot-swap over warmed batch buckets), `DynamicBatcher` (request coalescing
into padded buckets) and `InferenceServer` (the HTTP front end)."""
from .batcher import BatcherClosedError, DynamicBatcher
from .registry import (DEFAULT_BUCKETS, ModelRegistry, ServableVersion,
                       ServingError, UnknownModelError, load_source)
from .server import ClientError, InferenceServer

__all__ = ["BatcherClosedError", "DynamicBatcher", "DEFAULT_BUCKETS",
           "ModelRegistry", "ServableVersion", "ServingError",
           "UnknownModelError", "load_source", "ClientError",
           "InferenceServer"]
