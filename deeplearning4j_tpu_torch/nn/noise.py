"""The one place where the port's pretraining and routing layers draw
their noise: the AutoEncoder's corruption mask, the RBM's Gibbs samples,
the VAE's reparameterization and the MoE router's noise.

`draw("uniform" | "normal", shape, generator, dtype, device)` draws from
an explicit `torch.Generator`; a Bernoulli(p) sample is `draw("uniform",
...) < p`, as `jax.random.bernoulli` is `uniform(key) < p`. A generator's
stream is not `jax.random`'s (and a CUDA generator's is not a CPU
one's), so a comparison with the JAX package either replaces this
function with one that returns JAX's draws, or compares statistics.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["draw"]


def draw(kind: str, shape: Sequence[int], generator: Optional[torch.Generator],
         dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform [0, 1) or standard normal draws of `shape`, on `device`."""
    gdev = generator.device if generator is not None else device
    if kind == "uniform":
        out = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                         device=gdev)
    elif kind == "normal":
        out = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                          device=gdev)
    else:
        raise ValueError(f"unknown draw kind {kind!r}")
    return out.to(device)
