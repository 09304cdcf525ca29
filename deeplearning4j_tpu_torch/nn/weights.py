"""Weight initialization schemes (formulas of
`deeplearning4j_tpu/nn/weights.py`, drawn from an explicit
`torch.Generator`).

The numbers differ from the JAX package's for the same seed: `jax.random`
and torch generators are different streams. Parity between the packages
goes through parameters (the serializer zip), never through the RNG.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

__all__ = ["WeightInit", "init_weight", "Distribution"]


class WeightInit:
    DISTRIBUTION = "distribution"
    ZERO = "zero"
    ONES = "ones"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    NORMAL = "normal"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    IDENTITY = "identity"

    ALL = [
        DISTRIBUTION, ZERO, ONES, SIGMOID_UNIFORM, UNIFORM, XAVIER,
        XAVIER_UNIFORM, XAVIER_FAN_IN, XAVIER_LEGACY, RELU, RELU_UNIFORM,
        NORMAL, LECUN_NORMAL, LECUN_UNIFORM, VAR_SCALING_NORMAL_FAN_AVG,
        IDENTITY,
    ]


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=dtype)


def _uniform(gen, shape, dtype, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype)


@dataclass
class Distribution:
    """Custom distribution for WeightInit.DISTRIBUTION."""

    kind: str = "normal"  # normal | uniform | binomial | constant
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    n_trials: int = 1
    prob: float = 0.5
    value: float = 0.0

    def sample(self, gen: torch.Generator, shape, dtype=torch.float32):
        k = self.kind.lower()
        if k in ("normal", "gaussian"):
            return self.mean + self.std * _normal(gen, shape, dtype)
        if k == "uniform":
            return _uniform(gen, shape, dtype, self.lower, self.upper)
        if k == "binomial":
            counts = torch.full(shape, float(self.n_trials), dtype=torch.float64)
            probs = torch.full(shape, float(self.prob), dtype=torch.float64)
            return torch.binomial(counts, probs, generator=gen).to(dtype)
        if k == "constant":
            return torch.full(shape, self.value, dtype=dtype)
        raise ValueError(f"Unknown distribution kind '{self.kind}'")

    def to_dict(self):
        return {"kind": self.kind, "mean": self.mean, "std": self.std,
                "lower": self.lower, "upper": self.upper,
                "n_trials": self.n_trials, "prob": self.prob, "value": self.value}

    @staticmethod
    def from_dict(d):
        return Distribution(**d)


def init_weight(gen: torch.Generator, shape: Sequence[int],
                scheme: str = WeightInit.XAVIER,
                fan_in: Optional[float] = None,
                fan_out: Optional[float] = None,
                distribution: Optional[Distribution] = None,
                dtype=torch.float32) -> torch.Tensor:
    """A CPU weight tensor drawn from `gen`. fan_in/fan_out default to
    shape[0]/shape[-1]."""
    shape = tuple(int(s) for s in shape)
    if fan_in is None:
        fan_in = float(shape[0])
    if fan_out is None:
        fan_out = float(shape[-1]) if len(shape) > 1 else float(shape[0])
    s = str(scheme).lower()

    if s == WeightInit.DISTRIBUTION:
        if distribution is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a Distribution")
        return distribution.sample(gen, shape, dtype)
    if s == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype)
    if s == WeightInit.ONES:
        return torch.ones(shape, dtype=dtype)
    if s == WeightInit.SIGMOID_UNIFORM:
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if s == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, dtype, -a, a)
    if s in (WeightInit.XAVIER, WeightInit.VAR_SCALING_NORMAL_FAN_AVG):
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))
    if s == WeightInit.XAVIER_UNIFORM:
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -r, r)
    if s in (WeightInit.XAVIER_FAN_IN, WeightInit.NORMAL):
        return _normal(gen, shape, dtype) / math.sqrt(fan_in)
    if s == WeightInit.XAVIER_LEGACY:
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / (fan_in + fan_out))
    if s == WeightInit.RELU:
        return _normal(gen, shape, dtype) * math.sqrt(2.0 / fan_in)
    if s == WeightInit.RELU_UNIFORM:
        r = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, dtype, -r, r)
    if s == WeightInit.LECUN_NORMAL:
        return _normal(gen, shape, dtype) * math.sqrt(1.0 / fan_in)
    if s == WeightInit.LECUN_UNIFORM:
        r = math.sqrt(3.0 / fan_in)
        return _uniform(gen, shape, dtype, -r, r)
    if s == WeightInit.IDENTITY:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires square 2-D shape")
        return torch.eye(shape[0], dtype=dtype)
    raise ValueError(f"Unknown weight init '{scheme}'. Available: {WeightInit.ALL}")
