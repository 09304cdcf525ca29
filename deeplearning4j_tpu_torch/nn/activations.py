"""Activation functions by name (the names this slice's layers use; the
rest of `deeplearning4j_tpu/nn/activations.py` arrives with the layers that
need them). Softmax is over the last (feature) axis.
"""
from __future__ import annotations

import torch

__all__ = ["get", "ACTIVATIONS"]


def _identity(x):
    return x


def _gelu(x):
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "identity": _identity,
    "linear": _identity,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": _gelu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get(name):
    """Resolve an activation by name (case-insensitive) or pass through a
    callable."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available in the PyTorch port: "
            f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
