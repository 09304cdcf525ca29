"""Activation functions by name: the 21 of
`deeplearning4j_tpu/nn/activations.py`, with its constants. Softmax and
logsoftmax are over the last (feature) axis.

Every piecewise function makes the comparison JAX makes (`x > theta`,
`x >= 0`, `max`/`min` rather than `clamp`), so its derivative at the kink is
`jax.grad`'s: torch's `maximum` / `minimum` split a tie's gradient in two as
`lax.max` / `lax.min` do, where `clamp` would pass all of it.
"""
from __future__ import annotations

import torch

__all__ = ["get", "ACTIVATIONS"]


def _identity(x):
    return x


def _max(x, v):
    return torch.maximum(x, x.new_full((), v))


def _min(x, v):
    return torch.minimum(x, x.new_full((), v))


def _leakyrelu(x, alpha=0.01):
    # jax.nn.leaky_relu: where(x >= 0, ...), slope 1 at 0
    return torch.where(x >= 0, x, alpha * x)


def _elu(x, alpha=1.0):
    # jax.nn.elu: expm1 of the negative branch only
    return torch.where(x > 0, x,
                       alpha * torch.expm1(torch.where(x > 0, 0.0, x)))


def _selu(x):
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    return scale * _elu(x, alpha)


def _gelu(x):
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    return torch.nn.functional.gelu(x, approximate="tanh")


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) (no threshold, unlike F.softplus)
    return torch.logaddexp(x, torch.zeros_like(x))


def _softsign(x):
    return x / (x.abs() + 1)


def _hardtanh(x):
    return _min(_max(x, -1.0), 1.0)


def _hardsigmoid(x):
    return _min(_max(0.2 * x + 0.5, 0.0), 1.0)


def _cube(x):
    return x ** 3


def _rationaltanh(x):
    # ND4J ActivationRationalTanh: 1.7159 * tanh_approx(2x/3)
    a = (2.0 * x / 3.0).abs()
    approx = torch.sign(x) * (1.0 - 1.0 / (1.0 + a + a ** 2 + 1.41645 * a ** 4))
    return 1.7159 * approx


def _rectifiedtanh(x):
    return _max(torch.tanh(x), 0.0)


def _mish(x):
    return x * torch.tanh(_softplus(x))


def _threshold_relu(x, theta=1.0):
    return torch.where(x > theta, x, 0.0)


ACTIVATIONS = {
    "identity": _identity,
    "linear": _identity,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": _leakyrelu,
    "elu": _elu,
    "selu": _selu,
    "gelu": _gelu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": _softplus,
    "softsign": _softsign,
    "hardtanh": _hardtanh,
    "hardsigmoid": _hardsigmoid,
    "cube": _cube,
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": _rectifiedtanh,
    "swish": torch.nn.functional.silu,
    "mish": _mish,
    "thresholdedrelu": _threshold_relu,
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
