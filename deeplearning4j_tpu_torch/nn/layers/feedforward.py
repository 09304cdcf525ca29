"""Feed-forward layers: DenseLayer, OutputLayer, LossLayer, ActivationLayer,
DropoutLayer and EmbeddingLayer (forward and loss of
`deeplearning4j_tpu/nn/layers/feedforward.py`; backward through autograd).
W is [n_in, n_out] as in the JAX package, so parameters cross unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import losses as _losses
from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = ["DenseLayer", "OutputLayer", "BaseOutputLayerConf", "LossLayer",
           "ActivationLayer", "DropoutLayer", "EmbeddingLayer", "take_rows"]

# float ids saturate to int32 on the way to an index, as XLA's convert does
_INT32_MIN, _INT32_MAX = -2.0 ** 31, 2.0 ** 31 - 1


def take_rows(W, idx):
    """`jnp.take(W, idx.astype(int32), axis=0)`: a float id is truncated
    toward zero (NaN gives 0, out-of-range values saturate), an id in
    [-rows, -1] wraps to rows + id, and any other out-of-range id gives a NaN
    row. The gather never sees an out-of-range index: on the GPU that is a
    device-side assert, which leaves the process's CUDA context unusable."""
    if idx.is_floating_point():
        idx = torch.nan_to_num(idx, nan=0.0).clamp(_INT32_MIN, _INT32_MAX)
    idx = idx.to(torch.int64)
    rows = W.shape[0]
    idx = torch.where(idx < 0, idx + rows, idx)
    ok = (idx >= 0) & (idx < rows)
    z = W[idx.clamp(0, rows - 1)]
    return torch.where(ok[..., None], z, torch.full((), float("nan"),
                                                    dtype=z.dtype,
                                                    device=z.device))


def _affine(params, x, has_bias: bool):
    """x @ W (+ b), the operands promoted to a common float type first as
    jnp's `@` promotes them (a bf16 activation into an output layer's f32
    W); torch's matmul does not promote."""
    W = params["W"]
    if x.dtype != W.dtype:
        dt = torch.promote_types(x.dtype, W.dtype)
        x, W = x.to(dt), W.to(dt)
    z = x @ W
    if has_bias:
        z = z + params["b"]
    return z


def _affine_params(layer, gen, n_in: int, device):
    """{"W": [n_in, n_out], "b": [n_out]} for Dense, Output and RnnOutput."""
    p = {"W": layer._winit(gen, (n_in, layer.n_out), fan_in=n_in,
                           fan_out=layer.n_out, device=device)}
    if layer.has_bias:
        p["b"] = layer._binit((layer.n_out,), device)
    return p


@register_layer
@dataclass
class DenseLayer(LayerConf):
    """Fully connected layer: y = act(x @ W + b)."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, input_type: InputType, device):
        return _affine_params(self, gen, self.n_in or input_type.flat_size(),
                              device)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return self._act(_affine(params, x, self.has_bias)), state


@dataclass
class BaseOutputLayerConf(LayerConf):
    """Loss-bearing layers: `preout` gives the logits, `apply` the
    activations, `loss_score` the (fused, stable) mean loss from the
    logits."""

    loss: str = "mcxent"
    loss_weights: Optional[list] = None

    def loss_fn(self):
        return _losses.get(self.loss)

    def preout(self, params, state, x, *, train=False, generator=None,
               mask=None):
        return x

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        z = self.preout(params, state, x, train=train, generator=generator,
                        mask=mask)
        return self._act(z), state

    def loss_score(self, params, state, x, labels, *, train=False,
                   generator=None, mask=None):
        """Mean per-example loss computed from the logits."""
        z = self.preout(params, state, x, train=train, generator=generator,
                        mask=mask)
        return self.loss_fn().score(labels, z, activation=self.activation,
                                    mask=mask, weights=self.loss_weights)

    def loss_per_example(self, params, state, x, labels, *, mask=None):
        """Unreduced per-example loss [batch]: masked, and summed over time
        for a time series (JAX `loss_per_example`)."""
        z = self.preout(params, state, x, mask=mask)
        per = self.loss_fn().per_example(labels, z,
                                         activation=self.activation,
                                         weights=self.loss_weights)
        if mask is not None:
            m = mask.to(per.dtype)
            per = per * m.reshape(m.shape + (1,) * (per.dim() - m.dim()))
        while per.dim() > 1:    # [B, T] (RNN) -> sum over time
            per = per.sum(dim=-1)
        return per


@register_layer
@dataclass
class OutputLayer(BaseOutputLayerConf):
    """Dense + loss head."""

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def __post_init__(self):
        if self.activation is None:
            self.activation = "softmax"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, input_type: InputType, device):
        return _affine_params(self, gen, self.n_in or input_type.flat_size(),
                              device)

    def preout(self, params, state, x, *, train=False, generator=None,
               mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return _affine(params, x, self.has_bias)


@register_layer
@dataclass
class LossLayer(BaseOutputLayerConf):
    """Parameter-free loss head: the loss of its input, activated."""

    def __post_init__(self):
        if self.activation is None:
            self.activation = "identity"


@register_layer
@dataclass
class ActivationLayer(LayerConf):
    """Applies its activation only."""

    input_kind = "any"

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        return self._act(x), state


@register_layer
@dataclass
class DropoutLayer(LayerConf):
    """Standalone inverted dropout while training (`dropout` is the retain
    probability, 0.5 when unset); the identity at inference."""

    input_kind = "any"

    def __post_init__(self):
        if self.dropout is None:
            self.dropout = 0.5

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        return self.maybe_dropout_input(x, train, generator), state


@register_layer
@dataclass
class EmbeddingLayer(LayerConf):
    """Index -> vector lookup: class indices [B] or [B, 1] (as floats, the
    way the network feeds them) -> [B, n_out], a gather of W's rows with
    `jnp.take`'s index rules (`take_rows`)."""

    n_in: int = 0   # vocab size
    n_out: int = 0
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, input_type: InputType, device):
        return _affine_params(self, gen, self.n_in, device)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        idx = x[:, 0] if x.dim() == 2 and x.shape[-1] == 1 else x
        z = take_rows(params["W"], idx)
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state
