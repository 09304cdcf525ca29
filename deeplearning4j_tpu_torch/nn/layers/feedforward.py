"""Feed-forward layers: DenseLayer, OutputLayer (inference forward of
`deeplearning4j_tpu/nn/layers/feedforward.py`). W is [n_in, n_out] as in
the JAX package, so parameters cross unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = ["DenseLayer", "OutputLayer", "BaseOutputLayerConf"]


def _affine(params, x, has_bias: bool):
    z = x @ params["W"]
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

    def apply(self, params, state, x, *, mask=None):
        return self._act(_affine(params, x, self.has_bias)), state


@dataclass
class BaseOutputLayerConf(LayerConf):
    """Loss-bearing layers: `preout` gives the logits, `apply` the
    activations. The loss itself is configuration data until the training
    slice."""

    loss: str = "mcxent"
    loss_weights: Optional[list] = None

    def preout(self, params, state, x, *, mask=None):
        return x

    def apply(self, params, state, x, *, mask=None):
        return self._act(self.preout(params, state, x, mask=mask)), state


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

    def preout(self, params, state, x, *, mask=None):
        return _affine(params, x, self.has_bias)
