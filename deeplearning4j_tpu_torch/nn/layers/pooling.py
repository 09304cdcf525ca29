"""GlobalPoolingLayer (the port of `deeplearning4j_tpu/nn/layers/
pooling.py`): pools over time ([B, T, F] -> [B, F]) or space (NHWC
[B, H, W, C] -> [B, C]), with a time mask for variable-length sequences.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType
from .convolution import PoolingType

__all__ = ["GlobalPoolingLayer"]


@register_layer
@dataclass
class GlobalPoolingLayer(LayerConf):
    input_kind = "any"

    pooling_type: str = PoolingType.MAX
    pnorm: int = 2
    collapse_dimensions: bool = True
    eps: float = 1e-8

    def output_type(self, it: InputType) -> InputType:
        if it.kind in ("rnn", "cnn1d"):
            return InputType.feed_forward(it.size)
        if it.kind == "cnn":
            return InputType.feed_forward(it.channels)
        return it

    def output_mask(self, mask):
        return None  # pooled axes collapsed: a per-step mask no longer applies

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        if x.dim() == 3:        # [B, T, F] over time
            dims = (1,)
        elif x.dim() == 4:      # [B, H, W, C] over space
            dims = (1, 2)
        else:
            raise ValueError(
                f"GlobalPooling expects 3-D/4-D input, got {x.dim()}-D")
        pt = self.pooling_type
        p = float(self.pnorm)
        if mask is not None and x.dim() == 3:
            m = mask.to(x.dtype)[:, :, None]    # [B, T, 1]
            if pt == PoolingType.MAX:
                return torch.where(m > 0, x, -torch.inf).amax(dim=1), state
            if pt == PoolingType.SUM:
                return (x * m).sum(dim=1), state
            if pt == PoolingType.AVG:
                return ((x * m).sum(dim=1)
                        / torch.clamp(m.sum(dim=1), min=1.0)), state
            if pt == PoolingType.PNORM:
                return ((x.abs() ** p * m).sum(dim=1)
                        + self.eps) ** (1 / p), state
            raise ValueError(f"Unknown pooling type '{pt}'")
        if pt == PoolingType.MAX:
            return x.amax(dim=dims), state
        if pt == PoolingType.SUM:
            return x.sum(dim=dims), state
        if pt == PoolingType.AVG:
            return x.mean(dim=dims), state
        if pt == PoolingType.PNORM:
            return (x.abs().pow(p).sum(dim=dims) + self.eps) ** (1 / p), state
        raise ValueError(f"Unknown pooling type '{pt}'")
