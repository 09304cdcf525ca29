"""Input preprocessors: shape adapters between layer families (the port of
`deeplearning4j_tpu/nn/conf/preprocessors.py`, with the same dataclass
fields and `__dataclass__` JSON names).

Each is a reshape of a tensor; its backward comes from autograd. The layouts
are the JAX package's: convolutional activations are NHWC [B, H, W, C] and
recurrent ones [B, T, F], so `CnnToFeedForwardPreProcessor` flattens in
(H, W, C) order, which is the row order of the first Dense layer's W in a
JAX zip.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .base import register_aux_dataclass
from .input_type import InputType

__all__ = [
    "InputPreProcessor", "CnnToFeedForwardPreProcessor",
    "FeedForwardToCnnPreProcessor", "RnnToFeedForwardPreProcessor",
    "FeedForwardToRnnPreProcessor", "CnnToRnnPreProcessor",
    "RnnToCnnPreProcessor", "ComposableInputPreProcessor", "infer_preprocessor",
]


class InputPreProcessor:
    def apply(self, x):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def apply_mask(self, mask):
        return mask


@register_aux_dataclass
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def apply(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, it: InputType) -> InputType:
        h = self.height or it.height
        w = self.width or it.width
        c = self.channels or it.channels
        return InputType.feed_forward(h * w * c)


@register_aux_dataclass
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_aux_dataclass
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] -> [B*T, F] (time-distributed dense)."""

    def apply(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.size)

    def apply_mask(self, mask):
        return None if mask is None else mask.reshape(-1)


@register_aux_dataclass
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] -> [B, T, F]; timesteps must be known statically."""

    timesteps: int = 1

    def apply(self, x):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.flat_size(), self.timesteps)


@register_aux_dataclass
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, H, W*C]: H is time, the rest flattened."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def apply(self, x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.width * it.channels, it.height)


@register_aux_dataclass
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def apply(self, x):
        return x.reshape(x.shape[0] * x.shape[1], self.height, self.width,
                         self.channels)

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_aux_dataclass
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    processors: Sequence[InputPreProcessor] = ()

    def apply(self, x):
        for p in self.processors:
            x = p.apply(x)
        return x

    def output_type(self, it: InputType) -> InputType:
        for p in self.processors:
            it = p.output_type(it)
        return it

    def apply_mask(self, mask):
        for p in self.processors:
            mask = p.apply_mask(mask)
        return mask


def infer_preprocessor(input_type: InputType, layer) -> Optional[InputPreProcessor]:
    """The standard adapter when the incoming InputType's family differs from
    the layer's (`input_kind`), None when none is needed; raises where the
    JAX package cannot infer one, with its words."""
    want = getattr(layer, "input_kind", "ff")
    kind = input_type.kind
    if want == "any" or kind == want:
        return None
    if want == "ff":
        if kind == "cnn":
            return CnnToFeedForwardPreProcessor(input_type.height,
                                                input_type.width,
                                                input_type.channels)
        if kind == "cnn_flat":
            return None  # already flat
        if kind in ("rnn", "cnn1d"):
            return RnnToFeedForwardPreProcessor()
    if want == "cnn":
        if kind == "cnn_flat":
            return FeedForwardToCnnPreProcessor(input_type.height,
                                                input_type.width,
                                                input_type.channels)
        if kind == "ff":
            raise ValueError(
                "Cannot infer FF->CNN preprocessor without spatial dims; use "
                "InputType.convolutional_flat or set an explicit preprocessor")
        if kind == "rnn":
            raise ValueError("Set an explicit RnnToCnnPreProcessor (needs dims)")
    if want == "rnn":
        if kind == "ff" or kind == "cnn_flat":
            raise ValueError(
                "FF->RNN needs static timesteps; set FeedForwardToRnnPreProcessor")
        if kind == "cnn":
            return CnnToRnnPreProcessor(input_type.height, input_type.width,
                                        input_type.channels)
        if kind == "cnn1d":
            return None
    return None
