"""Convolution, pooling and padding layers (the port of
`deeplearning4j_tpu/nn/layers/convolution.py`): ConvolutionLayer,
Convolution1DLayer, SubsamplingLayer, Subsampling1DLayer, ZeroPaddingLayer.

Layout. Activations are NHWC ([B, T, F] in 1-D) and conv weights HWIO
([k, I, O] in 1-D) at every boundary, as in the JAX package, so parameters
and activations cross the zip and `from_jax_params` unchanged. Inside, a
layer hands torch the NCHW view `x.permute(0, 3, 1, 2)`, which is a
channels_last tensor with no copy, and the weight view `W.permute(3, 2, 0,
1)` (OIHW); the result is permuted back, a contiguous NHWC tensor wherever
the library returned channels_last.

The JAX package computes these with `lax.conv_general_dilated` and
`lax.reduce_window`, XLA ops and not Pallas kernels; the port maps them to
`torch.nn.functional` (cuDNN on the card), as the reference DL4J did through
its cuDNN helpers.

Padding. ConvolutionMode.SAME pads as XLA does: `total // 2` before and the
rest after, over the dilated kernel extent; an uneven split goes through
`F.pad`, since torch's symmetric `padding=` cannot express it. STRICT raises
JAX's error at build time; TRUNCATE floors. Pooling pads max with -inf and
divides avg by the count of real elements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = [
    "ConvolutionMode", "PoolingType", "ConvolutionLayer", "Convolution1DLayer",
    "SubsamplingLayer", "Subsampling1DLayer", "ZeroPaddingLayer",
    "conv_output_size",
]


class ConvolutionMode:
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv_output_size(size: int, k: int, s: int, mode: str, dilation: int = 1) -> int:
    """Output spatial extent (reference `util/ConvolutionUtils.java`)."""
    eff_k = k + (k - 1) * (dilation - 1)
    if mode == ConvolutionMode.SAME:
        return int(math.ceil(size / s))
    if mode == ConvolutionMode.STRICT:
        if (size - eff_k) % s != 0:
            raise ValueError(
                f"ConvolutionMode.STRICT: (size={size} - kernel={eff_k}) not "
                f"divisible by stride={s}. Use TRUNCATE or SAME.")
        return (size - eff_k) // s + 1
    # TRUNCATE
    return (size - eff_k) // s + 1


def _same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (total // 2, the rest)."""
    eff_k = k + (k - 1) * (dilation - 1)
    out = -(-size // s)
    total = max((out - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _pads(mode, sizes, kernel, stride, padding, dilation):
    """(lo, hi) per spatial dim: SAME's split, or the explicit padding."""
    if mode == ConvolutionMode.SAME:
        return [_same_pads(n, k, s, d)
                for n, k, s, d in zip(sizes, kernel, stride, dilation)]
    return [(p, p) for p in padding]


def _to_nc(x):
    """The channels-first view of a channels-last tensor (no copy)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_nlast(y):
    return y.permute(0, *range(2, y.dim()), 1)


def _pad(xc, pads, value=0.0):
    """A channels-first tensor padded by (lo, hi) per spatial dim."""
    return F.pad(xc, [v for lo, hi in reversed(pads) for v in (lo, hi)],
                 value=value)


def _pad_nc(xc, pads):
    """(input, symmetric padding left for torch): the input padded with
    F.pad where a dim's split is uneven, else as it is."""
    if all(lo == hi for lo, hi in pads):
        return xc, [lo for lo, _ in pads]
    return _pad(xc, pads), [0] * len(pads)


def _conv_nc(xc, w, stride, pads, dilation):
    """Convolution of a channels-first view `xc` with OI... weights, padded
    as `pads` says."""
    xc, padding = _pad_nc(xc, pads)
    conv = F.conv2d if xc.dim() == 4 else F.conv1d
    return conv(xc, w, None, stride, padding, dilation)


def _weight_nc(W):
    """HWIO ([k, I, O] in 1-D) -> the OIHW ([O, I, k]) view."""
    return W.permute(W.dim() - 1, W.dim() - 2, *range(W.dim() - 2))


class _ConvStored(torch.autograd.Function):
    """The convolution whose saved-for-backward input is stored in
    `store_dtype` (e.g. float8_e4m3fn) instead of the compute dtype; the
    backward casts it back and runs the two transposed convolutions
    (`aten.convolution_backward`). JAX's `_conv_stored` custom VJP."""

    @staticmethod
    def forward(ctx, x, W, stride, pads, dilation, store_dtype):
        ctx.conf = (stride, pads, dilation)
        ctx.save_for_backward(x.to(store_dtype), W)
        return _to_nlast(_conv_nc(_to_nc(x), _weight_nc(W), stride, pads,
                                  dilation))

    @staticmethod
    def backward(ctx, g):
        x_s, W = ctx.saved_tensors
        stride, pads, dilation = ctx.conf
        xc = _to_nc(x_s.to(W.dtype))
        xp, padding = _pad_nc(xc, pads)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            _to_nc(g), xp, _weight_nc(W), None, list(stride), padding,
            list(dilation), False, [0] * len(stride), 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if dx is not None:
            if xp is not xc:    # cut the F.pad margin back off
                dx = dx[(slice(None), slice(None))
                        + tuple(slice(lo, lo + n) for (lo, _), n
                                in zip(pads, xc.shape[2:]))]
            dx = _to_nlast(dx)
        if dw is not None:
            dw = dw.permute(*range(2, dw.dim()), 1, 0)
        return dx, dw, None, None, None, None


def _conv(layer, params, x, train, kernel, stride, padding, dilation):
    """The shared forward of the 2-D and 1-D convolution layers: x
    channels-last, W HWIO / HIO, operands promoted to a common float type
    as `jnp.result_type` does; bias, then activation."""
    W = params["W"]
    ct = torch.promote_types(x.dtype, W.dtype)
    x, W = x.to(ct), W.to(ct)
    pads = _pads(layer.convolution_mode, x.shape[1:-1], kernel, stride,
                 padding, dilation)
    sdt = layer.activation_store_dtype
    if (train and sdt is not None
            and getattr(torch, sdt).itemsize < ct.itemsize):
        z = _ConvStored.apply(x, W, tuple(stride), pads, tuple(dilation),
                              getattr(torch, sdt))
    else:
        z = _to_nlast(_conv_nc(_to_nc(x), _weight_nc(W), stride, pads,
                               dilation))
    if layer.has_bias:
        z = z + params["b"]
    return layer._act(z)


@register_layer
@dataclass
class ConvolutionLayer(LayerConf):
    """2-D convolution, NHWC. W: [kh, kw, c_in, n_out]."""

    input_kind = "cnn"

    n_in: Optional[int] = None          # input channels (inferred)
    n_out: int = 0                      # filters
    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)     # explicit padding (used when mode != SAME)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def fill_from_input_type(self, it: InputType):
        if it.kind == "cnn" and not self.n_in:
            return {"n_in": it.channels}
        return {}

    def n_in_from(self, it: InputType) -> int:
        return it.channels if it.kind == "cnn" else it.flat_size()

    def _dims(self):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        return kh, kw, sh, sw, ph, pw, dh, dw

    def output_type(self, it: InputType) -> InputType:
        kh, kw, sh, sw, ph, pw, dh, dw = self._dims()
        if self.convolution_mode == ConvolutionMode.SAME:
            oh = conv_output_size(it.height, kh, sh, ConvolutionMode.SAME, dh)
            ow = conv_output_size(it.width, kw, sw, ConvolutionMode.SAME, dw)
        else:
            oh = conv_output_size(it.height + 2 * ph, kh, sh,
                                  self.convolution_mode, dh)
            ow = conv_output_size(it.width + 2 * pw, kw, sw,
                                  self.convolution_mode, dw)
        return InputType.convolutional(oh, ow, self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        kh, kw, *_ = self._dims()
        c_in = self.n_in or it.channels
        p = {"W": self._winit(gen, (kh, kw, c_in, self.n_out),
                              fan_in=kh * kw * c_in,
                              fan_out=kh * kw * self.n_out, device=device)}
        if self.has_bias:
            p["b"] = self._binit((self.n_out,), device)
        return p

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        kh, kw, sh, sw, ph, pw, dh, dw = self._dims()
        return _conv(self, params, x, train, (kh, kw), (sh, sw), (ph, pw),
                     (dh, dw)), state


@register_layer
@dataclass
class Convolution1DLayer(LayerConf):
    """1-D convolution over time: input [B, T, F], W [k, F, n_out]."""

    input_kind = "rnn"

    n_in: Optional[int] = None
    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = ConvolutionMode.SAME
    has_bias: bool = True

    def n_in_from(self, it: InputType) -> int:
        return it.size

    def output_type(self, it: InputType) -> InputType:
        t = it.timesteps
        if t is not None:
            if self.convolution_mode == ConvolutionMode.SAME:
                t = conv_output_size(t, self.kernel_size, self.stride,
                                     ConvolutionMode.SAME, self.dilation)
            else:
                t = conv_output_size(t + 2 * self.padding, self.kernel_size,
                                     self.stride, self.convolution_mode,
                                     self.dilation)
        return InputType.recurrent(self.n_out, t)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        c_in = self.n_in or it.size
        k = self.kernel_size
        p = {"W": self._winit(gen, (k, c_in, self.n_out), fan_in=k * c_in,
                              fan_out=k * self.n_out, device=device)}
        if self.has_bias:
            p["b"] = self._binit((self.n_out,), device)
        return p

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        # train=False: JAX's 1-D layer has no stored-input path
        return _conv(self, params, x, False, (self.kernel_size,),
                     (self.stride,), (self.padding,), (self.dilation,)), state


def _pool(x, pooling_type, kernel, stride, pads, pnorm, eps):
    """Window reduction over the spatial dims of a channels-last tensor
    ([B, H, W, C], or [B, T, F] as a one-row image), `pads` (lo, hi) per
    dim. JAX's `_pool`: max pads with -inf, avg divides by the count of real
    elements, sum and pnorm sum zeros in the padding. The padding goes
    through F.pad: torch's own `padding=` is symmetric, at most half a
    kernel, and its avg count differs past that."""
    one_d = x.dim() == 3
    xc = _to_nc(x)
    if one_d:   # torch's 1-D avg pool has no divisor_override
        xc, kernel, stride = xc[:, :, None], (1,) + kernel, (1,) + stride
        pads = [(0, 0)] + list(pads)
    padded = any(lo or hi for lo, hi in pads)

    def window_sum(t):
        if padded:
            t = _pad(t, pads)
        return F.avg_pool2d(t, kernel, stride, divisor_override=1)

    if pooling_type == PoolingType.MAX:
        if padded:
            xc = _pad(xc, pads, value=-math.inf)
        y = F.max_pool2d(xc, kernel, stride)
    elif pooling_type == PoolingType.SUM:
        y = window_sum(xc)
    elif pooling_type == PoolingType.AVG:
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                          device=xc.device)
        y = window_sum(xc) / window_sum(ones)
    elif pooling_type == PoolingType.PNORM:
        p = float(pnorm)
        y = (window_sum(xc.abs() ** p) + eps) ** (1.0 / p)
    else:
        raise ValueError(f"Unknown pooling type '{pooling_type}'")
    if one_d:
        y = y[:, :, 0]
    return _to_nlast(y)


@register_layer
@dataclass
class SubsamplingLayer(LayerConf):
    """2-D pooling (max/avg/sum/pnorm), NHWC."""

    input_kind = "cnn"

    pooling_type: str = PoolingType.MAX
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = ConvolutionMode.TRUNCATE
    pnorm: int = 2
    eps: float = 1e-8

    def output_type(self, it: InputType) -> InputType:
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode == ConvolutionMode.SAME:
            oh = conv_output_size(it.height, kh, sh, ConvolutionMode.SAME)
            ow = conv_output_size(it.width, kw, sw, ConvolutionMode.SAME)
        else:
            oh = conv_output_size(it.height + 2 * ph, kh, sh, self.convolution_mode)
            ow = conv_output_size(it.width + 2 * pw, kw, sw, self.convolution_mode)
        return InputType.convolutional(oh, ow, it.channels)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        kernel, stride = _pair(self.kernel_size), _pair(self.stride)
        pads = _pads(self.convolution_mode, x.shape[1:3], kernel, stride,
                     _pair(self.padding), (1, 1))
        return _pool(x, self.pooling_type, kernel, stride, pads, self.pnorm,
                     self.eps), state


@register_layer
@dataclass
class Subsampling1DLayer(LayerConf):
    """1-D pooling over time: [B, T, F]."""

    input_kind = "rnn"

    pooling_type: str = PoolingType.MAX
    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    convolution_mode: str = ConvolutionMode.TRUNCATE
    pnorm: int = 2
    eps: float = 1e-8

    def output_type(self, it: InputType) -> InputType:
        t = it.timesteps
        if t is not None:
            if self.convolution_mode == ConvolutionMode.SAME:
                t = conv_output_size(t, self.kernel_size, self.stride,
                                     ConvolutionMode.SAME)
            else:
                t = conv_output_size(t + 2 * self.padding, self.kernel_size,
                                     self.stride, self.convolution_mode)
        return InputType.recurrent(it.size, t)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        kernel, stride = (self.kernel_size,), (self.stride,)
        pads = _pads(self.convolution_mode, x.shape[1:2], kernel, stride,
                     (self.padding,), (1,))
        return _pool(x, self.pooling_type, kernel, stride, pads, self.pnorm,
                     self.eps), state


@register_layer
@dataclass
class ZeroPaddingLayer(LayerConf):
    """Zero-pads H and W. pad = (top, bottom, left, right) or (h, w)."""

    input_kind = "cnn"

    pad: Sequence[int] = (1, 1)

    def _pads(self):
        p = tuple(int(v) for v in self.pad)
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        if len(p) == 4:
            return p
        raise ValueError("pad must be (h,w) or (top,bottom,left,right)")

    def output_type(self, it: InputType) -> InputType:
        t, b, l, r = self._pads()
        return InputType.convolutional(it.height + t + b, it.width + l + r,
                                       it.channels)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b)), state
