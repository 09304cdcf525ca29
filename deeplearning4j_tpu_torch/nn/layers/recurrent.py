"""Recurrent layers: GravesLSTM and RnnOutputLayer (forward of
`deeplearning4j_tpu/nn/layers/recurrent.py`; backward through autograd).

Data layout is [batch, time, features]. Parameters are keyed as in JAX:
GravesLSTM's `W` is [n_in + n_out, 4 n_out] (input and recurrent weights
stacked, gate columns i|f|o|g), `b` is [4 n_out], `peep` is [3 n_out]
(i|f|o), and the forget-gate bias offset stays out of `b`.

Kernel selection follows the JAX layer's `_helper`: a mask-free input with
sigmoid gates and tanh cell goes through the sequence kernels, which
compute in float32 (as the TPU kernel does): any float dtype on a GPU
tensor, float32 only on a CPU tensor, where another dtype takes the step
loop in its own precision (as JAX takes its scan there). A masked input
takes the plain step loop on any device. When autograd records (training),
the layer calls `kernels.lstm.lstm_sequence`, the autograd Function whose
forward saves residuals and whose backward runs the adjoint and reduction
kernels; otherwise (serving, `rnn_time_step`, scoring) it calls the primal
`fused_lstm_sequence`. On a CPU tensor both run their plain versions. The
JAX layer also takes its scan on the TPU where `lstm_fits_vmem` says its
kernel does not fit; the port has no such rule: the forward kernel streams
x_t through shared memory in chunks, so a layer of any input width (a
word-level one-hot vocabulary) runs the kernels on a GPU tensor.

Carry protocol (stateful `rnn_time_step`): `init_carry(batch, dtype,
device)` and `apply(..., carry=..., return_carry=True)`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import activations
from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType
from .feedforward import BaseOutputLayerConf, _affine, _affine_params

__all__ = ["GravesLSTM", "RnnOutputLayer", "BaseRecurrentLayer"]


@dataclass
class BaseRecurrentLayer(LayerConf):
    input_kind = "rnn"

    n_in: Optional[int] = None
    n_out: int = 0

    @property
    def is_recurrent(self) -> bool:
        return True

    def n_in_from(self, it: InputType) -> int:
        return it.size

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)


def _lstm_cell(W, b, peep, n_out, carry, x_t, m_t, forget_gate_offset,
               gate_act, cell_act):
    """One Graves-LSTM step; with a mask, masked rows keep their carry and
    output zeros."""
    h_prev, c_prev = carry
    gates = torch.cat([x_t, h_prev], dim=-1) @ W + b
    i_g, f_g, o_g, g_g = torch.split(gates, n_out, dim=-1)
    p_i, p_f, p_o = torch.split(peep, n_out)
    i = gate_act(i_g + c_prev * p_i)
    f = gate_act(f_g + c_prev * p_f + forget_gate_offset)
    g = cell_act(g_g)
    c = f * c_prev + i * g
    o = gate_act(o_g + c * p_o)
    h = o * cell_act(c)
    if m_t is not None:
        m = m_t[:, None]
        h = m * h
        c = m * c + (1.0 - m) * c_prev
        h_carry = m * h + (1.0 - m) * h_prev
    else:
        h_carry = h
    return (h_carry, c), h


@register_layer
@dataclass
class GravesLSTM(BaseRecurrentLayer):
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        n_in = self.n_in or it.size
        n_out = self.n_out
        w_in = self._winit(gen, (n_in, 4 * n_out), fan_in=n_in,
                           fan_out=n_out, device=device)
        w_rec = self._winit(gen, (n_out, 4 * n_out), fan_in=n_out,
                            fan_out=n_out, device=device)
        W = torch.cat([w_in, w_rec], dim=0)
        b = torch.zeros(4 * n_out, dtype=W.dtype, device=device)
        peep = 0.1 * torch.randn(3 * n_out, generator=gen,
                                 dtype=W.dtype).to(device)
        return {"W": W, "b": b, "peep": peep}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _helper(self, x, mask) -> bool:
        """Whether the sequence kernels compute this forward."""
        if mask is not None:
            return False
        if self.gate_activation != "sigmoid" or \
                (self.activation or "tanh") != "tanh":
            return False
        if not x.is_floating_point():
            return False
        return x.device.type != "cpu" or x.dtype == torch.float32

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None, carry=None, return_carry=False):
        x = self.maybe_dropout_input(x, train, generator)
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        else:
            carry = tuple(c.to(x.dtype) for c in carry)
        offs = float(self.forget_gate_bias_init)
        xs = x.transpose(0, 1).contiguous()   # [T, B, F]
        if self._helper(x, mask):
            from ...kernels import lstm
            args = (xs, params["W"].contiguous(), params["b"],
                    params["peep"], carry[0].contiguous(),
                    carry[1].contiguous())
            records = torch.is_grad_enabled() and any(
                a.requires_grad for a in args)
            fn = lstm.lstm_sequence if records else lstm.fused_lstm_sequence
            hs, hT, cT = fn(*args, offs)
            final = (hT, cT)
        else:
            gate_act = activations.get(self.gate_activation)
            cell_act = activations.get(self.activation or "tanh")
            ms = None if mask is None else mask.to(x.dtype).transpose(0, 1)
            outs = []
            final = carry
            for t in range(xs.shape[0]):
                final, h = _lstm_cell(params["W"], params["b"],
                                      params["peep"], self.n_out, final,
                                      xs[t], None if ms is None else ms[t],
                                      offs, gate_act, cell_act)
                outs.append(h)
            hs = torch.stack(outs)
        y = hs.transpose(0, 1)                # [B, T, H]
        if return_carry:
            return (y, final), state
        return y, state


@register_layer
@dataclass
class RnnOutputLayer(BaseOutputLayerConf):
    """Time-distributed output head: logits [B, T, C]."""

    input_kind = "rnn"

    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True

    def __post_init__(self):
        if self.activation is None:
            self.activation = "softmax"

    def n_in_from(self, it: InputType) -> int:
        return it.size

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        return _affine_params(self, gen, self.n_in or it.size, device)

    def preout(self, params, state, x, *, train=False, generator=None,
               mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return _affine(params, x, self.has_bias)
