"""Mixture-of-experts layer: the port of
`deeplearning4j_tpu/nn/layers/moe.py`.

x [B, n_in] -> router logits [B, E] -> softmax over the top-k logits as
gates (zero elsewhere) -> y = sum_e gate_e FFN_e(x), with FFN_e(x) =
act(x W1_e + b1_e) W2_e + b2_e. Every expert computes every row (dense
batched products, no token dispatch), so autograd differentiates the gates
exactly. The top k are the first k of a stable descending sort: on tied
logits (an all-zero row) the lowest expert indices win, as
`jax.lax.top_k` picks them, on the CPU and on the card alike.

Training options: `router_noise` adds normal noise (from `nn.noise.draw`)
to the logits; `load_balance_coef` > 0 stores the Switch-style load-balance
score E sum_e f_e p_e in the layer state, and `aux_score` adds it, times
the coefficient, to the training score.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from .. import noise as _noise
from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = ["MixtureOfExpertsLayer"]


def top_k_gates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[B, E] gates: the softmax of each row's k largest logits at their
    experts, 0 elsewhere; ties go to the lower expert index."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    top_idx = order[:, :k]
    top_gates = torch.softmax(torch.gather(logits, 1, top_idx), dim=-1)
    return torch.zeros_like(logits).scatter(1, top_idx, top_gates)


@register_layer
@dataclass
class MixtureOfExpertsLayer(LayerConf):
    """Top-k routed mixture of two-layer FFN experts."""

    input_kind = "ff"

    n_out: int = 0
    n_experts: int = 4
    top_k: int = 2
    expert_hidden: int = 0          # default: 4 * n_out
    load_balance_coef: float = 0.0  # aux loss weight (0 = off)
    router_noise: float = 0.0       # train-time routing noise stddev

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def _hidden(self) -> int:
        return self.expert_hidden or 4 * self.n_out

    def init_params(self, gen, it: InputType, device) -> Dict:
        n_in, h, e = it.flat_size(), self._hidden(), self.n_experts
        w = lambda shape, fi, fo: self._winit(gen, shape, fan_in=fi,
                                              fan_out=fo, device=device)
        return {"router_W": w((n_in, e), n_in, e),
                "expert_W1": w((e, n_in, h), n_in, h),
                "expert_b1": self._binit((e, h), device),
                "expert_W2": w((e, h, self.n_out), h, self.n_out),
                "expert_b2": self._binit((e, self.n_out), device)}

    def init_state(self, it: InputType, device) -> Dict:
        return ({"aux_loss": torch.zeros((), dtype=torch.float32,
                                         device=device)}
                if self.load_balance_coef > 0 else {})

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        logits = x @ params["router_W"]                      # [B, E]
        if train and self.router_noise > 0 and generator is not None:
            logits = logits + self.router_noise * _noise.draw(
                "normal", logits.shape, generator, logits.dtype,
                logits.device)
        gates = top_k_gates(logits, min(self.top_k, self.n_experts))
        hid = self._act(torch.einsum("bi,eih->beh", x, params["expert_W1"])
                        + params["expert_b1"])
        outs = (torch.einsum("beh,eho->beo", hid, params["expert_W2"])
                + params["expert_b2"])
        y = torch.einsum("beo,be->bo", outs, gates.to(outs.dtype))
        if train and self.load_balance_coef > 0:
            probs = torch.softmax(logits, dim=-1)
            frac = (gates > 0).to(torch.float32).mean(dim=0)
            state = dict(state)
            state["aux_loss"] = self.n_experts * torch.sum(
                frac * probs.mean(dim=0).to(torch.float32))
        return y, state

    def aux_score(self, state) -> torch.Tensor:
        if self.load_balance_coef > 0 and "aux_loss" in state:
            return self.load_balance_coef * state["aux_loss"]
        return torch.zeros((), dtype=torch.float32)
