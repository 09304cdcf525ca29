"""GPT-style transformer block and sequence embedding (the forward of
`deeplearning4j_tpu/nn/layers/transformer.py`, inference and training).

Parameters are keyed and shaped as in JAX, so they cross through the zip
unchanged: the block's `W_q`/`W_k`/`W_v`/`W_o` [d, d] with biases,
`W_ffn_in` [d, ffn_mult d], `W_ffn_out` [ffn_mult d, d] with biases, and
`ln1_g`/`ln1_b`/`ln2_g`/`ln2_b`; the embedding's token table `W`
[vocab, width] and positional table `P` [tmax, width].

Attention follows the JAX block's `_attend`: a features mask takes the
inline masked einsum on any device (the kernels take no mask); otherwise
`kernels.attention.flash_attention_heads` computes it, on a GPU tensor with
CUDA launches for all heads and on a CPU tensor with the plain versions.
When autograd records (training), that is the flash custom VJP: the
forward that saves the logsumexp, then the dq and dk/dv kernels in
backward; under `no_grad` / `inference_mode` (serving) the primal forward,
one launch per block. The JAX block's `flash` switch has no counterpart:
the tensor's device picks the implementation. Input dropout draws from the
network's `torch.Generator`, so only dropout-free runs are compared with
JAX. The decode-mode methods (`decode_qkv`, ...) wait for the decode slice
and the tensor-parallel hooks for the parallel stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType

__all__ = ["TransformerBlock", "EmbeddingSequenceLayer"]


def _layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


@register_layer
@dataclass
class TransformerBlock(LayerConf):
    """Pre-LN transformer block: x + MHA(LN(x)), then x + FFN(LN(x)).
    Input and output [B, T, n_model]; causal by default."""

    input_kind = "rnn"

    n_model: int = 0            # embedding width (0 = take from input type)
    n_heads: int = 4
    ffn_mult: int = 4           # FFN hidden = ffn_mult * n_model
    causal: bool = True

    def __post_init__(self):
        # FFN nonlinearity defaults to gelu (GPT convention), not identity
        if self.activation is None:
            self.activation = "gelu"

    def _width(self, it: Optional[InputType] = None) -> int:
        if self.n_model:
            return self.n_model
        if it is None:
            raise ValueError("TransformerBlock needs n_model or an input type")
        return it.size

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self._width(it), it.timesteps)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        d = self._width(it)
        if d % self.n_heads:
            raise ValueError(
                f"n_model={d} not divisible by n_heads={self.n_heads}")
        h = self.ffn_mult * d
        w = lambda shape: self._winit(gen, shape, fan_in=shape[0],
                                      fan_out=shape[1], device=device)
        one = lambda: torch.ones(d, dtype=torch.float32, device=device)
        zero = lambda: torch.zeros(d, dtype=torch.float32, device=device)
        return {
            "W_q": w((d, d)), "W_k": w((d, d)), "W_v": w((d, d)),
            "b_q": self._binit((d,), device), "b_k": self._binit((d,), device),
            "b_v": self._binit((d,), device),
            "W_o": w((d, d)), "b_o": self._binit((d,), device),
            "W_ffn_in": w((d, h)), "b_ffn_in": self._binit((h,), device),
            "W_ffn_out": w((h, d)), "b_ffn_out": self._binit((d,), device),
            "ln1_g": one(), "ln1_b": zero(), "ln2_g": one(), "ln2_b": zero(),
        }

    def _attend(self, q, k, v, mask):
        """q/k/v [B, T, H, Dh] -> [B, T, H, Dh]."""
        if mask is not None:
            # padded timesteps: keys at masked positions get no attention
            # weight (masked query rows give values the masked loss ignores)
            scale = 1.0 / (q.shape[-1] ** 0.5)
            logits = torch.einsum("bthd,bshd->bhts", q.float(),
                                  k.float()) * scale
            neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
            if self.causal:
                t = torch.arange(q.shape[1], device=q.device)
                logits = torch.where(t[:, None] >= t[None, :], logits, neg)
            logits = torch.where(mask.bool()[:, None, None, :], logits, neg)
            w = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhts,bshd->bthd", w, v.float())
            return out.to(q.dtype)
        from ...kernels.attention import flash_attention_heads
        return flash_attention_heads(q, k, v, self.causal)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        b, t, d = x.shape
        hd = d // self.n_heads

        h1 = _layer_norm(x, params["ln1_g"], params["ln1_b"])
        split = lambda z: z.reshape(b, t, self.n_heads, hd)
        q = split(h1 @ params["W_q"] + params["b_q"])
        k = split(h1 @ params["W_k"] + params["b_k"])
        v = split(h1 @ params["W_v"] + params["b_v"])
        a = self._attend(q, k, v, mask).reshape(b, t, d)
        x = x + a @ params["W_o"] + params["b_o"]

        h2 = _layer_norm(x, params["ln2_g"], params["ln2_b"])
        f = self._act(h2 @ params["W_ffn_in"] + params["b_ffn_in"])
        x = x + f @ params["W_ffn_out"] + params["b_ffn_out"]
        return x, state


# float ids saturate to int32 on the way to an index, as XLA's convert does
_INT32_MIN, _INT32_MAX = -2.0 ** 31, 2.0 ** 31 - 1


@register_layer
@dataclass
class EmbeddingSequenceLayer(LayerConf):
    """Token + learned-position embedding for sequences: indices [B, T] or
    [B, T, 1] (floats, as the network feeds them) -> [B, T, n_out].

    Ids follow `jnp.take` on the JAX layer's int32 cast: a float id is
    truncated toward zero (NaN gives 0, out-of-range values saturate), an
    id in [-vocab, -1] wraps to vocab + id, and any other out-of-range id
    gives a NaN row. The gather never sees an out-of-range index: on the
    GPU that is a device-side assert, which leaves the process's CUDA
    context unusable."""

    input_kind = "rnn"

    n_in: int = 0               # vocab size
    n_out: int = 0
    max_timesteps: Optional[int] = None   # positional table length
                                          # (default: input type timesteps)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        if not self.n_in or not self.n_out:
            raise ValueError("EmbeddingSequenceLayer needs n_in (vocab) "
                             "and n_out (width)")
        tmax = self.max_timesteps or it.timesteps
        if tmax is None:
            raise ValueError(
                "EmbeddingSequenceLayer needs max_timesteps (or an input "
                "type with a fixed timestep count) for the positional "
                "table")
        W = self._winit(gen, (self.n_in, self.n_out), fan_in=self.n_in,
                        fan_out=self.n_out, device=device)
        P = 0.02 * torch.randn((int(tmax), self.n_out), generator=gen,
                               dtype=torch.float32)
        return {"W": W, "P": P.to(device)}

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        idx = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
        if idx.is_floating_point():
            idx = torch.nan_to_num(idx, nan=0.0).clamp(_INT32_MIN, _INT32_MAX)
        idx = idx.to(torch.int64)
        W = params["W"]
        vocab = W.shape[0]
        idx = torch.where(idx < 0, idx + vocab, idx)
        ok = (idx >= 0) & (idx < vocab)
        z = W[idx.clamp(0, vocab - 1)]
        z = torch.where(ok[..., None], z, torch.full((), float("nan"),
                                                     dtype=z.dtype,
                                                     device=z.device))
        t = z.shape[1]
        return z + params["P"][:t][None], state
