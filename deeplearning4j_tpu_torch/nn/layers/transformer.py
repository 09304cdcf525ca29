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
JAX. The decode-mode methods (`decode_qkv`, `decode_attend`,
`decode_finish`, `decode_embed`) serve the KV-cache generation plane
(`serving/decode`).

Megatron roles (JAX's `_TP_ROLES`, `tp_shard_axis`, `tp_validate`): inside
the parallel stack's `tp_region` a block handed its model-axis shards
(column-parallel W_q / W_k / W_v / W_ffn_in, row-parallel W_o / W_ffn_out)
attends over its H/m heads and all-reduces once after attention and once
after the FFN (`parallel/tp.py`); the embedding, handed its vocab rows,
looks up the ids in them and all-reduces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..conf.base import LayerConf, register_layer
from ..conf.input_type import InputType
from .feedforward import take_rows

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

    # Megatron tensor-parallel roles (JAX's): the axis sharded over
    # "model", or "replicated"
    _TP_ROLES = {
        "W_q": -1, "W_k": -1, "W_v": -1,        # column parallel
        "b_q": 0, "b_k": 0, "b_v": 0,
        "W_ffn_in": -1, "b_ffn_in": 0,
        "W_o": 0, "W_ffn_out": 0,               # row parallel
        "b_o": "replicated", "b_ffn_out": "replicated",
        "ln1_g": "replicated", "ln1_b": "replicated",
        "ln2_g": "replicated", "ln2_b": "replicated",
    }
    #: the sharded leaves the block computes with as shards
    tp_local_keys = ("W_q", "W_k", "W_v", "b_q", "b_k", "b_v", "W_ffn_in",
                     "b_ffn_in", "W_o", "W_ffn_out")

    def __post_init__(self):
        # FFN nonlinearity defaults to gelu (GPT convention), not identity
        if self.activation is None:
            self.activation = "gelu"

    def tp_shard_axis(self, key: str, shape):
        return self._TP_ROLES.get(key)

    def tp_validate(self, model_size: int):
        """The QKV reshape [.., F] -> [.., H, Dh] stays local only when the
        model axis divides the head count (JAX's check and message)."""
        if model_size > 1 and self.n_heads % model_size:
            raise ValueError(
                f"TransformerBlock(n_heads={self.n_heads}) cannot shard "
                f"over a model axis of size {model_size}: heads must "
                "split evenly across the axis (n_heads % model_size == "
                "0). Use a head count divisible by the model-axis size, "
                "or a smaller model axis")

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
        from ...parallel.tp import tp_active
        tp = tp_active()
        if tp is not None and params["W_q"].shape[1] * tp.size == d:
            return self._apply_tp(params, x, mask, tp), state

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

    def _apply_tp(self, params, x, mask, tp):
        """The block on this rank's shards: its H/m heads, the row-parallel
        partial products summed over the model group in float32."""
        from ...parallel.tp import copy_to_tp, reduce_from_tp
        b, t, d = x.shape
        hd = d // self.n_heads
        hl = self.n_heads // tp.size
        h1 = copy_to_tp(_layer_norm(x, params["ln1_g"], params["ln1_b"]), tp)
        split = lambda z: z.reshape(b, t, hl, hd)
        q = split(h1 @ params["W_q"] + params["b_q"])
        k = split(h1 @ params["W_k"] + params["b_k"])
        v = split(h1 @ params["W_v"] + params["b_v"])
        a = self._attend(q, k, v, mask).reshape(b, t, hl * hd)
        o = reduce_from_tp(a @ params["W_o"], tp).to(x.dtype)
        x = x + o + params["b_o"]
        h2 = copy_to_tp(_layer_norm(x, params["ln2_g"], params["ln2_b"]), tp)
        f = self._act(h2 @ params["W_ffn_in"] + params["b_ffn_in"])
        o = reduce_from_tp(f @ params["W_ffn_out"], tp).to(x.dtype)
        return x + o + params["b_ffn_out"]

    # -- decode mode (KV-cache generation, serving/decode) -----------------
    # The generation plane splits the block in three so that the paged
    # cache's scatter and gather run between them (the layer owns the math,
    # the decode engine the block tables):
    #   q, k, v = blk.decode_qkv(p, x)        # LN1 + projections
    #   <the engine scatters k / v into its arena, gathers the cache view>
    #   a = blk.decode_attend(q, k_all, v_all, positions, lengths)
    #   y = blk.decode_finish(p, x, a)        # out-projection + FFN
    # Over a whole causal prompt (k_all = k, positions = arange) the three
    # are `apply`.
    def decode_qkv(self, params, x):
        """LN1 + QKV projection: x [B, T, D] -> q, k, v, each [B, T, H,
        Dh]."""
        b, t, d = x.shape
        hd = d // self.n_heads
        h1 = _layer_norm(x, params["ln1_g"], params["ln1_b"])
        split = lambda z: z.reshape(b, t, self.n_heads, hd)
        return (split(h1 @ params["W_q"] + params["b_q"]),
                split(h1 @ params["W_k"] + params["b_k"]),
                split(h1 @ params["W_v"] + params["b_v"]))

    def decode_attend(self, q, k_all, v_all, positions, lengths):
        """Attention over a cache view: q [B, Tn, H, Dh] (the Tn newest
        tokens, at absolute key indices `positions` [B, Tn]), k_all / v_all
        [B, S, H, Dh] the whole view (the new keys written in), `lengths`
        [B] valid slots a row. The plain masked attention on any device, as
        JAX runs `attention_reference` here: no kernel takes these masks."""
        from ...kernels.attention import attention_reference_heads
        return attention_reference_heads(q, k_all, v_all, self.causal,
                                         q_positions=positions,
                                         kv_length=lengths)

    def decode_finish(self, params, x, attn):
        """The half after attention: the out-projection residual, then the
        FFN residual. attn [B, Tn, H, Dh] -> [B, Tn, D]."""
        b, t, d = x.shape
        x = x + attn.reshape(b, t, d) @ params["W_o"] + params["b_o"]
        h2 = _layer_norm(x, params["ln2_g"], params["ln2_b"])
        f = self._act(h2 @ params["W_ffn_in"] + params["b_ffn_in"])
        return x + f @ params["W_ffn_out"] + params["b_ffn_out"]


@register_layer
@dataclass
class EmbeddingSequenceLayer(LayerConf):
    """Token + learned-position embedding for sequences: indices [B, T] or
    [B, T, 1] (floats, as the network feeds them) -> [B, T, n_out].

    Ids follow `jnp.take` on the JAX layer's int32 cast (`take_rows`)."""

    input_kind = "rnn"

    n_in: int = 0               # vocab size
    n_out: int = 0
    max_timesteps: Optional[int] = None   # positional table length
                                          # (default: input type timesteps)

    #: the vocab-sharded token table is looked up as its shard
    tp_local_keys = ("W",)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)

    def tp_shard_axis(self, key: str, shape):
        # JAX's: the token table vocab-sharded, the positional table on its
        # width axis (gathered before the lookup)
        return 0 if key == "W" else -1

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
        from ...parallel.tp import tp_active
        tp = tp_active()
        rows = params["W"].shape[0]
        if tp is not None and rows * tp.size == self.n_in:
            z = self._lookup_tp(params["W"], idx, rows, tp)
        else:
            z = take_rows(params["W"], idx)
        t = z.shape[1]
        return z + params["P"][:t][None], state

    def _lookup_tp(self, W, idx, rows, tp):
        """The ids in this rank's vocab rows looked up, the others zero,
        summed over the model group (exactly one rank holds each id)."""
        from ...parallel.tp import reduce_from_tp
        ids = idx.to(torch.int64) - tp.index * rows
        inside = (ids >= 0) & (ids < rows)
        z = take_rows(W, torch.where(inside, ids, torch.zeros_like(ids)))
        z = z * inside.unsqueeze(-1).to(z.dtype)
        return reduce_from_tp(z, tp).to(W.dtype)

    def decode_embed(self, params, idx, positions):
        """Token + position embedding at absolute positions: idx and
        positions [B, T] integer -> [B, T, n_out]. Positions must lie below
        the positional table's length, which bounds the context window."""
        return take_rows(params["W"], idx) + params["P"][positions]
