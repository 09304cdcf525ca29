"""Flash-attention forward: one CUDA kernel launch for all heads.

Counterpart of `deeplearning4j_tpu/kernels/attention.py:flash_attention` in
primal (inference) mode. The kernel is `csrc/attention.cu`; its header says
what bounds it and how its design answers that. The logsumexp-emitting
forward and the backward kernels wait for the training slice; the decode
plane's `q_positions` / `kv_length` masks wait for the decode slice.

  * `flash_attention` — the JAX contract: q [B, T, D], k/v [B, S, D].
  * `flash_attention_heads` — the entry the transformer layer calls:
    q [B, T, H, Dh], k/v [B, S, H, Dh] (what `vmap` over axis 2 gives in
    JAX, written as a batch dimension). One launch covers every head; the
    kernel reads rows with stride H * Dh, so the layer's projections go in
    as they are.
  * `attention_reference`, `attention_reference_heads` — the plain PyTorch
    versions, for the CPU and for holding the kernel to account.
  * `launches` — how many times a wrapper launched the kernel.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Both wrappers take float32 only, a head
dimension of at most 128 and contiguous tensors, on either device. The
kernel's output is not differentiable: on a CUDA tensor that autograd
records, the wrapper raises `AttentionGradientNotPorted` (the backward
kernels wait for LM training); the plain version on the CPU stays
differentiable.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_heads", "attention_reference",
           "attention_reference_heads", "launches", "reset_launches",
           "MAX_HEAD_DIM", "AttentionGradientNotPorted"]

MAX_HEAD_DIM = 128       # the kernel keeps 8 * 16 output columns per thread
_MAX_GRID_Y = 65535      # the kernel's grid is (ceil(T / 64), B * H)

launches = 0
_launch_lock = threading.Lock()
_fn = None


class AttentionGradientNotPorted(NotImplementedError):
    """The attention kernel was asked for an output autograd would
    differentiate; its backward (TPU kernels 2-3) is not ported yet."""


def reset_launches() -> int:
    """Set the launch count to 0; returns the count it had."""
    global launches
    with _launch_lock:
        n, launches = launches, 0
    return n


def _scale(q, sm_scale):
    return 1.0 / (q.shape[-1] ** 0.5) if sm_scale is None else float(sm_scale)


def attention_reference_heads(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain version on q [B, T, H, Dh], k/v [B, S, H, Dh]: float32
    logits, -inf above the top-left causal diagonal (kv <= q attends),
    softmax, output in q's dtype."""
    scale = _scale(q, sm_scale)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        T, S = logits.shape[-2:]
        live = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        logits = logits.masked_fill(~live, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", w, v.float()).to(q.dtype)


def attention_reference(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Plain version on q [B, T, D], k/v [B, S, D] (the JAX
    `attention_reference` without its decode arguments)."""
    return attention_reference_heads(
        q[:, :, None], k[:, :, None], v[:, :, None], causal,
        _scale(q, sm_scale))[:, :, 0]


def _kernel_fn():
    global _fn
    if _fn is None:
        from . import library
        fn = library().dl4j_flash_attn_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 4 + [i32] * 5 + [i64] * 4
                       + [i32, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, Dh], got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the attention kernel "
                             "takes float32 only")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, T, H, Dh = q.shape
    S = k.shape[1]
    if k.shape != (B, S, H, Dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, S, H, Dh] = [{B}, S, {H}, "
                         f"{Dh}] for q {tuple(q.shape)}; got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if min(B, T, S, H, Dh) < 1:
        raise ValueError(f"empty attention problem: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dimension {Dh} > {MAX_HEAD_DIM}, the most "
                         "the attention kernel takes")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} > {_MAX_GRID_Y} (the kernel's "
                         "grid)")


def flash_attention_heads(q, k, v, causal: bool = False,
                          sm_scale: Optional[float] = None):
    """Multi-head attention, q [B, T, H, Dh], k/v [B, S, H, Dh] ->
    [B, T, H, Dh]; semantics of `attention_reference_heads`. One kernel
    launch on a CUDA device."""
    global launches
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return attention_reference_heads(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise AttentionGradientNotPorted(
            "the CUDA attention kernel has no backward yet (LM training, "
            "ROADMAP A3); its output would be cut off from autograd. Run "
            "inference under torch.no_grad() / torch.inference_mode().")
    B, T, H, Dh = q.shape
    S = k.shape[1]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ld = H * Dh     # row stride of a contiguous [B, T, H, Dh] (size-1 dims
                    # may report any stride, so it is not read from them)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, T, S, H, Dh, ld, ld, ld, ld, int(bool(causal)), scale,
                 stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches += 1
    return o


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention with the JAX contract: q [B, T, D], k/v [B, S, D].
    The TPU kernel's tiling knobs `block_q` / `block_k` have no
    counterpart: the CUDA kernel tiles by 64 x 64."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, T, D], got shape "
                             f"{tuple(t.shape)}")
    return flash_attention_heads(q[:, :, None], k[:, :, None],
                                 v[:, :, None], causal, sm_scale)[:, :, 0]
