"""Fused training-mode BatchNorm + activation: the layer's second tier.

Counterpart of `deeplearning4j_tpu/kernels/batchnorm.py:fused_bn_act`, which
is not a Pallas kernel but a formulation for XLA's fuser; here it is a
`torch.autograd.Function` of plain PyTorch operations with the same math:

  * one reduction pass for the statistics: float32 sum and sum of squares,
    var = max(E[x^2] - E[x]^2, 0) (acceptable where the layer selects this
    tier: bf16 / f16 activations, whose own mantissa bounds the precision);
  * the normalisation folded to y = act(x * scale + shift), scale = gamma *
    inv and shift = beta - mean * scale;
  * a backward with the hand-derived formula, the ReLU mask recomputed from
    the saved x (sign of xhat * gamma + beta) rather than saved;
  * `store_dtype` (e.g. "float8_e4m3fn") keeps the x saved for backward in a
    compact dtype.

`BatchNormalization._helper` picks it for sub-f32 training batches that the
BN+ReLU kernel does not take (identity activation, 4-D input, N past the
TPU kernel's budget).
"""
from __future__ import annotations

import torch

__all__ = ["fused_bn_act", "FUSED_BN_ACTIVATIONS"]

# activations the fused backward knows how to mask / derive
FUSED_BN_ACTIVATIONS = ("identity", "relu")


def _stats(xf: torch.Tensor):
    """One-pass float32 statistics over every axis but the last."""
    dims = tuple(range(xf.dim() - 1))
    n = float(xf.numel() // xf.shape[-1])
    mean = xf.sum(dim=dims) / n
    var = torch.clamp_min(torch.square(xf).sum(dim=dims) / n
                          - torch.square(mean), 0.0)
    return mean, var, n


class _FusedBnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, store_dtype):
        f32 = torch.float32
        g, b = gamma.to(f32), beta.to(f32)
        xf = x.to(f32)
        mean, var, n = _stats(xf)
        inv = torch.rsqrt(var + eps)
        scale = g * inv
        y = xf * scale + (b - mean * scale)
        if act == "relu":
            y = torch.relu(y)
        saved = x.to(getattr(torch, store_dtype)) if store_dtype else x
        ctx.save_for_backward(saved, mean, inv, gamma, beta)
        ctx.n, ctx.act = n, act
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma, beta = ctx.saved_tensors
        f32 = torch.float32
        dims = tuple(range(x.dim() - 1))
        gf, dyf = gamma.to(f32), dy.to(f32)
        xhat = (x.to(f32) - mean) * inv
        if ctx.act == "relu":
            # the mask from xhat (x is being read anyway) instead of the
            # saved forward output: one fewer pass over an activation
            dyf = torch.where(xhat * gf + beta.to(f32) > 0, dyf, 0.0)
        dg = (dyf * xhat).sum(dim=dims)
        db = dyf.sum(dim=dims)
        # dx in the activation's own dtype (dy carries it; x may be stored
        # compactly)
        dx = ((gf * inv) * (dyf - (db + xhat * dg) / ctx.n)).to(dy.dtype)
        return (dx, dg.to(gamma.dtype), db.to(beta.dtype), None, None, None)


def fused_bn_act(x, gamma, beta, eps: float, act: str, store_dtype: str = ""):
    """Training-mode BN + activation over channels-last `x` (rank >= 2;
    stats over every axis but the last). Returns (y, batch_mean, batch_var),
    the stats without a gradient (running-average semantics). `act` must be
    in FUSED_BN_ACTIVATIONS; `store_dtype` names a torch dtype for the x
    saved for backward ("" keeps x as it is)."""
    if act not in FUSED_BN_ACTIVATIONS:
        raise ValueError(f"fused_bn_act takes activations "
                         f"{FUSED_BN_ACTIVATIONS}, got {act!r}")
    if x.dim() < 2:
        raise ValueError(f"x must be [..., C], got {tuple(x.shape)}")
    return _FusedBnAct.apply(x, gamma, beta, float(eps), act,
                             str(store_dtype))
