"""Per-layer gradient normalization and clipping: the port of
`deeplearning4j_tpu/nn/gradnorm.py` (renormalize-L2 per layer / per param
type, elementwise clip, L2-norm clip per layer / per param type)."""
from __future__ import annotations

import torch

from .conf import GradientNormalization

__all__ = ["apply_gradient_normalization"]


def _tmap(f, grads):
    return {k: f(g) for k, g in grads.items()}


def _global_l2(grads):
    return torch.sqrt(sum((g * g).sum() for g in grads.values()) + 1e-30)


def apply_gradient_normalization(mode: str, threshold: float, grads):
    """grads: one layer's gradient dict. Returns the transformed dict."""
    if mode in (None, GradientNormalization.NONE):
        return grads
    if mode == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        norm = _global_l2(grads)
        return _tmap(lambda g: g / norm, grads)
    if mode == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return _tmap(lambda g: g / torch.sqrt((g * g).sum() + 1e-30), grads)
    if mode == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return _tmap(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if mode == GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(threshold / _global_l2(grads), max=1.0)
        return _tmap(lambda g: g * scale, grads)
    if mode == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        def clip(g):
            norm = torch.sqrt((g * g).sum() + 1e-30)
            return g * torch.clamp(threshold / norm, max=1.0)
        return _tmap(clip, grads)
    raise ValueError(f"Unknown gradient normalization '{mode}'")
