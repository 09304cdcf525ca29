"""Per-layer gradient normalization and clipping: the port of
`deeplearning4j_tpu/nn/gradnorm.py` (renormalize-L2 per layer / per param
type, elementwise clip, L2-norm clip per layer / per param type)."""
from __future__ import annotations

import torch

from .conf import GradientNormalization
from .trees import flat_leaves, tree_map

__all__ = ["apply_gradient_normalization"]



def _global_l2(grads):
    return torch.sqrt(sum((g * g).sum() for g in flat_leaves(grads))
                      + 1e-30)


def apply_gradient_normalization(mode: str, threshold: float, grads):
    """grads: one layer's gradient tree (a dict, nested for a BiLSTM).
    Returns the transformed tree; "per param type" means per leaf."""
    if mode in (None, GradientNormalization.NONE):
        return grads
    if mode == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        norm = _global_l2(grads)
        return tree_map(lambda g: g / norm, grads)
    if mode == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return tree_map(lambda g: g / torch.sqrt((g * g).sum() + 1e-30), grads)
    if mode == GradientNormalization.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return tree_map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if mode == GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.clamp(threshold / _global_l2(grads), max=1.0)
        return tree_map(lambda g: g * scale, grads)
    if mode == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        def clip(g):
            norm = torch.sqrt((g * g).sum() + 1e-30)
            return g * torch.clamp(threshold / norm, max=1.0)
        return tree_map(clip, grads)
    raise ValueError(f"Unknown gradient normalization '{mode}'")
