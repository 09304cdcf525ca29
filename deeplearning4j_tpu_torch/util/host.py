"""Host copies for the port's host-side code (the trees, Barnes-Hut t-SNE,
the dashboard, the listeners).

That code is numpy, as in the JAX package. Handed a torch tensor on any
device it copies it to the host once; bfloat16 becomes float32 first
(numpy has no bfloat16). `np.asarray` is never called on a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["host_array"]


def host_array(a, dtype: Optional[np.dtype] = None) -> np.ndarray:
    """`a` (a torch tensor on any device, or array-like) as a numpy array,
    in `dtype` when given."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype=dtype)
