"""Device selection for the port's entry points.

Every entry point takes `device=`. Left out, it means the GPU: the port runs
on the card unless the caller asks for the CPU, and it never moves to the CPU
on its own. A missing GPU is an error, not a fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "as_device_input", "strict_fp32"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or CUDA when it is None. Raises when CUDA is asked for
    (explicitly or by default) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def as_device_input(x, device: torch.device) -> torch.Tensor:
    """`x` as float32 on `device`. A CUDA tensor is never moved to the
    CPU: a model on the CPU refuses it."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda and device.type != "cuda":
            raise ValueError(
                f"a CUDA input for a model on {device}: move the model to "
                "the GPU (device=None) or the input to the CPU")
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def strict_fp32():
    """Full float32 for matrix products and convolutions: the JAX reference
    is compared in f32, and TF32 keeps only about three decimal digits. A
    bf16 product keeps its float32 accumulation too (XLA accumulates bf16
    products in f32; cuBLAS's default reduced-precision split-K would not)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
