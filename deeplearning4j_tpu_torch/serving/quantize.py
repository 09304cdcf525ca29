"""Inference-time parameter transforms: bf16 cast and int8 weight-only
quantization (the port of `deeplearning4j_tpu/serving/quantize.py`).

Weight-only int8: every float weight tensor with ndim >= 2 and at least
`min_elems` elements is stored as int8 plus ONE per-tensor symmetric scale
(`scale = absmax / 127`); activations stay float. The quantization is
computed in numpy with JAX's own expressions, so both packages hold the
same int8 weights for the same parameters (numpy's `round` is
half-to-even, as `jnp.round` and `torch.round` are). The int8 data and the
scales live on the serving device, and dequantization (`int8 * scale`)
happens inside the forward, so a servable holds a ~4x smaller parameter
snapshot. Small leaves (biases, BN statistics) keep their dtype.

Post-training quantization with no calibration pass: expect ~1e-2-level
output drift on softmax heads, not bit-exactness.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..nn.trees import flatten_tree

__all__ = ["QuantizedTree", "quantize_tree", "cast_tree"]


def _as_tensor(leaf, device=None) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
        np.asarray(leaf))
    return t.detach().to(device if device is not None else t.device,
                         copy=True)


def _is_quantizable(t: torch.Tensor, min_elems: int) -> bool:
    return t.is_floating_point() and t.dim() >= 2 and t.numel() >= min_elems


class QuantizedTree:
    """A flattened parameter tree with int8-quantized weight leaves.

    `data` is the flat tuple a forward reads: a tensor for a pass-through
    leaf, an `(int8 weights, float32 scale)` pair of tensors for a
    quantized one. The scales are tensors read at run time, so two
    snapshots of one architecture share a runner (and its signature).
    `scales[i]` is the python-float scale (or None), for introspection.
    `rebuild(data)` returns the tree with every quantized leaf back in
    `compute_dtype`; `treedef` rebuilds a tree from a list of leaves."""

    def __init__(self, data: Tuple, scales: Tuple[Optional[float], ...],
                 treedef: Callable, compute_dtype=torch.float32):
        self.data = tuple(data)
        self.scales = tuple(scales)
        self.treedef = treedef
        self.compute_dtype = compute_dtype

    @property
    def n_quantized(self) -> int:
        return sum(1 for s in self.scales if s is not None)

    def nbytes(self) -> int:
        total = 0
        for d, s in zip(self.data, self.scales):
            for t in (d if s is not None else (d,)):
                total += t.numel() * t.element_size()
        return int(total)

    def rebuild(self, data):
        """The original tree from a flat `data` tuple, int8 leaves
        dequantized (called inside the forward)."""
        leaves = []
        for d, s in zip(data, self.scales):
            if s is not None:
                q, scale = d
                d = q.to(self.compute_dtype) * scale.to(self.compute_dtype)
            leaves.append(d)
        return self.treedef(leaves)


def quantize_tree(tree, min_elems: int = 64, compute_dtype=torch.float32,
                  device=None) -> QuantizedTree:
    """Per-tensor symmetric int8 weight-only quantization of a parameter
    tree (tensors or numpy arrays). Leaves below `min_elems` elements or
    with ndim < 2 pass through (biases, scalars, BN running statistics).
    The snapshot's tensors go to `device` (each leaf's own by default)."""
    leaves, rebuild = flatten_tree(tree)
    data, scales = [], []
    for leaf in leaves:
        t = _as_tensor(leaf, device)
        if _is_quantizable(t, min_elems):
            a = t.detach().to("cpu", torch.float32).numpy()
            absmax = float(np.max(np.abs(a)))
            scale = (absmax / 127.0) if absmax > 0 else 1.0
            q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
            data.append((torch.from_numpy(q).to(t.device),
                         torch.tensor(scale, dtype=torch.float32,
                                      device=t.device)))
            scales.append(scale)
        else:
            data.append(t)
            scales.append(None)
    return QuantizedTree(tuple(data), tuple(scales), rebuild,
                         compute_dtype=compute_dtype)


def cast_tree(tree, dtype):
    """Every floating leaf of a tree (tensors or numpy arrays) cast to
    `dtype` (a torch dtype or its name: the bf16 snapshot of the
    half-precision serving path); other leaves pass through as tensors."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    leaves, rebuild = flatten_tree(tree)
    out = []
    for leaf in leaves:
        t = _as_tensor(leaf)
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return rebuild(out)
