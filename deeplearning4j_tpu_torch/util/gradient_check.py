"""Gradient check: the port of `deeplearning4j_tpu/util/gradient_check.py`.

Central-difference numeric gradients against the analytic ones (autograd)
per parameter, in float64, with the reference's relative-error test

    relError = |analytic - numeric| / (|analytic| + |numeric|)

failing a coordinate only where it also exceeds `min_abs_error`. Large
tensors are checked on a seeded random subsample of coordinates. It runs
on the CPU: the CUDA kernels compute in float32, so a float64 network on
the CPU takes the layers' plain float64 paths.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..nn.trees import leaf_paths, tree_map

__all__ = ["GradientCheckUtil", "check_gradients_fn"]

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8


def _paths(params):
    """[(name, leaf)] of a tuple of per-layer (possibly nested) dicts, in
    sorted-key-path order: `0/W`, a BiLSTM's `0/fwd/W`."""
    return [(f"{i}/{path}", leaf) for i, p in enumerate(params)
            for path, leaf in leaf_paths(p)]


def check_gradients_fn(
    loss_fn: Callable,
    params,
    eps: float = DEFAULT_EPS,
    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
    max_params_per_array: Optional[int] = 128,
    seed: int = 0,
    print_results: bool = False,
) -> Tuple[bool, List[str]]:
    """Check d loss_fn(params) / d params numerically. `params` is a tuple
    of per-layer (possibly nested) dicts of tensors; `loss_fn(params)` returns a scalar
    tensor. Returns (passed, failure messages)."""
    params = tuple(tree_map(lambda v: v.detach().to(torch.float64).clone(),
                            p) for p in params)
    leaves = [leaf for _, leaf in _paths(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    with torch.enable_grad():
        analytic = torch.autograd.grad(loss_fn(params), leaves,
                                       allow_unused=True)
    rng = np.random.default_rng(seed)
    failures: List[str] = []
    checked = 0
    with torch.no_grad():
        for (name, leaf), grad in zip(_paths(params), analytic):
            n = leaf.numel()
            if n == 0:
                continue
            coords = np.arange(n)
            if max_params_per_array is not None and n > max_params_per_array:
                coords = np.sort(rng.choice(n, size=max_params_per_array,
                                            replace=False))
            flat = leaf.view(-1)
            numeric = np.empty(len(coords))
            for j, c in enumerate(coords):
                orig = flat[c].item()
                flat[c] = orig + eps
                plus = float(loss_fn(params))
                flat[c] = orig - eps
                minus = float(loss_fn(params))
                flat[c] = orig
                numeric[j] = (plus - minus) / (2.0 * eps)
            a = (np.zeros(len(coords)) if grad is None
                 else grad.reshape(-1).cpu().numpy()[coords])
            abs_err = np.abs(a - numeric)
            denom = np.abs(a) + np.abs(numeric)
            rel_err = np.where(denom > 0,
                               abs_err / np.maximum(denom, 1e-300), 0.0)
            bad = (rel_err > max_rel_error) & (abs_err > min_abs_error)
            checked += len(coords)
            for c, aa, nn_, re_ in zip(coords[bad], a[bad], numeric[bad],
                                       rel_err[bad]):
                failures.append(
                    f"param '{name}'[{c}]: analytic={aa:.8e} "
                    f"numeric={nn_:.8e} relError={re_:.4e}")
    if print_results:
        print(f"GradientCheck: {checked} checked, {len(failures)} failed")
    return len(failures) == 0, failures


class GradientCheckUtil:
    """Model-level wrapper (the reference's API shape)."""

    @staticmethod
    def check_gradients(model, dataset, eps: float = DEFAULT_EPS,
                        max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                        min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                        subsample: Optional[int] = 128,
                        print_results: bool = False) -> bool:
        """Check a MultiLayerNetwork's gradients on a DataSet, in float64
        on the CPU. The check draws no dropout (no generator is passed),
        so stochastic layers are deterministic during it."""
        if model.device.type != "cpu":
            raise ValueError("the gradient check runs on the CPU; move the "
                             "network with .to('cpu')")
        f64 = lambda a: (None if a is None
                         else torch.as_tensor(np.asarray(a),
                                              dtype=torch.float64))
        x, y = f64(dataset.features), f64(dataset.labels)
        fmask, lmask = f64(dataset.features_mask), f64(dataset.labels_mask)

        def loss(params):
            s, _ = model._loss_fn(params, model.state, x, y, None,
                                  fmask=fmask, lmask=lmask, train=True)
            return s

        ok, failures = check_gradients_fn(
            loss, model.params, eps=eps, max_rel_error=max_rel_error,
            min_abs_error=min_abs_error, max_params_per_array=subsample,
            print_results=print_results)
        if not ok and print_results:
            for f in failures[:20]:
                print("FAIL:", f)
        return ok
