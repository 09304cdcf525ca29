"""K-means clustering: the port of `deeplearning4j_tpu/clustering/kmeans.py`
(reference `deeplearning4j-core/.../clustering/kmeans/`).

Lloyd iterations on the device: the [N, K] distances through one product,
`argmin`, and the new centres from a one-hot product, as in the JAX
package. Empty clusters keep their centre. The first centres come from
the same numpy `default_rng(seed).choice` as JAX's, so the two packages
start alike. Each iteration reads its `shift` on the host once
(`host_reads` counts them), as JAX's `float(shift)` does.

`device=None` means the GPU. A CUDA input runs there; asked to run a
CUDA input on the CPU, `fit` raises rather than copy it back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..util.platform import DeviceLike, as_device_input, resolve_device

__all__ = ["KMeansClustering"]


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 seed: int = 0, distance: str = "euclidean",
                 device: DeviceLike = None):
        self.k = int(k)
        self.max_iterations = int(max_iterations)
        self.tol = float(tol)
        self.seed = seed
        self.distance = distance
        self.device = resolve_device(device)
        self.centers: Optional[np.ndarray] = None
        self.iterations = 0
        self.host_reads = 0

    def _dists(self, x, centers):
        if self.distance == "cosine":
            xn = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(
                1e-12)
            cn = centers / torch.linalg.norm(
                centers, dim=1, keepdim=True).clamp_min(1e-12)
            return 1.0 - xn @ cn.T
        sq_x = torch.sum(x * x, dim=1)[:, None]
        sq_c = torch.sum(centers * centers, dim=1)[None, :]
        return sq_x + sq_c - 2.0 * (x @ centers.T)

    def _step(self, x, centers):
        assign = torch.argmin(self._dists(x, centers), dim=1)
        one_hot = torch.nn.functional.one_hot(assign, self.k).to(x.dtype)
        counts = one_hot.sum(dim=0)
        new_centers = (one_hot.T @ x) / counts.clamp_min(1.0)[:, None]
        # keep empty clusters where they were
        new_centers = torch.where((counts == 0)[:, None], centers,
                                  new_centers)
        shift = torch.linalg.norm(new_centers - centers, dim=1).max()
        return new_centers, assign, shift

    def fit(self, x) -> "KMeansClustering":
        x = as_device_input(x, self.device)
        n = x.shape[0]
        rng = np.random.default_rng(self.seed)
        first = torch.as_tensor(rng.choice(n, self.k, replace=False),
                                device=self.device)
        centers = x[first]
        self.iterations = self.host_reads = 0
        for _ in range(self.max_iterations):
            centers, assign, shift = self._step(x, centers)
            self.iterations += 1
            self.host_reads += 1
            if float(shift) < self.tol:
                break
        self.centers = centers.cpu().numpy()
        self.labels_ = assign.cpu().numpy()
        return self

    def predict(self, x) -> np.ndarray:
        x = as_device_input(x, self.device)
        centers = torch.as_tensor(self.centers, device=self.device)
        return torch.argmin(self._dists(x, centers), dim=1).cpu().numpy()
