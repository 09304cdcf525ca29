"""Vantage-point tree for metric-space nearest neighbors: the port of
`deeplearning4j_tpu/clustering/vptree.py` (reference
`deeplearning4j-core/.../clustering/vptree/VPTree.java`, the structure the
Barnes-Hut t-SNE builds its sparse input similarities from). Euclidean or
cosine ("dot" in the reference) metrics.

Host-side numpy; torch tensors on any device are copied to the host once.
The same points, seed and queries give JAX's neighbour lists.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from ..util.host import host_array

__all__ = ["VPTree"]


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, points, metric: str = "euclidean", seed: int = 0):
        self.points = host_array(points, np.float64)
        self.metric = metric
        if metric == "cosine":
            norms = np.linalg.norm(self.points, axis=1, keepdims=True)
            self._unit = self.points / np.maximum(norms, 1e-12)
        rng = np.random.default_rng(seed)
        self._root = self._build(list(range(len(self.points))), rng)

    def _dist_many(self, i: int, idx: List[int]) -> np.ndarray:
        if self.metric == "cosine":
            # angular distance: a true metric (1 - cos violates the triangle
            # inequality, which breaks VP pruning); same neighbor ordering
            cos = np.clip(self._unit[idx] @ self._unit[i], -1.0, 1.0)
            return np.arccos(cos)
        diff = self.points[idx] - self.points[i]
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _dist_query(self, q: np.ndarray, i: int) -> float:
        if self.metric == "cosine":
            qn = q / max(float(np.linalg.norm(q)), 1e-12)
            return float(np.arccos(np.clip(self._unit[i] @ qn, -1.0, 1.0)))
        return float(np.sqrt(np.sum((self.points[i] - q) ** 2)))

    def _build(self, idx: List[int], rng) -> Optional[_VPNode]:
        if not idx:
            return None
        vp = idx[rng.integers(len(idx))]
        rest = [i for i in idx if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        d = self._dist_many(vp, rest)
        median = float(np.median(d))
        node.threshold = median
        inside = [i for i, di in zip(rest, d) if di <= median]
        outside = [i for i, di in zip(rest, d) if di > median]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        q = host_array(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap (negated)
        tau = [np.inf]

        def visit(node: Optional[_VPNode]):
            if node is None:
                return
            d = self._dist_query(q, node.index)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.inside is None and node.outside is None:
                return
            if d <= node.threshold:
                visit(node.inside)
                if d + tau[0] > node.threshold:
                    visit(node.outside)
            else:
                visit(node.outside)
                if d - tau[0] <= node.threshold:
                    visit(node.inside)

        visit(self._root)
        return sorted((-d, i) for d, i in heap)
