"""KD-tree for exact nearest-neighbor queries: the port of
`deeplearning4j_tpu/clustering/kdtree.py` (reference
`deeplearning4j-core/.../clustering/kdtree/KDTree.java`: insert / nn / knn
over axis-aligned median splits).

Host-side numpy, as in the JAX package and the reference: a pointer-chasing
traversal has no device mapping. Points and queries may be torch tensors on
any device; each is copied to the host once.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from ..util.host import host_array

__all__ = ["KDTree"]


class _Node:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, points):
        self.points = host_array(points, np.float64)
        if self.points.ndim != 2:
            raise ValueError("points must be [N, D]")
        n, self.dims = self.points.shape
        self._root = self._build(np.arange(n), 0)
        self._size = n

    def __len__(self):
        return self._size

    def _build(self, idx: np.ndarray, depth: int) -> Optional[_Node]:
        if idx.size == 0:
            return None
        axis = depth % self.dims
        order = np.argsort(self.points[idx, axis], kind="stable")
        idx = idx[order]
        mid = idx.size // 2
        node = _Node(int(idx[mid]), axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    # -- queries ---------------------------------------------------------
    def nn(self, query) -> Tuple[int, float]:
        """(index, distance) of the single nearest point."""
        [(dist, index)] = self.knn(query, 1)
        return index, dist

    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        """k nearest as [(distance, index)] sorted ascending."""
        q = host_array(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated dist

        def visit(node: Optional[_Node]):
            if node is None:
                return
            p = self.points[node.index]
            dist = float(np.sqrt(np.sum((p - q) ** 2)))
            if len(heap) < k:
                heapq.heappush(heap, (-dist, node.index))
            elif dist < -heap[0][0]:
                heapq.heapreplace(heap, (-dist, node.index))
            delta = q[node.axis] - p[node.axis]
            near, far = ((node.left, node.right) if delta <= 0
                         else (node.right, node.left))
            visit(near)
            if len(heap) < k or abs(delta) < -heap[0][0]:
                visit(far)

        visit(self._root)
        return sorted((-d, i) for d, i in heap)
