"""Space-partitioning tree (generalized quadtree/octree) for Barnes-Hut:
the port of `deeplearning4j_tpu/clustering/sptree.py` (reference
`deeplearning4j-core/.../clustering/sptree/SpTree.java`: n-D cells,
center-of-mass accumulation, `computeNonEdgeForces` with the theta
criterion; and `clustering/quadtree/QuadTree.java`, the d=2 case). Used by
BarnesHutTsne for the O(N log N) repulsive-force approximation.

Host-side numpy; torch tensors on any device are copied to the host once.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..util.host import host_array

__all__ = ["SpTree", "QuadTree"]


class _Cell:
    __slots__ = ("center", "width", "n_points", "com", "point_index",
                 "children", "is_leaf")

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = center          # cell midpoint [D]
        self.width = width            # half-extent per dim [D]
        self.n_points = 0
        self.com = np.zeros_like(center)   # center of mass
        self.point_index: Optional[int] = None
        self.children: Optional[List["_Cell"]] = None
        self.is_leaf = True


class SpTree:
    """Build once per t-SNE iteration over the embedding points."""

    def __init__(self, points: np.ndarray):
        self.points = host_array(points, np.float64)
        n, d = self.points.shape
        self.dims = d
        lo = self.points.min(axis=0)
        hi = self.points.max(axis=0)
        center = (lo + hi) / 2.0
        width = np.maximum((hi - lo) / 2.0, 1e-10) * (1.0 + 1e-3)
        self._root = _Cell(center, width)
        for i in range(n):
            self._insert(self._root, i)

    def _child_index(self, cell: _Cell, p: np.ndarray) -> int:
        idx = 0
        for dim in range(self.dims):
            if p[dim] > cell.center[dim]:
                idx |= (1 << dim)
        return idx

    def _make_children(self, cell: _Cell):
        half = cell.width / 2.0
        cell.children = []
        for ci in range(1 << self.dims):
            offset = np.array([half[dim] if (ci >> dim) & 1 else -half[dim]
                               for dim in range(self.dims)])
            cell.children.append(_Cell(cell.center + offset, half))
        cell.is_leaf = False

    def _insert(self, cell: _Cell, i: int, depth: int = 0):
        p = self.points[i]
        cell.com = (cell.com * cell.n_points + p) / (cell.n_points + 1)
        cell.n_points += 1
        if cell.is_leaf and cell.point_index is None:
            cell.point_index = i
            return
        if cell.is_leaf:
            j = cell.point_index
            # identical points would recurse forever; cap the depth
            if depth > 48 or np.allclose(self.points[j], p):
                return
            self._make_children(cell)
            cell.point_index = None
            self._insert(cell.children[self._child_index(cell,
                                                         self.points[j])],
                         j, depth + 1)
        self._insert(cell.children[self._child_index(cell, p)], i, depth + 1)

    # -- Barnes-Hut repulsive force (SpTree.computeNonEdgeForces) ---------
    def compute_non_edge_forces(self, i: int, theta: float):
        """Returns (neg_force [D], sum_q) for point i: the Barnes-Hut
        approximation of sum_j q_ij Z * (y_i - y_j) and Z itself."""
        p = self.points[i]
        neg = np.zeros(self.dims)
        sum_q = 0.0
        max_width = float(np.max(self._root.width)) * 2.0

        stack = [(self._root, max_width)]
        while stack:
            cell, width = stack.pop()
            if cell.n_points == 0:
                continue
            if cell.is_leaf and cell.point_index == i and cell.n_points == 1:
                continue
            diff = p - cell.com
            dist2 = float(diff @ diff)
            if cell.is_leaf or width * width < theta * theta * dist2:
                # treat the cell as one body; exclude self if inside
                n_eff = cell.n_points
                if cell.is_leaf and cell.point_index == i:
                    n_eff -= 1
                    if n_eff == 0:
                        continue
                q = 1.0 / (1.0 + dist2)
                contrib = n_eff * q
                sum_q += contrib
                neg += contrib * q * diff
            else:
                for child in cell.children:
                    stack.append((child, width / 2.0))
        return neg, sum_q


class QuadTree(SpTree):
    """2-D SpTree (`clustering/quadtree/QuadTree.java`)."""

    def __init__(self, points: np.ndarray):
        points = host_array(points, np.float64)
        if points.shape[1] != 2:
            raise ValueError("QuadTree is 2-D; use SpTree for other dims")
        super().__init__(points)
