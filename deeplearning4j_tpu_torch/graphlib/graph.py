"""Graph API.

Parity with `deeplearning4j-graph`: `graph/api/IGraph.java` contracts +
`graph/graph/Graph.java` adjacency-list implementation (directed/undirected,
weighted edges, vertex values).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Vertex", "Edge", "Graph"]


@dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclass
class Edge:
    from_idx: int
    to_idx: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False,
                 allow_multiple_edges: bool = True):
        self.directed = directed
        self.allow_multiple_edges = allow_multiple_edges
        self._vertices = [Vertex(i) for i in range(num_vertices)]
        self._adj: List[List[Edge]] = [[] for _ in range(num_vertices)]

    # ------------------------------------------------------------------
    def num_vertices(self) -> int:
        return len(self._vertices)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def set_vertex_value(self, idx: int, value):
        self._vertices[idx].value = value

    def add_edge(self, from_idx: int, to_idx: int, weight: float = 1.0,
                 directed: Optional[bool] = None):
        directed = self.directed if directed is None else directed
        e = Edge(from_idx, to_idx, weight, directed)
        if not self.allow_multiple_edges:
            for ex in self._adj[from_idx]:
                if ex.to_idx == to_idx:
                    return
        self._adj[from_idx].append(e)
        if not directed:
            self._adj[to_idx].append(Edge(to_idx, from_idx, weight, directed))

    def edges_out(self, idx: int) -> List[Edge]:
        return list(self._adj[idx])

    def neighbors(self, idx: int) -> List[int]:
        return [e.to_idx for e in self._adj[idx]]

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def num_edges(self) -> int:
        total = sum(len(a) for a in self._adj)
        return total if self.directed else total // 2
