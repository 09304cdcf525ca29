"""Graph loaders.

Parity with `graph/data/GraphLoader.java`: edge-list files ("from to" or
"from to weight" per line, configurable delimiter), adjacency-list files
("v n1 n2 n3 ...").
"""
from __future__ import annotations

from typing import Optional

from .graph import Graph

__all__ = ["GraphLoader"]


class GraphLoader:
    @staticmethod
    def load_edge_list(path: str, num_vertices: Optional[int] = None,
                       directed: bool = False, delimiter: str = None) -> Graph:
        edges = []
        max_v = -1
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                a, b = int(parts[0]), int(parts[1])
                w = float(parts[2]) if len(parts) > 2 else 1.0
                edges.append((a, b, w))
                max_v = max(max_v, a, b)
        g = Graph(num_vertices or max_v + 1, directed=directed)
        for a, b, w in edges:
            g.add_edge(a, b, w)
        return g

    @staticmethod
    def load_adjacency_list(path: str, num_vertices: Optional[int] = None,
                            directed: bool = False,
                            delimiter: str = None) -> Graph:
        rows = []
        max_v = -1
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [int(p) for p in line.split(delimiter)]
                rows.append(parts)
                max_v = max(max_v, *parts)
        g = Graph(num_vertices or max_v + 1, directed=True)
        for parts in rows:
            for b in parts[1:]:
                g.add_edge(parts[0], b, directed=True)
        return g
