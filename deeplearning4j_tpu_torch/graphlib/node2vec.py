"""Node2Vec graph embeddings: the port of
`deeplearning4j_tpu/graphlib/node2vec.py`, under the same names.

Parity with `deeplearning4j-nlp/.../models/node2vec/Node2Vec.java` — vertex
embeddings from second-order biased random walks (Grover & Leskovec's
return parameter p and in-out parameter q) fed to the shared SequenceVectors
skip-gram trainer (negative sampling by default, as the paper).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .deepwalk import GraphVectors
from .graph import Graph
from ..util.platform import DeviceLike

__all__ = ["Node2Vec", "Node2VecWalker"]


class Node2VecWalker:
    """Second-order biased walks: from (prev, cur), the unnormalized
    transition weight to neighbor x is  1/p if x == prev,  1 if x is a
    neighbor of prev, 1/q otherwise — times the edge weight."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 0):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.p = float(p)
        self.q = float(q)
        self.rng = np.random.default_rng(seed)
        self._nbr_sets = [set(graph.neighbors(v))
                          for v in range(graph.num_vertices())]

    def walk_from(self, start: int) -> List[int]:
        walk = [start]
        prev: Optional[int] = None
        cur = start
        for _ in range(self.walk_length - 1):
            edges = self.graph.edges_out(cur)
            if not edges:
                break
            nxt_ids = np.array([e.to_idx for e in edges])
            w = np.array([e.weight for e in edges], dtype=np.float64)
            if prev is not None:
                prev_nbrs = self._nbr_sets[prev]
                bias = np.array([
                    1.0 / self.p if x == prev
                    else (1.0 if x in prev_nbrs else 1.0 / self.q)
                    for x in nxt_ids])
                w = w * bias
            w = w / w.sum()
            nxt = int(self.rng.choice(nxt_ids, p=w))
            walk.append(nxt)
            prev, cur = cur, nxt
        return walk

    def walks(self, walks_per_vertex: int = 1):
        n = self.graph.num_vertices()
        for _ in range(walks_per_vertex):
            for start in self.rng.permutation(n):
                yield self.walk_from(int(start))


class Node2Vec(GraphVectors):
    """Builder parity with the reference's Node2Vec model class; p/q are the
    walk bias hyperparameters from the paper."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 p: float = 1.0, q: float = 1.0,
                 learning_rate: float = 0.025, epochs: int = 1,
                 seed: int = 12345, negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 batch_size: int = 512, device: DeviceLike = None):
        super().__init__(layer_size=vector_size, window_size=window_size,
                         learning_rate=learning_rate, min_word_frequency=1,
                         epochs=epochs, seed=seed,
                         use_hierarchic_softmax=use_hierarchic_softmax,
                         negative=negative, batch_size=batch_size,
                         train_elements=True, train_sequences=False,
                         device=device)
        self.walk_length = int(walk_length)
        self.walks_per_vertex = int(walks_per_vertex)
        self.p = float(p)
        self.q = float(q)
        self._walks: List[List[str]] = []

    def _sequences(self):
        for w in self._walks:
            yield w, []

    def fit(self, graph_or_walks=None):
        if isinstance(graph_or_walks, Graph):
            walker = Node2VecWalker(graph_or_walks, self.walk_length,
                                    p=self.p, q=self.q, seed=self.seed)
            self._walks = [[str(v) for v in walk]
                           for walk in walker.walks(self.walks_per_vertex)]
        elif graph_or_walks is not None:
            self._walks = [[str(v) for v in walk]
                           for walk in graph_or_walks]
        return super().fit()
