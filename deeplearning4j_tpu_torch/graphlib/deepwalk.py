"""DeepWalk graph embeddings: the port of
`deeplearning4j_tpu/graphlib/deepwalk.py`, under the same names.

Parity with `graph/models/deepwalk/DeepWalk.java:31` + `GraphHuffman.java` +
`embeddings/GraphVectorsImpl.java`: random walks over the graph fed to a
skip-gram trainer with hierarchical softmax (the reference scores via a
Huffman binary tree over vertex degrees — here the shared SequenceVectors
HS path serves, with walk-visit counts as frequencies).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .graph import Graph
from .walkers import RandomWalkIterator, WeightedRandomWalkIterator
from ..nlp.word2vec import SequenceVectors
from ..util.platform import DeviceLike

__all__ = ["DeepWalk", "GraphVectors"]


class GraphVectors(SequenceVectors):
    """Vertex-embedding query API (reference GraphVectorsImpl)."""

    def vertex_vector(self, idx: int) -> Optional[np.ndarray]:
        return self.word_vector(str(idx))

    def similarity_vertices(self, a: int, b: int) -> float:
        return self.similarity(str(a), str(b))

    def vertices_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.words_nearest(str(idx), top_n)]

    def num_vertices(self) -> int:
        return self.vocab.num_words() if self.vocab else 0


class DeepWalk(GraphVectors):
    """Builder parity: DeepWalk.Builder().vectorSize(..).windowSize(..)
    .walkLength(..).build(); then fit(graph) / fit(walk_iterator)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 learning_rate: float = 0.025, epochs: int = 1,
                 seed: int = 12345, weighted: bool = False,
                 use_hierarchic_softmax: bool = True, negative: int = 0,
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
        self.weighted = weighted
        self._walks: List[List[str]] = []

    def _sequences(self):
        for w in self._walks:
            yield w, []

    def fit(self, graph_or_walks=None):
        if isinstance(graph_or_walks, Graph):
            g = graph_or_walks
            self._walks = []
            cls = (WeightedRandomWalkIterator if self.weighted
                   else RandomWalkIterator)
            for rep in range(self.walks_per_vertex):
                it = cls(g, self.walk_length, seed=self.seed + rep)
                for walk in it:
                    self._walks.append([str(v) for v in walk])
        elif graph_or_walks is not None:
            self._walks = [[str(v) for v in walk]
                           for walk in graph_or_walks]
        return super().fit()
