from .graph import Graph, Vertex, Edge
from .loader import GraphLoader
from .walkers import RandomWalkIterator, WeightedRandomWalkIterator, NoEdgeHandling
from .deepwalk import DeepWalk, GraphVectors
from .node2vec import Node2Vec, Node2VecWalker

__all__ = ["Graph", "Vertex", "Edge", "GraphLoader", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "NoEdgeHandling", "DeepWalk",
           "GraphVectors", "Node2Vec", "Node2VecWalker"]
