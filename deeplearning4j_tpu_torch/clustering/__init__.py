"""Clustering and spatial structures: the port of
`deeplearning4j_tpu/clustering/`. K-means runs on the device; the KD, VP
and space-partitioning trees are host numpy, as in the JAX package."""
from .kmeans import KMeansClustering
from .kdtree import KDTree
from .vptree import VPTree
from .sptree import QuadTree, SpTree

__all__ = ["KMeansClustering", "KDTree", "VPTree", "QuadTree", "SpTree"]
