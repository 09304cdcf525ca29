"""Embedding plots: the port of `deeplearning4j_tpu/plot/`."""
from .tsne import BarnesHutTsne, Tsne, export_tsne_html

__all__ = ["BarnesHutTsne", "Tsne", "export_tsne_html"]
