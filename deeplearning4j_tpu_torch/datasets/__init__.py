"""Datasets of the port: DataSet, the in-memory iterators and the bundled
MNIST digits."""
from .fetchers import bundled_mnist_subset
from .iterators import (ArrayDataSetIterator, DataSet, DataSetIterator,
                        ListDataSetIterator)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator", "bundled_mnist_subset"]
