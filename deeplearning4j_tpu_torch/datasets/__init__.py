"""Datasets of the port: DataSet and the in-memory iterators."""
from .iterators import (ArrayDataSetIterator, DataSet, DataSetIterator,
                        ListDataSetIterator)

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator"]
