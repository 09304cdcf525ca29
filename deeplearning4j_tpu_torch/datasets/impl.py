"""Dataset iterators over the fetchers (MNIST, Iris, CIFAR-10): the port
of `deeplearning4j_tpu/datasets/impl.py`. MNIST and CIFAR-10 read a local
cache only.
"""
from __future__ import annotations

from typing import Optional

from .fetchers import CifarDataFetcher, IrisDataFetcher, MnistDataFetcher
from .iterators import ArrayDataSetIterator

__all__ = ["MnistDataSetIterator", "IrisDataSetIterator",
           "CifarDataSetIterator"]


class MnistDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 128,
                 num_examples: Optional[int] = None, train: bool = True,
                 binarize: bool = False, shuffle: bool = False,
                 seed: Optional[int] = None, cache: Optional[str] = None):
        x, y = MnistDataFetcher(binarize=binarize, train=train,
                                shuffle=shuffle, seed=seed,
                                cache=cache).fetch()
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch_size=batch_size)


class IrisDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 150,
                 num_examples: Optional[int] = None, shuffle: bool = True,
                 seed: Optional[int] = 6, normalize: bool = True):
        x, y = IrisDataFetcher(shuffle=shuffle, seed=seed,
                               normalize=normalize).fetch()
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch_size=batch_size)


class CifarDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 128,
                 num_examples: Optional[int] = None, train: bool = True,
                 cache: Optional[str] = None):
        x, y = CifarDataFetcher(train=train, cache=cache).fetch()
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(x, y, batch_size=batch_size)
