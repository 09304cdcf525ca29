"""DataSet and the in-memory iterators: the port of the part of
`deeplearning4j_tpu/datasets/iterators.py` that fit and evaluate use
(`DataSet`, `DataSetIterator`, `ArrayDataSetIterator` with its seed +
consumed-epoch shuffle, `ListDataSetIterator`). Batches are host numpy
arrays, so the same iterator can feed the JAX package and the port.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DataSet", "DataSetIterator", "ArrayDataSetIterator",
           "ListDataSetIterator"]


@dataclass
class DataSet:
    """features/labels (+ optional masks) minibatch of numpy arrays (ND4J
    DataSet: features, labels, featuresMaskArray, labelsMaskArray). The
    network moves a batch to its device when it trains on it."""

    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        def cut(a, lo, hi):
            return None if a is None else a[lo:hi]
        n = self.num_examples()
        return (DataSet(*(cut(a, 0, n_train) for a in
                          (self.features, self.labels, self.features_mask, self.labels_mask))),
                DataSet(*(cut(a, n_train, n) for a in
                          (self.features, self.labels, self.features_mask, self.labels_mask))))

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(xs):
            xs = [x for x in xs if x is not None]
            return np.concatenate(xs, axis=0) if xs else None

        def cat_masks(masks, anchors):
            """Concat masks; datasets lacking one get all-ones so rows stay
            aligned with their examples."""
            if all(m is None for m in masks):
                return None
            proto = next(m for m in masks if m is not None)
            out = []
            for m, anchor in zip(masks, anchors):
                if m is None:
                    m = np.ones((anchor.shape[0],) + proto.shape[1:],
                                dtype=proto.dtype)
                out.append(m)
            return np.concatenate(out, axis=0)

        feats = [d.features for d in datasets]
        labs = [d.labels for d in datasets]
        return DataSet(cat(feats), cat(labs),
                       cat_masks([d.features_mask for d in datasets], feats),
                       cat_masks([d.labels_mask for d in datasets],
                                 [l if l is not None else f
                                  for l, f in zip(labs, feats)]))


class DataSetIterator:
    """Iterator contract: `__iter__` restarts an epoch (calls `reset`)."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    @property
    def async_supported(self) -> bool:
        return True


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays (role of ND4J's ListDataSetIterator over a
    pre-split list, but vectorized)."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 features_mask=None, labels_mask=None, shuffle: bool = False,
                 seed: Optional[int] = None, drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last and self.features.shape[0] < self.batch_size:
            # has_next() would be False forever: every epoch yields ZERO
            # batches and fit() silently trains on nothing
            warnings.warn(
                f"ArrayDataSetIterator(drop_last=True) with only "
                f"{self.features.shape[0]} examples < batch_size="
                f"{self.batch_size}: every epoch yields zero batches, so "
                "fit() will train on NOTHING. Lower batch_size, set "
                "drop_last=False, or pad with "
                "datasets.pipeline.PadToBatchIterator",
                UserWarning, stacklevel=2)
        self._epoch = 0
        self._drawn = False   # batches consumed since the last reset?
        self.reset()

    def reset(self):
        # Epoch E shuffles with `seed + E`, E counting CONSUMED epochs:
        # reset() only advances the epoch after a batch was drawn, so the
        # constructor's reset and fit()'s epoch-start reset both leave the
        # first epoch on `seed + 0` (reproducible from `seed=` alone).
        if self._drawn:
            self._epoch += 1
        n = self.features.shape[0]
        if self.shuffle:
            rng = np.random.default_rng(
                None if self.seed is None else self.seed + self._epoch)
            self._order = rng.permutation(n)
        else:
            self._order = np.arange(n)
        self._pos = 0
        self._drawn = False

    def set_epoch(self, epoch: int):
        """Position the shuffle-epoch counter (resume): the
        iterator reshuffles as if `epoch` epochs had already been
        consumed, so a resumed fit replays the exact permutation the
        interrupted run would have used (seed + epoch)."""
        self._epoch = int(epoch)
        self._drawn = False
        self.reset()

    def has_next(self) -> bool:
        remaining = len(self._order) - self._pos
        if self.drop_last:
            return remaining >= self.batch_size
        return remaining > 0

    def next(self) -> DataSet:
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += len(idx)
        self._drawn = True

        def take(a):
            return None if a is None else a[idx]
        return DataSet(take(self.features), take(self.labels),
                       take(self.features_mask), take(self.labels_mask))

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return int(self.features.shape[0])


class ListDataSetIterator(DataSetIterator):
    """Iterates a list of pre-built DataSets, re-batched to `batch` examples
    (parity with `datasets/iterator/ListDataSetIterator`)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        self._datasets = list(datasets)
        self._batch = batch_size
        if batch_size is not None:
            merged = DataSet.merge(self._datasets)
            self._datasets = []
            for i in range(0, merged.num_examples(), batch_size):
                self._datasets.append(DataSet(
                    merged.features[i:i + batch_size],
                    None if merged.labels is None else merged.labels[i:i + batch_size],
                    None if merged.features_mask is None else merged.features_mask[i:i + batch_size],
                    None if merged.labels_mask is None else merged.labels_mask[i:i + batch_size]))
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._datasets)

    def next(self):
        d = self._datasets[self._pos]
        self._pos += 1
        return d

    def batch(self):
        return self._batch or (self._datasets[0].num_examples() if self._datasets else 0)
