"""LabeledPoint ingestion: the port of
`deeplearning4j_tpu/datasets/labeled_point.py`. A `LabeledPoint` is a
(label, feature vector) pair, dense or sparse (MLlib's layout); fitting
converts them to DataSets (one-hot labels for classification).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .iterators import DataSet, DataSetIterator

__all__ = ["LabeledPoint", "labeled_points_to_dataset",
           "LabeledPointDataSetIterator"]


@dataclass
class LabeledPoint:
    """(label, features) — features dense (array) or sparse
    ((indices, values, size) triple, MLlib SparseVector layout)."""

    label: float
    features: Union[np.ndarray, Tuple[Sequence[int], Sequence[float], int]]

    def dense(self) -> np.ndarray:
        f = self.features
        if isinstance(f, tuple) and len(f) == 3:
            idx, vals, size = f
            idx = np.asarray(idx, np.int64)
            if len(idx) and (idx.min() < 0 or idx.max() >= int(size)):
                # MLlib SparseVector contract: indices in [0, size) —
                # numpy wrap-around would silently shuffle features
                raise ValueError(
                    f"sparse indices outside [0, {int(size)}): "
                    f"{idx[(idx < 0) | (idx >= int(size))][:5].tolist()}")
            out = np.zeros(int(size), np.float32)
            out[idx] = np.asarray(vals, np.float32)
            return out
        return np.asarray(f, np.float32)


def labeled_points_to_dataset(points: Sequence[LabeledPoint],
                              n_classes: Optional[int] = None) -> DataSet:
    """Convert LabeledPoints to one DataSet. `n_classes` set: labels are
    class indices -> one-hot (the `fit(RDD<LabeledPoint>, nClasses)`
    overload); None: regression targets, shape [N, 1]."""
    if not points:
        raise ValueError("no points")
    x = np.stack([p.dense() for p in points])
    labels = np.asarray([p.label for p in points])
    if n_classes is not None:
        idx = labels.astype(np.int64)
        if (idx < 0).any() or (idx >= n_classes).any():
            raise ValueError(
                f"labels outside [0, {n_classes}): {sorted(set(idx) - set(range(n_classes)))[:5]}")
        y = np.eye(int(n_classes), dtype=np.float32)[idx]
    else:
        y = labels.astype(np.float32)[:, None]
    return DataSet(x, y)


class LabeledPointDataSetIterator(DataSetIterator):
    """Batched iterator over LabeledPoints — drop-in for fit()/evaluate()
    (the role `MLLibUtil.fromLabeledPoint` + RecordReaderDataSetIterator
    played for the reference's Spark front-end)."""

    def __init__(self, points: Sequence[LabeledPoint], batch_size: int = 32,
                 n_classes: Optional[int] = None):
        self.points = list(points)
        self.batch_size = int(batch_size)
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.points)

    def next(self) -> DataSet:
        chunk = self.points[self._pos:self._pos + self.batch_size]
        self._pos += len(chunk)
        return labeled_points_to_dataset(chunk, self.n_classes)

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.points)
