"""Record readers: the port of `deeplearning4j_tpu/datasets/records.py`
(the DataVec CSV and binary record readers). Readers parse whole files into
dense numpy arrays up front; the CSV parser is the native C++ one
(`native/dl4j_native.cpp`), and a binary record file streams through the
native prefetch ring (a background C++ reader thread, the MagicQueue
analog), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .iterators import ArrayDataSetIterator, DataSet, DataSetIterator

__all__ = ["CSVRecordReader", "RecordReaderDataSetIterator",
           "BinaryRecordReader", "BinaryRecordDataSetIterator"]


class CSVRecordReader:
    """Numeric CSV -> float32 matrix (DataVec `CSVRecordReader` analog).
    Non-numeric fields parse as 0 (native) — pre-encode categoricals."""

    def __init__(self, skip_num_lines: int = 0):
        self.skip_num_lines = int(skip_num_lines)

    def read_matrix(self, path: str) -> np.ndarray:
        from ..native import csv_read_native
        return csv_read_native(path, self.skip_num_lines)


class RecordReaderDataSetIterator(ArrayDataSetIterator):
    """CSV records -> (features, one-hot labels) minibatches. Parity with
    `RecordReaderDataSetIterator(reader, batch, labelIndex, numClasses)`:
    `label_index` selects the class column, `num_classes` one-hot encodes
    it; `regression=True` keeps the label column(s) as real values."""

    def __init__(self, path: str, batch_size: int, label_index: int,
                 num_classes: int = 0, regression: bool = False,
                 reader: Optional[CSVRecordReader] = None,
                 label_count: int = 1):
        reader = reader or CSVRecordReader()
        m = reader.read_matrix(path)
        li = label_index if label_index >= 0 else m.shape[1] + label_index
        label_cols = list(range(li, li + label_count))
        feat_cols = [c for c in range(m.shape[1]) if c not in label_cols]
        x = m[:, feat_cols]
        if regression:
            y = m[:, label_cols]
        else:
            if num_classes <= 0:
                raise ValueError("num_classes required for classification")
            y = np.eye(num_classes, dtype=np.float32)[
                m[:, li].astype(np.int64)]
        super().__init__(x, y, batch_size=batch_size)


class BinaryRecordReader:
    """Fixed-size binary records streamed via the native prefetch ring
    (a background C++ reader thread filling `slots` batch buffers, the
    file-backed MagicQueue/AsyncDataSetIterator analog)."""

    def __init__(self, path: str, record_shape: Sequence[int],
                 dtype=np.uint8, header_bytes: int = 0,
                 total_records: Optional[int] = None, slots: int = 3):
        self.path = path
        self.record_shape = tuple(int(s) for s in record_shape)
        self.dtype = np.dtype(dtype)
        self.header_bytes = int(header_bytes)
        self.record_bytes = int(np.prod(self.record_shape)
                                * self.dtype.itemsize)
        if total_records is None:
            payload = os.path.getsize(path) - self.header_bytes
            total_records = payload // self.record_bytes
        self.total_records = int(total_records)
        self.slots = int(slots)

    def batches(self, batch_records: int) -> Iterator[np.ndarray]:
        """Batches of `batch_records` records ([n, *record_shape]); a file
        shorter than `total_records` raises IOError. A consumer that stops
        early closes the ring (and joins its thread) when the generator
        is closed or dropped."""
        from ..native import PrefetchRing
        with PrefetchRing(self.path, self.record_bytes, self.total_records,
                          batch_records, header_bytes=self.header_bytes,
                          slots=self.slots) as ring:
            while True:
                raw = ring.next_batch()
                if raw is None:
                    return
                yield (raw.view(self.dtype)
                       .reshape((-1,) + self.record_shape))


class BinaryRecordDataSetIterator(DataSetIterator):
    """DataSetIterator over a binary record file where each record is
    `label_bytes` of label followed by a flat feature payload (the CIFAR-10
    binary layout, `CifarDataSetIterator.java:17` capability analog).
    Features normalize u8 -> [0,1] f32; labels one-hot."""

    def __init__(self, path: str, feature_shape: Sequence[int],
                 num_classes: int, batch_size: int, label_bytes: int = 1,
                 header_bytes: int = 0,
                 label_byte_index: Optional[int] = None):
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        self.label_bytes = int(label_bytes)
        # default: last label byte — byte 0 for CIFAR-10, the fine label for
        # CIFAR-100's coarse+fine pair
        self.label_byte_index = (self.label_bytes - 1
                                 if label_byte_index is None
                                 else int(label_byte_index))
        if not 0 <= self.label_byte_index < self.label_bytes:
            raise ValueError(
                f"label_byte_index {self.label_byte_index} outside the "
                f"{self.label_bytes} label byte(s)")
        feat_bytes = int(np.prod(self.feature_shape))
        self.reader = BinaryRecordReader(
            path, (self.label_bytes + feat_bytes,), np.uint8,
            header_bytes=header_bytes)
        self._gen = None

    def reset(self):
        self._gen = self.reader.batches(self.batch_size)
        self._peek = None

    def has_next(self) -> bool:
        if self._gen is None:
            self.reset()
        if getattr(self, "_peek", None) is None:
            self._peek = next(self._gen, None)
        return self._peek is not None

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        raw, self._peek = self._peek, None
        labels = raw[:, self.label_byte_index].astype(np.int64)
        feats = raw[:, self.label_bytes:].astype(np.float32) / 255.0
        x = feats.reshape((-1,) + self.feature_shape)
        y = np.eye(self.num_classes, dtype=np.float32)[labels]
        return DataSet(x, y)

    def batch(self) -> int:
        return self.batch_size
