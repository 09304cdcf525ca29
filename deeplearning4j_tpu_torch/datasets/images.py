"""Image record reader: the port of `deeplearning4j_tpu/datasets/images.py`
(DataVec's image pipeline: decode, channel fix, bilinear resize, NHWC
float32 in [0, 1], parent-directory labels). PNG, BMP, PPM and PGM decode
in the native C++ tier (`native/dl4j_native.cpp`); PIL opens what that tier
does not cover (JPEG and other formats), as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .iterators import DataSet, DataSetIterator

__all__ = ["ImageLoader", "ImageRecordReader",
           "ImageRecordDataSetIterator"]

_EXTS = (".png", ".bmp", ".ppm", ".pgm", ".jpg", ".jpeg", ".gif", ".webp")


def _decode(path: str) -> np.ndarray:
    """uint8 [H, W, C]: the native tier first, PIL for the formats it does
    not decode."""
    from ..native import image_decode_native

    img = image_decode_native(path)
    if img is not None:
        return img
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB") if im.mode not in ("L", "RGB") else im
        arr = np.asarray(im, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Vectorized bilinear resize, uint8 [H,W,C] -> float32 [h,w,C]."""
    H, W, _ = img.shape
    x = img.astype(np.float32)
    if (H, W) == (h, w):
        return x
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class ImageLoader:
    """NativeImageLoader analog: decode + channel-fix + resize + scale to
    [0,1] float32 NHWC slab."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height = int(height)
        self.width = int(width)
        self.channels = int(channels)

    def load(self, path: str) -> np.ndarray:
        img = _decode(path)
        if img.shape[2] == 2:   # gray+alpha (PNG color type 4): drop alpha
            img = img[:, :, :1]
        c = img.shape[2]
        if c != self.channels:
            if self.channels == 3 and c == 1:
                img = np.repeat(img, 3, axis=2)
            elif self.channels == 1 and c >= 3:
                img = np.round(
                    img[:, :, 0] * 0.299 + img[:, :, 1] * 0.587
                    + img[:, :, 2] * 0.114).astype(np.uint8)[:, :, None]
            elif self.channels == 3 and c == 4:
                img = img[:, :, :3]
            else:
                raise ValueError(
                    f"{path}: {c} channels, loader wants {self.channels}")
        return _resize_bilinear(img, self.height, self.width) / 255.0


class ImageRecordReader:
    """Directory-of-images reader with parent-directory labels (the
    reference `ImageRecordReader` + `ParentPathLabelGenerator` pattern):
    root/<label>/<image files>. Deterministic label-sorted order; shuffle
    at the iterator level."""

    def __init__(self, root: str, height: int, width: int,
                 channels: int = 3,
                 allowed_extensions: Sequence[str] = _EXTS):
        self.root = root
        self.loader = ImageLoader(height, width, channels)
        self.labels: List[str] = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.labels:
            raise ValueError(f"{root}: no label subdirectories")
        exts = tuple(allowed_extensions)
        self.records: List[Tuple[str, int]] = []
        for li, label in enumerate(self.labels):
            d = os.path.join(root, label)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(exts):
                    self.records.append((os.path.join(d, f), li))
        self._pos = 0

    def num_labels(self) -> int:
        return len(self.labels)

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self.records)

    def next(self) -> Tuple[np.ndarray, int]:
        path, label = self.records[self._pos]
        self._pos += 1
        return self.loader.load(path), label


class ImageRecordDataSetIterator(DataSetIterator):
    """Minibatch iterator over an ImageRecordReader: NHWC float32 features
    + one-hot labels (the RecordReaderDataSetIterator-over-images role)."""

    def __init__(self, reader: ImageRecordReader, batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.reader = reader
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self._epoch = 0
        self.reset()

    def reset(self):
        n = len(self.reader.records)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._order = rng.permutation(n)
        else:
            self._order = np.arange(n)
        self._pos = 0
        self._epoch += 1

    def batch(self) -> int:
        return self.batch_size

    def total_outcomes(self) -> int:
        return self.reader.num_labels()

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += len(idx)
        xs, ys = [], []
        for i in idx:
            path, label = self.reader.records[int(i)]
            xs.append(self.reader.loader.load(path))
            ys.append(label)
        x = np.stack(xs).astype(np.float32)
        y = np.eye(self.reader.num_labels(),
                   dtype=np.float32)[np.asarray(ys)]
        return DataSet(x, y)
