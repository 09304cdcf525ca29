"""Bundled datasets of the port: the 384 real MNIST digits that
`deeplearning4j_tpu/datasets/fetchers.py:bundled_mnist_subset` reads, from
the port's own copy `deeplearning4j_tpu_torch/resources/mnist_subset.npz`
(uint8 images and labels), with the same shuffled split.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["bundled_mnist_subset"]

_RESOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources", "mnist_subset.npz")


def bundled_mnist_subset(train_count: int = 320, seed: int = 0):
    """(x_train [N, 784] float32 in [0, 1], y_train one-hot [N, 10], x_test,
    y_test): the 384 bundled digits in a seeded permutation, the first
    `train_count` for training."""
    with np.load(_RESOURCE) as z:
        imgs, labels = z["images"].astype(np.uint8), z["labels"].astype(
            np.int64)
    x = imgs.astype(np.float32) / 255.0
    order = np.random.default_rng(seed).permutation(len(x))
    x, y = x[order].reshape(len(x), -1), labels[order]
    oh = np.eye(10, dtype=np.float32)[y]
    return (x[:train_count], oh[:train_count],
            x[train_count:], oh[train_count:])
