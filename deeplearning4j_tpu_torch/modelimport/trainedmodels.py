"""Pretrained model helpers (the port of
`deeplearning4j_tpu/modelimport/trainedmodels.py`; reference
`trainedmodels/TrainedModels.java`, `TrainedModelHelper.java`,
`Utils/ImageNetLabels.java`).

The canonical public Keras VGG16 weight file loads directly into the zoo's
VGG16 topology: TF-format HWIO conv kernels and NHWC-flattened dense kernels
are the port's layout as they are.

Nothing is downloaded here. `TrainedModelHelper` and `ImageNetLabels` look a
file up in a cache directory (by default the download cache,
`data_dir("storage")`, under the name `provision.StorageDownloader` gives
the file, which is the JAX package's, or under the file's own name) and
raise FileNotFoundError naming the file to place there when it is missing.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..util.platform import DeviceLike

__all__ = ["TrainedModels", "TrainedModelHelper", "ImageNetLabels",
           "assign_keras_weights_in_order"]

_VGG16_WEIGHTS_URL = ("https://storage.googleapis.com/tensorflow/"
                      "keras-applications/vgg16/"
                      "vgg16_weights_tf_dim_ordering_tf_kernels.h5")
_IMAGENET_LABELS_URL = ("https://storage.googleapis.com/download.tensorflow."
                        "org/data/imagenet_class_index.json")


class TrainedModels:
    VGG16 = "vgg16"


def _natural_key(s):
    import re as _re
    return [int(t) if t.isdigit() else t for t in _re.split(r"(\d+)", s)]


def _check_order_safe(names, where: str):
    """Alphabetical h5 iteration must equal natural order at EVERY level,
    else default-named children (dense_2 ... dense_10) silently pair
    kernels/biases out of order."""
    if sorted(names) != sorted(names, key=_natural_key):
        raise ValueError(
            f"HDF5 names under {where!r} are not ordering-safe (numeric "
            "suffixes sort differently alphabetically vs naturally); use "
            "the full-model modelimport.keras path instead")


def _collect_weight_pairs(h5file) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Walk an HDF5 weights file and return (kernel, bias) pairs in
    traversal order. Handles both the legacy keras-applications layout
    (`block1_conv1/block1_conv1_W...`) and Keras 3 (`layers/<name>/vars/N`):
    any dataset with ndim >= 2 is a kernel; the next 1-D dataset in the
    same group is its bias."""
    import h5py

    pairs: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []

    def walk(group):
        kernel = None
        # legacy Keras files record the TRUE order in h5 attrs
        # (layer_names at the root, weight_names per layer group) — prefer
        # that; only fall back to alphabetical iteration (with the
        # natural-order safety check) when the attrs are absent (Keras 3)
        keys = None
        attrs = getattr(group, "attrs", {})
        for attr in ("layer_names", "weight_names"):
            if attr in attrs:
                names = [n.decode() if isinstance(n, bytes) else str(n)
                         for n in attrs[attr]]
                missing = [n for n in names if n not in group]
                if missing:
                    # a truncated/renamed weights file would otherwise
                    # silently shift the remaining pairs onto wrong layers
                    raise ValueError(
                        f"HDF5 {attr} attr under "
                        f"{getattr(group, 'name', '/')!r} lists entries "
                        f"missing from the group: {missing[:5]} — the "
                        "weights file is truncated or renamed")
                keys = names
                break
        if keys is None:
            keys = list(group)
            _check_order_safe(keys, getattr(group, "name", "/"))
        for key in keys:
            item = group[key]
            if isinstance(item, h5py.Group):
                walk(item)
            else:
                arr = np.asarray(item)
                if arr.ndim >= 2:
                    if kernel is not None:
                        pairs.append((kernel, None))
                    kernel = arr
                elif arr.ndim == 1 and kernel is not None:
                    pairs.append((kernel, arr))
                    kernel = None
        if kernel is not None:
            pairs.append((kernel, None))

    walk(h5file)
    return pairs


def _tensor_like(ours: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """`arr` as float32 on `ours`'s device."""
    return torch.from_numpy(np.array(arr, np.float32)).to(ours.device)


def assign_keras_weights_in_order(net, h5_path: str):
    """Assign a Keras weight file's (kernel, bias) pairs to a
    MultiLayerNetwork's parameterized conv/dense layers in order, with
    shape validation. Returns the network."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        if "layers" in f and isinstance(f["layers"], h5py.Group):
            # Keras 3 .weights.h5: group iteration is alphabetical, so
            # conv2d_10 would sort before conv2d_2 — ordered pairing is
            # unsafe. Proper model files go through modelimport.keras.
            raise ValueError(
                "Keras 3 .weights.h5 layout detected; save the FULL model "
                "(.h5/.keras) and use modelimport.keras import functions, "
                "or use a legacy keras-applications weight file here")
        # ordering safety is checked recursively at every group level
        # inside _collect_weight_pairs (nested numeric-suffixed names are
        # just as unsafe as top-level ones)
        pairs = _collect_weight_pairs(f)
    new_params = list(net.params)
    idx = 0
    for li, p in enumerate(new_params):
        if not p or "W" not in p:
            continue
        if idx >= len(pairs):
            raise ValueError(
                f"weight file has {len(pairs)} kernel/bias pairs but the "
                f"network needs more (layer {li})")
        k, b = pairs[idx]
        idx += 1
        ours = tuple(p["W"].shape)
        if tuple(k.shape) != tuple(ours):
            raise ValueError(
                f"layer {li}: kernel shape {k.shape} != expected {ours}")
        upd = dict(p)
        upd["W"] = _tensor_like(p["W"], k)
        if "b" in p and b is not None:
            if tuple(p["b"].shape) != tuple(b.shape):
                raise ValueError(
                    f"layer {li}: bias shape {b.shape} != "
                    f"{tuple(p['b'].shape)}")
            upd["b"] = _tensor_like(p["b"], b)
        new_params[li] = upd
    if idx != len(pairs):
        raise ValueError(f"weight file has {len(pairs) - idx} unused "
                         "kernel/bias pairs")
    net.params = tuple(new_params)
    return net


def cached_file(url: str, cache_dir: Optional[str] = None) -> str:
    """The cached copy of `url` in `cache_dir`: the name the downloader
    stores it under (`provision.StorageDownloader.cache_name`) or its
    basename. Raises FileNotFoundError naming both when neither is there."""
    from ..provision import StorageDownloader, object_name
    cache_dir = StorageDownloader(cache_dir).cache_dir
    name = object_name(url)
    names = (StorageDownloader.cache_name(url), name)
    for n in names:
        path = os.path.join(cache_dir, n)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"{name} is not in the cache {cache_dir}: place {url} there as "
        f"{names[0]} or {names[1]} (nothing is downloaded)")


class TrainedModelHelper:
    """Load pretrained zoo models from the cache (`TrainedModelHelper.java`
    role) onto `device`."""

    def __init__(self, cache_dir: Optional[str] = None,
                 device: DeviceLike = None):
        self.cache_dir = cache_dir
        self.device = device

    def load_model(self, which: str = TrainedModels.VGG16):
        if which != TrainedModels.VGG16:
            raise ValueError(f"unknown pretrained model {which!r}")
        from ..models.zoo import vgg16
        path = cached_file(_VGG16_WEIGHTS_URL, self.cache_dir)
        net = vgg16(device=self.device).init()
        return assign_keras_weights_in_order(net, path)


class ImageNetLabels:
    """The 1000 ImageNet class labels + decode helper
    (`Utils/ImageNetLabels.java`), from `imagenet_class_index.json` in the
    cache."""

    def __init__(self, cache_dir: Optional[str] = None):
        path = cached_file(_IMAGENET_LABELS_URL, cache_dir)
        with open(path) as f:
            idx = json.load(f)
        self.labels = [idx[str(i)][1] for i in range(len(idx))]

    def label(self, i: int) -> str:
        return self.labels[i]

    def decode_predictions(self, probs, top: int = 5):
        """[N, 1000] probabilities -> per-example [(label, p), ...]."""
        if isinstance(probs, torch.Tensor):
            probs = probs.detach().float().cpu().numpy()
        probs = np.asarray(probs)
        out = []
        for row in probs:
            order = np.argsort(-row)[:top]
            out.append([(self.labels[int(i)], float(row[int(i)]))
                        for i in order])
        return out
