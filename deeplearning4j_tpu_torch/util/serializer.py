"""Model checkpoint zip, the same container `deeplearning4j_tpu/util/serializer.py`
writes, so a model saved by either package loads in the other:

  * `configuration.json`   — the network config (identical JSON)
  * `coefficients.npz`     — parameters, keyed `i:<layer>/k:<param>`
  * `networkState.npz`     — layer state, keyed `i:<layer>/k:<name>`
                             (BatchNormalization's `i:1/k:mean`, `k:var`)
  * `updaterState.npz`     — optimizer state, keyed `i:<layer>/k:<slot>/
                             k:<param>` (`i:0/k:m/k:W`)
  * `metadata.json`        — counters and model kind
  * `manifest.sha256.json` — sha256 of every other entry, checked on restore

Writes are crash-safe (fault/atomic.py). `from_jax_params` loads the JAX
net's parameters (and optionally its layer state and updater state), as
numpy arrays, straight into a port network.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..fault.atomic import CorruptCheckpointError, atomic_replace, sha256_hex
from ..util.platform import DeviceLike

__all__ = ["ModelSerializer", "tree_to_arrays", "arrays_to_tree",
           "from_jax_params"]


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + [f"k:{k}"], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, prefix + [f"i:{i}"], out)
    else:
        out["/".join(prefix)] = tree


def tree_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a tuple of per-layer dicts to {path: array}, with the key
    paths JAX's `tree_flatten_with_path` gives (`i:0/k:W`)."""
    flat: Dict = {}
    _flatten(tree, [], flat)
    # numpy has no bfloat16: such tensors (Adam's m with state_dtype
    # "bfloat16") are written as float32, which holds them exactly
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in flat.items()}


def arrays_to_tree(template, arrays: Dict[str, np.ndarray]):
    """Rebuild a tree shaped like `template` (tensors give shape, dtype and
    device) from {path: array}; raises on a missing key or a wrong shape."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(t[k], prefix + [f"k:{k}"]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + [f"i:{i}"])
                           for i, v in enumerate(t))
        key = "/".join(prefix)
        if key not in arrays:
            raise KeyError(f"Checkpoint missing array '{key}'")
        arr = np.asarray(arrays[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"Checkpoint shape mismatch at '{key}': "
                             f"{arr.shape} vs {tuple(t.shape)}")
        return torch.tensor(arr, dtype=t.dtype, device=t.device)   # a copy
    return build(template, [])


def from_jax_params(net, params: Sequence[Dict[str, np.ndarray]],
                    updater_state: Optional[Sequence] = None,
                    state: Optional[Sequence[Dict[str, np.ndarray]]] = None):
    """Load the JAX network's parameters (one dict of numpy arrays per
    layer, keyed as in JAX) into `net`, which must be initialized; with
    `updater_state` (JAX's `updater_state` with its leaves as numpy arrays:
    one entry per layer, `{"m": {"W": ...}, ...}` or `()`) its updater
    state, and with `state` (JAX's `state`: one dict per layer, `{"mean":
    ..., "var": ...}` for BatchNormalization, `{}` for the others) its layer
    state too. Shapes are checked; a missing key raises KeyError."""
    trees = (("parameter", params, "params"),
             ("updater state", updater_state, "updater_state"),
             ("layer state", state, "state"))
    for what, tree, _ in trees:
        if tree is not None and len(tree) != len(net.params):
            raise ValueError(f"{len(tree)} layer {what} dicts for a "
                             f"{len(net.params)}-layer network")
    for _, tree, attr in trees:
        if tree is not None:
            arrays: Dict = {}
            _flatten(list(tree), [], arrays)
            setattr(net, attr, arrays_to_tree(getattr(net, attr), arrays))
    return net


def _savez(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _loadz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class ModelSerializer:
    CONFIG = "configuration.json"
    COEFFICIENTS = "coefficients.npz"
    UPDATER_STATE = "updaterState.npz"
    NETWORK_STATE = "networkState.npz"
    METADATA = "metadata.json"
    MANIFEST = "manifest.sha256.json"

    @staticmethod
    def write_model(model, path: str, save_updater: bool = True):
        """Write a MultiLayerNetwork to a zip, crash-safely, with a sha256
        manifest of every entry; with `save_updater`, its updater state
        too."""
        meta = {"kind": type(model).__name__,
                "iteration_count": model.iteration_count,
                "epoch_count": model.epoch_count,
                "format_version": 1}
        entries = [(ModelSerializer.CONFIG, model.conf.to_json().encode()),
                   (ModelSerializer.COEFFICIENTS,
                    _savez(tree_to_arrays(model.params))),
                   (ModelSerializer.NETWORK_STATE,
                    _savez(tree_to_arrays(model.state)))]
        if save_updater and model.updater_state is not None:
            entries.append((ModelSerializer.UPDATER_STATE,
                            _savez(tree_to_arrays(model.updater_state))))
        entries.append((ModelSerializer.METADATA, json.dumps(meta).encode()))
        manifest = {"sha256": {name: sha256_hex(data)
                               for name, data in entries},
                    "format_version": 1}
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for name, data in entries:
                z.writestr(name, data)
            z.writestr(ModelSerializer.MANIFEST, json.dumps(manifest))
        atomic_replace(path, buf.getvalue())

    @staticmethod
    def _read_verified(path: str) -> Dict[str, bytes]:
        """Every entry, checked against the manifest (zips without one
        pass: there is nothing to check against)."""
        with zipfile.ZipFile(path) as z:
            entries = {n: z.read(n) for n in z.namelist()}
        raw = entries.pop(ModelSerializer.MANIFEST, None)
        if raw is None:
            return entries
        want = json.loads(raw.decode()).get("sha256", {})
        missing = set(want) - set(entries)
        if missing:
            raise CorruptCheckpointError(
                f"{path}: manifest lists entries missing from the zip: "
                f"{sorted(missing)}")
        for name in sorted(entries):
            if name in want and sha256_hex(entries[name]) != want[name]:
                raise CorruptCheckpointError(
                    f"{path}: sha256 mismatch for entry '{name}' — "
                    "checkpoint is corrupt (torn copy or bit rot)")
        return entries

    @staticmethod
    def restore(path: str, load_updater: bool = True,
                device: DeviceLike = None):
        """Restore a MultiLayerNetwork zip onto `device` (the GPU unless
        the caller asks for the CPU): parameters, layer state, and with
        `load_updater` its updater state where the zip has one (else the
        updater's zero state)."""
        from ..nn.conf import MultiLayerConfiguration
        from ..nn.multilayer import MultiLayerNetwork

        entries = ModelSerializer._read_verified(path)
        meta = json.loads(entries[ModelSerializer.METADATA].decode())
        if meta.get("kind", "MultiLayerNetwork") != "MultiLayerNetwork":
            raise NotImplementedError(
                f"{path}: a {meta['kind']} checkpoint; the PyTorch port "
                "restores MultiLayerNetwork only")
        conf = MultiLayerConfiguration.from_json(
            entries[ModelSerializer.CONFIG].decode())
        model = MultiLayerNetwork(conf, device=device).init()
        model.params = arrays_to_tree(
            model.params, _loadz(entries[ModelSerializer.COEFFICIENTS]))
        if ModelSerializer.NETWORK_STATE in entries:
            model.state = arrays_to_tree(
                model.state, _loadz(entries[ModelSerializer.NETWORK_STATE]))
        if load_updater and ModelSerializer.UPDATER_STATE in entries:
            model.updater_state = arrays_to_tree(
                model.updater_state,
                _loadz(entries[ModelSerializer.UPDATER_STATE]))
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        return model
