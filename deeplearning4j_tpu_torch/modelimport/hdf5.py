"""HDF5 archive reader for Keras files (the port of
`deeplearning4j_tpu/modelimport/hdf5.py`).

A thin h5py wrapper that understands both the Keras 2 layout
(`model_weights/<layer>/<weight_names attr>`) and the Keras 3 legacy-H5
layout (same attrs, nested groups). h5py is imported when an archive is
opened, so the package imports without it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Hdf5Archive"]


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


class Hdf5Archive:
    def __init__(self, path: str):
        import h5py

        self._f = h5py.File(path, "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- config ---------------------------------------------------------
    def model_config(self) -> Dict:
        """Parsed JSON of the `model_config` root attribute."""
        raw = self._f.attrs.get("model_config")
        if raw is None:
            raise ValueError("No model_config attribute — not a Keras "
                             "whole-model HDF5 file")
        return json.loads(_decode(raw))

    def training_config(self) -> Optional[Dict]:
        raw = self._f.attrs.get("training_config")
        return None if raw is None else json.loads(_decode(raw))

    def keras_version(self) -> Optional[str]:
        g = self._f["model_weights"] if "model_weights" in self._f else self._f
        v = g.attrs.get("keras_version")
        return None if v is None else _decode(v)

    # -- weights --------------------------------------------------------
    def _weights_root(self):
        return (self._f["model_weights"] if "model_weights" in self._f
                else self._f)

    def layer_names(self) -> List[str]:
        root = self._weights_root()
        names = root.attrs.get("layer_names")
        if names is not None:
            return [_decode(n) for n in names]
        return list(root.keys())

    def layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        """{short_weight_name: array} for one layer. Short name is the final
        path component with any ':0' suffix stripped (kernel, bias, gamma,
        beta, moving_mean, moving_variance, ...)."""
        root = self._weights_root()
        if layer_name not in root:
            return {}
        g = root[layer_name]
        weight_names = g.attrs.get("weight_names")
        out: Dict[str, np.ndarray] = {}
        if weight_names is not None:
            for wn in weight_names:
                wn = _decode(wn)
                arr = np.asarray(g[wn])
                short = wn.split("/")[-1].split(":")[0]
                out[short] = arr
            return out
        # fallback: walk the group
        def walk(grp, prefix=""):
            for k in grp:
                item = grp[k]
                if hasattr(item, "keys"):
                    walk(item, prefix + k + "/")
                else:
                    out[k.split(":")[0]] = np.asarray(item)
        walk(g)
        return out
