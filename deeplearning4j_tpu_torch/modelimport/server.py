"""Keras backend server (the port of `deeplearning4j_tpu/modelimport/server.py`;
the reference's deeplearning4j-keras: a py4j `GatewayServer`, `Server.java`,
exposing `DeepLearning4jEntryPoint.fit()`, with `HDF5MiniBatchDataSetIterator`
and `NDArrayHDF5Reader` doing the IO).

A plain HTTP JSON API (stdlib http.server, listen backlog 128 as the
serving plane's):

    POST /fit    {"model": "/path/model.h5", "data_dir": "...",
                  "epochs": 1, "save_to": "..."}   -> trains
    POST /output {"model": "/path/model.h5", "features": [[...]]}
                                                   -> predictions
    GET  /ping                                     -> {"status": "ok"}

`/output` is served by the port's `serving.ModelRegistry`: a model is
imported and registered (its buckets warmed) once, on first use, and
concurrent requests run through the registry's runners without a global
lock. `/fit` serializes training under a fit lock, then hot-swaps the
registry version. Models live on the registry's device, the GPU unless the
caller passes `device="cpu"`.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler
from typing import Dict, Optional

import numpy as np

from ..datasets.iterators import DataSet, DataSetIterator
from ..util.platform import DeviceLike

__all__ = ["NDArrayHDF5Reader", "HDF5MiniBatchDataSetIterator",
           "DeepLearning4jEntryPoint", "KerasBackendServer"]


class NDArrayHDF5Reader:
    """Read one dataset from an HDF5 file into numpy
    (`NDArrayHDF5Reader.java` analog)."""

    def read(self, path: str, dataset: str = "data") -> np.ndarray:
        import h5py

        with h5py.File(path, "r") as f:
            if dataset not in f:
                # fall back to the first dataset in the file
                keys = list(f.keys())
                if not keys:
                    raise KeyError(f"{path}: empty HDF5 file")
                dataset = keys[0]
            return np.asarray(f[dataset])


class HDF5MiniBatchDataSetIterator(DataSetIterator):
    """Iterates a directory of HDF5 minibatch files
    (`HDF5MiniBatchDataSetIterator.java` analog). Each file holds
    `features` and `labels` datasets; files iterate in sorted order."""

    def __init__(self, data_dir: str, features_key: str = "features",
                 labels_key: str = "labels"):
        self.data_dir = data_dir
        self.features_key = features_key
        self.labels_key = labels_key
        self._files = sorted(
            os.path.join(data_dir, f) for f in os.listdir(data_dir)
            if f.endswith((".h5", ".hdf5")))
        if not self._files:
            raise FileNotFoundError(f"no .h5 minibatches in {data_dir!r}")
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._files)

    def next(self) -> DataSet:
        import h5py

        path = self._files[self._pos]
        self._pos += 1
        with h5py.File(path, "r") as f:
            x = np.asarray(f[self.features_key], np.float32)
            y = np.asarray(f[self.labels_key], np.float32)
        return DataSet(x, y)

    def batch(self) -> int:
        import h5py

        with h5py.File(self._files[0], "r") as f:
            return int(f[self.features_key].shape[0])


class DeepLearning4jEntryPoint:
    """The fit/predict entry point (`DeepLearning4jEntryPoint.java:21`).

    `_cache_lock` guards only the model cache's lookup and import, and
    `_fit_lock` serializes training (two concurrent fits on one network
    would interleave weight updates). Inference takes neither across the
    forward: concurrent `/output` requests run in parallel through the
    serving registry.

    `/output` routes through a `serving.ModelRegistry` (one on `device`
    unless `registry` is given): the model is imported and its buckets
    warmed once, at first use, and a completed `/fit` hot-swaps the
    registry version so predictions follow training."""

    def __init__(self, registry=None, device: DeviceLike = None):
        if registry is None:
            from ..serving import ModelRegistry
            registry = ModelRegistry(device=device)
        self.registry = registry
        self._models: Dict[str, object] = {}
        self._cache_lock = threading.Lock()
        self._fit_lock = threading.Lock()

    def _load(self, model_path: str):
        """Cache lookup/load — the ONLY thing the cache lock covers."""
        with self._cache_lock:
            net = self._models.get(model_path)
            if net is None:
                from .keras import import_keras_sequential_model_and_weights
                net = self._models[model_path] = \
                    import_keras_sequential_model_and_weights(
                        model_path, device=self.registry.device)
            return net

    def fit(self, model_path: str, data_dir: str, epochs: int = 1,
            save_to: Optional[str] = None) -> Dict:
        net = self._load(model_path)
        with self._fit_lock:
            it = HDF5MiniBatchDataSetIterator(data_dir)
            net.fit(it, epochs=int(epochs))
            if save_to:
                from ..util.serializer import ModelSerializer
                ModelSerializer.write_model(net, save_to)
            result = {"status": "ok", "score": float(net.score()),
                      "iterations": int(net.iteration_count)}
        if model_path in self.registry:
            # hot-swap the served snapshot so /output reflects the fit;
            # same architecture -> the registry reuses its executables.
            # Keep the served input shape: configs without a derivable
            # one were registered with a request-inferred shape, and the
            # swap must not fail a fit that succeeded
            served = self.registry.get(model_path)
            self.registry.swap(model_path, net,
                               input_shape=served.example_shape)
        return result

    def _ensure_served(self, model_path: str, net, features: np.ndarray):
        from ..serving import ServingError
        try:
            return self.registry.ensure(model_path, net)
        except ServingError:
            # model config declares no fixed input shape (some imported
            # configs) — fall back to the request's trailing shape
            return self.registry.ensure(model_path, net,
                                        input_shape=features.shape[1:])

    def output(self, model_path: str, features) -> np.ndarray:
        net = self._load(model_path)
        features = np.asarray(features, np.float32)
        if features.ndim == 1:
            features = features[None]
        v = self._ensure_served(model_path, net, features)
        if tuple(features.shape[1:]) != v.example_shape:
            # the legacy contract accepts shape-varying requests (e.g.
            # variable-length sequences into an RNN import); the serving
            # plane warms fixed buckets, so off-shape requests take the
            # direct net.output() path (still with no global lock)
            out = net.output(features).detach()
            return out.float().cpu().numpy()
        out, _ = self.registry.predict(model_path, features)
        return out


class KerasBackendServer:
    """HTTP control server wrapping the entry point (`Server.java:15`).

    Error semantics match the serving plane (`serving/server.py`): a
    client mistake (malformed JSON, missing keys, bad shapes, nonexistent
    model path) is 400 with a structured `{"error": ...}` body; 500 is
    reserved for genuine server faults."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry=None, device: DeviceLike = None):
        from ..serving import ServingError
        from ..serving.server import (ClientError, _HTTPServer,
                                      parse_json_body, require)

        entry = self.entry_point = DeepLearning4jEntryPoint(
            registry=registry, device=device)
        self.registry = entry.registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code: int, payload: Dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/ping":
                    self._reply(200, {"status": "ok"})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                try:
                    if self.path not in ("/fit", "/output"):
                        self._reply(404,
                                    {"error": f"unknown path {self.path}"})
                        return
                    body = parse_json_body(self)
                    if self.path == "/fit":
                        out = entry.fit(require(body, "model"),
                                        require(body, "data_dir"),
                                        body.get("epochs", 1),
                                        body.get("save_to"))
                        self._reply(200, out)
                    else:
                        preds = entry.output(require(body, "model"),
                                             require(body, "features"))
                        self._reply(200, {"output": preds.tolist()})
                except (ClientError, ServingError, FileNotFoundError,
                        ValueError, TypeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:   # genuine server fault
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = _HTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "KerasBackendServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.modelimport.server --port 8998
    [--device cpu]`: the reference's `Server.main` (a gateway on a fixed
    port)."""
    import argparse
    import time

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.modelimport.server")
    ap.add_argument("--port", type=int, default=8998)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    srv = KerasBackendServer(host=args.host, port=args.port,
                             device=args.device).start()
    print(f"Keras backend server on http://{srv.host}:{srv.port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
