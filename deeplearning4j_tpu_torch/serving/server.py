"""Inference HTTP plane: the registry and per-model dynamic batchers behind a
threaded stdlib server (the port of `deeplearning4j_tpu/serving/server.py`,
same paths, JSON keys and status codes).

Endpoints
    GET  /v1/models                   -> {"models": [info, ...]}
    GET  /v1/models/<name>            -> info
    POST /v1/models/<name>/predict    {"features": [[...]], "batched": bool?}
                                      -> {"model":, "output": ..., "version": N,
                                          "batched": bool}
    POST /v1/models/<name>/swap       {"source": "/ckpt.zip"|dir,
                                       "precision"?, "buckets"?,
                                       "input_shape"?}
                                      -> info of the new version
    GET  /healthz                     -> {"status": "ok", "models": {...}}

400 + {"error": ...} for client mistakes (malformed JSON, missing keys,
shape mismatches, unknown precision), 404 for unknown models and paths, 503
while shutting down, 500 only for genuine server faults. `/generate`,
`/metrics`, canary routing and tracing arrive with later slices.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from ..util.platform import DeviceLike
from .batcher import BatcherClosedError, DynamicBatcher
from .registry import (ModelRegistry, ServingError, UnknownModelError,
                       _validate_features)

__all__ = ["InferenceServer", "ClientError"]

_MODEL_PATH = re.compile(r"^/v1/models/([^/]+)(?:/(predict|swap))?$")


class ClientError(ValueError):
    """Request the client got wrong -> HTTP 400 with a structured body."""


def parse_json_body(handler: BaseHTTPRequestHandler) -> Dict:
    try:
        n = int(handler.headers.get("Content-Length", "0"))
    except ValueError:
        raise ClientError("invalid Content-Length header") from None
    raw = handler.rfile.read(n) if n else b""
    if not raw:
        raise ClientError("empty request body (expected JSON)")
    try:
        body = json.loads(raw)
    except ValueError as e:
        raise ClientError(f"malformed JSON body: {e}") from None
    if not isinstance(body, dict):
        raise ClientError("JSON body must be an object")
    return body


def require(body: Dict, key: str):
    if key not in body:
        raise ClientError(f"missing required key {key!r}")
    return body[key]


class InferenceServer:
    """HTTP front end over a ModelRegistry with per-model dynamic batching.
    `batching=False` serves every request on the direct (chunk + pad)
    path. Without a `registry`, it makes one on `device` (the GPU unless
    the caller passes `device="cpu"`)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 batching: bool = True, max_wait_us: int = 2000,
                 max_batch: Optional[int] = None, device: DeviceLike = None):
        self.registry = (registry if registry is not None
                         else ModelRegistry(device=device))
        self.batching = bool(batching)
        self.max_wait_us = int(max_wait_us)
        self.max_batch = max_batch
        self._batchers: Dict[str, DynamicBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._stopping = False
        self._started_at = time.time()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- data plane ------------------------------------------------------
    def _batcher(self, name: str) -> DynamicBatcher:
        b = self._batchers.get(name)
        if b is not None:
            return b
        with self._batchers_lock:
            if self._stopping:
                raise BatcherClosedError("server is stopping")
            b = self._batchers.get(name)
            if b is None:
                reg = self.registry

                def runner(x_padded, bucket, _name=name):
                    # resolve the version once per flush: every row of a
                    # batch is served by one version
                    v = reg.get(_name)
                    if bucket in v.buckets:
                        return v.run_padded(x_padded, bucket), v.version
                    # a swap changed the bucket set since enqueue
                    return reg.predict(_name, x_padded)

                v = reg.get(name)
                b = DynamicBatcher(
                    runner,
                    bucket_for=lambda rows, _n=name:
                        reg.get(_n).bucket_for(rows),
                    max_batch=min(self.max_batch or v.buckets[-1],
                                  v.buckets[-1]),
                    max_wait_us=self.max_wait_us, name=name,
                    buckets=v.buckets)
                self._batchers[name] = b
            return b

    def predict(self, name: str, features, batched: Optional[bool] = None
                ) -> Tuple[np.ndarray, int, str]:
        """(outputs, version, path) where path is 'batched' | 'direct'.
        Requests larger than the batcher's row budget go direct, which
        chunks them."""
        v = self.registry.get(name)                 # -> 404 if unknown
        try:
            x = _validate_features(v, features)
        except ServingError as e:
            raise ClientError(str(e)) from None
        use_batch = self.batching if batched is None else bool(batched)
        if use_batch:
            batcher = self._batcher(name)
            if x.shape[0] <= batcher.max_batch:
                out, version = batcher.submit(x)
                return out, version, "batched"
        out, version = self.registry.predict(name, x)
        return out, version, "direct"

    # -- HTTP plumbing ---------------------------------------------------
    def _make_handler(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code: int, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if code >= 400:
                    # an error path may leave the request body unread, which
                    # would desynchronize a keep-alive socket
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, method: str):
                try:
                    m = _MODEL_PATH.match(self.path)
                    if self.path == "/healthz" and method == "GET":
                        self._reply(200, srv.health())
                    elif self.path == "/v1/models" and method == "GET":
                        self._reply(200, {"models": srv.registry.models()})
                    elif m and m.group(2) is None and method == "GET":
                        self._reply(200, srv.registry.get(m.group(1)).info())
                    elif m and m.group(2) == "predict" and method == "POST":
                        model = m.group(1)
                        body = parse_json_body(self)
                        out, version, path = srv.predict(
                            model, require(body, "features"),
                            batched=body.get("batched"))
                        self._reply(200, {"model": model, "version": version,
                                          "batched": path == "batched",
                                          "output": out.tolist()})
                    elif m and m.group(2) == "swap" and method == "POST":
                        body = parse_json_body(self)
                        try:
                            v = srv.registry.swap(
                                m.group(1), require(body, "source"),
                                precision=body.get("precision"),
                                buckets=body.get("buckets"),
                                input_shape=body.get("input_shape"))
                        except (TypeError, ValueError) as e:
                            raise ClientError(
                                f"invalid swap parameters: {e}") from None
                        self._reply(200, v.info())
                    else:
                        self._reply(404, {"error": f"unknown path "
                                          f"{method} {self.path}"})
                except UnknownModelError as e:
                    self._reply(404, {"error": f"unknown model {e.args[0]!r}"})
                except (ClientError, ServingError) as e:
                    self._reply(400, {"error": str(e)})
                except (BatcherClosedError, TimeoutError) as e:
                    self._reply(503, {"error": str(e)})
                except Exception as e:   # genuine server fault
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        return Handler

    def health(self) -> Dict:
        return {"status": "ok",
                "models": {n: self.registry.get(n).version
                           for n in self.registry.names()},
                "uptime_s": round(time.time() - self._started_at, 3)}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dl4j-torch-serving-http",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting connections, then drain the batchers (accepted
        requests finish)."""
        self._stopping = True
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        with self._batchers_lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.stop(drain=True)
        self._httpd.server_close()
        self._thread = None
