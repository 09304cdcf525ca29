"""Inference HTTP plane: the registry, per-model dynamic batchers and
generation schedulers behind a threaded stdlib server (the port of
`deeplearning4j_tpu/serving/server.py`: the same paths, JSON keys, headers
and status codes).

Endpoints
    GET  /v1/models                   -> {"models": [info, ...]}
    GET  /v1/models/<name>            -> info
    POST /v1/models/<name>/predict    {"features": [[...]], "batched": bool?}
                                      -> {"output": ..., "version": N,
                                          "batched": bool}
    POST /v1/models/<name>/swap       {"source": "/ckpt.zip"|dir,
                                       "precision"?, "buckets"?,
                                       "input_shape"?}
                                      -> {"model":, "version":, ...}
    POST /v1/models/<name>/generate   {"prompt": [ids], "max_tokens"?,
                                       "temperature"?, "stop"?: [ids],
                                       "seed"?}
                                      -> {"tokens": [ids],
                                          "finish_reason": ..., ...}
    GET  /v1/models/<name>/canary     -> {"active": bool, "version"?,
                                          "fraction"?, "arms"?: {...}}
    POST /v1/models/<name>/canary     {"action": "start"|"promote"|
                                       "rollback", "source"? (start),
                                       "fraction"?, "precision"?,
                                       "buckets"?, "input_shape"?}
                                      -> candidate/stable info

Canary routing: while a canary is active (started through the registry's
`start_canary` or via POST /canary), a deterministic fraction
of predict/generate traffic serves on the candidate version through its
OWN batcher/scheduler (per-arm queues: retiring the candidate never
touches in-flight stable requests), and every request's latency, error,
and SLO-breach outcome is observed per arm into the registry's
CanaryState — the signal that drives automatic promotion or rollback.
    GET  /healthz                     -> {"status": "ok", "models": {...}}
    GET  /metrics                     -> Prometheus text (0.0.4)
    GET  /debug/flightrecord          -> flight-recorder view: last guard
                                         dump + the live event ring

Tracing: every request gets a `TraceContext` (trace id + SLO tier from
the `X-DL4J-SLO-Tier` header); the trace id comes back on EVERY
response as the `X-DL4J-Trace` header and inside every structured error
body, and the request's spans (root + queue_wait/bucket_select/prefill/
decode_tick/scatter through the batching planes) land in the active
telemetry session's Tracer as one connected Perfetto track. Latency is
also observed per tier into the SLO surface (`dl4j_slo_latency_seconds`,
`dl4j_slo_burn_rate`).

Error semantics: 400 + {"error": ...} for client mistakes (malformed
JSON, missing keys, shape mismatches, unknown precision), 404 for
unknown models/paths, 503 while shutting down, 500 only for genuine
server faults. Hot-swap via POST /swap builds and warms the incoming
version (and captures its decode graphs on the card) entirely off the
request path and flips atomically — concurrent predicts never fail or
observe a version decrease during a swap.

The server runs on the registry's device: the GPU unless the caller passes
`device="cpu"` (`--device cpu` on the command line).
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from ..telemetry.recorder import flight_recorder
from ..telemetry.trace_context import DEFAULT_TIER, SloSurface, TraceContext
from ..util.platform import DeviceLike
from .batcher import BatcherClosedError, DynamicBatcher
from .decode.scheduler import GenerationScheduler
from .registry import (ModelRegistry, ServingError, UnknownModelError,
                       _validate_features)

__all__ = ["InferenceServer", "ClientError"]

_MODEL_PATH = re.compile(
    r"^/v1/models/([^/]+)(?:/(predict|swap|generate|canary))?$")


class _HTTPServer(ThreadingHTTPServer):
    """The stdlib threaded server with a listen backlog for many clients:
    the default of 5 overflows under a few dozen concurrent connections,
    and the kernel then drops connection attempts, which their clients
    retry only after seconds."""

    request_queue_size = 128


class ClientError(ValueError):
    """Request the client got wrong -> HTTP 400 with a structured body."""


def parse_json_body(handler: BaseHTTPRequestHandler) -> Dict:
    """Read+parse a JSON request body; client mistakes raise ClientError
    (-> 400), never a bare exception (-> 500)."""
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
    """HTTP front end over a ModelRegistry with per-model dynamic
    batching. `batching=False` serves every request on the direct
    (chunk + pad) path — the bench's unbatched arm. Without a `registry`,
    it makes one on `device` (the GPU unless the caller passes
    `device="cpu"`)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 batching: bool = True, max_wait_us: int = 2000,
                 max_batch: Optional[int] = None,
                 slo_targets: Optional[Dict[str, float]] = None,
                 device: DeviceLike = None):
        self.registry = (registry if registry is not None
                         else ModelRegistry(device=device))
        self.batching = bool(batching)
        self.max_wait_us = int(max_wait_us)
        self.max_batch = max_batch
        # both maps are keyed (model name, arm): per-arm queues mean a
        # canary promote/rollback retires the candidate's batcher and
        # scheduler without ever touching in-flight stable requests
        self._batchers: Dict[Tuple[str, str], DynamicBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._schedulers: Dict[Tuple[str, str], GenerationScheduler] = {}
        self._sched_opts: Dict[str, Dict] = {}
        self._stopping = False
        self._started_at = time.time()
        m = self.registry.metrics
        self._requests = m.counter(
            "dl4j_serving_requests_total",
            "serving HTTP requests by endpoint and status code",
            labels=("model", "endpoint", "code"))
        self._latency = m.histogram(
            "dl4j_serving_latency_seconds",
            "request latency through the serving data plane (queue wait + "
            "forward) by path", labels=("model", "path"))
        self.slo = SloSurface(m, targets=slo_targets)
        self._httpd = _HTTPServer((host, port), self._make_handler())
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- data plane (also driven directly by serving/bench.py) ----------
    def _batcher(self, name: str, arm: str = "stable") -> DynamicBatcher:
        b = self._batchers.get((name, arm))  # GIL-atomic fast path, no mutex
        if b is not None:
            return b
        with self._batchers_lock:
            if self._stopping:
                # an in-flight request racing stop() must not install a
                # fresh batcher after the drain pass — its worker would
                # leak. Checked INSIDE the lock: stop() sets the flag
                # before taking this lock for the drain, so a creator
                # either finishes first (and gets drained) or sees it
                raise BatcherClosedError("server is stopping")
            b = self._batchers.get((name, arm))
            if b is None:
                reg = self.registry

                def runner(x_padded, bucket, _name=name, _arm=arm):
                    # per-flush arm resolution: a canary batcher serves
                    # the candidate while one is active and falls back
                    # to stable the moment it is promoted/rolled back
                    v = reg.arm_version(_name, _arm)
                    if bucket in v.buckets:
                        return v.run_padded(x_padded, bucket), v.version
                    # a swap changed the bucket set between enqueue and
                    # flush: serve via the direct path (pad rows ride
                    # along; the batcher scatters only the real rows)
                    return reg.predict(_name, x_padded, arm=_arm)

                v = reg.arm_version(name, arm)
                b = DynamicBatcher(
                    runner,
                    bucket_for=lambda rows, _n=name, _a=arm:
                        reg.arm_version(_n, _a).bucket_for(rows),
                    # clamped: a flush can never exceed the largest
                    # compiled bucket, and requests beyond it must route
                    # to the direct path (which chunks) instead
                    max_batch=min(self.max_batch or v.buckets[-1],
                                  v.buckets[-1]),
                    max_wait_us=self.max_wait_us,
                    name=name if arm == "stable" else f"{name}:{arm}",
                    metrics=reg.metrics, buckets=v.buckets, arm=arm)
                self._batchers[(name, arm)] = b
            return b

    # -- generation plane ------------------------------------------------
    def enable_generation(self, name: str, arm: str = "stable",
                          **opts) -> GenerationScheduler:
        """Attach a GenerationScheduler (continuous batching + paged KV
        cache) to servable `name`. `opts` pass through to the scheduler
        (mode, block_len, num_blocks, kv_dtype, decode_buckets, ...).
        Idempotent for a given (name, arm); called lazily with defaults
        by the first /generate request if never called explicitly. The
        stable arm's opts are remembered so a canary scheduler created
        lazily for candidate traffic mirrors them."""
        with self._batchers_lock:
            if self._stopping:
                raise BatcherClosedError("server is stopping")
            sched = self._schedulers.get((name, arm))
            if sched is None:
                if arm == "stable":
                    self._sched_opts[name] = dict(opts)
                sched = GenerationScheduler(
                    self.registry, name, metrics=self.registry.metrics,
                    arm=arm, **opts)
                self._schedulers[(name, arm)] = sched
            return sched

    def disable_generation(self, name: str):
        """Drain and detach `name`'s schedulers, both arms (bench windows
        swap continuous/static schedulers on one server this way)."""
        with self._batchers_lock:
            scheds = [self._schedulers.pop((name, a), None)
                      for a in ("stable", "canary")]
            self._sched_opts.pop(name, None)
        for sched in scheds:
            if sched is not None:
                sched.stop(drain=True)

    def generate(self, name: str, prompt, *, max_tokens: int = 16,
                 temperature: float = 0.0, stop=(), seed=None,
                 timeout: Optional[float] = None, ctx=None) -> Dict:
        self.registry.get(name)                     # -> 404 if unknown
        arm = self.registry.route_arm(name)
        sched = self._schedulers.get((name, arm))
        if sched is None:
            # canary decode traffic mirrors the stable scheduler's opts
            sched = self.enable_generation(
                name, arm=arm,
                **(self._sched_opts.get(name, {}) if arm != "stable"
                   else {}))
        t0 = time.perf_counter()
        try:
            res = sched.submit(prompt, max_tokens=max_tokens,
                               temperature=temperature, stop=stop,
                               seed=seed, timeout=timeout, ctx=ctx)
        except BaseException:
            self._observe_arm(name, arm, time.perf_counter() - t0, ctx,
                              error=True)
            raise
        self._observe_arm(name, arm, time.perf_counter() - t0, ctx,
                          error=False)
        return res

    def predict(self, name: str, features, batched: Optional[bool] = None,
                ctx=None) -> Tuple[np.ndarray, int, str]:
        """(outputs, version, path) where path is 'batched' | 'direct'.
        Oversize requests (rows > largest bucket) always go direct — the
        direct path chunks; the batcher never splits a request. While a
        canary is active, a deterministic fraction of requests serves on
        the candidate arm, and every request's latency/error/SLO-breach
        outcome feeds the canary's per-arm stats."""
        v = self.registry.get(name)                 # -> 404 if unknown
        try:
            x = _validate_features(v, features)
        except ServingError as e:
            raise ClientError(str(e)) from None
        arm = self.registry.route_arm(name)
        use_batch = self.batching if batched is None else bool(batched)
        t0 = time.perf_counter()
        try:
            out, version, path = self._predict_arm(name, x, arm,
                                                   use_batch, ctx)
        except BaseException:
            self._observe_arm(name, arm, time.perf_counter() - t0, ctx,
                              error=True)
            raise
        self._observe_arm(name, arm, time.perf_counter() - t0, ctx,
                          error=False)
        return out, version, path

    def _predict_arm(self, name: str, x: np.ndarray, arm: str,
                     use_batch: bool, ctx) -> Tuple[np.ndarray, int, str]:
        path, batcher = "direct", None
        if use_batch:
            batcher = self._batcher(name, arm)
            # route by the BATCHER's own row budget (it may be smaller
            # than the largest bucket, or stale after a bucket-changing
            # swap) — oversize requests go direct, which chunks, instead
            # of bouncing off submit()'s max_batch validation
            if x.shape[0] <= batcher.max_batch:
                path = "batched"
        with self._latency.time(model=name, path=path):
            if path == "batched":
                try:
                    out, version = batcher.submit(x, ctx=ctx)
                except BatcherClosedError:
                    if arm == "canary" and not self._stopping:
                        # the canary batcher was retired by a concurrent
                        # promote/rollback — fall back to the stable arm
                        # rather than fail an accepted request
                        out, version = self._batcher(name).submit(x, ctx=ctx)
                    else:
                        raise
            else:
                if ctx is not None:
                    with ctx.span("direct_forward", model=name,
                                  rows=int(x.shape[0]), arm=arm):
                        out, version = self.registry.predict(name, x,
                                                             arm=arm)
                else:
                    out, version = self.registry.predict(name, x, arm=arm)
        return out, version, path

    def _observe_arm(self, name: str, arm: str, dt: float, ctx,
                     error: bool):
        """Feed one request outcome into the live canary's per-arm stats
        (latency, error, SLO breach against the request's tier target).
        No-op when no canary is active."""
        if self.registry.canary_state(name) is None:
            return
        tier = ctx.tier if ctx is not None else DEFAULT_TIER
        target = self.slo.targets.get(tier)
        self.registry.observe_canary(
            name, arm, latency_s=dt, error=error,
            breach=target is not None and dt > target)

    def _canary_started(self, name: str):
        """With generation enabled on `name`, start the candidate arm's
        scheduler now (capturing its graphs on the card), not on the first
        request routed to it."""
        if (name, "stable") in self._schedulers:
            self.enable_generation(name, arm="canary",
                                   **self._sched_opts.get(name, {}))

    def _retire_canary(self, name: str):
        """Drain and drop the candidate arm's batcher/scheduler after a
        promote or rollback. In-flight canary requests finish first (the
        runner resolves through `arm_version`, which already falls back
        to the post-decision version); requests racing the retirement
        fall back to the stable batcher."""
        with self._batchers_lock:
            b = self._batchers.pop((name, "canary"), None)
            s = self._schedulers.pop((name, "canary"), None)
        if b is not None:
            b.stop(drain=True)
        if s is not None:
            s.stop(drain=True)

    # -- HTTP plumbing ---------------------------------------------------
    def _make_handler(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet
                pass

            def _reply(self, code: int, payload, content_type=None,
                       endpoint="", model=""):
                ctx = getattr(self, "_trace_ctx", None)
                if (ctx is not None and isinstance(payload, dict)
                        and "error" in payload):
                    # every structured error body carries the trace id so
                    # a client-side failure correlates with server spans
                    payload = dict(payload, trace_id=ctx.trace_id)
                if isinstance(payload, (dict, list)):
                    data = json.dumps(payload).encode()
                    content_type = content_type or "application/json"
                else:
                    data = payload if isinstance(payload, bytes) \
                        else str(payload).encode()
                    content_type = content_type or "text/plain"
                if ctx is not None:
                    # root span + SLO observation land BEFORE the response
                    # bytes: a client that reads the tracer the moment its
                    # request returns always finds the connected trace
                    ctx.emit_root(f"http/{endpoint or 'other'}",
                                  code=code, model=model)
                    srv.slo.observe(ctx.tier, ctx.elapsed())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                if ctx is not None:
                    self.send_header("X-DL4J-Trace", ctx.trace_id)
                if code >= 400:
                    # error paths may not have consumed the request body;
                    # leaving it unread on an HTTP/1.1 keep-alive socket
                    # desynchronizes every later request on it — close
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(data)
                srv._requests.inc(model=model, endpoint=endpoint or "other",
                                  code=str(code))

            def _dispatch(self, method: str):
                endpoint, model = "other", ""
                self._trace_ctx = ctx = TraceContext.begin(
                    tier=self.headers.get("X-DL4J-SLO-Tier", DEFAULT_TIER))
                try:
                    m = _MODEL_PATH.match(self.path)
                    if self.path == "/healthz" and method == "GET":
                        endpoint = "healthz"
                        self._reply(200, srv.health(), endpoint=endpoint)
                    elif (self.path.partition("?")[0] == "/debug/flightrecord"
                            and method == "GET"):
                        endpoint = "flightrecord"
                        rec = flight_recorder()
                        self._reply(200,
                                    {"enabled": rec.enabled,
                                     "capacity": rec.capacity,
                                     "total_events": rec.total_written(),
                                     "last_dump": rec.last_dump,
                                     "events": rec.snapshot()},
                                    endpoint=endpoint)
                    elif self.path == "/metrics" and method == "GET":
                        endpoint = "metrics"
                        self._reply(
                            200, srv.registry.metrics.prometheus_text(),
                            content_type=(
                                "text/plain; version=0.0.4; charset=utf-8"),
                            endpoint=endpoint)
                    elif self.path == "/v1/models" and method == "GET":
                        endpoint = "models"
                        self._reply(200, {"models": srv.registry.models()},
                                    endpoint=endpoint)
                    elif m and m.group(2) is None and method == "GET":
                        endpoint, model = "model", m.group(1)
                        self._reply(200, srv.registry.get(model).info(),
                                    endpoint=endpoint, model=model)
                    elif m and m.group(2) == "predict" and method == "POST":
                        endpoint, model = "predict", m.group(1)
                        body = parse_json_body(self)
                        out, version, path = srv.predict(
                            model, require(body, "features"),
                            batched=body.get("batched"), ctx=ctx)
                        self._reply(200, {"model": model,
                                          "version": version,
                                          "batched": path == "batched",
                                          "output": out.tolist()},
                                    endpoint=endpoint, model=model)
                    elif m and m.group(2) == "generate" and method == "POST":
                        endpoint, model = "generate", m.group(1)
                        body = parse_json_body(self)
                        try:
                            prompt = [int(t) for t in require(body, "prompt")]
                            max_tokens = int(body.get("max_tokens", 16))
                            temperature = float(body.get("temperature", 0.0))
                            stop = [int(t) for t in (body.get("stop") or ())]
                            seed = body.get("seed")
                            seed = None if seed is None else int(seed)
                        except ClientError:
                            raise
                        except (TypeError, ValueError) as e:
                            raise ClientError(
                                f"invalid generate parameters: {e}") \
                                from None
                        with srv._latency.time(model=model, path="generate"):
                            res = srv.generate(
                                model, prompt, max_tokens=max_tokens,
                                temperature=temperature, stop=stop,
                                seed=seed, ctx=ctx)
                        self._reply(200, dict(
                            model=model,
                            version=srv.registry.get(model).version, **res),
                            endpoint=endpoint, model=model)
                    elif m and m.group(2) == "swap" and method == "POST":
                        endpoint, model = "swap", m.group(1)
                        body = parse_json_body(self)
                        try:
                            v = srv.registry.swap(
                                model, require(body, "source"),
                                precision=body.get("precision"),
                                buckets=body.get("buckets"),
                                input_shape=body.get("input_shape"))
                        except (TypeError, ValueError) as e:
                            # non-numeric buckets/input_shape etc. are
                            # the client's mistake, not a server fault
                            raise ClientError(
                                f"invalid swap parameters: {e}") from None
                        self._reply(200, v.info(), endpoint=endpoint,
                                    model=model)
                    elif m and m.group(2) == "canary" and method == "GET":
                        endpoint, model = "canary", m.group(1)
                        srv.registry.get(model)     # -> 404 if unknown
                        cs = srv.registry.canary_state(model)
                        payload = {"model": model, "active": cs is not None}
                        if cs is not None:
                            payload.update(cs.stats())
                        self._reply(200, payload, endpoint=endpoint,
                                    model=model)
                    elif m and m.group(2) == "canary" and method == "POST":
                        endpoint, model = "canary", m.group(1)
                        body = parse_json_body(self)
                        action = require(body, "action")
                        if action == "start":
                            try:
                                v = srv.registry.start_canary(
                                    model, require(body, "source"),
                                    fraction=float(
                                        body.get("fraction", 0.1)),
                                    precision=body.get("precision"),
                                    buckets=body.get("buckets"),
                                    input_shape=body.get("input_shape"))
                            except ClientError:
                                raise
                            except (TypeError, ValueError) as e:
                                raise ClientError(
                                    f"invalid canary parameters: {e}") \
                                    from None
                            srv._canary_started(model)
                            self._reply(200, dict(v.info(), canary=True),
                                        endpoint=endpoint, model=model)
                        elif action == "promote":
                            v = srv.registry.promote_canary(model)
                            srv._retire_canary(model)
                            self._reply(200, dict(v.info(), promoted=True),
                                        endpoint=endpoint, model=model)
                        elif action == "rollback":
                            v = srv.registry.rollback_canary(model)
                            srv._retire_canary(model)
                            self._reply(200,
                                        dict(v.info(), rolled_back=True),
                                        endpoint=endpoint, model=model)
                        else:
                            raise ClientError(
                                f"unknown canary action {action!r}; "
                                "expected start|promote|rollback")
                    else:
                        self._reply(404, {"error": f"unknown path "
                                          f"{method} {self.path}"},
                                    endpoint=endpoint, model=model)
                except UnknownModelError as e:
                    self._reply(404, {"error": f"unknown model "
                                      f"{e.args[0]!r}"},
                                endpoint=endpoint, model=model)
                except (ClientError, ServingError) as e:
                    self._reply(400, {"error": str(e)},
                                endpoint=endpoint, model=model)
                except (BatcherClosedError, TimeoutError) as e:
                    self._reply(503, {"error": str(e)},
                                endpoint=endpoint, model=model)
                except Exception as e:   # genuine server fault
                    self._reply(500, {"error":
                                      f"{type(e).__name__}: {e}"},
                                endpoint=endpoint, model=model)

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
        """Stop accepting connections, then drain batchers (accepted
        requests finish). The _stopping flag closes the race where an
        in-flight handler would lazily recreate a batcher after the
        drain pass."""
        self._stopping = True
        if self._thread is not None:
            # shutdown() handshakes with serve_forever — calling it when
            # the serve thread never started blocks forever
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        with self._batchers_lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
            schedulers = list(self._schedulers.values())
            self._schedulers.clear()
        for b in batchers:
            b.stop(drain=True)
        for s in schedulers:
            s.stop(drain=True)
        self._httpd.server_close()
        self._thread = None


def _smoke(device: DeviceLike = None) -> int:
    """End-to-end smoke: ephemeral port, register, predict (batched and
    direct), hot-swap, generate, scrape /metrics, clean shutdown, on
    `device` (the GPU by default). Prints PASS/FAIL, returns an exit
    code."""
    import tempfile
    import urllib.request

    import torch

    from .. import (EmbeddingSequenceLayer, InputType, MultiLayerNetwork,
                    NeuralNetConfiguration, RnnOutputLayer, TransformerBlock)
    from ..models.zoo import mlp_mnist
    from ..util.serializer import ModelSerializer

    def http(method, url, body=None, timeout=60):
        req = urllib.request.Request(
            url, None if body is None else json.dumps(body).encode(),
            {"Content-Type": "application/json"}, method=method)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ct = resp.headers.get("Content-Type", "")
            data = resp.read()
            return json.loads(data) if "json" in ct else data.decode()

    def mlp(seed):
        return mlp_mnist(seed=seed, device=device).init(
            generator=torch.Generator().manual_seed(seed))

    srv = InferenceServer(device=device).start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        srv.registry.register("mnist", mlp(3), buckets=(1, 8))
        x = np.zeros((3, 784), np.float32).tolist()
        out = http("POST", f"{base}/v1/models/mnist/predict",
                   {"features": x})
        assert np.asarray(out["output"]).shape == (3, 10), out
        assert out["version"] == 1 and out["batched"], out
        with tempfile.TemporaryDirectory() as d:
            ckpt = f"{d}/swap.zip"
            ModelSerializer.write_model(mlp(4), ckpt)
            info = http("POST", f"{base}/v1/models/mnist/swap",
                        {"source": ckpt})
        assert info["version"] == 2, info
        out = http("POST", f"{base}/v1/models/mnist/predict",
                   {"features": x, "batched": False})
        assert out["version"] == 2 and not out["batched"], out
        b = (NeuralNetConfiguration.builder().seed(5).list()
             .layer(EmbeddingSequenceLayer(n_in=32, n_out=32)))
        for _ in range(2):
            b = b.layer(TransformerBlock(n_heads=4))
        conf = (b.layer(RnnOutputLayer(n_out=32, activation="softmax",
                                       loss="mcxent"))
                .set_input_type(InputType.recurrent(1, 64)).build())
        lm = MultiLayerNetwork(conf, device=device).init(
            generator=torch.Generator().manual_seed(5))
        srv.registry.register("lm", lm, buckets=(1,))
        srv.enable_generation("lm", block_len=8, decode_buckets=(1, 2))
        gen = http("POST", f"{base}/v1/models/lm/generate",
                   {"prompt": [1, 2, 3], "max_tokens": 8})
        assert len(gen["tokens"]) == 8 and gen["finish_reason"] == "length"
        metrics = http("GET", f"{base}/metrics")
        for family in ("dl4j_serving_requests_total",
                       "dl4j_serving_swaps_total",
                       "dl4j_serving_latency_seconds",
                       "dl4j_decode_tokens_total"):
            assert family in metrics, f"{family} missing from /metrics"
        health = http("GET", f"{base}/healthz")
        assert health["status"] == "ok" \
            and health["models"] == {"mnist": 2, "lm": 1}, health
        print("serving smoke: PASS (predict + swap + generate + metrics on "
              f"http://{srv.host}:{srv.port}, {srv.registry.device})")
        return 0
    except AssertionError as e:
        print(f"serving smoke: FAIL — {e}")
        return 1
    finally:
        srv.stop()


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.serving.server --port 8999`
    (`--smoke` runs the end-to-end check and exits; `--device cpu` serves
    on the CPU)."""
    import argparse

    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch.serving."
                                      "server")
    ap.add_argument("--port", type=int, default=8999)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--no-batching", action="store_true")
    ap.add_argument("--model", action="append", default=[], metavar
                    ="NAME=SOURCE", help="register NAME from SOURCE "
                    "(checkpoint zip or directory) at startup")
    ap.add_argument("--smoke", action="store_true",
                    help="run the end-to-end smoke (ephemeral port) and "
                         "exit")
    args = ap.parse_args(argv)
    if args.smoke:
        raise SystemExit(_smoke(args.device))
    srv = InferenceServer(host=args.host, port=args.port,
                          batching=not args.no_batching, device=args.device)
    for spec in args.model:
        name, _, source = spec.partition("=")
        if not source:
            raise SystemExit(f"--model expects NAME=SOURCE, got {spec!r}")
        v = srv.registry.register(name, source)
        print(f"registered '{name}' v{v.version} from {source} "
              f"(buckets {list(v.buckets)}, {v.precision})")
    srv.start()
    print(f"inference server on http://{srv.host}:{srv.port} "
          f"({srv.registry.device})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
