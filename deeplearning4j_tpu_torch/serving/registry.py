"""Multi-model registry with versioned atomic hot-swap, reduced-precision
snapshots and canary routing (the port of
`deeplearning4j_tpu/serving/registry.py`).

  * **Warm buckets, no cold work on a request.** Every (model, batch bucket)
    forward runs once at `register()` / `swap()` / `start_canary()` time, on
    zeros, before the version goes live: the kernels are built and loaded
    then, never on a request. (JAX compiles an XLA executable per bucket
    there; PyTorch runs eagerly, so one warm-up forward per bucket takes
    that place.) A warm-up that fails raises `AotCompileError` and leaves
    the live version and the runner cache untouched.
  * **Runners shared across same-architecture swaps.** The forward a bucket
    runs (`_make_forward`: rebuild the parameters from the flat snapshot,
    dequantizing int8 leaves, then the model's pure predict) is cached per
    model under ("fwd", signature, bucket), the signature being the
    snapshot's and state's shapes and dtypes, never the int8 scales (JAX's
    `_abstract_sig`). A same-architecture swap reuses it, so
    `dl4j_serving_compiles_total` counts one build per (model, bucket) as
    JAX counts one compile; the decode plane keeps its step functions in
    the same cache under ("decode", signature, phase, bucket)
    (`compile_cached`).
  * **Atomic hot-swap.** A `ServableVersion` is an immutable snapshot: its
    own copy of the parameters on the registry's device, in the version's
    precision (`fp32`; `bf16`, every float leaf cast; `int8`, weight-only
    per-tensor quantization, `serving/quantize.py`). `swap()` builds and
    warms the new version off the request path, calls the model's version
    listeners (the decode plane captures the new version's CUDA graphs
    there), then flips one pointer under the registry lock. In-flight
    requests finish on the version they hold.
  * **Canary routing.** `start_canary` exposes a candidate version to a
    deterministic fraction of traffic (`CanaryState`) without touching the
    stable version; `promote_canary` / `rollback_canary` end it.
  * **Verified sources.** Zip checkpoints are checked against their sha256
    manifest on restore; a checkpoint directory serves its newest loadable
    `ckpt_*.zip`, skipping corrupt ones; a Keras HDF5 file is imported
    through `ModelGuesser`.

A model is a MultiLayerNetwork or a single-input ComputationGraph (whose
first output is served); a multi-input graph raises `ServingError`. The
metric families are JAX's `dl4j_serving_*`, in `metrics` (the active
telemetry session's registry by default).
"""
from __future__ import annotations

import os
import re
import threading
import time
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.trees import flatten_tree, tree_map
from ..util.platform import DeviceLike, resolve_device
from .quantize import QuantizedTree, cast_tree, quantize_tree

__all__ = ["ModelRegistry", "ServableVersion", "UnknownModelError",
           "ServingError", "AotCompileError", "CanaryState",
           "DEFAULT_BUCKETS", "PRECISIONS", "load_source", "pad_rows"]

DEFAULT_BUCKETS = (1, 8, 32)
PRECISIONS = ("fp32", "bf16", "int8")
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.zip$")


class ServingError(RuntimeError):
    """Client-facing serving failure (bad shape, unknown precision, ...)."""


class AotCompileError(ServingError):
    """A candidate version failed to build at `swap()` / `start_canary()` /
    `promote_canary()` time: a bucket's warm-up forward, or a decode
    listener's CUDA-graph capture. Carries the model name, the bucket (or
    the decode phase) that failed and the underlying exception. The failed
    build is discarded whole: the live version keeps serving and the
    runner cache holds nothing of the candidate."""

    def __init__(self, model: str, bucket, cause: BaseException):
        self.model = model
        self.bucket = bucket
        self.cause = cause
        super().__init__(
            f"{model}: AOT compile failed for bucket {bucket}: "
            f"{type(cause).__name__}: {cause}")


class UnknownModelError(KeyError):
    """Request for a model name the registry doesn't hold."""


def pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    """Append `n_pad` zero rows along axis 0 (pad-to-bucket)."""
    if n_pad == 0:
        return a
    return np.concatenate(
        [a, np.zeros((n_pad,) + a.shape[1:], dtype=a.dtype)], axis=0)


def load_source(source, device: torch.device):
    """Resolve a servable source to a live model on `device`: a model
    object (anything with `predict_fn`), a ModelSerializer zip path, a Keras
    HDF5 path (through `util.serializer.ModelGuesser`), or a checkpoint
    directory of `ckpt_<iteration>.zip` files (newest loadable wins)."""
    from ..fault.atomic import CorruptCheckpointError
    from ..util.serializer import ModelSerializer

    if hasattr(source, "predict_fn"):
        return source, "object"
    if not isinstance(source, (str, os.PathLike)):
        raise ServingError(
            f"unsupported model source {type(source).__name__}: expected a "
            "model object, a checkpoint zip path, or a checkpoint directory")
    path = os.fspath(source)
    if os.path.isdir(path):
        ckpts = sorted((int(m.group(1)), os.path.join(path, name))
                       for name in os.listdir(path)
                       for m in [_CKPT_RE.match(name)] if m)
        last_err = None
        for _, ckpt in reversed(ckpts):
            try:
                return ModelSerializer.restore(ckpt, load_updater=False,
                                                device=device), ckpt
            except (CorruptCheckpointError, OSError, KeyError,
                    ValueError, zipfile.BadZipFile) as e:
                last_err = e
        raise ServingError(
            f"no loadable committed checkpoint in {path!r}"
            + (f" (last error: {type(last_err).__name__}: {last_err})"
               if last_err else ""))
    if not os.path.exists(path):
        raise ServingError(f"model source {path!r} does not exist")
    from ..util.serializer import ModelGuesser
    kind = ModelGuesser.guess_format(path)
    if kind == "dl4j_tpu_zip":
        return ModelSerializer.restore(path, load_updater=False,
                                       device=device), path
    if kind == "keras_h5":
        return ModelGuesser.load(path, device=device), path
    raise ServingError(
        f"{path!r} is not a servable model file (sniffed: {kind}): expected "
        "a ModelSerializer zip or a Keras HDF5 file")


def _example_shape(model, override: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Per-example feature shape the buckets are fixed to."""
    if override is not None:
        return tuple(int(d) for d in override)
    conf = getattr(model, "conf", None)
    it = getattr(conf, "input_type", None)
    if it is None:
        its = getattr(conf, "input_types", None)   # a ComputationGraph's
        if its:
            it = its[0]
    if it is not None:
        if it.kind in ("ff", "cnn_flat"):
            return (int(it.flat_size()),)
        if it.kind == "cnn":
            return (int(it.height), int(it.width), int(it.channels))
        if it.kind in ("rnn", "cnn1d") and it.timesteps:
            return (int(it.timesteps), int(it.size))
    raise ServingError(
        "cannot derive a fixed per-example input shape from the model "
        "configuration — pass input_shape=(...) at register()/swap() time")


class ServableVersion:
    """Immutable snapshot of one model version: its parameters (`snapshot`,
    a `QuantizedTree` on the serving device), its layer state, one runner
    per bucket, and the live model (its layer stack, which the decode plane
    walks). `forwards` counts the bucket forwards it ran, warm-ups
    included."""

    __slots__ = ("name", "version", "precision", "buckets", "example_shape",
                 "snapshot", "state", "runners", "device", "model_kind",
                 "source", "created_at", "param_bytes", "model", "forwards",
                 "_count_lock")

    def __init__(self, name, precision, buckets, example_shape, snapshot,
                 state, runners, device, model_kind, source, model=None):
        self.name = name
        self.version = 0            # assigned at the atomic flip
        self.precision = precision
        self.buckets = buckets
        self.example_shape = example_shape
        self.snapshot = snapshot
        self.state = state
        self.runners = runners      # {bucket: forward(data, state, x)}
        self.device = device
        self.model_kind = model_kind
        self.source = source
        self.created_at = time.time()
        self.param_bytes = snapshot.nbytes()
        self.model = model
        self.forwards = 0
        self._count_lock = threading.Lock()

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        raise ServingError(
            f"{self.name}: request of {rows} rows exceeds the largest "
            f"batch bucket {self.buckets[-1]}")

    def run_padded(self, x_padded: np.ndarray, bucket: int) -> np.ndarray:
        """One forward over a bucket-shaped float32 batch."""
        if x_padded.shape != (bucket,) + self.example_shape:
            raise ServingError(f"{self.name}: batch of shape "
                               f"{x_padded.shape} for bucket {bucket}")
        x = torch.from_numpy(np.ascontiguousarray(x_padded, np.float32))
        out = self.runners[bucket](self.snapshot.data, self.state,
                                   x.to(self.device))
        with self._count_lock:
            self.forwards += 1
        return out.cpu().numpy()

    def info(self) -> Dict:
        return {
            "name": self.name, "version": self.version,
            "precision": self.precision, "buckets": list(self.buckets),
            "input_shape": list(self.example_shape),
            "model_kind": self.model_kind,
            "source": self.source if isinstance(self.source, str) else
            type(self.source).__name__,
            "param_mb": round(self.param_bytes / 1e6, 3),
            "created_at": self.created_at,
            "device": str(self.device),
        }


class CanaryState:
    """Live canary for one model: the candidate version, its routing
    fraction, and per-arm observations (requests, errors, latency, SLO
    breaches) that a promotion policy reads.

    Routing is deterministic: a per-model admission counter sends request
    `i` to the candidate iff ``i % 100 < round(fraction * 100)``, so the
    same request sequence always splits the same way. The internal lock is
    a leaf lock, held for a counter bump or a stats write."""

    __slots__ = ("version", "fraction", "started_at", "_slice",
                 "_counter", "_lock", "_arms")

    def __init__(self, version: ServableVersion, fraction: float):
        if not 0.0 < fraction < 1.0:
            raise ServingError(
                f"canary fraction must be in (0, 1), got {fraction}")
        self.version = version
        self.fraction = float(fraction)
        self.started_at = time.time()
        self._slice = max(1, round(self.fraction * 100))
        self._counter = 0
        self._lock = threading.Lock()
        self._arms = {arm: {"requests": 0, "errors": 0, "breaches": 0,
                            "latency_sum": 0.0, "latency_max": 0.0}
                      for arm in ("stable", "canary")}

    def route_arm(self) -> str:
        with self._lock:
            i = self._counter
            self._counter += 1
        return "canary" if i % 100 < self._slice else "stable"

    def observe(self, arm: str, latency_s: Optional[float] = None,
                error: bool = False, breach: bool = False):
        s = self._arms[arm]
        with self._lock:
            s["requests"] += 1
            if error:
                s["errors"] += 1
            if breach:
                s["breaches"] += 1
            if latency_s is not None:
                s["latency_sum"] += latency_s
                if latency_s > s["latency_max"]:
                    s["latency_max"] = latency_s

    def stats(self) -> Dict:
        with self._lock:
            arms = {a: dict(s) for a, s in self._arms.items()}
        for s in arms.values():
            n = max(1, s["requests"] - s["errors"])
            s["latency_mean"] = s["latency_sum"] / n
        return {"version": self.version.version, "fraction": self.fraction,
                "started_at": self.started_at, "arms": arms}


class _Entry:
    """Per-model-name registry slot: the current version pointer, the
    runner cache (signature-keyed, survives swaps), an optional live
    canary, the version listeners, and a swap lock serializing rebuilds of
    this one model (re-entrant: a listener builds decode steps through
    `compile_cached` under it)."""

    __slots__ = ("current", "version_counter", "compiled", "swap_lock",
                 "sig_history", "canary", "listeners")

    def __init__(self):
        self.current: Optional[ServableVersion] = None
        self.version_counter = 0
        self.compiled: Dict[tuple, object] = {}
        self.sig_history: list = []   # newest-first signatures, max 2
        self.swap_lock = threading.RLock()
        self.canary: Optional[CanaryState] = None
        self.listeners: List[Callable] = []


class ModelRegistry:
    """Named, versioned, hot-swappable servable models on one device (the
    GPU unless the caller passes `device="cpu"`).

    `metrics` defaults to the active telemetry session's registry or a
    fresh `MetricsRegistry`; `InferenceServer` exposes it at `/metrics`."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 precision: str = "fp32", device: DeviceLike = None,
                 metrics=None):
        self.default_buckets = tuple(sorted(int(b) for b in buckets))
        _check_precision(precision)
        self.default_precision = precision
        self.device = resolve_device(device)
        if metrics is None:
            from ..telemetry import runtime
            tel = runtime.active()
            if tel is not None:
                metrics = tel.registry
            else:
                from ..telemetry.registry import MetricsRegistry
                metrics = MetricsRegistry()
        self.metrics = metrics
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}
        self._swaps = metrics.counter(
            "dl4j_serving_swaps_total", "model version swaps committed",
            labels=("model",))
        self._version_g = metrics.gauge(
            "dl4j_serving_model_version", "currently served model version",
            labels=("model",))
        self._compiles = metrics.counter(
            "dl4j_serving_compiles_total",
            "runner builds per (model, bucket) — flat after startup/swap "
            "means the request path never builds one",
            labels=("model", "bucket"))
        self._compile_s = metrics.histogram(
            "dl4j_serving_compile_seconds",
            "wall seconds per runner build and warm-up",
            labels=("model",))
        self._canary_req = metrics.counter(
            "dl4j_continual_canary_requests_total",
            "requests observed per arm while a canary is active",
            labels=("model", "arm"))

    # -- registration / swap --------------------------------------------
    def register(self, name: str, source, *, precision: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 input_shape: Optional[Sequence[int]] = None
                 ) -> ServableVersion:
        """Load, transform and warm `source`, then atomically install it as
        the current version of `name` (creating the model on first call —
        `register` and `swap` are the same operation)."""
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
        with entry.swap_lock:
            if entry.canary is not None:
                raise ServingError(
                    f"{name}: a canary (candidate v"
                    f"{entry.canary.version.version}) is active — promote "
                    "or roll it back before swapping a new version in")
            return self._register_locked(entry, name, source,
                                         precision=precision,
                                         buckets=buckets,
                                         input_shape=input_shape)

    swap = register

    def _register_locked(self, entry: _Entry, name: str, source,
                         **kw) -> ServableVersion:
        version = self._build_version(entry, name, source, **kw)
        self._notify(entry, name, "swap", version)
        # the atomic flip: everything above ran off the request path
        with self._lock:
            entry.version_counter += 1
            version.version = entry.version_counter
            entry.current = version
        self._swaps.inc(model=name)
        self._version_g.set(version.version, model=name)
        return version

    def ensure(self, name: str, source, **kw) -> ServableVersion:
        """register() only if `name` isn't already served; concurrent
        ensure() calls on a new name serialize on the entry's swap lock, so
        exactly one builds."""
        v = self._current(name)
        if v is not None:
            return v
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
        with entry.swap_lock:
            if entry.current is not None:
                return entry.current
            return self._register_locked(entry, name, source, **kw)

    def unregister(self, name: str):
        with self._lock:
            self._entries.pop(name, None)

    # -- version listeners (the decode plane) ----------------------------
    def add_listener(self, name: str, fn: Callable):
        """Call `fn(event, version)` before each flip of `name`'s versions
        ("swap": a new current version; "canary": a candidate starts;
        "promote": the candidate becomes current), under the entry's swap
        lock and off the request path. An exception aborts the flip as an
        `AotCompileError`: the live version keeps serving."""
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
        with entry.swap_lock:
            entry.listeners.append(fn)

    def remove_listener(self, name: str, fn: Callable):
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            return
        with entry.swap_lock:
            if fn in entry.listeners:
                entry.listeners.remove(fn)

    def _notify(self, entry: _Entry, name: str, event: str,
                version: ServableVersion):
        for fn in list(entry.listeners):
            try:
                fn(event, version)
            except AotCompileError:
                raise
            except Exception as e:
                raise AotCompileError(name, f"decode ({event})", e) from e

    # -- lookup ---------------------------------------------------------
    def _current(self, name: str) -> Optional[ServableVersion]:
        with self._lock:
            entry = self._entries.get(name)
            return entry.current if entry is not None else None

    def get(self, name: str) -> ServableVersion:
        v = self._current(name)
        if v is None:
            raise UnknownModelError(name)
        return v

    def names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items()
                          if e.current is not None)

    def models(self) -> List[Dict]:
        return [self.get(n).info() for n in self.names()]

    def __contains__(self, name: str) -> bool:
        return self._current(name) is not None

    # -- inference (direct, unbatched path) -----------------------------
    def predict(self, name: str, features, arm: str = "stable"
                ) -> Tuple[np.ndarray, int]:
        """Direct forward: chunk by the largest bucket, pad each chunk to
        its bucket with zero rows, run, strip the padding. Returns
        `(outputs, version)`; the whole request runs on one version — the
        canary candidate's when `arm="canary"` and a canary is active."""
        v = self.get(name) if arm == "stable" else self.arm_version(name, arm)
        x = _validate_features(v, features)
        top = v.buckets[-1]
        outs = []
        for lo in range(0, x.shape[0], top):
            chunk = x[lo:lo + top]
            bucket = v.bucket_for(chunk.shape[0])
            out = v.run_padded(pad_rows(chunk, bucket - chunk.shape[0]),
                               bucket)
            outs.append(out[:chunk.shape[0]])
        return (outs[0] if len(outs) == 1 else np.concatenate(outs)), \
            v.version

    # -- canary routing ------------------------------------------------
    def start_canary(self, name: str, source, *, fraction: float = 0.1,
                     precision: Optional[str] = None,
                     buckets: Optional[Sequence[int]] = None,
                     input_shape: Optional[Sequence[int]] = None
                     ) -> ServableVersion:
        """Build and warm a candidate version of `name` and expose it to a
        deterministic `fraction` of traffic without touching the stable
        version. The candidate takes the next version number at once
        (numbers are never reused). Raises `AotCompileError` (live version
        and runner cache untouched) if the candidate fails to build, and
        `ServingError` if a canary is already active."""
        if not 0.0 < float(fraction) < 1.0:
            raise ServingError(
                f"canary fraction must be in (0, 1), got {fraction}")
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(name)
        with entry.swap_lock:
            if entry.current is None:
                raise UnknownModelError(name)
            if entry.canary is not None:
                raise ServingError(
                    f"{name}: a canary (candidate v"
                    f"{entry.canary.version.version}) is already active")
            version = self._build_version(entry, name, source,
                                          precision=precision,
                                          buckets=buckets,
                                          input_shape=input_shape)
            self._notify(entry, name, "canary", version)
            with self._lock:
                entry.version_counter += 1
                version.version = entry.version_counter
                entry.canary = CanaryState(version, float(fraction))
        return version

    def canary_state(self, name: str) -> Optional[CanaryState]:
        with self._lock:
            entry = self._entries.get(name)
            return entry.canary if entry is not None else None

    def route_arm(self, name: str) -> str:
        """Which arm serves the next request: "canary" for the
        deterministic fraction while a canary is active, else "stable"."""
        cs = self.canary_state(name)
        return cs.route_arm() if cs is not None else "stable"

    def arm_version(self, name: str, arm: str = "stable") -> ServableVersion:
        """The version serving `arm`; the stable version when no canary is
        active (a request routed to "canary" just before a rollback still
        gets a servable version)."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None or entry.current is None:
                raise UnknownModelError(name)
            if arm == "canary" and entry.canary is not None:
                return entry.canary.version
            return entry.current

    def observe_canary(self, name: str, arm: str,
                       latency_s: Optional[float] = None,
                       error: bool = False, breach: bool = False):
        """Feed one request observation into the live canary's per-arm
        stats (and `dl4j_continual_canary_requests_total`). No-op when no
        canary is active."""
        cs = self.canary_state(name)
        if cs is None:
            return
        cs.observe(arm, latency_s=latency_s, error=error, breach=breach)
        self._canary_req.inc(model=name, arm=arm)

    def promote_canary(self, name: str) -> ServableVersion:
        """Atomically make the canary candidate the stable version."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(name)
        with entry.swap_lock:
            cs = entry.canary
            if cs is None:
                raise ServingError(f"{name}: no canary is active")
            self._notify(entry, name, "promote", cs.version)
            with self._lock:
                entry.current = cs.version
                entry.canary = None
        self._swaps.inc(model=name)
        self._version_g.set(cs.version.version, model=name)
        return cs.version

    def rollback_canary(self, name: str) -> ServableVersion:
        """Drop the canary candidate; the stable version, never touched by
        the canary, keeps serving all traffic. Returns it."""
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise UnknownModelError(name)
        with entry.swap_lock:
            if entry.canary is None:
                raise ServingError(f"{name}: no canary is active")
            with self._lock:
                entry.canary = None
            return entry.current

    # -- version building -----------------------------------------------
    def _build_version(self, entry: _Entry, name: str, source, *,
                       precision=None, buckets=None,
                       input_shape=None) -> ServableVersion:
        precision = precision or self.default_precision
        _check_precision(precision)
        buckets = tuple(sorted(int(b) for b in (buckets or
                                                self.default_buckets)))
        if not buckets or buckets[0] < 1:
            raise ServingError(f"invalid batch buckets {buckets}")
        model, src = load_source(source, self.device)
        if getattr(model, "params", None) is None:
            model.init()
        shape = _example_shape(model, input_shape)
        snapshot = _snapshot_params(model, precision, self.device)
        state = tree_map(
            lambda v: v.detach().to(self.device, copy=True)
            if isinstance(v, torch.Tensor) else v, model.state)
        sig = _abstract_sig(snapshot, state, precision)
        version = ServableVersion(name, precision, buckets, shape, snapshot,
                                  state, {}, self.device,
                                  type(model).__name__, src, model=model)
        # stage new runners and merge them only after every bucket warmed:
        # a candidate that fails mid-build leaves the runner cache (and the
        # live version serving from it) untouched
        staged: Dict[tuple, Tuple[object, float]] = {}
        for b in buckets:
            # namespaced key: the decode plane's steps share the cache
            # under ("decode", sig, phase, bucket)
            key = ("fwd", sig, b)
            runner = entry.compiled.get(key)
            t0 = time.perf_counter()
            try:
                if runner is None:
                    runner = _make_forward(model, snapshot)
                version.runners[b] = runner
                version.run_padded(np.zeros((b,) + shape, np.float32), b)
            except ServingError:
                raise
            except Exception as e:
                raise AotCompileError(name, b, e) from e
            if key not in entry.compiled:
                staged[key] = (runner, time.perf_counter() - t0)
        for key, (runner, wall) in staged.items():
            entry.compiled[key] = runner
            self._record_compile(name, key[2], wall)
        # keep the current and the previous signature's runners (A/B
        # rollback stays build-free), drop older; decode-plane keys of a
        # kept signature survive a stateless swap and vice versa
        if sig in entry.sig_history:
            entry.sig_history.remove(sig)
        entry.sig_history.insert(0, sig)
        if len(entry.sig_history) > 2:
            keep = set(entry.sig_history[:2])
            del entry.sig_history[2:]
            for key in [k for k in entry.compiled if k[1] not in keep]:
                del entry.compiled[key]
        return version

    def compile_cached(self, name: str, key: tuple, build, label: str):
        """Build through `name`'s shared runner cache: the cached object
        under namespaced `key` (("decode", sig, phase, bucket) for the
        generation plane), or `build()` run once under the entry's swap
        lock and cached. `label` tags the compile accounting (one
        `record_aot` per miss). A hit takes no swap lock, so a prefill
        does not wait for a swap that is building another version."""
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
        compiled = entry.compiled.get(key)
        if compiled is not None:
            return compiled
        with entry.swap_lock:
            compiled = entry.compiled.get(key)
            if compiled is None:
                t0 = time.perf_counter()
                compiled = build()
                self._record_compile(name, label, time.perf_counter() - t0)
                entry.compiled[key] = compiled
        return compiled

    def _record_compile(self, name: str, bucket, wall_s: float):
        self._compiles.inc(model=name, bucket=str(bucket))
        self._compile_s.observe(wall_s, model=name)
        from ..telemetry import runtime
        tel = runtime.active()
        if tel is not None:
            tel.compiles.record_aot(f"serving/{name}:b{bucket}", wall_s)


# ---------------------------------------------------------------------------
# forward builders
# ---------------------------------------------------------------------------
def _snapshot_params(model, precision: str, device) -> QuantizedTree:
    """The model's parameters frozen into the serving representation for
    `precision`, on `device`: always a QuantizedTree (fp32 and bf16 just
    have no quantized leaves), so every runner shares one calling
    convention."""
    params = model.params
    if precision == "int8":
        return quantize_tree(params, device=device)
    if precision == "bf16":
        params = cast_tree(params, torch.bfloat16)
    leaves, rebuild = flatten_tree(params)
    data = tuple(v.detach().to(device, copy=True) for v in leaves)
    return QuantizedTree(data, (None,) * len(data), rebuild,
                         compute_dtype=torch.float32)


def _make_forward(model, snapshot: QuantizedTree):
    """The serving forward `(data, state, x) -> float32 out`: rebuild the
    parameters from the flat snapshot (dequantizing int8 leaves), cast the
    padded batch to the snapshot's float dtype, run the model's pure
    predict. For a ComputationGraph, its one input is fed by name and its
    first output returned (a multi-input graph cannot be served from one
    feature array)."""
    predict = model.predict_fn
    graph_inputs = getattr(getattr(model, "conf", None), "network_inputs",
                           None)
    if graph_inputs is not None and len(graph_inputs) != 1:
        raise ServingError(
            "serving supports single-input models; this ComputationGraph "
            f"declares inputs {list(graph_inputs)}")
    param_dtypes = {d.dtype for d, s in zip(snapshot.data, snapshot.scales)
                    if s is None}
    x_dtype = (torch.bfloat16 if torch.bfloat16 in param_dtypes
               else torch.float32)

    def forward(data, state, x):
        params = snapshot.rebuild(data)
        x = x.to(x_dtype)
        if graph_inputs is not None:
            name = graph_inputs[0]
            out = predict(params, state, {name: x}, {name: None})[0]
        else:
            out = predict(params, state, x, None)
        return out.to(torch.float32)

    return forward


def _abstract_sig(snapshot: QuantizedTree, state, precision: str) -> tuple:
    """Hashable (shapes + dtypes) signature of a version's inputs: two
    versions with equal signatures share runners and decode steps. int8
    scales are deliberately absent: a re-quantized same-architecture
    checkpoint signs identically."""
    def leaf_sig(a):
        return (tuple(a.shape), str(a.dtype))

    data_sig = tuple(
        leaf_sig(d) if s is None else (leaf_sig(d[0]), leaf_sig(d[1]))
        for d, s in zip(snapshot.data, snapshot.scales))
    flat_state, _ = flatten_tree(state)
    skeleton = tree_map(lambda _: None, state)
    return (precision, data_sig,
            tuple(s is not None for s in snapshot.scales),
            tuple(leaf_sig(s) if isinstance(s, torch.Tensor) else repr(s)
                  for s in flat_state), repr(skeleton))


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ServingError(f"unknown precision {precision!r}; expected one "
                           f"of {PRECISIONS}")


def _validate_features(v: ServableVersion, features) -> np.ndarray:
    try:
        x = np.asarray(features, np.float32)
    except (TypeError, ValueError) as e:
        raise ServingError(f"features are not a numeric array: {e}") from None
    if x.ndim == len(v.example_shape):      # single example convenience
        x = x[None]
    if x.ndim != len(v.example_shape) + 1 \
            or tuple(x.shape[1:]) != v.example_shape:
        raise ServingError(
            f"{v.name}: features shape {tuple(x.shape)} does not match "
            f"[rows]{list(v.example_shape)}")
    if x.shape[0] == 0:
        raise ServingError(f"{v.name}: empty features batch")
    return x
