"""Multi-model registry with versioned atomic hot-swap (the port of
`deeplearning4j_tpu/serving/registry.py`).

  * **Warm buckets.** Every (model, batch bucket) forward runs once at
    `register()`/`swap()` time, on zeros, before the version goes live: the
    kernels are built and loaded then, never on a request. (JAX compiles an
    XLA executable per bucket here; PyTorch runs eagerly, so one warm-up
    forward per bucket takes that place.)
  * **Atomic hot-swap.** A `ServableVersion` is an immutable snapshot: its
    own copy of the parameters on the registry's device. `swap()` builds and
    warms the new version off the request path, then flips one pointer under
    the registry lock. In-flight requests finish on the version they hold.
  * **Verified sources.** Zip checkpoints are checked against their sha256
    manifest on restore; a checkpoint directory serves its newest loadable
    `ckpt_*.zip`, skipping corrupt ones.

Only `precision="fp32"` is in the port; `bf16` and `int8` raise
`ServingError`. Canary routing and metrics arrive with later slices.
"""
from __future__ import annotations

import os
import re
import threading
import time
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..util.platform import DeviceLike, resolve_device

__all__ = ["ModelRegistry", "ServableVersion", "UnknownModelError",
           "ServingError", "DEFAULT_BUCKETS", "PRECISIONS", "load_source",
           "pad_rows"]

DEFAULT_BUCKETS = (1, 8, 32)
PRECISIONS = ("fp32",)
_NOT_PORTED = ("bf16", "int8")
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.zip$")


class ServingError(RuntimeError):
    """Client-facing serving failure (bad shape, unknown precision, ...)."""


class UnknownModelError(KeyError):
    """Request for a model name the registry doesn't hold."""


def pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    """Append `n_pad` zero rows along axis 0 (pad-to-bucket)."""
    if n_pad == 0:
        return a
    return np.concatenate(
        [a, np.zeros((n_pad,) + a.shape[1:], dtype=a.dtype)], axis=0)


def load_source(source, device: torch.device):
    """Resolve a servable source to a live model: a model object (anything
    with `predict_fn`), a ModelSerializer zip path, or a checkpoint
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
                return ModelSerializer.restore(ckpt, device=device), ckpt
            except (CorruptCheckpointError, OSError, KeyError,
                    ValueError, zipfile.BadZipFile) as e:
                last_err = e
        raise ServingError(
            f"no loadable committed checkpoint in {path!r}"
            + (f" (last error: {type(last_err).__name__}: {last_err})"
               if last_err else ""))
    if not os.path.exists(path):
        raise ServingError(f"model source {path!r} does not exist")
    if not zipfile.is_zipfile(path):
        raise ServingError(f"{path!r} is not a ModelSerializer zip (the "
                           "PyTorch port serves no other format yet)")
    return ModelSerializer.restore(path, device=device), path


def _example_shape(model, override: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Per-example feature shape the buckets are fixed to."""
    if override is not None:
        return tuple(int(d) for d in override)
    it = getattr(getattr(model, "conf", None), "input_type", None)
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
    """Immutable snapshot of one model version: its parameters and layer
    state on the serving device, and the model's pure forward. `forwards`
    counts the bucket forwards it ran, warm-ups included."""

    __slots__ = ("name", "version", "precision", "buckets", "example_shape",
                 "params", "state", "predict", "device", "model_kind",
                 "source", "created_at", "param_bytes", "forwards",
                 "_count_lock")

    def __init__(self, name, precision, buckets, example_shape, params,
                 state, predict, device, model_kind, source):
        self.name = name
        self.version = 0            # assigned at the atomic flip
        self.precision = precision
        self.buckets = buckets
        self.example_shape = example_shape
        self.params = params
        self.state = state
        self.predict = predict
        self.device = device
        self.model_kind = model_kind
        self.source = source
        self.created_at = time.time()
        self.param_bytes = sum(v.numel() * v.element_size()
                               for p in params for v in p.values())
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
        out = self.predict(self.params, self.state, x.to(self.device), None)
        with self._count_lock:
            self.forwards += 1
        return out.to(torch.float32).cpu().numpy()

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


class _Entry:
    """Per-model-name registry slot: the current version pointer and a swap
    lock serializing rebuilds of this one model."""

    __slots__ = ("current", "version_counter", "swap_lock")

    def __init__(self):
        self.current: Optional[ServableVersion] = None
        self.version_counter = 0
        self.swap_lock = threading.Lock()


class ModelRegistry:
    """Named, versioned, hot-swappable servable models on one device (the
    GPU unless the caller passes `device="cpu"`)."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 precision: str = "fp32", device: DeviceLike = None):
        self.default_buckets = tuple(sorted(int(b) for b in buckets))
        _check_precision(precision)
        self.default_precision = precision
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}

    # -- registration / swap --------------------------------------------
    def register(self, name: str, source, *, precision: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 input_shape: Optional[Sequence[int]] = None
                 ) -> ServableVersion:
        """Load and warm `source`, then atomically install it as the
        current version of `name` (creating the model on first call —
        `register` and `swap` are the same operation)."""
        with self._lock:
            entry = self._entries.setdefault(name, _Entry())
        with entry.swap_lock:
            version = self._build_version(name, source, precision=precision,
                                          buckets=buckets,
                                          input_shape=input_shape)
            with self._lock:      # the atomic flip
                entry.version_counter += 1
                version.version = entry.version_counter
                entry.current = version
        return version

    swap = register

    # -- lookup ---------------------------------------------------------
    def get(self, name: str) -> ServableVersion:
        with self._lock:
            entry = self._entries.get(name)
            v = entry.current if entry is not None else None
        if v is None:
            raise UnknownModelError(name)
        return v

    def names(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items()
                          if e.current is not None)

    def models(self) -> List[Dict]:
        return [self.get(n).info() for n in self.names()]

    # -- inference (direct, unbatched path) -----------------------------
    def predict(self, name: str, features) -> Tuple[np.ndarray, int]:
        """Direct forward: chunk by the largest bucket, pad each chunk to
        its bucket with zero rows, run, strip the padding. Returns
        `(outputs, version)`; the whole request runs on one version."""
        v = self.get(name)
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

    # -- version building -----------------------------------------------
    def _build_version(self, name: str, source, *, precision=None,
                       buckets=None, input_shape=None) -> ServableVersion:
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
        copy = lambda d: {k: v.detach().to(self.device, copy=True)
                          for k, v in d.items()}
        params = tuple(copy(p) for p in model.params)
        state = tuple(copy(s) for s in model.state)
        version = ServableVersion(name, precision, buckets, shape, params,
                                  state, model.predict_fn, self.device,
                                  type(model).__name__, src)
        for b in buckets:           # warm every bucket off the request path
            version.run_padded(np.zeros((b,) + shape, np.float32), b)
        return version


def _check_precision(precision: str):
    if precision in _NOT_PORTED:
        raise ServingError(
            f"precision {precision!r} is not in the PyTorch port yet; "
            f"it serves {PRECISIONS}")
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
