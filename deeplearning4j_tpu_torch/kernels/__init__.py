"""Hand-written Hopper kernels of the port, and the builder that compiles them.

Each kernel module here (lstm.py, attention.py, bn_relu.py, bn_split.py)
holds, for
every kernel, the wrapper the layers call, the kernel's plain PyTorch
version and a launch count. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises. There is no
switch that turns a kernel off.

The CUDA sources under `csrc/` are compiled with nvcc for `sm_90a` at first
use, through `torch.utils.cpp_extension.load`, into `_build/` beside this
file (a directory `.gitignore` lists). The sources have a plain C interface
and include no PyTorch headers, so the build takes seconds; the library is
bound with ctypes. Nothing is built when this package is imported.

Launch counts are kept in Python, by each wrapper where it launches its
kernel. A CUDA graph captured around wrappers records their launches once,
at capture, and replays them without Python: the capture code
(`nn/superstep.py`, chip_smoke.py's phase 2) makes its warm-up and its
capture inside `tally()`, whose launches go to a tally of their own instead
of the counters, and `add_counts(tally_delta(t))` adds the capture's at
every replay, so `launch_counts()` and `variant_counts()` count what ran on
the card. A tally holds one thread's launches (a capture made while other
threads launch and count: the decode plane captures a new version's ticks
while the old version serves) or, with `all_threads=True`, every thread's
(a process-wide capture: a training step's backward launches on autograd's
device thread). `count_snapshot` and `count_delta` read the counters.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import threading
import time
from typing import Optional

__all__ = ["library", "BUILD_DIR", "CUDA_FLAGS", "count_snapshot",
           "count_delta", "add_counts", "tally", "tallied", "tally_delta"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_tls = threading.local()          # .tally: this thread's tally
_all_tally: Optional[dict] = None  # the tally of every thread's launches
_tally_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def library() -> ctypes.CDLL:
    """The compiled kernel library, built on the first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load

            # load() takes a lock file inside the directory and does not
            # create it itself
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            path = load(name="dl4j_tpu_torch_kernels",
                        sources=sorted(glob.glob(os.path.join(_HERE, "csrc",
                                                              "*.cu"))),
                        extra_cuda_cflags=CUDA_FLAGS,
                        build_directory=BUILD_DIR, is_python_module=False)
            build_seconds = time.perf_counter() - t0
            _lib = ctypes.CDLL(path)
    return _lib


_COUNTED = ("lstm", "attention", "bn_relu", "bn_split")


def _counted_modules():
    import importlib
    return [(name, importlib.import_module(f"{__name__}.{name}"))
            for name in _COUNTED]


def count_snapshot() -> dict:
    """{module: ({count name: n}, {kind: {variant: n}})} of every kernel
    module's launch counters."""
    return {name: (mod.launch_counts(), mod.variant_counts())
            for name, mod in _counted_modules()}


def count_delta(before: dict, after: dict) -> dict:
    """The launches between two snapshots, in the snapshot's form."""
    out = {}
    for name, (totals, variants) in after.items():
        t0, v0 = before[name]
        out[name] = ({k: n - t0[k] for k, n in totals.items()},
                     {kind: {v: n - v0[kind][v] for v, n in vs.items()}
                      for kind, vs in variants.items()})
    return out


def _set_counts(mod, totals, variants):
    for k, n in totals.items():
        setattr(mod, k, n)
    for kind, vs in variants.items():
        mod._by_variant[kind].update(vs)


def add_counts(delta: dict, times: int = 1):
    """Add `times` x `delta` (a `count_delta`) to the counters: the
    launches of `times` replays of a captured graph."""
    if times == 0:
        return
    for name, mod in _counted_modules():
        totals, variants = delta[name]
        with mod._launch_lock:
            now_t = {k: getattr(mod, k) + times * n
                     for k, n in totals.items()}
            now_v = {kind: {v: mod._by_variant[kind][v] + times * n
                            for v, n in vs.items()}
                     for kind, vs in variants.items()}
            _set_counts(mod, now_t, now_v)


@contextlib.contextmanager
def tally(all_threads: bool = False):
    """The launches this thread (with `all_threads`, every thread) makes
    inside the block go to a tally of their own (yielded) instead of the
    counters, which the other threads go on counting into."""
    global _all_tally
    t = {}
    if all_threads:
        prev, _all_tally = _all_tally, t
    else:
        prev, _tls.tally = getattr(_tls, "tally", None), t
    try:
        yield t
    finally:
        if all_threads:
            _all_tally = prev
        else:
            _tls.tally = prev


def tallied(module: str, counter: str, kind: Optional[str] = None,
            variant: Optional[str] = None) -> bool:
    """Called by a kernel module where it counts a launch: True when a
    `tally()` holds this thread's launches, which then holds this one, and
    the counters must not."""
    t = getattr(_tls, "tally", None)
    if t is None:
        t = _all_tally
    if t is None:
        return False
    key = (module, counter, kind, variant)
    with _tally_lock:
        t[key] = t.get(key, 0) + 1
    return True


def tally_delta(t: dict) -> dict:
    """A `tally()` in `count_delta`'s form, for `add_counts`."""
    out = {}
    for name, mod in _counted_modules():
        out[name] = (dict.fromkeys(mod.launch_counts(), 0),
                     {kind: dict.fromkeys(vs, 0)
                      for kind, vs in mod.variant_counts().items()})
    for (name, counter, kind, variant), n in t.items():
        totals, variants = out[name]
        totals[counter] += n
        if kind is not None and variant is not None:
            variants[kind][variant] += n
    return out
