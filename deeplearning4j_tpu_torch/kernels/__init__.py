"""Hand-written Hopper kernels of the port, and the builder that compiles them.

Each kernel module here (lstm.py, attention.py, bn_relu.py) holds, for
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
at capture, and replays them without Python: `count_snapshot`,
`count_delta`, `add_counts` and `restore_counts` let the capture code
(`nn/superstep.py`, chip_smoke.py's phase 2) take the capture's launches
off the counters and add them back at every replay, so `launch_counts()`
and `variant_counts()` count what ran on the card.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time
from typing import Optional

__all__ = ["library", "BUILD_DIR", "CUDA_FLAGS", "count_snapshot",
           "count_delta", "add_counts", "restore_counts"]

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
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


_COUNTED = ("lstm", "attention", "bn_relu")


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


def restore_counts(snapshot: dict):
    """Put the counters back to a `count_snapshot` (after a warm-up or a
    capture, which launch nothing that the run keeps)."""
    for name, mod in _counted_modules():
        totals, variants = snapshot[name]
        with mod._launch_lock:
            _set_counts(mod, totals, variants)
