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
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time
from typing import Optional

__all__ = ["library", "BUILD_DIR", "CUDA_FLAGS"]

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
