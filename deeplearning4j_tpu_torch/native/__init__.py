"""The host C++ data plane of the port: builds, binds and wraps
`dl4j_native.cpp` (its own copy of the JAX package's
`deeplearning4j_tpu/native/dl4j_native.cpp`, ABI 2) with ctypes.

The readers of `datasets/` call these wrappers: the IDX reader and the
MNIST byte scaling (`datasets/fetchers.py`), the CSV parser and the
background-thread `PrefetchRing` (`datasets/records.py`), the PNG, BMP
and PNM decoders (`datasets/images.py`). It is host code, as in the JAX
package: nothing here touches the GPU.

Build. The library is compiled at first use with
`g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off`, linked
with `-lz`, or where zlib's headers are missing built with
`-DDL4J_NO_ZLIB` (PNG then goes to PIL, as in the JAX package), into
`_build/libdl4j_torch_native.so` beside this file (a directory
`.gitignore` lists; the name differs from the JAX package's library, so
both load into one process). `_build/libdl4j_torch_native.json` records
the source's sha256, which build was taken and its seconds; a library
whose record does not match the source is rebuilt. The compiler writes a
temporary file that `os.replace` moves into place, under an exclusive
file lock (`_build/.lock`): one process builds, the others wait for it
and load its library. `-ffp-contract=off` keeps `x * scale + shift`
unfused on hosts whose baseline has FMA, so the scaling rounds the same
everywhere.

No fallback hides the library. A failed build raises `NativeBuildError`
with the compiler's output, a library of another ABI raises it too, and
no switch turns the tier off; `native_available()` reports whether the
library loaded. Two things still go to PIL, because they are the JAX
package's documented format coverage: `image_decode_native` returns None
for a format it does not decode (JPEG, GIF, 16-bit or interlaced PNG, PNG
on a zlib-free build), and `datasets/images.py` then opens the file with
PIL.

Plain versions. Beside each wrapper is a plain numpy or PIL version of
the same function (`idx_read_plain`, `csv_read_plain`, `u8_to_f32_plain`,
`binary_batches_plain`, `image_decode_plain`). The tests and
`chip_smoke.py` hold the native functions against them; the readers never
call them.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import re
import struct
import subprocess
import threading
import time
from typing import Iterator, Optional

import numpy as np

__all__ = ["native_available", "lib", "idx_read_native", "csv_read_native",
           "u8_to_f32", "image_decode_native", "PrefetchRing",
           "NativeBuildError", "build_info", "BUILD_DIR", "LIB_NAME",
           "idx_read_plain", "csv_read_plain", "u8_to_f32_plain",
           "binary_batches_plain", "image_decode_plain"]

ABI = 2
LIB_NAME = "libdl4j_torch_native.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dl4j_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[BaseException] = None
_INFO: dict = {}


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded (the compiler's
    output is in the message), or it has another ABI."""


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _compile(dest: str) -> dict:
    """Compile the library to `dest` (through a temporary file and
    `os.replace`): with zlib, else zlib-free. Returns the build record."""
    tmp = f"{dest}.build.{os.getpid()}"
    base = ["g++"] + CXX_FLAGS + [_SRC, "-o", tmp]
    tries = (("zlib", ["-lz"]), ("no zlib", ["-DDL4J_NO_ZLIB"]))
    errors = []
    t0 = time.perf_counter()
    try:
        for kind, extra in tries:
            try:
                out = subprocess.run(base + extra, capture_output=True,
                                     text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(
                    f"cannot run the C++ compiler for {_SRC}: {e}") from e
            if out.returncode == 0:
                os.replace(tmp, dest)
                return {"build": kind, "zlib": kind == "zlib",
                        "seconds": time.perf_counter() - t0,
                        "command": " ".join(base[:-2] + [dest] + extra)}
            errors.append(f"$ {' '.join(base + extra)}\n"
                          f"{out.stderr[-4000:]}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    raise NativeBuildError("building the native data plane failed:\n"
                           + "\n".join(errors))


def _bind(l: ctypes.CDLL):
    c_char_p, c_int, c_i64 = ctypes.c_char_p, ctypes.c_int, ctypes.c_int64
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    f32_p = ctypes.POINTER(ctypes.c_float)
    i64_p = ctypes.POINTER(c_i64)
    int_p = ctypes.POINTER(c_int)
    sigs = {
        "idx_header": ([c_char_p, int_p, int_p, i64_p], c_int),
        "idx_payload": ([c_char_p, u8_p, c_i64], c_i64),
        "u8_to_f32": ([u8_p, f32_p, c_i64, ctypes.c_float, ctypes.c_float],
                      None),
        "u8_binarize_f32": ([u8_p, f32_p, c_i64, c_int], None),
        "csv_shape": ([c_char_p, c_int, i64_p, i64_p], c_int),
        "csv_parse_f32": ([c_char_p, c_int, f32_p, c_i64, c_i64], c_i64),
        "csv_parse_alloc": ([c_char_p, c_int, ctypes.POINTER(f32_p), i64_p,
                             i64_p], c_i64),
        "csv_free": ([f32_p], None),
        "ring_open": ([c_char_p, c_i64, c_i64, c_i64, c_i64, c_int],
                      ctypes.c_void_p),
        "ring_next": ([ctypes.c_void_p, u8_p], c_i64),
        "ring_close": ([ctypes.c_void_p], None),
        "ring_error": ([ctypes.c_void_p], c_int),
        "image_decode_alloc": ([c_char_p, ctypes.POINTER(u8_p), int_p, int_p,
                                int_p], c_int),
        "image_free": ([u8_p], None),
        "dl4j_native_abi": ([], c_int),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(l, name)
        fn.argtypes, fn.restype = args, res


def _load() -> ctypes.CDLL:
    global _LIB, _ERROR, _INFO
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERROR is not None:
            raise _ERROR
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            path = os.path.join(BUILD_DIR, LIB_NAME)
            record = os.path.join(BUILD_DIR, "libdl4j_torch_native.json")
            digest = _source_hash()
            with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
                # one builder across processes (xdist workers): the others
                # wait here and then find its library
                fcntl.flock(lock, fcntl.LOCK_EX)
                try:
                    info = {}
                    if os.path.exists(record) and os.path.exists(path):
                        with open(record) as f:
                            info = json.load(f)
                    if info.get("source_sha256") != digest:
                        info = dict(_compile(path), source_sha256=digest)
                        with open(f"{record}.{os.getpid()}", "w") as f:
                            json.dump(info, f)
                        os.replace(f"{record}.{os.getpid()}", record)
                        info["built_here"] = True
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
            try:
                l = ctypes.CDLL(path)
                _bind(l)
            except (OSError, AttributeError) as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            abi = l.dl4j_native_abi()
            if abi != ABI:
                raise NativeBuildError(f"{path} has ABI {abi}, the port "
                                       f"needs {ABI}")
        except OSError as e:    # the build directory, its lock, the record
            _ERROR = NativeBuildError(f"cannot build in {BUILD_DIR}: {e}")
            raise _ERROR from e
        except BaseException as e:
            _ERROR = e
            raise
        _INFO = dict(info, path=path)
        _LIB = l
        return _LIB


def lib() -> ctypes.CDLL:
    """The native library, built on the first call. Raises
    `NativeBuildError` (with the compiler's output) where it cannot be
    built or loaded."""
    return _load()


def native_available() -> bool:
    """Whether the native library is loaded (building it first if it has
    not been built). The readers do not consult this: they call the
    library and raise where it is missing."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def build_info() -> dict:
    """What the build took: {"build": "zlib" or "no zlib", "zlib",
    "seconds" (of the compile that made the library), "built_here" (this
    process compiled it), "path", "source_sha256"}; builds first."""
    _load()
    return dict(_INFO)


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------

_IDX_DTYPES = {0x08: (np.uint8, 1), 0x09: (np.int8, 1), 0x0B: (">i2", 2),
               0x0C: (">i4", 4), 0x0D: (">f4", 4), 0x0E: (">f8", 8)}
_IDX_ERRORS = {-1: "cannot open", -2: "bad magic", -3: "bad ndim",
               -4: "short header"}


def idx_read_native(path: str) -> np.ndarray:
    """Read an (uncompressed) IDX file through the native decoder."""
    l = lib()
    dtype = ctypes.c_int()
    ndim = ctypes.c_int()
    dims = (ctypes.c_int64 * 8)()
    rc = l.idx_header(path.encode(), ctypes.byref(dtype), ctypes.byref(ndim),
                      dims)
    if rc != 0:
        raise ValueError(f"bad IDX file {path!r} (rc={rc}: "
                         f"{_IDX_ERRORS.get(rc, 'error')})")
    if dtype.value not in _IDX_DTYPES:
        raise ValueError(f"unknown IDX dtype 0x{dtype.value:02x}")
    np_dtype, itemsize = _IDX_DTYPES[dtype.value]
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape)) * itemsize
    # the header is checked against the file's size before anything is
    # allocated (a corrupt header must not drive a huge np.empty), and
    # trailing bytes are rejected as the plain parser rejects them
    expected = 4 + 4 * ndim.value + n
    actual = os.path.getsize(path)
    if actual != expected:
        raise ValueError(
            f"{path}: payload size {actual - 4 - 4 * ndim.value} != shape "
            f"{shape} ({n} bytes expected)")
    buf = np.empty(n, np.uint8)
    got = l.idx_payload(path.encode(),
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        n)
    if got != n:
        raise ValueError(f"IDX payload short read: {got} != {n}")
    return buf.view(np_dtype).reshape(shape)


def csv_read_native(path: str, skip_rows: int = 0) -> np.ndarray:
    """Parse a numeric CSV into a float32 [rows, cols] array in one file
    read. Non-numeric fields read as 0; ragged rows raise ValueError."""
    l = lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    buf = ctypes.POINTER(ctypes.c_float)()
    rc = l.csv_parse_alloc(path.encode(), skip_rows, ctypes.byref(buf),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc == -5:
        raise ValueError(f"{path}: ragged CSV (rows have differing field "
                         "counts)")
    if rc != 0:
        raise ValueError(f"cannot read CSV {path!r} (rc={rc})")
    try:
        n = rows.value * cols.value
        out = np.ctypeslib.as_array(buf, shape=(n,)).astype(
            np.float32, copy=True).reshape(rows.value, cols.value) \
            if n else np.empty((rows.value, cols.value), np.float32)
    finally:
        if buf:  # free even for 0-element results (malloc(0) may be non-NULL)
            l.csv_free(buf)
    return out


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0,
              shift: float = 0.0, binarize: bool = False,
              threshold: int = 30) -> np.ndarray:
    """uint8 -> float32 as `x * float32(scale) + float32(shift)`, or with
    `binarize` 1 where x > threshold else 0 (the reference
    MnistDataFetcher's normalisation and binarize flags)."""
    l = lib()
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty(src.shape, np.float32)
    sp = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    dp = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if binarize:
        l.u8_binarize_f32(sp, dp, src.size, threshold)
    else:
        l.u8_to_f32(sp, dp, src.size, scale, shift)
    return out


def image_decode_native(path: str) -> Optional[np.ndarray]:
    """Decode PNG / BMP / PPM / PGM natively -> uint8 [H, W, C] in one
    pass. Returns None for a format the native tier does not decode (JPEG
    and others, 16-bit or interlaced PNG, PNG on a zlib-free build): the
    caller opens it with PIL. Raises ValueError on a corrupt file."""
    l = lib()
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    rc = l.image_decode_alloc(path.encode(), ctypes.byref(buf),
                              ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(ch))
    if rc == -2:
        return None
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"corrupt image file {path!r} (rc={rc})")
    try:
        n = h.value * w.value * ch.value
        out = np.ctypeslib.as_array(buf, shape=(n,)).copy().reshape(
            h.value, w.value, ch.value)
    finally:
        if buf:
            l.image_free(buf)
    return out


class PrefetchRing:
    """A background C++ thread streams fixed-size records from a binary
    file into a ring of `slots` batch buffers (the MagicQueue analog);
    `next_batch()` copies the next one out, None at the end of the epoch.
    A short read raises IOError. `close()` (or leaving the `with` block,
    or dropping the ring) stops the thread and joins it, also in the
    middle of an epoch. ctypes releases the GIL inside each native call."""

    def __init__(self, path: str, record_bytes: int, total_records: int,
                 batch_records: int, header_bytes: int = 0, slots: int = 3):
        self._h = None
        if int(batch_records) < 1 or int(record_bytes) < 1:
            raise ValueError(f"batch_records {batch_records} and "
                             f"record_bytes {record_bytes} must be >= 1")
        self._lib = lib()
        self.record_bytes = int(record_bytes)
        self.batch_records = int(batch_records)
        self._h = self._lib.ring_open(
            path.encode(), header_bytes, record_bytes, total_records,
            batch_records, slots)
        if not self._h:
            raise OSError(f"cannot open {path!r}")
        self._buf = np.empty(self.batch_records * self.record_bytes,
                             np.uint8)

    def next_batch(self) -> Optional[np.ndarray]:
        if not self._h:
            raise ValueError("the prefetch ring is closed")
        got = self._lib.ring_next(
            self._h,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if got == 0:
            return None
        if got < 0:
            raise IOError(f"prefetch ring error {got} (a short read: the "
                          "file holds fewer records than asked for)"
                          if got == -5 else f"prefetch ring error {got}")
        n = int(got)
        return (self._buf[:n * self.record_bytes]
                .reshape(n, self.record_bytes).copy())

    def close(self):
        if self._h:
            self._lib.ring_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# plain versions (numpy / PIL): the same functions, held against the native
# ones by the tests and chip_smoke.py; the readers never call them
# ---------------------------------------------------------------------------

def idx_read_plain(path: str) -> np.ndarray:
    """An uncompressed IDX file parsed with struct and numpy."""
    with open(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zero != 0:
        raise ValueError(f"{path}: bad IDX magic {data[:4]!r}")
    if dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=_IDX_DTYPES[dtype_code][0],
                        offset=4 + 4 * ndim)
    if arr.size != int(np.prod(dims)):
        raise ValueError(f"{path}: payload size {arr.size} != shape {dims}")
    return arr.reshape(dims)


# strtof's longest numeric prefix (decimal, exponent, inf, nan)
_NUMBER = re.compile(r"[ \t\n\v\f\r]*([+-]?(?:(?:\d+\.?\d*|\.\d+)"
                     r"(?:[eE][+-]?\d+)?|inf(?:inity)?|nan))", re.I)


def _field(text: str) -> float:
    m = _NUMBER.match(text)
    return float(m.group(1)) if m else 0.0


def csv_read_plain(path: str, skip_rows: int = 0) -> np.ndarray:
    """The native CSV parser's function in Python: lines that hold only
    spaces, tabs and CRs are skipped, then `skip_rows` lines; every row
    must have the first row's field count (else ValueError "ragged"); a
    field reads as its longest numeric prefix, 0 where it has none. Values
    round through float64 (exact for integers and short decimals)."""
    with open(path, "rb") as f:
        text = f.read().decode("latin-1")
    lines = [ln for ln in text.split("\n") if ln.strip(" \r\t")]
    lines = lines[skip_rows:]
    if not lines:
        return np.empty((0, 0), np.float32)
    cols = lines[0].count(",") + 1
    if any(ln.count(",") + 1 != cols for ln in lines):
        raise ValueError(f"{path}: ragged CSV (rows have differing field "
                         "counts)")
    fields = ",".join(lines).split(",")
    try:
        if "_" in text:     # float() reads 1_000, strtof stops at the _
            raise ValueError
        flat = np.array(fields, dtype=np.float64)
    except ValueError:
        flat = np.array([_field(s) for s in fields], dtype=np.float64)
    return flat.astype(np.float32).reshape(len(lines), cols)


def u8_to_f32_plain(src: np.ndarray, scale: float = 1.0 / 255.0,
                    shift: float = 0.0, binarize: bool = False,
                    threshold: int = 30) -> np.ndarray:
    """What the C computes: float32(x) * float32(scale) + float32(shift),
    each step rounded to float32 (a multiply, not a division by 255)."""
    src = np.asarray(src, np.uint8)
    if binarize:
        return (src > threshold).astype(np.float32)
    return src.astype(np.float32) * np.float32(scale) + np.float32(shift)


def binary_batches_plain(path: str, record_bytes: int, total_records: int,
                         batch_records: int, header_bytes: int = 0
                         ) -> Iterator[np.ndarray]:
    """The prefetch ring's batches by plain chunked reads: uint8
    [records, record_bytes] batches; a short read raises IOError."""
    if batch_records < 1 or record_bytes < 1:
        raise ValueError(f"batch_records {batch_records} and record_bytes "
                         f"{record_bytes} must be >= 1")
    with open(path, "rb") as f:
        f.seek(header_bytes)
        done = 0
        while done < total_records:
            n = min(batch_records, total_records - done)
            raw = f.read(n * record_bytes)
            if len(raw) < n * record_bytes:
                raise IOError(f"{path}: short read at record {done} "
                              f"({len(raw)} of {n * record_bytes} bytes)")
            done += n
            yield np.frombuffer(raw, np.uint8).reshape(n, record_bytes)


def image_decode_plain(path: str) -> np.ndarray:
    """uint8 [H, W, C] through PIL, in the native decoder's channel
    layout: gray 1, gray+alpha 2, RGB 3 (a palette expanded), RGBA 4."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("L", "LA", "RGB", "RGBA"):
            im = im.convert("RGB")
        arr = np.asarray(im, np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr
