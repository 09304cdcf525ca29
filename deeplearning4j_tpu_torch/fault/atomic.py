"""Crash-safe durable writes (the part of `deeplearning4j_tpu/fault/atomic.py`
the serializer uses): same-directory temp file, fsync, atomic rename, and
sha256 digests for the zip manifest.

At any kill point the destination holds either its complete previous
contents or the complete new ones, never a torn write.
"""
from __future__ import annotations

import hashlib
import os
import tempfile

__all__ = ["CorruptCheckpointError", "atomic_replace", "sha256_hex"]


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed manifest verification (torn write or bit rot)."""


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _fsync_dir(path: str):
    """fsync the containing directory so the rename itself is durable
    (best effort: not every filesystem supports directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_replace(path: str, data: bytes):
    """Write `data` to `path` via a same-directory temp file, fsync, then
    `os.replace` (atomic on POSIX)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
