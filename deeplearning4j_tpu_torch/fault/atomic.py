"""Crash-safe durable writes: temp file + fsync + atomic rename, sha256
manifests, commit markers (the port of `deeplearning4j_tpu/fault/atomic.py`).

The invariant every writer in this package maintains (Eisenman et al.,
*Check-N-Run*, NSDI 2022 — frequent, **verified** checkpoints as the core
fault-tolerance primitive): at any kill point, the destination path either
holds the complete previous version or the complete new version — never a
torn write. `os.replace` on a same-directory temp file is the commit;
everything before it is invisible to readers.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

__all__ = ["CorruptCheckpointError", "atomic_replace", "sha256_hex",
           "write_commit_marker", "read_commit_marker", "COMMIT_MARKER"]

COMMIT_MARKER = "COMMIT"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed manifest/commit verification (torn write, bit
    rot, or a crash between payload and commit)."""


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _fsync_dir(path: str):
    """fsync the containing directory so the rename itself is durable
    (best effort — not all filesystems support dir fds)."""
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


def atomic_replace(path: str, data: bytes, crash_point: Optional[str] = None):
    """Write `data` to `path` crash-safely: same-directory temp file,
    fsync, then `os.replace` (atomic on POSIX). A crash at ANY point
    leaves `path` either absent or holding its previous complete contents
    — never a torn write. `crash_point` names the injection hook fired
    after the temp bytes land (see fault/injection.py)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if crash_point:
                from .injection import fire_crash_point
                fire_crash_point(crash_point, path=path, tmp=tmp,
                                 nbytes=len(data))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        # best-effort cleanup; a SimulatedCrash/SIGKILL that skips this
        # leaves only a .tmp file, which GC sweeps and readers ignore
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_commit_marker(step_dir: str, meta: Optional[Dict] = None):
    """Mark a checkpoint directory complete: the atomic appearance of
    `COMMIT` (written last, after all payload writes returned) is the
    directory-granular commit point readers trust."""
    payload = json.dumps(meta or {}, sort_keys=True).encode()
    atomic_replace(os.path.join(step_dir, COMMIT_MARKER), payload)


def read_commit_marker(step_dir: str) -> Optional[Dict]:
    """The commit metadata, or None if the directory never committed
    (crashed mid-save) or the marker is unreadable."""
    try:
        with open(os.path.join(step_dir, COMMIT_MARKER), "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None
