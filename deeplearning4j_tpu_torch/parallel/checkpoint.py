"""Distributed (sharded) checkpointing (the port of
`deeplearning4j_tpu/parallel/checkpoint.py`).

JAX writes the trees of a mesh-trained model through orbax. The port's
layout is its own, per rank, and orbax-free: a step directory holds the
model-level trees as a `CoordinatedShardStore` (`tree/`: each rank writes
its byte-range slices of every leaf, `shards_p{r}.bin`, with a sha256
manifest), the configuration JSON and `meta.json` (counters, the dropout
generators' states, the fit's resume bookkeeping). The bridge between the
packages stays the `ModelSerializer` zip, and the coordinated store itself,
whose files are byte for byte JAX's.

Durability: each `step_NNNNNNNNN` directory commits via a COMMIT marker
written LAST, after rank 0 has seen every rank's `DURABLE_p{r}` marker —
a crash mid-save leaves a marker-less directory that `latest_step` skips
and `_gc` sweeps. Retention keeps the newest `keep` committed steps plus
the best-scoring one.

`CoordinatedShardStore` is the multi-worker two-phase commit (JAX's
layout: `shards_p{w}.bin`, `manifest_p{w}.json`, `meta.json`,
`DURABLE_p{w}`, `COMMIT`), synchronized through the shared directory
(poll + deadline), never through a collective, so a worker that dies
mid-commit makes the survivors time out (`ElasticWorkerLost`) instead of
hanging. A store written by either package restores in the other.
"""
from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..fault.atomic import (COMMIT_MARKER, CorruptCheckpointError,
                            atomic_replace, read_commit_marker, sha256_hex,
                            write_commit_marker)
from ..fault.injection import fire_crash_point
from ..fault.metrics import checkpoint_timer

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["save_sharded", "restore_sharded", "ShardedCheckpoint",
           "CoordinatedShardStore", "ElasticWorkerLost"]

_STEP_RE = re.compile(r"^step_(\d+)$")


class ElasticWorkerLost(RuntimeError):
    """A peer worker failed to reach a two-phase-commit boundary (or the
    COMMIT marker never appeared) within the deadline — it is presumed
    dead. The snapshot step is left uncommitted; callers fall back to the
    last committed step."""


def _world():
    from .distributed import process_count, process_index
    return process_count(), process_index()


def _model_tree(model):
    return {"params": model.params, "state": model.state,
            "updater_state": model.updater_state}


def save_sharded(path: str, model, extra: Optional[dict] = None, *,
                 n_workers: Optional[int] = None,
                 worker_id: Optional[int] = None):
    """Write this rank's slices of the model's trees (`tree/`), and, on
    rank 0, the configuration JSON and `meta.json`."""
    n, w = _world()
    n = n if n_workers is None else int(n_workers)
    w = w if worker_id is None else int(worker_id)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with checkpoint_timer("save", "sharded"):
        meta = {"kind": type(model).__name__,
                "iteration_count": model.iteration_count,
                "epoch_count": getattr(model, "epoch_count", 0),
                "generator_states": [
                    g.get_state().tolist()
                    for g in model._dropout_generators()]}
        if extra:
            meta.update(extra)
        store = CoordinatedShardStore(os.path.join(path, "tree"),
                                      n_workers=n, worker_id=w)
        store.write_shards(_model_tree(model))
        if w == 0:
            store.commit()
            atomic_replace(os.path.join(path, "config.json"),
                           model.conf.to_json().encode())
            atomic_replace(os.path.join(path, "meta.json"),
                           json.dumps(meta).encode())


def restore_sharded(path: str, model, shardings: Optional[Any] = None):
    """Restore into an initialized model: every rank reads every rank's
    slices (the layout does not depend on the rank count), the trees land
    on the model's device in the template's dtypes. `shardings` is
    accepted for JAX's signature; the trainer re-shards on `_prepare`."""
    from ..nn.trees import tree_map

    path = os.path.abspath(path)
    with checkpoint_timer("restore", "sharded"):
        store = CoordinatedShardStore(os.path.join(path, "tree"))
        tree = store.read_tree(_model_tree(model))
        dev = model.device
        to = lambda t: tree_map(lambda a: a.to(dev), t)
        model.params = to(tree["params"])
        model.state = to(tree["state"])
        model.updater_state = to(tree["updater_state"])
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        states = meta.get("generator_states") or []
        for g, s in zip(model._dropout_generators(), states):
            g.set_state(torch.tensor(s, dtype=torch.uint8))
        model.__dict__.pop("_captured_steps", None)
    return model


class ShardedCheckpoint:
    """Step-directory checkpoint manager with commit markers, verified
    retention (newest `keep` + best score) and corrupt-step fallback.
    `n_workers` / `worker_id` default to the process group's world."""

    def __init__(self, directory: str, keep: int = 3,
                 keep_best: bool = True, commit_timeout_s: float = 60.0,
                 n_workers: Optional[int] = None,
                 worker_id: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, int(keep))
        self.keep_best = bool(keep_best)
        self.commit_timeout_s = float(commit_timeout_s)
        n, w = _world()
        self.n_workers = n if n_workers is None else int(n_workers)
        self.worker_id = w if worker_id is None else int(worker_id)
        # steps THIS manager attempted to save: an uncommitted one of
        # these is a crashed save and safe to sweep. Marker-less dirs we
        # did not write may be a pre-COMMIT-marker layout — never deleted
        self._attempted: set = set()
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _all_steps(self) -> List[int]:
        """Every step-shaped entry, committed or not; stray files and
        foreign names are ignored."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def steps(self) -> List[int]:
        """Committed steps only, ascending."""
        return [s for s in self._all_steps()
                if read_commit_marker(self._step_dir(s)) is not None]

    def save(self, model, step: int, score: Optional[float] = None,
             extra: Optional[dict] = None):
        """Save + commit one step. The `sharded/tree_written` crash point
        fires between the payload write and the DURABLE / COMMIT markers:
        a crash there leaves an uncommitted directory readers skip."""
        d = self._step_dir(step)
        self._attempted.add(int(step))
        save_sharded(d, model, extra=extra, n_workers=self.n_workers,
                     worker_id=self.worker_id)
        fire_crash_point("sharded/tree_written", path=d, step=step)
        n, pid = self.n_workers, self.worker_id
        atomic_replace(os.path.join(d, f"DURABLE_p{pid}"),
                       json.dumps({"process": pid, "step": int(step)}
                                  ).encode())
        if pid == 0:
            deadline = time.monotonic() + self.commit_timeout_s
            missing = list(range(n))
            while missing:
                missing = [
                    w for w in missing
                    if not os.path.exists(os.path.join(d, f"DURABLE_p{w}"))]
                if not missing:
                    break
                if time.monotonic() >= deadline:
                    raise ElasticWorkerLost(
                        f"sharded checkpoint step {step}: process(es) "
                        f"{missing} never reached DURABLE within "
                        f"{self.commit_timeout_s:.1f}s — step left "
                        "uncommitted")
                time.sleep(0.02)
            commit = {"step": int(step), "n_processes": n}
            if score is not None:
                commit["score"] = float(score)
            write_commit_marker(d, commit)
            self._gc()
        else:
            # a rank returns once rank 0 has committed, so a restore on any
            # rank right after finds the step
            deadline = time.monotonic() + self.commit_timeout_s
            while read_commit_marker(d) is None:
                if time.monotonic() >= deadline:
                    raise ElasticWorkerLost(
                        f"sharded checkpoint step {step}: COMMIT never "
                        f"appeared within {self.commit_timeout_s:.1f}s — "
                        "rank 0 presumed lost")
                time.sleep(0.02)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        best = None
        for s in self.steps():
            marker = read_commit_marker(self._step_dir(s)) or {}
            score = marker.get("score")
            if score is not None and (best is None or score < best[0]):
                best = (score, s)
        return best[1] if best else None

    def meta(self, step: int) -> Optional[Dict]:
        try:
            with open(os.path.join(self._step_dir(step), "meta.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def restore_latest(self, model, shardings=None) -> Optional[int]:
        """Restore the newest committed step, falling back to older ones
        when a committed step fails to load; with no committed step at
        all, marker-less step dirs newest-first. Returns the step or
        None."""
        committed = self.steps()
        candidates = committed
        if not committed:
            candidates = self._all_steps()
            if candidates:
                log.warning(
                    "no COMMIT-marked steps under %s — pre-marker layout "
                    "(or only crashed saves); attempting marker-less step "
                    "dirs newest-first", self.directory)
        for s in reversed(candidates):
            try:
                restore_sharded(self._step_dir(s), model, shardings)
                return s
            except Exception as e:
                log.warning(
                    "sharded checkpoint step %d unusable (%s: %s) — "
                    "falling back to an older step", s,
                    type(e).__name__, e)
        return None

    def _gc(self):
        """Retention: newest `keep` committed steps + the best-scoring
        one; marker-less dirs only if this manager wrote them."""
        import shutil

        committed = self.steps()
        keep = set(committed[-self.keep:])
        if self.keep_best:
            b = self.best_step()
            if b is not None:
                keep.add(b)
        for s in committed:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        newest = committed[-1] if committed else None
        for s in self._all_steps():
            if (s not in committed and s in self._attempted
                    and newest is not None and s < newest):
                shutil.rmtree(self._step_dir(s), ignore_errors=True)


# ----------------------------------------------------------------------
# coordinated multi-worker snapshots (two-phase commit)
# ----------------------------------------------------------------------

def _leaf_items(tree, prefix: str = ""):
    """(key, leaf) pairs in JAX's pytree order with JAX's `keystr` keys:
    dict keys sorted (`['params']`), sequences by index (`[0]`); None and
    empty containers hold no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaf_items(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaf_items(v, f"{prefix}[{i}]"))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _host_leaf(a):
    """(dtype name, shape, raw C-order bytes as a flat numpy array) of a
    leaf; bfloat16 travels as its 16-bit patterns (numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy()
        arr = t.numpy()
    else:
        arr = np.asarray(a)
    name = str(arr.dtype)
    if name == "bfloat16":
        return name, arr.shape, arr.view(np.int16)
    return name, arr.shape, arr


def _from_raw(raw: bytes, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        return np.frombuffer(raw, dtype=np.int16)
    return np.frombuffer(raw, dtype=np.dtype(dtype))


def _to_leaf(full: np.ndarray, dtype: str, shape) -> torch.Tensor:
    t = torch.from_numpy(full.copy()).reshape(shape)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _worker_slice(n: int, worker: int, n_workers: int) -> slice:
    """Worker `worker`'s slice [w·n/W, (w+1)·n/W) of a flat leaf of n
    elements: depends only on (leaf size, worker count), so a snapshot
    written by W workers reassembles under any other count."""
    lo = (worker * n) // n_workers
    hi = ((worker + 1) * n) // n_workers
    return slice(lo, hi)


class CoordinatedShardStore:
    """One coordinated snapshot directory with a two-phase commit (JAX's
    layout and protocol, file for file).

      ``shards_p{w}.bin``     worker w's concatenated raw slices of every
                              leaf (flat C-order)
      ``manifest_p{w}.json``  per-slice sha256 + blob offsets + leaf
                              shapes/dtypes/global offsets
      ``meta.json``           worker 0's logical metadata
      ``DURABLE_p{w}``        phase 1: worker w's payload is on disk
      ``COMMIT``              phase 2: worker 0, after verifying every
                              worker's DURABLE marker

    Crash points (fault/injection.py): ``elastic/shards_written``,
    ``elastic/durable_marked``, ``elastic/commit_marker``."""

    def __init__(self, directory: str, n_workers: int = 1,
                 worker_id: int = 0, commit_timeout_s: float = 60.0,
                 poll_s: float = 0.02):
        self.directory = os.path.abspath(directory)
        self.n_workers = max(1, int(n_workers))
        self.worker_id = int(worker_id)
        self.commit_timeout_s = float(commit_timeout_s)
        self.poll_s = float(poll_s)
        os.makedirs(self.directory, exist_ok=True)

    def _blob_path(self, w: int) -> str:
        return os.path.join(self.directory, f"shards_p{w}.bin")

    def _manifest_path(self, w: int) -> str:
        return os.path.join(self.directory, f"manifest_p{w}.json")

    def _durable_path(self, w: int) -> str:
        return os.path.join(self.directory, f"DURABLE_p{w}")

    # -- phase 1: every worker ----------------------------------------
    def write_shards(self, tree, meta: Optional[Dict] = None,
                     worker_id: Optional[int] = None):
        """Write THIS worker's slices of every leaf + the sha256 manifest,
        then mark the worker DURABLE. `worker_id` overrides the store's id
        so one process can emulate every worker of the protocol."""
        w = self.worker_id if worker_id is None else int(worker_id)
        chunks: List[bytes] = []
        leaves = []
        off = 0
        for key, leaf in _leaf_items(tree):
            dtype, shape, arr = _host_leaf(leaf)
            flat = np.ravel(arr)
            sl = _worker_slice(flat.size, w, self.n_workers)
            blob = np.ascontiguousarray(flat[sl]).tobytes()
            leaves.append({
                "key": key, "shape": list(shape),
                "dtype": dtype, "global_offset": int(sl.start),
                "n": int(sl.stop - sl.start), "blob_offset": off,
                "nbytes": len(blob), "sha256": sha256_hex(blob)})
            chunks.append(blob)
            off += len(blob)
        payload = b"".join(chunks)
        atomic_replace(self._blob_path(w), payload)
        manifest = {"worker": w, "n_workers": self.n_workers,
                    "blob_sha256": sha256_hex(payload), "leaves": leaves}
        mbytes = json.dumps(manifest, sort_keys=True).encode()
        atomic_replace(self._manifest_path(w), mbytes)
        if w == 0 and meta is not None:
            atomic_replace(os.path.join(self.directory, "meta.json"),
                           json.dumps(meta, sort_keys=True).encode())
        fire_crash_point("elastic/shards_written", path=self.directory,
                         worker=w)
        atomic_replace(self._durable_path(w),
                       json.dumps({"worker": w,
                                   "manifest_sha256": sha256_hex(mbytes)
                                   }).encode())
        fire_crash_point("elastic/durable_marked", path=self.directory,
                         worker=w)

    # -- phase 2: worker 0 --------------------------------------------
    def commit(self, extra: Optional[Dict] = None):
        """Worker 0: wait (bounded) for every worker's DURABLE marker,
        verify each against its manifest, then write COMMIT."""
        deadline = time.monotonic() + self.commit_timeout_s
        missing = list(range(self.n_workers))
        while missing:
            missing = [w for w in missing
                       if not os.path.exists(self._durable_path(w))]
            if not missing:
                break
            if time.monotonic() >= deadline:
                raise ElasticWorkerLost(
                    f"coordinated snapshot {self.directory}: worker(s) "
                    f"{missing} never reached DURABLE within "
                    f"{self.commit_timeout_s:.1f}s — presumed lost; step "
                    "left uncommitted")
            time.sleep(self.poll_s)
        for w in range(self.n_workers):
            with open(self._durable_path(w), "rb") as f:
                marker = json.loads(f.read().decode())
            with open(self._manifest_path(w), "rb") as f:
                mbytes = f.read()
            if marker.get("manifest_sha256") != sha256_hex(mbytes):
                raise CorruptCheckpointError(
                    f"worker {w} DURABLE marker does not match its "
                    f"manifest under {self.directory}")
        commit = {"n_workers": self.n_workers}
        if extra:
            commit.update(extra)
        atomic_replace(os.path.join(self.directory, COMMIT_MARKER),
                       json.dumps(commit, sort_keys=True).encode(),
                       crash_point="elastic/commit_marker")

    def wait_committed(self):
        """Non-zero workers: block (bounded) until COMMIT appears."""
        deadline = time.monotonic() + self.commit_timeout_s
        while read_commit_marker(self.directory) is None:
            if time.monotonic() >= deadline:
                raise ElasticWorkerLost(
                    f"coordinated snapshot {self.directory}: COMMIT "
                    f"never appeared within {self.commit_timeout_s:.1f}s "
                    "— worker 0 presumed lost")
            time.sleep(self.poll_s)

    # -- restore -------------------------------------------------------
    def committed(self) -> bool:
        return read_commit_marker(self.directory) is not None

    def read_meta(self) -> Dict:
        with open(os.path.join(self.directory, "meta.json")) as f:
            return json.load(f)

    def read_tree(self, template):
        """Reassemble the full logical tree from every saver's slices,
        verifying each slice's sha256. `template` gives the structure
        (any tree of the same leaves); leaf keys must match the manifests
        or the snapshot is rejected. Leaves come back as CPU tensors."""
        from ..nn.trees import flatten_tree

        marker = read_commit_marker(self.directory)
        if marker is None:
            raise CorruptCheckpointError(
                f"{self.directory} has no COMMIT marker (crashed save)")
        n_savers = int(marker.get("n_workers", self.n_workers))
        items = _leaf_items(template)
        keys = [k for k, _ in items]
        parts: Dict[str, list] = {k: [] for k in keys}
        shapes: Dict[str, tuple] = {}
        dtypes: Dict[str, str] = {}
        for w in range(n_savers):
            try:
                with open(self._manifest_path(w), "rb") as f:
                    manifest = json.loads(f.read().decode())
                with open(self._blob_path(w), "rb") as f:
                    blob = f.read()
            except (OSError, ValueError) as e:
                raise CorruptCheckpointError(
                    f"worker {w} shards unreadable under "
                    f"{self.directory}: {e}") from e
            saved_keys = [ent["key"] for ent in manifest["leaves"]]
            if saved_keys != keys:
                raise CorruptCheckpointError(
                    f"snapshot tree structure mismatch under "
                    f"{self.directory}: saved {len(saved_keys)} leaves, "
                    f"restore template has {len(keys)}")
            for ent in manifest["leaves"]:
                raw = blob[ent["blob_offset"]:
                           ent["blob_offset"] + ent["nbytes"]]
                if sha256_hex(raw) != ent["sha256"]:
                    raise CorruptCheckpointError(
                        f"sha256 mismatch for leaf {ent['key']} slice of "
                        f"worker {w} under {self.directory}")
                parts[ent["key"]].append(
                    (ent["global_offset"], _from_raw(raw, ent["dtype"])))
                shapes[ent["key"]] = tuple(ent["shape"])
                dtypes[ent["key"]] = ent["dtype"]
        by_key = {}
        for key in keys:
            shape = shapes[key]
            n = int(np.prod(shape)) if shape else 1
            pieces = sorted(parts[key], key=lambda t: t[0])
            full = np.empty(n, dtype=pieces[0][1].dtype if pieces
                            else np.float32)
            covered = 0
            for off, piece in pieces:
                full[off:off + piece.size] = piece
                covered += piece.size
            if covered != n:
                raise CorruptCheckpointError(
                    f"leaf {key} reassembled {covered}/{n} elements "
                    f"under {self.directory}")
            by_key[key] = _to_leaf(full, dtypes[key], shape)
        # rebuild the template's structure with the restored leaves
        ids = {id(leaf): key for key, leaf in items}
        leaves, rebuild = flatten_tree(template)
        return rebuild([by_key[ids[id(a)]] if id(a) in ids else a
                        for a in leaves])
