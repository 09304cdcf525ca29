"""Elastic, preemption-tolerant multi-process training (the port of
`deeplearning4j_tpu/parallel/elastic.py`).

The supervision plane on top of `ParallelTrainer`, JAX's protocol:

  * **CoordinatedCheckpoint** — step directories over `checkpoint.py`'s
    `CoordinatedShardStore`: every worker writes its sha256-manifested
    byte ranges of the trainer's logical (mesh-shape-independent) state,
    a two-phase commit (all workers DURABLE, then worker 0 COMMIT) lands
    the step, and a restore re-lands the layouts on any (d, m, p)
    factorization through `ParallelTrainer.load_elastic_state`.
  * **HeartbeatLease** — worker liveness through a shared directory: each
    worker atomically renews ``lease_p{w}.json``; a lease older than the
    TTL is a lost worker.
  * **DrainSignal** — the first preempted worker (SIGTERM) publishes the
    superstep edge it will drain at; every worker snapshots that same edge
    and exits.
  * **ElasticTrainer** — renew the lease, fire the ``elastic/step`` crash
    point, check drain / loss / join, train one step, snapshot at edges.

A resize (a worker lost or joined): the survivors destroy the process
group and re-form it among themselves on a fresh rendezvous store (a file
store of the generation under the elastic directory, ranks renumbered in
worker order), rebuild `ParallelTrainer` on `surviving_mesh_shape` and
restore the last committed snapshot; the steps past its edge replay from
`batch_fn(step)`, which must be deterministic in the global step. JAX's
real multi-process mode cannot resize in place (its world is fixed at
initialize) and exits "worker_lost"; the port's gloo and NCCL groups can
be re-formed, so it resizes, and exits "worker_lost" only when the
re-formed world cannot meet (a peer wedged rather than dead).

`emulated=True` is JAX's single-process emulation: one process plays
every worker of the protocol (it writes every live worker's shards and
renews every lease) on its one rank; `mesh_shape` then reports the
logical factorization while the trainer runs on the process's rank. The
tests drive the real protocol on worlds of CPU ranks.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import re
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..fault.atomic import atomic_replace, read_commit_marker
from ..fault.injection import STEP_POINT, fire_crash_point
from ..fault.metrics import count_elastic, elastic_snapshot_timer
from .checkpoint import CoordinatedShardStore, ElasticWorkerLost
from .mesh import MeshAxes, forget_groups, make_mesh, surviving_mesh_shape
from .sharding import ShardingStrategy

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["HeartbeatLease", "DrainSignal", "CoordinatedCheckpoint",
           "ElasticTrainer", "ElasticWorkerLost", "surviving_mesh_shape"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


class HeartbeatLease:
    """Worker liveness through a shared directory: worker w atomically
    renews ``lease_p{w}.json`` (wall-clock stamp — comparable across
    processes on a shared filesystem, unlike monotonic clocks); a lease
    older than ``ttl_s`` marks its worker LOST. A clean leave deletes
    the lease (`resign`), distinguishing planned drains from deaths.
    `clock` is injectable so tests can expire leases without sleeping."""

    def __init__(self, directory: str, worker_id: int, ttl_s: float = 5.0,
                 clock: Callable[[], float] = time.time):
        self.directory = os.path.abspath(directory)
        self.worker_id = int(worker_id)
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self._renewals = 0
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, w: int) -> str:
        return os.path.join(self.directory, f"lease_p{w}.json")

    def renew(self, worker_id: Optional[int] = None):
        w = self.worker_id if worker_id is None else int(worker_id)
        self._renewals += 1
        atomic_replace(self._path(w), json.dumps(
            {"worker": w, "t": self.clock(),
             "n": self._renewals}).encode())

    def resign(self, worker_id: Optional[int] = None):
        w = self.worker_id if worker_id is None else int(worker_id)
        try:
            os.unlink(self._path(w))
        except OSError:
            pass

    def ages(self) -> Dict[int, float]:
        """{worker_id: seconds since last renewal} for every lease file
        present (unreadable/torn files count as infinitely old)."""
        now = self.clock()
        out: Dict[int, float] = {}
        for name in os.listdir(self.directory):
            m = re.match(r"^lease_p(\d+)\.json$", name)
            if not m:
                continue
            w = int(m.group(1))
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out[w] = now - float(json.load(f)["t"])
            except (OSError, ValueError, KeyError):
                out[w] = float("inf")
        return out

    def active_workers(self) -> List[int]:
        """Workers with a fresh lease (age <= ttl), sorted."""
        return sorted(w for w, age in self.ages().items()
                      if age <= self.ttl_s)

    def lost_workers(self, expected: Sequence[int]) -> List[int]:
        """Members of `expected` whose lease is stale or missing."""
        ages = self.ages()
        return sorted(w for w in expected
                      if ages.get(w, float("inf")) > self.ttl_s)


class DrainSignal:
    """The cross-process drain handshake: the FIRST preempted worker
    publishes the superstep edge it will drain at (``DRAIN.json``,
    atomic; first writer wins — later requests join the earlier edge if
    it is still ahead). Every worker polls `target_edge` at its own edge
    checks; all land the same edge, coordinated-snapshot there, and
    exit."""

    FILENAME = "DRAIN.json"

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    @property
    def _path(self) -> str:
        return os.path.join(self.directory, self.FILENAME)

    def request(self, edge: int, worker_id: int) -> int:
        """Request a drain at step-edge `edge`; returns the WINNING edge
        (an earlier request's edge may already be published and still
        ahead of the caller — everyone converges on one edge)."""
        cur = self.target_edge()
        if cur is not None:
            return cur
        atomic_replace(self._path, json.dumps(
            {"edge": int(edge), "worker": int(worker_id),
             "t": time.time()}).encode())
        return self.target_edge() or int(edge)

    def target_edge(self) -> Optional[int]:
        try:
            with open(self._path) as f:
                return int(json.load(f)["edge"])
        except (OSError, ValueError, KeyError):
            return None

    def clear(self):
        try:
            os.unlink(self._path)
        except OSError:
            pass


class CoordinatedCheckpoint:
    """Step-directory manager over `CoordinatedShardStore` (JAX's): one
    two-phase-committed snapshot of the trainer's logical state per
    ``step_NNNNNNNNN`` directory. Restore walks the committed steps newest
    first and falls back past any that fails sha256 / assembly checks."""

    def __init__(self, directory: str, n_workers: int = 1,
                 worker_id: int = 0, keep: int = 3,
                 commit_timeout_s: float = 60.0):
        self.directory = os.path.abspath(directory)
        self.n_workers = max(1, int(n_workers))
        self.worker_id = int(worker_id)
        self.keep = max(1, int(keep))
        self.commit_timeout_s = float(commit_timeout_s)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _store(self, step: int) -> CoordinatedShardStore:
        return CoordinatedShardStore(
            self._step_dir(step), n_workers=self.n_workers,
            worker_id=self.worker_id,
            commit_timeout_s=self.commit_timeout_s)

    def steps(self) -> List[int]:
        """Committed steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and read_commit_marker(
                    os.path.join(self.directory, name)) is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, trainer, extra: Optional[Dict] = None,
             wait_commit: bool = True,
             emulate_workers: Optional[Sequence[int]] = None) -> int:
        """Coordinated snapshot of `trainer` at its step: this worker
        writes its shards, worker 0 commits, the others wait for the
        marker (bounded: a death mid-protocol times out into
        ElasticWorkerLost, never a torn snapshot). `emulate_workers`: every
        worker id this one process writes as (worker 0 last, so its commit
        follows every durable marker)."""
        step = int(trainer.iteration_count)
        store = self._store(step)
        tree, meta = trainer.elastic_state()
        meta["n_workers"] = self.n_workers
        if extra:
            meta.update(extra)
        with elastic_snapshot_timer():
            if emulate_workers is not None:
                for w in sorted(emulate_workers, reverse=True):
                    store.write_shards(tree, meta=meta, worker_id=w)
            else:
                store.write_shards(tree, meta=meta)
            if self.worker_id == 0:
                store.commit(extra={"step": step})
                self._gc()
            elif wait_commit:
                store.wait_committed()
        return step

    def restore(self, trainer) -> Optional[int]:
        """The newest committed snapshot into `trainer` (any mesh shape),
        falling back to older committed steps; the restored step, or None
        when nothing is committed."""
        for step in reversed(self.steps()):
            store = self._store(step)
            try:
                meta = store.read_meta()
                tree = store.read_tree(
                    {"params": trainer.model.params,
                     "state": trainer.model.state,
                     "updater_state": trainer.model.updater_state})
                trainer.load_elastic_state(tree, meta)
                return step
            except Exception as e:
                log.warning(
                    "coordinated snapshot step %d unusable (%s: %s) — "
                    "falling back to an older step", step,
                    type(e).__name__, e)
        return None

    def meta(self, step: int) -> Optional[Dict]:
        try:
            return self._store(step).read_meta()
        except (OSError, ValueError):
            return None

    def _gc(self):
        import shutil
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def _strategy_for_shape(strategy: str, shape: Sequence[int]):
    """JAX's downgrade when a resize collapses the pipe axis: a (d, m, 1)
    survivor re-lands as the matching 2-D strategy (the snapshot is
    logical, so the cross-strategy restore is exact)."""
    shape = tuple(shape)
    if len(shape) == 3 and shape[2] == 1:
        if strategy == ShardingStrategy.ZERO1_TP_PP:
            return ShardingStrategy.ZERO1_TP, shape[:2]
        if strategy == ShardingStrategy.PP:
            return ShardingStrategy.REPLICATED, shape[:2]
        return strategy, shape[:2]
    return strategy, shape


class ElasticTrainer:
    """The supervision loop around `ParallelTrainer` (JAX's contract):
    heartbeat leases, coordinated edge snapshots, cross-process draining
    and deterministic resize.

    `model_factory()` returns a freshly initialized model; every resize
    builds a new model and trainer and restores the last committed
    snapshot into it. `batch_fn(step)` (or a list indexed by step) must be
    deterministic in the global step. `snapshot_every` is the edge
    cadence. `device` is each rank's device (the card unless "cpu");
    `timeout_s` bounds the re-formed process group's collectives."""

    def __init__(self, model_factory: Callable, directory: str, *,
                 mesh_shape: Optional[Sequence[int]] = None,
                 strategy: str = ShardingStrategy.REPLICATED,
                 n_workers: Optional[int] = None,
                 worker_id: Optional[int] = None,
                 devices_per_worker: Optional[int] = None,
                 emulated: Optional[bool] = None,
                 snapshot_every: int = 1, keep: int = 3,
                 lease_ttl_s: float = 5.0,
                 commit_timeout_s: float = 30.0,
                 trainer_kwargs: Optional[Dict] = None,
                 clock: Callable[[], float] = time.time,
                 device=None, timeout_s: float = 30.0):
        dist = _dist()
        world = 1 if dist is None else dist.get_world_size()
        self.model_factory = model_factory
        self.directory = os.path.abspath(directory)
        self.strategy = strategy
        self.n_workers = world if n_workers is None else max(1,
                                                              int(n_workers))
        self.worker_id = ((0 if dist is None else dist.get_rank())
                          if worker_id is None else int(worker_id))
        self.emulated = (world == 1 and self.n_workers > 1
                         if emulated is None else bool(emulated))
        if devices_per_worker is None:
            # one rank a worker; emulation spreads the wanted mesh's
            # devices over its logical workers, as JAX's does
            devices_per_worker = 1
            if self.emulated and mesh_shape is not None:
                total = 1
                for v in mesh_shape:
                    total *= int(v)
                devices_per_worker = max(1, total // self.n_workers)
        self.devices_per_worker = int(devices_per_worker)
        self.snapshot_every = max(1, int(snapshot_every))
        self.keep = keep
        self.commit_timeout_s = float(commit_timeout_s)
        self.trainer_kwargs = dict(trainer_kwargs or {})
        self.device = device
        self.timeout_s = float(timeout_s)
        self.lease = HeartbeatLease(os.path.join(self.directory, "leases"),
                                    self.worker_id, ttl_s=lease_ttl_s,
                                    clock=clock)
        self.drain = DrainSignal(self.directory)
        self._live: List[int] = list(range(self.n_workers))
        self._emulated_dead: set = set()
        self._generation = 0
        if mesh_shape is None:
            mesh_shape = (self.n_workers * self.devices_per_worker, 1)
        self._want_shape = tuple(int(v) for v in mesh_shape)
        self._preempted = False
        self._drain_edge: Optional[int] = None
        self.trainer = None
        self.mesh_shape: Optional[tuple] = None
        self._rebuild(len(self._live))

    # ------------------------------------------------------------------
    @property
    def checkpoint(self) -> CoordinatedCheckpoint:
        """The step manager of the live-worker set (the saver count is
        part of the commit contract); the worker's index among the live
        workers writes (emulation: worker 0, writing every live one)."""
        me = 0 if self.emulated else self._live.index(self.worker_id)
        return CoordinatedCheckpoint(
            os.path.join(self.directory, "steps"),
            n_workers=len(self._live), worker_id=me, keep=self.keep,
            commit_timeout_s=self.commit_timeout_s)

    def _rebuild(self, n_live: int):
        """Form the mesh on the live workers' ranks and build a fresh
        ParallelTrainer; the caller restores the last snapshot after."""
        from .trainer import ParallelTrainer

        shape = surviving_mesh_shape(n_live * self.devices_per_worker,
                                     self._want_shape)
        strategy, shape = _strategy_for_shape(self.strategy, shape)
        names = (MeshAxes.DATA, MeshAxes.MODEL, MeshAxes.PIPE)
        if self.emulated or _dist() is None:
            # one process plays the workers: its one rank, same axes
            axes = {n: 1 for n in names[:len(shape)]}
        else:
            axes = dict(zip(names, shape))
        mesh = make_mesh(axes, device=self.device)
        self.trainer = ParallelTrainer(self.model_factory(), mesh=mesh,
                                       strategy=strategy,
                                       **self.trainer_kwargs)
        self.mesh_shape = shape
        log.info("elastic: (re)formed mesh %s strategy=%s, %d live "
                 "worker(s)", shape, strategy, n_live)

    def _reform_world(self, live: List[int]):
        """Destroy the process group and re-form it among `live` (worker
        ids, renumbered in order) on a fresh file store of the next
        generation; a worker not in `live` leaves."""
        import torch.distributed as dist
        backend = str(dist.get_backend())
        if dist.is_initialized():
            dist.destroy_process_group()
        forget_groups()
        self._generation += 1
        store = os.path.join(self.directory, f"world_g{self._generation}")
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=len(live),
            rank=live.index(self.worker_id),
            timeout=datetime.timedelta(seconds=self.timeout_s))

    # ------------------------------------------------------------------
    def _snapshot(self, extra: Optional[Dict] = None) -> int:
        return self.checkpoint.save(
            self.trainer, extra=extra,
            emulate_workers=list(range(len(self._live)))
            if self.emulated else None)

    def _restore(self) -> Optional[int]:
        return self.checkpoint.restore(self.trainer)

    def _next_edge(self, step: int) -> int:
        k = self.snapshot_every
        return ((step + k - 1) // k) * k

    def _resize(self, live: List[int], *, event: str) -> None:
        """Snapshot-restore resize onto the `live` workers."""
        if self.emulated:
            for w in list(self.lease.ages()):
                self.lease.resign(w)
            self._emulated_dead.clear()
            live = list(range(len(live)))
            for w in live:
                self.lease.renew(w)
        else:
            self._reform_world(live)
        self._live = list(live)
        self._rebuild(len(live))
        restored = self._restore()
        count_elastic("resizes")
        log.warning("elastic: resized to %d worker(s) after %s; resumed "
                    "from %s", len(live), event,
                    f"step {restored}" if restored is not None
                    else "initial state")

    # -- the step barrier: a collective against a dead peer waits for the
    # group's timeout, so every worker announces its step ordinal and waits
    # (bounded by the lease TTL) for its live peers' before dispatching
    def _announce(self, step: int):
        atomic_replace(
            os.path.join(self.lease.directory,
                         f"ann_p{self.worker_id}.json"),
            json.dumps({"worker": self.worker_id,
                        "step": int(step)}).encode())

    def _peer_step(self, w: int) -> int:
        try:
            with open(os.path.join(self.lease.directory,
                                   f"ann_p{w}.json")) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError):
            return -1

    def _await_peers(self, step: int) -> List[int]:
        peers = [w for w in self._live if w != self.worker_id]
        deadline = time.monotonic() + self.lease.ttl_s
        while time.monotonic() < deadline:
            behind = [w for w in peers if self._peer_step(w) < step]
            if not behind:
                return []
            time.sleep(0.01)
        return [w for w in peers if self._peer_step(w) < step]

    def mark_worker_lost(self, worker_id: int):
        """Emulation hook: the worker's lease drops and is not renewed."""
        self._emulated_dead.add(int(worker_id))
        self.lease.resign(worker_id)

    def mark_worker_joined(self, worker_id: int):
        """Emulation hook: a returning worker renews a lease under its
        id."""
        self._emulated_dead.discard(int(worker_id))
        self.lease.renew(worker_id)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _sigterm_window(self):
        """SIGTERM sets a flag the loop turns into a drain request at its
        next edge check."""
        installed, prev = False, None

        def handler(signum, frame):
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, handler)
            installed = True
        except ValueError:
            pass  # not the main thread: drills set _preempted directly
        try:
            yield
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)

    def fit(self, batch_fn, n_steps: int, *, resume: bool = True) -> str:
        """Train until `n_steps` optimizer steps are done globally.
        Returns "completed", "drained" (every live worker snapshotted the
        same edge) or "worker_lost" (the world could not re-form)."""
        if isinstance(batch_fn, (list, tuple)):
            batches = batch_fn
            batch_fn = lambda step: batches[step % len(batches)]
        if resume:
            restored = self.checkpoint.restore(self.trainer)
            if restored is not None:
                meta = self.checkpoint.meta(restored) or {}
                savers = int(meta.get("n_workers", len(self._live)))
                if savers != len(self._live):
                    count_elastic("resizes")
                    if savers < len(self._live):
                        count_elastic("rejoins")
                    log.info("elastic: restored step %d written by %d "
                             "worker(s) onto %d live worker(s)", restored,
                             savers, len(self._live))
        stale = self.drain.target_edge()
        if stale is not None and self.trainer.iteration_count >= stale:
            # the previous generation's drain landed (we restored at or
            # past its edge): a new generation starts clean
            self.drain.clear()
            self._preempted = False
            self._drain_edge = None
        with self._sigterm_window():
            try:
                return self._fit_loop(batch_fn, n_steps)
            except (ElasticWorkerLost, RuntimeError) as e:
                if not isinstance(e, ElasticWorkerLost) \
                        and not _is_peer_loss(e):
                    raise
                count_elastic("worker_losses")
                log.error("elastic: peer lost (%s) — exiting; last "
                          "committed step %s", e,
                          self.checkpoint.latest_step())
                self.lease.resign()
                return "worker_lost"

    def _fit_loop(self, batch_fn, n_steps: int) -> str:
        while self.trainer.iteration_count < n_steps:
            step = self.trainer.iteration_count
            if self.emulated:
                for w in self._live:
                    if w not in self._emulated_dead:
                        self.lease.renew(w)
            else:
                self.lease.renew()
            fire_crash_point(STEP_POINT, step=step, worker=self.worker_id)
            # -- drain handshake (every step boundary) ----------------
            if self._preempted and self._drain_edge is None:
                self._drain_edge = self.drain.request(
                    self._next_edge(step), self.worker_id)
                count_elastic("drains")
                log.warning("elastic: preemption notice — draining at "
                            "edge %d", self._drain_edge)
            target = self.drain.target_edge()
            if target is not None and step >= target:
                self._snapshot(extra={"drained": True})
                self.lease.resign()
                return "drained"
            # -- liveness ---------------------------------------------
            if self.emulated:
                active = self.lease.active_workers() or [self.worker_id]
                lost = [w for w in self._live if w not in active]
                if lost:
                    count_elastic("worker_losses", len(lost))
                    self._resize(active, event=f"loss of worker(s) {lost}")
                    continue
                if len(active) > len(self._live):
                    count_elastic("rejoins", len(active) - len(self._live))
                    if step > (self.checkpoint.latest_step() or -1):
                        self._snapshot()
                    self._resize(active, event="worker join")
                    continue
            elif len(self._live) > 1:
                # a stale lease is a lost peer; a lease not yet written (a
                # peer still starting) is left to the step barrier
                written = self.lease.ages()
                lost = [w for w in self.lease.lost_workers(
                    [w for w in self._live if w != self.worker_id])
                    if w in written]
                if not lost:
                    self._announce(step)
                    lost = self._await_peers(step)
                if lost:
                    count_elastic("worker_losses", len(lost))
                    if _dist() is None:
                        # no process group to re-form (a worker driven
                        # alone): JAX's exit for a generation restart
                        self.lease.resign()
                        return "worker_lost"
                    live = [w for w in self._live if w not in lost]
                    self._resize(live, event=f"loss of worker(s) {lost}")
                    continue
            # -- one optimizer step ----------------------------------
            self.trainer.fit(batch_fn(step))
            if self.trainer.iteration_count % self.snapshot_every == 0:
                self._snapshot()
        if self.trainer.iteration_count % self.snapshot_every:
            self._snapshot()
        self.lease.resign()
        return "completed"


def _is_peer_loss(e: RuntimeError) -> bool:
    """A collective that failed because a peer went away (gloo's
    connection errors and timeouts)."""
    msg = str(e).lower()
    return any(w in msg for w in ("connection", "timed out", "timeout",
                                  "peer", "closed"))
