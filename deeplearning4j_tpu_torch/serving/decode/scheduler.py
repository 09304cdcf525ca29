"""Token-granularity continuous batching (Orca, Yu et al., OSDI 2022)
over the paged decode engine (the port of
`deeplearning4j_tpu/serving/decode/scheduler.py`; host code, the same as
JAX's but for the CUDA graphs it has the engine prepare).

One worker thread per generate-enabled servable runs the generation
loop: admit waiting sequences, grow/evict KV blocks, run ONE decode
tick, sample, retire finished rows, repeat. The load-bearing property
is WHERE admission happens: between every tick (token granularity), so
a new request starts decoding the moment a batch slot and KV blocks
exist instead of waiting for the whole current batch to drain — that
is the continuous-vs-static tokens/s gap the bench measures.

Invariant per sequence: ``ctx`` is prompt + every sampled token, and
``cached`` counts how many of ctx's K/V live in the arena. Prefill
caches all of ctx at once and samples token ``len(ctx)``; each tick
feeds ``ctx[cached]`` at position ``cached`` and samples the next.
Eviction (KV-block pressure) just frees the blocks and sets
``cached = 0`` — on re-admission the sequence re-prefills its whole ctx
and continues, so a greedy sequence is reproducible across evictions.

Batch composition per tick goes through the serving batcher's
`FlushEma` (per-bucket tick-wall-time EMAs): with `avail` live rows it
either pads up to the next decode bucket or runs the largest full
bucket now, whichever maximizes rows/s — the DynamicBatcher flush
policy generalized to the decode plane. A rotating offset keeps row
selection fair when only a sub-batch runs.

On the card each tick replays a CUDA graph captured for (pool, version,
bucket). The scheduler has the engine capture them for its arm's version
when it starts, and, through the registry's version listeners, for every
version about to serve its arm before that version goes live, so no
request waits on a capture; the graphs of a version it has moved off are
dropped.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...telemetry.recorder import flight_recorder
from ..batcher import FlushEma
from ..registry import ServingError
from .cache import OutOfBlocksError
from .engine import DecodeEngine

__all__ = ["GenerationScheduler", "GenerationError"]


class GenerationError(ServingError):
    """A generation request failed (bad arguments, scheduler closed, or
    a sequence could not hold its KV blocks)."""


class _Seq:
    __slots__ = ("sid", "ctx", "prompt_len", "max_tokens", "temperature",
                 "stop_ids", "rng", "blocks", "cached", "event", "result",
                 "error", "trace", "enqueued_at")

    def __init__(self, sid, prompt, max_tokens, temperature, stop_ids, seed,
                 trace=None):
        self.sid = sid
        self.ctx: List[int] = list(prompt)
        self.prompt_len = len(prompt)
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.stop_ids = frozenset(stop_ids)
        self.rng = np.random.default_rng(sid if seed is None else seed)
        self.blocks: List[int] = []
        self.cached = 0                 # ctx tokens whose K/V are cached
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.error: Optional[Exception] = None
        self.trace = trace              # TraceContext, or None
        self.enqueued_at = time.perf_counter()

    @property
    def generated(self) -> List[int]:
        return self.ctx[self.prompt_len:]


class GenerationScheduler:
    """Continuous-batching generation loop for one servable.

    `mode="continuous"` admits between every tick; `mode="static"`
    (the bench's control arm) only refills once the running set fully
    drains — classic request-level batching."""

    def __init__(self, registry, name: str, *, mode: str = "continuous",
                 block_len: int = 16, num_blocks: Optional[int] = None,
                 kv_dtype: str = "fp32",
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 prompt_buckets: Optional[Sequence[int]] = None,
                 metrics=None, idle_wait_s: float = 0.02,
                 arm: str = "stable"):
        if mode not in ("continuous", "static"):
            raise GenerationError(f"mode must be continuous|static, "
                                  f"got {mode!r}")
        self.name = name
        self.mode = mode
        # canary arm this scheduler serves: a "canary" scheduler
        # resolves the candidate version each tick (falling back to
        # stable after a rollback — the existing flush-on-version-change
        # path then restarts its running sequences on the stable version)
        self.arm = arm
        self.registry = registry
        self.engine = DecodeEngine(
            registry, name, block_len=block_len, num_blocks=num_blocks,
            kv_dtype=kv_dtype, decode_buckets=decode_buckets,
            prompt_buckets=prompt_buckets)
        self.pool = self.engine.new_pool(metrics)
        self._ema = FlushEma()
        self._idle_wait_s = idle_wait_s
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._waiting: deque = deque()
        self._running: List[_Seq] = []
        self._closed = False
        self._ids = itertools.count(1)
        self._rotate = 0
        self._version = None
        self._tokens_c = self._admit_c = self._evict_c = None
        self._phase_h = None
        if metrics is not None:
            self._tokens_c = metrics.counter(
                "dl4j_decode_tokens_total", "generated tokens",
                labels=("model",))
            self._admit_c = metrics.counter(
                "dl4j_decode_admissions_total",
                "sequences admitted to the decode batch", labels=("model",))
            self._evict_c = metrics.counter(
                "dl4j_decode_evictions_total",
                "sequences preempted for KV-block pressure",
                labels=("model",))
            self._phase_h = metrics.histogram(
                "dl4j_decode_phase_seconds",
                "wall seconds per compiled generation step",
                labels=("model", "phase"))
        # listen first: a version flipped in while this one is being
        # prepared gets its graphs from the listener
        add_listener = getattr(registry, "add_listener", None)
        if add_listener is not None:
            add_listener(name, self._on_version)
        try:
            self.engine.prepare(self._resolve_version(), self.pool)
        except BaseException:
            if add_listener is not None:
                registry.remove_listener(name, self._on_version)
            raise
        self._worker = threading.Thread(
            target=self._run,
            name=(f"dl4j-decode-sched-{name}" if arm == "stable"
                  else f"dl4j-decode-sched-{name}-{arm}"),
            daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------
    def submit(self, prompt: Sequence[int], *, max_tokens: int = 16,
               temperature: float = 0.0, stop: Sequence[int] = (),
               seed: Optional[int] = None,
               timeout: Optional[float] = None, ctx=None) -> Dict:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise GenerationError("prompt must be non-empty")
        if max_tokens < 1:
            raise GenerationError("max_tokens must be >= 1")
        if len(prompt) >= self.engine.max_context:
            raise GenerationError(
                f"prompt of {len(prompt)} tokens leaves no room in the "
                f"context window ({self.engine.max_context})")
        with self._lock:
            if self._closed:
                raise GenerationError(f"{self.name}: scheduler is stopped")
            seq = _Seq(next(self._ids), prompt, int(max_tokens),
                       float(temperature), [int(t) for t in stop], seed,
                       trace=ctx)
            self._waiting.append(seq)
        self._wake.set()
        if not seq.event.wait(timeout):
            raise TimeoutError(f"{self.name}: generation timed out")
        if seq.error is not None:
            raise seq.error
        return seq.result

    def stop(self, drain: bool = True):
        with self._lock:
            self._closed = True
            if not drain:
                while self._waiting:
                    self._fail(self._waiting.popleft(),
                               GenerationError("scheduler stopped"))
        self._wake.set()
        self._worker.join()
        remove = getattr(self.registry, "remove_listener", None)
        if remove is not None:
            remove(self.name, self._on_version)
        with self.pool.graph_lock:
            self.pool.graphs.clear()

    def _on_version(self, event: str, version):
        """Registry listener, before a flip: capture `version`'s graphs if
        it is about to serve this scheduler's arm (a failure aborts the
        flip)."""
        serves = (("swap", "promote") if self.arm == "stable"
                  else ("canary",))
        if event in serves and not self._closed:
            self.engine.prepare(version, self.pool)

    # -- worker side -----------------------------------------------------
    def _finish(self, seq: _Seq, reason: str):
        t0 = time.perf_counter()
        self.pool.release(seq.blocks)
        seq.blocks = []
        seq.result = {"tokens": seq.generated, "finish_reason": reason,
                      "prompt_tokens": seq.prompt_len,
                      "generated_tokens": len(seq.generated)}
        if seq.trace is not None:
            # emitted BEFORE event.set(): the waiter wakes to a complete
            # trace (queue -> prefill -> ticks -> scatter) in the buffer
            seq.trace.emit("scatter", t0, time.perf_counter(),
                           model=self.name, finish_reason=reason,
                           generated=len(seq.generated))
        seq.event.set()

    def _fail(self, seq: _Seq, err: Exception):
        self.pool.release(seq.blocks)
        seq.blocks = []
        seq.error = err
        seq.event.set()

    def _sample(self, seq: _Seq, logits: np.ndarray) -> int:
        if seq.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits.astype(np.float64) / seq.temperature
        z -= z.max()
        p = np.exp(z)
        return int(seq.rng.choice(len(p), p=p / p.sum()))

    def _append_sample(self, seq: _Seq, logits: np.ndarray) -> bool:
        """Sample the next token; True if the sequence is finished."""
        tok = self._sample(seq, logits)
        if self._tokens_c is not None:
            self._tokens_c.inc(model=self.name)
        if tok in seq.stop_ids:
            self._finish(seq, "stop")
            return True
        seq.ctx.append(tok)
        if len(seq.generated) >= seq.max_tokens:
            self._finish(seq, "length")
            return True
        if len(seq.ctx) >= self.engine.max_context:
            self._finish(seq, "context")
            return True
        return False

    def _evict_one(self, keep: _Seq) -> bool:
        """Preempt the NEWEST running sequence other than `keep` back to
        the waiting queue (its blocks freed; it will re-prefill)."""
        victims = [s for s in self._running if s is not keep]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.sid)
        self._running.remove(victim)
        self.pool.release(victim.blocks)
        victim.blocks = []
        victim.cached = 0
        victim.enqueued_at = time.perf_counter()   # re-queued: wait restarts
        with self._lock:
            self._waiting.appendleft(victim)
        if self._evict_c is not None:
            self._evict_c.inc(model=self.name)
        rec = flight_recorder()
        if rec.enabled:
            rec.record("decode/evict", model=self.name, sid=victim.sid,
                       kept_sid=keep.sid, ctx_len=len(victim.ctx),
                       free_blocks=self.pool.free_blocks())
        return True

    def _reserve(self, seq: _Seq, n_tokens: int) -> bool:
        """Grow seq's block table to cover `n_tokens` cache slots,
        evicting neighbours under pressure. False = impossible even
        alone (seq is failed)."""
        while True:
            need = self.engine.spec.blocks_for(n_tokens) - len(seq.blocks)
            if need <= 0:
                return True
            try:
                seq.blocks.extend(self.pool.alloc(need))
                return True
            except OutOfBlocksError as e:
                if not self._evict_one(seq):
                    if seq in self._running:
                        self._running.remove(seq)
                    self._fail(seq, GenerationError(str(e)))
                    return False

    def _flush_running(self):
        """Version swapped under us: preempt everything (sequences keep
        their ctx and re-prefill against the new weights)."""
        rec = flight_recorder()
        if rec.enabled and self._running:
            rec.record("decode/swap_flush", model=self.name,
                       preempted=len(self._running),
                       free_blocks=self.pool.free_blocks())
        for seq in list(self._running):
            self._running.remove(seq)
            self.pool.release(seq.blocks)
            seq.blocks = []
            seq.cached = 0
            seq.enqueued_at = time.perf_counter()
            with self._lock:
                self._waiting.appendleft(seq)

    def _admit(self, v):
        cap = self.engine.decode_buckets[-1]
        while True:
            with self._lock:
                if not self._waiting or len(self._running) >= cap:
                    return
                if self.mode == "static" and self._running:
                    return
                seq = self._waiting.popleft()
            if not self._reserve(seq, len(seq.ctx)):
                continue
            t0 = time.perf_counter()
            if seq.trace is not None:
                # enqueue (or eviction re-queue) -> admission
                seq.trace.emit("queue_wait", seq.enqueued_at, t0,
                               model=self.name, sid=seq.sid,
                               ctx_len=len(seq.ctx))
            try:
                logits = self.engine.run_prefill(v, self.pool, seq.ctx,
                                                 seq.blocks, ctx=seq.trace)
            except Exception as e:          # noqa: BLE001 - fail the seq
                self._fail(seq, e)
                continue
            if self._phase_h is not None:
                self._phase_h.observe(time.perf_counter() - t0,
                                      model=self.name, phase="prefill")
            if self._admit_c is not None:
                self._admit_c.inc(model=self.name)
            rec = flight_recorder()
            if rec.enabled:
                # KV-pool pressure at the admission decision point
                rec.record("decode/admit", model=self.name, sid=seq.sid,
                           prompt_len=seq.prompt_len,
                           blocks=len(seq.blocks),
                           free_blocks=self.pool.free_blocks())
            seq.cached = len(seq.ctx)
            if not self._append_sample(seq, logits):
                self._running.append(seq)

    def _tick(self, v):
        # room for each row's next slot BEFORE composing the batch, so
        # an eviction never invalidates a row already in the padded step
        for seq in list(self._running):
            if seq in self._running:        # _reserve may evict/fail rows
                self._reserve(seq, seq.cached + 1)
        if not self._running:
            return
        avail = len(self._running)
        rows = self._ema.pick_rows(avail, list(self.engine.decode_buckets),
                                   self.engine.decode_buckets[-1])
        order = (self._running[self._rotate % avail:]
                 + self._running[:self._rotate % avail])
        batch = order[:rows]
        self._rotate += rows
        bucket = self.engine.decode_bucket_for(len(batch))
        t0 = time.perf_counter()
        logits = self.engine.run_tick(
            v, self.pool, [s.ctx[s.cached] for s in batch],
            [s.cached for s in batch], [s.blocks for s in batch], bucket,
            ctxs=[s.trace for s in batch])
        dt = time.perf_counter() - t0
        self._ema.observe(bucket, dt)
        if self._phase_h is not None:
            self._phase_h.observe(dt, model=self.name, phase="decode")
        for seq, row in zip(batch, logits):
            seq.cached += 1
            if self._append_sample(seq, row):
                self._running.remove(seq)

    def _resolve_version(self):
        """The version this scheduler's arm serves this tick. Canary
        schedulers resolve through the registry's arm routing (which
        falls back to stable once the canary is promoted or rolled
        back); registries without the canary surface (ducks in tests)
        resolve the plain current version."""
        arm_version = getattr(self.registry, "arm_version", None)
        if arm_version is not None:
            return arm_version(self.name, self.arm)
        return self.registry.get(self.name)

    def _run(self):
        while True:
            # idle wait happens on the Event, never under self._lock, so
            # submit()/stop() can always get in to enqueue or close
            while True:
                with self._lock:
                    idle = not self._waiting and not self._running
                    closed = self._closed
                if not idle:
                    break
                if closed:
                    return
                self._wake.wait(self._idle_wait_s)
                self._wake.clear()
            try:
                v = self._resolve_version()
                if self._version is not v:
                    self._flush_running()
                    self.engine.release_graphs(self.pool, v)
                    self._version = v
                self._admit(v)
                self._tick(v)
            except Exception as e:          # noqa: BLE001 - never die quietly
                for seq in list(self._running):
                    self._running.remove(seq)
                    self._fail(seq, e)
                with self._lock:
                    while self._waiting:
                        self._fail(self._waiting.popleft(), e)
