"""ContinualTrainer: the supervised train-to-serve loop (the port of
`deeplearning4j_tpu/continual/trainer.py`).

One `run_cycle()` is one candidate's life:

        topic (committed offset)
              │ consume window
              ▼
        fine-tune candidate          TrainingGuard: non-finite
        (restored from stable ckpt)  batches skipped + counted
              │ save cand ckpt (atomic zip)
              ▼
        journal `window` ── commit consumer offset
              │
              ▼
        held-out gate  ── fail ──► journal `rolled_back {gate_fail}`
              │ pass
              ▼
        canary: deterministic N% of live traffic on the candidate
        (journal `canary`); per-arm latency / errors / SLO breaches
              │ CanaryPolicy.decide
              ▼
        journal `promoted` / `rolled_back`   ◄── THE commit point
              │
              ▼
        registry.promote_canary / rollback_canary

Crash-consistency contract: every durable effect (candidate checkpoint,
journal record, consumer-offset commit, registry flip) is ordered so a
crash at ANY boundary restarts into a consistent state:

  * a window is "trained" exactly when its `window` record is durable —
    crash before it retrains from the committed offset (no skip), crash
    after it never replays (recovery seeks past `end` even if the offset
    commit itself was lost);
  * a decision is taken exactly when its `promoted`/`rolled_back`
    record is durable — the registry flip is a pure function of the
    journal, replayed idempotently by `recover()`;
  * an undecided (mid-gate / mid-canary) cycle is closed as
    `rolled_back {crash_recovery}` on restart — an ungated or undecided
    candidate is NEVER served after a crash.

Every boundary fires a `fault/` crash point (``continual/*``), so a drill
can kill the loop at each one and check the contract.

The trainer works on its registry's device: the stable and candidate zips
are restored there, and each window's `fit` (with `superstep`, the guard
and `pad_ragged`) runs there, so on the card a window is replayed from the
step's CUDA graphs. The zips and the journal are the JAX package's formats:
a loop started by either package recovers in the other.
"""
from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.iterators import ArrayDataSetIterator, DataSet
from ..datasets.pipeline import split_xy
from ..fault.guard import TrainingGuard
from ..fault.injection import fire_crash_point
from ..serving.registry import (AotCompileError, ModelRegistry,
                                ServableVersion, load_source)
from ..streaming.topic import FileTopic, TopicConsumer
from ..util.serializer import ModelSerializer
from . import metrics as _m
from .canary import CanaryPolicy
from .journal import ContinualJournal

__all__ = ["ContinualTrainer"]


class ContinualTrainer:
    """Continual fine-tune -> gate -> canary -> promote/rollback loop
    for one servable.

    registry/name:    the serving plane this loop operates; its device is
                      where the loop restores, trains and scores.
    topic:            the FileTopic carrying training records (each record
                      a `[rows, feature_width + n_out]` array; see
                      `feature_width`/`record_to_dataset`).
    workdir:          journal + checkpoint directory. The journal at
                      `<workdir>/journal.jsonl` IS the loop's durable
                      state; a new ContinualTrainer over the same workdir
                      resumes exactly where the last one crashed.
    gate_set:         held-out DataSet every candidate must not regress
                      on (`candidate score <= stable score + gate_margin`,
                      lower is better, NaN always fails).
    initial_source:   stable v1 when the journal is empty (model object
                      or checkpoint path — anything `load_source` takes).
    feature_width:    split point for the default record decoder
                      (`datasets.pipeline.split_xy`); pass
                      `record_to_dataset` instead for custom records.
    guard_policy:     TrainingGuard policy for window fine-tunes (None
                      disables the guard — a NaN window then poisons the
                      candidate and the GATE rejects it).
    traffic_hook:     optional callable invoked once per canary poll —
                      lets single-threaded drills (and the demo) pump
                      synthetic traffic while the loop waits for canary
                      stats.
    """

    def __init__(self, registry: ModelRegistry, name: str, topic: FileTopic,
                 *, workdir: str, gate_set: DataSet, initial_source=None,
                 feature_width: Optional[int] = None,
                 record_to_dataset: Optional[Callable] = None,
                 window_records: int = 4, batch_size: int = 32,
                 epochs: int = 1, superstep=1,
                 gate_margin: float = 0.0,
                 canary_fraction: float = 0.2,
                 canary_policy: Optional[CanaryPolicy] = None,
                 canary_timeout_s: float = 30.0,
                 canary_poll_s: float = 0.02,
                 guard_policy: Optional[str] = "skip_batch",
                 group: str = "continual",
                 buckets: Optional[Sequence[int]] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 traffic_hook: Optional[Callable[[], None]] = None,
                 fsync_journal: bool = True):
        if record_to_dataset is None and feature_width is None:
            raise ValueError(
                "pass feature_width (default split_xy decoder) or a "
                "custom record_to_dataset")
        self.registry = registry
        self.name = name
        self.topic = topic
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.journal = ContinualJournal(
            os.path.join(self.workdir, "journal.jsonl"),
            fsync=fsync_journal)
        self.gate_set = gate_set
        self.initial_source = initial_source
        self.feature_width = feature_width
        self.record_to_dataset = record_to_dataset
        self.window_records = max(1, int(window_records))
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.superstep = superstep
        self.gate_margin = float(gate_margin)
        self.canary_fraction = float(canary_fraction)
        self.policy = canary_policy or CanaryPolicy()
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_poll_s = float(canary_poll_s)
        self.guard_policy = guard_policy
        self.group = group
        self.buckets = buckets
        self.input_shape = input_shape
        self.traffic_hook = traffic_hook
        self.cycle = 0
        self.stable_ckpt: Optional[str] = None
        self.stable_score: Optional[float] = None
        self._stable_model = None
        self.consumer: Optional[TopicConsumer] = None
        self.promotions = 0
        self.rollbacks = 0
        self._recovered = False

    @property
    def device(self):
        return self.registry.device

    def _restore(self, ckpt: str):
        return ModelSerializer.restore(ckpt, device=self.device)

    # -- recovery ---------------------------------------------------------
    def recover(self) -> ServableVersion:
        """Replay the journal into a consistent running state and
        (re)register the stable servable: the LAST `promoted` record is
        the stable checkpoint (bit-exact restore), any open cycle is
        closed as `rolled_back {crash_recovery}`, and the consumer
        resumes past every journaled window — trained windows are never
        replayed, untrained ones never skipped. Idempotent; must be
        called (once) before `run_cycle`."""
        records = self.journal.replay()
        last_promoted: Optional[Dict] = None
        open_cycle: Optional[int] = None
        max_window_end = 0
        max_cycle = 0
        for rec in records:
            cyc = int(rec.get("cycle", 0))
            max_cycle = max(max_cycle, cyc)
            kind = rec["kind"]
            if kind == "promoted":
                last_promoted, open_cycle = rec, None
            elif kind == "rolled_back":
                open_cycle = None
            elif kind in ("window", "gate", "canary"):
                open_cycle = cyc
                if kind == "window":
                    max_window_end = max(max_window_end, int(rec["end"]))

        if last_promoted is None:
            # bootstrap: install initial_source as stable v1. A crash
            # between the checkpoint write and the journal append redoes
            # the bootstrap (the ckpt write is atomic and idempotent)
            if self.initial_source is None:
                raise ValueError(
                    f"{self.name}: empty journal and no initial_source — "
                    "nothing to serve")
            model, _ = load_source(self.initial_source, self.device)
            if getattr(model, "params", None) is None:
                model.init()
            ckpt = os.path.join(self.workdir, "stable_boot.zip")
            ModelSerializer.write_model(model, ckpt)
            offset0 = int(self.topic.committed(self.group))
            last_promoted = self.journal.append(
                "promoted", cycle=0, ckpt=ckpt, offset=offset0, score=None)
            # a model object handed in on another device is scored from its
            # checkpoint on the loop's device
            if getattr(model, "device", self.device).type == \
                    self.device.type:
                self._stable_model = model
        if open_cycle is not None:
            # an undecided candidate (mid-fine-tune/gate/canary at crash
            # time) is discarded — it must never be served
            self.journal.append("rolled_back", cycle=open_cycle,
                                reason="crash_recovery")
            self.rollbacks += 1
            _m.count_rollback("crash_recovery")

        self.stable_ckpt = last_promoted["ckpt"]
        sc = last_promoted.get("score")
        self.stable_score = None if sc is None else float(sc)
        if self._stable_model is None:
            self._stable_model = self._restore(self.stable_ckpt)
        # a stale in-process canary (same registry object across a
        # simulated restart) is an undecided candidate too
        if self.registry.canary_state(self.name) is not None:
            self.registry.rollback_canary(self.name)
        version = self.registry.register(
            self.name, self._stable_model, buckets=self.buckets,
            input_shape=self.input_shape)
        fire_crash_point("continual/stable_registered", model=self.name,
                         version=version.version)

        # trained windows are durable in the journal even when the crash
        # beat the offset commit: resume past BOTH
        resume = max(int(self.topic.committed(self.group)),
                     int(last_promoted.get("offset", 0)), max_window_end)
        self.consumer = TopicConsumer(self.topic, self.group)
        self.consumer.seek(resume)
        self.topic.commit(self.group, resume)
        self.cycle = max_cycle + 1
        self._recovered = True
        return version

    # -- one cycle --------------------------------------------------------
    def run_cycle(self, poll_timeout_s: float = 0.0) -> Optional[Dict]:
        """Consume one fresh window and take one candidate through
        fine-tune -> gate -> canary -> decision. Returns a result dict
        (`outcome` one of promoted|rolled_back) or None when the topic had
        no fresh records within `poll_timeout_s`."""
        if not self._recovered:
            raise RuntimeError("call recover() before run_cycle()")
        cycle = self.cycle
        t_cycle = time.monotonic()
        start, end, arrays = self._consume_window(poll_timeout_s)
        if not arrays:
            return None
        fire_crash_point("continual/window_consumed", cycle=cycle,
                         start=start, end=end)
        self.cycle += 1

        candidate, batches, skipped, nonfinite = self._fine_tune(arrays)
        fire_crash_point("continual/window_trained", cycle=cycle,
                         batches=batches, skipped=skipped)
        cand_ckpt = os.path.join(self.workdir, f"cand_{cycle:05d}.zip")
        ModelSerializer.write_model(candidate, cand_ckpt)
        fire_crash_point("continual/candidate_saved", cycle=cycle,
                         ckpt=cand_ckpt)

        # THE window commit: from here this window counts as trained
        self.journal.append("window", cycle=cycle, start=start, end=end,
                            batches=batches, skipped=skipped,
                            nonfinite=nonfinite)
        fire_crash_point("continual/window_record", cycle=cycle)
        self.topic.commit(self.group, end)
        fire_crash_point("continual/offset_committed", cycle=cycle,
                         offset=end)

        if skipped >= batches:
            # the guard skipped the whole window (all non-finite): nothing
            # was learned, so no gate or canary for a bit-identical
            # candidate
            _m.count_window("skipped")
            return self._rollback(cycle, "empty_window", cand_ckpt)
        _m.count_window("trained")

        cand_score = float(candidate.score(self.gate_set))
        stable_score = self._stable_gate_score()
        passed = (math.isfinite(cand_score)
                  and cand_score <= stable_score + self.gate_margin)
        self.journal.append("gate", cycle=cycle, passed=passed,
                            cand_score=cand_score,
                            stable_score=stable_score)
        fire_crash_point("continual/gate_record", cycle=cycle,
                         passed=passed)
        _m.count_gate("pass" if passed else "fail")
        if not passed:
            return self._rollback(cycle, "gate_fail", cand_ckpt)

        try:
            cand_v = self.registry.start_canary(
                self.name, candidate, fraction=self.canary_fraction,
                buckets=self.buckets, input_shape=self.input_shape)
        except AotCompileError:
            # structured rejection: the live version and the runner cache
            # are untouched; the loop records why and keeps serving stable
            return self._rollback(cycle, "compile_failed", cand_ckpt)
        self.journal.append("canary", cycle=cycle, version=cand_v.version,
                            fraction=self.canary_fraction)
        fire_crash_point("continual/canary_started", cycle=cycle,
                         version=cand_v.version)

        decision = self._watch_canary(cand_score - stable_score)
        if decision[0] != "promote":
            return self._rollback(cycle, decision[1] or "timeout",
                                  cand_ckpt)

        # THE decision commit: journal first, then the (idempotent,
        # journal-replayable) registry flip
        self.journal.append("promoted", cycle=cycle, ckpt=cand_ckpt,
                            offset=end, score=cand_score)
        fire_crash_point("continual/decision_record", cycle=cycle,
                         decision="promote")
        self.registry.promote_canary(self.name)
        fire_crash_point("continual/decision_applied", cycle=cycle,
                         decision="promote")
        self.stable_ckpt = cand_ckpt
        self.stable_score = cand_score
        self._stable_model = candidate
        self.promotions += 1
        _m.count_promotion()
        _m.observe_promotion_latency(time.monotonic() - t_cycle)
        return {"cycle": cycle, "outcome": "promoted",
                "version": cand_v.version, "score": cand_score,
                "window": (start, end)}

    def run(self, max_cycles: Optional[int] = None,
            poll_timeout_s: float = 0.5) -> List[Dict]:
        """Cycle until the topic runs dry (or `max_cycles`); returns the
        per-cycle results."""
        out: List[Dict] = []
        while max_cycles is None or len(out) < max_cycles:
            res = self.run_cycle(poll_timeout_s=poll_timeout_s)
            if res is None:
                break
            out.append(res)
        return out

    def status(self) -> Dict:
        return {
            "model": self.name, "next_cycle": self.cycle,
            "stable_ckpt": self.stable_ckpt,
            "stable_score": self.stable_score,
            "position": None if self.consumer is None
            else self.consumer.position,
            "committed": int(self.topic.committed(self.group)),
            "promotions": self.promotions, "rollbacks": self.rollbacks,
        }

    # -- internals --------------------------------------------------------
    def _consume_window(self, poll_timeout_s: float
                        ) -> Tuple[int, int, List[np.ndarray]]:
        start = int(self.consumer.position)
        arrays: List[np.ndarray] = []
        while len(arrays) < self.window_records:
            arr = self.consumer.take(
                timeout=poll_timeout_s if not arrays else 0)
            if arr is None:
                break
            arrays.append(arr)
        return start, int(self.consumer.position), arrays

    def _decode(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self.record_to_dataset is not None:
            return self.record_to_dataset(arr)
        return split_xy(arr, self.feature_width)

    def _fine_tune(self, arrays: List[np.ndarray]):
        xs, ys = zip(*(self._decode(a) for a in arrays))
        x = np.concatenate(xs) if len(xs) > 1 else xs[0]
        y = np.concatenate(ys) if len(ys) > 1 else ys[0]
        candidate = self._restore(self.stable_ckpt)
        guard = (None if self.guard_policy is None else
                 TrainingGuard(policy=self.guard_policy, refresh_every=1))
        it = ArrayDataSetIterator(x, y, batch_size=self.batch_size)
        steps0 = candidate.iteration_count
        candidate.fit(it, epochs=self.epochs, superstep=self.superstep,
                      pad_ragged=True, guard=guard)
        batches = self.epochs * max(
            1, -(-int(x.shape[0]) // self.batch_size))
        # the guard counts a skipped superstep window as one skip; the steps
        # it undid are the batches the candidate did not keep
        kept = candidate.iteration_count - steps0
        skipped = (0 if guard is None else
                   max(int(guard.skipped_batches), batches - kept))
        nonfinite = 0 if guard is None else int(guard.nonfinite_steps)
        return candidate, batches, skipped, nonfinite

    def _stable_gate_score(self) -> float:
        if self.stable_score is None:
            self.stable_score = float(
                self._stable_model.score(self.gate_set))
        return self.stable_score

    def _watch_canary(self, score_drift: float
                      ) -> Tuple[str, Optional[str]]:
        deadline = time.monotonic() + self.canary_timeout_s
        while True:
            if self.traffic_hook is not None:
                self.traffic_hook()
            cs = self.registry.canary_state(self.name)
            if cs is None:
                # somebody (an operator via POST /canary) decided for us
                return ("rollback", "external")
            decision = self.policy.decide(cs.stats(),
                                          score_drift=score_drift)
            if decision is not None:
                return decision
            if time.monotonic() >= deadline:
                return ("rollback", "timeout")
            time.sleep(self.canary_poll_s)

    def _rollback(self, cycle: int, reason: str,
                  cand_ckpt: Optional[str]) -> Dict:
        self.journal.append("rolled_back", cycle=cycle, reason=reason)
        fire_crash_point("continual/decision_record", cycle=cycle,
                         decision="rollback", reason=reason)
        if self.registry.canary_state(self.name) is not None:
            self.registry.rollback_canary(self.name)
        fire_crash_point("continual/decision_applied", cycle=cycle,
                         decision="rollback", reason=reason)
        self.rollbacks += 1
        _m.count_rollback(reason)
        if cand_ckpt is not None:
            try:
                os.remove(cand_ckpt)   # never promoted; reclaim the zip
            except OSError:
                pass
        return {"cycle": cycle, "outcome": "rolled_back",
                "reason": reason}


# ---------------------------------------------------------------------------
# Demo: one rep of the loop end to end
# ---------------------------------------------------------------------------
def _demo(device=None) -> int:
    """Bootstrap a stable servable on `device`, publish an IMPROVEMENT
    window (promotion expected), then a poisoned NaN window without the
    guard (the gate rolls it back), and check that the stable version is
    untouched by the rollback. Prints a JSON summary; returns an exit
    code."""
    import json
    import tempfile

    from ..nn.conf import InputType, NeuralNetConfiguration
    from ..nn.layers import DenseLayer, OutputLayer
    from ..nn.multilayer import MultiLayerNetwork
    from ..nn.updaters import Sgd
    from ..streaming.topic import TopicPublisher
    from ..telemetry import runtime as tel_runtime

    n_in, n_out = 6, 3
    rng = np.random.default_rng(7)
    w_true = rng.normal(size=(n_in, n_out)).astype(np.float32)

    def batch(n, seed):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n, n_in)).astype(np.float32)
        y = np.eye(n_out, dtype=np.float32)[(x @ w_true).argmax(1)]
        return x, y

    def net(seed):
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Sgd(0.1)).list()
                .layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=n_out, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(n_in)).build())
        return MultiLayerNetwork(conf, device=device).init()

    with tempfile.TemporaryDirectory() as d, tel_runtime.enabled() as tel:
        topic = FileTopic(d, "windows")
        pub = TopicPublisher(topic)
        gx, gy = batch(64, seed=100)
        gate = DataSet(gx, gy)
        reg = ModelRegistry(buckets=(1, 8, 32), device=device,
                            metrics=tel.registry)

        def traffic():
            x, _ = batch(4, seed=int(time.monotonic() * 1e6) % 100000)
            for row in x:
                arm = reg.route_arm("demo")
                t0 = time.perf_counter()
                reg.predict("demo", row[None], arm=arm)
                reg.observe_canary("demo", arm,
                                   latency_s=time.perf_counter() - t0)

        trainer = ContinualTrainer(
            reg, "demo", topic, workdir=os.path.join(d, "loop"),
            gate_set=gate, initial_source=net(1), feature_width=n_in,
            window_records=2, batch_size=16, gate_margin=1e-6,
            canary_fraction=0.3,
            canary_policy=CanaryPolicy(min_requests=8),
            canary_timeout_s=20.0, traffic_hook=traffic)
        v1 = trainer.recover()

        for seed in (2, 3):                       # improvement window
            x, y = batch(32, seed)
            pub.publish(np.concatenate([x, y], axis=1))
        res1 = trainer.run_cycle()
        x, y = batch(32, 4)                       # poisoned window
        x[:] = np.nan
        pub.publish(np.concatenate([x, y], axis=1))
        trainer.guard_policy = None               # let the NaN through
        stable_before = reg.get("demo")
        res2 = trainer.run_cycle()
        stable_after = reg.get("demo")

        summary = {
            "device": str(reg.device),
            "bootstrap_version": v1.version,
            "cycle1": res1, "cycle2": res2,
            "status": trainer.status(),
            "telemetry": tel.summary().get("continual", {}),
        }
        print(json.dumps(summary, indent=1, default=str))
        ok = (res1 and res1["outcome"] == "promoted"
              and res2 and res2["outcome"] == "rolled_back"
              and stable_before is stable_after)
        print(f"continual demo: {'PASS' if ok else 'FAIL'} "
              f"(promote then NaN rollback, stable untouched)")
        return 0 if ok else 1


def main(argv=None):
    """`python -m deeplearning4j_tpu_torch.continual.trainer [--device
    cpu]` runs the demo rep (on the GPU unless --device says otherwise)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.continual.trainer")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    raise SystemExit(_demo(args.device))


if __name__ == "__main__":
    main()
