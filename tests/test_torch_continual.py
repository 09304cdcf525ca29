"""PyTorch port, the continual train-to-serve plane on the CPU: the twins of
`tests/test_continual.py` (journal crash consistency, the canary policy and
the registry's canary mechanics, the trainer's promote / empty-window /
gate / SLO rollbacks, the crash drill at all ten `continual/*` points, the
HTTP canary endpoints, `split_xy`), each held against the JAX package where
both can run the same thing, and the recovery crossing the packages: one
package's trainer crashes at `continual/window_record`, the other's
recovers from the same workdir (the zips and the journal are the bridge).

Tolerances: the port's candidates and scores against JAX's for the same
zip and records (an f32 MLP, Sgd, no dropout) at 1e-4; journals, offsets,
decisions and canary routing exactly; the served stable version after a
recovery bit-equal to its promoted checkpoint.
"""
import json
import logging
import os
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.continual import CanaryPolicy as JaxCanaryPolicy
from deeplearning4j_tpu.continual import ContinualJournal as JaxJournal
from deeplearning4j_tpu.continual import ContinualTrainer as JaxTrainer
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.pipeline import split_xy as jax_split_xy
from deeplearning4j_tpu.fault.injection import SimulatedCrash as JaxCrash
from deeplearning4j_tpu.fault.injection import crash_at_write as jax_crash
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.streaming.topic import FileTopic as JaxTopic
from deeplearning4j_tpu_torch import (DenseLayer, InputType, ModelSerializer,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      Sgd)
from deeplearning4j_tpu_torch.continual import (CanaryPolicy,
                                                ContinualJournal,
                                                ContinualTrainer,
                                                JournalCorruptError)
from deeplearning4j_tpu_torch.datasets.iterators import DataSet
from deeplearning4j_tpu_torch.datasets.pipeline import split_xy
from deeplearning4j_tpu_torch.fault.injection import (SimulatedCrash,
                                                      crash_at_write)
from deeplearning4j_tpu_torch.serving import (InferenceServer, ModelRegistry,
                                              ServingError)
from deeplearning4j_tpu_torch.streaming.topic import (FileTopic,
                                                      TopicPublisher)
from deeplearning4j_tpu_torch.telemetry import runtime as tel_runtime
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.sanitize(
    allow_threads=("dl4j-torch-serving-http", "dl4j-torch-serving-batcher-"))

N_IN, N_OUT = 6, 3
TOL = 1e-4
_W_TRUE = np.random.default_rng(11).normal(
    size=(N_IN, N_OUT)).astype(np.float32)


def tiny_net(seed=0, hidden=8):
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1))
            .list()
            .layer(DenseLayer(n_out=hidden, activation="relu"))
            .layer(OutputLayer(n_out=N_OUT, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(N_IN)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def tiny_zip(tmp_path, seed=1, name="init.zip"):
    """A port net's zip: the initial source both packages start from."""
    path = str(tmp_path / name)
    ModelSerializer.write_model(tiny_net(seed), path)
    return path


def batch(n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[(x @ _W_TRUE).argmax(1)]
    return x, y


def publish_window(pub, n=8, seed=0, poison=False):
    x, y = batch(n, seed)
    if poison:
        x[:] = np.nan
    return pub.publish(np.concatenate([x, y], axis=1))


def gate_set(seed=99, n=48, lib_dataset=DataSet):
    gx, gy = batch(n, seed)
    return lib_dataset(gx, gy)


def pump_canary(reg, name, n=4, latency=0.001, breach=False, error=False):
    for _ in range(n):
        reg.observe_canary(name, "canary", latency_s=latency,
                           breach=breach, error=error)


def _opts(workdir, **kw):
    opts = dict(workdir=str(workdir), feature_width=N_IN,
                window_records=1, batch_size=8, gate_margin=1.0,
                canary_fraction=0.3, canary_timeout_s=10.0,
                canary_poll_s=0.001, buckets=(1, 8), fsync_journal=False)
    opts.update(kw)
    return opts


def _mk_trainer(reg, topic, workdir, **kw):
    kw.setdefault("initial_source", tiny_net(1))
    kw.setdefault("gate_set", gate_set())
    kw.setdefault("canary_policy", CanaryPolicy(min_requests=4))
    return ContinualTrainer(reg, "m", topic, **_opts(workdir, **kw))


def _mk_jax_trainer(reg, topic, workdir, **kw):
    kw.setdefault("gate_set", gate_set(lib_dataset=JaxDataSet))
    kw.setdefault("canary_policy", JaxCanaryPolicy(min_requests=4))
    return JaxTrainer(reg, "m", topic, **_opts(workdir, **kw))


def _params(path):
    """{layer/param: array} of a checkpoint, read by the port."""
    net = ModelSerializer.restore(path, device="cpu")
    return {f"{i}/{k}": v.numpy() for i, p in enumerate(net.params)
            for k, v in p.items()}


def _close(a, b, tol=TOL):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=tol,
                                   err_msg=k)


def _kinds(path):
    return [(r["kind"], r.get("reason")) for r in
            ContinualJournal(path).replay()]


# ---------------------------------------------------------------------------
# ContinualJournal
# ---------------------------------------------------------------------------
def test_journal_append_replay_roundtrip(tmp_path):
    j = ContinualJournal(str(tmp_path / "j.jsonl"))
    j.append("promoted", cycle=0, ckpt="a.zip", offset=0, score=None)
    j.append("window", cycle=1, start=0, end=2, batches=4, skipped=0,
             nonfinite=0)
    recs = j.replay()
    assert [r["kind"] for r in recs] == ["promoted", "window"]
    assert recs[1]["end"] == 2 and "ts" in recs[0]
    # one format: JAX's journal appends to the port's file and replays it
    jj = JaxJournal(str(tmp_path / "j.jsonl"))
    jj.append("gate", cycle=1, passed=True, cand_score=0.5,
              stable_score=0.6)
    assert jj.replay() == j.replay()
    assert [r["kind"] for r in j.replay()] == ["promoted", "window", "gate"]


def test_journal_torn_tail_dropped_committed_garbage_raises(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ContinualJournal(path)
    j.append("promoted", cycle=0, ckpt="a.zip", offset=0, score=1.0)
    with open(path, "ab") as f:
        f.write(b'{"kind": "window", "cy')
    recs = j.replay()
    assert len(recs) == 1 and recs[0]["kind"] == "promoted"
    assert JaxJournal(path).replay() == recs
    with open(path, "ab") as f:
        f.write(b'not json at all\n')
    with pytest.raises(JournalCorruptError):
        j.replay()


def test_journal_newline_in_value_stays_single_line(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ContinualJournal(path)
    j.append("rolled_back", cycle=1, reason="multi\nline\ndetail")
    with open(path, "rb") as f:
        assert f.read().count(b"\n") == 1
    recs = j.replay()
    assert recs[0]["reason"] == "multi\nline\ndetail"
    assert JaxJournal(path).replay() == recs


# ---------------------------------------------------------------------------
# Torn topic tail: readers never truncate, the writer does (warning and
# the dl4j_topic_torn_records_total counter)
# ---------------------------------------------------------------------------
def test_topic_torn_tail_reader_preserves_writer_truncates(tmp_path, caplog):
    topic = FileTopic(str(tmp_path), "events")
    pub = TopicPublisher(topic)
    a0 = pub.publish(np.arange(4, dtype=np.float32))
    a1 = pub.publish(np.arange(8, dtype=np.float32))
    seg = [p for _, p in topic._segments()][-1]
    with open(seg, "ab") as f:
        f.write(struct.pack(">Q", 1 << 20) + b"partial")
    torn_size = os.path.getsize(seg)

    reader = FileTopic(str(tmp_path), "events")
    assert reader.read(a1) is not None and reader.end_offset() == 2
    assert os.path.getsize(seg) == torn_size
    # JAX's reader sees the same two records and leaves the tail alone too
    jreader = JaxTopic(str(tmp_path), "events")
    assert jreader.end_offset() == 2 and jreader.read(a1) == reader.read(a1)
    assert os.path.getsize(seg) == torn_size

    with tel_runtime.enabled() as tel:
        with caplog.at_level(
                logging.WARNING,
                logger="deeplearning4j_tpu_torch.streaming.topic"):
            a2 = pub.publish(np.arange(2, dtype=np.float32))
        assert any("torn tail" in r.message for r in caplog.records)
        assert tel.registry.counter(
            "dl4j_topic_torn_records_total",
            labels=("topic",)).value(topic="events") == 1.0
    assert a2 == 2
    for off in (a0, a1, a2):
        assert reader.read(off) is not None
        assert jreader.read(off) == reader.read(off)
    assert reader.end_offset() == 3


# ---------------------------------------------------------------------------
# CanaryPolicy decision table, against JAX's on a grid of arm stats
# ---------------------------------------------------------------------------
def _stats(c_req=0, c_err=0, c_breach=0, c_lat=0.001, s_req=0, s_breach=0,
           s_lat=0.001):
    return {"arms": {
        "canary": {"requests": c_req, "errors": c_err, "breaches": c_breach,
                   "latency_mean": c_lat},
        "stable": {"requests": s_req, "errors": 0, "breaches": s_breach,
                   "latency_mean": s_lat}}}


def test_canary_policy_decisions():
    kw = dict(min_requests=10, max_error_rate=0.0, max_breach_rate=0.25,
              max_latency_ratio=3.0, max_score_drift=0.5)
    p, jp = CanaryPolicy(**kw), JaxCanaryPolicy(**kw)
    assert p.decide(_stats(c_req=9)) is None
    assert p.decide(_stats(c_req=10, s_req=10)) == ("promote", None)
    assert p.decide(_stats(c_req=10, c_err=1)) == ("rollback", "errors")
    assert p.decide(_stats(c_req=10, c_breach=5, s_req=10,
                           s_breach=6)) == ("promote", None)
    assert p.decide(_stats(c_req=10, c_breach=5,
                           s_req=10)) == ("rollback", "slo_breach")
    assert p.decide(_stats(c_req=10, s_req=10, c_lat=0.01,
                           s_lat=0.001)) == ("rollback", "latency")
    assert p.decide(_stats(c_req=0),
                    score_drift=0.6) == ("rollback", "score_drift")
    grid = [(_stats(c_req=c, c_err=e, c_breach=b, c_lat=lat, s_req=s,
                    s_breach=sb), drift)
            for c in (0, 9, 10, 40) for e in (0, 1) for b in (0, 3, 12)
            for lat in (0.001, 0.004) for s in (0, 10) for sb in (0, 5)
            for drift in (None, 0.1, 0.6)]
    assert [p.decide(st, score_drift=d) for st, d in grid] == \
        [jp.decide(st, score_drift=d) for st, d in grid]


# ---------------------------------------------------------------------------
# Registry canary mechanics
# ---------------------------------------------------------------------------
def test_canary_routing_deterministic_fraction(tmp_path):
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", tiny_net(0))
    assert reg.route_arm("m") == "stable"
    reg.start_canary("m", tiny_net(1), fraction=0.2)
    arms = [reg.route_arm("m") for _ in range(200)]
    assert arms.count("canary") == 40
    assert arms[:100] == arms[100:]
    reg.rollback_canary("m")
    # JAX's registry splits the same request sequence the same way
    jreg = JaxRegistry(buckets=(1, 4))
    jreg.register("m", tiny_zip(tmp_path, 0, "a.zip"))
    jreg.start_canary("m", tiny_zip(tmp_path, 1, "b.zip"), fraction=0.2)
    assert [jreg.route_arm("m") for _ in range(200)] == arms
    jreg.rollback_canary("m")


def test_same_arch_canary_zero_new_compiles_and_register_blocked():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    reg.register("m", tiny_net(0))
    compiles = reg.metrics.counter("dl4j_serving_compiles_total",
                                   labels=("model", "bucket"))
    before = sum(compiles.values().values())
    assert before == 2                  # one build per bucket, as JAX
    cand = reg.start_canary("m", tiny_net(5), fraction=0.5)
    assert sum(compiles.values().values()) == before
    assert cand.version == reg.get("m").version + 1
    with pytest.raises(ServingError, match="canary"):
        reg.register("m", tiny_net(6))
    reg.rollback_canary("m")


def test_promote_flips_rollback_bit_exact_versions_monotonic():
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    v1 = reg.register("m", tiny_net(0))
    x = batch(3, seed=42)[0]
    stable_out, ver = reg.predict("m", x)
    assert ver == v1.version

    cand = reg.start_canary("m", tiny_net(1), fraction=0.1)
    cand_out, cver = reg.predict("m", x, arm="canary")
    assert cver == cand.version and not np.array_equal(cand_out, stable_out)
    reg.rollback_canary("m")
    assert reg.get("m") is v1
    out2, _ = reg.predict("m", x)
    np.testing.assert_array_equal(out2, stable_out)

    cand2 = reg.start_canary("m", tiny_net(2), fraction=0.1)
    assert cand2.version > cand.version
    promoted = reg.promote_canary("m")
    assert reg.get("m") is promoted and promoted.version == cand2.version
    assert reg.canary_state("m") is None


def test_arm_version_falls_back_to_stable():
    reg = ModelRegistry(buckets=(1,), device="cpu")
    v1 = reg.register("m", tiny_net(0))
    assert reg.arm_version("m", "canary") is v1
    reg.observe_canary("m", "canary")           # no-op without a canary


# ---------------------------------------------------------------------------
# ContinualTrainer end-to-end
# ---------------------------------------------------------------------------
def test_trainer_promotes_improvement_then_rolls_back_poison(tmp_path):
    """The port's loop and JAX's over the same zip and the same topic
    records: the same outcomes, offsets and journal, candidates at 1e-4."""
    init = tiny_zip(tmp_path)
    results, stables = {}, {}
    for lib in ("port", "jax"):
        topic = (FileTopic if lib == "port" else JaxTopic)(
            str(tmp_path / lib), "t")
        pub = TopicPublisher(topic)
        if lib == "port":
            reg = ModelRegistry(buckets=(1, 8), device="cpu")
            mk = _mk_trainer
        else:
            reg = JaxRegistry(buckets=(1, 8))
            mk = _mk_jax_trainer
        t = mk(reg, topic, tmp_path / lib / "loop", initial_source=init,
               traffic_hook=lambda reg=reg: pump_canary(reg, "m"))
        v1 = t.recover()
        assert reg.get("m").version == v1.version

        publish_window(pub, seed=1)
        res = t.run_cycle()
        assert res["outcome"] == "promoted" and res["version"] > v1.version
        assert reg.get("m").version == res["version"]
        assert topic.committed("continual") == 1
        stables[lib] = t.stable_ckpt

        publish_window(pub, seed=2, poison=True)
        res2 = t.run_cycle()
        assert res2 == {"cycle": res["cycle"] + 1, "outcome": "rolled_back",
                        "reason": "empty_window"}
        assert reg.get("m").version == res["version"]
        assert topic.committed("continual") == 2
        assert not os.path.exists(
            tmp_path / lib / "loop" / f"cand_{res2['cycle']:05d}.zip")
        assert t.run_cycle() is None
        results[lib] = (res, res2, t.status())
    (res, res2, st), (jres, jres2, jst) = results["port"], results["jax"]
    assert res2 == jres2
    for k in ("cycle", "outcome", "version"):
        assert res[k] == jres[k], k
    assert tuple(res["window"]) == tuple(jres["window"])
    assert abs(res["score"] - jres["score"]) <= TOL
    for k in ("next_cycle", "position", "committed", "promotions",
              "rollbacks"):
        assert st[k] == jst[k], k
    _close(_params(stables["port"]), _params(stables["jax"]))
    assert _kinds(str(tmp_path / "port" / "loop" / "journal.jsonl")) == \
        _kinds(str(tmp_path / "jax" / "loop" / "journal.jsonl"))


def test_trainer_gate_rejects_unguarded_nan(tmp_path):
    topic = FileTopic(str(tmp_path), "t")
    pub = TopicPublisher(topic)
    reg = ModelRegistry(buckets=(1, 8), device="cpu")
    t = _mk_trainer(reg, topic, tmp_path / "loop", guard_policy=None)
    t.recover()
    stable = reg.get("m")
    publish_window(pub, seed=3, poison=True)
    res = t.run_cycle()
    assert res["outcome"] == "rolled_back" and res["reason"] == "gate_fail"
    assert reg.get("m") is stable
    gate = [r for r in t.journal.replay() if r["kind"] == "gate"][0]
    assert gate["passed"] is False and np.isnan(gate["cand_score"])


def test_superstep_window_skipped_whole_is_an_empty_window(tmp_path):
    """Divergence from JAX (ROADMAP C): a poisoned window of two batches at
    superstep=2 is skipped by the guard as ONE window. The port counts the
    two batches the candidate did not keep, journals skipped=2 and rolls
    back as empty_window; JAX's trainer journals skipped=1 (its guard's
    count) and takes the bit-identical candidate through the gate and the
    canary to a promotion."""
    init = tiny_zip(tmp_path)
    outcomes = {}
    for lib in ("port", "jax"):
        topic = (FileTopic if lib == "port" else JaxTopic)(
            str(tmp_path / lib), "t")
        pub = TopicPublisher(FileTopic(str(tmp_path / lib), "t"))
        reg = (ModelRegistry(buckets=(1, 8), device="cpu") if lib == "port"
               else JaxRegistry(buckets=(1, 8)))
        mk = _mk_trainer if lib == "port" else _mk_jax_trainer
        t = mk(reg, topic, tmp_path / lib / "loop", initial_source=init,
               window_records=2, superstep=2, gate_margin=0.0,
               traffic_hook=lambda reg=reg: pump_canary(reg, "m"))
        v1 = t.recover()
        for seed in (1, 2):
            publish_window(pub, seed=seed, poison=True)
        res = t.run_cycle()
        window = [r for r in t.journal.replay() if r["kind"] == "window"][0]
        outcomes[lib] = (res["outcome"], res.get("reason"),
                         window["batches"], window["skipped"])
        if lib == "port":
            assert reg.get("m") is v1
    assert outcomes["port"] == ("rolled_back", "empty_window", 2, 2)
    assert outcomes["jax"] == ("promoted", None, 2, 1)


def test_canary_slo_regression_auto_rollback_zero_stable_failures(tmp_path):
    """An injected latency regression on the canary arm rolls the candidate
    back while the stable arm serves every request: zero failures, outputs
    bit-equal before, during and after the canary."""
    topic = FileTopic(str(tmp_path), "t")
    pub = TopicPublisher(topic)
    with tel_runtime.enabled() as tel:
        reg = ModelRegistry(buckets=(1, 8), device="cpu",
                            metrics=tel.registry)
        srv = InferenceServer(reg, batching=True, max_wait_us=500)
        x = batch(2, seed=7)[0]
        failures = []
        served = []

        def traffic():
            pump_canary(reg, "m", n=8, latency=10.0, breach=True)
            for _ in range(40):
                try:
                    out, version, _ = srv.predict("m", x)
                    served.append((np.asarray(out), version))
                except Exception as e:  # noqa: BLE001 - drill bookkeeping
                    failures.append(repr(e))

        t = _mk_trainer(reg, topic, tmp_path / "loop",
                        canary_policy=CanaryPolicy(min_requests=32,
                                                   max_breach_rate=0.1),
                        traffic_hook=traffic)
        v_stable = t.recover().version
        baseline, _, _ = srv.predict("m", x)
        publish_window(pub, seed=4)
        res = t.run_cycle()
        after, _, _ = srv.predict("m", x)
        srv.stop()

    assert res["outcome"] == "rolled_back" and res["reason"] == "slo_breach"
    assert failures == []
    stable_outs = [out for out, v in served if v == v_stable]
    assert stable_outs
    for out in stable_outs + [np.asarray(after)]:
        np.testing.assert_array_equal(out, np.asarray(baseline))
    summary = tel.summary()["continual"]
    assert summary["rollbacks"] == {"slo_breach": 1}
    assert summary["canary_requests"]["canary"] >= 4


# ---------------------------------------------------------------------------
# The crash drill: kill the loop at EVERY journal boundary
# ---------------------------------------------------------------------------
CRASH_POINTS = [
    "continual/stable_registered",
    "continual/window_consumed",
    "continual/window_trained",
    "continual/candidate_saved",
    "continual/window_record",
    "continual/offset_committed",
    "continual/gate_record",
    "continual/canary_started",
    "continual/decision_record",
    "continual/decision_applied",
]


def _drain_and_check_windows(trainer, topic, journal_path, total):
    """Run the loop dry; the journaled windows must tile [0, total)
    exactly once."""
    trainer.run(max_cycles=8, poll_timeout_s=0)
    spans = sorted((r["start"], r["end"]) for r in
                   ContinualJournal(journal_path).replay()
                   if r["kind"] == "window")
    assert spans[0][0] == 0 and spans[-1][1] == total
    for (_, e1), (s2, _) in zip(spans, spans[1:]):
        assert s2 == e1, f"window replayed or skipped: {spans}"
    assert topic.committed("continual") == total


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_drill_recovery_is_consistent(tmp_path, point):
    """Kill the loop at `point`; a fresh trainer and registry over the same
    workdir must (a) serve exactly the journal's last promoted checkpoint,
    bit-equal, (b) never serve the undecided candidate, and (c) neither
    replay nor skip a window."""
    topic = FileTopic(str(tmp_path), "t")
    pub = TopicPublisher(topic)
    for seed in (1, 2):
        publish_window(pub, seed=seed)

    def mk(reg):
        return _mk_trainer(reg, topic, tmp_path / "loop", gate_margin=100.0,
                           traffic_hook=lambda: pump_canary(reg, "m"))

    reg1 = ModelRegistry(buckets=(1, 8), device="cpu")
    with pytest.raises(SimulatedCrash):
        with crash_at_write(point):
            t1 = mk(reg1)
            t1.recover()
            t1.run(max_cycles=4, poll_timeout_s=0)

    jpath = str(tmp_path / "loop" / "journal.jsonl")
    pre = ContinualJournal(jpath).replay()
    promoted = [r for r in pre if r["kind"] == "promoted"][-1]
    expect = ModelRegistry(buckets=(1, 8), device="cpu")
    expect.register("m", ModelSerializer.restore(promoted["ckpt"],
                                                 device="cpu"))
    x = batch(3, seed=77)[0]
    want = expect.predict("m", x)[0]

    reg2 = ModelRegistry(buckets=(1, 8), device="cpu")
    t2 = mk(reg2)
    t2.recover()
    np.testing.assert_array_equal(reg2.predict("m", x)[0], want)
    assert reg2.canary_state("m") is None
    post = ContinualJournal(jpath).replay()
    if pre and pre[-1]["kind"] in ("window", "gate", "canary"):
        assert post[len(pre)]["kind"] == "rolled_back"
        assert post[len(pre)]["reason"] == "crash_recovery"
    _drain_and_check_windows(t2, topic, jpath, 2)


# ---------------------------------------------------------------------------
# Recovery across the packages: the zip and the journal are the bridge
# ---------------------------------------------------------------------------
def _cross_run(tmp_path, crasher, recoverer, init):
    """Two windows; `crasher`'s loop crashes at continual/window_record of
    cycle 1, `recoverer`'s recovers over the same topic and workdir and
    drains it. Returns (journal kinds, final stable params, served output
    after recovery, promoted checkpoint's output)."""
    root = tmp_path / f"{crasher}_{recoverer}"
    libs = {
        "port": (FileTopic, lambda: ModelRegistry(buckets=(1, 8),
                                                  device="cpu"),
                 _mk_trainer, crash_at_write, SimulatedCrash),
        "jax": (JaxTopic, lambda: JaxRegistry(buckets=(1, 8)),
                _mk_jax_trainer, jax_crash, JaxCrash)}
    topic_cls, make_reg, mk, crash, crash_exc = libs[crasher]
    topic = topic_cls(str(root), "t")
    pub = TopicPublisher(FileTopic(str(root), "t"))
    for seed in (1, 2):
        publish_window(pub, seed=seed)
    reg = make_reg()
    with pytest.raises(crash_exc):
        with crash("continual/window_record"):
            t1 = mk(reg, topic, root / "loop", initial_source=init,
                    gate_margin=100.0,
                    traffic_hook=lambda: pump_canary(reg, "m"))
            t1.recover()
            t1.run(max_cycles=4, poll_timeout_s=0)
    jpath = str(root / "loop" / "journal.jsonl")
    pre = ContinualJournal(jpath).replay()
    assert [r["kind"] for r in pre] == ["promoted", "window"]

    topic_cls, make_reg, mk, _, _ = libs[recoverer]
    topic = topic_cls(str(root), "t")
    reg = make_reg()
    t2 = mk(reg, topic, root / "loop", initial_source=init,
            gate_margin=100.0, traffic_hook=lambda: pump_canary(reg, "m"))
    t2.recover()
    x = batch(3, seed=77)[0]
    served = np.asarray(reg.predict("m", x)[0])
    boot = ModelSerializer.restore(pre[0]["ckpt"], device="cpu")
    want = boot.output(x).numpy()
    t2.run(max_cycles=8, poll_timeout_s=0)
    assert topic.committed("continual") == 2
    spans = [(r["start"], r["end"]) for r in ContinualJournal(jpath).replay()
             if r["kind"] == "window"]
    assert spans == [(0, 1), (1, 2)]
    return _kinds(jpath), _params(t2.stable_ckpt), served, want


@pytest.mark.parametrize("crasher,recoverer", [("jax", "port"),
                                               ("port", "jax")])
def test_recovery_crosses_packages(tmp_path, crasher, recoverer):
    """A loop that crashed in one package after journaling its first window
    recovers in the other: the candidate is closed as crash_recovery, the
    boot checkpoint is served (bit-equal on the port, 1e-5 on JAX's XLA),
    the second window is trained once, and the journal and the final
    stable model equal a recovery within the crashing package (1e-4)."""
    init = tiny_zip(tmp_path)
    kinds, final, served, want = _cross_run(tmp_path, crasher, recoverer,
                                            init)
    ref_kinds, ref_final, _, _ = _cross_run(tmp_path, crasher, crasher,
                                            init)
    assert kinds == ref_kinds == [
        ("promoted", None), ("window", None),
        ("rolled_back", "crash_recovery"), ("window", None),
        ("gate", None), ("canary", None), ("promoted", None)]
    if recoverer == "port":
        np.testing.assert_array_equal(served, want)
    else:
        np.testing.assert_allclose(served, want, atol=1e-5, rtol=1e-5)
    _close(final, ref_final)


# ---------------------------------------------------------------------------
# HTTP canary endpoints
# ---------------------------------------------------------------------------
def _http(method, url, body=None):
    req = urllib.request.Request(
        url, None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_http_canary_endpoints(tmp_path):
    """The canary endpoints driving a loop's candidate checkpoint: start
    from the zip the trainer wrote, promote, start again, roll back."""
    topic = FileTopic(str(tmp_path), "t")
    pub = TopicPublisher(topic)
    reg = ModelRegistry(buckets=(1, 4), device="cpu")
    t = _mk_trainer(reg, topic, tmp_path / "loop", buckets=(1, 4),
                    traffic_hook=lambda: pump_canary(reg, "m"))
    v1 = t.recover()
    publish_window(pub, seed=5)
    assert t.run_cycle()["outcome"] == "promoted"
    ckpt = t.stable_ckpt
    srv = InferenceServer(reg, max_wait_us=500).start()
    try:
        base = f"http://{srv.host}:{srv.port}/v1/models/m/canary"
        code, out = _http("GET", base)
        assert code == 200 and out == {"model": "m", "active": False}
        code, out = _http("POST", base, {"action": "start", "source": ckpt,
                                         "fraction": 0.5})
        assert code == 200 and out["canary"] is True
        cand_version = out["version"]
        code, out = _http("GET", base)
        assert code == 200 and out["active"] is True
        assert out["version"] == cand_version and out["fraction"] == 0.5
        code, _ = _http("POST", base, {"action": "start", "source": ckpt})
        assert code == 400
        code, out = _http("POST", base, {"action": "promote"})
        assert code == 200 and out["promoted"] is True
        assert reg.get("m").version == cand_version
        code, out = _http("POST", base, {"action": "start", "source": ckpt})
        assert code == 200
        code, out = _http("POST", base, {"action": "rollback"})
        assert code == 200 and out["rolled_back"] is True
        assert out["version"] == cand_version
        code, out = _http("POST", base, {"action": "resize"})
        assert code == 400 and "unknown canary action" in out["error"]
        code, _ = _http("GET", f"http://{srv.host}:{srv.port}"
                               "/v1/models/nope/canary")
        assert code == 404
    finally:
        srv.stop()
    assert v1.version < cand_version


def test_trainer_requires_recover_and_decoder(tmp_path):
    topic = FileTopic(str(tmp_path), "t")
    reg = ModelRegistry(buckets=(1, 8), device="cpu")
    with pytest.raises(ValueError, match="feature_width"):
        ContinualTrainer(reg, "m", topic, workdir=str(tmp_path / "w"),
                         gate_set=gate_set())
    t = _mk_trainer(reg, topic, tmp_path / "loop")
    with pytest.raises(RuntimeError, match="recover"):
        t.run_cycle()
    empty = ContinualTrainer(reg, "e", topic, workdir=str(tmp_path / "e"),
                             gate_set=gate_set(), feature_width=N_IN)
    with pytest.raises(ValueError, match="initial_source"):
        empty.recover()


def test_split_xy_shapes_and_validation():
    x, y = batch(5, seed=0)
    rec = np.concatenate([x, y], axis=1)
    fx, fy = split_xy(rec, N_IN)
    np.testing.assert_array_equal(fx, x)
    np.testing.assert_array_equal(fy, y)
    for a, b in zip((fx, fy), jax_split_xy(rec, N_IN)):
        np.testing.assert_array_equal(a, b)
    fx1, fy1 = split_xy(rec[0], N_IN)
    assert fx1.shape == (1, N_IN) and fy1.shape == (1, N_OUT)
    with pytest.raises(ValueError):
        split_xy(rec, rec.shape[1])
