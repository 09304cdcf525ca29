"""PyTorch port, fault tolerance on the CPU: the twins of
`tests/test_fault.py` (bar the sharded store's and ParallelTrainer's cases,
ROADMAP A11): crash-safe writes and manifests, the commit markers, the
checkpoint manager, kill-mid-save -> resume equal to the uninterrupted run,
SIGTERM snapshots, the TrainingGuard's four policies and its retries, the
fault injectors; and a checkpoint directory crossing the packages.

Within the port a resumed run matches the uninterrupted one bit for bit
(parameters, updater state, counters, the dropout generators, which the
zip now carries). Across the packages (a directory written by JAX's
`FitCheckpointer` resumed by the port, and the reverse; dropout-free, the
same start and batches) the resumed run is held to the uninterrupted run
of either package at the parity gate's 1e-4.
"""
import json
import os
import signal
import zipfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIt
from deeplearning4j_tpu.fault.injection import crash_at_write as jax_crash
from deeplearning4j_tpu.fault.injection import SimulatedCrash as JaxCrash
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.fault import (COMMIT_MARKER, CheckpointManager,
                                            CorruptCheckpointError,
                                            FaultyIterator, FitCheckpointer,
                                            NonFiniteScoreError,
                                            SimulatedCrash, TrainingGuard,
                                            atomic_replace,
                                            clear_crash_hooks,
                                            crash_at_write, hang_at_step,
                                            install_faults_from_env,
                                            kill_at_step,
                                            read_commit_marker,
                                            sharded_fit_checkpointer,
                                            sigterm_at_step,
                                            write_commit_marker)
from deeplearning4j_tpu_torch.fault import injection as _inj
from deeplearning4j_tpu_torch.fault.resume import (_ShardedTrainerStore,
                                                   _ZipModelStore)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from jax_reference import jax_init
from torch_threads import one_torch_thread  # noqa: F401

ModelSerializer = pt.ModelSerializer
TRAJ_TOL = 1e-4


def _conf(lib, seed=42, dropout=None):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Adam(1e-2)).list()
            .layer(lib.DenseLayer(n_out=16, activation="relu",
                                  dropout=dropout))
            .layer(lib.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(10))
            .build())


def _model(seed=42, dropout=None):
    return pt.MultiLayerNetwork(_conf(pt, seed, dropout), device="cpu").init()


def _graph(seed=42):
    conf = (pt.NeuralNetConfiguration.builder().seed(seed)
            .updater(pt.Adam(1e-2)).graph_builder()
            .add_inputs("in")
            .add_layer("dense", pt.DenseLayer(n_out=16, activation="relu"),
                       "in")
            .add_layer("out", pt.OutputLayer(n_out=3, activation="softmax",
                                             loss="mcxent"), "dense")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(10))
            .build())
    return pt.ComputationGraph(conf, device="cpu").init()


def _classification(n=96, n_features=10, n_classes=3, seed=3):
    r = np.random.default_rng(seed)
    centers = r.normal(0, 4.0, size=(n_classes, n_features))
    ys = r.integers(0, n_classes, size=n)
    xs = centers[ys] + r.normal(0, 1.0, size=(n, n_features))
    return xs.astype(np.float32), np.eye(n_classes, dtype=np.float32)[ys]


XS, YS = _classification()


def _iter(batch=16, xs=None, ys=None):
    return ArrayDataSetIterator(XS if xs is None else xs,
                                YS if ys is None else ys,
                                batch_size=batch, shuffle=True, seed=7)


def _params(m):
    return np.asarray(m.params_flat())


def _gens_equal(a, b):
    ga, gb = a._dropout_generators(), b._dropout_generators()
    return len(ga) == len(gb) and all(
        torch.equal(x.get_state(), y.get_state()) for x, y in zip(ga, gb))


# ======================================================================
# atomic writes, manifests, commit markers
# ======================================================================
def test_atomic_replace_crash_preserves_previous(tmp_path):
    p = str(tmp_path / "f.bin")
    atomic_replace(p, b"version-1", crash_point="t/point")
    with crash_at_write("t/point") as st:
        with pytest.raises(SimulatedCrash):
            atomic_replace(p, b"version-2", crash_point="t/point")
    assert st["fired"] == 1
    with open(p, "rb") as f:
        assert f.read() == b"version-1"
    assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []


def test_write_model_crash_preserves_previous_zip(tmp_path):
    path = str(tmp_path / "model.zip")
    m1 = _model(seed=1)
    m1.fit(pt.DataSet(XS[:16], YS[:16]))
    ModelSerializer.write_model(m1, path)
    m2 = _model(seed=2)
    with crash_at_write("zip/temp_written"):
        with pytest.raises(SimulatedCrash):
            ModelSerializer.write_model(m2, path)
    back = ModelSerializer.restore(path, device="cpu")
    np.testing.assert_array_equal(_params(back), _params(m1))


def test_manifest_detects_corruption(tmp_path):
    path = str(tmp_path / "model.zip")
    ModelSerializer.write_model(_model(), path)
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    entries[ModelSerializer.COEFFICIENTS] = (
        entries[ModelSerializer.COEFFICIENTS][:-8] + b"\0" * 8)
    with zipfile.ZipFile(path, "w") as z:
        for n, data in entries.items():
            z.writestr(n, data)
    with pytest.raises(CorruptCheckpointError, match="sha256 mismatch"):
        ModelSerializer.restore_into(_model(), path)
    with pytest.raises(CorruptCheckpointError):
        ModelSerializer.restore(path, device="cpu")


def test_restore_into_roundtrips_counters_and_generators(tmp_path):
    path = str(tmp_path / "model.zip")
    m1 = _model(seed=5, dropout=0.3)
    m1.fit(_iter(), epochs=1)
    ModelSerializer.write_model(m1, path)
    m2 = _model(seed=99, dropout=0.3)
    meta = ModelSerializer.restore_into(m2, path)
    assert meta["iteration_count"] == m1.iteration_count
    assert m2.iteration_count == m1.iteration_count
    assert m2.epoch_count == m1.epoch_count
    assert _gens_equal(m1, m2)
    np.testing.assert_array_equal(_params(m2), _params(m1))


def test_commit_marker_roundtrip_and_absence(tmp_path):
    d = str(tmp_path / "step_000000003")
    os.makedirs(d)
    assert read_commit_marker(d) is None
    write_commit_marker(d, {"step": 3, "world": 1})
    assert read_commit_marker(d) == {"step": 3, "world": 1}
    assert os.path.exists(os.path.join(d, COMMIT_MARKER))
    with open(os.path.join(d, COMMIT_MARKER), "wb") as f:
        f.write(b"{torn")
    assert read_commit_marker(d) is None


def test_sharded_store_waits_for_the_parallel_stack(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        sharded_fit_checkpointer(object(), str(tmp_path), 0, False)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        _ShardedTrainerStore(object(), str(tmp_path))


# ======================================================================
# CheckpointManager
# ======================================================================
def test_manager_retention_keeps_best_and_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    m = _model()
    for s in [5.0, 1.0, 4.0, 3.0, 2.0]:
        m.iteration_count += 1
        mgr.save(m, score=s)
    assert [it for it, _ in mgr.entries()] == [2, 4, 5]


def test_manager_restore_falls_back_past_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    m = _model(seed=11)
    m.fit(pt.DataSet(XS[:16], YS[:16]))
    good_params = _params(m)
    m.iteration_count = 1
    mgr.save(m)
    m.fit(pt.DataSet(XS[:16], YS[:16]))
    mgr.save(m)
    newest = mgr.entries()[-1][1]
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    m2 = _model(seed=12)
    meta = mgr.restore_latest(m2)
    assert meta is not None and m2.iteration_count == 1
    np.testing.assert_array_equal(_params(m2), good_params)


def test_manager_ignores_stray_files(tmp_path):
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / "ckpt_tmp.zip").write_text("stray")
    os.makedirs(tmp_path / "ckpt_9.zip.d")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.entries() == []
    assert mgr.restore_latest(_model()) is None


# ======================================================================
# kill-mid-save -> resume equivalence
# ======================================================================
def test_kill_mid_zip_save_resume_matches_uninterrupted(tmp_path):
    ref = _model(dropout=0.2)
    ref.fit(_iter(), epochs=3)
    d = str(tmp_path / "ck")
    m1 = _model(dropout=0.2)
    with crash_at_write("zip/temp_written", nth=4):
        with pytest.raises(SimulatedCrash):
            m1.fit(_iter(), epochs=3, checkpoint_dir=d, checkpoint_every=2)
    mgr = CheckpointManager(d)
    assert mgr.entries(), "no committed checkpoint survived the crash"
    for _, p in mgr.entries():
        ModelSerializer.restore_into(_model(dropout=0.2), p)
    m2 = _model(dropout=0.2)
    m2.fit(_iter(), epochs=3, checkpoint_dir=d, checkpoint_every=2,
           resume=True)
    assert m2.iteration_count == ref.iteration_count
    assert m2.epoch_count == ref.epoch_count
    np.testing.assert_array_equal(_params(m2), _params(ref))
    assert _gens_equal(m2, ref)


def test_graph_fit_resume_matches_uninterrupted(tmp_path):
    ref = _graph()
    ref.fit(_iter(), epochs=3)
    d = str(tmp_path / "ck")
    g1 = _graph()
    g1.fit(_iter(), epochs=2, checkpoint_dir=d, checkpoint_every=3)
    g2 = _graph()
    g2.fit(_iter(), epochs=3, checkpoint_dir=d, resume=True)
    assert g2.iteration_count == ref.iteration_count
    np.testing.assert_array_equal(g2.params_flat(), ref.params_flat())


def test_fit_scan_resume_matches_uninterrupted(tmp_path):
    ref = _model()
    ref.fit_scan(_iter(), epochs=3)
    d = str(tmp_path / "ck")
    m1 = _model()
    m1.fit_scan(_iter(), epochs=2, checkpoint_dir=d, checkpoint_every=1)
    m2 = _model()
    m2.fit_scan(_iter(), epochs=3, checkpoint_dir=d, resume=True)
    assert m2.iteration_count == ref.iteration_count
    np.testing.assert_array_equal(_params(m2), _params(ref))


def test_resume_after_complete_fit_is_noop(tmp_path):
    d = str(tmp_path / "ck")
    m1 = _model()
    m1.fit(_iter(), epochs=2, checkpoint_dir=d)
    done = _params(m1)
    m2 = _model()
    m2.fit(_iter(), epochs=2, checkpoint_dir=d, resume=True)
    assert m2.iteration_count == m1.iteration_count
    np.testing.assert_array_equal(_params(m2), done)


def test_checkpoint_knob_validation():
    m = _model()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        m.fit(_iter(), resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        m.fit(_iter(), checkpoint_every=5)
    with pytest.raises(ValueError, match="iterator"):
        m.fit(pt.DataSet(XS[:16], YS[:16]), checkpoint_dir="/tmp/x")


def test_set_epoch_positions_shuffle_permutation():
    it1 = _iter()
    orders = []
    for _ in range(3):
        it1.reset()
        while it1.has_next():
            it1.next()
        orders.append(np.array(it1._order))
    it2 = _iter()
    it2.set_epoch(2)
    np.testing.assert_array_equal(it2._order, orders[2])


def test_sigterm_snapshot_saves_before_exit(tmp_path):
    m = _model()
    m.fit(pt.DataSet(XS[:16], YS[:16]))
    ck = FitCheckpointer(_ZipModelStore(m, str(tmp_path)), every=0)
    with pytest.raises(SystemExit):
        with ck.sigterm_snapshot():
            os.kill(os.getpid(), signal.SIGTERM)
    entries = CheckpointManager(str(tmp_path)).entries()
    assert len(entries) == 1
    with zipfile.ZipFile(entries[0][1]) as z:
        meta = json.loads(z.read("metadata.json").decode())
    assert meta["reason"] == "sigterm"
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_sigterm_during_fit_defers_to_batch_boundary(tmp_path):
    m = _model()
    m.fit(pt.DataSet(XS[:16], YS[:16]))
    ck = FitCheckpointer(_ZipModelStore(m, str(tmp_path)), every=0)
    with pytest.raises(SystemExit):
        with ck.sigterm_snapshot():
            os.kill(os.getpid(), signal.SIGTERM)
            assert CheckpointManager(str(tmp_path)).entries() == []
            ck.on_batch()
    entries = CheckpointManager(str(tmp_path)).entries()
    assert len(entries) == 1


def test_sigterm_snapshot_honors_sig_ign(tmp_path):
    m = _model()
    m.fit(pt.DataSet(XS[:16], YS[:16]))
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        ck = FitCheckpointer(_ZipModelStore(m, str(tmp_path)), every=0)
        with ck.sigterm_snapshot():
            os.kill(os.getpid(), signal.SIGTERM)
        assert len(CheckpointManager(str(tmp_path)).entries()) == 1
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_IGN
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_backprop_false_rejects_fault_knobs():
    m = _model()
    m.conf.backprop = False
    with pytest.raises(ValueError, match="backprop"):
        m.fit(_iter(), checkpoint_dir="/tmp/x")
    with pytest.raises(ValueError, match="backprop"):
        m.fit(_iter(), guard=TrainingGuard("warn"))


# ======================================================================
# TrainingGuard
# ======================================================================
def test_guard_skip_batch_nan_counted_and_converges():
    m = _model()
    guard = TrainingGuard("skip_batch")
    with telemetry.enabled() as sess:
        m.fit(FaultyIterator(_iter(), nan_at=3), epochs=25, guard=guard)
    assert guard.nonfinite_steps == 1
    assert guard.skipped_batches == 1
    counter = sess.registry.get("dl4j_fault_nonfinite_steps_total")
    assert counter.value(policy="skip_batch") == 1
    assert sess.fault_summary()["nonfinite_steps"] == 1
    ev = m.evaluate(ArrayDataSetIterator(XS, YS, batch_size=64))
    assert ev.accuracy() > 0.9, ev.stats()
    assert np.isfinite(_params(m)).all()


def test_guard_halt_raises():
    m = _model()
    with pytest.raises(NonFiniteScoreError, match="policy=halt"):
        m.fit(FaultyIterator(_iter(), nan_at=2), epochs=1,
              guard=TrainingGuard("halt"))


def test_guard_warn_keeps_poisoned_step():
    m = _model()
    guard = TrainingGuard("warn", max_consecutive=50)
    m.fit(FaultyIterator(_iter(), nan_at=2), epochs=1, guard=guard)
    assert guard.nonfinite_steps >= 1
    assert guard.skipped_batches == 0
    assert not np.isfinite(_params(m)).all()


def test_guard_rollback_restores_known_good():
    m = _model()
    guard = TrainingGuard("rollback", refresh_every=2)
    m.fit(FaultyIterator(_iter(), nan_at=7), epochs=2, guard=guard)
    assert guard.skipped_batches == 1
    assert np.isfinite(_params(m)).all()
    assert np.isfinite(float(m._score))


def test_guard_skip_batch_restores_the_generator_in_place():
    """A skipped step's dropout draws are undone: the generator object is
    kept (a captured graph holds it) and takes the snapshot's state, so
    the run equals one that never saw the batch."""
    bs = list(_iter())
    ref = _model(dropout=0.4)
    ref.fit(pt.ListDataSetIterator(bs[:2] + bs[3:]))
    m = _model(dropout=0.4)
    m.fit(pt.ListDataSetIterator(bs[:1]))
    gen = m._generator
    m.fit(FaultyIterator(pt.ListDataSetIterator(bs[1:]), nan_at=1),
          guard=TrainingGuard("skip_batch"))
    assert m._generator is gen
    np.testing.assert_array_equal(_params(m), _params(ref))
    assert _gens_equal(m, ref)


def test_guard_max_consecutive_refuses_to_spin():
    xs = np.full_like(XS, np.nan)
    m = _model()
    guard = TrainingGuard("skip_batch", max_consecutive=3)
    with pytest.raises(NonFiniteScoreError, match="consecutive"):
        m.fit(_iter(xs=xs), epochs=5, guard=guard)


def test_guard_scan_epoch_discard():
    xs = XS.copy()
    xs[5, 0] = np.nan
    m = _model()
    guard = TrainingGuard("skip_batch", max_consecutive=10)
    m.fit_scan(_iter(xs=xs), epochs=3, guard=guard)
    assert guard.nonfinite_steps >= 3
    assert np.isfinite(_params(m)).all()


def test_guard_scan_discard_balances_epoch_listeners():
    class EpochCounter:
        def __init__(self):
            self.starts = self.ends = 0

        def iteration_done(self, model, iteration):
            pass

        def on_epoch_start(self, model):
            self.starts += 1

        def on_epoch_end(self, model):
            self.ends += 1

    xs = XS.copy()
    xs[5, 0] = np.nan
    m = _model()
    lis = EpochCounter()
    m.set_listeners(lis)
    m.fit_scan(_iter(xs=xs), epochs=3,
               guard=TrainingGuard("skip_batch", max_consecutive=10))
    assert lis.starts == lis.ends == 3


def test_guard_rollback_on_scan_path():
    xs = XS.copy()
    xs[5, 0] = np.nan
    m = _model()
    guard = TrainingGuard("rollback", refresh_every=1, max_consecutive=10)
    m.fit_scan(_iter(xs=xs), epochs=3, guard=guard)
    assert guard.nonfinite_steps >= 3
    assert np.isfinite(_params(m)).all()


def test_guard_retry_recovers_transient_error():
    m = _model()
    guard = TrainingGuard("warn", backoff_s=0.001)
    with telemetry.enabled() as sess:
        m.fit(FaultyIterator(_iter(), raise_at=2, fail_times=2), epochs=1,
              guard=guard)
    assert m.iteration_count == 6
    retries = sess.registry.get("dl4j_fault_retries_total")
    assert retries.value(kind="iterator") == 2


def test_guard_retry_gives_up_on_permanent_error():
    m = _model()
    guard = TrainingGuard("warn", max_retries=2, backoff_s=0.001)
    with pytest.raises(OSError, match="injected"):
        m.fit(FaultyIterator(_iter(), raise_at=1, fail_times=-1), epochs=1,
              guard=guard)


def test_guard_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown guard policy"):
        TrainingGuard("explode")


def test_guard_on_a_graph_skips_the_batch():
    g = _graph()
    guard = TrainingGuard("skip_batch")
    g.fit(FaultyIterator(_iter(), nan_at=2), epochs=2, guard=guard)
    assert guard.skipped_batches == 1
    assert np.isfinite(g.params_flat()).all()
    assert g.iteration_count == 11


def test_faulty_iterator_ordinals_count_across_epochs():
    f = FaultyIterator(_iter(), raise_at=8, fail_times=1, exc=RuntimeError)
    served = 0
    with pytest.raises(RuntimeError):
        for _ in range(2):
            f.reset()
            while f.has_next():
                f.next()
                served += 1
    assert served == 8


# ======================================================================
# early stopping beside the fault tools
# ======================================================================
def test_loss_calculator_empty_iterator_raises():
    from deeplearning4j_tpu_torch.earlystopping import DataSetLossCalculator

    class EmptyIter(ArrayDataSetIterator):
        def has_next(self):
            return False
    calc = DataSetLossCalculator(EmptyIter(XS, YS, batch_size=16))
    with pytest.raises(ValueError, match="no.*examples|yielded no"):
        calc.calculate_score(_model())


def test_invalid_score_termination_fires_on_nan():
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer,
        InvalidScoreIterationTerminationCondition,
        MaxEpochsTerminationCondition)
    xs = np.full_like(XS, np.nan)
    conf = (EarlyStoppingConfiguration.Builder()
            .iteration_termination_conditions(
                InvalidScoreIterationTerminationCondition())
            .epoch_termination_conditions(MaxEpochsTerminationCondition(5))
            .build())
    result = EarlyStoppingTrainer(conf, _model(), _iter(xs=xs)).fit()
    assert result.termination_reason == "IterationTerminationCondition"
    assert (result.termination_details
            == "InvalidScoreIterationTerminationCondition")


def test_local_file_saver_crash_preserves_previous_best(tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import LocalFileModelSaver
    saver = LocalFileModelSaver(str(tmp_path))
    m1 = _model(seed=31)
    m1.fit(pt.DataSet(XS[:16], YS[:16]))
    saver.save_best_model(m1, 0.5)
    m2 = _model(seed=32)
    with crash_at_write("zip/temp_written"):
        with pytest.raises(SimulatedCrash):
            saver.save_best_model(m2, 0.4)
    best = saver.get_best_model()
    np.testing.assert_array_equal(_params(best), _params(m1))


def test_checkpoint_timers_land_in_fault_summary(tmp_path):
    m = _model()
    with telemetry.enabled() as sess:
        m.fit(_iter(), epochs=1, checkpoint_dir=str(tmp_path / "ck"))
        m2 = _model()
        m2.fit(_iter(), epochs=1, checkpoint_dir=str(tmp_path / "ck"),
               resume=True)
        summary = sess.summary()
    fs = summary["fault"]
    assert fs["checkpoint_saves"]["zip"] >= 1
    assert fs["checkpoint_restores"]["zip"] >= 1
    assert fs["checkpoint_save_s"]["zip"] > 0


# ======================================================================
# process-level injectors
# ======================================================================
@pytest.fixture
def _hooks():
    yield
    clear_crash_hooks()


def test_kill_at_step_fires_on_exact_step(monkeypatch, _hooks):
    exits = []
    monkeypatch.setattr(_inj.os, "_exit", exits.append)
    kill_at_step(2)
    for step in range(4):
        _inj.fire_crash_point(_inj.STEP_POINT, step=step, worker=0)
    assert exits == [137]


def test_hang_at_step_stalls_without_exiting(monkeypatch, _hooks):
    naps = []
    monkeypatch.setattr(_inj.time, "sleep", naps.append)
    hang_at_step(1, hang_s=7.5)
    _inj.fire_crash_point(_inj.STEP_POINT, step=0)
    _inj.fire_crash_point(_inj.STEP_POINT, step=1)
    assert naps == [7.5]


def test_sigterm_at_step_delivers_to_self(monkeypatch, _hooks):
    sent = []
    monkeypatch.setattr(_inj.os, "kill",
                        lambda pid, sig: sent.append((pid, sig)))
    sigterm_at_step(3)
    _inj.fire_crash_point(_inj.STEP_POINT, step=3)
    assert sent == [(os.getpid(), signal.SIGTERM)]


def test_install_faults_from_env_arms_and_reports(_hooks):
    armed = install_faults_from_env({
        "DL4J_SIGTERM_AT_STEP": "5",
        "DL4J_CRASH_AT_WRITE": "zip/temp_written:2",
        "DL4J_EXIT_AT_WRITE": "elastic/commit_marker",
    })
    assert armed == ["sigterm_at_step(5)", "crash_at_write(zip/temp_written)",
                     "exit_at_write(elastic/commit_marker)"]
    assert install_faults_from_env({}) == []
    _inj.fire_crash_point("zip/temp_written", path="x")
    with pytest.raises(SimulatedCrash):
        _inj.fire_crash_point("zip/temp_written", path="x")


def test_exit_at_write_hard_exits_at_nth(monkeypatch, _hooks):
    exits = []
    monkeypatch.setattr(_inj.os, "_exit", exits.append)
    install_faults_from_env({"DL4J_EXIT_AT_WRITE": "zip/temp_written:2"})
    _inj.fire_crash_point("zip/temp_written", path="x")
    assert exits == []
    _inj.fire_crash_point("zip/temp_written", path="x")
    assert exits == [137]


# ======================================================================
# a checkpoint directory crossing the packages
# ======================================================================
CROSS_X, CROSS_Y = _classification(n=6 * 16, seed=9)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np_tree(v) for v in t)
    return np.array(t, np.float32)


_JAX_RUNS = {}


@pytest.fixture
def jax_cross_runs(one_torch_thread, tmp_path_factory):
    """The JAX run below, made once per module inside the port tests'
    one-core pin (a module-scoped fixture would run before the pin, and
    its XLA compiles would take every core)."""
    if "jax_cross_runs" not in _JAX_RUNS:
        _JAX_RUNS["jax_cross_runs"] = _jax_cross_runs(tmp_path_factory)
    return _JAX_RUNS["jax_cross_runs"]


def _jax_cross_runs(tmp_path_factory):
    """JAX: the uninterrupted 2-epoch run, a run killed at its second
    checkpoint save (its directory), and the start both begin from."""
    jit = lambda: JaxArrayIt(CROSS_X, CROSS_Y, batch_size=16)
    ref = jax_init(JaxNet(_conf(jx)))
    start = tuple(_np_tree(t) for t in (ref.params, ref.updater_state,
                                        ref.state))
    ref.fit(jit(), epochs=2)
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    killed = jax_init(JaxNet(_conf(jx)))
    with jax_crash("zip/temp_written", nth=2):
        with pytest.raises(JaxCrash):
            killed.fit(jit(), epochs=2, checkpoint_dir=d, checkpoint_every=4)
    return start, np.asarray(ref.params_flat(), np.float32), d


def _port_from(start):
    net = pt.MultiLayerNetwork(
        MultiLayerConfiguration.from_json(_conf(pt).to_json()),
        device="cpu").init()
    return pt.from_jax_params(net, start[0], start[1], start[2])


def _port_it():
    return ArrayDataSetIterator(CROSS_X, CROSS_Y, batch_size=16)


def test_jax_checkpoint_directory_resumes_in_the_port(jax_cross_runs):
    """JAX's FitCheckpointer killed at its second save (iteration 4 is on
    disk); the port resumes the directory and ends where JAX's
    uninterrupted run ends, and where the port's own does, within 1e-4."""
    start, jax_done, d = jax_cross_runs
    net = _port_from(start)
    net.fit(_port_it(), epochs=2, checkpoint_dir=d, checkpoint_every=4,
            resume=True)
    assert net.iteration_count == 12 and net.epoch_count == 2
    np.testing.assert_allclose(net.params_flat(), jax_done, rtol=0,
                               atol=TRAJ_TOL)
    own = _port_from(start)
    own.fit(_port_it(), epochs=2)
    np.testing.assert_allclose(net.params_flat(), own.params_flat(), rtol=0,
                               atol=TRAJ_TOL)


def test_port_checkpoint_directory_resumes_in_jax(jax_cross_runs, tmp_path):
    """The port killed at its second save; JAX resumes the directory and
    ends where its own uninterrupted run ends, within 1e-4."""
    start, jax_done, _ = jax_cross_runs
    d = str(tmp_path / "port_ckpt")
    net = _port_from(start)
    with crash_at_write("zip/temp_written", nth=2):
        with pytest.raises(SimulatedCrash):
            net.fit(_port_it(), epochs=2, checkpoint_dir=d,
                    checkpoint_every=4)
    jnet = jax_init(JaxNet(_conf(jx)))
    jnet.fit(JaxArrayIt(CROSS_X, CROSS_Y, batch_size=16), epochs=2,
             checkpoint_dir=d, checkpoint_every=4, resume=True)
    assert jnet.iteration_count == 12
    np.testing.assert_allclose(np.asarray(jnet.params_flat(), np.float32),
                               jax_done, rtol=0, atol=TRAJ_TOL)
