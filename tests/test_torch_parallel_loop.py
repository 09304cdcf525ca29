"""PyTorch port, the parallel trainer inside the training loop, on the
CPU: the ParallelTrainer twins that `tests/test_torch_superstep.py`,
`test_torch_accumulation.py`, `test_torch_fault.py`,
`test_torch_input_pipeline` coverage and `test_torch_telemetry.py` left
for ROADMAP A11 (from `tests/test_superstep.py`, `test_accumulation.py`,
`test_fault.py`, `test_input_pipeline.py`, `test_telemetry.py`), the three
`early_stopping_parallel_*` twins of
`tests/test_transfer_earlystopping_eval.py`, the sharded store, and the
coordinated two-phase-commit store crossing the packages.

Within the port: superstep K equals K = 1 bit for bit in every SYNC
strategy (at 2 ranks too: the collectives run in the same order either
way, where JAX's ZeRO scan body may reassociate, rtol 2e-6 there); resume
equals the uninterrupted run bit for bit; gradient accumulation equals the
native big batch at 1e-4 (JAX's bound, the batch sums in another order).
`pad_ragged` on 2 ranks equals JAX's on its 2-device mesh at 1e-5 (each
rank's mean weighted by its live rows). A `CoordinatedShardStore` written
by either package restores in the other with the same bits.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.checkpoint import \
    CoordinatedShardStore as JaxStore
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.fault import (FaultyIterator, GuardPolicy,
                                            SimulatedCrash, TrainingGuard,
                                            crash_at_write)
from deeplearning4j_tpu_torch.nn.trees import flat_leaves
from deeplearning4j_tpu_torch.parallel import (CoordinatedShardStore,
                                               ElasticWorkerLost,
                                               ParallelTrainer,
                                               ShardedCheckpoint,
                                               TrainingMode,
                                               collective_overlap_fraction,
                                               make_mesh,
                                               make_zero_accum_superstep,
                                               save_sharded)
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_parallel_tasks as tasks
from torch_world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("world"), widths=(1, 2))
    yield w
    w.close()


def _conf(lib, seed=7, updater=None):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or lib.Adam(1e-3)).list()
            .layer(lib.DenseLayer(n_out=32, activation="relu"))
            .layer(lib.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(12)).build())


def _start(seed=7, updater=None):
    j = jax_init(JaxNet(_conf(jx, seed, updater)))
    return j, j.conf.to_json(), np.asarray(j.params_flat())


def _mlp(seed=7):
    _, conf, start = _start(seed)
    return tasks.build(conf, start)


def _data(n, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 12)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[r.integers(0, 5, n)]
    return x, y


def _batches(x, y, b=16):
    return [(x[i:i + b], y[i:i + b]) for i in range(0, len(x), b)]


def _it(x, y, b=16):
    return pt.ArrayDataSetIterator(x, y, batch_size=b)


def _mesh():
    return make_mesh(device="cpu")


# ======================================================================
# superstep
# ======================================================================
@pytest.mark.parametrize("strategy", ["replicated", "zero1", "zero2",
                                      "fsdp"])
def test_superstep_parallel_trainer(world, strategy):
    _, conf, start = _start()
    x, y = _data(6 * 16)
    b = _batches(x, y)
    kw = {"strategy": strategy}
    k1 = world.run(tasks.train, conf, start, b, kw, {"epochs": 2},
                   width=2)[0]
    k4 = world.run(tasks.train, conf, start, b, kw,
                   {"epochs": 2, "superstep": 4}, width=2)[0]
    assert k1["iters"] == k4["iters"] == 12
    np.testing.assert_array_equal(k4["params"], k1["params"])
    np.testing.assert_array_equal(k4["opt"], k1["opt"])


def test_superstep_trainer_untrainable_batch_cursor_and_resume(world,
                                                               tmp_path):
    """A batch with fewer rows than the 4 ranks trims to nothing; a fit
    killed after it resumes bit-equal to the uninterrupted run."""
    _, conf, start = _start()
    x, y = _data(6 * 16)
    b = _batches(x, y)
    seq = b[:2] + [(x[:3], y[:3])] + b[2:]
    out = world.run(tasks.untrainable_resume, conf, start, seq,
                    str(tmp_path / "ckpt"))
    for o in out:
        assert o["raised"] and o["ref_iters"] == 6
        assert o["iters"] == o["ref_iters"]
        np.testing.assert_array_equal(o["params"], o["ref"])


def test_superstep_trainer_guard_and_checkpoint(tmp_path):
    x, y = _data(4 * 16)
    ref = ParallelTrainer(_mlp(), mesh=_mesh())
    ref.fit(_it(x[:32], y[:32]), superstep=2)
    t = ParallelTrainer(_mlp(), mesh=_mesh())
    guard = TrainingGuard(policy=GuardPolicy.SKIP_BATCH)
    t.fit(FaultyIterator(_it(x, y), nan_at=2), superstep=2, guard=guard)
    assert t.iteration_count == 2
    np.testing.assert_array_equal(t.model.params_flat(),
                                  ref.model.params_flat())
    assert guard.skipped_batches == 1
    # interval saves on the sharded store, resume to the same bits
    d = str(tmp_path / "ck")
    full = ParallelTrainer(_mlp(), mesh=_mesh())
    full.fit(_it(x, y), epochs=2, superstep=2)
    t1 = ParallelTrainer(_mlp(), mesh=_mesh())
    with crash_at_write("sharded/tree_written", nth=3):
        with pytest.raises(SimulatedCrash):
            t1.fit(_it(x, y), epochs=2, superstep=2, checkpoint_dir=d,
                   checkpoint_every=2)
    t2 = ParallelTrainer(_mlp(), mesh=_mesh())
    t2.fit(_it(x, y), epochs=2, superstep=2, checkpoint_dir=d,
           checkpoint_every=2, resume=True)
    np.testing.assert_array_equal(t2.model.params_flat(),
                                  full.model.params_flat())


# ======================================================================
# gradient accumulation
# ======================================================================
@pytest.mark.parametrize("strategy", ["replicated", "zero1", "zero2"])
def test_trainer_accum_matches_native_bigbatch(world, strategy):
    _, conf, start = _start()
    x, y = _data(8 * 32)
    kw = {"strategy": strategy}
    acc = world.run(tasks.train, conf, start, _batches(x, y, 32), kw,
                    {"epochs": 2, "grad_accumulation": 4}, width=2)[0]
    big = world.run(tasks.train, conf, start, _batches(x, y, 128), kw,
                    {"epochs": 2}, width=2)[0]
    assert acc["iters"] == big["iters"] == 4
    np.testing.assert_allclose(acc["params"], big["params"], rtol=1e-4,
                               atol=1e-6)


def test_trainer_zero2_sharded_vs_replicated_accumulation(world):
    _, conf, start = _start()
    x, y = _data(8 * 16)
    fit = {"epochs": 2, "grad_accumulation": 4}
    z = world.run(tasks.train, conf, start, _batches(x, y), {
        "strategy": "zero2"}, fit, width=2)[0]
    r = world.run(tasks.train, conf, start, _batches(x, y), {}, fit,
                  width=2)[0]
    np.testing.assert_allclose(z["params"], r["params"], rtol=1e-4,
                               atol=1e-6)
    # the accumulator footprint of the plan on 8 ranks: ~1/8 + bias slack
    big_conf = (pt.NeuralNetConfiguration.builder().seed(7)
                .updater(pt.Adam(1e-3)).list()
                .layer(pt.DenseLayer(n_out=256, activation="relu"))
                .layer(pt.OutputLayer(n_out=8, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(pt.InputType.feed_forward(128)).build())
    big = pt.MultiLayerNetwork(big_conf, device="cpu").init()
    import types
    mesh8 = types.SimpleNamespace(shape={"data": 8}, group=None,
                                  coords=lambda: {"data": 0})
    _, info = make_zero_accum_superstep(big, mesh8)
    acc = info["accum_bytes"]
    assert acc["sharded"] < 0.2 * acc["replicated"]
    assert acc["replicated"] == 4 * big.num_params()


def test_trainer_zero2_overlap_gauge_and_fraction():
    assert collective_overlap_fraction({"stage": 1, "n_buckets": 0},
                                       4) == 0.0
    assert collective_overlap_fraction(
        {"stage": 2, "n_buckets": 3}, 4) == pytest.approx(1 - 1 / 12,
                                                          abs=1e-3)
    x, y = _data(8 * 16)
    with telemetry.enabled() as sess:
        t = ParallelTrainer(_mlp(), mesh=_mesh(), strategy="zero2",
                            zero_bucket_mb=1e-4)
        t.fit(_it(x, y), epochs=1, grad_accumulation=4)
        g = sess.registry.get("dl4j_collective_overlap_fraction")
        nb = t.collective_accounting()["n_buckets"]
        assert nb >= 2
        assert g.value() == pytest.approx(1 - 1 / (4 * nb), abs=1e-3)
        dp = sess.dp_summary()
    info = t.collective_accounting()
    micros, steps = 8, 2
    assert dp["collective_bytes"]["reduce_scatter"] == \
        info["bytes"]["reduce_scatter"] * micros
    assert dp["collective_bytes"]["all_gather"] == \
        info["bytes"]["all_gather"] * steps


def test_trainer_accum_rejected_where_unsupported():
    x, y = _data(4 * 16)
    t = ParallelTrainer(_mlp(), mesh=_mesh(), collect_stats=True)
    with pytest.raises(ValueError, match="grad_accumulation"):
        t.fit(_it(x, y), grad_accumulation=2)
    t2 = ParallelTrainer(_mlp(), mesh=_mesh(), mode=TrainingMode.AVERAGING)
    with pytest.raises(ValueError, match="grad_accumulation"):
        t2.fit(_it(x, y), grad_accumulation=2)
    t3 = ParallelTrainer(_mlp(), mesh=_mesh())
    with pytest.raises(ValueError, match="grad_accumulation"):
        t3.fit(pt.DataSet(x, y), grad_accumulation=2)


def test_trainer_accum_guard_and_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    x, y = _data(8 * 16)
    ref = ParallelTrainer(_mlp(), mesh=_mesh())
    ref.fit(_it(x, y), epochs=1, grad_accumulation=2)
    t1 = ParallelTrainer(_mlp(), mesh=_mesh())
    with pytest.raises(RuntimeError):
        t1.fit(FaultyIterator(_it(x, y), raise_at=5, exc=RuntimeError),
               epochs=1, grad_accumulation=2, checkpoint_dir=d,
               checkpoint_every=1)
    t2 = ParallelTrainer(_mlp(), mesh=_mesh())
    t2.fit(_it(x, y), epochs=1, grad_accumulation=2, checkpoint_dir=d,
           resume=True)
    np.testing.assert_array_equal(t2.model.params_flat(),
                                  ref.model.params_flat())
    assert t2.iteration_count == ref.iteration_count == 4


# ======================================================================
# the sharded store (fault plane)
# ======================================================================
def _fit_one(m, seed=0):
    x, y = _data(16, seed)
    m.fit(pt.DataSet(x, y))
    return m


def test_sharded_latest_ignores_stray_entries(tmp_path):
    d = tmp_path / "ckpts"
    mgr = ShardedCheckpoint(str(d), keep=2)
    os.makedirs(d / "step_tmp")
    os.makedirs(d / "step_1_backup")
    (d / "stray.json").write_text("{}")
    (d / "step_0000").write_text("a FILE named like a step dir")
    assert mgr.latest_step() is None
    mgr._gc()
    mgr.save(_fit_one(_mlp()), 3)
    assert mgr.latest_step() == 3


def test_sharded_uncommitted_step_is_not_a_checkpoint(tmp_path):
    mgr = ShardedCheckpoint(str(tmp_path / "c"), keep=3)
    m = _fit_one(_mlp(21))
    mgr.save(m, 1)
    committed = m.params_flat()
    _fit_one(m)
    with crash_at_write("sharded/tree_written"):
        with pytest.raises(SimulatedCrash):
            mgr.save(m, 2)
    assert mgr._all_steps() == [1, 2]
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    m2 = _mlp(22)
    assert mgr.restore_latest(m2) == 1
    np.testing.assert_array_equal(m2.params_flat(), committed)


def test_sharded_gc_keeps_best_and_sweeps_crashed(tmp_path):
    mgr = ShardedCheckpoint(str(tmp_path / "c"), keep=2)
    m = _fit_one(_mlp())
    with crash_at_write("sharded/tree_written"):
        with pytest.raises(SimulatedCrash):
            mgr.save(m, 1)
    for step, score in [(2, 5.0), (3, 0.5), (4, 4.0), (5, 3.0)]:
        mgr.save(m, step, score=score)
    assert mgr.steps() == [3, 4, 5]
    assert mgr.best_step() == 3
    assert 1 not in mgr._all_steps()


def test_kill_mid_sharded_save_resume_matches_uninterrupted(tmp_path):
    x, y = _data(64)
    it = lambda: _it(x, y, 32)
    ref = ParallelTrainer(_mlp(), mesh=_mesh())
    ref.fit(it(), epochs=2)
    d = str(tmp_path / "ck")
    tr1 = ParallelTrainer(_mlp(), mesh=_mesh())
    with crash_at_write("sharded/tree_written", nth=2):
        with pytest.raises(SimulatedCrash):
            tr1.fit(it(), epochs=2, checkpoint_dir=d, checkpoint_every=2)
    mgr = ShardedCheckpoint(d)
    assert mgr.latest_step() is not None
    assert mgr.latest_step() < max(mgr._all_steps())
    tr2 = ParallelTrainer(_mlp(), mesh=_mesh())
    tr2.fit(it(), epochs=2, checkpoint_dir=d, checkpoint_every=2,
            resume=True)
    assert tr2.iteration_count == ref.iteration_count
    np.testing.assert_array_equal(tr2.publish_view().params_flat(),
                                  ref.publish_view().params_flat())


def test_sharded_legacy_unmarked_dirs_restorable_and_not_gced(tmp_path):
    d = tmp_path / "c"
    m = _fit_one(_mlp(41))
    legacy = m.params_flat()
    save_sharded(str(d / "step_000000001"), m)     # no step COMMIT marker
    mgr = ShardedCheckpoint(str(d), keep=1)
    assert mgr.steps() == []
    m2 = _mlp(43)
    assert mgr.restore_latest(m2) == 1
    np.testing.assert_array_equal(m2.params_flat(), legacy)
    _fit_one(m)
    mgr.save(m, 5)
    assert 1 in mgr._all_steps()
    assert mgr.latest_step() == 5


def test_guard_skip_batch_on_parallel_trainer():
    x, y = _data(64)
    tr = ParallelTrainer(_mlp(), mesh=_mesh())
    guard = TrainingGuard("skip_batch")
    tr.fit(FaultyIterator(_it(x, y, 32), nan_at=2), epochs=2, guard=guard)
    assert guard.skipped_batches == 1
    assert np.isfinite(tr.publish_view().params_flat()).all()


# ======================================================================
# input pipeline and telemetry
# ======================================================================
def test_parallel_trainer_pad_ragged_matches_jax_mesh(world):
    """26 rows at batch 8 on 2 ranks: the ragged tail of 2 is padded with
    weight-zero rows, every example trains, and the result equals JAX's
    pad_ragged fit on its 2-device mesh (the ranks' live rows differ in
    the tail: each mean is weighted by its live rows)."""
    j, conf, start = _start()
    x, y = _data(26)
    jt = JaxTrainer(j, mesh=jax_mesh({"data": 2},
                                     devices=jax.devices()[:2]))
    jt.fit(jx.ArrayDataSetIterator(x, y, batch_size=8), pad_ragged=True)
    jt._sync_back()
    out = world.run(tasks.train, conf, start, _batches(x, y, 8), {},
                    {"pad_ragged": True}, width=2)[0]
    assert np.isfinite(out["score"])
    assert not np.allclose(out["params"], start)
    np.testing.assert_allclose(out["params"], np.asarray(j.params_flat()),
                               rtol=1e-5, atol=1e-6)


def test_parallel_trainer_telemetry():
    x, y = _data(32)
    with telemetry.enabled(sync_per_step=True, report_window=1) as sess:
        tr = ParallelTrainer(_mlp(), mesh=_mesh())
        for _ in range(3):
            tr.fit(pt.DataSet(x, y))
        tr.fit(_it(x, y, 8), superstep=2)
        assert sess.compiles.report()["parallel/superstep"]["count"] == 1
        spans = sess.span_totals()
        assert spans.get("device/dispatch", 0) > 0
        assert spans.get("device/sync", 0) > 0
        assert sess.registry.get("dl4j_host_rss_mb").value() > 0


# ======================================================================
# early stopping over the parallel trainer
# ======================================================================
def _cls():
    from conftest import make_classification
    xs, ys = make_classification()
    return xs.astype(np.float32), ys.astype(np.float32)


def _es_conf(lib, seed):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Adam(1e-2)).list()
            .layer(lib.DenseLayer(n_out=16, activation="relu"))
            .layer(lib.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(10)).build())


def test_early_stopping_parallel_trainer(world):
    """Early stopping over 2 ranks: termination fires, the validation
    scores of every epoch and the best model equal the single-model early
    stopping run (1e-4, JAX's bound)."""
    from deeplearning4j_tpu_torch import earlystopping as es
    xs, ys = _cls()
    j = jax_init(JaxNet(_es_conf(jx, 4)))
    conf, start = j.conf.to_json(), np.asarray(j.params_flat())
    train = _batches(xs[:192], ys[:192], 64)
    val = _batches(xs[192:], ys[192:], 64)
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            pt.ListDataSetIterator(tasks._datasets(val))),
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(4)],
        model_saver=es.InMemoryModelSaver())
    single = tasks.build(conf, start)
    res_s = es.EarlyStoppingTrainer(
        cfg, single, pt.ListDataSetIterator(tasks._datasets(train))).fit()
    out = world.run(tasks.early_stopping, conf, start, train, val, {}, 4,
                    width=2)
    for o in out:
        assert sorted(o["scores"]) == sorted(res_s.score_vs_epoch)
        for e, s in res_s.score_vs_epoch.items():
            assert o["scores"][e] == pytest.approx(s, rel=1e-4, abs=1e-6)
        assert o["best_epoch"] == res_s.best_model_epoch
    np.testing.assert_allclose(out[0]["params"], single.params_flat(),
                               rtol=1e-4, atol=1e-6)


def test_early_stopping_parallel_iteration_condition():
    from deeplearning4j_tpu_torch import earlystopping as es
    xs, ys = _cls()
    j = jax_init(JaxNet(_es_conf(jx, 5)))
    model = tasks.build(j.conf.to_json(), np.asarray(j.params_flat()))
    cfg = (es.EarlyStoppingConfiguration.Builder()
           .score_calculator(es.DataSetLossCalculator(
               pt.ArrayDataSetIterator(xs, ys, batch_size=64)))
           .iteration_termination_conditions(
               es.MaxScoreIterationTerminationCondition(1e-9))
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(50))
           .build())
    result = es.EarlyStoppingParallelTrainer(
        cfg, model=model,
        train_iter=pt.ArrayDataSetIterator(xs, ys, batch_size=64),
        mesh=_mesh(), mode=TrainingMode.SYNC).fit()
    assert result.termination_reason == "IterationTerminationCondition"
    assert result.termination_details == \
        "MaxScoreIterationTerminationCondition"


def test_early_stopping_parallel_averaging_preserves_cadence(world):
    """The early-stopping loop does not publish (and so average) the
    replicas after every minibatch: with averaging_frequency 100 the two
    ranks' replicas stay apart through the run."""
    r = np.random.default_rng(1)
    xs = r.normal(size=(64, 10)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[r.integers(0, 3, 64)]
    j = jax_init(JaxNet(_es_conf(jx, 6)))
    out = world.run(tasks.replica_params, j.conf.to_json(),
                    np.asarray(j.params_flat()), _batches(xs, ys, 32),
                    {"mode": "averaging", "averaging_frequency": 100}, 2,
                    width=2)
    assert all(o["epochs"] == 2 and o["best"] for o in out)
    assert not np.allclose(out[0]["leaf"], out[1]["leaf"])


# ======================================================================
# the coordinated two-phase-commit store, across the packages
# ======================================================================
def _trees(seed=3):
    """The same logical tree in each package's form: a network's params,
    state and updater state, bf16 leaves included."""
    j, conf, start = _start(seed)
    p = tasks.build(conf, start)
    p.fit(pt.DataSet(*_data(16)))
    bf = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(
        torch.bfloat16)
    ptree = {"params": p.params, "state": p.state,
             "updater_state": p.updater_state, "extra": {"bf": bf}}
    import ml_dtypes
    to_np = lambda t: (t.float().numpy().astype(ml_dtypes.bfloat16)
                       if t.dtype == torch.bfloat16 else t.numpy())
    from deeplearning4j_tpu_torch.nn.trees import tree_map
    jtree = tree_map(to_np, ptree)
    return ptree, jtree


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_coordinated_store_crosses_the_packages(tmp_path, writer):
    """Two workers' shards written by one package (the protocol emulated
    in one process), committed, and restored by the other: the same
    bits, the same file names."""
    ptree, jtree = _trees()
    d = str(tmp_path / "snap")
    Store = JaxStore if writer == "jax" else CoordinatedShardStore
    tree = jtree if writer == "jax" else ptree
    store = Store(d, n_workers=2)
    store.write_shards(tree, meta={"iteration_count": 1}, worker_id=0)
    store.write_shards(tree, worker_id=1)
    store.commit()
    assert sorted(os.listdir(d)) == sorted(
        ["COMMIT", "DURABLE_p0", "DURABLE_p1", "manifest_p0.json",
         "manifest_p1.json", "meta.json", "shards_p0.bin", "shards_p1.bin"])
    if writer == "jax":
        back = CoordinatedShardStore(d).read_tree(ptree)
        for a, b in zip(flat_leaves(back), flat_leaves(ptree)):
            assert a.dtype == b.dtype and torch.equal(a, b.detach())
    else:
        back = JaxStore(d).read_tree(jtree)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jtree)):
            assert a.dtype == b.dtype and (np.asarray(a) == b).all()
    assert Store(d).read_meta() == {"iteration_count": 1}


@pytest.mark.parametrize("point", ["elastic/shards_written",
                                   "elastic/durable_marked",
                                   "elastic/commit_marker"])
def test_coordinated_store_crash_points_leave_no_commit(tmp_path, point):
    ptree, _ = _trees()
    d = str(tmp_path / "snap")
    store = CoordinatedShardStore(d, n_workers=1, commit_timeout_s=0.2)
    with crash_at_write(point):
        with pytest.raises(SimulatedCrash):
            store.write_shards(ptree)
            store.commit()
    assert not store.committed()
    with pytest.raises(Exception):
        store.read_tree(ptree)


def test_coordinated_store_missing_worker_is_lost(tmp_path):
    ptree, _ = _trees()
    store = CoordinatedShardStore(str(tmp_path / "s"), n_workers=2,
                                  commit_timeout_s=0.2, poll_s=0.01)
    store.write_shards(ptree, worker_id=0)
    with pytest.raises(ElasticWorkerLost, match="never reached DURABLE"):
        store.commit()
    with pytest.raises(ElasticWorkerLost, match="COMMIT"):
        store.wait_committed()


def test_sharded_step_dir_is_the_coordinated_layout(tmp_path):
    """A step directory of the trainer's store holds its trees as a
    coordinated store JAX's reader restores."""
    m = _fit_one(_mlp(9))
    mgr = ShardedCheckpoint(str(tmp_path / "c"))
    mgr.save(m, 1)
    tree_dir = os.path.join(mgr._step_dir(1), "tree")
    j = jax_init(JaxNet(_conf(jx, 9)))
    jtree = {"params": j.params, "state": j.state,
             "updater_state": j.updater_state}
    back = JaxStore(tree_dir).read_tree(jtree)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a).ravel() for a in
                        jax.tree_util.tree_leaves(back["params"])]),
        m.params_flat())
    meta = json.load(open(os.path.join(mgr._step_dir(1), "meta.json")))
    assert meta["iteration_count"] == 1


def test_elastic_state_relands_on_another_world_width(world):
    """ZERO1 on 2 ranks for 2 steps, its logical state re-landed on 4 ranks
    under REPLICATED for 2 more: the uninterrupted 2-rank run's parameters
    at 1e-5 (float32 sums over another rank count)."""
    _, conf, start = _start()
    x, y = _data(64)
    ref = world.run(tasks.train, conf, start, [(x, y)] * 4,
                    {"strategy": "zero1"}, width=2)[0]
    tree, meta = world.run(tasks.elastic_state_of, conf, start,
                           [(x, y)] * 2, {"strategy": "zero1"}, width=2)[0]
    assert meta["mesh_axes"] == {"data": 2}
    out = world.run(tasks.continue_from, conf, tree, meta, [(x, y)] * 2,
                    {}, width=4)
    for o in out:
        assert o["iters"] == 4
        np.testing.assert_allclose(o["params"], ref["params"], rtol=1e-5,
                                   atol=1e-6)


def test_bilstm_parallel_modes(world):
    """The nested parameter trees of a GravesBidirectionalLSTM through the
    trainer on 4 ranks: SYNC (and ZERO2's chunked moments of the nested
    leaves) equal JAX's 4-device mesh at 1e-5, AVERAGING trains (the twin
    of `tests/test_bilstm_subsystems.py::test_bilstm_parallel_modes`; its
    tensor-parallel case is in `test_torch_tp_models.py`)."""
    def conf(lib):
        return (lib.NeuralNetConfiguration.builder().seed(0)
                .updater(lib.Sgd(0.1)).list()
                .layer(lib.GravesBidirectionalLSTM(n_out=6,
                                                   activation="tanh"))
                .layer(lib.RnnOutputLayer(n_out=3, loss="mcxent"))
                .set_input_type(lib.InputType.recurrent(5, 7)).build())
    r = np.random.default_rng(0)
    x = r.normal(size=(8, 7, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (8, 7))]
    j = jax_init(JaxNet(conf(jx)))
    start = np.asarray(j.params_flat())
    jt = JaxTrainer(j, mesh=jax_mesh({"data": 4},
                                     devices=jax.devices()[:4]))
    jt.fit(jx.DataSet(x, y))
    jt._sync_back()
    for kw in ({}, {"strategy": "zero2"}):
        out = world.run(tasks.train, j.conf.to_json(), start, [(x, y)], kw)
        np.testing.assert_allclose(out[0]["params"],
                                   np.asarray(j.params_flat()), rtol=1e-5,
                                   atol=1e-6)
    avg = world.run(tasks.train, j.conf.to_json(), start, [(x, y)],
                    {"mode": "averaging"})
    assert all(np.isfinite(o["score"]) for o in avg)
