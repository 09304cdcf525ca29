"""PyTorch port, ZeRO sharded data parallelism on the CPU: the twins of
`tests/test_zero.py` (parallel/zero.py), and the plan held against JAX's.

Within the port ZERO1 / ZERO2 equal REPLICATED: at 2 and 4 ranks to the
float32 rounding of the sums' order (rtol 2e-6, JAX's own bound), at one
rank bit for bit. The plan is JAX's: the same buckets for the same sizes,
the same sharded leaves, the same bytes by collective, bucket count and
accumulator / per-device footprints for the same model and data-axis size
(exact); its gathered moments equal the replicated trainer's. A kill in
the middle of a sharded save resumes bit-equal to the uninterrupted run.
"""
import types

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel import zero as jzero
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                               ShardingStrategy,
                                               TrainingMode, ZeroConfig,
                                               assign_buckets,
                                               collective_overlap_fraction,
                                               make_mesh, make_zero_step,
                                               zero_grad_specs,
                                               zero_opt_shardings)
from deeplearning4j_tpu_torch.parallel import zero as pzero
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


def _conf(lib, seed=7, updater=None, hidden=16):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or lib.Adam(1e-2)).list()
            .layer(lib.DenseLayer(n_out=hidden, activation="tanh"))
            .layer(lib.DenseLayer(n_out=hidden, activation="relu"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _jnet(seed=7, updater=None, hidden=16):
    return jax_init(JaxNet(_conf(jx, seed, updater, hidden)))


def _model(seed=7, updater=None, hidden=16):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    j = _jnet(seed, updater, hidden)
    net = pt.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        j.conf.to_json()), device="cpu").init()
    net.set_params_flat(np.asarray(j.params_flat()))
    return net


def _xy(n=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, n)]
    return x, y


def _data(n=64, seed=0):
    return pt.DataSet(*_xy(n, seed))


def _mesh():
    return make_mesh(device="cpu")


def _train(trainer, ds, steps=5):
    for _ in range(steps):
        trainer.fit(ds)
    return trainer


def _fake_mesh(d):
    """A data axis of `d` ranks for the static layout (this rank 0)."""
    return types.SimpleNamespace(shape={"data": d}, group=None,
                                 coords=lambda: {"data": 0})


# ======================================================================
# equivalence: ZeRO-1/2 must match replicated Adam
# ======================================================================
@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("strategy", [ShardingStrategy.ZERO1,
                                      ShardingStrategy.ZERO2])
def test_zero_matches_replicated_adam(world, strategy, width):
    j = _jnet()
    conf, start = j.conf.to_json(), np.asarray(j.params_flat())
    batches = [_xy()] * 5
    ref = world.run(tasks.train, conf, start, batches, {}, width=width)[0]
    out = world.run(tasks.train, conf, start, batches,
                    {"strategy": strategy, "zero_bucket_mb": 0.0005},
                    width=width)[0]
    np.testing.assert_allclose(out["params"], ref["params"], rtol=2e-6,
                               atol=1e-7)
    # the sharded moments, gathered, equal the replicated trainer's
    np.testing.assert_allclose(out["opt"], ref["opt"], rtol=2e-6,
                               atol=1e-8)


@pytest.mark.parametrize("strategy", ["zero1", "zero2"])
def test_zero_one_rank_is_bit_equal_to_replicated(strategy):
    ds = _data()
    ref = _train(ParallelTrainer(_model(), mesh=_mesh()), ds)
    tr = _train(ParallelTrainer(_model(), mesh=_mesh(), strategy=strategy),
                ds)
    np.testing.assert_array_equal(tr.publish_view().params_flat(),
                                  ref.publish_view().params_flat())


def _shard_facts(ctx, conf, start):
    net = tasks.build(conf, start)
    tr = ParallelTrainer(net, mesh=ctx.mesh, strategy="zero1")
    x, y = _xy()
    tr.fit(pt.DataSet(x, y))
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    full = sum(t.numel() for t in flat_leaves(net.updater_state))
    mine = sum(t.numel() for t in flat_leaves(tr._opt))
    params = [tuple(t.shape) for t in flat_leaves(tr._params)]
    return {"full": full, "mine": mine, "params": params,
            "info": tr.collective_accounting()}


def test_zero_opt_state_is_sharded_params_replicated(world):
    j = _jnet()
    facts = world.run(_shard_facts, j.conf.to_json(),
                      np.asarray(j.params_flat()), width=2)
    f = facts[0]
    assert f["mine"] < f["full"], "no optimizer moment is sharded"
    assert f["params"] == [tuple(np.shape(a)) for a in
                           jax.tree_util.tree_leaves(j.params)]
    assert f["info"]["sharded_leaves"] > 0
    assert f["info"]["bytes"]["all_gather"] > 0


def test_zero2_bf16_wire_trains():
    """The bf16 reduction is a wire format: the fp32 master update still
    converges, params stay fp32."""
    ds = _data()
    tr = ParallelTrainer(_model(), mesh=_mesh(),
                         strategy=ShardingStrategy.ZERO2,
                         zero_reduce_dtype="bfloat16")
    tr.fit(ds)
    s0 = tr.score(ds)
    _train(tr, ds, 15)
    assert tr.score(ds) < s0
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    for t in flat_leaves(tr._params):
        assert t.dtype == torch.float32


def _graph_conf(lib, seed=7):
    b = (lib.NeuralNetConfiguration.builder().seed(seed)
         .updater(lib.Adam(1e-2)).graph_builder())
    b.add_inputs("in")
    b.add_layer("d0", lib.DenseLayer(n_out=16, activation="tanh"), "in")
    b.add_layer("out", lib.OutputLayer(n_out=4, loss="mcxent"), "d0")
    b.set_outputs("out")
    b.set_input_types(lib.InputType.feed_forward(8))
    return b.build()


def test_zero_graph_model_matches_replicated(world):
    conf = _graph_conf(jx).to_json()
    batches = [_xy()] * 5
    ref = world.run(tasks.train, conf, None, batches, {"graph": True},
                    width=2)[0]
    out = world.run(tasks.train, conf, None, batches,
                    {"graph": True, "strategy": "zero2"}, width=2)[0]
    np.testing.assert_allclose(out["params"], ref["params"], rtol=2e-6,
                               atol=1e-7)


# ======================================================================
# bucket assignment and the static layout, against JAX's
# ======================================================================
def test_assign_buckets_bounds_and_covers():
    sizes = [100, 200, 50, 1000, 10, 10, 10]
    buckets = assign_buckets(sizes, 300)
    assert [i for b in buckets for i in b] == list(range(len(sizes)))
    for b in buckets:
        assert sum(sizes[i] for i in b) <= 300 or len(b) == 1
    assert [3] in buckets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_buckets_equal_jax(seed):
    r = np.random.default_rng(seed)
    sizes = [int(s) for s in r.integers(1, 5000, 40)]
    for cap in (1, 1000, 4096, 1 << 20):
        assert assign_buckets(sizes, cap) == jzero.assign_buckets(sizes,
                                                                  cap)


def test_assign_buckets_bound_drives_flush_count():
    big = _model(hidden=32)
    _, few = make_zero_step(big, _mesh(),
                            config=ZeroConfig(stage=2, bucket_mb=64))
    _, many = make_zero_step(big, _mesh(),
                             config=ZeroConfig(stage=2, bucket_mb=0.001))
    assert few["n_buckets"] >= 1
    assert many["n_buckets"] > few["n_buckets"]


def test_zero_specs_equal_jax():
    """The PartitionSpecs of the gradients and the optimizer state are
    JAX's for the same model on 8 data ranks."""
    j = _jnet(hidden=16)
    m = _model(hidden=16)
    mesh8 = jax_mesh({"data": 8})
    jspecs = [tuple(s) for s in jax.tree_util.tree_leaves(
        jzero.zero_grad_specs(j.params, mesh8, "data"),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    pspecs = [tuple(s) for s in flat_leaves_specs(
        zero_grad_specs(m.params, _fake_mesh(8), "data"))]
    assert pspecs == jspecs
    o = zero_opt_shardings(m.updater_state, m.params, _fake_mesh(8))
    assert len(flat_leaves_specs(o)) == len(flat_leaves(m.updater_state))


def flat_leaves_specs(tree):
    from deeplearning4j_tpu_torch.parallel.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in flat_leaves_specs(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in flat_leaves_specs(t)]
    return [tree]


@pytest.mark.parametrize("stage,reduce_dtype,bucket_mb", [
    (1, None, 4.0), (2, None, 0.0005), (2, "bfloat16", 0.0005),
    (2, None, 64.0)])
def test_zero_plan_accounting_equals_jax(stage, reduce_dtype, bucket_mb):
    """The plan's static accounting (bytes by collective, buckets, sharded
    leaves, accumulator and per-device footprints) is JAX's, for the same
    model on 8 data ranks, and so is the overlap gauge's value."""
    j = _jnet(hidden=32)
    m = _model(hidden=32)
    cfg = dict(stage=stage, reduce_dtype=reduce_dtype, bucket_mb=bucket_mb)
    _, jinfo = jzero.make_zero_step(j, jax_mesh({"data": 8}),
                                    config=jzero.ZeroConfig(**cfg))
    plan = pzero._ZeroPlan(m, _fake_mesh(8), "data", ZeroConfig(**cfg))
    for key in ("stage", "n_buckets", "sharded_leaves", "replicated_leaves",
                "devices", "accum_bytes", "per_device_bytes", "bytes"):
        assert plan.info[key] == jinfo[key], key
    assert plan.expected_constraints() == jinfo["expected_constraints"]
    for m_ in (1, 4):
        assert collective_overlap_fraction(plan.info, m_) == \
            jzero.collective_overlap_fraction(jinfo, m_)


# ======================================================================
# mode/strategy validation
# ======================================================================
@pytest.mark.parametrize("strategy", [ShardingStrategy.ZERO1,
                                      ShardingStrategy.ZERO2,
                                      ShardingStrategy.FSDP,
                                      ShardingStrategy.TENSOR_PARALLEL])
def test_averaging_rejects_sharded_strategies_up_front(strategy):
    with pytest.raises(ValueError) as e:
        ParallelTrainer(_model(), mesh=_mesh(),
                        mode=TrainingMode.AVERAGING, strategy=strategy)
    msg = str(e.value)
    assert strategy in msg and "averaging" in msg
    assert "zero1" in msg and "zero2" in msg
    assert TrainingMode.SYNC in msg


def test_unknown_mode_and_strategy_rejected():
    with pytest.raises(ValueError, match="unknown training mode"):
        ParallelTrainer(_model(), mesh=_mesh(), mode="bogus")
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        ParallelTrainer(_model(), mesh=_mesh(), strategy="zero9")


def test_zero1_rejects_reduce_dtype():
    with pytest.raises(ValueError, match="ZERO2"):
        ParallelTrainer(_model(), mesh=_mesh(),
                        strategy=ShardingStrategy.ZERO1,
                        zero_reduce_dtype="bfloat16")


def test_non_zero_strategy_rejects_zero_knobs():
    for kw in ({"zero_reduce_dtype": "bfloat16"}, {"zero_bucket_mb": 1.0}):
        with pytest.raises(ValueError, match="only apply to the ZeRO"):
            ParallelTrainer(_model(), mesh=_mesh(), **kw)


def _gradnorm_conf(lib, mode):
    return (lib.NeuralNetConfiguration.builder().seed(1)
            .updater(lib.Adam(1e-2)).gradient_normalization(mode, 0.5)
            .list()
            .layer(lib.DenseLayer(n_out=16, activation="tanh"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


@pytest.mark.parametrize("mode", ["clip_l2_per_layer",
                                  "renormalize_l2_per_param_type"])
def test_zero2_whole_tensor_gradient_normalization_matches_jax(world, mode):
    """A per-layer / per-tensor gradient normalization under ZERO2 and
    FSDP takes its norms from the ranks' chunks (each chunk's sum of
    squares all-reduced): 2 ranks equal JAX's ZERO2 on its 8-device mesh
    at 1e-5, one rank equals the model's own fit bit for bit."""
    from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
    j = jax_init(JaxNet(_gradnorm_conf(jx, mode)))
    conf, start = j.conf.to_json(), np.asarray(j.params_flat())
    x, y = _xy()
    jt = JaxTrainer(j, mesh=jax_mesh({"data": 8}), strategy="zero2",
                    zero_bucket_mb=0.0005)
    for _ in range(4):
        jt.fit(jx.DataSet(x, y))
    jt._sync_back()
    for kw in ({"strategy": "zero2", "zero_bucket_mb": 0.0005},
               {"strategy": "fsdp"}):
        out = world.run(tasks.train, conf, start, [(x, y)] * 4, kw,
                        width=2)[0]
        np.testing.assert_allclose(out["params"],
                                   np.asarray(j.params_flat()), rtol=1e-5,
                                   atol=1e-6)
    single, multi = tasks.build(conf, start), tasks.build(conf, start)
    tr = ParallelTrainer(multi, mesh=_mesh(), strategy="zero2")
    for _ in range(4):
        single.fit(pt.DataSet(x, y))
        tr.fit(pt.DataSet(x, y))
    np.testing.assert_array_equal(multi.params_flat(), single.params_flat())


# ======================================================================
# the evaluation plane's caches and composition
# ======================================================================
def test_guard_rollback_invalidates_eval_caches():
    """A TrainingGuard rollback rewinds iteration_count; the per-step
    eval-view cache keyed on it must be dropped on restore."""
    from deeplearning4j_tpu_torch.fault import GuardPolicy, TrainingGuard

    ds, ragged = _data(64), _data(37, seed=3)
    tr = _train(ParallelTrainer(_model(), mesh=_mesh(), strategy="fsdp"),
                ds, 2)
    guard = TrainingGuard(policy=GuardPolicy.ROLLBACK)
    snap = guard._snapshot(tr)
    tr.fit(ds)
    tr.score(ragged)
    assert tr._eval_cache is not None
    guard._restore(tr, snap)
    assert tr._eval_cache is None
    ref = _train(ParallelTrainer(_model(), mesh=_mesh(), strategy="fsdp"),
                 ds, 2)
    assert tr.score(ragged) == pytest.approx(ref.score(ragged), rel=1e-6)


def _score_facts(ctx, conf, start):
    x, y = _xy()
    out = {}
    for strategy in ("replicated", "zero1"):
        tr = ParallelTrainer(tasks.build(conf, start), mesh=ctx.mesh,
                             strategy=strategy)
        for _ in range(5):
            tr.fit(pt.DataSet(x, y))
        xr, yr = _xy(37, seed=3)
        out[strategy] = {"score": tr.score(pt.DataSet(x, y)),
                         "n": tr.evaluate(pt.DataSet(x, y)).num_examples(),
                         "ragged": tr.score(pt.DataSet(xr, yr))}
    return out


def test_zero_score_evaluate_and_ragged_score(world):
    j = _jnet()
    f = world.run(_score_facts, j.conf.to_json(),
                  np.asarray(j.params_flat()), width=2)[0]
    assert f["zero1"]["score"] == pytest.approx(f["replicated"]["score"],
                                                rel=1e-6)
    assert f["zero1"]["n"] == 64
    assert np.isfinite(f["zero1"]["ragged"])
    assert f["zero1"]["ragged"] == pytest.approx(
        f["replicated"]["ragged"], rel=1e-6)


def test_gathered_view_cached_until_next_fit_step(monkeypatch):
    """Repeated score() calls between fit steps gather FSDP's params ONCE;
    the next fit invalidates the cache."""
    ds, ragged = _data(64), _data(37, seed=3)
    tr = _train(ParallelTrainer(_model(), mesh=_mesh(), strategy="fsdp"),
                ds, 2)
    calls = {"n": 0}
    orig = tr._plan.gather_params

    def counting(tree):
        calls["n"] += 1
        return orig(tree)

    monkeypatch.setattr(tr._plan, "gather_params", counting)
    tr._fit_batch(ds)        # a step without fit()'s publish
    s1 = tr.score(ragged)
    first = calls["n"]
    assert first > 0
    s2 = tr.score(ragged)
    assert calls["n"] == first and s1 == s2
    tr._fit_batch(ds)
    before = calls["n"]
    tr.score(ragged)
    assert calls["n"] > before


def test_averaging_eval_view_cached_per_step():
    ds = _data(64)
    tr = ParallelTrainer(_model(updater=jx.Sgd(0.05)), mesh=_mesh(),
                         mode=TrainingMode.AVERAGING)
    tr.fit(ds)
    p1, _ = tr._eval_params_state()
    p2, _ = tr._eval_params_state()
    assert p1 is p2
    tr._fit_batch(ds)
    p3, _ = tr._eval_params_state()
    assert p3 is not p1


def test_zero_early_stopping_compose():
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingParallelTrainer, MaxEpochsTerminationCondition)
    ds = _data(64)
    cfg = (EarlyStoppingConfiguration.Builder()
           .score_calculator(DataSetLossCalculator(
               pt.ListDataSetIterator([ds])))
           .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
           .build())
    tr = ParallelTrainer(_model(), mesh=_mesh(), strategy="zero1")
    result = EarlyStoppingParallelTrainer(
        cfg, train_iter=pt.ListDataSetIterator([ds]), trainer=tr).fit()
    assert result.total_epochs == 2
    assert result.best_model is not None


# ======================================================================
# telemetry: collective-traffic counters
# ======================================================================
def test_zero_telemetry_counters():
    from deeplearning4j_tpu_torch.telemetry import runtime as tel_runtime
    ds = _data(64)
    with tel_runtime.enabled() as sess:
        tr = ParallelTrainer(_model(), mesh=_mesh(), strategy="zero2",
                             zero_bucket_mb=0.0001)
        _train(tr, ds, 3)
        reg = sess.registry
        c = reg.get("dl4j_collective_bytes_total")
        assert c.value(op="reduce_scatter") > 0
        assert c.value(op="all_gather") > 0
        flushes = reg.get("dl4j_dp_bucket_flushes_total")
        assert flushes.value() >= 3 * 2
        dp = sess.dp_summary()
        assert dp["collective_bytes"]["reduce_scatter"] == \
            3 * tr.collective_accounting()["bytes"]["reduce_scatter"]
        assert dp["bucket_flushes"] == flushes.value()
        assert "dp" in sess.summary()


# ======================================================================
# the fault plane: kill mid-sharded-save, resume
# ======================================================================
def test_zero_kill_mid_sharded_save_resume_matches_uninterrupted(world,
                                                                 tmp_path):
    j = _jnet()
    x, y = _xy()
    batches = [(x[:32], y[:32]), (x[32:], y[32:])] * 2
    out = world.run(tasks.checkpoint_resume, j.conf.to_json(),
                    np.asarray(j.params_flat()), batches,
                    {"strategy": "zero1"}, str(tmp_path / "ck"), 2,
                    width=2)
    for o in out:
        assert o["crashed"]
        np.testing.assert_array_equal(o["params"], o["ref_params"])
        np.testing.assert_array_equal(o["opt"], o["ref_opt"])
        assert o["iters"] == 4
