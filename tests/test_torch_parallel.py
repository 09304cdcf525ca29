"""PyTorch port, the data-parallel trainer on the CPU: the twins of the
data-parallel half of `tests/test_parallel.py` (its tensor-parallel, ring
attention and pipeline cases are in `tests/test_torch_model_parallel.py`
and `tests/test_torch_pipeline_parallel.py`), and the port's
ParallelTrainer held against JAX's.

The port runs one rank per device over `torch.distributed`; here a world
of 4 gloo ranks (`torch_world`, started once for the module, with
subgroups of 1 and 2) stands in for JAX's 8-device virtual mesh. SYNC and
ZeRO do the same arithmetic at any width, so a world of 2 or 4 is held to
JAX's 8-device mesh at 1e-5 (float32 sums in another order; the ZeRO
strategies and FSDP too). AVERAGING's result depends on the number of
replicas, so it is held at JAX's own width: `make_mesh({"data": 4})`
against a world of 4, at 1e-5. The bf16 wire of ZERO2 is held to JAX's bf16
wire at the bf16 limits (2e-2 score, 5e-2 relative L2 of the parameters).
Within the port a world of one rank is bit-equal to the model's own fit.

A training-mode BatchNormalization takes its batch statistics over the
global batch in JAX's GSPMD step, and so does the port's SYNC step over
its ranks (`kernels/bn_split.py`); AVERAGING's replicas normalise by
their own rows in both.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.parallel import (MeshAxes, ParallelTrainer,
                                               ParallelWrapper,
                                               ShardedCheckpoint,
                                               ShardingStrategy,
                                               TrainingMode, global_mesh,
                                               make_mesh, param_specs,
                                               restore_sharded, save_sharded,
                                               shard_model,
                                               surviving_mesh_shape)
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_parallel_tasks as tasks
from torch_world import World

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("world"), widths=(1, 2))
    yield w
    w.close()


def _conf(lib, seed=7, updater=None, hidden=16, dropout=None):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or lib.Sgd(0.1)).list()
            .layer(lib.DenseLayer(n_out=hidden, activation="tanh",
                                  dropout=dropout))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _data(n=64, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, n)]
    return x, y


def _jnet(seed=7, updater=None, **kw):
    return jax_init(JaxNet(_conf(jx, seed, updater, **kw)))


def _pnet(jnet):
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    net = pt.MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    net.set_params_flat(np.asarray(jnet.params_flat()))
    return net


_JAX = {}


def _jax_trained(key, jnet, mesh_n, batches, **kw):
    """JAX's ParallelTrainer on `mesh_n` virtual devices, one fit per
    batch, cached per key."""
    if key not in _JAX:
        tr = JaxTrainer(jnet, mesh=jax_mesh({"data": mesh_n},
                                            devices=jax.devices()[:mesh_n]),
                        **kw)
        for x, y in batches:
            tr.fit(jx.DataSet(x, y))
        if getattr(tr, "_pipe", None) is None:   # the GPipe fit syncs back
            tr._sync_back()
        score = (tr._pipe.score() if getattr(tr, "_pipe", None) is not None
                 else tr.score())
        _JAX[key] = (np.asarray(jnet.params_flat()), float(score))
    return _JAX[key]


# ----------------------------------------------------------------------
# mesh
# ----------------------------------------------------------------------
def test_mesh_construction_single_rank():
    m = make_mesh(device="cpu")
    assert m.shape == {"data": 1} and m.size == 1 and m.rank == 0
    assert make_mesh({"data": -1}, device="cpu").shape["data"] == 1
    with pytest.raises(ValueError):
        make_mesh({"data": 3}, device="cpu")
    assert global_mesh(device="cpu").shape == {"data": 1}
    assert surviving_mesh_shape(4, (2, 2, 2)) == (1, 2, 2)
    assert surviving_mesh_shape(3, (2, 2, 2)) == (3, 1, 1)


def _mesh_facts(ctx):
    from deeplearning4j_tpu_torch.parallel import make_mesh as mk
    m = mk({"data": 2, "model": 2}, device="cpu")
    out = {"shape": m.shape, "coords": m.coords(), "backend": m.backend}
    try:
        mk({"data": 3}, device="cpu")
    except ValueError as e:
        out["err"] = str(e)
    return out


def test_mesh_construction_over_ranks(world):
    facts = world.run(_mesh_facts)
    assert facts[0]["shape"] == {"data": 2, "model": 2}
    assert [f["coords"] for f in facts] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert facts[0]["backend"] == "gloo"
    assert "needs 3 ranks" in facts[0]["err"]


def test_entry_points_default_to_the_gpu():
    """No GPU here: the default device raises, nothing falls back."""
    net = _pnet(_jnet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelTrainer(net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("strategy", [ShardingStrategy.TENSOR_PARALLEL,
                                      ShardingStrategy.ZERO1_TP,
                                      ShardingStrategy.PIPELINE,
                                      ShardingStrategy.PP,
                                      ShardingStrategy.ZERO1_TP_PP])
def test_model_parallel_strategies_name_roadmap_a11b(strategy):
    """The model-parallel strategies (ROADMAP A11b, now ported) on a
    one-rank data mesh, as JAX's on its one-device mesh: the trainer
    either raises JAX's ValueError (a model or pipe axis is missing) or,
    for PIPELINE (one stage on the data axis), trains a step equal to
    JAX's at 1e-5; `param_specs` gives JAX's specs, or its ValueError for
    the pipeline strategies (their layouts are their plans')."""
    jnet = _jnet()
    net = _pnet(jnet)
    mesh = make_mesh(device="cpu")
    jmesh = jax_mesh({"data": 1}, devices=jax.devices()[:1])
    try:
        JaxTrainer(jnet, mesh=jmesh, strategy=strategy)
        jax_err = None
    except ValueError as e:
        jax_err = str(e)
    if jax_err is not None:
        with pytest.raises(ValueError) as got:
            ParallelTrainer(net, mesh=mesh, strategy=strategy)
        assert str(got.value).split(" — ")[0].split(". ")[0] == \
            jax_err.split(" — ")[0].split(". ")[0]
    else:
        x, y = _data(16)
        ref, ref_score = _jax_trained(("one-rank", strategy), jnet, 1,
                                      [(x, y)], strategy=strategy)
        tr = ParallelTrainer(net, mesh=mesh, strategy=strategy)
        tr.fit(pt.DataSet(x, y))
        np.testing.assert_allclose(net.params_flat(), ref, **F32)
        assert tr.score() == pytest.approx(ref_score, rel=1e-5)
    from deeplearning4j_tpu.parallel import param_specs as jax_specs
    mesh2 = make_mesh({"data": 1, "model": 1}, device="cpu")
    jmesh2 = jax_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    try:
        want = jax_specs(jnet.params, strategy, jmesh2)
    except ValueError as e:
        with pytest.raises(ValueError, match="Unknown sharding strategy"):
            param_specs(net.params, strategy, mesh2)
        assert "Unknown sharding strategy" in str(e)
    else:
        got = param_specs(net.params, strategy, mesh2)
        assert [{k: tuple(v) for k, v in p.items()} for p in got] == \
            [{k: tuple(v) for k, v in p.items()} for p in want]


def test_model_axis_mesh_shape_names_roadmap_a11b():
    """mesh_shape=(d, m) builds the (data, model) mesh over the first d·m
    ranks (ROADMAP A11b, now ported): a (1, 1) mesh here, with its axes;
    one process cannot hold the 2 ranks of (1, 2)."""
    net = _pnet(_jnet())
    tr = ParallelTrainer(net, mesh_shape=(1, 1), device="cpu",
                         strategy=ShardingStrategy.TENSOR_PARALLEL)
    assert tr.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        ParallelTrainer(_pnet(_jnet()), mesh_shape=(1, 2), device="cpu")


# ----------------------------------------------------------------------
# SYNC against JAX's 8-device mesh
# ----------------------------------------------------------------------
_SYNC_CASES = {
    # (JAX trainer kwargs, port trainer kwargs, updater, steps)
    "replicated": ({}, {}, "sgd", 5),
    "zero1": ({"strategy": "zero1"}, {"strategy": "zero1"}, "adam", 5),
    "zero2": ({"strategy": "zero2", "zero_bucket_mb": 0.0005},
              {"strategy": "zero2", "zero_bucket_mb": 0.0005}, "adam", 5),
    "fsdp": ({"strategy": "fsdp"}, {"strategy": "fsdp"}, "sgd", 4),
}


def _updater(lib, name):
    return lib.Sgd(0.1) if name == "sgd" else lib.Adam(1e-2)


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("case", sorted(_SYNC_CASES))
def test_sync_matches_jax_eight_device_mesh(world, case, width):
    """The port's world of 2 / 4 against JAX's ParallelTrainer on its
    8-device mesh, the same strategy, start and batches: 1e-5."""
    jkw, pkw, upd, steps = _SYNC_CASES[case]
    x, y = _data(64)
    jnet = _jnet(seed=3, updater=_updater(jx, upd))
    start = np.asarray(jnet.params_flat())
    conf = jnet.conf.to_json()
    ref, ref_score = _jax_trained(case, jnet, 8, [(x, y)] * steps, **jkw)
    outs = world.run(tasks.train, conf, start, [(x, y)] * steps, pkw,
                     width=width)
    for o in outs:        # every rank holds the same replica
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    np.testing.assert_allclose(outs[0]["params"], ref, **F32)
    assert outs[0]["score"] == pytest.approx(ref_score, rel=1e-5)
    assert outs[0]["iters"] == steps


def test_zero2_bf16_wire_matches_jax_bf16_wire(world):
    """ZERO2 with the bf16 wire: each package rounds the stage-2 gradients
    to bfloat16 for the reduction (XLA sums in its own order, gloo adds
    the ranks' bf16 shares in float and rounds), so the two are held at
    the bf16 limits: 2e-2 on the score, 5e-2 relative L2 on the
    parameters."""
    x, y = _data(64)
    jnet = _jnet(seed=3, updater=jx.Adam(1e-2))
    start = np.asarray(jnet.params_flat())
    kw = {"strategy": "zero2", "zero_reduce_dtype": "bfloat16"}
    ref, ref_score = _jax_trained("zero2-bf16", jnet, 8, [(x, y)] * 5, **kw)
    out = world.run(tasks.train, jnet.conf.to_json(), start, [(x, y)] * 5,
                    kw, width=4)[0]
    rel = np.linalg.norm(out["params"] - ref) / np.linalg.norm(ref)
    assert rel < 5e-2
    assert out["score"] == pytest.approx(ref_score, rel=2e-2)
    full, _ = _jax_trained("zero2", _jnet(seed=3, updater=jx.Adam(1e-2)), 8,
                           [(x, y)] * 5, strategy="zero2",
                           zero_bucket_mb=0.0005)
    assert np.linalg.norm(out["params"] - full) / np.linalg.norm(full) < 5e-2


def test_averaging_matches_jax_at_width_four(world):
    """Local SGD with averaging every 2 steps (updaters averaged too): the
    port's world of 4 against JAX's make_mesh({"data": 4}), 1e-5."""
    x, y = _data(64, seed=2)
    jnet = _jnet(seed=13)
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 4},
                                        devices=jax.devices()[:4]),
                    mode="averaging", averaging_frequency=2,
                    average_updaters=True)
    it = jx.ArrayDataSetIterator(x, y, batch_size=32)
    tr.fit(it, epochs=4)
    ref = np.asarray(jnet.params_flat())
    batches = [(x[i:i + 32], y[i:i + 32]) for i in (0, 32)]
    out = world.run(tasks.train, jnet.conf.to_json(), start, batches,
                    {"mode": "averaging", "averaging_frequency": 2,
                     "average_updaters": True},
                    {"epochs": 4})[0]
    assert not np.allclose(out["params"], start)
    np.testing.assert_allclose(out["params"], ref, **F32)
    assert out["iters"] == tr.iteration_count == 8


def test_averaging_single_device_equals_serial():
    """With one rank and averaging frequency 1, averaging == serial fit,
    bit for bit."""
    x, y = _data(32, seed=4)
    jnet = _jnet(seed=17)
    serial, avg = _pnet(jnet), _pnet(jnet)
    tr = ParallelTrainer(avg, mesh=make_mesh({"data": 1}, device="cpu"),
                         mode=TrainingMode.AVERAGING, averaging_frequency=1)
    for _ in range(3):
        serial.fit(pt.DataSet(x, y))
        tr.fit(pt.DataSet(x, y))
    tr._sync_back()
    np.testing.assert_array_equal(avg.params_flat(), serial.params_flat())


@pytest.mark.parametrize("strategy", ["replicated", "zero1", "zero2", "fsdp"])
def test_one_rank_is_bit_equal_to_fit(strategy):
    """A world of one rank (no process group) is the model's own fit, bit
    for bit, in every SYNC strategy, per batch and in windows."""
    x, y = _data(64)
    jnet = _jnet(seed=5, updater=jx.Adam(1e-2))
    single, multi = _pnet(jnet), _pnet(jnet)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=16)
    single.fit(it(), superstep=2)
    ParallelTrainer(multi, mesh=make_mesh(device="cpu"),
                    strategy=strategy).fit(it(), superstep=2)
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    np.testing.assert_array_equal(multi.params_flat(), single.params_flat())
    for a, b in zip(flat_leaves(multi.updater_state),
                    flat_leaves(single.updater_state)):
        assert torch.equal(a, b)


def test_parallel_trainer_learns(world):
    from conftest import make_classification
    xs, ys = make_classification()
    xs, ys = xs.astype(np.float32)[:192], ys.astype(np.float32)[:192]
    conf = (jx.NeuralNetConfiguration.builder().seed(0)
            .updater(jx.Adam(1e-2)).list()
            .layer(jx.DenseLayer(n_out=32, activation="relu"))
            .layer(jx.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(jx.InputType.feed_forward(10)).build())
    batches = [(xs[i:i + 64], ys[i:i + 64]) for i in range(0, 192, 64)]
    out = world.run(tasks.train, conf.to_json(), None, batches, {},
                    {"epochs": 20}, width=2)
    for o in out:
        np.testing.assert_array_equal(o["params"], out[0]["params"])
    net = tasks.build(conf.to_json(), out[0]["params"])
    ev = net.evaluate(pt.ArrayDataSetIterator(xs, ys, batch_size=64))
    assert ev.accuracy() > 0.9


def test_masked_rnn_matches_jax_mesh(world):
    """Padded sequences through a GravesLSTM: each rank's loss weighted by
    its live mask entries, so 2 ranks with different live counts equal
    JAX's 8-device mesh, 1e-5."""
    def conf(lib):
        return (lib.NeuralNetConfiguration.builder().seed(31)
                .updater(lib.Sgd(0.1)).list()
                .layer(lib.GravesLSTM(n_out=8, activation="tanh"))
                .layer(lib.RnnOutputLayer(n_out=3, loss="mcxent"))
                .set_input_type(lib.InputType.recurrent(5, 6)).build())
    r = np.random.default_rng(9)
    x = r.normal(size=(16, 6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (16, 6))]
    mask = np.ones((16, 6), np.float32)
    mask[:, 4:] = 0.0
    mask[:8, 2:] = 0.0           # the ranks' rows differ in live entries
    jnet = jax_init(JaxNet(conf(jx)))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 8}))
    for _ in range(3):
        tr.fit(jx.DataSet(x, y, features_mask=mask, labels_mask=mask))
    tr._sync_back()
    out = world.run(tasks.train, jnet.conf.to_json(), start,
                    [(x, y, mask, mask)] * 3, {}, width=2)[0]
    np.testing.assert_allclose(out["params"],
                               np.asarray(jnet.params_flat()), **F32)


def test_l2_regularized_model_matches_jax_mesh(world):
    """l1/l2 is divided by the global rows once, not by each rank's."""
    def conf(lib):
        return (lib.NeuralNetConfiguration.builder().seed(3)
                .updater(lib.Sgd(0.1)).l2(1e-2).l1(1e-3).list()
                .layer(lib.DenseLayer(n_out=16, activation="tanh"))
                .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
                .set_input_type(lib.InputType.feed_forward(8)).build())
    x, y = _data(64)
    jnet = jax_init(JaxNet(conf(jx)))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 8}))
    for _ in range(3):
        tr.fit(jx.DataSet(x, y))
    tr._sync_back()
    out = world.run(tasks.train, jnet.conf.to_json(), start,
                    [(x, y)] * 3, {}, width=4)[0]
    np.testing.assert_allclose(out["params"],
                               np.asarray(jnet.params_flat()), **F32)
    assert out["score"] == pytest.approx(float(tr.score()), rel=1e-5)


# ----------------------------------------------------------------------
# graphs
# ----------------------------------------------------------------------
def _graph_conf(lib):
    b = (lib.NeuralNetConfiguration.builder().seed(23).updater(lib.Sgd(0.1))
         .graph_builder())
    b.add_inputs("a", "b")
    b.add_layer("ha", lib.DenseLayer(n_out=8, activation="tanh"), "a")
    b.add_layer("hb", lib.DenseLayer(n_out=8, activation="tanh"), "b")
    b.add_vertex("m", lib.nn.conf.graph.MergeVertex(), "ha", "hb")
    b.add_layer("out", lib.OutputLayer(n_out=3, loss="mcxent"), "m")
    b.set_outputs("out")
    b.set_input_types(lib.InputType.feed_forward(5),
                      lib.InputType.feed_forward(7))
    return b.build()


def _graph_batches():
    r = np.random.default_rng(4)
    xa = r.normal(size=(32, 5)).astype(np.float32)
    xb = r.normal(size=(32, 7)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 32)]
    return xa, xb, y


def test_graph_multidataset_matches_jax_mesh(world):
    """A two-input graph (MergeVertex) trained on MultiDataSet batches:
    the port's 2 ranks against JAX's 8-device mesh, 1e-5."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    xa, xb, y = _graph_batches()
    jg = jax_init(JaxGraph(_graph_conf(jx)))
    start = np.asarray(jg.params_flat())
    tr = JaxTrainer(jg, mesh=jax_mesh({"data": 8}))
    mds = jx.datasets.iterators.MultiDataSet(features=[xa, xb], labels=[y])
    for _ in range(3):
        tr.fit(mds)
    tr._sync_back()
    batch = {"features": [xa, xb], "labels": [y]}
    out = world.run(tasks.train, jg.conf.to_json(), start, [batch] * 3,
                    {"graph": True}, width=2)[0]
    np.testing.assert_allclose(out["params"], np.asarray(jg.params_flat()),
                               **F32)


def test_graph_averaging_mode(world):
    xa, xb, y = _graph_batches()
    conf = _graph_conf(jx).to_json()
    batch = {"features": [xa, xb], "labels": [y]}
    out = world.run(tasks.train, conf, None, [batch] * 4,
                    {"graph": True, "mode": "averaging",
                     "averaging_frequency": 2}, width=4)
    assert np.isfinite(out[0]["score"])
    for o in out:
        np.testing.assert_array_equal(o["params"], out[0]["params"])


# ----------------------------------------------------------------------
# sharded checkpoints (in process)
# ----------------------------------------------------------------------
def test_sharded_checkpoint_roundtrip(tmp_path):
    x, y = _data(32)
    jnet = _jnet(seed=23)
    model = _pnet(jnet)
    model.fit(pt.DataSet(x, y))
    out_before = model.output(x[:4])
    save_sharded(str(tmp_path / "ckpt"), model)
    model2 = _pnet(_jnet(seed=99))
    restore_sharded(str(tmp_path / "ckpt"), model2)
    torch.testing.assert_close(model2.output(x[:4]), out_before, rtol=0,
                               atol=0)
    assert model2.iteration_count == model.iteration_count
    model.fit(pt.DataSet(x, y))
    model2.fit(pt.DataSet(x, y))
    np.testing.assert_array_equal(model2.params_flat(), model.params_flat())


def test_sharded_checkpoint_manager(tmp_path):
    model = _pnet(_jnet(seed=29))
    mgr = ShardedCheckpoint(str(tmp_path / "ckpts"), keep=2)
    x, y = _data(16)
    for step in range(3):
        model.fit(pt.DataSet(x, y))
        mgr.save(model, step, score=float(3 - step))
    assert mgr.latest_step() == 2 and mgr.steps() == [1, 2]
    model2 = _pnet(_jnet(seed=1))
    assert mgr.restore_latest(model2) == 2
    np.testing.assert_array_equal(model2.params_flat(), model.params_flat())


def test_shard_model_places_and_specs():
    net = _pnet(_jnet())
    mesh = make_mesh(device="cpu")
    p_specs, s_spec, o_specs = shard_model(net, mesh,
                                           ShardingStrategy.FSDP)
    # a world of one: every divisible axis "shards" over data of size 1
    assert p_specs[0]["W"] == ("data", None) or p_specs[0]["W"] == (
        None, "data")
    assert tuple(s_spec) == ()
    assert ParallelWrapper is ParallelTrainer
    assert MeshAxes.DATA == "data"


def test_shard_files_train_as_the_global_batches(world, tmp_path):
    """The export plane across ranks: each of 2 ranks trains from its own
    shard files (LocalShardDataSet), bit-equal to the ranks slicing the
    same global batches in memory."""
    from deeplearning4j_tpu_torch.datasets import export_sharded
    x, y = _data(64, seed=5)
    jnet = _jnet(seed=9, updater=jx.Adam(1e-2))
    conf, start = jnet.conf.to_json(), np.asarray(jnet.params_flat())
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    paths = export_sharded([pt.DataSet(*b) for b in batches], tmp_path,
                           n_shards=2)
    got = world.run(tasks.export_plane, conf, start,
                    [p for ps in paths for p in ps], width=2)
    mem = world.run(tasks.train, conf, start, batches, {}, {"epochs": 1},
                    width=2)
    for g in got:
        np.testing.assert_array_equal(g, mem[0]["params"])


def test_graph_resnet_one_rank_matches_jax_mesh():
    """The tiny ResNet graph (ElementWiseVertex residuals, BatchNormalization
    in float32) by the trainer on one rank against JAX's trainer on its
    8-device mesh, 3 SGD steps: at one rank the BN batch statistics are
    the global batch's, as in JAX (across ranks they are each rank's:
    ROADMAP C). Float32 convolutions in two libraries: 1e-4 relative,
    1e-5 absolute."""
    from deeplearning4j_tpu.models.zoo import resnet50 as jax_resnet
    jg = jax_init(jax_resnet(n_classes=4, image=16, seed=13, blocks=(1, 1),
                             width=8, compute_dtype=None,
                             updater=jx.Sgd(0.05)))
    start = np.asarray(jg.params_flat())
    r = np.random.default_rng(0)
    x = r.normal(size=(32, 16, 16, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 32)]
    net = tasks.build(jg.conf.to_json(), start, graph=True)
    tr = ParallelTrainer(net, mesh=make_mesh(device="cpu"))
    jt = JaxTrainer(jg, mesh=jax_mesh({"data": 8}))
    for _ in range(3):
        jt.fit(jx.DataSet(x, y))
        tr.fit(pt.DataSet(x, y))
    jt._sync_back()
    np.testing.assert_allclose(net.params_flat(),
                               np.asarray(jg.params_flat()), rtol=1e-4,
                               atol=1e-5)


def _bn_conf(lib):
    return (lib.NeuralNetConfiguration.builder().seed(11)
            .updater(lib.Sgd(0.1)).list()
            .layer(lib.DenseLayer(n_out=16, activation="identity"))
            .layer(lib.BatchNormalization(activation="relu"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def test_batchnorm_over_two_ranks_against_jax_mesh(world):
    """A float32 BatchNormalization MLP over two ranks. SYNC training
    takes the global batch's statistics in every strategy (the split path,
    `kernels/bn_split.py`), as JAX's GSPMD step: one step each equals
    JAX's 8-device mesh at 1e-5, and the ZeRO step builders take it too;
    inference-mode scoring and evaluation equal JAX's at 1e-5. AVERAGING,
    whose replicas each normalise by their own rows in JAX too, is held
    to JAX's make_mesh({"data": 2}) at 1e-5 after 4 steps averaged every
    2."""
    x, y = _data(64, seed=6)
    jnet = jax_init(JaxNet(_bn_conf(jx)))
    start = np.asarray(jnet.params_flat())
    conf = jnet.conf.to_json()
    got = world.run(tasks.batchnorm_sync, conf, start, (x, y), width=2)
    for strategy in ("replicated", "zero1", "zero2", "fsdp"):
        kw = {} if strategy == "replicated" else {"strategy": strategy}
        ref, ref_score = _jax_trained(("bn-sync", strategy), jax_init(
            JaxNet(_bn_conf(jx))), 8, [(x, y)], **kw)
        for g in got:
            np.testing.assert_allclose(g["params"][strategy], ref, **F32,
                                       err_msg=strategy)
            assert g["scores"][strategy] == pytest.approx(ref_score,
                                                          rel=1e-5)
    for g in got:
        assert set(g["builders"]) == {"make_zero_step",
                                      "make_zero_accum_superstep"}
        assert all(np.isfinite(v) for v in g["builders"].values())
    jt = JaxTrainer(jnet, mesh=jax_mesh({"data": 8}))
    ref_score = float(jt.score(jx.DataSet(x, y)))
    assert got[0]["score"] == pytest.approx(ref_score, rel=1e-5)
    assert got[0]["accuracy"] == pytest.approx(
        jt.evaluate(jx.ArrayDataSetIterator(x, y, batch_size=64)).accuracy())
    batches = [(x[i:i + 32], y[i:i + 32]) for i in (0, 32)] * 2
    kw = {"mode": "averaging", "averaging_frequency": 2,
          "average_updaters": True}
    ref, ref_score = _jax_trained("bn-averaging", jax_init(
        JaxNet(_bn_conf(jx))), 2, batches, **kw)
    out = world.run(tasks.train, conf, start, batches, kw, width=2)
    assert not np.allclose(out[0]["params"], start)
    np.testing.assert_allclose(out[0]["params"], ref, **F32)
    assert out[0]["score"] == pytest.approx(ref_score, rel=1e-5)


def test_world_ranks_stay_on_the_worker_core(world):
    """Under pytest-xdist the world's rank processes run on their test
    worker's one core at the port tests' lower priority (they fork from a
    forkserver started inside `torch_threads.pinned()`), so a module's
    ranks never take the cores the JAX package's timed tests use."""
    import torch_threads
    got = world.run(tasks.placement)
    core = torch_threads._worker_core()
    if core is None:                  # not a parallel run: nothing pinned
        assert all(len(c) >= 1 for c, _ in got)
        return
    for cores, nice in got:
        assert cores == sorted(core)
        if torch_threads._RENICE:
            assert nice == torch_threads._BASE_NICE + torch_threads.PORT_NICE
