"""PyTorch port, 2-D and 3-D meshes on the CPU: the twins of
`tests/test_mesh2d.py`, `tests/test_flash_spmd.py`'s probe cases and the
validation and composition cases of `tests/test_pipeline_1f1b.py` (their
IR-probe cases are ROADMAP A13's).

The up-front errors are JAX's messages, checked by calling both packages'
validation on meshes of the same shape. The compositions run on a world of
4 gloo ranks: ZERO1_TP's moments chunk over (model, data) and take 1/(d·m)
of the moment bytes a rank; superstep windows and accumulation regroup
without changing a bit; a ZERO1_TP or PP fit killed in its second sharded
save resumes bit-equal to the uninterrupted run; the evaluation plane
reads the published view.
"""
import logging

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.trainer import \
    _validate_mode_strategy as jax_validate
from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                               ShardingStrategy,
                                               configure_flash_attention,
                                               make_mesh)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from deeplearning4j_tpu_torch.parallel.trainer import _validate_mode_strategy
from test_torch_model_parallel import _lm_batches, _lm_conf, _run
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_parallel_tasks as tasks
from torch_world import World

CPU = torch.device("cpu")


def _mlp(lib=jx):
    return (lib.NeuralNetConfiguration.builder().seed(4)
            .updater(lib.Adam(1e-2)).list()
            .layer(lib.DenseLayer(n_out=16, activation="tanh"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _net(conf=None):
    return tasks.build((conf or _mlp()).to_json())


def _jax_error(mode, strategy, axes):
    names = tuple(axes)
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh(dict(axes), devices=jax.devices()[:n])
    try:
        jax_validate(mode, strategy, mesh)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"JAX accepted {mode} {strategy} on {names}")


@pytest.mark.parametrize("mode,strategy,axes", [
    ("sync", "zero1", {"data": 2, "model": 4}),
    ("sync", "zero2", {"data": 2, "model": 4}),
    ("sync", "fsdp", {"data": 2, "model": 4}),
    ("sync", "pipeline", {"data": 2, "model": 4}),
    ("averaging", "replicated", {"data": 2, "model": 4}),
    ("sync", "tensor_parallel", {"data": 8}),
    ("sync", "zero1_tp", {"data": 8}),
    ("sync", "pp", {"data": 2, "pipe": 4}),
    ("sync", "pp", {"data": 8}),
    ("sync", "zero1", {"data": 2, "model": 1, "pipe": 4}),
])
def test_mesh_validation_is_jaxs(mode, strategy, axes):
    """Every unsupported (mode, strategy, mesh) combination raises JAX's
    ValueError, message for message."""
    want = _jax_error(mode, strategy, axes)
    n = int(np.prod(list(axes.values())))
    with pytest.raises(ValueError) as got:
        _validate_mode_strategy(mode, strategy, Mesh(axes, range(n), CPU))
    assert str(got.value) == want


def test_mesh_shape_knob_validation():
    with pytest.raises(ValueError, match="not both"):
        ParallelTrainer(_net(), mesh=make_mesh(device="cpu"),
                        mesh_shape=(1, 1))
    with pytest.raises(ValueError, match=r"\(data, model\)"):
        ParallelTrainer(_net(), mesh_shape=(1, 1, 1, 1), device="cpu")


def test_transformer_rejects_indivisible_head_count():
    conf = (jx.NeuralNetConfiguration.builder().seed(0)
            .updater(jx.Adam(1e-3)).list()
            .layer(jx.EmbeddingSequenceLayer(n_in=32, n_out=24))
            .layer(jx.TransformerBlock(n_heads=6))
            .layer(jx.RnnOutputLayer(n_out=32, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(jx.InputType.recurrent(1, 8)).build())
    from deeplearning4j_tpu_torch.parallel import param_specs
    net = _net(conf)
    with pytest.raises(ValueError, match="n_heads"):
        param_specs(net.params, "zero1_tp",
                    Mesh({"data": 2, "model": 4}, range(8), CPU),
                    layers=net.layers)


def test_zero1_tp_rejects_stage2_knobs_and_base_specs():
    with pytest.raises(ValueError, match="zero_bucket_mb"):
        ParallelTrainer(_net(), mesh_shape=(1, 1), device="cpu",
                        strategy="zero1_tp", zero_bucket_mb=1.0)
    from deeplearning4j_tpu_torch.parallel import ZeroConfig, make_zero_step
    net = _net()
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="stage 2"):
        make_zero_step(net, mesh, config=ZeroConfig(stage=2),
                       base_specs=({},), model_axis="model")


# ----------------------------------------------------------------------
# the flash probe
# ----------------------------------------------------------------------
def test_probe_spmd_for_tp_strategies_with_log_line(caplog):
    net = _net(_lm_conf())
    mesh = Mesh({"data": 2, "model": 2}, range(4), CPU)
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        mode, reason = configure_flash_attention(net, mesh, "zero1_tp")
    assert mode == "spmd" and "H/m" in reason
    assert any("flash attention" in r.message for r in caplog.records)


def test_probe_other_strategies_take_the_kernel_per_rank():
    """JAX falls back to einsum outside TP (and on the CPU); the port has
    no einsum switch: each rank runs kernel 1 on its rows (the plain
    version on the CPU)."""
    net = _net(_lm_conf())
    mode, reason = configure_flash_attention(
        net, Mesh({"data": 8}, range(8), CPU), "zero1")
    assert mode == "kernel" and "strategy=zero1" in reason
    with pytest.raises(ValueError, match="no einsum switch"):
        configure_flash_attention(net, Mesh({"data": 8}, range(8), CPU),
                                  "zero1", force=False)


def test_probe_force_override_and_no_attention_layers():
    mesh = Mesh({"data": 2, "model": 2}, range(4), CPU)
    mode, reason = configure_flash_attention(_net(_lm_conf()), mesh,
                                             "replicated", force="spmd")
    assert mode == "spmd" and "forced" in reason
    mode, reason = configure_flash_attention(_net(), mesh, "zero1_tp",
                                             force="spmd")
    assert mode is None and "no attention" in reason


# ----------------------------------------------------------------------
# compositions on a world of 4 ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("m2world"), widths=(1, 2))
    yield w
    w.close()


def _layout(ctx, conf_json):
    """ZERO1_TP on (2, 2): this rank's moment elements against the whole
    model's, and the shape of a sharded moment leaf."""
    import torch_mp_tasks as mp
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    mesh = mp.mesh_of(ctx, {"data": 2, "model": 2})
    if mesh is None:
        return None
    net = tasks.build(conf_json)
    full = sum(a.numel() for a in flat_leaves(net.updater_state))
    tr = ParallelTrainer(net, mesh=mesh, strategy="zero1_tp")
    mine = sum(a.numel() for a in flat_leaves(tr._opt))
    return {"full": full, "mine": mine,
            "W": tuple(tr._opt[0]["m"]["W"].shape),
            "info": tr.collective_accounting()["mesh_axes"]}


def test_zero1_tp_moments_take_one_over_dm(world):
    """The moments of ZERO1_TP on (data 2, model 2): W [8, 16] is a
    [8, 8] model shard, chunked over data to 32 elements a rank; the
    leaves the axes divide take 1/4 of the bytes a rank."""
    outs = _run(world, _layout, _mlp().to_json())
    for o in outs:
        assert o["W"] == (32,)
        assert o["info"] == {"data": 2, "model": 2}
        assert o["mine"] * 4 <= o["full"] + 4 * 8
    assert sum(o["mine"] for o in outs) < 2 * outs[0]["full"]


def _windows(ctx, conf_json, batches, axes, strategy, fits):
    import torch_mp_tasks as mp
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    mesh = mp.mesh_of(ctx, axes)
    if mesh is None:
        return None
    out = []
    for kw in fits:
        net = tasks.build(conf_json)
        tr = ParallelTrainer(net, mesh=mesh, strategy=strategy)
        tr.fit(ListDataSetIterator(tasks._datasets(batches)), **kw)
        out.append(net.params_flat())
    return out


@pytest.mark.parametrize("strategy,axes", [
    ("zero1_tp", {"data": 2, "model": 2}),
    ("pp", {"data": 1, "model": 1, "pipe": 2}),
])
def test_superstep_and_accumulation_grouping_bit_exact(world, strategy,
                                                       axes):
    """superstep=2 equals per-batch steps bit for bit, and
    grad_accumulation=2 under superstep 1 and 2 equal each other."""
    conf = _lm_conf().to_json()
    batches = _lm_batches(4, rows=8, seed=3)
    outs = _run(world, _windows, conf, batches, axes, strategy,
                [{}, {"superstep": 2}, {"grad_accumulation": 2},
                 {"grad_accumulation": 2, "superstep": 2}],
                width=int(np.prod(list(axes.values()))))
    per, win, acc, acc_win = outs[0]
    np.testing.assert_array_equal(per, win)
    np.testing.assert_array_equal(acc, acc_win)
    assert not np.array_equal(per, acc)


def _killed_resume(ctx, conf_json, batches, axes, strategy, ckpt):
    import torch_mp_tasks as mp
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import (SimulatedCrash,
                                                crash_at_write)
    mesh = mp.mesh_of(ctx, axes)
    if mesh is None:
        return None
    it = lambda: ListDataSetIterator(tasks._datasets(batches))
    ref = tasks.build(conf_json)
    ParallelTrainer(ref, mesh=mesh, strategy=strategy).fit(it())
    net = tasks.build(conf_json)
    crashed = False
    with crash_at_write("sharded/tree_written", nth=2):
        try:
            ParallelTrainer(net, mesh=mesh, strategy=strategy).fit(
                it(), checkpoint_dir=ckpt, checkpoint_every=2)
        except SimulatedCrash:
            crashed = True
    net2 = tasks.build(conf_json)
    tr = ParallelTrainer(net2, mesh=mesh, strategy=strategy)
    tr.fit(it(), checkpoint_dir=ckpt, checkpoint_every=2, resume=True)
    return {"crashed": crashed, "ref": ref.params_flat(),
            "resumed": net2.params_flat(), "iters": tr.iteration_count}


@pytest.mark.parametrize("strategy,axes", [
    ("zero1_tp", {"data": 2, "model": 2}),
    ("pp", {"data": 1, "model": 1, "pipe": 2}),
])
def test_kill_mid_sharded_save_resume_relands_layouts(world, tmp_path,
                                                      strategy, axes):
    """Killed in its second sharded save (step 4 of 6), resumed from the
    step-2 checkpoint: bit-equal to the uninterrupted run."""
    conf = _lm_conf().to_json()
    batches = _lm_batches(6, rows=8, seed=5)
    outs = _run(world, _killed_resume, conf, batches, axes, strategy,
                str(tmp_path / "ck"),
                width=int(np.prod(list(axes.values()))))
    for o in outs:
        assert o["crashed"] and o["iters"] == 6
        np.testing.assert_array_equal(o["resumed"], o["ref"])


def _masks_refused(ctx, conf_json, batch):
    import torch_mp_tasks as mp
    mesh = mp.mesh_of(ctx, {"data": 1, "model": 1, "pipe": 2})
    if mesh is None:
        return None
    tr = ParallelTrainer(tasks.build(conf_json), mesh=mesh, strategy="pp")
    try:
        tr.fit(tasks.pt.DataSet(*batch))
    except ValueError as e:
        return str(e)
    return None


def test_pp_rejects_features_masks(world):
    conf = _lm_conf().to_json()
    x, y = _lm_batches(1, rows=8)[0]
    fm = np.ones(x.shape[:2], np.float32)
    outs = _run(world, _masks_refused, conf, (x, y, fm, None), width=2)
    assert all("features masks" in o for o in outs)
