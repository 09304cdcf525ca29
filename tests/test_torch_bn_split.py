"""PyTorch port, global-batch BatchNorm + ReLU: the plain versions of the
four split kernels (`kernels/bn_split.py`) against JAX's BN+ReLU kernels in
interpret mode, on the CPU.

A batch split in row blocks (the data ranks' rows) goes through the split
path's halves: each block's (count, mean, M2) merged by Chan's formula in
block order, then the apply with the merged statistics; each block's
(sum dyr, sum dyr * xhat) summed, then dx from the global sums. The result
must be JAX's `fused_bn_relu` (`_fwd_call` / `_bwd_call`, interpret=True)
on the whole batch: float32 statistics and sums of up to 96 terms in
another order (1e-5 of the largest magnitude, as the fused plain versions
are held in `test_torch_bn_relu.py`), y and dx in bf16 within one bf16
ulp. Then the split path between the ranks of a gloo world, and a bf16
BN-MLP trained under SYNC over 2 ranks against JAX's 8-device mesh at the
bf16 limits (2e-2 score, 5e-2 relative L2 of the parameters).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.kernels import bn_relu as jax_bn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu_torch.kernels import bn_split as split
from jax_reference import jax_init
from test_torch_bn_relu import _close_bf16, _data, _jax, _np, _torch
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_mp_tasks as mp
import torch_parallel_tasks as tasks
from torch_world import World

TOL = 1e-5


def _blocks(n, parts):
    return np.array_split(np.arange(n), parts)


def _split_forward(x, g, b, parts):
    """The split forward over `parts` row blocks: merged stats, y."""
    triples = [split.split_stats_reference(x[i]) for i in _blocks(
        x.shape[0], parts)]
    n, mean, var = split.chan_merge(triples)
    return split.split_apply_reference(x, g, b, mean, var), mean, var, n


def _close(got, want, what):
    scale = np.abs(_np(want)).max()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=TOL * max(scale, 1e-30), err_msg=what)


@pytest.mark.parametrize("C", [10, 48, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parts", [2, 4])
def test_split_forward_matches_jax_kernel(C, dtype, parts):
    x, g, b, _ = _data(96, C, seed=C + parts)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jm, jv = jax_bn.fused_bn_relu(_jax(x, jdt), _jax(g), _jax(b),
                                      interpret=True)
    y, m, v, n = _split_forward(_torch(x, tdt), _torch(g), _torch(b), parts)
    assert float(n[0]) == 96.0
    _close(m, jm, "mean")
    _close(v, jv, "var")
    if dtype == "float32":
        _close(y, jy, "y")
    else:
        _close_bf16(y, jy, "y")


@pytest.mark.parametrize("C", [10, 48, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_backward_matches_jax_kernel(C, dtype):
    x, g, b, dy = _data(96, C, seed=30 + C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, jm, jv = jax_bn._fwd_call(_jax(x, jdt), _jax(g), _jax(b), 1e-5, True)
    jdx, jdg, jdb = jax_bn._bwd_call(_jax(x, jdt), _jax(g), _jax(b), jm, jv,
                                     _jax(dy, jdt), 1e-5, True)
    xt, dyt = _torch(x, tdt), _torch(dy, tdt)
    m, v = _torch(jm), _torch(jv)
    blocks = _blocks(96, 3)
    sums = sum(split.split_bwd_sums_reference(xt[i], _torch(g), _torch(b),
                                              m, v, dyt[i]) for i in blocks)
    _close(sums[0], jdb, "db")
    _close(sums[1], jdg, "dg")
    dx = torch.cat([split.split_bwd_dx_reference(
        xt[i], _torch(g), _torch(b), m, v, dyt[i], sums, 96.0)
        for i in blocks])
    if dtype == "float32":
        _close(dx, jdx, "dx")
    else:
        _close_bf16(dx, jdx, "dx")


def test_chan_merge_keeps_large_mean_channels():
    """Channels with mean 1e3 and unit spread: the merged variance keeps
    the two-pass precision of JAX's kernel (both within 1e-4 of the
    float64 variance: x - mean of a value near 1e3 carries float32's 6e-5
    spacing), where a one-pass E[x^2] - E[x]^2 over the same blocks loses
    it."""
    x, g, b, _ = _data(128, 48, seed=3, shift=1e3)
    _, _, jv = jax_bn.fused_bn_relu(_jax(x), _jax(g), _jax(b),
                                    interpret=True)
    _, _, v, _ = _split_forward(_torch(x), _torch(g), _torch(b), 4)
    want = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(_np(v), want, rtol=1e-4)
    np.testing.assert_allclose(_np(jv), want, rtol=1e-4)
    xt = _torch(x)
    one_pass = (xt * xt).mean(0) - xt.mean(0) ** 2
    assert np.abs(one_pass.numpy() - want).max() > \
        100 * np.abs(_np(v) - want).max()


def test_split_takes_nhwc_and_identity():
    """The plain split path on channels-last input (statistics over every
    axis but the last) and without the ReLU, against JAX's kernel and the
    plain expression."""
    r = np.random.default_rng(1)
    x = r.normal(size=(4, 6, 6, 24)).astype(np.float32)
    _, g, b, _ = _data(1, 24, seed=2)
    jy, jm, jv = jax_bn.fused_bn_relu(_jax(x), _jax(g), _jax(b),
                                      interpret=True)
    flat = _torch(x).reshape(-1, 24)
    y, m, v, _ = _split_forward(flat, _torch(g), _torch(b), 3)
    _close(y.reshape(4, 6, 6, 24), jy, "y")
    _close(m, jm, "mean")
    lin = split.split_apply_reference(flat, _torch(g), _torch(b), m, v,
                                      relu=False)
    want = (flat - m) / torch.sqrt(v + 1e-5) * _torch(g) + _torch(b)
    torch.testing.assert_close(lin, want, rtol=0, atol=1e-5)


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    x, g, b, dy = (_torch(a) for a in _data(16, 8, seed=4))
    split.reset_launches()
    st = split.split_stats(x)
    n, m, v = split.chan_merge([st])
    y = split.split_apply(x, g, b, m, v)
    s = split.split_bwd_sums(x, g, b, m, v, dy)
    dx = split.split_bwd_dx(x, g, b, m, v, dy, s, 16.0)
    assert y.shape == dx.shape == x.shape and s.shape == (2, 8)
    assert set(split.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match=r"\[N, C\]"):
        split.split_stats(x.reshape(-1))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("local_n", [512, 1024, 2048, 4096])
def test_global_bn_tier_follows_the_global_batch(ranks, local_n):
    """A rank's [N, 128] bf16 rows of a batch spread over `ranks` ranks
    take the tier JAX's layer gives the global [N * ranks, 128] batch
    (its kernel's VMEM budget counts the global rows); the split path
    refuses its kernels without a ReLU."""
    from deeplearning4j_tpu.nn.layers.normalization import \
        BatchNormalization as JaxBN
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization
    x = torch.zeros((local_n, 128), dtype=torch.bfloat16)
    jx_ = jnp.zeros((local_n * ranks, 128), jnp.bfloat16)
    port = BatchNormalization(activation="relu")
    assert port._helper(x, True, ranks) == \
        JaxBN(activation="relu")._helper(jx_, True)
    with pytest.raises(ValueError, match="ReLU"):
        split.split_bn_relu(x, torch.ones(128), torch.zeros(128), 1e-5,
                            None, relu=False, kernel=True)


# ----------------------------------------------------------------------
# between ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("bnworld"), widths=(1, 2))
    yield w
    w.close()


@pytest.mark.parametrize("width", [2, 4])
def test_split_path_between_ranks_matches_jax_kernel(world, width):
    """Each rank's rows through `split_bn_relu` over a data group of 2 / 4
    gloo ranks: the global statistics, each rank's y and dx rows, and the
    ranks' dgamma / dbeta partials summed, against JAX's kernel on the
    whole batch (f32, 1e-5)."""
    x, g, b, dy = _data(96, 40, seed=50 + width)
    outs = world.run(mp.split_bn, x, g, b, dy, width, width=width,
                     every=True, timeout=120)
    jy, jm, jv = jax_bn.fused_bn_relu(_jax(x), _jax(g), _jax(b),
                                      interpret=True)
    jdx, jdg, jdb = jax_bn._bwd_call(_jax(x), _jax(g), _jax(b), jm, jv,
                                     _jax(dy), 1e-5, True)
    for o in outs:
        np.testing.assert_array_equal(o["mean"], outs[0]["mean"])
        np.testing.assert_array_equal(o["var"], outs[0]["var"])
    _close(torch.tensor(outs[0]["mean"]), jm, "mean")
    _close(torch.tensor(outs[0]["var"]), jv, "var")
    _close(torch.tensor(np.concatenate([o["y"] for o in outs])), jy, "y")
    _close(torch.tensor(np.concatenate([o["dx"] for o in outs])), jdx, "dx")
    _close(torch.tensor(sum(o["dg"] for o in outs)), jdg, "dg")
    _close(torch.tensor(sum(o["db"] for o in outs)), jdb, "db")


def _bn_mlp(lib, seed=11):
    return (lib.NeuralNetConfiguration.builder().seed(seed)
            .updater(lib.Adam(1e-3)).compute_dtype("bfloat16").list()
            .layer(lib.DenseLayer(n_out=32, activation="identity"))
            .layer(lib.BatchNormalization(activation="relu"))
            .layer(lib.DenseLayer(n_out=32, activation="identity"))
            .layer(lib.BatchNormalization(activation="relu"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(16)).build())


def test_bf16_bn_mlp_sync_over_two_ranks_matches_jax_mesh(world):
    """The bf16 BN-MLP (the layer's kernel tier: the split kernels' plain
    versions on the CPU) trained 3 steps under SYNC over 2 ranks against
    JAX's 8-device mesh (the Pallas kernel's global statistics): score
    2e-2, parameters 5e-2 relative L2 (the bf16 limits)."""
    r = np.random.default_rng(8)
    batches = [(r.normal(size=(64, 16)).astype(np.float32),
                np.eye(4, dtype=np.float32)[r.integers(0, 4, 64)])
               for _ in range(3)]
    jnet = jax_init(JaxNet(_bn_mlp(jx)))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 8}))
    for x, y in batches:
        tr.fit(jx.DataSet(x, y))
    tr._sync_back()
    ref = np.asarray(jnet.params_flat())
    outs = world.run(tasks.train, jnet.conf.to_json(), start, batches, {},
                     width=2)
    got = outs[0]["params"]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 5e-2
    assert outs[0]["score"] == pytest.approx(float(tr.score()), abs=2e-2)


@pytest.mark.parametrize("width", [2, 4])
def test_f32_bn_sync_running_statistics_match_jax_mesh(world, width):
    """A float32 BN-MLP (the layer's plain tier: the split path's plain
    versions) 3 SGD steps under SYNC over 2 / 4 ranks against JAX's
    8-device mesh: parameters 1e-4 (a trajectory) and the running mean and
    variance 1e-5 (the global batch's; the variance biased, as JAX's
    layer keeps it)."""
    conf = (jx.NeuralNetConfiguration.builder().seed(12)
            .updater(jx.Sgd(0.1)).list()
            .layer(jx.DenseLayer(n_out=16, activation="identity"))
            .layer(jx.BatchNormalization(activation="relu"))
            .layer(jx.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(jx.InputType.feed_forward(8)).build())
    r = np.random.default_rng(width)
    batches = [((r.normal(size=(32, 8)) * 2 + 1).astype(np.float32),
                np.eye(4, dtype=np.float32)[r.integers(0, 4, 32)])
               for _ in range(3)]
    jnet = jax_init(JaxNet(conf))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 8}))
    for x, y in batches:
        tr.fit(jx.DataSet(x, y))
    tr._sync_back()
    import jax
    want_state = np.concatenate([np.asarray(a).reshape(-1) for a in
                                 jax.tree_util.tree_leaves(jnet.state)])
    outs = world.run(mp.train_mesh, jnet.conf.to_json(), start, batches,
                     {"data": width}, {}, width=width, every=True,
                     timeout=120)
    np.testing.assert_allclose(outs[0]["params"],
                               np.asarray(jnet.params_flat()), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(outs[0]["state"], want_state, rtol=1e-5,
                               atol=1e-6)
