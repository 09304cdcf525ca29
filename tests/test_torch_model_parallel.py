"""PyTorch port, the model-parallel half of the parallel stack on the CPU:
the mesh's axis groups, Megatron tensor parallelism (TENSOR_PARALLEL,
ZERO1_TP) with the flash "spmd" mode, global-batch BatchNormalization
under SYNC, and the 1F1B pipeline (PP, ZERO1_TP_PP), each held against
JAX's ParallelTrainer on its 8-device virtual mesh.

The port runs one rank per device; here a world of 4 gloo ranks
(`torch_world`, started once for the module, subgroups of 1 and 2) stands
in for the mesh. A mesh shape of the port and one of JAX compute the same
function (Megatron splits sums, the pipeline splits the layer run), so a
world of 2 or 4 is held to JAX's 8-device mesh at the Parity gate's
tolerances: 1e-5 for one float32 step, scores and evaluation, 1e-4 for
trajectories. The key biases `b_k` of a transformer block have a zero
gradient in exact arithmetic (softmax is shift-invariant) and Adam moves
them by its step on the rounding noise, so they are held to that bound
instead. JAX's TP strategies run `attention_reference` (einsum) on the
CPU; the port's block takes the kernels' plain versions there (it has no
einsum switch, `configure_flash_attention` says "spmd").
"""
import jax
import numpy as np
import pytest

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from jax_reference import jax_init
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_mp_tasks as mp
from torch_world import World

F32 = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)
VOCAB, WIDTH, HEADS, SEQ, LR = 12, 16, 4, 8, 1e-2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("mpworld"), widths=(1, 2))
    yield w
    w.close()


def _lm_conf(blocks=2, updater=None, seed=3):
    b = jx.NeuralNetConfiguration.builder().seed(seed).updater(
        updater or jx.Adam(LR))
    lb = b.list().layer(jx.EmbeddingSequenceLayer(n_in=VOCAB, n_out=WIDTH))
    for _ in range(blocks):
        lb = lb.layer(jx.TransformerBlock(n_heads=HEADS))
    return (lb.layer(jx.RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                       loss="mcxent"))
            .set_input_type(jx.InputType.recurrent(1, SEQ)).build())


def _lm_batches(n_batches=2, rows=8, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        idx = r.integers(0, VOCAB, (rows, SEQ + 1))
        out.append((idx[:, :-1, None].astype(np.float32),
                    np.eye(VOCAB, dtype=np.float32)[idx[:, 1:]]))
    return out


_JAX = {}


def _run(world, fn, *args, width=4, **kw):
    """`fn` on every rank of the world (making a mesh's groups is a call
    of the whole world), the results of the first `width` ranks; 120 s
    at most, so a hang fails fast."""
    return world.run(fn, *args, width=width, every=True, timeout=120, **kw)


def _jax_run(key, conf, batches, mesh_shape, **kw):
    """JAX's ParallelTrainer on its virtual mesh, one fit per batch:
    (start params, final params, per-step scores), cached per key."""
    if key not in _JAX:
        jnet = jax_init(JaxNet(conf))
        start = np.asarray(jnet.params_flat())
        tr = JaxTrainer(jnet, mesh_shape=mesh_shape, **kw)
        scores = []
        for x, y in batches:
            tr.fit(jx.DataSet(x, y))
            scores.append(float(tr.score()))
        tr._sync_back()
        _JAX[key] = (start, np.asarray(jnet.params_flat()), scores,
                     jnet.conf.to_json())
    return _JAX[key]


def _b_k_mask(conf_json, blocks):
    """The flat positions of the blocks' key biases (see the module
    docstring), from a port model's parameter layout."""
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    net = mp.build(conf_json)
    mask, pos = [], 0
    for p in net.params:
        for k in sorted(p):
            n = p[k].numel()
            mask.append(np.full(n, k == "b_k"))
            pos += n
    return np.concatenate(mask)


def _close_but_b_k(got, want, conf_json, blocks, steps, tol, lr=LR):
    kmask = _b_k_mask(conf_json, blocks)
    np.testing.assert_allclose(got[~kmask], want[~kmask], **tol)
    assert np.abs(got[kmask]).max() <= lr * steps + 1e-7


# ----------------------------------------------------------------------
# mesh
# ----------------------------------------------------------------------
def test_mesh_axis_groups(world):
    facts = _run(world, mp.mesh_facts, {"data": 2, "model": 2})
    assert [f["coords"] for f in facts] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert facts[1]["ranks"] == {"data": [1, 3], "model": [0, 1]}
    assert all(f["sizes"] == {"data": 2, "model": 2} for f in facts)
    facts = _run(world, mp.mesh_facts, {"data": 1, "model": 2, "pipe": 2})
    assert facts[3]["coords"] == {"data": 0, "model": 1, "pipe": 1}
    assert facts[3]["ranks"] == {"data": [3], "model": [1, 3],
                                 "pipe": [2, 3]}
    assert facts[3]["sizes"] == {"data": 1, "model": 2, "pipe": 2}


@pytest.mark.parametrize("m", [2, 4])
def test_megatron_f_and_g(world, m):
    """reduce_from_tp sums forward and passes the gradient; copy_to_tp
    passes forward and sums the gradient."""
    outs = _run(world, mp.tp_collectives, m, width=m)
    total = sum(range(1, m + 1))
    for o in outs:
        np.testing.assert_array_equal(o["y"], np.full(3, 2.0 * total))
        np.testing.assert_array_equal(o["dx"], np.full(3, 2.0))
        np.testing.assert_array_equal(o["dz"], np.full(2, float(total)))


# ----------------------------------------------------------------------
# tensor parallelism on the transformer LM
# ----------------------------------------------------------------------
_TP_CASES = {
    # (port mesh axes, strategy)
    "tp_d1m2": ({"data": 1, "model": 2}, "tensor_parallel"),
    "tp_d2m2": ({"data": 2, "model": 2}, "tensor_parallel"),
    "tp_d1m4": ({"data": 1, "model": 4}, "tensor_parallel"),
    "zero1_tp_d2m2": ({"data": 2, "model": 2}, "zero1_tp"),
}


@pytest.mark.parametrize("case", sorted(_TP_CASES))
def test_tp_lm_matches_jax_mesh(world, case):
    """The port's Megatron LM on a (d, m) world against JAX's
    TENSOR_PARALLEL / ZERO1_TP on its (2, 4) mesh: 3 Adam steps, 1e-4
    (a trajectory), every step's score 1e-5; each rank holds 1/m of the
    sharded leaves."""
    axes, strategy = _TP_CASES[case]
    conf = _lm_conf()
    batches = _lm_batches(3)
    start, ref, ref_scores, cj = _jax_run(("lm", strategy), conf, batches,
                                          (2, 4), strategy=strategy)
    width = int(np.prod(list(axes.values())))
    outs = _run(world, mp.train_mesh, cj, start, batches, axes,
                     {"strategy": strategy}, width=width)
    for o in outs:
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    _close_but_b_k(outs[0]["params"], ref, cj, 2, len(batches), TRAJ)
    np.testing.assert_allclose(outs[0]["scores"], ref_scores, rtol=1e-5)
    assert outs[0]["flash"] == "spmd"
    assert outs[0]["local_numel"] < start.size


def test_tp_lm_evaluation_matches_single_rank(world):
    """score and evaluate of a TP-trained LM over the composed (2, 2)
    mesh equal JAX's model's own on the same parameters, 1e-5."""
    conf = _lm_conf()
    batches = _lm_batches(2)
    start, ref, _, cj = _jax_run(("lm", "tensor_parallel"), conf,
                                 _lm_batches(3), (2, 4),
                                 strategy="tensor_parallel")
    ev = _lm_batches(1, rows=8, seed=5)[0]
    outs = _run(world, mp.train_mesh, cj, start, batches,
                     {"data": 2, "model": 2},
                     {"strategy": "tensor_parallel"}, evaluate=ev)
    jnet = JaxNet(jx.MultiLayerConfiguration.from_json(cj)) \
        if hasattr(jx, "MultiLayerConfiguration") else None
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMC
    jnet = JaxNet(JMC.from_json(cj)).init()
    jnet.set_params_flat(outs[0]["params"])
    want = float(jnet.score(jx.DataSet(*ev)))
    assert outs[0]["eval_score"] == pytest.approx(want, rel=1e-5)
    assert all(o["eval_score"] == outs[0]["eval_score"] for o in outs)


@pytest.mark.parametrize("strategy,axes", [
    ("tensor_parallel", {"data": 2, "model": 2}),
    ("zero1_tp_pp", {"data": 1, "model": 2, "pipe": 2}),
])
def test_jax_params_land_as_rank_shards_and_zip_crosses(world, tmp_path,
                                                        strategy, axes):
    """JAX's global parameters and Adam state (numpy, `from_jax_params`)
    give each rank its shard of the strategy's layout: a column-parallel
    W_q's columns and a row-parallel W_o's rows of the rank's heads, on
    the pipe stage's blocks; after a step the gathered view, written as a
    zip, restores in the JAX package bit-equal to the port's published
    parameters."""
    from deeplearning4j_tpu.util.serializer import \
        ModelSerializer as JaxSerializer

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(np_tree(v) for v in t)
        return np.asarray(t)
    jnet = jax_init(JaxNet(_lm_conf()))
    params, opt = np_tree(jnet.params), np_tree(jnet.updater_state)
    zpath = str(tmp_path / "sharded.zip")
    x, y = _lm_batches(1)[0]
    outs = _run(world, mp.jax_params_to_shards, jnet.conf.to_json(), params,
                opt, axes, strategy, (x, y), zpath)
    hd = WIDTH // HEADS
    for o in outs:
        m = o["coords"]["model"]
        stage = o["coords"].get("pipe", 0)
        blocks = 2 // axes.get("pipe", 1)
        first = 1 + stage * blocks       # the rank's first block
        local = 1 if "pipe" in axes else first
        cols = slice(m * WIDTH // 2, (m + 1) * WIDTH // 2)
        np.testing.assert_array_equal(o["shards"][local]["W_q"],
                                      params[first]["W_q"][:, cols])
        np.testing.assert_array_equal(o["shards"][local]["W_o"],
                                      params[first]["W_o"][cols, :])
        assert o["shards"][local]["W_q"].shape == (WIDTH, 2 * hd)
    back = JaxSerializer.restore(zpath)
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  outs[0]["flat"])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_spmd_matches_jax(world, causal):
    """`flash_attention_spmd` on the port's (2, 2) world (each rank's
    [B/2, T, H/2, Dh] block through kernel 1's plain version, gathered)
    against JAX's under shard_map on its (2, 4) mesh (interpret-mode
    Pallas) and against the plain attention: the output 2e-5, the
    gradients of sum(sin(out)) 5e-5 (JAX's test's limits)."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.kernels.attention import \
        flash_attention_spmd as jax_spmd
    from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
    r = np.random.default_rng(5 + causal)
    q, k, v = (r.normal(size=(4, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    outs = _run(world, mp.flash_spmd, q, k, v, causal,
                {"data": 2, "model": 2})
    mesh = jax_mesh({"data": 2, "model": 4})
    want = np.asarray(jax_spmd(*(jnp.asarray(a) for a in (q, k, v)),
                               causal, mesh=mesh, interpret=True))
    for o in outs:
        np.testing.assert_allclose(o["out"], want, rtol=2e-5, atol=2e-5)
    grads = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(jax_spmd(
        a, b, c, causal, mesh=mesh, interpret=True))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(outs[0][name], np.asarray(g), rtol=5e-5,
                                   atol=5e-5, err_msg=name)
