"""PyTorch port, the pipelines and ring attention on the CPU: the 1F1B
pipeline over the mesh's pipe axis (PP, ZERO1_TP_PP), the host-driven
GPipe of one process (PIPELINE: PipelinedNetworkTrainer,
PipelinedGraphTrainer, pipeline_forward) and ring attention over a
sequence group, each held against JAX's.

A world of 4 gloo ranks (`torch_world`) stands in for JAX's 8-device
virtual mesh: the pipeline splits the layer run, not the arithmetic, so a
world of 2 or 4 pipe ranks is held to JAX's (1, 1, 2) / (1, 1, 4) mesh at
1e-5 for one float32 step and 1e-4 for a trajectory (the blocks' key
biases held to Adam's step instead, see `test_torch_model_parallel.py`).
Dropout-free runs only (the port's dropout draws from torch generators).
The 1F1B trajectories train with SGD, which moves each element by its
gradient, so the trajectory holds the gradients themselves; and with
JAX's own test's Adam(1e-3), whose moments (sharded over (data, model,
pipe) under ZERO1_TP_PP) are held to JAX's at 1e-4 beside the
parameters. Adam divides each element's step by the element's own
gradient magnitude, so at the tests' Adam(1e-2) an element whose
gradient is near zero moved by about its learning rate on float32
rounding of the schedule's sums; at 1e-3 only the key biases need
Adam's reach, as in the TP tests.
The 1F1B schedule of M microbatches (`make_pp_accum_superstep`: a group
of M batches is one schedule) gives the mean of the microbatches' mean
losses, which the trainer's gradient accumulation over M per-batch
flushes also gives: the two are held together at 1e-6, and the trainer's
accumulation to JAX's `fit(grad_accumulation=2)` under PP at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from jax_reference import jax_init
from test_torch_model_parallel import (TRAJ, F32, _close_but_b_k,
                                       _jax_run, _lm_batches, _lm_conf, _run)
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_mp_tasks as mp
import torch_parallel_tasks as tasks
from torch_world import World


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("ppworld"), widths=(1, 2))
    yield w
    w.close()


# ----------------------------------------------------------------------
# 1F1B over the pipe axis
# ----------------------------------------------------------------------
_PP_CASES = {
    # (port mesh axes, strategy, JAX mesh_shape, blocks, trainer kwargs)
    "pp_p2": ({"data": 1, "model": 1, "pipe": 2}, "pp", (1, 1, 2), 2, {}),
    "pp_p4": ({"data": 1, "model": 1, "pipe": 4}, "pp", (1, 1, 4), 4, {}),
    "zero1_tp_pp_d1m2p2": ({"data": 1, "model": 2, "pipe": 2},
                           "zero1_tp_pp", (2, 2, 2), 2, {}),
    "zero1_tp_pp_d2m1p2": ({"data": 2, "model": 1, "pipe": 2},
                           "zero1_tp_pp", (2, 2, 2), 2, {}),
}


@pytest.mark.parametrize("case", sorted(_PP_CASES))
def test_1f1b_lm_matches_jax_mesh(world, case):
    """The LM's 1F1B pipeline on the port's world against JAX's PP /
    ZERO1_TP_PP on its mesh: 3 SGD steps, 1e-4, the scores 1e-5."""
    axes, strategy, jshape, blocks, kw = _PP_CASES[case]
    conf = _lm_conf(blocks=blocks, updater=jx.Sgd(0.1))
    batches = _lm_batches(3)
    start, ref, ref_scores, cj = _jax_run(
        ("pp", strategy, jshape, blocks), conf, batches, jshape,
        strategy=strategy)
    outs = _run(world, mp.train_mesh, cj, start, batches, axes,
                dict(kw, strategy=strategy),
                width=int(np.prod(list(axes.values()))))
    for o in outs:
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    _close_but_b_k(outs[0]["params"], ref, cj, blocks, len(batches), TRAJ)
    np.testing.assert_allclose(outs[0]["scores"], ref_scores, rtol=1e-5)


_JAX_ADAM = {}


@pytest.mark.parametrize("case", sorted(_PP_CASES))
def test_1f1b_lm_adam_matches_jax_mesh(world, case):
    """The LM's 1F1B pipeline with Adam(1e-3) (JAX's 1F1B test's updater)
    against JAX's PP / ZERO1_TP_PP: 3 steps, the parameters at 1e-4 (the
    key biases to Adam's reach), the Adam moments, gathered from their
    stage-1 shards, at 1e-4, the scores 1e-5."""
    from deeplearning4j_tpu_torch import from_jax_params
    axes, strategy, jshape, blocks, kw = _PP_CASES[case]
    lr = 1e-3
    batches = _lm_batches(3)
    if case not in _JAX_ADAM:
        jnet = jax_init(JaxNet(_lm_conf(blocks=blocks, updater=jx.Adam(lr))))
        start = np.asarray(jnet.params_flat())
        tr = JaxTrainer(jnet, mesh_shape=jshape, strategy=strategy)
        scores = []
        for x, y in batches:
            tr.fit(jx.DataSet(x, y))
            scores.append(float(tr.score()))
        tr._sync_back()
        cj = jnet.conf.to_json()
        # JAX's moments in the port's leaf order
        view = mp.build(cj)
        from_jax_params(view, jax.tree_util.tree_map(np.asarray, jnet.params),
                        jax.tree_util.tree_map(np.asarray,
                                               jnet.updater_state))
        _JAX_ADAM[case] = (start, np.asarray(jnet.params_flat()),
                           tasks._opt_flat(view), scores, cj)
    start, ref, ref_opt, ref_scores, cj = _JAX_ADAM[case]
    outs = _run(world, mp.train_mesh, cj, start, batches, axes,
                dict(kw, strategy=strategy),
                width=int(np.prod(list(axes.values()))))
    for o in outs:
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    _close_but_b_k(outs[0]["params"], ref, cj, blocks, len(batches), TRAJ,
                   lr=lr)
    assert outs[0]["opt"].shape == ref_opt.shape
    np.testing.assert_allclose(outs[0]["opt"], ref_opt, **TRAJ)
    np.testing.assert_allclose(outs[0]["scores"], ref_scores, rtol=1e-5)


def test_1f1b_accumulation_matches_jax_and_the_m_microbatch_schedule(
        world):
    """grad_accumulation=2 under PP on 2 pipe ranks against JAX's PP
    accumulation (its microbatches are the pipeline's) at 1e-4 after 2
    optimizer steps; the port's M = 2 1F1B schedule
    (`make_pp_accum_superstep`) against its per-batch accumulation, 1e-6
    (float32 sums in another order)."""
    from deeplearning4j_tpu.datasets.iterators import \
        ListDataSetIterator as JaxList
    conf = _lm_conf(updater=jx.Sgd(0.1))
    batches = _lm_batches(4, seed=6)
    jnet = jax_init(JaxNet(conf))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh_shape=(1, 1, 2), strategy="pp")
    tr.fit(JaxList([jx.DataSet(x, y) for x, y in batches]),
           grad_accumulation=2)
    tr._sync_back()
    ref = np.asarray(jnet.params_flat())
    cj = jnet.conf.to_json()
    outs = _run(world, mp.pp_accumulation, cj, start, batches, width=2)
    _close_but_b_k(outs[0]["trainer"], ref, cj, 2, 2, TRAJ)
    np.testing.assert_allclose(outs[0]["schedule"], outs[0]["trainer"],
                               rtol=1e-6, atol=1e-7)


def test_1f1b_label_mask_and_ragged_rows(world):
    """The label mask goes through the last stage's loss: a masked batch
    (a quarter of the time steps zero-weighted) trained 2 steps equals
    JAX's PP steps at 1e-4 (a trajectory)."""
    conf = _lm_conf(updater=jx.Sgd(0.1))
    r = np.random.default_rng(9)
    batches = []
    for x, y in _lm_batches(2, seed=4):
        lm = (r.random(x.shape[:2]) > 0.25).astype(np.float32)
        batches.append((x, y, None, lm))
    jnet = jax_init(JaxNet(conf))
    start = np.asarray(jnet.params_flat())
    tr = JaxTrainer(jnet, mesh_shape=(1, 1, 2), strategy="pp")
    for x, y, _, lm in batches:
        tr.fit(jx.DataSet(x, y, labels_mask=lm))
    tr._sync_back()
    ref = np.asarray(jnet.params_flat())
    outs = _run(world, mp.train_mesh, jnet.conf.to_json(), start, batches,
                {"data": 1, "model": 1, "pipe": 2}, {"strategy": "pp"},
                width=2)
    _close_but_b_k(outs[0]["params"], ref, jnet.conf.to_json(), 2, 2, TRAJ)


@pytest.mark.parametrize("bad", ["no_pipe_axis", "pp_with_data",
                                 "depth_not_divisible", "graph"])
def test_1f1b_refuses_what_jax_refuses(bad):
    """The PP strategies' up-front errors, JAX's messages: a mesh without
    a pipe axis, 'pp' with a data axis, a block run the pipe size does not
    divide, a ComputationGraph."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer, make_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelinePlan
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    net = mp.build(_lm_conf(blocks=3).to_json())
    cpu = torch.device("cpu")
    if bad == "no_pipe_axis":
        with pytest.raises(ValueError, match="stages the model over a"):
            ParallelTrainer(net, mesh=make_mesh(device="cpu"),
                            strategy="pp")
    elif bad == "pp_with_data":
        mesh = Mesh({"data": 2, "pipe": 2}, range(4), cpu)
        from deeplearning4j_tpu_torch.parallel.trainer import \
            _validate_mode_strategy
        with pytest.raises(ValueError, match="is the pure pipeline"):
            _validate_mode_strategy("sync", "pp", mesh)
    elif bad == "depth_not_divisible":
        mesh = Mesh({"pipe": 2}, range(2), cpu)
        with pytest.raises(ValueError, match="does not divide into 2"):
            PipelinePlan(net, mesh)
    else:
        from test_torch_model_parallel import _lm_conf as _  # noqa: F401
        g = tasks.build(jax_init(_jax_graph()).conf.to_json(), graph=True)
        with pytest.raises(ValueError, match="ComputationGraph models"):
            PipelinePlan(g, Mesh({"pipe": 2}, range(2), cpu))


def _jax_graph():
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    conf = (jx.NeuralNetConfiguration.builder().seed(5)
            .updater(jx.Sgd(0.1)).graph_builder().add_inputs("in")
            .add_layer("d1", jx.DenseLayer(n_out=12, activation="tanh"),
                       "in")
            .add_layer("d2", jx.DenseLayer(n_out=12, activation="tanh"),
                       "d1")
            .add_layer("d3", jx.DenseLayer(n_out=12, activation="tanh"),
                       "d2")
            .add_layer("out", jx.OutputLayer(n_out=4, loss="mcxent"), "d3")
            .set_outputs("out")
            .set_input_types(jx.InputType.feed_forward(8)).build())
    return JaxGraph(conf)


# ----------------------------------------------------------------------
# the host-driven GPipe
# ----------------------------------------------------------------------
def _mlp_conf(lib, layers=4, l2=None, seed=7):
    b = lib.NeuralNetConfiguration.builder().seed(seed).updater(
        lib.Adam(1e-2))
    if l2:
        b = b.l2(l2)
    lb = b.list()
    for _ in range(layers):
        lb = lb.layer(lib.DenseLayer(n_out=16, activation="tanh"))
    return (lb.layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _mlp_data(n=32, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 8)).astype(np.float32),
            np.eye(4, dtype=np.float32)[r.integers(0, 4, n)])


@pytest.mark.parametrize("stages,micro,l2", [(2, 2, None), (4, 4, None),
                                             (2, 4, 1e-3)])
def test_gpipe_network_matches_jax(one_torch_thread, stages, micro, l2):
    """PipelinedNetworkTrainer against JAX's on its pipe mesh: the same
    stage boundaries (JAX's `_balance`), 3 Adam steps of M microbatches,
    1e-4 (l2 included: once a step over the live rows)."""
    from deeplearning4j_tpu.parallel.pipeline import \
        PipelinedNetworkTrainer as JaxPipe
    from deeplearning4j_tpu_torch.parallel import PipelinedNetworkTrainer
    jnet = jax_init(JaxNet(_mlp_conf(jx, l2=l2)))
    start = np.asarray(jnet.params_flat())
    net = tasks.build(jnet.conf.to_json(), start)
    jp = JaxPipe(jnet, jax_mesh({"pipe": stages},
                                devices=jax.devices()[:stages]),
                 n_microbatches=micro)
    pp = PipelinedNetworkTrainer(net, n_stages=stages, n_microbatches=micro)
    assert pp.boundaries == list(jp.boundaries)
    for seed in range(3):
        x, y = _mlp_data(seed=seed)
        jp.fit(jx.DataSet(x, y))
        pp.fit(tasks.pt.DataSet(x, y))
        assert pp.score() == pytest.approx(jp.score(), rel=1e-5)
    jp.sync_back()
    np.testing.assert_allclose(pp.sync_back().params_flat(),
                               np.asarray(jnet.params_flat()), **TRAJ)


def test_pipeline_strategy_trains_like_single_device(world):
    """ParallelTrainer(strategy="pipeline") on a {"pipe": 2} mesh (2
    ranks, as JAX's test on its 2-device pipe mesh: 2 stages, each rank
    running both) equals the model's own full-batch fit (mean losses): 2
    steps, 1e-5; and so does `PipelinedNetworkTrainer` built directly
    with 4 microbatches."""
    from deeplearning4j_tpu_torch.parallel import PipelinedNetworkTrainer
    jnet = jax_init(JaxNet(_mlp_conf(jx)))
    start = np.asarray(jnet.params_flat())
    cj = jnet.conf.to_json()
    batches = [_mlp_data(seed=seed) for seed in range(2)]
    outs = _run(world, mp.train_mesh, cj, start, batches, {"pipe": 2},
                {"strategy": "pipeline"}, width=2)
    a = tasks.build(cj, start)
    b = tasks.build(cj, start)
    pp = PipelinedNetworkTrainer(a, n_stages=2, n_microbatches=4)
    for x, y in batches:
        pp.fit(tasks.pt.DataSet(x, y))
        b.fit(tasks.pt.DataSet(x, y))
    pp.sync_back()
    for o in outs:
        np.testing.assert_allclose(o["params"], b.params_flat(), **F32)
        assert o["iters"] == 2
    np.testing.assert_allclose(a.params_flat(), b.params_flat(), **F32)
    assert pp.iteration_count == 2


def test_gpipe_graph_clean_cuts_and_training(one_torch_thread):
    """PipelinedGraphTrainer: the clean cuts of a chain graph, and 2 steps
    of 2 stages x 2 microbatches equal the graph's own fit, 1e-5."""
    from deeplearning4j_tpu_torch.parallel import PipelinedGraphTrainer
    jg = jax_init(_jax_graph())
    start = np.asarray(jg.params_flat())
    a = tasks.build(jg.conf.to_json(), start, graph=True)
    b = tasks.build(jg.conf.to_json(), start, graph=True)
    pp = PipelinedGraphTrainer(a, n_stages=2, n_microbatches=2)
    assert pp.clean_cuts() == [1, 2, 3]
    for seed in range(2):
        x, y = _mlp_data(seed=seed)
        pp.fit(tasks.pt.DataSet(x, y))
        b.fit(tasks.pt.DataSet(x, y))
    np.testing.assert_allclose(a.params_flat(), b.params_flat(), **F32)


@pytest.mark.parametrize("stages,micro", [(2, 2), (4, 8)])
def test_pipeline_forward_matches_sequential(one_torch_thread, stages,
                                             micro):
    """PipelinedDenseStack's ticked forward against its sequential
    forward and JAX's stack at the same weights, 1e-6."""
    from deeplearning4j_tpu_torch.parallel import PipelinedDenseStack
    st = PipelinedDenseStack(8, stages, seed=1, device="cpu")
    x = torch.tensor(_mlp_data(16)[0])
    got = st.pipelined_forward(x, micro)
    want = st.reference_forward(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    W, b = st.params["W"].numpy(), st.params["b"].numpy()
    h = x.numpy()
    for s in range(stages):
        h = np.asarray(jnp.tanh(jnp.asarray(h) @ W[s] + b[s]))
    np.testing.assert_allclose(got.numpy(), h, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# ring attention
# ----------------------------------------------------------------------
def _qkv(B=2, T=16, F=8, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(B, T, F)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(world, width, causal):
    """Each rank's block of the ring's output against JAX's
    `ring_attention_sharded` on its (seq = width) mesh and against plain
    attention on the whole sequence, 1e-5; the gradients of sum(out)
    w.r.t. q, k, v against autograd of the plain attention, 1e-5."""
    from deeplearning4j_tpu.parallel.ring_attention import \
        ring_attention_sharded as jax_ring
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        local_attention_reference
    q, k, v = _qkv(seed=width + causal)
    outs = _run(world, mp.ring, q, k, v, causal, width, width=width)
    got = np.concatenate([o["out"] for o in outs], axis=1)
    want = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jax_mesh(
                                   {"seq": width},
                                   devices=jax.devices()[:width]),
                               axis="seq", causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ref = local_attention_reference(qt, kt, vt, causal)
    ref.sum().backward()
    np.testing.assert_allclose(got, ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
        g = np.concatenate([o[name] for o in outs], axis=1)
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_blockwise_attention_matches_jax(one_torch_thread):
    """The single-device blockwise form against JAX's (its jnp scan on the
    CPU), causal and not, at a block size that leaves a ragged tail."""
    from deeplearning4j_tpu.parallel.ring_attention import \
        blockwise_attention as jax_blockwise
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        blockwise_attention
    q, k, v = _qkv(T=20, seed=3)
    for causal in (False, True):
        got = blockwise_attention(*(torch.tensor(a) for a in (q, k, v)),
                                  block_size=8, causal=causal)
        want = jax_blockwise(*(jnp.asarray(a) for a in (q, k, v)),
                             block_size=8, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_gpipe_cnn_stack_matches_single_device(one_torch_thread):
    """A conv net (heterogeneous shapes across stages) through the
    GPipe (JAX's case; its stage boundaries by parameter count): 3 Adam
    steps of 2 microbatches equal the model's own full-batch fit, 1e-5,
    and the score falls over 10 more."""
    from deeplearning4j_tpu_torch.parallel import PipelinedNetworkTrainer
    L = pytest.importorskip("deeplearning4j_tpu.nn.layers")
    conf = (jx.NeuralNetConfiguration.builder().seed(0)
            .updater(jx.Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      stride=(1, 1), activation="relu",
                                      convolution_mode="same"))
            .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                      stride=(2, 2)))
            .layer(jx.DenseLayer(n_out=16, activation="relu"))
            .layer(jx.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(jx.InputType.convolutional_flat(8, 8, 1))
            .build())
    jnet = jax_init(JaxNet(conf))
    start = np.asarray(jnet.params_flat())
    a = tasks.build(jnet.conf.to_json(), start)
    b = tasks.build(jnet.conf.to_json(), start)
    pp = PipelinedNetworkTrainer(a, n_stages=2, n_microbatches=2)
    r = np.random.default_rng(3)
    ds = tasks.pt.DataSet(r.normal(size=(16, 64)).astype(np.float32),
                          np.eye(2, dtype=np.float32)[r.integers(0, 2, 16)])
    for _ in range(3):
        pp.fit(ds)
        b.fit(ds)
    np.testing.assert_allclose(a.params_flat(), b.params_flat(), **F32)
    s0 = pp.score()
    for _ in range(10):
        pp.fit(ds)
    assert pp.score() < s0


def test_gpipe_dropout_model_trains_deterministically(one_torch_thread):
    """Dropout models train through the GPipe (training only: the port's
    dropout draws from the network's torch generator, so no comparison
    with JAX): the loss falls, two runs from one seed are bit-equal, and
    dropout is active (the step differs from the dropout-free one)."""
    from deeplearning4j_tpu_torch.parallel import PipelinedNetworkTrainer

    def conf(dropout):
        return (jx.NeuralNetConfiguration.builder().seed(0)
                .updater(jx.Adam(1e-2)).list()
                .layer(jx.DenseLayer(n_out=16, activation="relu",
                                     dropout=dropout))
                .layer(jx.DenseLayer(n_out=16, activation="relu",
                                     dropout=dropout))
                .layer(jx.OutputLayer(n_out=2, loss="mcxent"))
                .set_input_type(jx.InputType.feed_forward(4)).build())
    r = np.random.default_rng(3)
    ds = tasks.pt.DataSet(r.normal(size=(8, 4)).astype(np.float32),
                          np.eye(2, dtype=np.float32)[r.integers(0, 2, 8)])
    runs = []
    for dropout in (0.5, 0.5, None):
        jnet = jax_init(JaxNet(conf(dropout)))
        net = tasks.build(jnet.conf.to_json(), np.asarray(jnet.params_flat()))
        pp = PipelinedNetworkTrainer(net, n_stages=2, n_microbatches=2)
        pp.fit(ds)
        s0 = pp.score()
        for _ in range(30):
            pp.fit(ds)
        runs.append((net.params_flat(), s0, pp.score()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][2] < runs[0][1]
    assert not np.array_equal(runs[0][0], runs[2][0])


def test_gpipe_graph_maximize_and_bf16(one_torch_thread):
    """PipelinedGraphTrainer on the chain graph with minimize=False (the
    update ascends, as the graph's own fit) and in bf16 compute: each
    equal to the graph's own fit, 1e-5 (the bf16 run: the same bf16
    arithmetic on both sides)."""
    from deeplearning4j_tpu_torch.parallel import PipelinedGraphTrainer
    from deeplearning4j_tpu_torch.nn.conf.graph import \
        ComputationGraphConfiguration
    import json
    jg = jax_init(_jax_graph())
    base = json.loads(jg.conf.to_json())
    for change in ({"minimize": False}, {"compute_dtype": "bfloat16"}):
        d = json.loads(json.dumps(base))
        d.setdefault("conf", {}).update(change)
        cj = json.dumps(d)
        try:
            ComputationGraphConfiguration.from_json(cj)
        except Exception:
            pytest.fail(f"graph conf with {change} does not load")
        a = tasks.build(cj, np.asarray(jg.params_flat()), graph=True)
        b = tasks.build(cj, np.asarray(jg.params_flat()), graph=True)
        pp = PipelinedGraphTrainer(a, n_stages=2, n_microbatches=1)
        for seed in range(2):
            x, y = _mlp_data(seed=seed)
            pp.fit(tasks.pt.DataSet(x, y))
            b.fit(tasks.pt.DataSet(x, y))
        np.testing.assert_allclose(a.params_flat(), b.params_flat(), **F32)


def test_1f1b_ragged_tail_group_renormalizes(world):
    """6 batches at grad_accumulation=4 under ZERO1_TP_PP on (1, 2, 2)
    train as [4] + [2]: the tail group is one renormalized optimizer step,
    as the model's own accumulated fit on one process (JAX's case; 2e-5,
    its limit)."""
    conf = _lm_conf(updater=jx.Sgd(0.1))
    batches = _lm_batches(6, rows=8, seed=8)
    jnet = jax_init(JaxNet(conf))
    start = np.asarray(jnet.params_flat())
    cj = jnet.conf.to_json()
    ref = tasks.build(cj, start)
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    ref.fit(ListDataSetIterator(tasks._datasets(batches)),
            grad_accumulation=4)
    outs = _run(world, mp.train_mesh, cj, start, batches,
                {"data": 1, "model": 2, "pipe": 2},
                {"strategy": "zero1_tp_pp"}, fit={"grad_accumulation": 4})
    assert outs[0]["iters"] == ref.iteration_count == 2
    np.testing.assert_allclose(outs[0]["params"], ref.params_flat(),
                               rtol=2e-5, atol=2e-6)
