"""PyTorch port, tensor parallelism beyond the transformer: the twins of
`tests/test_parallel.py`'s TP cases (dense, conv with BatchNormalization,
LSTM), `test_moe.py`'s expert parallelism, `test_bilstm_subsystems.py`'s
BiLSTM under TP and the TP cases of `test_distributed_eval.py` and
`test_zero.py`.

Layers with no Megatron role keep their model-axis shard between steps,
all-gather it before the forward and cut the gradient back to it
(`parallel/tp.py`): the same function as JAX's GSPMD step, so the port's
(data 2, model 2) world of gloo ranks is held to JAX's TENSOR_PARALLEL /
ZERO1_TP on its (2, 4) virtual mesh at 1e-4 for a trajectory of SGD steps,
1e-5 for scores and evaluation; the PartitionSpecs equal JAX's on the same
mesh shape. The conv model's BatchNormalization normalises by the global
batch over the data axis (`kernels/bn_split.py`), as JAX's does.
"""
import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jx
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.parallel import ParallelTrainer as JaxTrainer
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel import param_specs as jax_specs
from deeplearning4j_tpu_torch.parallel import param_specs
from deeplearning4j_tpu_torch.parallel.mesh import Mesh
from jax_reference import jax_init
from test_torch_model_parallel import _run
from torch_threads import one_torch_thread, pinned  # noqa: F401
import torch_mp_tasks as mp
import torch_parallel_tasks as tasks
from torch_world import World

TRAJ = dict(rtol=1e-4, atol=1e-5)


def _layers(lib):
    import importlib
    return importlib.import_module(lib.__name__ + ".nn.layers")


def _mlp(lib):
    return (lib.NeuralNetConfiguration.builder().seed(5)
            .updater(lib.Sgd(0.1)).list()
            .layer(lib.DenseLayer(n_out=16, activation="tanh"))
            .layer(lib.DenseLayer(n_out=16, activation="tanh"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _cnn_bn(lib):
    L = _layers(lib)
    return (lib.NeuralNetConfiguration.builder().seed(21)
            .updater(lib.Sgd(0.05)).list()
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                      stride=(1, 1), activation="relu",
                                      convolution_mode="same"))
            .layer(L.BatchNormalization())
            .layer(L.SubsamplingLayer(pooling_type="max",
                                      kernel_size=(2, 2), stride=(2, 2)))
            .layer(lib.DenseLayer(n_out=16, activation="relu"))
            .layer(lib.OutputLayer(n_out=4, loss="mcxent"))
            .set_input_type(lib.InputType.convolutional(8, 8, 3)).build())


def _lstm(lib):
    return (lib.NeuralNetConfiguration.builder().seed(2)
            .updater(lib.Sgd(0.1)).list()
            .layer(lib.GravesLSTM(n_out=8, activation="tanh"))
            .layer(lib.RnnOutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(lib.InputType.recurrent(5, 7)).build())


def _bilstm(lib):
    L = _layers(lib)
    return (lib.NeuralNetConfiguration.builder().seed(0)
            .updater(lib.Sgd(0.1)).list()
            .layer(L.GravesBidirectionalLSTM(n_out=6, activation="tanh"))
            .layer(lib.RnnOutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(lib.InputType.recurrent(5, 7)).build())


def _moe(lib):
    L = _layers(lib)
    return (lib.NeuralNetConfiguration.builder().seed(3)
            .updater(lib.Sgd(0.05)).list()
            .layer(L.MixtureOfExpertsLayer(n_out=16, n_experts=4, top_k=2,
                                           expert_hidden=32,
                                           activation="relu",
                                           load_balance_coef=0.0))
            .layer(lib.OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(lib.InputType.feed_forward(8)).build())


def _data(kind, n=64, seed=0):
    r = np.random.default_rng(seed)
    if kind == "cnn_bn":
        x = r.normal(size=(n, 8, 8, 3))
        y = np.eye(4)[r.integers(0, 4, n)]
    elif kind in ("lstm", "bilstm"):
        x = r.normal(size=(n // 4, 7, 5))
        y = np.eye(3)[r.integers(0, 3, (n // 4, 7))]
    else:
        x = r.normal(size=(n, 8))
        y = np.eye(4)[r.integers(0, 4, n)]
    return x.astype(np.float32), y.astype(np.float32)


_MODELS = {"mlp": _mlp, "cnn_bn": _cnn_bn, "lstm": _lstm,
           "bilstm": _bilstm, "moe": _moe}
_JAX = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pinned():
        w = World(4, tmp_path_factory.mktemp("tpworld"), widths=(1, 2))
    yield w
    w.close()


def _jax_tp(kind, strategy, steps):
    key = (kind, strategy, steps)
    if key not in _JAX:
        jnet = jax_init(JaxNet(_MODELS[kind](jx)))
        start = np.asarray(jnet.params_flat())
        tr = JaxTrainer(jnet, mesh=jax_mesh({"data": 2, "model": 4}),
                        strategy=strategy)
        x, y = _data(kind)
        for _ in range(steps):
            tr.fit(jx.DataSet(x, y))
        tr._sync_back()
        _JAX[key] = (start, np.asarray(jnet.params_flat()),
                     float(tr.score()), jnet.conf.to_json())
    return _JAX[key]


@pytest.mark.parametrize("kind", sorted(_MODELS))
def test_tp_model_matches_jax_mesh(world, kind):
    """TENSOR_PARALLEL on the port's (2, 2) world against JAX's (2, 4)
    mesh: 3 SGD steps, 1e-4; the last score 1e-5."""
    start, ref, ref_score, cj = _jax_tp(kind, "tensor_parallel", 3)
    x, y = _data(kind)
    outs = _run(world, mp.train_mesh, cj, start, [(x, y)] * 3,
                {"data": 2, "model": 2}, {"strategy": "tensor_parallel"})
    for o in outs:
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    np.testing.assert_allclose(outs[0]["params"], ref, **TRAJ)
    assert outs[0]["score"] == pytest.approx(ref_score, rel=1e-5)


@pytest.mark.parametrize("kind", sorted(_MODELS))
def test_tp_specs_equal_jax(kind):
    """param_specs under TENSOR_PARALLEL on a (2, 2) mesh equal JAX's:
    MoE experts on axis 0, the rest on their last axis where 2 divides
    it."""
    jnet = jax_init(JaxNet(_MODELS[kind](jx)))
    net = tasks.build(jnet.conf.to_json(), np.asarray(jnet.params_flat()))
    want = jax_specs(jnet.params, "tensor_parallel",
                     jax_mesh({"data": 2, "model": 2},
                              devices=jax.devices()[:4]),
                     layers=jnet.layers)
    mesh = Mesh({"data": 2, "model": 2}, range(4), torch.device("cpu"))
    got = param_specs(net.params, "tensor_parallel", mesh,
                      layers=net.layers)

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") \
                and type(tree).__name__ != "PartitionSpec":
            return [plain(v) for v in tree]
        return tuple(tree)
    assert plain(got) == plain(want)


def test_zero1_tp_mlp_evaluation_matches_jax(world):
    """ZERO1_TP on the (2, 2) world: 3 SGD steps against JAX's ZERO1_TP
    on (2, 4) at 1e-4, then score and evaluate of a held-out batch over
    the composed mesh against JAX's trainer's at 1e-5."""
    start, ref, ref_score, cj = _jax_tp("mlp", "zero1_tp", 3)
    x, y = _data("mlp")
    ev = _data("mlp", n=32, seed=9)
    outs = _run(world, mp.train_mesh, cj, start, [(x, y)] * 3,
                {"data": 2, "model": 2}, {"strategy": "zero1_tp"},
                evaluate=ev)
    np.testing.assert_allclose(outs[0]["params"], ref, **TRAJ)
    jnet = jax_init(JaxNet(_mlp(jx)))
    jnet.set_params_flat(outs[0]["params"])
    jt = JaxTrainer(jnet, mesh=jax_mesh({"data": 2, "model": 4}),
                    strategy="zero1_tp")
    assert outs[0]["eval_score"] == pytest.approx(
        float(jt.score(jx.DataSet(*ev))), rel=1e-5)
    assert outs[0]["accuracy"] == pytest.approx(jt.evaluate(
        jx.ArrayDataSetIterator(*ev, batch_size=32)).accuracy())
    for o in outs:
        assert o["eval_score"] == outs[0]["eval_score"]
