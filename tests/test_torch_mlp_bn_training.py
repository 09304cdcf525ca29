"""PyTorch port, the batch-normalised MLP trained in bf16 (the fifth slice as
a whole), on the CPU against the JAX package: parameters, updater state and
layer state cross through `from_jax_params` or the zip, and the same numpy
batches feed both sides.

Two networks: a narrow BN-MLP (20 -> Dense 16 -> BN+ReLU -> Dense 16 ->
BN+ReLU -> softmax 3, batch 32) and `mlp_mnist` with a BatchNormalization
after each hidden Dense layer (784 -> 1024 -> 1024 -> 10, Adam 1e-3, the
configuration `chip_smoke.py` trains on the card) built from the JAX JSON,
on the bundled MNIST digits. With `compute_dtype("bfloat16")` the BN layers
take the BN+ReLU kernels' tier ("pallas"; JAX runs its Pallas kernel in
interpret mode, the port its plain versions on the CPU); without it, the
exact float32 path.

  * forward (inference and the training score), first-step gradients
    against `jax.grad` of JAX's `_loss_fn`, one SGD and one Adam step, and
    a 20-step Adam `fit` trajectory on the same iterator;
  * the float64 gradient check through the plain BN path;
  * `mlp_mnist`, `bundled_mnist_subset` and `evaluate` against JAX.

The bias of a Dense layer feeding a BN layer has a zero gradient in exact
arithmetic (the batch mean removes it), so both packages see only rounding
noise there, which Adam turns into updates of up to lr per step with the
noise's sign: those biases are held to Adam's reach, their gradients to
the rounding scale, and a running mean (which carries them) is compared
after taking out the weighted biases each side used.

Tolerances, float32 compute: the parity gate's 1e-5 (single step) and 1e-4
(trajectory). bfloat16 compute: gradients 2e-2 of each tensor's largest
entry and one step's parameters 1e-5 absolute (lr 1e-3 times Adam's
normalised update, which rounding cannot move by more than about 1e-2 of
itself, or an SGD step of lr times such a gradient); the trajectory's
scores 2e-2 absolute and parameters 5e-2 relative L2 per tensor (relative
to the larger of the tensor's norm and that of Adam's reach over the run,
for tensors that start at 0); running statistics (relative L2 per tensor, as
the parameters they follow) 5e-2: the two sides round at other places in
the backward (bf16 products, their accumulation, casts of the
cotangents), and 20 Adam steps at lr 1e-3 compound it (an Adam step moves
a weight by up to a third of its Xavier scale, and where a gradient entry
is within rounding of 0 the two sides step opposite ways). Run as a
script from the repository root (`JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_mlp_bn_training.py`), this file prints the measured
gaps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import \
    bundled_mnist_subset as jax_bundled_mnist_subset
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.models.zoo import mlp_mnist as jax_mlp_mnist
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu_torch import (BatchNormalization, DenseLayer,
                                      InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      bundled_mnist_subset, from_jax_params,
                                      mlp_mnist)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.kernels import bn_relu
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.util.gradient_check import GradientCheckUtil
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL, TRAJ_TOL = 1e-5, 1e-4              # float32 compute
BF16 = {"grad": 2e-2, "step": 1e-5, "score": 2e-2, "param_l2": 5e-2}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _twin(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    return from_jax_params(net, _np_tree(jnet.params),
                           _np_tree(jnet.updater_state),
                           _np_tree(jnet.state))


def _narrow(updater, compute_dtype, seed=3):
    b = JaxNNC.builder().seed(seed).updater(updater)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(JaxDense(n_out=16, activation="identity"))
            .layer(JaxBN(activation="relu"))
            .layer(JaxDense(n_out=16, activation="identity"))
            .layer(JaxBN(activation="relu"))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(20)).build())
    return JaxMultiLayerNetwork(conf).init()


def _bn_mlp_mnist_conf(builder, dense, bn, output, input_type, adam,
                       compute_dtype):
    """`mlp_mnist` (784 -> 1024 -> 1024 -> 10, Adam 1e-3) with each hidden
    Dense(relu) split into Dense(identity) + BatchNormalization(relu)."""
    b = builder().seed(42).updater(adam(1e-3))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(dense(n_out=1024, activation="identity"))
            .layer(bn(activation="relu"))
            .layer(dense(n_out=1024, activation="identity"))
            .layer(bn(activation="relu"))
            .layer(output(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(784)).build())


def _jax_bn_mlp_mnist(compute_dtype):
    return JaxMultiLayerNetwork(_bn_mlp_mnist_conf(
        JaxNNC.builder, JaxDense, JaxBN, JaxOutput, JaxInputType,
        jax_updaters.Adam, compute_dtype)).init()


def _narrow_batch(seed, n=32):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, 20)).astype(np.float32),
            np.eye(3, dtype=np.float32)[r.integers(0, 3, n)])


def _pre_bn_bias(net, i, k):
    """Whether param k of layer i is the bias of a Dense layer feeding a BN
    layer (zero gradient in exact arithmetic)."""
    layers = net.layers
    return (k == "b" and i + 1 < len(layers)
            and type(layers[i + 1]).__name__ == "BatchNormalization")


def _jax_grads(jnet, x, y):
    return jax.grad(lambda p: jnet._loss_fn(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None)[0])(jnet.params)


def _port_grads(net, x, y):
    params = tuple({k: v.detach().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, (state, _) = net._loss_fn(params, net.state, torch.from_numpy(x),
                                     torch.from_numpy(y))
    leaves = [v for p in params for v in p.values()]
    flat = iter(torch.autograd.grad(score, leaves))
    return score, state, [{k: next(flat) for k in p} for p in params]


def _check_grads(net, grads, jgrads, rel_tol):
    """Per tensor, |port - JAX| <= rel_tol x the tensor's largest entry; a
    pre-BN bias (whose exact gradient is 0) to rel_tol x its W's largest
    gradient entry on both sides."""
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        for k in jg:
            got, want = g[k].numpy(), np.asarray(jg[k])
            assert got.dtype == want.dtype == np.float32
            if _pre_bn_bias(net, i, k):
                w_scale = np.abs(np.asarray(jg["W"])).max()
                assert max(np.abs(got).max(), np.abs(want).max()) <= \
                    rel_tol * w_scale, f"layer {i} b"
                continue
            np.testing.assert_allclose(
                got, want, rtol=0, atol=rel_tol * np.abs(want).max(),
                err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("compute", ["bfloat16", None])
def test_forward_and_first_step_gradients_match_jax(compute):
    jnet = _narrow(jax_updaters.Sgd(0.1), compute)
    net = _twin(jnet)
    x, y = _narrow_batch(1)
    tol = STEP_TOL if compute is None else BF16["grad"]
    # inference (running stats) and the training score
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=tol)
    score, state, grads = _port_grads(net, x, y)
    (jscore, (jstate, _)), jgrads = jax.value_and_grad(
        lambda p: jnet._loss_fn(p, jnet.state, jnp.asarray(x),
                                jnp.asarray(y), None), has_aux=True)(
        jnet.params)
    assert score.dtype == torch.float32
    np.testing.assert_allclose(float(score.detach()), float(jscore), rtol=0,
                               atol=STEP_TOL)
    _check_grads(net, grads, jgrads, tol)
    for i in (1, 3):
        for k in ("mean", "var"):
            np.testing.assert_allclose(state[i][k].detach().numpy(),
                                       np.asarray(jstate[i][k]), rtol=0,
                                       atol=STEP_TOL)


def test_bf16_compute_casts_as_jax():
    """Hidden layers compute in bf16 (their parameters cast, BN's gamma and
    beta too), the output layer in float32; the masters, the updater state
    and the layer state stay float32; the narrow net's BN layers take the
    kernels' tier."""
    jnet = _narrow(jax_updaters.Adam(1e-3), "bfloat16")
    net = _twin(jnet)
    assert net._compute_dtype == torch.bfloat16
    x, y = _narrow_batch(2)
    acts = {}
    for i, layer in enumerate(net.layers):
        name = "loss_score" if i == len(net.layers) - 1 else "apply"
        orig = getattr(layer, name)

        def spy(params, state, x_, *args, _i=i, _orig=orig, **kw):
            acts[_i] = (x_.dtype, {k: v.dtype for k, v in params.items()})
            return _orig(params, state, x_, *args, **kw)
        setattr(layer, name, spy)
    net.fit(x, y)
    assert acts[0][0] == torch.bfloat16 and acts[0][1]["W"] == torch.bfloat16
    assert acts[1][1] == {"gamma": torch.bfloat16, "beta": torch.bfloat16}
    assert acts[4][1]["W"] == torch.float32          # the output layer
    for tree in (net.params, net.state):
        assert all(t.dtype == torch.float32 for d in tree for t in d.values())
    assert all(t.dtype == torch.float32 for d in net.updater_state
               for slot in d.values() for t in slot.values())
    xb = torch.zeros(32, 16, dtype=torch.bfloat16)
    assert net.layers[1]._helper(xb, True) == "pallas"


def _check_step(net, jnet, jgrads, tol, adam_lr=None):
    """The parameters after one step, per entry within `tol`. After an Adam
    step (lr * g / (|g| + eps), about lr * sign(g)) an entry whose JAX
    gradient is within the bf16 gradient tolerance of 0 may have the other
    sign on the other side: such entries, and the pre-BN biases, are held
    to Adam's reach from the previous value, 2 lr apart at most."""
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            got, want = p[k].numpy(), np.asarray(jp[k])
            g = np.abs(np.asarray(jgrads[i][k]))
            if adam_lr is not None:
                near0 = (np.ones_like(g, bool) if _pre_bn_bias(net, i, k)
                         else g <= BF16["grad"] * g.max())
                assert np.abs(got - want)[near0].max(initial=0.0) <= \
                    2 * adam_lr + 1e-7, f"layer {i} {k}"
                got, want = got[~near0], want[~near0]
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("compute", ["bfloat16", None])
@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_one_step_matches_jax(updater, compute):
    make = {"sgd": lambda u: u.Sgd(0.1), "adam": lambda u: u.Adam(1e-3)}
    jnet = _narrow(make[updater](jax_updaters), compute)
    net = _twin(jnet)
    x, y = _narrow_batch(3)
    jgrads = _jax_grads(jnet, x, y)
    jnet.fit(x, y)
    net.fit(x, y)
    tol = STEP_TOL if compute is None else BF16["step"]
    if compute is not None and updater == "sgd":
        tol = 0.1 * BF16["grad"]     # lr 0.1 x gradients of scale ~1
    _check_step(net, jnet, jgrads, tol,
                adam_lr=1e-3 if updater == "adam" else None)
    for i in (1, 3):
        for k in ("mean", "var"):
            np.testing.assert_allclose(net.state[i][k].numpy(),
                                       np.asarray(jnet.state[i][k]), rtol=0,
                                       atol=STEP_TOL)


class _Log:
    """Listener: scores, and the pre-BN biases each step used."""

    def __init__(self, net, indices, to_np):
        self.scores, self.to_np, self.net = [], to_np, net
        self.indices = indices
        self.biases = [self._biases()]      # before the first step

    def _biases(self):
        return [self.to_np(self.net.params[i]["b"]) for i in self.indices]

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))
        self.biases.append(self._biases())


def _bias_part_of_running_mean(log, bn_pos, decay):
    """sum_t (1 - d) d^(T-1-t) b_t over the steps t = 0..T-1: the share of a
    running mean (started at 0) that is the pre-BN bias."""
    steps = len(log.scores)
    return sum((1 - decay) * decay ** (steps - 1 - t) * log.biases[t][bn_pos]
               for t in range(steps))


def _trajectory(network, compute):
    """20 Adam steps (lr 1e-3) of the JAX network and its port twin on one
    iterator: the narrow BN-MLP on 128 synthetic rows at batch 32, or the
    BN `mlp_mnist` on the 320 bundled digits at batch 128 with drop_last
    (the run `chip_smoke.py` makes on the card). Returns (net, jnet, log,
    jlog)."""
    if network == "narrow":
        jnet = _narrow(jax_updaters.Adam(1e-3), compute, seed=4)
        r = np.random.default_rng(5)
        x = r.normal(size=(128, 20)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                        + (x[:, 1] > 0.5).astype(int)]
        kw, epochs = dict(batch_size=32, shuffle=True, seed=6), 5
    else:
        jnet = _jax_bn_mlp_mnist(compute)
        x, y, _, _ = bundled_mnist_subset()
        kw = dict(batch_size=128, shuffle=True, seed=13, drop_last=True)
        epochs = 10
    net = _twin(jnet)
    jlog = _Log(jnet, [0, 2], np.asarray)
    log = _Log(net, [0, 2], lambda t: t.numpy().copy())
    jnet.set_listeners(jlog)
    net.set_listeners(log)
    jnet.fit(JaxArrayIterator(x, y, **kw), epochs=epochs)
    net.fit(ArrayDataSetIterator(x, y, **kw), epochs=epochs)
    assert len(log.scores) == len(jlog.scores) == 20
    return net, jnet, log, jlog


def _trajectory_gaps(net, jnet, log, jlog, lr=1e-3):
    """{"score": max abs gap of the step scores, "param": the largest
    per-tensor |a - b|_2 / max(|b|_2, Adam's reach over the run in L2) (the
    reach for tensors that start at 0: beta, biases), "param_abs": the
    largest entry gap, "pre_bn_bias": the largest |b| of a pre-BN bias,
    "state": the largest relative L2 gap of a running mean (less its
    pre-BN bias share) or var, "state_abs": its largest entry gap}."""
    steps = len(log.scores)
    gaps = {"score": float(np.abs(np.subtract(log.scores,
                                              jlog.scores)).max()),
            "param": 0.0, "param_abs": 0.0, "pre_bn_bias": 0.0,
            "state": 0.0, "state_abs": 0.0}
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            got, want = p[k].numpy(), np.asarray(jp[k])
            if _pre_bn_bias(net, i, k):
                gaps["pre_bn_bias"] = max(gaps["pre_bn_bias"],
                                          np.abs(got).max(),
                                          np.abs(want).max())
                continue
            scale = max(np.linalg.norm(want), steps * lr * np.sqrt(want.size))
            gaps["param"] = max(gaps["param"],
                                np.linalg.norm(got - want) / scale)
            gaps["param_abs"] = max(gaps["param_abs"],
                                    np.abs(got - want).max())
    for pos, i in enumerate((1, 3)):
        d = net.layers[i].decay
        pairs = ((net.state[i]["mean"].numpy()
                  - _bias_part_of_running_mean(log, pos, d),
                  np.asarray(jnet.state[i]["mean"])
                  - _bias_part_of_running_mean(jlog, pos, d)),
                 (net.state[i]["var"].numpy(),
                  np.asarray(jnet.state[i]["var"])))
        for got, want in pairs:
            gaps["state"] = max(gaps["state"], np.linalg.norm(got - want)
                                / np.linalg.norm(want))
            gaps["state_abs"] = max(gaps["state_abs"],
                                    np.abs(got - want).max())
    return {k: float(v) for k, v in gaps.items()}


@pytest.mark.parametrize("network,compute", [
    ("narrow", "bfloat16"), ("narrow", None), ("mlp_mnist", "bfloat16")])
def test_twenty_step_adam_trajectory_matches_jax(network, compute):
    net, jnet, log, jlog = _trajectory(network, compute)
    gaps = _trajectory_gaps(net, jnet, log, jlog)
    assert log.scores[-1] < log.scores[0]
    assert gaps["pre_bn_bias"] <= 20 * 1e-3 + 1e-6, gaps    # Adam's reach
    if compute is None:
        assert gaps["score"] <= TRAJ_TOL and gaps["param_abs"] <= TRAJ_TOL \
            and gaps["state_abs"] <= TRAJ_TOL, gaps
    else:
        assert gaps["score"] <= BF16["score"] and \
            gaps["param"] <= BF16["param_l2"] and \
            gaps["state"] <= BF16["param_l2"], gaps


# ---------------------------------------------------------------------------
# the full-width BN-MLP (mlp_mnist with BN) on the bundled digits
# ---------------------------------------------------------------------------
def test_mlp_mnist_and_the_bundled_digits_match_jax():
    assert (MultiLayerConfiguration.from_json(mlp_mnist(device="cpu")
                                              .conf.to_json()).to_json()
            == jax_mlp_mnist().conf.to_json())
    for got, want in zip(bundled_mnist_subset(), jax_bundled_mnist_subset()):
        np.testing.assert_array_equal(got, want)
    port_json = _bn_mlp_mnist_conf(
        NeuralNetConfiguration.builder, DenseLayer, BatchNormalization,
        OutputLayer, InputType,
        __import__("deeplearning4j_tpu_torch").Adam, "bfloat16").to_json()
    assert port_json == _jax_bn_mlp_mnist("bfloat16").conf.to_json()


@pytest.mark.parametrize("compute", ["bfloat16", None])
def test_bn_mlp_mnist_gradients_and_adam_step_match_jax(compute):
    jnet = _jax_bn_mlp_mnist(compute)
    net = _twin(jnet)
    xtr, ytr, _, _ = bundled_mnist_subset()
    x, y = xtr[:32], ytr[:32]
    tol = STEP_TOL if compute is None else BF16["grad"]
    _, state, grads = _port_grads(net, x, y)
    jgrads = _jax_grads(jnet, x, y)
    _check_grads(net, grads, jgrads, tol)
    bn_relu.reset_launches()
    jnet.fit(x, y)
    net.fit(x, y)
    assert bn_relu.launch_counts() == {"fwd_launches": 0, "bwd_launches": 0}
    _check_step(net, jnet, jgrads,
                STEP_TOL if compute is None else BF16["step"], adam_lr=1e-3)
    for i in (1, 3):
        np.testing.assert_allclose(net.state[i]["var"].numpy(),
                                   np.asarray(jnet.state[i]["var"]),
                                   rtol=0, atol=STEP_TOL)


def test_bn_mlp_evaluate_matches_jax_after_training():
    jnet = _jax_bn_mlp_mnist("bfloat16")
    net = _twin(jnet)
    xtr, ytr, xte, yte = bundled_mnist_subset()
    jnet.fit(JaxArrayIterator(xtr, ytr, batch_size=128, shuffle=True,
                              seed=11, drop_last=True), epochs=2)
    net.fit(ArrayDataSetIterator(xtr, ytr, batch_size=128, shuffle=True,
                                 seed=11, drop_last=True), epochs=2)
    assert net.iteration_count == jnet.iteration_count == 4
    out = net.output(xte).numpy()
    jout = np.asarray(jnet.output(xte))
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, jout, rtol=0, atol=BF16["score"])
    ev = net.evaluate(ArrayDataSetIterator(xte, yte, batch_size=64))
    jev = jnet.evaluate(JaxArrayIterator(xte, yte, batch_size=64))
    assert abs(ev.accuracy() - jev.accuracy()) <= 2 / 64   # two digits
    assert ev.accuracy() > 0.5


# ---------------------------------------------------------------------------
# float64, and the compute_dtype setting
# ---------------------------------------------------------------------------
def test_float64_gradient_check_through_the_plain_bn_path():
    conf = (NeuralNetConfiguration.builder().seed(1).dtype("float64")
            .list()
            .layer(DenseLayer(n_out=6, activation="identity"))
            .layer(BatchNormalization(activation="relu"))
            .layer(DenseLayer(n_out=5, activation="identity"))
            .layer(BatchNormalization(activation="tanh", decay=0.5))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    r = np.random.default_rng(7)
    ds = DataSet(r.normal(size=(9, 4)),
                 np.eye(3)[r.integers(0, 3, 9)])
    x = torch.from_numpy(ds.features)
    assert net.layers[1]._helper(x, True) is None
    assert GradientCheckUtil.check_gradients(net, ds, subsample=24)


def test_compute_dtype_setting():
    def conf(dtype, compute):
        return (NeuralNetConfiguration.builder().dtype(dtype)
                .compute_dtype(compute).list()
                .layer(OutputLayer(n_out=2, n_in=3)).build())
    assert MultiLayerNetwork(conf("float32", "float32"),
                             device="cpu")._compute_dtype is None
    assert MultiLayerNetwork(conf("float32", "float16"),
                             device="cpu")._compute_dtype == torch.float16
    with pytest.raises(ValueError, match="not_a_dtype"):
        MultiLayerNetwork(conf("float32", "not_a_dtype"), device="cpu")


def _report():
    """Print the measured gaps behind this file's bf16 limits."""
    for network, compute in (("narrow", "bfloat16"), ("narrow", None),
                             ("mlp_mnist", "bfloat16")):
        print(network, compute or "float32", "20 Adam steps:",
              _trajectory_gaps(*_trajectory(network, compute)))
    for compute in ("bfloat16", None):
        jnet = _jax_bn_mlp_mnist(compute)
        net = _twin(jnet)
        xtr, ytr, _, _ = bundled_mnist_subset()
        _, _, grads = _port_grads(net, xtr[:32], ytr[:32])
        jgrads = _jax_grads(jnet, xtr[:32], ytr[:32])
        worst = max(np.abs(g[k].numpy() - np.asarray(jg[k])).max()
                    / np.abs(np.asarray(jg[k])).max()
                    for i, (g, jg) in enumerate(zip(grads, jgrads))
                    for k in jg if not _pre_bn_bias(net, i, k))
        print("mlp_mnist", compute or "float32", "first-step gradients, "
              "max err / max |JAX| per tensor:", float(worst))


if __name__ == "__main__":
    # JAX on the CPU in float64 mode, as the suite's conftest sets it
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _report()
