"""PyTorch port, the LM-training slice as a whole, on the CPU against the
JAX package: a small transformer LM (vocab 11, width 32, 4 heads, 2 blocks,
T 16, softmax RnnOutputLayer, Adam 1e-3 with beta2 0.99) with parameters
crossing through `from_jax_params` or the zip and the same numpy batches on
both sides.

  * one batch's gradients against `jax.grad` of the JAX network's
    `_loss_fn` with every block's `flash = True`, so the JAX side runs the
    Pallas forward with logsumexp and the dq and dk/dv kernels in interpret
    mode (the port runs its plain versions through the same autograd
    Function the card runs); with a features mask, the masked-einsum path
    on both sides;
  * one Adam step (1e-5: float32 sums in another order through two blocks
    and a softmax);
  * a 20-step `fit` trajectory on the same `ArrayDataSetIterator` (1e-4,
    the parity gate's bound for trajectories; JAX's default `flash="auto"`,
    its plain attention on the CPU, for speed);
  * the key bias `b_k` apart: its gradient is exactly 0 in exact
    arithmetic (adding one vector to every key shifts a row's logits by a
    constant, which the softmax ignores), so both packages see only
    rounding noise there, and Adam's m / (sqrt(v) + eps) turns that into
    updates (below lr) whose sign is the noise's. Its values are
    held to what Adam can move them, lr per step, not to each other;
  * the zip with updater state port -> JAX -> port, and a JAX zip resumed
    in the port equal to JAX training straight through;
  * the float64 LM: output equal to JAX's x64 output, and the float64
    gradient check;
  * no kernel launch on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import \
    EmbeddingSequenceLayer as JaxEmbedding
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.layers import TransformerBlock as JaxBlock
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (ModelSerializer, MultiLayerNetwork,
                                      from_jax_params)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.kernels import attention, lstm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.util.gradient_check import GradientCheckUtil

VOCAB, WIDTH, HEADS, BLOCKS, SEQ = 11, 32, 4, 2, 16
STEP_TOL = 1e-5
TRAJ_TOL = 1e-4
LR = 1e-3


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _jax_lm(seed=3, blocks=BLOCKS, width=WIDTH, heads=HEADS, seq=SEQ,
            dtype=None):
    b = JaxNNC.builder().seed(seed).updater(JaxAdam(LR, beta2=0.99))
    if dtype:
        b = b.dtype(dtype)
    lb = b.list().layer(JaxEmbedding(n_in=VOCAB, n_out=width))
    for _ in range(blocks):
        lb = lb.layer(JaxBlock(n_heads=heads))
    conf = (lb.layer(JaxRnnOutput(n_out=VOCAB, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(1, seq)).build())
    return JaxNet(conf).init()


def _twin(jnet):
    """The port network of the JAX network's configuration JSON, with its
    parameters and updater state."""
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    return from_jax_params(net, _np_tree(jnet.params),
                           _np_tree(jnet.updater_state))


def _text(n, seed=0, seq=SEQ, dtype=np.float32):
    """Random ids [n, T, 1] labelled with the next id (one-hot)."""
    idx = np.random.default_rng(seed).integers(0, VOCAB, (n, seq + 1))
    return (idx[:, :-1, None].astype(dtype),
            np.eye(VOCAB, dtype=dtype)[idx[:, 1:]])


def _params_close(net, jnet, atol, msg=""):
    """Parameters within `atol`, the key biases within Adam's reach (lr per
    step taken, see the module docstring)."""
    steps = net.iteration_count
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            got, want = p[k].detach().numpy(), np.asarray(jp[k])
            if k == "b_k":
                bound = LR * steps
                assert np.abs(got).max() <= bound, f"{msg} layer {i} b_k"
                assert np.abs(want).max() <= bound, f"{msg} layer {i} b_k"
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=f"{msg} layer {i} {k}")


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_grad_through_the_flash_kernels(masked):
    jnet = _jax_lm()
    for layer in jnet.layers:
        if isinstance(layer, JaxBlock):
            layer.flash = True        # the Pallas kernels, interpret mode
    net = _twin(jnet)
    x, y = _text(3, seed=1)
    fmask = None
    if masked:
        fmask = np.ones((3, SEQ), np.float32)
        fmask[0, 11:] = 0.0
        fmask[2, 5:] = 0.0
    want = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None,
        fmask=None if fmask is None else jnp.asarray(fmask))[0])(jnet.params)
    params = tuple({k: v.clone().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, _ = net._loss_fn(params, net.state, torch.from_numpy(x),
                            torch.from_numpy(y), None,
                            fmask=None if fmask is None
                            else torch.from_numpy(fmask))
    got = iter(torch.autograd.grad(score, [v for p in params
                                           for v in p.values()]))
    for i, p in enumerate(params):
        for k in p:
            np.testing.assert_allclose(next(got).numpy(),
                                       np.asarray(want[i][k]), rtol=0,
                                       atol=STEP_TOL, err_msg=f"{i}/{k}")


def test_one_adam_step_matches_jax():
    """Adam's first step moves a parameter by lr * g / (|g| + eps), whose
    slope in g is lr * eps / (|g| + eps)^2: where |g| is below 100 eps =
    1e-6 (a nearly dead GELU unit's FFN weights, the key biases) float32
    rounding of g moves the update by more than 1e-5. There the
    parameters are held to lr, the most a step can move them; everywhere
    else, and for Adam's m and v, 1e-5."""
    jnet = _jax_lm(seed=4)
    net = _twin(jnet)
    x, y = _text(4, seed=2)
    grads = jax.grad(lambda p: jnet._loss_fn(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None)[0])(jnet.params)
    jnet.fit(x, y)
    net.fit(x, y)
    assert net.iteration_count == jnet.iteration_count == 1
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=0,
                               atol=STEP_TOL)
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            tol = np.where(np.abs(np.asarray(grads[i][k])) < 1e-6, LR,
                           STEP_TOL)
            err = np.abs(p[k].numpy() - np.asarray(jp[k]))
            assert (err <= tol).all(), f"layer {i} {k}: {err.max()}"
    for i, (s, js) in enumerate(zip(net.updater_state, jnet.updater_state)):
        for slot in js:
            for k in js[slot]:
                np.testing.assert_allclose(
                    s[slot][k].numpy(), np.asarray(js[slot][k]), rtol=0,
                    atol=STEP_TOL, err_msg=f"{i}/{slot}/{k}")


def test_twenty_step_fit_trajectory_matches_jax_fit():
    jnet = _jax_lm(seed=5)
    net = _twin(jnet)
    x, y = _text(40, seed=3)
    jl, pl = _Scores(), _Scores()
    jnet.set_listeners(jl)
    net.set_listeners(pl)
    jnet.fit(JaxArrayIterator(x, y, batch_size=4, shuffle=True, seed=9),
             epochs=2)
    net.fit(ArrayDataSetIterator(x, y, batch_size=4, shuffle=True, seed=9),
            epochs=2)
    assert len(pl.scores) == len(jl.scores) == 20
    np.testing.assert_allclose(pl.scores, jl.scores, rtol=0, atol=TRAJ_TOL)
    assert pl.scores[-1] < pl.scores[0]
    _params_close(net, jnet, TRAJ_TOL, "after 20 steps")


def _assert_trees_equal(a, b, msg=""):
    if isinstance(b, dict):
        assert set(a) == set(b), msg
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{msg}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), msg
        for i, v in enumerate(b):
            _assert_trees_equal(a[i], v, f"{msg}/{i}")
    else:
        np.testing.assert_array_equal(
            a.detach().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a),
            b.detach().numpy() if isinstance(b, torch.Tensor)
            else np.asarray(b), err_msg=msg)


def test_zip_with_adam_state_goes_port_to_jax_and_back(tmp_path):
    net = _twin(_jax_lm(seed=6))
    net.fit(*_text(3, seed=4))
    path = str(tmp_path / "port_lm.zip")
    ModelSerializer.write_model(net, path)
    jnet = JaxModelSerializer.restore(path, load_updater=True)
    assert jnet.iteration_count == net.iteration_count == 1
    _assert_trees_equal(net.updater_state, jnet.updater_state, "updater")
    _assert_trees_equal(net.params, jnet.params, "params")
    jpath = str(tmp_path / "jax_lm.zip")
    JaxModelSerializer.write_model(jnet, jpath)
    back = ModelSerializer.restore(jpath, device="cpu")
    _assert_trees_equal(back.updater_state, net.updater_state, "back")
    _assert_trees_equal(back.params, net.params, "back params")


def test_jax_zip_resumed_in_the_port_equals_jax_straight_through(tmp_path):
    x, y = _text(12, seed=5)
    batches = [(x[i:i + 3], y[i:i + 3]) for i in range(0, 12, 3)]
    whole, half = _jax_lm(seed=7), _jax_lm(seed=7)
    for bx, by in batches:
        whole.fit(bx, by)
    for bx, by in batches[:2]:
        half.fit(bx, by)
    path = str(tmp_path / "half.zip")
    JaxModelSerializer.write_model(half, path)
    net = ModelSerializer.restore(path, device="cpu")
    assert net.iteration_count == 2
    for bx, by in batches[2:]:
        net.fit(bx, by)
    assert net.iteration_count == whole.iteration_count == 4
    _params_close(net, whole, STEP_TOL, "resumed across packages")


def test_cpu_fit_launches_no_kernel():
    net = _twin(_jax_lm(seed=8))
    attention.reset_launches()
    lstm.reset_launches()
    net.fit(*_text(2, seed=6))
    assert net.iteration_count == 1 and np.isfinite(net.score())
    assert set(attention.launch_counts().values()) == {0}
    assert set(lstm.launch_counts().values()) == {0}


def _float64_probe():
    """The float64 probe: one EmbeddingSequenceLayer (11 -> 16), one
    TransformerBlock(n_heads=2), a softmax RnnOutputLayer, input [2, 8, 1]."""
    jnet = _jax_lm(seed=9, blocks=1, width=16, heads=2, seq=8,
                   dtype="float64")
    return jnet, _twin(jnet)


def test_float64_lm_output_matches_jax_x64():
    """The attention computes float32 logits and softmax and casts back to
    float64 on both sides, as JAX's `attention_reference` does."""
    jnet, net = _float64_probe()
    x, _ = _text(2, seed=7, seq=8, dtype=np.float64)
    want = np.asarray(jnet.output(x))
    got = net.output(x)
    assert want.dtype == np.float64 and got.dtype == torch.float64
    assert got.shape == (2, 8, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_float64_gradient_check_on_a_one_block_lm():
    """The float64 gradient check passes on the LM, with its settings
    widened for the attention's float32 arithmetic (the reference's own
    semantics): rounding of about 1e-7 in the loss becomes noise of about
    1e-7 / eps in a central difference, so eps is 1e-2 (not 1e-6) and a
    coordinate fails only beyond 1e-5 absolute: the coordinates that need
    that floor are those whose analytic gradient is about 0 (the key
    bias's is exactly 0: a shift of every key leaves the softmax
    unchanged)."""
    _, net = _float64_probe()
    x, y = _text(2, seed=8, seq=8, dtype=np.float64)
    assert GradientCheckUtil.check_gradients(
        net, DataSet(x, y), eps=1e-2, max_rel_error=1e-3, min_abs_error=1e-5,
        subsample=24)
