"""PyTorch port, the training slice as a whole, on the CPU against the JAX
package: a small char-RNN (vocab 11, 2 x GravesLSTM(8), softmax
RnnOutputLayer, batch 3) and a small MLP, with parameters crossing through
`from_jax_params` or the zip and the same numpy batches on both sides.

  * one batch's gradients against `jax.grad` of the JAX network's
    `_loss_fn`; one SGD and one Adam step (tolerance 1e-5: float32 sums in
    another order through 12 LSTM steps and a softmax);
  * a 20-step TBPTT `fit` trajectory (T 11, TBPTT 3: chunks 3/3/3/2, five
    shuffled batches) against JAX `fit` on the same iterator (1e-4, the
    parity gate's bound for trajectories: 20 Adam steps compound the
    per-step float32 differences);
  * `score`, `score_examples` and `evaluate`; an MLP step with l2, a bias
    lr, gradient normalization and an lr schedule (1e-5);
  * a float64 gradient check;
  * the zip with updater state both ways, and resumed training equal to
    uninterrupted training;
  * named errors for what the slice does not train, the transformer LM's
    `fit` against JAX's, and no kernel launch on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import \
    EmbeddingSequenceLayer as JaxEmbedding
from deeplearning4j_tpu.nn.layers import GravesLSTM as JaxGravesLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.layers import TransformerBlock as JaxBlock
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (InputType, ModelSerializer,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, RnnOutputLayer,
                                      char_rnn, from_jax_params)
from deeplearning4j_tpu_torch.datasets import (ArrayDataSetIterator, DataSet,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.kernels import lstm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.gradient_check import (
    GradientCheckUtil, check_gradients_fn)
from jax_reference import jax_init, jax_value_and_grad
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, HIDDEN = 11, 8
STEP_TOL = 1e-5
TRAJ_TOL = 1e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _twin(jnet):
    """The port network of the JAX network's configuration JSON, with its
    parameters and updater state."""
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    return from_jax_params(net, _np_tree(jnet.params),
                           _np_tree(jnet.updater_state))


def _char_data(n, T, seed=0):
    """One-hot random characters, labelled with the next character."""
    idx = np.random.default_rng(seed).integers(0, VOCAB, (n, T + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]]


def _params_close(net, jnet, atol, msg=""):
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            np.testing.assert_allclose(p[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=atol,
                                       err_msg=f"{msg} layer {i} {k}")


def _jax_rnn_conf(updater, seq_len=12, l2=0.0):
    b = JaxNNC.builder().seed(5).updater(updater)
    if l2:
        b = b.l2(l2)
    return (b.list().layer(JaxGravesLSTM(n_out=HIDDEN))
            .layer(JaxGravesLSTM(n_out=HIDDEN))
            .layer(JaxRnnOutput(n_out=VOCAB, activation="softmax",
                                loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(VOCAB, seq_len)).build())


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))


# ---------------------------------------------------------------------------
# gradients and single steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_one_batch_gradients_match_jax_grad(masked):
    jnet = jax_init(jax_char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN,
                                 seq_len=12, tbptt=5, seed=3))
    net = _twin(jnet)
    x, y = _char_data(3, 12, seed=1)
    lmask = None
    if masked:
        lmask = np.ones((3, 12), np.float32)
        lmask[0, 7:] = 0.0
        lmask[2, :] = 0.0
    _, want = jax_value_and_grad(jnet, x, y, lmask=lmask)
    params = tuple({k: v.clone().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, _ = net._loss_fn(params, net.state, torch.from_numpy(x),
                            torch.from_numpy(y), None,
                            lmask=None if lmask is None
                            else torch.from_numpy(lmask))
    leaves = [v for p in params for v in p.values()]
    got = iter(torch.autograd.grad(score, leaves))
    for i, p in enumerate(params):
        for k in p:
            np.testing.assert_allclose(next(got).numpy(),
                                       np.asarray(want[i][k]), rtol=0,
                                       atol=STEP_TOL, err_msg=f"{i}/{k}")


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_one_optimizer_step_matches_jax(updater):
    u = (jax_updaters.Sgd(0.1) if updater == "sgd"
         else jax_updaters.Adam(2e-3))
    jnet = jax_init(JaxMultiLayerNetwork(_jax_rnn_conf(u)))
    net = _twin(jnet)
    x, y = _char_data(3, 12, seed=2)
    jnet.fit(x, y)
    net.fit(x, y)
    assert net.iteration_count == jnet.iteration_count == 1
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=0,
                               atol=STEP_TOL)
    _params_close(net, jnet, STEP_TOL, updater)
    for i, (s, js) in enumerate(zip(net.updater_state, jnet.updater_state)):
        for slot in (js or {}):
            for k in js[slot]:
                np.testing.assert_allclose(
                    s[slot][k].numpy(), np.asarray(js[slot][k]), rtol=0,
                    atol=STEP_TOL, err_msg=f"{i}/{slot}/{k}")


def test_twenty_step_tbptt_trajectory_matches_jax_fit():
    jnet = jax_init(jax_char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN,
                                 seq_len=11, tbptt=3, seed=4))
    net = _twin(jnet)
    x, y = _char_data(15, 11, seed=3)
    jl, pl = _Scores(), _Scores()
    jnet.set_listeners(jl)
    net.set_listeners(pl)
    jnet.fit(JaxArrayIterator(x, y, batch_size=3, shuffle=True, seed=9))
    net.fit(ArrayDataSetIterator(x, y, batch_size=3, shuffle=True, seed=9))
    assert len(pl.scores) == len(jl.scores) == 20
    assert net.iteration_count == jnet.iteration_count == 20
    np.testing.assert_allclose(pl.scores, jl.scores, rtol=0, atol=TRAJ_TOL)
    _params_close(net, jnet, TRAJ_TOL, "after 20 steps")


def test_tbptt_carries_cross_chunks_detached():
    """A 2-chunk batch is two steps whose second chunk starts from the
    first chunk's final (h, c), as JAX's `_fit_tbptt` does."""
    jnet = jax_init(jax_char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN,
                                 seq_len=10, tbptt=5, seed=6))
    net = _twin(jnet)
    x, y = _char_data(3, 10, seed=4)
    jnet.fit(x, y)
    net.fit(x, y)
    assert net.iteration_count == 2
    _params_close(net, jnet, STEP_TOL, "two chunks")


# ---------------------------------------------------------------------------
# scoring and evaluation
# ---------------------------------------------------------------------------
def test_score_score_examples_and_evaluate_match_jax():
    jnet = jax_init(JaxMultiLayerNetwork(
        _jax_rnn_conf(jax_updaters.Adam(1e-2), l2=1e-2)))
    net = _twin(jnet)
    x, y = _char_data(6, 12, seed=5)
    mask = np.ones((6, 12), np.float32)
    mask[1, 5:] = 0.0
    from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet
    for lm in (None, mask):
        np.testing.assert_allclose(
            net.score(DataSet(x, y, labels_mask=lm)),
            float(jnet.score(JaxDataSet(x, y, labels_mask=lm))), rtol=1e-6)
        for reg in (True, False):
            np.testing.assert_allclose(
                net.score_examples(DataSet(x, y, labels_mask=lm), reg),
                np.asarray(jnet.score_examples(
                    JaxDataSet(x, y, labels_mask=lm), reg)), rtol=1e-5)
    got = net.score_examples(ArrayDataSetIterator(x, y, batch_size=4))
    assert got.shape == (6,)
    ev = net.evaluate(ArrayDataSetIterator(x, y, batch_size=4,
                                           labels_mask=mask))
    jev = jnet.evaluate(JaxArrayIterator(x, y, batch_size=4,
                                         labels_mask=mask))
    assert ev.num_examples() == jev.num_examples() == int(mask.sum())
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    assert ev.accuracy() == jev.accuracy() and ev.f1() == jev.f1()


@pytest.mark.parametrize("minimize", [True, False])
def test_mlp_steps_with_l2_bias_lr_gradnorm_and_schedule(minimize):
    conf = (JaxNNC.builder().seed(2)
            .updater(jax_updaters.Nesterovs(0.1, 0.9)).l2(1e-3).l2_bias(5e-4)
            .learning_rate_decay_policy("exponential", decay_rate=0.8)
            .gradient_normalization("clip_l2_per_layer", 0.5)
            .minimize(minimize).list()
            .layer(JaxDense(n_out=7, activation="tanh",
                            bias_learning_rate=0.02))
            .layer(JaxDense(n_out=6, activation="relu", learning_rate=0.05))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = jax_init(JaxMultiLayerNetwork(conf))
    net = _twin(jnet)
    r = np.random.default_rng(6)
    for _ in range(3):
        x = r.normal(size=(5, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 5)]
        jnet.fit(x, y)
        net.fit(x, y)
    _params_close(net, jnet, STEP_TOL, "mlp")
    assert net.num_params() == jnet.num_params()
    np.testing.assert_allclose(net.params_flat(), jnet.params_flat(),
                               rtol=0, atol=STEP_TOL)


def test_params_flat_round_trips():
    net = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=5,
                   device="cpu").init()
    vec = net.params_flat()
    assert vec.shape == (net.num_params(),)
    net.set_params_flat(vec * 2.0)
    np.testing.assert_array_equal(net.params_flat(), vec * 2.0)


# ---------------------------------------------------------------------------
# gradient check (float64)
# ---------------------------------------------------------------------------
def test_float64_gradient_check_passes():
    conf = (NeuralNetConfiguration.builder().seed(1).dtype("float64")
            .l2(1e-3).list()
            .layer(GravesLSTM(n_out=4)).layer(GravesLSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(InputType.recurrent(5, 4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    idx = np.random.default_rng(2).integers(0, 5, (2, 5))
    eye = np.eye(5)
    ds = DataSet(eye[idx[:, :-1]], eye[idx[:, 1:]])
    assert GradientCheckUtil.check_gradients(net, ds, subsample=24)


def test_gradient_check_catches_a_wrong_gradient():
    params = ({"W": torch.linspace(-1.0, 1.0, 6)},)
    ok, failures = check_gradients_fn(
        lambda p: (p[0]["W"] ** 2).sum() + (p[0]["W"].detach() ** 3).sum(),
        params)
    assert not ok and "param '0/W'" in failures[0]
    ok, _ = check_gradients_fn(lambda p: (p[0]["W"] ** 3).sum(), params)
    assert ok


# ---------------------------------------------------------------------------
# the zip with updater state
# ---------------------------------------------------------------------------
def _assert_trees_equal(a, b, msg=""):
    if isinstance(b, dict):
        assert set(a) == set(b), msg
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{msg}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b) or (len(b) == 0 and not a), msg
        for i, v in enumerate(b):
            _assert_trees_equal(a[i], v, f"{msg}/{i}")
    else:
        np.testing.assert_array_equal(
            a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a),
            b.detach().float().numpy() if isinstance(b, torch.Tensor)
            else np.asarray(b), err_msg=msg)


def test_port_zip_with_updater_state_restores_in_jax_and_back(tmp_path):
    net = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=6, tbptt=3,
                   device="cpu").init()
    x, y = _char_data(3, 6, seed=7)
    net.fit(x, y)
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    jnet = JaxModelSerializer.restore(path, load_updater=True)
    assert jnet.iteration_count == net.iteration_count == 2
    _assert_trees_equal(net.updater_state, jnet.updater_state, "updater")
    _assert_trees_equal(net.params, jnet.params, "params")
    jpath = str(tmp_path / "jax.zip")
    JaxModelSerializer.write_model(jnet, jpath)
    back = ModelSerializer.restore(jpath, device="cpu")
    _assert_trees_equal(back.updater_state, net.updater_state, "back")
    fresh = ModelSerializer.restore(jpath, load_updater=False, device="cpu")
    assert not fresh.updater_state[0]["m"]["W"].any()


def test_resumed_training_equals_uninterrupted(tmp_path):
    """JAX trains two batches, its zip crosses to the port, which trains
    two more: the same as JAX training all four; and the port's own zip
    resumes bit-exactly."""
    x, y = _char_data(12, 8, seed=8)
    batches = [(x[i:i + 3], y[i:i + 3]) for i in range(0, 12, 3)]
    make = lambda: jax_init(jax_char_rnn(vocab_size=VOCAB,
                                         lstm_size=HIDDEN, seq_len=8,
                                         tbptt=4, seed=7))
    whole, half = make(), make()
    for bx, by in batches:
        whole.fit(bx, by)
    for bx, by in batches[:2]:
        half.fit(bx, by)
    path = str(tmp_path / "half.zip")
    JaxModelSerializer.write_model(half, path)
    net = ModelSerializer.restore(path, device="cpu")
    assert net.iteration_count == 4
    for bx, by in batches[2:]:
        net.fit(bx, by)
    assert net.iteration_count == whole.iteration_count == 8
    _params_close(net, whole, STEP_TOL, "resumed across packages")

    straight = ModelSerializer.restore(path, device="cpu")
    for bx, by in batches[2:]:
        straight.fit(bx, by)
    ModelSerializer.write_model(net, str(tmp_path / "mid.zip"))
    resumed = ModelSerializer.restore(path, device="cpu")
    resumed.fit(*batches[2])
    mid = str(tmp_path / "mid2.zip")
    ModelSerializer.write_model(resumed, mid)
    resumed = ModelSerializer.restore(mid, device="cpu")
    resumed.fit(*batches[3])
    _assert_trees_equal(resumed.params, straight.params, "port resume")
    _assert_trees_equal(resumed.updater_state, straight.updater_state)


def test_bfloat16_first_moment_round_trips_through_the_zip(tmp_path):
    conf = (NeuralNetConfiguration.builder()
            .updater(Adam(1e-2, state_dtype="bfloat16")).list()
            .layer(GravesLSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(InputType.recurrent(5, 3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(np.eye(5, dtype=np.float32)[[[0, 1, 2], [3, 4, 0]]],
            np.eye(5, dtype=np.float32)[[[1, 2, 3], [4, 0, 1]]])
    path = str(tmp_path / "bf16.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore(path, device="cpu")
    assert back.updater_state[0]["m"]["W"].dtype == torch.bfloat16
    _assert_trees_equal(back.updater_state, net.updater_state)


# ---------------------------------------------------------------------------
# what the slice does not train, and the counters
# ---------------------------------------------------------------------------
def _fit_option_case(option, value, tmp_path):
    """Fit the small char-RNN (three series of 5, batch 2: a ragged tail)
    with one of JAX's `fit` options; returns (net, the same fit without
    the option)."""
    from deeplearning4j_tpu_torch.fault import TrainingGuard
    x, y = _char_data(3, 5)
    mk = lambda: char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=5,
                          device="cpu").init()
    plain = mk()
    plain.fit(ArrayDataSetIterator(x, y, batch_size=2))
    if option == "checkpoint_dir":
        value = str(tmp_path / value)
    if option == "guard":
        value = TrainingGuard(value)
    net = mk()
    net.fit(ArrayDataSetIterator(x, y, batch_size=2), **{option: value})
    return net, plain


@pytest.mark.parametrize("option,value", [
    ("superstep", 2), ("grad_accumulation", 2), ("prefetch", True),
    ("pad_ragged", True), ("time_buckets", [8]), ("checkpoint_dir", "ckpt"),
    ("checkpoint_every", 5), ("resume", True), ("guard", "warn")])
def test_fit_options_train_the_char_rnn(option, value, tmp_path):
    """Each of JAX's `fit` options on the TBPTT char-RNN, as JAX treats
    it: superstep falls back to per-batch steps (the same bits), prefetch
    and a warn guard change nothing, padding rows and the time axis is a
    learning no-op (1e-5), checkpoint_dir leaves a resumable checkpoint,
    and grad_accumulation, checkpoint_every or resume without a directory
    raise JAX's errors."""
    if option == "grad_accumulation":
        with pytest.raises(ValueError, match="not supported for this "
                                             "configuration"):
            _fit_option_case(option, value, tmp_path)
        return
    if option in ("checkpoint_every", "resume"):
        with pytest.raises(ValueError, match="need checkpoint_dir"):
            _fit_option_case(option, value, tmp_path)
        return
    net, plain = _fit_option_case(option, value, tmp_path)
    assert net.iteration_count == plain.iteration_count == 2
    if option in ("pad_ragged", "time_buckets"):
        np.testing.assert_allclose(net.params_flat(), plain.params_flat(),
                                   rtol=0, atol=1e-5)
        return
    np.testing.assert_array_equal(net.params_flat(), plain.params_flat())
    if option == "checkpoint_dir":
        from deeplearning4j_tpu_torch.fault import CheckpointManager
        (it, path), = CheckpointManager(str(tmp_path / "ckpt")).entries()
        assert it == 2
        back = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=5,
                        device="cpu").init()
        ModelSerializer.restore_into(back, path)
        np.testing.assert_array_equal(back.params_flat(), net.params_flat())


def test_fit_on_the_lm_matches_jax_fit():
    """`fit(features, labels)` trains the transformer LM as JAX's does
    (three Adam steps on arrays; the trajectory bound 1e-4; the key bias,
    whose gradient is exactly 0 and whose Adam updates follow rounding
    noise, is held to lr per step: `tests/test_torch_lm_training.py`)."""
    conf = (JaxNNC.builder().seed(2).updater(jax_updaters.Adam(1e-3)).list()
            .layer(JaxEmbedding(n_in=16, n_out=8))
            .layer(JaxBlock(n_heads=2))
            .layer(JaxRnnOutput(n_out=16, activation="softmax",
                                loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(1, 6)).build())
    jnet = jax_init(JaxMultiLayerNetwork(conf))
    net = _twin(jnet)
    r = np.random.default_rng(10)
    for _ in range(3):
        idx = r.integers(0, 16, (2, 7))
        x = idx[:, :-1, None].astype(np.float32)
        y = np.eye(16, dtype=np.float32)[idx[:, 1:]]
        jnet.fit(x, y)
        net.fit(x, y)
    assert net.iteration_count == jnet.iteration_count == 3
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=0,
                               atol=TRAJ_TOL)
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            if k == "b_k":
                assert np.abs(p[k].numpy()).max() <= 3e-3
                continue
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=TRAJ_TOL,
                                       err_msg=f"layer {i} {k}")


def test_fit_with_a_line_search_optimizer_matches_jax():
    """optimization_algo="lbfgs" (refused until the port's twelfth slice):
    the recurrent net the refusal was tested on (GravesLSTM(4) + softmax
    RnnOutputLayer) fits six batches through the L-BFGS line search, each
    score within the trajectory tolerance of JAX's, and so the final
    parameters."""
    conf = (JaxNNC.builder().seed(3).optimization_algo("lbfgs").list()
            .layer(JaxGravesLSTM(n_out=4))
            .layer(JaxRnnOutput(n_out=5, activation="softmax"))
            .set_input_type(JaxInputType.recurrent(5, 3)).build())
    jnet = jax_init(JaxMultiLayerNetwork(conf))
    net = _twin(jnet)
    r = np.random.default_rng(13)
    eye = np.eye(5, dtype=np.float32)
    x, y = eye[r.integers(0, 5, (4, 3))], eye[r.integers(0, 5, (4, 3))]
    for _ in range(6):
        jnet.fit(x, y)
        net.fit(ListDataSetIterator([DataSet(x, y)]))
        assert abs(net.score() - float(jnet.score())) <= TRAJ_TOL
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=TRAJ_TOL,
                                       err_msg=f"layer {i} {k}")


def test_fit_on_a_pretrain_config_matches_jax():
    """pretrain=True (refused until the port's eleventh slice): `fit` runs
    the layerwise pretraining once (an AutoEncoder at corruption 0: no
    noise), then backprop over the same iterator, as JAX's `fit`; a
    recurrent net with pretrain=True and no pretrainable layer trains as
    without it. One-step tolerance for the three pretraining steps,
    trajectory tolerance after the backprop steps."""
    from deeplearning4j_tpu.nn.layers import AutoEncoder as JaxAutoEncoder
    conf = (JaxNNC.builder().seed(2).updater(jax_updaters.Adam(1e-2)).list()
            .layer(JaxAutoEncoder(n_out=6, corruption_level=0.0))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(VOCAB))
            .pretrain(True).backprop(False).build())
    jnet = jax_init(JaxMultiLayerNetwork(conf))
    net = _twin(jnet)
    r = np.random.default_rng(12)
    x = r.random((12, VOCAB)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 12)]
    jnet.fit(JaxArrayIterator(x, y, batch_size=4))
    net.fit(ArrayDataSetIterator(x, y, batch_size=4))
    assert net.iteration_count == 0          # backprop off: pretrain only
    _params_close(net, jnet, STEP_TOL, "pretrained")
    for n in (jnet, net):
        n.conf.backprop = True
    jnet.fit(JaxArrayIterator(x, y, batch_size=4), epochs=2)
    net.fit(ArrayDataSetIterator(x, y, batch_size=4), epochs=2)
    assert net.iteration_count == jnet.iteration_count == 6
    _params_close(net, jnet, TRAJ_TOL, "trained")
    rnn = (NeuralNetConfiguration.builder().seed(1).list()
           .layer(GravesLSTM(n_out=4))
           .layer(RnnOutputLayer(n_out=5, activation="softmax"))
           .set_input_type(InputType.recurrent(5, 3)).pretrain(True).build())
    xs = np.eye(5, dtype=np.float32)[[[0, 1, 2], [3, 4, 0]]]
    nets = [MultiLayerNetwork(c, device="cpu").init() for c in (
        rnn, MultiLayerConfiguration.from_json(
            rnn.to_json().replace('"pretrain": true', '"pretrain": false')))]
    for n in nets:
        n.fit(ListDataSetIterator([DataSet(xs, xs)]))
    np.testing.assert_array_equal(nets[0].params_flat(),
                                  nets[1].params_flat())


def test_fit_on_the_cpu_launches_no_kernel():
    net = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=6, tbptt=3,
                   device="cpu").init()
    lstm.reset_launches()
    net.fit(*_char_data(3, 6, seed=9))
    assert net.iteration_count == 2
    assert set(lstm.launch_counts().values()) == {0}


def test_dropout_draws_from_the_network_generator():
    conf = (NeuralNetConfiguration.builder().seed(4).dropout(0.5)
            .regularization(True).list()
            .layer(GravesLSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(InputType.recurrent(5, 3)).build())
    assert conf.layers[0].dropout == 0.5
    x = np.eye(5, dtype=np.float32)[[[0, 1, 2], [3, 4, 0]]]
    runs = []
    for _ in range(2):
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.fit(x, x)
        runs.append(net.params_flat())
    np.testing.assert_array_equal(runs[0], runs[1])
    layer = conf.layers[0]
    gen = torch.Generator().manual_seed(0)
    ones = torch.ones(4000)
    out = layer.maybe_dropout_input(ones, True, gen)
    kept = out != 0
    assert torch.all(out[kept] == 2.0)
    assert abs(kept.float().mean().item() - 0.5) < 0.05
    assert torch.equal(layer.maybe_dropout_input(ones, False, gen), ones)
