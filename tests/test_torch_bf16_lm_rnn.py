"""PyTorch port, bf16 compute on the transformer LM and the char-RNN, on the
CPU against the JAX package under `compute_dtype("bfloat16")` (float32
masters): parameters and updater state cross through `from_jax_params`, and
the same numpy batches feed both sides.

  * a 2-block LM (vocab 11, width 32, 4 heads, T 16, Adam 1e-3 with beta2
    0.99): the output probabilities (JAX with its plain attention and with
    its Pallas kernels in interpret mode), the first step's gradients, and
    five Adam steps of `fit`;
  * the char-RNN (2 x GravesLSTM(16), vocab 12, T 10, Adam 2e-3): the
    output, `rnn_time_step`, the first step's gradients and five Adam
    steps.

Tolerances are PR 5's bf16 limits (`tests/test_torch_mlp_bn_training.py`):
outputs 2e-2 absolute, gradients 2e-2, scores 2e-2 absolute, weight
matrices 5e-2 relative L2 per tensor. The two sides round to bf16 at other
places (XLA keeps excess precision inside fused chains, eager torch rounds
after each op), so the gaps are bf16 rounding noise, as large as the gap
between JAX's own bf16 and float32 runs of the same networks (measured
over four seeds each: gradients 1.1-2.7e-2 port against JAX, 1.1-3.0e-2
JAX bf16 against f32; parameters after 5 steps 0.5-12e-2 and 0.4-10e-2):

  * gradients are held in relative L2 per tensor, as the parameters are
    (the LM's bias gradients sum 64 tokens' bf16 cotangents with
    cancellation, and their largest entry moves by 2.2-4.0e-2 of the
    tensor's largest between JAX's own bf16 and float32 runs), and against
    two references: the port's bf16 gradients within 2e-2 of JAX's
    float32 gradients of the same parameters (what bf16 compute should
    give), and within 2e-2 plus JAX's own bf16-to-float32 gap of JAX's
    bf16 gradients (the second layer's peephole gradient of the char-RNN
    is 2.1e-2 from JAX's bf16 one, which is itself 2.3e-2 from float32,
    while the port's is 0.8e-2 from float32);
  * vectors (biases, LayerNorm and peephole vectors) are held to Adam's
    reach, 2 lr per step apart at most: most start at 0 and have entries
    whose gradient is within rounding of 0, which Adam moves by lr per
    step with the noise's sign, so their relative L2 gap after 5 steps
    (up to 0.13 for one bias, against 0.02 for JAX bf16 against f32 on
    the same tensor) measures sign flips, not the math; PR 5's BN-MLP
    holds its pre-BN biases the same way.

The LM's key bias has an exactly-zero gradient (a constant shift of a
row's logits), so its gradient is held to the rounding scale of its W_k's.

Run as a script from the repository root (`JAX_PLATFORMS=cpu PYTHONPATH=.
python tests/test_torch_bf16_lm_rnn.py`), this file prints the measured
gaps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JaxMultiLayerConfiguration
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import \
    EmbeddingSequenceLayer as JaxEmbedding
from deeplearning4j_tpu.nn.layers import GravesLSTM as JaxGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.layers import TransformerBlock as JaxBlock
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu_torch import MultiLayerNetwork, from_jax_params
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.kernels import attention, lstm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from torch_threads import one_torch_thread  # noqa: F401

BF16 = {"out": 2e-2, "grad": 2e-2, "score": 2e-2, "param_l2": 5e-2}
LM_VOCAB, LM_WIDTH, LM_HEADS, LM_SEQ, LM_LR = 11, 32, 4, 16, 1e-3
RNN_VOCAB, RNN_HIDDEN, RNN_SEQ, RNN_LR = 12, 16, 10, 2e-3
STEPS = 5


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
                           _np_tree(jnet.updater_state))


def _jax_lm(seed, flash=None):
    b = (JaxNNC.builder().seed(seed)
         .updater(jax_updaters.Adam(LM_LR, beta2=0.99))
         .compute_dtype("bfloat16"))
    lb = b.list().layer(JaxEmbedding(n_in=LM_VOCAB, n_out=LM_WIDTH))
    for _ in range(2):
        lb = lb.layer(JaxBlock(n_heads=LM_HEADS))
    conf = (lb.layer(JaxRnnOutput(n_out=LM_VOCAB, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(1, LM_SEQ)).build())
    jnet = JaxNet(conf).init()
    if flash is not None:
        for layer in jnet.layers:
            if isinstance(layer, JaxBlock):
                layer.flash = flash
    return jnet


def _cyclic(n, length, vocab, seed):
    """Sequences that count up modulo `vocab` from a random start, with a
    random id in one place in five: a task a few steps can learn."""
    r = np.random.default_rng(seed)
    idx = (r.integers(0, vocab, (n, 1)) + np.arange(length)) % vocab
    noise = r.random((n, length)) < 0.2
    return np.where(noise, r.integers(0, vocab, (n, length)), idx)


def _lm_data(n, seed):
    idx = _cyclic(n, LM_SEQ + 1, LM_VOCAB, seed)
    return (idx[:, :-1, None].astype(np.float32),
            np.eye(LM_VOCAB, dtype=np.float32)[idx[:, 1:]])


def _jax_rnn(seed):
    conf = (JaxNNC.builder().seed(seed)
            .updater(jax_updaters.Adam(RNN_LR)).compute_dtype("bfloat16")
            .list().layer(JaxGravesLSTM(n_out=RNN_HIDDEN))
            .layer(JaxGravesLSTM(n_out=RNN_HIDDEN))
            .layer(JaxRnnOutput(n_out=RNN_VOCAB, activation="softmax",
                                loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(RNN_VOCAB, RNN_SEQ))
            .build())
    return JaxNet(conf).init()


def _rnn_data(n, seed):
    idx = _cyclic(n, RNN_SEQ + 1, RNN_VOCAB, seed)
    eye = np.eye(RNN_VOCAB, dtype=np.float32)
    return eye[idx[:, :-1]], eye[idx[:, 1:]]


MODELS = {"lm": (_jax_lm, _lm_data, LM_LR),
          "char_rnn": (_jax_rnn, _rnn_data, RNN_LR)}


def _float32_twin(jnet):
    """JAX's network of the same configuration without compute_dtype."""
    conf = json.loads(jnet.conf.to_json())
    conf["conf"]["compute_dtype"] = None
    return JaxNet(JaxMultiLayerConfiguration.from_json(
        json.dumps(conf))).init()


def _grads(net, jnet, x, y):
    """First-step gradients at the same parameters, lists of {name:
    numpy}: (the port's in bf16, JAX's in bf16, JAX's in float32)."""
    def jax_grads(model):
        g = jax.grad(lambda p: model._loss_fn(
            p, model.state, jnp.asarray(x), jnp.asarray(y), None)[0])(
            jnet.params)
        return [{k: np.asarray(v) for k, v in d.items()} for d in g]

    params = tuple({k: v.clone().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, _ = net._loss_fn(params, net.state, torch.from_numpy(x),
                            torch.from_numpy(y), None)
    got = iter(torch.autograd.grad(score, [v for p in params
                                           for v in p.values()]))
    port = [{k: next(got).numpy() for k in p} for p in params]
    return port, jax_grads(jnet), jax_grads(_float32_twin(jnet))


def _grad_gaps(port, ref, f32):
    """Per tensor, relative L2: {"f32": the largest gap of the port's bf16
    gradients to JAX's float32 ones, "jax": the largest gap to JAX's bf16
    ones less JAX's own bf16-to-float32 gap, "b_k": the largest key-bias
    gradient over its W_k's largest entry (either package)}."""
    rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    gaps = {"f32": 0.0, "jax": 0.0, "b_k": 0.0}
    for g, w, f in zip(port, ref, f32):
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32, k
            if k == "b_k":
                scale = np.abs(w["W_k"]).max()
                gaps["b_k"] = max(gaps["b_k"], np.abs(g[k]).max() / scale,
                                  np.abs(w[k]).max() / scale)
                continue
            gaps["f32"] = max(gaps["f32"], rel(g[k], f[k]))
            gaps["jax"] = max(gaps["jax"], rel(g[k], w[k]) - rel(w[k], f[k]))
    return gaps


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))


def _fit_gaps(model):
    """STEPS Adam steps of the JAX network and its port twin on one
    iterator: {"score": max abs gap, "param": largest relative L2 gap of a
    weight matrix, "vector": largest entry gap of a vector over Adam's
    reach (2 lr per step)}, and the port's scores."""
    make, data, lr = MODELS[model]
    jnet = make(seed=8)
    net = _twin(jnet)
    x, y = data(4 * STEPS, seed=9)
    jl, pl = _Scores(), _Scores()
    jnet.set_listeners(jl)
    net.set_listeners(pl)
    kw = dict(batch_size=4, shuffle=True, seed=10)
    jnet.fit(JaxArrayIterator(x, y, **kw))
    net.fit(ArrayDataSetIterator(x, y, **kw))
    assert len(pl.scores) == len(jl.scores) == STEPS
    gaps = {"score": float(np.abs(np.subtract(pl.scores, jl.scores)).max()),
            "param": 0.0, "vector": 0.0}
    for p, jp in zip(net.params, jnet.params):
        for k in jp:
            a, b = p[k].numpy(), np.asarray(jp[k])
            assert p[k].dtype == torch.float32, k
            if b.ndim == 1:
                gaps["vector"] = max(gaps["vector"], np.abs(a - b).max()
                                     / (2 * lr * STEPS))
                continue
            gaps["param"] = max(gaps["param"],
                                np.linalg.norm(a - b) / np.linalg.norm(b))
    return gaps, pl.scores


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_lm_output_matches_jax(flash):
    """JAX with its plain attention, and with its Pallas forward in
    interpret mode (`flash = True`); the port's plain attention."""
    jnet = _jax_lm(seed=3, flash=flash)
    net = _twin(jnet)
    assert net._compute_dtype == torch.bfloat16
    x, _ = _lm_data(3, seed=1)
    got, want = net.output(x).numpy(), np.asarray(jnet.output(x))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16["out"])
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["lm", "char_rnn"])
def test_bf16_first_step_gradients_match_jax(model):
    make, data, _ = MODELS[model]
    jnet = make(seed=4)
    net = _twin(jnet)
    x, y = data(4, seed=2)
    gaps = _grad_gaps(*_grads(net, jnet, x, y))
    assert gaps["f32"] <= BF16["grad"], gaps
    assert gaps["jax"] <= BF16["grad"], gaps
    assert gaps["b_k"] <= BF16["grad"], gaps


@pytest.mark.parametrize("model", ["lm", "char_rnn"])
def test_bf16_five_adam_steps_match_jax(model):
    attention.reset_launches()
    lstm.reset_launches()
    gaps, scores = _fit_gaps(model)
    assert gaps["score"] <= BF16["score"], gaps
    assert gaps["param"] <= BF16["param_l2"], gaps
    assert gaps["vector"] <= 1.0 + 1e-6, gaps   # within Adam's reach
    assert np.isfinite(scores).all() and scores[-1] < scores[0], scores
    # the CPU takes the plain versions: no launch
    assert set(attention.launch_counts().values()) == {0}
    assert set(lstm.launch_counts().values()) == {0}


def test_bf16_char_rnn_output_and_time_steps_match_jax():
    jnet = _jax_rnn(seed=5)
    net = _twin(jnet)
    x, _ = _rnn_data(3, seed=3)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=BF16["out"])
    for t in range(3):
        got = net.rnn_time_step(x[:, t]).numpy()
        want = np.asarray(jnet.rnn_time_step(x[:, t]))
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16["out"],
                                   err_msg=f"step {t}")


if __name__ == "__main__":
    for flash in (False, True):
        jnet = _jax_lm(seed=3, flash=flash)
        x, _ = _lm_data(3, seed=1)
        gap = np.abs(_twin(jnet).output(x).numpy()
                     - np.asarray(jnet.output(x))).max()
        print(f"LM output, JAX flash={flash}: {gap:.3e}")
    for model in MODELS:
        make, data, _ = MODELS[model]
        jnet = make(seed=4)
        x, y = data(4, seed=2)
        print(f"{model} first-step gradients:",
              _grad_gaps(*_grads(_twin(jnet), jnet, x, y)))
        print(f"{model} after {STEPS} Adam steps:", _fit_gaps(model)[0])
