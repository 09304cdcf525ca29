"""PyTorch port, layerwise pretraining on the CPU against the JAX package:
AutoEncoder, RBM (CD-k), VariationalAutoencoder with its four
reconstruction distributions, CenterLossOutputLayer, and
`MultiLayerNetwork.pretrain` / `pretrain_layer` / `fit` on a pretrain=True
configuration / `reconstruction_log_probability`; the twins of the JAX
package's `tests/test_generative.py`.

Stochastic steps are compared exactly: the port draws every corruption
mask, Gibbs sample and reparameterization through `nn.noise.draw`, and
these tests replace it with a function that returns the draws the JAX
layer makes from the same key (the network's key split per step as JAX's
`pretrain_layer` splits it; `jax.random.bernoulli(key, p)` is
`uniform(key) < p`, and the port compares the same uniform with p). With
the same noise both packages run the same arithmetic, so the parity gate's
float32 tolerances apply: one step 1e-5, several steps 1e-4 (absolute, on
parameters of order 0.1-1 and scores of order 1-10, relative where a
score is in the hundreds). The port's own generator (whose stream is not
jax.random's) is checked by what pretraining achieves, as JAX's tests
check theirs.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JaxMultiLayerConfiguration
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import generative as jgen
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration,
                                      from_jax_params)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn import noise
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    RBM, AutoEncoder, BernoulliReconstructionDistribution,
    CenterLossOutputLayer, CompositeReconstructionDistribution,
    GaussianReconstructionDistribution, LossFunctionWrapper,
    VariationalAutoencoder)
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.util.gradient_check import GradientCheckUtil
from jax_reference import jax_init
from torch_threads import one_torch_thread  # noqa: F401

D, N = 12, 40
STEP_TOL, TRAJ_TOL = 1e-5, 1e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _blobs(n=N, d=D, seed=0):
    return (np.random.default_rng(seed).random((n, d)) > 0.5).astype(
        np.float32)


def _pair(layers, updater, pretrain=True, backprop=False, n_in=D):
    b = JaxNNC.builder().seed(3).updater(updater).list()
    for layer in layers:
        b = b.layer(layer)
    jconf = (b.set_input_type(JaxInputType.feed_forward(n_in))
             .pretrain(pretrain).backprop(backprop).build())
    jnet = jax_init(JaxMultiLayerNetwork(jconf))
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    return jnet, from_jax_params(net, _np_tree(jnet.params),
                                 _np_tree(jnet.updater_state))


class JaxDraws:
    """Replays, in the port's call order, the noise the JAX package draws
    while pretraining `jnet` on batches of the given sizes (its network
    key split once a step, the step key split once more, the layer's key
    as `pretrain_value_and_grad` splits it)."""

    def __init__(self, rng):
        self.rng, self.queue = rng, []

    def step_key(self):
        self.rng, r = jax.random.split(self.rng)
        return jax.random.split(r)[1]

    def plan(self, layer, rows, steps_of_layer):
        for b in rows * steps_of_layer:
            key = self.step_key()
            if isinstance(layer, jgen.AutoEncoder):
                c = layer.corruption_level
                if c > 0:
                    self.queue.append(jax.random.uniform(
                        key, (b, layer.n_in), lax.dtype(1.0 - c)))
            elif isinstance(layer, jgen.RBM):
                keys = jax.random.split(key, layer.k + 1)
                if layer.hidden_unit == "binary":
                    self.queue.append(jax.random.uniform(
                        keys[0], (b, layer.n_out), jnp.float32))
                for i in range(layer.k):
                    if layer.visible_unit == "binary":
                        self.queue.append(jax.random.uniform(
                            keys[i + 1], (b, layer.n_in), jnp.float32))
            elif isinstance(layer, jgen.VariationalAutoencoder):
                for k in jax.random.split(key, layer.num_samples):
                    self.queue.append(jax.random.normal(
                        k, (b, layer.n_out), jnp.float32))

    def draw(self, kind, shape, generator, dtype, device):
        got = np.asarray(self.queue.pop(0))
        assert got.shape == tuple(shape), (got.shape, shape)
        return torch.as_tensor(got)


def _replay(monkeypatch, jnet, rows, epochs=1):
    """Queue the JAX draws of `pretrain(epochs)` over batches of `rows`
    and route the port's draws to them."""
    d = JaxDraws(jnet._rng)
    for layer in jnet.layers:
        if getattr(layer, "is_pretrainable", False):
            d.plan(layer, rows, epochs)
    monkeypatch.setattr(noise, "draw", d.draw)
    return d


def _close_params(net, jnet, atol, msg=""):
    from deeplearning4j_tpu_torch.nn.trees import leaf_paths
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for path, v in leaf_paths(p):
            want = jp
            for k in path.split("/"):
                want = want[k]
            np.testing.assert_allclose(v.numpy(), np.asarray(want), rtol=0,
                                       atol=atol, err_msg=f"{msg} {i}/{path}")


# ---------------------------------------------------------------------------
# pretraining against JAX under the same noise
# ---------------------------------------------------------------------------
AE_CASES = [
    ("corruption 0", dict(corruption_level=0.0)),
    ("corruption 0.3", dict(corruption_level=0.3)),
    ("sparsity", dict(corruption_level=0.2, sparsity=0.05)),
    ("xent", dict(corruption_level=0.0, pretrain_loss="xent"))]


@pytest.mark.parametrize("name,kw", AE_CASES, ids=[c[0] for c in AE_CASES])
def test_autoencoder_pretraining_matches_jax(monkeypatch, name, kw):
    jnet, net = _pair([jgen.AutoEncoder(n_out=8, **kw)],
                      jax_updaters.Adam(1e-2))
    x = _blobs()
    _replay(monkeypatch, jnet, [16, 16, 8], epochs=2)
    jnet.pretrain(JaxArrayIterator(x, x, batch_size=16), epochs=2)
    net.pretrain(ArrayDataSetIterator(x, x, batch_size=16), epochs=2)
    # six Adam steps; at corruption 0 there is no noise, and the run is
    # held to the one-step tolerance all the same
    tol = STEP_TOL if kw["corruption_level"] == 0 else TRAJ_TOL
    assert abs(float(net._score) - float(jnet._score)) <= tol
    _close_params(net, jnet, tol, name)
    for a, b in zip(net.updater_state[0]["m"].values(),
                    jnet.updater_state[0]["m"].values()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol)


RBM_CASES = [
    ("binary k1", dict()),
    ("binary k2", dict(k=2)),
    ("gaussian visible", dict(visible_unit="gaussian")),
    ("rectified hidden", dict(hidden_unit="rectified")),
    ("gaussian hidden", dict(hidden_unit="gaussian"))]


@pytest.mark.parametrize("name,kw", RBM_CASES, ids=[c[0] for c in RBM_CASES])
def test_rbm_cd_k_matches_jax(monkeypatch, name, kw):
    jnet, net = _pair([jgen.RBM(n_out=7, **kw), jgen.RBM(n_out=5)],
                      jax_updaters.Sgd(0.05))
    x = _blobs()
    _replay(monkeypatch, jnet, [20, 20])
    jnet.pretrain(JaxArrayIterator(x, x, batch_size=20))
    net.pretrain(ArrayDataSetIterator(x, x, batch_size=20))
    assert abs(float(net._score) - float(jnet._score)) <= STEP_TOL
    _close_params(net, jnet, STEP_TOL, name)


def _vae(dist, **kw):
    return jgen.VariationalAutoencoder(
        n_out=3, encoder_layer_sizes=(10, 9), decoder_layer_sizes=(9,),
        reconstruction_distribution=dist, activation="tanh", **kw)


VAE_CASES = [
    ("bernoulli", lambda: jgen.BernoulliReconstructionDistribution(), {}),
    ("gaussian", lambda: jgen.GaussianReconstructionDistribution(
        activation="tanh"), {}),
    ("composite", lambda: jgen.CompositeReconstructionDistribution(
        sizes=[6, 6], dists=[jgen.BernoulliReconstructionDistribution(),
                             jgen.GaussianReconstructionDistribution()]), {}),
    ("loss wrapper", lambda: jgen.LossFunctionWrapper(
        loss="mse", activation="sigmoid"), {"num_samples": 2}),
    ("pzx tanh", lambda: jgen.BernoulliReconstructionDistribution(),
     {"pzx_activation": "tanh", "num_samples": 3})]


@pytest.mark.parametrize("name,dist,kw", VAE_CASES,
                         ids=[c[0] for c in VAE_CASES])
def test_vae_pretraining_matches_jax(monkeypatch, name, dist, kw):
    jnet, net = _pair([_vae(dist(), **kw)], jax_updaters.RmsProp(1e-2))
    x = _blobs()
    _replay(monkeypatch, jnet, [16, 16, 8])
    jnet.pretrain(JaxArrayIterator(x, x, batch_size=16))
    net.pretrain(ArrayDataSetIterator(x, x, batch_size=16))
    s, js = float(net._score), float(jnet._score)
    assert abs(s - js) <= STEP_TOL * max(1.0, abs(js))
    _close_params(net, jnet, STEP_TOL, name)


def test_fit_on_a_pretrain_config_pretrains_then_trains_as_jax(monkeypatch):
    """`fit(iterator)` with pretrain=True runs `pretrain` once (JAX
    `fit`), then backprop over the same iterator: an AutoEncoder and an
    RBM under a softmax output, Adam."""
    jnet, net = _pair([jgen.AutoEncoder(n_out=8, corruption_level=0.2),
                       jgen.RBM(n_out=6),
                       JaxOutput(n_out=3, activation="softmax",
                                 loss="mcxent")],
                      jax_updaters.Adam(1e-2), backprop=True)
    x = _blobs()
    y = np.eye(3, dtype=np.float32)[np.arange(N) % 3]
    _replay(monkeypatch, jnet, [16, 16, 8])
    jnet.fit(JaxArrayIterator(x, y, batch_size=16), epochs=2)
    net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    assert net.iteration_count == jnet.iteration_count == 6
    assert abs(net.score() - float(jnet.score())) <= TRAJ_TOL
    _close_params(net, jnet, TRAJ_TOL, "fit")
    # pretraining ran once: a second fit only trains
    before = [p.clone() for p in net.params[0].values()]
    net.fit(ArrayDataSetIterator(x, y, batch_size=40))
    assert net._pretrained and net.iteration_count == 7
    assert not all(torch.equal(a, b) for a, b in zip(
        before, net.params[0].values()))


def test_pretrain_layer_keeps_the_layer_updater_state(monkeypatch):
    jnet, net = _pair([jgen.AutoEncoder(n_out=8, corruption_level=0.0)],
                      jax_updaters.Adam(1e-2))
    x = _blobs()
    net.pretrain_layer(0, ArrayDataSetIterator(x, x, batch_size=20))
    jnet.pretrain_layer(0, JaxArrayIterator(x, x, batch_size=20))
    for key in ("m", "v"):
        for k, v in jnet.updater_state[0][key].items():
            np.testing.assert_allclose(
                net.updater_state[0][key][k].numpy(), np.asarray(v), rtol=0,
                atol=STEP_TOL)
    # a layer that does not pretrain is left alone
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer
    dense = _net(DenseLayer(n_out=4), updater=Sgd(0.1))
    before = dense.params_flat()
    assert dense.pretrain_layer(0, ArrayDataSetIterator(x, x)) is dense
    np.testing.assert_array_equal(dense.params_flat(), before)


@pytest.mark.parametrize("seed", [0, 3])
def test_reconstruction_log_probability_matches_jax(monkeypatch, seed):
    jnet, net = _pair([_vae(jgen.BernoulliReconstructionDistribution())],
                      jax_updaters.Sgd(0.1))
    x = _blobs(10)
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    queue = [jax.random.normal(k, (10, 3), jnp.float32) for k in keys]
    monkeypatch.setattr(noise, "draw", lambda *a: torch.as_tensor(
        np.asarray(queue.pop(0))))
    got = net.reconstruction_log_probability(x, num_samples=4, seed=seed)
    want = np.asarray(jnet.reconstruction_log_probability(
        x, num_samples=4, seed=seed))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    queue[:] = [jax.random.normal(k, (10, 3), jnp.float32) for k in keys]
    np.testing.assert_allclose(
        net.reconstruction_probability(x, num_samples=4, seed=seed),
        np.exp(want), rtol=1e-4, atol=0)


def test_reconstruction_log_probability_needs_a_leading_vae():
    _, net = _pair([jgen.AutoEncoder(n_out=4)], jax_updaters.Sgd(0.1))
    with pytest.raises(ValueError, match="VariationalAutoencoder"):
        net.reconstruction_log_probability(_blobs(3))


def test_generate_at_mean_given_z_and_apply_match_jax():
    layer = _vae(jgen.CompositeReconstructionDistribution(
        sizes=[6, 6], dists=[jgen.BernoulliReconstructionDistribution(),
                             jgen.GaussianReconstructionDistribution()]),
        n_in=D)
    params = layer.init_params(jax.random.PRNGKey(0),
                               JaxInputType.feed_forward(D))
    port = _port_layer(layer)
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    z = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        port.generate_at_mean_given_z(tp, torch.as_tensor(z)).numpy(),
        np.asarray(layer.generate_at_mean_given_z(params, jnp.asarray(z))),
        rtol=0, atol=1e-6)
    x = _blobs(5)
    np.testing.assert_allclose(
        port.apply(tp, {}, torch.as_tensor(x))[0].numpy(),
        np.asarray(layer.apply(params, {}, jnp.asarray(x))[0]), rtol=0,
        atol=1e-6)


def _port_layer(jlayer):
    from deeplearning4j_tpu.nn.conf.base import conf_to_dict as jax_to_dict
    from deeplearning4j_tpu_torch.nn.conf.base import conf_from_dict
    return conf_from_dict(json.loads(json.dumps(jax_to_dict(jlayer))))


def test_center_loss_step_matches_jax():
    b = JaxNNC.builder().seed(5).updater(jax_updaters.Sgd(0.1)).l2(1e-3)
    jconf = (b.list().layer(JaxDense(n_out=6, activation="tanh"))
             .layer(jgen.CenterLossOutputLayer(
                 n_out=3, activation="softmax", loss="mcxent", lambda_=0.05,
                 alpha=0.3))
             .set_input_type(JaxInputType.feed_forward(5)).build())
    jnet = jax_init(JaxMultiLayerNetwork(jconf))
    net = from_jax_params(MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init(), _np_tree(jnet.params))
    r = np.random.default_rng(6)
    x = r.normal(size=(9, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 9)]
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    assert abs(net.score() - float(jnet.score())) <= STEP_TOL
    _close_params(net, jnet, STEP_TOL, "center loss")
    assert net.params[1]["centers"].abs().sum() > 0


# ---------------------------------------------------------------------------
# twins of tests/test_generative.py (the port's own generator)
# ---------------------------------------------------------------------------
def _net(*layers, updater, n_in=D):
    b = NeuralNetConfiguration.builder().seed(0).updater(updater).list()
    for layer in layers:
        b = b.layer(layer)
    return MultiLayerNetwork(b.set_input_type(InputType.feed_forward(n_in))
                             .build(), device="cpu").init()


def test_autoencoder_pretrain_reduces_reconstruction():
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    x = _blobs(128)
    m = _net(AutoEncoder(n_out=8, corruption_level=0.0),
             OutputLayer(n_out=2, loss="mcxent"), updater=Adam(1e-2))
    layer, xt = m.layers[0], torch.as_tensor(x)

    def err(p):
        return float(((layer.decode(p, layer.encode(p, xt)) - xt) ** 2)
                     .mean())
    before = err(m.params[0])
    m.pretrain_layer(0, ArrayDataSetIterator(x, np.zeros((128, 2)),
                                             batch_size=32), epochs=60)
    assert err(m.params[0]) < 0.7 * before


def test_rbm_pretrain_reduces_reconstruction():
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    x = _blobs(128)
    m = _net(RBM(n_out=16), OutputLayer(n_out=2, loss="mcxent"),
             updater=Sgd(0.05))
    layer, xt = m.layers[0], torch.as_tensor(x)

    def err(p):
        return float(((layer._prop_down(p, layer._prop_up(p, xt)) - xt) ** 2)
                     .mean())
    before = err(m.params[0])
    m.pretrain_layer(0, ArrayDataSetIterator(x, np.zeros((128, 2)),
                                             batch_size=32), epochs=30)
    assert err(m.params[0]) < before


@pytest.mark.parametrize("dist", [BernoulliReconstructionDistribution,
                                  GaussianReconstructionDistribution])
def test_vae_pretrain_improves_elbo(dist):
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    x = _blobs(64)
    m = _net(VariationalAutoencoder(
        n_out=2, encoder_layer_sizes=(16,), decoder_layer_sizes=(16,),
        reconstruction_distribution=dist()), updater=Adam(1e-2))
    layer = m.layers[0]
    gen = torch.Generator().manual_seed(1)
    before, _ = layer.pretrain_value_and_grad(m.params[0],
                                              torch.as_tensor(x), gen)
    m.pretrain_layer(0, ArrayDataSetIterator(x, x, batch_size=16), epochs=30)
    after, _ = layer.pretrain_value_and_grad(m.params[0],
                                             torch.as_tensor(x), gen)
    assert float(after) < float(before)


def test_vae_and_center_loss_gradient_checks():
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    r = np.random.default_rng(0)
    vae = _net(VariationalAutoencoder(n_out=3, encoder_layer_sizes=(6,),
                                      decoder_layer_sizes=(6,),
                                      activation="tanh"),
               OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
               updater=Sgd(0.1), n_in=5)
    x = r.normal(size=(6, 5))
    y = np.eye(2)[r.integers(0, 2, 6)]
    assert GradientCheckUtil.check_gradients(vae, DataSet(x, y))
    cl = _net(DenseLayer(n_out=6, activation="tanh"),
              CenterLossOutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent", lambda_=0.01, alpha=0.1),
              updater=Sgd(0.1), n_in=5)
    x = r.normal(size=(9, 5))
    y = np.eye(3)[r.integers(0, 3, 9)]
    # the centers' gradient is alpha times the center term's (JAX's form),
    # which the numeric difference of the score does not see: check the
    # rest of the network
    params_ok = GradientCheckUtil.check_gradients(
        _net(DenseLayer(n_out=6, activation="tanh"),
             CenterLossOutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent", lambda_=0.01, alpha=1.0),
             updater=Sgd(0.1), n_in=5), DataSet(x, y))
    assert params_ok
    s0 = cl.score(DataSet(x, y))
    for _ in range(30):
        cl.fit(x, y)
    assert cl.score(DataSet(x, y)) < s0


def test_generative_config_json_crosses_both_codecs():
    jconf = (JaxNNC.builder().seed(0).list()
             .layer(jgen.VariationalAutoencoder(
                 n_out=4, encoder_layer_sizes=(16, 8),
                 decoder_layer_sizes=(8, 16),
                 reconstruction_distribution=
                 jgen.CompositeReconstructionDistribution(
                     sizes=[6, 6],
                     dists=[jgen.BernoulliReconstructionDistribution(),
                            jgen.GaussianReconstructionDistribution()])))
             .layer(jgen.AutoEncoder(n_out=8))
             .layer(jgen.RBM(n_out=4))
             .layer(jgen.CenterLossOutputLayer(n_out=2))
             .set_input_type(JaxInputType.feed_forward(12)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert [type(l) for l in conf.layers] == [
        VariationalAutoencoder, AutoEncoder, RBM, CenterLossOutputLayer]
    d = conf.layers[0].reconstruction_distribution
    assert isinstance(d, CompositeReconstructionDistribution)
    assert isinstance(d.dists[1], GaussianReconstructionDistribution)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = JaxMultiLayerConfiguration.from_json(conf.to_json())
    assert back.to_json() == jconf.to_json()
    assert isinstance(LossFunctionWrapper(), LossFunctionWrapper)


def test_noise_draw_uses_the_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = noise.draw("uniform", (3, 4), g1, torch.float32, "cpu")
    b = noise.draw("uniform", (3, 4), g2, torch.float32, "cpu")
    assert torch.equal(a, b) and float(a.min()) >= 0 and float(a.max()) < 1
    n = noise.draw("normal", (2000,), g1, torch.float64, "cpu")
    assert abs(float(n.mean())) < 0.1 and abs(float(n.std()) - 1) < 0.1
    with pytest.raises(ValueError, match="kind"):
        noise.draw("gamma", (1,), g1, torch.float32, "cpu")
