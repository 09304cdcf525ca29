"""PyTorch port, the convolutional slice as a whole, on the CPU against the
JAX package: LeNet-MNIST (BASELINE config 1: conv 5x5x20, max pool, conv
5x5x50, max pool, Dense 500, softmax 10; Nesterovs 0.01 / 0.9, l2 5e-4),
VGG-16 / VGG-19 and AlexNet, built from the JAX package's JSON, parameters
crossing through `from_jax_params` or the zip, the same numpy batches on
both sides.

  * the JSON of `lenet_mnist()`, `vgg16(n_classes=3, image=32)` and
    `alexnet(n_classes=5, image=64)` builds in the port and serialises back
    to the same text; the port's zoo builders write it too;
  * LeNet's forward (1e-5), first-step gradients (1e-5 of each tensor's
    largest entry), one SGD and one Adam step (1e-5), a 20-step Nesterovs +
    l2 `fit` trajectory on the 320 bundled digits, batch 128 shuffled with
    drop_last (scores and parameters 1e-4, the parity gate's trajectory
    bound), `evaluate` on the 64 held-out digits, the zip with its updater
    state both ways and one more step after it;
  * VGG-19 at image 32 with 3 classes and AlexNet at image 64 with 5 classes
    (dropout stripped from the config, as the comparison needs the same
    random draws): forward and first-step gradients (1e-5 of each tensor's
    largest entry: f32 sums of up to 4608 terms per output over 16 conv
    layers);
  * LeNet and AlexNet zips registered, warmed and served through the
    batcher and over HTTP, against JAX's output on the same zip (1e-5);
  * a CNN with a 4-D BatchNormalization in bf16 compute (the "fused" tier);
  * input-shape errors with JAX's words, and the default device.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fetchers import \
    bundled_mnist_subset as jax_bundled_mnist_subset
from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.datasets.iterators import DataSet as JaxDataSet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JaxMultiLayerConfiguration
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JaxSub
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (InferenceServer, ModelRegistry,
                                      ModelSerializer, MultiLayerNetwork,
                                      bundled_mnist_subset, from_jax_params)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

STEP_TOL, TRAJ_TOL = 1e-5, 1e-4
BF16_GRAD = 2e-2

ZOO = [("lenet_mnist", {}), ("vgg16", {"n_classes": 3, "image": 32}),
       ("alexnet", {"n_classes": 5, "image": 64})]



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side of each comparison: the
    suite runs in parallel workers, and torch's default of one thread per
    core in each of them oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


def _digits():
    x, y, xt, yt = bundled_mnist_subset()
    return x, y, xt, yt


def _jax_lenet(updater=None):
    return jax_zoo.lenet_mnist(updater=updater).init()


def _port_grads(net, x, y):
    params = tuple({k: v.detach().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, _ = net._loss_fn(params, net.state, net._as_input(x),
                            net._as_input(y))
    leaves = [v for p in params for v in p.values()]
    flat = iter(torch.autograd.grad(score, leaves))
    return score, [{k: next(flat) for k in p} for p in params]


def _check_grads(grads, jgrads, tol):
    """Per tensor, |port - JAX| <= tol x the tensor's largest JAX entry."""
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert set(g) == set(jg), i
        for k in jg:
            want = np.asarray(jg[k])
            np.testing.assert_allclose(
                g[k].numpy(), want, rtol=0,
                atol=tol * max(np.abs(want).max(), 1e-30),
                err_msg=f"layer {i} {k}")


def _check_first_step(jnet, net, x, y, tol=STEP_TOL, jit=True):
    """JAX's score and gradients (jitted, or op by op where bf16 compute
    must round after every op as the port does) against the port's."""
    grad = jax.value_and_grad(lambda p: jnet._loss_fn(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None)[0])
    jscore, jgrads = (jax.jit(grad) if jit else grad)(jnet.params)
    score, grads = _port_grads(net, x, y)
    assert abs(float(score.detach()) - float(jscore)) <= tol
    _check_grads(grads, jgrads, tol)


def _check_params(net, jnet, tol):
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=tol,
                                       err_msg=f"layer {i} {k}")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_json_builds_in_the_port_and_reemits_equal(name, kw):
    jax_json = getattr(jax_zoo, name)(**kw).conf.to_json()
    conf = MultiLayerConfiguration.from_json(jax_json)
    assert conf.to_json() == jax_json
    assert getattr(zoo, name)(device="cpu", **kw).conf.to_json() == jax_json
    assert conf.preprocessors      # an inferred CNN -> FF adapter at least


@pytest.mark.parametrize("name,kw,count", [
    ("lenet_mnist", {}, 431_080), ("vgg16", {}, 138_357_544),
    ("vgg19", {"n_classes": 3, "image": 32}, None),
    ("alexnet", {}, 62_378_344)])
def test_zoo_parameter_shapes_match_jax(name, kw, count):
    """Every parameter's shape as JAX's (HWIO conv weights), from the input
    types the port carries through the preprocessors; the full-size counts
    of `chip_smoke.py`'s networks."""
    jnet = getattr(jax_zoo, name)(**kw)
    net = getattr(zoo, name)(device="cpu", **kw)
    its = [JaxInputType.from_dict(t.to_dict()) for t in _input_types(net)]
    want = [{k: tuple(v.shape) for k, v in
             jax.eval_shape(lambda: l.init_params(jax.random.PRNGKey(0),
                                                  it)).items()}
            for l, it in zip(jnet.layers, its)]
    with torch.device("meta"):      # shapes only: nothing is drawn
        got = [{k: tuple(v.shape) for k, v in
                l.init_params(torch.Generator(), it, "meta").items()}
               for l, it in zip(net.layers, _input_types(net))]
    assert got == want
    if count is not None:
        assert sum(int(np.prod(s)) for p in got for s in p.values()) == count


def _input_types(net):
    """Each layer's input type, as `init` carries it (without drawing
    weights)."""
    it, out = net.conf.input_type, []
    for i, layer in enumerate(net.layers):
        if i in net.conf.preprocessors:
            it = net.conf.preprocessors[i].output_type(it)
        out.append(it)
        it = layer.output_type(it)
    return out


def test_input_shape_errors_match_jax():
    jnet = _jax_lenet()
    net = _twin(jnet)
    for bad in (np.zeros((2, 783), np.float32),):
        with pytest.raises(ValueError) as jerr:
            jnet._check_input_width(jnp.asarray(bad))
        with pytest.raises(ValueError) as err:
            net.output(bad)
        assert str(err.value) == str(jerr.value)
    jv = jax_zoo.vgg16(n_classes=3, image=32)
    v = zoo.vgg16(n_classes=3, image=32, device="cpu")
    bad = np.zeros((1, 32, 31, 3), np.float32)
    with pytest.raises(ValueError) as jerr:
        jv._check_input_width(jnp.asarray(bad))
    with pytest.raises(ValueError) as err:
        v._check_input_width(torch.tensor(bad))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["lenet_mnist", "vgg16", "vgg19",
                                  "alexnet"])
def test_zoo_builders_default_to_the_gpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(zoo, name)()


# ---------------------------------------------------------------------------
# LeNet training against JAX
# ---------------------------------------------------------------------------
def test_lenet_forward_and_first_step_gradients_match_jax():
    jnet = _jax_lenet()
    net = _twin(jnet)
    x, y, _, _ = _digits()
    x, y = x[:64], y[:64]
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=STEP_TOL)
    acts, jacts = net.feed_forward(x[:4]), jnet.feed_forward(x[:4])
    assert [tuple(a.shape) for a in acts] == [a.shape for a in jacts]
    for a, ja in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0,
                                   atol=STEP_TOL)
    _check_first_step(jnet, net, x, y)
    np.testing.assert_allclose(net.score_examples(DataSet(x, y)),
                               np.asarray(jnet.score_examples(
                                   JaxDataSet(x, y))), rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_lenet_one_step_matches_jax(updater):
    make = {"sgd": lambda u: u.Sgd(0.1), "adam": lambda u: u.Adam(1e-3)}
    jnet = _jax_lenet(make[updater](jax_updaters))
    net = _twin(jnet)
    x, y, _, _ = _digits()
    x, y = x[:32], y[:32]
    jnet.fit(x, y)
    net.fit(x, y)
    assert abs(float(net.score()) - float(jnet.score())) <= STEP_TOL
    _check_params(net, jnet, STEP_TOL)


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))


def _lenet_trajectory():
    """20 Nesterovs steps (lr 0.01, momentum 0.9, l2 5e-4) of JAX's LeNet
    and its port twin over one iterator of the 320 bundled digits: batch
    128, shuffled, drop_last, ten epochs (the run `chip_smoke.py` makes on
    the card)."""
    jnet = _jax_lenet()
    net = _twin(jnet)
    x, y, _, _ = _digits()
    kw = dict(batch_size=128, shuffle=True, seed=13, drop_last=True)
    jlog, log = _Scores(), _Scores()
    jnet.set_listeners(jlog)
    net.set_listeners(log)
    jnet.fit(JaxArrayIterator(x, y, **kw), epochs=10)
    net.fit(ArrayDataSetIterator(x, y, **kw), epochs=10)
    assert len(log.scores) == len(jlog.scores) == 20
    return net, jnet, log, jlog


@pytest.fixture(scope="module")
def trajectory():
    return _lenet_trajectory()


def test_lenet_twenty_step_nesterovs_trajectory_matches_jax(trajectory):
    net, jnet, log, jlog = trajectory
    assert log.scores[-1] < log.scores[0]
    np.testing.assert_allclose(log.scores, jlog.scores, rtol=0,
                               atol=TRAJ_TOL)
    _check_params(net, jnet, TRAJ_TOL)
    for i, (u, ju) in enumerate(zip(net.updater_state, jnet.updater_state)):
        for k in ju["v"]:      # Nesterovs' velocity
            np.testing.assert_allclose(u["v"][k].numpy(),
                                       np.asarray(ju["v"][k]), rtol=0,
                                       atol=TRAJ_TOL, err_msg=f"{i} v {k}")


def test_lenet_evaluate_matches_jax(trajectory):
    net, jnet, _, _ = trajectory
    _, _, xt, yt = _digits()
    ev = net.evaluate(ArrayDataSetIterator(xt, yt, batch_size=32))
    jev = jnet.evaluate(JaxArrayIterator(xt, yt, batch_size=32))
    assert ev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(ev.confusion.matrix, jev.confusion.matrix)
    for got, want in zip(bundled_mnist_subset(), jax_bundled_mnist_subset()):
        np.testing.assert_array_equal(got, want)


def test_lenet_zip_both_ways_then_one_more_step(trajectory, tmp_path):
    """The trained port LeNet's zip (with Nesterovs' velocity) restores in
    JAX, JAX's zip of it restores in the port, and one more step on each
    side agrees."""
    net, _, _, _ = trajectory
    path, jpath = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    ModelSerializer.write_model(net, path)
    jnet = JaxModelSerializer.restore(path, load_updater=True)
    JaxModelSerializer.write_model(jnet, jpath)
    back = ModelSerializer.restore(jpath, device="cpu")
    assert back.conf.to_json() == net.conf.to_json()
    _check_params(back, jnet, 0.0)
    assert back.iteration_count == jnet.iteration_count == 20
    x, y, _, _ = _digits()
    jnet.fit(x[:128], y[:128])
    back.fit(x[:128], y[:128])
    assert abs(float(back.score()) - float(jnet.score())) <= STEP_TOL
    _check_params(back, jnet, STEP_TOL)


# ---------------------------------------------------------------------------
# VGG-19 and AlexNet against JAX
# ---------------------------------------------------------------------------
def _without_dropout(jnet):
    d = json.loads(jnet.conf.to_json())
    for layer in d["layers"]:
        layer["__layer__"]["fields"]["dropout"] = None
    return JaxMultiLayerNetwork(
        JaxMultiLayerConfiguration.from_json(json.dumps(d))).init()


@pytest.mark.parametrize("name,kw,batch", [
    ("vgg19", {"n_classes": 3, "image": 32}, 2),
    ("alexnet", {"n_classes": 5, "image": 64}, 3)])
def test_vgg19_and_alexnet_forward_and_gradients_match_jax(name, kw, batch):
    jnet = _without_dropout(getattr(jax_zoo, name)(**kw))
    net = _twin(jnet)
    assert len(net.layers) == (24 if name == "vgg19" else 13)
    r = np.random.default_rng(3)
    image = kw["image"]
    x = r.normal(size=(batch, image, image, 3)).astype(np.float32)
    y = np.eye(kw["n_classes"], dtype=np.float32)[
        r.integers(0, kw["n_classes"], batch)]
    out = net.output(x).numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), rtol=0,
                               atol=STEP_TOL)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    _check_first_step(jnet, net, x, y)


def test_cnn_bf16_batchnorm_takes_the_fused_tier():
    """Conv (no bias: BN's batch mean would leave it a gradient of rounding
    noise only) -> 4-D BatchNormalization(relu) -> pool -> softmax in bf16
    compute: the BN layer's tier is "fused" on both sides, and the first
    step's gradients agree at the bf16 limit (2e-2 of each tensor's largest
    entry)."""
    conf = (JaxNNC.builder().seed(5).compute_dtype("bfloat16")
            .updater(jax_updaters.Sgd(0.1)).list()
            .layer(JaxConv(n_out=8, kernel_size=(3, 3), has_bias=False,
                           convolution_mode="same", activation="identity"))
            .layer(JaxBN(activation="relu"))
            .layer(JaxSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(8, 8, 3)).build())
    jnet = JaxMultiLayerNetwork(conf).init()
    net = _twin(jnet)
    xb = torch.zeros(4, 8, 8, 8, dtype=torch.bfloat16)
    assert net.layers[1]._helper(xb, True) == "fused"
    assert jnet.layers[1]._helper(jnp.zeros((4, 8, 8, 8), jnp.bfloat16),
                                  True) == "fused"
    r = np.random.default_rng(8)
    x = r.normal(size=(16, 8, 8, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 16)]
    _check_first_step(jnet, net, x, y, tol=BF16_GRAD, jit=False)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _http(method, url, body):
    import urllib.request
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"},
                                 method=method)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("name,kw,shape", [
    ("lenet_mnist", {}, (784,)),
    ("alexnet", {"n_classes": 5, "image": 64}, (64, 64, 3))])
def test_cnn_zip_serves_like_jax(name, kw, shape, tmp_path):
    """A JAX zip registers (one warm-up forward per bucket), and answers
    direct, batched and unbatched HTTP requests as JAX's network does."""
    jnet = getattr(jax_zoo, name)(**kw).init()
    path = str(tmp_path / f"{name}.zip")
    JaxModelSerializer.write_model(jnet, path)
    srv = InferenceServer(registry=ModelRegistry(buckets=(1, 8),
                                                 device="cpu"),
                          port=0).start()
    try:
        v = srv.registry.register("m", path)
        assert v.example_shape == shape and v.forwards == 2
        r = np.random.default_rng(4)
        for rows, batched in ((1, True), (5, True), (3, False)):
            x = r.normal(size=(rows,) + shape).astype(np.float32)
            want = np.asarray(jnet.output(x))
            code, out = _http("POST", f"http://{srv.host}:{srv.port}"
                              "/v1/models/m/predict",
                              {"features": x.tolist(), "batched": batched})
            assert code == 200
            np.testing.assert_allclose(np.asarray(out["output"]), want,
                                       rtol=0, atol=STEP_TOL)
        got, _ = srv.registry.predict("m", x)
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL)
    finally:
        srv.stop()


def _cpu_rounding_gaps():
    """Per-tensor relative L2 gaps of LeNet's 20-step trajectory on the CPU
    against itself: at 1 and 4 threads (another summation order), and in
    float32 against float64. They bound how closely any other device can
    follow the CPU (the chip run's LeNet limits)."""
    x, y, _, _ = _digits()

    def run(threads, dtype):
        torch.set_num_threads(threads)
        net = zoo.lenet_mnist(device="cpu").init(
            generator=torch.Generator().manual_seed(7))
        net.conf.conf.dtype = str(dtype).split(".")[-1]
        net.params = tuple({k: v.to(dtype) for k, v in p.items()}
                           for p in net.params)
        net.updater_state = tuple(
            {s: {k: v.to(dtype) for k, v in d.items()} for s, d in u.items()}
            for u in net.updater_state)
        net.fit(ArrayDataSetIterator(x, y, batch_size=128, shuffle=True,
                                     seed=13, drop_last=True), epochs=10)
        return net

    f32_1, f32_4 = run(1, torch.float32), run(4, torch.float32)
    f64 = run(4, torch.float64)
    for what, (a, b) in (("1 vs 4 threads", (f32_1, f32_4)),
                         ("float32 vs float64", (f32_4, f64))):
        gaps = {f"{i}/{k}": float((p[k].double() - q[k].double()).norm()
                                  / q[k].double().norm())
                for i, (p, q) in enumerate(zip(a.params, b.params))
                for k in q}
        print(what + ": " + ", ".join(f"{k} {v:.2e}"
                                      for k, v in gaps.items()))


if __name__ == "__main__":
    _cpu_rounding_gaps()
