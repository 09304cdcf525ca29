"""PyTorch port, the bidirectional LSTM slice on the CPU against the JAX
package: GravesBidirectionalLSTM (a nested parameter tree, `{"fwd": {W, b,
peep}, "bwd": {...}}`) and LastTimeStep, through every place that walks a
parameter tree, and the twins of the JAX package's `tests/test_recurrent.py`
and `tests/test_bilstm_subsystems.py` (its parallel case is in
`tests/test_torch_parallel_loop.py`, its `fit_scan` half in
`tests/test_torch_fit_scan.py`).

The same numpy inputs, made from a seed, go through both packages; the
parameters and updater state cross through `from_jax_params` or the zip.
Tolerances, stated per check (the parity gate's defaults):
  * float32 forward: 1e-5 (absolute, on outputs of order 1);
  * first-step gradients and one optimizer step: 1e-5 (float32 sums
    through 7 LSTM steps in another order);
  * a 20-step trajectory: 1e-4;
  * the float64 gradient check: the reference's relative error 1e-3 past
    an absolute 1e-8.

Where the JAX package fails (a BiLSTM with l1 / l2 raises a TypeError in
its `reg_score`; TBPTT and `rnn_time_step` raise an AttributeError), the
port implements the documented behaviour: the penalty of a BiLSTM is its
two directions' GravesLSTM penalties summed, and the carry-bearing paths
raise a named ValueError.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.iterators import \
    ArrayDataSetIterator as JaxArrayIterator
from deeplearning4j_tpu.nn import gradnorm as jax_gradnorm
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import \
    MultiLayerConfiguration as JaxMultiLayerConfiguration
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import (
    GravesBidirectionalLSTM as JaxBiLSTM, GravesLSTM as JaxGravesLSTM,
    LastTimeStep as JaxLastTimeStep, OutputLayer as JaxOutput,
    RnnOutputLayer as JaxRnnOutput)
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (InputType, ModelRegistry,
                                      ModelSerializer, MultiLayerNetwork,
                                      NeuralNetConfiguration,
                                      from_jax_params)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn import gradnorm, updaters
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (GravesBidirectionalLSTM,
                                                GravesLSTM, LastTimeStep,
                                                RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import _rescale_bias_updates
from deeplearning4j_tpu_torch.nn.trees import flat_leaves
from deeplearning4j_tpu_torch.util.gradient_check import (
    GradientCheckUtil, check_gradients_fn)
from jax_reference import jax_init, jax_value_and_grad
from torch_threads import one_torch_thread  # noqa: F401

N_IN, HIDDEN, T, B, CLASSES = 5, 6, 7, 8, 3
FWD_TOL = STEP_TOL = 1e-5
TRAJ_TOL = 1e-4
UPDATERS = [("Sgd", {"learning_rate": 0.1}), ("Adam", {"learning_rate": 1e-2}),
            ("AdaMax", {"learning_rate": 1e-2}),
            ("AdaGrad", {"learning_rate": 0.1}), ("AdaDelta", {}),
            ("RmsProp", {"learning_rate": 1e-2}),
            ("Nesterovs", {"learning_rate": 0.1, "momentum": 0.9}),
            ("NoOp", {})]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _jax_conf(updater=None, head="rnn", **glob):
    b = JaxNNC.builder().seed(4).updater(updater or jax_updaters.Sgd(0.1))
    for k, v in glob.items():
        b = getattr(b, k)(v)
    lb = b.list().layer(JaxBiLSTM(n_out=HIDDEN))
    if head == "rnn":
        lb = lb.layer(JaxRnnOutput(n_out=CLASSES, activation="softmax",
                                   loss="mcxent"))
    else:
        lb = (lb.layer(JaxBiLSTM(n_out=4)).layer(JaxLastTimeStep())
              .layer(JaxOutput(n_out=CLASSES, activation="softmax",
                               loss="mcxent")))
    return lb.set_input_type(JaxInputType.recurrent(N_IN, T)).build()


def _pair(updater=None, head="rnn", **glob):
    """(JAX network, the port's twin from its JSON, parameters and updater
    state)."""
    jnet = jax_init(JaxMultiLayerNetwork(_jax_conf(updater, head, **glob)))
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    return jnet, from_jax_params(net, _np_tree(jnet.params),
                                 _np_tree(jnet.updater_state))


def _data(seed=0, head="rnn", n=B, mask=False):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, T, N_IN)).astype(np.float32)
    shape = (n, T) if head == "rnn" else (n,)
    y = np.eye(CLASSES, dtype=np.float32)[r.integers(0, CLASSES, shape)]
    m = None
    if mask:
        lengths = r.integers(2, T + 1, n)
        m = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return x, y, m


def _tree_close(got, want, atol, msg=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (msg, set(got), set(want))
        for k in want:
            _tree_close(got[k], want[k], atol, f"{msg}/{k}")
        return
    if isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_close(g, w, atol, f"{msg}/{i}")
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=msg)


def _port_grads(net, x, y, fm=None, lm=None):
    from deeplearning4j_tpu_torch.nn.trees import tree_map
    params = tuple(tree_map(lambda v: v.detach().requires_grad_(), p)
                   for p in net.params)
    t = lambda a: None if a is None else torch.as_tensor(a)
    score, _ = net._loss_fn(params, net.state, t(x), t(y), fmask=t(fm),
                            lmask=t(lm))
    leaves = [v for p in params for v in flat_leaves(p)]
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(score, leaves)))
    return float(score.detach()), tuple(
        tree_map(lambda v: by_leaf[id(v)], p) for p in params)


def _jax_grads(jnet, x, y, fm=None, lm=None):
    return jax_value_and_grad(jnet, x, y, fm, lm)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head", ["rnn", "last"])
def test_forward_matches_jax(head, masked):
    jnet, net = _pair(head=head)
    x, _, m = _data(1, head, mask=masked)
    want = np.asarray(jnet.output(x, features_mask=m) if m is not None
                      else jnet.output(x))
    got = net.output(x, features_mask=m).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_output_type_is_twice_n_out_and_json_crosses_both_codecs():
    jconf = _jax_conf(head="last")
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(conf.layers[0], GravesBidirectionalLSTM)
    assert isinstance(conf.layers[2], LastTimeStep)
    it = conf.layers[0].output_type(InputType.recurrent(N_IN, T))
    assert (it.kind, it.size) == ("rnn", 2 * HIDDEN)
    assert conf.layers[1].n_in == 2 * HIDDEN
    back = JaxMultiLayerConfiguration.from_json(conf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    r = np.random.default_rng(2)
    x = r.normal(size=(4, T, 3)).astype(np.float32)
    m = None
    if masked:
        m = np.ones((4, T), np.float32)
        m[0, 3:] = 0
        m[1, :] = 0               # no live step: clamps to step 0
    want, _ = JaxLastTimeStep().apply({}, {}, jnp.asarray(x),
                                      mask=None if m is None
                                      else jnp.asarray(m))
    got, _ = LastTimeStep().apply({}, {}, torch.as_tensor(x),
                                  mask=None if m is None
                                  else torch.as_tensor(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert LastTimeStep().output_mask(m) is None


# ---------------------------------------------------------------------------
# gradients and single steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_first_step_gradients_match_jax(masked):
    jnet, net = _pair()
    x, y, m = _data(3, mask=masked)
    s, g = _port_grads(net, x, y, m, m)
    js, jg = _jax_grads(jnet, x, y, m, m)
    assert abs(s - js) <= STEP_TOL
    _tree_close(g, _np_tree(jg), STEP_TOL, "grads")


@pytest.mark.parametrize("name,kw", UPDATERS, ids=[u[0] for u in UPDATERS])
def test_one_step_of_each_updater_matches_jax(name, kw):
    """One step, parameters within STEP_TOL, except that an updater whose
    first step divides a gradient by its own magnitude (AdaGrad: lr g /
    (|g| + 1e-6)) turns a gradient within rounding of 0 into a step of up
    to lr either way: entries whose JAX gradient is below 1e-4 are held to
    2 lr there, as ROADMAP's parity notes hold Adam's."""
    jnet, net = _pair(getattr(jax_updaters, name)(**kw), head="last")
    x, y, _ = _data(4, "last")
    _, jg = _jax_grads(jnet, x, y)
    tiny = [np.abs(np.asarray(g)) < 1e-4 for p in jg
            for g in jax.tree_util.tree_leaves(p)]
    jnet.fit(x, y)
    net.fit(x, y)
    assert abs(net.score() - float(jnet.score())) <= STEP_TOL
    lr = kw.get("learning_rate", 1.0)
    for got, want, near0 in zip(
            [v for p in net.params for v in flat_leaves(p)],
            [np.asarray(v) for p in jnet.params
             for v in jax.tree_util.tree_leaves(p)], tiny):
        err = np.abs(got.numpy() - want)
        assert err[~near0].max(initial=0) <= STEP_TOL, name
        assert err[near0].max(initial=0) <= 2 * lr, name
    _tree_close(net.updater_state, _np_tree(jnet.updater_state), STEP_TOL,
                f"{name} state")


def test_l2_and_bias_lr_step_matches_the_documented_penalty():
    """The JAX package's BiLSTM raises in `reg_score` (a TypeError on the
    nested dict), so the reference here is the documented behaviour
    computed with JAX: the unregularised JAX score plus each direction's
    GravesLSTM penalty and the output layer's, over the batch, its
    jax.grad, and JAX's own `apply_layer_updates` (bias lr rescale of both
    directions included)."""
    l2, bias_lr = 1e-2, 0.03
    updater = jax_updaters.Adam(1e-2)
    jreg = jax_init(JaxMultiLayerNetwork(_jax_conf(updater, l2=l2)))
    jreg.layers[0].bias_learning_rate = bias_lr
    with pytest.raises(TypeError):
        jreg.fit(*_data(5)[:2])                 # the reference defect
    jplain = jax_init(JaxMultiLayerNetwork(_jax_conf(updater)))
    conf = MultiLayerConfiguration.from_json(jreg.conf.to_json())
    conf.layers[0].bias_learning_rate = bias_lr
    net = from_jax_params(MultiLayerNetwork(conf, device="cpu").init(),
                          _np_tree(jplain.params),
                          _np_tree(jplain.updater_state))
    x, y, _ = _data(5)
    sub = JaxGravesLSTM(n_out=HIDDEN, l2=l2, l2_bias=0.0, l1=0.0,
                        l1_bias=0.0)

    def loss(p):
        s, _ = jplain._loss_fn(p, jplain.state, jnp.asarray(x),
                               jnp.asarray(y), None)
        reg = (sub.reg_score(p[0]["fwd"]) + sub.reg_score(p[0]["bwd"])
               + jreg.layers[1].reg_score(p[1]))
        return s + reg / x.shape[0]
    js, g = jax.jit(jax.value_and_grad(loss))(jplain.params)
    want, _ = jreg.apply_layer_updates(jreg.layers, jplain.params, g,
                                       jplain.updater_state, 0)
    net.fit(x, y)
    assert abs(net.score() - float(js)) <= STEP_TOL
    _tree_close(net.params, _np_tree(want), STEP_TOL, "l2 + bias lr step")


def test_twenty_step_trajectory_matches_jax_fit():
    jnet, net = _pair(jax_updaters.Adam(1e-2), head="last")
    x, y, _ = _data(6, "last", n=40)
    scores = [[], []]

    class Log:
        def __init__(self, out):
            self.out = out

        def iteration_done(self, model, iteration):
            self.out.append(float(model._score))
    jnet.set_listeners(Log(scores[0]))
    net.set_listeners(Log(scores[1]))
    jnet.fit(JaxArrayIterator(x, y, batch_size=8), epochs=4)
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=4)
    assert len(scores[1]) == len(scores[0]) == 20
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=TRAJ_TOL)
    _tree_close(net.params, _np_tree(jnet.params), TRAJ_TOL, "20 steps")


def test_float64_gradient_check_passes_and_names_nested_paths():
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_conf(head="last").to_json()), device="cpu").init()
    x, y, m = _data(7, "last", mask=True)
    assert GradientCheckUtil.check_gradients(
        net, DataSet(x, y, features_mask=m), subsample=24)
    # a wrong gradient is caught, and named by its nested path: half of
    # peep^2's derivative hides behind a detach
    x64, y64 = (torch.as_tensor(a, dtype=torch.float64) for a in (x, y))

    def bad(p):
        s, _ = net._loss_fn(p, net.state, x64, y64)
        peep = p[0]["bwd"]["peep"]
        return s + (peep * peep.detach()).sum()
    ok, failures = check_gradients_fn(bad, net.params,
                                      max_params_per_array=4)
    assert not ok
    assert any("0/bwd/peep" in f for f in failures), failures[:3]


# ---------------------------------------------------------------------------
# every place that walks a parameter tree
# ---------------------------------------------------------------------------
def test_params_flat_and_num_params_match_jax():
    jnet, net = _pair(head="last")
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    assert net.num_params() == jnet.num_params()


def test_set_params_flat_is_the_inverse_in_jax_order():
    jnet, net = _pair(head="last")
    vec = np.random.default_rng(8).normal(
        size=jnet.num_params()).astype(np.float32)
    jnet.set_params_flat(vec)
    net.set_params_flat(vec)
    np.testing.assert_array_equal(net.params_flat(), vec)
    _tree_close(net.params, _np_tree(jnet.params), 0.0, "set_params_flat")


def test_bias_update_rescale_walks_nested_trees():
    upd = {"fwd": {"W": torch.ones(2), "b": torch.ones(2)},
           "bwd": {"peep": torch.ones(2), "b": torch.ones(2)},
           "bias_x": torch.ones(1)}
    out = _rescale_bias_updates(upd, 0.5)
    assert torch.equal(out["fwd"]["b"], torch.full((2,), 0.5))
    assert torch.equal(out["bwd"]["b"], torch.full((2,), 0.5))
    assert torch.equal(out["fwd"]["W"], torch.ones(2))
    assert torch.equal(out["bwd"]["peep"], torch.ones(2))
    assert torch.equal(out["bias_x"], torch.full((1,), 0.5))


def test_apply_layer_updates_subtracts_nested_updates():
    jnet, net = _pair(jax_updaters.Sgd(0.5))
    grads = [{"fwd": {k: torch.ones_like(v) for k, v in p["fwd"].items()},
              "bwd": {k: torch.ones_like(v) for k, v in p["bwd"].items()}}
             if "fwd" in p else {k: torch.ones_like(v) for k, v in p.items()}
             for p in net.params]
    new, _ = net.apply_layer_updates(net.layers, net.params, grads,
                                     net.updater_state, 0)
    for a, b in zip(flat_leaves(new[0]), flat_leaves(net.params[0])):
        assert torch.allclose(a, b - 0.5)


@pytest.mark.parametrize("name,kw", UPDATERS, ids=[u[0] for u in UPDATERS])
def test_updaters_init_and_update_nested_trees_as_jax(name, kw):
    r = np.random.default_rng(9)
    tree = {"fwd": {"W": r.normal(size=(3, 4)), "b": r.normal(size=4)},
            "bwd": {"W": r.normal(size=(3, 4)), "b": r.normal(size=4)}}
    tree = {d: {k: v.astype(np.float32) for k, v in t.items()}
            for d, t in tree.items()}
    port = getattr(updaters, name)(**kw)
    ref = getattr(jax_updaters, name)(**kw)
    params = {d: {k: torch.as_tensor(v) for k, v in t.items()}
              for d, t in tree.items()}
    state, jstate = port.init(params), ref.init(
        jax.tree_util.tree_map(jnp.asarray, tree))
    for step in range(2):
        u, state = port.update(params, state, step)
        ju, jstate = ref.update(jax.tree_util.tree_map(jnp.asarray, tree),
                                jstate, step)
        _tree_close(u, _np_tree(ju), 1e-6, f"{name} step {step}")
    _tree_close(state, _np_tree(jstate) if jstate != () else {}, 1e-6,
                f"{name} state")


@pytest.mark.parametrize("mode", [
    "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
    "clip_elementwise_absolute_value", "clip_l2_per_layer",
    "clip_l2_per_param_type"])
def test_gradient_normalization_of_nested_trees_matches_jax(mode):
    r = np.random.default_rng(10)
    tree = {d: {"W": r.normal(size=(3, 4)).astype(np.float32),
                "b": r.normal(size=4).astype(np.float32)}
            for d in ("fwd", "bwd")}
    got = gradnorm.apply_gradient_normalization(
        mode, 0.7, {d: {k: torch.as_tensor(v) for k, v in t.items()}
                    for d, t in tree.items()})
    want = jax_gradnorm.apply_gradient_normalization(
        mode, 0.7, jax.tree_util.tree_map(jnp.asarray, tree))
    _tree_close(got, _np_tree(want), 1e-6, mode)


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_reg_score_is_the_two_directions_penalties(reg):
    jnet, _ = _pair()
    kw = {reg: 0.1, f"{reg}_bias": 0.01}
    port = GravesBidirectionalLSTM(n_out=HIDDEN, **kw)
    sub = JaxGravesLSTM(n_out=HIDDEN, **kw)
    p = jnet.params[0]
    want = float(sub.reg_score(p["fwd"]) + sub.reg_score(p["bwd"]))
    got = float(port.reg_score(
        {d: {k: torch.tensor(np.asarray(v)) for k, v in t.items()}
         for d, t in p.items()}))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    with pytest.raises(TypeError):
        JaxBiLSTM(n_out=HIDDEN, **kw).reg_score(p)      # the reference


# ---------------------------------------------------------------------------
# the zip, clone, serving
# ---------------------------------------------------------------------------
def test_jax_zip_restores_in_the_port_and_trains_on(tmp_path):
    jnet, _ = _pair(jax_updaters.Adam(1e-2), head="last")
    x, y, _ = _data(11, "last")
    jnet.fit(x, y)
    path = str(tmp_path / "bi.zip")
    JaxModelSerializer.write_model(jnet, path)
    import zipfile
    with zipfile.ZipFile(path) as z:
        keys = np.load(z.open("coefficients.npz")).files
    assert "i:0/k:fwd/k:W" in keys
    net = ModelSerializer.restore(path, device="cpu")
    _tree_close(net.params, _np_tree(jnet.params), 0.0, "restored")
    _tree_close(net.updater_state, _np_tree(jnet.updater_state), 0.0,
                "updater")
    jnet.fit(x, y)
    net.fit(x, y)
    _tree_close(net.params, _np_tree(jnet.params), STEP_TOL, "resumed")


def test_port_zip_restores_in_jax(tmp_path):
    jnet, net = _pair(jax_updaters.Adam(1e-2), head="last")
    x, y, _ = _data(12, "last")
    net.fit(x, y)
    path = str(tmp_path / "bi_port.zip")
    ModelSerializer.write_model(net, path)
    back = JaxModelSerializer.restore(path)
    _tree_close(net.params, _np_tree(back.params), 0.0, "params")
    _tree_close(net.updater_state, _np_tree(back.updater_state), 0.0,
                "updater")
    back.fit(x, y)
    net.fit(x, y)
    _tree_close(net.params, _np_tree(back.params), STEP_TOL, "both trained")


def test_serialize_restore_train(tmp_path):
    """`test_bilstm_subsystems.py::test_bilstm_serialize_restore_train`."""
    _, net = _pair()
    x, y, _ = _data(13)
    net.fit(x, y)
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(net, path)
    back = ModelSerializer.restore(path, device="cpu")
    assert torch.equal(back.params[0]["bwd"]["W"], net.params[0]["bwd"]["W"])
    back.fit(x, y)
    assert np.isfinite(back.score())


def test_clone_trains_apart_and_alike():
    """`test_bilstm_subsystems.py::test_bilstm_clone_and_fit_scan`'s clone
    half: the clone and the original train on independently, to the same
    parameters (bit-equal: one process, one device)."""
    _, net = _pair(jax_updaters.Adam(1e-2), head="last")
    x, y, _ = _data(14, "last")
    c = net.clone()
    assert c.params[0]["fwd"]["W"] is not net.params[0]["fwd"]["W"]
    c.fit(x, y)
    assert not np.array_equal(c.params_flat(), net.params_flat())
    net.fit(x, y)
    np.testing.assert_array_equal(c.params_flat(), net.params_flat())
    _tree_close(c.updater_state, net.updater_state, 0.0, "clone state")
    assert c.iteration_count == net.iteration_count == 1


def test_clone_carries_the_dropout_generator():
    conf = (NeuralNetConfiguration.builder().seed(4).dropout(0.7)
            .regularization(True).list()
            .layer(GravesBidirectionalLSTM(n_out=3))
            .layer(RnnOutputLayer(n_out=CLASSES, activation="softmax"))
            .set_input_type(InputType.recurrent(N_IN, T)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y, _ = _data(15)
    net.fit(x, y)
    c = net.clone()
    for n in (net, c):
        n.fit(x, y)
    np.testing.assert_array_equal(c.params_flat(), net.params_flat())


def test_registry_serves_the_nested_tree(tmp_path):
    _, net = _pair(head="last")
    path = str(tmp_path / "serve.zip")
    ModelSerializer.write_model(net, path)
    reg = ModelRegistry(device="cpu", buckets=(1, 4))
    v = reg.register("bi", path)
    assert v.param_bytes == 4 * net.num_params()
    x, _, _ = _data(16, "last", n=3)
    out, _ = reg.predict("bi", x)
    np.testing.assert_allclose(out, net.output(x).numpy(), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# named errors
# ---------------------------------------------------------------------------
def test_tbptt_on_a_bidirectional_net_raises_named_error():
    conf = (NeuralNetConfiguration.builder().list()
            .layer(GravesBidirectionalLSTM(n_out=3))
            .layer(RnnOutputLayer(n_out=CLASSES, activation="softmax"))
            .set_input_type(InputType.recurrent(N_IN, T))
            .backprop_type("truncated_bptt").t_bptt_forward_length(3)
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y, _ = _data(17)
    with pytest.raises(ValueError, match="bidirectional"):
        net.fit(x, y)
    assert net.iteration_count == 0
    # the JAX package fails here with an AttributeError (no init_carry)
    jconf = JaxMultiLayerConfiguration.from_json(conf.to_json())
    with pytest.raises(AttributeError):
        JaxMultiLayerNetwork(jconf).init().fit(x, y)


def test_rnn_time_step_on_a_bidirectional_net_raises_named_error():
    _, net = _pair()
    x, _, _ = _data(18)
    with pytest.raises(ValueError, match="rnn_time_step"):
        net.rnn_time_step(x[:, 0])


# ---------------------------------------------------------------------------
# twins of tests/test_recurrent.py
# ---------------------------------------------------------------------------
def _rnn_net(*layers, n_in=4, t=6):
    b = NeuralNetConfiguration.builder().seed(12345).list()
    for layer in layers:
        b = b.layer(layer)
    return MultiLayerNetwork(b.set_input_type(InputType.recurrent(n_in, t))
                             .build(), device="cpu").init()


def _seq_data(n=4, t=6, n_in=4, n_out=3, seed=0, mask=False):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, t, n_in))
    y = np.eye(n_out)[r.integers(0, n_out, (n, t))]
    lm = None
    if mask:
        lengths = r.integers(2, t + 1, n)
        lm = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float64)
    return DataSet(x, y, features_mask=lm, labels_mask=lm)


@pytest.mark.parametrize("layer,masked", [
    (lambda: GravesLSTM(n_out=5), False),
    (lambda: GravesBidirectionalLSTM(n_out=4), False),
    (lambda: GravesLSTM(n_out=4), True),
    (lambda: GravesBidirectionalLSTM(n_out=4), True)],
    ids=["lstm", "bilstm", "lstm-masked", "bilstm-masked"])
def test_recurrent_gradient_checks(layer, masked):
    net = _rnn_net(layer(), RnnOutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"))
    assert GradientCheckUtil.check_gradients(net, _seq_data(mask=masked))


def test_mask_equivalence_padding_irrelevant():
    net = _rnn_net(GravesBidirectionalLSTM(n_out=4),
                   RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
    r = np.random.default_rng(1)
    x_short = r.normal(size=(2, 3, 4))
    y_short = np.zeros((2, 3, 3))
    y_short[:, :, 0] = 1.0
    pad_x = np.concatenate([x_short, r.normal(size=(2, 2, 4)) * 100], axis=1)
    pad_y = np.concatenate([y_short, np.zeros((2, 2, 3))], axis=1)
    pad_y[:, 3:, 1] = 1.0
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 0, 0]], np.float64)
    # the backward direction starts at the padded end: masked steps keep
    # its carry at zero, so the live steps see what the short series gives
    s_short = net.score(DataSet(x_short, y_short))
    s_pad = net.score(DataSet(pad_x, pad_y, features_mask=m, labels_mask=m))
    np.testing.assert_allclose(s_short, s_pad, rtol=1e-6)


def test_rnn_time_step_matches_full_forward():
    net = _rnn_net(GravesLSTM(n_out=5), GravesLSTM(n_out=4),
                   RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"), t=None)
    x = np.random.default_rng(2).normal(size=(2, 7, 4))
    full = net.output(x).numpy()
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(x[:, t]).numpy() for t in range(7)]
    np.testing.assert_allclose(np.stack(steps, axis=1), full, rtol=1e-5,
                               atol=1e-7)


def test_lstm_evaluation_time_series():
    net = _rnn_net(GravesBidirectionalLSTM(n_out=4),
                   RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
    ds = _seq_data(mask=True)
    ev = net.evaluate(ArrayDataSetIterator(
        ds.features, ds.labels, batch_size=2,
        features_mask=ds.features_mask, labels_mask=ds.labels_mask))
    assert 0.0 <= ev.accuracy() <= 1.0
    assert ev.num_examples() == int(ds.labels_mask.sum())


def test_bilstm_learns_a_sequence_classification():
    """Whether a series' first step is positive: a backward direction
    carries it to the last step, which LastTimeStep reads."""
    r = np.random.default_rng(3)
    x = r.normal(size=(64, 6, 2)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0, 0] > 0).astype(int)]
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater(updaters.Adam(2e-2)).list()
            .layer(GravesBidirectionalLSTM(n_out=8))
            .layer(LastTimeStep())
            .layer(_output(2))
            .set_input_type(InputType.recurrent(2, 6)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=30)
    acc = (net.predict(x) == y.argmax(1)).mean()
    assert acc > 0.9, acc


def _output(n):
    from deeplearning4j_tpu_torch.nn.layers import OutputLayer
    return OutputLayer(n_out=n, activation="softmax", loss="mcxent")
