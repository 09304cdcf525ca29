"""PyTorch port, the MixtureOfExpertsLayer and remat on the CPU against the
JAX package: the twins of `tests/test_moe.py` (its expert-parallel cases
are in `test_torch_tp_models.py`) and of `tests/test_precision_remat.py`'s
remat cases (its superstep and accumulation paths wait for A8, its
pipeline cases are not twinned).

MoE: the same parameters (through `from_jax_params`) and numpy inputs in
both packages; outputs within 1e-5 (float32 einsums over 8-32 terms in
another order), gradients and one step within 1e-5, an 8-step trajectory
within 1e-4. Tied router logits (all-zero rows) route to the lowest expert
indices, as `jax.lax.top_k` does; the port takes the first k of a stable
descending sort. Router noise draws through `nn.noise.draw`, replaced here
by JAX's draw from the same key.

Remat: every placement ("layer", "blocks", "full") and policy (None,
"nothing", "dots", "dots_no_batch", "everything") leaves scores and
parameters bit-equal to the run without remat, dropout included; the
parameters also match JAX's rematerialized run within the trajectory
tolerance 1e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import \
    MixtureOfExpertsLayer as JaxMoE
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu_torch import (InputType, MultiLayerNetwork,
                                      NeuralNetConfiguration,
                                      from_jax_params)
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn import noise, remat
from deeplearning4j_tpu_torch.nn.conf import (MaskState,
                                              MultiLayerConfiguration,
                                              layer_from_dict)
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer,
                                                GravesBidirectionalLSTM,
                                                LastTimeStep,
                                                MixtureOfExpertsLayer,
                                                OutputLayer,
                                                TransformerBlock)
from deeplearning4j_tpu_torch.nn.layers.moe import top_k_gates
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.gradient_check import check_gradients_fn
from jax_reference import jax_init
from torch_threads import one_torch_thread  # noqa: F401

TOL, STEP_TOL, TRAJ_TOL = 1e-5, 1e-5, 1e-4


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _moe_pair(top_k=2, n_experts=4, lb=0.0, updater=None, noise_std=0.0):
    jconf = (JaxNNC.builder().seed(3)
             .updater(updater or jax_updaters.Sgd(0.05)).list()
             .layer(JaxMoE(n_out=16, n_experts=n_experts, top_k=top_k,
                           expert_hidden=32, activation="relu",
                           load_balance_coef=lb, router_noise=noise_std))
             .layer(JaxOutput(n_out=4, activation="softmax", loss="mcxent"))
             .set_input_type(JaxInputType.feed_forward(8)).build())
    jnet = jax_init(JaxMultiLayerNetwork(jconf))
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json()), device="cpu").init()
    return jnet, from_jax_params(net, _np_tree(jnet.params),
                                 _np_tree(jnet.updater_state),
                                 _np_tree(jnet.state))


def _data(n=32, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 8)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[r.integers(0, 4, n)]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=msg)


def _params_close(net, jnet, tol, msg=""):
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            _close(p[k].detach().numpy(), jp[k], tol, f"{msg} {i}/{k}")


# ---------------------------------------------------------------------------
# MixtureOfExpertsLayer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("top_k,n_experts", [(1, 4), (2, 4), (3, 8), (9, 4)])
def test_moe_forward_matches_jax(top_k, n_experts):
    jnet, net = _moe_pair(top_k, n_experts)
    x, _ = _data()
    x[:3] = 0.0                          # tied logits
    _close(net.output(x).numpy(), jnet.output(x), TOL)
    layer, p = net.layers[0], net.params[0]
    y, _ = layer.apply(p, net.state[0], torch.as_tensor(x))
    jy, _ = jax.jit(jnet.layers[0].apply)(jnet.params[0], jnet.state[0],
                                          jnp.asarray(x))
    _close(y.numpy(), jy, TOL)


def test_moe_top1_output_is_the_argmax_expert():
    """`test_moe_forward_shapes_and_gates`: with top-1 the output is the
    argmax expert's FFN exactly (one gate of 1)."""
    _, net = _moe_pair(top_k=1)
    x, _ = _data()
    p = {k: v.numpy() for k, v in net.params[0].items()}
    y, _ = net.layers[0].apply(net.params[0], {}, torch.as_tensor(x))
    pick = (x @ p["router_W"]).argmax(1)
    hid = np.maximum(np.einsum("bi,eih->beh", x, p["expert_W1"])
                     + p["expert_b1"], 0.0)
    outs = np.einsum("beh,eho->beo", hid, p["expert_W2"]) + p["expert_b2"]
    _close(y.numpy(), outs[np.arange(len(x)), pick], 2e-5)


def test_moe_ties_route_the_lowest_experts_as_jax_top_k():
    logits = torch.zeros(5, 6)
    logits[1, [1, 3, 4]] = 2.0          # a three-way tie above the rest
    logits[2] = torch.tensor([0.5, 1.0, 1.0, 0.2, 1.0, -1.0])
    g = top_k_gates(logits, 2)
    _, idx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    for row in range(5):
        assert set(np.nonzero(g[row].numpy())[0]) == set(
            np.asarray(idx[row]).tolist()), row
    assert int((g > 0).sum(1).max()) == 2
    assert torch.equal(g[0], torch.tensor([.5, .5, 0, 0, 0, 0]))


@pytest.mark.parametrize("lb", [0.0, 0.05])
def test_moe_gradients_and_one_step_match_jax(lb):
    jnet, net = _moe_pair(lb=lb, updater=jax_updaters.Adam(1e-2))
    x, y = _data(seed=1)
    jnet.fit(x, y)
    net.fit(x, y)
    assert abs(net.score() - float(jnet.score())) <= STEP_TOL
    _params_close(net, jnet, STEP_TOL, "step")
    if lb:
        _close(net.state[0]["aux_loss"].numpy(), jnet.state[0]["aux_loss"],
               1e-6)


def test_moe_ten_step_trajectory_matches_jax():
    jnet, net = _moe_pair(lb=0.01, updater=jax_updaters.Adam(1e-2))
    x, y = _data(64, seed=2)
    from deeplearning4j_tpu.datasets.iterators import \
        ArrayDataSetIterator as JaxArrayIterator
    jnet.fit(JaxArrayIterator(x, y, batch_size=16), epochs=2)
    net.fit(ArrayDataSetIterator(x, y, batch_size=16), epochs=2)
    assert net.iteration_count == 8
    assert abs(net.score() - float(jnet.score())) <= TRAJ_TOL
    _params_close(net, jnet, TRAJ_TOL, "trajectory")


def test_moe_router_noise_matches_jax_under_the_same_draw(monkeypatch):
    jnet, net = _moe_pair(noise_std=0.3)
    x, _ = _data(seed=3)
    rng = jax.random.PRNGKey(7)
    _, noise_rng = jax.random.split(rng)
    draw = np.asarray(jax.random.normal(noise_rng, (32, 4), jnp.float32))
    monkeypatch.setattr(noise, "draw",
                        lambda *a: torch.as_tensor(draw))
    y, _ = net.layers[0].apply(net.params[0], {}, torch.as_tensor(x),
                               train=True,
                               generator=torch.Generator().manual_seed(0))
    jy, _ = jnet.layers[0].apply(jnet.params[0], {}, jnp.asarray(x),
                                 train=True, rng=rng)
    _close(y.numpy(), jy, TOL)


def test_moe_gradient_check_in_float64():
    """`test_moe_gradient_check`: numeric against analytic gradients in
    float64 away from routing boundaries, through the evaluation score
    (no aux), as JAX's test takes it."""
    _, net = _moe_pair()
    r = np.random.default_rng(1)
    x = torch.as_tensor(r.normal(size=(8, 8)))
    y = torch.as_tensor(np.eye(4)[r.integers(0, 4, 8)])
    ok, failures = check_gradients_fn(
        lambda p: net._loss_fn(p, net.state, x, y, train=False)[0],
        net.params, max_rel_error=1e-5)
    assert ok, failures[:3]


def test_moe_aux_score_in_training_only():
    """`test_moe_aux_loss_present_and_finite` and
    `test_moe_eval_score_excludes_aux`."""
    jnet, net = _moe_pair(lb=0.5)
    x, y = _data()
    net.fit(x, y)
    assert np.isfinite(net.score()) and float(net.state[0]["aux_loss"]) > 0
    ds = DataSet(x, y)
    s_eval = net.score(ds)
    _, plain = _moe_pair(lb=0.0)
    plain.params = net.params
    assert abs(s_eval - plain.score(ds)) <= 1e-6 * abs(s_eval)
    jnet.fit(x, y)
    _params_close(net, jnet, STEP_TOL, "lb 0.5 step")
    assert abs(s_eval - float(jnet._score_fn(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None,
        None))) <= STEP_TOL


def test_moe_learns_cluster_specialization():
    r = np.random.default_rng(4)
    centers = r.normal(size=(4, 8)) * 4
    idx = r.integers(0, 4, 256)
    x = (centers[idx] + r.normal(size=(256, 8))).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[idx]
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2))
            .list().layer(MixtureOfExpertsLayer(n_out=16, n_experts=4,
                                                top_k=1, expert_hidden=32,
                                                activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(ArrayDataSetIterator(x, y, batch_size=64), epochs=20)
    assert (net.predict(x) == idx).mean() > 0.9


def test_moe_json_crosses_both_codecs():
    jnet, net = _moe_pair()
    l0 = net.conf.layers[0]
    assert isinstance(l0, MixtureOfExpertsLayer)
    assert (l0.n_experts, l0.top_k, l0.expert_hidden) == (4, 2, 32)
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())


# ---------------------------------------------------------------------------
# nn.conf: MaskState and layer_from_dict
# ---------------------------------------------------------------------------
def test_mask_state_and_layer_from_dict_as_jax():
    from deeplearning4j_tpu.nn.conf import MaskState as JaxMaskState
    from deeplearning4j_tpu.nn.conf import layer_from_dict as jax_from_dict
    from deeplearning4j_tpu.nn.conf.base import conf_to_dict as jax_to_dict
    assert (MaskState.ACTIVE, MaskState.PASSTHROUGH) == (
        JaxMaskState.ACTIVE, JaxMaskState.PASSTHROUGH)
    d = jax_to_dict(JaxMoE(n_out=5, n_experts=3))
    for spec in (d, d["__layer__"]):
        layer = layer_from_dict(json.loads(json.dumps(spec)))
        assert isinstance(layer, MixtureOfExpertsLayer)
        assert layer.n_experts == 3 and layer.n_out == 5
        assert type(jax_from_dict(spec)).__name__ == type(layer).__name__
    with pytest.raises(ValueError, match="Unknown layer type"):
        layer_from_dict({"type": "NoSuchLayer", "fields": {}})


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
def _mlp(remat_mode=None, policy=None, dropout=None, jax_side=False):
    nnc = JaxNNC if jax_side else NeuralNetConfiguration
    upd = jax_updaters.Adam(1e-2) if jax_side else Adam(1e-2)
    b = nnc.builder().seed(7).updater(upd)
    if dropout:
        b = b.dropout(dropout).regularization(True)
    if remat_mode:
        b = b.remat(remat_mode)
    if policy:
        b = b.remat_policy(policy)
    b = b.list()
    dense = JaxDense if jax_side else DenseLayer
    out = JaxOutput if jax_side else OutputLayer
    for _ in range(2):
        b = b.layer(dense(n_out=16, activation="tanh"))
    conf = (b.layer(out(n_out=4, loss="mcxent"))
            .set_input_type((JaxInputType if jax_side else InputType)
                            .feed_forward(8)).build())
    if jax_side:
        return jax_init(JaxMultiLayerNetwork(conf))
    return MultiLayerNetwork(conf, device="cpu").init(
        generator=torch.Generator().manual_seed(1))


def _fit(net, epochs=1):
    r = np.random.default_rng(0)
    x = r.normal(size=(32, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 32)]
    net.fit(ArrayDataSetIterator(x, y, batch_size=8), epochs=epochs)
    return net


POLICIES = [None, "nothing", "dots", "dots_no_batch", "everything"]


@pytest.mark.parametrize("dropout", [None, 0.8])
@pytest.mark.parametrize("mode", ["full", "layer", "blocks"])
def test_remat_is_bit_equal_for_every_policy(mode, dropout):
    want = _fit(_mlp(dropout=dropout))
    for policy in POLICIES:
        got = _fit(_mlp(mode, policy, dropout))
        np.testing.assert_array_equal(got.params_flat(), want.params_flat(),
                                      err_msg=f"{mode} {policy}")
        assert got.score() == want.score()


@pytest.mark.parametrize("mode,policy", [("full", "dots"),
                                         ("layer", "dots")])
def test_remat_matches_jax_remat(mode, policy):
    jnet = _mlp(mode, policy, jax_side=True)
    net = from_jax_params(_mlp(mode, policy), _np_tree(jnet.params),
                          _np_tree(jnet.updater_state))
    r = np.random.default_rng(0)
    x = r.normal(size=(32, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 32)]
    from deeplearning4j_tpu.datasets.iterators import \
        ArrayDataSetIterator as JaxArrayIterator
    jnet.fit(JaxArrayIterator(x, y, batch_size=8, shuffle=False))
    net.fit(ArrayDataSetIterator(x, y, batch_size=8))
    _params_close(net, jnet, TRAJ_TOL, f"{mode} {policy}")


def test_bilstm_remat_is_bit_equal_and_masks_warn():
    def net(mode=None):
        b = NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-2))
        if mode:
            b = b.remat(mode).remat_policy("dots")
        conf = (b.list().layer(GravesBidirectionalLSTM(n_out=5))
                .layer(LastTimeStep()).layer(OutputLayer(n_out=3))
                .set_input_type(InputType.recurrent(4, 6)).build())
        return MultiLayerNetwork(conf, device="cpu").init(
            generator=torch.Generator().manual_seed(3))
    r = np.random.default_rng(5)
    x = r.normal(size=(6, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)]
    a, b = net(), net("layer")
    for n in (a, b):
        n.fit(x, y)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    m = np.ones((6, 6), np.float32)
    m[0, 3:] = 0
    with pytest.warns(UserWarning, match="inactive"):
        b.fit(DataSet(x, y, features_mask=m))


def test_remat_policy_typo_fails_fast():
    with pytest.raises(ValueError, match="unknown remat policy"):
        NeuralNetConfiguration.builder().remat_policy("bogus")
    with pytest.raises(ValueError, match="Valid policies"):
        remat.resolve_policy("bogus")
    assert remat.resolve_policy(None) is None


def test_saved_bytes_boundary_inputs_excluded_and_ordered():
    """`test_saved_bytes_boundary_inputs_excluded` and the ordering of
    `test_pp_stage_saved_bytes_policy_ordering` on one transformer block:
    save-nothing keeps 0 bytes, "dots" keeps some, fewer than the residuals
    autograd keeps without a checkpoint ("everything")."""
    a, b = torch.zeros(4, 8), torch.zeros(8, 8)
    f = lambda a_, b_: torch.tanh(a_ @ b_).sum()
    assert remat.saved_bytes(f, a, b, policy="nothing") == 0
    assert remat.saved_bytes(f, a, b) == 0
    assert remat.saved_bytes(f, a, b, policy="dots") == 4 * 8 * 4
    block = TransformerBlock(n_heads=2)
    from deeplearning4j_tpu_torch.nn.conf import InputType as It
    p = block.init_params(torch.Generator().manual_seed(0),
                          It.recurrent(16, 12), "cpu")
    x = torch.zeros(2, 12, 16)
    fn = lambda x_: block.apply(p, {}, x_, train=True)[0]
    col = {pol: remat.saved_bytes(fn, x, policy=pol) for pol in POLICIES}
    assert col[None] == col["nothing"] == 0
    assert 0 < col["dots_no_batch"] <= col["dots"] < col["everything"]
