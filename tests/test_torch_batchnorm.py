"""PyTorch port, the BatchNormalization layer and the layer state it brings,
on the CPU against the JAX package.

  * `_helper` selects the tier JAX's does ("pallas" | "fused" | None) over
    dtype x rank x activation x train x lock_gamma_beta x N in {4096, 4097};
  * `apply` on each tier, in training and inference, against the JAX
    layer's `apply` on the same params, state and input (the JAX "pallas"
    tier runs its Pallas kernel in interpret mode): output and new state;
  * the BN configuration JSON both ways; `networkState.npz` in the zip both
    ways and through `from_jax_params`;
  * the state repair: layer state is carried through training (a tiny BN
    net's running mean and var after SGD steps equal JAX's), stored
    detached, and moved by `to()`;
  * `cast_floating`, `strict_fp32`'s bf16 setting and the output layer's
    promotion of bf16 activations.

Tolerances: float32 outputs and states 2e-6 absolute on unit-scale data
(float32 sums in another order); bfloat16 and float16 outputs within one
ulp of the larger magnitude (both sides compute in float32 and round once);
float64 1e-12.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (BatchNormalization, DenseLayer,
                                      InputType, ModelSerializer,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, OutputLayer,
                                      from_jax_params)
from deeplearning4j_tpu_torch.kernels import bn_relu
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.base import cast_floating
from deeplearning4j_tpu_torch.util.platform import strict_fp32

F32_TOL = 2e-6
# one ulp relative to the magnitude: 8 and 11 significant bits
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(tree)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.element_size() < 4 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype.itemsize < 4 else a)


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    if dtype in ULP:
        limit = ULP[dtype] * np.maximum(np.abs(got), np.abs(want))
        bad = np.abs(got - want) > limit
        assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond "
                               f"one {dtype} ulp")
    else:
        tol = 1e-12 if dtype == "float64" else F32_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# tier selection
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [4096, 4097])
@pytest.mark.parametrize("ndim", [2, 4])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
def test_helper_selects_as_jax(dtype, ndim, N):
    C = 128
    shape = (N, C) if ndim == 2 else (N, 1, 1, C)
    x = torch.zeros(shape, dtype=getattr(torch, dtype))
    jx = jnp.zeros(shape, getattr(jnp, dtype))
    seen = set()
    for act in (None, "identity", "relu", "tanh"):
        for train in (False, True):
            for lock in (False, True):
                port = BatchNormalization(activation=act,
                                          lock_gamma_beta=lock)
                ref = JaxBN(activation=act, lock_gamma_beta=lock)
                got = port._helper(x, train)
                assert got == ref._helper(jx, train), (act, train, lock)
                seen.add(got)
    if dtype in ("float32", "float64"):
        assert seen == {None}
    else:
        assert seen == ({None, "fused", "pallas"}
                        if ndim == 2 and N == 4096 else {None, "fused"})


# ---------------------------------------------------------------------------
# apply on each tier
# ---------------------------------------------------------------------------
def _bn_inputs(shape, seed):
    r = np.random.default_rng(seed)
    C = shape[-1]
    x = (r.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    params = {"gamma": (1 + 0.2 * r.normal(size=C)).astype(np.float32),
              "beta": (0.3 * r.normal(size=C)).astype(np.float32)}
    state = {"mean": (0.1 * r.normal(size=C)).astype(np.float32),
             "var": r.uniform(0.5, 2.0, size=C).astype(np.float32)}
    return x, params, state


@pytest.mark.parametrize("case", [
    # (dtype, shape, activation, train, lock, store dtype, expected tier)
    ("bfloat16", (64, 48), "relu", True, False, None, "pallas"),
    ("float16", (64, 200), "relu", True, False, None, "pallas"),
    ("bfloat16", (64, 48), "identity", True, False, None, "fused"),
    ("bfloat16", (4, 3, 3, 16), "relu", True, False, None, "fused"),
    ("bfloat16", (64, 48), "relu", True, True, None, "fused"),
    ("bfloat16", (2, 4, 4, 8), "relu", True, False, "float8_e4m3fn",
     "fused"),
    ("bfloat16", (64, 48), "tanh", True, False, None, None),
    ("bfloat16", (64, 48), "relu", False, False, None, None),
    ("float32", (64, 48), "relu", True, False, None, None),
    ("float32", (4, 3, 3, 16), "identity", True, True, None, None),
    ("float32", (64, 48), "relu", False, False, None, None),
    ("float64", (64, 48), "relu", True, False, None, None),
    ("float64", (64, 48), "tanh", False, False, None, None),
])
def test_apply_matches_the_jax_layer(case):
    dtype, shape, act, train, lock, store, tier = case
    x, params, state = _bn_inputs(shape, seed=len(shape) + shape[-1])
    kw = dict(activation=act, lock_gamma_beta=lock, gamma_init=1.5,
              beta_init=-0.25, activation_store_dtype=store)
    port, ref = BatchNormalization(**kw), JaxBN(**kw)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    assert port._helper(tx, train) == tier == ref._helper(jx, train)
    p = {} if lock else {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {} if lock else {k: jnp.asarray(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    y, new = port.apply(p, s, tx, train=train)
    jy, jnew = ref.apply(jp, js, jx, train=train)
    assert y.dtype == tdt and tuple(y.shape) == shape
    _close(y, jy, dtype, f"{tier} y")
    for k in ("mean", "var"):
        assert new[k].dtype == getattr(torch, str(jnew[k].dtype))
        _close(new[k], jnew[k], "float64" if dtype == "float64"
               else "float32", f"{tier} state {k}")
    if not train:
        assert new is s


def test_training_state_update_is_the_running_average():
    x, params, state = _bn_inputs((32, 6), seed=5)
    bn = BatchNormalization(decay=0.75)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    _, new = bn.apply(p, s, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(
        new["mean"].numpy(), 0.75 * state["mean"] + 0.25 * x.mean(0),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        new["var"].numpy(), 0.75 * state["var"] + 0.25 * x.var(0),
        rtol=0, atol=1e-5)


def test_helper_tiers_detach_the_running_stats():
    x, params, state = _bn_inputs((16, 8), seed=6)
    bn = BatchNormalization(activation="relu")
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    assert bn._helper(xt, True) == "pallas"
    y, new = bn.apply(p, s, xt, train=True)
    assert y.requires_grad
    assert not new["mean"].requires_grad and not new["var"].requires_grad


# ---------------------------------------------------------------------------
# configuration, zip and from_jax_params
# ---------------------------------------------------------------------------
def _bn_mlp_conf(builder, dense, bn, output, input_type, updater, seed=3,
                 compute_dtype=None, bn_kw=None):
    b = builder().seed(seed).updater(updater)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(dense(n_out=16, activation="identity"))
            .layer(bn(activation="relu", **(bn_kw or {})))
            .layer(dense(n_out=16, activation="identity"))
            .layer(bn(activation="relu", **(bn_kw or {})))
            .layer(output(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(20)).build())


def _jax_bn_mlp(updater=None, **kw):
    return JaxMultiLayerNetwork(_bn_mlp_conf(
        JaxNNC.builder, JaxDense, JaxBN, JaxOutput, JaxInputType,
        updater or JaxSgd(0.1), **kw)).init()


def _twin(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    return from_jax_params(net, _np_tree(jnet.params),
                           _np_tree(jnet.updater_state),
                           _np_tree(jnet.state))


def _batches(n, seed):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(32, 20)).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.integers(0, 3, 32)])
            for _ in range(n)]


@pytest.mark.parametrize("bn_kw", [
    {}, {"decay": 0.5, "eps": 1e-3, "lock_gamma_beta": True,
         "gamma_init": 2.0, "beta_init": 0.5}])
def test_bn_config_json_both_ways(bn_kw):
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JaxMLC
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    jax_json = _bn_mlp_conf(JaxNNC.builder, JaxDense, JaxBN, JaxOutput,
                            JaxInputType, JaxSgd(0.1),
                            compute_dtype="bfloat16", bn_kw=bn_kw).to_json()
    port_json = _bn_mlp_conf(NeuralNetConfiguration.builder, DenseLayer,
                             BatchNormalization, OutputLayer, InputType,
                             Sgd(0.1), compute_dtype="bfloat16",
                             bn_kw=bn_kw).to_json()
    assert json.loads(port_json) == json.loads(jax_json)
    assert json.loads(MultiLayerConfiguration.from_json(jax_json).to_json()) \
        == json.loads(jax_json)
    assert json.loads(JaxMLC.from_json(port_json).to_json()) == \
        json.loads(jax_json)
    layer = MultiLayerConfiguration.from_json(jax_json).layers[1]
    assert isinstance(layer, BatchNormalization) and layer.n_out == 16


def test_state_repair_running_stats_follow_jax_through_training():
    """The fault this slice repairs: the port dropped every layer's new
    state. After four SGD steps the running mean and var of both BN layers
    equal JAX's (float32, 1e-6 absolute: float32 sums in another order over
    four steps), parameters too, and the state is stored detached."""
    jnet = _jax_bn_mlp()
    net = _twin(jnet)
    for x, y in _batches(4, seed=7):
        jnet.fit(x, y)
        net.fit(x, y)
    for i in (1, 3):
        for k in ("mean", "var"):
            got, want = net.state[i][k], np.asarray(jnet.state[i][k])
            assert not got.requires_grad and got.grad_fn is None
            assert np.abs(want - np.asarray(jax.tree_util.tree_leaves(
                _jax_bn_mlp().state[i][k]))).max() > 1e-3   # it moved
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=f"layer {i} {k}")
    for i, (p, jp) in enumerate(zip(net.params, jnet.params)):
        for k in jp:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"layer {i} {k}")
    # inference reads the running stats, as JAX's output does
    x = _batches(1, seed=8)[0][0]
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0,
                               atol=1e-5)


def test_network_state_npz_both_ways(tmp_path):
    jnet = _jax_bn_mlp()
    for x, y in _batches(2, seed=9):
        jnet.fit(x, y)
    jzip = str(tmp_path / "jax.zip")
    JaxModelSerializer.write_model(jnet, jzip)
    net = ModelSerializer.restore(jzip, device="cpu")
    for s, js in zip(net.state, jnet.state):
        assert set(s) == set(js)
        for k in js:
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]))
    # the port trains on, writes its zip, JAX restores it
    for x, y in _batches(2, seed=10):
        net.fit(x, y)
    pzip = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, pzip)
    back = JaxModelSerializer.restore(pzip)
    for s, js in zip(net.state, back.state):
        for k in s:
            np.testing.assert_array_equal(np.asarray(js[k]), s[k].numpy())
    again = ModelSerializer.restore(pzip, device="cpu")
    x = _batches(1, seed=11)[0][0]
    np.testing.assert_array_equal(again.output(x).numpy(),
                                  net.output(x).numpy())
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               net.output(x).numpy(), rtol=0, atol=1e-5)


def test_from_jax_params_takes_the_state_and_checks_it():
    jnet = _jax_bn_mlp()
    jnet.fit(*_batches(1, seed=12)[0])
    net = _twin(jnet)
    np.testing.assert_array_equal(net.state[1]["mean"].numpy(),
                                  np.asarray(jnet.state[1]["mean"]))
    bad = list(_np_tree(jnet.state))
    bad[1] = {"mean": bad[1]["mean"]}
    with pytest.raises(KeyError, match="i:1/k:var"):
        from_jax_params(net, _np_tree(jnet.params), state=bad)
    with pytest.raises(ValueError, match="layer state"):
        from_jax_params(net, _np_tree(jnet.params), state=bad[:2])


def test_to_moves_the_layer_state():
    net = _twin(_jax_bn_mlp())
    net.to("cpu")
    assert all(t.device.type == "cpu" for s in net.state for t in s.values())
    assert set(net.state[1]) == {"mean", "var"} and net.state[0] == {}


# ---------------------------------------------------------------------------
# the mixed-precision pieces
# ---------------------------------------------------------------------------
def test_cast_floating_casts_floats_only_and_grads_come_back_f32():
    w = torch.ones(3, requires_grad=True)
    tree = {"W": w, "idx": torch.arange(3), "nested": {"b": w * 2}}
    out = cast_floating(tree, torch.bfloat16)
    assert out["W"].dtype == out["nested"]["b"].dtype == torch.bfloat16
    assert out["idx"].dtype == torch.int64
    (g,) = torch.autograd.grad(out["W"].float().sum(), w)
    assert g.dtype == torch.float32


def test_strict_fp32_keeps_bf16_products_accumulating_in_f32():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    strict_fp32()
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32


def test_output_layer_promotes_bf16_activations_like_jax():
    r = np.random.default_rng(13)
    h = r.normal(size=(5, 7)).astype(np.float32)
    W = r.normal(size=(7, 4)).astype(np.float32)
    b = r.normal(size=4).astype(np.float32)
    port = OutputLayer(n_out=4)
    ref = JaxOutput(n_out=4)
    z = port.preout({"W": torch.from_numpy(W), "b": torch.from_numpy(b)},
                    {}, torch.from_numpy(h).to(torch.bfloat16))
    jz = ref.preout({"W": jnp.asarray(W), "b": jnp.asarray(b)}, {},
                    jnp.asarray(h).astype(jnp.bfloat16))
    assert z.dtype == torch.float32 and jz.dtype == jnp.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-5)


def test_cpu_training_launches_no_bn_kernel():
    net = _twin(_jax_bn_mlp(compute_dtype="bfloat16"))
    bn_relu.reset_launches()
    net.fit(*_batches(1, seed=14)[0])
    assert bn_relu.launch_counts() == {"fwd_launches": 0, "bwd_launches": 0}
