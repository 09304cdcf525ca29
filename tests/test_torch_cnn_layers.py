"""PyTorch port, the convolutional path's parts on the CPU against the JAX
package: all 21 activations, every conv / pool / pad layer, the input
preprocessors and `infer_preprocessor`, LocalResponseNormalization,
GlobalPoolingLayer, and the Loss / Activation / Dropout / Embedding layers.

Each layer is built from the JAX layer's own `__layer__` JSON, the same
numpy inputs (made from a seed) go through JAX's `apply` and `jax.vjp` and
through the port's `apply` and autograd, with one cotangent.

Tolerances, stated per check:
  * activations: float32 1e-6 (relative to max(1, |value|)), bfloat16 2e-2
    (8 significant bits; both sides round the same f32 result, but bf16
    intermediates may round apart by one ulp);
  * layers in float32: 1e-5 of max(1, the largest reference magnitude) per
    tensor: sums of up to 11 x 11 x 3 products (outputs) or 2 x 32 x 32
    (weight gradients) in another order;
  * the float8-stored bf16 convolution: 2e-2 of the largest magnitude (both
    sides round x to float8 the same way; the bf16 results may land one
    ulp apart).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jax_acts
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.base import conf_to_dict as jax_conf_to_dict
from deeplearning4j_tpu.nn.layers import (
    ActivationLayer as JaxActivation, Convolution1DLayer as JaxConv1D,
    ConvolutionLayer as JaxConv, DenseLayer as JaxDense,
    DropoutLayer as JaxDropout, EmbeddingLayer as JaxEmbedding,
    GlobalPoolingLayer as JaxGlobalPooling, GravesLSTM as JaxLSTM,
    LocalResponseNormalization as JaxLRN, LossLayer as JaxLoss,
    Subsampling1DLayer as JaxSub1D, SubsamplingLayer as JaxSub,
    ZeroPaddingLayer as JaxZeroPad)
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.base import conf_from_dict, conf_to_dict

ACT_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
TOL = 1e-5
F8_TOL = 2e-2



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's side of each comparison: the
    suite runs in parallel workers, and torch's default of one thread per
    core in each of them oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port(jax_obj):
    """The port's twin of a JAX layer or preprocessor, through the JSON."""
    return conf_from_dict(json.loads(json.dumps(jax_conf_to_dict(jax_obj))))


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _params(layer_shapes, seed):
    r = np.random.default_rng(seed)
    out = {}
    for k, shape in layer_shapes.items():
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        out[k] = (r.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    return out


def _jax_vjp(layer, params, x, train=False, mask=None):
    """(y, a seeded normal cotangent ct, d params, dx) of JAX's apply."""
    def f(p, x_):
        return layer.apply(p, {}, x_, train=train, rng=None, mask=mask)[0]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y, vjp = jax.vjp(f, jp, jnp.asarray(x))
    ct = np.random.default_rng(99).normal(size=y.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct, y.dtype))
    return np.asarray(y.astype(jnp.float32)), ct, \
        {k: np.asarray(v.astype(jnp.float32)) for k, v in gp.items()}, \
        np.asarray(gx.astype(jnp.float32))


def _port_vjp(layer, params, x, ct, train=False, mask=None):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(np.asarray(x, np.float32), requires_grad=True)
    m = None if mask is None else torch.tensor(mask)
    y = layer.apply(p, {}, xt, train=train, generator=None, mask=m)[0]
    leaves = [xt] + list(p.values())
    grads = torch.autograd.grad(y, leaves, torch.tensor(ct, dtype=y.dtype),
                                allow_unused=True)   # integer-cast input
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    gx, gp = grads[0], dict(zip(p, grads[1:]))
    return (y.detach().numpy(), {k: v.numpy() for k, v in gp.items()},
            gx.numpy())


def _check_layer(jl, params, x, tol=TOL, train=False, mask=None):
    """JAX and port apply + vjp of the same layer on the same inputs."""
    layer = _port(jl)
    y, ct, jgp, jgx = _jax_vjp(jl, params, x, train=train, mask=mask)
    py, pgp, pgx = _port_vjp(layer, params, x, ct, train=train, mask=mask)
    _close(py, y, tol, "output")
    _close(pgx, jgx, tol, "dx")
    for k in jgp:
        _close(pgp[k], jgp[k], tol, f"d{k}")
    return layer


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
KINKS = [-2.5, -1.0, 0.0, 1.0, 2.5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(jax_acts.ACTIVATIONS))
def test_activation_values_and_gradients_match_jax(name, dtype):
    """Values and vjp on a grid over [-4, 4] with every kink (-2.5 and 2.5
    for hardsigmoid, -1 and 1 for hardtanh and thresholdedrelu, 0 for the
    rest), as [8, 11] rows so softmax and logsoftmax reduce the last
    axis."""
    assert set(activations.ACTIVATIONS) == set(jax_acts.ACTIVATIONS)
    grid = np.concatenate([np.linspace(-4, 4, 83), KINKS]).astype(np.float32)
    x = grid.reshape(8, 11)
    ct = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    y, vjp = jax.vjp(jax_acts.get(name), jnp.asarray(x, jdt))
    (gx,) = vjp(jnp.asarray(ct, jdt))
    tdt = getattr(torch, dtype)
    xt = torch.tensor(x, dtype=tdt, requires_grad=True)
    yt = activations.get(name)(xt)
    assert yt.dtype == tdt
    (gt,) = torch.autograd.grad(yt, xt, torch.tensor(ct, dtype=tdt))
    tol = ACT_TOL[dtype]
    for got, want, what in ((yt, y, "value"), (gt, gx, "gradient")):
        got = got.detach().float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"{name} {what}")


def test_activation_kinks_take_jax_derivative():
    """At the kinks the derivative is jax.grad's: leakyrelu's slope 1 at 0,
    an even split of hardtanh's and hardsigmoid's clip bounds and of
    rectifiedtanh at 0, thresholdedrelu 0 at theta."""
    want = {"leakyrelu": [0.0, 1.0], "hardtanh": [1.0, 0.5],
            "hardsigmoid": [2.5, 0.1], "rectifiedtanh": [0.0, 0.5],
            "thresholdedrelu": [1.0, 0.0], "relu": [0.0, 0.0],
            "elu": [0.0, 1.0]}
    for name, (at, d) in want.items():
        x = torch.tensor(at, requires_grad=True)
        (g,) = torch.autograd.grad(activations.get(name)(x), x)
        jg = jax.grad(jax_acts.get(name))(jnp.float32(at))
        assert float(g) == pytest.approx(d) == pytest.approx(float(jg)), name


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------
CONV_CASES = [
    # (kernel, stride, padding, dilation, mode, size)
    ((5, 5), (1, 1), (0, 0), (1, 1), "truncate", 12),
    ((3, 3), (2, 2), (1, 1), (1, 1), "truncate", 13),
    ((4, 4), (3, 3), (2, 2), (1, 1), "truncate", 14),       # even kernel
    ((3, 2), (4, 1), (0, 1), (1, 1), "truncate", 13),
    ((3, 3), (1, 1), (0, 0), (2, 2), "truncate", 11),       # dilation 2
    ((3, 3), (2, 2), (0, 0), (1, 1), "strict", 9),
    ((3, 3), (1, 1), (0, 0), (1, 1), "same", 10),
    ((11, 11), (4, 4), (0, 0), (1, 1), "same", 32),         # AlexNet: (3, 4)
    ((4, 4), (2, 2), (0, 0), (1, 1), "same", 9),            # even, uneven
    ((3, 3), (3, 3), (0, 0), (2, 2), "same", 10),           # dilated SAME
    ((5, 3), (2, 1), (0, 0), (1, 1), "same", 11),
]


@pytest.mark.parametrize("kernel,stride,padding,dilation,mode,size",
                         CONV_CASES)
def test_convolution_layer_matches_jax(kernel, stride, padding, dilation,
                                       mode, size):
    jl = JaxConv(n_in=3, n_out=4, kernel_size=kernel, stride=stride,
                 padding=padding, dilation=dilation, convolution_mode=mode,
                 activation="relu")
    params = _params({"W": kernel + (3, 4), "b": (4,)}, seed=size)
    width = size if mode == "strict" else size + 1
    x = np.random.default_rng(2).normal(size=(2, size, width, 3)) \
        .astype(np.float32)
    layer = _check_layer(jl, params, x)
    it = JaxInputType.convolutional(size, width, 3)
    assert layer.output_type(InputType.convolutional(size, width, 3)) \
        .to_dict() == jl.output_type(it).to_dict()


def test_strict_mode_raises_jax_error():
    jl = JaxConv(n_in=3, n_out=4, kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="strict")
    with pytest.raises(ValueError) as jerr:
        jl.output_type(JaxInputType.convolutional(10, 10, 3))
    with pytest.raises(ValueError) as err:
        _port(jl).output_type(InputType.convolutional(10, 10, 3))
    assert str(err.value) == str(jerr.value)


def test_convolution_output_is_nhwc_and_weights_hwio():
    """The layer keeps NHWC activations and HWIO weights, and its result is
    a contiguous NHWC tensor (the channels_last output permuted back)."""
    jl = JaxConv(n_in=3, n_out=5, kernel_size=(3, 3),
                 convolution_mode="same")
    layer = _port(jl)
    p = layer.init_params(torch.Generator().manual_seed(0),
                          InputType.convolutional(8, 8, 3), "cpu")
    assert tuple(p["W"].shape) == (3, 3, 3, 5)
    y, _ = layer.apply(p, {}, torch.randn(2, 8, 8, 3))
    assert tuple(y.shape) == (2, 8, 8, 5) and y.is_contiguous()


@pytest.mark.parametrize("kernel,stride,padding,dilation,mode,size", [
    (3, 1, 0, 1, "same", 10), (4, 2, 1, 2, "truncate", 17),
    (5, 2, 0, 1, "same", 12), (3, 2, 0, 1, "strict", 11)])
def test_convolution1d_layer_matches_jax(kernel, stride, padding, dilation,
                                         mode, size):
    jl = JaxConv1D(n_in=5, n_out=6, kernel_size=kernel, stride=stride,
                   padding=padding, dilation=dilation, convolution_mode=mode,
                   activation="tanh")
    params = _params({"W": (kernel, 5, 6), "b": (6,)}, seed=size)
    x = np.random.default_rng(3).normal(size=(3, size, 5)).astype(np.float32)
    layer = _check_layer(jl, params, x)
    assert layer.output_type(InputType.recurrent(5, size)).to_dict() == \
        jl.output_type(JaxInputType.recurrent(5, size)).to_dict()


@pytest.mark.parametrize("compute,store,tol", [
    ("float32", "bfloat16", TOL), ("bfloat16", "float8_e4m3fn", F8_TOL)])
def test_conv_stored_matches_jax(compute, store, tol):
    """The convolution whose saved input is stored in a narrower dtype (JAX
    `_conv_stored`): forward, and the dx / dW that the backward derives from
    the stored input, at values inside float8_e4m3fn's range (|x| < 448).
    The stored path's dW differs from the exact one (the check that the
    narrow copy is what the backward read)."""
    jl = JaxConv(n_in=3, n_out=4, kernel_size=(3, 3), stride=(2, 2),
                 convolution_mode="same", activation_store_dtype=store)
    params = _params({"W": (3, 3, 3, 4), "b": (4,)}, seed=5)
    x = np.random.default_rng(4).normal(size=(2, 9, 9, 3)).astype(np.float32)
    jdt = getattr(jnp, compute)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    y, vjp = jax.vjp(lambda p, x_: jl.apply(p, {}, x_, train=True)[0], jp,
                     jnp.asarray(x, jdt))
    ct = np.random.default_rng(6).normal(size=y.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(ct, jdt))
    layer = _port(jl)
    tdt = getattr(torch, compute)
    p = {k: torch.tensor(v, dtype=tdt, requires_grad=True)
         for k, v in params.items()}
    xt = torch.tensor(x, dtype=tdt, requires_grad=True)
    yt = layer.apply(p, {}, xt, train=True)[0]
    gx, gW = torch.autograd.grad(yt, (xt, p["W"]), torch.tensor(ct, dtype=tdt))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    _close(yt.detach().float().numpy(), f32(y), tol, "y")
    _close(gx.float().numpy(), f32(jgx), tol, "dx")
    _close(gW.float().numpy(), f32(jgp["W"]), tol, "dW")
    pe = {k: v.detach().requires_grad_() for k, v in p.items()}
    exact = layer.apply(pe, {}, xt, train=False)[0]
    (gW_exact,) = torch.autograd.grad(exact, pe["W"],
                                      torch.tensor(ct, dtype=tdt))
    assert not torch.equal(gW_exact, gW)


# ---------------------------------------------------------------------------
# pooling and padding
# ---------------------------------------------------------------------------
POOL_CASES = [
    # (kernel, stride, padding, mode, size)
    ((2, 2), (2, 2), (0, 0), "truncate", 12),
    ((3, 3), (2, 2), (0, 0), "truncate", 13),               # AlexNet's
    ((3, 3), (2, 2), (1, 1), "truncate", 12),               # torch's padding
    ((3, 3), (1, 1), (2, 2), "truncate", 7),                # past half a kernel
    ((3, 2), (1, 2), (1, 0), "truncate", 9),
    ((3, 3), (2, 2), (0, 0), "same", 12),                   # even split
    ((2, 2), (2, 2), (0, 0), "same", 7),                    # (0, 1)
    ((4, 4), (3, 3), (0, 0), "same", 11),
    ((3, 3), (2, 2), (0, 0), "strict", 9),
]


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("kernel,stride,padding,mode,size", POOL_CASES)
def test_subsampling_layer_matches_jax(ptype, kernel, stride, padding, mode,
                                       size):
    jl = JaxSub(pooling_type=ptype, kernel_size=kernel, stride=stride,
                padding=padding, convolution_mode=mode, pnorm=3)
    x = np.random.default_rng(7).normal(size=(2, size, size + 2, 3)) \
        .astype(np.float32)
    layer = _check_layer(jl, {}, x)
    assert layer.output_type(InputType.convolutional(size, size + 2, 3)) \
        .to_dict() == jl.output_type(
            JaxInputType.convolutional(size, size + 2, 3)).to_dict()


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("kernel,stride,padding,mode,size", [
    (2, 2, 0, "truncate", 10), (3, 1, 2, "truncate", 8),
    (3, 2, 0, "same", 10), (2, 2, 0, "same", 9), (3, 2, 0, "strict", 11)])
def test_subsampling1d_layer_matches_jax(ptype, kernel, stride, padding,
                                         mode, size):
    jl = JaxSub1D(pooling_type=ptype, kernel_size=kernel, stride=stride,
                  padding=padding, convolution_mode=mode)
    x = np.random.default_rng(8).normal(size=(3, size, 4)).astype(np.float32)
    layer = _check_layer(jl, {}, x)
    assert layer.output_type(InputType.recurrent(4, size)).to_dict() == \
        jl.output_type(JaxInputType.recurrent(4, size)).to_dict()


@pytest.mark.parametrize("pad", [(1, 2), (0, 1, 2, 3), (2, 0, 0, 1)])
def test_zero_padding_layer_matches_jax(pad):
    jl = JaxZeroPad(pad=pad)
    x = np.random.default_rng(9).normal(size=(2, 5, 6, 3)).astype(np.float32)
    layer = _check_layer(jl, {}, x)
    assert layer.output_type(InputType.convolutional(5, 6, 3)).to_dict() \
        == jl.output_type(JaxInputType.convolutional(5, 6, 3)).to_dict()


# ---------------------------------------------------------------------------
# LRN, global pooling, the parameter-free and embedding layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, {"n": 3, "k": 1.0, "alpha": 0.5,
                                     "beta": 0.6}, {"n": 7}])
def test_local_response_normalization_matches_jax(kw):
    x = (3 * np.random.default_rng(10).normal(size=(2, 4, 5, 9))) \
        .astype(np.float32)
    _check_layer(JaxLRN(**kw), {}, x)


def test_lrn_even_window_raises_named_error():
    """JAX's padded window gives C + 1 sums for an even n, and the division
    fails to broadcast; the port names the cause."""
    x = np.ones((1, 2, 2, 6), np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        JaxLRN(n=4).apply({}, {}, jnp.asarray(x))
    with pytest.raises(ValueError, match="odd window n, got n=4"):
        _port(JaxLRN(n=4)).apply({}, {}, torch.tensor(x))


def _time_mask(B, T, seed):
    r = np.random.default_rng(seed)
    lengths = r.integers(1, T + 1, B)
    return (np.arange(T)[None] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("shape,masked", [((3, 6, 4), False),
                                          ((3, 6, 4), True),
                                          ((2, 5, 4, 3), False)])
def test_global_pooling_matches_jax(ptype, shape, masked):
    jl = JaxGlobalPooling(pooling_type=ptype, pnorm=3)
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    mask = _time_mask(shape[0], shape[1], 12) if masked else None
    layer = _check_layer(jl, {}, x, mask=mask)
    assert layer.output_mask(torch.ones(3, 6)) is None
    for it in (InputType.recurrent(4, 6), InputType.convolutional(5, 4, 3)):
        jit = JaxInputType.from_dict(it.to_dict())
        assert layer.output_type(it).to_dict() == \
            jl.output_type(jit).to_dict()


def test_activation_and_dropout_layers_match_jax():
    x = np.random.default_rng(13).normal(size=(4, 7)).astype(np.float32)
    _check_layer(JaxActivation(activation="elu"), {}, x)
    dl = _check_layer(JaxDropout(), {}, x)           # inference: identity
    assert dl.dropout == 0.5
    xt = torch.tensor(x)
    y, _ = dl.apply({}, {}, xt, train=True,
                    generator=torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], 2 * xt[kept], rtol=0, atol=0)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"), ("mse", None)])
def test_loss_layer_matches_jax(loss, act):
    jl = JaxLoss(loss=loss, activation=act)
    r = np.random.default_rng(14)
    x = r.normal(size=(5, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, 5)]
    _check_layer(jl, {}, x)
    layer = _port(jl)
    assert layer.activation == jl.activation
    jscore, jgx = jax.value_and_grad(lambda x_: jl.loss_score(
        {}, {}, x_, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    score = layer.loss_score({}, {}, xt, torch.tensor(y))
    (gx,) = torch.autograd.grad(score, xt)
    _close(float(score.detach()), float(jscore), TOL, "score")
    _close(gx.numpy(), np.asarray(jgx), TOL, "dx")
    per = layer.loss_per_example({}, {}, torch.tensor(x), torch.tensor(y))
    _close(per.numpy(), np.asarray(jl.loss_per_example(
        {}, {}, jnp.asarray(x), jnp.asarray(y))), TOL, "per example")


@pytest.mark.parametrize("column", [False, True])
def test_embedding_layer_matches_jax(column):
    """Indices as floats (the network's input dtype), [B] or [B, 1]: a
    fraction truncates, -1 wraps to the last row, an index past the table
    gives a NaN row, as `jnp.take` does."""
    jl = JaxEmbedding(n_in=6, n_out=3, activation="tanh")
    params = _params({"W": (6, 3), "b": (3,)}, seed=15)
    idx = np.array([0, 5, 2.7, -1, 3, 6], np.float32)
    x = idx[:, None] if column else idx
    jy = np.asarray(jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                             {}, jnp.asarray(x))[0])
    assert np.isnan(jy[-1]).all()
    _check_layer(jl, params, x[:-1])
    layer = _port(jl)
    y, _ = layer.apply({k: torch.tensor(v) for k, v in params.items()}, {},
                       torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# input preprocessors
# ---------------------------------------------------------------------------
PREPROCESSORS = [
    (jpp.CnnToFeedForwardPreProcessor(4, 5, 3), (2, 4, 5, 3),
     JaxInputType.convolutional(4, 5, 3)),
    (jpp.FeedForwardToCnnPreProcessor(4, 5, 3), (2, 60),
     JaxInputType.convolutional_flat(4, 5, 3)),
    (jpp.RnnToFeedForwardPreProcessor(), (2, 6, 7),
     JaxInputType.recurrent(7, 6)),
    (jpp.FeedForwardToRnnPreProcessor(timesteps=3), (6, 7),
     JaxInputType.feed_forward(7)),
    (jpp.CnnToRnnPreProcessor(4, 5, 3), (2, 4, 5, 3),
     JaxInputType.convolutional(4, 5, 3)),
    (jpp.RnnToCnnPreProcessor(4, 5, 3), (2, 3, 60),
     JaxInputType.recurrent(60, 3)),
    (jpp.ComposableInputPreProcessor((jpp.CnnToRnnPreProcessor(4, 5, 3),
                                      jpp.RnnToFeedForwardPreProcessor())),
     (2, 4, 5, 3), JaxInputType.convolutional(4, 5, 3)),
]


@pytest.mark.parametrize("jp,shape,it", PREPROCESSORS,
                         ids=[type(p[0]).__name__ for p in PREPROCESSORS])
def test_preprocessor_matches_jax(jp, shape, it):
    """apply (and its gradient), output_type, apply_mask and the JSON form
    of each preprocessor against JAX's."""
    p = _port(jp)
    assert type(p).__name__ == type(jp).__name__
    assert json.dumps(conf_to_dict(p)) == json.dumps(jax_conf_to_dict(jp))
    x = np.random.default_rng(16).normal(size=shape).astype(np.float32)
    want = np.asarray(jp.apply(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = p.apply(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got, xt, torch.ones_like(got))
    assert tuple(g.shape) == shape and bool((g == 1).all())
    assert p.output_type(InputType.from_dict(it.to_dict())).to_dict() == \
        jp.output_type(it).to_dict()
    mask = _time_mask(2, 6, 17)
    jm = jp.apply_mask(jnp.asarray(mask))
    pm = p.apply_mask(torch.tensor(mask))
    np.testing.assert_array_equal(np.asarray(pm), np.asarray(jm))
    assert p.apply_mask(None) is None


_KINDS = {
    "ff": (JaxInputType.feed_forward(12), InputType.feed_forward(12)),
    "cnn": (JaxInputType.convolutional(2, 3, 2),
            InputType.convolutional(2, 3, 2)),
    "cnn_flat": (JaxInputType.convolutional_flat(2, 3, 2),
                 InputType.convolutional_flat(2, 3, 2)),
    "rnn": (JaxInputType.recurrent(12, 4), InputType.recurrent(12, 4)),
    "cnn1d": (JaxInputType.convolutional1d(12, 4),
              InputType.convolutional1d(12, 4)),
}
_WANTS = {"ff": JaxDense(n_out=3), "cnn": JaxConv(n_out=3),
          "rnn": JaxLSTM(n_out=3), "any": JaxActivation()}


@pytest.mark.parametrize("want", sorted(_WANTS))
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_infer_preprocessor_matches_jax(kind, want):
    """Every (input kind, layer family) pair: the same preprocessor, with
    the same fields, or the same ValueError with JAX's words."""
    jit, it = _KINDS[kind]
    jl = _WANTS[want]
    try:
        jres = jpp.infer_preprocessor(jit, jl)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            pp.infer_preprocessor(it, _port(jl))
        assert str(err.value) == str(e)
        return
    res = pp.infer_preprocessor(it, _port(jl))
    assert json.dumps(conf_to_dict(res)) == json.dumps(
        jax_conf_to_dict(jres))
