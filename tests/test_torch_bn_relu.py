"""PyTorch port, the BN+ReLU kernels' plain versions and the fused BN tier,
on the CPU against the JAX package.

  * `bn_relu_reference` / `bn_relu_forward` (the plain forward) against
    JAX's `fused_bn_relu(interpret=True)` (the Pallas kernel in interpret
    mode) and `bn_relu_reference`, float32 and bfloat16 inputs, C in {10,
    48, 200}, and an NHWC input;
  * `bn_relu_backward_reference` (the plain backward, `_bwd_kernel`'s math)
    against JAX's `_bwd_call(interpret=True)` and `jax.grad` of
    `fused_bn_relu`; the autograd Function against torch autograd of the
    plain forward;
  * `fused_bn_act` (identity and ReLU, 2-D and 4-D, with and without a
    `store_dtype`) against JAX's `fused_bn_act` and `jax.grad`;
  * `bn_relu_inference`, `_block_c`, and no kernel launch on the CPU.

Tolerances: float32 results 2e-6 absolute on unit-scale data (sums of at
most 400 float32 terms in another order); bfloat16 outputs within one
bfloat16 ulp of the larger magnitude (2^-7 relative: both sides compute in
float32 and round once, and a value on a rounding boundary may go either
way); gradients, whose reductions run over up to 400 rows, 1e-5 of the
largest entry in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import batchnorm as jax_batchnorm
from deeplearning4j_tpu.kernels import bn_relu as jax_bn
from deeplearning4j_tpu_torch.kernels import batchnorm, bn_relu
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-6
GRAD_TOL = 1e-5
BF16_ULP = 2.0 ** -7     # one ulp of bfloat16 relative to the magnitude


def _data(N, C, seed, shift=0.0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(N, C)) * 1.5 + shift).astype(np.float32)
    g = (1.0 + 0.2 * r.normal(size=C)).astype(np.float32)
    b = (0.3 * r.normal(size=C)).astype(np.float32)
    dy = r.normal(size=(N, C)).astype(np.float32)
    return x, g, b, dy


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _jax(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _close_bf16(got, want, what):
    """Within one bfloat16 ulp of the larger magnitude."""
    got, want = _np(got), _np(want)
    limit = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-30
    bad = np.abs(got - want) > limit
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond one "
                           f"bf16 ulp, max err {np.abs(got - want).max()}")


@pytest.mark.parametrize("C", [10, 48, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax_kernel_and_reference(C, dtype):
    x, g, b, _ = _data(64, C, seed=C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jm, jv = jax_bn.fused_bn_relu(_jax(x, jdt), _jax(g), _jax(b),
                                      interpret=True)
    ry, rm, rv = jax_bn.bn_relu_reference(_jax(x, jdt), _jax(g), _jax(b))
    y, m, v = bn_relu.bn_relu_forward(_torch(x, tdt), _torch(g), _torch(b))
    assert y.dtype == tdt and m.dtype == v.dtype == torch.float32
    for want_y, want_m, want_v, who in ((jy, jm, jv, "kernel"),
                                        (ry, rm, rv, "reference")):
        np.testing.assert_allclose(_np(m), _np(want_m), rtol=0, atol=F32_TOL,
                                   err_msg=f"mean vs JAX {who}")
        np.testing.assert_allclose(_np(v), _np(want_v), rtol=2e-6,
                                   atol=F32_TOL, err_msg=f"var vs JAX {who}")
        if dtype == "float32":
            np.testing.assert_allclose(_np(y), _np(want_y), rtol=0,
                                       atol=F32_TOL, err_msg=f"y vs {who}")
        else:
            _close_bf16(y, want_y, f"y vs JAX {who}")


def test_plain_forward_takes_nhwc_like_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(4, 6, 6, 24)).astype(np.float32)
    _, g, b, _ = _data(1, 24, seed=2)
    jy, jm, jv = jax_bn.fused_bn_relu(_jax(x), _jax(g), _jax(b),
                                      interpret=True)
    y, m, v = bn_relu.fused_bn_relu(_torch(x), _torch(g), _torch(b))
    assert tuple(y.shape) == (4, 6, 6, 24)
    for got, want in ((y, jy), (m, jm), (v, jv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_TOL)


def test_large_mean_channels_keep_the_two_pass_variance():
    """The forward's variance is centred (two passes), as `_fwd_kernel`'s:
    channels with mean 1e3 and unit spread keep their variance."""
    x, g, b, _ = _data(128, 48, seed=3, shift=1e3)
    _, _, v = bn_relu.bn_relu_forward(_torch(x), _torch(g), _torch(b))
    _, _, jv = jax_bn.fused_bn_relu(_jax(x), _jax(g), _jax(b),
                                    interpret=True)
    want = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(_np(v), want, rtol=1e-4)
    np.testing.assert_allclose(_np(v), _np(jv), rtol=1e-5)


@pytest.mark.parametrize("C", [10, 48, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_kernel(C, dtype):
    x, g, b, dy = _data(96, C, seed=10 + C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, jm, jv = jax_bn._fwd_call(_jax(x, jdt), _jax(g), _jax(b), 1e-5, True)
    jdx, jdg, jdb = jax_bn._bwd_call(_jax(x, jdt), _jax(g), _jax(b), jm, jv,
                                     _jax(dy, jdt), 1e-5, True)
    dx, dg, db = bn_relu.bn_relu_backward(
        _torch(x, tdt), _torch(g), _torch(b), _torch(jm), _torch(jv),
        _torch(dy, tdt))
    assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    for name, got, want in (("dg", dg, jdg), ("db", db, jdb)):
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    if dtype == "float32":
        scale = np.abs(_np(jdx)).max()
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=0,
                                   atol=GRAD_TOL * scale)
    else:
        _close_bf16(dx, jdx, "dx")


@pytest.mark.parametrize("C", [10, 48, 200])
def test_function_gradients_match_jax_grad(C):
    """dx, dgamma and dbeta through `fused_bn_relu` (the autograd Function)
    against `jax.grad` of JAX's `fused_bn_relu` (its custom VJP around the
    Pallas kernels, interpret mode), for a weighted-sum loss."""
    x, g, b, w = _data(64, C, seed=20 + C)

    def jloss(x_, g_, b_):
        y, _, _ = jax_bn.fused_bn_relu(x_, g_, b_, interpret=True)
        return jnp.sum(y * _jax(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(_jax(x), _jax(g), _jax(b))
    leaves = [_torch(a).requires_grad_() for a in (x, g, b)]
    y, mean, var = bn_relu.fused_bn_relu(*leaves)
    assert not mean.requires_grad and not var.requires_grad
    grads = torch.autograd.grad((y * _torch(w)).sum(), leaves)
    for name, got, want in zip(("dx", "dgamma", "dbeta"), grads, jgrads):
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("shape", [(50, 12), (3, 5, 4, 12)])
def test_function_equals_autograd_of_the_plain_forward(shape):
    """The Function's hand-written backward against torch autograd through
    `bn_relu_reference`, float32 leaves, 1e-5 of the largest entry."""
    r = np.random.default_rng(30)
    x = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    g = torch.from_numpy((1 + 0.3 * r.normal(size=shape[-1])).astype(
        np.float32))
    b = torch.from_numpy((0.2 * r.normal(size=shape[-1])).astype(np.float32))
    w = torch.from_numpy(r.normal(size=shape).astype(np.float32))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, g, b)]
        y = fn(*leaves)
        return torch.autograd.grad((y * w).sum(), leaves)

    got = grads(lambda x_, g_, b_: bn_relu.fused_bn_relu(x_, g_, b_)[0])
    want = grads(lambda x_, g_, b_: bn_relu.bn_relu_reference(
        x_.reshape(-1, shape[-1]), g_, b_)[0].reshape(shape))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=GRAD_TOL * c.abs().max().item())


def test_bf16_gradients_come_back_in_the_parameter_dtypes():
    x, g, b, w = _data(32, 16, seed=40)
    xb = _torch(x, torch.bfloat16).requires_grad_()
    gb = _torch(g, torch.bfloat16).requires_grad_()
    bf = _torch(b).requires_grad_()
    y, _, _ = bn_relu.fused_bn_relu(xb, gb, bf)
    assert y.dtype == torch.bfloat16
    dx, dg, db = torch.autograd.grad((y.float() * _torch(w)).sum(),
                                     (xb, gb, bf))
    assert (dx.dtype, dg.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16,
                                              torch.float32)


def test_inference_matches_jax():
    x, g, b, _ = _data(20, 48, seed=50)
    r = np.random.default_rng(51)
    mean = r.normal(size=48).astype(np.float32)
    var = r.uniform(0.5, 2.0, size=48).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = bn_relu.bn_relu_inference(_torch(x, tdt), _torch(g),
                                        _torch(b), _torch(mean),
                                        _torch(var))
        want = jax_bn.bn_relu_inference(_jax(x, jdt), _jax(g), _jax(b),
                                        _jax(mean), _jax(var))
        assert got.dtype == tdt
        if tdt == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                       atol=F32_TOL)
        else:
            _close_bf16(got, want, "bf16 inference")


@pytest.mark.parametrize("C", [1, 10, 127, 128, 129, 1024])
@pytest.mark.parametrize("N", [1, 4096, 4097, 16384, 52429, 52430])
def test_block_c_selects_as_jax(C, N):
    assert bn_relu._block_c(C, N) == jax_bn._block_c(C, N)


def test_cpu_launches_no_kernel_and_refuses_bad_shapes():
    bn_relu.reset_launches()
    x, g, b, dy = _data(8, 4, seed=60)
    y, m, v = bn_relu.fused_bn_relu(_torch(x).requires_grad_(), _torch(g),
                                    _torch(b))
    y.sum().backward()
    assert bn_relu.launch_counts() == {"fwd_launches": 0, "bwd_launches": 0}
    with pytest.raises(ValueError, match="shape"):
        bn_relu.bn_relu_forward(_torch(x), _torch(g[:3]), _torch(b))
    with pytest.raises(ValueError, match=r"\[N, C\]"):
        bn_relu.fused_bn_relu(_torch(x[0]), _torch(g), _torch(b))
    with pytest.raises(TypeError, match="floating"):
        bn_relu.bn_relu_forward(torch.ones(8, 4, dtype=torch.int32),
                                _torch(g), _torch(b))


# ---------------------------------------------------------------------------
# fused_bn_act (the one-pass tier)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("shape", [(40, 10), (2, 5, 3, 48)])
@pytest.mark.parametrize("dtype,store", [
    ("float32", ""), ("bfloat16", ""), ("bfloat16", "float8_e4m3fn")])
def test_fused_bn_act_matches_jax(act, shape, dtype, store):
    r = np.random.default_rng(sum(shape))
    x = r.normal(size=shape).astype(np.float32)
    C = shape[-1]
    g = (1.0 + 0.2 * r.normal(size=C)).astype(np.float32)
    b = (0.3 * r.normal(size=C)).astype(np.float32)
    w = r.normal(size=shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x_, g_, b_):
        y, _, _ = jax_batchnorm.fused_bn_act(x_, g_, b_, 1e-5, act, store)
        return jnp.sum(y.astype(jnp.float32) * _jax(w))

    jx = _jax(x, jdt)
    jy, jm, jv = jax_batchnorm.fused_bn_act(jx, _jax(g), _jax(b), 1e-5, act,
                                            store)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jx, _jax(g), _jax(b))
    leaves = [_torch(x, tdt).requires_grad_(), _torch(g).requires_grad_(),
              _torch(b).requires_grad_()]
    y, m, v = batchnorm.fused_bn_act(*leaves, 1e-5, act, store)
    assert y.dtype == tdt and not m.requires_grad and not v.requires_grad
    grads = torch.autograd.grad((y.float() * _torch(w)).sum(), leaves)
    np.testing.assert_allclose(_np(m), _np(jm), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(v), _np(jv), rtol=0, atol=5 * F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=5 * F32_TOL)
    else:
        _close_bf16(y, jy, "y")
    for name, got, want in zip(("dx", "dgamma", "dbeta"), grads, jgrads):
        assert got.dtype == leaves[("dx", "dgamma", "dbeta").index(name)
                                   ].dtype
        if name == "dx" and dtype == "bfloat16":
            _close_bf16(got, want, "dx")
            continue
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_fused_bn_act_refuses_other_activations():
    with pytest.raises(ValueError, match="tanh"):
        batchnorm.fused_bn_act(torch.ones(4, 3), torch.ones(3),
                               torch.zeros(3), 1e-5, "tanh")
