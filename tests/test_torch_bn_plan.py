"""PyTorch port, the BN+ReLU kernels' launch plan (`bn_relu.bn_plan`) and
their plain versions at the plan's boundary shapes, on the CPU.

  * `bn_plan` at every shape `chip_smoke.py` phase 2 and the card tests
    give the kernels, at the BN-MLP's N = 128 and 4096, and at C in {1, 10,
    48, 127, 128, 200, 1024} for N up to the largest `_block_c` admits
    (the BN layer's tier): the slabs cover N and C, a CTA's shared memory
    fits 227 KB, clusters are portable (at most 8 CTAs), N = 128 at
    C = 1024 runs without a cluster, and each variant is reached at its
    boundary N and at N + 1;
  * the plain forward and backward (what a CPU tensor runs, and what the
    card's kernels are held to) against JAX's Pallas kernels in interpret
    mode, as JAX's own tests run them, at ragged N (1, 3, 4097) and at the
    variants' boundary shapes, within the tolerances of
    tests/test_torch_bn_relu.py (float32 2e-6 absolute on unit-scale data,
    the variance also 2e-6 relative; bfloat16 outputs one bfloat16 ulp of
    the larger magnitude; gradients 1e-5 of the largest entry). A bfloat16
    dx is a gradient rounded to bfloat16, so it takes both: 1e-5 of the
    largest entry plus one ulp. (At N = 28,672 the two sides' dgamma and
    dbeta, sums of 28,672 terms in another order, agree to 3e-7 of their
    largest; where n * dyr - dbeta - xhat * dgamma cancels to ~1e-8, the
    rounded dx lands a few ulps apart, 2e-10 absolute.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import bn_relu as jax_bn
from deeplearning4j_tpu_torch.kernels import bn_relu
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-6
GRAD_TOL = 1e-5
BF16_ULP = 2.0 ** -7
MAX_SHARED = 227 * 1024

# The boundary N of the resident variant: a cluster of 8 CTAs each holding
# 7168 rows (one slab) or 3584 (x and dy), rows reserved 128 at a time
FWD_LIMIT, BWD_LIMIT = 8 * 7168, 8 * 3584


def _largest_n(C):
    """The largest N `_block_c` admits at width C (the BN layer's tier)."""
    bc = 128 if C >= 128 else C
    return 2 * 1024 * 1024 // (4 * bc)


def _plan_shapes():
    shapes = {(n, c) for n in (128, 4096, 4097) for c in (1024, 200, 48)}
    shapes |= {(2 * 14 * 14, 64), (2 * 21 * 7, 64), (5 * 3 * 3823, 16),
               (256, 96), (30000, 8), (1, 48), (33, 10), (64, 7),
               (28673, 10), (57345, 8)}
    for C in (1, 10, 48, 127, 128, 200, 1024):
        top = _largest_n(C)
        shapes |= {(n, C) for n in (1, 2, 3, 127, 128, 129, 511, 512, 1023,
                                    1024, 1025, 4096, 4097, BWD_LIMIT,
                                    BWD_LIMIT + 1, FWD_LIMIT, FWD_LIMIT + 1,
                                    top) if n <= top}
    return sorted(shapes)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("N,C", _plan_shapes())
def test_plan_covers_the_batch_within_a_cta(N, C, itemsize, backward):
    plan = bn_relu.bn_plan(N, C, itemsize, backward)
    assert plan.variant in ("resident", "streamed")
    assert plan.smem_bytes <= MAX_SHARED
    groups = -(-C // plan.channels)
    assert plan.channels * groups >= C > plan.channels * (groups - 1)
    assert plan.ctas == groups * plan.cluster
    # the ranks' row slabs cover N, and no rank is wholly past it
    assert plan.rows * plan.cluster >= N > plan.rows * (plan.cluster - 1)
    assert 1 <= plan.cluster <= 8 and plan.cluster & (plan.cluster - 1) == 0
    if plan.variant == "resident":
        # one 32-byte sector a row: 16 two-byte or 8 four-byte channels
        assert plan.channels * itemsize == 32
        assert plan.smem_bytes == bn_relu.resident_bytes(plan.rows, backward)
        assert plan.rows <= (3584 if backward else 7168)
    else:
        assert (plan.channels, plan.cluster, plan.rows) == (32, 1, N)
        assert N > (BWD_LIMIT if backward else FWD_LIMIT)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_main_path_plans(itemsize):
    """The BN-MLP's N = 128 runs without a cluster (the channel groups
    alone, one pack a thread); N = 4096 at C = 1024 fills the card in about
    one wave."""
    for backward in (False, True):
        small = bn_relu.bn_plan(128, 1024, itemsize, backward)
        assert (small.variant, small.cluster, small.rows) == ("resident", 1,
                                                              128)
        big = bn_relu.bn_plan(4096, 1024, itemsize, backward)
        assert big.variant == "resident"
        assert 64 <= big.ctas <= 2 * 132
    bf16 = bn_relu.bn_plan(4096, 1024, 2, True)
    assert (bf16.cluster, bf16.ctas) == (2, 128)
    # the narrow shapes the streamed kernels ran on 7 and 2 blocks
    for C, ctas in ((200, 104), (48, 24)):
        assert bn_relu.bn_plan(4096, C, 2, False).ctas == ctas


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("backward,limit", [(False, FWD_LIMIT),
                                            (True, BWD_LIMIT)])
@pytest.mark.parametrize("C", [1, 8, 10, 1024])
def test_each_variant_at_its_boundary(C, backward, limit, itemsize):
    at = bn_relu.bn_plan(limit, C, itemsize, backward)
    past = bn_relu.bn_plan(limit + 1, C, itemsize, backward)
    assert (at.variant, at.cluster, at.rows) == ("resident", 8,
                                                 limit // 8)
    assert past.variant == "streamed"
    assert at.smem_bytes <= MAX_SHARED < bn_relu.resident_bytes(
        -(-(limit + 1) // 8), backward)


def test_the_tier_sends_streamed_shapes_only_at_narrow_widths():
    """`_block_c` admits up to 524,288 / C rows below C = 128: the widths
    whose largest admitted N passes a resident slab are C <= 18 (the
    backward) and C <= 9 (the forward); every other batch the BN layer
    sends to the kernels runs resident."""
    for C in range(1, 300):
        top = _largest_n(C)
        for backward, widest in ((False, 9), (True, 18)):
            variant = bn_relu.bn_plan(top, C, 2, backward).variant
            assert (variant == "streamed") == (C <= widest), (C, backward)


def test_plan_refuses_other_value_sizes():
    with pytest.raises(ValueError, match="8-byte"):
        bn_relu.bn_plan(4, 4, 8, False)


def test_no_cuda_launch_here():
    bn_relu.reset_launches()
    x = torch.ones(8, 4)
    bn_relu.fused_bn_relu(x.requires_grad_(), torch.ones(4),
                          torch.zeros(4))[0].sum().backward()
    assert bn_relu.launch_counts() == {"fwd_launches": 0, "bwd_launches": 0}
    assert bn_relu.variant_counts() == {
        kind: {"resident": 0, "streamed": 0} for kind in ("fwd", "bwd")}


# ---------------------------------------------------------------------------
# the plain versions against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _data(N, C, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(N, C)) * 1.5).astype(np.float32)
    g = (1.0 + 0.2 * r.normal(size=C)).astype(np.float32)
    b = (0.3 * r.normal(size=C)).astype(np.float32)
    dy = r.normal(size=(N, C)).astype(np.float32)
    return x, g, b, dy


def _np(a):
    return np.asarray(a.detach().float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _close_bf16(got, want, what, atol=1e-30):
    got, want = _np(got), _np(want)
    limit = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + atol
    bad = np.abs(got - want) > limit
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond one "
                           f"bf16 ulp, max err {np.abs(got - want).max()}")


# ragged N, and the shapes at and past each variant's boundary (C small
# enough that `_block_c` admits the batch to JAX's kernel)
PLAIN_SHAPES = [(1, 48), (3, 10), (4097, 100), (BWD_LIMIT, 8),
                (BWD_LIMIT + 1, 8), (FWD_LIMIT, 8), (FWD_LIMIT + 1, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,C", PLAIN_SHAPES)
def test_plain_versions_match_jax_kernels(N, C, dtype):
    assert jax_bn._block_c(C, N) is not None
    x, g, b, dy = _data(N, C, seed=N + C)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    jy, jm, jv = jax_bn._fwd_call(jx, jnp.asarray(g), jnp.asarray(b), 1e-5,
                                  True)
    jdx, jdg, jdb = jax_bn._bwd_call(jx, jnp.asarray(g), jnp.asarray(b), jm,
                                     jv, jdy, 1e-5, True)
    tx = torch.from_numpy(x).to(tdt)
    y, m, v = bn_relu.bn_relu_forward(tx, torch.from_numpy(g),
                                      torch.from_numpy(b))
    dx, dg, db = bn_relu.bn_relu_backward(
        tx, torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(_np(jm).copy()), torch.from_numpy(_np(jv).copy()),
        torch.from_numpy(dy).to(tdt))
    assert y.dtype == dx.dtype == tdt
    np.testing.assert_allclose(_np(m), _np(jm), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(_np(v), _np(jv), rtol=2e-6, atol=F32_TOL)
    for name, got, want in (("dg", dg, jdg), ("db", db, jdb)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=GRAD_TOL * np.abs(_np(want)).max(),
                                   err_msg=name)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(jy), rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(_np(dx), _np(jdx), rtol=0,
                                   atol=GRAD_TOL * np.abs(_np(jdx)).max())
    else:
        _close_bf16(y, jy, "y")
        _close_bf16(dx, jdx, "dx", atol=GRAD_TOL * np.abs(_np(jdx)).max())
