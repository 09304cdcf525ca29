"""PyTorch port, LSTM sequence kernel variants, on the CPU.

  * `sequence_plan` / `sequence_variant` (which kernel a shape takes and
    how it is launched) at every shape of the card tests and the char-RNN
    paths: the CTAs' hidden-unit and input-row slices cover H and F (the
    last slices may be short or empty), the groups cover the batch, every
    cluster CTA's shared memory fits MAX_SHARED_BYTES, the char-RNN takes
    "cluster", and shapes past the limit take "streamed";
  * the plain forward, residual forward and backward against the JAX
    package's Pallas kernels in interpret mode (as its own tests run them
    on the CPU) at H = 37 and 201 (not multiples of the cluster size) and
    at the variant boundary H and H + 1.

Tolerance atol 1e-5: float32 sums of at most F + H = 317 terms (dW and db:
B * T = 4 more) in another order, over 2 steps, against values of order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import lstm as jax_lstm
from deeplearning4j_tpu_torch.kernels import lstm
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
OFFS = 1.0
GRADS = ("dx", "dW", "db", "dpeep", "dh0", "dc0")

CHAR_RNN = [(B, F, 200) for B in (1, 8, 32, 64) for F in (77, 200)]
# (B, F, H) of tests/test_torch_cuda.py's LSTM cases and chip_smoke.py's
CARD = [(32, 77, 200), (8, 200, 200), (1, 77, 200), (3, 5, 6), (2, 33, 300),
        (2, 1000, 257), (3, 58200, 2), (2, 120000, 40), (2, 9, 16),
        (64, 77, 200), (64, 200, 200), (1, 200, 200), (3, 5, 37),
        (13, 5, 37), (1, 5, 37), (5, 130, 70), (4, 5, 37), (4, 11, 16),
        (2, 5, 312), (2, 5, 313), (4, 77, 512), (3, 1000, 257)]
STREAMED = [(2, 1000, 257), (3, 58200, 2), (2, 120000, 40), (2, 5, 313),
            (4, 77, 512), (3, 1000, 257), (1, 5, 9685)]


def _boundary(B, F):
    """The largest H that takes the cluster variant at (B, F)."""
    return max(h for h in range(1, 1024)
               if lstm.sequence_variant(B, F, h) == "cluster")


@pytest.mark.parametrize("B,F,H", sorted(set(CHAR_RNN + CARD)))
def test_plan_covers_the_problem_and_fits_a_cta(B, F, H):
    plan = lstm.sequence_plan(B, F, H)
    assert plan.variant == lstm.sequence_variant(B, F, H)
    assert plan == lstm.sequence_plan(B, F, H)        # the shape alone
    # the groups cover the batch, none empty
    assert plan.groups * plan.group >= B > (plan.groups - 1) * plan.group
    if plan.variant == "streamed":
        assert (plan.group, plan.groups) == (1, B)
        return
    n, U, Fr = lstm.CLUSTER_SIZE, plan.units, plan.x_rows
    # CTA r owns units [r U, r U + U) and input rows [r Fr, r Fr + Fr) of
    # W, cut at H and F: together every unit and row exactly once
    units = [u for r in range(n) for u in range(r * U, min(H, r * U + U))]
    rows = [f for r in range(n) for f in range(r * Fr, min(F, r * Fr + Fr))]
    assert units == list(range(H)) and rows == list(range(F))
    assert plan.group in lstm.GROUP_ROWS
    for adjoint, got in ((False, plan.fwd_bytes), (True, plan.bwd_bytes)):
        assert got == lstm.cluster_bytes(F, H, U, Fr, plan.group, adjoint)
        assert 0 < got <= lstm.MAX_SHARED_BYTES
    # a column group of four per thread at most, K-slices of at least one
    assert U <= lstm.CLUSTER_THREADS
    assert -(-(U + Fr) // 4) <= lstm.CLUSTER_THREADS


@pytest.mark.parametrize("B,F,H", CHAR_RNN)
def test_char_rnn_takes_the_cluster_variant_over_many_sms(B, F, H):
    plan = lstm.sequence_plan(B, F, H)
    assert plan.variant == "cluster"
    assert (plan.units, plan.x_rows) == (25, -(-F // 8))
    # the fewest rows a cluster for which the clusters run side by side
    assert plan.group == {1: 1, 8: 1, 32: 3, 64: 5}[B]
    assert plan.groups <= lstm.CLUSTER_GROUPS
    assert plan.groups * lstm.CLUSTER_SIZE == {1: 8, 8: 64, 32: 88,
                                               64: 104}[B]


@pytest.mark.parametrize("B,F,H", STREAMED)
def test_shapes_past_a_cta_take_the_streamed_variant(B, F, H):
    plan = lstm.sequence_plan(B, F, H)
    assert plan.variant == "streamed"
    assert (plan.units, plan.fwd_bytes, plan.bwd_bytes) == (0, 0, 0)
    U, Fr = -(-H // 8), -(-F // 8)
    assert min(max(lstm.cluster_bytes(F, H, U, Fr, g, False),
                   lstm.cluster_bytes(F, H, U, Fr, g, True))
               for g in lstm.GROUP_ROWS) > lstm.MAX_SHARED_BYTES


def test_group_shrinks_before_the_variant_changes():
    """A batch that wants 8 rows a cluster takes fewer where 8 do not fit
    (B = 128 at the char-RNN's second layer: the adjoint's buffers fit at
    5 rows, not at 6)."""
    plan = lstm.sequence_plan(128, 200, 200)
    assert plan.variant == "cluster" and plan.group == 5
    assert plan.groups == 26          # two waves of clusters
    assert lstm.cluster_bytes(200, 200, 25, 25, 6, True) > \
        lstm.MAX_SHARED_BYTES
    # and a huge batch runs in waves of clusters of 8 rows
    assert lstm.sequence_plan(4096, 77, 64).group == 8


@pytest.mark.parametrize("B,F", [(2, 5), (64, 77), (64, 200), (1, 58200)])
def test_variant_boundary_in_h(B, F):
    """Below the boundary H every width is "cluster", above it "streamed";
    the boundary sits where a CTA's bytes pass MAX_SHARED_BYTES."""
    if F == 58200:   # a slice of 7,275 input rows never fits a CTA
        assert all(lstm.sequence_variant(B, F, h) == "streamed"
                   for h in (1, 2, 64, 200))
        return
    hb = _boundary(B, F)
    assert all(lstm.sequence_variant(B, F, h) == "cluster"
               for h in range(1, hb + 1))
    assert all(lstm.sequence_variant(B, F, h) == "streamed"
               for h in range(hb + 1, hb + 64))
    U, Fr = -(-(hb + 1) // 8), -(-F // 8)
    assert max(lstm.cluster_bytes(F, hb + 1, U, Fr, 1, False),
               lstm.cluster_bytes(F, hb + 1, U, Fr, 1, True)) > \
        lstm.MAX_SHARED_BYTES


def test_boundary_of_the_jax_comparisons():
    assert _boundary(2, 5) == 312


# ---------------------------------------------------------------------------
# the plain versions against JAX's Pallas kernels, at the widths the
# variants split on
# ---------------------------------------------------------------------------
def _arrays(T, B, F, H, seed):
    r = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(F + H)
    f32 = lambda a: a.astype(np.float32)
    return (f32(r.normal(size=(T, B, F))),
            f32(r.normal(size=(F + H, 4 * H)) * k),
            f32(r.normal(size=(4 * H,)) * 0.1),
            f32(r.normal(size=(3 * H,)) * 0.1),
            f32(r.normal(size=(B, H)) * 0.5),
            f32(r.normal(size=(B, H)) * 0.5))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


WIDTHS = [37, 201, 312, 313]   # not multiples of 8; the boundary at (2, 5)


@pytest.mark.parametrize("H", WIDTHS)
def test_plain_forward_matches_jax_pallas_kernel(H):
    arrays = _arrays(2, 2, 5, H, seed=H)
    want = jax_lstm.fused_lstm_sequence(*map(jnp.asarray, arrays), OFFS,
                                        True)
    got = lstm.fused_lstm_sequence(*map(torch.from_numpy, arrays), OFFS)
    for name, g, w in zip(("hs", "h_T", "c_T"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("H", WIDTHS)
def test_plain_residual_forward_matches_jax_pallas_kernel(H):
    arrays = _arrays(2, 2, 5, H, seed=H + 1)
    canon = jax_lstm._canon(*map(jnp.asarray, arrays))
    want = jax_lstm._fwd_impl(*canon, OFFS, True, save_residuals=True)
    got = lstm.lstm_residual_forward(*map(torch.from_numpy, arrays), OFFS)
    got = (got[0],) + got[3:]        # hs, cs, i, f, o, g
    for name, g, w in zip(("hs", "cs", "i", "f", "o", "g"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("H", WIDTHS)
def test_plain_backward_matches_jax_pallas_vjp(H):
    T, B, F = 2, 2, 5
    arrays = _arrays(T, B, F, H, seed=H + 2)
    r = np.random.default_rng(H + 3)
    cots = tuple(r.normal(size=s).astype(np.float32)
                 for s in ((T, B, H), (B, H), (B, H)))
    _, vjp = jax.vjp(lambda *a: jax_lstm.fused_lstm_sequence(*a, OFFS, True),
                     *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cots)))
    x, W, b, peep, h0, c0 = map(torch.from_numpy, arrays)
    res = lstm.lstm_residual_forward(x, W, b, peep, h0, c0, OFFS)
    hs, cs, ii, ff, oo, gg = (res[0],) + res[3:]
    before = lstm.launch_counts()
    got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, hs, cs, ii, ff, oo,
                                      gg, *map(torch.from_numpy, cots))
    assert lstm.launch_counts() == before      # the CPU launches nothing
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_variant_counts_stay_zero_on_the_cpu():
    arrays = _arrays(2, 2, 5, 37, seed=0)
    lstm.reset_launches()
    lstm.fused_lstm_sequence(*map(torch.from_numpy, arrays), OFFS)
    counts = lstm.variant_counts()
    assert set(counts) == {"fwd", "residual", "adjoint"}
    assert all(c == {"cluster": 0, "streamed": 0} for c in counts.values())
