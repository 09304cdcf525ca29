"""PyTorch port, attention at wide heads and in bf16: the port's plain
versions of the forward (primal and with the logsumexp) and of the dq and
dk/dv kernels against the JAX package's Pallas kernels in interpret mode
(`_flash_fwd_impl`, `_flash_bwd_impl`) at head dimensions 160 and 256,
and past the tiled kernels' 256 at 257, 320 and 512 (the CUDA "wide"
kernels' range, which no cap refuses), in float32 and bfloat16, on the same
numpy inputs; and the wrapper's dtype contract (o, dq, dk, dv in q's
dtype; L and D float32).

Tolerances: float32 1e-5 absolute (softmax over at most 24 keys of O(1)
logits, sums of up to 512 products in another order than the TPU kernel's
blocks); bfloat16 2e-2 absolute, PR 5's bf16 limit (both sides compute in
float32 from the same bf16 inputs and round the outputs to bf16, whose
spacing is 2^-8 relative, so a value on a rounding boundary lands one ulp
apart). JAX gets explicit float32 or bfloat16 arrays (the suite enables
x64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.attention import (_flash_bwd_impl,
                                                  _flash_fwd_impl)
from deeplearning4j_tpu_torch.kernels import attention

HEADS, BLOCK = 2, 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(24, 24, True), (20, 13, False)]


def _arrays(T, S, Dh, dtype, seed):
    """q, k, v, do as numpy [B, *, H, Dh] of `dtype` (standard normal,
    rounded to it)."""
    r = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(r.normal(size=(2, n, HEADS, Dh)),
                                   getattr(jnp, dtype)))
            for n in (T, S, S, T)]


def _per_head(fn, *arrays):
    """`fn` on each head's [B, *, Dh] slice; results stacked back on a head
    axis: a [B, *, Dh] result becomes [B, *, H, Dh], a [B, T] one
    [B, H, T]."""
    outs = [fn(*(jnp.asarray(a[:, :, h]) for a in arrays))
            for h in range(arrays[0].shape[2])]
    stack = lambda parts: np.stack([np.asarray(p) for p in parts],
                                   axis=2 if np.ndim(parts[0]) == 3 else 1)
    return tuple(stack(parts) for parts in zip(*outs))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [160, 256, 257, 320, 512])
@pytest.mark.parametrize("T,S,causal", CASES)
def test_forward_matches_jax_pallas_kernel(T, S, causal, Dh, dtype):
    q, k, v, _ = _arrays(T, S, Dh, dtype, seed=T + S + Dh)
    scale = float(1.0 / np.sqrt(Dh))
    want_o, want_lse = _per_head(
        lambda q_, k_, v_: _flash_fwd_impl(q_, k_, v_, causal, scale, BLOCK,
                                           BLOCK, True, emit_lse=True),
        q, k, v)
    tq, tk, tv = (t.to(getattr(torch, dtype)) for t in _t(q, k, v))
    o, lse = attention.flash_attention_fwd_lse_heads(tq, tk, tv, causal)
    out = attention.flash_attention_heads(tq, tk, tv, causal)
    assert o.dtype == out.dtype == tq.dtype and lse.dtype == torch.float32
    _close(o, want_o, TOL[dtype], "o")
    _close(out, want_o, TOL[dtype], "primal o")
    # L is float32 on both sides; the TPU kernel's is padded to the block
    _close(lse, want_lse[:, :, :T], TOL["float32"], "L")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [160, 256, 257, 320, 512])
@pytest.mark.parametrize("T,S,causal", CASES)
def test_backward_matches_jax_pallas_kernels(T, S, causal, Dh, dtype):
    """The same q, k, v, o, logsumexp and cotangent into both backwards."""
    q, k, v, do = _arrays(T, S, Dh, dtype, seed=2 * T + S + Dh)
    scale = float(1.0 / np.sqrt(Dh))
    o, lse = _per_head(
        lambda q_, k_, v_: _flash_fwd_impl(q_, k_, v_, causal, scale, BLOCK,
                                           BLOCK, True, emit_lse=True),
        q, k, v)
    want = _per_head(
        lambda q_, k_, v_, o_, l_, g_: _flash_bwd_impl(
            q_, k_, v_, o_, l_, g_, causal, scale, BLOCK, BLOCK, True),
        q, k, v, o, np.moveaxis(lse, 1, 2), do)
    lse = torch.from_numpy(np.ascontiguousarray(lse[:, :, :T]))
    dt = getattr(torch, dtype)
    tq, tk, tv, to, tdo = (t.to(dt) for t in _t(q, k, v, o, do))
    got = attention.flash_attention_bwd_heads(tq, tk, tv, to, lse, tdo,
                                              causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        _close(g, w, TOL[dtype], name)
