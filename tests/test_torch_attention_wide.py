"""PyTorch port, attention at wide heads and in bf16: the port's plain
versions of the forward (primal and with the logsumexp) and of the dq and
dk/dv kernels at head dimensions 160 and 256, and past the tiled kernels'
256 at 257, 320 and 512 (the CUDA "wide" kernels' range, which no cap
refuses), in float32 and bfloat16, on the same numpy inputs, against the
JAX package's plain oracle `attention_reference` (jitted; its logsumexp
from the same logits, its gradients from `jax.vjp`), the reference the JAX
package's own tests hold its Pallas kernels to; then at the widest head
(Dh 512, causal, both dtypes) against the Pallas kernels themselves in
interpret mode (`_flash_fwd_impl`, `_flash_bwd_impl`). Also the wrapper's
dtype contract (o, dq, dk, dv in q's dtype; L and D float32).

Tolerances: float32 1e-5 absolute (softmax over at most 24 keys of O(1)
logits, sums of up to 512 products in another order than the reference's
einsum or the TPU kernel's blocks); bfloat16 2e-2 absolute, ROADMAP's bf16
limit (both sides compute in float32 from the same bf16 inputs and round
the outputs to bf16, whose spacing is 2^-8 relative, so a value on a
rounding boundary lands one ulp apart). JAX gets explicit float32 or
bfloat16 arrays (the suite enables x64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.attention import (_flash_bwd_impl,
                                                  _flash_fwd_impl,
                                                  attention_reference)
from deeplearning4j_tpu_torch.kernels import attention
from torch_threads import one_torch_thread  # noqa: F401

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


def _heads_first(a):
    """[B, n, H, Dh] -> [B * H, n, Dh]."""
    B, n, H, Dh = a.shape
    return jnp.moveaxis(a, 2, 1).reshape(B * H, n, Dh)


def _heads_back(a, B):
    """[B * H, n, Dh] -> [B, n, H, Dh]."""
    BH, n, Dh = a.shape
    return jnp.moveaxis(a.reshape(B, BH // B, n, Dh), 1, 2)


def _reference_fwd(q, k, v, causal):
    """`attention_reference` per head, and the logsumexp [B, H, T] of the
    same scaled, masked float32 logits."""
    B, T = q.shape[:2]
    qh, kh, vh = (_heads_first(a) for a in (q, k, v))
    o = attention_reference(qh, kh, vh, causal)
    logits = jnp.einsum("bqd,bkd->bqk", qh.astype(jnp.float32),
                        kh.astype(jnp.float32)) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        S = k.shape[1]
        logits = jnp.where(jnp.arange(S)[None, :] <= jnp.arange(T)[:, None],
                           logits, -jnp.inf)
    lse = jax.nn.logsumexp(logits, axis=-1).reshape(B, -1, T)
    return _heads_back(o, B), lse


def _reference_bwd(q, k, v, do, causal):
    """dq, dk, dv of `attention_reference` (`jax.vjp`), per head."""
    B = q.shape[0]
    f = lambda q_, k_, v_: attention_reference(q_, k_, v_, causal)
    _, vjp = jax.vjp(f, *(_heads_first(a) for a in (q, k, v)))
    return tuple(_heads_back(g, B) for g in vjp(_heads_first(do)))


_reference_fwd = jax.jit(_reference_fwd, static_argnums=3)
_reference_bwd = jax.jit(_reference_bwd, static_argnums=4)
_JAX_FORWARD = {}


def _jax_forward(T, S, causal, Dh, dtype):
    """The reference forward (o and logsumexp) of one case's inputs,
    computed once for the module: the forward test and the backward test
    of a case share it (the inputs are seeded alike)."""
    key = (T, S, causal, Dh, dtype)
    if key not in _JAX_FORWARD:
        q, k, v, _ = _arrays(T, S, Dh, dtype, seed=T + S + Dh)
        o, lse = _reference_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                                causal)
        _JAX_FORWARD[key] = np.asarray(o), np.asarray(lse)
    return _JAX_FORWARD[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [160, 256, 257, 320, 512])
@pytest.mark.parametrize("T,S,causal", CASES)
def test_forward_matches_jax_pallas_kernel(T, S, causal, Dh, dtype):
    q, k, v, _ = _arrays(T, S, Dh, dtype, seed=T + S + Dh)
    want_o, want_lse = _jax_forward(T, S, causal, Dh, dtype)
    tq, tk, tv = (t.to(getattr(torch, dtype)) for t in _t(q, k, v))
    o, lse = attention.flash_attention_fwd_lse_heads(tq, tk, tv, causal)
    out = attention.flash_attention_heads(tq, tk, tv, causal)
    assert o.dtype == out.dtype == tq.dtype and lse.dtype == torch.float32
    _close(o, want_o, TOL[dtype], "o")
    _close(out, want_o, TOL[dtype], "primal o")
    _close(lse, want_lse, TOL["float32"], "L")      # float32 on both sides


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [160, 256, 257, 320, 512])
@pytest.mark.parametrize("T,S,causal", CASES)
def test_backward_matches_jax_pallas_kernels(T, S, causal, Dh, dtype):
    """The same q, k, v, o, logsumexp and cotangent into the port's
    backward; the reference's gradients from `jax.vjp`."""
    q, k, v, do = _arrays(T, S, Dh, dtype, seed=T + S + Dh)
    o, lse = _jax_forward(T, S, causal, Dh, dtype)
    want = _reference_bwd(*(jnp.asarray(a) for a in (q, k, v, do)), causal)
    lse = torch.from_numpy(np.ascontiguousarray(lse))
    dt = getattr(torch, dtype)
    tq, tk, tv, to, tdo = (t.to(dt) for t in _t(q, k, v, o, do))
    got = attention.flash_attention_bwd_heads(tq, tk, tv, to, lse, tdo,
                                              causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt and g.shape == w.shape, name
        _close(g, np.asarray(w, np.float32), TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_widest_head_matches_the_pallas_kernels_in_interpret_mode(dtype):
    """Dh 512, causal: the port's forward, logsumexp and dq / dk / dv
    against JAX's Pallas kernels themselves (interpret mode), on the
    inputs and cotangent of the parametrised cases."""
    T = S = 24
    Dh, causal = 512, True
    q, k, v, do = _arrays(T, S, Dh, dtype, seed=T + S + Dh)
    scale = float(1.0 / np.sqrt(Dh))
    o, lse = _per_head(
        lambda q_, k_, v_: _flash_fwd_impl(q_, k_, v_, causal, scale, BLOCK,
                                           BLOCK, True, emit_lse=True),
        q, k, v)
    dt = getattr(torch, dtype)
    tq, tk, tv, tdo = (t.to(dt) for t in _t(q, k, v, do))
    got_o, got_lse = attention.flash_attention_fwd_lse_heads(tq, tk, tv,
                                                             causal)
    _close(got_o, o, TOL[dtype], "o")
    # the TPU kernel's L is padded to its block
    _close(got_lse, lse[:, :, :T], TOL["float32"], "L")
    want = _per_head(
        lambda q_, k_, v_, o_, l_, g_: _flash_bwd_impl(
            q_, k_, v_, o_, l_, g_, causal, scale, BLOCK, BLOCK, True),
        q, k, v, o, np.moveaxis(lse, 1, 2), do)
    got = attention.flash_attention_bwd_heads(
        tq, tk, tv, _t(o)[0].to(dt),
        torch.from_numpy(np.ascontiguousarray(lse[:, :, :T])), tdo, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, TOL[dtype], name)
