"""PyTorch port, the attention backward: the port's plain versions of the
logsumexp-emitting forward and of the dq and dk/dv kernels against the JAX
package's Pallas kernels in interpret mode (`_flash_fwd_impl(...,
emit_lse=True)`, `_flash_bwd_impl`) and against `jax.grad` of its
`attention_reference`, on the same numpy inputs; the autograd Function on
the CPU against autograd of the plain forward; the launch counts and the
dtypes the CPU path takes.

Shapes are the cases of the JAX package's own backward tests: ragged
(T 33, S 17) non-causal, (50, 50) causal and (48, 48) causal, with head
dimensions 32, 16 and 64, two heads, the TPU kernel's blocks at 16 so that
both axes leave tails.

Tolerances: the forward and the logsumexp atol 2e-6 (float32 throughout,
softmax over at most 50 keys of O(1) logits, sums in another order);
gradients rtol 2e-4 / atol 2e-5, the JAX package's own backward tolerance
(`tests/test_kernels.py`). JAX gets explicit float32 arrays (the suite
enables x64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.attention import (_flash_bwd_impl,
                                                  _flash_fwd_impl)
from deeplearning4j_tpu.kernels.attention import \
    attention_reference as jax_reference
from deeplearning4j_tpu_torch.kernels import attention

FWD_ATOL = 2e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
HEADS, BLOCK = 2, 16
CASES = [(33, 17, 32, False), (50, 50, 16, True), (48, 48, 64, True)]


def _arrays(T, S, Dh, seed):
    """q, k, v, do as float32 numpy [B, *, H, Dh], standard normal."""
    r = np.random.default_rng(seed)
    return [r.normal(size=(2, n, HEADS, Dh)).astype(np.float32)
            for n in (T, S, S, T)]


def _per_head(fn, *arrays):
    """`fn` on each head's [B, *, Dh] slice of the [B, *, H, Dh] arrays;
    results stacked on a head axis at position 1 of their inputs' layout:
    a [B, *, Dh] result becomes [B, *, H, Dh], a [B, T] one [B, H, T]."""
    outs = [fn(*(jnp.asarray(a[:, :, h]) for a in arrays))
            for h in range(arrays[0].shape[2])]
    stack = lambda parts: np.stack([np.asarray(p) for p in parts],
                                   axis=2 if np.ndim(parts[0]) == 3 else 1)
    if isinstance(outs[0], tuple):
        return tuple(stack(parts) for parts in zip(*outs))
    return stack(outs)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,S,Dh,causal", CASES)
def test_lse_forward_matches_jax_pallas_kernel(T, S, Dh, causal):
    q, k, v, _ = _arrays(T, S, Dh, seed=T + S + Dh)
    scale = 1.0 / np.sqrt(Dh)
    want_o, want_lse = _per_head(
        lambda q_, k_, v_: _flash_fwd_impl(q_, k_, v_, causal, float(scale),
                                           BLOCK, BLOCK, True, emit_lse=True),
        q, k, v)
    got_o, got_lse = attention.flash_attention_fwd_lse_heads(
        *_t(q, k, v), causal)
    assert got_lse.shape == (2, HEADS, T) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=0, atol=FWD_ATOL)
    # the TPU kernel's logsumexp is padded to the block: keep [:, :T]
    np.testing.assert_allclose(got_lse.numpy(), want_lse[:, :, :T], rtol=0,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("T,S,Dh,causal", CASES)
def test_backward_matches_jax_pallas_kernels(T, S, Dh, causal):
    """The same q, k, v, o, logsumexp and cotangent into both backwards."""
    q, k, v, do = _arrays(T, S, Dh, seed=2 * T + S + Dh)
    scale = float(1.0 / np.sqrt(Dh))
    o, lse = _per_head(
        lambda q_, k_, v_: _flash_fwd_impl(q_, k_, v_, causal, scale, BLOCK,
                                           BLOCK, True, emit_lse=True),
        q, k, v)
    # JAX's backward takes its forward's block-padded [B, Tp] logsumexp
    want = _per_head(
        lambda q_, k_, v_, o_, l_, g_: _flash_bwd_impl(
            q_, k_, v_, o_, l_, g_, causal, scale, BLOCK, BLOCK, True),
        q, k, v, o, np.moveaxis(lse, 1, 2), do)
    lse = np.ascontiguousarray(lse[:, :, :T])
    got = attention.flash_attention_bwd_heads(*_t(q, k, v, o, lse, do),
                                              causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("T,S,Dh,causal", CASES)
def test_function_gradient_matches_jax_grad_of_reference(T, S, Dh, causal):
    q, k, v, do = _arrays(T, S, Dh, seed=3 * T + S + Dh)

    def loss(q_, k_, v_):
        out = jax.vmap(lambda a, b, c: jax_reference(a, b, c, causal),
                       in_axes=2, out_axes=2)(q_, k_, v_)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = attention.flash_attention_heads(*leaves, causal)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_function_equals_autograd_of_the_plain_forward(causal):
    q, k, v, do = _t(*_arrays(21, 30 if not causal else 21, 8, seed=7))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.flash_attention_heads(*a, causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    ref = attention.attention_reference_heads(*b, causal)
    torch.testing.assert_close(out, ref, rtol=0, atol=FWD_ATOL)
    got = torch.autograd.grad((out * do).sum(), a)
    want = torch.autograd.grad((ref * do).sum(), b)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_dq_entry_forms_d_and_dkv_entry_reads_it():
    q, k, v, do = _t(*_arrays(20, 20, 8, seed=9))
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, True)
    dq, dsum = attention.attention_bwd_dq(q, k, v, o, lse, do, True)
    torch.testing.assert_close(dsum, (do * o).sum(-1).permute(0, 2, 1),
                               rtol=0, atol=1e-6)
    dk, dv = attention.attention_bwd_dkv(q, k, v, do, lse, dsum, True)
    for g, w in zip((dq, dk, dv), attention.attention_bwd_reference_heads(
            q, k, v, o, lse, do, True)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_no_grad_and_inference_mode_take_the_primal_forward():
    leaves = [t.requires_grad_() for t in _t(*_arrays(9, 9, 8, seed=1)[:3])]
    with torch.no_grad():
        assert attention.flash_attention_heads(*leaves, True).grad_fn is None
    with torch.inference_mode():
        out = attention.flash_attention_heads(*(t.detach() for t in leaves))
    assert out.grad_fn is None


def test_cpu_forward_and_backward_count_no_launch():
    attention.reset_launches()
    leaves = [t.requires_grad_() for t in _t(*_arrays(9, 9, 8, seed=2)[:3])]
    attention.flash_attention_heads(*leaves, True).sum().backward()
    attention.flash_attention_heads(*(t.detach() for t in leaves))
    assert attention.launch_counts() == {"launches": 0, "lse_launches": 0,
                                         "dq_launches": 0, "dkv_launches": 0}
    assert attention.reset_launches() == 0


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_cpu_takes_other_float_dtypes_as_jax_reference_does(dtype):
    """float32 logits and softmax, the output cast back to q's dtype; the
    gradients come back in each input's dtype."""
    q, k, v, do = _arrays(12, 12, 8, seed=3)
    want = jax.vmap(lambda a, b, c: jax_reference(a, b, c, True),
                    in_axes=2, out_axes=2)(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
              for a in (q, k, v)]
    out = attention.flash_attention_heads(*leaves, True)
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float64" else 1e-2     # bf16 keeps 8 bits
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=0,
                               atol=tol)
    grads = torch.autograd.grad((out * torch.from_numpy(do).to(out.dtype))
                                .sum(), leaves)
    assert all(g.dtype == out.dtype for g in grads)
