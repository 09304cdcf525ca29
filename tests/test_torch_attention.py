"""PyTorch port, attention kernel module: the port's `flash_attention` on
CPU tensors (its plain version) against the JAX package's Pallas flash
kernel in interpret mode and against its `attention_reference`, on the same
numpy inputs; the multi-head entry against a per-head loop; and the
wrapper's refusals.

Tolerance atol 2e-6: float32 throughout (inputs are fed to JAX as explicit
f32, since the suite enables x64), softmax over at most 40 keys of O(1)
logits, sums of at most 40 terms in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.attention import (
    attention_reference as jax_reference, flash_attention as jax_flash)
from deeplearning4j_tpu_torch.kernels import attention
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-6


def _qkv(B, T, S, D, seed=0, heads=None):
    r = np.random.default_rng(seed)
    lead = (B, T) if heads is None else (B, T, heads)
    kv = (B, S) if heads is None else (B, S, heads)
    return (r.normal(size=lead + (D,)).astype(np.float32),
            r.normal(size=kv + (D,)).astype(np.float32),
            r.normal(size=kv + (D,)).astype(np.float32))


def _port(arrays, causal, **kw):
    return attention.flash_attention(*map(torch.from_numpy, arrays), causal,
                                     **kw).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,S,bq,bk", [(16, 16, 8, 8), (13, 29, 8, 16),
                                       (21, 7, 16, 8), (1, 40, 8, 16)])
def test_plain_version_matches_jax_pallas_kernel(causal, T, S, bq, bk):
    """Ragged T != S with block sizes that leave tails on both axes."""
    arrays = _qkv(2, T, S, 8, seed=T * 100 + S)
    want = np.asarray(jax_flash(*map(jnp.asarray, arrays), causal,
                                block_q=bq, block_k=bk, interpret=True))
    got = _port(arrays, causal)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,S,D", [(12, 12, 16), (9, 17, 32)])
def test_plain_version_matches_jax_reference(causal, T, S, D):
    arrays = _qkv(3, T, S, D, seed=D)
    want = np.asarray(jax_reference(*map(jnp.asarray, arrays), causal))
    np.testing.assert_allclose(_port(arrays, causal), want, rtol=0,
                               atol=ATOL)
    got = attention.attention_reference(*map(torch.from_numpy, arrays),
                                        causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sm_scale_is_honoured():
    arrays = _qkv(1, 6, 6, 8, seed=5)
    want = np.asarray(jax_reference(*map(jnp.asarray, arrays), True,
                                    sm_scale=0.7))
    np.testing.assert_allclose(_port(arrays, True, sm_scale=0.7), want,
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_heads_entry_equals_per_head_loop(causal):
    q, k, v = map(torch.from_numpy, _qkv(2, 11, 19, 8, seed=7, heads=3))
    got = attention.flash_attention_heads(q, k, v, causal)
    assert got.shape == (2, 11, 3, 8)
    for h in range(3):
        want = attention.flash_attention(q[:, :, h].contiguous(),
                                         k[:, :, h].contiguous(),
                                         v[:, :, h].contiguous(), causal)
        torch.testing.assert_close(got[:, :, h], want, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        got, attention.attention_reference_heads(q, k, v, causal),
        rtol=0, atol=0)


def test_cpu_tensors_never_count_a_launch():
    before = attention.launches
    attention.flash_attention(*map(torch.from_numpy, _qkv(2, 5, 5, 8)), True)
    attention.flash_attention_heads(
        *map(torch.from_numpy, _qkv(2, 5, 5, 8, heads=2)), False)
    assert attention.launches == before


def test_reset_launches_returns_the_count():
    attention.reset_launches()
    assert attention.reset_launches() == 0 and attention.launches == 0


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "rank", "kv_shape",
                                 "head_dim", "empty", "non_contiguous",
                                 "mixed_device", "meta_device"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    q, k, v = map(torch.from_numpy, _qkv(2, 6, 6, 8, heads=2))
    match = {"float64": "float32", "bfloat16": "mixed dtypes",
             "rank": r"\[B, T, H, Dh\]", "kv_shape": "k and v",
             "head_dim": "head dimension", "empty": "empty",
             "non_contiguous": "contiguous", "mixed_device": "on meta",
             "meta_device": "no attention kernel"}[bad]
    if bad == "float64":
        # a CPU tensor of another float dtype takes the plain version (as
        # JAX's reference does); off the CPU float64 reaches no kernel
        q, k, v = (t.to("meta", torch.float64) for t in (q, k, v))
    elif bad == "bfloat16":
        # bf16 reaches the kernels, but q, k and v must share one dtype
        q = q.to(torch.bfloat16)
    elif bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :-1].contiguous()
    elif bad == "head_dim":
        # no head-dimension cap: Dh = 257 answers as the plain version does
        q = k = v = torch.ones((1, 2, 1, attention.TILED_HEAD_DIM + 1))
        out = attention.flash_attention_heads(q, k, v, True)
        assert out.shape == q.shape and torch.equal(out, q)
        return
    elif bad == "empty":
        k, v = k[:, :0], v[:, :0]
    elif bad == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mixed_device":
        k = k.to("meta")
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(ValueError, match=match):
        attention.flash_attention_heads(q, k, v, True)


def test_three_dim_entry_checks_rank():
    q, k, v = map(torch.from_numpy, _qkv(2, 6, 6, 8, heads=2))
    with pytest.raises(ValueError, match=r"\[B, T, D\]"):
        attention.flash_attention(q, k, v)
