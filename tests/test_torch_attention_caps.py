"""PyTorch port, the caps that refused what JAX runs, lifted: B * H past
the old grid limit of 65,535 (the port's plain attention, forward and
backward, against JAX's `attention_reference` and its vjp); a GravesLSTM
whose input width is past the CUDA sequence kernels' shared-memory rule
(the port's char-RNN against JAX's through `from_jax_params`, and the
layer against the plain `fused_lstm_sequence`); and the attention
wrapper's choice of kernel variant (`backward_variant`,
`forward_variant`). Head dimensions past 256 are held to JAX's Pallas
kernels in `tests/test_torch_attention_wide.py`.

Tolerances: attention 1e-5 absolute in float32 (softmax over 2 keys, sums
of 4 products); the LSTM network 1e-5 absolute (float32, gate sums of
58,202 terms in another order, two steps, a softmax over 58,200 columns);
the layer against `fused_lstm_sequence` bit-equal (the same plain
function). JAX gets explicit float32 arrays (the suite enables x64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.attention import \
    attention_reference as jax_attention_reference
from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu_torch import char_rnn, from_jax_params
from deeplearning4j_tpu_torch.kernels import attention, lstm
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _heads(fn, *arrays):
    """`fn` on each head's [B, T, Dh] slice of [B, T, H, Dh] arrays; the
    results stacked back on the head axis."""
    outs = [fn(*(jnp.asarray(a[:, :, h]) for a in arrays))
            for h in range(arrays[0].shape[2])]
    if not isinstance(outs[0], tuple):
        return np.stack([np.asarray(o) for o in outs], axis=2)
    return tuple(np.stack([np.asarray(p) for p in parts], axis=2)
                 for parts in zip(*outs))


@pytest.mark.parametrize("causal", [True, False])
def test_batch_times_heads_past_the_old_grid_cap_matches_jax(causal):
    B, H, T, Dh = 16384, 4, 2, 4          # B * H = 65,536
    r = np.random.default_rng(7 + causal)
    q, k, v, do = (r.normal(size=(B, T, H, Dh)).astype(np.float32)
                   for _ in range(4))
    want_o = _heads(lambda q_, k_, v_: jax_attention_reference(
        q_, k_, v_, causal), q, k, v)

    def vjp(q_, k_, v_, g_):
        _, back = jax.vjp(lambda a, b, c: jax_attention_reference(
            a, b, c, causal), q_, k_, v_)
        return back(g_)

    want_grads = _heads(vjp, q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = attention.flash_attention_heads(tq, tk, tv, causal)
    o_lse, lse = attention.flash_attention_fwd_lse_heads(tq, tk, tv, causal)
    grads = attention.flash_attention_bwd_heads(tq, tk, tv, o_lse, lse, tdo,
                                                causal)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=ATOL)
    np.testing.assert_allclose(o_lse.numpy(), want_o, rtol=0, atol=ATOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# a GravesLSTM past the TPU kernel's VMEM rule
# ---------------------------------------------------------------------------
WIDE_VOCAB, WIDE_HIDDEN, WIDE_T = 58200, 2, 2


def test_wide_input_streams_through_the_kernel_in_chunks():
    """(58,200 + 6 * 2) * 4 bytes exceed a block's shared memory, so the
    forward kernel stages x_t in chunks; 100 features fewer fit in one. The
    layer takes the sequence kernels (their plain versions on the CPU) at
    any input width."""
    chunk = lstm.lstm_x_chunk(WIDE_VOCAB, WIDE_HIDDEN)
    assert 0 < chunk < WIDE_VOCAB
    assert (chunk + 6 * WIDE_HIDDEN) * 4 == lstm.MAX_SHARED_BYTES
    assert lstm.lstm_x_chunk(WIDE_VOCAB - 100, WIDE_HIDDEN) == \
        WIDE_VOCAB - 100
    net = char_rnn(vocab_size=WIDE_VOCAB, lstm_size=WIDE_HIDDEN,
                   seq_len=WIDE_T, device="cpu")
    layer = net.conf.layers[0]
    for device in ("cpu", "meta"):
        assert layer._helper(
            torch.zeros((1, WIDE_T, WIDE_VOCAB), device=device), None)


def _wide_features(batch, seed):
    r = np.random.default_rng(seed)
    return np.eye(WIDE_VOCAB, dtype=np.float32)[
        r.integers(0, WIDE_VOCAB, (batch, WIDE_T))]


def test_wide_char_rnn_matches_jax():
    jnet = jax_char_rnn(vocab_size=WIDE_VOCAB, lstm_size=WIDE_HIDDEN,
                        seq_len=WIDE_T, seed=5).init()
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    net = from_jax_params(char_rnn(vocab_size=WIDE_VOCAB,
                                   lstm_size=WIDE_HIDDEN, seq_len=WIDE_T,
                                   device="cpu").init(), params)
    assert net.params[0]["W"].shape == (WIDE_VOCAB + WIDE_HIDDEN,
                                        4 * WIDE_HIDDEN)
    x = _wide_features(3, seed=6)
    lstm.reset_launches()
    got = net.output(x).numpy()
    assert set(lstm.launch_counts().values()) == {0}
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), rtol=0,
                               atol=ATOL)


def test_wide_layer_equals_plain_sequence_function():
    net = char_rnn(vocab_size=WIDE_VOCAB, lstm_size=WIDE_HIDDEN,
                   seq_len=WIDE_T, device="cpu").init(
                       generator=torch.Generator().manual_seed(8))
    layer, params = net.conf.layers[0], net.params[0]
    x = torch.from_numpy(_wide_features(2, seed=9))
    y, _ = layer.apply(params, {}, x)
    zeros = torch.zeros((2, WIDE_HIDDEN))
    hs, _, _ = lstm.fused_lstm_sequence(
        x.transpose(0, 1).contiguous(), params["W"], params["b"],
        params["peep"], zeros, zeros, float(layer.forget_gate_bias_init))
    assert torch.equal(y, hs.transpose(0, 1))


# ---------------------------------------------------------------------------
# the kernel variant chooser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,Dh,ld,aligned,want", [
    (torch.float32, 64, 384, True, "simt"),       # the f32 LM
    (torch.bfloat16, 64, 384, True, "wgmma"),     # the bf16 LM
    (torch.float16, 128, 384, True, "wgmma"),
    (torch.bfloat16, 256, 512, True, "wgmma"),    # Gemma's heads
    (torch.bfloat16, 10, 30, True, "simt"),       # not a multiple of 16
    (torch.bfloat16, 64, 100, True, "simt"),      # rows not 16-byte aligned
    (torch.bfloat16, 64, 384, False, "simt"),     # a pointer not aligned
    (torch.float32, 257, 514, True, "wide"),
    (torch.bfloat16, 320, 640, True, "wide"),
    (torch.float16, 512, 1024, True, "wide")])
def test_backward_variant_follows_dtype_head_dim_and_alignment(
        dtype, Dh, ld, aligned, want):
    assert attention.backward_variant(dtype, Dh, ld, aligned) == want


def test_forward_variant_switches_past_256():
    assert attention.forward_variant(attention.TILED_HEAD_DIM) == "tiled"
    assert attention.forward_variant(attention.TILED_HEAD_DIM + 1) == "wide"


def test_wrapper_reads_alignment_from_the_tensors():
    """An offset view (a pointer 2 bytes past a 16-byte boundary) keeps a
    bf16 tensor off the TMA-fed variant."""
    q = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(
        q.shape)
    assert attention._backward_variant(q, q, q) == "wgmma"
    assert attention._backward_variant(q, shifted, q) == "simt"
    assert attention._backward_variant(q.float(), q.float()) == "simt"


def test_cpu_calls_count_no_variant():
    q = torch.zeros((1, 4, 1, 300))
    attention.reset_launches()
    attention.flash_attention_heads(q, q, q, True)
    o, lse = attention.flash_attention_fwd_lse_heads(q, q, q, True)
    attention.flash_attention_bwd_heads(q, q, q, o, lse, q, True)
    counts = attention.variant_counts()
    assert set(counts) == {"fwd", "lse", "dq", "dkv"}
    assert all(n == 0 for c in counts.values() for n in c.values())
    assert set(counts["dq"]) == {"simt", "wgmma", "wide"}
