"""Card tests of the PyTorch port's CUDA kernels: each kernel against its
plain PyTorch version on the same GPU tensors, and the full-width
transformer LM on the card against the CPU.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs on a machine without it. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest configures JAX.)
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.kernels import attention, lstm

pytestmark = pytest.mark.cuda

# f32 sums of up to F+H terms in another order than the plain version's
# matmul, compounded over the recurrence
TOL = 5e-5
# attention: f32 sums of up to 256 terms in another order, and exp of
# logits rounded differently; about 2e-5 abs is the expected scale
ATTN_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lstm_args(T, B, F, H, device, seed=0):
    r = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(F + H)
    arrays = (r.normal(size=(T, B, F)), r.normal(size=(F + H, 4 * H)) * k,
              r.normal(size=(4 * H,)) * 0.1, r.normal(size=(3 * H,)) * 0.1,
              r.normal(size=(B, H)) * 0.5, r.normal(size=(B, H)) * 0.5)
    return [torch.as_tensor(a.astype(np.float32), device=device)
            for a in arrays]


@pytest.mark.parametrize("T,B,F,H", [
    (64, 32, 77, 200), (64, 8, 200, 200), (1, 1, 77, 200),   # char-RNN
    (7, 3, 5, 6), (5, 2, 33, 300), (3, 2, 1000, 257)])       # ragged, wide
def test_lstm_kernel_matches_plain(cuda, T, B, F, H):
    args = _lstm_args(T, B, F, H, cuda)
    before = lstm.launches
    got = lstm.fused_lstm_sequence(*args, 1.0)
    torch.cuda.synchronize()
    assert lstm.launches == before + 1
    want = lstm.lstm_sequence_reference(*args, 1.0)
    for name, g, w in zip(("hs", "h_T", "c_T"), got, want):
        assert g.shape == w.shape and g.device == w.device
        err = (g - w).abs().max().item()
        assert err <= TOL, f"{name}: max abs err {err}"


def test_lstm_kernel_keeps_input_dtype(cuda):
    args = _lstm_args(4, 2, 9, 16, cuda)
    x16 = args[0].to(torch.bfloat16)
    hs, hT, cT = lstm.fused_lstm_sequence(x16, *args[1:], 1.0)
    assert hs.dtype == hT.dtype == cT.dtype == torch.bfloat16
    want, _, _ = lstm.lstm_sequence_reference(x16, *args[1:], 1.0)
    assert (hs.float() - want).abs().max().item() <= 1e-2


def test_lstm_kernel_refuses_what_it_cannot_take(cuda):
    x, W, b, peep, h0, c0 = _lstm_args(4, 2, 9, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lstm.fused_lstm_sequence(x.transpose(0, 1).contiguous()
                                 .transpose(0, 1), W, b, peep, h0, c0, 1.0)
    with pytest.raises(ValueError, match="on cpu"):
        lstm.fused_lstm_sequence(x, W.cpu(), b, peep, h0, c0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        lstm.fused_lstm_sequence(x, W[:-1], b, peep, h0, c0, 1.0)
    wide = torch.zeros((1, 10000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lstm.fused_lstm_sequence(x[:, :1], W, b, peep, wide, wide, 1.0)


def _qkv(B, T, S, H, Dh, device, seed=0):
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.normal(size=(B, n, H, Dh)).astype(np.float32),
                            device=device) for n in (T, S, S)]


@pytest.mark.parametrize("B,T,S,H,Dh,causal", [
    (32, 256, 256, 6, 64, True), (1, 256, 256, 6, 64, True),   # the LM
    (2, 100, 100, 6, 64, True), (3, 37, 129, 3, 64, False),    # ragged
    (2, 70, 70, 4, 32, True), (2, 70, 50, 2, 128, False),      # head dims
    (3, 24, 24, 4, 8, True), (2, 9, 17, 2, 10, False),
    (2, 1, 40, 3, 16, False)])                                 # one query
def test_attention_kernel_matches_plain(cuda, B, T, S, H, Dh, causal):
    q, k, v = _qkv(B, T, S, H, Dh, cuda, seed=T + S + Dh)
    before = attention.launches
    got = attention.flash_attention_heads(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.attention_reference_heads(q, k, v, causal)
    assert got.shape == want.shape and got.device == want.device
    err = (got - want).abs().max().item()
    assert err <= ATTN_TOL, f"max abs err {err}"


def test_attention_three_dim_entry_matches_plain(cuda):
    q, k, v = (t[:, :, 0].contiguous() for t in _qkv(4, 45, 45, 1, 64, cuda))
    got = attention.flash_attention(q, k, v, True)
    want = attention.attention_reference(q, k, v, True)
    assert (got - want).abs().max().item() <= ATTN_TOL


def test_attention_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(2, 16, 16, 2, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        attention.flash_attention_heads(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_heads(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="on cpu"):
        attention.flash_attention_heads(q, k.cpu(), v)


def _lm(device, width=384, heads=6, blocks=6, t=256, vocab=65, seed=1):
    b = (pt.NeuralNetConfiguration.builder().list()
         .layer(pt.EmbeddingSequenceLayer(n_in=vocab, n_out=width)))
    for _ in range(blocks):
        b = b.layer(pt.TransformerBlock(n_heads=heads))
    conf = (b.layer(pt.RnnOutputLayer(n_out=vocab, activation="softmax"))
            .set_input_type(pt.InputType.recurrent(1, t)).build())
    return pt.MultiLayerNetwork(conf, device=device).init(
        generator=torch.Generator().manual_seed(seed))


def test_block_launches_once_for_all_heads(cuda):
    net = _lm(cuda, blocks=2)
    x = np.random.default_rng(0).integers(0, 65, (3, 256, 1))
    before = attention.launches
    net.output(x.astype(np.float32))
    torch.cuda.synchronize()
    assert attention.launches == before + 2


def test_full_width_lm_on_the_card_matches_the_cpu(cuda):
    net = _lm(cuda)
    cpu = _lm("cpu")
    x = np.random.default_rng(1).integers(0, 65, (2, 256, 1)).astype(
        np.float32)
    got = net.output(x).cpu().numpy()
    want = cpu.output(x).numpy()
    assert got.shape == (2, 256, 65) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4


def test_out_of_range_ids_give_nan_rows_and_keep_the_context(cuda):
    net = _lm(cuda, blocks=1)
    x = np.random.default_rng(2).integers(0, 65, (2, 256, 1)).astype(
        np.float32)
    x[0, 3, 0] = 65.0            # one past the vocabulary
    x[1, 0, 0] = -1000.0
    out = net.output(x).cpu().numpy()
    torch.cuda.synchronize()
    assert np.isnan(out[0, 3]).all() and np.isnan(out[1, 0]).all()
    # the same NaNs as the CPU (a masked key's NaN value still reaches
    # earlier rows through 0 * NaN in the weighted sum, on both devices)
    want = _lm("cpu", blocks=1).output(x).numpy()
    assert np.array_equal(np.isnan(out), np.isnan(want))
    x[0, 3, 0], x[1, 0, 0] = 5.0, -1.0           # -1 wraps to 64
    ok = net.output(x).cpu().numpy()
    assert np.isfinite(ok).all()
