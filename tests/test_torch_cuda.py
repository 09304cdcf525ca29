"""Card tests of the PyTorch port's CUDA kernels: each kernel against its
plain PyTorch version on the same GPU tensors (the LSTM forward in primal
and residual mode, its adjoint and its parameter-gradient reduction, the
attention forward), the LSTM autograd Function against autograd of the
plain forward, the launch counts of a TBPTT training step, and the
full-width transformer LM on the card against the CPU.

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


# The backward: dx, dh0 and dc0 come out of a 64-step recurrence of f32
# products in another order than the plain version's; dW, db and dpeep sum
# T*B = 4096 terms each. Both are held relative to the largest magnitude
# of the plain result (an absolute bound would depend on the scale of the
# cotangents).
BWD_REL_TOL = 2e-5


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _cotangents(T, B, H, device, seed):
    r = np.random.default_rng(seed)
    return [torch.as_tensor(r.normal(size=s).astype(np.float32),
                            device=device)
            for s in ((T, B, H), (B, H), (B, H))]


@pytest.mark.parametrize("T,B,F,H", [
    (64, 64, 77, 200), (64, 64, 200, 200),      # the char-RNN's training
    (1, 64, 77, 200), (64, 1, 200, 200),        # one step, one row
    (9, 3, 5, 37)])                             # a column tail
def test_lstm_residual_forward_matches_plain(cuda, T, B, F, H):
    args = _lstm_args(T, B, F, H, cuda, seed=T + B + F)
    before = lstm.launch_counts()
    got = lstm.lstm_residual_forward(*args, 1.0)
    torch.cuda.synchronize()
    after = lstm.launch_counts()
    assert after["residual_launches"] == before["residual_launches"] + 1
    assert after["launches"] == before["launches"]
    hs, cs, ii, ff, oo, gg = lstm.lstm_sequence_reference(
        *args, 1.0, save_residuals=True)
    want = (hs, hs[-1], cs[-1], cs, ii, ff, oo, gg)
    names = ("hs", "h_T", "c_T", "cs", "i", "f", "o", "g")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = (g - w).abs().max().item()
        assert err <= TOL, f"{name}: max abs err {err}"


@pytest.mark.parametrize("T,B,F,H,need_dx", [
    (64, 64, 77, 200, False), (64, 64, 200, 200, True),
    (1, 64, 77, 200, True), (64, 1, 200, 200, True), (9, 3, 5, 37, True)])
def test_lstm_backward_kernels_match_plain(cuda, T, B, F, H, need_dx):
    args = _lstm_args(T, B, F, H, cuda, seed=T * B + F)
    x, W, b, peep, h0, c0 = args
    hs, cs, ii, ff, oo, gg = lstm.lstm_sequence_reference(
        *args, 1.0, save_residuals=True)
    dhs, dhT, dcT = _cotangents(T, B, H, cuda, seed=F + H)
    before = lstm.launch_counts()
    got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, hs, cs, ii, ff, oo,
                                      gg, dhs, dhT, dcT, need_dx=need_dx)
    torch.cuda.synchronize()
    after = lstm.launch_counts()
    assert after["adjoint_launches"] == before["adjoint_launches"] + 1
    assert after["reduction_launches"] == before["reduction_launches"] + 1
    want = lstm.lstm_sequence_backward_reference(
        x, W, peep, h0, c0, hs, cs, ii, ff, oo, gg, dhs, dhT, dcT)
    names = ("dx", "dW", "db", "dpeep", "dh0", "dc0")
    assert (got[0] is None) == (not need_dx)
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        assert g.shape == w.shape
        err = _rel_err(g, w)
        assert err <= BWD_REL_TOL, f"{name}: max err / max |ref| {err}"


def test_lstm_backward_kernels_take_missing_cotangents(cuda):
    args = _lstm_args(6, 4, 5, 37, cuda, seed=3)
    x, W, b, peep, h0, c0 = args
    res = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
    dhs, _, _ = _cotangents(6, 4, 37, cuda, seed=4)
    got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, *res, dhs)
    want = lstm.lstm_sequence_backward_reference(x, W, peep, h0, c0, *res,
                                                 dhs)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= BWD_REL_TOL


def test_lstm_function_matches_autograd_of_plain_forward(cuda):
    T, B, F, H = 16, 8, 77, 200
    leaves = [a.requires_grad_() for a in _lstm_args(T, B, F, H, cuda)]
    w = _cotangents(T, B, H, cuda, seed=5)
    mix = lambda outs: sum((o * c).sum() for o, c in zip(outs, w))
    got = torch.autograd.grad(mix(lstm.lstm_sequence(*leaves, 1.0)), leaves)
    want = torch.autograd.grad(
        mix(lstm.lstm_sequence_reference(*leaves, 1.0)), leaves)
    for name, g, r in zip(("dx", "dW", "db", "dpeep", "dh0", "dc0"), got,
                          want):
        err = _rel_err(g, r)
        assert err <= BWD_REL_TOL, f"{name}: max err / max |ref| {err}"


def test_tbptt_step_launches_two_of_each_training_kernel(cuda):
    net = pt.char_rnn(vocab_size=11, lstm_size=16, seq_len=8, tbptt=8,
                      device=cuda).init()
    r = np.random.default_rng(0)
    idx = r.integers(0, 11, (4, 9))
    eye = np.eye(11, dtype=np.float32)
    lstm.reset_launches()
    net.fit(eye[idx[:, :-1]], eye[idx[:, 1:]])
    torch.cuda.synchronize()
    assert lstm.launch_counts() == {"launches": 0, "residual_launches": 2,
                                    "adjoint_launches": 2,
                                    "reduction_launches": 2}
    assert net.iteration_count == 1 and np.isfinite(net.score())


def test_attention_kernel_refuses_autograd(cuda):
    q, k, v = _qkv(2, 16, 16, 2, 64, cuda)
    with pytest.raises(attention.AttentionGradientNotPorted, match="A3"):
        attention.flash_attention_heads(q.requires_grad_(), k, v)
    with torch.no_grad():
        attention.flash_attention_heads(q, k, v)
