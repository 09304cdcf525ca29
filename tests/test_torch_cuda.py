"""Card tests of the PyTorch port's CUDA kernels: each kernel against its
plain PyTorch version on the same GPU tensors (the LSTM forward in primal
and residual mode, its adjoint and its parameter-gradient reduction, the
attention forward and backward, the BN+ReLU forward and backward in
float32, bfloat16 and float16), the autograd Functions against autograd of
the plain forwards, bit-equal reruns, the launch counts of training steps,
and full-width networks on the card against the CPU.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs on a machine without it. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest configures JAX.)
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.kernels import attention, bn_relu, lstm

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


def _lm(device, width=384, heads=6, blocks=6, t=256, vocab=65, seed=1,
        updater=None):
    b = pt.NeuralNetConfiguration.builder()
    if updater is not None:
        b = b.updater(updater)
    b = (b.list()
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


# The attention backward against its plain version, relative to the
# largest magnitude of the plain result: f32 sums of up to 256 terms (the
# kv or q loop, and Dh for each score) in another order, and exp of
# differently rounded logits.
ATTN_GRAD_TOL = 2e-5
ATTN_BWD_SHAPES = [
    (64, 256, 256, 6, 64, True), (1, 256, 256, 6, 64, True),   # the LM
    (2, 100, 100, 6, 64, True), (3, 96, 80, 6, 64, False),     # ragged
    (2, 70, 70, 4, 16, True), (2, 70, 50, 2, 128, False),      # head dims
    (2, 9, 17, 2, 10, True)]


@pytest.mark.parametrize("B,T,S,H,Dh,causal", ATTN_BWD_SHAPES)
def test_attention_lse_forward_matches_plain(cuda, B, T, S, H, Dh, causal):
    q, k, v = _qkv(B, T, S, H, Dh, cuda, seed=T + S + Dh)
    before = attention.launch_counts()
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, causal)
    torch.cuda.synchronize()
    after = attention.launch_counts()
    assert after["lse_launches"] == before["lse_launches"] + 1
    assert after["launches"] == before["launches"]
    want_o, want_lse = attention.attention_reference_heads_lse(q, k, v,
                                                               causal)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    assert (o - want_o).abs().max().item() <= ATTN_TOL
    assert _rel_err(lse, want_lse) <= ATTN_GRAD_TOL


@pytest.mark.parametrize("B,T,S,H,Dh,causal", ATTN_BWD_SHAPES)
def test_attention_backward_kernels_match_plain(cuda, B, T, S, H, Dh,
                                                causal):
    q, k, v = _qkv(B, T, S, H, Dh, cuda, seed=2 * T + S + Dh)
    do = _qkv(B, T, T, H, Dh, cuda, seed=3 * T + Dh)[0]
    o, lse = attention.attention_reference_heads_lse(q, k, v, causal)
    before = attention.launch_counts()
    dq, dsum = attention.attention_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = attention.attention_bwd_dkv(q, k, v, do, lse, dsum, causal)
    torch.cuda.synchronize()
    after = attention.launch_counts()
    assert after["dq_launches"] == before["dq_launches"] + 1
    assert after["dkv_launches"] == before["dkv_launches"] + 1
    want_dq, want_dsum = attention.attention_bwd_dq_reference(
        q, k, v, o, lse, do, causal)
    want_dk, want_dv = attention.attention_bwd_dkv_reference(
        q, k, v, do, lse, want_dsum, causal)
    for name, g, w in (("D", dsum, want_dsum), ("dq", dq, want_dq),
                       ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = _rel_err(g, w)
        assert err <= ATTN_GRAD_TOL, f"{name}: max err / max |ref| {err}"


def test_attention_backward_is_deterministic(cuda):
    q, k, v, do = _qkv(4, 256, 256, 6, 64, cuda, seed=8) + \
        _qkv(4, 256, 256, 6, 64, cuda, seed=9)[:1]
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, True)
    first = attention.flash_attention_bwd_heads(q, k, v, o, lse, do, True)
    again = attention.flash_attention_bwd_heads(q, k, v, o, lse, do, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_attention_function_matches_autograd_of_plain_forward(cuda):
    leaves = [t.requires_grad_() for t in _qkv(3, 100, 100, 6, 64, cuda)]
    w = _qkv(3, 100, 100, 6, 64, cuda, seed=5)[0]
    before = attention.launch_counts()
    out = attention.flash_attention_heads(*leaves, True)
    got = torch.autograd.grad((out * w).sum(), leaves)
    torch.cuda.synchronize()
    after = attention.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "launches": 0, "lse_launches": 1, "dq_launches": 1,
        "dkv_launches": 1}
    ref = attention.attention_reference_heads(*leaves, True)
    assert (out - ref).abs().max().item() <= ATTN_TOL
    want = torch.autograd.grad((ref * w).sum(), leaves)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        err = _rel_err(g, r)
        assert err <= ATTN_GRAD_TOL, f"{name}: max err / max |ref| {err}"


def test_inference_mode_still_takes_the_primal_attention_kernel(cuda):
    net = _lm(cuda, blocks=2)
    x = np.random.default_rng(3).integers(0, 65, (2, 256, 1))
    attention.reset_launches()
    net.output(x.astype(np.float32))
    torch.cuda.synchronize()
    assert attention.launch_counts() == {"launches": 2, "lse_launches": 0,
                                         "dq_launches": 0, "dkv_launches": 0}


def test_lm_training_step_on_the_card_matches_the_cpu(cuda):
    """A 2-block LM (width 384, 6 heads, T 256), one Adam step on batch 4:
    scores within 1e-4, parameters within 1e-3 relative L2 per tensor (the
    key bias apart: its gradient is exactly 0 and Adam follows the rounding
    noise, tests/test_torch_lm_training.py); 2 LSE, 2 dq and 2 dk/dv
    launches and no primal one."""
    nets = [_lm(d, blocks=2, seed=4, updater=pt.Adam(1e-3, beta2=0.99))
            for d in (cuda, "cpu")]
    r = np.random.default_rng(4)
    idx = r.integers(0, 65, (4, 257))
    x = idx[:, :-1, None].astype(np.float32)
    y = np.eye(65, dtype=np.float32)[idx[:, 1:]]
    attention.reset_launches()
    lstm.reset_launches()
    for n in nets:
        n.fit(x, y)
    torch.cuda.synchronize()
    assert attention.launch_counts() == {"launches": 0, "lse_launches": 2,
                                         "dq_launches": 2, "dkv_launches": 2}
    assert set(lstm.launch_counts().values()) == {0}
    assert abs(nets[0].score() - nets[1].score()) <= 1e-4
    for p, q in zip(*(n.params for n in nets)):
        for k in q:
            if k == "b_k":
                continue
            a, b = p[k].cpu(), q[k]
            assert ((a - b).norm() / b.norm()).item() <= 1e-3, k


# The BN+ReLU kernels against their plain versions: statistics, dgamma and
# dbeta are float32 sums of up to 4097 terms in another order (1e-5 of the
# largest plain magnitude); y and dx are compared in float32 after both are
# rounded to x's dtype, within that plus one ulp of the dtype for a value
# on a rounding boundary.
BN_TOL = 1e-5
BN_ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
          torch.float16: 2.0 ** -10}


def _bn_args(N, C, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, C)) * 1.5 + r.normal(size=C)
    arrays = (x, 1 + 0.2 * r.normal(size=C), 0.3 * r.normal(size=C),
              r.normal(size=(N, C)))
    x, g, b, dy = (torch.as_tensor(a.astype(np.float32), device=device)
                   for a in arrays)
    return x.to(dtype), g, b, dy.to(dtype)


def _bn_close(got, want, dtype):
    got, want = got.float(), want.float()
    limit = (BN_ULP[dtype] * torch.maximum(got.abs(), want.abs())
             + BN_TOL * want.abs().max())
    return bool(((got - want).abs() <= limit).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("N,C", [(128, 1024), (4096, 1024), (4097, 200),
                                 (1, 48), (33, 10), (64, 7)])
def test_bn_relu_kernels_match_plain(cuda, N, C, dtype):
    x, g, b, dy = _bn_args(N, C, dtype, cuda, seed=N + C)
    before = bn_relu.launch_counts()
    y, mean, var = bn_relu.bn_relu_forward(x, g, b)
    dx, dg, db = bn_relu.bn_relu_backward(x, g, b, mean, var, dy)
    torch.cuda.synchronize()
    after = bn_relu.launch_counts()
    assert after["fwd_launches"] == before["fwd_launches"] + 1
    assert after["bwd_launches"] == before["bwd_launches"] + 1
    want_y, want_m, want_v = bn_relu.bn_relu_reference(x, g, b)
    want = bn_relu.bn_relu_backward_reference(x, g, b, mean, var, dy)
    assert y.dtype == dx.dtype == dtype
    assert _bn_close(y, want_y, dtype) and _bn_close(dx, want[0], dtype)
    for got, ref in ((mean, want_m), (var, want_v), (dg, want[1]),
                     (db, want[2])):
        assert got.dtype == torch.float32
        assert _bn_close(got, ref, torch.float32)


def test_bn_relu_takes_nhwc_and_unaligned_rows(cuda):
    x, g, b, _ = _bn_args(2 * 21 * 7 + 1, 64, torch.bfloat16, cuda)
    # a storage offset of 3 elements (6 bytes): the one-element loads
    nhwc = x.reshape(-1)[3:3 + 2 * 21 * 7 * 64].reshape(2, 21, 7, 64)
    y, mean, var = bn_relu.fused_bn_relu(nhwc, g, b)
    want = bn_relu.bn_relu_reference(nhwc.reshape(-1, 64), g, b)
    assert tuple(y.shape) == tuple(nhwc.shape)
    assert _bn_close(y.reshape(-1, 64), want[0], torch.bfloat16)
    assert _bn_close(mean, want[1], torch.float32)


def test_bn_relu_kernels_are_bit_equal_run_to_run(cuda):
    x, g, b, dy = _bn_args(4096, 1024, torch.bfloat16, cuda, seed=3)
    first = bn_relu.bn_relu_forward(x, g, b)
    first += bn_relu.bn_relu_backward(x, g, b, first[1], first[2], dy)
    for _ in range(3):
        again = bn_relu.bn_relu_forward(x, g, b)
        again += bn_relu.bn_relu_backward(x, g, b, again[1], again[2], dy)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_bn_relu_refuses_float64_on_the_card(cuda):
    x, g, b, _ = _bn_args(8, 4, torch.float64, cuda)
    with pytest.raises(ValueError, match="float64"):
        bn_relu.fused_bn_relu(x, g, b)
    with pytest.raises(ValueError, match="on cpu"):
        bn_relu.bn_relu_forward(x.float(), g.cpu(), b)


def test_bn_relu_function_matches_autograd_of_plain_forward(cuda):
    x, g, b, w = _bn_args(256, 96, torch.float32, cuda, seed=5)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, g, b)]
        return torch.autograd.grad((fn(*leaves) * w).sum(), leaves)

    got = grads(lambda *a: bn_relu.fused_bn_relu(*a)[0])
    want = grads(lambda *a: bn_relu.bn_relu_reference(*a)[0])
    for a, c in zip(got, want):
        assert _bn_close(a, c, torch.float32)


def _bn_mlp(device, compute_dtype="bfloat16", width=64):
    b = pt.NeuralNetConfiguration.builder().seed(2).updater(pt.Adam(1e-3))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(pt.DenseLayer(n_out=width, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.DenseLayer(n_out=width, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(pt.InputType.feed_forward(784)).build())
    return pt.MultiLayerNetwork(conf, device=device).init(
        generator=torch.Generator().manual_seed(2))


@pytest.mark.parametrize("compute", ["bfloat16", None])
def test_bn_mlp_step_launches_bn_kernels_only_in_bf16(cuda, compute):
    """A bf16 BN-MLP step launches one forward and one backward BN kernel
    per BN layer, inference none; the float32 net none at all. The step
    agrees with the CPU's: score within 2e-2 in bf16 (rounding in another
    order through two bf16 layers), 1e-4 in float32."""
    nets = [_bn_mlp(d, compute) for d in (cuda, "cpu")]
    x, y, _, _ = pt.bundled_mnist_subset()
    bn_relu.reset_launches()
    nets[0].fit(x[:128], y[:128])
    torch.cuda.synchronize()
    want = 2 if compute else 0
    assert bn_relu.launch_counts() == {"fwd_launches": want,
                                       "bwd_launches": want}
    nets[0].output(x[128:192])
    nets[0].score(pt.DataSet(x[:64], y[:64]))
    assert bn_relu.launch_counts()["fwd_launches"] == want
    nets[1].fit(x[:128], y[:128])
    assert abs(nets[0].score() - nets[1].score()) <= (2e-2 if compute
                                                      else 1e-4)
    for s, t in zip(nets[0].state, nets[1].state):
        for k in s:
            assert s[k].dtype == torch.float32 and not s[k].requires_grad
