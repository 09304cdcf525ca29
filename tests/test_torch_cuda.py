"""Card tests of the PyTorch port's CUDA kernels: each kernel against its
plain PyTorch version on the same GPU tensors (the LSTM forward in primal
and residual mode, its adjoint and its parameter-gradient reduction, the
attention forward and backward, the BN+ReLU forward and backward in
float32, bfloat16 and float16), the autograd Functions against autograd of
the plain forwards, bit-equal reruns, the launch counts of training steps,
and full-width networks on the card against the CPU. Every LSTM sequence
kernel test runs both kernel variants ("cluster" and "streamed"), each at
shapes that `lstm.sequence_plan` sends to it; every BN+ReLU kernel test
both of its variants ("resident" and "streamed"), each at shapes that
`bn_relu.bn_plan` sends to it.

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


def _variant_launched(kind, B, F, H, before):
    """The sequence kernel `kind` launched once since `before`
    (`lstm.variant_counts()`), in the variant the plan picks."""
    want = lstm.sequence_variant(B, F, H)
    after = lstm.variant_counts()[kind]
    assert after[want] == before[kind][want] + 1, (kind, want, after)
    assert sum(after.values()) == sum(before[kind].values()) + 1
    return want


# (T, B, F, H) that take the streamed variant: a slice of W past a cluster
# CTA's shared memory
STREAMED = [(4, 2, 9, 320), (3, 2, 1000, 257)]


@pytest.mark.parametrize("T,B,F,H", [
    (64, 32, 77, 200), (64, 8, 200, 200), (1, 1, 77, 200),   # char-RNN
    (7, 3, 5, 6), (5, 2, 33, 300), (3, 2, 1000, 257),        # ragged, wide
    (2, 3, 58200, 2), (2, 2, 120000, 40)])   # x_t in two and three chunks
def test_lstm_kernel_matches_plain(cuda, T, B, F, H):
    args = _lstm_args(T, B, F, H, cuda)
    before, variants = lstm.launches, lstm.variant_counts()
    got = lstm.fused_lstm_sequence(*args, 1.0)
    torch.cuda.synchronize()
    assert lstm.launches == before + 1
    _variant_launched("fwd", B, F, H, variants)
    want = lstm.lstm_sequence_reference(*args, 1.0)
    for name, g, w in zip(("hs", "h_T", "c_T"), got, want):
        assert g.shape == w.shape and g.device == w.device
        err = (g - w).abs().max().item()
        assert err <= TOL, f"{name}: max abs err {err}"


def test_lstm_kernel_keeps_input_dtype(cuda):
    for T, B, F, H in [(4, 2, 9, 16)] + STREAMED[:1]:
        args = _lstm_args(T, B, F, H, cuda)
        x16 = args[0].to(torch.bfloat16)
        hs, hT, cT = lstm.fused_lstm_sequence(x16, *args[1:], 1.0)
        assert hs.dtype == hT.dtype == cT.dtype == torch.bfloat16
        want, _, _ = lstm.lstm_sequence_reference(x16, *args[1:], 1.0)
        assert (hs.float() - want).abs().max().item() <= 1e-2


def test_lstm_kernel_refuses_what_it_cannot_take(cuda):
    for T, B, F, H in [(4, 2, 9, 16)] + STREAMED[:1]:
        x, W, b, peep, h0, c0 = _lstm_args(T, B, F, H, cuda)
        with pytest.raises(ValueError, match="contiguous"):
            lstm.fused_lstm_sequence(x.transpose(0, 1).contiguous()
                                     .transpose(0, 1), W, b, peep, h0, c0,
                                     1.0)
        with pytest.raises(ValueError, match="on cpu"):
            lstm.fused_lstm_sequence(x, W.cpu(), b, peep, h0, c0, 1.0)
        with pytest.raises(ValueError, match="shape"):
            lstm.fused_lstm_sequence(x, W[:-1], b, peep, h0, c0, 1.0)
    x, W, b, peep, h0, c0 = _lstm_args(4, 2, 9, 16, cuda)
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
    with pytest.raises(ValueError, match="mixed dtypes"):
        attention.flash_attention_heads(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        attention.flash_attention_heads(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention_heads(
            q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="on cpu"):
        attention.flash_attention_heads(q, k.cpu(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_257_runs_the_wide_kernels(cuda, dtype):
    """No head-dimension cap: Dh = 257 takes the wide forward and backward
    (one launch each) and matches the plain version within the limits of
    test_attention_kernels_take_dtypes_and_wide_heads."""
    q, k, v = (t.to(dtype) for t in _qkv(2, 40, 40, 1, 257, cuda, seed=3))
    do = _qkv(2, 40, 40, 1, 257, cuda, seed=4)[0].to(dtype)
    attention.reset_launches()
    out = attention.flash_attention_heads(q, k, v, True)
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, True)
    dq, dk, dv = attention.flash_attention_bwd_heads(q, k, v, o, lse, do,
                                                     True)
    torch.cuda.synchronize()
    assert attention.variant_counts() == {
        "fwd": {"tiled": 0, "wide": 1}, "lse": {"tiled": 0, "wide": 1},
        "dq": {"simt": 0, "wgmma": 0, "wide": 1},
        "dkv": {"simt": 0, "wgmma": 0, "wide": 1}}
    want_o, want_lse = attention.attention_reference_heads_lse(q, k, v, True)
    want = attention.attention_bwd_reference_heads(q, k, v, o, lse, do, True)
    for name, g, w in (("o", out, want_o), ("o (lse)", o, want_o),
                       ("L", lse, want_lse), ("dq", dq, want[0]),
                       ("dk", dk, want[1]), ("dv", dv, want[2])):
        ok, err = _close(g, w, g.dtype, ATTN_GRAD_TOL)
        assert ok and g.dtype == w.dtype, f"{name}: max abs err {err}"


def _lm(device, width=384, heads=6, blocks=6, t=256, vocab=65, seed=1,
        updater=None, compute_dtype=None):
    b = pt.NeuralNetConfiguration.builder()
    if updater is not None:
        b = b.updater(updater)
    if compute_dtype is not None:
        b = b.compute_dtype(compute_dtype)
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
    (9, 3, 5, 37),                              # a column tail
    (2, 3, 58200, 2),                           # x_t in two chunks
    (4, 2, 9, 320)])                            # streamed: wide H
def test_lstm_residual_forward_matches_plain(cuda, T, B, F, H):
    args = _lstm_args(T, B, F, H, cuda, seed=T + B + F)
    before, variants = lstm.launch_counts(), lstm.variant_counts()
    got = lstm.lstm_residual_forward(*args, 1.0)
    torch.cuda.synchronize()
    _variant_launched("residual", B, F, H, variants)
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
    (1, 64, 77, 200, True), (64, 1, 200, 200, True), (9, 3, 5, 37, True),
    (2, 3, 58200, 2, True),                     # past one chunk of x_t
    (9, 3, 5, 37, False), (4, 2, 9, 320, True), (4, 2, 9, 320, False)])
def test_lstm_backward_kernels_match_plain(cuda, T, B, F, H, need_dx):
    args = _lstm_args(T, B, F, H, cuda, seed=T * B + F)
    x, W, b, peep, h0, c0 = args
    hs, cs, ii, ff, oo, gg = lstm.lstm_sequence_reference(
        *args, 1.0, save_residuals=True)
    dhs, dhT, dcT = _cotangents(T, B, H, cuda, seed=F + H)
    before, variants = lstm.launch_counts(), lstm.variant_counts()
    got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, hs, cs, ii, ff, oo,
                                      gg, dhs, dhT, dcT, need_dx=need_dx)
    torch.cuda.synchronize()
    _variant_launched("adjoint", B, F, H, variants)
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
    for T, B, F, H in [(6, 4, 5, 37)] + STREAMED[:1]:
        args = _lstm_args(T, B, F, H, cuda, seed=3)
        x, W, b, peep, h0, c0 = args
        res = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
        dhs, _, _ = _cotangents(T, B, H, cuda, seed=4)
        variants = lstm.variant_counts()
        got = lstm.lstm_sequence_backward(x, W, peep, h0, c0, *res, dhs)
        _variant_launched("adjoint", B, F, H, variants)
        want = lstm.lstm_sequence_backward_reference(x, W, peep, h0, c0,
                                                     *res, dhs)
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= BWD_REL_TOL


def test_lstm_function_matches_autograd_of_plain_forward(cuda):
    for T, B, F, H in [(16, 8, 77, 200)] + STREAMED[:1]:
        leaves = [a.requires_grad_() for a in _lstm_args(T, B, F, H, cuda)]
        w = _cotangents(T, B, H, cuda, seed=5)
        mix = lambda outs: sum((o * c).sum() for o, c in zip(outs, w))
        got = torch.autograd.grad(mix(lstm.lstm_sequence(*leaves, 1.0)),
                                  leaves)
        want = torch.autograd.grad(
            mix(lstm.lstm_sequence_reference(*leaves, 1.0)), leaves)
        for name, g, r in zip(("dx", "dW", "db", "dpeep", "dh0", "dc0"),
                              got, want):
            err = _rel_err(g, r)
            assert err <= BWD_REL_TOL, \
                f"H={H} {name}: max err / max |ref| {err}"


def test_tbptt_step_launches_two_of_each_training_kernel(cuda):
    # 16 hidden units take the cluster variant, 400 the streamed one
    for hidden, variant in ((16, "cluster"), (400, "streamed")):
        net = pt.char_rnn(vocab_size=11, lstm_size=hidden, seq_len=8,
                          tbptt=8, device=cuda).init()
        r = np.random.default_rng(0)
        idx = r.integers(0, 11, (4, 9))
        eye = np.eye(11, dtype=np.float32)
        lstm.reset_launches()
        net.fit(eye[idx[:, :-1]], eye[idx[:, 1:]])
        torch.cuda.synchronize()
        assert lstm.launch_counts() == {"launches": 0,
                                        "residual_launches": 2,
                                        "adjoint_launches": 2,
                                        "reduction_launches": 2}
        other = "streamed" if variant == "cluster" else "cluster"
        assert lstm.variant_counts() == {
            "fwd": {"cluster": 0, "streamed": 0},
            "residual": {variant: 2, other: 0},
            "adjoint": {variant: 2, other: 0}}
        assert net.iteration_count == 1 and np.isfinite(net.score())


# Each variant of the sequence kernels sums in a fixed order: reruns give
# the same bits (the cluster forward at a bucket-32 and a training shape,
# its adjoint with and without dx; the streamed ones past a CTA).
@pytest.mark.parametrize("T,B,F,H", [(64, 32, 200, 200), (64, 64, 77, 200),
                                     (4, 2, 9, 320)])
def test_lstm_sequence_kernels_are_bit_equal_run_to_run(cuda, T, B, F, H):
    args = _lstm_args(T, B, F, H, cuda, seed=13)
    x, W, b, peep, h0, c0 = args
    dhs, dhT, dcT = _cotangents(T, B, H, cuda, seed=14)
    runs = []
    for _ in range(3):
        res = lstm.lstm_residual_forward(*args, 1.0)
        runs.append([lstm.fused_lstm_sequence(*args, 1.0), res]
                    + [lstm.lstm_adjoint(W, peep, c0, *res[3:], dhs, dhT,
                                         dcT, F, need_dx)
                       for need_dx in (True, False)])
    for run in runs[1:]:
        for got, first in zip(run, runs[0]):
            assert all(g is None and f is None or torch.equal(g, f)
                       for g, f in zip(got, first))


def test_cluster_plan_bytes_match_the_kernels(cuda):
    """`lstm.cluster_bytes` (what the plan checks against a CTA's shared
    memory) is what the kernels' own layouts take."""
    import ctypes
    from deeplearning4j_tpu_torch.kernels import library
    fn = library().dl4j_lstm_cluster_bytes
    fn.restype = ctypes.c_longlong
    for B, F, H in [(1, 77, 200), (32, 200, 200), (64, 200, 200),
                    (2, 5, 312), (3, 5, 37), (2, 33, 300)]:
        plan = lstm.sequence_plan(B, F, H)
        assert plan.variant == "cluster"
        for adjoint, want in ((0, plan.fwd_bytes), (1, plan.bwd_bytes)):
            assert fn(F, H, plan.units, plan.x_rows, plan.group,
                      adjoint) == want


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


def _bn_variants_launched(N, C, dtype, before):
    """The forward and the backward launched once each since `before`
    (`bn_relu.variant_counts()`), each in the variant `bn_plan` picks;
    returns the two variants."""
    after = bn_relu.variant_counts()
    size = torch.tensor([], dtype=dtype).element_size()
    picked = []
    for kind in ("fwd", "bwd"):
        want = bn_relu.bn_plan(N, C, size, kind == "bwd").variant
        assert after[kind][want] == before[kind][want] + 1, (kind, after)
        assert sum(after[kind].values()) == sum(before[kind].values()) + 1
        picked.append(want)
    return tuple(picked)


# Shapes past the resident slabs (N above 28,672 backward, 57,344
# forward) take the streamed variant; the rest the resident one
BN_STREAMED = [(28673, 10), (57345, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("N,C", [(128, 1024), (4096, 1024), (4097, 200),
                                 (1, 48), (33, 10), (64, 7)] + BN_STREAMED)
def test_bn_relu_kernels_match_plain(cuda, N, C, dtype):
    x, g, b, dy = _bn_args(N, C, dtype, cuda, seed=N + C)
    before = bn_relu.launch_counts()
    variants = bn_relu.variant_counts()
    y, mean, var = bn_relu.bn_relu_forward(x, g, b)
    dx, dg, db = bn_relu.bn_relu_backward(x, g, b, mean, var, dy)
    torch.cuda.synchronize()
    after = bn_relu.launch_counts()
    assert after["fwd_launches"] == before["fwd_launches"] + 1
    assert after["bwd_launches"] == before["bwd_launches"] + 1
    picked = _bn_variants_launched(N, C, dtype, variants)
    assert ("streamed" in picked) == ((N, C) in BN_STREAMED)
    want_y, want_m, want_v = bn_relu.bn_relu_reference(x, g, b)
    want = bn_relu.bn_relu_backward_reference(x, g, b, mean, var, dy)
    assert y.dtype == dx.dtype == dtype
    assert _bn_close(y, want_y, dtype) and _bn_close(dx, want[0], dtype)
    for got, ref in ((mean, want_m), (var, want_v), (dg, want[1]),
                     (db, want[2])):
        assert got.dtype == torch.float32
        assert _bn_close(got, ref, torch.float32)


@pytest.mark.parametrize("lead,C", [((2, 21, 7), 64),       # resident
                                    ((5, 3, 3823), 16)])    # streamed
def test_bn_relu_takes_nhwc_and_unaligned_rows(cuda, lead, C):
    N = int(np.prod(lead))
    x, g, b, dy = _bn_args(N + 1, C, torch.bfloat16, cuda)
    # a storage offset of 3 elements (6 bytes): the one-element copies
    nhwc = x.reshape(-1)[3:3 + N * C].reshape(*lead, C)
    dy = dy.reshape(-1)[3:3 + N * C].reshape(N, C)
    variants = bn_relu.variant_counts()
    y, mean, var = bn_relu.fused_bn_relu(nhwc, g, b)
    dx, dg, db = bn_relu.bn_relu_backward(nhwc.reshape(N, C), g, b, mean,
                                          var, dy)
    torch.cuda.synchronize()
    _bn_variants_launched(N, C, torch.bfloat16, variants)
    want = bn_relu.bn_relu_reference(nhwc.reshape(-1, C), g, b)
    want_b = bn_relu.bn_relu_backward_reference(nhwc.reshape(N, C), g, b,
                                                mean, var, dy)
    assert tuple(y.shape) == tuple(nhwc.shape)
    assert _bn_close(y.reshape(-1, C), want[0], torch.bfloat16)
    assert _bn_close(mean, want[1], torch.float32)
    assert _bn_close(var, want[2], torch.float32)
    assert _bn_close(dx, want_b[0], torch.bfloat16)
    assert _bn_close(dg, want_b[1], torch.float32)
    assert _bn_close(db, want_b[2], torch.float32)


@pytest.mark.parametrize("N,C", [(4096, 1024), (4096, 48)] + BN_STREAMED)
def test_bn_relu_kernels_are_bit_equal_run_to_run(cuda, N, C):
    x, g, b, dy = _bn_args(N, C, torch.bfloat16, cuda, seed=3)
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


@pytest.mark.parametrize("N,C", [(256, 96), (30000, 8), (57345, 8)])
def test_bn_relu_function_matches_autograd_of_plain_forward(cuda, N, C):
    """Resident both halves; a resident forward with a streamed backward;
    streamed both."""
    x, g, b, w = _bn_args(N, C, torch.float32, cuda, seed=5)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, g, b)]
        return torch.autograd.grad((fn(*leaves) * w).sum(), leaves)

    variants = bn_relu.variant_counts()
    got = grads(lambda *a: bn_relu.fused_bn_relu(*a)[0])
    _bn_variants_launched(N, C, torch.float32, variants)
    want = grads(lambda *a: bn_relu.bn_relu_reference(*a)[0])
    for a, c in zip(got, want):
        assert _bn_close(a, c, torch.float32)


def test_bn_plan_bytes_match_the_kernels(cuda):
    """`bn_plan`'s shared memory (what it checks against a CTA's 227 KB) is
    what the kernels take: the resident carve-up, or the streamed
    kernels' static arrays."""
    import ctypes
    from deeplearning4j_tpu_torch.kernels import library
    fn = library().dl4j_bn_relu_plan_bytes
    fn.restype = ctypes.c_longlong
    seen = set()
    for N, C in [(128, 1024), (4096, 1024), (4097, 200), (4096, 48),
                 (1, 10), (52428, 10), (28672, 16), (57344, 8),
                 (57345, 8)]:
        for size in (2, 4):
            for backward in (False, True):
                plan = bn_relu.bn_plan(N, C, size, backward)
                seen.add(plan.variant)
                assert fn(int(plan.variant == "resident"), plan.rows,
                          int(backward)) == plan.smem_bytes
    assert seen == {"resident", "streamed"}


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
    assert bn_relu.variant_counts() == {
        kind: {"resident": want, "streamed": 0} for kind in ("fwd", "bwd")}
    nets[0].output(x[128:192])
    nets[0].score(pt.DataSet(x[:64], y[:64]))
    assert bn_relu.launch_counts()["fwd_launches"] == want
    nets[1].fit(x[:128], y[:128])
    assert abs(nets[0].score() - nets[1].score()) <= (2e-2 if compute
                                                      else 1e-4)
    for s, t in zip(nets[0].state, nets[1].state):
        for k in s:
            assert s[k].dtype == torch.float32 and not s[k].requires_grad


# The redesigned LSTM reduction (split T*B axis, cluster reduction) against
# its plain version at the char-RNN's training shapes and ragged ones (a
# row tail of the 16-row chunks and of the eight slices, column tails of
# the 128 x 64 tiles): f32 sums of T*B terms in another order, relative to
# the largest magnitude (BWD_REL_TOL).
@pytest.mark.parametrize("T,B,F,H", [
    (64, 64, 77, 200), (64, 64, 200, 200),      # the char-RNN, T*B = 4096
    (9, 3, 5, 37), (7, 13, 5, 37), (1, 1, 5, 37), (33, 5, 130, 70)])
def test_lstm_reduction_matches_plain(cuda, T, B, F, H):
    x, W, b, peep, h0, c0 = _lstm_args(T, B, F, H, cuda, seed=T + B + H)
    hs, cs, ii, ff, oo, gg = lstm.lstm_sequence_reference(
        x, W, b, peep, h0, c0, 1.0, save_residuals=True)
    dgates = torch.as_tensor(np.random.default_rng(F).normal(
        size=(T, B, 4 * H)).astype(np.float32), device=cuda)
    before = lstm.launch_counts()["reduction_launches"]
    got = lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates)
    torch.cuda.synchronize()
    assert lstm.launch_counts()["reduction_launches"] == before + 1
    want = lstm.lstm_param_grads_reference(x, hs, h0, cs, c0, dgates)
    for name, g, w in zip(("dW", "db", "dpeep"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        err = _rel_err(g, w)
        assert err <= BWD_REL_TOL, f"{name}: max err / max |ref| {err}"


def test_lstm_reduction_is_bit_equal_run_to_run(cuda):
    T, B, F, H = 64, 64, 77, 200
    x, W, b, peep, h0, c0 = _lstm_args(T, B, F, H, cuda, seed=11)
    hs, cs, *_ = lstm.lstm_sequence_reference(x, W, b, peep, h0, c0, 1.0,
                                              save_residuals=True)
    dgates = torch.as_tensor(np.random.default_rng(12).normal(
        size=(T, B, 4 * H)).astype(np.float32), device=cuda)
    first = lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates)
    for _ in range(3):
        again = lstm.lstm_param_grads(x, hs, h0, cs, c0, dgates)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


# Attention in bf16 and f16, and at head dimensions 160 and 256: the
# kernels and the plain versions both compute in f32 from the same inputs
# and round o, dq, dk, dv to the inputs' dtype, so a value on a rounding
# boundary may land one ulp of the dtype apart (BN_ULP: 2^-7 of its
# magnitude for bf16, 2^-10 for f16); on top of that the f32 limits above,
# relative to the largest plain magnitude (sums in another order). L and D
# are f32.
def _close(got, want, dtype, tol):
    got, want = got.float(), want.float()
    limit = (BN_ULP[dtype] * torch.maximum(got.abs(), want.abs())
             + tol * want.abs().max())
    err = (got - want).abs()
    return bool((err <= limit).all()), err.max().item()


TYPED_CASES = [
    (torch.bfloat16, 64, 256, 256, 6, 64, True),   # the LM's training shape
    (torch.float16, 4, 256, 256, 6, 64, True),
    (torch.bfloat16, 2, 100, 100, 6, 64, True),    # ragged causal
    (torch.bfloat16, 3, 37, 129, 3, 10, False),    # unaligned head dim
    (torch.float32, 2, 100, 100, 2, 160, True),    # wide heads
    (torch.float32, 2, 70, 50, 2, 256, False),
    (torch.bfloat16, 2, 100, 100, 2, 256, True),
    (torch.float16, 2, 70, 70, 2, 160, True),
    (torch.bfloat16, 2, 70, 70, 4, 16, True),      # wgmma head sizes
    (torch.float16, 2, 70, 50, 2, 128, False),
    (torch.float32, 2, 24, 24, 2, 257, True),      # the wide kernels
    (torch.bfloat16, 2, 20, 13, 2, 320, False),
    (torch.float32, 2, 70, 70, 2, 512, True),
    (torch.bfloat16, 2, 64, 64, 2, 512, True),
    (torch.float32, 16384, 8, 8, 4, 16, True),     # B * H = 65,536
    (torch.bfloat16, 16384, 8, 8, 4, 16, True)]


@pytest.mark.parametrize("dtype,B,T,S,H,Dh,causal", TYPED_CASES)
def test_attention_kernels_take_dtypes_and_wide_heads(cuda, dtype, B, T, S,
                                                      H, Dh, causal):
    q, k, v = (t.to(dtype) for t in _qkv(B, T, S, H, Dh, cuda, seed=T + Dh))
    do = _qkv(B, T, T, H, Dh, cuda, seed=2 * T + Dh)[0].to(dtype)
    before = attention.launch_counts()
    out = attention.flash_attention_heads(q, k, v, causal)
    o, lse = attention.flash_attention_fwd_lse_heads(q, k, v, causal)
    want_o, want_lse = attention.attention_reference_heads_lse(q, k, v,
                                                               causal)
    dq, dsum = attention.attention_bwd_dq(q, k, v, want_o, want_lse, do,
                                          causal)
    dk, dv = attention.attention_bwd_dkv(q, k, v, do, want_lse, dsum, causal)
    torch.cuda.synchronize()
    after = attention.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "launches": 1, "lse_launches": 1, "dq_launches": 1,
        "dkv_launches": 1}
    want_dq, want_dsum = attention.attention_bwd_dq_reference(
        q, k, v, want_o, want_lse, do, causal)
    want_dk, want_dv = attention.attention_bwd_dkv_reference(
        q, k, v, do, want_lse, want_dsum, causal)
    for name, g, w, tol in (
            ("o", out, want_o, ATTN_GRAD_TOL), ("o (lse)", o, want_o,
                                                ATTN_GRAD_TOL),
            ("L", lse, want_lse, ATTN_GRAD_TOL),
            ("D", dsum, want_dsum, ATTN_GRAD_TOL),
            ("dq", dq, want_dq, ATTN_GRAD_TOL),
            ("dk", dk, want_dk, ATTN_GRAD_TOL),
            ("dv", dv, want_dv, ATTN_GRAD_TOL)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        ok, err = _close(g, w, g.dtype, tol)
        assert ok, f"{name}: max abs err {err}"


@pytest.mark.parametrize("dtype,Dh,variant", [
    (torch.float32, 64, "simt"), (torch.bfloat16, 64, "wgmma"),
    (torch.float16, 128, "wgmma"), (torch.bfloat16, 10, "simt"),
    (torch.float32, 320, "wide")])
def test_attention_backward_variants_are_bit_equal_run_to_run(cuda, dtype,
                                                               Dh, variant):
    q, k, v, do = (t.to(dtype) for t in _qkv(4, 200, 200, 2, Dh, cuda,
                                             seed=21) +
                   _qkv(4, 200, 200, 2, Dh, cuda, seed=22)[:1])
    o, lse = attention.attention_reference_heads_lse(q, k, v, True)
    attention.reset_launches()
    first = attention.flash_attention_bwd_heads(q, k, v, o, lse, do, True)
    again = attention.flash_attention_bwd_heads(q, k, v, o, lse, do, True)
    assert attention.variant_counts()["dq"][variant] == 2
    assert attention.variant_counts()["dkv"][variant] == 2
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compute,variant", [(None, "simt"),
                                             ("bfloat16", "wgmma")])
def test_lm_step_launches_one_backward_variant(cuda, compute, variant):
    """One training step of a 2-block LM (Dh 64): the f32 network's
    backward runs only the simt kernels, the bf16 network's only wgmma."""
    net = _lm(cuda, blocks=2, seed=7, compute_dtype=compute)
    r = np.random.default_rng(7)
    idx = r.integers(0, 65, (2, 257))
    attention.reset_launches()
    net.fit(idx[:, :-1, None].astype(np.float32),
            np.eye(65, dtype=np.float32)[idx[:, 1:]])
    torch.cuda.synchronize()
    counts = attention.variant_counts()
    for kind in ("dq", "dkv"):
        assert counts[kind] == {n: 2 if n == variant else 0
                                for n in ("simt", "wgmma", "wide")}
    assert counts["lse"] == {"tiled": 2, "wide": 0}
    assert np.isfinite(net.score())


def test_wide_graves_lstm_runs_the_kernels_and_matches_the_cpu(cuda,
                                                                tmp_path):
    """A GravesLSTM past one shared-memory chunk of x_t (n_in 58,200): on
    the card its forward and training steps launch the sequence kernels,
    x_t streamed in chunks, and answer as the CPU does."""
    vocab, hidden = 58200, 2
    conf = (pt.NeuralNetConfiguration.builder().seed(5).list()
            .layer(pt.GravesLSTM(n_out=hidden))
            .layer(pt.RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(pt.InputType.recurrent(vocab, 2)).build())
    cpu = pt.MultiLayerNetwork(conf, device="cpu").init()
    path = str(tmp_path / "wide.zip")
    pt.ModelSerializer.write_model(cpu, path)
    nets = [pt.ModelSerializer.restore(path, device=cuda), cpu]
    assert lstm.lstm_x_chunk(vocab, hidden) < vocab
    r = np.random.default_rng(5)
    x = np.eye(vocab, dtype=np.float32)[r.integers(0, vocab, (3, 2))]
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, (3, 2))]
    lstm.reset_launches()
    got = nets[0].output(x)
    torch.cuda.synchronize()
    assert lstm.launch_counts()["launches"] == 1
    want = nets[1].output(x)
    assert (got.cpu() - want).abs().max().item() <= TOL
    lstm.reset_launches()
    for net in nets:
        net.fit(x, y)
    torch.cuda.synchronize()
    assert lstm.launch_counts() == {"launches": 0, "residual_launches": 1,
                                    "adjoint_launches": 1,
                                    "reduction_launches": 1}
    for name in ("W", "b", "peep"):
        err = (nets[0].params[0][name].detach().cpu()
               - nets[1].params[0][name].detach()).abs().max().item()
        assert err <= TOL, f"{name} after one step: max abs err {err}"


def test_attention_forward_is_bit_equal_run_to_run(cuda):
    for dtype, Dh in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v = (t.to(dtype) for t in _qkv(2, 200, 200, 2, Dh, cuda))
        first = attention.flash_attention_fwd_lse_heads(q, k, v, True)
        again = attention.flash_attention_fwd_lse_heads(q, k, v, True)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def _first_grads(net, x, y):
    """{"layer/name": gradient on the CPU} of the network's score at its
    parameters."""
    params = tuple({k: v.detach().requires_grad_() for k, v in p.items()}
                   for p in net.params)
    score, _ = net._loss_fn(params, net.state,
                            torch.as_tensor(x, device=net.device),
                            torch.as_tensor(y, device=net.device))
    grads = torch.autograd.grad(score, [v for p in params for v in p.values()])
    names = [f"{i}/{k}" for i, p in enumerate(params) for k in p]
    return {n: g.detach().cpu() for n, g in zip(names, grads)}


@pytest.mark.parametrize("width,heads", [(384, 6), (512, 2)])
def test_bf16_lm_step_on_the_card_matches_the_cpu(cuda, width, heads):
    """A bf16-compute LM (2 blocks; Dh 64, or 256 at width 512 and 2
    heads) through the bf16 attention kernels, against the CPU within PR
    5's bf16 limits: first-step gradients per tensor within 2e-2 of its
    largest entry (the key bias, whose exact gradient is 0, to 2e-2 of its
    W_k's); one Adam step's score and the following forward's outputs
    within 2e-2; the step's parameters, as PR 5's one-step check: within
    1e-5 where the CPU's gradient entry is beyond 2e-2 of the tensor's
    largest (Adam's first step is lr times its sign), else within Adam's
    reach, 2 lr (rounding noise may flip the sign of a near-zero entry;
    every entry of the key bias, whose exact gradient is 0).
    One launch of each attention kernel per block."""
    lr = 1e-3
    nets = [_lm(d, width=width, heads=heads, blocks=2, seed=6,
                updater=pt.Adam(lr, beta2=0.99),
                compute_dtype="bfloat16") for d in (cuda, "cpu")]
    r = np.random.default_rng(6)
    idx = r.integers(0, 65, (4, 257))
    x = idx[:, :-1, None].astype(np.float32)
    y = np.eye(65, dtype=np.float32)[idx[:, 1:]]
    grads = [_first_grads(n, x, y) for n in nets]
    for name, want in grads[1].items():
        got = grads[0][name]
        if name.endswith("/b_k"):
            w_k = grads[1][name[:-3] + "W_k"].abs().max()
            assert max(got.abs().max(), want.abs().max()) <= 2e-2 * w_k
            continue
        err = _rel_err(got, want)
        assert err <= 2e-2, f"{name}: max err / max |ref| {err}"
    attention.reset_launches()
    for n in nets:
        n.fit(x, y)
    outs = [n.output(x) for n in nets]
    torch.cuda.synchronize()
    assert attention.launch_counts() == {"launches": 2, "lse_launches": 2,
                                         "dq_launches": 2, "dkv_launches": 2}
    assert abs(nets[0].score() - nets[1].score()) <= 2e-2
    assert (outs[0].cpu() - outs[1]).abs().max().item() <= 2e-2
    for i, (p, q) in enumerate(zip(*(n.params for n in nets))):
        for k in q:
            a, b = p[k].cpu(), q[k]
            assert a.dtype == torch.float32
            g = grads[1][f"{i}/{k}"].abs()
            clear = g > 2e-2 * g.max()
            err = (a - b).abs()
            assert err.max().item() <= 2 * lr + 1e-7, k
            if k != "b_k" and clear.any():   # b_k's gradient is all noise
                assert err[clear].max().item() <= 1e-5, k


# ---------------------------------------------------------------------------
# the convolutional path: no hand kernel, conv / pool / LRN through
# torch.nn.functional (cuDNN), NHWC at every boundary
# ---------------------------------------------------------------------------
def _hand_kernel_launches():
    return {f"{m.__name__}/{k}": n for m in (lstm, attention, bn_relu)
            for k, n in m.launch_counts().items()}


def _layer_on(device, spec, x, ct, seed):
    """A layer's output and its gradients (input, then parameters) on
    `device`, from the same CPU-drawn parameters, in full float32 (TF32
    off, as a network sets it when it is built)."""
    from deeplearning4j_tpu_torch.nn.conf.base import conf_from_dict
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()
    layer = conf_from_dict({"__layer__": {"type": spec[0],
                                          "fields": spec[1]}})
    params = {}
    if layer.has_params:
        params = layer.init_params(torch.Generator().manual_seed(seed),
                                   pt.InputType.convolutional(*x.shape[1:]),
                                   "cpu")
    p = {k: v.to(device).requires_grad_() for k, v in params.items()}
    xt = torch.tensor(x, device=device, requires_grad=True)
    y, _ = layer.apply(p, {}, xt)
    grads = torch.autograd.grad(y, [xt] + list(p.values()),
                                torch.tensor(ct, device=device))
    return [y.detach().cpu()] + [g.cpu() for g in grads]


CNN_LAYER_CASES = [
    (("ConvolutionLayer", {"n_in": 3, "n_out": 8, "kernel_size": [11, 11],
                           "stride": [4, 4], "convolution_mode": "same"}),
     (2, 32, 32, 3)),                          # SAME padding split (3, 4)
    (("ConvolutionLayer", {"n_in": 3, "n_out": 8, "kernel_size": [4, 4],
                           "stride": [2, 2], "convolution_mode": "same"}),
     (2, 9, 9, 3)),                            # even kernel, split (1, 2)
    (("ConvolutionLayer", {"n_in": 4, "n_out": 6, "kernel_size": [3, 3],
                           "dilation": [2, 2], "padding": [1, 1]}),
     (2, 12, 12, 4)),
    (("LocalResponseNormalization", {}), (2, 5, 5, 16)),
] + [(("SubsamplingLayer", {"pooling_type": pool, **kw}), shape)
     for pool in ("max", "avg", "sum", "pnorm")
     for kw, shape in (({"kernel_size": [3, 3], "stride": [2, 2]},
                        (2, 13, 13, 8)),
                       ({"kernel_size": [2, 2], "stride": [2, 2],
                         "convolution_mode": "same"}, (2, 7, 7, 8)),
                       ({"kernel_size": [3, 3], "stride": [1, 1],
                         "padding": [2, 2]}, (2, 7, 7, 8)))]


@pytest.mark.parametrize("spec,shape", CNN_LAYER_CASES,
                         ids=[f"{c[0][0]}-{i}"
                              for i, c in enumerate(CNN_LAYER_CASES)])
def test_conv_pool_lrn_on_the_card_match_the_cpu(cuda, spec, shape):
    """The SAME-asymmetric convolution, each pooling type (TRUNCATE, an
    uneven SAME split, padding past half a kernel) and LRN on the card
    against the CPU: output and gradients within 1e-4 of each tensor's
    largest entry (f32 sums in another order; cuDNN may take FFT or
    Winograd algorithms). No hand kernel launches."""
    from deeplearning4j_tpu_torch.nn.conf.base import conf_from_dict
    r = np.random.default_rng(len(shape) + shape[1])
    x = r.normal(size=shape).astype(np.float32)
    out = conf_from_dict({"__layer__": {"type": spec[0], "fields": spec[1]}}
                         ).output_type(pt.InputType.convolutional(*shape[1:]))
    ct = r.normal(size=(shape[0], out.height, out.width,
                        out.channels)).astype(np.float32)
    before = _hand_kernel_launches()
    got = _layer_on(cuda, spec, x, ct, 3)
    torch.cuda.synchronize()
    want = _layer_on("cpu", spec, x, ct, 3)
    assert _hand_kernel_launches() == before
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= 1e-4


def test_conv_nhwc_round_trip_is_contiguous_without_a_copy(cuda):
    """The layer hands cuDNN the NCHW view of the contiguous NHWC input
    (channels_last memory, the same storage) and permutes the result back:
    cuDNN returns channels_last, so the NHWC output is contiguous and is the
    convolution's own storage, no copy on either side."""
    from deeplearning4j_tpu_torch.nn.layers import convolution as conv
    x = torch.randn(4, 17, 19, 8, device=cuda)
    W = torch.randn(3, 3, 8, 16, device=cuda)
    xc = conv._to_nc(x)
    assert xc.data_ptr() == x.data_ptr()
    assert xc.is_contiguous(memory_format=torch.channels_last)
    yc = conv._conv_nc(xc, conv._weight_nc(W), (1, 1), [(1, 1), (1, 1)],
                       (1, 1))
    assert yc.is_contiguous(memory_format=torch.channels_last)
    y = conv._to_nlast(yc)
    assert y.is_contiguous() and y.data_ptr() == yc.data_ptr()
    layer = pt.ConvolutionLayer(n_in=8, n_out=16, kernel_size=(3, 3),
                                convolution_mode="same")
    out, _ = layer.apply({"W": W, "b": torch.zeros(16, device=cuda)}, {}, x)
    assert tuple(out.shape) == (4, 17, 19, 16) and out.is_contiguous()


def test_lenet_step_on_the_card_matches_the_cpu(cuda):
    """LeNet-MNIST (full width) from one set of seeded weights: the first
    step's gradients within 1e-4 of each tensor's largest entry, one
    Nesterovs step's score within 1e-4 and parameters within 1e-3 relative
    L2 of the CPU's (the char-RNN's float32 limits); no hand kernel
    launches; the card's output contiguous and finite."""
    from deeplearning4j_tpu_torch.models import zoo
    nets = [zoo.lenet_mnist(device=d).init(
        generator=torch.Generator().manual_seed(4)) for d in (cuda, "cpu")]
    x, y, _, _ = pt.bundled_mnist_subset()
    x, y = x[:128], y[:128]
    before = _hand_kernel_launches()
    grads = [_first_grads(n, x, y) for n in nets]
    for name, want in grads[1].items():
        assert _rel_err(grads[0][name], want) <= 1e-4, name
    for n in nets:
        n.fit(x, y)
    out = nets[0].output(x)
    torch.cuda.synchronize()
    assert _hand_kernel_launches() == before
    assert abs(nets[0].score() - nets[1].score()) <= 1e-4
    for p, q in zip(*(n.params for n in nets)):
        for k in q:
            a, b = p[k].cpu(), q[k]
            assert ((a - b).norm() / b.norm()).item() <= 1e-3, k
    assert out.is_contiguous() and bool(torch.isfinite(out).all())
