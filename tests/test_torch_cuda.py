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
from torch_threads import one_torch_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# the bidirectional LSTM, MoE ties and remat (main paths 8-9)
# ---------------------------------------------------------------------------
def _tree_grads(net, x, y, fmask=None):
    """{"layer/key path": gradient on the CPU} of the network's score,
    through nested parameter trees (a BiLSTM's `0/fwd/W`)."""
    from deeplearning4j_tpu_torch.nn.trees import leaf_paths, tree_map
    params = tuple(tree_map(lambda v: v.detach().requires_grad_(), p)
                   for p in net.params)
    paths = [(f"{i}/{k}", v) for i, p in enumerate(params)
             for k, v in leaf_paths(p)]
    as_t = lambda a: None if a is None else torch.as_tensor(
        a, device=net.device)
    score, _ = net._loss_fn(params, net.state, as_t(x), as_t(y),
                            fmask=as_t(fmask))
    grads = torch.autograd.grad(score, [v for _, v in paths])
    return score.item(), {n: g.detach().cpu()
                          for (n, _), g in zip(paths, grads)}


def _bilstm_net(device, B=64, remat=None, policy=None):
    from deeplearning4j_tpu_torch.nn.layers import (GravesBidirectionalLSTM,
                                                    LastTimeStep)
    b = pt.NeuralNetConfiguration.builder().seed(3).updater(pt.Adam(2e-3))
    if remat is not None:
        b = b.remat(remat).remat_policy(policy)
    conf = (b.list().layer(GravesBidirectionalLSTM(n_out=200))
            .layer(GravesBidirectionalLSTM(n_out=200))
            .layer(LastTimeStep())
            .layer(pt.OutputLayer(n_out=77, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.recurrent(77, 64)).build())
    return pt.MultiLayerNetwork(conf, device=device).init(
        generator=torch.Generator().manual_seed(5))


def _bilstm_batch(B=64, T=64, seed=0):
    r = np.random.default_rng(seed)
    eye = np.eye(77, dtype=np.float32)
    return eye[r.integers(0, 77, (B, T))], eye[r.integers(0, 77, B)]


def test_bilstm_on_the_card_matches_the_plain_path(cuda):
    """The stacked BiLSTM of chip_smoke's main path 8 (B 64, T 64, 2 x
    BiLSTM(200)): the output (primal kernel) within TOL and the gradients
    (residual forward, adjoint and reduction kernels) within 1e-4 of each
    tensor's largest entry of the same network on the card with every LSTM
    kernel replaced by its plain version."""
    net = _bilstm_net(cuda)
    x, y = _bilstm_batch()
    out = net.output(x)
    got = _tree_grads(net, x, y)
    saved = {name: getattr(lstm, name) for name in (
        "fused_lstm_sequence", "lstm_sequence")}
    lstm.fused_lstm_sequence = lambda *a: lstm.lstm_sequence_reference(*a)
    lstm.lstm_sequence = lambda *a: lstm.lstm_sequence_reference(*a)
    try:
        ref_out = net.output(x)
        want = _tree_grads(net, x, y)
    finally:
        for name, fn in saved.items():
            setattr(lstm, name, fn)
    assert (out - ref_out).abs().max().item() <= TOL
    assert abs(got[0] - want[0]) <= 1e-5
    for name, g in want[1].items():
        assert _rel_err(got[1][name], g) <= 1e-4, name


def test_bilstm_step_launch_counts_and_variants(cuda):
    """One training step of the BiLSTM: 4 residual-forward, 4 adjoint and 4
    reduction launches, the forward and adjoint 2 "cluster" (layer 1, F 77)
    and 2 "streamed" (layer 2, F 400); an inference forward 4 primal
    launches; a masked batch none."""
    net = _bilstm_net(cuda)
    x, y = _bilstm_batch()
    assert lstm.sequence_variant(64, 77, 200) == "cluster"
    assert lstm.sequence_variant(64, 400, 200) == "streamed"
    lstm.reset_launches()
    net.fit(x, y)
    torch.cuda.synchronize()
    assert lstm.launch_counts() == {"launches": 0, "residual_launches": 4,
                                    "adjoint_launches": 4,
                                    "reduction_launches": 4}
    v = lstm.variant_counts()
    for kind in ("residual", "adjoint"):
        assert v[kind] == {"cluster": 2, "streamed": 2}, (kind, v)
    lstm.reset_launches()
    net.output(x)
    assert lstm.launch_counts()["launches"] == 4
    lstm.reset_launches()
    mask = np.ones((64, 64), np.float32)
    mask[::2, 40:] = 0.0
    net.output(x, features_mask=mask)
    assert set(lstm.launch_counts().values()) == {0}


def test_bilstm_remat_is_bit_equal_and_relaunches_the_residual(cuda):
    """remat="layer" with policy "dots": the score and every gradient
    bit-equal to the run without remat; the recompute launches the
    residual-saving forward once more per direction and layer (4 + 4)."""
    x, y = _bilstm_batch(B=16)
    runs = {}
    for key, args in (("plain", {}), ("remat", {"remat": "layer",
                                                "policy": "dots"})):
        net = _bilstm_net(cuda, **args)
        lstm.reset_launches()
        runs[key] = (_tree_grads(net, x, y),
                     lstm.launch_counts()["residual_launches"])
    (s0, g0), n0 = runs["plain"]
    (s1, g1), n1 = runs["remat"]
    assert s0 == s1
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert (n0, n1) == (4, 8)


def test_moe_ties_route_the_lowest_experts_on_the_card(cuda):
    """All-zero rows tie every router logit: experts 0 and 1 win with gates
    1/2 on the card as on the CPU (a stable descending sort, where
    torch.topk promises no order); other rows route to the same experts on
    both devices."""
    from deeplearning4j_tpu_torch.nn.layers.moe import top_k_gates
    r = np.random.default_rng(0)
    logits = r.normal(size=(64, 8)).astype(np.float32)
    logits[-8:] = 0.0
    logits[5, 2:5] = 0.25           # a three-way tie within a row
    cpu = top_k_gates(torch.as_tensor(logits), 2)
    card = top_k_gates(torch.as_tensor(logits, device=cuda), 2).cpu()
    assert torch.equal(card > 0, cpu > 0)
    assert torch.allclose(card, cpu, rtol=0, atol=1e-6)
    want = torch.zeros(8, 8)
    want[:, :2] = 0.5
    assert torch.equal(card[-8:], want)
    assert int((card > 0).sum(1).max()) == 2


# ---------------------------------------------------------------------------
# ComputationGraphs: kernels 4-7 through graph vertices (main path 10)
# ---------------------------------------------------------------------------
def _graph_grads(g, ds):
    """(score, {"vertex/key path": gradient on the CPU}) of a graph."""
    from deeplearning4j_tpu_torch.nn.trees import leaf_paths, tree_map
    inputs, labels, fm, lm = g._to_inputs(ds)
    params = {n: tree_map(lambda v: v.detach().requires_grad_(), p)
              for n, p in g.params.items()}
    paths = [(f"{n}/{k}", v) for n, p in params.items()
             for k, v in leaf_paths(p)]
    score, _ = g._loss_fn(params, g.state, inputs, labels, None, fm, lm)
    grads = torch.autograd.grad(score, [v for _, v in paths])
    return score.item(), {n: d.detach().cpu()
                          for (n, _), d in zip(paths, grads)}


def _seq2seq_graph(device, B=64, T=64):
    """chip_smoke's encoder-decoder graph (AdditionRNN's shape at the
    char-RNN's widths) and one batch of one-hot characters."""
    conf = (pt.NeuralNetConfiguration.builder().seed(7)
            .updater(pt.Adam(2e-3)).graph_builder()
            .add_inputs("enc", "dec")
            .add_layer("encoder", pt.GravesLSTM(n_out=200), "enc")
            .add_vertex("last", pt.LastTimeStepVertex(), "encoder")
            .add_vertex("dup", pt.DuplicateToTimeSeriesVertex(), "last",
                        "dec")
            .add_vertex("merge", pt.MergeVertex(), "dec", "dup")
            .add_layer("decoder", pt.GravesLSTM(n_out=200), "merge")
            .add_layer("out", pt.RnnOutputLayer(n_out=77,
                                                activation="softmax",
                                                loss="mcxent"), "decoder")
            .set_outputs("out")
            .set_input_types(pt.InputType.recurrent(77, T),
                             pt.InputType.recurrent(77, T)).build())
    g = pt.ComputationGraph(conf, device=device).init(
        generator=torch.Generator().manual_seed(8))
    r = np.random.default_rng(9)
    eye = np.eye(77, dtype=np.float32)
    ds = pt.MultiDataSet(features=[eye[r.integers(0, 77, (B, T))]
                                   for _ in range(2)],
                         labels=[eye[r.integers(0, 77, (B, T))]])
    return g, ds


def test_seq2seq_graph_step_matches_the_cpu_with_cluster_launches(cuda):
    """The seq2seq graph's GravesLSTM vertices on the card: first-step
    gradients within 1e-4 of each tensor's largest entry of the CPU's, one
    Adam step's score within 1e-4 and parameters within 1e-3 relative L2;
    the step launches 2 residual-forward, 2 adjoint and 2 reduction
    kernels, forward and adjoint "cluster" (F 77 and 277, H 200); an
    rnn_time_step call 2 primal launches, within TOL of the CPU's."""
    pair = [_seq2seq_graph(d) for d in (cuda, "cpu")]
    grads = [_graph_grads(g, ds) for g, ds in pair]
    for name, want in grads[1][1].items():
        assert _rel_err(grads[0][1][name], want) <= 1e-4, name
    lstm.reset_launches()
    pair[0][0].fit(pair[0][1])
    torch.cuda.synchronize()
    assert lstm.launch_counts() == {"launches": 0, "residual_launches": 2,
                                    "adjoint_launches": 2,
                                    "reduction_launches": 2}
    v = lstm.variant_counts()
    for kind in ("residual", "adjoint"):
        assert v[kind] == {"cluster": 2, "streamed": 0}, (kind, v)
    pair[1][0].fit(pair[1][1])
    (g, ds), (ref, _) = pair
    assert abs(g.score() - ref.score()) <= 1e-4
    for n in ref.params:
        for k, b in ref.params[n].items():
            a = g.params[n][k].cpu()
            assert ((a - b).norm() / b.norm()).item() <= 1e-3, (n, k)
    lstm.reset_launches()
    x = [f[:8, 0] for f in ds.features]
    assert (g.rnn_time_step(*x).cpu() - ref.rnn_time_step(*x)).abs().max() \
        <= TOL
    assert lstm.launch_counts()["launches"] == 2


def _two_branch_graph(device, width=1024, B=128):
    conf = (pt.NeuralNetConfiguration.builder().seed(10)
            .updater(pt.Adam(1e-3)).compute_dtype("bfloat16")
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", pt.DenseLayer(n_out=width, activation="identity",
                                           has_bias=False), "a")
            .add_layer("bna", pt.BatchNormalization(activation="relu"), "da")
            .add_layer("db", pt.DenseLayer(n_out=width, activation="identity",
                                           has_bias=False), "b")
            .add_layer("bnb", pt.BatchNormalization(activation="relu"), "db")
            .add_vertex("m", pt.MergeVertex(), "bna", "bnb")
            .add_layer("out", pt.OutputLayer(n_out=10, activation="softmax",
                                             loss="mcxent"), "m")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(784),
                             pt.InputType.feed_forward(784)).build())
    g = pt.ComputationGraph(conf, device=device).init(
        generator=torch.Generator().manual_seed(11))
    x, y, _, _ = pt.bundled_mnist_subset()
    return g, pt.MultiDataSet(features=[x[:B], x[B:2 * B]], labels=[y[:B]])


def test_two_branch_bn_graph_step_matches_the_cpu_with_resident_launches(
        cuda):
    """The bf16 two-branch graph's BatchNormalization(relu) vertices on the
    card: first-step gradients within 2e-2 of each tensor's largest entry
    of the CPU's (the bf16 limit), one Adam step's score within 2e-2 and
    parameters and running statistics within 5e-2 relative L2; the step
    launches one "resident" forward and one backward per BN vertex, the
    evaluation forward none."""
    pair = [_two_branch_graph(d) for d in (cuda, "cpu")]
    grads = [_graph_grads(g, ds) for g, ds in pair]
    for name, want in grads[1][1].items():
        assert _rel_err(grads[0][1][name], want) <= 2e-2, name
    bn_relu.reset_launches()
    pair[0][0].fit(pair[0][1])
    torch.cuda.synchronize()
    assert bn_relu.launch_counts() == {"fwd_launches": 2, "bwd_launches": 2}
    assert bn_relu.variant_counts() == {
        "fwd": {"resident": 2, "streamed": 0},
        "bwd": {"resident": 2, "streamed": 0}}
    pair[1][0].fit(pair[1][1])
    (g, ds), (ref, _) = pair
    assert abs(g.score() - ref.score()) <= 2e-2
    for tree, ref_tree in ((g.params, ref.params), (g.state, ref.state)):
        for n in ref_tree:
            for k, b in ref_tree[n].items():
                a = tree[n][k].cpu().double()
                b = b.double()
                scale = max(b.norm().item(), 1e-3 * b.numel() ** 0.5)
                assert (a - b).norm().item() / scale <= 5e-2, (n, k)
    bn_relu.reset_launches()
    out = g.output(*ds.features)[0]
    torch.cuda.synchronize()
    assert set(bn_relu.launch_counts().values()) == {0}
    assert (out.cpu() - ref.output(*ds.features)[0]).abs().max() <= 2e-2


def test_resnet_block_on_the_card_matches_the_cpu(cuda):
    """One bottleneck block of ResNet-50 at ImageNet's first-stage widths
    (56 x 56 x 64 in, 256 out, the projection shortcut, batch 4, float32):
    output within 1e-4 of the largest entry and the first step's gradients
    within 1e-2 relative L2 per tensor of the CPU's (the VGG limits: ReLU
    masks and BN); no hand kernel launches (4-D BN: the plain tier)."""
    from deeplearning4j_tpu_torch.models import zoo
    pair = [zoo.resnet50(n_classes=10, image=224, blocks=(1,), width=64,
                         compute_dtype=None, device=d).init(
        generator=torch.Generator().manual_seed(12)) for d in (cuda, "cpu")]
    r = np.random.default_rng(13)
    x = r.normal(size=(4, 224, 224, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, 4)]
    ds = pt.DataSet(x, y)
    before = _hand_kernel_launches()
    outs = [g.output(x)[0].cpu() for g in pair]
    assert _rel_err(outs[0], outs[1]) <= 1e-4
    grads = [_graph_grads(g, ds) for g in pair]
    torch.cuda.synchronize()
    assert _hand_kernel_launches() == before
    assert abs(grads[0][0] - grads[1][0]) <= 1e-4 * abs(grads[1][0])
    for name, want in grads[1][1].items():
        got = grads[0][1][name]
        assert ((got - want).norm() / want.norm()).item() <= 1e-2, name


# ---------------------------------------------------------------------------
# the training loop on the card: CUDA-graph replays (nn/superstep.py)
# ---------------------------------------------------------------------------
def _loop_mlp(cuda, dropout=None, bn=False, width=64, dtype=None, seed=3):
    b = pt.NeuralNetConfiguration.builder().seed(seed).updater(
        pt.Adam(1e-3))
    if dtype is not None:
        b = b.compute_dtype(dtype)
    b = b.list().layer(pt.DenseLayer(
        n_out=width, activation="identity" if bn else "relu",
        dropout=dropout))
    if bn:
        b = b.layer(pt.BatchNormalization(activation="relu"))
    conf = (b.layer(pt.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(12)).build())
    return pt.MultiLayerNetwork(conf, device=cuda).init(
        generator=torch.Generator().manual_seed(seed))


def _loop_data(n, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 12)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[r.integers(0, 5, n)]


def _same_run(a, b):
    from deeplearning4j_tpu_torch.nn.trees import flatten_tree
    for tree in ("params", "updater_state", "state"):
        la = flatten_tree(getattr(a, tree))[0]
        lb = flatten_tree(getattr(b, tree))[0]
        assert len(la) == len(lb)
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), tree
    assert a.iteration_count == b.iteration_count


_UPDATERS = [pt.nn.updaters.Sgd(0.1), pt.nn.updaters.Adam(1e-2),
             pt.nn.updaters.AdaMax(1e-2), pt.nn.updaters.AdaGrad(0.1),
             pt.nn.updaters.AdaDelta(), pt.nn.updaters.RmsProp(1e-2),
             pt.nn.updaters.Nesterovs(0.1, 0.9), pt.nn.updaters.NoOp()]


@pytest.mark.parametrize("u", _UPDATERS,
                         ids=[type(u).__name__ for u in _UPDATERS])
def test_scalar_row_gives_the_bits_of_host_floats_on_the_card(cuda, u):
    """A multiply by a 0-dim float32 CUDA tensor (a replayed step's scalar
    row) gives the bits of a multiply by the same float32 as a Python
    scalar, through every updater, five steps."""
    r = np.random.default_rng(4)
    p = {"W": torch.tensor(r.normal(size=(33, 17)), dtype=torch.float32,
                           device=cuda)}
    sa, sb = u.init(p), u.init(p)
    for step in range(5):
        g = {"W": torch.tensor(r.normal(size=(33, 17)), dtype=torch.float32,
                               device=cuda)}
        host = u.scalars(step, None)
        row = torch.tensor(host, dtype=torch.float32, device=cuda)
        ua, sa = u.apply(g, sa, host)
        ub, sb = u.apply(g, sb, tuple(row[i] for i in range(len(host))))
        assert torch.equal(ua["W"], ub["W"])
    h = torch.tensor(r.normal(size=257), dtype=torch.bfloat16, device=cuda)
    s = float(torch.tensor(0.1234567, dtype=torch.float32))
    assert torch.equal(pt.nn.updaters.smul(s, h),
                       pt.nn.updaters.smul(torch.tensor(s, device=cuda), h))


def _replay_check(cuda, make, call):
    """Capture one wrapper call, replay it on 3 fresh inputs: each replay
    bit-equal to an eager call, the counters at 3 replayed launches."""
    from deeplearning4j_tpu_torch import kernels
    def quiet(fn):
        with kernels.tally():
            return fn()

    static = quiet(lambda: make(0))
    quiet(lambda: call(*static))
    torch.cuda.synchronize()
    before = kernels.count_snapshot()
    g = torch.cuda.CUDAGraph()
    with kernels.tally() as launched, torch.cuda.graph(g):
        out = call(*static)
    captured = kernels.tally_delta(launched)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for seed in (1, 2, 3):
        fresh = quiet(lambda: make(seed))
        for s, f in zip(static, fresh):
            if isinstance(s, torch.Tensor):
                s.copy_(f)
        g.replay()
        kernels.add_counts(captured)
        want = quiet(lambda: call(*fresh))
        want = want if isinstance(want, (tuple, list)) else (want,)
        torch.cuda.synchronize()
        assert all((o is None and w is None) or torch.equal(o, w)
                   for o, w in zip(outs, want))
    got = kernels.count_delta(before, kernels.count_snapshot())
    n = sum(sum(t.values()) for t, _ in got.values())
    m = sum(sum(t.values()) for t, _ in captured.values())
    assert m == 1 and n == 3


@pytest.mark.parametrize("kind,shape", [
    ("fwd", (64, 32, 77, 200)), ("fwd", (8, 4, 77, 512)),
    ("residual", (64, 64, 77, 200)), ("residual", (8, 4, 77, 512)),
    ("adjoint", (64, 64, 77, 200)), ("adjoint", (8, 4, 77, 512)),
    ("reduction", (64, 64, 77, 200))])
def test_lstm_kernels_replay_bit_equal_from_a_cuda_graph(cuda, kind, shape):
    T, B, F, H = shape

    def make(seed):
        args = _lstm_args(T, B, F, H, cuda, seed=seed)
        if kind in ("fwd", "residual"):
            return args + [1.0]
        x, W, b, peep, h0, c0 = args
        res = lstm.lstm_sequence_reference(*args, 1.0, save_residuals=True)
        r = np.random.default_rng(seed + 50)
        dh = [torch.as_tensor(r.normal(size=s).astype(np.float32),
                              device=cuda)
              for s in ((T, B, H), (B, H), (B, H), (T, B, 4 * H))]
        if kind == "adjoint":
            return [W, peep, c0, *res[1:], dh[0], dh[1], dh[2], F]
        return [x, res[0], h0, res[1], c0, dh[3]]
    call = {"fwd": lstm.fused_lstm_sequence,
            "residual": lstm.lstm_residual_forward,
            "adjoint": lstm.lstm_adjoint,
            "reduction": lstm.lstm_param_grads}[kind]
    _replay_check(cuda, make, call)


@pytest.mark.parametrize("kind,dtype,Dh", [
    ("fwd", "float32", 64), ("lse", "float32", 64), ("dq", "float32", 64),
    ("dkv", "float32", 64), ("dq", "bfloat16", 64), ("dkv", "bfloat16", 64),
    ("lse", "float32", 512), ("dq", "float32", 512)])
def test_attention_kernels_replay_bit_equal_from_a_cuda_graph(cuda, kind,
                                                              dtype, Dh):
    B, T, H = 4, 128, 6 if Dh == 64 else 2
    dt = getattr(torch, dtype)

    def make(seed):
        r = np.random.default_rng(seed)
        q, k, v, do = (torch.as_tensor(r.normal(size=(B, T, H, Dh)).astype(
            np.float32), device=cuda).to(dt) for _ in range(4))
        if kind in ("fwd", "lse"):
            return [q, k, v, True]
        o, lse = attention.attention_reference_heads_lse(q, k, v, True)
        if kind == "dq":
            return [q, k, v, o, lse, do, True]
        dsum = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
        return [q, k, v, do, lse, dsum, True]
    call = {"fwd": attention.flash_attention_heads,
            "lse": attention.flash_attention_fwd_lse_heads,
            "dq": attention.attention_bwd_dq,
            "dkv": attention.attention_bwd_dkv}[kind]
    _replay_check(cuda, make, call)


@pytest.mark.parametrize("kind,N,C", [("fwd", 128, 1024), ("bwd", 128, 1024),
                                      ("fwd", 57345, 8), ("bwd", 57345, 8)])
def test_bn_kernels_replay_bit_equal_from_a_cuda_graph(cuda, kind, N, C):
    def make(seed):
        r = np.random.default_rng(seed)
        x, dy = (torch.as_tensor(r.normal(size=(N, C)).astype(np.float32),
                                 device=cuda).to(torch.bfloat16)
                 for _ in range(2))
        g, b = (torch.as_tensor(r.normal(size=C).astype(np.float32),
                                device=cuda) for _ in range(2))
        if kind == "fwd":
            return [x, g, b]
        _, mean, var = bn_relu.bn_relu_reference(x, g, b)
        return [x, g, b, mean, var, dy]
    call = (bn_relu.bn_relu_forward if kind == "fwd"
            else bn_relu.bn_relu_backward)
    _replay_check(cuda, make, call)


@pytest.mark.parametrize("k", [2, 3, "epoch"])
def test_superstep_replays_match_eager_steps_with_dropout(cuda, k):
    """Windows replayed from one captured step (the dropout generator
    registered with the graph) give the eager per-batch bits, generator
    state included."""
    x, y = _loop_data(7 * 16 + 5)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=16)
    a = _loop_mlp(cuda, dropout=0.4)
    a.fit(it(), epochs=2)
    b = _loop_mlp(cuda, dropout=0.4)
    b.fit(it(), epochs=2, superstep=k)
    _same_run(a, b)
    assert torch.equal(a._generator.get_state(), b._generator.get_state())
    assert len(b._captured_steps) == 2        # full batches and the tail


def test_superstep_bf16_bn_counts_replayed_launches(cuda):
    """A bf16 BN network: K=4 bit-equal to K=1, one resident forward and
    backward BN launch a step counted through the replays."""
    x, y = _loop_data(8 * 128)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=128)
    a = _loop_mlp(cuda, bn=True, width=256, dtype="bfloat16")
    a.fit(it())
    bn_relu.reset_launches()
    b = _loop_mlp(cuda, bn=True, width=256, dtype="bfloat16")
    b.fit(it(), superstep=4)
    assert bn_relu.variant_counts() == {
        "fwd": {"resident": 8, "streamed": 0},
        "bwd": {"resident": 8, "streamed": 0}}
    _same_run(a, b)


def test_accumulation_replays_match_eager_on_the_card(cuda):
    x, y = _loop_data(9 * 16)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=16)
    from deeplearning4j_tpu_torch.nn import superstep as ss
    a = _loop_mlp(cuda, dropout=0.3)
    keep = ss._captures
    ss._captures = lambda model: False
    try:
        a.fit(it(), grad_accumulation=4, superstep=2)
    finally:
        ss._captures = keep
    b = _loop_mlp(cuda, dropout=0.3)
    b.fit(it(), grad_accumulation=4, superstep=2)
    _same_run(a, b)


def test_fit_scan_tbptt_replays_match_the_per_batch_fit(cuda):
    V, T = 11, 40
    r = np.random.default_rng(5)
    idx = r.integers(0, V, (8, T + 1))
    eye = np.eye(V, dtype=np.float32)
    x, y = eye[idx[:, :-1]], eye[idx[:, 1:]]
    mk = lambda: pt.char_rnn(vocab_size=V, lstm_size=24, seq_len=T,
                             tbptt=20, device=cuda).init(
        generator=torch.Generator().manual_seed(6))
    batches = [pt.DataSet(x[:4], y[:4]), pt.DataSet(x[4:], y[4:])]
    a = mk()
    a.fit(pt.ListDataSetIterator(batches))
    lstm.reset_launches()
    b = mk()
    b.fit_scan(batches)
    assert lstm.launch_counts()["residual_launches"] == 2 * 4
    _same_run(a, b)


def test_guard_rollback_and_resume_on_the_card(cuda, tmp_path):
    from deeplearning4j_tpu_torch.fault import (FaultyIterator, SimulatedCrash,
                                                TrainingGuard, crash_at_write)
    x, y = _loop_data(12 * 16)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=16)
    keep = np.r_[0:64, 128:192]
    ref = _loop_mlp(cuda)
    ref.fit(pt.ArrayDataSetIterator(x[keep], y[keep], batch_size=16),
            superstep=4)
    m = _loop_mlp(cuda)
    m.fit(FaultyIterator(it(), nan_at=5), superstep=4,
          guard=TrainingGuard("rollback", refresh_every=100))
    _same_run(ref, m)
    full = _loop_mlp(cuda)
    full.fit(it(), superstep=4)
    d = str(tmp_path / "ck")
    k = _loop_mlp(cuda)
    with crash_at_write(nth=2):
        with pytest.raises(SimulatedCrash):
            k.fit(it(), superstep=4, checkpoint_dir=d, checkpoint_every=5)
    r = _loop_mlp(cuda)
    r.fit(it(), superstep=4, checkpoint_dir=d, resume=True)
    _same_run(full, r)


def test_prefetch_stages_on_a_side_stream_and_matches(cuda):
    x, y = _loop_data(8 * 64)
    it = lambda: pt.ArrayDataSetIterator(x, y, batch_size=64)
    a = _loop_mlp(cuda)
    a.fit(it())
    for k in (1, 4):
        b = _loop_mlp(cuda)
        b.fit(it(), prefetch=True, superstep=k)
        _same_run(a, b)


def test_a_step_that_syncs_raises_capture_error(cuda, monkeypatch):
    """A step with a host sync cannot be captured: CaptureError names the
    op, and nothing trains eagerly in its place."""
    from deeplearning4j_tpu_torch.nn.superstep import CaptureError
    m = _loop_mlp(cuda)
    layer = m.layers[0]
    orig = type(layer).apply

    def syncing(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0].sum().item()
        return out
    monkeypatch.setattr(type(layer), "apply", syncing)
    before = m.params_flat()
    x, y = _loop_data(4 * 16)
    with pytest.raises(CaptureError, match="synchroniz"):
        m.fit(pt.ArrayDataSetIterator(x, y, batch_size=16), superstep=2)
    assert m.iteration_count == 0
    np.testing.assert_array_equal(m.params_flat(), before)


def test_telemetry_counts_captures_and_reads_the_card(cuda):
    x, y = _loop_data(6 * 16)
    sess = pt.TelemetrySession()
    with pt.telemetry.enabled(sess):
        _loop_mlp(cuda).fit(pt.ArrayDataSetIterator(x, y, batch_size=16),
                            epochs=2, superstep=3)
        sample = sess.watermarks.sample()
    assert sess.compiles.count("nn/superstep") == 1
    assert sample["device0_bytes"] > 0 and sample["device0_peak_bytes"] > 0


@pytest.mark.parametrize("k", [1, 2])
def test_fit_takes_batches_already_on_the_card(cuda, k):
    """DataSets and MultiDataSets holding CUDA tensors train per batch and
    in windows on both model kinds, as their host arrays do, and
    fit_scan stacks them on the card."""
    x, y = _loop_data(4 * 16)
    host = [pt.DataSet(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    dev = [pt.DataSet(torch.as_tensor(d.features, device=cuda),
                      torch.as_tensor(d.labels, device=cuda)) for d in host]
    a = _loop_mlp(cuda)
    a.fit(pt.ListDataSetIterator(host), superstep=k)
    b = _loop_mlp(cuda)
    b.fit(pt.ListDataSetIterator(dev), superstep=k)
    _same_run(a, b)
    c = _loop_mlp(cuda)
    c.fit_scan(dev)
    _same_run(a, c)
    conf = (pt.NeuralNetConfiguration.builder().seed(3).updater(pt.Sgd(0.1))
            .graph_builder().add_inputs("in")
            .add_layer("out", pt.OutputLayer(n_out=5, activation="softmax",
                                             loss="mcxent"), "in")
            .set_outputs("out")
            .set_input_types(pt.InputType.feed_forward(12)).build())
    ga = pt.ComputationGraph(conf, device=cuda).init()
    ga.fit(pt.ListDataSetIterator(host), superstep=k)
    gb = pt.ComputationGraph(conf, device=cuda).init()
    gb.fit(pt.ListDataSetIterator(
        [pt.MultiDataSet(features=[d.features], labels=[d.labels])
         for d in dev]), superstep=k)
    _same_run(ga, gb)


# ---- the decode plane (generation) ----------------------------------------

def _gen_lm(device, seed=3, width=64, heads=4, blocks=2, t=64):
    b = (pt.NeuralNetConfiguration.builder().seed(seed).list()
         .layer(pt.EmbeddingSequenceLayer(n_in=48, n_out=width)))
    for _ in range(blocks):
        b = b.layer(pt.TransformerBlock(n_heads=heads))
    conf = (b.layer(pt.RnnOutputLayer(n_out=48, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(pt.InputType.recurrent(1, t)).build())
    return pt.MultiLayerNetwork(conf, device=device).init()


def _gen_registry(device, precision="fp32", seed=3):
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()
    reg = ModelRegistry(buckets=(1,), device=device)
    reg.register("lm", _gen_lm(device, seed=seed), precision=precision)
    return reg


def _full_logits(net, ctx):
    x = torch.tensor(ctx, dtype=torch.float32,
                     device=net.device)[None, :, None]
    with torch.no_grad():
        h = net._forward(net.params, net.state, x,
                         upto=len(net.layers) - 1)[0]
        return net.layers[-1].preout(net.params[-1], {}, h)[0, -1].float()


@pytest.mark.parametrize("n", [5, 9, 40])
def test_decode_prefill_launches_kernel_one_per_block(cuda, n):
    """A prefill attends through kernel 1's primal, "tiled", float32: one
    launch per block; a tick launches no hand kernel. Its logits are the
    full forward's."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    reg = _gen_registry(cuda)
    v = reg.get("lm")
    eng = DecodeEngine(reg, "lm", block_len=8, decode_buckets=(1, 2))
    pool = eng.new_pool()
    eng.prepare(v, pool)
    prompt = list(np.random.default_rng(n).integers(0, 48, n))
    blocks = pool.alloc(eng.spec.blocks_for(n + 1))
    attention.reset_launches()
    logits = eng.run_prefill(v, pool, prompt, blocks)
    assert attention.launch_counts()["launches"] == 2
    assert attention.variant_counts()["fwd"]["tiled"] == 2
    assert attention.dtype_counts()["float32"] == 2
    eng.run_tick(v, pool, [int(np.argmax(logits))], [n], [blocks], bucket=1)
    assert attention.launch_counts()["launches"] == 2
    assert eng.lazy_captures == 0 and eng.captures == 2
    want = _full_logits(v.model, prompt).cpu().numpy()
    assert np.abs(logits - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("bucket", [1, 8])
def test_decode_tick_replays_bit_equal_to_an_eager_tick(cuda, bucket):
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    reg = _gen_registry(cuda)
    v = reg.get("lm")
    eng = DecodeEngine(reg, "lm", block_len=8, decode_buckets=(1, 8))
    pool = eng.new_pool()
    eng.prepare(v, pool)
    r = np.random.default_rng(bucket)
    rows = []
    for i in range(bucket):
        n = int(r.integers(3, 30))
        prompt = list(r.integers(0, 48, n))
        blocks = pool.alloc(eng.spec.blocks_for(n + 1))
        tok = int(np.argmax(eng.run_prefill(v, pool, prompt, blocks)))
        rows.append((tok, n, blocks))
    toks, pos, tabs = zip(*rows)
    replayed = eng.run_tick(v, pool, toks, pos, tabs, bucket)
    inp = np.zeros((bucket, 2 + eng.spec.table_width), np.int64)
    for i, (t, p, b) in enumerate(rows):
        inp[i, 0], inp[i, 1] = t, p
        inp[i, 2:] = eng._pad_table(b)
    x = torch.from_numpy(inp).to(cuda)
    with torch.no_grad():
        eager = eng.decode_exec(v, bucket)(v.snapshot.data, pool.cache,
                                           x[:, 0], x[:, 1], x[:, 2:],
                                           eng.spec)
    np.testing.assert_array_equal(replayed, eager.cpu().numpy())


def test_failed_tick_capture_raises_and_keeps_the_live_version(
        cuda, monkeypatch):
    """A tick with a host sync cannot be captured: the swap that would
    bring it in raises AotCompileError, the live version keeps serving
    from its graphs, and nothing runs a tick eagerly."""
    from deeplearning4j_tpu_torch.nn.layers.transformer import \
        TransformerBlock
    from deeplearning4j_tpu_torch.serving import AotCompileError
    from deeplearning4j_tpu_torch.serving.decode import GenerationScheduler
    reg = _gen_registry(cuda)
    v1 = reg.get("lm")
    sched = GenerationScheduler(reg, "lm", block_len=8,
                                decode_buckets=(1, 2))
    try:
        before = sched.submit([1, 2, 3], max_tokens=6, timeout=120)
        orig = TransformerBlock.decode_attend

        def syncing(self, *a, **kw):
            out = orig(self, *a, **kw)
            out.sum().item()
            return out
        monkeypatch.setattr(TransformerBlock, "decode_attend", syncing)
        with pytest.raises(AotCompileError, match="tick-b1"):
            reg.swap("lm", _gen_lm(cuda, seed=4))
        assert reg.get("lm") is v1
        assert sched.submit([1, 2, 3], max_tokens=6,
                            timeout=120) == before
        assert sched.engine.lazy_captures == 0
    finally:
        sched.stop()


def test_int8_kv_arena_on_the_card(cuda):
    from deeplearning4j_tpu_torch.serving.decode import GenerationScheduler
    reg = _gen_registry(cuda)
    first = {}
    for kv in ("fp32", "int8"):
        sched = GenerationScheduler(reg, "lm", block_len=8, kv_dtype=kv,
                                    decode_buckets=(1,))
        try:
            cache = sched.pool.cache
            assert cache["kv"].device.type == "cuda"
            assert cache["kv"].dtype == (torch.int8 if kv == "int8"
                                         else torch.float32)
            res = sched.submit([4, 9, 1, 7], max_tokens=8, timeout=120)
            assert res["generated_tokens"] == 8
            first[kv] = res["tokens"][0]
        finally:
            sched.stop()
    assert first["int8"] == first["fp32"]


def test_bf16_prefill_takes_the_bf16_instantiation(cuda):
    from deeplearning4j_tpu_torch.serving.decode import GenerationScheduler
    reg = _gen_registry(cuda, precision="bf16")
    sched = GenerationScheduler(reg, "lm", block_len=8, decode_buckets=(1,))
    try:
        attention.reset_launches()
        res = sched.submit([4, 9, 1, 7], max_tokens=8, timeout=120)
        assert res["generated_tokens"] == 8
        assert attention.dtype_counts() == {"float32": 0, "bfloat16": 2,
                                            "float16": 0}
        assert attention.launch_counts()["launches"] == 2
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# the continual loop and the streaming route on the card
# ---------------------------------------------------------------------------
def _bn_mlp_zip(path, width=256):
    conf = (pt.NeuralNetConfiguration.builder().seed(3)
            .updater(pt.Adam(1e-3)).compute_dtype("bfloat16").list()
            .layer(pt.DenseLayer(n_out=width, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(784)).build())
    net = pt.MultiLayerNetwork(conf, device="cpu").init()
    pt.ModelSerializer.write_model(net, str(path))
    return str(path)


@pytest.mark.parametrize("superstep", [1, 2])
def test_continual_cycle_fine_tunes_through_the_bn_kernels(cuda, tmp_path,
                                                           superstep):
    """One promoted cycle on the card: one resident BN+ReLU forward and
    backward launch a step (through the replays at superstep 2), none in
    gate scoring or serving; the candidate on the CPU from the same zip
    and window within the bf16 limits."""
    from deeplearning4j_tpu_torch.continual import (CanaryPolicy,
                                                    ContinualTrainer)
    from deeplearning4j_tpu_torch.streaming.topic import (FileTopic,
                                                          TopicPublisher)
    x, y, xt, yt = pt.bundled_mnist_subset()
    boot = _bn_mlp_zip(tmp_path / "boot.zip")
    topic = FileTopic(str(tmp_path), "t")
    rec = np.concatenate([x[:256], y[:256]], axis=1)
    for i in range(0, 256, 64):
        TopicPublisher(topic).publish(rec[i:i + 64])
    reg = pt.ModelRegistry(buckets=(1, 8), device=cuda)
    gate = pt.DataSet(xt, yt)

    def traffic():
        for i in range(40):
            arm = reg.route_arm("m")
            reg.predict("m", xt[i][None], arm=arm)
            reg.observe_canary("m", arm, latency_s=1e-3)

    t = ContinualTrainer(reg, "m", topic, workdir=str(tmp_path / "loop"),
                         gate_set=gate, initial_source=boot,
                         feature_width=784, window_records=4,
                         batch_size=128, superstep=superstep,
                         canary_policy=CanaryPolicy(min_requests=8),
                         buckets=(1, 8), traffic_hook=traffic)
    t.recover()
    bn_relu.reset_launches()
    cand = []
    fine_tune = t._fine_tune
    t._fine_tune = lambda arrays: cand.append(fine_tune(arrays)) or cand[-1]
    res = t.run_cycle()
    assert res["outcome"] == "promoted"
    assert bn_relu.launch_counts() == {"fwd_launches": 2, "bwd_launches": 2}
    assert len(cand[0][0].__dict__.get("_captured_steps", {})) == \
        (1 if superstep > 1 else 0)
    cpu = ContinualTrainer(pt.ModelRegistry(buckets=(1,), device="cpu"),
                           "m", topic, workdir=str(tmp_path / "cpu"),
                           gate_set=gate, feature_width=784,
                           batch_size=128, superstep=superstep)
    cpu.stable_ckpt = t.journal.replay()[0]["ckpt"]
    arrays = [np.asarray(rec[i:i + 64]) for i in range(0, 256, 64)]
    cpu_cand = cpu._fine_tune(arrays)[0]
    assert abs(cpu_cand.score(gate) - res["score"]) <= 2e-2
    for p, q in zip(cand[0][0].params, cpu_cand.params):
        for k in ("W",):
            if k in q:
                a, b = p[k].detach().cpu(), q[k]
                assert ((a - b).norm() / b.norm()).item() <= 5e-2


def test_inference_route_serves_the_char_rnn_on_the_card(cuda, tmp_path):
    """Arrays over TCP through the route on the card: two cluster LSTM
    launches a batch, outputs within 1e-4 of the CPU."""
    from deeplearning4j_tpu_torch.streaming import (InferenceRoute,
                                                    NDArrayConsumer,
                                                    NDArrayPublisher)
    net = pt.char_rnn(vocab_size=77, lstm_size=200, seq_len=64,
                      device="cpu")
    net.init(generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "rnn.zip")
    pt.ModelSerializer.write_model(net, path)
    r = np.random.default_rng(0)
    xs = [np.eye(77, dtype=np.float32)[r.integers(0, 77, (b, 64))]
          for b in (1, 8, 32)]
    lstm.reset_launches()
    with NDArrayConsumer() as sink:
        route = InferenceRoute(path, device=cuda, forward=NDArrayPublisher(
            sink.host, sink.port)).start()
        try:
            with NDArrayPublisher("127.0.0.1", route.port) as src:
                for x in xs:
                    src.publish(x)
            outs = [sink.take(timeout=60) for _ in xs]
        finally:
            route.stop()
            route.forward.close()
    for x, o in zip(xs, outs):
        assert o is not None
        np.testing.assert_allclose(o, net.output(x).numpy(), atol=1e-4)
    assert lstm.variant_counts()["fwd"] == {"cluster": 6, "streamed": 0}
    assert lstm.launch_counts()["residual_launches"] == 0


# ----------------------------------------------------------------------
# the data-parallel trainer on a one-rank NCCL group (ROADMAP A11a)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def nccl_world():
    """A one-rank NCCL process group on the card (rendezvous on a free
    localhost port); skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket

    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import initialize
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    assert initialize(f"localhost:{port}", 1, 0) is True
    assert dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


def _par_mlp(seed=5):
    conf = (pt.NeuralNetConfiguration.builder().seed(seed)
            .updater(pt.Adam(1e-3)).compute_dtype("bfloat16").list()
            .layer(pt.DenseLayer(n_out=256, activation="identity"))
            .layer(pt.BatchNormalization(activation="relu"))
            .layer(pt.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(64)).build())
    return pt.MultiLayerNetwork(conf, device="cuda").init(
        generator=torch.Generator().manual_seed(seed))


def _par_batches(n=4, b=128):
    r = np.random.default_rng(3)
    x = r.normal(size=(n * b, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, n * b)]
    return [pt.DataSet(x[i:i + b], y[i:i + b]) for i in range(0, n * b, b)]


def _trees_equal(a, b):
    from deeplearning4j_tpu_torch.nn.trees import flat_leaves
    la, lb = flat_leaves(a), flat_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("strategy", ["replicated", "zero1", "zero2",
                                      "fsdp"])
def test_one_rank_nccl_trainer_matches_fit(cuda, nccl_world, strategy, k):
    """ParallelTrainer on the one-rank NCCL group: the bf16 BN-MLP through
    kernels 4-5, bit-equal to the model's own fit at superstep 1 and 2
    (parameters, updater state, running statistics), one resident BN
    forward and backward launch a BN layer and step."""
    from deeplearning4j_tpu_torch.parallel import ParallelTrainer, make_mesh
    batches = _par_batches()
    ref, net = _par_mlp(), _par_mlp()
    ref.fit(pt.ListDataSetIterator(batches), superstep=k)
    tr = ParallelTrainer(net, mesh=make_mesh(), strategy=strategy)
    assert tr.mesh.backend == "nccl"
    bn_relu.reset_launches()
    tr.fit(pt.ListDataSetIterator(batches), superstep=k)
    torch.cuda.synchronize()
    got = bn_relu.variant_counts()
    assert got["fwd"]["resident"] == got["bwd"]["resident"] == 4
    for a, b in ((net.params, ref.params),
                 (net.updater_state, ref.updater_state),
                 (net.state, ref.state)):
        assert _trees_equal(a, b)
    assert net.iteration_count == ref.iteration_count == 4


def test_captured_window_replays_its_collective(cuda, nccl_world,
                                                monkeypatch):
    """A superstep window of the ZERO2 trainer is replays of one CUDA graph
    that holds the step's NCCL collectives: the Python collective calls
    happen only in the capture's warm-up and capture (never per replayed
    step), the replays are bit-equal to the eager per-batch steps, and a
    step whose collective cannot be captured would raise CaptureError."""
    from deeplearning4j_tpu_torch.parallel import (ParallelTrainer,
                                                   make_mesh, zero)
    calls = {"rs": 0}
    orig = zero.reduce_scatter_

    def counting(out, inp, group=None):
        calls["rs"] += 1
        return orig(out, inp, group)

    monkeypatch.setattr(zero, "reduce_scatter_", counting)
    batches = _par_batches(n=8)
    eager, windowed = _par_mlp(), _par_mlp()
    te = ParallelTrainer(eager, mesh=make_mesh(), strategy="zero2")
    te.fit(pt.ListDataSetIterator(batches))
    per_step = calls["rs"] // 8
    assert per_step >= 1
    calls["rs"] = 0
    tw = ParallelTrainer(windowed, mesh=make_mesh(), strategy="zero2")
    tw.fit(pt.ListDataSetIterator(batches), superstep=4)
    torch.cuda.synchronize()
    assert len(tw.__dict__["_captured_steps"]) == 1
    assert calls["rs"] == 2 * per_step      # warm-up + capture, 8 replays
    for a, b in ((windowed.params, eager.params),
                 (windowed.updater_state, eager.updater_state),
                 (windowed.state, eager.state)):
        assert _trees_equal(a, b)


# ---------------------------------------------------------------------------
# the split BN+ReLU kernels (global-batch BN across data ranks)
# ---------------------------------------------------------------------------
def _split_args(N, C, dtype, device, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(N, C)) * 1.5 + r.normal(size=C)
    arrays = (x, 1 + 0.2 * r.normal(size=C), 0.3 * r.normal(size=C),
              r.normal(size=(N, C)))
    x, g, b, dy = (torch.as_tensor(a.astype(np.float32), device=device)
                   for a in arrays)
    return x.to(dtype), g, b, dy.to(dtype)


def _ulp(dtype):
    return {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("N,C", [(64, 1024), (2048, 1024), (2049, 200),
                                 (300, 48)])
def test_bn_split_kernels_match_plain(cuda, dtype, N, C):
    """Each of the four split kernels against its plain version on the
    same card tensors: the [3, C] and [2, C] sums at 1e-5 of the largest
    magnitude, y and dx within one ulp of the dtype plus that; one launch
    each, counted."""
    from deeplearning4j_tpu_torch.kernels import bn_split as s
    x, g, b, dy = _split_args(N, C, dtype, cuda, N + C)
    before = s.launch_counts()
    st = s.split_stats(x)
    n, mean, var = s.chan_merge([st])
    y = s.split_apply(x, g, b, mean, var)
    sums = s.split_bwd_sums(x, g, b, mean, var, dy)
    dx = s.split_bwd_dx(x, g, b, mean, var, dy, sums, float(N))
    after = s.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after), (before, after)
    rel = lambda a, w: float((a.float() - w.float()).abs().max()
                             / w.float().abs().max())
    assert rel(st, s.split_stats_reference(x)) <= 1e-5
    assert rel(sums, s.split_bwd_sums_reference(x, g, b, mean, var, dy)) \
        <= 1e-5
    for got, want in ((y, s.split_apply_reference(x, g, b, mean, var)),
                      (dx, s.split_bwd_dx_reference(x, g, b, mean, var, dy,
                                                    sums, float(N)))):
        got, want = got.float(), want.float()
        limit = (_ulp(dtype) * got.abs().maximum(want.abs())
                 + 1e-5 * want.abs().max())
        assert bool(((got - want).abs() <= limit).all())


def test_bn_split_merge_equals_fused_statistics(cuda):
    """Four ranks' triples from the stats kernel, merged by Chan's formula,
    give the fused forward kernel's mean and variance over the union (1e-5
    of the largest magnitude)."""
    from deeplearning4j_tpu_torch.kernels import bn_split as s
    x, g, b, _ = _split_args(4096, 1024, torch.bfloat16, cuda, 7)
    n, mean, var = s.chan_merge([s.split_stats(p) for p in x.chunk(4)])
    _, f_mean, f_var = bn_relu.bn_relu_forward(x, g, b)
    assert float(n[0]) == 4096.0
    for got, want in ((mean, f_mean), (var, f_var)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_bn_split_autograd_one_rank_group_equals_fused(cuda):
    """`split_bn_relu` over a one-rank group (no process group: the
    gather is the identity) through autograd: y, dx, dgamma and dbeta
    against the fused kernels' autograd Function, within one bf16 ulp /
    1e-5; one launch of each split kernel."""
    from deeplearning4j_tpu_torch.kernels import bn_split as s
    from deeplearning4j_tpu_torch.parallel.collectives import BatchGroup
    x, g, b, dy = _split_args(512, 1024, torch.bfloat16, cuda, 9)
    xs, gs, bs = (t.clone().requires_grad_(True) for t in (x, g, b))
    xf, gf, bf = (t.clone().requires_grad_(True) for t in (x, g, b))
    before = s.launch_counts()
    ys, _, _ = s.split_bn_relu(xs, gs, bs, 1e-5, BatchGroup(None, 2))
    ys.backward(dy)
    yf, _, _ = bn_relu.fused_bn_relu(xf, gf, bf)
    yf.backward(dy)
    after = s.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after), (before, after)
    for got, want in ((ys, yf), (xs.grad, xf.grad)):
        got, want = got.float(), want.float()
        limit = 2.0 ** -7 * got.abs().maximum(want.abs()) + 1e-5 * \
            want.abs().max()
        assert bool(((got - want).abs() <= limit).all())
    for got, want in ((gs.grad, gf.grad), (bs.grad, bf.grad)):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


_GLOO_CAPTURE = r'''
import socket, sys
import torch
import deeplearning4j_tpu_torch as pt
from deeplearning4j_tpu_torch.nn.superstep import CaptureError
from deeplearning4j_tpu_torch.parallel import ParallelTrainer, make_mesh
import torch.distributed as dist
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
conf = (pt.NeuralNetConfiguration.builder().seed(1).updater(pt.Sgd(0.1))
        .list().layer(pt.DenseLayer(n_out=8, activation="tanh"))
        .layer(pt.OutputLayer(n_out=4, loss="mcxent"))
        .set_input_type(pt.InputType.feed_forward(8)).build())
net = pt.MultiLayerNetwork(conf, device="cuda").init()
tr = ParallelTrainer(net, mesh=make_mesh())
x = torch.randn(32, 8).numpy()
y = torch.eye(4)[torch.randint(0, 4, (32,))].numpy()
it = pt.ListDataSetIterator([pt.DataSet(x[i:i + 8], y[i:i + 8])
                             for i in range(0, 32, 8)])
tr.fit(it)                       # superstep 1: eager, staged through host
try:
    tr.fit(it, superstep=2)
except CaptureError as e:
    print("CaptureError", "cannot be captured" in str(e))
    sys.exit(0)
print("no CaptureError")
sys.exit(1)
'''


def test_gloo_window_on_the_card_raises_capture_error(cuda):
    """Ranks sharing a card run gloo, whose collectives go through the
    host (`parallel/collectives.py`): a window of superstep 2 cannot be
    captured and raises CaptureError naming it; superstep 1 trains. Run
    in its own process (one process group a process)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _GLOO_CAPTURE],
                          capture_output=True, text=True, cwd=root,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CaptureError True" in proc.stdout


# ----------------------------------------------------------------------
# word vectors (ROADMAP A12: nlp/, graphlib/): no hand kernel; the epochs
# replay one captured step
# ----------------------------------------------------------------------
def _nlp_step_args(dtype, device, B=96, V=700, D=64, W2=8, seed=0):
    r = np.random.default_rng(seed)
    ctx = r.integers(0, V, (B, W2))
    ctx[:, 1] = ctx[:, 0]
    vm = (r.random((B, W2)) > 0.3).astype(np.float32)
    pn = r.random(V)
    arrays = (r.normal(size=(B, D)) * 0.3, r.normal(size=(V, D)) * 0.3)
    return ([torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
            + [torch.as_tensor(ctx, device=device),
               torch.as_tensor(vm, device=device),
               torch.as_tensor(vm.sum(1), device=device),
               torch.as_tensor(pn / pn.sum(), dtype=torch.float32,
                               device=device)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sgns_step_on_the_card_matches_the_cpu(cuda, dtype):
    """The expected-NS step on the card against the same code on the CPU:
    float64 at 1e-9 of the largest entry; float32 (bf16 logits and
    cotangent, f32 products via `torch.mm(out_dtype=)`) at 1e-2."""
    from deeplearning4j_tpu_torch.nlp.embeddings import _sgns_expected_step
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()
    got = _sgns_expected_step(*_nlp_step_args(dtype, cuda), 5)
    want = _sgns_expected_step(*_nlp_step_args(dtype, "cpu"), 5)
    tol = 1e-9 if dtype == torch.float64 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        err = ((g.cpu() - w).abs().max() / w.abs().max()).item()
        assert err <= tol, err


def _nlp_corpus(n_sent=300, V=120, L=12, seed=0):
    r = np.random.default_rng(seed)
    words = r.zipf(1.3, size=(n_sent, L)) % V
    return [" ".join(f"w{w}" for w in row) for row in words]


def _nlp_epoch(device, dtype, steps, seed=0):
    """A corpus-runner epoch of `steps` steps from one seeded table and one
    CPU draw stream; returns (syn0, syn1neg, init, runner)."""
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.nlp.embeddings import (
        InMemoryLookupTable, make_skipgram_corpus_runner)
    m = nlp.Word2Vec(sentence_iterator=nlp.CollectionSentenceIterator(
        _nlp_corpus(seed=seed)), layer_size=32, window_size=3, seed=seed,
        min_word_frequency=1, device="cpu")
    seqs = m.build_vocab()
    flat, sid = m._flatten_corpus(seqs, subsample=False)
    n, B = len(flat), 64
    g = torch.Generator().manual_seed(seed)
    T = -(-n // B)
    pos = torch.randperm(n, generator=g).repeat(2)[:T * B].view(T, B)
    win = torch.randint(1, 4, (T, B), generator=g)
    lrs = torch.linspace(0.025, 0.001, T)
    init = m.lookup_table.syn0.clone()
    t = InMemoryLookupTable.from_arrays(m.vocab, init, negative=5,
                                        device=device)
    s0, s1 = t.syn0.to(dtype), t.syn1neg.to(dtype)
    run = make_skipgram_corpus_runner(t, 3)
    run(s0, s1, torch.as_tensor(flat, dtype=torch.int64, device=device),
        torch.as_tensor(sid, dtype=torch.int64, device=device),
        pos[:steps].to(device), win[:steps].to(device),
        lrs[:steps].to(device))
    return s0.cpu(), s1.cpu(), init.to(dtype), run


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sgns_epoch_replays_one_capture_and_matches_the_cpu(cuda, dtype):
    """A corpus-runner epoch on the card is one capture and a replay a
    step, launches no hand kernel, and equals the CPU's eager epoch on the
    same draws: float64 at 1e-9 of the largest entry, float32 (8 steps)
    at 5e-2 of the tables' move (a run that lost its last step reads past
    it)."""
    from deeplearning4j_tpu_torch import kernels
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()
    S = 40 if dtype == torch.float64 else 8
    before = kernels.count_snapshot()
    g0, g1, init, run = _nlp_epoch(cuda, dtype, S)
    torch.cuda.synchronize()
    assert run.epochs.captures == 1 and run.epochs.replays == S
    assert kernels.count_delta(before, kernels.count_snapshot()) == \
        kernels.count_delta(before, before)
    c0, c1, _, _ = _nlp_epoch("cpu", dtype, S)
    s0, s1, _, _ = _nlp_epoch("cpu", dtype, S - 1)
    if dtype == torch.float64:
        for g, c in ((g0, c0), (g1, c1)):
            assert ((g - c).abs().max() / c.abs().max()).item() <= 1e-9
    else:
        def gap(a, b, o):
            return ((a - b).norm() / (b - o).norm()).item()
        zero = torch.zeros_like(c1)
        assert gap(g0, c0, init) <= 5e-2 and gap(g1, c1, zero) <= 5e-2
        assert gap(g0, s0, init) > 5e-2 and gap(g1, s1, zero) > 5e-2


def test_word2vec_fit_captures_once_and_records_the_dispatch(cuda):
    """Two epochs of one fit on the card capture the SGNS step once (the
    telemetry twin: `word2vec/sgns_epoch` counts 1), replay it every step
    and record the device/dispatch span; a second fit replays the same
    capture."""
    from deeplearning4j_tpu_torch import nlp
    sents = ["the quick brown fox jumps over the lazy dog",
             "the cat sat on the mat and the dog barked"] * 20
    w2v = nlp.Word2Vec(sentence_iterator=nlp.CollectionSentenceIterator(
        sents), layer_size=8, window_size=2, negative=2,
        min_word_frequency=1, epochs=2, batch_size=64, seed=3)
    assert w2v.device.type == "cuda"
    sess = pt.TelemetrySession()
    with pt.telemetry.enabled(sess):
        w2v.fit()
        rep = sess.compiles.report()
        assert rep.get("word2vec/sgns_epoch", {}).get("count") == 1, rep
        assert sess.span_totals().get("device/dispatch", 0) > 0
    w2v.fit()
    eps = w2v._sg_runner.epochs
    assert eps.captures == 1 and eps.replays > 0
    assert np.isfinite(w2v.lookup_table.vectors_matrix()).all()


class _CpuDraws:
    """Negatives and infer_vector's draws from one CPU stream, moved to the
    model's device: the card and the CPU train on the same draws."""

    def _stream(self):
        from deeplearning4j_tpu_torch.nlp import NegativeSampler
        if getattr(self, "_draw_gen", None) is None:
            self._draw_gen = torch.Generator().manual_seed(5)
            self._cpu_sampler = NegativeSampler(self.vocab.counts_array(),
                                                device="cpu")
        return self._draw_gen

    def _pair_negatives(self, gen, table, T, B, K):
        g = self._stream()
        return self._cpu_sampler.sample(g, (T, B, K)).to(table.device)


@pytest.mark.parametrize("case", ["sg_hs", "cbow", "dbow", "dm"])
def test_pair_epochs_replay_on_the_card_and_match_the_cpu(cuda, case):
    """The pair path (autograd inside the captured step) on the card
    against the CPU from one table and the same negatives, two epochs:
    1e-4 of the largest entry; one capture per task."""
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.nlp.embeddings import InMemoryLookupTable
    from deeplearning4j_tpu_torch.util.platform import strict_fp32
    strict_fp32()
    kw = dict(layer_size=16, window_size=3, min_word_frequency=1, seed=2,
              epochs=2, batch_size=64, negative=4)
    sents = _nlp_corpus(80, V=40, L=8, seed=3)
    if case == "sg_hs":
        kw.update(negative=0, use_hierarchic_softmax=True)
    elif case == "cbow":
        kw.update(elements_learning_algorithm="cbow")
    base = (nlp.ParagraphVectors if case in ("dbow", "dm")
            else nlp.Word2Vec)
    cls = type("M", (_CpuDraws, base), {})
    if case == "dm":
        kw.update(sequence_learning_algorithm="dm")
    out = []
    for device in (cuda, "cpu"):
        if base is nlp.ParagraphVectors:
            m = cls(iterator=nlp.CollectionLabeledSentenceIterator(
                sents, [f"d{i % 4}" for i in range(len(sents))]),
                device=device, **kw)
        else:
            m = cls(sentence_iterator=nlp.CollectionSentenceIterator(sents),
                    device=device, **kw)
        m.build_vocab()
        if out:
            t = out[0].lookup_table
            m.lookup_table = InMemoryLookupTable.from_arrays(
                m.vocab, init, negative=t.negative, use_hs=t.use_hs,
                device="cpu")
        else:
            init = m.lookup_table.syn0.cpu().clone()
        m.fit()
        out.append(m)
    for k in ("syn0", "syn1", "syn1neg"):
        a = getattr(out[0].lookup_table, k)
        if a is None:
            continue
        b = getattr(out[1].lookup_table, k)
        assert ((a.cpu() - b).abs().max() / b.abs().max()).item() <= 1e-4, k
    assert all(r.epochs.captures == 1
               for r in out[0]._pair_runners.values())


def test_glove_epochs_replay_on_the_card_and_match_the_cpu(cuda):
    from deeplearning4j_tpu_torch import nlp

    class G(nlp.Glove):
        def _init_params(self, V, D):
            g = torch.Generator().manual_seed(1)
            p = {k: torch.empty((V, D)).uniform_(-0.5 / D, 0.5 / D,
                                                 generator=g)
                 for k in ("w", "wc")}
            p.update(b=torch.zeros(V), bc=torch.zeros(V))
            return {k: v.to(self.device) for k, v in p.items()}

    sents = _nlp_corpus(100, V=50, L=8, seed=4)
    ms = [G(sentence_iterator=nlp.CollectionSentenceIterator(sents),
            layer_size=12, window=4, epochs=5, batch_size=100, seed=1,
            device=d) for d in (cuda, "cpu")]
    for m in ms:
        m.fit()
    a, b = (m.lookup_table.syn0.cpu() for m in ms)
    assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4
    assert ms[0]._epochs.captures == 1 and ms[0]._epochs.replays > 0


def test_distributed_word2vec_one_rank_nccl_bit_equal_to_fit(cuda,
                                                             nccl_world):
    """DistributedWord2Vec on the one-rank NCCL group (the step's sums
    all-reduced inside the captured graph) is bit-equal to Word2Vec.fit,
    the corpus path and the pair path."""
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.parallel import make_mesh
    sents = _nlp_corpus(120, V=60, L=10, seed=6)
    for extra in ({}, {"negative": 0, "use_hierarchic_softmax": True}):
        kw = dict(layer_size=16, window_size=3, min_word_frequency=1,
                  epochs=2, seed=4, batch_size=128, **extra)
        a = nlp.Word2Vec(sentence_iterator=nlp.CollectionSentenceIterator(
            sents), **kw)
        a.fit()
        b = DistributedWord2Vec(mesh=make_mesh(),
                                sentence_iterator=nlp.CollectionSentenceIterator(
                                    sents), **kw)
        b.fit()
        for k in ("syn0", "syn1", "syn1neg"):
            x = getattr(a.lookup_table, k)
            if x is not None:
                assert torch.equal(x, getattr(b.lookup_table, k)), k


def test_word_vectors_load_on_the_card_through_model_guesser(cuda,
                                                             tmp_path):
    from deeplearning4j_tpu_torch import nlp
    from deeplearning4j_tpu_torch.util import ModelGuesser
    m = nlp.Word2Vec(sentence_iterator=nlp.CollectionSentenceIterator(
        _nlp_corpus(40, V=30, L=6)), layer_size=8, min_word_frequency=1,
        seed=1)
    m.fit()
    S = nlp.WordVectorSerializer
    for write, read, name in ((S.write_word_vectors, S.read_word_vectors,
                               "v.txt"),
                              (S.write_binary, S.read_binary, "v.bin"),
                              (S.write_word2vec_model,
                               S.read_word2vec_model, "v.zip")):
        path = str(tmp_path / name)
        write(m, path)
        got = ModelGuesser.load(path)
        assert got.lookup_table.syn0.device.type == "cuda"
        np.testing.assert_array_equal(
            got.lookup_table.vectors_matrix(),
            read(path, device="cpu").lookup_table.vectors_matrix())


def test_graph_embeddings_on_the_card_separate_communities(cuda):
    from deeplearning4j_tpu_torch.graphlib import DeepWalk, Graph, Node2Vec
    g = Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(5, 6)
    for model in (DeepWalk(vector_size=16, walk_length=10,
                           walks_per_vertex=10, window_size=3, seed=3,
                           epochs=2),
                  Node2Vec(vector_size=16, walk_length=10,
                           walks_per_vertex=10, window_size=3, q=0.5,
                           seed=3, epochs=2)):
        model.fit(g)
        emb = np.stack([model.vertex_vector(i) for i in range(12)])
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        same = np.mean([emb[i] @ emb[j] for i in range(5) for j in range(5)
                        if i != j])
        cross = np.mean([emb[i] @ emb[j] for i in range(5)
                         for j in range(7, 12)])
        assert same > cross + 0.1, (type(model).__name__, same, cross)


# ------------------- the dashboard and the embedding plots -------------------

def _tsne_blobs(n=500, d=32, k=5, seed=0):
    r = np.random.default_rng(seed)
    c = r.normal(scale=3, size=(k, d))
    x = np.concatenate([c[i] + r.normal(size=(n // k, d)) for i in range(k)])
    return x.astype(np.float32), np.repeat(np.arange(k), n // k)


def test_tsne_p_and_first_steps_on_the_card_match_the_cpu(cuda):
    """The P matrix's search and 10 steps on the card against the CPU
    (the same P and start y); each row's entropy at log(perplexity); a
    CPU run that lost its last step reads past the steps' limit."""
    from deeplearning4j_tpu_torch.plot.tsne import Tsne, row_entropy
    x, _ = _tsne_blobs()
    xt = torch.tensor(x, device=cuda)
    card = Tsne(max_iter=10, perplexity=30.0)
    assert card.device.type == "cuda"
    cond = card.conditional_p(xt)
    want = Tsne(perplexity=30.0, device="cpu").conditional_p(x)
    assert (cond.cpu() - want).abs().max() <= 1e-4 * want.max()
    assert (row_entropy(cond) - np.log(30.0)).abs().max().item() <= 1e-3
    p = card._p_matrix(xt)
    y = card.fit_transform(xt)
    assert card.host_reads == 1 and np.isfinite(card.kl_divergence)
    runs = {}
    for steps in (9, 10):
        cpu = Tsne(max_iter=steps, perplexity=30.0, device="cpu")
        cpu._p_matrix = lambda _x: p.cpu()
        runs[steps] = cpu.fit_transform(x)
    scale = np.abs(runs[10]).max()
    err = np.abs(y - runs[10]).max() / scale
    control = np.abs(runs[9] - runs[10]).max() / scale
    assert err <= 1e-3 < control, (err, control)


def test_kmeans_on_the_card_matches_the_cpu(cuda):
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    x, _ = _tsne_blobs(n=2000)
    for distance in ("euclidean", "cosine"):
        card = KMeansClustering(5, distance=distance, seed=1).fit(
            torch.tensor(x, device=cuda))
        cpu = KMeansClustering(5, distance=distance, seed=1,
                               device="cpu").fit(x)
        np.testing.assert_array_equal(card.labels_, cpu.labels_)
        np.testing.assert_allclose(card.centers, cpu.centers, rtol=0,
                                   atol=1e-5)
        assert card.iterations == cpu.iterations == card.host_reads
        np.testing.assert_array_equal(card.predict(x[:50]),
                                      cpu.predict(x[:50]))


def test_cuda_input_never_falls_back_to_the_cpu(cuda):
    """A model on the CPU refuses a CUDA input; the host-side tools copy it
    to the host once."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, VPTree
    from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne
    from deeplearning4j_tpu_torch.ui import UIServer
    x, _ = _tsne_blobs(n=60, d=4)
    xt = torch.tensor(x, device=cuda)
    for model in (KMeansClustering(3, device="cpu"),
                  Tsne(max_iter=2, device="cpu")):
        with pytest.raises(ValueError, match="CUDA input"):
            model.fit(xt)
    bh = BarnesHutTsne(max_iter=20, perplexity=5.0).fit_transform(xt)
    assert bh.shape == (60, 2)
    tree = VPTree(xt)
    assert [i for _, i in tree.knn(xt[3], 1)] == [3]
    coords = torch.tensor(bh, device=cuda)
    data = UIServer(port=0).attach_tsne(coords, list(range(60))).tsne_data()
    np.testing.assert_allclose(data["points"], bh.astype(np.float64),
                               rtol=1e-6)


def test_stats_listener_on_a_cuda_model_matches_the_cpu(cuda, tmp_path):
    """The same zip and batches on the card and the CPU: reports' scores at
    1e-5, summaries at 1e-4 of the tensor's largest magnitude, the
    topology equal; a CUDA report carries the card's memory and takes two
    host copies (the score, the parameters)."""
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener
    conf = (pt.NeuralNetConfiguration.builder().seed(3)
            .updater(pt.Adam(1e-2)).list()
            .layer(pt.DenseLayer(n_out=32, activation="relu"))
            .layer(pt.OutputLayer(n_out=4, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(16)).build())
    path = str(tmp_path / "m.zip")
    pt.ModelSerializer.write_model(
        pt.MultiLayerNetwork(conf, device="cpu").init(), path)
    r = np.random.default_rng(0)
    data = [(r.normal(size=(64, 16)).astype(np.float32),
             np.eye(4, dtype=np.float32)[r.integers(0, 4, 64)])
            for _ in range(5)]
    reports, listeners = [], []
    for dev in ("cuda", "cpu"):
        net = pt.ModelSerializer.restore(path, device=dev)
        storage = InMemoryStatsStorage()
        listeners.append(StatsListener(storage, session_id=dev))
        net.set_listeners(listeners[-1])
        for x, y in data:
            net.fit(pt.DataSet(x, y))
        reports.append([rep for _, rep in storage.get_all_updates(
            dev, StatsListener.TYPE_ID, "local")])
    assert len(reports[0]) == len(reports[1]) == 5
    assert reports[0][0]["model"] == reports[1][0]["model"]
    for g, w in zip(*reports):
        assert abs(g["score"] - w["score"]) <= 1e-5
        assert g["memory"]["device_bytes_in_use"] > 0
        assert "device_bytes_in_use" not in w["memory"]
        for k, s in w["params"].items():
            scale = max(abs(s["min"]), abs(s["max"]))
            for key in ("mean", "stdev", "min", "max"):
                assert abs(g["params"][k][key] - s[key]) <= 1e-4 * scale
    assert listeners[0].host_copies == 2 * 5
    assert listeners[1].host_copies == 0


def _idx(path, arr):
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, arr.ndim]))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(arr.tobytes())


def test_bn_mlp_epoch_from_the_idx_fetcher_equals_the_plain_feed(cuda,
                                                                 tmp_path):
    """The bf16 BN-MLP trained one epoch on the card from
    MnistDataSetIterator over IDX files (the native reader and scaling)
    is bit-equal to the epoch fed from the plain numpy path's arrays, with
    one resident BN+ReLU forward and backward launch per BN layer a
    step."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    r = np.random.default_rng(20)
    images = r.integers(0, 256, (3000, 28, 28), dtype=np.uint8)
    labels = r.integers(0, 10, 3000).astype(np.uint8)
    _idx(str(tmp_path / "train-images-idx3-ubyte"), images)
    _idx(str(tmp_path / "train-labels-idx1-ubyte"), labels)
    x = native.u8_to_f32_plain(native.idx_read_plain(
        str(tmp_path / "train-images-idx3-ubyte")).reshape(3000, -1))
    y = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
    nets = []
    for it in (MnistDataSetIterator(batch_size=1024, cache=str(tmp_path)),
               pt.ArrayDataSetIterator(x, y, batch_size=1024)):
        net = _bn_mlp(cuda, width=256)
        bn_relu.reset_launches()
        net.fit(it)
        torch.cuda.synchronize()
        assert bn_relu.variant_counts() == {
            "fwd": {"resident": 6, "streamed": 0},
            "bwd": {"resident": 6, "streamed": 0}}
        nets.append(net)
    for p, q in zip(nets[0].params, nets[1].params):
        for k in q:
            assert torch.equal(p[k], q[k]), k


def test_char_rnn_benches_count_their_kernel_launches(cuda):
    """bench_char_rnn's windows replay the captured TBPTT chunk step (2 +
    2 + 2 cluster launches a chunk step, counted through the replays);
    bench_char_rnn_dispatch launches the same per chunk step eagerly."""
    from deeplearning4j_tpu_torch.models import zoo
    for bench, series in ((lambda: zoo.bench_char_rnn(batch=8, steps=3),
                           2 * 3),
                          (lambda: zoo.bench_char_rnn_dispatch(
                              batch=8, steps=2, warmup=1), 3)):
        lstm.reset_launches()
        value, label = bench()
        torch.cuda.synchronize()
        want = 2 * series * 2           # 2 layers, 2 chunks a series
        assert np.isfinite(value) and value > 0, label
        assert lstm.launch_counts() == {
            "launches": 0, "residual_launches": want,
            "adjoint_launches": want, "reduction_launches": want}, label
        assert lstm.variant_counts()["adjoint"]["cluster"] == want


def test_resnet50_and_lenet_benches_run_on_the_card(cuda):
    """The bf16 ResNet-50 bench (its 4-D BN takes the plain tier: no hand
    kernel) and the LeNet benches run on the card and give JAX's labels."""
    from deeplearning4j_tpu_torch.models import zoo
    bn_relu.reset_launches()
    value, label = zoo.bench_resnet50(batch=4, steps=2, image=64,
                                      n_classes=10)
    assert label == "ResNet50-ImageNet" and np.isfinite(value)
    assert set(bn_relu.launch_counts().values()) == {0}
    assert zoo.bench_lenet(batch=64, steps=4)[1] == "LeNet-MNIST"
    out = zoo.bench_lenet_superstep(batch=64, n_batches=4, epochs=1)
    assert out["superstep"]["superstep_compiles"] == 1
