"""Card tests of the PyTorch port's CUDA kernels: each kernel against its
plain PyTorch version on the same GPU tensors.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs on a machine without it. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest configures JAX.)
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import lstm

pytestmark = pytest.mark.cuda

# f32 sums of up to F+H terms in another order than the plain version's
# matmul, compounded over the recurrence
TOL = 5e-5


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
