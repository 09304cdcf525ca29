"""PyTorch port, LSTM kernel module: the port's `fused_lstm_sequence` on
CPU tensors (its plain version) against the JAX package's Pallas kernel in
interpret mode and against its `_lstm_cell` scan, on the same numpy inputs.

Tolerance atol 1e-5: float32 throughout (inputs are fed to JAX as explicit
f32, since the suite enables x64), sums of at most F+H = 14 terms in
another order, over at most 6 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.lstm import \
    fused_lstm_sequence as jax_fused_lstm
from deeplearning4j_tpu.nn.layers.recurrent import _lstm_cell as jax_cell
from deeplearning4j_tpu_torch.kernels import lstm
from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
OFFS = 1.0


def _arrays(T, B=3, F=5, H=6, seed=0):
    r = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return (f32(r.normal(size=(T, B, F))),
            f32(r.normal(size=(F + H, 4 * H)) * 0.3),
            f32(r.normal(size=(4 * H,)) * 0.1),
            f32(r.normal(size=(3 * H,)) * 0.1),
            f32(r.normal(size=(B, H)) * 0.5),
            f32(r.normal(size=(B, H)) * 0.5))


def _jax_scan(x, W, b, peep, h0, c0):
    H = h0.shape[-1]
    step = lambda c, x_t: jax_cell(W, b, peep, H, c, x_t, None, OFFS,
                                   jax.nn.sigmoid, jnp.tanh)
    (hT, cT), hs = jax.lax.scan(step, (h0, c0), x)
    return hs, hT, cT


def _close(got, want):
    for name, g, w in zip(("hs", "h_T", "c_T"), got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == np.float32 and w.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("T", [1, 6])
def test_plain_version_matches_jax_pallas_kernel(T):
    arrays = _arrays(T)
    want = jax_fused_lstm(*map(jnp.asarray, arrays), OFFS, True)
    got = lstm.fused_lstm_sequence(*map(torch.from_numpy, arrays), OFFS)
    _close(got, want)


@pytest.mark.parametrize("T", [1, 6])
def test_plain_version_matches_jax_scan(T):
    arrays = _arrays(T, seed=1)
    want = _jax_scan(*map(jnp.asarray, arrays))
    got = lstm.lstm_sequence_reference(*map(torch.from_numpy, arrays), OFFS)
    _close(got, want)


def test_cpu_tensors_never_count_a_launch():
    before = lstm.launches
    lstm.fused_lstm_sequence(*map(torch.from_numpy, _arrays(3)), OFFS)
    assert lstm.launches == before


def test_output_keeps_input_dtype():
    x, *rest = map(torch.from_numpy, _arrays(2))
    hs, hT, cT = lstm.fused_lstm_sequence(x.double(), *rest, OFFS)
    assert hs.dtype == hT.dtype == cT.dtype == torch.float64


@pytest.mark.parametrize("bad", ["int_input", "bad_W", "bad_peep", "empty",
                                 "non_contiguous", "too_wide"])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad):
    x, W, b, peep, h0, c0 = map(torch.from_numpy, _arrays(3))
    if bad == "int_input":
        args, err = (x.long(), W, b, peep, h0, c0), TypeError
    elif bad == "bad_W":
        args, err = (x, W[:, :-1], b, peep, h0, c0), ValueError
    elif bad == "bad_peep":
        args, err = (x, W, b, peep[:-1], h0, c0), ValueError
    elif bad == "empty":
        args, err = (x[:0], W, b, peep, h0, c0), ValueError
    elif bad == "non_contiguous":
        args, err = (x.transpose(0, 1).contiguous().transpose(0, 1), W, b,
                     peep, h0, c0), ValueError
    else:
        # past one shared-memory chunk of x_t: the kernel streams it in
        # chunks (card test), the plain version on the CPU answers
        F, H = lstm.MAX_SHARED_BYTES // 4, 2
        assert 0 < lstm.lstm_x_chunk(F, H) < F
        hs, hT, cT = lstm.fused_lstm_sequence(
            torch.zeros((2, 1, F)), torch.zeros((F + H, 4 * H)),
            torch.zeros(4 * H), torch.zeros(3 * H), torch.zeros((1, H)),
            torch.zeros((1, H)), OFFS)
        assert hs.shape == (2, 1, H) and torch.equal(hs, torch.zeros_like(hs))
        return
    with pytest.raises(err):
        lstm.fused_lstm_sequence(*args, OFFS)


def test_layer_selects_the_kernel_like_the_jax_helper():
    """Mask-free sigmoid/tanh float input -> the kernel wrapper; a mask or
    another activation -> the plain step loop."""
    layer = GravesLSTM(n_in=5, n_out=6)
    x = torch.zeros((2, 4, 5))
    assert layer._helper(x, None)
    assert not layer._helper(x, torch.ones((2, 4)))
    assert not GravesLSTM(n_out=6, gate_activation="hardsigmoid")._helper(
        x, None)
    assert not layer._helper(x.long(), None)


def test_layer_kernel_path_equals_step_loop():
    """The layer's kernel path (plain version on the CPU) and its masked
    step loop with an all-ones mask give the same sequence."""
    layer = GravesLSTM(n_in=5, n_out=6)
    _, W, b, peep, _, _ = map(torch.from_numpy, _arrays(1))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 4, 5)).astype(np.float32))
    params = {"W": W, "b": b, "peep": peep}
    y_kernel, _ = layer.apply(params, {}, x)
    y_loop, _ = layer.apply(params, {}, x, mask=torch.ones((3, 4)))
    np.testing.assert_allclose(y_kernel.numpy(), y_loop.numpy(), rtol=0,
                               atol=ATOL)
