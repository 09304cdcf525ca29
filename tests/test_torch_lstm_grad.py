"""PyTorch port, the LSTM training kernels' plain versions and autograd
Function, on CPU tensors, against the JAX package on the same numpy inputs:

  * the residual-saving forward against JAX `_fwd_impl(save_residuals=True)`
    run in interpret mode;
  * the plain backward against `jax.vjp` of JAX `fused_lstm_sequence` in
    interpret mode (its Pallas `_bwd_kernel`), with random cotangents on
    hs, h_T and c_T;
  * the Function against torch autograd of the plain forward;
  * the float64 layer and network against JAX's float64 scan (the repair of
    a float64 LSTM that computed in float32 on the CPU).

Tolerances: atol 1e-5 for float32 (sums of at most F+H = 14 terms in
another order, over at most 6 steps; dW and db sum B*T = 18 terms more);
1e-12 for float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import lstm as jax_lstm
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import GravesLSTM as JaxGravesLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOutput
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JaxMultiLayerNetwork
from deeplearning4j_tpu_torch import from_jax_params
from deeplearning4j_tpu_torch.kernels import lstm
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import GravesLSTM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
OFFS = 1.0
GRADS = ("dx", "dW", "db", "dpeep", "dh0", "dc0")


def _arrays(T, B=3, F=5, H=6, seed=0, dtype=np.float32):
    r = np.random.default_rng(seed)
    c = lambda a: a.astype(dtype)
    return (c(r.normal(size=(T, B, F))), c(r.normal(size=(F + H, 4 * H)) * 0.3),
            c(r.normal(size=(4 * H,)) * 0.1), c(r.normal(size=(3 * H,)) * 0.1),
            c(r.normal(size=(B, H)) * 0.5), c(r.normal(size=(B, H)) * 0.5))


def _cotangents(T, B=3, H=6, seed=1):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(np.float32)
                 for s in ((T, B, H), (B, H), (B, H)))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("T", [1, 6])
def test_residual_forward_matches_jax_pallas_in_interpret_mode(T):
    arrays = _arrays(T)
    canon = jax_lstm._canon(*map(jnp.asarray, arrays))
    want = jax_lstm._fwd_impl(*canon, OFFS, True, save_residuals=True)
    got = lstm.lstm_sequence_reference(*map(torch.from_numpy, arrays), OFFS,
                                       save_residuals=True)
    for name, g, w in zip(("hs", "cs", "i", "f", "o", "g"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)
    # the wrapper on a CPU tensor: the same eight tensors, no launch
    before = lstm.launch_counts()
    wrapped = lstm.lstm_residual_forward(*map(torch.from_numpy, arrays), OFFS)
    assert lstm.launch_counts() == before
    for g, w in zip(wrapped, (got[0], got[0][-1], got[1][-1]) + got[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T", [1, 6])
def test_plain_backward_matches_jax_pallas_vjp(T):
    arrays = _arrays(T, seed=T)
    cots = _cotangents(T, seed=T + 1)
    _, vjp = jax.vjp(lambda *a: jax_lstm.fused_lstm_sequence(*a, OFFS, True),
                     *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cots)))
    x, W, b, peep, h0, c0 = map(torch.from_numpy, arrays)
    res = lstm.lstm_sequence_reference(x, W, b, peep, h0, c0, OFFS,
                                       save_residuals=True)
    got = lstm.lstm_sequence_backward_reference(
        x, W, peep, h0, c0, *res, *map(torch.from_numpy, cots))
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("with_dx", [True, False])
@pytest.mark.parametrize("missing", [None, "dhs", "carries"])
def test_function_matches_autograd_of_plain_forward(missing, with_dx):
    """All six gradients through every cotangent path, and with the h_T /
    c_T (or hs) outputs unused, as in a TBPTT chunk."""
    arrays = _arrays(6, seed=4)
    dhs, dhT, dcT = map(torch.from_numpy, _cotangents(6, seed=5))

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(with_dx or i > 0)
                  for i, a in enumerate(arrays)]
        hs, hT, cT = fn(*leaves, OFFS)
        loss = (0 if missing == "dhs" else (hs * dhs).sum()) + (
            0 if missing == "carries" else (hT * dhT).sum() + (cT * dcT).sum())
        want = [l for l in leaves if l.requires_grad]
        return torch.autograd.grad(loss, want)

    got = grads(lstm.lstm_sequence)
    want = grads(lstm.lstm_sequence_reference)
    assert len(got) == (6 if with_dx else 5)
    for name, g, w in zip(GRADS[(0 if with_dx else 1):], got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_function_keeps_input_dtype_and_counts_no_launch_on_cpu():
    x, *rest = map(torch.from_numpy, _arrays(3))
    x = x.double().requires_grad_()
    lstm.reset_launches()
    hs, hT, cT = lstm.lstm_sequence(x, *rest, OFFS)
    assert hs.dtype == hT.dtype == cT.dtype == torch.float64
    (dx,) = torch.autograd.grad(hs.sum(), [x])
    assert dx.dtype == torch.float64
    assert lstm.launch_counts() == dict.fromkeys(
        ("launches", "residual_launches", "adjoint_launches",
         "reduction_launches"), 0)


def test_layer_takes_the_function_only_when_autograd_records():
    layer = GravesLSTM(n_in=5, n_out=6)
    _, W, b, peep, _, _ = map(torch.from_numpy, _arrays(1))
    params = {"W": W.requires_grad_(), "b": b, "peep": peep}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 4, 5)).astype(np.float32))
    y, _ = layer.apply(params, {}, x)
    assert y.grad_fn is not None
    with torch.no_grad():
        y_ng, _ = layer.apply(params, {}, x)
    with torch.inference_mode():
        y_inf, _ = layer.apply(params, {}, x)
    assert y_ng.grad_fn is None and torch.equal(y.detach(), y_ng)
    assert torch.equal(y_ng, y_inf)


# ---------------------------------------------------------------------------
# float64 on the CPU
# ---------------------------------------------------------------------------
def test_float64_layer_matches_jax_float64_scan():
    arrays = _arrays(7, B=2, F=5, H=6, seed=9, dtype=np.float64)
    x, W, b, peep, h0, c0 = arrays
    x = np.swapaxes(x, 0, 1)       # the layer takes [B, T, F]
    params = {"W": W, "b": b, "peep": peep}
    want, _ = JaxGravesLSTM(n_in=5, n_out=6).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, {}, jnp.asarray(x))
    layer = GravesLSTM(n_in=5, n_out=6)
    xt = torch.from_numpy(x)
    assert not layer._helper(xt, None)   # float64 on the CPU: the step loop
    got, _ = layer.apply({k: torch.from_numpy(v) for k, v in params.items()},
                         {}, xt)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_float64_network_matches_jax_float64_network():
    conf = (JaxNNC.builder().seed(3).dtype("float64").list()
            .layer(JaxGravesLSTM(n_out=6)).layer(JaxGravesLSTM(n_out=6))
            .layer(JaxRnnOutput(n_out=5, activation="softmax"))
            .set_input_type(JaxInputType.recurrent(5, 8)).build())
    jnet = JaxMultiLayerNetwork(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                            device="cpu").init()
    from_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    assert net.params[0]["W"].dtype == torch.float64
    x = np.eye(5)[np.random.default_rng(1).integers(0, 5, (3, 8))]
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
