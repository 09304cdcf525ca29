"""PyTorch port, the slice as a whole: a small char-RNN (vocab 11,
2 x GravesLSTM(8), T=5) moves between the packages through the
ModelSerializer zip both ways and through `from_jax_params`, and the port's
`output` and stateful `rnn_time_step` match the JAX package's.

Tolerance atol 1e-5: float32 on both sides (inputs fed to JAX as explicit
f32 under the suite's x64), two LSTM layers of 5 steps and a softmax head.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (ModelSerializer, char_rnn,
                                      from_jax_params, sample_characters)
from deeplearning4j_tpu_torch.fault.atomic import CorruptCheckpointError
from deeplearning4j_tpu_torch.kernels import lstm

ATOL = 1e-5
VOCAB, HIDDEN, SEQ = 11, 8, 5


def _jax_net(seed=3):
    return jax_char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ,
                        seed=seed).init()


def _features(batch, seed=0):
    r = np.random.default_rng(seed)
    return np.eye(VOCAB, dtype=np.float32)[r.integers(0, VOCAB, (batch, SEQ))]


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jz") / "char_rnn.zip")
    JaxModelSerializer.write_model(_jax_net(), path)
    return path


@pytest.mark.parametrize("batch", [1, 3])
def test_jax_zip_output_matches(jax_zip, batch):
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    x = _features(batch)
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    assert got.shape == want.shape == (batch, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 3])
def test_rnn_time_step_matches_over_four_steps(jax_zip, batch):
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    x = _features(batch, seed=1)
    for t in range(4):
        want = np.asarray(jnet.rnn_time_step(x[:, t]))
        got = net.rnn_time_step(x[:, t]).numpy()
        assert got.shape == (batch, VOCAB)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"step {t}")
    for i in range(2):                      # both layers carry (h, c)
        jh, jc = jnet.rnn_get_previous_state(i)
        h, c = net.rnn_get_previous_state(i)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL)
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state(0) is None


def test_port_zip_restores_in_jax(tmp_path):
    net = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ,
                   device="cpu").init(generator=torch.Generator()
                                      .manual_seed(5))
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    jnet = JaxModelSerializer.restore(path)
    x = _features(3, seed=2)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=ATOL)
    for i, p in enumerate(net.params):
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(jnet.params[i][k]),
                                          v.numpy())


def test_from_jax_params_gives_the_same_outputs():
    jnet = _jax_net(seed=4)
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    net = from_jax_params(char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN,
                                   seq_len=SEQ, device="cpu").init(), params)
    x = _features(3, seed=3)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=ATOL)


def test_from_jax_params_checks_keys_and_shapes():
    net = char_rnn(vocab_size=VOCAB, lstm_size=HIDDEN, seq_len=SEQ,
                   device="cpu").init()
    params = [{k: v.numpy() for k, v in p.items()} for p in net.params]
    missing = [dict(p) for p in params]
    del missing[1]["peep"]
    with pytest.raises(KeyError, match="i:1/k:peep"):
        from_jax_params(net, missing)
    wrong = [dict(p) for p in params]
    wrong[0]["W"] = wrong[0]["W"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        from_jax_params(net, wrong)
    with pytest.raises(ValueError, match="layer parameter dicts"):
        from_jax_params(net, params[:2])


def test_masked_input_matches_jax_masked_scan(jax_zip):
    """A features mask takes the plain step loop (as JAX takes its scan)."""
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    x = _features(3, seed=4)
    mask = np.ones((3, SEQ), np.float32)
    mask[0, 3:] = 0.0
    mask[2, 1:] = 0.0
    before = lstm.launches
    got = net.output(x, features_mask=mask).numpy()
    want = np.asarray(jnet.output(x, features_mask=mask))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert lstm.launches == before


def test_cpu_run_launches_no_kernel(jax_zip):
    net = ModelSerializer.restore(jax_zip, device="cpu")
    lstm.reset_launches()
    net.output(_features(3))
    net.rnn_time_step(_features(3)[:, 0])
    assert lstm.launches == 0


def test_sample_characters_matches_jax(jax_zip):
    """Same weights, same sampling RNG seed: the same text."""
    from deeplearning4j_tpu.models.zoo import \
        sample_characters as jax_sample
    chars = {c: i for i, c in enumerate("abcdefghij ")}
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    want = jax_sample(jnet, chars, "ab", 12, rng_seed=7)
    got = sample_characters(net, chars, "ab", 12, rng_seed=7)
    assert got == want and len(got) == 12


def test_corrupt_zip_is_refused(tmp_path, jax_zip):
    import zipfile
    path = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(jax_zip) as src, \
            zipfile.ZipFile(path, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "coefficients.npz":
                data = data[:-1] + bytes([data[-1] ^ 1])
            dst.writestr(name, data)
    with pytest.raises(CorruptCheckpointError, match="coefficients.npz"):
        ModelSerializer.restore(path, device="cpu")


def test_input_width_is_checked(jax_zip):
    net = ModelSerializer.restore(jax_zip, device="cpu")
    with pytest.raises(ValueError, match="feature size"):
        net.output(np.zeros((2, SEQ, VOCAB + 1), np.float32))
    with pytest.raises(ValueError, match="3-D"):
        net.output(np.zeros((2, VOCAB), np.float32))
