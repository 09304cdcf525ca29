"""Model zoo of the port: the char-RNN (BASELINE config 3, the reference's
GravesLSTMCharModellingExample topology) and its sampling loop, and the MNIST
MLP, as in `deeplearning4j_tpu/models/zoo.py`.
"""
from __future__ import annotations

import numpy as np

from ..nn.conf import BackpropType, InputType, NeuralNetConfiguration
from ..nn.layers import DenseLayer, GravesLSTM, OutputLayer, RnnOutputLayer
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam
from ..util.platform import DeviceLike

__all__ = ["char_rnn", "mlp_mnist", "sample_characters"]


def mlp_mnist(seed: int = 42, device: DeviceLike = None) -> MultiLayerNetwork:
    """784 -> Dense(1024, relu) -> Dense(1024, relu) -> softmax 10, Adam
    1e-3. Returns the network uninitialized, as JAX does."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(1e-3))
            .list()
            .layer(DenseLayer(n_out=1024, activation="relu"))
            .layer(DenseLayer(n_out=1024, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(784))
            .build())
    return MultiLayerNetwork(conf, device=device)


def char_rnn(vocab_size: int = 77, lstm_size: int = 200, seq_len: int = 64,
             seed: int = 42, tbptt: int = 50,
             device: DeviceLike = None) -> MultiLayerNetwork:
    """2 x GravesLSTM + softmax RnnOutputLayer, TBPTT settings kept as
    configuration data. Returns the network uninitialized, as JAX does."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(Adam(2e-3))
            .list()
            .layer(GravesLSTM(n_out=lstm_size, activation="tanh"))
            .layer(GravesLSTM(n_out=lstm_size, activation="tanh"))
            .layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(vocab_size, seq_len))
            .backprop_type(BackpropType.TRUNCATED_BPTT)
            .t_bptt_forward_length(tbptt)
            .t_bptt_backward_length(tbptt)
            .build())
    return MultiLayerNetwork(conf, device=device)


def sample_characters(net, char_to_idx: dict, seed_text: str, n_chars: int,
                      temperature: float = 1.0, rng_seed: int = 0):
    """Generate text with a char-RNN through stateful rnn_time_step."""
    if not seed_text:
        raise ValueError("seed_text must contain at least one character")
    idx_to_char = {i: c for c, i in char_to_idx.items()}
    vocab = len(char_to_idx)
    net.rnn_clear_previous_state()
    out = None
    for ch in seed_text:
        x = np.zeros((1, vocab), np.float32)
        x[0, char_to_idx[ch]] = 1.0
        out = net.rnn_time_step(x)
    rng = np.random.default_rng(rng_seed)
    generated = []
    for _ in range(n_chars):
        p = out.detach().cpu().numpy().astype(np.float64).reshape(-1)
        if temperature != 1.0:
            logp = np.log(np.maximum(p, 1e-12)) / temperature
            p = np.exp(logp - logp.max())
        p = p / p.sum()
        nxt = int(rng.choice(vocab, p=p))
        generated.append(idx_to_char[nxt])
        x = np.zeros((1, vocab), np.float32)
        x[0, nxt] = 1.0
        out = net.rnn_time_step(x)
    net.rnn_clear_previous_state()
    return "".join(generated)
