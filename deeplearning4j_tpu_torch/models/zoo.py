"""Model zoo of the port, as in `deeplearning4j_tpu/models/zoo.py`: LeNet-MNIST
(BASELINE config 1), the MNIST MLP, the char-RNN (BASELINE config 3, the
reference's GravesLSTMCharModellingExample topology) and its sampling loop,
VGG-16 / VGG-19 and AlexNet. Each builder returns the network uninitialized,
on the GPU unless `device` says otherwise.
"""
from __future__ import annotations

import numpy as np

from ..nn.conf import BackpropType, InputType, NeuralNetConfiguration
from ..nn.layers import (ConvolutionLayer, ConvolutionMode, DenseLayer,
                         GravesLSTM, LocalResponseNormalization, OutputLayer,
                         PoolingType, RnnOutputLayer, SubsamplingLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam, Nesterovs
from ..util.platform import DeviceLike

__all__ = ["lenet_mnist", "char_rnn", "mlp_mnist", "vgg16", "vgg19",
           "alexnet", "sample_characters"]


def lenet_mnist(seed: int = 42, updater=None,
                device: DeviceLike = None) -> MultiLayerNetwork:
    """Conv 5x5x20 -> maxpool 2 -> Conv 5x5x50 -> maxpool 2 -> Dense 500 ->
    softmax 10 on 28 x 28 x 1 flat input, Nesterovs 0.01 / 0.9, l2 5e-4."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Nesterovs(learning_rate=0.01, momentum=0.9))
            .l2(5e-4)
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity",
                                    convolution_mode=ConvolutionMode.TRUNCATE))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
    return MultiLayerNetwork(conf, device=device)


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


def _vgg(cfg, n_classes, image, seed, updater, device) -> MultiLayerNetwork:
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Nesterovs(learning_rate=0.01, momentum=0.9))
         .weight_init("relu")
         .list())
    for v in cfg:
        if v == "M":
            b.layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                     kernel_size=(2, 2), stride=(2, 2)))
        else:
            b.layer(ConvolutionLayer(n_out=v, kernel_size=(3, 3),
                                     stride=(1, 1), activation="relu",
                                     convolution_mode=ConvolutionMode.SAME))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(DenseLayer(n_out=4096, activation="relu"))
    b.layer(OutputLayer(n_out=n_classes, activation="softmax", loss="mcxent"))
    conf = b.set_input_type(InputType.convolutional(image, image, 3)).build()
    return MultiLayerNetwork(conf, device=device)


def vgg16(n_classes: int = 1000, image: int = 224, seed: int = 42,
          updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """VGG-16: 13 SAME 3x3 convs in five blocks, each closed by a 2x2 max
    pool, then Dense 4096 x 2 and softmax (138,357,544 parameters at 224 and
    1000 classes)."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    return _vgg(cfg, n_classes, image, seed, updater, device)


def vgg19(n_classes: int = 1000, image: int = 224, seed: int = 42,
          updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """VGG-19: VGG-16 with a fourth conv in blocks 3-5."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    return _vgg(cfg, n_classes, image, seed, updater, device)


def alexnet(n_classes: int = 1000, image: int = 224, seed: int = 42,
            updater=None, device: DeviceLike = None) -> MultiLayerNetwork:
    """AlexNet, single tower, NHWC: SAME convs (the first 11x11 stride 4),
    LRN after the first two conv blocks, 3x3 stride-2 max pools, Dense 4096
    x 2 with dropout 0.5 (62,378,344 parameters at 224 and 1000 classes)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Nesterovs(learning_rate=0.01, momentum=0.9))
         .weight_init("relu")
         .list()
         .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                 stride=(4, 4), activation="relu",
                                 convolution_mode=ConvolutionMode.SAME))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                 kernel_size=(3, 3), stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                 stride=(1, 1), activation="relu",
                                 convolution_mode=ConvolutionMode.SAME))
         .layer(LocalResponseNormalization())
         .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                 kernel_size=(3, 3), stride=(2, 2)))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 stride=(1, 1), activation="relu",
                                 convolution_mode=ConvolutionMode.SAME))
         .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                 stride=(1, 1), activation="relu",
                                 convolution_mode=ConvolutionMode.SAME))
         .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                 stride=(1, 1), activation="relu",
                                 convolution_mode=ConvolutionMode.SAME))
         .layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                 kernel_size=(3, 3), stride=(2, 2)))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
         .layer(OutputLayer(n_out=n_classes, activation="softmax",
                            loss="mcxent")))
    conf = b.set_input_type(InputType.convolutional(image, image, 3)).build()
    return MultiLayerNetwork(conf, device=device)
