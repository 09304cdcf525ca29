"""Model zoo of the port, as in `deeplearning4j_tpu/models/zoo.py`: LeNet-MNIST
(BASELINE config 1), the MNIST MLP, the char-RNN (BASELINE config 3, the
reference's GravesLSTMCharModellingExample topology) and its sampling loop,
VGG-16 / VGG-19, AlexNet, and the ComputationGraphs ResNet-50 (BASELINE
config 2) and GoogLeNet. Each builder returns the model uninitialized, on
the GPU unless `device` says otherwise.

The `bench_*` functions are the measured forms of BASELINE configs 1-3,
with the JAX package's defaults, data (`np.random.default_rng(0)`) and
return values (the value and its label, or a dict with JAX's keys). They
measure wall time as JAX's do; each timed window ends with
`float(model.score())`, a host read that waits for the window's work on
the card. They run on the card unless `device` says otherwise.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..nn.conf import BackpropType, InputType, NeuralNetConfiguration
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         ConvolutionLayer, ConvolutionMode, DenseLayer,
                         GlobalPoolingLayer, GravesLSTM,
                         LocalResponseNormalization, OutputLayer,
                         PoolingType, RnnOutputLayer, SubsamplingLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..nn.updaters import Adam, Nesterovs
from ..util.platform import DeviceLike

__all__ = ["lenet_mnist", "bench_lenet", "bench_lenet_dispatch",
           "bench_lenet_ragged", "bench_lenet_superstep", "mlp_mnist",
           "char_rnn", "bench_char_rnn", "bench_char_rnn_dispatch",
           "resnet50", "bench_resnet50", "vgg16", "vgg19", "alexnet",
           "googlenet", "sample_characters"]


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


def resnet50(n_classes: int = 1000, image: int = 224, seed: int = 42,
             updater=None, blocks=(3, 4, 6, 3), width: int = 64,
             compute_dtype: Optional[str] = "bfloat16",
             remat: Optional[str] = None,
             activation_store_dtype: Optional[str] = None,
             device: DeviceLike = None):
    """ResNet-50 as a ComputationGraph: a 7x7 stride-2 stem with BN+ReLU
    and a 3x3 max pool, then four stages of bottleneck blocks (1x1, 3x3,
    1x1 convs, each with BatchNormalization; a projection shortcut on each
    stage's first block), each block closed by an add ElementWiseVertex
    and a ReLU; global average pool and softmax. NHWC, Adam 1e-3, bf16
    compute over float32 masters by default."""
    from ..nn.conf.graph import ElementWiseVertex
    from ..nn.graph import ComputationGraph

    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Adam(1e-3))
         .weight_init("relu")
         .compute_dtype(compute_dtype)
         .remat(remat)
         .activation_store_dtype(activation_store_dtype)
         .graph_builder()
         .add_inputs("input")
         .set_input_types(InputType.convolutional(image, image, 3)))

    def conv_bn_relu(name, inp, n_out, k, s, relu=True):
        b.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                     stride=(s, s), activation="identity",
                                     convolution_mode=ConvolutionMode.SAME,
                                     has_bias=False), inp)
        b.add_layer(f"{name}_bn",
                    BatchNormalization(
                        activation="relu" if relu else "identity"),
                    f"{name}_conv")
        return f"{name}_bn"

    top = conv_bn_relu("stem", "input", width, 7, 2)
    b.add_layer("stem_pool",
                SubsamplingLayer(pooling_type=PoolingType.MAX,
                                 kernel_size=(3, 3), stride=(2, 2),
                                 convolution_mode=ConvolutionMode.SAME),
                top)
    top = "stem_pool"
    ch = width
    for stage, n_blocks in enumerate(blocks):
        out_ch = ch * 4
        for blk in range(n_blocks):
            name = f"s{stage}b{blk}"
            stride = 2 if (blk == 0 and stage > 0) else 1
            t1 = conv_bn_relu(f"{name}_1", top, ch, 1, stride)
            t2 = conv_bn_relu(f"{name}_2", t1, ch, 3, 1)
            t3 = conv_bn_relu(f"{name}_3", t2, out_ch, 1, 1, relu=False)
            if blk == 0:
                sc = conv_bn_relu(f"{name}_sc", top, out_ch, 1, stride,
                                  relu=False)
            else:
                sc = top
            b.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), t3, sc)
            b.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                        f"{name}_add")
            top = f"{name}_relu"
        ch *= 2
    b.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                top)
    b.add_layer("fc", OutputLayer(n_out=n_classes, activation="softmax",
                                  loss="mcxent"), "avgpool")
    b.set_outputs("fc")
    return ComputationGraph(b.build(), device=device)


def googlenet(n_classes: int = 1000, image: int = 224, seed: int = 42,
              updater=None, device: DeviceLike = None):
    """GoogLeNet (Inception-v1) as a ComputationGraph: a conv / pool stem,
    nine inception modules (1x1, 3x3 and 5x5 branches behind 1x1
    reductions, and a pooled 1x1 projection, joined by a MergeVertex), max
    pools between the stages, global average pool and a softmax head with
    input dropout 0.6."""
    from ..nn.conf.graph import MergeVertex
    from ..nn.graph import ComputationGraph

    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Adam(1e-3))
         .weight_init("relu")
         .graph_builder()
         .add_inputs("input")
         .set_input_types(InputType.convolutional(image, image, 3)))

    def conv(name, inp, n_out, k, s=1):
        b.add_layer(name, ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=(s, s),
            activation="relu", convolution_mode=ConvolutionMode.SAME), inp)
        return name

    def pool(name, inp, k=3, s=2):
        b.add_layer(name, SubsamplingLayer(
            pooling_type=PoolingType.MAX, kernel_size=(k, k), stride=(s, s),
            convolution_mode=ConvolutionMode.SAME), inp)
        return name

    def inception(name, inp, c1, c3r, c3, c5r, c5, pp):
        b1 = conv(f"{name}_1x1", inp, c1, 1)
        b3 = conv(f"{name}_3x3", conv(f"{name}_3x3r", inp, c3r, 1), c3, 3)
        b5 = conv(f"{name}_5x5", conv(f"{name}_5x5r", inp, c5r, 1), c5, 5)
        bp = conv(f"{name}_poolproj",
                  pool(f"{name}_pool", inp, 3, 1), pp, 1)
        b.add_vertex(f"{name}_concat", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_concat"

    top = conv("stem1", "input", 64, 7, 2)
    top = pool("stem1_pool", top)
    top = conv("stem2a", top, 64, 1)
    top = conv("stem2b", top, 192, 3)
    top = pool("stem2_pool", top)
    top = inception("i3a", top, 64, 96, 128, 16, 32, 32)
    top = inception("i3b", top, 128, 128, 192, 32, 96, 64)
    top = pool("pool3", top)
    top = inception("i4a", top, 192, 96, 208, 16, 48, 64)
    top = inception("i4b", top, 160, 112, 224, 24, 64, 64)
    top = inception("i4c", top, 128, 128, 256, 24, 64, 64)
    top = inception("i4d", top, 112, 144, 288, 32, 64, 64)
    top = inception("i4e", top, 256, 160, 320, 32, 128, 128)
    top = pool("pool4", top)
    top = inception("i5a", top, 256, 160, 320, 32, 128, 128)
    top = inception("i5b", top, 384, 192, 384, 48, 128, 128)
    b.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                top)
    b.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent", dropout=0.6), "gap")
    return ComputationGraph(b.set_outputs("out").build(), device=device)


# ---------------------------------------------------------------------------
# benches (BASELINE configs 1-3)
# ---------------------------------------------------------------------------

def _steps_window(model, a, steps: int):
    """[steps, *a.shape]: one batch put on the model's device and broadcast
    across the steps (a view, no copy), as JAX's `jnp.broadcast_to` of one
    `device_put`."""
    import torch
    t = torch.as_tensor(a, device=model.device)
    return t.expand((steps,) + tuple(t.shape))


def _timed_scan(model, xs, ys) -> float:
    """Seconds of one `fit_scan_arrays` window after a warm-up window of
    the same length (on the card, the warm-up captures the step)."""
    model.fit_scan_arrays(xs, ys)
    float(model.score())
    t0 = time.perf_counter()
    model.fit_scan_arrays(xs, ys)
    float(model.score())
    return time.perf_counter() - t0


def _timed_fits(model, ds, steps: int, warmup: int) -> float:
    """Seconds of `steps` per-batch `fit(ds)` calls after `warmup` of
    them."""
    for _ in range(warmup):
        model.fit(ds)
    float(model.score())
    t0 = time.perf_counter()
    for _ in range(steps):
        model.fit(ds)
    float(model.score())
    return time.perf_counter() - t0


def _char_batch(batch: int, seq_len: int, vocab: int):
    r = np.random.default_rng(0)
    idx = r.integers(0, vocab, (batch, seq_len))
    x = np.eye(vocab, dtype=np.float32)[idx]
    y = np.eye(vocab, dtype=np.float32)[np.roll(idx, -1, axis=1)]
    return x, y


def _lenet_batch(batch: int):
    r = np.random.default_rng(0)
    x = r.normal(size=(batch, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, batch)]
    return x, y


def bench_char_rnn(batch: int = 64, seq_len: int = 128, steps: int = 240,
                   warmup: int = 3, vocab: int = 77,
                   device: DeviceLike = None):
    """tokens/s of char-RNN training (BASELINE config 3: batch 64, sequence
    128, TBPTT 64): `steps` series as one `fit_scan_arrays` window (on the
    card, replays of the captured TBPTT chunk step, two chunks a series)
    over one batch broadcast across the steps; the warm-up is one window of
    the same length. Returns (tokens/s, "charRNN-tokens")."""
    model = char_rnn(vocab_size=vocab, seq_len=seq_len, tbptt=64,
                     device=device).init()
    x, y = _char_batch(batch, seq_len, vocab)
    dt = _timed_scan(model, _steps_window(model, x, steps),
                     _steps_window(model, y, steps))
    return batch * seq_len * steps / dt, "charRNN-tokens"


def bench_resnet50(batch: int = 256, steps: int = 30, image: int = 224,
                   n_classes: int = 1000,
                   compute_dtype: Optional[str] = "bfloat16",
                   device: DeviceLike = None):
    """samples/s of ResNet-50 ImageNet-shaped training (BASELINE config 2):
    bf16 compute, Adam(1e-3) with bf16 moments, the `steps` window as one
    `fit_scan_arrays` call (on the card, replays of the captured step)
    after a warm-up window of the same length. The input window holds the
    batch rounded to the compute dtype, as JAX's; the graph takes its
    inputs in float32 (exact for bf16 values) and casts them to the compute
    dtype at entry, so the window is held on the device as steps x the
    float32 batch. Returns (samples/s, "ResNet50-ImageNet")."""
    import torch

    model = resnet50(image=image, n_classes=n_classes,
                     compute_dtype=compute_dtype,
                     updater=Adam(1e-3, state_dtype="bfloat16"),
                     device=device).init()
    r = np.random.default_rng(0)
    x = r.normal(size=(batch, image, image, 3)).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[r.integers(0, n_classes, batch)]
    xt = torch.as_tensor(x, device=model.device)
    if compute_dtype is not None:
        xt = xt.to(getattr(torch, compute_dtype))
    dt = _timed_scan(model, xt.expand((steps,) + tuple(xt.shape)),
                     _steps_window(model, y, steps))
    return batch * steps / dt, "ResNet50-ImageNet"


def bench_lenet(batch: int = 512, steps: int = 800, warmup: int = 5,
                device: DeviceLike = None):
    """samples/s of LeNet-MNIST training (BASELINE config 1): `steps`
    steps as one `fit_scan_arrays` window over one batch broadcast across
    the steps, after a warm-up window of the same length. Returns
    (samples/s, "LeNet-MNIST")."""
    model = lenet_mnist(device=device).init()
    x, y = _lenet_batch(batch)
    dt = _timed_scan(model, _steps_window(model, x, steps),
                     _steps_window(model, y, steps))
    return batch * steps / dt, "LeNet-MNIST"


def bench_lenet_dispatch(batch: int = 512, steps: int = 300,
                         warmup: int = 20, device: DeviceLike = None):
    """samples/s of LeNet through the per-batch `fit(DataSet)` path (one
    step launched from the host a batch: the reference's usage), beside
    `bench_lenet`'s window. Returns (samples/s, "LeNet-MNIST-dispatch")."""
    from ..datasets.iterators import DataSet

    model = lenet_mnist(device=device).init()
    dt = _timed_fits(model, DataSet(*_lenet_batch(batch)), steps, warmup)
    return batch * steps / dt, "LeNet-MNIST-dispatch"


def bench_char_rnn_dispatch(batch: int = 64, seq_len: int = 128,
                            steps: int = 150, warmup: int = 10,
                            vocab: int = 77, device: DeviceLike = None):
    """tokens/s of the char-RNN through the per-batch `fit(DataSet)` path
    (TBPTT chunking included), beside `bench_char_rnn`'s window. Returns
    (tokens/s, "charRNN-tokens-dispatch")."""
    from ..datasets.iterators import DataSet

    model = char_rnn(vocab_size=vocab, seq_len=seq_len, tbptt=64,
                     device=device).init()
    dt = _timed_fits(model, DataSet(*_char_batch(batch, seq_len, vocab)),
                     steps, warmup)
    return batch * seq_len * steps / dt, "charRNN-tokens-dispatch"


def bench_lenet_ragged(batch: int = 256, full_batches: int = 5,
                       ragged: int = 255, epochs: int = 4, warmup: int = 1,
                       device: DeviceLike = None):
    """A ragged final batch through LeNet's per-batch `fit()`, three ways:

      serial           the plain iterator: the ragged tail is a second
                       batch signature (a second step capture on the card)
      padded           fit(pad_ragged=True): weight-zero padding, one
                       signature, pad_fraction reported
      padded_prefetch  + fit(prefetch=True): batches staged one ahead on a
                       background thread

    Each variant runs under its own telemetry session on a fresh model, so
    compile (capture) counts attribute cleanly; the warm-up epochs are not
    timed; three rounds alternate the variants; samples/s counts real rows
    only. Returns JAX's dict: per variant samples_per_s, steps_per_s, its
    spread, train_step_compiles (and pipeline), then
    prefetch_vs_serial_paired_ratio and prefetch_ge_serial."""
    from ..datasets.iterators import ArrayDataSetIterator
    from ..telemetry import runtime as telemetry_runtime
    from ..telemetry.runtime import TelemetrySession

    n = batch * full_batches + ragged
    r = np.random.default_rng(0)
    x = r.normal(size=(n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]
    variants = (("serial", {}),
                ("padded", dict(pad_ragged=True)),
                ("padded_prefetch", dict(pad_ragged=True, prefetch=True)))
    state = {}
    for name, kw in variants:
        sess = TelemetrySession()
        model = lenet_mnist(device=device).init()
        it = ArrayDataSetIterator(x, y, batch_size=batch)
        with telemetry_runtime.enabled(sess):
            model.fit(it, epochs=warmup, **kw)
            float(model.score())
        state[name] = (sess, model, it, kw, [])
    rounds = []
    for _ in range(3):
        times = {}
        for name, kw in variants:
            sess, model, it, kw, reps = state[name]
            with telemetry_runtime.enabled(sess):
                t0 = time.perf_counter()
                model.fit(it, epochs=epochs, **kw)
                float(model.score())
                times[name] = time.perf_counter() - t0
                reps.append(times[name])
        rounds.append(times)
    out = {}
    steps = (full_batches + 1) * epochs
    for name, _ in variants:
        sess, model, it, kw, reps = state[name]
        reps.sort()
        dt = reps[len(reps) // 2]
        rec = {"samples_per_s": round(n * epochs / dt, 1),
               "steps_per_s": round(steps / dt, 2),
               "steps_per_s-spread": [round(steps / reps[-1], 2),
                                      round(steps / reps[0], 2)],
               "train_step_compiles": sess.compiles.count("nn/train_step")}
        pipe = sess.pipeline_summary()
        if pipe:
            rec["pipeline"] = pipe
        out[name] = rec
    ratios = sorted(r["serial"] / r["padded_prefetch"] for r in rounds)
    out["prefetch_vs_serial_paired_ratio"] = round(
        ratios[len(ratios) // 2], 4)
    out["prefetch_ge_serial"] = ratios[len(ratios) // 2] >= 1.0
    return out


def _paired_superstep(model_fn, x, y, batch, epochs, warmup, superstep):
    """Alternating paired rounds of fit(superstep=K) against
    fit(superstep=1): the same `fit(iterator)` call, only the knob differs,
    so the paired ratio isolates the host launch path that a window of
    replayed steps removes. Each variant has its own telemetry session and
    fresh model."""
    from ..datasets.iterators import ArrayDataSetIterator
    from ..nn.superstep import auto_superstep_k
    from ..telemetry import runtime as telemetry_runtime
    from ..telemetry.runtime import TelemetrySession

    n = x.shape[0]
    variants = (("perbatch", 1), ("superstep", superstep))
    state = {}
    for name, k in variants:
        sess = TelemetrySession()
        model = model_fn()
        it = ArrayDataSetIterator(x, y, batch_size=batch)
        with telemetry_runtime.enabled(sess):
            model.fit(it, epochs=warmup, superstep=k)
            float(model.score())
        state[name] = (sess, model, it, k, [], [])
    rounds = []
    for _ in range(3):
        times = {}
        for name, _k in variants:
            sess, model, it, k, reps, disp = state[name]
            with telemetry_runtime.enabled(sess):
                d0 = sess.span_totals().get("device/dispatch", 0.0)
                t0 = time.perf_counter()
                model.fit(it, epochs=epochs, superstep=k)
                float(model.score())
                dt = time.perf_counter() - t0
                disp.append(sess.span_totals().get("device/dispatch", 0.0)
                            - d0)
            times[name] = dt
            reps.append(dt)
        rounds.append(times)
    out = {}
    for name, _k in variants:
        sess, model, it, k, reps, disp = state[name]
        order = sorted(range(len(reps)), key=lambda i: reps[i])
        mid = order[len(order) // 2]
        dt = reps[mid]
        out[name] = {
            "samples_per_s": round(n * epochs / dt, 1),
            "samples_per_s-spread": [round(n * epochs / max(reps), 1),
                                     round(n * epochs / min(reps), 1)],
            # host seconds inside the dispatch spans over the wall
            "dispatch_share": round(disp[mid] / dt, 4),
            "superstep_compiles": sess.compiles.count("nn/superstep"),
            "train_step_compiles": sess.compiles.count("nn/train_step"),
        }
    out["superstep_k"] = (auto_superstep_k(x[:batch].nbytes + y[:batch].nbytes)
                          if superstep == "auto" else superstep)
    ratios = sorted(r["perbatch"] / r["superstep"] for r in rounds)
    out["superstep_vs_perbatch_paired_ratio"] = round(
        ratios[len(ratios) // 2], 4)
    out["paired_ratios"] = [round(v, 4) for v in ratios]
    return out


def bench_lenet_superstep(batch: int = 512, n_batches: int = 24,
                          epochs: int = 3, warmup: int = 1,
                          superstep="auto", device: DeviceLike = None):
    """LeNet's per-batch `fit()` through windows of replayed steps
    (`superstep`) against K = 1, in alternating paired rounds, plus a
    launch-bound mlp128 (64 -> 128 -> 10, batch 64) pairing. Returns JAX's
    dict (`_paired_superstep`'s keys, the mlp128 pairing under
    "mlp128")."""
    r = np.random.default_rng(0)
    n = batch * n_batches
    x = r.normal(size=(n, 784)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]
    out = _paired_superstep(lambda: lenet_mnist(device=device).init(), x, y,
                            batch, epochs, warmup, superstep)

    def mlp128():
        conf = (NeuralNetConfiguration.builder()
                .seed(7).updater(Adam(1e-3)).list()
                .layer(DenseLayer(n_out=128, activation="relu"))
                .layer(OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(64))
                .build())
        return MultiLayerNetwork(conf, device=device).init()

    b2 = 64
    x2 = r.normal(size=(b2 * 64, 64)).astype(np.float32)
    y2 = np.eye(10, dtype=np.float32)[r.integers(0, 10, b2 * 64)]
    out["mlp128"] = _paired_superstep(mlp128, x2, y2, b2, epochs, warmup,
                                      superstep)
    return out
