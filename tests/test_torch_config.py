"""PyTorch port, configuration: the port reads and writes the JAX package's
`configuration.json` identically; unknown names raise named errors; and the
port imports neither JAX nor the JAX package."""
import ast
import json
import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu.models.zoo import char_rnn as jax_char_rnn
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.layers import (DenseLayer as JaxDense,
                                          OutputLayer as JaxOutput)
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.updaters import Nesterovs as JaxNesterovs
from deeplearning4j_tpu_torch import (DenseLayer, InputType,
                                      MultiLayerConfiguration,
                                      MultiLayerNetwork, Nesterovs,
                                      NeuralNetConfiguration, OutputLayer,
                                      char_rnn)
from deeplearning4j_tpu_torch.nn import activations
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deeplearning4j_tpu_torch")


def _mlp_json(builder, dense, output, input_type, nesterovs):
    return (builder().seed(7).updater(nesterovs(0.01, 0.9)).l2(1e-4)
            .weight_init("relu").list()
            .layer(dense(n_out=16, activation="relu"))
            .layer(output(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.feed_forward(6)).build().to_json())


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 11, "lstm_size": 8,
                                     "seq_len": 5}])
def test_char_rnn_json_parses_and_reemits_equal(kw):
    jax_json = jax_char_rnn(**kw).conf.to_json()
    port = MultiLayerConfiguration.from_json(jax_json)
    assert json.loads(port.to_json()) == json.loads(jax_json)


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 11, "lstm_size": 8,
                                     "seq_len": 5}])
def test_port_builder_writes_the_jax_json(kw):
    port_json = char_rnn(device="cpu", **kw).conf.to_json()
    assert json.loads(port_json) == json.loads(jax_char_rnn(**kw).conf.to_json())


def test_mlp_builder_json_matches_jax():
    jax_json = _mlp_json(JaxNNC.builder, JaxDense, JaxOutput, JaxInputType,
                         JaxNesterovs)
    port_json = _mlp_json(NeuralNetConfiguration.builder, DenseLayer,
                          OutputLayer, InputType, Nesterovs)
    assert json.loads(port_json) == json.loads(jax_json)


def test_unknown_layer_type_raises_named_error():
    d = json.loads(jax_char_rnn(vocab_size=11, lstm_size=8,
                                seq_len=5).conf.to_json())
    d["layers"][0]["__layer__"]["type"] = "NoSuchLayer"
    with pytest.raises(ValueError, match="Unknown layer type 'NoSuchLayer'"):
        MultiLayerConfiguration.from_json(json.dumps(d))


def test_unknown_activation_raises_named_error():
    with pytest.raises(ValueError, match="Unknown activation 'swishy'"):
        activations.get("swishy")
    conf = (NeuralNetConfiguration.builder().list()
            .layer(DenseLayer(n_out=4, activation="swishy"))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(3)).build())
    with pytest.raises(ValueError, match="Unknown activation"):
        MultiLayerNetwork(conf, device="cpu").init()


def test_unknown_updater_raises_named_error():
    with pytest.raises(ValueError, match="Unknown updater 'nadamax'"):
        NeuralNetConfiguration.builder().updater("nadamax")


@pytest.mark.parametrize("layer,input_type", [
    ("GravesLSTM", ("feed_forward", 3)),
    ("GravesLSTM", ("convolutional_flat", 2, 2, 1)),
    ("ConvolutionLayer", ("feed_forward", 4)),
    ("ConvolutionLayer", ("recurrent", 4, 3))])
def test_preprocessor_configs_raise_named_error(layer, input_type):
    """Where JAX's builder cannot infer an input preprocessor (a recurrent
    layer after feed-forward input needs static timesteps, a convolution
    after feed-forward or recurrent input needs spatial dims), the port
    raises the same ValueError with the same words."""
    import deeplearning4j_tpu.nn.layers as jax_layers
    import deeplearning4j_tpu_torch.nn.layers as port_layers
    kind, *dims = input_type

    def build(nnc, layers, it_cls):
        return (nnc.builder().list()
                .layer(getattr(layers, layer)(n_out=4))
                .set_input_type(getattr(it_cls, kind)(*dims)).build())
    with pytest.raises(ValueError) as jerr:
        build(JaxNNC, jax_layers, JaxInputType)
    with pytest.raises(ValueError) as err:
        build(NeuralNetConfiguration, port_layers, InputType)
    assert str(err.value) == str(jerr.value)


def test_default_device_is_the_gpu(monkeypatch):
    """Entry points never move to the CPU on their own: without a GPU and
    without device="cpu" they raise."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        char_rnn()
    assert char_rnn(device="cpu").device.type == "cpu"


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_no_jax_by_ast():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "deeplearning4j_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, deeplearning4j_tpu_torch, "
            "deeplearning4j_tpu_torch.kernels.lstm, "
            "deeplearning4j_tpu_torch.kernels.attention; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
