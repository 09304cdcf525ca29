"""Keras -> deeplearning4j_tpu_torch model import (the port of
`deeplearning4j_tpu/modelimport/keras.py`).

The reference's 14 layer mappers (`modelimport/keras/layers/Keras{Dense,
Convolution,Pooling,Lstm,Embedding,BatchNormalization,Merge,Activation,
Dropout,Flatten,GlobalPooling,Input,Loss,ZeroPadding}.java`), the Sequential
import (-> MultiLayerNetwork) and the functional import (-> ComputationGraph)
for Keras 2/3 HDF5 whole-model files in `channels_last` layout, which is the
port's NHWC / HWIO layout, so weights load as they are. A Keras LSTM maps to
a GravesLSTM with zero peepholes, its gates reordered from Keras's
(i, f, c, o) to (i, f, o, g), so it runs the LSTM sequence kernels on the
card. The imported model lives on `device` (the GPU unless the caller passes
`device="cpu"`); its parameters are the file's values in the layer's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .hdf5 import Hdf5Archive
from ..nn.conf import InputType, NeuralNetConfiguration
from ..nn.conf.graph import ElementWiseVertex, MergeVertex
from ..nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from ..nn.graph import ComputationGraph
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         Convolution1DLayer, ConvolutionLayer,
                         ConvolutionMode, DenseLayer, DropoutLayer,
                         EmbeddingLayer, GlobalPoolingLayer, GravesLSTM,
                         LastTimeStep, OutputLayer, PoolingType,
                         Subsampling1DLayer, SubsamplingLayer,
                         ZeroPaddingLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..util.platform import DeviceLike

__all__ = [
    "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
    "import_keras_model_configuration",
    "import_keras_sequential_configuration",
]


class KerasImportError(Exception):
    """Parity with InvalidKerasConfigurationException /
    UnsupportedKerasConfigurationException."""


_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "elu": "elu", "selu": "selu",
    "gelu": "gelu", "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "silu": "swish",
    "mish": "mish", "leaky_relu": "leakyrelu",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "poisson": "poisson", "kullback_leibler_divergence": "kl_divergence",
    "kl_divergence": "kl_divergence", "cosine_proximity": "cosine_proximity",
}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras activation '{name}'")


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _conv_mode(padding: str) -> str:
    if padding == "same":
        return ConvolutionMode.SAME
    if padding == "valid":
        return ConvolutionMode.TRUNCATE
    raise KerasImportError(f"Unsupported Keras padding '{padding}'")


def _check_channels_last(cfg: Dict, name: str):
    df = cfg.get("data_format", "channels_last")
    if df != "channels_last":
        raise KerasImportError(
            f"Layer '{name}': data_format='{df}' unsupported — export the "
            "Keras model with channels_last (TF dim ordering)")


def _input_type_from_shape(shape) -> InputType:
    dims = [d for d in shape if d is not None]
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        # [T, F] sequence input
        t = shape[-2]
        return InputType.recurrent(dims[-1], t)
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(h, w, c)
    raise KerasImportError(f"Unsupported input shape {shape}")


# ---------------------------------------------------------------------------
# per-layer config mappers (KerasLayer.java getLayer equivalents)
# ---------------------------------------------------------------------------

def _map_dense(cfg, is_output, loss):
    act = _act(cfg.get("activation"))
    if is_output:
        if loss is None:
            loss = "mcxent" if act == "softmax" else "mse"
        return OutputLayer(n_out=int(cfg["units"]), activation=act, loss=loss,
                           has_bias=bool(cfg.get("use_bias", True)))
    return DenseLayer(n_out=int(cfg["units"]), activation=act,
                      has_bias=bool(cfg.get("use_bias", True)))


def _map_conv2d(cfg, name):
    _check_channels_last(cfg, name)
    kh, kw = _pair(cfg["kernel_size"])
    sh, sw = _pair(cfg.get("strides", (1, 1)))
    dh, dw = _pair(cfg.get("dilation_rate", (1, 1)))
    return ConvolutionLayer(
        n_out=int(cfg["filters"]), kernel_size=(kh, kw), stride=(sh, sw),
        dilation=(dh, dw), convolution_mode=_conv_mode(cfg.get("padding",
                                                               "valid")),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))


def _map_conv1d(cfg, name):
    return Convolution1DLayer(
        n_out=int(cfg["filters"]), kernel_size=int(cfg["kernel_size"][0]
        if isinstance(cfg["kernel_size"], (list, tuple))
        else cfg["kernel_size"]),
        stride=int(cfg.get("strides", [1])[0]
                   if isinstance(cfg.get("strides", 1), (list, tuple))
                   else cfg.get("strides", 1)),
        convolution_mode=_conv_mode(cfg.get("padding", "valid")),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))


def _map_pool2d(cfg, name, ptype):
    _check_channels_last(cfg, name)
    kh, kw = _pair(cfg.get("pool_size", (2, 2)))
    strides = cfg.get("strides") or (kh, kw)
    sh, sw = _pair(strides)
    return SubsamplingLayer(pooling_type=ptype, kernel_size=(kh, kw),
                            stride=(sh, sw),
                            convolution_mode=_conv_mode(cfg.get("padding",
                                                                "valid")))


def _map_pool1d(cfg, ptype):
    k = cfg.get("pool_size", 2)
    k = int(k[0]) if isinstance(k, (list, tuple)) else int(k)
    s = cfg.get("strides") or k
    s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
    return Subsampling1DLayer(pooling_type=ptype, kernel_size=k, stride=s,
                              convolution_mode=_conv_mode(cfg.get("padding",
                                                                  "valid")))


def _map_batchnorm(cfg, name):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0]
    # channels_last: feature axis must be the last one
    if axis not in (-1, 3, 1):
        raise KerasImportError(
            f"Layer '{name}': BatchNormalization axis={axis} unsupported "
            "(channels_last/last-axis only)")
    return BatchNormalization(decay=float(cfg.get("momentum", 0.99)),
                              eps=float(cfg.get("epsilon", 1e-3)))


def _map_lstm(cfg):
    return (GravesLSTM(n_out=int(cfg["units"]),
                       activation=_act(cfg.get("activation", "tanh")),
                       gate_activation=_act(cfg.get("recurrent_activation",
                                                    "sigmoid")),
                       forget_gate_bias_init=0.0),
            bool(cfg.get("return_sequences", False)))


def _map_zeropad2d(cfg, name):
    _check_channels_last(cfg, name)
    p = cfg.get("padding", (1, 1))
    if isinstance(p, (list, tuple)) and len(p) == 2 \
            and isinstance(p[0], (list, tuple)):
        (t, b), (l, r) = p
        return ZeroPaddingLayer(pad=(int(t), int(b), int(l), int(r)))
    ph, pw = _pair(p)
    return ZeroPaddingLayer(pad=(ph, pw))


# ---------------------------------------------------------------------------
# weight conversion (KerasLayer.java setWeights equivalents)
# ---------------------------------------------------------------------------

def _lstm_reorder(k: np.ndarray, units: int) -> np.ndarray:
    """Keras gate order (i, f, c, o) -> ours (i, f, o, g=c), last axis."""
    i, f, c, o = np.split(k, 4, axis=-1)
    return np.concatenate([i, f, o, c], axis=-1)


def _convert_weights(layer, kw: Dict[str, np.ndarray]):
    """Returns (params_dict, state_dict) for one of our layers given keras
    weight arrays (already channels_last)."""
    if isinstance(layer, (DenseLayer, OutputLayer)):
        p = {"W": kw["kernel"]}
        if layer.has_bias:
            p["b"] = kw.get("bias", np.zeros(layer.n_out, np.float32))
        return p, {}
    if isinstance(layer, (ConvolutionLayer, Convolution1DLayer)):
        p = {"W": kw["kernel"]}  # HWIO == our layout
        if layer.has_bias:
            p["b"] = kw.get("bias", np.zeros(layer.n_out, np.float32))
        return p, {}
    if isinstance(layer, BatchNormalization):
        nf = None
        for key in ("moving_mean", "moving_variance", "gamma", "beta"):
            if key in kw:
                nf = len(kw[key])
                break
        p = {"gamma": kw.get("gamma", np.ones(nf, np.float32)),
             "beta": kw.get("beta", np.zeros(nf, np.float32))}
        s = {"mean": kw["moving_mean"], "var": kw["moving_variance"]}
        return p, s
    if isinstance(layer, GravesLSTM):
        units = layer.n_out
        kern = _lstm_reorder(kw["kernel"], units)
        rec = _lstm_reorder(kw["recurrent_kernel"], units)
        W = np.concatenate([kern, rec], axis=0)
        b = _lstm_reorder(kw.get("bias", np.zeros(4 * units, np.float32)),
                          units)
        return {"W": W, "b": b,
                "peep": np.zeros(3 * units, np.float32)}, {}
    if isinstance(layer, EmbeddingLayer):
        p = {"W": kw.get("embeddings", kw.get("kernel"))}
        if layer.has_bias:
            p["b"] = np.zeros(layer.n_out, np.float32)
        return p, {}
    raise KerasImportError(
        f"No weight converter for layer type {type(layer).__name__}")


# ---------------------------------------------------------------------------
# Sequential
# ---------------------------------------------------------------------------

def _loss_from_training_config(tc: Optional[Dict]) -> Optional[str]:
    if not tc:
        return None
    loss = tc.get("loss")
    if isinstance(loss, dict):
        loss = next(iter(loss.values())) if loss else None
    if isinstance(loss, dict):  # serialized loss object
        loss = (loss.get("config") or {}).get("name") or loss.get("class_name")
    if loss is None:
        return None
    key = str(loss).lower()
    # class-style names like "CategoricalCrossentropy"
    key = {"categoricalcrossentropy": "categorical_crossentropy",
           "binarycrossentropy": "binary_crossentropy",
           "meansquarederror": "mean_squared_error",
           "meanabsoluteerror": "mean_absolute_error"}.get(key, key)
    return _LOSSES.get(key)


def _sequential_layer_list(model_cfg: Dict) -> List[Dict]:
    layers = model_cfg["config"]
    if isinstance(layers, dict):
        layers = layers["layers"]
    return layers


def import_keras_sequential_configuration(
        model_cfg: Dict, training_cfg: Optional[Dict] = None):
    """Keras Sequential config dict -> (MultiLayerConfiguration,
    [keras_layer_name per our-layer-index or None])."""
    layers_cfg = _sequential_layer_list(model_cfg)
    loss = _loss_from_training_config(training_cfg)

    lb = NeuralNetConfiguration.builder().list()
    names: List[Optional[str]] = []
    input_type = None
    cur: Optional[InputType] = None  # shape *entering* the next layer
    idx = 0

    def add(our_layer, keras_name):
        nonlocal idx, cur
        lb.layer(our_layer)
        names.append(keras_name)
        if cur is not None:
            # n_in filling happens in ListBuilder.build(); only the shape
            # needs tracking here (for Flatten preprocessor insertion)
            cur = our_layer.output_type(cur)
        idx += 1

    seq = list(layers_cfg)
    for j, entry in enumerate(seq):
        cls = entry["class_name"]
        cfg = entry.get("config", {})
        name = cfg.get("name") or entry.get("name")
        is_last = all(e["class_name"] in ("Dropout", "Activation")
                      for e in seq[j + 1:])
        if cls == "InputLayer":
            shape = cfg.get("batch_shape") or cfg.get("batch_input_shape")
            input_type = _input_type_from_shape(shape[1:])
            cur = input_type
            continue
        if "batch_input_shape" in cfg and input_type is None:
            input_type = _input_type_from_shape(cfg["batch_input_shape"][1:])
            cur = input_type
        if cls == "Dense":
            add(_map_dense(cfg, is_last, loss), name)
        elif cls in ("Conv2D", "Convolution2D"):
            add(_map_conv2d(cfg, name), name)
        elif cls in ("Conv1D", "Convolution1D"):
            add(_map_conv1d(cfg, name), name)
        elif cls in ("MaxPooling2D", "MaxPool2D"):
            add(_map_pool2d(cfg, name, PoolingType.MAX), name)
        elif cls in ("AveragePooling2D", "AvgPool2D"):
            add(_map_pool2d(cfg, name, PoolingType.AVG), name)
        elif cls in ("MaxPooling1D",):
            add(_map_pool1d(cfg, PoolingType.MAX), name)
        elif cls in ("AveragePooling1D",):
            add(_map_pool1d(cfg, PoolingType.AVG), name)
        elif cls in ("GlobalMaxPooling2D", "GlobalMaxPooling1D"):
            add(GlobalPoolingLayer(pooling_type=PoolingType.MAX), name)
        elif cls in ("GlobalAveragePooling2D", "GlobalAveragePooling1D"):
            add(GlobalPoolingLayer(pooling_type=PoolingType.AVG), name)
        elif cls == "BatchNormalization":
            add(_map_batchnorm(cfg, name), name)
        elif cls == "Activation":
            add(ActivationLayer(activation=_act(cfg.get("activation"))), name)
        elif cls == "Dropout":
            add(DropoutLayer(dropout=1.0 - float(cfg.get("rate", 0.5))), name)
        elif cls == "Flatten":
            if cur is not None and cur.kind == "cnn":
                lb.input_pre_processor(idx, CnnToFeedForwardPreProcessor(
                    cur.height, cur.width, cur.channels))
                cur = InputType.feed_forward(cur.flat_size())
            elif cur is not None and cur.kind == "rnn":
                # our RnnToFeedForward is [B,T,F]->[B*T,F] (time-distributed),
                # NOT keras Flatten's [B,T*F] — don't silently mis-map
                raise KerasImportError(
                    "Flatten after a recurrent layer is unsupported")
            # ff input: no-op
        elif cls in ("ZeroPadding2D",):
            add(_map_zeropad2d(cfg, name), name)
        elif cls in ("LSTM", "GravesLSTM"):
            lstm, return_seq = _map_lstm(cfg)
            add(lstm, name)
            if not return_seq:
                add(LastTimeStep(), None)
        elif cls == "Embedding":
            add(EmbeddingLayer(n_in=int(cfg["input_dim"]),
                               n_out=int(cfg["output_dim"]),
                               has_bias=False), name)
        elif cls in ("Reshape", "Permute", "RepeatVector", "Masking"):
            raise KerasImportError(f"Unsupported Keras layer '{cls}'")
        else:
            raise KerasImportError(f"Unknown Keras layer '{cls}'")

    if input_type is None:
        raise KerasImportError("Model config declares no input shape")
    conf = lb.set_input_type(input_type).build()
    return conf, names


def import_keras_sequential_model_and_weights(
        path: str, device: DeviceLike = None) -> MultiLayerNetwork:
    """HDF5 file -> MultiLayerNetwork on `device` with imported weights
    (`KerasModelImport.importKerasSequentialModelAndWeights`)."""
    with Hdf5Archive(path) as ar:
        model_cfg = ar.model_config()
        if model_cfg.get("class_name") != "Sequential":
            raise KerasImportError(
                f"Not a Sequential model: {model_cfg.get('class_name')} — "
                "use import_keras_model_and_weights")
        conf, names = import_keras_sequential_configuration(
            model_cfg, ar.training_config())
        model = MultiLayerNetwork(conf, device=device).init()
        params = list(model.params)
        state = list(model.state)
        for i, kname in enumerate(names):
            if kname is None or not model.layers[i].has_params:
                continue
            kw = ar.layer_weights(kname)
            if not kw:
                continue
            p, s = _convert_weights(model.layers[i], kw)
            params[i] = _shaped_like(params[i], p, kname)
            if s:
                state[i] = _shaped_like(state[i], s, kname)
        model.params = tuple(params)
        model.state = tuple(state)
        return model


def _shaped_like(ours: Dict, theirs: Dict, name: str) -> Dict:
    out = dict(ours)
    for k, v in theirs.items():
        if k not in ours:
            raise KerasImportError(f"Layer '{name}': no param '{k}'")
        if tuple(ours[k].shape) != tuple(np.shape(v)):
            raise KerasImportError(
                f"Layer '{name}' param '{k}': shape {np.shape(v)} != "
                f"expected {tuple(ours[k].shape)}")
        out[k] = torch.from_numpy(np.array(v)).to(
            device=ours[k].device, dtype=ours[k].dtype)
    return out


# ---------------------------------------------------------------------------
# Functional (graph)
# ---------------------------------------------------------------------------

def _inbound_names(entry) -> List[str]:
    """Parse inbound layer names from Keras 2 ([[["name",0,0,{}]]]) or
    Keras 3 ({"args": [KerasTensor...]}) inbound_nodes."""
    nodes = entry.get("inbound_nodes") or []
    names: List[str] = []

    def rec(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                names.append(obj["config"]["keras_history"][0])
                return
            for v in obj.values():
                rec(v)
        elif isinstance(obj, (list, tuple)):
            # keras-2 style ["layer_name", node_idx, tensor_idx, {...}]
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int)):
                names.append(obj[0])
                return
            for v in obj:
                rec(v)

    rec(nodes)
    return names


def import_keras_model_configuration(model_cfg: Dict,
                                     training_cfg: Optional[Dict] = None):
    """Keras functional config -> (ComputationGraphConfiguration,
    {our_vertex_name: keras_layer_name})."""
    cfg = model_cfg["config"]
    layers = cfg["layers"]
    loss = _loss_from_training_config(training_cfg)

    def _names(spec):
        # input_layers/output_layers: ["name",0,0] or [["name",0,0], ...]
        if not spec:
            return []
        if isinstance(spec[0], str):
            return [spec[0]]
        return [s[0] for s in spec]

    in_names = _names(cfg.get("input_layers"))
    out_names = _names(cfg.get("output_layers"))

    gb = (NeuralNetConfiguration.builder().graph_builder()
          .add_inputs(*in_names))
    names_map: Dict[str, str] = {}
    input_types = []
    for entry in layers:
        cls = entry["class_name"]
        lcfg = entry.get("config", {})
        name = lcfg.get("name") or entry.get("name")
        inbound = _inbound_names(entry)
        if cls == "InputLayer":
            shape = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
            input_types.append(_input_type_from_shape(shape[1:]))
            continue
        is_output = name in out_names
        if cls == "Dense":
            gb.add_layer(name, _map_dense(lcfg, is_output, loss), *inbound)
        elif cls in ("Conv2D", "Convolution2D"):
            gb.add_layer(name, _map_conv2d(lcfg, name), *inbound)
        elif cls in ("MaxPooling2D", "MaxPool2D"):
            gb.add_layer(name, _map_pool2d(lcfg, name, PoolingType.MAX),
                         *inbound)
        elif cls in ("AveragePooling2D", "AvgPool2D"):
            gb.add_layer(name, _map_pool2d(lcfg, name, PoolingType.AVG),
                         *inbound)
        elif cls in ("GlobalMaxPooling2D", "GlobalMaxPooling1D"):
            gb.add_layer(name, GlobalPoolingLayer(
                pooling_type=PoolingType.MAX), *inbound)
        elif cls in ("GlobalAveragePooling2D", "GlobalAveragePooling1D"):
            gb.add_layer(name, GlobalPoolingLayer(
                pooling_type=PoolingType.AVG), *inbound)
        elif cls == "BatchNormalization":
            gb.add_layer(name, _map_batchnorm(lcfg, name), *inbound)
        elif cls == "Activation":
            gb.add_layer(name, ActivationLayer(
                activation=_act(lcfg.get("activation"))), *inbound)
        elif cls == "Dropout":
            gb.add_layer(name, DropoutLayer(
                dropout=1.0 - float(lcfg.get("rate", 0.5))), *inbound)
        elif cls in ("ZeroPadding2D",):
            gb.add_layer(name, _map_zeropad2d(lcfg, name), *inbound)
        elif cls in ("LSTM", "GravesLSTM"):
            lstm, return_seq = _map_lstm(lcfg)
            if not return_seq:
                raise KerasImportError(
                    "functional import: LSTM return_sequences=False "
                    "unsupported — wrap with return_sequences=True + pooling")
            gb.add_layer(name, lstm, *inbound)
        elif cls == "Embedding":
            gb.add_layer(name, EmbeddingLayer(
                n_in=int(lcfg["input_dim"]), n_out=int(lcfg["output_dim"]),
                has_bias=False), *inbound)
        elif cls == "Add":
            gb.add_vertex(name, ElementWiseVertex(op="add"), *inbound)
        elif cls == "Subtract":
            gb.add_vertex(name, ElementWiseVertex(op="subtract"), *inbound)
        elif cls == "Multiply":
            gb.add_vertex(name, ElementWiseVertex(op="product"), *inbound)
        elif cls == "Average":
            gb.add_vertex(name, ElementWiseVertex(op="average"), *inbound)
        elif cls == "Maximum":
            gb.add_vertex(name, ElementWiseVertex(op="max"), *inbound)
        elif cls in ("Concatenate", "Merge"):
            gb.add_vertex(name, MergeVertex(), *inbound)
        elif cls == "Flatten":
            # becomes a preprocessor on the consumer in sequential; in graphs
            # we model it as a PreprocessorVertex
            from ..nn.conf.graph import PreprocessorVertex
            gb.add_vertex(name, PreprocessorVertex(
                _FlattenPreprocessor()), *inbound)
        else:
            raise KerasImportError(f"Unknown Keras layer '{cls}'")
        names_map[name] = name

    gb.set_input_types(*input_types)
    gb.set_outputs(*out_names)
    return gb.build(), names_map


class _FlattenPreprocessor:
    """Shape-agnostic flatten (keras Flatten inside a functional graph)."""

    def apply(self, x):
        return x.reshape(x.shape[0], -1)

    def apply_mask(self, mask):
        return mask

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(it.flat_size())


def import_keras_model_and_weights(path: str, device: DeviceLike = None):
    """HDF5 file -> ComputationGraph (functional) or MultiLayerNetwork
    (sequential) on `device`, with weights
    (`KerasModelImport.importKerasModelAndWeights`)."""
    with Hdf5Archive(path) as ar:
        model_cfg = ar.model_config()
        if model_cfg.get("class_name") == "Sequential":
            return import_keras_sequential_model_and_weights(path, device)
        conf, names_map = import_keras_model_configuration(
            model_cfg, ar.training_config())
        graph = ComputationGraph(conf, device=device).init()
        for vname, kname in names_map.items():
            layer = graph.conf.vertices.get(vname)
            if layer is None or not getattr(layer, "has_params", False):
                continue
            kw = ar.layer_weights(kname)
            if not kw:
                continue
            p, s = _convert_weights(layer, kw)
            graph.params[vname] = _shaped_like(graph.params[vname], p, kname)
            if s:
                graph.state[vname] = _shaped_like(graph.state[vname], s,
                                                  kname)
        return graph
