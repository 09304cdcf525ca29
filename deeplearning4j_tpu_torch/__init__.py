"""deeplearning4j_tpu_torch — the PyTorch / CUDA port of deeplearning4j_tpu
for one NVIDIA H100.

It grows slice by slice beside the JAX package, which stays the reference.
This package imports torch and numpy, never jax and nothing of
deeplearning4j_tpu. Its entry points run on the GPU unless the caller
passes `device="cpu"`.

The first slice serves the char-RNN: configuration DSL and JSON, the
GravesLSTM / RnnOutputLayer / Dense / Output layers, `MultiLayerNetwork`
inference and stateful `rnn_time_step`, the `ModelSerializer` zip shared
with the JAX package, and the serving plane. Both LSTM layers run the
hand-written CUDA sequence kernel in `kernels/csrc/lstm.cu`.
"""
from .models import char_rnn, sample_characters
from .nn import (BackpropType, InputType, MultiLayerConfiguration,
                 MultiLayerNetwork, NeuralNetConfiguration)
from .nn.layers import DenseLayer, GravesLSTM, OutputLayer, RnnOutputLayer
from .nn.updaters import Adam, Nesterovs, Sgd
from .serving import InferenceServer, ModelRegistry
from .util import ModelSerializer, from_jax_params

__all__ = ["char_rnn", "sample_characters", "BackpropType", "InputType",
           "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "DenseLayer", "GravesLSTM",
           "OutputLayer", "RnnOutputLayer", "Adam", "Nesterovs", "Sgd",
           "InferenceServer", "ModelRegistry", "ModelSerializer",
           "from_jax_params"]
