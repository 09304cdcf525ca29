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

The second slice serves a GPT-style transformer LM
(`EmbeddingSequenceLayer`, `TransformerBlock`, softmax `RnnOutputLayer`)
through the same registry and server; every block's attention runs the
hand-written CUDA flash-attention kernel in `kernels/csrc/attention.cu`.

The third slice trains the char-RNN: losses, updaters, lr schedules,
gradient normalization, `MultiLayerNetwork.fit` with truncated BPTT,
`score` / `score_examples` / `evaluate`, the in-memory iterators, the
updater state in the zip and a float64 gradient check. The LSTM's
gradients come from its autograd Function: the residual-saving forward,
the reverse-time adjoint and the parameter-gradient reduction, each a
hand-written CUDA kernel in `kernels/csrc/lstm.cu`.

The fourth slice trains the transformer LM through the flash-attention
backward kernels in `kernels/csrc/attention.cu`.

The fifth slice trains a batch-normalised MLP in bf16: the bf16-compute /
f32-master contract (`compute_dtype`), layer state (BatchNormalization's
running statistics, carried through training and the zip), the
`BatchNormalization` layer with JAX's tier selection, and its training-mode
BN+ReLU forward and backward as hand-written CUDA kernels in
`kernels/csrc/bn_relu.cu`.
"""
from .datasets import (ArrayDataSetIterator, DataSet, DataSetIterator,
                       ListDataSetIterator, bundled_mnist_subset)
from .eval import Evaluation
from .models import char_rnn, mlp_mnist, sample_characters
from .nn import (BackpropType, InputType, MultiLayerConfiguration,
                 MultiLayerNetwork, NeuralNetConfiguration)
from .nn.layers import (BatchNormalization, DenseLayer,
                        EmbeddingSequenceLayer, GravesLSTM, OutputLayer,
                        RnnOutputLayer, TransformerBlock)
from .nn.updaters import Adam, Nesterovs, Sgd
from .serving import InferenceServer, ModelRegistry
from .util import ModelSerializer, from_jax_params

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator", "bundled_mnist_subset", "Evaluation",
           "char_rnn", "mlp_mnist", "sample_characters", "BackpropType",
           "InputType", "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "BatchNormalization", "DenseLayer",
           "EmbeddingSequenceLayer", "GravesLSTM", "OutputLayer",
           "RnnOutputLayer", "TransformerBlock", "Adam", "Nesterovs", "Sgd",
           "InferenceServer", "ModelRegistry", "ModelSerializer",
           "from_jax_params"]
