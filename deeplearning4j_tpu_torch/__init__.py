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

The tenth slice is the convolutional path: convolution, pooling, zero
padding, local response normalization, global pooling, the input
preprocessors and all 21 activations, so LeNet-MNIST and VGG-16 train and
AlexNet serves. Activations stay NHWC and conv weights HWIO, as in the JAX
package; conv, pool and LRN map to `torch.nn.functional` (cuDNN on the
card), as the JAX package's map to XLA ops. This path launches no hand
kernel.

The eleventh slice: GravesBidirectionalLSTM (both directions through the
LSTM kernels) and LastTimeStep, nested parameter trees, layerwise
pretraining (AutoEncoder, RBM, VariationalAutoencoder), the
mixture-of-experts layer, remat on `torch.utils.checkpoint`, `clone`, and
the offline data side (iterators, fetchers over a local cache, record and
image readers, LabeledPoint).

The twelfth slice: ComputationGraph with its twelve vertex types beside the
layer vertex, the graph zip, the line-search solvers (line gradient
descent, conjugate gradient, L-BFGS), the training listeners, transfer
learning, early stopping, ROC and regression evaluation, and ResNet-50 and
GoogLeNet in the zoo. A graph applies the same layer objects as
MultiLayerNetwork, so its GravesLSTM vertices run the LSTM kernels and its
bf16 [N, C] BatchNormalization(relu) vertices the BN+ReLU kernels.

The thirteenth slice is the training-loop machinery: `fit(superstep=K)`
windows (on the card, replays of one CUDA graph of the optimizer step,
captured per batch signature; `nn/superstep.py`), gradient accumulation,
`fit_scan` / `fit_scan_arrays`, the input pipeline with padding, time
buckets and pinned device prefetch (`datasets/pipeline.py`), the
asynchronous iterators, the TrainingGuard, crash-safe checkpoints with
resume and fault injection (`fault/`), and the telemetry (`telemetry/`).

The fifteenth slice is the train-to-serve loop and model import: the
streaming plane (`streaming/`: the length-prefixed `.npy` wire format, the
`InferenceRoute`, the file-backed topic with committed offsets), the
continual plane (`continual/`: the `ContinualTrainer` that fine-tunes the
served model from a topic on the registry's device, gates, canaries and
promotes or rolls back, with its crash-consistent journal), and Keras
import (`modelimport/`, `util.serializer.ModelGuesser`, the registry's
HDF5 source and the Keras backend server). An imported Keras LSTM is a
GravesLSTM without peepholes, so it runs the LSTM sequence kernels.
"""
from .datasets import (ArrayDataSetIterator, DataSet, DataSetIterator,
                       ListDataSetIterator, bundled_mnist_subset)
from .datasets.iterators import MultiDataSet
from .eval import ROC, Evaluation, RegressionEvaluation, ROCMultiClass
from .models import (alexnet, char_rnn, googlenet, lenet_mnist, mlp_mnist,
                     resnet50, sample_characters, vgg16, vgg19)
from .nn import (BackpropType, InputType, MultiLayerConfiguration,
                 MultiLayerNetwork, NeuralNetConfiguration)
from .nn.conf.graph import (ComputationGraphConfiguration,
                            DuplicateToTimeSeriesVertex, ElementWiseVertex,
                            GraphVertex, L2NormalizeVertex, L2Vertex,
                            LastTimeStepVertex, MergeVertex,
                            PreprocessorVertex, ScaleVertex, ShiftVertex,
                            StackVertex, SubsetVertex, UnstackVertex)
from .nn.graph import ComputationGraph
from .nn.layers import (BatchNormalization, ConvolutionLayer, DenseLayer,
                        EmbeddingSequenceLayer, GravesLSTM,
                        LocalResponseNormalization, OutputLayer,
                        RnnOutputLayer, SubsamplingLayer, TransformerBlock)
from .nn.updaters import Adam, Nesterovs, Sgd
from .serving import InferenceServer, ModelRegistry
from .util import ModelSerializer, from_jax_params
from . import telemetry
from .telemetry import TelemetryListener, TelemetrySession

__all__ = ["ArrayDataSetIterator", "DataSet", "DataSetIterator",
           "ListDataSetIterator", "MultiDataSet", "bundled_mnist_subset",
           "Evaluation", "ROC", "ROCMultiClass", "RegressionEvaluation",
           "alexnet", "char_rnn", "googlenet", "lenet_mnist", "mlp_mnist",
           "resnet50", "sample_characters", "vgg16", "vgg19",
           "ComputationGraph", "ComputationGraphConfiguration",
           "GraphVertex", "MergeVertex", "ElementWiseVertex", "SubsetVertex",
           "StackVertex", "UnstackVertex", "ScaleVertex", "ShiftVertex",
           "L2Vertex", "L2NormalizeVertex", "PreprocessorVertex",
           "LastTimeStepVertex", "DuplicateToTimeSeriesVertex",
           "BackpropType",
           "InputType", "MultiLayerConfiguration", "MultiLayerNetwork",
           "NeuralNetConfiguration", "BatchNormalization",
           "ConvolutionLayer", "DenseLayer", "EmbeddingSequenceLayer",
           "GravesLSTM", "LocalResponseNormalization", "OutputLayer",
           "RnnOutputLayer", "SubsamplingLayer", "TransformerBlock", "Adam", "Nesterovs", "Sgd",
           "InferenceServer", "ModelRegistry", "ModelSerializer",
           "telemetry", "TelemetryListener", "TelemetrySession",
           "from_jax_params"]
