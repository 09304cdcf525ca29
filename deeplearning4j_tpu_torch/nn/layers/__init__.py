"""Layers of the port. Importing this package registers every layer type
for the JSON codec."""
from .feedforward import BaseOutputLayerConf, DenseLayer, OutputLayer
from .recurrent import BaseRecurrentLayer, GravesLSTM, RnnOutputLayer
from .transformer import EmbeddingSequenceLayer, TransformerBlock

__all__ = ["BaseOutputLayerConf", "DenseLayer", "OutputLayer",
           "BaseRecurrentLayer", "GravesLSTM", "RnnOutputLayer",
           "EmbeddingSequenceLayer", "TransformerBlock"]
