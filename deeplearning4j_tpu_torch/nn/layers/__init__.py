"""Layers of the port (inference forward). Importing this package
registers every layer type for the JSON codec."""
from .feedforward import BaseOutputLayerConf, DenseLayer, OutputLayer
from .recurrent import BaseRecurrentLayer, GravesLSTM, RnnOutputLayer

__all__ = ["BaseOutputLayerConf", "DenseLayer", "OutputLayer",
           "BaseRecurrentLayer", "GravesLSTM", "RnnOutputLayer"]
