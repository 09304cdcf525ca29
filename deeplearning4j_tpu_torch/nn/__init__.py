"""Neural-network core of the port: configuration, layers, network."""
from . import layers  # noqa: F401  (registers the layer types)
from .conf import (BackpropType, InputType, MultiLayerConfiguration,
                   NeuralNetConfiguration)
from .multilayer import MultiLayerNetwork

__all__ = ["BackpropType", "InputType", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "MultiLayerNetwork", "layers"]
