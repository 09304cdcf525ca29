"""Layers of the port. Importing this package registers every layer type
for the JSON codec."""
from .convolution import (Convolution1DLayer, ConvolutionLayer,
                          ConvolutionMode, PoolingType, Subsampling1DLayer,
                          SubsamplingLayer, ZeroPaddingLayer)
from .feedforward import (ActivationLayer, BaseOutputLayerConf, DenseLayer,
                          DropoutLayer, EmbeddingLayer, LossLayer,
                          OutputLayer)
from .normalization import BatchNormalization, LocalResponseNormalization
from .pooling import GlobalPoolingLayer
from .generative import (RBM, AutoEncoder,
                         BernoulliReconstructionDistribution,
                         CenterLossOutputLayer,
                         CompositeReconstructionDistribution,
                         GaussianReconstructionDistribution,
                         LossFunctionWrapper, VariationalAutoencoder)
from .moe import MixtureOfExpertsLayer
from .recurrent import (BaseRecurrentLayer, GravesBidirectionalLSTM,
                        GravesLSTM, LastTimeStep, RnnOutputLayer)
from .transformer import EmbeddingSequenceLayer, TransformerBlock

__all__ = ["ConvolutionMode", "PoolingType", "ConvolutionLayer",
           "Convolution1DLayer", "SubsamplingLayer", "Subsampling1DLayer",
           "ZeroPaddingLayer", "BaseOutputLayerConf", "DenseLayer",
           "OutputLayer", "LossLayer", "ActivationLayer", "DropoutLayer",
           "EmbeddingLayer", "BatchNormalization",
           "LocalResponseNormalization", "GlobalPoolingLayer",
           "BaseRecurrentLayer", "GravesLSTM", "GravesBidirectionalLSTM",
           "LastTimeStep", "RnnOutputLayer", "AutoEncoder", "RBM",
           "VariationalAutoencoder", "CenterLossOutputLayer",
           "GaussianReconstructionDistribution",
           "BernoulliReconstructionDistribution",
           "CompositeReconstructionDistribution", "LossFunctionWrapper",
           "MixtureOfExpertsLayer",
           "EmbeddingSequenceLayer", "TransformerBlock"]
