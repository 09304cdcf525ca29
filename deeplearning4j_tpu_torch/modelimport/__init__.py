"""Keras model import (the port of `deeplearning4j_tpu/modelimport/`).

HDF5 -> network configuration + weights (`keras.py`: the 14 layer mappers,
Sequential -> MultiLayerNetwork, functional -> ComputationGraph), the h5py
archive reader (`hdf5.py`), the pretrained-weight helpers over a local cache
(`trainedmodels.py`) and the Keras backend HTTP server (`server.py`). h5py is
imported only when a file is read, so the package imports without it.
"""
from .hdf5 import Hdf5Archive
from .keras import (KerasImportError, import_keras_model_and_weights,
                    import_keras_model_configuration,
                    import_keras_sequential_configuration,
                    import_keras_sequential_model_and_weights)

__all__ = [
    "Hdf5Archive", "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_sequential_model_and_weights",
    "import_keras_model_configuration",
    "import_keras_sequential_configuration",
]
