"""Keras HDF5 model import (counterpart of ``deeplearning4j_tpu/keras``)."""

from deeplearning4j_tpu_torch.keras.importer import (
    KerasImportError, import_keras_model_and_weights,
    import_keras_sequential_model)

__all__ = ["import_keras_model_and_weights",
           "import_keras_sequential_model", "KerasImportError"]
