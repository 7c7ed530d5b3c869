"""Configuration: input types, layer configs, network configs (the
package-level names resolve at first use, ``_lazy.py``)."""

from deeplearning4j_tpu_torch import _lazy

__all__ = [
    "InputType",
    "NeuralNetConfiguration",
    "MultiLayerConfiguration",
    "ComputationGraphConfiguration",
]

__getattr__ = _lazy.exports(__name__, {
    "InputType": "inputs",
    "NeuralNetConfiguration": "builder",
    "MultiLayerConfiguration": "multi_layer",
    "ComputationGraphConfiguration": "graph_conf",
})
