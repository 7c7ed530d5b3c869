"""Executors (MultiLayerNetwork and ComputationGraph: inference and
training) and the streaming, paged-KV and speculative decode
sessions."""

from deeplearning4j_tpu_torch import _lazy

__all__ = ["MultiLayerNetwork", "ComputationGraph"]

__getattr__ = _lazy.exports(__name__, {
    "MultiLayerNetwork": "multi_layer_network",
    "ComputationGraph": "computation_graph",
})
