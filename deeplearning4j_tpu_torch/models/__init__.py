"""Executors (MultiLayerNetwork and ComputationGraph: inference and
training) and the streaming, paged-KV and speculative decode
sessions."""
