"""Executors (ported so far: MultiLayerNetwork inference)."""
