"""Executors (ported so far: MultiLayerNetwork inference and training)
and the streaming, paged-KV and speculative decode sessions."""
