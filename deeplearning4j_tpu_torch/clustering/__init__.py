"""Clustering (counterpart of ``deeplearning4j_tpu/clustering``).
Ported: ``KMeansClustering``, the IVF index's coarse quantizer. The
JAX package's VPTree, KDTree, QuadTree / SpTree and t-SNE wait for
ROADMAP A8."""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering

__all__ = ["KMeansClustering"]
