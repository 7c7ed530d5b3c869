"""Clustering (counterpart of ``deeplearning4j_tpu/clustering``):
``KMeansClustering`` (torch on its device, the IVF index's coarse
quantizer) and the host trees VPTree, KDTree, QuadTree / SpTree, which
Barnes-Hut t-SNE (``tsne.BarnesHutTsne``) stands on."""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.vptree import VPTree
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree, SpTree

__all__ = ["KMeansClustering", "VPTree", "KDTree", "QuadTree", "SpTree"]
