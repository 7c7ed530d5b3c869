"""KD-tree (nearestneighbor-core clustering/kdtree/KDTree.java):
axis-cycling median splits, k-NN branch-and-bound search.

(Counterpart of ``deeplearning4j_tpu/clustering/kdtree.py``, copied with the
imports renamed: host code, no device tensor.)"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["KDTree"]


class _KDNode:
    __slots__ = ("index", "axis", "left", "right")

    def __init__(self, index: int, axis: int):
        self.index = index
        self.axis = axis
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(len(self.points))), 0)

    def insert(self, point) -> None:
        """Incremental insert (reference KDTree.insert)."""
        point = np.asarray(point, np.float64)[None, :]
        idx = len(self.points)
        self.points = np.concatenate([self.points, point])
        node = self.root
        axis = 0
        if node is None:
            self.root = _KDNode(idx, 0)
            return
        while True:
            if point[0, node.axis] < self.points[node.index, node.axis]:
                if node.left is None:
                    node.left = _KDNode(idx, (node.axis + 1) % self.dims)
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = _KDNode(idx, (node.axis + 1) % self.dims)
                    return
                node = node.right

    def _build(self, idx: List[int], depth: int) -> Optional[_KDNode]:
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.points[i, axis])
        mid = len(idx) // 2
        node = _KDNode(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - q))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = q[node.axis] - self.points[node.index, node.axis]
            near, far = (node.left, node.right) if diff < 0 else \
                (node.right, node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        return [i for _, i in pairs], [d for d, _ in pairs]

    def nearest(self, query) -> Tuple[int, float]:
        ids, ds = self.knn(query, 1)
        return ids[0], ds[0]
