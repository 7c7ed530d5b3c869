"""VP-tree for exact nearest-neighbor search.

(Counterpart of ``deeplearning4j_tpu/clustering/vptree.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors nearestneighbor-core clustering/vptree/VPTree.java:48 (build)
and :471-508 (search): vantage-point partitioning by median distance,
branch-and-bound k-NN with a bounded priority queue. Distances:
euclidean / cosine (the reference's similarity functions).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["VPTree"]


class _Node:
    __slots__ = ("index", "threshold", "left", "right")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class VPTree:
    """NOTE on cosine: 1-cos violates the triangle inequality, which
    breaks VP-tree pruning. Internally cosine mode searches EUCLIDEAN
    distance on L2-normalized vectors (a true metric with identical
    ordering: ||a-b||² = 2(1-cos) on the unit sphere) and converts
    reported distances back to 1-cos."""

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 seed: int = 0):
        self.items = np.asarray(items, np.float64)
        self.distance = distance
        if distance == "cosine":
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._search_items = self.items / np.maximum(norms, 1e-12)
        else:
            self._search_items = self.items
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.items)))
        self.root = self._build(idx)

    def _dist_many(self, i: int, others: np.ndarray) -> np.ndarray:
        diff = self._search_items[others] - self._search_items[i]
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _dist_point(self, q: np.ndarray, i: int) -> float:
        return float(np.linalg.norm(self._search_items[i] - q))

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        vp_pos = self._rng.integers(0, len(idx))
        vp = idx.pop(int(vp_pos))
        node = _Node(vp)
        if not idx:
            return node
        others = np.array(idx)
        dists = self._dist_many(vp, others)
        median = float(np.median(dists))
        node.threshold = median
        inner = [int(i) for i, d in zip(others, dists) if d < median]
        outer = [int(i) for i, d in zip(others, dists) if d >= median]
        node.left = self._build(inner)
        node.right = self._build(outer)
        return node

    def search(self, query: np.ndarray, k: int) -> Tuple[List[int],
                                                         List[float]]:
        """k nearest neighbors (reference search :471). Cosine mode
        returns 1-cos distances."""
        q = np.asarray(query, np.float64)
        if self.distance == "cosine":
            q = q / max(np.linalg.norm(q), 1e-12)
        heap: List[Tuple[float, int]] = []   # max-heap via negatives
        tau = [np.inf]

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = self._dist_point(q, node.index)
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.left is None and node.right is None:
                return
            if d < node.threshold:
                visit(node.left)
                if d + tau[0] >= node.threshold:
                    visit(node.right)
            else:
                visit(node.right)
                if d - tau[0] <= node.threshold:
                    visit(node.left)

        visit(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        dists = [d for d, _ in pairs]
        if self.distance == "cosine":
            dists = [d * d / 2.0 for d in dists]    # ||a-b||²/2 = 1-cos
        return [i for _, i in pairs], dists
