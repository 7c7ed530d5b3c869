"""QuadTree (2-d) and SpTree (n-d) for Barnes-Hut approximations.

(Counterpart of ``deeplearning4j_tpu/clustering/quadtree.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors nearestneighbor-core clustering/quadtree/QuadTree.java and
clustering/sptree/SpTree.java: spatial subdivision with per-cell center
of mass, used by Barnes-Hut t-SNE to approximate repulsive forces in
O(N log N).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["QuadTree", "SpTree"]


class SpTree:
    """n-dimensional Barnes-Hut tree (SpTree.java). Cells split into
    2^d children; each keeps cumulative center of mass + count."""

    __slots__ = ("center", "width", "dim", "cum_center", "count",
                 "children", "point_index", "coords")

    def __init__(self, center: np.ndarray, width: np.ndarray,
                 coords: Optional[np.ndarray] = None):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.dim = len(self.center)
        self.cum_center = np.zeros(self.dim)
        self.count = 0
        self.children: Optional[List["SpTree"]] = None
        self.point_index: Optional[int] = None
        self.coords = coords          # full point array (shared refs)

    def _child_for(self, point: np.ndarray) -> int:
        idx = 0
        for d in range(self.dim):
            if point[d] > self.center[d]:
                idx |= (1 << d)
        return idx

    def _subdivide(self):
        self.children = []
        for ci in range(1 << self.dim):
            offs = np.array([(1 if (ci >> d) & 1 else -1)
                             for d in range(self.dim)], np.float64)
            self.children.append(
                SpTree(self.center + offs * self.width / 2,
                       self.width / 2, self.coords))

    def insert(self, point: np.ndarray, index: int):
        self.cum_center = (self.cum_center * self.count + point) / \
            (self.count + 1)
        self.count += 1
        if self.children is None:
            if self.point_index is None:
                self.point_index = index
                return
            old = self.point_index
            # duplicate points would subdivide forever; fold into mass
            if np.allclose(self.coords[old], point) or \
                    float(np.max(self.width)) < 1e-12:
                return
            # split and reinsert the resident point
            self.point_index = None
            self._subdivide()
            self.children[self._child_for(self.coords[old])].insert(
                self.coords[old], old)
        if self.children is not None:
            self.children[self._child_for(point)].insert(point, index)

    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Barnes-Hut negative-force accumulation for t-SNE
        (SpTree.computeNonEdgeForces). Returns the partition-sum
        contribution."""
        if self.count == 0:
            return 0.0
        diff = point - self.cum_center
        d2 = float(diff @ diff)
        max_width = float(np.max(self.width) * 2)
        if self.children is None or \
                (d2 > 0 and max_width / np.sqrt(d2) < theta):
            if self.count == 1 and d2 == 0.0:
                return 0.0      # the point itself
            q = 1.0 / (1.0 + d2)
            mult = self.count * q
            neg_f += mult * q * diff
            return mult
        s = 0.0
        for ch in self.children:
            s += ch.compute_non_edge_forces(point, theta, neg_f)
        return s


def _build_sptree(points: np.ndarray) -> SpTree:
    points = np.asarray(points, np.float64)
    lo, hi = points.min(0), points.max(0)
    center = (lo + hi) / 2
    width = np.maximum((hi - lo) / 2 + 1e-9, 1e-9)
    tree = SpTree(center, width, coords=points)
    for i, p in enumerate(points):
        tree.insert(p, i)
    return tree


SpTree.build = staticmethod(_build_sptree)


class QuadTree(SpTree):
    """2-d specialization (QuadTree.java)."""

    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        assert np.asarray(points).shape[1] == 2, "QuadTree is 2-d"
        return _build_sptree(points)
