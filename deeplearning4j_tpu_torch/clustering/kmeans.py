"""K-Means clustering (counterpart of
``deeplearning4j_tpu/clustering/kmeans.py``).

The Lloyd step runs as torch ops on the points' device: the squared
distances of a block of rows to every centroid, their argmin, the
per-cell sums (``index_add_``) and counts, and the update in which an
empty cell keeps its old centroid. The (N, K) distance matrix is never
whole: rows go in blocks of at most ``_BLOCK_ELEMS`` distances, so a
million rows against 1024 centroids stay within a few hundred MiB.
The per-cell sums differ from the JAX package's ``onehot.T @ points``
only in the order of the additions.

k-means++ draws from the same ``numpy`` generator as the JAX package
(``rng.integers`` first, then ``rng.choice(p=)``) and keeps a running
minimum of the squared distance to the centroids picked so far, which
holds the same values as the JAX package's ``np.min`` over the list of
every earlier centroid's distances, at O(k·N·D) instead of O(k²·N·D).
On the CPU the distances are the same numpy expression, so the picks
equal the JAX package's bit for bit; on a card they are computed on the
device, and each pick's probabilities are copied to the host for
``rng.choice``.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import keep_float32, resolve_device

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["KMeansClustering"]

# distances computed at once in the assignment (rows x centroids)
_BLOCK_ELEMS = 1 << 25


def _assign(points: torch.Tensor, centroids: torch.Tensor):
    """(argmin cell, min squared distance) per row, in row blocks: the
    JAX package's ``sum(p²) - 2·p·cᵀ + sum(c²)`` and ``argmin``."""
    keep_float32(points)
    n, k = points.shape[0], centroids.shape[0]
    block = max(1, _BLOCK_ELEMS // max(k, 1))
    c_sq = torch.sum(centroids ** 2, dim=1)[None, :]
    assign = torch.empty(n, dtype=torch.int64, device=points.device)
    mins = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, block):
        p = points[s:s + block]
        d2 = (torch.sum(p ** 2, dim=1, keepdim=True)
              - 2 * p @ centroids.T + c_sq)
        # torch.min returns the first minimal index, as jnp.argmin does
        mins[s:s + block], assign[s:s + block] = torch.min(d2, dim=1)
    return assign, mins


def _lloyd_step(points: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration: (new centroids, assignment, inertia tensor)."""
    assign, mins = _assign(points, centroids)
    k = centroids.shape[0]
    sums = torch.zeros_like(centroids).index_add_(0, assign, points)
    counts = torch.bincount(assign, minlength=k).to(points.dtype)[:, None]
    new = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                      centroids)
    return new, assign, torch.sum(mins)


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100,
                 tol: float = 1e-5, seed: int = 0,
                 init: str = "kmeans++", distance: str = "euclidean",
                 device="cuda"):
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"Unsupported distance '{distance}'")
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.init = init
        self.distance = distance
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.inertia: float = float("inf")

    @staticmethod
    def setup(k: int, max_iterations: int = 100,
              distance: str = "euclidean",
              device="cuda") -> "KMeansClustering":
        """Reference-style factory (KMeansClustering.setup)."""
        return KMeansClustering(k, max_iterations, distance=distance,
                                device=device)

    def _prep(self, x: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            # spherical k-means: L2-normalize so squared-euclidean
            # ordering equals cosine ordering
            n = np.linalg.norm(x, axis=1, keepdims=True)
            return x / np.maximum(n, 1e-12)
        return x

    def _init_centroids(self, x: np.ndarray, xt: torch.Tensor,
                        rng: np.random.Generator) -> np.ndarray:
        if self.init != "kmeans++":
            return x[rng.choice(x.shape[0], self.k, replace=False)]
        on_host = xt.device.type == "cpu"

        def dist2(c: np.ndarray) -> np.ndarray:
            if on_host:
                return np.sum((x - c) ** 2, axis=1)
            ct = torch.from_numpy(np.ascontiguousarray(c)).to(xt.device)
            return torch.sum((xt - ct) ** 2, dim=1)

        centroids = [x[rng.integers(0, x.shape[0])]]
        d2 = dist2(centroids[0])
        for _ in range(1, self.k):
            d2_host = d2 if on_host else d2.cpu().numpy()
            probs = d2_host / max(d2_host.sum(), 1e-12)
            centroids.append(x[rng.choice(x.shape[0], p=probs)])
            d2 = (np.minimum(d2, dist2(centroids[-1])) if on_host
                  else torch.minimum(d2, dist2(centroids[-1])))
        return np.stack(centroids)

    def apply_to(self, points: np.ndarray) -> np.ndarray:
        """Fit; returns cluster assignments (reference applyTo returns a
        ClusterSet: assignments + centroids here)."""
        x = self._prep(np.asarray(points, np.float32))
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        rng = np.random.default_rng(self.seed)
        c = torch.from_numpy(np.ascontiguousarray(
            self._init_centroids(x, xt, rng))).to(self.device)
        prev = np.inf
        assign = None
        inertia = float("inf")
        for _ in range(self.max_iterations):
            c, assign, inertia = _lloyd_step(xt, c)
            inertia = float(inertia)      # the one sync an iteration
            if abs(prev - inertia) < self.tol * max(abs(prev), 1.0):
                break
            prev = inertia
        self.centroids = c.cpu().numpy()
        self.inertia = inertia
        return assign.cpu().numpy().astype(np.int32)

    fit_predict = apply_to

    def predict(self, points: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(
            self._prep(np.asarray(points, np.float32)))).to(self.device)
        assign, _ = _assign(x, torch.from_numpy(self.centroids).to(
            self.device))
        return assign.cpu().numpy().astype(np.int32)
