"""Barnes-Hut t-SNE.

(Counterpart of ``deeplearning4j_tpu/clustering/tsne.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors deeplearning4j-core plot/BarnesHutTsne.java:65 (implements
Model; fit(X) learns a 2/3-d embedding): input-space affinities via
perplexity-calibrated Gaussian kernels on the k-NN graph (VPTree),
low-dim repulsion approximated with the SpTree (theta), gradient
descent with momentum + early exaggeration — the van der Maaten
Barnes-Hut algorithm the reference implements.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.clustering.quadtree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["BarnesHutTsne"]


class BarnesHutTsne:
    def __init__(self, *, n_components: int = 2, perplexity: float = 30.0,
                 theta: float = 0.5, learning_rate: float = 200.0,
                 n_iter: int = 500, early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 100, momentum: float = 0.5,
                 final_momentum: float = 0.8, seed: int = 42):
        self.n_components = n_components
        self.perplexity = perplexity
        self.theta = theta
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.seed = seed
        self.embedding: Optional[np.ndarray] = None

    # -------------------------------------------------- affinities (P)
    def _binary_search_beta(self, dists: np.ndarray) -> np.ndarray:
        """Per-point precision for target perplexity (reference
        computeGaussianPerplexity)."""
        target = np.log(self.perplexity)
        beta = 1.0
        beta_min, beta_max = -np.inf, np.inf
        for _ in range(50):
            p = np.exp(-dists * beta)
            sum_p = max(p.sum(), 1e-12)
            h = np.log(sum_p) + beta * float((dists * p).sum()) / sum_p
            diff = h - target
            if abs(diff) < 1e-5:
                break
            if diff > 0:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else \
                    (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else \
                    (beta + beta_min) / 2
        p = np.exp(-dists * beta)
        return p / max(p.sum(), 1e-12)

    def _input_affinities(self, x: np.ndarray):
        n = x.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        tree = VPTree(x, seed=self.seed)
        rows, cols, vals = [], [], []
        for i in range(n):
            idx, dist = tree.search(x[i], k + 1)
            pairs = [(j, d) for j, d in zip(idx, dist) if j != i][:k]
            d2 = np.array([d * d for _, d in pairs])
            p = self._binary_search_beta(d2)
            for (j, _), pj in zip(pairs, p):
                rows.append(i)
                cols.append(j)
                vals.append(pj)
        P = {}
        for r, c, v in zip(rows, cols, vals):
            P[(r, c)] = P.get((r, c), 0.0) + v
            P[(c, r)] = P.get((c, r), 0.0) + v   # symmetrize
        total = sum(P.values())
        rows = np.array([k_[0] for k_ in P], np.int32)
        cols = np.array([k_[1] for k_ in P], np.int32)
        vals = np.array([v / total for v in P.values()], np.float64)
        return rows, cols, vals

    # ---------------------------------------------------------- fitting
    def fit(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        rows, cols, vals = self._input_affinities(x)
        rng = np.random.default_rng(self.seed)
        y = rng.normal(0, 1e-4, (n, self.n_components))
        gains = np.ones_like(y)
        velocity = np.zeros_like(y)

        for it in range(self.n_iter):
            exag = (self.early_exaggeration
                    if it < self.exaggeration_iters else 1.0)
            mom = (self.momentum if it < self.exaggeration_iters
                   else self.final_momentum)
            # attractive forces over the sparse P graph
            diff = y[rows] - y[cols]
            q = 1.0 / (1.0 + np.sum(diff ** 2, axis=1))
            coeff = (exag * vals * q)[:, None] * diff
            pos_f = np.zeros_like(y)
            np.add.at(pos_f, rows, coeff)
            # repulsive forces via Barnes-Hut tree
            tree = SpTree.build(y)
            neg_f = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                acc = np.zeros(self.n_components)
                z += tree.compute_non_edge_forces(y[i], self.theta, acc)
                neg_f[i] = acc
            z = max(z, 1e-12)
            grad = pos_f - neg_f / z
            # delta-bar-delta gains (reference update rule)
            gains = np.where(np.sign(grad) != np.sign(velocity),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            velocity = mom * velocity - self.learning_rate * gains * grad
            y = y + velocity
            y = y - y.mean(0)
        self.embedding = y
        return y

    fit_transform = fit
