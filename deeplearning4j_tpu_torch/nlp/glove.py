"""GloVe embeddings on torch (counterpart of
``deeplearning4j_tpu/nlp/glove.py``).

Mirrors models/glove/Glove.java + learning/impl/elements/GloVe.java:
the co-occurrence counts with 1/distance weighting within a window,
then the weighted least-squares objective
  J = Σ f(X_ij)(wᵢᵀw̃ⱼ + bᵢ + b̃ⱼ − log X_ij)²,   f(x)=(x/x_max)^α
trained with AdaGrad over every non-zero co-occurrence at once, an
epoch a step (``glove_epoch_step``: plain torch on the tables' device,
the gradients written out and summed into the tables by
``index_add_``). The counts are built on the host, in the JAX
package's order.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["Glove", "glove_epoch_step"]


def glove_epoch_step(params, accum, rows, cols, logv, wgt, lr: float):
    """One full-batch AdaGrad step (JAX ``epoch_step``) over
    ``params`` = [w, wc, bw, bc] and their accumulators ``accum``, both
    updated in place; returns the loss 0.5 Σ f·err²."""
    w, wc, bw, bc = params
    wi = w[rows]
    cj = wc[cols]
    pred = torch.sum(wi * cj, dim=-1) + bw[rows] + bc[cols]
    err = pred - logv
    loss = 0.5 * torch.sum(wgt * err * err)
    ge = wgt * err                                        # dJ/dpred
    grads = [torch.zeros_like(w).index_add_(0, rows, ge[:, None] * cj),
             torch.zeros_like(wc).index_add_(0, cols, ge[:, None] * wi),
             torch.zeros_like(bw).index_add_(0, rows, ge),
             torch.zeros_like(bc).index_add_(0, cols, ge)]
    for p, a, g in zip(params, accum, grads):
        a.add_(g * g)
        p.sub_(lr * g / torch.sqrt(a))
    return loss


class Glove(SequenceVectors):
    def __init__(self, *, x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, **kw):
        kw.setdefault("learning_rate", 0.05)
        super().__init__(**kw)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.bias_w: Optional[np.ndarray] = None
        self.bias_c: Optional[np.ndarray] = None

    def _cooccurrences(self, sequences) -> Dict[Tuple[int, int], float]:
        counts: Dict[Tuple[int, int], float] = {}
        for seq in sequences:
            idxs = [self.vocab.index_of(t) for t in seq]
            idxs = [i for i in idxs if i >= 0]
            for pos, w in enumerate(idxs):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idxs):
                        break
                    c = idxs[j]
                    inc = 1.0 / off        # 1/distance weighting
                    counts[(w, c)] = counts.get((w, c), 0.0) + inc
                    if self.symmetric:
                        counts[(c, w)] = counts.get((c, w), 0.0) + inc
        return counts

    def fit(self, sequences: List[List[str]]):
        if self.vocab is None:
            self.build_vocab(sequences)
        co = self._cooccurrences(sequences)
        if not co:
            raise ValueError("No co-occurrences found")
        rows = np.array([k[0] for k in co], np.int64)
        cols = np.array([k[1] for k in co], np.int64)
        vals = np.array(list(co.values()), np.float32)
        logv = np.log(vals)
        weights = np.minimum(1.0, (vals / self.x_max) ** self.alpha) \
            .astype(np.float32)

        V, D = len(self.vocab), self.layer_size
        rng = np.random.default_rng(self.seed)
        dev = self.device
        w = torch.from_numpy(((rng.random((V, D)) - 0.5) / D)
                             .astype(np.float32)).to(dev)
        wc = torch.from_numpy(((rng.random((V, D)) - 0.5) / D)
                              .astype(np.float32)).to(dev)
        params = [w, wc, torch.zeros(V, device=dev),
                  torch.zeros(V, device=dev)]
        # AdaGrad accumulators
        accum = [torch.full_like(p, 1e-8) for p in params]
        rows_t = self._idx(rows)
        cols_t = self._idx(cols)
        logv_t = torch.from_numpy(logv).to(dev)
        wgt_t = torch.from_numpy(weights).to(dev)
        lr = self.learning_rate
        loss = None
        for _ in range(max(self.epochs, 1)):
            loss = glove_epoch_step(params, accum, rows_t, cols_t, logv_t,
                                    wgt_t, lr)
        logger.info("GloVe fit: %d cooccurrences, final loss %.4f",
                    len(vals), float(loss))
        # final embedding = w + context (GloVe convention)
        self.syn0 = (w + wc).cpu().numpy()
        self.syn1 = wc.cpu().numpy()
        self.bias_w = params[2].cpu().numpy()
        self.bias_c = params[3].cpu().numpy()
        return self
