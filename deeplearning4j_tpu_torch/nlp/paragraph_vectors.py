"""ParagraphVectors (doc2vec) on torch (counterpart of
``deeplearning4j_tpu/nlp/paragraph_vectors.py``).

Mirrors models/paragraphvectors/ParagraphVectors.java: PV-DBOW (the
doc vector predicts words, learning/impl/sequence/DBOW.java) and PV-DM
(the doc vector and the context's mean predict the center, DM.java),
both by negative sampling. Document vectors live in a table of their
own; inferring a new document's vector freezes the word tables and
descends on that one vector (reference inferVector).

The step (``doc_step``) is a plain torch function on the tables'
device with its gradients written out, each table updated on the rows
the batch names (``word2vec._apply_rows``). Every random number is the
JAX package's numpy draw, in its order.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.word2vec import (SequenceVectors, _apply_rows,
                                                   _f32, _neg_sampling)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ParagraphVectors", "doc_step", "infer_step"]


def doc_step(docs, syn0, syn1, doc_idx, centers, contexts, negatives, lr):
    """One PV step (JAX ``_make_doc_step``): h is the doc row (DBOW,
    ``contexts`` None) or (doc + Σ context rows) / (1 + W) (DM, (B, W)
    contexts); negative sampling of the center on ``syn1``. Updates the
    tables in place (syn0 only under DM: DBOW gives it no gradient) and
    returns the loss."""
    d = docs[doc_idx]                                     # (B, D)
    if contexts is not None:
        ctx = syn0[contexts]                              # (B, W, D)
        scale = 1 + ctx.shape[1]
        h = (d + torch.sum(ctx, dim=1)) / scale
    else:
        h = d
    loss, gh, gpos, gneg = _neg_sampling(h, syn1, centers, negatives)
    if contexts is not None:
        gd = gh / scale
        W = contexts.shape[1]
        _apply_rows(syn0, contexts.reshape(-1),
                    gd[:, None, :].expand(-1, W, -1).reshape(-1, gd.shape[1]),
                    lr)
    else:
        gd = gh
    _apply_rows(docs, doc_idx, gd, lr)
    _apply_rows(syn1, torch.cat([centers, negatives.reshape(-1)]),
                torch.cat([gpos, gneg.reshape(-1, gneg.shape[-1])]), lr)
    return loss


def infer_step(v, syn1, centers, negatives, lr):
    """One inference step on the doc vector ``v`` (D,) with ``syn1``
    frozen: the loss is a MEAN over the document's words (JAX
    ``infer_step``); returns the new ``v``."""
    pos = syn1[centers]                                   # (n, D)
    neg = syn1[negatives]                                 # (n, K, D)
    n = centers.shape[0]
    gp = -torch.sigmoid(-(pos @ v)) / n
    gn = torch.sigmoid(torch.einsum("nkd,d->nk", neg, v)) / n
    g = gp @ pos + torch.einsum("nk,nkd->d", gn, neg)
    return v - lr * g


class ParagraphVectors(SequenceVectors):
    def __init__(self, *, dm: bool = False, **kw):
        super().__init__(**kw)
        self.dm = dm
        self.doc_vectors: Optional[np.ndarray] = None
        self.doc_labels: List[str] = []
        self._label_index: Dict[str, int] = {}

    def _doc_pairs(self, documents):
        """(doc index, center, DM context or None) a word, in JAX's
        order; the DM context is the window's words repeated to
        ``window`` ids."""
        pairs = []
        for di, doc in enumerate(documents):
            idxs = [self.vocab.index_of(t) for t in doc]
            idxs = [i for i in idxs if i >= 0]
            for pos, center in enumerate(idxs):
                if self.dm:
                    lo = max(0, pos - self.window)
                    hi = min(len(idxs), pos + self.window + 1)
                    ctx = [idxs[j] for j in range(lo, hi) if j != pos]
                    if not ctx:
                        continue
                    ctx = (ctx * self.window)[:self.window]
                    pairs.append((di, center, ctx))
                else:
                    pairs.append((di, center, None))
        return pairs

    def fit_documents(self, documents: Sequence, labels=None):
        """documents: list of token lists; labels default doc_0..n."""
        documents = [list(d) for d in documents]
        labels = (list(labels) if labels is not None
                  else [f"doc_{i}" for i in range(len(documents))])
        self.doc_labels = labels
        self._label_index = {l: i for i, l in enumerate(labels)}
        self.build_vocab(documents)
        rng = np.random.default_rng(self.seed)
        D = self.layer_size
        self.doc_vectors = ((rng.random((len(documents), D)) - 0.5)
                            / D).astype(np.float32)
        pairs = self._doc_pairs(documents)
        doc_idx = np.array([p[0] for p in pairs], np.int64)
        centers = np.array([p[1] for p in pairs], np.int64)
        ctxs = (np.array([p[2] for p in pairs], np.int64).reshape(
            len(pairs), self.window) if self.dm else None)

        syn0, syn1 = self._tables()
        docs = torch.tensor(self.doc_vectors, device=self.device)
        doc_idx, centers = self._idx(doc_idx), self._idx(centers)
        if self.dm:
            ctxs = self._idx(ctxs)
        B = min(self.batch_size, max(1, len(pairs)))
        total_steps = max(1, len(pairs) * self.epochs // B)
        step_i = 0
        for _ in range(self.epochs):
            if not pairs:
                continue
            order, negs = self._epoch(len(pairs), B, rng)
            for i in range(order.shape[0]):
                sel = order[i]
                doc_step(docs, syn0, syn1, doc_idx[sel], centers[sel],
                         ctxs[sel] if self.dm else None, negs[i],
                         self._lr(step_i, total_steps))
                step_i += 1
        self.syn0 = syn0.cpu().numpy()
        self.syn1 = syn1.cpu().numpy()
        self.doc_vectors = docs.cpu().numpy()
        return self

    # ------------------------------------------------------------- queries
    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        return None if i is None else self.doc_vectors[i]

    def infer_vector(self, tokens: List[str], steps: int = 50,
                     lr: float = 0.05) -> np.ndarray:
        """Infer an unseen document's vector with the word tables
        frozen (reference inferVector); the rate decays linearly over
        ``steps``."""
        idxs = [self.vocab.index_of(t) for t in tokens]
        idxs = [i for i in idxs if i >= 0]
        if not idxs:
            return np.zeros(self.layer_size, np.float32)
        rng = np.random.default_rng(self.seed)
        v = torch.from_numpy(((rng.random(self.layer_size) - 0.5)
                              / self.layer_size).astype(np.float32)).to(
            self.device)
        syn1 = torch.from_numpy(self.syn1).to(self.device)
        centers = self._idx(idxs)
        # every step's negatives in one draw: the numbers of one a step
        negs = self._idx(self._negatives(rng, steps * len(idxs))).view(
            steps, len(idxs), self.negative)
        for s in range(steps):
            v = infer_step(v, syn1, centers, negs[s],
                           _f32(lr * (1 - s / steps)))
        return v.cpu().numpy()

    def similarity_to_label(self, tokens: List[str], label: str) -> float:
        d = self.get_doc_vector(label)
        if d is None:
            return float("nan")       # matches similarity() on unknowns
        v = self.infer_vector(tokens)
        denom = np.linalg.norm(v) * np.linalg.norm(d)
        return float(v @ d / denom) if denom else 0.0
