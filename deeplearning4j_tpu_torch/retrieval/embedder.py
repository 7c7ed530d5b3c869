"""Batched on-device text -> vector encoding over a Word2Vec vocab
(counterpart of ``deeplearning4j_tpu/retrieval/embedder.py``).

The query-side half of the retrieval subsystem: texts tokenize on the
host (the same ``DefaultTokenizerFactory`` SPI the Word2Vec trainer
uses), pack into fixed-shape ``(B, 2, L)`` id+mask tensors, and the
embedding itself (table lookup, masked mean-pool, optional unit
normalization) runs as torch ops on the embedder's ``device`` over the
whole batch, where the JAX package runs one jitted op.

The packed tensor IS the serving wire format: a ``TextEmbedder``
registers in the ``ModelRegistry`` like any predict model (it exposes
``.output``), so ``/v1/embed`` resolves it through
``resolve_serving_model`` and batches it through the ordinary
``BatchScheduler``: deadlines, tiers, chaos and all. Sequence
lengths pad to pow2 buckets (capped at ``max_tokens``), as in the JAX
package, so both pack the same wire tensor.

``from_word2vec`` adapts a trained Word2Vec / ParagraphVectors (its
vocab, ``syn0`` and tokenizer); the ``TextEmbedder(vocab, table)``
constructor is the path the CLI uses.

Out-of-vocabulary tokens drop out of the mean (mask 0); an all-OOV or
empty text embeds to the zero vector, which cosine search scores
-inf-equivalently (zero dot against every unit row).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.retrieval.index import pow2_bucket

__all__ = ["TextEmbedder"]

# shortest padded token length: tiny queries share one compiled shape
_MIN_TOKENS = 8


def _mean_pool(table: torch.Tensor, packed: torch.Tensor,
               normalize: bool) -> torch.Tensor:
    """packed (B, 2, L): row 0 token indices (float storage), row 1
    the validity mask. Returns (B, D) mean-pooled embeddings."""
    ids = packed[:, 0, :].to(torch.int64)
    mask = packed[:, 1, :]
    vecs = table[ids] * mask[..., None]
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    out = torch.sum(vecs, dim=1) / denom
    if normalize:
        norm = torch.linalg.vector_norm(out, dim=1, keepdim=True)
        out = out / torch.clamp(norm, min=1e-12)
    return out


class TextEmbedder:
    """Mean-pooled word-vector encoder behind the predict-model shape.

    ``vocab`` is either a ``VocabCache`` (the Word2Vec family's) or a
    plain ``{token: row}`` dict; ``vectors`` the (V, D) embedding
    table those rows index, held on ``device`` (default ``"cuda"``).
    """

    def __init__(self, vocab, vectors,
                 normalize: bool = True,
                 max_tokens: int = 64,
                 tokenizer_factory=None, device="cuda"):
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[0] < 1:
            raise ValueError(
                f"vectors must be a (V, D) table; got {vectors.shape}")
        if hasattr(vocab, "index_of"):
            self._index_of = vocab.index_of
            self._vocab_size = len(vocab)
        elif isinstance(vocab, dict):
            self._index_of = lambda tok: vocab.get(tok, -1)
            self._vocab_size = len(vocab)
        else:
            raise TypeError(
                "vocab must be a VocabCache-like (index_of) or a "
                f"token->row dict; got {type(vocab).__name__}")
        if self._vocab_size > vectors.shape[0]:
            raise ValueError(
                f"vocab has {self._vocab_size} entries but the table "
                f"only {vectors.shape[0]} rows")
        self.dim = int(vectors.shape[1])
        self.normalize = bool(normalize)
        self.max_tokens = int(max_tokens)
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be positive")
        self.device = resolve_device(device)
        self._table = torch.from_numpy(np.ascontiguousarray(vectors)).to(
            self.device)
        self._tokenizer = tokenizer_factory or DefaultTokenizerFactory()

    @classmethod
    def from_word2vec(cls, w2v, **kwargs) -> "TextEmbedder":
        """Adapt a trained SequenceVectors (Word2Vec /
        ParagraphVectors): its vocab + syn0 + tokenizer, on the model's
        device unless ``device`` says otherwise."""
        kwargs.setdefault("tokenizer_factory",
                          getattr(w2v, "_tokenizer", None))
        kwargs.setdefault("device", getattr(w2v, "device", "cuda"))
        return cls(w2v.vocab, np.asarray(w2v.syn0), **kwargs)

    # ---- host side: tokenize + pack ----
    def encode(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """Pack texts into the (B, 2, L_pad) float32 wire tensor the
        device pool consumes: this is what a /v1/embed or text
        /v1/search request submits to the scheduler."""
        if isinstance(texts, str):
            texts = [texts]
        rows: List[List[int]] = []
        for text in texts:
            if not isinstance(text, str):
                raise ValueError(
                    "texts must be strings; got "
                    f"{type(text).__name__}")
            toks = self._tokenizer.create(text).get_tokens()
            ids = [self._index_of(t) for t in toks]
            ids = [i for i in ids if i >= 0][:self.max_tokens]
            rows.append(ids)
        width = max((len(r) for r in rows), default=0)
        l_pad = min(pow2_bucket(max(width, 1), lo=_MIN_TOKENS),
                    pow2_bucket(self.max_tokens))
        packed = np.zeros((len(rows), 2, l_pad), np.float32)
        for b, ids in enumerate(rows):
            n = min(len(ids), l_pad)
            packed[b, 0, :n] = ids[:n]
            packed[b, 1, :n] = 1.0
        return packed

    # ---- device side: the serving-model contract ----
    def output(self, packed) -> torch.Tensor:
        """(B, 2, L) packed ids+mask -> (B, D) embeddings on the
        embedder's device. This is the method BatchScheduler batches;
        encode() keeps L bucketed."""
        if isinstance(packed, torch.Tensor):
            packed = packed.to(self.device, torch.float32)
        else:
            packed = torch.from_numpy(np.ascontiguousarray(
                packed, np.float32)).to(self.device)
        if packed.ndim != 3 or packed.shape[1] != 2:
            raise ValueError(
                "embedder input must be (B, 2, L) packed ids+mask "
                f"from encode(); got {tuple(packed.shape)}")
        # clamp: padded/junk ids must stay inside the table (their
        # mask is 0 so the value never contributes)
        ids = torch.clamp(packed[:, 0, :], 0, self._table.shape[0] - 1)
        packed = torch.stack([ids, packed[:, 1, :]], dim=1)
        return _mean_pool(self._table, packed, self.normalize)

    def embed(self, texts: Union[str, Sequence[str]]) -> np.ndarray:
        """encode + pool in one host call (the non-serving path:
        tests, index build, oracle computation)."""
        return self.output(self.encode(texts)).cpu().numpy()

    # ---- introspection ----
    def __len__(self) -> int:
        return self._vocab_size

    def info(self) -> dict:
        return {"dim": self.dim, "vocab": self._vocab_size,
                "normalize": self.normalize,
                "max_tokens": self.max_tokens}
