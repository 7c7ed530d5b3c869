"""Word vector serialization + bag-of-words/TF-IDF vectorizers.

(Counterpart of ``deeplearning4j_tpu/nlp/serializer.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors models/embeddings/loader/WordVectorSerializer.java (classic
word2vec text format: header 'V D', then 'word v1 v2 ...') and
bagofwords/vectorizer (BagOfWordsVectorizer, TfidfVectorizer).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

__all__ = ["write_word_vectors", "read_word_vectors",
           "BagOfWordsVectorizer", "TfidfVectorizer"]


def write_word_vectors(model, path: str) -> None:
    """word2vec .vec text format."""
    V, D = model.syn0.shape
    with open(path, "w") as f:
        f.write(f"{V} {D}\n")
        for i in range(V):
            word = model.vocab.word_at(i)
            vec = " ".join(f"{x:.6f}" for x in model.syn0[i])
            f.write(f"{word} {vec}\n")


def read_word_vectors(path: str):
    """Returns (VocabCache, np.ndarray) from .vec text format."""
    with open(path) as f:
        header = f.readline().split()
        V, D = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.zeros((V, D), np.float32)
        for i in range(V):
            parts = f.readline().rstrip("\n").split(" ")
            cache.add(VocabWord(parts[0], 1))
            vecs[i] = [float(x) for x in parts[1:D + 1]]
    return cache, vecs


class BagOfWordsVectorizer:
    """(bagofwords/vectorizer/BagOfWordsVectorizer.java)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency
        self.vocab: Optional[VocabCache] = None

    def fit(self, documents: Iterable[List[str]]):
        from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor
        self.vocab = VocabConstructor(
            self.min_word_frequency).build_joint_vocabulary(documents)
        return self

    def transform(self, document: List[str]) -> np.ndarray:
        v = np.zeros(len(self.vocab), np.float32)
        for tok in document:
            i = self.vocab.index_of(tok)
            if i >= 0:
                v[i] += 1.0
        return v

    def fit_transform(self, documents: List[List[str]]) -> np.ndarray:
        self.fit(documents)
        return np.stack([self.transform(d) for d in documents])


class TfidfVectorizer(BagOfWordsVectorizer):
    """(bagofwords/vectorizer/TfidfVectorizer.java): tf * log(N/df)."""

    def __init__(self, min_word_frequency: int = 1):
        super().__init__(min_word_frequency)
        self.idf: Optional[np.ndarray] = None

    def fit(self, documents: Iterable[List[str]]):
        documents = [list(d) for d in documents]
        super().fit(documents)
        df = np.zeros(len(self.vocab), np.float64)
        for d in documents:
            for i in {self.vocab.index_of(t) for t in d}:
                if i >= 0:
                    df[i] += 1
        n = len(documents)
        self.idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def transform(self, document: List[str]) -> np.ndarray:
        tf = super().transform(document)
        total = max(tf.sum(), 1.0)
        return (tf / total) * self.idf
