"""Vocabulary construction + Huffman coding.

(Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors models/word2vec/wordstore/VocabConstructor.java:167
(buildJointVocabulary: count, prune by minWordFrequency) +
AbstractCache and models/word2vec/Huffman.java (binary Huffman tree
over word frequencies, producing per-word codes/paths for hierarchical
softmax).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["VocabWord", "VocabCache", "VocabConstructor", "Huffman"]


class VocabWord:
    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word: str, count: int = 0, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.codes: List[int] = []
        self.points: List[int] = []


class VocabCache:
    """(AbstractCache.java): index ↔ word ↔ frequency."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_count = 0

    def add(self, vw: VocabWord):
        vw.index = len(self.words)
        self.words.append(vw)
        self._by_word[vw.word] = vw

    def __len__(self):
        return len(self.words)

    def __contains__(self, w: str):
        return w in self._by_word

    def word_for(self, w: str) -> Optional[VocabWord]:
        return self._by_word.get(w)

    def index_of(self, w: str) -> int:
        vw = self._by_word.get(w)
        return -1 if vw is None else vw.index

    def word_at(self, i: int) -> str:
        return self.words[i].word

    def frequencies(self) -> np.ndarray:
        return np.array([w.count for w in self.words], np.float64)


class VocabConstructor:
    """(VocabConstructor.java:31)."""

    def __init__(self, min_word_frequency: int = 5,
                 stop_words: Iterable[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)

    def build_joint_vocabulary(self, token_sequences) -> VocabCache:
        counts: Dict[str, int] = {}
        total = 0
        for seq in token_sequences:
            for tok in seq:
                if tok in self.stop_words:
                    continue
                counts[tok] = counts.get(tok, 0) + 1
                total += 1
        cache = VocabCache()
        # descending frequency, ties alphabetical: stable indexing
        for word, c in sorted(counts.items(), key=lambda kv: (-kv[1],
                                                              kv[0])):
            if c >= self.min_word_frequency:
                cache.add(VocabWord(word, c))
        cache.total_count = total
        return cache


class Huffman:
    """(models/word2vec/Huffman.java): assigns binary codes + inner-node
    paths to each vocab word for hierarchical softmax. Inner nodes are
    numbered 0..V-2; word w's ``points`` are the inner nodes on its
    root→leaf path, ``codes`` the branch bits."""

    MAX_CODE_LENGTH = 40

    def __init__(self, cache: VocabCache):
        self.cache = cache
        self.build()

    def build(self):
        V = len(self.cache)
        if V == 0:
            return
        # heap of (count, tiebreak, node_id); leaves 0..V-1, inner V..2V-2
        heap = [(w.count, i, i) for i, w in enumerate(self.cache.words)]
        heapq.heapify(heap)
        parent = {}
        code_of = {}
        next_id = V
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_id
            parent[n2] = next_id
            code_of[n1] = 0
            code_of[n2] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, w in enumerate(self.cache.words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(code_of[node])
                node = parent[node]
                points.append(node - V)    # inner-node index 0..V-2
            codes.reverse()
            points.reverse()
            w.codes = codes[:self.MAX_CODE_LENGTH]
            w.points = points[:self.MAX_CODE_LENGTH]

    def padded_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(points, codes, mask) as (V, L) int arrays padded to the max
        path length — ready for a batched hierarchical-softmax kernel."""
        V = len(self.cache)
        L = max((len(w.codes) for w in self.cache.words), default=1)
        points = np.zeros((V, L), np.int32)
        codes = np.zeros((V, L), np.float32)
        mask = np.zeros((V, L), np.float32)
        for i, w in enumerate(self.cache.words):
            n = len(w.codes)
            points[i, :n] = w.points
            codes[i, :n] = w.codes
            mask[i, :n] = 1.0
        return points, codes, mask
