"""Graph embeddings: DeepWalk + random walks (counterpart of
``deeplearning4j_tpu/nlp/deepwalk.py``: the walks are the JAX package's
host code, copied with the imports renamed, and the skip-gram trainer
is the port's ``SequenceVectors`` on ``device``).

Mirrors deeplearning4j-graph (graph/models/deepwalk/DeepWalk.java:31,95
fit(IGraph, walkLength); graph/iterator/RandomWalkIterator;
GraphHuffman): random walks over an adjacency structure feed the
SequenceVectors skip-gram trainer (hierarchical softmax available via
hs=True — the reference's GraphHuffman path).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["Graph", "DeepWalk", "Node2Vec"]


class Graph:
    """Minimal IGraph (deeplearning4j-graph api/IGraph semantics):
    vertices 0..n-1, directed or undirected edges."""

    def __init__(self, n_vertices: int, undirected: bool = True):
        self.n = n_vertices
        self.undirected = undirected
        self.adj: List[List[int]] = [[] for _ in range(n_vertices)]

    def add_edge(self, a: int, b: int):
        self.adj[a].append(b)
        if self.undirected:
            self.adj[b].append(a)

    def degree(self, v: int) -> int:
        return len(self.adj[v])


class DeepWalk:
    """(DeepWalk.java): uniform random walks → skip-gram."""

    def __init__(self, *, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 10,
                 learning_rate: float = 0.025, negative: int = 5,
                 hs: bool = False, epochs: int = 1, seed: int = 123,
                 batch_size: int = 256, device="cuda"):
        self.vector_size = vector_size
        self.window_size = window_size
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.seed = seed
        self._sv = SequenceVectors(
            layer_size=vector_size, window=window_size,
            negative=negative, hs=hs, learning_rate=learning_rate,
            min_word_frequency=1, subsampling=0.0, epochs=epochs,
            seed=seed, batch_size=batch_size, device=device)

    def _walks(self, graph: Graph, rng) -> List[List[str]]:
        walks = []
        for _ in range(self.walks_per_vertex):
            for start in rng.permutation(graph.n):
                walk = [int(start)]
                cur = int(start)
                for _ in range(self.walk_length - 1):
                    nbrs = graph.adj[cur]
                    if not nbrs:
                        break
                    cur = int(nbrs[rng.integers(0, len(nbrs))])
                    walk.append(cur)
                walks.append([str(v) for v in walk])
        return walks

    def fit(self, graph: Graph) -> "DeepWalk":
        rng = np.random.default_rng(self.seed)
        walks = self._walks(graph, rng)
        logger.info("DeepWalk: %d walks over %d vertices", len(walks),
                    graph.n)
        self._sv.fit(walks)
        return self

    def get_vertex_vector(self, v: int) -> Optional[np.ndarray]:
        return self._sv.get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, v: int, n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(v), n)]


class Node2Vec(DeepWalk):
    """node2vec (Grover & Leskovec): 2nd-order biased random walks with
    return parameter p and in-out parameter q over the DeepWalk trainer
    (the reference exposes Node2Vec atop SequenceVectors too)."""

    def __init__(self, *, p: float = 1.0, q: float = 1.0, **kw):
        super().__init__(**kw)
        self.p = p
        self.q = q

    def _walks(self, graph: Graph, rng) -> List[List[str]]:
        walks = []
        adj_sets = [set(a) for a in graph.adj]
        for _ in range(self.walks_per_vertex):
            for start in rng.permutation(graph.n):
                walk = [int(start)]
                prev = None
                cur = int(start)
                for _ in range(self.walk_length - 1):
                    nbrs = graph.adj[cur]
                    if not nbrs:
                        break
                    if prev is None:
                        nxt = int(nbrs[rng.integers(0, len(nbrs))])
                    else:
                        w = np.empty(len(nbrs))
                        for i, x in enumerate(nbrs):
                            if x == prev:
                                w[i] = 1.0 / self.p      # return
                            elif x in adj_sets[prev]:
                                w[i] = 1.0               # distance 1
                            else:
                                w[i] = 1.0 / self.q      # explore
                        w /= w.sum()
                        nxt = int(nbrs[rng.choice(len(nbrs), p=w)])
                    walk.append(nxt)
                    prev, cur = cur, nxt
                walks.append([str(v) for v in walk])
        return walks
