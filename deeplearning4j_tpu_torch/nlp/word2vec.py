"""Word2Vec / SequenceVectors on torch (counterpart of
``deeplearning4j_tpu/nlp/word2vec.py``).

Mirrors models/sequencevectors/SequenceVectors.java:192 (fit ->
buildVocab -> train) with SkipGram/CBOW elements, negative sampling and
hierarchical softmax, lookup tables (InMemoryLookupTable) and the
Word2Vec builder facade (models/word2vec/Word2Vec.java:621).

As in the JAX package, a step trains a whole batch of (center, context,
negatives) pairs at once: gathers, a (B, K+1) block of dot products,
sigmoid cross-entropy SUMMED over the batch, and each table row moved
by ``lr`` times its total gradient over the batch, clipped to norm 5
(``clip_rows``). The JAX package leaves the step to XLA; here each step
is a plain torch function on the tables' device (cuBLAS and the
gather / scatter ops on a card), with its gradients written out. The
update touches only the rows the batch names: the row ids are sorted
once, each occurrence's gradient is summed into its row's slot
(``index_add_``), the slot is clipped, and ``-lr`` times it is added to
the row. Every size is the batch's, so a step never synchronizes with
the host, and a row the batch does not name stays bit-unchanged, as in
the JAX package's dense update of a zero gradient.

Every random number is drawn on the host with numpy, in the JAX
package's order: the syn0 init, the subsampling draws, the dynamic
window, the permutation, the negatives. The pair and CBOW streams are
built with a few numpy calls a sentence instead of a few a token; the
draws stay the same calls in the same order (one ``random`` per
in-vocabulary token, then one ``integers`` per kept token), so the same
seed gives the same pairs, batches and negatives.

After ``fit``, ``syn0`` and ``syn1`` are numpy float32 arrays, as in
the JAX package. The queries (``words_nearest_batch``) run on the
model's device: cosine by ``torch.matmul`` over a chunk of queries,
then ``topk``.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.tokenization import (DefaultTokenizerFactory,
                                                       SentenceIterator)
from deeplearning4j_tpu_torch.nlp.vocab import (Huffman, VocabCache,
                                                VocabConstructor, VocabWord)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["SequenceVectors", "Word2Vec", "vectors_from_jax", "clip_rows",
           "ns_step", "hs_step", "cbow_step"]


def clip_rows(g: torch.Tensor, max_norm: float = 5.0) -> torch.Tensor:
    """Per-row gradient clip (JAX ``_clip_rows``): a batched step sums
    the updates of every occurrence of a word, so frequent rows of a
    small vocabulary can get O(batch) gradients."""
    n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    return g * torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)


def _apply_rows(table: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor,
                lr: float, group=None, local=None) -> None:
    """``table[r] -= lr * clip_rows(sum of grads at r)`` for every row
    ``r`` of ``idx`` (the batch's row ids, every rank's), in place.

    ``grads`` are one row a position of ``idx``, or, with ``local``, of
    ``idx[local]`` only (this rank's part of the batch); the slots are
    then summed over ``group`` before the clip. The slots are as many as
    ``idx`` has positions; those past the distinct rows stay zero and
    add -0.0, which leaves a row as it is, to the batch's rows at their
    own positions of the sorted ids (spread out: on a card, thousands of
    them on one row would queue on its atomics)."""
    s, perm = torch.sort(idx)
    new = torch.ones_like(s, dtype=torch.bool)
    new[1:] = s[1:] != s[:-1]
    slot_sorted = torch.cumsum(new, 0) - 1
    slot = torch.empty_like(slot_sorted)
    slot[perm] = slot_sorted
    rows = s.clone().scatter_(0, slot_sorted, s)
    g = torch.zeros((idx.numel(), table.shape[1]), dtype=table.dtype,
                    device=table.device)
    g.index_add_(0, slot if local is None else slot[local], grads)
    if group is not None:
        from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_
        all_reduce_(g, group, kind="dp")
    # t + (-(lr * g)) is t - lr * g bit for bit
    table.index_add_(0, rows, clip_rows(g) * -lr)


def _neg_sampling(h, syn1, centers, negatives):
    """Loss and gradients of -log σ(h·pos) - Σ log σ(-h·neg), summed:
    (loss, dL/dh, dL/dpos rows, dL/dneg rows)."""
    pos = syn1[centers]                                   # (B, D)
    neg = syn1[negatives]                                 # (B, K, D)
    pos_score = torch.sum(h * pos, dim=-1)
    neg_score = torch.einsum("bd,bkd->bk", h, neg)
    loss = (torch.sum(F.softplus(-pos_score))
            + torch.sum(F.softplus(neg_score)))
    gp = -torch.sigmoid(-pos_score)                       # d/d pos_score
    gn = torch.sigmoid(neg_score)
    gh = gp[:, None] * pos + torch.einsum("bk,bkd->bd", gn, neg)
    return loss, gh, gp[:, None] * h, gn[..., None] * h[:, None, :]


def _hier_softmax(h, syn1, points, codes, mask, words):
    """Loss and gradients of Σ (softplus(s) - code·s) over each word's
    Huffman path (masked), s = h·node: (loss, dL/dh, node ids, dL/d
    node rows)."""
    pts = points[words]                                   # (B, L)
    cds = codes[words]
    msk = mask[words]
    node = syn1[pts]                                      # (B, L, D)
    scores = torch.einsum("bd,bld->bl", h, node)
    loss = torch.sum((F.softplus(scores) - cds * scores) * msk)
    gs = (torch.sigmoid(scores) - cds) * msk
    gh = torch.einsum("bl,bld->bd", gs, node)
    return loss, gh, pts, gs[..., None] * h[:, None, :]


def _local(part, device, width: int = 1):
    """Positions of rows ``part`` = (lo, hi) of a batch flattened
    ``width`` ids a row; None for the whole batch."""
    if part is None:
        return None
    lo, hi = part
    return torch.arange(lo * width, hi * width, device=device)


def ns_step(syn0, syn1, centers, contexts, negatives, lr, *, group=None,
            part=None):
    """Skip-gram with negative sampling (JAX ``_make_ns_step``): updates
    ``syn0`` and ``syn1`` in place, returns the loss (a device scalar).
    ``centers``, ``contexts`` (B,) and ``negatives`` (B, K) are the whole
    batch; with ``part`` = (lo, hi) this rank computes rows lo:hi and
    the gradients are summed over ``group``."""
    B, K = negatives.shape
    lo, hi = part or (0, B)
    c = syn0[centers[lo:hi]]
    loss, gc, gpos, gneg = _neg_sampling(c, syn1, contexts[lo:hi],
                                         negatives[lo:hi])
    dev = syn0.device
    local1 = None
    if part is not None:
        local1 = torch.cat([_local(part, dev),
                            B + _local(part, dev, K)])
    _apply_rows(syn0, centers, gc, lr, group, _local(part, dev))
    _apply_rows(syn1, torch.cat([contexts, negatives.reshape(-1)]),
                torch.cat([gpos, gneg.reshape(-1, gneg.shape[-1])]), lr,
                group, local1)
    return loss


def hs_step(syn0, syn1, hs, centers, contexts, lr, *, group=None,
            part=None):
    """Skip-gram with hierarchical softmax (JAX ``_make_hs_step``) over
    ``hs`` = (points, codes, mask) device tensors, (V, L) each; in
    place, returns the loss."""
    B = centers.shape[0]
    lo, hi = part or (0, B)
    c = syn0[centers[lo:hi]]
    loss, gc, pts, gnode = _hier_softmax(c, syn1, *hs, contexts[lo:hi])
    dev = syn0.device
    L = hs[0].shape[1]
    all_pts = hs[0][contexts].reshape(-1)
    _apply_rows(syn0, centers, gc, lr, group, _local(part, dev))
    _apply_rows(syn1, all_pts, gnode.reshape(-1, gnode.shape[-1]), lr,
                group, _local(part, dev, L))
    return loss


def cbow_step(syn0, syn1, contexts, ctx_mask, centers, negatives, lr,
              hs=None):
    """CBOW (JAX ``_make_cbow_step``): the masked mean of the (B, 2W)
    context rows predicts the center word, by negative sampling on
    ``syn1`` or, with ``hs``, hierarchical softmax on the center's
    path; in place, returns the loss."""
    ctx = syn0[contexts]                                  # (B, 2W, D)
    denom = torch.clamp(torch.sum(ctx_mask, dim=1, keepdim=True), min=1.0)
    h = torch.sum(ctx * ctx_mask[..., None], dim=1) / denom
    if hs is not None:
        loss, gh, pts, gnode = _hier_softmax(h, syn1, *hs, centers)
        idx1, g1 = pts.reshape(-1), gnode.reshape(-1, gnode.shape[-1])
    else:
        loss, gh, gpos, gneg = _neg_sampling(h, syn1, centers, negatives)
        idx1 = torch.cat([centers, negatives.reshape(-1)])
        g1 = torch.cat([gpos, gneg.reshape(-1, gneg.shape[-1])])
    gctx = (gh / denom)[:, None, :] * ctx_mask[..., None]
    _apply_rows(syn0, contexts.reshape(-1),
                gctx.reshape(-1, gctx.shape[-1]), lr)
    _apply_rows(syn1, idx1, g1, lr)
    return loss


def _data_group(mesh):
    """The :class:`RankGroup` over ``mesh``'s data axis through this
    rank (None when the mesh is one rank with no process group)."""
    from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
    from deeplearning4j_tpu_torch.parallel.mesh import _rank
    g, h, ranks = mesh.axis_group(["data"])
    if len(ranks) == mesh.size:
        g, h = mesh.group, mesh.host_group
    if g is None:
        return None
    return RankGroup(g, h, ranks, ranks.index(_rank()), mesh.backend)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX step receives its lr."""
    return float(np.float32(x))


class SequenceVectors:
    """Generic embedding trainer over element sequences
    (SequenceVectors.java). ``device`` (default ``"cuda"``) holds the
    tables while they train and the queries' unit rows."""

    def __init__(self, *, layer_size: int = 100, window: int = 5,
                 negative: int = 5, hs: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 min_word_frequency: int = 5, subsampling: float = 1e-3,
                 epochs: int = 1, batch_size: int = 512, seed: int = 123,
                 stop_words: Iterable[str] = (),
                 algorithm: str = "skipgram", device="cuda"):
        if algorithm not in ("skipgram", "cbow"):
            raise ValueError(f"Unknown algorithm '{algorithm}'")
        self.algorithm = algorithm
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.hs = hs
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.min_word_frequency = min_word_frequency
        self.subsampling = subsampling
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.stop_words = stop_words
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None
        self.syn1: Optional[np.ndarray] = None
        self._unigram_table: Optional[np.ndarray] = None
        self._hs_arrays = None

    # -------------------------------------------------------------- vocab
    def build_vocab(self, sequences: List[List[str]]):
        self.vocab = VocabConstructor(
            self.min_word_frequency,
            self.stop_words).build_joint_vocabulary(sequences)
        if len(self.vocab) == 0:
            raise ValueError("Empty vocabulary (check minWordFrequency)")
        rng = np.random.default_rng(self.seed)
        V, D = len(self.vocab), self.layer_size
        self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        self.syn1 = np.zeros((V, D), np.float32)
        self._tables_from_vocab()

    def _tables_from_vocab(self):
        """The negative-sampling unigram^0.75 table (float64) and, with
        ``hs``, the Huffman arrays, from the vocab's counts."""
        probs = self.vocab.frequencies() ** 0.75
        self._unigram_table = (probs / probs.sum()).astype(np.float64)
        if self.hs:
            self._hs_arrays = Huffman(self.vocab).padded_arrays()

    def _hs_tensors(self):
        points, codes, mask = self._hs_arrays
        dev = self.device
        return (torch.from_numpy(points.astype(np.int64)).to(dev),
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(mask).to(dev))

    # ------------------------------------------------------------ training
    def _kept(self, sequences, rng: np.random.Generator):
        """Per sequence, the (in-vocab, kept by subsampling) indices: one
        ``rng.random()`` per in-vocab token in order, as JAX's
        ``i >= 0 and rng.random() < keep_prob[i]`` draws them."""
        vocab = self.vocab
        freqs = vocab.frequencies()
        total = max(freqs.sum(), 1.0)
        keep_prob = np.ones(len(vocab))
        if self.subsampling > 0:
            f = freqs / total
            keep_prob = np.minimum(
                1.0, (np.sqrt(f / self.subsampling) + 1)
                * self.subsampling / np.maximum(f, 1e-12))
        index_of = vocab.index_of
        for seq in sequences:
            ids = np.fromiter((index_of(t) for t in seq), np.int64,
                              len(seq))
            ids = ids[ids >= 0]
            if len(ids):
                ids = ids[rng.random(len(ids)) < keep_prob[ids]]
            yield ids

    @staticmethod
    def _windows(seqs, W: int):
        """Every token of ``seqs`` (a list of index arrays) with its
        window: (tokens (N,), offsets (2W,) ascending, in-sequence mask
        (N, 2W), the neighbours' token ids (N, 2W); 0 where masked)."""
        lens = np.array([len(s) for s in seqs], np.int64)
        tok = (np.concatenate(seqs) if len(seqs)
               else np.zeros(0, np.int64))
        N = len(tok)
        starts = np.repeat(np.cumsum(lens) - lens, lens)
        pos = np.arange(N) - starts
        n = np.repeat(lens, lens)
        offs = np.array([o for o in range(-W, W + 1) if o != 0], np.int64)
        j = pos[:, None] + offs[None, :]
        inside = (j >= 0) & (j < n[:, None])
        nb = np.where(inside, tok[np.clip(np.arange(N)[:, None] + offs,
                                          0, max(N - 1, 0))], 0)
        return tok, offs, inside, nb

    def _training_pairs(self, sequences, rng: np.random.Generator):
        """(center, context) index pairs, (P, 2) int64, with the dynamic
        window and frequency subsampling (SkipGram.learnSequence): the
        JAX generator's pairs in its order, from the same draws."""
        W = self.window
        seqs, bs = [], []
        for ids in self._kept(sequences, rng):
            seqs.append(ids)
            bs.append(rng.integers(1, W + 1, size=len(ids)) if len(ids)
                      else np.zeros(0, np.int64))
        tok, offs, inside, nb = self._windows(seqs, W)
        if not len(tok):
            return np.zeros((0, 2), np.int64)
        b = np.concatenate(bs)
        valid = inside & (np.abs(offs)[None, :] <= b[:, None])
        centers = np.broadcast_to(tok[:, None], valid.shape)[valid]
        return np.stack([centers, nb[valid]], axis=1)

    def _cbow_batches(self, sequences, rng):
        """(contexts (N, 2W) int64, mask (N, 2W) float32, centers (N,)):
        each kept token's window packed to the left, as JAX's rows;
        tokens with an empty window dropped. The same subsampling draws
        as the skip-gram path."""
        W = self.window
        tok, offs, inside, nb = self._windows(
            list(self._kept(sequences, rng)), W)
        order = np.argsort(~inside, axis=1, kind="stable")
        ctx = np.take_along_axis(nb, order, axis=1)
        mask = np.take_along_axis(inside, order, axis=1)
        keep = mask.any(axis=1)
        return (ctx[keep], mask[keep].astype(np.float32), tok[keep])

    def _tables(self):
        """syn0 and syn1 as float32 tensors on the device (copies)."""
        return (torch.tensor(self.syn0, device=self.device),
                torch.tensor(self.syn1, device=self.device))

    def _idx(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    def _negatives(self, rng, n: int) -> np.ndarray:
        return rng.choice(len(self.vocab), size=(n, self.negative),
                          p=self._unigram_table)

    def _lr(self, step_i: int, total_steps: int) -> float:
        return _f32(max(self.min_learning_rate,
                        self.learning_rate * (1 - step_i / total_steps)))

    def _epoch(self, n: int, B: int, rng, negatives: bool = True):
        """One epoch's draws, as the JAX loop makes them: the
        permutation of the ``n`` examples (wrapped to one batch when
        ``n < B``), then each step's (B, K) negatives. The steps' draws
        are one ``choice`` call here, which gives the numbers of one call
        a step. Returns (the order, the negatives or None) on the
        device: the steps then slice them there, with no copy from the
        host and no wait for the card."""
        order = rng.permutation(n)
        if n < B:
            # tiny corpora: wrap-pad to one full batch
            order = np.resize(order, B)
        steps = len(order) // B
        negs = self._negatives(rng, steps * B) if negatives else None
        return self._idx(order[:steps * B]).view(steps, B), (
            None if negs is None else
            self._idx(negs).view(steps, B, self.negative))

    def sg_batches(self, pairs: np.ndarray, rng):
        """One skip-gram epoch over ``pairs`` (from ``_training_pairs``):
        (centers, contexts, negatives or None under ``hs``) device
        tensors a step, the JAX loop's batches from the same draws."""
        order, negs = self._epoch(len(pairs), self.batch_size, rng,
                                  not self.hs)
        pairs_t = self._idx(pairs)
        for i in range(order.shape[0]):
            sel = pairs_t[order[i]]
            yield sel[:, 0], sel[:, 1], None if negs is None else negs[i]

    def _fit_cbow(self, sequences):
        rng = np.random.default_rng(self.seed + 1)
        hs = self._hs_tensors() if self.hs else None
        syn0, syn1 = self._tables()
        B = self.batch_size
        ctxs, masks, centers = self._cbow_batches(sequences, rng)
        n = len(centers)
        if n == 0:
            raise ValueError("No CBOW training examples")
        ctxs, centers = self._idx(ctxs), self._idx(centers)
        masks = torch.from_numpy(masks).to(self.device)
        total_steps = max(1, n * self.epochs // B)
        step_i = 0
        for _ in range(self.epochs):
            order, negs = self._epoch(n, B, rng)    # JAX draws them under hs too
            for i in range(order.shape[0]):
                sel = order[i]
                cbow_step(syn0, syn1, ctxs[sel], masks[sel], centers[sel],
                          negs[i], self._lr(step_i, total_steps), hs)
                step_i += 1
        self.syn0 = syn0.cpu().numpy()
        self.syn1 = syn1.cpu().numpy()
        return self

    def fit(self, sequences: List[List[str]], mesh=None):
        """Train. With ``mesh`` (the port's ``parallel.mesh.Mesh`` with a
        data axis; every rank calls ``fit`` on the same sequences) each
        rank computes its contiguous part of every batch, the gradient
        slots are summed over the data axis
        (``collectives.all_reduce_``), clipped, and applied on every
        rank: the single-device result up to summation order. The
        counterpart of JAX's batch sharded over the mesh (and of the
        reference's Spark Word2Vec / TextPipeline)."""
        if self.vocab is None:
            self.build_vocab(sequences)
        if self.algorithm == "cbow":
            return self._fit_cbow(sequences)
        rng = np.random.default_rng(self.seed + 1)
        hs = self._hs_tensors() if self.hs else None
        syn0, syn1 = self._tables()
        group = part = None
        if mesh is not None:
            ndata = mesh.shape["data"]
            if self.batch_size % ndata:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by "
                    f"mesh data axis {ndata}")
            group = _data_group(mesh)
            b = self.batch_size // ndata
            i = mesh.coords()["data"]
            part = (i * b, (i + 1) * b)
        pairs = self._training_pairs(sequences, rng)
        total_steps = max(1, (len(pairs) * self.epochs) // self.batch_size)
        step_i = 0
        loss = None
        for ep in range(self.epochs):
            if ep > 0:
                pairs = self._training_pairs(sequences, rng)
            if not len(pairs):
                continue
            for centers, contexts, negs in self.sg_batches(pairs, rng):
                lr = self._lr(step_i, total_steps)
                if self.hs:
                    loss = hs_step(syn0, syn1, hs, centers, contexts, lr,
                                   group=group, part=part)
                else:
                    loss = ns_step(syn0, syn1, centers, contexts, negs, lr,
                                   group=group, part=part)
                step_i += 1
        self.syn0 = syn0.cpu().numpy()
        self.syn1 = syn1.cpu().numpy()
        if loss is not None:
            logger.info("SequenceVectors fit done: %d steps, loss %.4f",
                        step_i, float(loss))
        return self

    # ------------------------------------------------------------- queries
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def _unit_syn0(self) -> torch.Tensor:
        """Row-normalized vectors on the device, cached (and invalidated
        when syn0's identity changes: training replaces the array)."""
        cached = getattr(self, "_unit_cache", None)
        if cached is not None and cached[0] is self.syn0:
            return cached[1]
        t = torch.from_numpy(np.ascontiguousarray(self.syn0)).to(
            self.device)
        norms = torch.linalg.vector_norm(t, dim=1, keepdim=True)
        unit = t / torch.clamp(norms, min=1e-12)
        self._unit_cache = (self.syn0, unit)
        return unit

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        return self.words_nearest_batch([word], n=n)[0]

    def words_nearest_batch(self, words: List[str], n: int = 10,
                            chunk: int = 1024) -> List[List[str]]:
        """Top-n neighbours (self excluded) for many query words: a
        (chunk, V) block of cosines at a time on the device, then
        ``topk``; an unknown word gets ``[]``. Memory is bounded by
        ``chunk`` whatever the number of queries."""
        unit = self._unit_syn0()
        V = unit.shape[0]
        k = min(n, V - 1)
        idxs = np.array([max(self.vocab.index_of(w), 0) for w in words],
                        np.int64)
        valid = [self.vocab.index_of(w) >= 0 for w in words]
        out: List[List[str]] = []
        for lo in range(0, len(words), chunk):
            hi = min(lo + chunk, len(words))
            q = self._idx(idxs[lo:hi])
            sims = unit[q] @ unit.T                       # (chunk, V)
            sims[torch.arange(hi - lo, device=sims.device), q] = -np.inf
            top = torch.topk(sims, max(k, 0), dim=1).indices.cpu().numpy()
            for r in range(hi - lo):
                out.append([self.vocab.word_at(int(i)) for i in top[r]]
                           if valid[lo + r] else [])
        return out


class Word2Vec(SequenceVectors):
    """User-facing builder facade (models/word2vec/Word2Vec.java)."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator: Optional[SentenceIterator] = None
            self._tokenizer = DefaultTokenizerFactory()

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        def window_size(self, n):
            self._kw["window"] = n
            return self

        def negative_sample(self, n):
            self._kw["negative"] = n
            return self

        def use_hierarchic_softmax(self, b=True):
            self._kw["hs"] = b
            return self

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def sampling(self, s):
            self._kw["subsampling"] = s
            return self

        def batch_size(self, n):
            self._kw["batch_size"] = n
            return self

        def stop_words(self, sw):
            self._kw["stop_words"] = sw
            return self

        def elements_learning_algorithm(self, name: str):
            """'skipgram' | 'cbow' (reference
            elementsLearningAlgorithm(SkipGram/CBOW))."""
            self._kw["algorithm"] = name.lower()
            return self

        def device(self, device):
            """Where the tables train (default ``"cuda"``)."""
            self._kw["device"] = device
            return self

        def iterate(self, it: SentenceIterator):
            self._iterator = it
            return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf
            return self

        def build(self) -> "Word2Vec":
            w = Word2Vec(**self._kw)
            w._iterator = self._iterator
            w._tokenizer = self._tokenizer
            return w

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def __init__(self, **kw):
        super().__init__(**kw)
        self._iterator = None
        self._tokenizer = DefaultTokenizerFactory()

    def fit(self, sequences=None, mesh=None):
        if sequences is None:
            if self._iterator is None:
                raise ValueError("No sentence iterator configured")
            sequences = [self._tokenizer.create(s).get_tokens()
                         for s in self._iterator]
        return super().fit(sequences, mesh=mesh)


def vectors_from_jax(state, words, counts, *, labels=None, device="cuda",
                     **kw):
    """The port's model over tables a JAX model trained: ``state`` holds
    numpy ``syn0`` and ``syn1`` and, for ParagraphVectors,
    ``doc_vectors`` (``labels`` name its rows, default ``doc_{i}``), for
    GloVe ``bias_w`` and ``bias_c``; ``words`` and ``counts`` are the
    JAX vocab's, in its index order. The vocab keeps those indices, and
    the unigram table and Huffman arrays are rebuilt from the counts as
    ``build_vocab`` builds them. ``kw`` goes to the model's constructor
    (seed, negative, hs, ...)."""
    syn0 = np.asarray(state["syn0"], np.float32)
    kw.setdefault("layer_size", syn0.shape[1])
    if state.get("doc_vectors") is not None:
        from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
            ParagraphVectors)
        model = ParagraphVectors(device=device, **kw)
        model.doc_vectors = np.asarray(state["doc_vectors"], np.float32)
        model.doc_labels = (list(labels) if labels is not None else
                            [f"doc_{i}" for i in
                             range(len(model.doc_vectors))])
        model._label_index = {l: i for i, l in
                              enumerate(model.doc_labels)}
    elif state.get("bias_w") is not None:
        from deeplearning4j_tpu_torch.nlp.glove import Glove
        model = Glove(device=device, **kw)
        model.bias_w = np.asarray(state["bias_w"], np.float32)
        model.bias_c = np.asarray(state["bias_c"], np.float32)
    else:
        model = Word2Vec(device=device, **kw)
    cache = VocabCache()
    for w, c in zip(words, counts):
        cache.add(VocabWord(str(w), int(c)))
    cache.total_count = int(sum(int(c) for c in counts))
    model.vocab = cache
    model.syn0 = syn0.copy()
    model.syn1 = np.asarray(state["syn1"], np.float32).copy()
    model._tables_from_vocab()
    if model._hs_arrays is None:
        model._hs_arrays = Huffman(cache).padded_arrays()
    return model
