"""Device-resident vector indexes: brute-force matmul top-k + IVF
(counterpart of ``deeplearning4j_tpu/retrieval/index.py``).

The retrieval subsystem's data plane. Two index kinds behind one
contract:

- :class:`BruteForceIndex`: the exact baseline, one matmul over the
  whole corpus plus ``torch.topk``. The corpus matrix grows to a
  power-of-two capacity, and ``add``/``remove`` are incremental:
  removes tombstone rows (masked out of the scores, reported in
  ``stats()``), and the store compacts when tombstones outnumber live
  rows or on capacity growth.
- :class:`IVFIndex`: the inverted-file coarse quantizer. k-means (the
  Lloyd step of ``clustering/kmeans.py``, on the index's device)
  partitions the corpus into ``nlist`` cells; a query scores only its
  ``nprobe`` nearest cells' members (gathered into one padded device
  call), trading recall for QPS. ``estimate_recall`` measures that
  trade against the exact answer on a sample of the corpus itself.

Scores are HIGHER-IS-BETTER for every metric: cosine similarity, dot
product, or negative squared euclidean distance. Missing results (k
larger than the live corpus, or an empty probe set) come back as id
``-1`` with score ``-inf``.

The JAX package's jitted ``_dot_topk``, ``_l2_topk``,
``_gather_dot_topk`` and ``_gather_l2_topk`` are XLA ops, outside any
Pallas kernel, so their counterparts here are library calls on the
index's ``device``: ``torch.matmul`` / ``bmm`` (cuBLAS, float32 kept by
``device.keep_float32``), ``masked_fill``, ``torch.topk`` and
``torch.gather``. The JAX package pads query batches to powers of two
to bound its compiled shapes; eager torch needs no such padding, so a
batch runs at its own row count (the top-k width still rounds up to a
power of two, as there, and is trimmed back to ``k``).

Concurrency: mutations serialize on a writer lock and publish an
immutable snapshot (host + device arrays, generation-tagged);
searches read the current snapshot with one atomic attribute load and
never block writers: the single-writer / wait-free-reader discipline
the ``/v1/index`` admin verbs build on. A snapshot's device tensors are
complete before it is published (the publisher synchronizes the card
once), so a search on another thread never sees a half-copied matrix.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import keep_float32, resolve_device

__all__ = ["BruteForceIndex", "IVFIndex", "pow2_bucket", "METRICS"]

METRICS = ("cosine", "dot", "euclidean")

# smallest corpus capacity: tiny indexes do not regrow on every add
_MIN_CAPACITY = 64


def pow2_bucket(n: int, lo: int = 1) -> int:
    """The next power of two >= max(n, lo): the shape-bucketing
    helper shared by top-k widths, capacities and token lengths."""
    target = int(lo)
    n = int(n)
    while target < n:
        target *= 2
    return target


# ---------------------------------------------------------------------------
# device scoring (pure: tensors in, (scores, positions) out)
# ---------------------------------------------------------------------------

def _dot_topk(q, mat, mask, k):
    """Top-k by dot product: q (B, D) @ mat (N, D).T with dead and pad
    rows masked to -inf. Cosine rides this with both sides
    unit-normalized."""
    keep_float32(q)
    scores = (q @ mat.T).masked_fill_(~mask[None, :], -float("inf"))
    return torch.topk(scores, k, dim=1)


def _l2_topk(q, mat, sq, mask, k):
    """Top-k by negative squared euclidean distance, expanded so the
    corpus norms ``sq`` are computed once per snapshot."""
    keep_float32(q)
    scores = (2.0 * (q @ mat.T) - sq[None, :]
              - torch.sum(q * q, dim=1, keepdim=True))
    scores.masked_fill_(~mask[None, :], -float("inf"))
    return torch.topk(scores, k, dim=1)


def _gather_scores(q, mat, idx):
    """IVF fine scoring: each query's candidate rows (idx (B, C) into
    mat) dotted with the query, (B, C)."""
    keep_float32(q)
    cand = mat[idx]                                   # (B, C, D)
    return torch.bmm(cand, q[:, :, None])[:, :, 0]


def _gather_dot_topk(q, mat, idx, cmask, k):
    """Returns (scores, rows) with rows already mapped through idx."""
    scores = _gather_scores(q, mat, idx).masked_fill_(~cmask,
                                                      -float("inf"))
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, torch.gather(idx, 1, pos)


def _gather_l2_topk(q, mat, sq, idx, cmask, k):
    scores = (2.0 * _gather_scores(q, mat, idx) - sq[idx]
              - torch.sum(q * q, dim=1, keepdim=True))
    scores.masked_fill_(~cmask, -float("inf"))
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, torch.gather(idx, 1, pos)


class _Snapshot:
    """One immutable published view of the store. Searches hold a
    reference for their whole duration, so a concurrent compaction
    can never shift rows under a running device call."""

    __slots__ = ("mat", "sq", "mask", "mat_host", "row_ids",
                 "id_to_row", "live", "cap", "generation", "dead",
                 "lists", "centroids")

    def __init__(self, device: torch.device, mat_host: np.ndarray,
                 prepped: np.ndarray, mask: np.ndarray,
                 row_ids: np.ndarray, id_to_row: Dict[int, int],
                 live: int, generation: int, dead: int = 0,
                 lists: Optional[List[np.ndarray]] = None,
                 centroids: Optional[np.ndarray] = None):
        self.mat_host = mat_host          # raw vectors (cap, D)
        # metric-prepped, on the device
        self.mat = torch.from_numpy(np.ascontiguousarray(prepped)).to(
            device)
        self.sq = torch.from_numpy(
            np.sum(prepped.astype(np.float64) ** 2,
                   axis=1).astype(np.float32)).to(device)
        self.mask = torch.from_numpy(mask).to(device)
        if device.type == "cuda":
            # complete before publication: readers run on other threads
            torch.cuda.synchronize(device)
        self.row_ids = row_ids            # external id per row, -1 dead
        self.id_to_row = id_to_row
        self.live = live
        self.cap = mat_host.shape[0]
        self.generation = generation
        self.dead = dead
        self.lists = lists                # IVF: row indices per cell
        self.centroids = centroids        # IVF: prepped (nlist, D)


class _FlatStore:
    """Capacity-managed flat vector store with tombstoned removes:
    the host half shared by both index kinds. ``device`` holds the
    snapshot's matrix (default ``"cuda"``; ``"cpu"`` without a card)."""

    kind = "flat"

    def __init__(self, dim: int, metric: str = "cosine", device="cuda"):
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; known: "
                             f"{METRICS}")
        if int(dim) <= 0:
            raise ValueError("dim must be positive")
        self.dim = int(dim)
        self.metric = metric
        self.device = resolve_device(device)
        self._lock = threading.Lock()      # single writer at a time
        self._mat = np.zeros((0, self.dim), np.float32)
        self._row_ids = np.zeros(0, np.int64)
        self._mask = np.zeros(0, bool)
        self._id_to_row: Dict[int, int] = {}
        self._n = 0                        # append watermark
        self._dead = 0
        self._generation = 0
        self._snap: Optional[_Snapshot] = None
        with self._lock:
            self._publish()

    # ---- metric prep (host mirror of the device scoring) ----
    def _prep(self, x: np.ndarray) -> np.ndarray:
        if self.metric == "cosine":
            n = np.linalg.norm(x, axis=1, keepdims=True)
            return (x / np.maximum(n, 1e-12)).astype(np.float32)
        return x.astype(np.float32)

    # ---- mutation (call with self._lock held) ----
    def _publish(self) -> None:
        self._generation += 1
        prepped = self._prep(self._mat) if self._mat.size \
            else self._mat
        self._snap = _Snapshot(
            self.device, self._mat, prepped, self._mask.copy(),
            self._row_ids.copy(), dict(self._id_to_row),
            live=len(self._id_to_row), generation=self._generation,
            dead=self._dead, **self._extra_snapshot())

    def _extra_snapshot(self) -> dict:
        return {}

    def _grow_to(self, need: int) -> None:
        """Compact + regrow the arrays to a pow2 capacity >= need
        (tombstones are dropped here: growth IS a compaction)."""
        live_rows = np.flatnonzero(self._mask)
        cap = pow2_bucket(need, lo=_MIN_CAPACITY)
        mat = np.zeros((cap, self.dim), np.float32)
        row_ids = np.full(cap, -1, np.int64)
        n = live_rows.size
        mat[:n] = self._mat[live_rows]
        row_ids[:n] = self._row_ids[live_rows]
        mask = np.zeros(cap, bool)
        mask[:n] = True
        self._mat, self._row_ids, self._mask = mat, row_ids, mask
        self._id_to_row = {int(i): r for r, i
                           in enumerate(row_ids[:n])}
        self._n, self._dead = n, 0
        self._on_rows_moved(live_rows)

    def _on_rows_moved(self, old_rows: np.ndarray) -> None:
        """Hook for subclasses carrying per-row sidecars (IVF cell
        assignments): ``old_rows[new_row]`` is the previous index of
        each surviving row."""

    def _compact_locked(self) -> None:
        self._grow_to(max(len(self._id_to_row), 1))

    def _tombstone(self, row: int) -> None:
        self._mask[row] = False
        ext = int(self._row_ids[row])
        self._row_ids[row] = -1
        self._id_to_row.pop(ext, None)
        self._dead += 1

    def _append_rows(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Upsert ``vecs`` under ``ids`` (existing ids are replaced).
        Caller holds the lock; caller publishes."""
        for ext in ids:
            row = self._id_to_row.get(int(ext))
            if row is not None:
                self._tombstone(row)
        if self._n + ids.size > self._mat.shape[0]:
            self._grow_to(len(self._id_to_row) + ids.size)
        start = self._n
        self._mat[start:start + ids.size] = vecs
        self._row_ids[start:start + ids.size] = ids
        self._mask[start:start + ids.size] = True
        for off, ext in enumerate(ids):
            self._id_to_row[int(ext)] = start + off
        self._n += ids.size
        if self._dead > max(len(self._id_to_row), 1):
            self._compact_locked()

    @staticmethod
    def _check_pair(ids, vectors, dim) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, np.int64).reshape(-1)
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.ndim != 2 or vecs.shape[1] != dim:
            raise ValueError(
                f"vectors must be (n, {dim}); got {vecs.shape}")
        if ids.size != vecs.shape[0]:
            raise ValueError(
                f"{ids.size} ids for {vecs.shape[0]} vectors")
        if ids.size and np.any(ids < 0):
            raise ValueError("ids must be non-negative (id -1 is the "
                             "missing-result sentinel)")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids within one add() call")
        return ids, vecs

    # ---- public mutation API ----
    def add(self, ids, vectors) -> int:
        """Upsert vectors under integer ids; returns the new
        generation."""
        ids, vecs = self._check_pair(ids, vectors, self.dim)
        with self._lock:
            if ids.size:
                self._append_rows(ids, vecs)
            self._publish()
            return self._generation

    def remove(self, ids) -> int:
        """Tombstone the given ids (unknown ids ignored); returns
        the number actually removed. Compacts once tombstones
        outnumber live rows."""
        removed = 0
        with self._lock:
            for ext in np.asarray(ids, np.int64).reshape(-1):
                row = self._id_to_row.get(int(ext))
                if row is not None:
                    self._tombstone(row)
                    removed += 1
            if removed:
                if self._dead > max(len(self._id_to_row), 1):
                    self._compact_locked()
                self._publish()
        return removed

    def compact(self) -> int:
        """Force tombstone compaction; returns the generation."""
        with self._lock:
            self._compact_locked()
            self._publish()
            return self._generation

    # ---- introspection ----
    @property
    def generation(self) -> int:
        snap = self._snap
        return snap.generation if snap is not None else 0

    def __len__(self) -> int:
        snap = self._snap
        return snap.live if snap is not None else 0

    def stats(self) -> dict:
        snap = self._snap
        return {"kind": self.kind, "metric": self.metric,
                "dim": self.dim, "vectors": snap.live,
                "tombstones": snap.dead, "capacity": snap.cap,
                "generation": snap.generation}

    def get(self, ext_id: int) -> Optional[np.ndarray]:
        snap = self._snap
        row = snap.id_to_row.get(int(ext_id))
        return None if row is None else snap.mat_host[row].copy()

    # ---- shared search plumbing ----
    @staticmethod
    def _empty_result(b: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
        return (np.full((b, k), -1, np.int64),
                np.full((b, k), -np.inf, np.float32))

    def _check_queries(self, queries) -> np.ndarray:
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be (b, {self.dim}); got {q.shape}")
        return q

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _finish(vals: torch.Tensor, rows: torch.Tensor,
                snap: _Snapshot, b: int, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Trim the device output to (b, k) and map internal rows to
        external ids (-inf scores become id -1)."""
        vals = vals[:b, :k].cpu().numpy()
        rows = rows[:b, :k].cpu().numpy()
        ids = snap.row_ids[rows]
        ids = np.where(np.isfinite(vals), ids, -1)
        if vals.shape[1] < k:            # corpus smaller than k
            pad = k - vals.shape[1]
            ids = np.concatenate(
                [ids, np.full((b, pad), -1, np.int64)], axis=1)
            vals = np.concatenate(
                [vals, np.full((b, pad), -np.inf, np.float32)],
                axis=1)
        return ids.astype(np.int64), vals.astype(np.float32)

    def _search_filtered(self, snap: _Snapshot, q: np.ndarray,
                         k: int, allow_ids) -> Tuple[np.ndarray,
                                                     np.ndarray]:
        """Restrict the search to an explicit id allow-list. Host
        numpy over the (small) allowed subset: filtered queries are
        per-request shaped and deliberately stay off the batched
        device path."""
        rows = [snap.id_to_row[int(i)] for i in allow_ids
                if int(i) in snap.id_to_row]
        b = q.shape[0]
        if not rows:
            return self._empty_result(b, k)
        rows = np.asarray(sorted(set(rows)), np.int64)
        sub = snap.mat_host[rows]
        qp = self._prep(q)
        subp = self._prep(sub)
        if self.metric == "euclidean":
            scores = (2.0 * (qp @ subp.T)
                      - np.sum(subp.astype(np.float64) ** 2, axis=1,
                               dtype=np.float64).astype(np.float32)
                      - np.sum(qp * qp, axis=1, keepdims=True))
        else:
            scores = qp @ subp.T
        kk = min(k, rows.size)
        order = np.argsort(-scores, axis=1)[:, :kk]
        vals = np.take_along_axis(scores, order, axis=1)
        ids = snap.row_ids[rows[order]]
        if kk < k:
            ids = np.concatenate(
                [ids, np.full((b, k - kk), -1, np.int64)], axis=1)
            vals = np.concatenate(
                [vals, np.full((b, k - kk), -np.inf, np.float32)],
                axis=1)
        return ids.astype(np.int64), vals.astype(np.float32)


class BruteForceIndex(_FlatStore):
    """Exact top-k by one matmul over the whole corpus."""

    kind = "brute_force"

    def search(self, queries, k: int,
               nprobe: Optional[int] = None,
               allow_ids: Optional[Sequence[int]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, scores), each (b, k). ``nprobe`` is accepted (and
        ignored) so both index kinds serve one call shape."""
        del nprobe
        q = self._check_queries(queries)
        if k <= 0:
            raise ValueError("k must be positive")
        snap = self._snap
        b = q.shape[0]
        if snap.live == 0:
            return self._empty_result(b, k)
        if allow_ids is not None:
            return self._search_filtered(snap, q, k, allow_ids)
        k_dev = min(pow2_bucket(k), snap.cap)
        qd = self._to_device(self._prep(q))
        if self.metric == "euclidean":
            vals, rows = _l2_topk(qd, snap.mat, snap.sq, snap.mask,
                                  k_dev)
        else:
            vals, rows = _dot_topk(qd, snap.mat, snap.mask, k_dev)
        return self._finish(vals, rows, snap, b, k)


class IVFIndex(_FlatStore):
    """Inverted-file index: k-means cells + nprobe-cell search."""

    kind = "ivf"

    def __init__(self, dim: int, nlist: int = 16,
                 metric: str = "cosine", seed: int = 0,
                 train_iters: int = 25, device="cuda"):
        self.nlist = int(nlist)
        if self.nlist <= 0:
            raise ValueError("nlist must be positive")
        self.seed = int(seed)
        self.train_iters = int(train_iters)
        self._centroids: Optional[np.ndarray] = None  # prepped space
        self._assign = np.zeros(0, np.int32)
        # the split of the last search's time (seconds): host coarse
        # scoring + candidate lists, then the device gather and top-k
        self.last_split: Dict[str, float] = {}
        super().__init__(dim, metric, device=device)

    # ---- training ----
    def train(self, vectors) -> "IVFIndex":
        """Fit the coarse quantizer on (a sample of) the corpus: the
        Lloyd step of ``clustering/kmeans.py`` runs on the index's
        device. Must run before ``add``; re-training an index with
        resident vectors reassigns them."""
        from deeplearning4j_tpu_torch.clustering.kmeans import (
            KMeansClustering)
        x = np.asarray(vectors, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(
                f"training vectors must be (n, {self.dim}); got "
                f"{x.shape}")
        if x.shape[0] < 1:
            raise ValueError("training needs at least one vector")
        k = min(self.nlist, x.shape[0])
        km = KMeansClustering(
            k, max_iterations=self.train_iters, seed=self.seed,
            distance="cosine" if self.metric == "cosine"
            else "euclidean", device=self.device)
        km.apply_to(x)
        # centroids live in the metric-prepped space (unit sphere for
        # cosine), matching what _prep does to queries and rows
        self._centroids = np.asarray(km.centroids, np.float32)
        with self._lock:
            if self._n:
                self._assign[:self._n] = self._assign_cells(
                    self._mat[:self._n])
            self._publish()
        return self

    def build(self, ids, vectors) -> "IVFIndex":
        """train + add in one call: the load-a-corpus path."""
        self.train(vectors)
        self.add(ids, vectors)
        return self

    @property
    def trained(self) -> bool:
        return self._centroids is not None

    def _assign_cells(self, vecs: np.ndarray) -> np.ndarray:
        """Nearest-centroid cell per row, in prepped space (squared
        euclidean there equals the metric's own ordering), on the
        index's device in row blocks."""
        from deeplearning4j_tpu_torch.clustering.kmeans import _assign
        v = self._to_device(self._prep(np.asarray(vecs, np.float32)))
        cells, _ = _assign(v, self._to_device(self._centroids))
        return cells.cpu().numpy().astype(np.int32)

    # ---- store hooks ----
    def add(self, ids, vectors) -> int:
        if self._centroids is None:
            raise ValueError(
                "IVF index is untrained: call train()/build() "
                "before add()")
        ids_arr, vecs = self._check_pair(ids, vectors, self.dim)
        with self._lock:
            if ids_arr.size:
                cells = self._assign_cells(vecs)
                self._pending_cells = cells
                try:
                    self._append_rows(ids_arr, vecs)
                finally:
                    del self._pending_cells
            self._publish()
            return self._generation

    def _append_rows(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        if self._assign.shape[0] < self._mat.shape[0]:
            self._assign = np.resize(self._assign,
                                     self._mat.shape[0])
        super()._append_rows(ids, vecs)
        if self._assign.shape[0] < self._mat.shape[0]:
            grown = np.full(self._mat.shape[0], -1, np.int32)
            grown[:self._assign.shape[0]] = self._assign
            self._assign = grown
        cells = getattr(self, "_pending_cells", None)
        if cells is not None:
            start = self._n - ids.size
            self._assign[start:start + ids.size] = cells

    def _on_rows_moved(self, old_rows: np.ndarray) -> None:
        if self._assign.size:
            moved = np.full(self._mat.shape[0], -1, np.int32)
            moved[:old_rows.size] = self._assign[old_rows]
            self._assign = moved
        else:
            self._assign = np.full(self._mat.shape[0], -1, np.int32)

    def _extra_snapshot(self) -> dict:
        if self._centroids is None:
            return {"lists": None, "centroids": None}
        lists: List[np.ndarray] = [
            np.zeros(0, np.int64)] * self._centroids.shape[0]
        if self._n:
            live = self._mask[:self._n]
            rows = np.flatnonzero(live)
            cells = self._assign[:self._n][live]
            order = np.argsort(cells, kind="stable")
            rows, cells = rows[order], cells[order]
            bounds = np.searchsorted(
                cells, np.arange(self._centroids.shape[0] + 1))
            lists = [rows[bounds[c]:bounds[c + 1]].astype(np.int64)
                     for c in range(self._centroids.shape[0])]
        return {"lists": lists, "centroids": self._centroids}

    def stats(self) -> dict:
        out = super().stats()
        out["nlist"] = self.nlist
        out["trained"] = self.trained
        snap = self._snap
        if snap is not None and snap.lists is not None:
            sizes = [int(r.size) for r in snap.lists]
            out["cells"] = {"count": len(sizes),
                            "max_size": max(sizes, default=0),
                            "empty": sum(1 for s in sizes if not s)}
        return out

    # ---- search ----
    def search(self, queries, k: int,
               nprobe: Optional[int] = None,
               allow_ids: Optional[Sequence[int]] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        t0 = time.perf_counter()
        q = self._check_queries(queries)
        if k <= 0:
            raise ValueError("k must be positive")
        snap = self._snap
        b = q.shape[0]
        if snap.live == 0 or snap.centroids is None:
            return self._empty_result(b, k)
        if allow_ids is not None:
            return self._search_filtered(snap, q, k, allow_ids)
        nlist = snap.centroids.shape[0]
        nprobe = nlist if nprobe is None \
            else max(1, min(int(nprobe), nlist))
        qp = self._prep(q)
        # coarse scoring on the host, as in the JAX package: the
        # (b, nlist) distance matrix is small next to the fine
        # gather-matmul the device call does below
        c = snap.centroids
        d2 = (np.sum(qp ** 2, axis=1, keepdims=True)
              - 2.0 * (qp @ c.T) + np.sum(c ** 2, axis=1)[None, :])
        probes = np.argpartition(d2, nprobe - 1,
                                 axis=1)[:, :nprobe]
        cand = [np.concatenate([snap.lists[c] for c in row])
                for row in probes]
        width = max((r.size for r in cand), default=0)
        if width == 0:
            return self._empty_result(b, k)
        # candidate width pads to a SNAPSHOT-level constant (nprobe
        # cells of the largest list), not the batch's own max: the
        # JAX package's rule (there it bounds compiles), kept so both
        # gather the same candidate matrix
        max_list = max((r.size for r in snap.lists), default=0)
        c_pad = min(pow2_bucket(max(width, nprobe * max_list)),
                    pow2_bucket(snap.cap))
        idx = np.zeros((b, c_pad), np.int64)
        cmask = np.zeros((b, c_pad), bool)
        for i, r in enumerate(cand):
            idx[i, :r.size] = r
            cmask[i, :r.size] = True
        k_dev = min(pow2_bucket(k), c_pad)
        t1 = time.perf_counter()
        qd = self._to_device(qp)
        idx_d = self._to_device(idx)
        cmask_d = self._to_device(cmask)
        if self.metric == "euclidean":
            vals, rows = _gather_l2_topk(qd, snap.mat, snap.sq,
                                         idx_d, cmask_d, k_dev)
        else:
            vals, rows = _gather_dot_topk(qd, snap.mat, idx_d, cmask_d,
                                          k_dev)
        out = self._finish(vals, rows, snap, b, k)
        self.last_split = {"host_s": t1 - t0,
                           "device_s": time.perf_counter() - t1,
                           "c_pad": c_pad}
        return out

    # ---- quality ----
    def estimate_recall(self, k: int = 10, sample: int = 16,
                        nprobe: Optional[int] = None,
                        seed: int = 0) -> Optional[float]:
        """recall@k of THIS index against the exact answer, probing
        with a seeded sample of its own resident vectors. None on an
        empty/untrained index. The exact reference is host numpy over
        the live rows, independent of the device scoring it grades."""
        snap = self._snap
        if snap is None or snap.live == 0 or snap.centroids is None:
            return None
        live_rows = np.flatnonzero(snap.mask.cpu().numpy())
        rng = np.random.default_rng(seed)
        take = min(int(sample), live_rows.size)
        qrows = rng.choice(live_rows, size=take, replace=False)
        queries = snap.mat_host[qrows]
        ids, _ = self.search(queries, k=k, nprobe=nprobe)
        qp = self._prep(queries)
        mp = self._prep(snap.mat_host[live_rows])
        if self.metric == "euclidean":
            scores = (2.0 * (qp @ mp.T)
                      - np.sum(mp * mp, axis=1)[None, :])
        else:
            scores = qp @ mp.T
        kk = min(k, live_rows.size)
        order = np.argsort(-scores, axis=1)[:, :kk]
        truth = snap.row_ids[live_rows[order]]
        hits = 0
        for got, want in zip(ids, truth):
            hits += len(set(int(g) for g in got if g >= 0)
                        & set(int(w) for w in want))
        return hits / max(truth.size, 1)
