"""DataSet iterators (counterpart of the base, list and array iterators
of ``deeplearning4j_tpu/data/iterators.py``).

``DataSetIterator`` with the checkpointable-state protocol
(``state_dict`` / ``load_state_dict``: a one-shot resume at a batch
cursor, guarded by a signature of the source), ``ListDataSetIterator``
over pre-built batches and ``ArrayDataSetIterator`` over dense arrays
with an optional per-epoch shuffle. Every batch goes through the
``data.fetch`` chaos site and the shared retry policy
(:func:`fetch_batch`), as in the JAX package. Around them:
``AsyncDataSetIterator`` (a producer thread and a bounded queue, so host
ETL overlaps the device; an exception in the producer is raised to the
consumer), ``MultipleEpochsIterator``, ``EarlyTerminationDataSetIterator``,
``SamplingDataSetIterator`` (with-replacement draws from numpy's
generator, so the batches equal the JAX package's for one seed),
``BenchmarkDataSetIterator`` (one cached batch replayed),
``JointParallelDataSetIterator`` (sources interleaved round-robin) and
``FileSplitParallelDataSetIterator`` (one CSV file a source).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.chaos.retry import retrying_io
from deeplearning4j_tpu_torch.data.dataset import DataSet

__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator",
           "AsyncDataSetIterator", "MultipleEpochsIterator",
           "EarlyTerminationDataSetIterator", "SamplingDataSetIterator",
           "BenchmarkDataSetIterator", "JointParallelDataSetIterator",
           "FileSplitParallelDataSetIterator", "fetch_batch"]


def fetch_batch(make):
    """Produce one batch through the ``data.fetch`` chaos site and the
    shared retry policy (:func:`chaos.retry.retrying_io`): a transient
    IOError (injected or real) costs a backed-off retry of the SAME
    batch, so a flaky source degrades throughput, never the batch
    stream."""
    return retrying_io("data.fetch", make)


class DataSetIterator:
    """Base: restartable iterator over DataSet minibatches.

    Checkpointable-state protocol (opt-in): a stateful iterator
    implements ``state_dict()`` (a JSON-serializable dict with at least
    ``cursor``, the batches yielded so far this epoch, plus whatever
    epoch fields reproduce the rest of the epoch) and
    ``load_state_dict(state)`` (the NEXT iteration starts at ``cursor``
    without materializing the consumed prefix). The base is stateless
    and returns None.
    """

    _resume: Optional[dict] = None
    _cursor: int = 0

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self._iterate()

    def _iterate(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def state_dict(self) -> Optional[dict]:
        """Position state for checkpointing, or None (stateless)."""
        return None

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support iterator-state "
            "resume")

    def _source_signature(self) -> Optional[list]:
        """Cheap JSON-safe identity of the data source (None: no check)."""
        return None

    def _arm_resume(self, state: dict) -> None:
        state = dict(state)
        theirs = state.get("source")
        mine = self._source_signature()
        if theirs is not None and mine is not None \
                and list(theirs) != list(mine):
            raise ValueError(
                f"iterator state does not match this data source "
                f"(checkpointed {theirs}, current {mine}) — the "
                "wrong (or a modified) dataset was passed to the "
                "resumed run")
        self._resume = state

    def _consume_resume(self, total: Optional[int] = None) -> int:
        st, self._resume = self._resume, None
        start = 0 if st is None else int(st.get("cursor", 0))
        if total is not None and start > total:
            raise ValueError(
                f"iterator state cursor {start} is beyond the "
                f"{total} batches this source can produce — the "
                "data source shrank (or the wrong one was passed) "
                "since the checkpoint was written")
        self._cursor = start
        return start

    def batch_size(self) -> Optional[int]:
        return None

    def num_examples(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Over a pre-batched list."""

    def __init__(self, batches: Sequence[DataSet]):
        self._batches = list(batches)
        self._cursor = 0
        self._resume: Optional[dict] = None

    def reset(self):
        pass

    def _source_signature(self):
        return ["list", len(self._batches),
                sum(b.num_examples() for b in self._batches)]

    def state_dict(self):
        return {"cursor": self._cursor,
                "source": self._source_signature()}

    def load_state_dict(self, state):
        self._arm_resume(state)

    def _iterate(self):
        start = self._consume_resume(len(self._batches))
        # skipping is a slice, not a replay: the consumed prefix is
        # never materialized (no data.fetch hits, no retry budget)
        for b in self._batches[start:]:
            self._cursor += 1
            yield fetch_batch(lambda b=b: b)

    def batch_size(self):
        return self._batches[0].num_examples() if self._batches else None

    def num_examples(self):
        return sum(b.num_examples() for b in self._batches)


class ArrayDataSetIterator(DataSetIterator):
    """Batches dense arrays, with an optional per-epoch shuffle (the
    permutation is a function of (seed, epoch))."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0,
                 features_mask=None, labels_mask=None,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._drop_last = drop_last
        self._cursor = 0
        self._resume: Optional[dict] = None

    def reset(self):
        # an armed resume pins the epoch so the restored shuffle
        # permutation is the interrupted epoch's own
        if self._resume is not None:
            self._epoch = int(self._resume.get("epoch", self._epoch))
        else:
            self._epoch += 1

    def _source_signature(self):
        return ["array", self._bs, self._seed, int(self._shuffle),
                str(self.features.dtype),
                *map(int, self.features.shape)]

    def state_dict(self):
        return {"cursor": self._cursor, "epoch": self._epoch,
                "source": self._source_signature()}

    def load_state_dict(self, state):
        self._arm_resume(state)
        self._epoch = int(self._resume.get("epoch", self._epoch))

    def _iterate(self):
        n = self.features.shape[0]
        total = (n // self._bs if self._drop_last
                 else -(-n // self._bs))
        start = self._consume_resume(total)
        idx = np.arange(n)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(idx)
        for i in range(start * self._bs, n, self._bs):
            sel = idx[i:i + self._bs]
            if self._drop_last and len(sel) < self._bs:
                return
            self._cursor += 1
            yield fetch_batch(lambda sel=sel: DataSet(
                self.features[sel],
                None if self.labels is None else self.labels[sel],
                None if self.features_mask is None
                else self.features_mask[sel],
                None if self.labels_mask is None
                else self.labels_mask[sel]))

    def batch_size(self):
        return self._bs

    def num_examples(self):
        return int(self.features.shape[0])


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference AsyncDataSetIterator.java:30,
    wrapped around every fit() iterator at MultiLayerNetwork.java:1172).
    Keeps up to ``prefetch`` batches ready so host ETL overlaps device
    compute — the JAX analog of the reference's ETL thread + workspaces.
    """

    _END = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2):
        self.base = base
        self.prefetch = prefetch

    def reset(self):
        self.base.reset()

    def _iterate(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        exc: List[BaseException] = []

        def producer():
            try:
                for ds in self.base._iterate():
                    q.put(ds)
            except BaseException as e:        # propagate to consumer
                exc.append(e)
            finally:
                q.put(self._END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._END:
                if exc:
                    raise exc[0]
                return
            yield item

    def batch_size(self):
        return self.base.batch_size()

    def num_examples(self):
        return self.base.num_examples()


class MultipleEpochsIterator(DataSetIterator):
    """(reference MultipleEpochsIterator)."""

    def __init__(self, base: DataSetIterator, epochs: int):
        self.base = base
        self.epochs = epochs

    def reset(self):
        self.base.reset()

    def _iterate(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base._iterate()

    def batch_size(self):
        return self.base.batch_size()


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches (reference
    EarlyTerminationDataSetIterator)."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self.base = base
        self.max_batches = max_batches

    def reset(self):
        self.base.reset()

    def _iterate(self):
        for i, ds in enumerate(self.base._iterate()):
            if i >= self.max_batches:
                return
            yield ds

    def batch_size(self):
        return self.base.batch_size()


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement sampling from a full DataSet (reference
    SamplingDataSetIterator)."""

    def __init__(self, data: DataSet, batch_size: int, batches_per_epoch: int,
                 seed: int = 0):
        self.data = data
        self._bs = batch_size
        self._n = batches_per_epoch
        self._seed = seed
        self._epoch = 0
        self._cursor = 0
        self._resume: Optional[dict] = None

    def reset(self):
        if self._resume is not None:
            self._epoch = int(self._resume.get("epoch", self._epoch))
        else:
            self._epoch += 1

    def _source_signature(self):
        return ["sampling", int(self.data.num_examples()), self._bs,
                self._n, self._seed]

    def state_dict(self):
        return {"cursor": self._cursor, "epoch": self._epoch,
                "source": self._source_signature()}

    def load_state_dict(self, state):
        self._arm_resume(state)
        self._epoch = int(self._resume.get("epoch", self._epoch))

    def _iterate(self):
        start = self._consume_resume(self._n)
        rng = np.random.default_rng(self._seed + self._epoch)
        n = self.data.num_examples()
        # fast-forward the rng past the consumed draws (index draws
        # only, no batch assembly) so the remaining samples match the
        # uninterrupted epoch's stream exactly
        for _ in range(start):
            rng.integers(0, n, size=self._bs)
        for _ in range(self._n - start):
            self._cursor += 1
            sel = rng.integers(0, n, size=self._bs)
            yield DataSet(
                self.data.features[sel],
                None if self.data.labels is None else self.data.labels[sel],
                None if self.data.features_mask is None
                else self.data.features_mask[sel],
                None if self.data.labels_mask is None
                else self.data.labels_mask[sel])

    def batch_size(self):
        return self._bs


class BenchmarkDataSetIterator(DataSetIterator):
    """Replays one cached batch N times to isolate compute from ETL
    (reference datasets/iterator/impl/BenchmarkDataSetIterator.java)."""

    def __init__(self, batch: DataSet, n_batches: int):
        self.batch = batch
        self.n_batches = n_batches

    def reset(self):
        pass

    def _iterate(self):
        for _ in range(self.n_batches):
            yield self.batch

    def batch_size(self):
        return self.batch.num_examples()

    def num_examples(self):
        return self.batch.num_examples() * self.n_batches


class JointParallelDataSetIterator(DataSetIterator):
    """Interleaves several source iterators round-robin (reference
    datasets/iterator/parallel/JointParallelDataSetIterator.java —
    feeds multi-device training from N independent sources)."""

    def __init__(self, *iterators: DataSetIterator):
        if not iterators:
            raise ValueError("need at least one iterator")
        self.iterators = list(iterators)

    def reset(self):
        for it in self.iterators:
            it.reset()

    def _iterate(self):
        gens = [it._iterate() for it in self.iterators]
        while gens:
            done = []
            for g in gens:
                try:
                    yield next(g)
                except StopIteration:
                    done.append(g)
            for g in done:
                gens.remove(g)

    def batch_size(self):
        return self.iterators[0].batch_size()


class FileSplitParallelDataSetIterator(JointParallelDataSetIterator):
    """One CSV file per worker, interleaved (reference
    FileSplitParallelDataSetIterator). ``files``: list of csv paths."""

    def __init__(self, files, batch_size: int, label_index: int,
                 num_classes: int = 0, regression: bool = False):
        from deeplearning4j_tpu_torch.data.records import (
            CSVRecordReader, RecordReaderDataSetIterator)
        its = []
        for f in files:
            rr = CSVRecordReader().initialize(f)
            its.append(RecordReaderDataSetIterator(
                rr, batch_size, label_index=label_index,
                num_classes=num_classes, regression=regression))
        super().__init__(*its)
