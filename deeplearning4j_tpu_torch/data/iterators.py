"""DataSet iterators (counterpart of the base, list and array iterators
of ``deeplearning4j_tpu/data/iterators.py``).

``DataSetIterator`` with the checkpointable-state protocol
(``state_dict`` / ``load_state_dict``: a one-shot resume at a batch
cursor, guarded by a signature of the source), ``ListDataSetIterator``
over pre-built batches and ``ArrayDataSetIterator`` over dense arrays
with an optional per-epoch shuffle. The JAX package routes each batch
through its ``data.fetch`` chaos site and retry policy; chaos is not
ported, so a batch is produced directly. The async, multi-epoch,
sampling and parallel iterators are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet

__all__ = ["DataSetIterator", "ListDataSetIterator", "ArrayDataSetIterator"]


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
        for b in self._batches[start:]:
            self._cursor += 1
            yield b

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
            yield DataSet(
                self.features[sel],
                None if self.labels is None else self.labels[sel],
                None if self.features_mask is None
                else self.features_mask[sel],
                None if self.labels_mask is None
                else self.labels_mask[sel])

    def batch_size(self):
        return self._bs

    def num_examples(self):
        return int(self.features.shape[0])
