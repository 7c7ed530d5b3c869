"""Record readers: CSV / image / sequence → DataSet pipelines
(counterpart of ``deeplearning4j_tpu/data/records.py``).

Mirrors the DataVec bridge (deeplearning4j-core
datasets/datavec/RecordReaderDataSetIterator.java:52,
SequenceRecordReaderDataSetIterator, RecordReaderMultiDataSetIterator):
a RecordReader yields records (lists of values); the iterator assembles
minibatches, splitting off the label column(s). DataVec's
transform-process role is covered by a composable ``transforms`` list.
"""

from __future__ import annotations

import csv
import itertools
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (DataSetIterator,
                                               fetch_batch)

__all__ = ["CSVRecordReader", "CSVSequenceRecordReader",
           "ImageRecordReader", "RecordReaderDataSetIterator",
           "SequenceRecordReaderDataSetIterator"]


class CSVRecordReader:
    """(datavec CSVRecordReader): one record per CSV line."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._rows: List[List[str]] = []

    def initialize(self, path: str) -> "CSVRecordReader":
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self.delimiter))
        self._rows = rows[self.skip_lines:]
        return self

    def __iter__(self):
        return iter(self._rows)

    def iter_from(self, start: int):
        """Iterate records starting at ordinal ``start`` without
        touching the skipped prefix (the iterator-state resume
        hook)."""
        return iter(self._rows[start:])

    def __len__(self):
        return len(self._rows)


class CSVSequenceRecordReader:
    """(datavec CSVSequenceRecordReader): one sequence per FILE in a
    directory (each file: timestep rows)."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._seqs: List[List[List[str]]] = []

    def initialize(self, paths) -> "CSVSequenceRecordReader":
        if isinstance(paths, str):
            paths = sorted(
                os.path.join(paths, f) for f in os.listdir(paths)
                if f.endswith(".csv"))
        for p in paths:
            with open(p, newline="") as f:
                rows = list(csv.reader(f, delimiter=self.delimiter))
            self._seqs.append(rows[self.skip_lines:])
        return self

    def __iter__(self):
        return iter(self._seqs)

    def __len__(self):
        return len(self._seqs)


class ImageRecordReader:
    """(datavec ImageRecordReader): directory-per-label image tree →
    (H,W,C) float arrays + label index. Uses PIL; NHWC."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height = height
        self.width = width
        self.channels = channels
        self.labels: List[str] = []
        self._items: List[tuple] = []

    def initialize(self, root: str) -> "ImageRecordReader":
        from PIL import Image     # noqa: F401  (validated at init)
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        for li, lab in enumerate(self.labels):
            d = os.path.join(root, lab)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                    self._items.append((os.path.join(d, f), li))
        return self

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start: int):
        """Decode from ordinal ``start`` on: a state resume must skip
        the consumed prefix without paying its image decodes."""
        from PIL import Image
        for path, li in self._items[start:]:
            img = Image.open(path)
            if self.channels == 1:
                img = img.convert("L")
            else:
                img = img.convert("RGB")
            img = img.resize((self.width, self.height))
            arr = np.asarray(img, dtype=np.float32)
            if arr.ndim == 2:
                arr = arr[..., None]
            yield arr, li


class RecordReaderDataSetIterator(DataSetIterator):
    """(datasets/datavec/RecordReaderDataSetIterator.java:52).

    For CSV readers: ``label_index`` column is the class id (one-hot to
    ``num_classes``) or, with ``regression=True``, the regression
    target. For ImageRecordReader, labels come from directory names.
    """

    def __init__(self, reader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 transforms: Sequence[Callable] = ()):
        self.reader = reader
        self.batch_size = lambda: batch_size
        self._bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.transforms = list(transforms)
        self._cursor = 0
        self._resume: Optional[dict] = None

    def reset(self):
        pass

    def _source_signature(self):
        sig = ["records", self._bs,
               -1 if self.label_index is None else self.label_index]
        if hasattr(self.reader, "__len__"):
            sig.append(len(self.reader))
        return sig

    def state_dict(self):
        return {"cursor": self._cursor,
                "source": self._source_signature()}

    def load_state_dict(self, state):
        self._arm_resume(state)

    def _records(self, skip: int = 0):
        """Yield (features, label) records, skipping the first
        ``skip`` WITHOUT parsing or decoding them (readers expose
        ``iter_from``; islice would still run the skipped records
        through PIL/float parsing)."""
        src = (self.reader.iter_from(skip)
               if skip and hasattr(self.reader, "iter_from")
               else itertools.islice(iter(self.reader), skip, None)
               if skip else self.reader)
        if isinstance(self.reader, ImageRecordReader):
            for arr, li in src:
                for t in self.transforms:
                    arr = t(arr)
                onehot = np.zeros(len(self.reader.labels), np.float32)
                onehot[li] = 1.0
                yield arr, onehot
        else:
            for row in src:
                vals = [float(v) for v in row]
                for t in self.transforms:
                    vals = t(vals)
                if self.label_index is None:
                    yield np.asarray(vals, np.float32), None
                    continue
                label = vals.pop(self.label_index)
                if self.regression:
                    y = np.asarray([label], np.float32)
                else:
                    y = np.zeros(self.num_classes, np.float32)
                    y[int(label)] = 1.0
                yield np.asarray(vals, np.float32), y

    def _iterate(self):
        # the bounds check needs len(reader), which duck-typed
        # streaming readers may not have — only compute it when a
        # resume is actually armed (plain iteration stays len-free)
        total = None
        if self._resume is not None and hasattr(self.reader, "__len__"):
            total = -(-len(self.reader) // self._bs)
        start = self._consume_resume(total)
        # record-level skip INSIDE the reader: the consumed prefix
        # costs no decode, no parse, no batch assembly, no data.fetch
        recs = self._records(skip=start * self._bs)
        feats, labs = [], []
        for f, y in recs:
            feats.append(f)
            labs.append(y)
            if len(feats) == self._bs:
                self._cursor += 1
                yield fetch_batch(lambda: self._mk(feats, labs))
                feats, labs = [], []
        if feats:
            self._cursor += 1
            yield fetch_batch(lambda: self._mk(feats, labs))

    def _mk(self, feats, labs):
        x = np.stack(feats)
        y = None if labs[0] is None else np.stack(labs)
        return DataSet(x, y)

    def num_examples(self):
        return len(self.reader)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """(SequenceRecordReaderDataSetIterator): sequences (possibly
    unequal length) → padded (B,T,C) + masks; per-step label column."""

    def __init__(self, reader: CSVSequenceRecordReader, batch_size: int,
                 label_index: int, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self._bs = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def reset(self):
        pass

    def _iterate(self):
        seqs = list(self.reader)
        for i in range(0, len(seqs), self._bs):
            chunk = seqs[i:i + self._bs]
            yield self._mk(chunk)

    def _mk(self, chunk):
        T = max(len(s) for s in chunk)
        n_feat = len(chunk[0][0]) - 1
        n_lab = 1 if self.regression else self.num_classes
        B = len(chunk)
        x = np.zeros((B, T, n_feat), np.float32)
        y = np.zeros((B, T, n_lab), np.float32)
        mask = np.zeros((B, T), np.float32)
        for b, seq in enumerate(chunk):
            for t, row in enumerate(seq):
                vals = [float(v) for v in row]
                lab = vals.pop(self.label_index)
                x[b, t] = vals
                if self.regression:
                    y[b, t, 0] = lab
                else:
                    y[b, t, int(lab)] = 1.0
                mask[b, t] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)

    def batch_size(self):
        return self._bs
