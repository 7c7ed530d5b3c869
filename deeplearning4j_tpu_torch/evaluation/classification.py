"""Classification evaluation (counterpart of
``deeplearning4j_tpu/evaluation/classification.py``; host numpy, the
same definitions): accuracy, per-class and macro precision, recall and
F1, the confusion matrix, top-N accuracy, and per-output binary stats
for multi-label sigmoid outputs. A (B, T, C) time series is flattened
with its mask applied.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary"]


class ConfusionMatrix:
    """(eval/ConfusionMatrix.java) — integer counts[actual][predicted]."""

    def __init__(self, n_classes: int):
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def to_string(self, labels: Optional[List[str]] = None) -> str:
        n = self.matrix.shape[0]
        labels = labels or [str(i) for i in range(n)]
        w = max(5, max(len(l) for l in labels) + 1)
        head = " " * w + "".join(f"{l:>{w}}" for l in labels)
        rows = [head]
        for i in range(n):
            rows.append(f"{labels[i]:>{w}}"
                        + "".join(f"{self.matrix[i, j]:>{w}}"
                                  for j in range(n)))
        return "\n".join(rows)


class Evaluation:
    """(eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self.n_classes = n_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n = 1
        self._total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels, predictions, mask=None, top_n: int = 1):
        """labels: one-hot or int class ids; predictions: probabilities.
        3-d (B,T,C) time series are flattened with mask applied
        (reference evalTimeSeries)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            b, t, c = labels.shape
            if mask is not None:
                m = np.asarray(mask).reshape(b * t) > 0
            else:
                m = np.ones(b * t, dtype=bool)
            labels = labels.reshape(b * t, c)[m]
            predictions = predictions.reshape(b * t, -1)[m]
        if labels.ndim == 2 and labels.shape[1] > 1:
            actual = np.argmax(labels, axis=1)
        else:
            actual = labels.astype(np.int64).ravel()
        predicted = np.argmax(predictions, axis=1)
        self._ensure(predictions.shape[1])
        self.confusion.add(actual, predicted)
        self._total += len(actual)
        if top_n > 1:
            self.top_n = top_n
            topk = np.argsort(-predictions, axis=1)[:, :top_n]
            self.top_n_correct += int(np.sum(topk == actual[:, None]))

    # ---- metrics (definitions match Evaluation.java) ----
    def _diag(self):
        return np.diag(self.confusion.matrix)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        tot = m.sum()
        return float(self._diag().sum() / tot) if tot else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self._total if self._total else 0.0

    def true_positives(self) -> np.ndarray:
        return self._diag()

    def false_positives(self) -> np.ndarray:
        return self.confusion.matrix.sum(axis=0) - self._diag()

    def false_negatives(self) -> np.ndarray:
        return self.confusion.matrix.sum(axis=1) - self._diag()

    def precision(self, cls: Optional[int] = None) -> float:
        tp = self._diag().astype(float)
        denom = self.confusion.matrix.sum(axis=0).astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(denom > 0, tp / denom, np.nan)
        if cls is not None:
            return float(per[cls]) if not np.isnan(per[cls]) else 0.0
        valid = ~np.isnan(per)
        return float(np.mean(per[valid])) if valid.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        tp = self._diag().astype(float)
        denom = self.confusion.matrix.sum(axis=1).astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(denom > 0, tp / denom, np.nan)
        if cls is not None:
            return float(per[cls]) if not np.isnan(per[cls]) else 0.0
        valid = ~np.isnan(per)
        return float(np.mean(per[valid])) if valid.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        p, r = self.precision(), self.recall()
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def matthews_correlation(self, cls: int) -> float:
        m = self.confusion.matrix
        tp = float(m[cls, cls])
        fp = float(m[:, cls].sum() - tp)
        fn = float(m[cls, :].sum() - tp)
        tn = float(m.sum() - tp - fp - fn)
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return (tp * tn - fp * fn) / denom if denom > 0 else 0.0

    def stats(self) -> str:
        names = self.label_names or [str(i)
                                     for i in range(self.n_classes or 0)]
        out = [
            "========================Evaluation Metrics=================",
            f" # of classes:    {self.n_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            out.append(f" Top-{self.top_n} accuracy: "
                       f"{self.top_n_accuracy():.4f}")
        out += ["", "=========================Confusion Matrix==================",
                self.confusion.to_string(names) if self.confusion else "",
                "============================================================"]
        return "\n".join(out)


class EvaluationBinary:
    """Per-output binary classification stats for multi-label sigmoid
    outputs (eval/EvaluationBinary.java)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = None
        self.fp = None
        self.tn = None
        self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = (np.asarray(predictions) >= self.threshold)
        actual = labels >= 0.5
        if mask is not None:
            m = np.asarray(mask) > 0
        else:
            m = np.ones_like(actual, dtype=bool)
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        flat = lambda a: a.reshape(-1, a.shape[-1])
        a, p, mm = flat(actual), flat(preds), flat(m)
        self.tp += np.sum(a & p & mm, axis=0)
        self.fp += np.sum(~a & p & mm, axis=0)
        self.tn += np.sum(~a & ~p & mm, axis=0)
        self.fn += np.sum(a & ~p & mm, axis=0)

    def accuracy(self, i: int) -> float:
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def stats(self) -> str:
        n = len(self.tp) if self.tp is not None else 0
        rows = ["label  acc     precision recall  f1"]
        for i in range(n):
            rows.append(f"{i:<6} {self.accuracy(i):.4f}  "
                        f"{self.precision(i):.4f}    {self.recall(i):.4f}  "
                        f"{self.f1(i):.4f}")
        return "\n".join(rows)
