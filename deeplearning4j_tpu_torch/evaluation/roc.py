"""ROC / AUC evaluation (counterpart of
``deeplearning4j_tpu/evaluation/roc.py``).

Mirrors eval/ROC.java, ROCBinary.java, ROCMultiClass.java + the curve
classes under eval/curves/. ``threshold_steps=0`` gives exact AUC (all
distinct scores as thresholds, the reference's "exact" mode); >0 uses
that many evenly spaced thresholds (the reference's histogram mode).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["ROC", "ROCBinary", "ROCMultiClass", "RocCurve",
           "PrecisionRecallCurve"]


class RocCurve:
    def __init__(self, thresholds, fpr, tpr):
        self.thresholds = thresholds
        self.fpr = fpr
        self.tpr = tpr

    def area(self) -> float:
        # trapezoidal integration over FPR (sorted ascending)
        order = np.argsort(self.fpr, kind="stable")
        return float(np.trapezoid(self.tpr[order], self.fpr[order]))


class PrecisionRecallCurve:
    def __init__(self, thresholds, precision, recall):
        self.thresholds = thresholds
        self.precision = precision
        self.recall = recall

    def area(self) -> float:
        order = np.argsort(self.recall, kind="stable")
        return float(np.trapezoid(self.precision[order], self.recall[order]))


class ROC:
    """Binary ROC on probability scores (positive class = column 1 of a
    2-col one-hot, or the single column for 1-d outputs)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions):
        l = np.asarray(labels)
        p = np.asarray(predictions)
        if l.ndim > 1 and l.shape[-1] == 2:
            l = l[..., 1]
            p = p[..., 1]
        self._labels.append(l.ravel())
        self._scores.append(p.ravel())

    def _collect(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.concatenate(self._labels) >= 0.5,
                np.concatenate(self._scores))

    def get_roc_curve(self) -> RocCurve:
        y, s = self._collect()
        if self.threshold_steps > 0:
            thr = np.linspace(0, 1, self.threshold_steps + 1)
        else:
            thr = np.unique(s)[::-1]
            thr = np.concatenate([[np.inf], thr])
        pos = max(int(y.sum()), 1)
        neg = max(int((~y).sum()), 1)
        tpr = np.array([np.sum((s >= t) & y) / pos for t in thr])
        fpr = np.array([np.sum((s >= t) & ~y) / neg for t in thr])
        return RocCurve(thr, fpr, tpr)

    def get_precision_recall_curve(self) -> PrecisionRecallCurve:
        y, s = self._collect()
        if self.threshold_steps > 0:
            thr = np.linspace(0, 1, self.threshold_steps + 1)
        else:
            thr = np.unique(s)[::-1]
        prec, rec = [], []
        pos = max(int(y.sum()), 1)
        for t in thr:
            sel = s >= t
            tp = np.sum(sel & y)
            prec.append(tp / max(int(sel.sum()), 1))
            rec.append(tp / pos)
        return PrecisionRecallCurve(thr, np.array(prec), np.array(rec))

    def calculate_auc(self) -> float:
        """Exact AUC via rank statistic (matches reference exact mode)."""
        y, s = self._collect()
        n_pos = int(y.sum())
        n_neg = len(y) - n_pos
        if n_pos == 0 or n_neg == 0:
            return 0.0
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty(len(s), dtype=np.float64)
        sorted_s = s[order]
        i = 0
        r = 1
        while i < len(s):
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            avg = 0.5 * (r + r + (j - i))
            ranks[order[i:j + 1]] = avg
            r += (j - i + 1)
            i = j + 1
        sum_pos = ranks[y].sum()
        return float((sum_pos - n_pos * (n_pos + 1) / 2)
                     / (n_pos * n_neg))

    def calculate_auprc(self) -> float:
        return self.get_precision_recall_curve().area()


class ROCBinary:
    """Per-output ROC for multi-label networks (eval/ROCBinary.java)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._per_col: List[ROC] = []

    def eval(self, labels, predictions):
        l = np.asarray(labels)
        p = np.asarray(predictions)
        c = l.shape[-1]
        while len(self._per_col) < c:
            self._per_col.append(ROC(self.threshold_steps))
        for i in range(c):
            self._per_col[i].eval(l[..., i], p[..., i])

    def calculate_auc(self, col: int) -> float:
        return self._per_col[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_col]))


class ROCMultiClass:
    """One-vs-all ROC per class (eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._per_class: List[ROC] = []

    def eval(self, labels, predictions):
        l = np.asarray(labels)
        p = np.asarray(predictions)
        c = p.shape[-1]
        while len(self._per_class) < c:
            self._per_class.append(ROC(self.threshold_steps))
        if l.ndim > 1 and l.shape[-1] == c:
            onehot = l
        else:
            onehot = np.eye(c)[l.astype(int).ravel()]
        for i in range(c):
            self._per_class[i].eval(onehot[..., i], p[..., i])

    def calculate_auc(self, cls: int) -> float:
        return self._per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_class]))
