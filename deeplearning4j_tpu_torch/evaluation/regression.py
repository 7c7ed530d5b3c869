"""Regression evaluation (counterpart of
``deeplearning4j_tpu/evaluation/regression.py``;
eval/RegressionEvaluation.java): per-column MSE, MAE, RMSE, RSE, PC
(Pearson correlation), R^2."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["RegressionEvaluation"]


class RegressionEvaluation:
    def __init__(self, column_names: Optional[List[str]] = None):
        self.column_names = column_names
        self._n = 0
        self._sum_err2 = None     # sum (p - l)^2
        self._sum_abs = None
        self._sum_l = None
        self._sum_p = None
        self._sum_l2 = None
        self._sum_p2 = None
        self._sum_lp = None

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        if l.ndim == 3:
            c = l.shape[-1]
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
            else:
                m = np.ones(l.shape[0] * l.shape[1], bool)
            l = l.reshape(-1, c)[m]
            p = p.reshape(-1, c)[m]
        if self._sum_err2 is None:
            c = l.shape[-1]
            z = lambda: np.zeros(c, np.float64)
            self._sum_err2, self._sum_abs = z(), z()
            self._sum_l, self._sum_p = z(), z()
            self._sum_l2, self._sum_p2, self._sum_lp = z(), z(), z()
        self._n += l.shape[0]
        d = p - l
        self._sum_err2 += np.sum(d * d, axis=0)
        self._sum_abs += np.sum(np.abs(d), axis=0)
        self._sum_l += np.sum(l, axis=0)
        self._sum_p += np.sum(p, axis=0)
        self._sum_l2 += np.sum(l * l, axis=0)
        self._sum_p2 += np.sum(p * p, axis=0)
        self._sum_lp += np.sum(l * p, axis=0)

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_err2[col] / self._n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self._sum_err2[col] / self._n))

    def relative_squared_error(self, col: int) -> float:
        mean_l = self._sum_l[col] / self._n
        ss_tot = self._sum_l2[col] - self._n * mean_l ** 2
        return float(self._sum_err2[col] / ss_tot) if ss_tot else np.inf

    def pearson_correlation(self, col: int) -> float:
        n = self._n
        cov = self._sum_lp[col] - self._sum_l[col] * self._sum_p[col] / n
        vl = self._sum_l2[col] - self._sum_l[col] ** 2 / n
        vp = self._sum_p2[col] - self._sum_p[col] ** 2 / n
        denom = np.sqrt(vl * vp)
        return float(cov / denom) if denom > 0 else 0.0

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self._sum_err2) / self._n)

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self._sum_abs) / self._n)

    def num_columns(self) -> int:
        return 0 if self._sum_err2 is None else len(self._sum_err2)

    def stats(self) -> str:
        cols = self.column_names or [f"col_{i}"
                                     for i in range(self.num_columns())]
        rows = ["column   MSE        MAE        RMSE       RSE        "
                "PC         R^2"]
        for i, c in enumerate(cols):
            rows.append(
                f"{c:<8} {self.mean_squared_error(i):<10.5f} "
                f"{self.mean_absolute_error(i):<10.5f} "
                f"{self.root_mean_squared_error(i):<10.5f} "
                f"{self.relative_squared_error(i):<10.5f} "
                f"{self.pearson_correlation(i):<10.5f} "
                f"{self.r_squared(i):<10.5f}")
        return "\n".join(rows)
