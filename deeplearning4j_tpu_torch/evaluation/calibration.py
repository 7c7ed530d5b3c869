"""EvaluationCalibration (counterpart of
``deeplearning4j_tpu/evaluation/calibration.py``;
eval/EvaluationCalibration.java): reliability diagram bins, residual
plots (overall + per label class) and probability histograms (overall +
per label class) for classifier calibration analysis, plus expected
calibration error.

Masking contract: ``eval(..., mask=...)`` accepts a per-example mask
(N,) / (N, 1), a per-output mask (N, C), or — for rank-3 time-series
input — a (N, T) timestep mask; masked entries leave EVERY statistic
(reference EvaluationCalibration.java:149-157 applies the mask to the
reliability bins, prediction counts and residual/probability
histograms alike). An unrecognized mask shape raises rather than being
silently ignored.

Deviation from the reference, on purpose: the reference computes its
residual/probability histograms with the RELIABILITY bin width
(EvaluationCalibration.java:144 ``binSize = 1/reliabilityDiagNumBins``
reused at :223-233), so with the default 10/50 split only the first
10 of 50 histogram bins can ever be populated. Here histogram bins
span [0, 1] with width ``1/histogram_bins``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["EvaluationCalibration"]


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.n_bins = reliability_bins
        self.hist_bins = histogram_bins
        self.reset()

    def reset(self):
        self._bin_counts = None       # (classes, bins)
        self._bin_pos = None
        self._bin_prob_sum = None
        self._label_counts = None
        self._pred_counts = None
        self._residual_overall = None     # (hist_bins,)
        self._residual_by_class = None    # (classes, hist_bins), pos labels
        self._prob_overall = None
        self._prob_by_class = None

    # ------------------------------------------------------------ eval

    def _as_element_mask(self, mask, n, c, timesteps: Optional[int]):
        """Normalize the mask to a boolean (N, C) element mask (N is
        already flattened over time for rank-3 input)."""
        m = np.asarray(mask)
        if timesteps is not None:
            # time series: (B, T) timestep mask, rows flattened the
            # same way labels/predictions were; a pre-flattened (B*T,)
            # vector is also accepted. Anything else raises — a
            # transposed (T, B) mask has the right SIZE but would
            # land on the wrong (batch, time) cells.
            if m.shape == (n // timesteps, timesteps):
                m = m.reshape(-1)
            elif m.shape != (n,):
                raise ValueError(
                    f"time-series mask shape {m.shape} does not "
                    f"match (batch, timesteps)=("
                    f"{n // timesteps}, {timesteps}) or ({n},)")
            return np.broadcast_to((m > 0)[:, None], (n, c))
        if m.ndim == 1 and m.shape[0] == n:
            return np.broadcast_to((m > 0)[:, None], (n, c))
        if m.ndim == 2 and m.shape == (n, 1):
            return np.broadcast_to(m > 0, (n, c))
        if m.ndim == 2 and m.shape == (n, c):
            return m > 0
        raise ValueError(
            f"mask shape {m.shape} unsupported: want per-example "
            f"({n},)/({n}, 1) or per-output ({n}, {c})")

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        timesteps = None
        if l.ndim == 3:
            timesteps = l.shape[1]
            c = l.shape[-1]
            l = l.reshape(-1, c)
            p = p.reshape(-1, c)
        n, c = p.shape
        if self._bin_counts is None:
            self._bin_counts = np.zeros((c, self.n_bins), np.int64)
            self._bin_pos = np.zeros((c, self.n_bins), np.int64)
            self._bin_prob_sum = np.zeros((c, self.n_bins), np.float64)
            self._label_counts = np.zeros(c, np.int64)
            self._pred_counts = np.zeros(c, np.int64)
            self._residual_overall = np.zeros(self.hist_bins, np.int64)
            self._residual_by_class = np.zeros((c, self.hist_bins),
                                               np.int64)
            self._prob_overall = np.zeros(self.hist_bins, np.int64)
            self._prob_by_class = np.zeros((c, self.hist_bins), np.int64)

        m = (np.ones((n, c), bool) if mask is None
             else self._as_element_mask(mask, n, c, timesteps))

        bins = np.clip((p * self.n_bins).astype(int), 0, self.n_bins - 1)
        hbins = np.clip((p * self.hist_bins).astype(int), 0,
                        self.hist_bins - 1)
        resid = np.abs(l - p)
        rbins = np.clip((resid * self.hist_bins).astype(int), 0,
                        self.hist_bins - 1)
        pos = (l >= 0.5) & m

        for i in range(c):
            sel = m[:, i]
            np.add.at(self._bin_counts[i], bins[sel, i], 1)
            np.add.at(self._bin_pos[i], bins[sel, i], pos[sel, i])
            np.add.at(self._bin_prob_sum[i], bins[sel, i], p[sel, i])
            np.add.at(self._prob_overall, hbins[sel, i], 1)
            np.add.at(self._residual_overall, rbins[sel, i], 1)
            # per-label-class rows: POSITIVE instances of class i
            # (reference residualPlotByLabelClass /
            # probHistogramByLabelClass accumulate l * bitmask)
            np.add.at(self._residual_by_class[i], rbins[pos[:, i], i], 1)
            np.add.at(self._prob_by_class[i], hbins[pos[:, i], i], 1)
        self._label_counts += pos.sum(axis=0)
        # prediction counts: argmax row one-hot, then masked
        # elementwise (reference IsMax + LossUtil.applyMask)
        onehot = np.zeros((n, c), bool)
        onehot[np.arange(n), p.argmax(axis=1)] = True
        self._pred_counts += (onehot & m).sum(axis=0)

    # --------------------------------------------------------- getters

    def reliability_diagram(self, cls: int):
        """Returns (mean_predicted_prob, observed_frequency) per bin."""
        counts = np.maximum(self._bin_counts[cls], 1)
        mean_pred = self._bin_prob_sum[cls] / counts
        observed = self._bin_pos[cls] / counts
        return mean_pred, observed

    def expected_calibration_error(self, cls: int) -> float:
        counts = self._bin_counts[cls]
        total = max(int(counts.sum()), 1)
        mean_pred, observed = self.reliability_diagram(cls)
        return float(np.sum(counts / total * np.abs(mean_pred - observed)))

    def _hist_edges(self):
        return np.linspace(0.0, 1.0, self.hist_bins + 1)

    def residual_plot(self, cls: Optional[int] = None):
        """Histogram of |label − predicted probability| over all
        (example, class) entries: ``(bin_edges, counts)``. With
        ``cls``, counts only the POSITIVE instances of that class
        (reference getResidualPlot / residualPlotByLabelClass,
        EvaluationCalibration.java:69-76, 208-246)."""
        counts = (self._residual_overall if cls is None
                  else self._residual_by_class[cls])
        return self._hist_edges(), counts.copy()

    def probability_histogram(self, cls: Optional[int] = None):
        """Histogram of predicted probabilities over all (example,
        class) entries, or over the positive instances of ``cls``
        (reference getProbabilityHistogram)."""
        counts = (self._prob_overall if cls is None
                  else self._prob_by_class[cls])
        return self._hist_edges(), counts.copy()

    @property
    def label_counts(self):
        """Observed positive-label count per class."""
        return self._label_counts.copy()

    @property
    def prediction_counts(self):
        """Predicted (argmax) count per class, mask-aware."""
        return self._pred_counts.copy()

    def num_classes(self) -> int:
        return -1 if self._bin_counts is None else self._bin_counts.shape[0]

    # ----------------------------------------------------------- merge

    def merge(self, other: "EvaluationCalibration"):
        """Accumulate another instance's statistics (reference
        BaseEvaluation.merge contract — distributed eval combines
        per-shard instances)."""
        if (self.n_bins, self.hist_bins) != (other.n_bins,
                                             other.hist_bins):
            raise ValueError(
                "cannot merge EvaluationCalibration instances with "
                "different bin counts")
        if other._bin_counts is None:
            return
        if self._bin_counts is None:
            for name in ("_bin_counts", "_bin_pos", "_bin_prob_sum",
                         "_label_counts", "_pred_counts",
                         "_residual_overall", "_residual_by_class",
                         "_prob_overall", "_prob_by_class"):
                setattr(self, name, getattr(other, name).copy())
            return
        for name in ("_bin_counts", "_bin_pos", "_bin_prob_sum",
                     "_label_counts", "_pred_counts",
                     "_residual_overall", "_residual_by_class",
                     "_prob_overall", "_prob_by_class"):
            getattr(self, name).__iadd__(getattr(other, name))

    def stats(self) -> str:
        c = self.num_classes()
        if c < 0:
            return "EvaluationCalibration: no data"
        lines = [f"EvaluationCalibration (classes={c}, "
                 f"reliability bins={self.n_bins}, "
                 f"histogram bins={self.hist_bins})"]
        for i in range(c):
            lines.append(f"  class {i}: ECE="
                         f"{self.expected_calibration_error(i):.4f}, "
                         f"labels={int(self._label_counts[i])}, "
                         f"predicted={int(self._pred_counts[i])}")
        return "\n".join(lines)
