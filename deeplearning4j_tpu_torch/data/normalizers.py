"""Data normalizers (counterpart of
``deeplearning4j_tpu/data/normalizers.py``).

Mirrors ND4J's DataNormalization family used throughout the reference
(NormalizerStandardize, NormalizerMinMaxScaler,
ImagePreProcessingScaler, NormalizerStandardizeLabels option), with the
same fit/transform/revert lifecycle and checkpoint persistence (the
``normalizer.bin`` entry of ModelSerializer zips — here a JSON-able
state dict stored in metadata).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet

__all__ = ["NormalizerStandardize", "NormalizerMinMaxScaler",
           "ImagePreProcessingScaler", "normalizer_from_dict"]


class _BaseNormalizer:
    kind = "base"

    def fit(self, data) -> "_BaseNormalizer":
        """data: DataSet or DataSetIterator."""
        if isinstance(data, DataSet):
            self._fit_arrays([data.features], [data.labels])
        else:
            feats, labs = [], []
            for ds in data:
                feats.append(ds.features)
                labs.append(ds.labels)
            self._fit_arrays(feats, labs)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform_features(ds.features),
                       self.transform_labels(ds.labels),
                       ds.features_mask, ds.labels_mask)

    # aliases matching the reference's preProcess naming
    def pre_process(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    def transform_labels(self, labels):
        return labels

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def _axes(x):
        # statistics per final-axis feature, pooled over batch/time/space
        return tuple(range(x.ndim - 1))


class NormalizerStandardize(_BaseNormalizer):
    """Zero-mean unit-variance per feature (NormalizerStandardize)."""

    kind = "standardize"

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = fit_labels
        self.mean = None
        self.std = None
        self.label_mean = None
        self.label_std = None

    def _fit_arrays(self, feats, labs):
        x = np.concatenate([f.reshape(-1, f.shape[-1]) for f in feats])
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0) + 1e-8
        if self.fit_labels and labs[0] is not None:
            y = np.concatenate([l.reshape(-1, l.shape[-1]) for l in labs])
            self.label_mean = y.mean(axis=0)
            self.label_std = y.std(axis=0) + 1e-8

    def transform_features(self, x):
        return (x - self.mean) / self.std

    def transform_labels(self, y):
        if y is None or self.label_mean is None:
            return y
        return (y - self.label_mean) / self.label_std

    def revert_features(self, x):
        return x * self.std + self.mean

    def revert_labels(self, y):
        if self.label_mean is None:
            return y
        return y * self.label_std + self.label_mean

    def to_dict(self):
        return {"kind": self.kind, "fit_labels": self.fit_labels,
                "mean": self.mean.tolist(), "std": self.std.tolist(),
                "label_mean": (None if self.label_mean is None
                               else self.label_mean.tolist()),
                "label_std": (None if self.label_std is None
                              else self.label_std.tolist())}

    @staticmethod
    def from_dict(d):
        n = NormalizerStandardize(d.get("fit_labels", False))
        n.mean = np.asarray(d["mean"])
        n.std = np.asarray(d["std"])
        if d.get("label_mean") is not None:
            n.label_mean = np.asarray(d["label_mean"])
            n.label_std = np.asarray(d["label_std"])
        return n


class NormalizerMinMaxScaler(_BaseNormalizer):
    """Scale features to [lo, hi] (NormalizerMinMaxScaler)."""

    kind = "minmax"

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo = lo
        self.hi = hi
        self.min = None
        self.max = None

    def _fit_arrays(self, feats, labs):
        x = np.concatenate([f.reshape(-1, f.shape[-1]) for f in feats])
        self.min = x.min(axis=0)
        self.max = x.max(axis=0)

    def transform_features(self, x):
        span = np.where(self.max > self.min, self.max - self.min, 1.0)
        return (x - self.min) / span * (self.hi - self.lo) + self.lo

    def revert_features(self, x):
        span = np.where(self.max > self.min, self.max - self.min, 1.0)
        return (x - self.lo) / (self.hi - self.lo) * span + self.min

    def to_dict(self):
        return {"kind": self.kind, "lo": self.lo, "hi": self.hi,
                "min": self.min.tolist(), "max": self.max.tolist()}

    @staticmethod
    def from_dict(d):
        n = NormalizerMinMaxScaler(d["lo"], d["hi"])
        n.min = np.asarray(d["min"])
        n.max = np.asarray(d["max"])
        return n


class ImagePreProcessingScaler(_BaseNormalizer):
    """uint8 pixels → [lo, hi] (ImagePreProcessingScaler); stateless."""

    kind = "image"

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_pixel: float = 255.0):
        self.lo = lo
        self.hi = hi
        self.max_pixel = max_pixel

    def _fit_arrays(self, feats, labs):
        pass

    def fit(self, data):
        return self

    def transform_features(self, x):
        return x / self.max_pixel * (self.hi - self.lo) + self.lo

    def revert_features(self, x):
        return (x - self.lo) / (self.hi - self.lo) * self.max_pixel

    def to_dict(self):
        return {"kind": self.kind, "lo": self.lo, "hi": self.hi,
                "max_pixel": self.max_pixel}

    @staticmethod
    def from_dict(d):
        return ImagePreProcessingScaler(d["lo"], d["hi"], d["max_pixel"])


_KINDS = {"standardize": NormalizerStandardize,
          "minmax": NormalizerMinMaxScaler,
          "image": ImagePreProcessingScaler}


def normalizer_from_dict(d: Optional[dict]):
    if d is None:
        return None
    return _KINDS[d["kind"]].from_dict(d)
