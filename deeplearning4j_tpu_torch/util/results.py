"""Simple classification-result wrappers (counterpart of
``deeplearning4j_tpu/util/results.py``).

Mirrors nn/simple/binary/BinaryClassificationResult.java and
nn/simple/multiclass/RankClassificationResult.java: thin convenience
views over raw network outputs. The probabilities may be numpy arrays
or tensors on any device (an ``output`` of the port's networks): they
are read to the host once, at construction.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["BinaryClassificationResult", "RankClassificationResult"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class BinaryClassificationResult:
    def __init__(self, probabilities, threshold: float = 0.5):
        p = _host(probabilities)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        self.probabilities = p.ravel()
        self.threshold = threshold

    def predicted(self) -> np.ndarray:
        return (self.probabilities >= self.threshold).astype(np.int32)

    def probability_of(self, i: int) -> float:
        return float(self.probabilities[i])


class RankClassificationResult:
    """Per-example class ranking by probability."""

    def __init__(self, probabilities, labels: Optional[List[str]] = None):
        self.probabilities = _host(probabilities)
        n = self.probabilities.shape[-1]
        self.labels = labels or [str(i) for i in range(n)]

    def ranked_classes(self, i: int) -> List[str]:
        order = np.argsort(-self.probabilities[i])
        return [self.labels[j] for j in order]

    def max_outcome(self, i: int) -> str:
        return self.labels[int(np.argmax(self.probabilities[i]))]

    def max_outcomes(self) -> List[str]:
        return [self.max_outcome(i)
                for i in range(self.probabilities.shape[0])]
