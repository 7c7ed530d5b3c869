"""DataSet / MultiDataSet containers (counterpart of
``deeplearning4j_tpu/data/dataset.py``).

ND4J's DataSet (features, labels, feature mask, label mask) and
MultiDataSet (lists of each). Arrays are host numpy until the train step
moves a batch to the network's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["DataSet", "MultiDataSet"]


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (DataSet(*[a[:n_train] if a is not None else None
                          for a in self._arrays()]),
                DataSet(*[a[n_train:] if a is not None else None
                          for a in self._arrays()]))

    def _arrays(self):
        return (self.features, self.labels, self.features_mask,
                self.labels_mask)

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(*[a[idx] if a is not None else None
                         for a in self._arrays()])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [DataSet(*[a[i:i + batch_size] if a is not None else None
                          for a in self._arrays()])
                for i in range(0, n, batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(xs):
            xs = [x for x in xs if x is not None]
            return np.concatenate(xs, axis=0) if xs else None
        return DataSet(cat([d.features for d in datasets]),
                       cat([d.labels for d in datasets]),
                       cat([d.features_mask for d in datasets]),
                       cat([d.labels_mask for d in datasets]))


@dataclasses.dataclass
class MultiDataSet:
    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
