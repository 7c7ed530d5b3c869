"""Host-side data containers, iterators, normalizers, record readers,
dataset fetchers and the native loader (numpy), as in the JAX
package."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator, AsyncDataSetIterator, BenchmarkDataSetIterator,
    DataSetIterator, EarlyTerminationDataSetIterator, ListDataSetIterator,
    MultipleEpochsIterator, SamplingDataSetIterator)

__all__ = [
    "DataSet", "MultiDataSet", "DataSetIterator", "ListDataSetIterator",
    "ArrayDataSetIterator", "AsyncDataSetIterator", "MultipleEpochsIterator",
    "EarlyTerminationDataSetIterator", "SamplingDataSetIterator",
    "BenchmarkDataSetIterator",
]
