"""Distributed training (counterpart of ``deeplearning4j_tpu/parallel``).

Ported so far: the asynchronous parameter server
(:mod:`~deeplearning4j_tpu_torch.parallel.paramserver`) and gradient
compression (:mod:`~deeplearning4j_tpu_torch.parallel.compression`).
The mesh, ``ParallelWrapper`` and the other parallel modules come with
ROADMAP A6.
"""

from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    ThresholdCompressor, int8_all_reduce, int8_all_reduce_ef,
    int8_dequantize, int8_quantize_ef, make_compressed_psum,
    make_compressed_psum_ef,
)
from deeplearning4j_tpu_torch.parallel.paramserver import (  # noqa: F401
    ParameterServer, PSClient, PSWorker, run_async_training,
)

__all__ = ["ParameterServer", "PSClient", "PSWorker",
           "run_async_training", "ThresholdCompressor",
           "int8_all_reduce", "int8_all_reduce_ef", "int8_quantize_ef",
           "int8_dequantize", "make_compressed_psum",
           "make_compressed_psum_ef"]
