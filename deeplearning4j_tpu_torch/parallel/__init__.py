"""Distributed training (counterpart of ``deeplearning4j_tpu/parallel``).

Ported: data parallelism over a ``torch.distributed`` process group, one
rank a device (:mod:`~deeplearning4j_tpu_torch.parallel.mesh`,
:mod:`~deeplearning4j_tpu_torch.parallel.mesh_spec`,
:mod:`~deeplearning4j_tpu_torch.parallel.multihost`,
:mod:`~deeplearning4j_tpu_torch.parallel.wrapper`, the executors'
``fit(mesh_spec=)``), ``ParallelInference``
(:mod:`~deeplearning4j_tpu_torch.parallel.inference`), the asynchronous
parameter server (:mod:`~deeplearning4j_tpu_torch.parallel.paramserver`)
and gradient compression
(:mod:`~deeplearning4j_tpu_torch.parallel.compression`). Tensor,
sequence and pipeline parallelism wait for ROADMAP A6b.
"""

from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    ThresholdCompressor, int8_all_reduce, int8_all_reduce_ef,
    int8_dequantize, int8_quantize_ef, make_compressed_psum,
    make_compressed_psum_ef,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec, build_mesh, device_count,
)
from deeplearning4j_tpu_torch.parallel.paramserver import (  # noqa: F401
    ParameterServer, PSClient, PSWorker, run_async_training,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    GraphParallelWrapper, ParallelWrapper,
)

__all__ = ["MeshSpec", "build_mesh", "device_count", "ParallelWrapper",
           "GraphParallelWrapper", "ParameterServer", "PSClient",
           "PSWorker", "run_async_training", "ThresholdCompressor",
           "int8_all_reduce", "int8_all_reduce_ef", "int8_quantize_ef",
           "int8_dequantize", "make_compressed_psum",
           "make_compressed_psum_ef"]
