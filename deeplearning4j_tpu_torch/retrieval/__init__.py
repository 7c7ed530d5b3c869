"""Device-resident vector search (counterpart of
``deeplearning4j_tpu/retrieval``): batched on-device embedding
(:mod:`~deeplearning4j_tpu_torch.retrieval.embedder`) and top-k vector
search (:mod:`~deeplearning4j_tpu_torch.retrieval.index`: a brute-force
matmul index plus an IVF coarse quantizer), served through the
scheduler/router stack by
:mod:`deeplearning4j_tpu_torch.serving.retrieval_backend`.
"""

from deeplearning4j_tpu_torch.retrieval.index import (  # noqa: F401
    BruteForceIndex, IVFIndex, pow2_bucket,
)
from deeplearning4j_tpu_torch.retrieval.embedder import (  # noqa: F401
    TextEmbedder,
)

__all__ = ["BruteForceIndex", "IVFIndex", "TextEmbedder",
           "pow2_bucket"]
