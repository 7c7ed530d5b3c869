from deeplearning4j_tpu_torch.services.nearest_neighbors import (
    NearestNeighborsServer, NearestNeighborsClient,
)

__all__ = ["NearestNeighborsServer", "NearestNeighborsClient"]
