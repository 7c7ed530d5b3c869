from deeplearning4j_tpu_torch.ml.estimators import (NetworkEstimator,
                                                    NetworkModel)

__all__ = ["NetworkEstimator", "NetworkModel"]
