"""Evaluation of predictions (ported so far: classification)."""

from deeplearning4j_tpu_torch.evaluation.classification import (
    ConfusionMatrix, Evaluation, EvaluationBinary)

__all__ = ["ConfusionMatrix", "Evaluation", "EvaluationBinary"]
