"""Evaluation of predictions (host numpy, as in the JAX package):
classification, regression, ROC / AUC, calibration, and the HTML
exports of ``evaluation/tools.py``."""

from deeplearning4j_tpu_torch.evaluation.calibration import (
    EvaluationCalibration)
from deeplearning4j_tpu_torch.evaluation.classification import (
    ConfusionMatrix, Evaluation, EvaluationBinary)
from deeplearning4j_tpu_torch.evaluation.regression import (
    RegressionEvaluation)
from deeplearning4j_tpu_torch.evaluation.roc import (ROC, ROCBinary,
                                                     ROCMultiClass)

__all__ = ["Evaluation", "EvaluationBinary", "ConfusionMatrix",
           "RegressionEvaluation", "ROC", "ROCBinary", "ROCMultiClass",
           "EvaluationCalibration"]
