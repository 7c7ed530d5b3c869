"""Training utilities: per-layer gradient normalization, parameter
constraints, training listeners and early stopping."""

from deeplearning4j_tpu_torch.train.listeners import (
    TrainingListener, ScoreIterationListener, PerformanceListener,
    CollectScoresIterationListener, TimeIterationListener,
    EvaluativeListener, SleepyTrainingListener, CheckpointListener,
)

__all__ = [
    "TrainingListener", "ScoreIterationListener", "PerformanceListener",
    "CollectScoresIterationListener", "TimeIterationListener",
    "EvaluativeListener", "SleepyTrainingListener", "CheckpointListener",
]
