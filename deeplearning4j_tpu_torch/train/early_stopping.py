"""Early stopping (counterpart of
``deeplearning4j_tpu/train/early_stopping.py``).

Mirrors earlystopping/**: EarlyStoppingConfiguration, termination
conditions (termination/*.java: MaxEpochsTerminationCondition,
MaxTimeIterationTerminationCondition, MaxScoreIterationTermination
Condition, ScoreImprovementEpochTerminationCondition,
InvalidScoreIterationTerminationCondition, BestScoreEpochTermination
Condition), model savers (saver/LocalFileModelSaver, InMemoryModelSaver)
and the trainer fit loop (trainer/BaseEarlyStoppingTrainer.java:76).

Score calculators mirror ScoreCalculator: default is loss on a test
iterator (DataSetLossCalculator).

The port's parameters are ``nn.Parameter`` tensors that the updater
changes in place, so ``InMemoryModelSaver.restore_best`` copies the
saved values into the live tensors (the modules and the updater keep
pointing at them) where the JAX package assigns new trees, and
``LocalFileModelSaver.restore_best`` restores onto the model's own
device.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
from deeplearning4j_tpu_torch.util.tree import tree_copy

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult",
    "EarlyStoppingTrainer", "MaxEpochsTerminationCondition",
    "MaxTimeTerminationCondition", "MaxScoreTerminationCondition",
    "InvalidScoreTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition", "LocalFileModelSaver",
    "InMemoryModelSaver", "DataSetLossCalculator",
]


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------

class EpochTerminationCondition:
    requires_score = True      # False → checked even on unscored epochs

    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no score improvement
    (ScoreImprovementEpochTerminationCondition.java)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = math.inf
        self.epochs_without = 0

    def initialize(self):
        self.best = math.inf
        self.epochs_without = 0

    def terminate(self, epoch, score):
        if score < self.best - self.min_improvement:
            self.best = score
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without > self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score is at/below a target
    (BestScoreEpochTerminationCondition.java)."""

    def __init__(self, target_score: float):
        self.target = target_score

    def terminate(self, epoch, score):
        return score <= self.target


class MaxTimeTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self.start = None

    def initialize(self):
        self.start = time.time()

    def terminate(self, last_score):
        return (time.time() - self.start) > self.max_seconds


class MaxScoreTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score


class InvalidScoreTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)


# ---------------------------------------------------------------------------
# savers
# ---------------------------------------------------------------------------

class InMemoryModelSaver:
    """(saver/InMemoryModelSaver.java): copies of the params and the
    state; the updater state is not saved, as in the JAX package."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, model):
        self.best = (tree_copy(model.params), tree_copy(model.state))

    def save_latest(self, model):
        self.latest = (tree_copy(model.params), tree_copy(model.state))

    def restore_best(self, model):
        if self.best is not None:
            params, state = self.best
            # into the live tensors: the layers' modules and the updater
            # hold these, and a later fit() updates them in place
            with torch.no_grad():
                for live, saved in zip(tree_leaves(model.params),
                                       tree_leaves(params)):
                    live.copy_(saved)
            model.state = tree_copy(state)
        return model


class LocalFileModelSaver:
    """(saver/LocalFileModelSaver.java): bestModel.zip / latestModel.zip."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save_best(self, model):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model)
        write_model(model, os.path.join(self.directory, "bestModel.zip"))

    def save_latest(self, model):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model)
        write_model(model, os.path.join(self.directory, "latestModel.zip"))

    def restore_best(self, model):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model)
        return restore_model(os.path.join(self.directory, "bestModel.zip"),
                             device=model.device)


# ---------------------------------------------------------------------------
# score calculators
# ---------------------------------------------------------------------------

class DataSetLossCalculator:
    """Average loss over a held-out iterator
    (scorecalc/DataSetLossCalculator.java)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total = 0.0
        n = 0
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


# ---------------------------------------------------------------------------
# config + result + trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = \
        dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        dataclasses.field(default_factory=list)
    score_calculator: Optional[object] = None
    model_saver: object = dataclasses.field(
        default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str            # 'epoch' | 'iteration' | 'error'
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object


class EarlyStoppingTrainer:
    """(trainer/BaseEarlyStoppingTrainer.java:76 fit loop)."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        model = self.model
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        if model.params is None:
            model.init()

        best_score = math.inf
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        reason, details = "epoch", "max epochs"

        class _IterationGuard:
            """Listener that raises to stop mid-epoch on iteration
            conditions (reference checks per-minibatch)."""
            class Stop(Exception):
                def __init__(self, cond):
                    self.cond = cond

            def __init__(self, conds):
                self.conds = conds

            def on_epoch_start(self, m):
                pass

            def on_epoch_end(self, m):
                pass

            def iteration_done(self, m, it, score, bs):
                s = float(score)
                for c in self.conds:
                    if c.terminate(s):
                        raise _IterationGuard.Stop(c)

        guard = _IterationGuard(cfg.iteration_termination_conditions)
        saved_listeners = list(model.listeners)
        model.listeners = saved_listeners + [guard]
        try:
            while True:
                try:
                    model.fit(self.train_iterator, epochs=1)
                except _IterationGuard.Stop as stop:
                    reason = "iteration"
                    details = type(stop.cond).__name__
                    break
                # score this epoch; with a score calculator, epochs it
                # skips are NOT scored at all (mixing train loss into
                # best-model selection would compare different metrics —
                # reference BaseEarlyStoppingTrainer skips them too)
                score = None
                if cfg.score_calculator is not None:
                    if epoch % cfg.evaluate_every_n_epochs == 0:
                        score = float(
                            cfg.score_calculator.calculate_score(model))
                else:
                    score = float(model.score_value)
                if score is not None:
                    score_vs_epoch[epoch] = score
                    if score < best_score:
                        best_score = score
                        best_epoch = epoch
                        cfg.model_saver.save_best(model)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest(model)
                stop_now = False
                for c in cfg.epoch_termination_conditions:
                    if score is None and c.requires_score:
                        continue
                    if c.terminate(epoch, score):
                        reason = "epoch"
                        details = type(c).__name__
                        stop_now = True
                        break
                epoch += 1
                if stop_now:
                    break
        finally:
            model.listeners = saved_listeners

        best_model = cfg.model_saver.restore_best(model) \
            if best_epoch >= 0 else model
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            total_epochs=epoch, best_model_epoch=best_epoch,
            best_model_score=best_score, score_vs_epoch=score_vs_epoch,
            best_model=best_model)
