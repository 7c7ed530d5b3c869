"""Training listeners (counterpart of
``deeplearning4j_tpu/train/listeners.py``).

Mirrors optimize/api/IterationListener.java + TrainingListener.java and
the impls in optimize/listeners/**: ScoreIterationListener,
PerformanceListener (samples/sec, batches/sec,
PerformanceListener.java:97-119), EvaluativeListener,
CollectScoresIterationListener, TimeIterationListener,
SleepyTrainingListener (debug throttle), CheckpointListener.

Listeners run on the host between steps; the executor calls
``iteration_done`` with the loss as a device tensor, which the step
left without a host sync: a listener that reads it (``float(score)``)
waits for the device, so throughput-sensitive ones (Performance) never
touch it. ``CheckpointListener`` writes through the port's
``write_model``.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "CollectScoresIterationListener",
           "TimeIterationListener", "EvaluativeListener",
           "SleepyTrainingListener", "CheckpointListener",
           "protect_checkpoint", "unprotect_checkpoint",
           "is_checkpoint_protected"]


# Checkpoint files that pruning must never delete: a trainer registers
# its live rollback target here, so a CheckpointListener sharing a
# directory can never prune the file a rollback is about to restore.
_PROTECTED_CHECKPOINTS = set()


def protect_checkpoint(path: str) -> None:
    import os
    _PROTECTED_CHECKPOINTS.add(os.path.abspath(path))


def unprotect_checkpoint(path: str) -> None:
    import os
    _PROTECTED_CHECKPOINTS.discard(os.path.abspath(path))


def is_checkpoint_protected(path: str) -> bool:
    import os
    return os.path.abspath(path) in _PROTECTED_CHECKPOINTS


class TrainingListener:
    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass

    def iteration_done(self, model, iteration: int, score, batch_size: int):
        pass


class ScoreIterationListener(TrainingListener):
    """(optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10):
        self.freq = max(1, print_iterations)

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration % self.freq == 0:
            logger.info("Score at iteration %d is %s", iteration,
                        float(score))


class PerformanceListener(TrainingListener):
    """samples/sec + batches/sec (PerformanceListener.java:97-119)."""

    def __init__(self, frequency: int = 1, report: bool = True):
        self.freq = max(1, frequency)
        self.report = report
        self._last_time = None
        self._samples = 0
        self._batches = 0
        self.last_samples_per_sec: Optional[float] = None
        self.last_batches_per_sec: Optional[float] = None

    def iteration_done(self, model, iteration, score, batch_size):
        self._samples += batch_size
        self._batches += 1
        if iteration % self.freq != 0:
            return
        now = time.perf_counter()
        if self._last_time is not None:
            dt = now - self._last_time
            if dt > 0:
                self.last_samples_per_sec = self._samples / dt
                self.last_batches_per_sec = self._batches / dt
                if self.report:
                    logger.info(
                        "iteration %d: %.1f samples/sec, %.2f batches/sec",
                        iteration, self.last_samples_per_sec,
                        self.last_batches_per_sec)
        self._last_time = now
        self._samples = 0
        self._batches = 0


class CollectScoresIterationListener(TrainingListener):
    """(optimize/listeners/CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.freq = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration % self.freq == 0:
            self.scores.append((iteration, float(score)))


class TimeIterationListener(TrainingListener):
    """ETA logging (optimize/listeners/TimeIterationListener.java)."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.freq = frequency
        self.start = time.time()

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration == 0 or iteration % self.freq != 0:
            return
        elapsed = time.time() - self.start
        rate = elapsed / max(iteration, 1)
        remaining = (self.total - iteration) * rate
        logger.info("iteration %d/%d, remaining ~%.0f s", iteration,
                    self.total, remaining)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator
    (optimize/listeners/EvaluativeListener.java:34)."""

    def __init__(self, iterator, frequency: int = 100,
                 invocation: str = "iteration"):
        self.iterator = iterator
        self.freq = max(1, frequency)
        self.invocation = invocation  # 'iteration' | 'epoch'
        self.evaluations = []

    def _evaluate(self, model):
        ev = model.evaluate(self.iterator)
        self.evaluations.append(ev)
        logger.info("EvaluativeListener:\n%s", ev.stats())

    def iteration_done(self, model, iteration, score, batch_size):
        if self.invocation == "iteration" and iteration > 0 \
                and iteration % self.freq == 0:
            self._evaluate(model)

    def on_epoch_end(self, model):
        if self.invocation == "epoch":
            self._evaluate(model)


class SleepyTrainingListener(TrainingListener):
    """Debug throttle (optimize/listeners/SleepyTrainingListener.java;
    used by SharedTrainingWrapper debugLongerIterations)."""

    def __init__(self, timer_iteration_ms: float = 0.0,
                 timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration, score, batch_size):
        if self.timer_iteration_ms > 0:
            time.sleep(self.timer_iteration_ms / 1000.0)

    def on_epoch_end(self, model):
        if self.timer_epoch_ms > 0:
            time.sleep(self.timer_epoch_ms / 1000.0)


class CheckpointListener(TrainingListener):
    """Periodic model save (reference CheckpointListener semantics)."""

    def __init__(self, directory: str, save_every_n_iterations: int = 1000,
                 keep_last: int = 3):
        import os
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.freq = save_every_n_iterations
        self.keep_last = keep_last
        self._saved: List[str] = []

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration == 0 or iteration % self.freq != 0:
            return
        import os
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model)
        path = os.path.join(self.directory, f"checkpoint_{iteration}.zip")
        write_model(model, path)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if is_checkpoint_protected(old):
                # a trainer's rollback restore target: keep the
                # file, just stop tracking it
                continue
            try:
                os.remove(old)
            except OSError:
                pass
