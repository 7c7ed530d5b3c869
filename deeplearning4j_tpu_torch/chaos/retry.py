"""Shared retry policy: bounded attempts, exponential backoff with
full jitter, deadline-aware budget.

Counterpart of ``deeplearning4j_tpu/chaos/retry.py``
(host code, stdlib only).

One policy object, used everywhere transient I/O is retried (data
iterators, dataset fetchers) — retry behaviour is a resilience
POLICY, and a fix to it must not silently miss a call site. The
backoff follows the standard full-jitter scheme: attempt ``k`` sleeps
``uniform(0, min(max_delay, base_delay * multiplier**k))``, which
de-correlates a thundering herd of retriers while keeping the
expected wait half the deterministic schedule.

Deadline awareness: ``call(..., deadline=t)`` never sleeps past a
``time.monotonic()`` deadline — when the next backoff would overrun
the budget, the last failure is raised immediately instead of burning
the caller's remaining time asleep.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["RetryPolicy", "DEFAULT_IO_RETRY", "retrying_io"]


class RetryPolicy:
    """Immutable-ish retry policy; ``call`` runs a function under it.

    ``retry_on`` is the default tuple of exception types considered
    transient; anything else propagates on the first failure.
    """

    def __init__(self, max_attempts: int = 6,
                 base_delay: float = 0.02, max_delay: float = 1.0,
                 multiplier: float = 2.0, jitter: bool = True,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 name: str = "io"):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.retry_on = retry_on
        self.name = name
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        cap = min(self.max_delay,
                  self.base_delay * (self.multiplier ** attempt))
        if not self.jitter:
            return cap
        with self._lock:               # Random() is not thread-safe
            return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable, *args,
             retry_on: Optional[Tuple[Type[BaseException], ...]] = None,
             deadline: Optional[float] = None, **kwargs):
        """Run ``fn(*args, **kwargs)``; retry transient failures with
        backoff. ``deadline`` is an absolute ``time.monotonic()``
        budget: the policy never sleeps past it."""
        retry_on = self.retry_on if retry_on is None else retry_on
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                d = self.delay(attempt - 1)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or d > remaining:
                        # sleeping would overrun the budget: fail now
                        # with the real error, not a timeout later
                        raise
                self._count_retry()
                logger.debug("retry %d/%d after %r (backoff %.3fs)",
                             attempt, self.max_attempts - 1, e, d)
                self._sleep(d)

    def _count_retry(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observability.registry import (
                safe_inc)
            safe_inc("retry_attempts_total",
                     help="transient failures retried with backoff",
                     labels={"policy": self.name})
        except Exception:
            pass


# The shared data-path policy (iterators + fetchers). Six attempts
# with 20ms..1s full-jitter backoff rides out injected fault bursts
# (p=0.2 per hit -> ~6e-5 residual failure per batch) and real NFS
# blips without turning a dead disk into a hang.
DEFAULT_IO_RETRY = RetryPolicy(max_attempts=6, base_delay=0.02,
                               max_delay=1.0, name="io")


def retrying_io(site: str, fn: Callable):
    """THE data-path guard: hit chaos ``site``, run ``fn``, retry
    transient (injected or real) I/O failures under
    :data:`DEFAULT_IO_RETRY`. One shared implementation for every
    batch/file producer, so a fix to the pattern cannot miss a call
    site."""
    from deeplearning4j_tpu_torch.chaos.injector import step_fault

    def attempt():
        step_fault(site)
        return fn()

    return DEFAULT_IO_RETRY.call(attempt)
