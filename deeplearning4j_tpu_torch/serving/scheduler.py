"""Dynamic-batching scheduler with admission control (counterpart of
``deeplearning4j_tpu/serving/scheduler.py``).

Concurrent callers submit one-shot predict requests; a collector thread
coalesces requests of the same per-item shape and dtype into one
``model.output`` call of at most ``max_batch_size`` rows (unless a
single request is larger). Admission is bounded (QueueFullError),
every request may carry a deadline (DeadlineExceededError), and drain
completes queued work while refusing new work.

Unlike the JAX scheduler, a coalesced batch is not padded to a power of
two: that bucketing only bounds XLA recompiles, and an eager PyTorch
model runs any row count as it is.
"""

from __future__ import annotations

import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.lifecycle import (BaseRequest,
                                                        ServingBackend)

__all__ = ["BatchScheduler"]


class _Request(BaseRequest):
    __slots__ = ("x",)

    def __init__(self, x, deadline: Optional[float]):
        super().__init__(deadline)
        self.x = x


class _Bucket:
    __slots__ = ("items", "rows", "t_first")

    def __init__(self):
        self.items: List[_Request] = []
        self.rows = 0
        self.t_first = time.monotonic()


def _to_numpy(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class BatchScheduler(ServingBackend):
    """One collector thread per hosted model. ``submit`` returns a
    waitable request; ``predict`` blocks for the result (a numpy
    array). ``device_calls`` and ``rows_served`` count the coalesced
    ``model.output`` calls and their rows."""

    def __init__(self, model, max_batch_size: int = 32,
                 queue_limit: int = 256, wait_ms: float = 2.0,
                 name: str = "predict"):
        super().__init__("batch", name, queue_limit)
        self.model = model
        self.max_batch_size = max_batch_size
        self.wait_ms = wait_ms
        self.device_calls = 0
        self.rows_served = 0
        self._buckets: Dict[tuple, _Bucket] = {}
        self._start_worker()

    # ---- admission ----
    def submit(self, x, timeout: Optional[float] = None) -> _Request:
        """Enqueue one request of shape (n, ...features). Raises
        QueueFullError at the queue limit and ServerClosedError once
        draining."""
        self._admit_guard()
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must have a leading batch axis")
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        return self._enqueue(_Request(x, deadline))

    def predict(self, x, timeout: Optional[float] = None) -> np.ndarray:
        return self.wait(self.submit(x, timeout=timeout))

    def _extra_depth(self) -> int:
        return sum(b.rows for b in list(self._buckets.values()))

    # ---- collection ----
    def _loop(self):
        while not self._stop.is_set():
            wait_s = self.wait_ms / 1000.0
            if self._buckets:
                oldest = min(b.t_first for b in self._buckets.values())
                timeout = min(max(oldest + wait_s - time.monotonic(),
                                  1e-4), 0.05)
            else:
                timeout = 0.05
            try:
                r = self._queue.get(timeout=timeout)
            except queue.Empty:
                r = None
            now = time.monotonic()
            if r is not None:
                if r.deadline is not None and now > r.deadline:
                    self._fail_expired(r)
                else:
                    key = (r.x.shape[1:], str(r.x.dtype))
                    b = self._buckets.get(key)
                    if b is not None and b.rows + r.x.shape[0] > \
                            self.max_batch_size:
                        # a batch never exceeds max_batch_size unless a
                        # single request does: cut the bucket first
                        del self._buckets[key]
                        self._serve(b.items)
                        b = None
                    if b is None:
                        b = self._buckets[key] = _Bucket()
                    b.items.append(r)
                    b.rows += r.x.shape[0]
            # cut every bucket that is full or past its wait window;
            # while draining, cut at once
            for key in list(self._buckets):
                b = self._buckets[key]
                if (b.rows >= self.max_batch_size
                        or now >= b.t_first + wait_s
                        or self._draining.is_set()):
                    del self._buckets[key]
                    self._serve(b.items)
            if (self._draining.is_set() and not self._buckets
                    and self._queue.empty()):
                self._drained.set()

    def _abort_inflight(self) -> List[_Request]:
        leftovers = [r for b in self._buckets.values() for r in b.items]
        self._buckets.clear()
        return leftovers

    def _call(self, x: np.ndarray) -> np.ndarray:
        self.device_calls += 1
        self.rows_served += x.shape[0]
        return _to_numpy(self.model.output(x))

    def _serve(self, items: List[_Request]) -> None:
        now = time.monotonic()
        live = []
        for r in items:
            if r.deadline is not None and now > r.deadline:
                self._fail_expired(r)
            else:
                live.append(r)
        if not live:
            return
        try:
            out = self._call(np.concatenate([r.x for r in live], axis=0))
        except Exception as batch_err:
            self._retry_each(live, batch_err)
            return
        off = 0
        for r in live:
            n = r.x.shape[0]
            r.result = out[off:off + n]
            off += n
            r.event.set()

    def _retry_each(self, live: List[_Request], batch_err: Exception):
        """The coalesced call failed: retry each request alone so a
        poison request fails only its own caller, but stop after two
        consecutive failures (then the model, not an input, is
        broken) and fail the rest with the batch's error."""
        consecutive = 0
        for r in live:
            if consecutive >= 2:
                self._deliver_failure(r, batch_err)
                continue
            try:
                r.result = self._call(r.x)
                consecutive = 0
                r.event.set()
            except Exception as e:
                consecutive += 1
                self._deliver_failure(r, e)
