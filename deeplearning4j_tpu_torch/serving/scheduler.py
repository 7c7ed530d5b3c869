"""Dynamic-batching scheduler with admission control (counterpart of
``deeplearning4j_tpu/serving/scheduler.py``).

Concurrent callers submit one-shot predict requests; a collector thread
coalesces requests of the same per-item shape and dtype into one
``model.output`` call of at most ``max_batch_size`` rows (unless a
single request is larger). Admission is bounded (QueueFullError),
every request may carry a deadline (DeadlineExceededError), and drain
completes queued work while refusing new work.

Each request carries its trace context (``RequestContext``) and
priority tier: the context's phase ledger records ``admission ->
queue_wait -> batch_form -> device_step -> respond``, the queue is
drained weighted-fair across tiers, every coalesced call is recorded by
``BatchOccupancy``, and the ``serving.worker.step`` chaos site sits
before the device call (``crash`` kills the worker loop with the
batch's waiters, ``hang`` stalls it, ``poison`` NaNs the batch's output
tensor on its device).

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

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.observability.tracing import RequestContext
from deeplearning4j_tpu_torch.serving import tiers
from deeplearning4j_tpu_torch.serving.lifecycle import (BaseRequest,
                                                        CircuitBreaker,
                                                        ServingBackend)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["BatchScheduler"]


class _Request(BaseRequest):
    __slots__ = ("x",)

    def __init__(self, x, deadline: Optional[float], ctx=None):
        super().__init__(deadline, ctx=ctx)
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
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "predict",
                 breaker: Optional[CircuitBreaker] = None):
        super().__init__("batch", name, queue_limit, max_batch_size,
                         metrics, breaker=breaker)
        self.model = model
        self.max_batch_size = max_batch_size
        self.wait_ms = wait_ms
        self.device_calls = 0
        self.rows_served = 0
        self._buckets: Dict[tuple, _Bucket] = {}
        self._start_worker()

    # ---- admission ----
    def submit(self, x, timeout: Optional[float] = None, ctx=None,
               tier: Optional[str] = None) -> _Request:
        """Enqueue one request of shape (n, ...features). Raises
        QueueFullError at the queue limit (the cheapest backlogged tier
        is evicted first, see ``serving/tiers.py``), CircuitOpenError
        while the breaker is open and ServerClosedError once draining.
        ``ctx`` is the request's trace context (the HTTP front end
        mints one at admission; in-process callers get a fresh
        unsampled one); ``tier`` is gold / standard / best_effort
        (default standard)."""
        probe = self._admit_guard()
        tier = tiers.parse_tier(tier)
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must have a leading batch axis")
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        if ctx is None:
            ctx = RequestContext(route=self.name, deadline=deadline)
        ctx.attrs["tier"] = tier
        # the enqueue below is the admission / queue_wait boundary
        ctx.phase_done("admission", now_in="queue_wait")
        r = _Request(x, deadline, ctx=ctx)
        r.probe = probe
        r.tier = tier
        return self._enqueue(r)

    def predict(self, x, timeout: Optional[float] = None, ctx=None,
                tier: Optional[str] = None) -> np.ndarray:
        return self.wait(self.submit(x, timeout=timeout, ctx=ctx,
                                     tier=tier))

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
                    self._expire(r)
                else:
                    # dequeued by the collector (on the worker thread):
                    # queue_wait ends, batch formation begins
                    r.ctx.phase_done("queue_wait", now_in="batch_form")
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

    def _crash_casualties(self) -> List[_Request]:
        # the batch being served when the worker crashed is failed in
        # _serve; open buckets were never started, and the restarted
        # loop cuts and serves them
        return []

    def _abort_inflight(self) -> List[_Request]:
        leftovers = [r for b in self._buckets.values() for r in b.items]
        self._buckets.clear()
        return leftovers

    def _expire(self, r: _Request) -> None:
        self._fail_expired(
            r, f"request deadline expired after "
               f"{time.monotonic() - r.t_submit:.3f}s in the "
               f"{self.name!r} queue (work was never started)")

    def _call(self, x: np.ndarray, poison: bool) -> np.ndarray:
        self.device_calls += 1
        self.rows_served += x.shape[0]
        out = self.model.output(x)
        if poison:
            # the chaos site's poison: NaNs in the output tensor, on
            # the device it was computed on
            out = torch.full_like(torch.as_tensor(out), float("nan"))
        return _to_numpy(out)

    def _serve(self, items: List[_Request]) -> None:
        now = time.monotonic()
        live = []
        for r in items:
            if r.deadline is not None and now > r.deadline:
                self._expire(r)
            else:
                live.append(r)
        if not live:
            return
        # chaos site: crash kills the worker loop (taking this batch's
        # waiters down with it, as a real crash would), hang stalls
        # it, poison corrupts the delivered results
        try:
            fault = chaos.step_fault("serving.worker.step")
        except BaseException as e:
            for r in live:
                self._endpoint.count_error()
                self._deliver_failure(r, e)
            raise
        poison = fault is not None and fault.kind == "poison"
        rows = sum(r.x.shape[0] for r in live)
        self._occupancy.record(rows)
        for r in live:
            r.ctx.phase_done("batch_form", now_in="device_step",
                             attrs={"batch_rows": rows})
        try:
            out = self._call(np.concatenate([r.x for r in live], axis=0),
                             poison)
        except Exception as batch_err:
            self._retry_each(live, batch_err, poison)
            return
        off = 0
        for r in live:
            n = r.x.shape[0]
            r.result = out[off:off + n]
            off += n
            self._served(r)

    @staticmethod
    def _served(r: _Request) -> None:
        # the device_step segment closes BEFORE the waiter can wake and
        # stamp respond
        r.ctx.phase_done("device_step", now_in="respond")
        r.event.set()

    def _retry_each(self, live: List[_Request], batch_err: Exception,
                    poison: bool) -> None:
        """The coalesced call failed: retry each request alone so a
        poison request fails only its own caller, but stop after two
        consecutive failures (then the model, not an input, is
        broken) and fail the rest with the batch's error."""
        consecutive = 0
        for r in live:
            if consecutive >= 2:
                self._endpoint.count_error()
                self._deliver_failure(r, batch_err)
                continue
            try:
                r.result = self._call(r.x, poison)
                consecutive = 0
                self._served(r)
            except Exception as e:
                consecutive += 1
                self._endpoint.count_error()
                self._deliver_failure(r, e)
