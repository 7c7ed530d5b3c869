"""Backend lifecycle: bounded admission, waitable requests, deadlines,
crash containment, graceful drain (counterpart of the part of
``deeplearning4j_tpu/serving/lifecycle.py`` that ``BatchScheduler`` and
``ContinuousBatcher`` stand on). Priority tiers, circuit breakers, chaos
sites, metrics and tracing are not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     QueueFullError,
                                                     ServerClosedError)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["BaseRequest", "ServingBackend"]


class BaseRequest:
    """A waitable unit of admitted work."""

    __slots__ = ("event", "result", "error", "deadline", "t_submit")

    def __init__(self, deadline: Optional[float]):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.deadline = deadline
        self.t_submit = time.monotonic()


class ServingBackend:
    """Queue + worker-thread lifecycle. Subclasses implement ``_loop``
    and call ``_start_worker`` once constructed. A crash of the loop
    fails the work it held in flight with the crash error and restarts
    the loop (after a bounded backoff) for the work still queued. When
    the worker exits, every request it never completed fails with
    ServerClosedError, so no caller stays blocked."""

    def __init__(self, kind: str, name: str, queue_limit: int):
        self.name = name
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._stop = threading.Event()
        self._queue: "queue.Queue[BaseRequest]" = queue.Queue(
            maxsize=max(0, int(queue_limit)))
        self._worker = threading.Thread(target=self._run,
                                        name=f"{kind}-{name}", daemon=True)

    def _start_worker(self) -> None:
        self._worker.start()

    def _run(self) -> None:
        crashes = 0
        try:
            while True:
                try:
                    self._loop()
                    break                          # clean stop
                except Exception as e:
                    # the work the crashed loop held in flight fails with
                    # the crash error; queued work survives the restart
                    for r in self._crash_casualties():
                        self._deliver_failure(r, e)
                    if self._stop.is_set():
                        break
                    # bounded backoff: a persistent failure must not
                    # become a hot crash/restart spin
                    delay = min(2.0, 0.05 * (2.0 ** min(crashes, 6)))
                    crashes += 1
                    logger.warning("%r worker restarting after crash "
                                   "(%.2fs backoff): %r", self.name, delay,
                                   e, exc_info=e)
                    if self._stop.wait(delay):
                        break
        finally:
            self._stop.set()
            self._sweep_leftovers(self._abort_inflight())

    def _loop(self) -> None:
        raise NotImplementedError

    def _abort_inflight(self) -> List[BaseRequest]:
        """Every uncompleted request the subclass holds outside the
        queue; called once at worker exit."""
        return []

    def _crash_casualties(self) -> List[BaseRequest]:
        """The requests that die with a worker crash: only work actually
        in flight. Defaults to everything the subclass holds."""
        return self._abort_inflight()

    # ---- admission ----
    def _admit_guard(self) -> None:
        if self._draining.is_set() or self._stop.is_set():
            raise ServerClosedError(
                f"{self.name!r} is draining; not admitting new requests",
                retry_after_s=2.0)

    def _enqueue(self, r: BaseRequest) -> BaseRequest:
        """Fail-fast put: shed at the limit, and fail the request if
        shutdown's final sweep already ran."""
        try:
            self._queue.put_nowait(r)
        except queue.Full:
            raise QueueFullError(
                f"{self.name!r} queue is at its limit "
                f"({self._queue.maxsize}); retry with backoff",
                retry_after_s=max(0.1, 0.01 * self._queue.maxsize)
            ) from None
        if self._stop.is_set():
            self._deliver_failure(r, ServerClosedError(
                f"{self.name!r} shut down while the request was being "
                "admitted", retry_after_s=2.0))
        return r

    @staticmethod
    def _deliver_failure(r: BaseRequest, err: BaseException) -> None:
        """Set the error and wake the waiter (idempotent)."""
        if r.event.is_set():
            return
        r.error = err
        r.event.set()

    def _fail_expired(self, r: BaseRequest,
                      detail: Optional[str] = None) -> None:
        """Deadline expiry for work that never started: one
        implementation for the scheduler's queue sweep and the
        batcher's pending sweep."""
        self._deliver_failure(r, DeadlineExceededError(
            f"request deadline expired after "
            f"{time.monotonic() - r.t_submit:.3f}s in the {self.name!r} "
            "queue (work was never started)" if detail is None
            else detail))

    def wait(self, r: BaseRequest):
        """Block until ``r`` completes; raise its error. A heartbeat
        wait: once the worker is gone, a request it never completed
        fails with ServerClosedError instead of blocking forever."""
        while not r.event.wait(1.0):
            if self._stop.is_set() and not self._worker.is_alive():
                self._deliver_failure(r, ServerClosedError(
                    f"{self.name!r} shut down without serving the "
                    "request", retry_after_s=2.0))
                break
        if r.error is not None:
            raise r.error
        return r.result

    # ---- observability ----
    def _extra_depth(self) -> int:
        return 0

    def queue_depth(self) -> int:
        return self._queue.qsize() + self._extra_depth()

    # ---- shutdown ----
    def _sweep_leftovers(self, extra: Optional[List[BaseRequest]] = None):
        err = ServerClosedError(
            f"{self.name!r} shut down before the request was served")
        leftovers = list(extra or [])
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            self._deliver_failure(r, err)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting; let queued and in-flight work complete, then
        stop the worker. True when fully drained in time."""
        self._draining.set()
        ok = self._drained.wait(timeout)
        self._stop.set()
        self._worker.join(timeout=5.0)
        return ok

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> bool:
        if drain:
            return self.drain(timeout)
        self._draining.set()
        self._stop.set()
        self._worker.join(timeout=5.0)
        return True
