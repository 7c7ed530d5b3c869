"""Backend lifecycle: bounded tiered admission, waitable requests,
deadlines, crash containment with a circuit breaker, graceful drain
(counterpart of ``deeplearning4j_tpu/serving/lifecycle.py``).

``BatchScheduler`` (one-shot predict) and ``ContinuousBatcher``
(generate) differ only in their serving loops; the request plumbing
around those loops lives here: fail-fast enqueue into a
:class:`TierQueue` with shed accounting by tier, the post-enqueue
shutdown race guard, waiter completion (which closes the request's
``respond`` phase and feeds the latency and phase histograms), the
leftover sweep that keeps shutdown from stranding blocked callers,
drain/shutdown ordering, and gauge registration/cleanup.

Crash containment: a worker loop that dies is RESTARTED (its in-flight
work fails with the crash error, each casualty's trace promoted to
sampled; queued work survives for the restarted loop), every crash
counts as ``serving_worker_crashes_total``, leaves a flight-recorder
event and feeds the per-backend :class:`CircuitBreaker`. After
``failure_threshold`` crashes inside ``window_s`` the breaker OPENS and
admission sheds at once with a typed
:class:`~deeplearning4j_tpu_torch.serving.errors.CircuitOpenError`;
after ``cooldown_s`` it goes HALF-OPEN and lets ``half_open_max`` probe
requests through: a probe success closes the circuit, a further crash
re-opens it. State is the ``circuit_state`` gauge (0=closed,
1=half-open, 2=open) and shows on ``ModelServer /healthz``. The
breaker runs on the host clock (injectable for tests).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.serving import tiers
from deeplearning4j_tpu_torch.serving.errors import (CircuitOpenError,
                                                     DeadlineExceededError,
                                                     QueueFullError,
                                                     ServerClosedError)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["BaseRequest", "ServingBackend", "CircuitBreaker",
           "TierQueue"]


class TierQueue:
    """Bounded request queue with weighted-fair service across
    priority tiers and shed-cheapest-first admission.

    The drop-in replacement for the backends' ``queue.Queue``
    (``put_nowait`` / ``get`` / ``get_nowait`` / ``qsize`` /
    ``empty`` / ``maxsize``), with two tier behaviours layered on:

    - **dequeue** is smooth weighted round-robin over the non-empty
      tiers (``tiers.WEIGHTS``): under full backlog gold drains ~8x
      as fast as best-effort, but best-effort is never starved.
    - **overflow** sheds the cheapest traffic first: ``put_nowait``
      at capacity evicts the NEWEST queued request of the lowest
      backlogged tier strictly below the arrival's (returned to the
      caller to fail typed — its waiter has invested the least
      queue time of its tier); an arrival that outranks nothing
      queued raises ``queue.Full`` and is shed itself.
    """

    def __init__(self, maxsize: int,
                 stop: Optional[threading.Event] = None):
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._q = {t: collections.deque() for t in tiers.TIERS}
        self._picker = tiers.WeightedFairPicker()
        # the owning backend's stop event: a timeout-less get() is
        # bounded by it (raises queue.Empty once the backend stops
        # and the queue is drained) instead of blocking forever
        self._stop = stop

    def qsize(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._q.values())

    def empty(self) -> bool:
        return self.qsize() == 0

    def depth_by_tier(self) -> dict:
        with self._lock:
            return {t: len(d) for t, d in self._q.items() if d}

    def put_nowait(self, r: "BaseRequest"
                   ) -> Optional["BaseRequest"]:
        """Admit ``r``; returns the evicted lower-tier request when
        admission had to make room (the caller owns failing it), or
        None on a plain admit. Raises ``queue.Full`` when ``r``
        itself must shed."""
        tier = getattr(r, "tier", tiers.DEFAULT_TIER)
        with self._not_empty:
            total = sum(len(d) for d in self._q.values())
            if self.maxsize <= 0 or total < self.maxsize:
                self._q[tier].append(r)
                self._not_empty.notify()
                return None
            for victim_tier in reversed(tiers.TIERS):
                if (tiers.PRIORITY[victim_tier]
                        <= tiers.PRIORITY[tier]):
                    break       # nothing queued outranks the arrival
                if self._q[victim_tier]:
                    victim = self._q[victim_tier].pop()
                    self._q[tier].append(r)
                    return victim
            raise queue.Full

    def _pop_locked(self) -> "BaseRequest":
        avail = [t for t in tiers.TIERS if self._q[t]]
        return self._q[self._picker.pick(avail)].popleft()

    def get(self, timeout: Optional[float] = None) -> "BaseRequest":
        """Weighted-fair dequeue. With no ``timeout`` the wait is a
        1s heartbeat bounded by the owner's stop event: once
        the backend stops and nothing is queued, raises
        ``queue.Empty`` — nothing will ever arrive — instead of
        blocking its caller forever."""
        with self._not_empty:
            if timeout is None:
                while not any(self._q.values()):
                    self._not_empty.wait(1.0)
                    if self._stop is not None \
                            and self._stop.is_set() \
                            and not any(self._q.values()):
                        raise queue.Empty
            else:
                deadline = time.monotonic() + max(0.0, timeout)
                while not any(self._q.values()):
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._not_empty.wait(left):
                        if not any(self._q.values()):
                            raise queue.Empty
                        break
            return self._pop_locked()

    def get_nowait(self) -> "BaseRequest":
        with self._lock:
            if not any(self._q.values()):
                raise queue.Empty
            return self._pop_locked()


class CircuitBreaker:
    """Three-state (closed / open / half-open) breaker over a sliding
    failure window.

    Failures are recorded by the owner (here: worker-loop crashes),
    successes by completed requests. Thread-safe; ``clock`` is
    injectable for tests.
    """

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    _CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, failure_threshold: int = 5,
                 window_s: float = 30.0, cooldown_s: float = 10.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.half_open_max = max(1, half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: collections.deque = collections.deque()
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probes = 0
        self._last_probe_at = 0.0
        self.opened_total = 0
        # optional hook(old_state, new_state) for metrics/recording;
        # called with the lock held, must not re-enter the breaker
        self.on_transition: Optional[Callable[[str, str], None]] = None

    # ---- internals (lock held) ----
    def _transition(self, new: str) -> None:
        old = self._state
        if new == old:
            return
        self._state = new
        if new == self.OPEN:
            self.opened_total += 1
            self._opened_at = self._clock()
        if new == self.HALF_OPEN:
            self._probes = 0
        hook = self.on_transition
        if hook is not None:
            try:
                hook(old, new)
            except Exception:
                logger.exception("circuit transition hook failed")

    def _tick(self) -> None:
        now = self._clock()
        if (self._state == self.OPEN
                and now - self._opened_at >= self.cooldown_s):
            self._transition(self.HALF_OPEN)
        elif (self._state == self.HALF_OPEN
              and self._probes >= self.half_open_max
              and now - self._last_probe_at >= self.cooldown_s):
            # a probe that died without touching the breaker (shed at
            # the queue, expired on its deadline) must not wedge the
            # circuit half-open forever: replenish the probe budget
            # one cooldown after the last grant
            self._probes = 0

    # ---- the API ----
    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def state_code(self) -> int:
        """0=closed, 1=half-open, 2=open (the ``circuit_state``
        gauge)."""
        return self._CODES[self.state]

    def try_admit(self) -> str:
        """Atomic admission decision: ``"normal"`` (closed),
        ``"probe"`` (half-open, probe budget granted), or ``""``
        (denied). Half-open admits at most ``half_open_max`` probes
        per cooldown."""
        with self._lock:
            self._tick()
            if self._state == self.CLOSED:
                return "normal"
            if self._state == self.OPEN:
                return ""
            if self._probes < self.half_open_max:
                self._probes += 1
                self._last_probe_at = self._clock()
                return "probe"
            return ""

    def allow(self) -> bool:
        """May one more request be admitted right now?"""
        return bool(self.try_admit())

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            now = self._clock()
            if self._state == self.HALF_OPEN:
                # the probe found the backend still broken
                self._transition(self.OPEN)
                return
            if self._state == self.OPEN:
                self._opened_at = now     # re-arm the cooldown
                return
            self._failures.append(now)
            while (self._failures
                   and now - self._failures[0] > self.window_s):
                self._failures.popleft()
            if len(self._failures) >= self.failure_threshold:
                self._failures.clear()
                self._transition(self.OPEN)

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            # only a success while a granted probe is outstanding may
            # close the circuit: a STALE success (a request served
            # before the crashes, whose caller only now called
            # wait()) must not re-admit traffic into a worker no
            # probe has touched
            if self._state == self.HALF_OPEN and self._probes > 0:
                self._transition(self.CLOSED)
                self._failures.clear()

    def cooldown_remaining(self) -> float:
        """Seconds until an OPEN circuit half-opens (0.0 when the
        circuit already admits work) — what a ``Retry-After`` header
        should tell the caller."""
        with self._lock:
            self._tick()
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def force_open(self) -> None:
        """Operator override (and test hook): open now."""
        with self._lock:
            self._transition(self.OPEN)


class BaseRequest:
    """A waitable unit of admitted work."""

    __slots__ = ("event", "result", "error", "deadline", "t_submit",
                 "probe", "ctx", "tier")

    def __init__(self, deadline: Optional[float], ctx=None):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.deadline = deadline
        self.t_submit = time.monotonic()
        # priority-admission tier (tiers.py): decides weighted-fair
        # service order, who is evicted first under queue pressure,
        # and how the Retry-After backoff is priced. Stamped by the
        # backend's submit() from the request body.
        self.tier = tiers.DEFAULT_TIER
        # True when this request was admitted as a half-open circuit
        # probe: ONLY its success may close the circuit (a stale
        # pre-crash success must not vouch for a worker it never
        # touched)
        self.probe = False
        # the request-scoped trace context
        # (observability.tracing.RequestContext): trace id, sampling
        # decision, deadline, per-phase ledger. It RIDES the request
        # across queues / buckets / slots / worker crash-restarts, so
        # the retried work keeps its original trace id and the span
        # tree stays parented to the same root.
        self.ctx = ctx


class ServingBackend:
    """Queue + worker-thread lifecycle shared by the serving
    backends. Subclasses implement ``_loop`` and call
    ``_start_worker`` once constructed. The worker is crash-proof:
    a dying ``_loop`` is counted, fed to the circuit breaker, and
    restarted until shutdown."""

    def __init__(self, kind: str, name: str, queue_limit: int,
                 occupancy_max: int,
                 metrics: Optional[ServingMetrics] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.name = name
        self.metrics = metrics or ServingMetrics()
        self._endpoint = self.metrics.endpoint(name)
        self._occupancy = self.metrics.occupancy(name, occupancy_max)
        self.metrics.register_gauge(f"{name}_queue_depth",
                                    self.queue_depth)
        self.breaker = breaker or CircuitBreaker()
        self.metrics.registry.gauge(
            "circuit_state",
            help="per-backend circuit breaker state "
                 "(0=closed, 1=half-open, 2=open)",
            labels={"endpoint": name}, fn=self.breaker.state_code)
        # per-tier shed accounting, instruments created ONCE here
        # (never per request)
        self._shed_by_tier = {
            t: self.metrics.registry.counter(
                "admission_shed_total",
                help="requests shed at admission (queue overflow "
                     "eviction or refusal), by priority tier",
                labels={"endpoint": name, "tier": t})
            for t in tiers.TIERS}
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._stop = threading.Event()
        self._queue = TierQueue(queue_limit, stop=self._stop)
        self._worker = threading.Thread(target=self._run,
                                        name=f"{kind}-{name}",
                                        daemon=True)

    def _start_worker(self) -> None:
        self._worker.start()

    def _run(self) -> None:
        # the worker must NEVER die without releasing waiters, and
        # must not stay dead: a loop crash (bad
        # request data, device fault outside the guarded step, an
        # injected chaos crash) fails the in-flight work with the
        # crash error, counts toward the circuit breaker, and the
        # loop RESTARTS for the work still queued. Admission-side
        # shedding is the breaker's job, not the worker's.
        crashes = 0
        try:
            while True:
                try:
                    self._loop()
                    break                      # clean stop
                except BaseException as e:
                    self._on_worker_crash(e)
                    if self._stop.is_set():
                        break
                    # bounded backoff between restarts: a persistent
                    # pre-dequeue failure must not become a hot spin
                    # of crash/restart/metric/bundle at 100% CPU
                    delay = min(2.0, 0.05 * (2.0 ** min(crashes, 6)))
                    crashes += 1
                    # exc_info: without a flight recorder this log
                    # line is the ONLY artifact of a real crash — it
                    # must carry the traceback the pre-restart
                    # re-raise used to surface via the excepthook
                    logger.warning(
                        "%r worker restarting after crash (%.2fs "
                        "backoff): %r", self.name, delay, e,
                        exc_info=e)
                    if self._stop.wait(delay):
                        break
        finally:
            self._stop.set()
            self._sweep_leftovers(self._abort_inflight())

    def _on_worker_crash(self, exc: BaseException) -> None:
        # a dying worker is an incident, not a log line: count it,
        # trip the breaker toward open, leave a flight-recorder
        # bundle when one is installed, and fail the work the crashed
        # loop held in flight (queued work survives for the restart)
        from deeplearning4j_tpu_torch.observability.registry import safe_inc
        safe_inc("serving_worker_crashes_total",
                 help="serving backend worker loops that died",
                 labels={"endpoint": self.name},
                 registry=self.metrics.registry)
        try:
            self.breaker.record_failure()
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.observability import (
                flight_recorder)
            flight_recorder.on_backend_crash(self.name, exc)
        except Exception:
            pass
        for r in self._crash_casualties():
            # promote to sampled: a request killed by a worker crash
            # must leave a trace
            self._deliver_failure(r, exc)

    def _loop(self) -> None:
        raise NotImplementedError

    def _abort_inflight(self) -> List["BaseRequest"]:
        """Every uncompleted request the subclass holds outside the
        queue (open buckets, occupied slots, pending lists); called
        once at worker exit."""
        return []

    def _crash_casualties(self) -> List["BaseRequest"]:
        """Requests that die WITH a worker crash: only work actually
        in flight on the device. Admitted-but-unstarted work must
        survive for the restarted loop (the crash-containment
        contract). Defaults to everything the subclass holds."""
        return self._abort_inflight()

    # ---- admission ----
    def _admit_guard(self) -> bool:
        """Raises when admission is refused; returns True when this
        admission is a half-open circuit probe (the subclass stamps
        it on the request)."""
        if self._draining.is_set() or self._stop.is_set():
            # a draining backend is being replaced: "come back soon"
            # is measured in seconds, and the hint must ride the
            # error: the HTTP layer forwards it as
            # Retry-After on the 503
            raise ServerClosedError(
                f"{self.name!r} is draining; not admitting new "
                "requests", retry_after_s=2.0)
        kind = self.breaker.try_admit()
        if not kind:
            raise CircuitOpenError(
                f"{self.name!r} circuit is {self.breaker.state} "
                f"after repeated worker crashes; request shed — "
                f"retry after the cooldown",
                retry_after_s=self.breaker.cooldown_remaining())
        return kind == "probe"

    def _shed_error(self, r: BaseRequest,
                    detail: str) -> QueueFullError:
        """Build the typed shed error and do its accounting: the
        endpoint shed counter, the per-tier ``admission_shed_total``
        family, and a Retry-After priced by the request's tier (the
        base hint — 10 ms/queued item, floor 100 ms — is roughly the
        time the backlog needs to clear; cheap tiers are told to
        stay away for a multiple of it)."""
        self._endpoint.count_shed()
        counter = self._shed_by_tier.get(r.tier)
        if counter is not None:
            counter.inc()
        base = max(0.1, 0.01 * self._queue.maxsize)
        return QueueFullError(
            f"{self.name!r} queue is at its limit "
            f"({self._queue.maxsize}); {r.tier} request {detail} — "
            "retry with backoff",
            retry_after_s=tiers.priced_retry_after_s(base, r.tier))

    def _enqueue(self, r: BaseRequest) -> BaseRequest:
        """Fail-fast put: shed at the limit — evicting the newest
        queued request of a cheaper tier first, so a spike degrades
        best-effort traffic before paid traffic — and guard the race
        where shutdown's final sweep already ran (nothing would ever
        complete a request admitted after it)."""
        try:
            victim = self._queue.put_nowait(r)
        except queue.Full:
            raise self._shed_error(r, "refused") from None
        if victim is not None:
            # a higher-tier arrival took the evicted request's queue
            # slot: the victim is shed exactly as if admission had
            # refused it — typed error, tier-priced Retry-After,
            # counted against ITS tier
            self._deliver_failure(victim,
                                  self._shed_error(victim,
                                                   "evicted"))
        if self._stop.is_set():
            self._deliver_failure(r, ServerClosedError(
                f"{self.name!r} shut down while the request was "
                "being admitted", retry_after_s=2.0))
        return r

    @staticmethod
    def _deliver_failure(r: BaseRequest, err: BaseException) -> None:
        """The one fail-and-wake implementation: set the typed
        error, promote the trace (always-sample on failure), wake
        the waiter — idempotent on an already-completed request.
        Every failure path (expiry, eviction, crash casualties, the
        shutdown sweep) goes through here so the semantics cannot
        drift between copies."""
        if r.event.is_set():
            return
        r.error = err
        if r.ctx is not None:
            r.ctx.set_error(err)
        r.event.set()

    def _fail_expired(self, r: BaseRequest, detail: str) -> None:
        """Deadline expiry for work that never started: count it,
        then the shared fail-and-wake — ONE implementation for both
        backends (the scheduler's queue sweep and the batcher's
        pending sweep), so the always-sample-on-expiry and counter
        semantics cannot drift."""
        self._endpoint.count_expired()
        self._deliver_failure(r, DeadlineExceededError(detail))

    def wait(self, r: BaseRequest):
        # heartbeat wait, never an unbounded block. The
        # worker's exit sweep normally fails every leftover, but a
        # request leaked PAST the sweep (a subclass holding work in a
        # structure _abort_inflight misses, an admission racing the
        # final sweep) used to strand its caller on event.wait()
        # forever; now, once the worker thread is gone — its finally
        # block, sweep included, has run — an still-incomplete
        # request is failed here with the same typed shutdown error.
        while not r.event.wait(1.0):
            if self._stop.is_set() and not self._worker.is_alive():
                self._deliver_failure(r, ServerClosedError(
                    f"{self.name!r} shut down without serving the "
                    "request", retry_after_s=2.0))
                break
        if r.error is not None:
            if r.ctx is not None:
                # always-sample on failure: the error (deadline
                # expiry, crash, poison) promotes the trace
                r.ctx.set_error(r.error)
            raise r.error
        # ONLY a completed probe is the breaker's success signal: a
        # stale success (served before the crash burst, wait()ed
        # late) must not close a circuit no probe has verified
        if r.probe:
            self.breaker.record_success()
        ctx = r.ctx
        if ctx is not None:
            # close the final contiguous segment (result ready ->
            # waiter woken), then feed the attribution pipeline: the
            # whole-request histogram gets the sampled trace id as an
            # exemplar, the phase ledger the per-phase histograms
            ctx.phase_done("respond")
            tid = ctx.trace_id if ctx.sampled else None
            # observe the SAME interval the ledger covers (context
            # mint → respond done, ctx.age_s()), not submit → now:
            # the HTTP path mints the context before parse/resolve,
            # so measuring from t_submit would make the phase sums
            # exceed the whole-request histogram on payload-heavy
            # requests and break the attribution reconciliation
            self._endpoint.observe(ctx.age_s(), trace_id=tid)
            self._endpoint.record_phases(ctx.phases, trace_id=tid)
        else:
            self._endpoint.observe(time.monotonic() - r.t_submit)
        return r.result

    # ---- observability ----
    def _extra_depth(self) -> int:
        """Work the subclass holds outside the queue (e.g. open
        batching buckets)."""
        return 0

    def queue_depth(self) -> int:
        return self._queue.qsize() + self._extra_depth()

    # ---- shutdown ----
    def _sweep_leftovers(self,
                         extra: Optional[List[BaseRequest]] = None):
        """Fail whatever never started so no caller stays blocked on
        ``event.wait()`` after the worker exits."""
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

    def _unregister_gauges(self) -> None:
        self.metrics.unregister_gauge(f"{self.name}_queue_depth")
        self.metrics.registry.unregister(
            "circuit_state", labels={"endpoint": self.name})

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting; let queued and in-flight work complete,
        then stop the worker. True when fully drained in time."""
        self._draining.set()
        ok = self._drained.wait(timeout)
        self._stop.set()
        self._worker.join(timeout=5.0)
        self._unregister_gauges()
        return ok

    def shutdown(self, drain: bool = True,
                 timeout: float = 30.0) -> bool:
        if drain:
            return self.drain(timeout)
        self._draining.set()
        self._stop.set()
        self._worker.join(timeout=5.0)
        self._unregister_gauges()
        return True
