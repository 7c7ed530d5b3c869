"""Continuous batching over bounded-KV-cache decode sessions
(counterpart of ``deeplearning4j_tpu/serving/continuous.py``).

Iteration-level scheduling (the Orca/vLLM idea): a fixed set of KV-cache
slots steps together, one (slots, 1, 1) decode step at a time, and
between steps finished slots are recycled to pending requests. Prompt
prefill rides the decode steps token by token (teacher-forced), so
admission never changes the step's shape.

By default (``kv_mode="auto"``) the KV state behind the slots is PAGED
(:class:`~deeplearning4j_tpu_torch.models.paged_kv.PagedSlotSession`):
admission asks the allocator for the pages of this request's ``prompt +
n_tokens`` worst case, a request it cannot place yet stays pending as
the sticky head (so a big request is not starved by small ones), and a
prompt whose page-aligned prefix is cached resumes prefill after the
cached pages. ``kv_mode="dense"`` uses the per-slot capacity rows of a
:class:`~deeplearning4j_tpu_torch.models.streaming.SlotStreamingSession`;
greedy ids are the same either way.

Admission is bounded and tiered (``QueueFullError``; pending requests
are granted slots weighted-fair across gold / standard / best_effort),
deadlines are enforced while requests wait (also while every slot is
busy), and drain completes the work admitted. Sampling is host-side per
step: greedy, or temperature with a per-request
``np.random.default_rng(seed)`` exactly as the JAX batcher samples, so
temperature ids match it for the same probabilities. A failed device
step fails the streams it carried, rebuilds the session state (pools
half-written by the failed step are discarded), and the batcher goes
on.

Observability rides the step's one host sync (the probabilities coming
back for sampling) and adds none: each request's phase ledger records
``admission -> queue_wait -> prefill -> decode -> respond``, time to
first token and inter-token latency are the ``serving_ttft_seconds``
(split ``cold`` / ``prefix_hit``) and ``serving_itl_seconds``
histograms, and the KV page gauges and prefix-cache counters read host
counts. The ``serving.worker.step`` chaos site sits before the device
step (``poison`` NaNs the step's probabilities on the device; each
stream that samples from them fails with the per-slot error). The
KV-stream export/import and drain-migration methods wait for ROADMAP
A4b.
"""

from __future__ import annotations

import queue
import time
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.observability.tracing import RequestContext
from deeplearning4j_tpu_torch.serving import tiers
from deeplearning4j_tpu_torch.serving.errors import KVPagePoolExhaustedError
from deeplearning4j_tpu_torch.serving.lifecycle import (BaseRequest,
                                                        CircuitBreaker,
                                                        ServingBackend)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["ContinuousBatcher"]


class _GenRequest(BaseRequest):
    __slots__ = ("prompt", "n_tokens", "temperature", "seed")

    def __init__(self, prompt, n_tokens, temperature, seed, deadline,
                 ctx=None):
        super().__init__(deadline, ctx=ctx)
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.seed = seed


class _Slot:
    __slots__ = ("req", "feed", "prompt_left", "out", "rng", "prefix_hit",
                 "t_slotted", "t_last_token")

    def __init__(self, req: _GenRequest, resume: int = 0):
        # ``resume``: prompt positions [0, resume) are already in the KV
        # cache (a prefix-cache hit); prefill starts at the resume token
        self.req = req
        self.feed = int(req.prompt[resume])
        self.prompt_left = [int(t) for t in req.prompt[resume + 1:]]
        self.prefix_hit = int(resume)
        self.out: List[int] = []
        self.rng = (np.random.default_rng(req.seed)
                    if req.temperature > 0 else None)
        self.t_slotted = time.monotonic()
        self.t_last_token: Optional[float] = None


class ContinuousBatcher(ServingBackend):
    """Slot-recycling decode scheduler for one id-input (embedding-first)
    language model. ``slots`` is the device batch; ``capacity`` bounds
    prompt + generation length per request; ``version`` labels the
    streaming histograms. ``device_steps`` counts the decode steps run;
    ``prefix_hits`` the admissions that reused cached prompt pages."""

    def __init__(self, net, slots: int = 4, capacity: int = 256,
                 queue_limit: int = 64,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "generate",
                 breaker: Optional[CircuitBreaker] = None,
                 version: str = "0", kv_mode: str = "auto",
                 page_size: int = 16, kv_pages: Optional[int] = None):
        if kv_mode not in ("auto", "paged", "dense"):
            raise ValueError(
                f"kv_mode must be auto|paged|dense, got {kv_mode!r}")
        super().__init__("contbatch", name, queue_limit, slots, metrics,
                         breaker=breaker)
        from deeplearning4j_tpu_torch.models.paged_kv import (
            PagedSlotSession)
        # auto's dense fallback keys on the SUPPORT predicate only: a
        # real construction error (bad page_size / kv_pages) surfaces
        self._paged = kv_mode == "paged" or (
            kv_mode == "auto" and PagedSlotSession.supports(net))
        try:
            if self._paged:
                self.session = net.paged_slot_streaming_session(
                    capacity=capacity, slots=slots, page_size=page_size,
                    n_pages=kv_pages)
                self._register_kv_metrics()
            else:
                self.session = net.slot_streaming_session(
                    capacity=capacity, slots=slots)
        except BaseException:
            # the base class registered the queue-depth and circuit
            # gauges: a failed construction must not leak them (a
            # leaked gauge pins the half-built backend and its model)
            self._unregister_gauges()
            raise
        self._stream = self.metrics.streaming(name, version)
        self.slots = slots
        self.capacity = capacity
        self.device_steps = 0
        self._slots: List[Optional[_Slot]] = [None] * slots
        # admitted-but-unslotted requests live HERE, not in the queue:
        # deadlines must be enforceable while every slot is busy
        self._pending: List[_GenRequest] = []
        # weighted-fair slot granting across the tiers pending (worker
        # thread only, see _next_pending)
        self._picker = tiers.WeightedFairPicker()
        # the request whose KV reservation last failed: admissions HOLD
        # until it fits (or leaves the pending list), so a big request
        # is not starved by small ones eating every freed page
        self._kv_blocked: Optional[_GenRequest] = None
        self._start_worker()

    # ---- paged-KV observability ----
    def _register_kv_metrics(self) -> None:
        """Pool gauges and prefix-cache counters on the shared registry,
        mirrored into the JSON gauges snapshot. Every value is a host
        count (the allocator's free list, the cache's tallies)."""
        reg = self.metrics.registry
        lbl = {"endpoint": self.name}
        sess = self.session
        reg.gauge("kv_pages_in_use",
                  help="KV cache pages currently referenced",
                  labels=lbl, fn=sess.pages_in_use)
        reg.gauge("kv_pages_total", help="KV cache pages in the pool",
                  labels=lbl, fn=sess.pages_total)
        self._prefix_hits = reg.counter(
            "prefix_cache_hits_total",
            help="admissions that reused cached prompt-prefix pages",
            labels=lbl)
        self._prefix_evictions = reg.counter(
            "prefix_cache_evictions_total",
            help="prefix-cache entries LRU-evicted under page pressure",
            labels=lbl)
        self._evictions_seen = 0
        self.metrics.register_gauge(f"{self.name}_kv_pages_in_use",
                                    sess.pages_in_use)
        self.metrics.register_gauge(f"{self.name}_kv_pages_total",
                                    sess.pages_total)
        cache = sess.prefix_cache
        self.metrics.register_gauge(
            f"{self.name}_prefix_cache_hits_total",
            lambda c=cache: c.hits_total)
        self.metrics.register_gauge(
            f"{self.name}_prefix_cache_evictions_total",
            lambda c=cache: c.evictions_total)

    def _unregister_gauges(self) -> None:
        super()._unregister_gauges()
        if self._paged:
            for g in ("kv_pages_in_use", "kv_pages_total",
                      "prefix_cache_hits_total",
                      "prefix_cache_evictions_total"):
                self.metrics.unregister_gauge(f"{self.name}_{g}")
            lbl = {"endpoint": self.name}
            self.metrics.registry.unregister("kv_pages_in_use",
                                             labels=lbl)
            self.metrics.registry.unregister("kv_pages_total",
                                             labels=lbl)

    def _sync_evictions(self) -> None:
        # evictions happen inside the allocator mid-reserve; bridge the
        # cache's plain count onto the registry counter
        ev = self.session.prefix_cache.evictions_total
        if ev > self._evictions_seen:
            self._prefix_evictions.inc(ev - self._evictions_seen)
            self._evictions_seen = ev

    @property
    def prefix_hits(self) -> int:
        return int(self._prefix_hits.value) if self._paged else 0

    def _release_slot(self, i: int, register: bool = False) -> None:
        """Recycle slot ``i``: for paged sessions drop its page
        references, registering its prompt's full pages in the prefix
        cache first when the stream completed cleanly."""
        s = self._slots[i]
        if self._paged and s is not None:
            self.session.release(
                i, register_prompt=s.req.prompt if register else None)
        self._slots[i] = None

    # ---- admission ----
    def submit(self, prompt, n_tokens: int, temperature: float = 0.0,
               seed: int = 0, timeout: Optional[float] = None,
               ctx=None, tier: Optional[str] = None) -> _GenRequest:
        """Enqueue one generate request. ``prompt`` is a 1-d (or (1, T0))
        sequence of token ids; returns a waitable handle. ``ctx`` is the
        request's trace context (minted at HTTP admission; in-process
        callers get a fresh unsampled one); ``tier`` is the priority
        tier (gold / standard / best_effort)."""
        probe = self._admit_guard()
        tier = tiers.parse_tier(tier)
        prompt = np.asarray(prompt)
        if prompt.ndim > 1 and prompt.shape[0] != 1:
            raise ValueError(
                f"prompt must be one sequence (1-d or (1, T)); got shape "
                f"{prompt.shape} — submit one request per prompt")
        prompt = prompt.reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        if int(n_tokens) < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if prompt.size + n_tokens > self.capacity:
            raise ValueError(
                f"prompt ({prompt.size}) + n_tokens ({n_tokens}) exceeds "
                f"slot capacity {self.capacity}")
        if self._paged and not self.session.can_ever_fit(prompt.size,
                                                         n_tokens):
            # a worst case beyond the WHOLE pool can never be admitted:
            # a client error, not transient pressure
            raise ValueError(
                f"prompt ({prompt.size}) + n_tokens ({n_tokens}) needs "
                f"more KV pages than the whole pool "
                f"({self.session.pages_total()} pages of "
                f"{self.session.page_size} tokens)")
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        if ctx is None:
            ctx = RequestContext(route=self.name, deadline=deadline)
        ctx.attrs["tier"] = tier
        ctx.phase_done("admission", now_in="queue_wait")
        r = _GenRequest(prompt, int(n_tokens), float(temperature),
                        int(seed), deadline, ctx=ctx)
        r.probe = probe
        r.tier = tier
        return self._enqueue(r)

    def generate(self, prompt, n_tokens: int, temperature: float = 0.0,
                 seed: int = 0, timeout: Optional[float] = None,
                 ctx=None, tier: Optional[str] = None) -> np.ndarray:
        return self.wait(self.submit(prompt, n_tokens, temperature, seed,
                                     timeout=timeout, ctx=ctx, tier=tier))

    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _extra_depth(self) -> int:
        return len(self._pending)

    # ---- iteration-level scheduling ----
    def _pump(self, block: bool) -> None:
        """Move everything queued into the pending list (blocking briefly
        only when the batcher is otherwise idle)."""
        try:
            self._pending.append(
                self._queue.get(timeout=0.05 if block else 0.0))
        except queue.Empty:
            return
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _expire_pending(self) -> None:
        """Deadline enforcement runs EVERY step, also while all slots are
        busy: a waiter fails at its deadline, not when a slot frees."""
        now = time.monotonic()
        keep = []
        for r in self._pending:
            if r.deadline is not None and now > r.deadline:
                self._fail_expired(r, "generate request deadline expired "
                                      "while queued (decoding never "
                                      "started)")
            else:
                keep.append(r)
        self._pending = keep

    def _next_pending(self) -> int:
        """Index of the next request to slot: weighted-fair across the
        tiers pending, FIFO within a tier (the TierQueue's contract,
        re-applied here because ``_pump`` drains the queue into
        ``_pending`` wholesale: slots, not dequeues, are this backend's
        scarce resource)."""
        present = sorted({r.tier for r in self._pending},
                         key=lambda t: tiers.PRIORITY.get(t, 1))
        chosen = self._picker.pick(present)
        return next(i for i, r in enumerate(self._pending)
                    if r.tier == chosen)

    def _admit(self) -> None:
        while self._pending:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                return
            if self._kv_blocked not in self._pending:
                # the blocked request expired or was swept: release it
                self._kv_blocked = None
            # a request the pool could not place yet stays the head
            # until it fits
            nxt = (self._next_pending() if self._kv_blocked is None
                   else self._pending.index(self._kv_blocked))
            resume = 0
            if self._paged:
                try:
                    lease = self.session.reserve(
                        self._pending[nxt].prompt,
                        self._pending[nxt].n_tokens)
                except KVPagePoolExhaustedError:
                    self._kv_blocked = self._pending[nxt]
                    return
                r = self._pending.pop(nxt)
                if r is self._kv_blocked:
                    self._kv_blocked = None
                self.session.bind(free[0], lease)
                resume = lease.resume_pos
                if lease.prefix_hit_tokens:
                    self._prefix_hits.inc()
                self._sync_evictions()
            else:
                r = self._pending.pop(nxt)
                self.session.reset_slot(free[0])
            # slotted: queue_wait ends, prefill begins; the ledger (and
            # the context, for /debug/requests) records how many prompt
            # tokens a prefix hit skipped
            attrs = {"slot": free[0]}
            if resume:
                attrs["prefix_hit_tokens"] = resume
            r.ctx.attrs["prefix_hit_tokens"] = resume
            r.ctx.phase_done("queue_wait", now_in="prefill", attrs=attrs)
            self._slots[free[0]] = _Slot(r, resume)

    @staticmethod
    def _sample(probs: np.ndarray, slot: _Slot) -> int:
        if not np.isfinite(probs).all():
            # np.argmax over an all-NaN row returns 0: a poisoned step
            # must fail THIS request loudly, not stream token 0
            raise ValueError(
                "non-finite probabilities in decode step (device fault or "
                "poisoned model output)")
        if slot.req.temperature <= 0:
            return int(np.argmax(probs))
        logits = np.log(probs + 1e-9) / slot.req.temperature
        p = np.exp(logits - logits.max())
        p = p / p.sum()
        return int(slot.rng.choice(p.size, p=p))

    def _fail_slot(self, i: int, err: BaseException) -> None:
        self._endpoint.count_error()
        self._deliver_failure(self._slots[i].req, err)
        self._release_slot(i)

    def _fail_active(self, err: BaseException) -> None:
        for i, s in enumerate(self._slots):
            if s is not None:
                self._fail_slot(i, err)

    def _loop(self) -> None:
        while not self._stop.is_set():
            have_active = any(s is not None for s in self._slots)
            self._pump(block=not have_active and not self._pending)
            self._expire_pending()
            self._admit()
            active = np.asarray([s is not None for s in self._slots])
            if not active.any():
                if (self._draining.is_set() and self._queue.empty()
                        and not self._pending):
                    self._drained.set()
                continue
            x = np.zeros((self.slots, 1, 1), np.float32)
            for i, s in enumerate(self._slots):
                if s is not None:
                    x[i, 0, 0] = s.feed
            # chaos site: crash kills the worker (active streams fail
            # with the crash error, the loop restarts), hang stalls a
            # step, poison NaNs this step's probabilities
            try:
                fault = chaos.step_fault("serving.worker.step")
            except BaseException as e:
                self._fail_active(e)
                raise
            try:
                probs = self.session.step_slots(x, active)
                if fault is not None and fault.kind == "poison":
                    probs = torch.full_like(probs, float("nan"))
                # the step's one host sync: the probabilities come back
                h = probs.cpu().numpy()
            except Exception as e:
                # a failed step poisons every active stream and may have
                # written some layers' k/v and not others: deliver the
                # error, recycle the slots and REBUILD the session state
                self._fail_active(e)
                self.session.reinit_states()
                continue
            self.device_steps += 1
            self._occupancy.record(int(active.sum()))
            now = time.monotonic()
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                if s.prompt_left:
                    # still prefilling: teacher-force the next prompt
                    # token; this step's output is discarded
                    s.feed = s.prompt_left.pop(0)
                    continue
                try:
                    nxt = self._sample(h[i, 0], s)
                except ValueError as e:
                    # a per-slot failure (non-finite probabilities) fails
                    # only this request, never the worker
                    self._fail_slot(i, e)
                    continue
                s.out.append(nxt)
                ctx = s.req.ctx
                tid = ctx.trace_id if ctx.sampled else None
                if len(s.out) == 1:
                    # first token: prefill ends, decode begins; TTFT from
                    # admission, prefix hits in their own population
                    ctx.phase_done("prefill", now_in="decode")
                    self._stream.record_ttft(now - s.req.t_submit,
                                             trace_id=tid,
                                             prefix_hit=s.prefix_hit > 0)
                else:
                    self._stream.record_itl(now - s.t_last_token,
                                            trace_id=tid)
                s.t_last_token = now
                if len(s.out) >= s.req.n_tokens:
                    s.req.result = np.asarray(s.out, np.int64)
                    # the decode segment closes BEFORE the event: the
                    # waiter's respond stamp must come after
                    ctx.phase_done("decode", now_in="respond",
                                   attrs={"tokens": len(s.out)})
                    s.req.event.set()
                    # a cleanly finished stream donates its full-prompt
                    # pages to the prefix cache
                    self._release_slot(i, register=True)
                else:
                    s.feed = nxt

    # ---- /debug/slots ----
    def slots_debug(self) -> List[dict]:
        """Per-slot state, with the trace id to chase it by. Read from
        request threads while the worker mutates the slot list: a
        best-effort snapshot, never blocking."""
        now = time.monotonic()
        out = []
        for i, s in enumerate(list(self._slots)):
            if s is None:
                out.append({"slot": i, "state": "free"})
                continue
            entry = {"slot": i,
                     "state": "prefill" if s.prompt_left else "decode",
                     "tokens_out": len(s.out),
                     "prompt_left": len(s.prompt_left),
                     "prefix_hit_tokens": s.prefix_hit,
                     "age_ms": round((now - s.t_slotted) * 1e3, 3),
                     "trace_id": s.req.ctx.trace_id,
                     "sampled": s.req.ctx.sampled}
            if self._paged:
                entry["kv_pages"] = self.session.slot_pages(i)
            out.append(entry)
        return out

    def kv_debug(self) -> Optional[dict]:
        """Pool and prefix-cache state (None on the dense path)."""
        if not self._paged:
            return None
        sess = self.session
        return {"page_size": sess.page_size,
                "kv_pages_total": sess.pages_total(),
                "kv_pages_in_use": sess.pages_in_use(),
                "pages_per_slot": sess.pages_per_slot,
                "prefix_cache_entries": len(sess.prefix_cache),
                "prefix_cache_hits_total": sess.prefix_cache.hits_total,
                "prefix_cache_evictions_total":
                    sess.prefix_cache.evictions_total}

    def _crash_casualties(self):
        # only streams mid-decode die with a crash; pending requests are
        # served by the restarted loop. Their page leases are released
        # here so refcounts cannot leak across the restart
        casualties = []
        for i, s in enumerate(self._slots):
            if s is not None:
                casualties.append(s.req)
                self._release_slot(i)
        return casualties

    def _abort_inflight(self):
        leftovers = self._crash_casualties()
        leftovers.extend(self._pending)
        self._pending = []
        return leftovers
