"""Continuous batching over bounded-KV-cache decode sessions
(counterpart of ``deeplearning4j_tpu/serving/continuous.py``).

Iteration-level scheduling (the Orca/vLLM idea): a fixed set of KV-cache
slots steps together, one (slots, 1, 1) decode step at a time, and
between steps finished slots are recycled to pending requests. Prompt
prefill rides the decode steps token by token (teacher-forced), so
admission never changes the step's shape, and on a card every paged
step replays the session's one captured CUDA graph.

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
stream that samples from them fails with the per-slot error).

KV streams (disaggregated prefill/decode and drain migration): a
``prefill_export`` request runs its prompt's prefill and completes with
the stream's serialized lease (the DKVL wire format of
``models/paged_kv.py``) instead of tokens; ``import_stream`` rebuilds
such a lease into this batcher's page pool and decodes the rest,
token-for-token what the exporter would have produced (temperature
streams carry their numpy rng state across). ``request_migration``
makes every live stream complete with a :class:`MigrationOffer` (its
lease plus a handle) while its slot stays parked; the holder acks the
handle once a survivor imported it (the pages free) or resumes it (the
stream finishes here). Page bytes reach the host only in
``PagedSlotSession.export_lease``, on the worker thread. The
``serving.kv.migrate`` chaos site sits on every hop (export and import):
``error`` fails the hop, ``slow`` stalls it, ``corrupt`` flips a byte
after the CRC was stamped.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.observability.tracing import RequestContext
from deeplearning4j_tpu_torch.serving import tiers
from deeplearning4j_tpu_torch.serving.errors import (KVLeaseError,
                                                     KVPagePoolExhaustedError,
                                                     ServingError)
from deeplearning4j_tpu_torch.serving.lifecycle import (BaseRequest,
                                                        CircuitBreaker,
                                                        ServingBackend)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["ContinuousBatcher", "MigrationOffer"]


def _migrate_chaos(blob: bytes) -> bytes:
    """The ``serving.kv.migrate`` chaos site, hit once per lease hop
    (export and import): ``error`` raises a transient ChaosIOError (a
    failed export leaves the stream on the incumbent; a failed import
    makes the router fall back), ``slow`` stalls the hop, ``corrupt``
    flips one payload byte AFTER the CRC was stamped, which the
    importer's integrity check must catch."""
    fault = chaos.hit("serving.kv.migrate")
    if fault is None:
        return blob
    if fault.kind == "error":
        raise chaos.ChaosIOError(
            f"[chaos] KV lease hop failed at ordinal #{fault.ordinal}")
    if fault.kind == "slow":
        time.sleep(float(fault.args.get("delay_s", 0.1)))
        return blob
    if fault.kind == "corrupt" and len(blob) > 8:
        # the flipped byte moves with the ordinal: an export-side and an
        # import-side corruption in one run must not XOR it back
        b = bytearray(blob)
        b[-1 - (fault.ordinal % 4)] ^= 0xFF
        return bytes(b)
    return blob


class MigrationOffer:
    """A request completed with an OFFER instead of tokens: the draining
    batcher exported the stream's KV lease and parked its slot. The
    holder (the fleet router) imports ``blob`` on a survivor and acks
    ``handle`` (the parked pages free), or resumes it (the stream
    finishes here). A parked slot nobody claims within
    ``migrate_resume_timeout_s`` resumes by itself."""

    __slots__ = ("handle", "blob", "pos", "tokens_out")

    def __init__(self, handle: str, blob: bytes, pos: int,
                 tokens_out: int):
        self.handle = handle
        self.blob = blob
        self.pos = int(pos)
        self.tokens_out = int(tokens_out)


class _GenRequest(BaseRequest):
    __slots__ = ("prompt", "n_tokens", "temperature", "seed",
                 "prefill_export", "export_extra", "import_blob",
                 "import_state")

    def __init__(self, prompt, n_tokens, temperature, seed, deadline,
                 ctx=None):
        super().__init__(deadline, ctx=ctx)
        self.prompt = prompt
        self.n_tokens = n_tokens
        self.temperature = temperature
        self.seed = seed
        # the disaggregated shapes of the same request: a prefill-only
        # submission completes with an exported lease blob instead of
        # tokens; an imported one starts from a rebuilt lease instead of
        # a cold prefill
        self.prefill_export = False
        self.export_extra: Optional[dict] = None
        self.import_blob: Optional[bytes] = None
        self.import_state: Optional[dict] = None


class _Slot:
    __slots__ = ("req", "feed", "prompt_left", "out", "rng", "prefix_hit",
                 "t_slotted", "t_last_token", "parked", "no_migrate")

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
        # parked = mid-migration: the slot holds its pages and the device
        # step skips it until acked (released) or resumed. A resumed
        # stream sets no_migrate: its handoff failed once, and offering
        # it again would ping-pong it
        self.parked = False
        self.no_migrate = False

    @classmethod
    def restored(cls, req: _GenRequest, pos: int, out,
                 rng_state) -> "_Slot":
        """Rebuild a slot from an imported lease: ``pos`` KV positions
        written elsewhere, ``out`` tokens already emitted. An out-empty
        restore is the prefix-hit shape (resume at ``pos``); a
        mid-decode one re-feeds the last emitted token. The sampling rng
        resumes from the exporter's state, so temperature streams stay
        identical across the hop."""
        out = [int(t) for t in (out or [])]
        if out:
            s = cls(req, resume=len(req.prompt) - 1)
            s.prompt_left = []
            s.feed = out[-1]
            s.out = out
        else:
            s = cls(req, resume=pos)
        s.prefix_hit = int(pos)
        if rng_state is not None and s.rng is not None:
            s.rng.bit_generator.state = rng_state
        return s


class ContinuousBatcher(ServingBackend):
    """Slot-recycling decode scheduler for one id-input (embedding-first)
    language model. ``slots`` is the device batch; ``capacity`` bounds
    prompt + generation length per request; ``version`` labels the
    streaming histograms; ``model_name`` (the registry name) rides every
    exported lease so an importing replica resolves the same model.
    ``device_steps`` counts the decode steps run; ``prefix_hits`` the
    admissions that reused cached prompt pages."""

    def __init__(self, net, slots: int = 4, capacity: int = 256,
                 queue_limit: int = 64,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "generate",
                 breaker: Optional[CircuitBreaker] = None,
                 version: str = "0", kv_mode: str = "auto",
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 model_name: Optional[str] = None):
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
        self.version = version
        self.model_name = model_name
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
        # drain migration: request_migration() arms the flag; the worker
        # then offers every live paged stream and parks its slot until
        # acked, resumed or the failsafe window passes
        self._migrate = threading.Event()
        self._migrate_lock = threading.Lock()
        self._parked: Dict[str, dict] = {}
        self.migrate_resume_timeout_s = 10.0
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
        # disaggregation traffic: prefill handoffs and drain offers
        # leaving this backend, exported streams rebuilt into it
        self._kv_exports = reg.counter(
            "kv_stream_exports_total",
            help="KV leases exported (prefill handoffs + drain "
                 "migration offers)", labels=lbl)
        self._kv_imports = reg.counter(
            "kv_stream_imports_total",
            help="exported streams rebuilt into this backend's "
                 "page pool", labels=lbl)

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
               ctx=None, tier: Optional[str] = None,
               prefill_export: bool = False,
               export_extra: Optional[dict] = None) -> _GenRequest:
        """Enqueue one generate request. ``prompt`` is a 1-d (or (1, T0))
        sequence of token ids; returns a waitable handle. ``ctx`` is the
        request's trace context (minted at HTTP admission; in-process
        callers get a fresh unsampled one); ``tier`` is the priority
        tier (gold / standard / best_effort). ``prefill_export`` makes
        the request complete with its exported lease after the prefill
        (``export_extra`` rides in the lease's header)."""
        probe = self._admit_guard()
        tier = tiers.parse_tier(tier)
        if prefill_export and not self._paged:
            # the exported artifact IS the page set; a dense session has
            # no portable form of its cache rows
            raise ServingError(
                f"{self.name!r} decodes over a dense KV session; prefill "
                "export needs kv_mode=paged (or auto with a transformer "
                "model)")
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
        r.prefill_export = bool(prefill_export)
        r.export_extra = dict(export_extra or {}) if prefill_export \
            else None
        return self._enqueue(r)

    def generate(self, prompt, n_tokens: int, temperature: float = 0.0,
                 seed: int = 0, timeout: Optional[float] = None,
                 ctx=None, tier: Optional[str] = None) -> np.ndarray:
        return self.wait(self.submit(prompt, n_tokens, temperature, seed,
                                     timeout=timeout, ctx=ctx, tier=tier))

    # ---- disaggregated prefill/decode (models/paged_kv.py leases) ----
    def prefill_export(self, prompt, n_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       timeout: Optional[float] = None, ctx=None,
                       tier: Optional[str] = None,
                       export_extra: Optional[dict] = None) -> bytes:
        """Run the prompt's prefill (all but the last token) and return
        the stream's serialized KV lease instead of decoding: the
        prefill half of disaggregated serving. The blob imports on any
        replica holding the same model (:meth:`import_stream`), which
        resumes at the last prompt token and streams the completion,
        token for token what running the whole request here gives."""
        return self.wait(self.submit(
            prompt, n_tokens, temperature, seed, timeout=timeout, ctx=ctx,
            tier=tier, prefill_export=True, export_extra=export_extra))

    def import_stream(self, blob: bytes, timeout: Optional[float] = None,
                      ctx=None, tier: Optional[str] = None,
                      header: Optional[dict] = None) -> _GenRequest:
        """Admit an exported stream (a prefill handoff or a drain
        offer): validate the blob, rebuild the request and queue it; at
        slotting the lease is rebuilt into this session's page pool and
        decode resumes mid-stream. A corrupt blob raises
        :class:`~.errors.KVLeaseCorruptError`, version or model skew
        :class:`~.errors.KVLeaseVersionError` (both here, both 422:
        sending a bad blob elsewhere cannot help). Pool pressure keeps
        the request pending like a cold reservation. ``header`` is the
        already-parsed lease header, when the caller has it."""
        from deeplearning4j_tpu_torch.models.paged_kv import parse_lease
        probe = self._admit_guard()
        tier = tiers.parse_tier(tier)
        if not self._paged:
            raise ServingError(
                f"{self.name!r} decodes over a dense KV session; lease "
                "import needs kv_mode=paged")
        blob = _migrate_chaos(bytes(blob))
        if header is None:
            # the synchronous integrity gate (the payload CRC runs again,
            # authoritatively, at slotting)
            header, _ = parse_lease(blob)
        extra = dict(header.get("extra") or {})
        prompt = np.asarray(extra.get("prompt", []), np.int64).reshape(-1)
        n_tokens = int(extra.get("n_tokens", 0))
        if prompt.size == 0 or n_tokens < 1:
            raise KVLeaseError(
                "lease extra lacks the stream state (prompt / n_tokens): "
                "not a stream export")
        if prompt.size + n_tokens > self.capacity:
            raise ValueError(
                f"imported stream's prompt ({prompt.size}) + n_tokens "
                f"({n_tokens}) exceeds slot capacity {self.capacity}")
        if not self.session.can_ever_fit(prompt.size, n_tokens):
            raise ValueError(
                f"imported stream needs more KV pages than the whole pool "
                f"({self.session.pages_total()} pages of "
                f"{self.session.page_size} tokens)")
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        if ctx is None:
            ctx = RequestContext(route=self.name, deadline=deadline)
        req_tier = tiers.parse_tier(extra.get("tier")) \
            if extra.get("tier") else tier
        ctx.attrs["tier"] = req_tier
        ctx.phase_done("admission", now_in="queue_wait")
        r = _GenRequest(prompt, n_tokens,
                        float(extra.get("temperature", 0.0)),
                        int(extra.get("seed", 0)), deadline, ctx=ctx)
        r.probe = probe
        r.tier = req_tier
        r.import_blob = blob
        r.import_state = {"pos": int(header.get("pos", 0)),
                          "out": extra.get("out") or [],
                          "rng_state": extra.get("rng_state")}
        return self._enqueue(r)

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
            if self._paged and self._pending[nxt].import_blob is not None:
                if not self._admit_import(nxt, free[0]):
                    return
                continue
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
            slot = self._slots[free[0]] = _Slot(r, resume)
            if r.prefill_export and not slot.prompt_left:
                # the whole prefill was covered by cached pages (or a
                # one-token prompt): the export point is already here
                self._finish_prefill_export(free[0], slot)

    def _admit_import(self, nxt: int, i: int) -> bool:
        """Slot the pending imported stream ``nxt`` into free slot ``i``:
        the lease rebuilds into THIS pool (fresh pages, payload written
        in) and decode resumes where the exporter stopped. False when
        the pool cannot hold it yet (it becomes the sticky head). A bad
        blob fails its request typed and never the worker: /v1/kv/import
        is a public surface."""
        head = self._pending[nxt]
        try:
            lease, _ = self.session.import_lease(
                head.import_blob, head.prompt.size + head.n_tokens)
        except KVPagePoolExhaustedError:
            self._kv_blocked = head
            return False
        except Exception as e:
            if not isinstance(e, KVLeaseError):
                e = KVLeaseError(f"lease import failed: {e!r}")
            self._pending.pop(nxt)
            if head is self._kv_blocked:
                self._kv_blocked = None
            self._endpoint.count_error()
            self._deliver_failure(head, e)
            return True
        r = self._pending.pop(nxt)
        if r is self._kv_blocked:
            self._kv_blocked = None
        st = r.import_state
        out_toks = st["out"]
        pos = int(st["pos"])
        if not out_toks and pos >= r.prompt.size:
            # an out-empty restore re-feeds prompt[pos]: a blob claiming
            # more written positions than the prompt has would index
            # past it. Fail typed and give the pages back
            self.session.allocator.decref(lease.pages)
            self._endpoint.count_error()
            self._deliver_failure(r, KVLeaseError(
                f"lease position {pos} exceeds the prompt length "
                f"{r.prompt.size} with no emitted tokens"))
            return True
        self.session.bind(i, lease)
        try:
            slot = _Slot.restored(r, pos, out_toks, st["rng_state"])
        except Exception as e:
            # e.g. a malformed rng state: the slot is bound, so release
            # returns the pages; the request fails typed
            self.session.release(i)
            self._endpoint.count_error()
            self._deliver_failure(r, KVLeaseError(
                f"lease stream state failed to restore: {e!r}"))
            return True
        self._sync_evictions()
        self._kv_imports.inc()
        r.ctx.attrs["kv_imported_tokens"] = slot.prefix_hit
        r.ctx.phase_done("queue_wait",
                         now_in="decode" if slot.out else "prefill",
                         attrs={"slot": i,
                                "kv_imported_tokens": slot.prefix_hit})
        self._slots[i] = slot
        return True

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

    # ---- KV streams: export and drain migration ----
    def _stream_extra(self, s: _Slot) -> dict:
        """The stream state a lease carries besides the pages: what the
        importing batcher needs to resume decoding identically."""
        extra = {"prompt": [int(t) for t in s.req.prompt],
                 "out": [int(t) for t in s.out],
                 "n_tokens": int(s.req.n_tokens),
                 "temperature": float(s.req.temperature),
                 "seed": int(s.req.seed),
                 "tier": s.req.tier}
        if s.rng is not None:
            extra["rng_state"] = s.rng.bit_generator.state
        if self.model_name is not None:
            extra["model"] = self.model_name
            try:
                extra["version"] = int(self.version)
            except (TypeError, ValueError):
                pass
        if s.req.export_extra:
            extra.update(s.req.export_extra)
        return extra

    def _finish_prefill_export(self, i: int, s: _Slot) -> None:
        """Complete a prefill-only request at its export point (every
        prompt position but the last is in the KV cache): serialize the
        slot's lease, donate the written prompt pages to the local
        prefix cache and recycle the slot. Worker thread only."""
        try:
            blob = _migrate_chaos(self.session.export_lease(
                i, extra=self._stream_extra(s)))
        except BaseException as e:
            self._fail_slot(i, e)
            return
        self.session.register_written_prefix(i, s.req.prompt)
        self._kv_exports.inc()
        pos = int(self.session.slot_pos[i])
        s.req.result = blob
        s.req.ctx.attrs["kv_exported_tokens"] = pos
        s.req.ctx.phase_done("prefill", now_in="respond",
                             attrs={"kv_exported_tokens": pos})
        s.req.event.set()
        self._release_slot(i)

    def _offer_migration(self, i: int, s: _Slot) -> None:
        """Export one live stream and PARK its slot: the waiting request
        completes with a :class:`MigrationOffer` while the pages stay, so
        a failed handoff can resume here. A failed export is silent: the
        stream finishes on this backend (retrying every step would copy
        the pages to the host once a step for nothing)."""
        try:
            blob = _migrate_chaos(self.session.export_lease(
                i, extra=self._stream_extra(s)))
        except BaseException:
            s.no_migrate = True
            return
        handle = uuid.uuid4().hex
        with self._migrate_lock:
            self._parked[handle] = {"slot": i, "state": "parked",
                                    "t": time.monotonic()}
        s.parked = True
        self._kv_exports.inc()
        pos = int(self.session.slot_pos[i])
        s.req.result = MigrationOffer(handle, blob, pos, len(s.out))
        s.req.ctx.attrs["kv_migrated"] = True
        s.req.ctx.phase_done("decode" if s.out else "prefill",
                             now_in="respond", attrs={"kv_migrated": True})
        s.req.event.set()

    def _unpark(self, handle: str, s: _Slot) -> None:
        # the stream finishes here; its context already closed with the
        # offer, and the resume caller (if any) owns the new waiter
        s.req.ctx = None
        s.parked = False
        s.no_migrate = True
        with self._migrate_lock:
            self._parked.pop(handle, None)

    def _service_migration(self) -> None:
        """Worker-side migration bookkeeping each iteration: free acked
        slots, un-park resumed or failsafe-expired ones, and offer every
        live stream once migration is armed."""
        if not self._paged:
            return
        now = time.monotonic()
        with self._migrate_lock:
            entries = list(self._parked.items())
        for handle, ent in entries:
            i = ent["slot"]
            s = self._slots[i]
            if s is None:
                with self._migrate_lock:
                    self._parked.pop(handle, None)
            elif ent["state"] == "acked":
                # a survivor owns the stream now: drop the pages
                self._release_slot(i)
                with self._migrate_lock:
                    self._parked.pop(handle, None)
            elif ent["state"] == "resumed" or \
                    now - ent["t"] > self.migrate_resume_timeout_s:
                # a failed handoff, or an offer nobody claimed (the
                # router died mid-drain, or a caller outside the fleet
                # got the 202): finish the decode here so the pages free
                # and the drain completes
                self._unpark(handle, s)
        if self._migrate.is_set():
            for i, s in enumerate(self._slots):
                if s is not None and not s.parked and not s.no_migrate \
                        and not s.req.prefill_export \
                        and not s.req.event.is_set():
                    self._offer_migration(i, s)

    def request_migration(self) -> int:
        """Arm drain migration: every live stream is exported as a
        :class:`MigrationOffer` on the next worker iteration (streams
        admitted later are offered too, until the backend stops).
        Returns the streams live at the call; a dense backend returns 0
        and finishes its streams in place."""
        if not self._paged:
            return 0
        n = sum(1 for s in self._slots if s is not None and not s.parked)
        self._migrate.set()
        return n

    def resume_stream(self, handle: str):
        """Failed-handoff fallback: un-park the offered stream, finish it
        HERE and return the completed token array."""
        with self._migrate_lock:
            ent = self._parked.get(handle)
            if ent is None or ent["state"] != "parked":
                raise ValueError(
                    f"unknown or already-claimed migration handle "
                    f"{handle!r}")
            s = self._slots[ent["slot"]]
            if s is None:
                self._parked.pop(handle, None)
                raise ValueError(
                    f"migration handle {handle!r} no longer holds a "
                    "stream")
            r = s.req
            r.event = threading.Event()
            r.result = None
            r.error = None
            ent["state"] = "resumed"
        return self.wait(r)

    def has_migration(self, handle: str) -> bool:
        """Does this backend hold the (unclaimed) parked stream behind
        ``handle``?"""
        with self._migrate_lock:
            ent = self._parked.get(handle)
            return ent is not None and ent["state"] == "parked"

    def ack_migration(self, handle: str) -> bool:
        """Successful handoff: a survivor imported the lease, so the
        parked slot's pages free on the next worker iteration. False
        when the handle is unknown or already claimed."""
        with self._migrate_lock:
            ent = self._parked.get(handle)
            if ent is None or ent["state"] != "parked":
                return False
            ent["state"] = "acked"
        return True

    def prefix_digest(self, limit: int = 512) -> Optional[dict]:
        """The advertisement for KV-aware routing: page size and the
        fingerprints of the cached prompt prefixes (None when dense)."""
        if not self._paged:
            return None
        return {"page_size": self.session.page_size,
                "prefixes": self.session.prefix_cache.fingerprints(limit)}

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._service_migration()
            have_active = any(s is not None and not s.parked
                              for s in self._slots)
            self._pump(block=not have_active and not self._pending)
            self._expire_pending()
            self._admit()
            active = np.asarray([s is not None and not s.parked
                                 for s in self._slots])
            if not active.any():
                # parked slots count: a drain must not complete while an
                # unclaimed offer still owns pages
                if (self._draining.is_set() and self._queue.empty()
                        and not self._pending
                        and not any(s is not None for s in self._slots)):
                    self._drained.set()
                continue
            x = np.zeros((self.slots, 1, 1), np.float32)
            for i, s in enumerate(self._slots):
                if s is not None and not s.parked:
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
                # (on a card, the static output of the session's CUDA
                # graph: copied before the next replay overwrites it)
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
                if s is None or s.parked:
                    continue
                if s.prompt_left:
                    # still prefilling: teacher-force the next prompt
                    # token; this step's output is discarded
                    s.feed = s.prompt_left.pop(0)
                    if not s.prompt_left and s.req.prefill_export:
                        # the export point: every prompt position but the
                        # last is in the KV cache; the decode replica
                        # re-feeds the last token and samples
                        self._finish_prefill_export(i, s)
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
                tid = ctx.trace_id if ctx is not None and ctx.sampled \
                    else None
                if len(s.out) == 1:
                    # first token: prefill ends, decode begins; TTFT from
                    # admission, prefix hits in their own population
                    if ctx is not None:
                        ctx.phase_done("prefill", now_in="decode")
                    self._stream.record_ttft(now - s.req.t_submit,
                                             trace_id=tid,
                                             prefix_hit=s.prefix_hit > 0)
                elif s.t_last_token is not None:
                    # (a stream restored mid-decode has no last token
                    # here yet)
                    self._stream.record_itl(now - s.t_last_token,
                                            trace_id=tid)
                s.t_last_token = now
                if len(s.out) >= s.req.n_tokens:
                    s.req.result = np.asarray(s.out, np.int64)
                    # the decode segment closes BEFORE the event: the
                    # waiter's respond stamp must come after
                    if ctx is not None:
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
                     "state": "parked" if s.parked
                     else "prefill" if s.prompt_left else "decode",
                     "tokens_out": len(s.out),
                     "prompt_left": len(s.prompt_left),
                     "prefix_hit_tokens": s.prefix_hit,
                     "age_ms": round((now - s.t_slotted) * 1e3, 3)}
            if self._paged:
                entry["kv_pages"] = self.session.slot_pages(i)
            if s.req.ctx is not None:
                entry["trace_id"] = s.req.ctx.trace_id
                entry["sampled"] = s.req.ctx.sampled
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
