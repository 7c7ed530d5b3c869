"""Stdlib HTTP front end for the predict and generate paths
(counterpart of ``deeplearning4j_tpu/serving/http.py``).

- ``POST /v1/predict``  {"model", "version"?, "inputs", "timeout_ms"?,
  "tier"?} -> {"outputs", "model_version"}
- ``POST /v1/generate`` {"model", "version"?, "prompt", "n_tokens"?,
  "temperature"?, "seed"?, "timeout_ms"?, "tier"?} -> {"ids",
  "model_version"} (continuous batching over paged KV decode sessions,
  serving/continuous.py)
- ``POST /v1/kv/export`` (the generate body) -> {"blob" (base64 DKVL
  lease), "model_version"}: the prompt's prefill runs here and its KV
  lease comes back instead of tokens (the prefill half of disaggregated
  serving)
- ``POST /v1/kv/import`` {"blob", "timeout_ms"?, "tier"?} -> {"ids",
  "model_version"}: the lease is rebuilt into this server's page pool
  and the stream decodes to the end (a bad blob is 422)
- ``POST /v1/kv/migrate`` -> {"parked": n}, ``/v1/kv/ack`` {"handle"}
  -> {"acked"}, ``/v1/kv/resume`` {"handle"} -> {"ids",
  "model_version"}: the drain-migration control plane, served while the
  server drains. After ``migrate``, a live stream's ``/v1/generate`` (or
  ``/v1/kv/import``) answers 202 {"migration": {"handle", "blob", "pos",
  "tokens_out", "model_version"}}; the holder imports the blob on a
  survivor and acks, or resumes the handle here
- ``GET  /v1/kv/prefixes`` -> {"page_size", "prefixes"}: the prefix-cache
  fingerprints, for KV-aware routing
- ``POST /v1/embed``    {"texts" | "text", "timeout_ms"?, "tier"?} ->
  {"embeddings", "dim", "model_version"}: the embedder is a registered
  model ("embedder"), batched by the ordinary scheduler
- ``POST /v1/search``   {"query" (text) | "vector"/"vectors", "k"?,
  "nprobe"?, "filter_ids"?, "timeout_ms"?, "tier"?} -> {"results":
  [[{"id", "score"}...]...], "k", "generation"}: text queries embed
  first, then search; both hops share one deadline budget
- ``POST /v1/index/{upsert,delete,compact,stats}``: admin verbs,
  single-writer serialized on the retrieval service's admin lock
  (``retrieval=``, ``serve --index``; see ``serving/retrieval_backend.py``)
- ``GET  /v1/models``   -> {"models": registry listing}
- ``GET  /healthz``     -> {"status": "ok" | "degraded" | "draining",
  ...}: always 200 for humans; the status field carries the judgement
  (firing alerts, non-closed circuit breakers, SLO breaches)
- ``GET  /readyz`` (or ``/healthz?ready``) -> the same payload, but 503
  with ``Retry-After`` when draining or degraded: the form a load
  balancer's check consumes
- ``GET  /metrics``     -> the ServingMetrics snapshot (JSON), or
  Prometheus text (``?format=prometheus`` or an ``Accept`` naming
  ``text/plain``), or OpenMetrics with exemplars
  (``?format=openmetrics`` or an ``Accept`` naming ``openmetrics``)
- ``GET  /debug/requests`` (in flight, recent, queue depth by tier,
  latency attribution), ``/debug/slots`` (generate slots and KV pool),
  ``/debug/traces`` (slow and errored requests),
  ``/debug/trace-export?since=&limit=`` (the tracer's span ring, paged)
  and ``/debug/bundle`` (a flight-recorder bundle as JSON);
  ``/debug/modules`` says whether the process imported jax or the JAX
  package (it must not)

``tier`` is the priority-admission tier (``gold`` / ``standard`` /
``best_effort``, default standard, see ``serving/tiers.py``). Every
request gets a trace context at admission (adopted from a W3C
``traceparent`` header or minted), and every response carries its
``traceparent``. Typed errors map to status codes as in the JAX
package: QueueFullError -> 429, DeadlineExceededError -> 504,
ModelNotFoundError -> 404, ServerClosedError and CircuitOpenError ->
503 (with a ``Retry-After`` the raiser priced: tier, breaker cooldown,
drain), KVLeaseError -> 422, a bad body -> 400, anything else -> 500;
error bodies carry the ``trace_id``. ``stop(drain=True)`` refuses new
work, completes queued and in-flight requests, then stops the listener;
the fleet calls ``migrate_streams()`` first, so a replica's live streams
leave as migration offers instead of finishing in place.
``chaos_delay_s`` (the ``serving.replica`` hang) stalls every handler.
``warmup()`` (``serve --aot-warmup``) runs every hosted model's predict
buckets and one dummy generate before traffic, which captures each
generate backend's decode-step CUDA graph (``serving/warmup.py``), and
the retrieval service's default search bucket. The serving mesh (a
tensor-parallel backend) waits for ROADMAP A6b.
"""

from __future__ import annotations

import base64
import binascii
import collections
import functools
import itertools
import json
import logging
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.observability.tracing import (RequestContext,
                                                            Sampler,
                                                            get_tracer)
from deeplearning4j_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                         MigrationOffer)
from deeplearning4j_tpu_torch.serving.errors import (CircuitOpenError,
                                                     DeadlineExceededError,
                                                     KVLeaseCorruptError,
                                                     KVLeaseError,
                                                     ModelNotFoundError,
                                                     QueueFullError,
                                                     ServerClosedError,
                                                     ServingError)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ModelServer"]

# typed error -> status, first match wins (CircuitOpenError and
# ServerClosedError both mean "this backend cannot take work now")
_STATUS = ((QueueFullError, 429), (DeadlineExceededError, 504),
           (ModelNotFoundError, 404), (ServerClosedError, 503),
           (CircuitOpenError, 503), (KVLeaseError, 422),
           (ServingError, 400),
           (ValueError, 400), (KeyError, 400), (TypeError, 400))


def _retry_after_header(seconds: float) -> str:
    """Integer delta-seconds, at least 1."""
    return str(max(1, int(-(-float(seconds) // 1))))


def _metrics_mode(path: str, accept: str) -> str:
    """"json" | "text" (Prometheus 0.0.4) | "openmetrics". Exemplars
    are only legal in OpenMetrics, so a scraper that wants them must
    say so (``format=openmetrics`` or the Accept header Prometheus
    sends)."""
    fmt = (parse_qs(urlparse(path).query).get("format") or [None])[0]
    if fmt in ("openmetrics", "json"):
        return fmt
    if fmt == "prometheus":
        return "text"
    if "openmetrics" in accept:
        return "openmetrics"
    if "text/plain" in accept:
        return "text"
    return "json"


_CONTENT_TYPES = {
    "openmetrics": "application/openmetrics-text; version=1.0.0; "
                   "charset=utf-8",
    "text": "text/plain; version=0.0.4; charset=utf-8"}


class _JsonRequestHandler(BaseHTTPRequestHandler):
    """The base of both listeners (ModelServer and the fleet Router):
    quiet logging, TCP_NODELAY, bounded reads and the JSON/bytes
    response helpers."""

    # headers and body go out as two writes: with Nagle on, the second
    # waits for the client's delayed ACK, ~40 ms a hop
    disable_nagle_algorithm = True
    # every read is bounded: a half-open peer costs one handler thread
    # 30 s, never wedges it
    timeout = 30.0

    def log_message(self, fmt, *args):
        pass

    def _send(self, code, obj, headers=None, content_type=None):
        data = obj if isinstance(obj, bytes) else \
            obj.encode() if isinstance(obj, str) else json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type or "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, code, text, content_type):
        self._send(code, text, content_type=content_type)

    def _metrics_mode(self) -> str:
        return _metrics_mode(self.path, self.headers.get("Accept", ""))

    def _content_length(self) -> int:
        n = int(self.headers.get("Content-Length", 0))
        if n < 0:
            # rfile.read(-1) reads to EOF: on a keep-alive connection
            # that blocks forever
            raise ValueError(f"negative Content-Length: {n}")
        return n

    def _read_body(self, n: int) -> bytes:
        """Exactly the advertised body under the socket deadline; a peer
        that stops mid-body is a ValueError (the callers' 400 path)."""
        try:
            data = self.rfile.read(n)
        except socket.timeout as e:
            raise ValueError(f"body read timed out after {self.timeout}s "
                             f"({n} byte(s) advertised)") from e
        if len(data) < n:
            raise ValueError(f"body truncated: Content-Length {n} but only "
                             f"{len(data)} byte(s) arrived")
        return data


def _make_listener(host: str, port: int, handler_cls):
    """ThreadingHTTPServer with a listen backlog of 128 (the stdlib's 5
    drops SYNs under connection churn, and a dropped SYN retries after
    ~1 s)."""
    class _Httpd(ThreadingHTTPServer):
        request_queue_size = 128

    return _Httpd((host, port), handler_cls)


class ModelServer:
    """Registry + per-(model, version) schedulers (predict) and
    continuous batchers (generate) behind one HTTP listener, created on
    first use. ``slots``, ``capacity``, ``kv_mode``, ``page_size`` and
    ``kv_pages`` configure the batchers. ``metrics`` is the shared
    ServingMetrics (one per server by default); ``alerts`` (an
    AlertManager) and ``slos`` (an SLOMonitor) are evaluated on every
    ``/healthz``; ``sample_rate`` / ``sample_routes`` set the head
    sampler, ``tracer`` the span sink (the process tracer by default);
    requests at or above ``slow_ms`` land in ``/debug/traces``."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 max_batch_size: int = 32, queue_limit: int = 256,
                 wait_ms: float = 2.0, slots: int = 4,
                 capacity: int = 256,
                 metrics: Optional[ServingMetrics] = None,
                 alerts=None, sample_rate: float = 0.01,
                 sample_routes: Optional[Dict[str, float]] = None,
                 slow_ms: float = 250.0, slos=None, tracer=None,
                 kv_mode: str = "auto", page_size: int = 16,
                 kv_pages: Optional[int] = None, retrieval=None):
        self.registry = registry or ModelRegistry()
        self.metrics = metrics or ServingMetrics()
        # last good /metrics payload per mode, served when a rebuild
        # raises mid-drain so a collector's final scrape still lands
        self._last_exposition: Dict[str, object] = {}
        self.alerts = alerts
        self.slos = slos
        self.sampler = Sampler(rate=sample_rate, routes=sample_routes)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.slow_ms = float(slow_ms)
        self._inflight: Dict[int, dict] = {}
        self._inflight_lock = threading.Lock()
        self._req_seq = itertools.count()
        # completed-request ring for /debug/traces and /debug/requests
        self._recent: collections.deque = collections.deque(maxlen=256)
        self.host = host
        self.port = port
        self.max_batch_size = max_batch_size
        self.queue_limit = queue_limit
        self.wait_ms = wait_ms
        self.slots = slots
        self.capacity = capacity
        self.kv_mode = kv_mode
        self.page_size = page_size
        self.kv_pages = kv_pages
        self.drain_retry_after_s = 2.0
        # chaos hook (site serving.replica, kind hang/slow): every
        # handler, health probes included, stalls this long, so a hung
        # replica looks to the router like a wedged process
        self.chaos_delay_s = 0.0
        self._schedulers: Dict[Tuple[str, int], BatchScheduler] = {}
        self._batchers: Dict[Tuple[str, int], ContinuousBatcher] = {}
        # batchers mid-drain: stop() clears _batchers before the drains,
        # but /v1/kv/resume and /v1/kv/ack must still find a draining
        # backend's parked streams (that is exactly when they arrive)
        self._stopping_batchers: List[ContinuousBatcher] = []
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # retrieval: a RetrievalService (or a callable building one from
        # the server's metrics, the in-process-fleet shape, so each
        # replica owns its index and search backends) hosting /v1/search
        # and /v1/index. Its embedder registers as the "embedder" model,
        # so /v1/embed is the predict path over another model.
        self.retrieval = None
        if retrieval is not None:
            self.retrieval = retrieval(self.metrics) \
                if callable(retrieval) \
                else retrieval.attach_metrics(self.metrics)
            emb = self.retrieval.embedder
            if emb is not None and "embedder" not in self.registry:
                self.registry.register("embedder", emb)

    # ---- backends ----
    def _get_or_create(self, table, key, make):
        with self._lock:
            if self._draining.is_set():
                raise ServerClosedError(
                    "server is draining; not creating new backends",
                    retry_after_s=self.drain_retry_after_s)
            b = table.get(key)
            if b is None:
                b = table[key] = make()
        return b

    def _backends(self):
        with self._lock:
            return (list(self._schedulers.values())
                    + list(self._batchers.values()))

    def scheduler_for(self, name: str, version: Optional[int] = None
                      ) -> Tuple[BatchScheduler, int]:
        """(scheduler, served version): the single resolution point for
        a predict request."""
        model, version = self.registry.resolve(name, version)
        s = self._get_or_create(
            self._schedulers, (name, version),
            lambda: BatchScheduler(
                model, max_batch_size=self.max_batch_size,
                queue_limit=self.queue_limit, wait_ms=self.wait_ms,
                metrics=self.metrics, name=f"predict/{name}/v{version}"))
        return s, version

    def batcher_for(self, name: str, version: Optional[int] = None
                    ) -> Tuple[ContinuousBatcher, int]:
        """(batcher, served version): the resolution point for a
        generate request."""
        model, version = self.registry.resolve(name, version)
        if not hasattr(model, "slot_streaming_session"):
            raise ServingError(
                f"model {name!r} does not support streaming generation "
                "(no slot_streaming_session)")
        b = self._get_or_create(
            self._batchers, (name, version),
            lambda: ContinuousBatcher(
                model, slots=self.slots, capacity=self.capacity,
                queue_limit=self.queue_limit, metrics=self.metrics,
                name=f"generate/{name}/v{version}",
                version=str(version), kv_mode=self.kv_mode,
                page_size=self.page_size, kv_pages=self.kv_pages,
                model_name=name))
        return b, version

    def warmup(self, **kwargs) -> Dict[str, dict]:
        """AOT warmup for every hosted model: run the predict pow2 batch
        buckets and (optionally) one short generate, whose first step
        captures the batcher's decode-step CUDA graph, so the first real
        request never pays a capture (see serving/warmup.py). Call
        before serving traffic. A hosted index's default search bucket
        is built and driven once too."""
        from deeplearning4j_tpu_torch.serving.warmup import warmup_server
        report = warmup_server(self, **kwargs)
        if self.retrieval is not None:
            report["_search"] = {"buckets": self.retrieval.warmup()}
        return report

    # ---- endpoint handlers (also the in-process API) ----
    @staticmethod
    def _timeout_s(body) -> Optional[float]:
        t = body.get("timeout_ms")
        return None if t is None else float(t) / 1e3

    def _handle_predict(self, body: dict, ctx=None) -> dict:
        if not isinstance(body, dict) or "model" not in body \
                or "inputs" not in body:
            raise ValueError('predict body needs "model" and "inputs"')
        sched, version = self.scheduler_for(body["model"],
                                            body.get("version"))
        x = np.asarray(body["inputs"], np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if ctx is not None:
            ctx.attrs["model_version"] = version
        out = sched.predict(x, timeout=self._timeout_s(body), ctx=ctx,
                            tier=body.get("tier"))
        return {"outputs": out.tolist(), "model_version": version}

    @staticmethod
    def _offer_payload(offer: MigrationOffer, version) -> Tuple[int, dict]:
        """The 202 body a :class:`MigrationOffer` becomes: the router
        imports ``blob`` on a survivor and acks, or resumes ``handle``
        here."""
        return 202, {"migration": {
            "handle": offer.handle,
            "blob": base64.b64encode(offer.blob).decode(),
            "pos": offer.pos,
            "tokens_out": offer.tokens_out,
            "model_version": version}}

    def _stream_reply(self, ids, version):
        if isinstance(ids, MigrationOffer):
            # the backend started draining mid-stream and exported this
            # stream's lease instead of finishing it
            return self._offer_payload(ids, version)
        return {"ids": np.asarray(ids).tolist(), "model_version": version}

    def _handle_generate(self, body: dict, ctx=None):
        if not isinstance(body, dict) or "model" not in body \
                or "prompt" not in body:
            raise ValueError('generate body needs "model" and "prompt"')
        batcher, version = self.batcher_for(body["model"],
                                            body.get("version"))
        if ctx is not None:
            ctx.attrs["model_version"] = version
        ids = batcher.generate(
            np.asarray(body["prompt"], np.int64),
            int(body.get("n_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)),
            timeout=self._timeout_s(body), ctx=ctx,
            tier=body.get("tier"))
        return self._stream_reply(ids, version)

    # ---- retrieval: embed + search + index admin ----
    def _require_retrieval(self):
        if self.retrieval is None:
            raise ModelNotFoundError(
                "no index hosted on this server (start it with "
                "serve --index)")
        return self.retrieval

    @staticmethod
    def _texts_of(body: dict, plural: str = "texts",
                  singular: str = "text"):
        texts = body.get(plural, body.get(singular))
        if texts is None:
            raise ValueError(f'body needs "{plural}" (list) or '
                             f'"{singular}" (string)')
        if isinstance(texts, str):
            texts = [texts]
        if not texts or not all(isinstance(t, str) for t in texts):
            raise ValueError(f'"{plural}" must be a non-empty list '
                             "of strings")
        return texts

    def _embed_sched(self, texts, timeout, ctx, tier):
        """Embed texts through the REGISTERED embedder's scheduler (the
        predict path, not a host-side shortcut): the (B, D) query
        matrix and the served model version."""
        r = self._require_retrieval()
        if r.embedder is None:
            raise ValueError(
                "this index has no embedder: send raw vectors")
        sched, version = self.scheduler_for("embedder")
        packed = r.embedder.encode(texts)
        out = sched.predict(packed, timeout=timeout, ctx=ctx, tier=tier)
        return np.asarray(out), version

    def _handle_embed(self, body: dict, ctx=None) -> dict:
        texts = self._texts_of(body)
        out, version = self._embed_sched(
            texts, self._timeout_s(body), ctx, body.get("tier"))
        if ctx is not None:
            ctx.attrs["model_version"] = version
        return {"embeddings": out.tolist(), "dim": int(out.shape[1]),
                "model_version": version}

    def _handle_search(self, body: dict, ctx=None) -> dict:
        r = self._require_retrieval()
        has_text = "query" in body or "queries" in body
        has_vec = "vector" in body or "vectors" in body
        if has_text == has_vec:
            raise ValueError(
                'search body needs exactly one of "query"/"queries" '
                '(text) or "vector"/"vectors" (raw floats)')
        k = int(body.get("k", 10))
        nprobe = body.get("nprobe")
        if nprobe is not None:
            nprobe = int(nprobe)
        filter_ids = body.get("filter_ids")
        if filter_ids is not None and not isinstance(
                filter_ids, (list, tuple)):
            raise ValueError('"filter_ids" must be a list of ids')
        tier = body.get("tier")
        timeout = self._timeout_s(body)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        embedder_version = None
        if has_text:
            texts = self._texts_of(body, "queries", "query")
            q, embedder_version = self._embed_sched(
                texts, timeout, ctx, tier)
        else:
            q = np.asarray(body.get("vectors", body.get("vector")),
                           np.float32)
            if q.ndim == 1:
                q = q[None, :]
        # one deadline budget across both hops: the search leg gets
        # whatever the embed leg left
        remaining = None if deadline is None \
            else deadline - time.monotonic()
        ids, scores = r.search(q, k=k, nprobe=nprobe,
                               filter_ids=filter_ids,
                               timeout=remaining, ctx=ctx, tier=tier)
        results = [[{"id": int(i), "score": float(s)}
                    for i, s in zip(row_ids, row_scores) if i >= 0]
                   for row_ids, row_scores in zip(ids, scores)]
        out = {"results": results, "k": k,
               "generation": r.index.generation}
        if embedder_version is not None:
            out["embedder_version"] = embedder_version
        if ctx is not None:
            ctx.attrs["index_generation"] = r.index.generation
        return out

    def _handle_index(self, verb: str, body: dict, ctx=None) -> dict:
        r = self._require_retrieval()
        if verb == "upsert":
            if "ids" not in body:
                raise ValueError('index upsert body needs "ids"')
            return r.upsert(body["ids"], vectors=body.get("vectors"),
                            texts=body.get("texts"))
        if verb == "delete":
            if "ids" not in body:
                raise ValueError('index delete body needs "ids"')
            return r.delete(body["ids"])
        if verb == "compact":
            return r.compact()
        return r.stats()

    # ---- disaggregated prefill/decode and drain migration ----
    def _handle_kv_export(self, body: dict, ctx=None):
        """``POST /v1/kv/export``, the prefill half: run the prompt's
        prefill here and return the serialized lease for a decode
        replica's ``/v1/kv/import``. The body is the generate body."""
        if not isinstance(body, dict) or "model" not in body \
                or "prompt" not in body:
            raise ValueError('kv export body needs "model" and "prompt"')
        batcher, version = self.batcher_for(body["model"],
                                            body.get("version"))
        if ctx is not None:
            ctx.attrs["model_version"] = version
        blob = batcher.prefill_export(
            np.asarray(body["prompt"], np.int64),
            int(body.get("n_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)),
            timeout=self._timeout_s(body), ctx=ctx, tier=body.get("tier"),
            export_extra={"model": body["model"], "version": version})
        if isinstance(blob, MigrationOffer):
            return self._offer_payload(blob, version)
        return {"blob": base64.b64encode(blob).decode(),
                "model_version": version}

    def _handle_kv_import(self, body: dict, ctx=None):
        """``POST /v1/kv/import``: rebuild an exported stream into this
        replica's page pool and decode it to the end. The lease's
        ``extra`` names the model; version, page and CRC skew fail typed
        (422)."""
        from deeplearning4j_tpu_torch.models.paged_kv import parse_lease
        if not isinstance(body, dict) or "blob" not in body:
            raise ValueError('kv import body needs "blob"')
        try:
            blob = base64.b64decode(body["blob"], validate=True)
        except (binascii.Error, ValueError, TypeError) as e:
            raise KVLeaseCorruptError(
                f"lease blob is not valid base64: {e}") from e
        header, _ = parse_lease(blob)
        extra = dict(header.get("extra") or {})
        model = extra.get("model")
        if not model:
            raise KVLeaseError("lease extra names no model: exported "
                               "outside the serving stack?")
        batcher, version = self.batcher_for(model, extra.get("version"))
        if ctx is not None:
            ctx.attrs["model_version"] = version
        ids = batcher.wait(batcher.import_stream(
            blob, timeout=self._timeout_s(body), ctx=ctx,
            tier=body.get("tier"), header=header))
        return self._stream_reply(ids, version)

    def _all_batchers(self) -> List[ContinuousBatcher]:
        """Live and mid-drain generate backends: the handle lookup set
        of the migration control plane."""
        with self._lock:
            return (list(self._batchers.values())
                    + list(self._stopping_batchers))

    def migrate_streams(self) -> int:
        """Arm drain migration on every paged generate backend: live
        streams complete with 202 migration offers the fleet router
        re-homes onto survivors. Returns how many live streams will be
        offered. The fleet calls this right before a retire/replace
        drain; ``POST /v1/kv/migrate`` is the same verb over HTTP."""
        return sum(b.request_migration() for b in self._all_batchers())

    def kv_ack(self, handle) -> bool:
        """``POST /v1/kv/ack``: a survivor imported the offered stream;
        the parked pages free."""
        if not handle:
            raise ValueError('kv ack body needs "handle"')
        return any(b.ack_migration(str(handle))
                   for b in self._all_batchers())

    def kv_resume(self, handle) -> dict:
        """``POST /v1/kv/resume``: the handoff failed; finish the parked
        stream HERE and return its ids (the generate reply's shape)."""
        if not handle:
            raise ValueError('kv resume body needs "handle"')
        for b in self._all_batchers():
            if b.has_migration(str(handle)):
                ids = b.resume_stream(str(handle))
                return {"ids": np.asarray(ids).tolist(),
                        "model_version": b.version}
        raise ValueError(f"unknown migration handle {handle!r}")

    def kv_prefixes(self, limit: int = 512) -> dict:
        """``GET /v1/kv/prefixes``: page size and cached prefix
        fingerprints, merged over the paged generate backends."""
        page_size = None
        prefixes: List[str] = []
        for b in self._all_batchers():
            d = b.prefix_digest(limit)
            if d is None:
                continue
            page_size = d["page_size"]
            prefixes.extend(d["prefixes"])
        return {"page_size": page_size, "prefixes": prefixes[-int(limit):]}

    # ---- request-scoped tracing plumbing ----
    def _mint_ctx(self, headers, route: str,
                  body: dict) -> RequestContext:
        t = self._timeout_s(body)
        deadline = time.monotonic() + t if t is not None else None
        ctx = RequestContext.from_traceparent(
            headers.get("traceparent"), route, self.sampler,
            deadline=deadline, tracer=self.tracer)
        if ctx is None:
            ctx = RequestContext.new(route, self.sampler,
                                     deadline=deadline, tracer=self.tracer)
        # announce the root span to the sinks: a crash bundle lists this
        # request as an unclosed span until finish() closes it
        ctx.open_root()
        return ctx

    def _track_request(self, ctx: RequestContext, body: dict) -> int:
        key = next(self._req_seq)
        with self._inflight_lock:
            self._inflight[key] = {"ctx": ctx, "model": body.get("model")}
        return key

    def _finish_request(self, key: int, ctx: RequestContext, code: int,
                        body: dict) -> None:
        with self._inflight_lock:
            self._inflight.pop(key, None)
        total_s = ctx.finish(attrs={"http_status": code})
        entry = {"trace_id": ctx.trace_id, "route": ctx.route,
                 "model": body.get("model"), "status": code,
                 "duration_ms": round(total_s * 1e3, 3),
                 "phases_ms": {k: round(v * 1e3, 3)
                               for k, v in ctx.phases.items()},
                 # scalar attrs (slot, prefix_hit_tokens, model_version)
                 # make the completion ring assertable
                 "attrs": {k: v for k, v in ctx.attrs.items()
                           if isinstance(v, (int, float, str, bool))},
                 "sampled": ctx.sampled,
                 "slow": total_s * 1e3 >= self.slow_ms or code >= 400,
                 "t_end": time.time()}
        if ctx.error is not None:
            entry["error"] = ctx.error
        with self._inflight_lock:
            self._recent.append(entry)

    # ---- /debug payloads ----
    def debug_requests(self) -> dict:
        """In-flight requests (current phase, age, deadline), the most
        recent completions, per-backend queue depth by tier, and the
        latency-attribution report."""
        with self._inflight_lock:
            inflight = [dict(v["ctx"].to_debug(), model=v["model"])
                        for v in self._inflight.values()]
            recent = list(self._recent)[-20:]
        by_tier = {b.name: d for b in self._backends()
                   for d in [b._queue.depth_by_tier()] if d}
        return {"in_flight": inflight,
                "in_flight_count": len(inflight),
                "recent": recent,
                "queue_by_tier": by_tier,
                "latency_attribution":
                    self.metrics.latency_attribution()}

    def debug_slots(self) -> dict:
        """Slot states per generate backend, with the KV pool and the
        prefix cache."""
        with self._lock:
            batchers = list(self._batchers.values())
        out = {}
        for b in batchers:
            entry = {"active_slots": b.active_slots(),
                     "pending": len(b._pending),
                     "slots": b.slots_debug()}
            kv = b.kv_debug()
            if kv is not None:
                entry["kv"] = kv
            out[b.name] = entry
        return {"backends": out}

    @staticmethod
    def modules_debug() -> dict:
        """Which of the two packages (and jax) this process imported: a
        port server, in-process or a fleet's child, shows no jax and no
        ``deeplearning4j_tpu``."""
        import torch
        return {"jax": "jax" in sys.modules,
                "deeplearning4j_tpu": "deeplearning4j_tpu" in sys.modules,
                "deeplearning4j_tpu_torch": True,
                "torch": torch.__version__,
                "cuda": torch.cuda.is_available()}

    def debug_traces(self) -> dict:
        """Recent slow and errored requests with their phase breakdown:
        what an exemplar trace id from /metrics resolves to."""
        with self._inflight_lock:
            recent = list(self._recent)
        slow = [e for e in recent if e.get("slow")]
        return {"slow": slow[-50:], "sample_rate": self.sampler.rate,
                "slow_ms": self.slow_ms}

    def metrics_exposition(self, mode: str):
        """The /metrics payload in ``mode`` (json | text |
        openmetrics); the last good one when a rebuild raises (registry
        churn mid-drain), so a collector's final scrape still lands."""
        try:
            if mode == "json":
                out = self.metrics.snapshot()
            else:
                out = self.metrics.prometheus_text(
                    openmetrics=mode == "openmetrics")
            self._last_exposition[mode] = out
        except Exception:
            out = self._last_exposition.get(mode)
            if out is None:
                raise
        return out

    # ---- health ----
    def health_payload(self) -> dict:
        """The /healthz body: status ``ok`` | ``degraded`` |
        ``draining`` plus the evidence (firing alerts, non-closed
        circuits, SLO breaches) and the models served."""
        if self._draining.is_set():
            return {"status": "draining"}
        firing = []
        if self.alerts is not None:
            try:
                self.alerts.evaluate()
                firing = self.alerts.firing()
            except Exception:
                logger.exception("alert evaluation failed")
        slo_status = None
        if self.slos is not None:
            try:
                self.slos.evaluate()
                slo_status = self.slos.status()
            except Exception:
                logger.exception("SLO evaluation failed")
        circuits = self._circuit_states()
        breached = [s for s in (slo_status or []) if s.get("breached")]
        if firing or circuits or breached:
            payload = {"status": "degraded"}
            if firing:
                payload["alerts"] = firing
            if circuits:
                payload["circuits"] = circuits
            if breached:
                payload["slo_breaches"] = breached
        else:
            payload = {"status": "ok"}
        if slo_status is not None:
            payload["slos"] = slo_status
        if self.retrieval is not None:
            # index generation + size ride the health payload: the
            # fleet's convergence checks (did the upsert land on every
            # replica) read them here
            payload["index"] = self.retrieval.describe()
        payload["models"] = self.registry.models()
        return payload

    def _unready_retry_after_s(self, payload: dict) -> float:
        """Backoff hint for a not-ready 503: the longest breaker
        cooldown still running when circuits degraded us, else the
        drain default."""
        if payload.get("circuits"):
            longest = max((b.breaker.cooldown_remaining()
                           for b in self._backends()), default=0.0)
            if longest > 0:
                return longest
        return self.drain_retry_after_s

    def _circuit_states(self) -> Dict[str, str]:
        """Backend name -> breaker state, for every backend whose
        circuit is NOT closed."""
        out = {}
        for b in self._backends():
            state = b.breaker.state
            if state != "closed":
                out[b.name] = state
        if self.retrieval is not None:
            out.update(self.retrieval.breaker_states())
        return out

    # ---- HTTP plumbing ----
    def start(self) -> "ModelServer":
        server = self

        class Handler(_JsonRequestHandler):
            def do_GET(self):
                url = urlparse(self.path)
                path = url.path
                if server.chaos_delay_s:
                    # chaos hang: the whole replica stalls, health
                    # probes included; the router must see it
                    time.sleep(server.chaos_delay_s)
                if path in ("/healthz", "/readyz"):
                    payload = server.health_payload()
                    ready = path == "/readyz" or "ready" in parse_qs(
                        url.query, keep_blank_values=True)
                    if ready and payload["status"] != "ok":
                        # the load-balancer form: draining/degraded IS a
                        # 503 (stop sending), with a backoff hint
                        self._send(503, payload, {
                            "Retry-After": _retry_after_header(
                                server._unready_retry_after_s(payload))})
                    else:
                        self._send(200, payload)
                elif path == "/metrics":
                    mode = self._metrics_mode()
                    self._send(200, server.metrics_exposition(mode),
                               content_type=_CONTENT_TYPES.get(mode))
                elif path == "/v1/models":
                    self._send(200, {"models": server.registry.models()})
                elif path == "/v1/kv/prefixes":
                    self._send(200, server.kv_prefixes())
                elif path == "/debug/requests":
                    self._send(200, server.debug_requests())
                elif path == "/debug/slots":
                    self._send(200, server.debug_slots())
                elif path == "/debug/traces":
                    self._send(200, server.debug_traces())
                elif path == "/debug/modules":
                    self._send(200, server.modules_debug())
                elif path == "/debug/trace-export":
                    q = parse_qs(url.query)
                    self._send(200, server.tracer.export_since(
                        since=int((q.get("since") or ["0"])[0]),
                        limit=int((q.get("limit") or ["10000"])[0])))
                elif path == "/debug/bundle":
                    from deeplearning4j_tpu_torch.observability.fleetobs \
                        import local_bundle_payload
                    reason = (parse_qs(url.query).get("reason")
                              or ["manual"])[0]
                    self._send(200, local_bundle_payload(
                        registry=server.metrics.registry,
                        tracer=server.tracer, reason=reason))
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                route = urlparse(self.path).path
                if route in ("/v1/kv/migrate", "/v1/kv/resume",
                             "/v1/kv/ack"):
                    # the migration control plane MUST work while the
                    # server drains (that is when it fires), so it skips
                    # the draining refusal below
                    self._kv_control(route)
                    return
                handler = {"/v1/predict": server._handle_predict,
                           "/v1/generate": server._handle_generate,
                           "/v1/embed": server._handle_embed,
                           "/v1/search": server._handle_search,
                           "/v1/kv/export": server._handle_kv_export,
                           "/v1/kv/import": server._handle_kv_import}.get(
                               route)
                if route in ("/v1/index/upsert", "/v1/index/delete",
                             "/v1/index/compact", "/v1/index/stats"):
                    handler = functools.partial(
                        server._handle_index, route.rsplit("/", 1)[1])
                if handler is None:
                    self._send(404, {"error": "not found"})
                    return
                if server.chaos_delay_s:
                    time.sleep(server.chaos_delay_s)
                if server._draining.is_set():
                    self._send(503, {"error": "server is draining"},
                               {"Retry-After": _retry_after_header(
                                   server.drain_retry_after_s)})
                    return
                try:
                    body = self._body()
                except ValueError as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                # admission: adopt the upstream trace or mint a fresh
                # one; the head sampling decision rides the context end
                # to end. Bad client input (a non-numeric timeout_ms)
                # still gets a 400, not a dropped connection
                try:
                    ctx = server._mint_ctx(self.headers, route, body)
                except (ValueError, KeyError, TypeError,
                        AttributeError) as e:
                    self._send(400, {"error": str(e)})
                    return
                key = server._track_request(ctx, body)
                code = 500
                try:
                    # attach() scopes the context to THIS handler thread
                    # only, restored on exit: pooled HTTP threads cannot
                    # leak a request's context
                    with ctx.attach():
                        reply = handler(body, ctx=ctx)
                    # a handler may set the status (the 202 offer)
                    code, reply = reply if isinstance(reply, tuple) \
                        else (200, reply)
                    self._send(code, reply,
                               {"traceparent": ctx.traceparent()})
                except Exception as e:
                    code = next((c for cls, c in _STATUS
                                 if isinstance(e, cls)), 500)
                    if code == 500:
                        logger.exception("serving error")
                    # always-sample on error: the promoted decision
                    # reaches the response header too
                    ctx.set_error(e)
                    headers = {"traceparent": ctx.traceparent()}
                    if code in (429, 503):
                        ra = getattr(e, "retry_after_s", None)
                        headers["Retry-After"] = _retry_after_header(
                            server.drain_retry_after_s if ra is None
                            else ra)
                    self._send(code, {"error": str(e),
                                      "trace_id": ctx.trace_id}, headers)
                finally:
                    server._finish_request(key, ctx, code, body)

            def _body(self):
                data = self._read_body(self._content_length())
                return json.loads(data.decode() or "{}")

            def _kv_control(self, route):
                if server.chaos_delay_s:
                    time.sleep(server.chaos_delay_s)
                try:
                    body = self._body()
                except ValueError as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    if route == "/v1/kv/migrate":
                        self._send(200, {"parked": server.migrate_streams()})
                    elif route == "/v1/kv/ack":
                        self._send(200, {"acked": server.kv_ack(
                            body.get("handle"))})
                    else:
                        self._send(200, server.kv_resume(body.get("handle")))
                except (ValueError, KeyError, TypeError,
                        AttributeError) as e:
                    # an unknown or claimed handle is the caller's answer,
                    # not a server fault: it falls back
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    logger.exception("kv control error")
                    self._send(500, {"error": str(e)})

        with self._lock:
            if self._draining.is_set():
                raise ServerClosedError(
                    "server was stopped; not starting listener")
            if self._httpd is not None:
                return self
            self._httpd = _make_listener(self.host, self.port, Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="model-server")
            self._thread.start()
        logger.info("model server on http://%s:%d/", self.host, self.port)
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Refuse new work, let every scheduler and batcher complete its
        queued and in-flight requests (concurrently), then stop the
        listener."""
        self._draining.set()
        with self._lock:
            backends = (list(self._schedulers.values())
                        + list(self._batchers.values()))
            # parked-stream lookups (/v1/kv/resume, /v1/kv/ack) keep
            # working through the drains below
            self._stopping_batchers = list(self._batchers.values())
            self._schedulers.clear()
            self._batchers.clear()
        oks: Dict[int, bool] = {}
        threads = [threading.Thread(
            target=lambda i=i, b=b: oks.__setitem__(
                i, b.shutdown(drain=drain, timeout=timeout)),
            daemon=True) for i, b in enumerate(backends)]
        retrieval = self.retrieval
        if retrieval is not None:
            # the search backends drain in the same concurrent wave
            # (close() also releases the retrieval gauges)
            threads.append(threading.Thread(
                target=lambda: oks.__setitem__(
                    -1, retrieval.close(drain=drain, timeout=timeout)),
                daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 10.0)
        with self._lock:
            self._stopping_batchers = []
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        return all(oks.get(i, False) for i in range(len(backends))) \
            and (retrieval is None or oks.get(-1, False))
