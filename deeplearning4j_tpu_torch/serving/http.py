"""Stdlib HTTP front end for the predict and generate paths
(counterpart of ``deeplearning4j_tpu/serving/http.py``).

- ``POST /v1/predict``  {"model", "version"?, "inputs", "timeout_ms"?}
  -> {"outputs", "model_version"}
- ``POST /v1/generate`` {"model", "version"?, "prompt", "n_tokens"?,
  "temperature"?, "seed"?, "timeout_ms"?} -> {"ids", "model_version"}
  (continuous batching over paged KV decode sessions, serving/
  continuous.py)
- ``GET  /v1/models``   -> {"models": registry listing}
- ``GET  /healthz``     -> {"status": "ok" | "draining", "models"}

Typed errors map to status codes as in the JAX package:
QueueFullError -> 429, DeadlineExceededError -> 504,
ModelNotFoundError -> 404, ServerClosedError (draining) -> 503, a bad
body -> 400, anything else -> 500. ``stop(drain=True)`` refuses new
work, completes queued and in-flight requests, then stops the listener.
``/metrics``, tracing, retrieval, the KV endpoints and the fleet are
not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.serving.continuous import ContinuousBatcher
from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ModelNotFoundError,
                                                     QueueFullError,
                                                     ServerClosedError,
                                                     ServingError)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ModelServer"]

_STATUS = ((QueueFullError, 429), (DeadlineExceededError, 504),
           (ModelNotFoundError, 404), (ServerClosedError, 503),
           (ServingError, 400), (ValueError, 400), (KeyError, 400),
           (TypeError, 400))


def _retry_after_header(seconds: float) -> str:
    """Integer delta-seconds, at least 1."""
    return str(max(1, int(-(-float(seconds) // 1))))


class ModelServer:
    """Registry + per-(model, version) schedulers (predict) and
    continuous batchers (generate) behind one HTTP listener, created on
    first use. ``slots``, ``capacity``, ``kv_mode``, ``page_size`` and
    ``kv_pages`` configure the batchers (``ContinuousBatcher``)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 max_batch_size: int = 32, queue_limit: int = 256,
                 wait_ms: float = 2.0, slots: int = 4,
                 capacity: int = 256, kv_mode: str = "auto",
                 page_size: int = 16, kv_pages: Optional[int] = None):
        self.registry = registry or ModelRegistry()
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
        self._schedulers: Dict[Tuple[str, int], BatchScheduler] = {}
        self._batchers: Dict[Tuple[str, int], ContinuousBatcher] = {}
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

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
                name=f"predict/{name}/v{version}"))
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
                queue_limit=self.queue_limit,
                name=f"generate/{name}/v{version}", kv_mode=self.kv_mode,
                page_size=self.page_size, kv_pages=self.kv_pages))
        return b, version

    # ---- endpoint handlers (also the in-process API) ----
    def health_payload(self) -> dict:
        if self._draining.is_set():
            return {"status": "draining"}
        return {"status": "ok", "models": self.registry.models()}

    def handle_predict(self, body: dict) -> dict:
        if not isinstance(body, dict) or "model" not in body \
                or "inputs" not in body:
            raise ValueError('predict body needs "model" and "inputs"')
        sched, version = self.scheduler_for(body["model"],
                                            body.get("version"))
        x = np.asarray(body["inputs"], np.float32)
        if x.ndim == 1:
            x = x[None, :]
        t = body.get("timeout_ms")
        out = sched.predict(x, timeout=None if t is None
                            else float(t) / 1e3)
        return {"outputs": out.tolist(), "model_version": version}

    def handle_generate(self, body: dict) -> dict:
        if not isinstance(body, dict) or "model" not in body \
                or "prompt" not in body:
            raise ValueError('generate body needs "model" and "prompt"')
        batcher, version = self.batcher_for(body["model"],
                                            body.get("version"))
        t = body.get("timeout_ms")
        ids = batcher.generate(
            np.asarray(body["prompt"], np.int64),
            int(body.get("n_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
            seed=int(body.get("seed", 0)),
            timeout=None if t is None else float(t) / 1e3)
        return {"ids": np.asarray(ids).tolist(), "model_version": version}

    # ---- HTTP plumbing ----
    def start(self) -> "ModelServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            disable_nagle_algorithm = True
            timeout = 30.0

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, obj, headers=None):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send(200, server.health_payload())
                elif path == "/v1/models":
                    self._send(200, {"models": server.registry.models()})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                handler = {"/v1/predict": server.handle_predict,
                           "/v1/generate": server.handle_generate}.get(
                               urlparse(self.path).path)
                if handler is None:
                    self._send(404, {"error": "not found"})
                    return
                if server._draining.is_set():
                    self._send(503, {"error": "server is draining"},
                               {"Retry-After": _retry_after_header(
                                   server.drain_retry_after_s)})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n < 0:
                        raise ValueError(f"negative Content-Length: {n}")
                    data = self.rfile.read(n)
                    if len(data) < n:
                        raise ValueError(f"body truncated: {len(data)} of "
                                         f"{n} byte(s)")
                    body = json.loads(data.decode() or "{}")
                except (ValueError, socket.timeout) as e:
                    self._send(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    self._send(200, handler(body))
                except Exception as e:
                    code = next((c for cls, c in _STATUS
                                 if isinstance(e, cls)), 500)
                    if code == 500:
                        logger.exception("serving error")
                    headers = {}
                    if code in (429, 503):
                        ra = getattr(e, "retry_after_s", None)
                        headers["Retry-After"] = _retry_after_header(
                            server.drain_retry_after_s if ra is None
                            else ra)
                    self._send(code, {"error": str(e)}, headers)

        with self._lock:
            if self._draining.is_set():
                raise ServerClosedError(
                    "server was stopped; not starting listener")
            if self._httpd is not None:
                return self

            class _Httpd(ThreadingHTTPServer):
                request_queue_size = 128

            self._httpd = _Httpd((self.host, self.port), Handler)
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
            self._schedulers.clear()
            self._batchers.clear()
        oks: Dict[int, bool] = {}
        threads = [threading.Thread(
            target=lambda i=i, b=b: oks.__setitem__(
                i, b.shutdown(drain=drain, timeout=timeout)),
            daemon=True) for i, b in enumerate(backends)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 10.0)
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        return all(oks.get(i, False) for i in range(len(backends)))
