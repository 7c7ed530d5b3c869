"""Flight recorder: a bounded black box that survives the crash
(counterpart of ``deeplearning4j_tpu/observability/flight_recorder.py``).

The flight recorder keeps the last N observability events — tracer
spans, serving worker crashes, fired chaos faults — in a ring buffer,
and on a backend crash or an explicit ``dump()`` writes a
**self-contained post-mortem bundle**:

    <out_dir>/postmortem-<stamp>-<reason>/
        MANIFEST.json   reason, timestamps, file list, drop counts
        events.jsonl    the ring, one JSON event per line
        trace.json      Chrome trace-event JSON (Perfetto-loadable)
        env.json        torch/CUDA/device/platform/env snapshot
        metrics.json    MetricsRegistry snapshot

Everything in the bundle loads standalone — no repo, no model, no
live process needed. Wiring:

- ``FlightRecorder(...)`` subscribes itself to the process tracer
  (``Tracer.add_sink``) so spans stream in while tracing is enabled;
- ``install()`` makes it the process recorder: the executors' fit
  loops call :func:`on_fit_exception` on any escaping exception, and
  serving backends call :func:`on_backend_crash` from their worker's
  crash handler, so an aborted run or a crash-looping backend leaves a
  bundle without per-callsite wiring.

Backend-crash dumps are debounced (``min_dump_interval_s``): a crash
loop must not fill the disk with bundles; a fit-loop exception and an
explicit ``dump()`` always write. ``HealthMonitor(recorder=...)``
(``observability/health.py``) hands every anomaly to
:meth:`FlightRecorder.on_anomaly`, which records it and dumps
(debounced).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import platform
import sys
import threading
import time
import traceback
from typing import List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["FlightRecorder", "install", "uninstall", "get_recorder",
           "on_fit_exception", "on_backend_crash"]


def _jsonable(obj):
    """Best-effort JSON coercion for ring payloads (numpy scalars,
    dataclasses, exceptions)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, BaseException):
        return repr(obj)
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return str(obj)


class FlightRecorder:
    def __init__(self, capacity: int = 20_000,
                 out_dir: Optional[str] = None,
                 registry=None, tracer=None,
                 capture_spans: bool = True,
                 min_dump_interval_s: float = 60.0):
        self.capacity = capacity
        self.out_dir = out_dir
        if registry is None:
            from deeplearning4j_tpu_torch.observability.registry import (
                REGISTRY)
            registry = REGISTRY
        self.registry = registry
        if tracer is None:
            from deeplearning4j_tpu_torch.observability.tracing import trace
            tracer = trace
        self.tracer = tracer
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=capacity)
        # spans the tracer announced OPEN but has not yet closed:
        # keyed by span id (fallback: name+thread+ts); a crash-time
        # bundle includes these with an ``unclosed`` marker — the
        # work in flight at the moment of death, which close-only
        # sinks used to lose entirely
        self._open_spans: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._open_cap = 4096
        self.total_events = 0       # including ones the ring dropped
        self.dumps: List[str] = []
        self._last_dump = -float("inf")
        self.min_dump_interval_s = min_dump_interval_s
        self._sink_installed = False
        if capture_spans:
            try:
                self.tracer.add_sink(self._on_span)
                self._sink_installed = True
            except Exception:
                logger.exception("could not subscribe to tracer")

    def close(self) -> None:
        if self._sink_installed:
            try:
                self.tracer.remove_sink(self._on_span)
            except Exception:
                pass
            self._sink_installed = False

    # ------------------------------------------------------------------
    # feeds
    # ------------------------------------------------------------------
    def record(self, kind: str, /, **payload) -> None:
        # ``kind`` is positional-only so a payload carrying its own
        # "kind" key can't collide with the event kind
        ev = {"t": time.time()}
        ev.update(payload)
        ev["kind"] = kind
        with self._lock:
            self._events.append(ev)
            self.total_events += 1

    @staticmethod
    def _span_key(span_event: dict) -> str:
        sid = span_event.get("span_id")
        if sid:
            return sid
        return (f"{span_event.get('name')}|{span_event.get('tid')}|"
                f"{span_event.get('ts_us')}")

    def _on_span(self, span_event: dict) -> None:
        # tracer sink: span-open events maintain the open-span table
        # (never the ring); close events retire their open entry and
        # land in the ring. The ring bounds memory, never the tracer.
        if span_event.get("ph") == "open":
            ev = {"t": time.time(), "kind": "span_open"}
            ev.update(span_event)
            with self._lock:
                self._open_spans[self._span_key(span_event)] = ev
                while len(self._open_spans) > self._open_cap:
                    self._open_spans.popitem(last=False)
            return
        ev = {"t": time.time(), "kind": "span"}
        ev.update(span_event)
        with self._lock:
            self._open_spans.pop(self._span_key(span_event), None)
            self._events.append(ev)
            self.total_events += 1

    def record_registry_snapshot(self) -> None:
        try:
            self.record("metrics", snapshot=self.registry.snapshot())
        except Exception:
            logger.exception("registry snapshot failed")

    def put_update(self, report) -> None:
        """Stats-storage protocol: a StatsReport (a dataclass) lands
        in the ring, so the recorder can sit behind a HealthMonitor's
        ``storage=``."""
        try:
            payload = dataclasses.asdict(report)
        except TypeError:
            payload = {"repr": repr(report)}
        self.record("stats_report", report=payload)

    def on_anomaly(self, anomaly: dict) -> None:
        """Health-monitor hook (``HealthMonitor(recorder=...)``):
        record the anomaly, then dump (debounced)."""
        payload = dict(anomaly)
        payload["detector"] = payload.pop("kind", "unknown")
        self.record("anomaly", **payload)
        self.dump(reason=f"anomaly_{payload['detector']}",
                  force=False)

    def on_exception(self, where: str, exc: BaseException,
                     force: bool = True, **context) -> None:
        self.record("exception", where=where, error=repr(exc),
                    traceback="".join(traceback.format_exception(
                        type(exc), exc, exc.__traceback__))[-8000:],
                    **context)
        self.dump(reason=f"exception_{where}", force=force)

    # ------------------------------------------------------------------
    # snapshotting
    # ------------------------------------------------------------------
    def env_snapshot(self) -> dict:
        snap = {
            "time": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "python": sys.version,
            "platform": platform.platform(),
            "hostname": platform.node(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("CUDA_", "TORCH_", "NVIDIA_"))},
        }
        try:
            import torch
            snap["torch_version"] = torch.__version__
            snap["cuda_version"] = torch.version.cuda
            snap["devices"] = [
                {"id": i, "name": props.name,
                 "capability": f"{props.major}.{props.minor}",
                 "memory_bytes": props.total_memory}
                for i in range(torch.cuda.device_count())
                for props in [torch.cuda.get_device_properties(i)]]
        except Exception as e:
            snap["devices_error"] = repr(e)
        return snap

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # ------------------------------------------------------------------
    # the bundle
    # ------------------------------------------------------------------
    def dump(self, reason: str = "manual",
             out_dir: Optional[str] = None,
             force: bool = True) -> Optional[str]:
        """Write a post-mortem bundle; returns its directory (or None
        when a non-forced dump was debounced or no out_dir is known).
        """
        base = out_dir or self.out_dir
        if base is None:
            return None
        now = time.monotonic()
        with self._lock:
            if not force and (now - self._last_dump
                              < self.min_dump_interval_s):
                return None
            self._last_dump = now
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                              for c in reason)[:60]
        stamp = time.strftime("%Y%m%d-%H%M%S")
        bundle = os.path.join(base, f"postmortem-{stamp}-{safe_reason}")
        n = 1
        while os.path.exists(bundle):
            bundle = os.path.join(
                base, f"postmortem-{stamp}-{safe_reason}.{n}")
            n += 1
        os.makedirs(bundle, exist_ok=True)
        files = []

        evs = self.events()
        with self._lock:
            open_now = [dict(ev, unclosed=True,
                             age_s=round(time.time() - ev["t"], 3))
                        for ev in self._open_spans.values()]
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=_jsonable) + "\n")
            # spans still open at dump time (the work in flight when
            # the process died) ride the same file, marked unclosed
            for ev in open_now:
                f.write(json.dumps(ev, default=_jsonable) + "\n")
        files.append("events.jsonl")

        try:
            self.tracer.export_chrome_trace(
                os.path.join(bundle, "trace.json"))
            files.append("trace.json")
        except Exception:
            logger.exception("chrome trace export failed")

        with open(os.path.join(bundle, "env.json"), "w") as f:
            json.dump(self.env_snapshot(), f, indent=2,
                      default=_jsonable)
        files.append("env.json")

        try:
            with open(os.path.join(bundle, "metrics.json"), "w") as f:
                json.dump(self.registry.snapshot(), f, indent=2,
                          default=_jsonable)
            files.append("metrics.json")
        except Exception:
            logger.exception("metrics snapshot failed")

        with self._lock:
            dropped = self.total_events - len(evs)
        with open(os.path.join(bundle, "MANIFEST.json"), "w") as f:
            json.dump({"reason": reason, "created": time.time(),
                       "files": sorted(files + ["MANIFEST.json"]),
                       "events": len(evs),
                       "unclosed_spans": len(open_now),
                       "events_total": self.total_events,
                       "events_dropped_from_ring": dropped}, f,
                      indent=2)
        self.dumps.append(bundle)
        logger.warning("flight-recorder bundle (%s): %s", reason,
                       bundle)
        return bundle


# ---------------------------------------------------------------------------
# process-wide recorder (the executors' and serving backends' crash
# hook target)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process recorder: fit-loop exceptions and
    serving worker crashes land in it automatically."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None and _GLOBAL is not recorder:
            _GLOBAL.close()
        _GLOBAL = recorder
    return recorder


def uninstall() -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None


def get_recorder() -> Optional[FlightRecorder]:
    return _GLOBAL


def on_fit_exception(model, exc: BaseException) -> None:
    """Called by the executors when any exception escapes the fit loop;
    no-op without an installed recorder, never raises."""
    rec = _GLOBAL
    if rec is None:
        return
    try:
        rec.record_registry_snapshot()
        # a rollback-flagged divergence is about to be handled by a
        # trainer: debounce those dumps; anything else is a crash
        handled = bool(getattr(exc, "rollback", False))
        rec.on_exception(
            "fit_loop", exc, force=not handled,
            model=type(model).__name__,
            iteration=getattr(model, "iteration_count", None),
            epoch=getattr(model, "epoch_count", None))
    except Exception:
        logger.exception("flight recorder failed during fit crash")


def on_backend_crash(name: str, exc: BaseException) -> None:
    """Called from a serving backend's worker sweep when its loop
    dies; no-op without an installed recorder, never raises."""
    rec = _GLOBAL
    if rec is None:
        return
    try:
        rec.record("backend_crash", backend=name, error=repr(exc))
        rec.dump(reason=f"backend_crash_{name}", force=False)
    except Exception:
        logger.exception("flight recorder failed during backend crash")
