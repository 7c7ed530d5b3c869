"""The ``/debug/bundle`` payload of one server (counterpart of
``local_bundle_payload`` in ``deeplearning4j_tpu/observability/
fleetobs.py``). The fleet collector, exposition parsing and histogram
merging around it wait for ROADMAP A4b-2.
"""

from __future__ import annotations

import os
import socket
import sys
import time
from typing import Any, Dict

__all__ = ["local_bundle_payload"]


def local_bundle_payload(registry=None, tracer=None,
                         reason: str = "incident",
                         max_spans: int = 2000) -> dict:
    """The JSON form of a flight-recorder bundle, built in-process so
    a collector can pull it over HTTP instead of reading the member's
    filesystem: ``{"reason", "files": {name: content}}`` where
    ``events.jsonl`` content is a list of event dicts and everything
    else is a JSON object. Works with or without an installed
    :class:`FlightRecorder`: a server that never installed one still
    contributes metrics + traces + env."""
    files: Dict[str, Any] = {}
    files["env.json"] = {
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
        "ts_unix": time.time(),
    }
    if registry is not None:
        try:
            files["metrics.json"] = registry.snapshot()
        except Exception:
            files["metrics.json"] = {"error": "snapshot failed"}
    if tracer is not None:
        try:
            evs = tracer.events()[-max_spans:]
            files["trace.json"] = {"events": evs,
                                   "dropped": tracer.dropped,
                                   "origin_unix":
                                       getattr(tracer, "_origin_unix",
                                               0.0)}
        except Exception:
            pass
    try:
        from deeplearning4j_tpu_torch.observability import flight_recorder
        rec = flight_recorder.get_recorder()
        if rec is not None:
            files["events.jsonl"] = rec.events()
            files["recorder_env.json"] = rec.env_snapshot()
    except Exception:
        pass
    files["MANIFEST.json"] = {
        "reason": reason,
        "pid": os.getpid(),
        "ts_unix": time.time(),
        "files": sorted(k for k in files),
    }
    return {"reason": reason, "files": files}
