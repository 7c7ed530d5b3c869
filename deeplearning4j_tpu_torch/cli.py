"""Command line (counterpart of ``deeplearning4j_tpu/cli.py``). Ported
so far: ``serve`` (``/v1/predict``, ``/v1/generate``, ``/metrics``,
``/healthz``, ``/readyz`` and ``/debug/*``) and the top-level
``--trace PATH`` and ``--flight-record DIR``.

    python -m deeplearning4j_tpu_torch serve --model lm=lm.zip --port 8080 \
        --slots 8 --capacity 1024 --trace-sample 0.01 --slo slo.json
"""

from __future__ import annotations

import argparse
import os
import time

__all__ = ["main"]


def _parse_model_spec(spec):
    """[NAME=]PATH: an existing file wins outright (a bare path may
    itself contain '='); otherwise split on the first '=' when the
    prefix looks like a name."""
    name, sep, path = spec.partition("=")
    if os.path.exists(spec) or not sep or os.sep in name or "/" in name:
        name, path = "default", spec
    return name, path


def _cmd_serve(args):
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, verify_checkpoint)
    registry = ModelRegistry()
    for spec in args.model:
        name, path = _parse_model_spec(spec)
        verify_checkpoint(path)
        version = registry.register(name, restore_model(
            path, device=args.device))
        print(f"registered {name} v{version} from {path} on {args.device}")
    metrics = ServingMetrics()
    slos = None
    if args.slo:
        # declarative SLO rules (inline JSON or a file); burn rates are
        # evaluated on /healthz, and a breach degrades health
        from deeplearning4j_tpu_torch.observability.slo import SLOMonitor
        slos = SLOMonitor.from_config(metrics.registry, args.slo)
        print(f"SLOs: {', '.join(s['name'] for s in slos.status())}")
    server = ModelServer(registry, port=args.port, host=args.host,
                         max_batch_size=args.max_batch_size,
                         queue_limit=args.queue_limit, wait_ms=args.wait_ms,
                         slots=args.slots, capacity=args.capacity,
                         metrics=metrics, sample_rate=args.trace_sample,
                         slow_ms=args.slow_ms, slos=slos,
                         kv_mode=args.kv_mode, page_size=args.page_size,
                         kv_pages=args.kv_pages)
    server.start()
    print(f"serving on http://{args.host}:{server.port}/ (/v1/predict "
          f"/v1/generate /v1/models /healthz /readyz /metrics "
          f"/debug/requests /debug/slots /debug/traces "
          f"/debug/trace-export /debug/bundle; trace sampling "
          f"{args.trace_sample:g}; ctrl-c drains and stops)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("draining...")
        server.stop(drain=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="record structured spans for this run and write "
                        "a Chrome trace-event file (open in Perfetto / "
                        "chrome://tracing) to PATH on exit")
    p.add_argument("--flight-record", metavar="DIR", default=None,
                   help="install a flight recorder: spans and worker "
                        "crashes ride a bounded ring, and a "
                        "self-contained post-mortem bundle (JSONL + "
                        "Chrome trace + env snapshot) is written under "
                        "DIR on crash or exit")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("serve", help="model-serving HTTP server (dynamic "
                                     "+ continuous batching, admission "
                                     "control)")
    v.add_argument("--model", action="append", required=True,
                   metavar="[NAME=]PATH",
                   help="model zip to host; repeatable; NAME defaults to "
                        "'default'")
    v.add_argument("--device", default="cuda",
                   help="torch device the models run on (default cuda; "
                        "cpu for a machine without a card)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8080)
    v.add_argument("--max-batch-size", type=int, default=32,
                   help="rows per coalesced predict call")
    v.add_argument("--queue-limit", type=int, default=256,
                   help="pending requests before load-shed (429)")
    v.add_argument("--wait-ms", type=float, default=2.0,
                   help="batch collection window")
    v.add_argument("--slots", type=int, default=4,
                   help="continuous-batching KV-cache slots")
    v.add_argument("--capacity", type=int, default=256,
                   help="max prompt+generated tokens per request")
    v.add_argument("--kv-mode", choices=("auto", "paged", "dense"),
                   default="auto",
                   help="decode KV cache: 'paged' = refcounted page pool + "
                        "prefix cache (slot count bounded by memory), "
                        "'dense' = per-slot capacity rows, 'auto' pages "
                        "every model that has no recurrent state")
    v.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page (paged mode)")
    v.add_argument("--kv-pages", type=int, default=None,
                   help="total pages in the pool (default: memory parity "
                        "with the dense session, "
                        "slots * ceil(capacity/page_size))")
    v.add_argument("--trace-sample", type=float, default=0.01,
                   metavar="RATE",
                   help="head-based request-trace sampling rate in [0, 1] "
                        "(default 0.01); deterministic in the trace id, "
                        "honours inbound W3C traceparent headers, errors "
                        "always sampled")
    v.add_argument("--slow-ms", type=float, default=250.0,
                   help="requests at or above this duration land in the "
                        "/debug/traces slow ring")
    v.add_argument("--slo", metavar="RULES", default=None,
                   help="declarative SLOs: inline JSON or a JSON file "
                        "(the JAX package's rule schema); multi-window "
                        "burn-rate breaches flip /healthz to degraded")
    v.set_defaults(fn=_cmd_serve)
    args = p.parse_args(argv)
    recorder = None
    if args.flight_record:
        from deeplearning4j_tpu_torch.observability.flight_recorder import (
            FlightRecorder, install)
        from deeplearning4j_tpu_torch.observability.tracing import trace
        trace.enable()     # spans must flow for trace.json to matter
        recorder = install(FlightRecorder(out_dir=args.flight_record))
    if args.trace:
        import atexit

        from deeplearning4j_tpu_torch.observability.tracing import trace
        trace.enable()

        def _dump(path=args.trace):
            n = trace.export_chrome_trace(path)
            print(f"trace written: {path} ({n} events)")

        atexit.register(_dump)
    try:
        args.fn(args)
    except Exception:
        if recorder is not None:
            recorder.dump("cli_exception", force=False)
        raise
    else:
        if recorder is not None:
            bundle = recorder.dump("exit", force=True)
            if bundle:
                print(f"flight-recorder bundle: {bundle}")
