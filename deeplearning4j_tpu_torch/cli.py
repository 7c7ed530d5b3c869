"""Command line (counterpart of ``deeplearning4j_tpu/cli.py``). Ported
so far: ``serve`` (``/v1/predict``, ``/v1/generate``, ``/v1/kv/*``,
``/metrics``, ``/healthz``, ``/readyz`` and ``/debug/*``;
``--aot-warmup``),
``serve-fleet`` (N in-process replicas behind the health-aware router,
with disaggregated prefill/decode roles), ``summary`` (a checkpoint zip
or Keras ``.h5`` through the model guesser) and the top-level ``--trace
PATH`` and ``--flight-record DIR``.

    python -m deeplearning4j_tpu_torch serve --model lm=lm.zip --port 8080 \
        --slots 8 --capacity 1024 --trace-sample 0.01 --slo slo.json
    python -m deeplearning4j_tpu_torch serve-fleet --model lm=lm.zip \
        --replicas 3 --roles prefill=1,decode=2 --slots 8 --capacity 1024
    python -m deeplearning4j_tpu_torch summary --model model.h5
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
    if args.aot_warmup:
        # run every hosted model's predict buckets and one generate
        # (which captures the decode step's CUDA graph) BEFORE the
        # listener takes traffic: the first real request never pays a
        # capture
        rep = server.warmup()
        for name, r in rep.items():
            print(f"aot warmup: {name} v{r['version']} — predict "
                  f"buckets {r['predict_buckets']}, generate="
                  f"{r['generate']} ({r['seconds']:.1f}s"
                  + (f"; skipped: {'; '.join(r['skipped'])}"
                     if r["skipped"] else "") + ")")
    server.start()
    # announce inside the try: a SIGINT sent as soon as the line is read
    # must drain, not kill the process
    try:
        print(f"serving on http://{args.host}:{server.port}/ (/v1/predict "
              f"/v1/generate /v1/models /healthz /readyz /metrics "
              f"/debug/requests /debug/slots /debug/traces "
              f"/debug/trace-export /debug/bundle; trace sampling "
              f"{args.trace_sample:g}; ctrl-c drains and stops)",
              flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("draining...")
        server.stop(drain=True)


# serve-fleet flags whose modules a later slice ports: given one, the verb
# exits before any replica boots
_LATER_FLEET_FLAGS = (
    ("autoscale", "--autoscale", "A4b-2"),
    ("autoscale_tick", "--autoscale-tick", "A4b-2"),
    ("queue_high", "--queue-high", "A4b-2"),
    ("queue_low", "--queue-low", "A4b-2"),
    ("slo", "--slo", "A4b-2"),
    ("collector", "--collector", "A4b-2"),
    ("collector_interval", "--collector-interval", "A4b-2"),
    ("incident_dir", "--incident-dir", "A4b-2"),
    ("rollout", "--rollout", "A4b-2"),
    ("rollout_version", "--rollout-version", "A4b-2"),
    ("rollout_canary_weight", "--rollout-canary-weight", "A4b-2"),
    ("rollout_shadow_sample", "--rollout-shadow-sample", "A4b-2"),
    ("rollout_min_requests", "--rollout-min-requests", "A4b-2"),
    ("mesh", "--mesh", "A6"))


def _cmd_serve_fleet(args):
    from deeplearning4j_tpu_torch.serving.fleet import (ReplicaFleet,
                                                        parse_roles)
    from deeplearning4j_tpu_torch.serving.router import Router
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, verify_checkpoint)
    # every input is validated before any replica boots: a bad flag must
    # exit here, not after N replicas started
    for dest, flag, item in _LATER_FLEET_FLAGS:
        if getattr(args, dest) is not None:
            raise SystemExit(
                f"serve-fleet {flag} is not ported yet (ROADMAP {item})")
    roles = None
    if args.roles:
        try:
            roles = parse_roles(args.roles, args.replicas)
        except ValueError as e:
            raise SystemExit(f"bad --roles: {e}")
    if args.net_chaos:
        from deeplearning4j_tpu_torch.chaos.netproxy import parse_net_plan
        try:
            parse_net_plan(args.net_chaos)
        except (ValueError, TypeError, OSError) as e:
            raise SystemExit(f"bad --net-chaos plan: {e}")
    specs = [_parse_model_spec(s) for s in args.model]
    for _, path in specs:
        verify_checkpoint(path)
    if args.chaos:
        from deeplearning4j_tpu_torch import chaos
        inj = chaos.install(args.chaos, seed=args.chaos_seed)
        print(f"chaos: fault plan installed ({len(inj.plan.faults)} "
              f"spec(s), seed {inj.seed}; replay with --chaos-seed "
              f"{inj.seed})")

    def factory(specs=specs):
        # called once per replica boot: each replica owns its models
        return {name: restore_model(path, device=args.device)
                for name, path in specs}

    fleet = ReplicaFleet(
        factory, n=args.replicas, roles=roles,
        net_chaos=args.net_chaos or None,
        net_chaos_seed=args.net_chaos_seed, device=args.device,
        server_kwargs=dict(max_batch_size=args.max_batch_size,
                           queue_limit=args.queue_limit,
                           wait_ms=args.wait_ms, slots=args.slots,
                           capacity=args.capacity, kv_mode=args.kv_mode,
                           page_size=args.page_size,
                           kv_pages=args.kv_pages)).start()
    if args.net_chaos:
        print(f"net-chaos: every replica fronted by a seeded TCP fault "
              f"proxy (seed {fleet._net_seed}; replay with "
              f"--net-chaos-seed {fleet._net_seed})")
    if roles:
        print("fleet roles: " + ", ".join(
            f"replica {r.id}={r.role}" for r in fleet.snapshot()))
    router = Router(
        fleet, port=args.port, host=args.host,
        probe_interval_s=args.probe_interval,
        hedge_after_s=None if args.hedge_after_ms <= 0
        else args.hedge_after_ms / 1e3,
        kv_routing=not args.no_kv_routing,
        sample_rate=args.trace_sample).start()
    try:                       # as in serve: announce inside the try
        print(f"fleet router on http://{args.host}:{router.port}/ over "
              f"{fleet.size()} replica(s) on {args.device} (/v1/predict "
              f"/v1/generate /v1/models /healthz /readyz /metrics /fleet; "
              f"ctrl-c drains the fleet and stops)", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("draining fleet...")
        router.stop()
        fleet.stop(drain=True)


def _cmd_summary(args):
    from deeplearning4j_tpu_torch.util.model_guesser import (
        guess_format, load_model_guess)
    kind = guess_format(args.model)
    print(f"format: {kind}")
    model = load_model_guess(args.model, device=args.device)
    if hasattr(model, "summary"):
        print(model.summary())


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
    v.add_argument("--aot-warmup", action="store_true",
                   help="warm every hosted model at boot, before the "
                        "listener opens (predict pow2 batch buckets up "
                        "to --max-batch-size + one generate, which "
                        "captures the decode step's CUDA graph): the "
                        "first real request never pays a capture")
    v.set_defaults(fn=_cmd_serve)

    f = sub.add_parser(
        "serve-fleet",
        help="N-replica serving fleet behind the health-aware router "
             "(failover, hedging, session affinity, zero-downtime "
             "drain, disaggregated prefill/decode)")
    f.add_argument("--model", action="append", required=True,
                   metavar="[NAME=]PATH",
                   help="model zip hosted on EVERY replica; repeatable")
    f.add_argument("--device", default="cuda",
                   help="torch device every replica serves on (default "
                        "cuda; cpu for a machine without a card)")
    f.add_argument("--replicas", type=int, default=2,
                   help="fleet size (in-process ModelServer replicas on "
                        "loopback ports)")
    f.add_argument("--host", default="127.0.0.1")
    f.add_argument("--port", type=int, default=8080,
                   help="the ROUTER's port (replicas pick free loopback "
                        "ports)")
    f.add_argument("--max-batch-size", type=int, default=32)
    f.add_argument("--queue-limit", type=int, default=256)
    f.add_argument("--wait-ms", type=float, default=2.0)
    f.add_argument("--slots", type=int, default=4)
    f.add_argument("--capacity", type=int, default=256)
    f.add_argument("--roles", metavar="SPEC", default=None,
                   help="disaggregated prefill/decode serving: "
                        "per-replica roles as 'prefill=1,decode=3' "
                        "(counts must sum to --replicas; roles are "
                        "prefill / decode / mixed). A prefill replica "
                        "runs prompts and exports KV leases "
                        "(/v1/kv/export); the router rebuilds them on a "
                        "decode replica (/v1/kv/import), which streams "
                        "the completion")
    f.add_argument("--kv-mode", choices=("auto", "paged", "dense"),
                   default="auto",
                   help="replica decode KV mode (see serve --kv-mode); "
                        "disaggregation and prefix-aware routing need "
                        "the paged path")
    f.add_argument("--page-size", type=int, default=16,
                   help="tokens per KV page on every replica")
    f.add_argument("--kv-pages", type=int, default=None,
                   help="KV pool pages per replica (default: memory "
                        "parity with the dense session)")
    f.add_argument("--no-kv-routing", action="store_true",
                   help="disable prefix-aware generate routing (affinity "
                        "+ least-loaded only)")
    f.add_argument("--probe-interval", type=float, default=1.0,
                   metavar="S", help="active health-probe period (s)")
    f.add_argument("--hedge-after-ms", type=float, default=750.0,
                   help="fire a hedged /v1/predict on a second replica "
                        "after this quiet interval; <= 0 disables "
                        "hedging")
    f.add_argument("--trace-sample", type=float, default=0.01,
                   metavar="RATE")
    f.add_argument("--chaos", metavar="PLAN", default=None,
                   help="deterministic fault plan (the serving.replica "
                        "site kills/hangs whole replicas mid-load; "
                        "serving.replica.boot fails/stalls boots; "
                        "serving.kv.migrate corrupts/slows/fails lease "
                        "hops)")
    f.add_argument("--chaos-seed", type=int, default=None, metavar="N")
    f.add_argument("--net-chaos", metavar="PLAN", default=None,
                   help="deterministic NETWORK plan: every replica boots "
                        "behind a seeded TCP fault proxy (site "
                        "net.replica; kinds partition/reset/truncate/"
                        "corrupt/delay/throttle/half_open)")
    f.add_argument("--net-chaos-seed", type=int, default=None,
                   metavar="N")
    # parsed so the JAX package's command lines are understood; each
    # exits before any replica boots (ROADMAP A4b-2, A6)
    later = f.add_argument_group(
        "not ported yet", "the autoscaler, SLO gate, collector and "
        "rollout (ROADMAP A4b-2) and the serving mesh (A6)")
    later.add_argument("--mesh", metavar="SPEC", default=None)
    later.add_argument("--autoscale", metavar="MIN:MAX", default=None)
    later.add_argument("--autoscale-tick", type=float, default=None,
                       metavar="S")
    later.add_argument("--queue-high", type=float, default=None)
    later.add_argument("--queue-low", type=float, default=None)
    later.add_argument("--slo", metavar="RULES", default=None)
    later.add_argument("--collector", type=int, default=None,
                       metavar="PORT")
    later.add_argument("--collector-interval", type=float, default=None,
                       metavar="S")
    later.add_argument("--incident-dir", default=None, metavar="DIR")
    later.add_argument("--rollout", action="append", default=None,
                       metavar="[NAME=]PATH")
    later.add_argument("--rollout-version", type=int, default=None,
                       metavar="N")
    later.add_argument("--rollout-canary-weight", type=float,
                       default=None, metavar="FRAC")
    later.add_argument("--rollout-shadow-sample", type=float,
                       default=None, metavar="FRAC")
    later.add_argument("--rollout-min-requests", type=int, default=None,
                       metavar="N")
    f.set_defaults(fn=_cmd_serve_fleet)

    s = sub.add_parser("summary", help="inspect a model file")
    s.add_argument("--model", required=True)
    s.add_argument("--device", default="cuda",
                   help="torch device to load the model on (default cuda; "
                        "cpu for a machine without a card)")
    s.set_defaults(fn=_cmd_summary)
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
