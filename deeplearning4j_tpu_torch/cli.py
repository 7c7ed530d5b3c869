"""Command line (counterpart of ``deeplearning4j_tpu/cli.py``). Ported
so far: ``serve`` (``/v1/predict``, ``/v1/generate``, ``/v1/kv/*``,
``/metrics``, ``/healthz``, ``/readyz`` and ``/debug/*``;
``--aot-warmup``; a vector index behind ``/v1/embed``, ``/v1/search``
and ``/v1/index/*`` with ``--index``),
``serve-fleet`` (N in-process replicas behind the health-aware router,
with disaggregated prefill/decode roles, the autoscaler, the fleet
collector and the canary rollout; every JAX flag but ``--mesh``),
``fleet-status``, ``fleet-rollout``, ``index build``, ``summary`` (a
checkpoint zip or Keras ``.h5`` through the model guesser) and the
top-level ``--trace PATH`` and ``--flight-record DIR``.

    python -m deeplearning4j_tpu_torch serve --model lm=lm.zip --port 8080 \
        --slots 8 --capacity 1024 --trace-sample 0.01 --slo slo.json
    python -m deeplearning4j_tpu_torch serve --index random:n=4096,dim=64
    python -m deeplearning4j_tpu_torch serve-fleet --model lm=lm.zip \
        --replicas 3 --roles prefill=1,decode=2 --slots 8 --capacity 1024
    python -m deeplearning4j_tpu_torch serve-fleet --model lm=lm.zip \
        --autoscale 1:4 --collector 9290 --rollout lm=lm_v2.zip
    python -m deeplearning4j_tpu_torch fleet-status --collector URL
    python -m deeplearning4j_tpu_torch fleet-rollout start --router URL
    python -m deeplearning4j_tpu_torch index build --corpus random: \
        --index-kind ivf --nlist 64 --out corpus.npz
    python -m deeplearning4j_tpu_torch summary --model model.h5
"""

from __future__ import annotations

import argparse
import os
import time

__all__ = ["main"]


def _sleep_until_interrupted():
    """Block until ctrl-c. In one-second sleeps: a SIGINT the kernel
    hands to another of the process's threads only sets Python's flag,
    which the main thread reads when it next runs, so one long sleep
    could outlast it."""
    while True:
        time.sleep(1.0)


def _parse_model_spec(spec):
    """[NAME=]PATH: an existing file wins outright (a bare path may
    itself contain '='); otherwise split on the first '=' when the
    prefix looks like a name."""
    name, sep, path = spec.partition("=")
    if os.path.exists(spec) or not sep or os.sep in name or "/" in name:
        name, path = "default", spec
    return name, path


def _parse_random_corpus(spec):
    """``random:n=4096,dim=64,seed=0[,clusters=32]`` -> params dict.
    Clustered gaussian data, NOT uniform: uniform low-D gaussians are
    adversarial for IVF (every cell borders every other), clustered
    corpora are what the recall acceptance gate measures."""
    params = {"n": 4096, "dim": 64, "seed": 0, "clusters": 32}
    body = spec.split(":", 1)[1] if ":" in spec else ""
    for part in filter(None, body.split(",")):
        key, sep, val = part.partition("=")
        if not sep or key not in params:
            raise SystemExit(
                f"bad --index random spec field {part!r} (want "
                "n=,dim=,seed=,clusters=)")
        try:
            params[key] = int(val)
        except ValueError:
            raise SystemExit(f"--index random spec field {part!r} "
                             "must be an integer")
    if params["n"] < 1 or params["dim"] < 1 or params["clusters"] < 1:
        raise SystemExit("--index random spec wants positive "
                         "n/dim/clusters")
    return params


def _load_corpus(spec):
    """--index SPEC -> (ids, vectors, vocab|None, table|None).

    SPEC is either ``random:...`` (synthetic clustered corpus with a
    w{i}->row vocab so text search works out of the box) or a .npz
    with ``vectors`` (n,d) [+ ``ids``] [+ ``tokens``/``table`` for
    the embedder].
    """
    import numpy as np
    if spec.startswith("random:") or spec == "random":
        p = _parse_random_corpus(spec)
        rng = np.random.default_rng(p["seed"])
        centers = rng.normal(size=(p["clusters"], p["dim"]))
        assign = rng.integers(0, p["clusters"], size=p["n"])
        vectors = (centers[assign]
                   + 0.15 * rng.normal(size=(p["n"], p["dim"]))
                   ).astype(np.float32)
        ids = np.arange(p["n"], dtype=np.int64)
        vocab = {f"w{i}": i for i in range(p["n"])}
        return ids, vectors, vocab, vectors
    if not os.path.exists(spec):
        raise SystemExit(f"--index: no such corpus file: {spec}")
    data = np.load(spec, allow_pickle=False)
    if "vectors" not in data:
        raise SystemExit(f"--index: {spec} has no 'vectors' array "
                         f"(found {sorted(data.files)})")
    vectors = np.asarray(data["vectors"], np.float32)
    ids = (np.asarray(data["ids"], np.int64) if "ids" in data
           else np.arange(vectors.shape[0], dtype=np.int64))
    vocab = table = None
    if "tokens" in data and "table" in data:
        toks = [str(t) for t in data["tokens"]]
        vocab = {t: i for i, t in enumerate(toks)}
        table = np.asarray(data["table"], np.float32)
    return ids, vectors, vocab, table


def build_index(ids, vectors, kind, nlist=16, metric="cosine",
                device="cuda"):
    """The index ``index build`` and ``--index`` build: ``kind`` brute
    (exact) or ivf (k-means cells, trained on the whole corpus), on
    ``device``."""
    from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex,
                                                    IVFIndex)
    dim = int(vectors.shape[1])
    if kind == "ivf":
        return IVFIndex(dim, nlist=nlist, metric=metric,
                        device=device).build(ids, vectors)
    index = BruteForceIndex(dim, metric=metric, device=device)
    index.add(ids, vectors)
    return index


def _retrieval_factory(args):
    """--index/--index-kind/--nlist/--nprobe/--index-metric -> a
    ``metrics -> RetrievalService`` factory. Each call builds a FRESH
    index + embedder on ``--device``, so every replica owns its device
    arrays (and a replaced replica reloads, not shares, the corpus)."""
    spec, kind = args.index, args.index_kind
    metric, nlist = args.index_metric, args.nlist
    nprobe, device = args.nprobe, args.device

    def factory(metrics):
        from deeplearning4j_tpu_torch.retrieval import TextEmbedder
        from deeplearning4j_tpu_torch.serving.retrieval_backend import (
            RetrievalService)
        ids, vectors, vocab, table = _load_corpus(spec)
        index = build_index(ids, vectors, kind, nlist=nlist,
                            metric=metric, device=device)
        embedder = None
        if vocab is not None and table is not None:
            embedder = TextEmbedder(vocab, table, device=device)
        svc = RetrievalService(
            index, embedder=embedder,
            max_batch_size=args.max_batch_size,
            queue_limit=args.queue_limit, wait_ms=args.wait_ms,
            default_nprobe=nprobe)
        return svc.attach_metrics(metrics)

    return factory


def _add_index_flags(p):
    """The retrieval knobs serve and serve-fleet share."""
    p.add_argument("--index", metavar="SPEC", default=None,
                   help="host a vector index: 'random:n=4096,dim=64,"
                        "seed=0,clusters=32' or an .npz with "
                        "vectors[+ids][+tokens/table for /v1/embed] "
                        "(enables /v1/embed /v1/search /v1/index/*)")
    p.add_argument("--index-kind", choices=("brute", "ivf"),
                   default="brute",
                   help="brute = exact matmul top-k; ivf = coarse-"
                        "quantized cells, recall traded for latency "
                        "via nprobe")
    p.add_argument("--nlist", type=int, default=16,
                   help="IVF cell count (k-means centroids)")
    p.add_argument("--nprobe", type=int, default=None,
                   help="server default IVF cells probed per query "
                        "(requests may override per call)")
    p.add_argument("--index-metric",
                   choices=("cosine", "dot", "euclidean"),
                   default="cosine", help="similarity metric")


def _add_index_flags(p):
    """The retrieval knobs serve and serve-fleet share."""
    p.add_argument("--index", metavar="SPEC", default=None,
                   help="host a vector index: 'random:n=4096,dim=64,"
                        "seed=0,clusters=32' or an .npz with "
                        "vectors[+ids][+tokens/table for /v1/embed] "
                        "(enables /v1/embed /v1/search /v1/index/*)")
    p.add_argument("--index-kind", choices=("brute", "ivf"),
                   default="brute",
                   help="brute = exact matmul top-k; ivf = coarse-"
                        "quantized cells, recall traded for latency "
                        "via nprobe")
    p.add_argument("--nlist", type=int, default=16,
                   help="IVF cell count (k-means centroids)")
    p.add_argument("--nprobe", type=int, default=None,
                   help="server default IVF cells probed per query "
                        "(requests may override per call)")
    p.add_argument("--index-metric",
                   choices=("cosine", "dot", "euclidean"),
                   default="cosine", help="similarity metric")


def _cmd_serve(args):
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, verify_checkpoint)
    if not args.model and not args.index:
        raise SystemExit("serve needs --model and/or --index")
    registry = ModelRegistry()
    for spec in args.model or []:
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
                         kv_pages=args.kv_pages,
                         retrieval=_retrieval_factory(args) if args.index
                         else None)
    if args.index:
        st = server.retrieval.stats()["index"]
        print(f"index: {st['kind']}/{st['metric']} on {args.device}: "
              f"{st['vectors']} vector(s), dim {st['dim']}"
              + (f", nlist {st['nlist']}" if "nlist" in st else "")
              + ("; embedder attached (/v1/embed, text /v1/search)"
                 if server.retrieval.embedder is not None else ""))
    if args.aot_warmup:
        # run every hosted model's predict buckets and one generate
        # (which captures the decode step's CUDA graph) BEFORE the
        # listener takes traffic: the first real request never pays a
        # capture
        rep = server.warmup()
        search = rep.pop("_search", None)
        if search is not None:
            print(f"aot warmup: search buckets {search['buckets']}")
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
              f"/v1/generate "
              + ("/v1/embed /v1/search /v1/index/* " if args.index else "")
              + f"/v1/models /healthz /readyz /metrics "
              f"/debug/requests /debug/slots /debug/traces "
              f"/debug/trace-export /debug/bundle; trace sampling "
              f"{args.trace_sample:g}; ctrl-c drains and stops)",
              flush=True)
        _sleep_until_interrupted()
    except KeyboardInterrupt:
        print("draining...")
        server.stop(drain=True)


def _validate_fleet_args(args):
    """Every input of serve-fleet is checked before any replica boots:
    a typo'd bound, watermark band, SLO rule, rollout or chaos plan
    exits here, not after N replicas started (and leaked). Returns the
    autoscaler's (min, max) bounds or None."""
    if args.mesh is not None:
        raise SystemExit("serve-fleet --mesh is not ported yet "
                         "(ROADMAP A6)")
    bounds = None
    if args.autoscale:
        try:
            lo, _, hi = args.autoscale.partition(":")
            bounds = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(
                f"--autoscale wants MIN:MAX, got {args.autoscale!r}")
        if bounds[0] < 1 or bounds[1] < bounds[0]:
            raise SystemExit(
                f"--autoscale bounds must satisfy 1 <= MIN <= MAX, "
                f"got {args.autoscale!r}")
        if not args.queue_low < args.queue_high:
            raise SystemExit(
                f"--queue-low ({args.queue_low:g}) must sit below "
                f"--queue-high ({args.queue_high:g}): the band "
                "between them is the anti-flap dead zone")
    if args.slo:
        # --slo stands on its own (burn rates + slo_breach on the
        # router's /metrics, autoscaler or not); this pass only
        # validates the rules on a throwaway registry
        from deeplearning4j_tpu_torch.observability.registry import (
            MetricsRegistry)
        from deeplearning4j_tpu_torch.observability.slo import SLOMonitor
        try:
            SLOMonitor.from_config(MetricsRegistry(), args.slo)
        except Exception as e:
            raise SystemExit(f"bad --slo rules: {e}")
    if args.net_chaos:
        from deeplearning4j_tpu_torch.chaos.netproxy import parse_net_plan
        try:
            parse_net_plan(args.net_chaos)
        except (ValueError, TypeError, OSError) as e:
            raise SystemExit(f"bad --net-chaos plan: {e}")
    if not args.model and not args.index:
        raise SystemExit("serve-fleet needs --model and/or --index")
    if args.rollout:
        # an unpromotable rollout (no collector = no gate evidence =
        # holds forever) must exit before replicas boot
        if args.collector is None:
            raise SystemExit(
                "--rollout needs --collector: the promotion gate reads "
                "the merged replica-labeled series, and without them "
                "the rollout would hold forever")
        if not args.model:
            raise SystemExit(
                "--rollout replaces --model served in-process; an "
                "--index-only fleet has no model versions to roll")
        if not 0.0 < args.rollout_canary_weight <= 1.0:
            raise SystemExit(
                f"--rollout-canary-weight must be in (0, 1], got "
                f"{args.rollout_canary_weight:g}")
        if not 0.0 <= args.rollout_shadow_sample <= 1.0:
            raise SystemExit(
                f"--rollout-shadow-sample must be in [0, 1], got "
                f"{args.rollout_shadow_sample:g}")
    return bounds


def _cmd_serve_fleet(args):
    from deeplearning4j_tpu_torch.serving.fleet import (ReplicaFleet,
                                                        parse_roles)
    from deeplearning4j_tpu_torch.serving.router import Router
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, verify_checkpoint)
    bounds = _validate_fleet_args(args)
    roles = None
    if args.roles:
        try:
            roles = parse_roles(args.roles, args.replicas)
        except ValueError as e:
            raise SystemExit(f"bad --roles: {e}")
    specs = [_parse_model_spec(s) for s in args.model or []]
    rollout_specs = [_parse_model_spec(s) for s in args.rollout or []]
    for _, path in specs + rollout_specs:
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
                           kv_pages=args.kv_pages,
                           retrieval=_retrieval_factory(args)
                           if args.index else None)).start()
    if args.net_chaos:
        print(f"net-chaos: every replica fronted by a seeded TCP fault "
              f"proxy (seed {fleet._net_seed}; replay with "
              f"--net-chaos-seed {fleet._net_seed})")
    if args.index:
        print(f"index: {args.index_kind} over --index {args.index} "
              f"(one copy per replica on {args.device}; /v1/search fails "
              f"over, /v1/index/* fans out to every replica)")
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
    slos = None
    if args.slo:
        from deeplearning4j_tpu_torch.observability.slo import SLOMonitor
        # objectives over the ROUTER's own latency family: the burn
        # rate measures what clients experienced through failover and
        # hedging
        slos = SLOMonitor.from_config(router.registry, args.slo)
        print(f"slo: {len(slos.status())} objective(s) over the router "
              "registry (slo_breach on /metrics)")
    collector = None
    if args.collector is not None:
        from deeplearning4j_tpu_torch.observability.fleetobs import (
            FleetCollector)
        fleet_slos = ()
        if args.slo:
            # the SAME rules judged a second time over the MERGED
            # series: the router's monitor sees one process, the
            # collector's copy the whole fleet
            from deeplearning4j_tpu_torch.observability.registry import (
                MetricsRegistry)
            from deeplearning4j_tpu_torch.observability.slo import (
                SLOMonitor)
            fleet_slos = tuple(SLOMonitor.from_config(
                MetricsRegistry(), args.slo)._slos.values())
        collector = FleetCollector(
            fleet=fleet, router=router,
            interval_s=args.collector_interval, port=args.collector,
            slos=fleet_slos, incident_dir=args.incident_dir).start()
        router.attach_fleet_health(collector.fleet_health)
        print(f"fleet collector on http://127.0.0.1:{collector.port}/ "
              f"scraping every {args.collector_interval:g}s (/metrics "
              f"/fleet/snapshot /traces /healthz; incidents under "
              f"{collector.incident_dir})")
    scaler = None
    if bounds is not None:
        from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
        lo, hi = bounds
        scaler = Autoscaler(
            fleet, router, slos=slos, min_replicas=lo, max_replicas=hi,
            tick_interval_s=args.autoscale_tick,
            queue_high=args.queue_high, queue_low=args.queue_low,
            collector=collector).start()
        print(f"autoscaler: bounds {lo}..{hi}, tick "
              f"{args.autoscale_tick:g}s, queue watermarks "
              f"{args.queue_low:g}/{args.queue_high:g}"
              + (f", {len(slos.status())} SLO(s)" if slos else "")
              + (", merged signals via collector"
                 if collector is not None else ""))
    rollout = None
    if args.rollout:
        from deeplearning4j_tpu_torch.serving.rollout import (
            RolloutController)

        def candidate_factory(specs=rollout_specs):
            return {name: restore_model(path, device=args.device)
                    for name, path in specs}

        rollout = RolloutController(
            fleet, router, candidate_factory=candidate_factory,
            candidate_version=args.rollout_version,
            collector=collector, autoscaler=scaler,
            canary_weight=args.rollout_canary_weight,
            shadow_sample=args.rollout_shadow_sample,
            min_requests=args.rollout_min_requests)
        router.attach_rollout(rollout)
        print(f"rollout: candidate staged "
              f"({', '.join(n for n, _ in rollout_specs)}), armed, not "
              f"deploying; trigger with 'fleet-rollout start --router "
              f"http://{args.host}:{router.port}' (canary weight "
              f"{args.rollout_canary_weight:g}, shadow sample "
              f"{args.rollout_shadow_sample:g}, min "
              f"{args.rollout_min_requests} gated requests)")
    try:                       # as in serve: announce inside the try
        print(f"fleet router on http://{args.host}:{router.port}/ over "
              f"{fleet.size()} replica(s) on {args.device} (/v1/predict "
              f"/v1/generate /v1/models /healthz /readyz /metrics /fleet; "
              f"ctrl-c drains the fleet and stops)", flush=True)
        _sleep_until_interrupted()
    except KeyboardInterrupt:
        print("draining fleet...")
        if rollout is not None:
            try:
                rollout.abort("serve-fleet shutdown")
            except ValueError:
                pass        # no rollout in flight
            rollout.join(timeout=30.0)
        if scaler is not None:
            scaler.stop(wait_retires=False)
        if collector is not None:
            collector.stop()
        router.stop()
        fleet.stop(drain=True)


def _cmd_fleet_status(args):
    """Render a running collector's /fleet/snapshot as the text
    dashboard — once, or forever under --watch."""
    import json as _json
    import urllib.request

    from deeplearning4j_tpu_torch.observability.fleetobs import (
        render_status)

    base = args.collector.rstrip("/")

    def fetch():
        with urllib.request.urlopen(base + "/fleet/snapshot",
                                    timeout=5.0) as resp:
            return _json.loads(resp.read().decode("utf-8"))

    if args.watch is None:
        print(render_status(fetch()))
        return
    try:
        while True:
            try:
                text = render_status(fetch())
            except (OSError, ValueError) as exc:
                text = f"collector unreachable at {base}: {exc}"
            # clear-screen escape keeps the dashboard in place like
            # watch(1) without depending on curses
            print("\x1b[2J\x1b[H" + text, flush=True)
            time.sleep(max(0.2, args.watch))
    except KeyboardInterrupt:
        pass


def _render_rollout(st):
    lines = [
        f"state    : {st.get('state')}"
        + (f" ({st.get('outcome')})" if st.get("outcome") else ""),
        f"versions : v{st.get('incumbent_version')} -> "
        f"v{st.get('candidate_version')}",
        f"progress : {st.get('updated')}/{st.get('total')} "
        f"replica(s) updated (canary rid "
        f"{st.get('canary_rid')})",
        f"gate     : verdict={st.get('last_verdict')} "
        f"holds={st.get('holds')}"
        + (f" gate={st.get('last_gate')}"
           if st.get("last_gate") else ""),
    ]
    if st.get("last_detail"):
        lines.append(f"detail   : {st['last_detail']}")
    if st.get("incident_dir"):
        lines.append(f"incident : {st['incident_dir']}")
    return "\n".join(lines)


def _cmd_fleet_rollout(args):
    """Operator verbs over the router's /v1/rollout/* endpoints."""
    import json as _json
    import urllib.error
    import urllib.request

    base = args.router.rstrip("/")

    def call(method, path, body=None):
        data = _json.dumps(body).encode() \
            if body is not None else None
        req = urllib.request.Request(
            base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10.0) as resp:
                return resp.status, _json.loads(
                    resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return e.code, _json.loads(
                    e.read().decode("utf-8"))
            except ValueError:
                return e.code, {"error": str(e)}
        except OSError as e:
            raise SystemExit(
                f"router unreachable at {base}: {e}")

    if args.verb == "start":
        status, body = call("POST", "/v1/rollout/start", {})
        if status != 200:
            raise SystemExit(
                f"start refused ({status}): "
                f"{body.get('error', body)}")
        print(_render_rollout(body))
        return
    if args.verb == "abort":
        status, body = call("POST", "/v1/rollout/abort",
                            {"reason": args.reason})
        if status != 200:
            raise SystemExit(
                f"abort refused ({status}): "
                f"{body.get('error', body)}")
        print(_render_rollout(body))
        return
    # status
    if args.watch is None:
        status, body = call("GET", "/v1/rollout/status")
        if status != 200:
            raise SystemExit(
                f"no rollout controller ({status}): "
                f"{body.get('error', body)}")
        print(_render_rollout(body))
        return
    try:
        while True:
            status, body = call("GET", "/v1/rollout/status")
            text = _render_rollout(body) if status == 200 \
                else f"no rollout controller ({status})"
            print("\x1b[2J\x1b[H" + text, flush=True)
            # outcome only lands at a terminal state (promoted /
            # rolled_back) — stop watching there
            if status == 200 and body.get("outcome") \
                    and body.get("state") not in (
                        "canary", "expanding", "rolling_back"):
                return
            time.sleep(max(0.2, args.watch))
    except KeyboardInterrupt:
        pass


def _cmd_index_build(args):
    """The offline index workload: load or synthesize a corpus, build
    the index on ``--device``, report stats (+ IVF recall vs exact),
    and optionally write the .npz corpus serve --index consumes."""
    import numpy as np
    ids, vectors, vocab, table = _load_corpus(args.corpus)
    t0 = time.perf_counter()
    index = build_index(ids, vectors, args.index_kind, nlist=args.nlist,
                        metric=args.index_metric, device=args.device)
    built_s = time.perf_counter() - t0
    st = index.stats()
    extra = (f", {st['cells']['count']} populated cell(s) of nlist "
             f"{st['nlist']} (largest {st['cells']['max_size']})"
             if "nlist" in st else "")
    print(f"built {st['kind']}/{st['metric']} on {args.device}: "
          f"{st['vectors']} vector(s), dim {st['dim']}{extra} in "
          f"{built_s:.2f}s")
    if args.report_recall and hasattr(index, "estimate_recall"):
        k = args.report_recall
        probes = sorted({max(1, min(n, args.nlist))
                         for n in (1, 4, 16, args.nlist)})
        for npb in probes:
            t0 = time.perf_counter()
            r = index.estimate_recall(k=k, sample=64, nprobe=npb)
            dt = time.perf_counter() - t0
            if r is None:
                continue
            print(f"recall@{k} nprobe={npb}: {r:.3f} "
                  f"(64-query probe, {dt:.2f}s)")
    elif args.report_recall:
        print(f"recall@{args.report_recall}: 1.000 (brute force is "
              "the exact oracle)")
    if args.out:
        payload = {"ids": np.asarray(ids), "vectors": vectors}
        if vocab is not None and table is not None:
            payload["tokens"] = np.array(sorted(vocab, key=vocab.get))
            payload["table"] = table
        np.savez_compressed(args.out, **payload)
        print(f"wrote {args.out}: {vectors.shape[0]} vector(s)"
              + (", embedder vocab+table included"
                 if vocab is not None else "")
              + ": load it with serve --index")


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
    v.add_argument("--model", action="append", required=False,
                   metavar="[NAME=]PATH",
                   help="model zip to host; repeatable; NAME defaults to "
                        "'default' (--model and/or --index)")
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
    _add_index_flags(v)
    v.set_defaults(fn=_cmd_serve)

    f = sub.add_parser(
        "serve-fleet",
        help="N-replica serving fleet behind the health-aware router "
             "(failover, hedging, session affinity, zero-downtime "
             "drain, disaggregated prefill/decode)")
    f.add_argument("--model", action="append", required=False,
                   metavar="[NAME=]PATH",
                   help="model zip hosted on EVERY replica; repeatable "
                        "(--model and/or --index)")
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
    f.add_argument("--mesh", metavar="SPEC", default=None,
                   help="serving mesh: not ported yet (ROADMAP A6); "
                        "given, the verb exits before any replica boots")
    f.add_argument("--autoscale", metavar="MIN:MAX", default=None,
                   help="run the SLO-driven autoscaler over the "
                        "fleet: replica count moves inside "
                        "[MIN, MAX] from SLO burn rate + queue "
                        "depth + KV pressure (boot-first scale-up, "
                        "drain-based scale-down of the replica "
                        "with the fewest pinned streams)")
    f.add_argument("--autoscale-tick", type=float, default=1.0,
                   metavar="S",
                   help="autoscaler control-loop period (seconds)")
    f.add_argument("--queue-high", type=float, default=8.0,
                   help="mean OUTSTANDING work per replica (probed "
                        "backend queue depth + router in-flight — "
                        "a queued request appears in both) above "
                        "which the autoscaler votes scale-up")
    f.add_argument("--queue-low", type=float, default=1.0,
                   help="mean outstanding work per replica below "
                        "which the autoscaler votes scale-down")
    f.add_argument("--slo", metavar="RULES", default=None,
                   help="declarative SLOs evaluated over the "
                        "ROUTER's latency/availability metrics "
                        "(inline JSON or @file; see README "
                        "'Request tracing & SLOs'); burn-rate "
                        "breaches are the autoscaler's primary "
                        "scale-up trigger. Use metric "
                        "'router_latency_seconds' with labels "
                        "{'route': '/v1/predict'} for latency "
                        "objectives at the router")
    f.add_argument("--collector", type=int, default=None,
                   metavar="PORT",
                   help="run the fleet observability collector on "
                        "this port (0 picks a free one): scrapes "
                        "every member's /metrics each interval, "
                        "re-exposes the merged fleet registry, "
                        "stitches cross-process traces, and writes "
                        "incident bundles on fleet-SLO breach or "
                        "replica death. Read it with 'fleet-status "
                        "--collector URL'")
    f.add_argument("--collector-interval", type=float, default=1.0,
                   metavar="S",
                   help="collector scrape period (seconds)")
    f.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="where the collector writes incident-scoped "
                        "fleet bundles (default: cwd)")
    f.add_argument("--rollout", action="append", default=None,
                   metavar="[NAME=]PATH",
                   help="stage a CANDIDATE model zip for an SLO-"
                        "gated canary rollout (repeatable, same "
                        "spec format as --model). The controller "
                        "arms but does NOT deploy: trigger it with "
                        "'fleet-rollout start'. Requires "
                        "--collector — promotion needs the merged "
                        "replica-labeled series as gate evidence")
    f.add_argument("--rollout-version", type=int, default=None,
                   metavar="N",
                   help="candidate model version (default: "
                        "incumbent + 1)")
    f.add_argument("--rollout-canary-weight", type=float,
                   default=0.25, metavar="FRAC",
                   help="deterministic traffic share hashed to the "
                        "canary during the gate window (trace-id-"
                        "sticky: a request's retries and hedges "
                        "stay on-version)")
    f.add_argument("--rollout-shadow-sample", type=float,
                   default=0.5, metavar="FRAC",
                   help="mirror this fraction of predict traffic "
                        "to the canary and score its answers "
                        "against the primary's (never returned to "
                        "clients); 0 disables shadow scoring")
    f.add_argument("--rollout-min-requests", type=int, default=50,
                   metavar="N",
                   help="minimum candidate-cohort requests inside "
                        "the gate window before the comparative "
                        "SLO gate may pass (below it the rollout "
                        "HOLDS — no wall-clock-only promotion)")
    _add_index_flags(f)
    f.set_defaults(fn=_cmd_serve_fleet)

    fs = sub.add_parser(
        "fleet-status",
        help="one-shot (or --watch) dashboard over a running fleet "
             "collector's /fleet/snapshot")
    fs.add_argument("--collector", default="http://127.0.0.1:9290",
                    metavar="URL",
                    help="base URL of the collector started by "
                         "serve-fleet --collector")
    fs.add_argument("--watch", type=float, default=None, metavar="S",
                    help="refresh every S seconds until ctrl-c "
                         "instead of printing once")
    fs.set_defaults(fn=_cmd_fleet_status)

    fr = sub.add_parser(
        "fleet-rollout",
        help="drive the canary rollout armed by serve-fleet "
             "--rollout: start it, watch its gate verdicts, or "
             "abort into an automatic rollback")
    fr.add_argument("verb", choices=("start", "status", "abort"),
                    help="start = begin the canary deployment; "
                         "status = one-shot (or --watch) state/"
                         "gate dump; abort = roll every updated "
                         "replica back to the incumbent")
    fr.add_argument("--router", default="http://127.0.0.1:8080",
                    metavar="URL",
                    help="base URL of the fleet router (the "
                         "controller answers on /v1/rollout/*)")
    fr.add_argument("--reason", default="operator abort",
                    help="abort reason recorded in the incident "
                         "bundle (abort only)")
    fr.add_argument("--watch", type=float, default=None, metavar="S",
                    help="with 'status': refresh every S seconds "
                         "until ctrl-c or the rollout reaches a "
                         "terminal state")
    fr.set_defaults(fn=_cmd_fleet_rollout)

    ix = sub.add_parser(
        "index",
        help="vector-index workloads (build / recall report)")
    ixsub = ix.add_subparsers(dest="index_cmd", required=True)
    ib = ixsub.add_parser(
        "build",
        help="build an index from a corpus, report recall, write "
             "the .npz serve --index loads")
    ib.add_argument("--corpus", required=True, metavar="SPEC",
                    help="'random:n=4096,dim=64,seed=0,clusters=32' "
                         "or an existing .npz with vectors[+ids]"
                         "[+tokens/table]")
    ib.add_argument("--out", default=None, metavar="FILE",
                    help="write the corpus as .npz (ids, vectors "
                         "[, tokens, table]) for serve --index")
    ib.add_argument("--index-kind", choices=("brute", "ivf"),
                    default="ivf")
    ib.add_argument("--nlist", type=int, default=16,
                    help="IVF cell count")
    ib.add_argument("--index-metric",
                    choices=("cosine", "dot", "euclidean"),
                    default="cosine")
    ib.add_argument("--device", default="cuda",
                    help="torch device the index is built on (default "
                         "cuda; cpu for a machine without a card)")
    ib.add_argument("--report-recall", type=int, default=10,
                    metavar="K",
                    help="estimate recall@K vs the exact answer "
                         "over a seeded 64-query probe (0 skips)")
    ib.set_defaults(fn=_cmd_index_build)

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
