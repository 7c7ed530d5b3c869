"""Command line (counterpart of ``deeplearning4j_tpu/cli.py``). Ported
so far: ``serve`` (``/v1/predict``, ``/v1/generate``, ``/v1/kv/*``,
``/metrics``, ``/healthz``, ``/readyz`` and ``/debug/*``;
``--aot-warmup``; a vector index behind ``/v1/embed``, ``/v1/search``
and ``/v1/index/*`` with ``--index``),
``serve-fleet`` (N in-process replicas behind the health-aware router,
with disaggregated prefill/decode roles, the autoscaler, the fleet
collector and the canary rollout; every JAX flag but ``--mesh``, a
tensor-parallel mesh a replica, queued as ROADMAP A6c), ``serve --mesh
tp=N`` (predict tensor-parallel over N rank processes: rank 0 serves,
the others follow),
``fleet-status``, ``fleet-rollout``, ``index build``, ``summary`` (a
checkpoint zip or Keras ``.h5`` through the model guesser), ``train``
(CSV training; ``--mesh dp=N,tp=M`` / ``--workers N`` data- and
tensor-parallel over the processes started with the multihost
variables, sp and pp routed as in the JAX package, ``--k-step``,
``--aot-warmup``, ``--health``, ``--async-checkpoint``), ``train-ps``
(asynchronous parameter-server training: a launcher with worker
subprocesses, or one server or worker a process) and the top-level
``--trace PATH`` and ``--flight-record DIR``.

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
    DL4J_TPU_COORDINATOR=127.0.0.1:29500 DL4J_TPU_NUM_PROCESSES=2 \
    DL4J_TPU_PROCESS_ID=0 python -m deeplearning4j_tpu_torch train \
        --model m.zip --data d.csv --label-index 4 --classes 3 \
        --mesh dp=2                      # and PROCESS_ID=1 beside it
    python -m deeplearning4j_tpu_torch train-ps --model m.zip \
        --data d.csv --label-index 4 --classes 3 --ps-workers 3
"""

from __future__ import annotations

import argparse
import os
import sys
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
    device = args.device
    leader = True
    if args.mesh:
        from deeplearning4j_tpu_torch.parallel.mesh_spec import (
            LAUNCH_RECIPE, parse_mesh_spec)
        from deeplearning4j_tpu_torch.parallel.multihost import (
            initialize_distributed, process_index, rank_device)
        try:
            plan = parse_mesh_spec(args.mesh)
        except (ValueError, TypeError) as e:
            raise SystemExit(f"serve: bad --mesh: {e}")
        if plan.sp > 1 or plan.pp > 1:
            raise SystemExit("serve: serving meshes take dp/tp axes only; "
                             "sp and pp belong to training")
        if args.index:
            raise SystemExit("serve: --index does not compose with --mesh "
                             "(the embedder/search models are not "
                             "tensor-parallel)")
        if plan.n_devices() > 1:
            if not initialize_distributed(device=device):
                raise SystemExit(f"serve: --mesh {plan} needs "
                                 f"{plan.n_devices()} processes: "
                                 f"{LAUNCH_RECIPE}")
            device = rank_device(device)
        leader = process_index() == 0
    registry = ModelRegistry()
    for spec in args.model or []:
        name, path = _parse_model_spec(spec)
        verify_checkpoint(path)
        version = registry.register(name, restore_model(path, device=device))
        print(f"registered {name} v{version} from {path} on {device}")
    if not leader:
        # a follower rank: its shards of every hosted model, then the
        # leader's forwards until it stops
        from deeplearning4j_tpu_torch.serving.tp_backend import (
            follow, host_models)
        host_models(registry, args.mesh)
        print(f"rank {process_index()}: following the mesh's rank 0",
              flush=True)
        n = follow()
        print(f"rank {process_index()}: {n} forwards; stopped")
        return
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
                         kv_pages=args.kv_pages, mesh=args.mesh,
                         retrieval=_retrieval_factory(args) if args.index
                         else None)
    if args.mesh:
        print(f"serving mesh: {server.mesh_plan} "
              f"({server.mesh_plan.n_devices()} rank(s); predict "
              f"tensor-parallel, generate refused)")
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
        raise SystemExit(
            "serve-fleet --mesh (a tensor-parallel mesh a replica) is not "
            "ported: each replica would need a rank set of its own "
            "(ROADMAP A6c; A6b ported the single-server serve --mesh)")
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


def _ps_batches(args):
    from deeplearning4j_tpu_torch.data.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    rr = CSVRecordReader().initialize(args.data)
    it = RecordReaderDataSetIterator(
        rr, args.batch_size, label_index=args.label_index,
        num_classes=args.classes, regression=args.classes == 0)
    return list(it)


def _rank_shard(it, ctx=None):
    """``it`` with each global batch cut to this rank's slice
    (``multihost.local_batch_slice``, or under a mesh its data index's
    rows, ``MeshContext.local_shard``: the ranks of one model group read
    the same rows): how a rank reads the CSV every rank holds."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
    from deeplearning4j_tpu_torch.parallel.multihost import (
        local_batch_slice)

    class RankShard(DataSetIterator):
        def reset(self):
            it.reset()

        def _iterate(self):
            for ds in it:
                arrays = (ds.features, ds.labels, ds.features_mask,
                          ds.labels_mask)
                if ctx is not None:
                    yield DataSet(*(None if a is None else
                                    ctx.local_shard(a, temporal=False)
                                    for a in arrays))
                    continue
                sl = local_batch_slice(ds.num_examples())
                yield DataSet(*(None if a is None else a[sl]
                                for a in arrays))
    return RankShard()


def _cmd_train(args):
    """Train a saved model on CSV data (the JAX ``train`` verb), on
    ``--device``. ``--mesh dp=N`` / ``--workers N`` train data-parallel
    over N ranks, one process each, launched with the multihost
    variables (``DL4J_TPU_COORDINATOR``, ``DL4J_TPU_NUM_PROCESSES``,
    ``DL4J_TPU_PROCESS_ID``): every rank reads the CSV and trains on its
    slice of each batch; only the coordinator writes the model."""
    if args.chaos:
        # the plan is JSON (inline or a file); the effective seed is
        # printed so any chaotic run can be replayed exactly
        from deeplearning4j_tpu_torch import chaos
        inj = chaos.install(args.chaos, seed=args.chaos_seed)
        print(f"chaos: fault plan installed ({len(inj.plan.faults)} "
              f"spec(s), seed {inj.seed}; replay with --chaos-seed "
              f"{inj.seed})")
    from deeplearning4j_tpu_torch.data.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.parallel.mesh_spec import (
        LAUNCH_RECIPE, PP_ROUTE, SP_ROUTE, parse_mesh_spec)
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, is_coordinator, process_count,
        process_index, rank_device)
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, ScoreIterationListener)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    workers = args.workers if args.workers and args.workers > 1 else 0
    if args.health == "rollback" and workers:
        # nothing in the ParallelWrapper path catches the rollback flag
        sys.exit("train: --health rollback is not supported with "
                 "--workers >1 (rollback needs the single-worker "
                 "ElasticTrainer loop); use --health warn/raise or "
                 "drop --workers")
    if args.k_step < 1:
        sys.exit("train: --k-step must be >= 1")
    if args.mesh and workers:
        sys.exit("train: pass either --mesh (declarative sharded "
                 "fit) or --workers (legacy data-parallel wrapper), "
                 "not both")
    if args.k_step > 1 and workers:
        sys.exit("train: --k-step >1 is not supported with "
                 "--workers >1 (the legacy wrapper steps per-batch); "
                 "use --mesh \"dp=N\" — the sharded fit path fuses "
                 "k-step windows")
    if args.aot_warmup and workers:
        sys.exit("train: --aot-warmup is not supported with "
                 "--workers >1 (warmup builds the single-worker "
                 "programs; with --mesh the warmed programs ARE the "
                 "data-parallel ones)")
    ranks = workers
    if args.mesh:
        try:
            plan = parse_mesh_spec(args.mesh)
        except (ValueError, TypeError) as e:
            sys.exit(f"train: bad --mesh: {e}")
        # sp and pp route as the JAX package's build_mesh_context does
        if plan.pp > 1:
            sys.exit(f"train: {PP_ROUTE}")
        if plan.sp > 1:
            sys.exit(f"train: {SP_ROUTE}")
        ranks = plan.n_devices()
    device = args.device
    if ranks > 1:
        if not initialize_distributed(device=device):
            sys.exit(f"train: {ranks} ranks need {ranks} processes: "
                     f"{LAUNCH_RECIPE}")
        device = rank_device(device)
    model = restore_model(args.model, device=device)
    if args.mesh:
        # installed BEFORE warmup and the trainer: the warmed programs
        # and any checkpoint restore must be the data-parallel ones
        try:
            model.use_mesh(args.mesh)
        except (ValueError, NotImplementedError) as e:
            sys.exit(f"train: {e}")
        ctx = model._mesh_ctx
        print(f"mesh: {ctx.plan} over {ctx.world} device(s); "
              f"backend {ctx.backend}; {ctx.reduce_route(model)}")
    rr = CSVRecordReader().initialize(args.data)
    it = RecordReaderDataSetIterator(
        rr, args.batch_size, label_index=args.label_index,
        num_classes=args.classes, regression=args.classes == 0)
    if process_count() > 1:
        it = _rank_shard(it, model._mesh_ctx)
    model.set_listeners(ScoreIterationListener(10),
                        PerformanceListener(frequency=10))
    if args.health:
        from deeplearning4j_tpu_torch.observability.flight_recorder import (
            get_recorder)
        from deeplearning4j_tpu_torch.observability.health import (
            HealthMonitor)
        model.add_listeners(HealthMonitor(policy=args.health,
                                          recorder=get_recorder()))
    if args.aot_warmup:
        # after the listeners (the health toggle rebuilds the programs):
        # one batch for its shape, then the iterator rewound
        ds0 = next(iter(it), None)
        if ds0 is None:
            sys.exit("train: --aot-warmup found no data to derive "
                     "the batch shape from")
        it.reset()
        rep = model.warmup(ds0, steps_per_device_call=args.k_step)
        print("aot warmup: "
              + (", ".join(f"{n} captured in {s:.2f}s"
                           for n, s in rep.items())
                 or "all programs already warm"))
    use_elastic = args.health == "rollback" or args.async_checkpoint
    ckpt_dir = (args.output or args.model) + ".ckpts"
    if workers:
        # under ElasticTrainer the trainer owns the batch loop: no
        # wrapper-level prefetch there
        wrapper_prefetch = 0 if use_elastic else args.prefetch
        if use_elastic and args.prefetch:
            print("train: --prefetch is inactive under the elastic "
                  "trainer (it owns the batch loop; checkpointable "
                  "iterator state requires consuming batches in "
                  "step order)")
        pw = (ParallelWrapper.builder(model).workers(workers)
              .prefetch_buffer(wrapper_prefetch).build())
        print(f"workers: {pw.describe()}")
        if use_elastic:
            from deeplearning4j_tpu_torch.train.fault_tolerance import (
                ElasticTrainer)
            ElasticTrainer(model, ckpt_dir, save_every=10,
                           async_checkpoint=args.async_checkpoint,
                           wrapper=pw).fit(it, epochs=args.epochs)
        else:
            pw.fit(it, epochs=args.epochs)
    elif use_elastic:
        # the rollback policy needs a checkpoint loop to roll back TO
        from deeplearning4j_tpu_torch.train.fault_tolerance import (
            ElasticTrainer)
        ElasticTrainer(model, ckpt_dir, save_every=10,
                       async_checkpoint=args.async_checkpoint,
                       steps_per_device_call=args.k_step).fit(
            it, epochs=args.epochs)
    else:
        model.fit(it, epochs=args.epochs,
                  steps_per_device_call=args.k_step)
    out = args.output or args.model
    if getattr(model, "_tp", None) is not None:
        # the zip holds the full parameters: every rank of each model
        # group joins the gather, the coordinator writes
        from deeplearning4j_tpu_torch.util.model_serializer import (
            snapshot_model, write_snapshot)
        snap = snapshot_model(model)
        if is_coordinator():
            write_snapshot(snap, out)
            print(f"trained {args.epochs} epochs; saved to {out}")
        else:
            print(f"rank {process_index()}: trained {args.epochs} epochs; "
                  f"the coordinator saves the model")
    elif is_coordinator():
        write_model(model, out)
        print(f"trained {args.epochs} epochs; saved to {out}")
    else:
        print(f"rank {process_index()}: trained {args.epochs} epochs; "
              f"the coordinator saves the model")


def _cmd_train_ps(args):
    """Async parameter-server training (the reference's Aeron
    ``VoidParameterServer`` sharing, TF-style PS architecture). The
    launcher role runs the server in-process and spawns worker
    subprocesses (each on ``--device``); the server/worker roles exist
    so soaks (and real deployments) can place each piece in its own
    killable process. The server holds its params on the host; the
    workers' gradients and codec run on ``--device``."""
    if args.chaos:
        from deeplearning4j_tpu_torch import chaos
        inj = chaos.install(args.chaos, seed=args.chaos_seed)
        print(f"chaos: fault plan installed ({len(inj.plan.faults)} "
              f"spec(s), seed {inj.seed}; replay with --chaos-seed "
              f"{inj.seed})", flush=True)
    from deeplearning4j_tpu_torch.parallel.paramserver import (
        ParameterServer, PSClient, PSWorker)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    max_staleness = None if args.max_staleness < 0 else args.max_staleness

    if args.role == "worker":
        if not args.connect:
            sys.exit("train-ps: --role worker needs --connect HOST:PORT")
        host, _, port = args.connect.rpartition(":")
        model = restore_model(args.model, device=args.device)
        batches = _ps_batches(args)
        shard = batches[args.worker_index::max(1, args.num_workers)]
        client = PSClient((host, int(port)), op_timeout_s=args.op_timeout)
        try:
            worker = PSWorker(model, client, threshold=args.push_threshold,
                              name=f"ps-worker-{args.worker_index}")
            stats = worker.run(shard, epochs=args.epochs)
        finally:
            client.close()
        print(f"train-ps worker {args.worker_index}: "
              f"{stats['steps']} steps, "
              f"{stats['pushes_applied']} pushes applied, "
              f"{stats['stale_rejects']} stale rejects, "
              f"last loss {stats['last_loss']:.4f}")
        return

    model = restore_model(args.model, device=args.device)
    ckpt_dir = args.ckpt_dir or ((args.output or args.model) + ".ps-ckpts")
    server = ParameterServer(
        model.params, lr=args.lr, max_staleness=max_staleness,
        host=args.host, port=args.ps_port, checkpoint_dir=ckpt_dir,
        save_every=args.save_every,
        heartbeat_timeout_s=args.heartbeat_timeout).start()
    print(f"train-ps: parameter server on {server.host}:{server.port} "
          f"(version {server.version}, max_staleness={max_staleness}, "
          f"ckpts in {ckpt_dir})", flush=True)

    if args.role == "server":
        # standalone (killable) server: serve until interrupted, then
        # drain; a restart against the same --ckpt-dir resumes from the
        # newest durable generation
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
            model.set_params(server.params_tree())
            if args.output:
                write_model(model, args.output)
                print(f"train-ps: saved v{server.version} to "
                      f"{args.output}")
        return

    # launcher: one worker subprocess per --ps-workers. With --net-chaos
    # the workers dial a seeded TCP fault proxy fronting the DPS1 wire
    # instead of the server directly
    import subprocess
    net_proxy = None
    connect_to = f"{server.host}:{server.port}"
    if args.net_chaos:
        from deeplearning4j_tpu_torch.chaos.netproxy import NetChaosProxy
        try:
            net_proxy = NetChaosProxy(
                (server.host, server.port), plan=args.net_chaos,
                seed=args.net_chaos_seed, site="net.ps",
                name="ps").start()
        except (ValueError, TypeError, OSError) as e:
            server.stop()
            raise SystemExit(f"bad --net-chaos plan: {e}")
        connect_to = f"{net_proxy.listen_host}:{net_proxy.port}"
        print(f"net-chaos: PS wire proxied on {connect_to} (seed "
              f"{net_proxy.seed}; replay with --net-chaos-seed "
              f"{net_proxy.seed})", flush=True)
    procs = []
    failures = 0
    try:
        for i in range(args.ps_workers):
            cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch",
                   "train-ps", "--role", "worker",
                   "--connect", connect_to,
                   "--model", args.model, "--data", args.data,
                   "--label-index", str(args.label_index),
                   "--classes", str(args.classes),
                   "--batch-size", str(args.batch_size),
                   "--epochs", str(args.epochs),
                   "--worker-index", str(i),
                   "--num-workers", str(args.ps_workers),
                   "--push-threshold", str(args.push_threshold),
                   "--op-timeout", str(args.op_timeout),
                   "--device", args.device]
            procs.append(subprocess.Popen(cmd))
        for i, pr in enumerate(procs):
            if pr.wait() != 0:
                failures += 1
                print(f"train-ps: worker {i} exited {pr.returncode}",
                      file=sys.stderr)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.terminate()
                try:
                    pr.wait(10)
                except subprocess.TimeoutExpired:
                    pr.kill()
        if net_proxy is not None:
            net_proxy.stop()
        server.stop()
    model.set_params(server.params_tree())
    out = args.output or args.model
    write_model(model, out)
    st = server.stats
    print(f"train-ps: v{server.version} "
          f"({st['pushes_applied']} pushes applied, "
          f"{st['pushes_duplicate']} duplicate, "
          f"{st['pushes_stale']} stale, "
          f"{st['workers_reaped']} reaped, "
          f"{st['restarts']} restarts); saved to {out}")
    if failures:
        sys.exit(f"train-ps: {failures} worker(s) failed")


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
    v.add_argument("--mesh", metavar="SPEC", default=None,
                   help="serve predict tensor-parallel: 'tp=N' | "
                        "'dp=M,tp=N' | JSON. Run one process a rank with "
                        "DL4J_TPU_COORDINATOR=HOST:PORT "
                        "DL4J_TPU_NUM_PROCESSES=N DL4J_TPU_PROCESS_ID=i "
                        "and the same flags: rank 0 serves HTTP, the "
                        "others follow it; generate is refused")
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
                   help="a tensor-parallel mesh a replica: not ported "
                        "(ROADMAP A6c; serve --mesh runs one); given, the "
                        "verb exits before any replica boots")
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
    t = sub.add_parser("train", help="train a saved model on CSV data")
    t.add_argument("--model", required=True)
    t.add_argument("--data", required=True)
    t.add_argument("--label-index", type=int, required=True)
    t.add_argument("--classes", type=int, default=0,
                   help="0 = regression")
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--workers", type=int, default=0,
                   help=">1 = data-parallel over that many ranks "
                        "(legacy wrapper; prefer --mesh)")
    t.add_argument("--mesh", metavar="SPEC", default=None,
                   help="data-parallel training: 'dp=N' | JSON. Run N "
                        "processes with DL4J_TPU_COORDINATOR=HOST:PORT "
                        "DL4J_TPU_NUM_PROCESSES=N DL4J_TPU_PROCESS_ID=i "
                        "(or under torchrun); each trains on its slice "
                        "of every batch, gradients all-reduced each "
                        "step (nccl with a card a rank, else gloo); "
                        "composes with --k-step and --aot-warmup. "
                        "'dp=N,tp=M' also splits the layers tensor-"
                        "parallel (N*M processes); sp and pp exit "
                        "naming ParallelWrapper and pipeline_spmd")
    t.add_argument("--prefetch", type=int, default=2)
    t.add_argument("--output", default=None)
    t.add_argument("--health", nargs="?", const="warn", default=None,
                   choices=["warn", "raise", "rollback"],
                   metavar="POLICY",
                   help="attach the training-health monitor (fused "
                        "NaN/Inf check in the train step + "
                        "divergence/plateau/gradient detectors); "
                        "POLICY = warn | raise | rollback "
                        "(default warn)")
    t.add_argument("--k-step", type=int, default=1, metavar="N",
                   help="run N train steps a program call (one CUDA "
                        "graph replay on a card); listeners and health "
                        "still see every step, checkpoints land on "
                        "N-step boundaries; an epoch tail of "
                        "n_batches %% N runs through the single-step "
                        "program")
    t.add_argument("--aot-warmup", action="store_true",
                   help="capture the train-step programs from the "
                        "first batch's shape before training: the "
                        "steady state then captures nothing for "
                        "batches of that shape")
    t.add_argument("--async-checkpoint", action="store_true",
                   help="train under ElasticTrainer with background "
                        "checkpoint writes: saves cost the train "
                        "thread a device->host snapshot only")
    t.add_argument("--chaos", metavar="PLAN", default=None,
                   help="install a deterministic fault-injection plan "
                        "for this run: inline JSON or a path to a JSON "
                        "file; fired faults count as "
                        "chaos_faults_fired_total")
    t.add_argument("--chaos-seed", type=int, default=None, metavar="N")
    t.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; a "
                        "rank takes cuda:LOCAL_RANK modulo the cards; "
                        "cpu for a machine without a card)")
    t.set_defaults(fn=_cmd_train)
    ps = sub.add_parser(
        "train-ps",
        help="asynchronous parameter-server training: compressed-"
             "delta push/pull with bounded staleness")
    ps.add_argument("--model", required=True)
    ps.add_argument("--data", required=True)
    ps.add_argument("--label-index", type=int, required=True)
    ps.add_argument("--classes", type=int, default=0,
                    help="0 = regression")
    ps.add_argument("--batch-size", type=int, default=64)
    ps.add_argument("--epochs", type=int, default=1)
    ps.add_argument("--role", choices=("launcher", "server", "worker"),
                    default="launcher",
                    help="launcher runs the server here and spawns "
                         "worker subprocesses; server/worker run one "
                         "piece each (for soaks that SIGKILL them)")
    ps.add_argument("--ps-workers", type=int, default=2,
                    help="worker subprocesses the launcher spawns")
    ps.add_argument("--connect", metavar="HOST:PORT", default=None,
                    help="(worker role) the server to join")
    ps.add_argument("--worker-index", type=int, default=0,
                    help="(worker role) this worker's shard index")
    ps.add_argument("--num-workers", type=int, default=1,
                    help="(worker role) total shard count")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--ps-port", type=int, default=0,
                    help="server listen port (0 = ephemeral)")
    ps.add_argument("--lr", type=float, default=0.05,
                    help="server-side SGD rate applied to pushed deltas")
    ps.add_argument("--max-staleness", type=int, default=-1, metavar="N",
                    help="refuse pushes based on params more than N "
                         "versions behind (-1 = unbounded async, 0 = "
                         "every push must be current)")
    ps.add_argument("--push-threshold", type=float, default=0.0,
                    help="EF sparsification threshold (entries with "
                         "|g+residual| below it wait in the residual; "
                         "the reference's ThresholdAlgorithm knob)")
    ps.add_argument("--ckpt-dir", default=None,
                    help="durable-generation directory (default "
                         "OUTPUT.ps-ckpts); a restarted server resumes "
                         "from the newest intact one")
    ps.add_argument("--save-every", type=int, default=50, metavar="N",
                    help="checkpoint every N applied pushes (async, off "
                         "the serving path)")
    ps.add_argument("--heartbeat-timeout", type=float, default=3.0,
                    metavar="S",
                    help="retire a worker silent for S seconds")
    ps.add_argument("--op-timeout", type=float, default=2.0, metavar="S",
                    help="per-op client deadline before reconnect+retry")
    ps.add_argument("--output", default=None)
    ps.add_argument("--chaos", metavar="PLAN", default=None,
                    help="deterministic fault plan (sites ps.push.drop / "
                         "ps.pull.timeout / ps.server.restart)")
    ps.add_argument("--chaos-seed", type=int, default=None, metavar="N")
    ps.add_argument("--net-chaos", metavar="PLAN", default=None,
                    help="deterministic NETWORK plan on the DPS1 wire "
                         "(launcher role): workers dial a seeded TCP "
                         "fault proxy (site net.ps) instead of the "
                         "server directly")
    ps.add_argument("--net-chaos-seed", type=int, default=None,
                    metavar="N")
    ps.add_argument("--device", default="cuda",
                    help="torch device of the model and the workers' "
                         "gradients and codec (default cuda; cpu for a "
                         "machine without a card)")
    ps.set_defaults(fn=_cmd_train_ps)
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
