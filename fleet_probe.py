#!/usr/bin/env python3
"""Where a fleet of port replicas on one NVIDIA card loses its tokens/s.

    python3 fleet_probe.py

The diagnostics behind PERF.md's fleet findings, kept apart from
``chip_smoke.py``, which asserts the fleet's path. The full-width LM of
``chip_smoke.py`` (random weights from seed 0) serves that script's
16-request generate burst, a session each, through

1. one port server;
2. the port's Router over 3 in-process replicas (prefill=1, decode=2),
   the burst split prefill -> decode;
3. the same fleet with every replica mixed (no split; fresh ids of the
   same lengths, so no prefix cache helps);
4. the Router over 3 subprocess replicas (a process and a GIL each),
   split as in 2.

It prints each one's generated tokens/s, the in-process replicas'
decode-step host ms, the subprocess decode replicas' inter-token p50,
and the host ms of each stage the largest lease crosses between the
prefill worker and the decode worker, timed alone in one thread. Every
request must succeed, and the subprocess fleet's ids must equal the
in-process fleet's; the rest of the checks are ``chip_smoke.py``'s.
Without a CUDA device it exits 2.
"""

import base64
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
import urllib.request

import chip_smoke as smoke
from chip_smoke import (CAPACITY, FLEET_ATTEMPT_TIMEOUT_S, FLEET_PAGES,
                        FLEET_ROLES, GEN_REQUESTS, GEN_TOKENS, PAGE, SLOTS,
                        V, burst, free_ports, http, log, stats, time_steps)


def keep_largest(sess, sink):
    """Keep the largest lease ``sess`` exports in ``sink[0]``."""
    export = sess.export_lease

    def keeping(slot, extra=None):
        blob = export(slot, extra=extra)
        if not sink or len(blob) > len(sink[0]):
            sink[:] = [blob]
        return blob

    sess.export_lease = keeping


def hop_stages(blob):
    """Host ms of each stage a lease crosses between the prefill worker
    and the decode worker, one thread, nothing else running (best of
    3): what each hop costs the process's one GIL at most."""
    from deeplearning4j_tpu_torch.models.paged_kv import parse_lease
    b64 = base64.b64encode(blob).decode()
    reply = json.dumps({"blob": b64, "model_version": 1}).encode()
    body = json.dumps({"blob": b64}).encode()
    stages = {
        "base64 encode": lambda: base64.b64encode(blob).decode(),
        "reply json.dumps": lambda: json.dumps(
            {"blob": b64, "model_version": 1}).encode(),
        "router json.loads (x2)": lambda: json.loads(reply.decode()),
        "import body json.dumps": lambda: json.dumps({"blob": b64}).encode(),
        "replica json.loads": lambda: json.loads(body.decode()),
        "base64 decode": lambda: base64.b64decode(b64, validate=True),
        "parse_lease, CRC (x2)": lambda: parse_lease(blob)}
    out = {}
    for name, fn in stages.items():
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        out[name] = best * 1e3
    return out


def remote_itl_p50_ms(port):
    """The inter-token p50 (ms) of a replica in another process, from
    its ``serving_itl_seconds`` buckets (Prometheus text), interpolated
    in the bucket as the in-process histograms are."""
    from deeplearning4j_tpu_torch.observability.registry import Histogram
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/metrics?format=prometheus")
    with urllib.request.urlopen(req, timeout=60) as resp:
        text = resp.read().decode()
    cum = {}
    for line in text.splitlines():
        m = re.match(r'serving_itl_seconds_bucket\{[^}]*le="([^"]+)"[^}]*\} '
                     r'(\S+)', line)
        if m:
            le = float(m.group(1))
            cum[le] = cum.get(le, 0) + float(m.group(2))
    assert cum, f"no serving_itl_seconds buckets on port {port}"
    les = sorted(cum)
    h = Histogram("itl", buckets=[le for le in les if math.isfinite(le)])
    h.counts = [int(cum[le] - (cum[les[i - 1]] if i else 0))
                for i, le in enumerate(les)]
    h.count = int(cum[les[-1]])
    return h.quantile(0.5) * 1e3


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fleet_probe: no CUDA device; this script needs one NVIDIA "
              "card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.ops import native
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.router import Router
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    card = smoke.card_name()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.build_all()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(smoke.lm_config()),
        device="cuda").init(seed=0)
    bodies = [dict(b, session=f"burst-{i}")
              for i, b in enumerate(smoke.generate_bodies())]
    rng = np.random.default_rng(1)
    fresh = [dict(b, prompt=rng.integers(0, V, len(b["prompt"])).tolist(),
                  session=f"mixed-{i}") for i, b in enumerate(bodies)]
    tmp = tempfile.mkdtemp(prefix="fleet-probe-")
    path = os.path.join(tmp, "lm.zip")
    write_model(net, path)
    del net
    kw = dict(slots=SLOTS, capacity=CAPACITY, page_size=PAGE,
              kv_pages=FLEET_PAGES)
    warm = {"model": "lm", "prompt": [1, 2, 3], "n_tokens": 2}
    tokens = GEN_REQUESTS * GEN_TOKENS

    def factory():
        return {"lm": restore_model(path, device="cuda")}

    try:
        # 1. one server
        registry = ModelRegistry()
        registry.register("lm", factory()["lm"])
        single = ModelServer(registry, **kw).start()
        steps = []
        try:
            assert http(single.port, "/v1/generate", warm)[0] == 200
            time_steps(single.batcher_for("lm")[0].session, steps)
            _, wall = burst(single.port, "/v1/generate", bodies)
        finally:
            single.stop(drain=True)
        del registry, single
        log(f"one server ({card}): {tokens / wall:.1f} generated tokens/s "
            f"({wall:.3f} s); decode step host ms {stats(steps)} over "
            f"{len(steps)} steps")

        # 2-3. in-process replicas, split, then every replica mixed
        fleet = ReplicaFleet(factory, n=len(FLEET_ROLES), roles=FLEET_ROLES,
                             server_kwargs=kw).start()
        router = Router(fleet, hedge_after_s=None,
                        attempt_timeout_s=FLEET_ATTEMPT_TIMEOUT_S,
                        request_timeout_s=600.0).start()
        largest = []
        try:
            replicas = fleet.snapshot()
            steps = {}
            for r in replicas:
                assert http(r.port, "/v1/generate", warm)[0] == 200
                sess = r.server.batcher_for("lm")[0].session
                time_steps(sess, steps.setdefault(r.id, []))
                if r.role == "prefill":
                    keep_largest(sess, largest)
            for label, sent, roles in (
                    ("split prefill -> decode", bodies, FLEET_ROLES),
                    ("every replica mixed (no split, fresh ids)", fresh,
                     ["mixed"] * len(replicas))):
                for r, role in zip(replicas, roles):
                    r.role = role
                for sink in steps.values():
                    sink.clear()
                replies, wall = burst(router.port, "/v1/generate", sent)
                if sent is bodies:
                    split_ids = [reply["ids"] for _, reply, _ in replies]
                log(f"in-process fleet of 3, {label} ({card}): "
                    f"{tokens / wall:.1f} generated tokens/s ({wall:.3f} s); "
                    f"decode step host ms " + "; ".join(
                        f"replica {r.id} ({role}) {stats(steps[r.id])} over "
                        f"{len(steps[r.id])} steps"
                        for r, role in zip(replicas, roles) if steps[r.id]))
        finally:
            router.stop()
            fleet.stop(drain=False, timeout=30.0)
        log(f"host ms of each stage of the largest lease's hop "
            f"({len(largest[0]) / 2 ** 20:.3f} MB; one thread, nothing "
            f"else running): " + ", ".join(
                f"{k} {v:.3f}" for k, v in hop_stages(largest[0]).items()))

        # 4. subprocess replicas, split
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "")
                      .split(os.pathsep) if p])
        sub = ReplicaFleet(
            model_specs=[f"lm={path}"], n=len(FLEET_ROLES),
            roles=FLEET_ROLES, base_port=free_ports(len(FLEET_ROLES)),
            device="cuda",
            extra_args=["--slots", str(SLOTS), "--capacity", str(CAPACITY),
                        "--page-size", str(PAGE), "--kv-pages",
                        str(FLEET_PAGES)])
        sub.start()
        srouter = Router(sub, probe_interval_s=0.5, hedge_after_s=None,
                         attempt_timeout_s=FLEET_ATTEMPT_TIMEOUT_S,
                         request_timeout_s=600.0).start()
        try:
            t_end = time.monotonic() + 300
            while srouter.health_payload()["eligible"] < len(FLEET_ROLES):
                assert all(r.proc.poll() is None for r in sub.snapshot()), \
                    "a subprocess replica died"
                assert time.monotonic() < t_end, "subprocess replicas " \
                    "never up"
                time.sleep(0.2)
            children = sub.snapshot()
            for r in children:
                assert http(r.port, "/v1/generate", warm)[0] == 200
            replies, wall = burst(srouter.port, "/v1/generate", bodies)
            assert [reply["ids"] for _, reply, _ in replies] == split_ids
            itl = {r.id: remote_itl_p50_ms(r.port) for r in children
                   if r.role == "decode"}
            log(f"subprocess fleet of 3, split prefill -> decode ({card}): "
                f"{tokens / wall:.1f} generated tokens/s ({wall:.3f} s); "
                f"router_kv_handoffs_total "
                f"{srouter.registry.get('router_kv_handoffs_total').value:g}"
                f"; decode replicas' inter-token p50 ms "
                + ", ".join(f"{rid} {ms:.3f}" for rid, ms in itl.items()))
        finally:
            srouter.stop()
            sub.stop(drain=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
