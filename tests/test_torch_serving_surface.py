"""The serving surface of one server, the port against the JAX package
(the slice's parity test), on the CPU.

A JAX ``ModelServer`` and a port ``ModelServer`` boot on the same zip
(a 2-layer causal LM, D=32, H=2, V=64, written by the JAX package) with
``sample_rate=1.0`` and get the same request sequence: 3 predicts, 3
greedy generates (the third repeats the first prompt, a prefix hit),
gold and best_effort tiers, one inbound sampled ``traceparent``, one
unknown model (404) and one bad body (400). Their ``/metrics`` must
then agree: the same metric names and labels, equal counter and gauge
values, equal histogram counts (latency values differ by nature and are
not compared), with only :data:`ONLY_JAX` differing. Both must answer
``/readyz`` 200, echo the inbound trace id, and resolve an OpenMetrics
exemplar in ``/debug/trace-export``; under a ``serving.worker.step``
crash plan both must open the breaker (503 ``CircuitOpenError`` with
``Retry-After``, ``/healthz`` degraded with ``circuits``, ``/readyz``
503) and close it on the half-open probe, after which greedy ids equal
the reference. Ids are compared exactly; predict outputs (float32 on
both sides) to atol=2e-5, rtol=2e-4.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu import chaos as jchaos
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.observability.tracing import Tracer as JaxTracer
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos as tchaos
from deeplearning4j_tpu_torch.observability.tracing import Tracer
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, CAP, PS = 64, 32, 4

# Metrics only one server exports: none, since the port has the
# KV-stream counters too. Nothing may differ.
ONLY_JAX = set()
ONLY_PORT = set()

INBOUND = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
PROMPTS = ([5, 9, 14, 3, 22, 7, 1, 30, 11], [2, 8, 40], None)


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    b = (NeuralNetConfiguration.builder().set_seed(3).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=32)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=2, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    path = str(tmp_path_factory.mktemp("surface") / "lm.zip")
    jser.write_model(JaxNet(conf).init(), path)
    return path


def _servers(path):
    kw = dict(sample_rate=1.0, slots=2, capacity=CAP, page_size=PS,
              wait_ms=5.0)
    jr = JaxRegistry()
    jr.register("lm", jser.restore_model(path))
    tr = ModelRegistry()
    tr.register("lm", restore_model(path, device="cpu"))
    return (JaxServer(jr, tracer=JaxTracer(), **kw).start(),
            ModelServer(tr, tracer=Tracer(), **kw).start())


def _call(port, path, body=None, raw=None, headers=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _sequence(port):
    """The request sequence; returns (status, body, headers) each."""
    rng = np.random.default_rng(0)
    out = []
    for tier, hdrs in (("gold", {"traceparent": INBOUND}),
                       ("best_effort", None), (None, None)):
        body = {"model": "lm",
                "inputs": rng.integers(0, V, (1, 8)).astype(
                    float).tolist()}
        if tier:
            body["tier"] = tier
        out.append(_call(port, "/v1/predict", body, headers=hdrs))
    for prompt, tier in zip(PROMPTS, ("gold", None, "best_effort")):
        out.append(_call(port, "/v1/generate", {
            "model": "lm", "prompt": prompt or PROMPTS[0],
            "n_tokens": 5, "tier": tier}))
    out.append(_call(port, "/v1/predict", {"model": "nope",
                                           "inputs": [[1.0]]}))
    out.append(_call(port, "/v1/predict", raw=b"{not json"))
    return out


def _flat(text):
    """Prometheus text -> {name{labels}: value}, comments dropped."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


@pytest.fixture(scope="module")
def served(zip_path):
    """Both servers after the same request sequence, with what each
    answered and exported."""
    servers = _servers(zip_path)
    runs = []
    for s in servers:
        replies = _sequence(s.port)
        runs.append({
            "server": s, "replies": replies,
            "json": json.loads(_call(s.port, "/metrics")[1]),
            "text": _call(s.port, "/metrics?format=prometheus")[1],
            "om": _call(s.port, "/metrics",
                        headers={"Accept": "application/openmetrics-text"}
                        )[1]})
    yield runs
    for s in servers:
        s.stop()


def test_replies_match_jax(served):
    (j, t) = [[(c, json.loads(b)) for c, b, _ in r["replies"]]
              for r in served]
    assert [c for c, _ in t] == [c for c, _ in j] == \
        [200] * 6 + [404, 400]
    for (_, jb), (_, tb) in zip(j[3:6], t[3:6]):
        assert tb == jb                     # greedy ids, model_version
    for (_, jb), (_, tb) in zip(j[:3], t[:3]):
        np.testing.assert_allclose(np.asarray(tb["outputs"]),
                                   np.asarray(jb["outputs"]),
                                   atol=2e-5, rtol=2e-4)
    # a typed error body carries the trace id on both; a body that does
    # not parse fails before a trace context exists
    for side in (j, t):
        assert re.fullmatch(r"[0-9a-f]{32}", side[6][1]["trace_id"])
        assert "trace_id" not in side[7][1]


def test_metrics_names_labels_counts_match_jax(served):
    jf, tf = (_flat(r["text"]) for r in served)
    assert set(jf) - set(tf) == ONLY_JAX
    assert set(tf) - set(jf) == ONLY_PORT
    for key in sorted(set(jf) & set(tf)):
        # every counter and gauge value, and every histogram's count;
        # bucket fills and sums are latencies
        if "_bucket{" in key or re.match(r"\w+_sum\b", key):
            continue
        assert tf[key] == jf[key], key
    ep = 'endpoint="generate/lm/v1"'
    assert tf[f'prefix_cache_hits_total{{{ep}}}'] == 1
    assert tf[f'serving_ttft_seconds_count{{{ep},model_version="1",'
              f'population="cold"}}'] == 2
    assert tf[f'serving_ttft_seconds_count{{{ep},model_version="1",'
              f'population="prefix_hit"}}'] == 1
    assert tf[f'serving_itl_seconds_count{{{ep},model_version="1"}}'] == 12
    assert tf['admission_shed_total{endpoint="predict/lm/v1",'
              'tier="gold"}'] == 0


def test_metrics_json_snapshot_matches_jax(served):
    js, ts = (r["json"] for r in served)
    assert sorted(ts) == sorted(js) == ["batching", "endpoints", "gauges"]
    assert ts["batching"] == js["batching"]
    assert ts["gauges"] == js["gauges"]
    assert sorted(ts["endpoints"]) == sorted(js["endpoints"])
    for name, e in ts["endpoints"].items():
        je = js["endpoints"][name]
        assert sorted(e) == sorted(je)
        for k in ("requests", "errors", "shed", "deadline_expired"):
            assert e[k] == je[k], (name, k)
        assert e["latency"]["count"] == je["latency"]["count"]


def test_readyz_traceparent_and_exemplars_on_both(served):
    for r in served:
        port = r["server"].port
        code, body, _ = _call(port, "/readyz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body, _ = _call(port, "/healthz?ready")
        assert code == 200
        # the inbound sampled trace id rides the response header
        hdr = r["replies"][0][2]["traceparent"]
        ver, tid, span, flags = hdr.split("-")
        assert (ver, tid, flags) == ("00", INBOUND.split("-")[1], "01")
        assert span != INBOUND.split("-")[2]
        # every reply carries a well-formed traceparent
        for _, _, h in r["replies"][:6]:
            assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01",
                                h["traceparent"])
        # an exemplar trace id from OpenMetrics resolves in the span ring
        assert r["om"].endswith("# EOF\n")
        ex = re.findall(r'# \{trace_id="([0-9a-f]{32})"\}', r["om"])
        assert ex
        spans = json.loads(_call(
            port, "/debug/trace-export?since=0&limit=100000")[1])["spans"]
        traced = {s.get("trace_id") for s in spans}
        assert set(ex) <= traced
        assert INBOUND.split("-")[1] in traced
        names = {s["name"] for s in spans
                 if s.get("trace_id") == ex[0]}
        assert "request" in names
        page = json.loads(_call(port, "/debug/trace-export?since=0"
                                      "&limit=3")[1])
        assert len(page["spans"]) == 3 and page["next"] == \
            page["spans"][-1]["seq"]


def test_debug_pages_on_both(served):
    pages = []
    for r in served:
        port = r["server"].port
        req = json.loads(_call(port, "/debug/requests")[1])
        slots = json.loads(_call(port, "/debug/slots")[1])
        traces = json.loads(_call(port, "/debug/traces")[1])
        bundle = json.loads(_call(port, "/debug/bundle?reason=t")[1])
        recent = req["recent"]
        pages.append((
            sorted(req), [e["status"] for e in recent],
            [e["attrs"].get("prefix_hit_tokens") for e in recent],
            sorted(req["latency_attribution"]),
            sorted(req["latency_attribution"]["generate/lm/v1"]
                   ["phases_ms"]),
            slots["backends"]["generate/lm/v1"]["kv"],
            [s["state"] for s in
             slots["backends"]["generate/lm/v1"]["slots"]],
            sorted(traces), traces["sample_rate"],
            bundle["reason"], sorted(bundle["files"])))
    assert pages[0] == pages[1]
    assert pages[1][4] == ["admission", "decode", "prefill", "queue_wait",
                           "respond"]


def _chaos_cycle(srv, chaos_mod, ref_ids):
    """Open the generate breaker with 3 injected crashes, check the
    degraded surface, let the half-open probe close it."""
    port = srv.port
    b, _ = srv.batcher_for("lm")
    b.breaker.failure_threshold = 3
    b.breaker.cooldown_s = 0.5
    chaos_mod.install([{"site": "serving.worker.step", "kind": "crash",
                        "p": 1.0, "max_fires": 3}], seed=1)
    body = {"model": "lm", "prompt": PROMPTS[1], "n_tokens": 5}
    seen = {"crash_codes": [_call(port, "/v1/generate", body)[0]
                            for _ in range(3)]}
    t_end = time.monotonic() + 10
    while b.breaker.state != "open":
        assert time.monotonic() < t_end
        time.sleep(0.005)
    code, reply, hdrs = _call(port, "/v1/generate", body)
    reply = json.loads(reply)
    seen["open"] = (code, "circuit" in reply["error"],
                    int(hdrs["Retry-After"]) >= 1,
                    len(reply["trace_id"]))
    code, health, _ = _call(port, "/healthz")
    health = json.loads(health)
    seen["healthz"] = (code, health["status"], health["circuits"])
    code, _, hdrs = _call(port, "/readyz")
    seen["readyz"] = (code, "Retry-After" in hdrs)
    t_end = time.monotonic() + 10
    while b.breaker.state != "half_open":
        assert time.monotonic() < t_end
        time.sleep(0.01)
    code, reply, _ = _call(port, "/v1/generate", body)   # the probe
    seen["probe"] = (code, json.loads(reply)["ids"] == ref_ids)
    seen["closed"] = (b.breaker.state, _call(port, "/readyz")[0])
    flat = _flat(_call(port, "/metrics?format=prometheus")[1])
    ep = 'endpoint="generate/lm/v1"'
    seen["counts"] = (flat[f"serving_worker_crashes_total{{{ep}}}"],
                      flat[f"circuit_state{{{ep}}}"],
                      flat[f"serving_errors_total{{{ep}}}"],
                      flat[f"kv_pages_in_use{{{ep}}}"])
    chaos_mod.uninstall()
    return seen


def test_breaker_opens_and_recovers_like_jax(zip_path):
    servers = _servers(zip_path)
    try:
        cycles = []
        for srv, mod in zip(servers, (jchaos, tchaos)):
            code, ref, _ = _call(srv.port, "/v1/generate", {
                "model": "lm", "prompt": PROMPTS[1], "n_tokens": 5})
            assert code == 200
            cycles.append(_chaos_cycle(srv, mod, json.loads(ref)["ids"]))
    finally:
        for s in servers:
            s.stop()
        jchaos.uninstall()
        tchaos.uninstall()
    assert cycles[1] == cycles[0]
    assert cycles[1]["crash_codes"] == [500] * 3
    assert cycles[1]["open"] == (503, True, True, 32)
    assert cycles[1]["healthz"] == (200, "degraded",
                                    {"generate/lm/v1": "open"})
    assert cycles[1]["readyz"] == (503, True)
    assert cycles[1]["probe"] == (200, True)
    assert cycles[1]["closed"] == ("closed", 200)
    assert cycles[1]["counts"][:3] == (3, 0, 3)


def test_cli_serve_traces_slos_and_drains(zip_path, tmp_path):
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"slos": [
        {"name": "predict_fast", "objective": 0.9, "threshold_ms": 500,
         "endpoint": "predict/lm/v1", "window_m": 5}]}))
    trace = tmp_path / "trace.json"
    rec = tmp_path / "rec"
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch",
         "--trace", str(trace), "--flight-record", str(rec), "serve",
         "--model", f"lm={zip_path}", "--device", "cpu", "--port", "0",
         "--trace-sample", "1", "--slo", str(slo)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port, banner = None, []
        for line in proc.stdout:
            banner.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)/", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server did not start: " + "".join(banner)
        assert any("SLOs: predict_fast" in ln for ln in banner)
        for route in ("/readyz", "/metrics", "/debug/trace-export"):
            assert route in banner[-1]
        code, body, hdrs = _call(port, "/v1/predict", {
            "model": "lm", "inputs": [[1.0, 2.0, 3.0]]})
        assert code == 200 and hdrs["traceparent"].endswith("-01")
        code, text, hdrs = _call(port, "/metrics?format=prometheus")
        assert code == 200 and hdrs["Content-Type"].startswith(
            "text/plain; version=0.0.4")
        assert 'serving_requests_total{endpoint="predict/lm/v1"} 1' \
            in text
        assert 'slo_breach{slo="predict_fast"}' in text
        health = json.loads(_call(port, "/healthz")[1])
        assert health["slos"][0]["name"] == "predict_fast"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0
        rest = proc.stdout.read()
        assert "draining" in rest and "flight-recorder bundle" in rest
        assert "trace written" in rest
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e["name"] == "request" for e in events)
        assert any(d.startswith("postmortem-") for d in os.listdir(rec))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_alerts_degrade_health_and_scrapes_survive_a_failed_rebuild(
        zip_path):
    """A firing AlertManager rule degrades /healthz (and /readyz) the
    same way in both servers; a /metrics rebuild that raises (registry
    churn mid-drain) serves the last good exposition in both."""
    from deeplearning4j_tpu.observability.alerts import (
        AlertManager as JaxAlerts, AlertRule as JaxRule)
    from deeplearning4j_tpu_torch.observability.alerts import (AlertManager,
                                                               AlertRule)
    servers = _servers(zip_path)
    seen = []
    try:
        for srv, manager, rule in zip(servers, (JaxAlerts, AlertManager),
                                      (JaxRule, AlertRule)):
            srv.alerts = manager(srv.metrics.registry, rules=[rule(
                name="any_predict", metric="serving_requests_total",
                labels={"endpoint": "predict/lm/v1"}, op=">=",
                threshold=1.0, severity="page")])
            port = srv.port
            before = json.loads(_call(port, "/healthz")[1])["status"]
            assert _call(port, "/v1/predict", {
                "model": "lm", "inputs": [[1.0, 2.0]]})[0] == 200
            code, health, hdrs = _call(port, "/readyz")
            health = json.loads(health)
            text = _call(port, "/metrics?format=prometheus")[1]
            srv.metrics.prometheus_text = _raise
            again = _call(port, "/metrics?format=prometheus")
            seen.append((before, code, "Retry-After" in hdrs,
                         health["status"],
                         [a["name"] for a in health["alerts"]],
                         again[0], again[1] == text))
    finally:
        for s in servers:
            s.stop()
    assert seen[0] == seen[1] == (
        "ok", 503, True, "degraded", ["any_predict"], 200, True)


def _raise(*a, **k):
    raise RuntimeError("registry churn")
