"""The port's fleet observability plane (``observability/fleetobs.py``)
against the JAX package's, on the CPU.

Exposition parsing, bucket-wise histogram merging, quantiles and the
downsampled ring are host code copied from the JAX package: the same
exposition text (from either package's registry) must parse, merge and
render identically. A ``FleetCollector`` over a 2-replica in-process
port fleet merges counters equal to the members' sums, and a fleet-SLO
breach writes exactly one incident bundle. ``render_status`` equals the
JAX package's on one snapshot. No test asserts a wall-clock time.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.observability import fleetobs as jobs
from deeplearning4j_tpu.observability.registry import \
    MetricsRegistry as JaxRegistry
from deeplearning4j_tpu_torch.observability import fleetobs as tobs
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry
from deeplearning4j_tpu_torch.observability.slo import SLO
from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
from deeplearning4j_tpu_torch.serving.router import Router

PREDICT_EP = "predict/default/v1"

MEMBER_A = """\
# TYPE serving_requests_total counter
serving_requests_total{endpoint="predict/default/v1"} 7
# TYPE serving_latency_seconds histogram
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="0.01"} 3 # {trace_id="aaa"} 0.004 100.0
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="0.1"} 6
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="+Inf"} 7
serving_latency_seconds_sum{endpoint="predict/default/v1"} 0.35
serving_latency_seconds_count{endpoint="predict/default/v1"} 7
# EOF
"""

MEMBER_B = """\
# TYPE serving_requests_total counter
serving_requests_total{endpoint="predict/default/v1"} 5
# TYPE serving_gauge gauge
serving_gauge{name="default_queue_depth"} 3
# TYPE serving_latency_seconds histogram
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="0.01"} 2 # {trace_id="bbb"} 0.003 200.0
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="0.1"} 4
serving_latency_seconds_bucket{endpoint="predict/default/v1",le="+Inf"} 5
serving_latency_seconds_sum{endpoint="predict/default/v1"} 0.21
serving_latency_seconds_count{endpoint="predict/default/v1"} 5
m_total{a="x\\"y",b="p,q r"} 7
g{path="{brace}"} 2
# EOF
"""


def _fill(reg):
    c = reg.counter("x_total", labels={"endpoint": PREDICT_EP})
    c.inc(5)
    g = reg.gauge("serving_gauge", labels={"name": "default_queue_depth"})
    g.set(3)
    h = reg.histogram("lat_seconds", labels={"endpoint": "p"},
                      buckets=[0.01, 0.1, 1])
    for i, v in enumerate((0.005, 0.05, 0.5, 5.0, 0.07)):
        h.record(v, exemplar={"trace_id": f"t{i}"})
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("source", ["jax_registry", "port_registry",
                                    "golden_a", "golden_b"])
def test_parse_exposition_matches_jax(source, openmetrics):
    if source == "jax_registry":
        text = _fill(JaxRegistry()).prometheus_text(openmetrics=openmetrics)
    elif source == "port_registry":
        text = _fill(MetricsRegistry()).prometheus_text(
            openmetrics=openmetrics)
    else:
        text = MEMBER_A if source == "golden_a" else MEMBER_B
    want = jobs.parse_exposition(text)
    got = tobs.parse_exposition(text)
    assert got == want
    if source.endswith("registry") and not openmetrics:
        # the two registries expose the same text (the OpenMetrics
        # form carries each exemplar's wall-clock stamp)
        assert text == _fill(JaxRegistry()).prometheus_text()


def _parts(seed, n=4, edges=(0.001, 0.01, 0.1, 1.0)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = [int(v) for v in rng.integers(0, 50, len(edges) + 1)]
        ex = {int(rng.integers(0, len(edges) + 1)):
              ({"trace_id": f"s{seed}p{i}"}, float(rng.uniform(0, 1)),
               float(rng.uniform(0, 1000)))}
        out.append({"edges": list(edges), "counts": counts,
                    "count": sum(counts), "sum": float(rng.uniform(0, 9)),
                    "exemplars": ex})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_merge_and_quantiles_match_jax(seed):
    parts = _parts(seed)
    got = tobs.merge_histograms(parts)
    assert got == jobs.merge_histograms(parts)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for p in parts + [got]:
            assert tobs._hist_quantile(p["edges"], p["counts"], q) == \
                jobs._hist_quantile(p["edges"], p["counts"], q)
    bad = dict(parts[0], edges=[0.2, 1.0, 2.0, 3.0])
    for mod in (tobs, jobs):
        with pytest.raises(ValueError):
            mod.merge_histograms([parts[1], bad])


def test_downsampled_ring_matches_jax():
    rings = [tobs._DownsampledRing(16), jobs._DownsampledRing(16)]
    for i in range(200):
        for r in rings:
            r.append(i)
        assert rings[0].items() == rings[1].items()
        assert rings[0].stride == rings[1].stride


@pytest.mark.parametrize("members", ["a", "ab", "b"])
def test_merged_registry_matches_jax(members):
    scraped = {"a": MEMBER_A, "b": MEMBER_B}
    texts = []
    for mod in (tobs, jobs):
        col = mod.FleetCollector(targets=[])
        col._merge({f"replica-{i}": mod.parse_exposition(scraped[m])
                    for i, m in enumerate(members)})
        texts.append(col.registry.prometheus_text(openmetrics=True))
        col.stop()
    assert texts[0] == texts[1]


def test_render_status_matches_jax():
    snap = {"ts_unix": 1700000000.0, "interval_s": 1.0, "cycles": 12,
            "targets": {"router": "up", "replica-0": "up",
                        "replica-1": "down"},
            "endpoints": {"predict": {"count": 40, "errors": 1,
                                      "p50_ms": 1.25, "p99_ms": 9.5}},
            "phases_p99_ms": {"device_step": 3.0, "queue_wait": 0.5},
            "slo": [{"name": "lat", "breached": True,
                     "burn_rates": {"1h": 14.5, "5m": 20.0}}],
            "replicas": [{"rid": 0, "queue_depth": 2, "inflight": 1,
                          "kv_pages_in_use": 3, "kv_pages_total": 12}],
            "versions": {"0": 2},
            "rollout": {"state": "canary", "incumbent_version": 1,
                        "candidate_version": 2, "updated": 1, "total": 4,
                        "last_gate": "warmup", "holds": 3},
            "traces": {"count": 5, "recent": [{"trace_id": "ab" * 16}]},
            "incidents": [{"incident": "incident-x"}],
            "alerts": [{"name": "fleet-slo-lat"}]}
    assert tobs.render_status(snap) == jobs.render_status(snap)
    assert tobs.render_status({}) == jobs.render_status({})


def test_local_bundle_payload_shape():
    reg = _fill(MetricsRegistry())
    p = tobs.local_bundle_payload(registry=reg, reason="t")
    j = jobs.local_bundle_payload(registry=_fill(JaxRegistry()), reason="t")
    assert set(p["files"]) == set(j["files"])
    assert p["files"]["MANIFEST.json"]["reason"] == "t"


# ---------------------------------------------------------------------------
# the collector over an in-process port fleet
# ---------------------------------------------------------------------------

class EchoModel:
    def output(self, x):
        return np.asarray(x) * 2.0


def _post(port, path, body, timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture()
def fleet():
    f = ReplicaFleet(lambda: {"default": EchoModel()}, n=2, device="cpu",
                     server_kwargs=dict(wait_ms=1.0)).start()
    r = Router(f, probe_interval_s=0.05, hedge_after_s=None,
               sample_rate=1.0).start()
    cols = []
    yield f, r, cols
    for c in cols:
        c.stop()
    r.stop()
    f.stop(drain=False, timeout=2.0)


def _predict(i):
    return {"model": "default", "inputs": [[float(i % 5), 1.0, 2.0]]}


def test_collector_merged_counters_equal_member_sum(fleet):
    f, router, cols = fleet
    for i in range(20):
        assert _post(router.port, "/v1/predict", _predict(i))[0] == 200
    col = tobs.FleetCollector(fleet=f, router=router)
    cols.append(col)
    col.scrape_once()
    agg = col.registry.get("serving_requests_total",
                           {"endpoint": PREDICT_EP})
    per = [col.registry.get("serving_requests_total",
                            {"endpoint": PREDICT_EP,
                             "replica": f"replica-{r.id}"})
           for r in f.snapshot()]
    assert agg is not None and all(m is not None for m in per)
    assert agg.value == sum(m.value for m in per) == 20.0
    # the fleet-level view the autoscaler and rollout read
    sigs = col.load_signals()
    assert sorted(s["rid"] for s in sigs) == [str(r.id)
                                              for r in f.snapshot()]
    raw = col.replica_raw([r.id for r in f.snapshot()])
    assert sum(v["requests"] for v in raw.values()) == 20
    snap = col.fleet_snapshot()
    assert "replica-0" in snap["targets"]
    assert tobs.render_status(snap) == jobs.render_status(snap)


def test_collector_incident_writes_one_bundle(fleet, tmp_path):
    f, router, cols = fleet
    slo = SLO(name="lat", objective=0.99, threshold_s=1e-9,
              labels={"endpoint": PREDICT_EP}, window_s=60.0)
    col = tobs.FleetCollector(fleet=f, router=router, slos=[slo],
                              incident_dir=str(tmp_path),
                              incident_min_interval_s=0.0)
    cols.append(col)
    router.attach_fleet_health(col.fleet_health)
    for i in range(5):
        _post(router.port, "/v1/predict", _predict(i))
    col.scrape_once()                 # seeds the burn sample
    time.sleep(0.05)
    for i in range(5):
        _post(router.port, "/v1/predict", _predict(i))
    col.scrape_once()                 # delta -> breach -> incident
    fh = col.fleet_health()
    assert fh["ok"] is False and fh["slo_breaches"] == ["lat"]
    incidents = [d for d in os.listdir(tmp_path)
                 if d.startswith("incident-")]
    assert len(incidents) == 1 and "slo-breach-lat" in incidents[0]
    root = tmp_path / incidents[0]
    manifest = json.loads((root / "MANIFEST.json").read_text())
    members = {m for m, v in manifest["members"].items() if v == "ok"}
    assert members == {"router", "replica-0", "replica-1"}
    for m in members:
        assert {"MANIFEST.json", "env.json", "metrics.json"} <= set(
            os.listdir(root / m))
    # serving is untouched by the breach
    assert _post(router.port, "/v1/predict", _predict(0))[0] == 200


def test_collector_http_and_fleet_status_cli(fleet, capsys):
    from deeplearning4j_tpu_torch import cli
    f, router, cols = fleet
    for i in range(4):
        _post(router.port, "/v1/predict", _predict(i))
    col = tobs.FleetCollector(fleet=f, router=router, interval_s=0.05,
                              port=0).start()
    cols.append(col)
    base = f"http://127.0.0.1:{col.port}"
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        with urllib.request.urlopen(base + "/fleet/snapshot",
                                    timeout=5) as r:
            snap = json.loads(r.read())
        if snap.get("cycles", 0) >= 1:
            break
        time.sleep(0.05)
    with urllib.request.urlopen(base + "/metrics?format=prometheus",
                                timeout=5) as r:
        text = r.read().decode()
    assert 'replica="replica-0"' in text
    cli.main(["fleet-status", "--collector", base])
    out = capsys.readouterr().out
    assert out.startswith("fleet-status") and "replica-0 UP" in out
