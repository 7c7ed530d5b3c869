"""The port's metrics, SLO and alert layers against the JAX package's,
on the CPU: the same sequence of counter, gauge and histogram calls
(exemplars included) into both registries gives the same snapshot,
byte-identical Prometheus text, the same OpenMetrics text once exemplar
timestamps are masked, and the same interpolated quantiles (to 1e-12,
float64 on both sides); the serving instruments register the same
names and labels; SLOMonitor and AlertManager reach the same verdicts
over one recorded sequence on an injected clock; the flight recorder's
environment names torch and CUDA, not jax.
"""

import json
import re

import numpy as np
import pytest

from deeplearning4j_tpu.observability import alerts as jal
from deeplearning4j_tpu.observability import registry as jreg
from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu.serving import metrics as jmet
from deeplearning4j_tpu_torch.observability import alerts as tal
from deeplearning4j_tpu_torch.observability import flight_recorder as tfr
from deeplearning4j_tpu_torch.observability import registry as treg
from deeplearning4j_tpu_torch.observability import slo as tslo
from deeplearning4j_tpu_torch.observability.fleetobs import (
    local_bundle_payload)
from deeplearning4j_tpu_torch.observability.tracing import Tracer
from deeplearning4j_tpu_torch.serving import metrics as tmet

_TS = re.compile(r"(# \{[^}]*\} \S+) \d+\.\d{3}$", re.M)


def _drive(mod, seed):
    """One seeded sequence of instrument calls; returns the registry
    and the histograms it touched."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    depth = [3.0]
    reg.gauge("queue_depth", help="items queued", labels={"q": "a"},
              fn=lambda: depth[0])
    g = reg.gauge("kv_pages_in_use", help='pages "in" use\nnow',
                  labels={"endpoint": 'gen\\v1'})
    hists = [reg.histogram("serving_latency_seconds", help="latency",
                           labels={"endpoint": "p"},
                           buckets=mod.default_latency_buckets()),
             reg.histogram("step_ms", help="custom buckets",
                           buckets=[0.5, 1.0, 2.5, 10.0])]
    for i in range(400):
        k = int(rng.integers(0, 4))
        if k == 0:
            reg.counter("serving_requests_total", help="requests",
                        labels={"endpoint": f"e{i % 3}"}).inc(
                            float(rng.integers(1, 4)))
        elif k == 1:
            g.set(float(rng.integers(0, 100)))
        else:
            v = float(rng.lognormal(-4.0, 2.0))
            ex = ({"trace_id": f"{i:032x}"} if rng.random() < 0.5
                  else None)
            hists[k - 2].record(v, exemplar=ex)
    mod.safe_inc("serving_worker_crashes_total", help="crashes",
                 labels={"endpoint": "p"}, registry=reg)
    depth[0] = 7.0
    return reg, hists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_identical_to_jax(seed):
    (jr, jh), (tr, th) = _drive(jreg, seed), _drive(treg, seed)
    assert tr.snapshot() == jr.snapshot()
    assert tr.prometheus_text() == jr.prometheus_text()
    jo = jr.prometheus_text(openmetrics=True)
    to = tr.prometheus_text(openmetrics=True)
    assert " # {trace_id=" in to and to.endswith("# EOF\n")
    assert _TS.sub(r"\1 TS", to) == _TS.sub(r"\1 TS", jo)
    for a, b in zip(jh, th):
        assert a.count == b.count
        for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999):
            assert abs(a.quantile(q) - b.quantile(q)) <= 1e-12


def _serving(mod):
    m = mod.ServingMetrics()
    ep = m.endpoint("generate/lm/v1")
    occ = m.occupancy("generate/lm/v1", 8)
    st = m.streaming("generate/lm/v1", "1")
    m.register_gauge("generate/lm/v1_queue_depth", lambda: 2)
    for i, v in enumerate([0.01, 0.2, 0.03, 4.0]):
        ep.observe(v, trace_id=f"{i:032x}" if i % 2 else None)
        ep.record_phases({"admission": v / 4, "queue_wait": v / 4,
                          "prefill": v / 4, "decode": v / 8,
                          "respond": v / 8})
        occ.record(i + 1)
        st.record_ttft(v, prefix_hit=bool(i % 2))
        st.record_itl(v / 10, trace_id=f"{i:032x}")
    ep.count_error()
    ep.count_shed()
    ep.count_expired()
    return m


def test_serving_instruments_register_the_jax_names_and_labels():
    jm, tm = _serving(jmet), _serving(tmet)
    assert tm.registry.snapshot() == jm.registry.snapshot()
    assert tm.prometheus_text() == jm.prometheus_text()

    def shape(snap):
        # keys, and the nested latency summary's keys: rates and
        # latencies are wall-clock numbers, compared by count only
        return {k: sorted(v) if isinstance(v, dict) else None
                for k, v in snap.items()}
    js, ts = jm.snapshot(), tm.snapshot()
    assert ts["batching"] == js["batching"] and ts["gauges"] == js["gauges"]
    for name, e in ts["endpoints"].items():
        je = js["endpoints"][name]
        assert shape(e) == shape(je)
        keys = ("requests", "errors", "shed", "deadline_expired")
        assert [e[k] for k in keys] == [je[k] for k in keys]
        assert e["latency"]["count"] == je["latency"]["count"]
    # the latency-attribution report reconciles the same way
    ja, ta = jm.latency_attribution(), tm.latency_attribution()
    assert ta == ja
    assert tm.evict_endpoint("generate/lm/v1") == \
        jm.evict_endpoint("generate/lm/v1")


RULES = [{"name": "gen_p99", "objective": 0.9, "threshold_ms": 50,
          "endpoint": "generate/lm/v1", "window_m": 1},
         {"name": "gen_avail", "objective": 0.95,
          "endpoint": "generate/lm/v1", "window_s": 60.0,
          "windows": None}]


def _slo_run(mod_slo, mod_met, path):
    clock = [0.0]
    m = mod_met.ServingMetrics()
    mon = mod_slo.SLOMonitor.from_config(
        m.registry, str(path), clock=lambda: clock[0],
        min_eval_interval_s=0.0)
    ep = m.endpoint("generate/lm/v1")
    rng = np.random.default_rng(5)
    trail = []
    for t in range(60):
        clock[0] = float(t * 5)
        bad = 20 <= t < 35
        for _ in range(int(rng.integers(5, 15))):
            if bad and rng.random() < 0.4:
                ep.count_error()
            ep.observe(float(rng.lognormal(-2.0 if bad else -5.0, 0.5)),
                       trace_id=f"{t:032x}")
        changes = mon.evaluate()
        trail.append(([c["event"] for c in changes],
                      [(s["name"], s["breached"],
                        sorted(s["burn_rates"].items()))
                       for s in mon.status()]))
    return trail, mon


def test_slo_monitor_from_config_matches_jax(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"slos": RULES}))
    jt, jmon = _slo_run(jslo, jmet, path)
    tt, tmon = _slo_run(tslo, tmet, path)
    assert tt == jt
    events = [e for evs, _ in tt for e in evs]
    assert "breach" in events and "recover" in events
    assert tmon.offending_traces(tmon._slos["gen_p99"]) == \
        jmon.offending_traces(jmon._slos["gen_p99"])


def _alert_run(mod_al, mod_reg):
    clock = [0.0]
    reg = mod_reg.MetricsRegistry()
    c = reg.counter("serving_shed_total", help="shed",
                    labels={"endpoint": "p"})
    h = reg.histogram("serving_latency_seconds", help="l",
                      labels={"endpoint": "p"},
                      buckets=mod_reg.default_latency_buckets())
    fired = []
    mgr = mod_al.AlertManager(
        reg, rules=[
            mod_al.AlertRule(name="shed", metric="serving_shed_total",
                             labels={"endpoint": "p"}, op=">=",
                             threshold=3, for_seconds=2.0),
            mod_al.AlertRule(name="p99", metric="serving_latency_seconds",
                             labels={"endpoint": "p"}, quantile=0.99,
                             threshold=0.1, debounce_seconds=5.0)],
        on_fire=lambda a: fired.append(("fire", a["name"])),
        on_resolve=lambda a: fired.append(("resolve", a["name"])),
        clock=lambda: clock[0])
    trail = []
    for t in range(30):
        clock[0] = float(t)
        if t in (3, 4, 5):
            c.inc()
        for _ in range(10):
            h.record(0.5 if 8 <= t < 12 or 16 <= t < 18 else 0.001)
        changes = mgr.evaluate()
        trail.append(([(x["event"], x["name"]) for x in changes],
                      sorted(a["name"] for a in mgr.firing())))
    return trail, fired


def test_alert_manager_fires_the_same_rules_as_jax():
    tt, tf = _alert_run(tal, treg)
    jt, jf = _alert_run(jal, jreg)
    assert tt == jt and tf == jf
    assert ("fire", "shed") in tf and ("fire", "p99") in tf


def test_flight_recorder_env_names_torch_and_bundles(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    tracer = Tracer()
    reg = treg.MetricsRegistry()
    rec = tfr.install(tfr.FlightRecorder(out_dir=str(tmp_path),
                                         registry=reg, tracer=tracer,
                                         min_dump_interval_s=0.0))
    try:
        env = rec.env_snapshot()
        assert "torch_version" in env and "cuda_version" in env
        assert env["devices"] == []          # no card visible here
        assert "JAX_PLATFORMS" not in env["env"]
        assert env["env"]["CUDA_VISIBLE_DEVICES"] == ""
        tracer.record_span("request", 0, 10, trace_id="a" * 32)
        tfr.on_backend_crash("generate/lm/v1", RuntimeError("boom"))
        assert len(rec.dumps) == 1
        kinds = [json.loads(ln)["kind"] for ln in
                 open(f"{rec.dumps[0]}/events.jsonl")]
        assert kinds == ["span", "backend_crash"]
        payload = local_bundle_payload(registry=reg, tracer=tracer,
                                       reason="test")
        assert payload["reason"] == "test"
        assert [e["kind"] for e in payload["files"]["events.jsonl"]] \
            == kinds
        assert payload["files"]["MANIFEST.json"]["files"] == sorted(
            set(payload["files"]) - {"MANIFEST.json"})
    finally:
        tfr.uninstall()
    assert tfr.get_recorder() is None
