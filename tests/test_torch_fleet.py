"""The port's replica fleet and router (``serving/fleet.py``,
``serving/router.py``) over port replicas, on the CPU, against the JAX
package's.

Replicas serve the small LM of tests/test_torch_disagg.py (V=64, D=32,
L=2, H=4, capacity 64, page_size 4, saved by the JAX package and
restored by the port) for generate, and a threadsafe echo model with a
settable delay for the predict drills. Covered: failover on ``kill``,
outlier ejection on ``hang`` and readmission, hedging, session affinity,
``replace()`` with zero dropped requests, roles, the disaggregated
prefill -> decode split and drain migration through the router (greedy
ids equal the JAX package's whole run), the ``serving.kv.migrate``
chaos fallbacks, the router's ``/metrics`` names and labels against the
JAX router's, a mixed fleet of one JAX and one port replica handing a
stream off over HTTP both ways, the ``serve-fleet`` verb, and the argv a
subprocess replica would spawn. No test asserts a wall-clock time.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.serving import ContinuousBatcher as JaxBatcher
from deeplearning4j_tpu.serving.fleet import (
    InProcessReplica as JaxReplica)
from deeplearning4j_tpu.serving.fleet import ReplicaFleet as JaxFleet
from deeplearning4j_tpu.serving.router import Router as JaxRouter
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.serving.fleet import (ReplicaFleet,
                                                    SubprocessReplica,
                                                    parse_roles)
from deeplearning4j_tpu_torch.serving.lifecycle import CircuitBreaker
from deeplearning4j_tpu_torch.serving.router import Router
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_dp_worker import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, L, H, CAP, PS = 64, 32, 2, 4, 64, 4
TIME_LIMIT_S = 150
PROMPT = np.random.default_rng(7).integers(1, V, 11).tolist()


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: SIGALRM fails it past TIME_LIMIT_S."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    chaos.uninstall()


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    b = (NeuralNetConfiguration.builder().set_seed(0).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    path = str(tmp_path_factory.mktemp("fleet") / "lm.zip")
    jser.write_model(JaxNet(conf).init(), path)
    return path


@pytest.fixture(scope="module")
def whole(zip_path):
    """Whole-run greedy ids on one JAX batcher, at 12 and 40 tokens."""
    cb = JaxBatcher(jser.restore_model(zip_path), slots=2, capacity=CAP,
                    kv_mode="paged", page_size=PS, name="whole")
    try:
        return {n: np.asarray(cb.generate(PROMPT, n)).tolist()
                for n in (12, 40)}
    finally:
        cb.shutdown(drain=False)


class EchoModel:
    """Threadsafe predictor: doubles its input after ``delay`` seconds."""

    def __init__(self, delay=0.0):
        self.delay = delay

    def output(self, x):
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(x) * 2.0


class SlowLM:
    """The port LM with a throttled paged decode step, so a stream lives
    long enough for the drain drills."""

    def __init__(self, net, delay):
        self.net, self.delay = net, delay
        self.layers = net.layers

    def slot_streaming_session(self, **kw):
        return self.net.slot_streaming_session(**kw)

    def paged_slot_streaming_session(self, **kw):
        s = self.net.paged_slot_streaming_session(**kw)
        step, d = s.step_slots, self.delay

        def slow(x, active):
            time.sleep(d)
            return step(x, active)

        s.step_slots = slow
        return s


@pytest.fixture()
def stack(zip_path):
    """Builds port fleet + router pairs with test-speed knobs; tears
    every one down afterwards."""
    built = []

    def build(n=3, roles=None, delays=None, stream_delay=0.0, **router_kw):
        seq = {"i": 0}

        def factory():
            i = seq["i"]
            seq["i"] += 1
            d = 0.0 if delays is None else delays[min(i, len(delays) - 1)]
            net = restore_model(zip_path, device="cpu")
            return {"default": EchoModel(d),
                    "lm": SlowLM(net, stream_delay) if stream_delay
                    else net}

        fleet = ReplicaFleet(factory, n=n, roles=roles, device="cpu",
                             server_kwargs=dict(
                                 wait_ms=1.0, slots=2, capacity=CAP,
                                 kv_mode="paged", page_size=PS)).start()
        kw = dict(probe_interval_s=0.05, probe_timeout_s=0.4,
                  eject_consecutive=2, eject_cooldown_s=0.5,
                  attempt_timeout_s=5.0, request_timeout_s=30.0,
                  hedge_after_s=None, sample_rate=1.0)
        kw.update(router_kw)
        router = Router(fleet, **kw).start()
        built.append((fleet, router))
        return fleet, router

    yield build
    chaos.uninstall()
    for fleet, router in built:
        router.stop()
        fleet.stop(drain=False, timeout=2.0)


def _post(port, path, body, timeout=60.0, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path, timeout=10.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            raw = r.read()
            return r.status, raw
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _counter(router, name, **labels):
    m = router.registry.get(name, labels=labels or None)
    return 0.0 if m is None else m.value


def _predict(i=0):
    return {"model": "default", "inputs": [[float(i % 5), 1.0, 2.0, 3.0]]}


def _served(replica, endpoint="predict/default/v1"):
    return replica.server.metrics.snapshot()["endpoints"].get(
        endpoint, {}).get("requests", 0)


def _until(cond, what, limit=10.0):
    t_end = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.02)


def _load(port, n, workers=6, body=_predict):
    """``n`` predicts from ``workers`` threads: the statuses."""
    codes, lock, it = [], threading.Lock(), iter(range(n))

    def work():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            c = _post(port, "/v1/predict", body(i), timeout=30)[0]
            with lock:
                codes.append(c)

    ts = [threading.Thread(target=work) for _ in range(workers)]
    for t in ts:
        t.start()
    return ts, codes


# ------------------------------------------------------------ routing

def test_routes_spreads_and_serves_the_lm(stack, whole):
    fleet, router = stack(n=3)
    for i in range(30):
        code, body, hdrs = _post(router.port, "/v1/predict", _predict(i))
        assert code == 200 and "traceparent" in hdrs
        np.testing.assert_allclose(body["outputs"],
                                   np.asarray(_predict(i)["inputs"]) * 2)
    served = [_served(r) for r in fleet.snapshot()]
    assert sum(served) == 30 and all(s > 0 for s in served)
    code, body, _ = _post(router.port, "/v1/generate",
                          {"model": "lm", "prompt": PROMPT, "n_tokens": 12})
    assert (code, body["ids"]) == (200, whole[12])
    code, raw = _get(router.port, "/fleet")
    assert code == 200 and {r["state"] for r in json.loads(raw)[
        "replicas"]} == {"ok"}
    assert json.loads(_get(router.port, "/healthz")[1])["eligible"] == 3


def test_failover_on_kill_drops_nothing(stack):
    fleet, router = stack(n=3, delays=[0.01])
    ts, codes = _load(router.port, 120)
    _until(lambda: len(codes) >= 20, "load never started")
    fleet.kill(0)
    for t in ts:
        t.join(60)
    assert codes == [200] * 120
    assert fleet.size() == 2


def test_seeded_chaos_kill_at_an_ordinal(stack):
    fleet, router = stack(n=3)
    inj = chaos.install({"faults": [
        {"site": "serving.replica", "kind": "kill", "at": [10],
         "args": {"replica": 0}}]}, seed=77)
    for i in range(15):
        assert _post(router.port, "/v1/predict", _predict(i))[0] == 200
    assert fleet.size() == 2
    assert inj.hits("serving.replica") == 15 and inj.fired_total == 1


def test_hang_ejects_then_readmits(stack):
    fleet, router = stack(n=3, probe_timeout_s=0.15)
    rep = fleet.replica(0)
    fleet.hang(0, delay_s=1.0)
    _until(lambda: router.replica_states().get(rep.id) == "ejected",
           "hung replica never ejected")
    assert _counter(router, "router_ejections_total",
                    replica=str(rep.id)) >= 1
    time.sleep(1.2)                 # stragglers into the hang finish
    before = _served(rep)
    for i in range(20):
        assert _post(router.port, "/v1/predict", _predict(i))[0] == 200
    assert _served(rep) == before   # no traffic while ejected
    fleet.hang(0, delay_s=0.0)
    _until(lambda: router.replica_states().get(rep.id) == "ok",
           "replica never readmitted")
    assert _counter(router, "router_readmissions_total",
                    replica=str(rep.id)) >= 1


def test_hedge_answers_from_the_fast_replica(stack):
    fleet, router = stack(n=2, delays=[1.0, 0.0], hedge_after_s=0.15,
                          hedge_min_budget_s=0.5, attempt_timeout_s=5.0)
    for i in range(6):
        assert _post(router.port, "/v1/predict", _predict(i))[0] == 200
    assert _counter(router, "router_hedges_total") >= 1
    assert _counter(router, "router_hedge_wins_total") >= 1


def test_429_fails_over_without_ejection(stack):
    fleet, router = stack(n=2, probe_interval_s=30.0)
    full, real = fleet.replica(0), router._forward

    def forward(view, method, path, body, headers, timeout):
        if view.rid == full.id:
            return 429, json.dumps({"error": "queue full"}).encode(), \
                {"Retry-After": "30"}
        return real(view, method, path, body, headers, timeout)

    router._forward = forward
    for i in range(10):
        assert _post(router.port, "/v1/predict", _predict(i))[0] == 200
    view = router._views[full.id]
    assert view.unavailable_until > time.monotonic() + 10
    assert view.breaker.state == CircuitBreaker.CLOSED


def test_session_pin_sticks_until_death_then_rebinds(stack, whole):
    fleet, router = stack(n=3)
    body = {"model": "lm", "prompt": PROMPT, "n_tokens": 12,
            "session": "user-42"}
    for _ in range(3):
        code, out, _ = _post(router.port, "/v1/generate", body)
        assert (code, out["ids"]) == (200, whole[12])
    rid = router._affinity["user-42"]
    counts = {r.id: _served(r, "generate/lm/v1") for r in fleet.snapshot()}
    assert counts[rid] == 3 and sum(counts.values()) == 3
    fleet.kill([r.id for r in fleet.snapshot()].index(rid))
    code, out, _ = _post(router.port, "/v1/generate", body)
    assert (code, out["ids"]) == (200, whole[12])
    assert router._affinity["user-42"] != rid
    assert _counter(router, "router_affinity_breaks_total") >= 1


def test_replace_under_load_drops_nothing(stack):
    fleet, router = stack(n=2, delays=[0.004])
    before = {r.id for r in fleet.snapshot()}
    ts, codes = _load(router.port, 150)
    _until(lambda: len(codes) >= 10, "load never started")
    successor = fleet.replace(0, drain_timeout=20.0)
    for t in ts:
        t.join(60)
    assert codes == [200] * 150
    after = {r.id for r in fleet.snapshot()}
    assert successor.id in after and len(after) == 2 and after != before


def test_parse_roles():
    assert parse_roles("prefill=1,decode=3") == \
        ["prefill", "decode", "decode", "decode"]
    assert parse_roles(None, 2) == ["mixed", "mixed"]
    for bad, n in (("turbo=2", None), ("prefill=1", 3), ("decode=x", None)):
        with pytest.raises(ValueError):
            parse_roles(bad, n)


def test_replace_successor_inherits_role(stack):
    fleet, router = stack(n=2, roles=["prefill", "decode"])
    fleet.replace(0, drain_timeout=10.0)
    assert sorted(r.role for r in fleet.snapshot()) == ["decode", "prefill"]


# ------------------------------------------- disaggregation and migration

def test_disaggregated_split_through_the_router(stack, whole):
    fleet, router = stack(n=2, roles=["prefill", "decode"])
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    code, out, hdrs = _post(router.port, "/v1/generate",
                            {"model": "lm", "prompt": PROMPT,
                             "n_tokens": 12},
                            headers={"traceparent": tp})
    assert (code, out["ids"]) == (200, whole[12])
    assert hdrs["traceparent"][3:35] == "ab" * 16
    assert _counter(router, "router_kv_handoffs_total") == 1
    assert _counter(router, "router_kv_fallbacks_total") == 0
    lbl = {"endpoint": "generate/lm/v1"}
    per = {r.role: r.server.metrics.registry for r in fleet.snapshot()}
    assert per["prefill"].get("kv_stream_exports_total",
                              labels=lbl).value == 1
    assert per["decode"].get("kv_stream_imports_total",
                             labels=lbl).value == 1


def test_prefix_aware_routing_counts(stack, whole):
    fleet, router = stack(n=2)
    body = {"model": "lm", "prompt": PROMPT, "n_tokens": 12}
    assert _post(router.port, "/v1/generate", body)[1]["ids"] == whole[12]
    _until(lambda: any(v.prefix_fps for v in router._views.values()),
           "no prefix advertisement scraped")
    assert _post(router.port, "/v1/generate", body)[1]["ids"] == whole[12]
    assert _counter(router, "router_kv_routed_total") >= 1
    assert _counter(router, "router_prefix_hit_tokens_total") >= PS


def _stream(port, session, n_tokens=40):
    res = {}

    def run():
        res["r"] = _post(port, "/v1/generate",
                         {"model": "lm", "prompt": PROMPT,
                          "n_tokens": n_tokens, "session": session})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, res


def _pinned(fleet, router):
    _until(lambda: router.pinned_sessions(), "stream never pinned")
    rid = next(iter(router.pinned_sessions()))
    return [r.id for r in fleet.snapshot()].index(rid), rid


def _mid_stream(fleet, pos, tokens=3):
    b = fleet.replica(pos).server.batcher_for("lm")[0]
    _until(lambda: any(s is not None and len(s.out) >= tokens
                       for s in b._slots), "stream never decoding")
    return b


def test_replace_migrates_a_pinned_stream(stack, whole):
    fleet, router = stack(n=2, stream_delay=0.02)
    t, res = _stream(router.port, "soak-1")
    pos, rid = _pinned(fleet, router)
    old = _mid_stream(fleet, pos)
    fleet.replace(pos, drain_timeout=30.0)
    t.join(60)
    code, out, _ = res["r"]
    assert (code, out["ids"]) == (200, whole[40])
    assert _counter(router, "router_kv_migrations_total") >= 1
    assert rid not in router.pinned_sessions()
    # the incumbent's acked stream gave its pages back before it left
    assert old.session.pages_in_use() == 0


@pytest.mark.parametrize("kind", ["corrupt", "error"])
def test_migrate_chaos_finishes_on_the_incumbent(stack, whole, kind):
    """serving.kv.migrate corrupt: the survivor's import fails 422 and
    the router resumes the stream on the incumbent. error: the export
    fails, no offer is made, the stream finishes in place. No drops."""
    fleet, router = stack(n=2, stream_delay=0.02)
    t, res = _stream(router.port, f"soak-{kind}")
    pos, _ = _pinned(fleet, router)
    _mid_stream(fleet, pos)
    chaos.install({"faults": [{"site": "serving.kv.migrate",
                               "kind": kind, "p": 1.0}]}, seed=3)
    fleet.replace(pos, drain_timeout=30.0)
    t.join(60)
    code, out, _ = res["r"]
    assert (code, out["ids"]) == (200, whole[40])
    assert _counter(router, "router_kv_migrations_total") == 0
    assert _counter(router, "router_kv_resumes_total") == \
        (1 if kind == "corrupt" else 0)


# --------------------------------------------------- against the JAX router

def _flat_keys(text):
    return {line.rsplit(" ", 1)[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def _drive(port):
    """The request sequence: predicts, a split generate, a bad body."""
    codes = [_post(port, "/v1/predict", _predict(i))[0] for i in range(4)]
    codes.append(_post(port, "/v1/generate", {
        "model": "lm", "prompt": PROMPT, "n_tokens": 6})[0])
    codes.append(_post(port, "/v1/predict", {"model": "nope",
                                             "inputs": [[1.0]]})[0])
    return codes


def test_router_metrics_names_and_labels_equal_jax(zip_path):
    server_kwargs = dict(wait_ms=1.0, slots=2, capacity=CAP,
                         kv_mode="paged", page_size=PS)
    rkw = dict(probe_interval_s=0.05, hedge_after_s=None, sample_rate=1.0)
    port_fleet = ReplicaFleet(
        lambda: {"default": EchoModel(),
                 "lm": restore_model(zip_path, device="cpu")},
        n=2, roles=["prefill", "decode"], device="cpu",
        server_kwargs=server_kwargs).start()
    jax_fleet = JaxFleet(
        lambda: {"default": EchoModel(),
                 "lm": jser.restore_model(zip_path)},
        n=2, roles=["prefill", "decode"],
        server_kwargs=server_kwargs).start()
    routers = [Router(port_fleet, **rkw).start(),
               JaxRouter(jax_fleet, **rkw).start()]
    try:
        codes = [_drive(r.port) for r in routers]
        assert codes[0] == codes[1] == [200] * 5 + [404]
        texts = [_get(r.port, "/metrics?format=prometheus")[1].decode()
                 for r in routers]
    finally:
        for r in routers:
            r.stop()
        port_fleet.stop(drain=False, timeout=2.0)
        jax_fleet.stop(drain=False, timeout=2.0)
    port_keys, jax_keys = (_flat_keys(t) for t in texts)
    assert port_keys == jax_keys
    flat = [dict(line.rsplit(" ", 1) for line in t.splitlines()
                 if line and not line.startswith("#")) for t in texts]
    for key in ('router_requests_total{route="/v1/predict"}',
                'router_requests_total{route="/v1/generate"}',
                "router_kv_handoffs_total", "router_kv_fallbacks_total"):
        assert flat[0][key] == flat[1][key], key
    assert float(flat[0]["router_kv_handoffs_total"]) == 1


@pytest.mark.parametrize("prefill_side", ["jax", "port"])
def test_mixed_fleet_hands_off_over_http(zip_path, whole, prefill_side):
    """The port's router over one JAX replica and one port replica: the
    lease crosses the two packages over the wire, and the ids are the
    whole run's."""
    port_role = "decode" if prefill_side == "jax" else "prefill"
    jax_role = "prefill" if prefill_side == "jax" else "decode"
    kw = dict(slots=2, capacity=CAP, kv_mode="paged", page_size=PS)
    fleet = ReplicaFleet(lambda: {"lm": restore_model(zip_path,
                                                      device="cpu")},
                         n=1, roles=[port_role], device="cpu",
                         server_kwargs=kw).start()
    jr = JaxReplica(1, lambda: {"lm": jser.restore_model(zip_path)},
                    server_kwargs=kw)
    jr.role = jax_role
    jr.start()
    with fleet._lock:
        fleet._replicas.append(jr)
        fleet._next_id = 2
    router = Router(fleet, probe_interval_s=0.05, hedge_after_s=None).start()
    try:
        code, out, _ = _post(router.port, "/v1/generate",
                             {"model": "lm", "prompt": PROMPT,
                              "n_tokens": 12})
        assert (code, out["ids"]) == (200, whole[12])
        assert _counter(router, "router_kv_handoffs_total") == 1
        assert _counter(router, "router_kv_fallbacks_total") == 0
        lbl = {"endpoint": "generate/lm/v1"}
        jreg = jr.server.metrics.registry
        preg = fleet.replica(0).server.metrics.registry
        exporter, importer = (jreg, preg) if prefill_side == "jax" \
            else (preg, jreg)
        assert exporter.get("kv_stream_exports_total",
                            labels=lbl).value == 1
        assert importer.get("kv_stream_imports_total",
                            labels=lbl).value == 1
    finally:
        router.stop()
        fleet.stop(drain=False, timeout=2.0)


# ---------------------------------------------------- serve-fleet and argv

def test_subprocess_replica_spawns_the_port():
    r = SubprocessReplica(3, ["lm=/m/lm.zip"], 9123, extra_args=["--x"],
                          device="cpu")
    cmd = r.command()
    assert cmd[:4] == [sys.executable, "-m", "deeplearning4j_tpu_torch",
                       "serve"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--port") + 1] == "9123"
    assert cmd[cmd.index("--model") + 1] == "lm=/m/lm.zip"
    assert cmd[-1] == "--x"
    fleet = ReplicaFleet(model_specs=["lm=/m/lm.zip"], n=2, base_port=9100)
    assert fleet._new_replica().command()[
        fleet._new_replica().command().index("--device") + 1] == "cuda"


@pytest.mark.parametrize("argv,item", [
    (["--roles", "prefill=1"], "roles"),
    (["--roles", "turbo=2"], "roles"),
    # the control-loop flags are ported: a bad value of each refuses
    (["--autoscale", "nope"], "MIN:MAX"),
    (["--autoscale", "1:3", "--queue-high", "0.5"], "--queue-low"),
    (["--autoscale", "1:3", "--queue-low", "9"], "--queue-low"),
    (["--autoscale", "3:1", "--autoscale-tick", "1"], "1 <= MIN <= MAX"),
    (["--slo", '[{"objective": 2.0}]'], "bad --slo"),
    (["--rollout", "m2.zip"], "needs --collector"),
    (["--collector", "0", "--collector-interval", "1", "--net-chaos",
      '{"faults": [{"site": "net.replica", "kind": "nope"}]}'],
     "bad --net-chaos"),
    (["--collector", "0", "--incident-dir", "x", "--autoscale", "0:1"],
     "1 <= MIN <= MAX"),
    (["--rollout", "m2.zip", "--autoscale", "1:3"], "needs --collector"),
    (["--rollout", "m2.zip", "--rollout-version", "2"], "needs --collector"),
    (["--rollout", "m2.zip", "--collector", "0",
      "--rollout-canary-weight", "0"], "canary-weight"),
    (["--rollout", "m2.zip", "--collector", "0",
      "--rollout-shadow-sample", "1.5"], "shadow-sample"),
    (["--rollout", "m2.zip", "--rollout-min-requests", "5"],
     "needs --collector"),
    # a serving mesh a replica: the JAX mesh server's refusals
    (["--mesh", "sp=2"], "dp/tp axes only"),
    (["--mesh", "dp=1,pp=2"], "dp/tp axes only"),
    (["--mesh", "tp=2", "--index", "random:n=64,dim=8"],
     "--index does not compose with --mesh"),
    (["--mesh", "tp"], "bad --mesh"),
])
def test_serve_fleet_refuses_before_any_replica_boots(monkeypatch, argv,
                                                      item):
    from deeplearning4j_tpu_torch.cli import main

    def boot(*_a, **_k):
        raise AssertionError("a replica booted")

    monkeypatch.setattr(ReplicaFleet, "start", boot)
    with pytest.raises(SystemExit) as e:
        main(["serve-fleet", "--model", "m.zip", "--replicas", "2",
              "--device", "cpu"] + argv)
    assert item in str(e.value)


def test_serve_fleet_cli_splits_prefill_and_decode(zip_path, whole,
                                                   tmp_path):
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-fleet",
         "--model", f"lm={zip_path}", "--replicas", "2", "--roles",
         "prefill=1,decode=1", "--port", str(port), "--device", "cpu",
         "--slots", "2", "--capacity", str(CAP), "--page-size", str(PS),
         "--probe-interval", "0.2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t_end = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < t_end, "fleet never became ready"
            try:
                if json.loads(_get(port, "/healthz")[1])["eligible"] == 2:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        code, out, _ = _post(port, "/v1/generate",
                             {"model": "lm", "prompt": PROMPT,
                              "n_tokens": 12})
        assert (code, out["ids"]) == (200, whole[12])
        text = _get(port, "/metrics?format=prometheus")[1].decode()
        assert "router_kv_handoffs_total 1.0" in text or \
            "router_kv_handoffs_total 1\n" in text
        roles = {r["role"] for r in json.loads(_get(port, "/fleet")[1])[
            "replicas"]}
        assert roles == {"prefill", "decode"}
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "draining fleet" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
