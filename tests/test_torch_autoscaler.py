"""The port's autoscaler (``serving/autoscaler.py``) against the JAX
package's, and the ``serve-fleet`` control-loop flags.

Decision parity: each scenario drives one scripted signal sequence (queue
depth, SLO breach, probe health, sensor failures, boot failures, pause
tokens) under one fake clock through both packages' ``Autoscaler`` over
stub fleets and routers, and holds the decision list, the fleet's size,
the retired replicas and the registry's exposition equal. No test
sleeps on a load-timed condition: ``tick()`` is called directly, as the
JAX package's ``TestAutoscalerDecisions`` does. Scale-down under live
streams runs on two in-process port replicas of a small LM on the CPU.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.observability.registry import \
    MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.serving.autoscaler import Autoscaler as JaxScaler
from deeplearning4j_tpu.serving.errors import \
    ReplicaBootError as JaxBootError
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry
from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
from deeplearning4j_tpu_torch.serving.errors import ReplicaBootError
from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
from deeplearning4j_tpu_torch.serving.router import Router
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class StubReplica:
    def __init__(self, rid):
        self.id = rid
        self.fleet_state = "up"


class StubFleet:
    """Boot-first grow / instant retire, as the JAX tests' stub."""

    def __init__(self, boot_error, n=1):
        self._next = n
        self.replicas = [StubReplica(i) for i in range(n)]
        self.boot_failures = 0
        self.boot_attempts = 0
        self.retired = []
        self._boot_error = boot_error
        self.done = threading.Event()

    def size(self):
        return len(self.replicas)

    def draining_count(self):
        return sum(1 for r in self.replicas if r.fleet_state == "draining")

    def snapshot(self):
        return list(self.replicas)

    def grow(self, max_boot_retries=3):
        self.boot_attempts += 1
        if self.boot_failures > 0:
            self.boot_failures -= 1
            raise self._boot_error("stub boot failure")
        r = StubReplica(self._next)
        self._next += 1
        self.replicas.append(r)
        return r

    def retire(self, rid, drain_timeout=30.0):
        self.retired.append(rid)
        self.replicas = [r for r in self.replicas if r.id != rid]
        self.done.set()
        return True


class StubRouter:
    def __init__(self, registry, fleet):
        self.registry = registry
        self.fleet = fleet
        self.queue_depth = 0.0
        self.health = "ok"
        self.pins = {}
        self.broken = False

    def load_signals(self):
        if self.broken:
            raise RuntimeError("prober dead")
        return [{"rid": r.id, "health": self.health,
                 "queue_depth": self.queue_depth, "inflight": 0,
                 "kv_pages_in_use": 0.0, "kv_pages_total": 0.0,
                 "eligible": self.health == "ok"}
                for r in self.fleet.snapshot() if r.fleet_state == "up"]

    def pinned_sessions(self):
        return dict(self.pins)


class StubSLOs:
    def __init__(self):
        self.breached = False
        self.broken = False

    def any_breached(self):
        if self.broken:
            raise RuntimeError("bad SLO rule")
        return self.breached


# one scenario = (scaler kwargs, initial fleet size, script); a script
# step is ("set", attr, value) on router / slos / fleet, ("tick",),
# ("advance", dt), ("pause", token), ("resume", token), ("kill",)
def _ticks(n, dt=1.0):
    out = []
    for _ in range(n):
        out += [("tick",), ("advance", dt)]
    return out


SCENARIOS = {
    "hysteresis": ({}, 1, [("router", "queue_depth", 20.0)] + _ticks(3)),
    "noisy_no_flap": ({}, 2, [
        step for i in range(12) for step in
        [("router", "queue_depth", 20.0 if i % 2 == 0 else 0.0),
         ("tick",), ("advance", 1.0)]]),
    "up_cooldown": ({}, 1, [("router", "queue_depth", 20.0)]
                    + _ticks(6) + [("advance", 2.0)] + _ticks(2)),
    "slo_breach_up": ({}, 1, [("slos", "breached", True)] + _ticks(3)),
    "bounds_max": ({"max_replicas": 3}, 3,
                   [("router", "queue_depth", 50.0)] + _ticks(8)),
    "bounds_min": ({}, 1, [("router", "queue_depth", 0.0)] + _ticks(8)),
    "scale_down_fewest_pinned": (
        {"down_cooldown_s": 0.0}, 3,
        [("router", "queue_depth", 0.0),
         ("router", "pins", {0: 2, 1: 0, 2: 1})] + _ticks(4)),
    "down_cooldown": ({"down_consecutive": 2}, 3,
                      [("router", "queue_depth", 0.0)] + _ticks(8)),
    "boot_failure_backoff": (
        {}, 1, [("fleet", "boot_failures", 1),
                ("router", "queue_depth", 20.0), ("tick",),
                ("advance", 1.0), ("tick",), ("advance", 0.5), ("tick",),
                ("advance", 5.0), ("tick",)]),
    "unprobed_pool_held": (
        {"down_consecutive": 2, "down_cooldown_s": 0.0}, 2,
        [("router", "health", "unprobed")] + _ticks(6)),
    "probed_dead_scales_up": ({}, 1, [("router", "health", "dead")]
                              + _ticks(3)),
    "sensor_failure_holds": ({}, 1, [("router", "queue_depth", 20.0),
                                     ("tick",),
                                     ("router", "broken", True)]
                             + _ticks(6)),
    "slo_sensor_failure_blocks_down": (
        {"down_consecutive": 2, "down_cooldown_s": 0.0}, 2,
        [("slos", "broken", True)] + _ticks(6)),
    "below_min_repair": ({"min_replicas": 2}, 2, [("kill",), ("tick",),
                                                  ("tick",)]),
    "pause_holds_then_resume": (
        {}, 1, [("router", "queue_depth", 20.0), ("pause", "rollout")]
        + _ticks(4) + [("resume", "rollout")] + _ticks(3)),
}


def _run(scaler_cls, registry_cls, boot_error, scenario):
    kw, n, script = SCENARIOS[scenario]
    clk = FakeClock()
    fleet = StubFleet(boot_error, n=n)
    router = StubRouter(registry_cls(), fleet)
    slos = StubSLOs()
    cfg = dict(min_replicas=1, max_replicas=4, queue_high=8.0,
               queue_low=1.0, up_consecutive=2, down_consecutive=3,
               up_cooldown_s=5.0, down_cooldown_s=30.0, clock=clk)
    cfg.update(kw)
    sc = scaler_cls(fleet, router, slos=slos, **cfg)
    targets = {"router": router, "slos": slos, "fleet": fleet}
    decisions = []
    for step in script:
        if step[0] == "tick":
            d = sc.tick()
            decisions.append(d)
            if d == "down":
                # the retire runs on a worker thread; the stub's is
                # instant, wait for it before the next step
                assert fleet.done.wait(10.0)
                fleet.done.clear()
        elif step[0] == "advance":
            clk.advance(step[1])
        elif step[0] == "pause":
            sc.pause(step[1])
        elif step[0] == "resume":
            sc.resume(step[1])
        elif step[0] == "kill":
            fleet.replicas.pop()
        else:
            setattr(targets[step[0]], step[1], step[2])
    sc.stop(wait_retires=True)
    return {"decisions": decisions, "size": fleet.size(),
            "retired": fleet.retired, "attempts": fleet.boot_attempts,
            "exposition": sc.registry.prometheus_text(),
            "debug": json.dumps(sc.debug(), sort_keys=True, default=str)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_match_jax(scenario):
    want = _run(JaxScaler, JaxRegistry, JaxBootError, scenario)
    got = _run(Autoscaler, MetricsRegistry, ReplicaBootError, scenario)
    assert got == want
    # each scenario shows what it is named for
    d = got["decisions"]
    expect = {"hysteresis": lambda: d[:2] == [None, "up"],
              "noisy_no_flap": lambda: set(d) == {None},
              "up_cooldown": lambda: d.count("up") == 2,
              "slo_breach_up": lambda: "up" in d,
              "bounds_max": lambda: got["size"] == 3,
              "bounds_min": lambda: got["size"] == 1,
              "scale_down_fewest_pinned": lambda: got["retired"] == [1],
              "down_cooldown": lambda: d.count("down") == 1,
              "boot_failure_backoff": lambda: d[-1] == "up"
              and got["attempts"] == 2,
              "unprobed_pool_held": lambda: set(d) == {None},
              "probed_dead_scales_up": lambda: "up" in d,
              "sensor_failure_holds": lambda: got["size"] == 1,
              "slo_sensor_failure_blocks_down": lambda: not got["retired"],
              "below_min_repair": lambda: d[0] == "up",
              "pause_holds_then_resume": lambda: d[:4] == [None] * 4
              and "up" in d[4:]}[scenario]
    assert expect(), got


def test_constructor_validation_matches_jax():
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(queue_low=8.0, queue_high=8.0)):
        for cls in (JaxScaler, Autoscaler):
            with pytest.raises(ValueError):
                cls(None, None, **bad)


# ---------------------------------------------------------------------------
# scale-down under live streams (in-process port replicas, CPU)
# ---------------------------------------------------------------------------

V, D, L, H, CAP, PS = 64, 32, 2, 4, 64, 4


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    b = (NeuralNetConfiguration.builder().set_seed(0).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    path = str(tmp_path_factory.mktemp("scaler") / "lm.zip")
    jser.write_model(JaxNet(conf).init(), path)
    return path


class SlowLM:
    """The port LM with a throttled paged decode step, so a stream lives
    through the scale-down."""

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


def _post(port, path, body, timeout=60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("retire_pinned", [False, True])
def test_scale_down_under_live_streams_drops_nothing(zip_path,
                                                     retire_pinned):
    fleet = ReplicaFleet(
        lambda: {"lm": SlowLM(restore_model(zip_path, device="cpu"),
                              0.02)},
        n=2, device="cpu",
        server_kwargs=dict(wait_ms=1.0, slots=2, capacity=CAP,
                           kv_mode="paged", page_size=PS)).start()
    router = Router(fleet, probe_interval_s=0.05, hedge_after_s=None,
                    sample_rate=0.0).start()
    result = {}

    def stream():
        result["resp"] = _post(router.port, "/v1/generate",
                               {"model": "lm", "prompt": [1, 2, 3],
                                "n_tokens": 40, "session": "s1"})

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not router.pinned_sessions():
            time.sleep(0.02)
        pins = router.pinned_sessions()
        assert pins, "stream never pinned"
        pinned = next(iter(pins))
        rep = next(r for r in fleet.snapshot() if r.id == pinned)
        while time.monotonic() < deadline:
            slots = rep.server.debug_slots()["backends"]
            if any(b["active_slots"] > 0 for b in slots.values()):
                break
            time.sleep(0.02)
        clk = FakeClock()
        sc = Autoscaler(fleet, router, min_replicas=1, max_replicas=4,
                        down_consecutive=1, down_cooldown_s=0.0,
                        drain_timeout_s=30.0, clock=clk)
        victim = sc._pick_scale_down_victim()
        assert victim is not None and victim != pinned
        if retire_pinned:
            ok = fleet.retire(pinned, drain_timeout=30.0)
            assert ok
        else:
            # the control loop's own scale-down: low queues, one tick
            assert sc.tick() == "down"
            sc.stop(wait_retires=True)
        t.join(timeout=60.0)
        assert not t.is_alive()
        st, body = result["resp"]
        assert st == 200 and len(body["ids"]) == 40
        assert fleet.size() == 1
        survivor = fleet.snapshot()[0].id
        assert survivor == (victim if retire_pinned else pinned)
    finally:
        t.join(timeout=1.0)
        router.stop()
        fleet.stop(drain=False, timeout=2.0)


# ---------------------------------------------------------------------------
# the serve-fleet flags
# ---------------------------------------------------------------------------

def test_control_loop_flags_registered():
    jax_help = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu", "serve-fleet",
         "--help"], capture_output=True, text=True, timeout=120, cwd=REPO)
    port_help = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-fleet",
         "--help"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert jax_help.returncode == 0 and port_help.returncode == 0
    flags = lambda text: set(re.findall(r"--[a-z][a-z-]*", text))  # noqa
    assert flags(jax_help.stdout) <= flags(port_help.stdout)
    for flag in ("--autoscale", "--autoscale-tick", "--queue-high",
                 "--queue-low", "--slo", "--collector",
                 "--collector-interval", "--incident-dir", "--rollout",
                 "--rollout-version", "--rollout-canary-weight",
                 "--rollout-shadow-sample", "--rollout-min-requests",
                 "--index", "--nprobe"):
        assert flag in port_help.stdout
    assert "A4b-2" not in port_help.stdout


def _fleet_args(**over):
    base = dict(autoscale="1:3", chaos=None, chaos_seed=None,
                model=["missing.zip"], replicas=1, host="127.0.0.1",
                port=0, max_batch_size=32, queue_limit=256, wait_ms=2.0,
                slots=4, capacity=256, probe_interval=1.0,
                hedge_after_ms=0.0, trace_sample=0.0, mesh=None,
                autoscale_tick=1.0, queue_high=8.0, queue_low=1.0,
                slo=None, net_chaos=None, net_chaos_seed=None, roles=None,
                kv_mode="auto", page_size=16, kv_pages=None,
                no_kv_routing=False, collector=None,
                collector_interval=1.0, incident_dir=None, rollout=None,
                rollout_version=None, rollout_canary_weight=0.25,
                rollout_shadow_sample=0.5, rollout_min_requests=50,
                index=None, index_kind="brute", nlist=16, nprobe=None,
                index_metric="cosine", device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("bad", [
    dict(autoscale="nope"), dict(autoscale="4:2"), dict(autoscale="0:3"),
    dict(queue_low=8.0, queue_high=8.0),
    dict(slo='[{"objective": 2.0}]'),
    dict(rollout=["cand.zip"]),                          # no collector
    dict(rollout=["cand.zip"], collector=0, rollout_canary_weight=0.0),
    dict(rollout=["cand.zip"], collector=0, rollout_shadow_sample=1.5),
    dict(rollout=["cand.zip"], collector=0, model=None,
         index="random:n=8"),
    dict(model=None),
    dict(mesh="sp=2"),          # serving meshes take dp/tp axes only
    dict(net_chaos='{"faults": [{"site": "net.replica", "kind": "nope"}]}'),
])
def test_bad_fleet_inputs_exit_before_any_replica_boots(bad, monkeypatch):
    booted = []
    monkeypatch.setattr(ReplicaFleet, "start",
                        lambda self: booted.append(self) or self)
    with pytest.raises(SystemExit) as e:
        cli._cmd_serve_fleet(_fleet_args(**bad))
    assert booted == []
    assert "not ported" not in str(e.value)
