"""The port's canary rollout (``serving/rollout.py``) and its gate
(``observability/slo.compare_cohorts``), against the JAX package's, on
the CPU.

``compare_cohorts`` is held equal to the JAX package's over a grid of
cohorts. The rollout drills run on in-process port replicas behind the
port's router and collector (the JAX package's ``tests/test_rollout.py``
soaks, with the port's stack): a good candidate is promoted with zero
dropped requests and capacity never below N, and a seeded
``serving.rollout`` ``bad_version`` candidate is caught by shadow scoring
and rolled back with exactly one incident bundle. Their assertions are
on outcomes, never on a wall-clock time; a watchdog aborts a hung gate.
``fleet-status`` and ``fleet-rollout`` are driven against a subprocess
``serve-fleet`` on the CPU.
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
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.observability.slo import \
    compare_cohorts as jax_compare
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos, cli
from deeplearning4j_tpu_torch.observability.fleetobs import FleetCollector
from deeplearning4j_tpu_torch.observability.slo import compare_cohorts
from deeplearning4j_tpu_torch.serving.fleet import UP, ReplicaFleet
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.rollout import (RolloutController,
                                                      _PoisonedModel,
                                                      _SlowModel)
from deeplearning4j_tpu_torch.serving.router import Router

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = ("gold", "standard", "best_effort")


# ---------------------------------------------------------------------------
# the comparative gate
# ---------------------------------------------------------------------------

BASE = {"requests": 500, "errors": 2, "p99_ms": 40.0}
COHORTS = [
    (BASE, {"requests": 9, "errors": 0, "p99_ms": 1.0}, {}),
    (BASE, {"requests": 100, "errors": 10, "p99_ms": 40.0}, {}),
    (BASE, {"requests": 100, "errors": 0, "p99_ms": 90.0}, {}),
    (BASE, {"requests": 100, "errors": 1, "p99_ms": 45.0}, {}),
    ({"requests": 500, "errors": 0, "p99_ms": 0.9},
     {"requests": 100, "errors": 0, "p99_ms": 2.0},
     {"p99_floor_ms": 5.0}),
    ({"requests": 0, "errors": 0, "p99_ms": 0.0},
     {"requests": 60, "errors": 1, "p99_ms": 3.0}, {}),
    (BASE, {"requests": 50, "errors": 2, "p99_ms": 59.0},
     {"max_p99_ratio": 1.5, "max_error_rate_delta": 0.05}),
    ({}, {"requests": None, "errors": None}, {}),
]


@pytest.mark.parametrize("case", range(len(COHORTS)))
def test_compare_cohorts_matches_jax(case):
    base, cand, kw = COHORTS[case]
    assert compare_cohorts(base, cand, **kw) == jax_compare(base, cand,
                                                            **kw)


def test_chaos_wrappers():
    class M:
        def output(self, x):
            return np.asarray(x, np.float32) * 2.0

    import torch
    t = _PoisonedModel(type("T", (), {"output": lambda s, x:
                                      torch.ones(2, 2)})())
    assert torch.isnan(t.output(None)).all()
    assert np.isnan(_PoisonedModel(M()).output([[1.0]])).all()
    assert _SlowModel(M(), 0.0).output([[1.0]]).tolist() == [[2.0]]


def test_registry_get_and_unregister():
    reg = ModelRegistry()
    a, b = object(), object()
    assert reg.register("m", a) == 1 and reg.register("m", b) == 2
    assert reg.get("m") is b and reg.get("m", 1) is a
    reg.unregister("m", 2)
    assert reg.get("m") is a
    reg.unregister("m")
    assert "m" not in reg
    from deeplearning4j_tpu_torch.serving.errors import ModelNotFoundError
    with pytest.raises(ModelNotFoundError):
        reg.get("m")
    with pytest.raises(ModelNotFoundError):
        reg.unregister("m")


# ---------------------------------------------------------------------------
# rollout drills on in-process port replicas
# ---------------------------------------------------------------------------

class EchoModel:
    """x * 2.0: the incumbent and, re-instantiated, a behavior-equal
    candidate (the same weights written again)."""

    def output(self, x):
        return np.asarray(x) * 2.0


def _post(base, path, body, timeout=10.0):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, {}


class _Driver:
    """Background tier-mix predict load with per-tier outcome counts and
    a running minimum of UP serving capacity."""

    def __init__(self, base, fleet, pace_s=0.004):
        self.base, self.fleet, self.pace_s = base, fleet, pace_s
        self.counts = {t: {"ok": 0, "dropped": 0, "nan": 0}
                       for t in TIERS}
        self.min_capacity = 10 ** 9
        self._stop = threading.Event()
        self._threads = []

    def _loop(self, tier):
        i = 0
        while not self._stop.is_set():
            i += 1
            st, body = _post(self.base, "/v1/predict",
                             {"model": "default",
                              "inputs": [[float(i % 5)]], "tier": tier})
            c = self.counts[tier]
            if st == 200:
                flat = np.asarray(body.get("outputs"), np.float64)
                c["ok" if flat.size and np.isfinite(flat).all()
                  else "nan"] += 1
            else:
                c["dropped"] += 1
            up = sum(1 for r in self.fleet.snapshot()
                     if r.fleet_state == UP)
            self.min_capacity = min(self.min_capacity, up)
            time.sleep(self.pace_s)

    def __enter__(self):
        for tier in TIERS:
            t = threading.Thread(target=self._loop, args=(tier,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)


def _run_with_watchdog(rc, timeout_s=90.0):
    done = {}
    t = threading.Thread(target=lambda: done.setdefault("s", rc.run()),
                         daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive():
        rc.abort("watchdog timeout")
        t.join(timeout=30.0)
    return done.get("s")


def _drill(tmp_path, bad):
    if bad:
        chaos.install({"faults": [{"site": "serving.rollout",
                                   "kind": "bad_version", "at": [1]}]},
                      seed=11)
    fleet = ReplicaFleet(lambda: {"default": EchoModel()}, n=4,
                         device="cpu",
                         server_kwargs=dict(wait_ms=1.0)).start()
    router = Router(fleet, probe_interval_s=0.05, probe_timeout_s=0.4,
                    eject_consecutive=3, eject_cooldown_s=0.5,
                    attempt_timeout_s=2.0, request_timeout_s=10.0,
                    hedge_after_s=None, sample_rate=1.0).start()
    col = FleetCollector(fleet=fleet, router=router, interval_s=0.2,
                         incident_min_interval_s=0.0,
                         incident_dir=str(tmp_path)).start()
    try:
        # max_p99_ratio wide open, as in the JAX package's soaks: the
        # drills hold the machinery (split, shadow scoring, rollback),
        # the p99 arithmetic is compare_cohorts' test
        rc = RolloutController(
            fleet, router, candidate_factory=lambda: {
                "default": EchoModel()},
            collector=col, min_requests=30, warmup_requests=5,
            min_shadow_compared=8, gate_poll_s=0.1, drain_timeout_s=5.0,
            max_p99_ratio=50.0)
        router.attach_rollout(rc)
        with _Driver(f"http://127.0.0.1:{router.port}", fleet) as drv:
            time.sleep(0.8)            # baseline evidence
            final = _run_with_watchdog(rc)
        shape = {"versions": set(fleet.versions().values()),
                 "size": fleet.size(),
                 "incumbent": fleet.incumbent_version,
                 "candidate": fleet.candidate_version}
        return shape, drv, final
    finally:
        chaos.uninstall()
        col.stop()
        router.stop()
        fleet.stop(drain=False, timeout=2.0)


def test_good_candidate_is_promoted_with_zero_drops(tmp_path):
    fleet, drv, final = _drill(tmp_path, bad=False)
    assert final is not None and final["outcome"] == "promoted", final
    assert final["state"] == "complete" and final["holds"] >= 1
    assert fleet["versions"] == {2} and fleet["size"] == 4
    assert fleet["incumbent"] == 2
    assert sum(c["dropped"] for c in drv.counts.values()) == 0, drv.counts
    assert all(drv.counts[t]["ok"] > 0 and drv.counts[t]["nan"] == 0
               for t in TIERS)
    assert drv.min_capacity >= 4
    assert not list(tmp_path.glob("incident-*"))


def test_bad_candidate_is_rolled_back_with_one_incident(tmp_path):
    fleet, drv, final = _drill(tmp_path, bad=True)
    assert final is not None and final["outcome"] == "rolled_back", final
    assert final["last_gate"] == "shadow_mismatch", final
    assert fleet["versions"] == {1} and fleet["size"] == 4
    assert fleet["incumbent"] == 1 and fleet["candidate"] is None
    assert drv.counts["gold"]["dropped"] == 0, drv.counts
    assert drv.min_capacity >= 4
    bundles = sorted(tmp_path.glob("incident-*"))
    assert len(bundles) == 1, bundles
    assert "rollout-rollback-shadow_mismatch" in bundles[0].name
    ev = json.loads((bundles[0] / "rollout.json").read_text())
    assert ev["gate"] == "shadow_mismatch" and ev["offending_trace_ids"]
    assert ev["candidate_version"] == 2


def test_no_collector_holds_and_abort_rolls_back():
    fleet = ReplicaFleet(lambda: {"default": EchoModel()}, n=2,
                         device="cpu",
                         server_kwargs=dict(wait_ms=1.0)).start()
    router = Router(fleet, probe_interval_s=0.05, hedge_after_s=None,
                    sample_rate=0.0).start()
    try:
        rc = RolloutController(fleet, router,
                               candidate_factory=lambda: {
                                   "default": EchoModel()},
                               gate_poll_s=0.05, drain_timeout_s=5.0)
        with pytest.raises(ValueError):
            rc.abort("nothing to abort")
        rc.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and rc.status()["holds"] < 3:
            time.sleep(0.05)
        st = rc.status()
        assert st["state"] == "canary" and st["last_gate"] == "no_collector"
        with pytest.raises(ValueError):
            rc.start()
        rc.abort("done")
        rc.join(timeout=30.0)
        st = rc.status()
        assert st["outcome"] == "rolled_back"
        assert st["last_gate"] == "operator_abort"
        assert set(fleet.versions().values()) == {1}
    finally:
        router.stop()
        fleet.stop(drain=False, timeout=2.0)


# ---------------------------------------------------------------------------
# fleet-status / fleet-rollout against a CPU serve-fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_zip(tmp_path_factory):
    conf = (NeuralNetConfiguration.builder().set_seed(0).list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    path = str(tmp_path_factory.mktemp("rollout") / "mlp.zip")
    jser.write_model(JaxNet(conf).init(), path)
    return path


def test_fleet_status_and_rollout_verbs(mlp_zip, tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-fleet",
         "--model", f"default={mlp_zip}", "--replicas", "2", "--port",
         "0", "--device", "cpu", "--probe-interval", "0.1",
         "--collector", "0", "--collector-interval", "0.2",
         "--incident-dir", str(tmp_path), "--rollout",
         f"default={mlp_zip}", "--rollout-min-requests", "1000000",
         "--autoscale", "2:3"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        lines, router_url, collector_url = [], None, None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and router_url is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("fleet collector on "):
                collector_url = line.split()[3].rstrip("/")
            if line.startswith("fleet router on "):
                router_url = line.split()[3].rstrip("/")
        text = "".join(lines)
        assert router_url and collector_url, text
        assert "autoscaler: bounds 2..3" in text
        assert "rollout: candidate staged (default)" in text
        while time.monotonic() < deadline:
            with urllib.request.urlopen(collector_url + "/fleet/snapshot",
                                        timeout=5) as r:
                if json.loads(r.read()).get("cycles", 0) >= 1:
                    break
            time.sleep(0.1)
        cli.main(["fleet-status", "--collector", collector_url])
        out = capsys.readouterr().out
        assert out.startswith("fleet-status") and "router UP" in out
        cli.main(["fleet-rollout", "status", "--router", router_url])
        assert "state    : idle" in capsys.readouterr().out
        cli.main(["fleet-rollout", "start", "--router", router_url])
        capsys.readouterr()
        while time.monotonic() < deadline:
            st, body = _post(router_url, "/v1/predict",
                             {"model": "default", "inputs": [[1.0] * 4]})
            assert st == 200
            cli.main(["fleet-rollout", "status", "--router", router_url])
            if "state    : canary" in capsys.readouterr().out:
                break
        cli.main(["fleet-rollout", "abort", "--router", router_url,
                  "--reason", "verb test"])
        capsys.readouterr()
        while time.monotonic() < deadline:
            cli.main(["fleet-rollout", "status", "--router", router_url])
            out = capsys.readouterr().out
            if "(rolled_back)" in out:
                break
            time.sleep(0.1)
        assert "state    : idle (rolled_back)" in out
        assert "detail   : verb test" in out
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "draining fleet" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
