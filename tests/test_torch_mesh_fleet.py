"""``serve-fleet --mesh``: a fleet whose every replica serves predict
tensor-parallel, on the CPU, against the JAX package's mesh server.

In the JAX package one process drives every device, so each replica is
an in-process ``ModelServer(mesh=)``. In the port a replica is a rank
set of ``serve --mesh`` processes (``serving.fleet.MeshReplica``): one
``serve-fleet --mesh tp=2 --replicas 2`` launch here runs four ranks.
Predict through the router equals the JAX mesh server's on the same zip
(within 1e-5), every replica's ``/healthz`` carries the mesh, generate
is refused as the JAX server refuses it, a SIGKILLed follower takes its
rank 0 with it and the fleet boots a successor, and ctrl-c leaves no
rank behind. The refusals before any boot are JAX's for ``serve
--mesh``.
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

import jax

from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu_torch.serving.fleet import MeshReplica, ReplicaFleet

from torch_dp_worker import free_port

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 2,
                                 reason="the JAX mesh server needs 2 "
                                        "virtual devices")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, T = 11, 8
ATOL = 1e-5
GONE_S = 10.0       # a dead follower's rank 0 is killed within this


def lm(seed=17):
    b = (NeuralNetConfiguration.builder().set_seed(seed)
         .updater(updaters.adam(1e-2)).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=16)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=4, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return MultiLayerNetwork(conf).init()


def _call(base, path, body=None, timeout=60):
    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _alive(pid):
    import psutil
    try:
        return psutil.Process(pid).status() != psutil.STATUS_ZOMBIE
    except psutil.NoSuchProcess:
        return False


def _jax_mesh_server(path, ids):
    """The JAX package's ``ModelServer(mesh="tp=2")`` on the zip: its
    predict of ``ids`` and its generate refusal."""
    from deeplearning4j_tpu.serving.errors import ServingError
    from deeplearning4j_tpu.serving.http import ModelServer
    from deeplearning4j_tpu.serving.registry import ModelRegistry
    from deeplearning4j_tpu.util.model_serializer import restore_model
    reg = ModelRegistry()
    reg.register("lm", restore_model(path))
    server = ModelServer(reg, mesh="tp=2")
    try:
        model, _ = server.resolve_serving_model("lm")
        want = np.asarray(model.output(ids))
        with pytest.raises(ServingError) as refused:
            server.batcher_for("lm")
    finally:
        server.stop(drain=False)
    return want, str(refused.value)


def test_serve_fleet_mesh_serves_replaces_and_stops(tmp_path):
    path = str(tmp_path / "lm.zip")
    write_model(lm(), path)
    ids = np.random.default_rng(5).integers(0, V, (3, T)).astype(np.float32)
    want, jax_refusal = _jax_mesh_server(path, ids)
    port = free_port()
    logs = tmp_path / "ranks"
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-fleet",
         "--model", f"lm={path}", "--mesh", "tp=2", "--replicas", "2",
         "--port", str(port), "--device", "cpu", "--probe-interval", "0.2",
         "--log-dir", str(logs)],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO,
                           "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)     # the fleet and its ranks: one group
    base = f"http://127.0.0.1:{port}"
    pids = set()

    def fleet_view(n_eligible=2, deadline_s=90):
        t_end = time.monotonic() + deadline_s
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < t_end, "the fleet never became ready"
            try:
                if _call(base, "/healthz", timeout=5)[1][
                        "eligible"] == n_eligible:
                    view = _call(base, "/fleet", timeout=5)[1]["replicas"]
                    for r in view:
                        pids.update(r["pids"])
                    return view
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.2)

    try:
        view = fleet_view()
        assert [len(r["pids"]) for r in view] == [2, 2]
        for r in view:          # each replica's rank 0 serves the mesh
            health = _call(r["url"], "/healthz")[1]
            assert health["mesh"]["axes"]["tp"] == 2
            with urllib.request.urlopen(
                    r["url"] + "/metrics?format=prometheus",
                    timeout=30) as resp:
                assert re.search(r'serving_mesh_devices\{axis="tp"\} 2',
                                 resp.read().decode())
        body = {"model": "lm", "inputs": ids.tolist()}
        for _ in range(4):
            code, out = _call(base, "/v1/predict", body)
            assert code == 200, out
            np.testing.assert_allclose(np.asarray(out["outputs"]), want,
                                       atol=ATOL, rtol=0)
        # generate: refused as the JAX mesh server refuses it (a
        # ServingError, 400; the reason in brackets names each
        # package's own proxy)
        code, out = _call(view[0]["url"], "/v1/generate",
                          {"model": "lm", "prompt": [1, 2], "n_tokens": 2})
        assert code == 400, out
        assert out["error"].split(" (")[0] == jax_refusal.split(" (")[0]
        # a follower dies: its rank 0 goes with it, a successor boots
        dead = view[0]
        os.kill(dead["pids"][1], signal.SIGKILL)
        t_end = time.monotonic() + GONE_S
        while _alive(dead["pids"][0]):
            assert time.monotonic() < t_end, "rank 0 outlived its follower"
            time.sleep(0.05)
        t_end = time.monotonic() + 90
        while True:
            view = fleet_view()
            if dead["id"] not in [r["id"] for r in view]:
                break
            assert time.monotonic() < t_end, "the replica was not replaced"
            time.sleep(0.2)
        assert len(view) == 2
        code, out = _call(base, "/v1/predict", body)
        assert code == 200, out
        np.testing.assert_allclose(np.asarray(out["outputs"]), want,
                                   atol=ATOL, rtol=0)
        proc.send_signal(signal.SIGINT)
        text, _ = proc.communicate(timeout=60)
    finally:
        try:                    # whatever failed, no rank outlives it
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(10)
    assert proc.returncode == 0 and "draining fleet" in text, text
    assert "mesh: every replica is tp=2 over 2 rank processes" in text
    assert len(pids) == 6
    assert not [p for p in pids if _alive(p)], "a rank outlived the fleet"
    # the drained ranks' own words: rank 0 drained, the follower ran the
    # forwards and was sent home
    follower = (logs / "replica-1-rank-1.log").read_text()
    assert "following the mesh's rank 0" in follower
    assert "kernel launches" in follower and "stopped" in follower


@pytest.mark.parametrize("spec,jax_says,port_says", [
    ("sp=2", "sp belongs to training", "dp/tp axes only"),
    ("dp=2,pp=2", None, "dp/tp axes only"),
    ("tp=two", None, "bad --mesh"),
])
def test_serve_fleet_mesh_refuses_what_jax_refuses(monkeypatch, spec,
                                                   jax_says, port_says):
    """A spec the JAX package's mesh server refuses exits before any
    replica boots."""
    from deeplearning4j_tpu.serving.http import ModelServer as JServer
    from deeplearning4j_tpu.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.cli import main

    def boot(*_a, **_k):
        raise AssertionError("a replica booted")

    monkeypatch.setattr(ReplicaFleet, "start", boot)
    reg = ModelRegistry()
    reg.register("lm", lm())
    with pytest.raises(Exception, match=jax_says):
        JServer(reg, mesh=spec)
    with pytest.raises(SystemExit) as e:
        main(["serve-fleet", "--model", "m.zip", "--replicas", "2",
              "--device", "cpu", "--mesh", spec])
    assert port_says in str(e.value)


def test_mesh_replica_spawns_a_rank_set():
    """A mesh replica's argv is ``serve --mesh`` on its port and device,
    one process a rank of the spec; a mesh fleet boots from model specs
    only."""
    r = MeshReplica(2, ["lm=/m/lm.zip"], 9124, "dp=2,tp=2",
                    extra_args=["--wait-ms", "1"], device="cpu")
    cmd = r.command()
    assert cmd[:4] == [sys.executable, "-m", "deeplearning4j_tpu_torch",
                       "serve"]
    assert cmd[cmd.index("--mesh") + 1] == "dp=2,tp=2"
    assert cmd[cmd.index("--port") + 1] == "9124"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert r.world == 4
    fleet = ReplicaFleet(model_specs=["lm=/m/lm.zip"], n=2, mesh="tp=2",
                         device="cpu")
    a, b = fleet._new_replica(), fleet._new_replica()
    assert isinstance(a, MeshReplica) and a.world == 2 and a.port != b.port
    with pytest.raises(ValueError, match="model_specs"):
        ReplicaFleet(lambda: {}, n=1, mesh="tp=2")


def test_mesh_fleet_candidate_boots_from_its_specs():
    """A mesh fleet's versions are model specs: a staged candidate's
    boot runs its ranks on the candidate's zip, at its version."""
    fleet = ReplicaFleet(model_specs=["lm=/m/v1.zip"], n=1, mesh="tp=2",
                         device="cpu")
    assert fleet.set_candidate(["lm=/m/v2.zip"]) == 2
    inc, cand = fleet._new_replica(), fleet._new_replica(version=2)
    assert inc.command()[inc.command().index("--model") + 1] == \
        "lm=/m/v1.zip"
    assert cand.command()[cand.command().index("--model") + 1] == \
        "lm=/m/v2.zip"
    assert (inc.model_version, cand.model_version) == (1, 2)


class _Sleepers(MeshReplica):
    """A rank set of sleeping processes: the replica's verbs without a
    server."""

    def command(self):
        return [sys.executable, "-c", "import time; time.sleep(120)"]


def _state(pid):
    import psutil
    return psutil.Process(pid).status()


def test_mesh_replica_hangs_dies_whole_and_reports(tmp_path):
    """``hang`` stops every rank for its delay and resumes them; when a
    rank exits unbidden the watcher kills the rest and calls
    ``on_exit``; ``kill`` reaps every rank."""
    import psutil
    import threading
    died = threading.Event()
    r = _Sleepers(0, ["lm=x.zip"], free_port(), "dp=1,tp=3",
                  device="cpu", log_dir=str(tmp_path),
                  on_exit=lambda rep: died.set()).start()
    try:
        assert len(r.pids) == 3
        assert sorted(os.listdir(tmp_path)) == [
            f"replica-0-rank-{i}.log" for i in range(3)]
        r.hang(1.0)
        t_end = time.monotonic() + 0.8
        while {_state(p) for p in r.pids} != {psutil.STATUS_STOPPED}:
            assert time.monotonic() < t_end, "the ranks did not stop"
            time.sleep(0.01)
        t_end = time.monotonic() + 10
        while {_state(p) for p in r.pids} == {psutil.STATUS_STOPPED}:
            assert time.monotonic() < t_end, "the ranks stayed stopped"
            time.sleep(0.05)
        threading.Thread(target=r._watch, daemon=True).start()
        os.kill(r.pids[2], signal.SIGKILL)
        assert died.wait(10), "on_exit was not called"
        assert not [p for p in r.pids if _alive(p)]
        assert r.fleet_state == "dead"
    finally:
        r.kill()
    r2 = _Sleepers(1, ["lm=x.zip"], free_port(), "tp=2", device="cpu",
                   on_exit=lambda rep: died.clear()).start()
    threading.Thread(target=r2._watch, daemon=True).start()
    r2.kill()                   # planned: no on_exit
    assert not [p for p in r2.pids if _alive(p)]
    time.sleep(3 * MeshReplica.POLL_S)
    assert died.is_set()


class _Served(MeshReplica):
    """A rank set whose rank 0 answers HTTP on the replica's port and
    whose other ranks sleep: a replica that boots without a model."""

    def command(self):
        return [sys.executable, "-c",
                "import http.server as h, os, sys, time\n"
                "if os.environ['DL4J_TPU_PROCESS_ID'] == '0':\n"
                "    h.HTTPServer(('127.0.0.1', int(sys.argv[1])),\n"
                "                 h.BaseHTTPRequestHandler).serve_forever()\n"
                "time.sleep(120)\n", str(self.port)]


def test_a_dead_rank_set_takes_its_chaos_proxy_and_is_regrown(monkeypatch):
    """Behind a network-chaos proxy, a replica whose follower dies goes
    whole: its ranks are reaped, it reads DEAD, its proxy port refuses
    connections, and the fleet grows a successor behind a proxy of its
    own."""
    import socket
    from deeplearning4j_tpu_torch.serving import fleet as fleet_mod
    monkeypatch.setattr(fleet_mod, "MeshReplica", _Served)
    fleet = ReplicaFleet(model_specs=["lm=x.zip"], n=1, mesh="tp=2",
                         device="cpu", net_chaos=[]).start()
    try:
        (r,) = fleet.snapshot()
        assert r.net_proxy is not None and r.port != r.upstream_port
        socket.create_connection((r.host, r.port), timeout=5).close()
        os.kill(r.pids[1], signal.SIGKILL)
        t_end = time.monotonic() + 30
        while [x.id for x in fleet.snapshot()] in ([r.id], []):
            assert time.monotonic() < t_end, "the replica was not regrown"
            time.sleep(0.05)
        (successor,) = fleet.snapshot()
        assert successor.net_proxy is not None
        assert r.fleet_state == "dead" and r.net_proxy is None
        assert not [p for p in r.pids if _alive(p)]
        with pytest.raises(ConnectionRefusedError):
            socket.create_connection((r.host, r.port), timeout=5)
    finally:
        fleet.stop(drain=False)
    assert not [p for p in successor.pids if _alive(p)]


def test_a_lost_rank_is_the_replicas_fault_not_the_requests():
    """gloo's bare RuntimeError for a peer that is gone becomes a
    DistError (which the layers pass through), and the mesh leader
    answers it as ServerClosedError (503: the router fails over)."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.collectives import (
        lost_rank_as_dist_error)
    from deeplearning4j_tpu_torch.serving import tp_backend
    from deeplearning4j_tpu_torch.serving.errors import ServerClosedError
    from deeplearning4j_tpu_torch.serving.http import _STATUS
    with pytest.raises(dist.DistError, match="closed by peer"):
        with lost_rank_as_dist_error():
            raise RuntimeError("Connection closed by peer")
    leader = object.__new__(tp_backend.TensorParallelModel)
    leader.index = 0

    def lost(t):
        with lost_rank_as_dist_error():
            raise RuntimeError("Connection closed by peer")

    leader._broadcast = lost
    with pytest.raises(ServerClosedError, match="lost a rank"):
        leader._run(np.zeros((1, T), np.float32))
    assert next(code for cls, code in _STATUS
                if issubclass(ServerClosedError, cls)) == 503
