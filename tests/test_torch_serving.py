"""The port's serving path (deeplearning4j_tpu_torch/serving) on the
CPU: ModelServer routes and error mapping, the dynamic-batching
scheduler, the ``serve`` CLI, and ``/v1/predict`` against the
in-process output and the JAX package's. Tolerance against JAX:
float32 on both sides, atol=2e-5, rtol=2e-4.
"""

import json
import os
import re
import shutil
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
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.cli import _parse_model_spec
from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ModelNotFoundError,
                                                     QueueFullError,
                                                     ServerClosedError)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.scheduler import BatchScheduler
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 2e-4
V, T = 32, 8


@pytest.fixture(scope="module")
def lm_zip(tmp_path_factory):
    b = (NeuralNetConfiguration.builder().set_seed(1).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=16)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=2, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    net = JaxNet(conf).init()
    path = str(tmp_path_factory.mktemp("serve") / "lm.zip")
    jser.write_model(net, path)
    return path, net


@pytest.fixture(scope="module")
def server(lm_zip):
    registry = ModelRegistry()
    registry.register("lm", restore_model(lm_zip[0], device="cpu"))
    s = ModelServer(registry, wait_ms=30.0).start()
    yield s
    s.stop()


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(0, V, (n, T)).astype(
        np.float32)


def _call(port, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


class _Gate:
    """A stub model whose output blocks until released."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def output(self, x):
        self.entered.set()
        assert self.release.wait(10)
        return np.asarray(x) * 2


def _post_async(port, body, results):
    t = threading.Thread(target=lambda: results.append(
        _call(port, "/v1/predict", body)))
    t.start()
    return t


def test_healthz_and_models(server):
    code, body, _ = _call(server.port, "/healthz")
    assert code == 200 and body["status"] == "ok"
    code, body, _ = _call(server.port, "/v1/models")
    assert code == 200
    assert [(m["name"], m["versions"]) for m in body["models"]] == [
        ("lm", [1])]


def test_predict_matches_in_process_and_jax(server, lm_zip):
    ids = _ids(2)
    code, body, _ = _call(server.port, "/v1/predict",
                          {"model": "lm", "inputs": ids.tolist()})
    assert code == 200 and body["model_version"] == 1
    out = np.asarray(body["outputs"], np.float32)
    assert out.shape == (2, T, V) and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    model, _ = server.registry.resolve("lm")
    np.testing.assert_allclose(out, model.output(ids).numpy(), atol=1e-7,
                               rtol=1e-6)
    np.testing.assert_allclose(out, np.asarray(lm_zip[1].output(ids)),
                               atol=ATOL, rtol=RTOL)


def test_concurrent_requests_are_coalesced(server):
    sched, _ = server.scheduler_for("lm")
    calls, rows = sched.device_calls, sched.rows_served
    ids = _ids(6, seed=1)
    barrier = threading.Barrier(6)
    got = [None] * 6

    def client(i):
        barrier.wait(10)
        got[i] = sched.predict(ids[i:i + 1], timeout=20)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sched.rows_served - rows == 6
    assert sched.device_calls - calls < 6       # coalesced
    model, _ = server.registry.resolve("lm")
    np.testing.assert_allclose(np.concatenate(got),
                               model.output(ids).numpy(), atol=1e-7,
                               rtol=1e-6)


@pytest.mark.parametrize("raw,body", [
    (b"{not json", None),
    (None, {"inputs": [[1.0]]}),
    (None, {"model": "lm"}),
    (None, {"model": "lm", "inputs": [["a", "b"]]}),
    (None, {"model": "lm", "inputs": [[1.0]], "timeout_ms": "soon"}),
])
def test_bad_request_is_400(server, raw, body):
    code, reply, _ = _call(server.port, "/v1/predict", body, raw=raw)
    assert code == 400 and "error" in reply


def test_unknown_model_is_404(server):
    code, reply, _ = _call(server.port, "/v1/predict",
                           {"model": "nope", "inputs": [[1.0]]})
    assert code == 404 and "nope" in reply["error"]
    code, _, _ = _call(server.port, "/v1/predict",
                       {"model": "lm", "version": 7, "inputs": [[1.0]]})
    assert code == 404
    assert _call(server.port, "/v1/nothing")[0] == 404
    assert _call(server.port, "/v1/nothing", {"a": 1})[0] == 404


def test_queue_full_is_429():
    gate = _Gate()
    reg = ModelRegistry()
    reg.register("m", gate)
    srv = ModelServer(reg, max_batch_size=1, queue_limit=1,
                      wait_ms=0.0).start()
    results = []
    try:
        first = _post_async(srv.port, {"model": "m", "inputs": [[1.0]]},
                            results)
        assert gate.entered.wait(10)
        sched, _ = srv.scheduler_for("m")
        second = _post_async(srv.port, {"model": "m", "inputs": [[2.0]]},
                             results)
        deadline = time.monotonic() + 10
        while sched.queue_depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        code, reply, headers = _call(srv.port, "/v1/predict",
                                     {"model": "m", "inputs": [[3.0]]})
        assert code == 429 and "limit" in reply["error"]
        assert int(headers["Retry-After"]) >= 1
        with pytest.raises(QueueFullError):
            sched.submit([[4.0]])
    finally:
        gate.release.set()
        first.join(10)
        second.join(10)
        srv.stop()
    assert sorted(r[1]["outputs"][0][0] for r in results) == [2.0, 4.0]


def test_expired_deadline_is_504():
    gate = _Gate()
    reg = ModelRegistry()
    reg.register("m", gate)
    srv = ModelServer(reg, max_batch_size=1, wait_ms=0.0).start()
    results = []
    try:
        first = _post_async(srv.port, {"model": "m", "inputs": [[1.0]]},
                            results)
        assert gate.entered.wait(10)
        threading.Timer(0.3, gate.release.set).start()
        code, reply, _ = _call(srv.port, "/v1/predict",
                               {"model": "m", "inputs": [[2.0]],
                                "timeout_ms": 50})
        assert code == 504 and "deadline" in reply["error"]
        first.join(10)
    finally:
        gate.release.set()
        srv.stop()
    assert results[0][0] == 200


def test_stop_drains_in_flight_work_and_refuses_new():
    gate = _Gate()
    reg = ModelRegistry()
    reg.register("m", gate)
    srv = ModelServer(reg, max_batch_size=1, wait_ms=0.0).start()
    port = srv.port
    results, stopped = [], []
    first = _post_async(port, {"model": "m", "inputs": [[1.0]]}, results)
    assert gate.entered.wait(10)
    sched, _ = srv.scheduler_for("m")
    queued = sched.submit([[5.0]])
    stopper = threading.Thread(target=lambda: stopped.append(srv.stop()))
    stopper.start()
    deadline = time.monotonic() + 10
    while not sched._draining.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    code, reply, headers = _call(port, "/v1/predict",
                                 {"model": "m", "inputs": [[2.0]]})
    assert code == 503 and "Retry-After" in headers
    assert srv.health_payload() == {"status": "draining"}
    with pytest.raises(ServerClosedError):
        sched.submit([[3.0]])
    gate.release.set()
    first.join(10)
    stopper.join(40)
    assert stopped == [True]
    assert results[0][0] == 200 and results[0][1]["outputs"] == [[2.0]]
    assert sched.wait(queued).tolist() == [[10.0]]


def test_poison_request_fails_alone():
    class Picky:
        def output(self, x):
            if np.isnan(x).any():
                raise ValueError("poison row")
            return x + 1

    sched = BatchScheduler(Picky(), max_batch_size=8, wait_ms=50.0)
    try:
        reqs = [sched.submit(np.array([[v]], np.float32))
                for v in (1.0, np.nan, 3.0)]
        assert sched.wait(reqs[0]).tolist() == [[2.0]]
        with pytest.raises(ValueError, match="poison"):
            sched.wait(reqs[1])
        assert sched.wait(reqs[2]).tolist() == [[4.0]]
        late = sched.submit(np.array([[1.0]]), timeout=-1.0)
        with pytest.raises(DeadlineExceededError):
            sched.wait(late)
    finally:
        assert sched.shutdown()


def test_registry_versions():
    reg = ModelRegistry()
    assert reg.register("a", "m1") == 1
    assert reg.register("a", "m2") == 2
    assert reg.resolve("a") == ("m2", 2) and reg.resolve("a", 1) == (
        "m1", 1)
    assert "a" in reg and "b" not in reg
    assert [m["serving_default"] for m in reg.models()] == [2]
    with pytest.raises(ModelNotFoundError):
        reg.resolve("a", 3)
    with pytest.raises(ModelNotFoundError):
        reg.resolve("b")


def test_parse_model_spec(tmp_path):
    assert _parse_model_spec("lm=x.zip") == ("lm", "x.zip")
    assert _parse_model_spec("x.zip") == ("default", "x.zip")
    odd = tmp_path / "run=3.zip"
    odd.write_bytes(b"")
    assert _parse_model_spec(str(odd)) == ("default", str(odd))


def test_cli_serves_and_drains_on_interrupt(lm_zip):
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--model", f"lm={lm_zip[0]}", "--device", "cpu", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)/", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server did not start"
        ids = _ids(1, seed=4)
        code, body, _ = _call(port, "/v1/predict",
                              {"model": "lm", "inputs": ids.tolist()})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["outputs"]),
                                   np.asarray(lm_zip[1].output(ids)),
                                   atol=ATOL, rtol=RTOL)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(30) == 0
        assert "draining" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import "
                         r"deeplearning4j_tpu\b(?!_torch)|from "
                         r"deeplearning4j_tpu\b(?!_torch))", re.M)
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "fleet_probe.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "deeplearning4j_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
