"""``ModelServer.evict_model``: a swapped-out version's backends go.

Mirrors ``tests/test_serving.py::TestModelServer::test_version_swap_in``
and ``tests/test_rollout.py::TestVersionMetricsEviction`` on the port,
plus a generate batcher: its worker thread stops and its model and
session (the page pool, and on a card the captured step graph) are
freed, while the other version keeps answering.
"""

import gc
import json
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (EmbeddingSequenceLayer,
                                                     RnnOutputLayer,
                                                     TransformerEncoderLayer)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry


class EchoModel:
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
        return e.code, json.loads(e.read().decode() or "{}")


def _series(server, endpoint):
    return [m for m in server.metrics.registry.collect()
            if m.labels and m.labels.get("endpoint") == endpoint]


@pytest.fixture
def server():
    registry = ModelRegistry()
    registry.register("m", EchoModel())
    s = ModelServer(registry, wait_ms=1.0).start()
    yield s
    s.stop(drain=False)


def test_version_swap_in_then_evict(server):
    base = f"http://{server.host}:{server.port}"
    server.registry.register("m", EchoModel())
    st, body = _post(base, "/v1/predict", {"model": "m",
                                           "inputs": [[1.0, 2.0]]})
    assert st == 200 and body["model_version"] == 2
    st, body = _post(base, "/v1/predict", {"model": "m", "version": 1,
                                           "inputs": [[1.0, 2.0]]})
    assert st == 200 and body["model_version"] == 1
    assert ("m", 1) in server._schedulers
    thread = server._schedulers[("m", 1)]._worker
    assert server.evict_model("m", version=1)
    assert ("m", 1) not in server._schedulers
    assert ("m", 2) in server._schedulers
    assert not thread.is_alive()
    gauges = server.metrics.snapshot()["gauges"]
    assert "predict/m/v1_queue_depth" not in gauges
    assert "predict/m/v2_queue_depth" in gauges


def test_evicted_version_drops_its_series(server):
    base = f"http://{server.host}:{server.port}"
    for _ in range(3):
        _post(base, "/v1/predict", {"model": "m", "inputs": [[1.0]]})
    server.registry.register("m", EchoModel())
    for _ in range(3):
        _post(base, "/v1/predict", {"model": "m", "inputs": [[1.0]]})
    assert _series(server, "predict/m/v1")
    assert _series(server, "predict/m/v2")
    server.registry.unregister("m", version=1)
    assert server.evict_model("m", version=1, drain=True, timeout=5.0)
    assert not _series(server, "predict/m/v1")
    assert _series(server, "predict/m/v2")
    st, body = _post(base, "/v1/predict", {"model": "m", "inputs": [[1.0]]})
    assert st == 200 and body["model_version"] == 2


def test_evict_of_every_version_and_of_nothing(server):
    base = f"http://{server.host}:{server.port}"
    server.registry.register("m", EchoModel())
    for v in (1, 2):
        _post(base, "/v1/predict", {"model": "m", "version": v,
                                    "inputs": [[1.0]]})
    assert server.evict_model("m")            # every version of "m"
    assert not server._schedulers
    assert server.evict_model("nope")         # nothing to evict
    st, _ = _post(base, "/v1/predict", {"model": "m", "inputs": [[1.0]]})
    assert st == 200                          # rebuilt on demand


def _lm(seed):
    V = 16
    conf = (NeuralNetConfiguration.builder().set_seed(seed).list()
            .layer(EmbeddingSequenceLayer(n_in=V, n_out=16))
            .layer(TransformerEncoderLayer(n_heads=2, causal=True))
            .layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, 32)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_evicting_a_generate_batcher_frees_its_session():
    registry = ModelRegistry()
    v1 = _lm(0)
    registry.register("lm", v1)
    registry.register("lm", _lm(1))
    model = weakref.ref(v1)
    del v1
    server = ModelServer(registry, slots=2, capacity=32, kv_mode="paged",
                         page_size=4).start()
    base = f"http://{server.host}:{server.port}"
    try:
        outs = {}
        for v in (1, 2):
            st, body = _post(base, "/v1/generate",
                             {"model": "lm", "version": v,
                              "prompt": [1, 2, 3], "n_tokens": 4})
            assert st == 200 and body["model_version"] == v
            outs[v] = body["ids"]
        batcher = server._batchers[("lm", 1)]
        thread, session = batcher._worker, weakref.ref(batcher.session)
        pool = weakref.ref(batcher.session._pools[1]["k"])
        del batcher
        registry.unregister("lm", version=1)
        assert server.evict_model("lm", version=1, timeout=10.0)
        assert ("lm", 1) not in server._batchers
        assert not thread.is_alive()
        gc.collect()
        assert session() is None and pool() is None and model() is None
        assert not _series(server, "generate/lm/v1")
        st, body = _post(base, "/v1/generate",
                         {"model": "lm", "prompt": [1, 2, 3],
                          "n_tokens": 4})
        assert st == 200 and body["model_version"] == 2
        assert body["ids"] == outs[2]
    finally:
        server.stop(drain=False)
