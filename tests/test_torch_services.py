"""The port's services, estimators and result wrappers against the JAX
package's: ``services/nearest_neighbors.py`` (the legacy ``/knn``,
``/knnindex``, ``/status`` wire and the ``serve-knn`` verb),
``services/streaming.py`` (brokers, the ndarray publisher and consumer,
``InferenceRoute``), ``ml/estimators.py`` and ``util/results.py``.

The k-NN answers are held against a float64 oracle and against a JAX
server on the same points: the same ids (ties as sets) and distances
within 1e-9. The streaming frames are the JAX package's byte for byte: a
JAX publisher and consumer talk to a port route through one broker. The
estimator's models are JAX's zips: a JAX ``NetworkModel.save`` loads in
the port with its normalizer and transforms within f32 tolerance; the
mesh fit runs as two gloo ranks (tests/torch_dp_worker.py).
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.services import nearest_neighbors as jnn
from deeplearning4j_tpu.services import streaming as jstream
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu.util import results as jres
from deeplearning4j_tpu_torch.services import nearest_neighbors as tnn
from deeplearning4j_tpu_torch.services import streaming as tstream
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util import results as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _oracle(pts, q, k):
    d = np.linalg.norm(np.asarray(pts, np.float64) - q[None, :], axis=1)
    return np.argsort(d, kind="stable")[:k], np.sort(d)[:k]


# ---------------------------------------------------------------- k-NN

@pytest.fixture(scope="module")
def knn_verb(tmp_path_factory):
    """The serve-knn verb on 200 points, started with the module's first
    k-NN test so that it boots while the others run."""
    tmp = tmp_path_factory.mktemp("verb")
    pts = np.random.default_rng(5).normal(size=(200, 8)).astype(np.float32)
    np.save(tmp / "p.npy", pts)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-knn",
         "--points", str(tmp / "p.npy"), "--port", "0", "--device", "cpu"],
        cwd=str(tmp), env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def knn(knn_verb):
    pts = np.random.default_rng(12).normal(size=(80, 6))
    port = tnn.NearestNeighborsServer(pts, port=0, distance="euclidean",
                                      device="cpu").start()
    jax = jnn.NearestNeighborsServer(pts, port=0,
                                     distance="euclidean").start()
    yield pts, port, jax
    port.stop()
    jax.stop()


def test_knn_answers_equal_the_oracle_and_jax(knn):
    pts, port, jax = knn
    client = tnn.NearestNeighborsClient(port=port.port)
    jclient = jnn.NearestNeighborsClient(port=jax.port)
    rng = np.random.default_rng(3)
    for q in [pts[13], pts[11] + 0.001] + list(rng.normal(size=(4, 6))):
        res, jres_ = client.knn(q, k=5), jclient.knn(q, k=5)
        assert set(res) == {"indices", "distances"}
        ids, dists = _oracle(pts, np.asarray(q), 5)
        assert set(res["indices"]) == set(ids.tolist())
        np.testing.assert_allclose(res["distances"], dists, atol=1e-9)
        assert res["distances"] == sorted(res["distances"])
        assert res["indices"] == jres_["indices"]
        np.testing.assert_allclose(res["distances"], jres_["distances"],
                                   atol=1e-9)
    # the legacy promise: an exact 0.0 self-distance
    res = client.knn_index(13, k=5)
    assert res["indices"][0] == 13 and res["distances"][0] == 0.0
    assert res == jclient.knn_index(13, k=5)
    with urllib.request.urlopen(f"http://127.0.0.1:{port.port}/status") \
            as r:
        assert json.loads(r.read()) == {"points": 80, "dims": 6}


def test_knn_validation_answers_as_jax(knn):
    pts, port, jax = knn
    for body, path in (({"vector": [1.0], "k": 3}, "/knn"),
                       ({"index": 999, "k": 3}, "/knnindex"),
                       ({"index": "x", "k": 3}, "/knnindex"),
                       ({"vector": pts[0].tolist(), "k": "lots"}, "/knn"),
                       ({}, "/nope")):
        got = _post(f"http://127.0.0.1:{port.port}", path, body)
        want = _post(f"http://127.0.0.1:{jax.port}", path, body)
        assert got == want, (path, body)
        assert got[0] in (400, 404)
    with pytest.raises(urllib.error.HTTPError):
        tnn.NearestNeighborsClient(port=port.port).knn([1.0, 2.0], k=3)


@pytest.mark.parametrize("length,code", [("-1", 400),
                                         (str((1 << 20) + 1), 413)])
def test_knn_bounds_the_body(knn, length, code):
    # the guard trips on the DECLARED length, before any read
    _, port, _ = knn
    conn = http.client.HTTPConnection("127.0.0.1", port.port, timeout=5.0)
    try:
        conn.putrequest("POST", "/knn")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        assert conn.getresponse().status == code
    finally:
        conn.close()


# ----------------------------------------------------------- streaming

def _conf():
    return (JaxBuilder.builder().updater(jupd.adam(0.05)).list()
            .layer(jl.DenseLayer(n_out=8, activation="relu"))
            .layer(jl.OutputLayer(n_out=3))
            .set_input_type(JIT.feed_forward(4)).build())


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    xs, ys = iris_data()
    jn = JNet(_conf()).init()
    jn.fit(xs[:120], ys[:120], epochs=20, batch_size=40)
    path = str(tmp_path_factory.mktemp("nets") / "iris.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def test_inference_route_in_process(nets):
    jn, tn = nets
    xs, _ = iris_data()
    broker = tstream.InProcessBroker()
    route = tstream.InferenceRoute(broker, tn, "in", "out").start()
    try:
        pub = tstream.NDArrayPublisher(broker, "in")
        sub = tstream.NDArrayConsumer(broker, "out")
        pub.publish(xs[:8])
        preds = sub.get(timeout=10)
        assert preds.shape == (8, 3)
        np.testing.assert_allclose(preds, tn.output(xs[:8]).numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(preds, np.asarray(jn.output(xs[:8])),
                                   atol=ATOL, rtol=RTOL)
        # the error path keeps the route alive
        err_q = broker.subscribe("out.errors")
        broker.publish("in", b"not an ndarray payload")
        assert "error" in json.loads(err_q.get(timeout=10))
        pub.publish(xs[8:12])
        assert sub.get(timeout=10).shape == (4, 3)
    finally:
        route.stop()


def test_socket_broker_pub_sub():
    srv = tstream.SocketBrokerServer()
    try:
        broker = tstream.SocketBroker(srv.host, srv.port)
        q = broker.subscribe("t1")
        broker.publish("t1", b"hello")
        broker.publish("t2", b"other-topic")
        broker.publish("t1", b"world")
        assert q.get(timeout=5) == b"hello"
        assert q.get(timeout=5) == b"world"
        assert q.empty()
    finally:
        srv.close()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_port_route_between_jax_clients_over_tcp(nets, server):
    """A JAX publisher and consumer, a port route: one wire, either
    package's broker server."""
    jn, tn = nets
    xs, _ = iris_data()
    srv = (jstream if server == "jax" else tstream).SocketBrokerServer()
    try:
        route = tstream.InferenceRoute(
            tstream.SocketBroker(srv.host, srv.port), tn, "features",
            "predictions").start()
        jbroker = jstream.SocketBroker(srv.host, srv.port)
        consumer = jstream.NDArrayConsumer(jbroker, "predictions")
        jstream.NDArrayPublisher(jbroker, "features").publish(
            xs[:4].astype(np.float32))
        preds = consumer.get(timeout=15)
        assert preds.shape == (4, 3)
        np.testing.assert_allclose(preds, np.asarray(jn.output(xs[:4])),
                                   atol=ATOL, rtol=RTOL)
        route.stop()
    finally:
        srv.close()
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    assert tstream._encode(a) == jstream._encode(a)
    np.testing.assert_array_equal(tstream._decode(jstream._encode(a)), a)


# ----------------------------------------------------------- estimators

def _estimator_factory():
    """The JAX estimator's network (``worker.estimator_conf`` is the
    same one through the port's builder)."""
    def conf_factory():
        return (JaxBuilder.builder().set_seed(0)
                .updater(jupd.adam(0.05)).list()
                .layer(jl.DenseLayer(n_out=12, activation="relu"))
                .layer(jl.OutputLayer(n_out=3))
                .set_input_type(JIT.feed_forward(4)).build())
    return conf_factory


def test_estimator_fit_transform_and_jax_models(tmp_path):
    from deeplearning4j_tpu.ml import NetworkEstimator as JEstimator
    from deeplearning4j_tpu_torch.ml import NetworkEstimator, NetworkModel
    xs, ys = iris_data()
    est = NetworkEstimator(worker.estimator_conf, epochs=100,
                           normalize=True, device="cpu")
    model = est.fit(xs[:120], ys[:120])
    probs = model.transform(xs[120:])
    assert isinstance(probs, np.ndarray) and probs.shape == (30, 3)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-4)
    assert model.score(xs[120:], ys[120:]) > 0.85
    np.testing.assert_array_equal(model.predict(xs[120:]),
                                  probs.argmax(-1))
    p = str(tmp_path / "model.zip")
    model.save(p)
    back = NetworkModel.load(p, device="cpu")
    np.testing.assert_allclose(back.transform(xs[120:]), probs, rtol=1e-5)
    # a JAX estimator's model, saved with its normalizer, in the port
    jmodel = JEstimator(_estimator_factory(), epochs=30,
                        normalize=True).fit(xs[:120], ys[:120])
    jp = str(tmp_path / "jax_model.zip")
    jmodel.save(jp)
    ported = NetworkModel.load(jp, device="cpu")
    np.testing.assert_allclose(ported.transform(xs[120:]),
                               jmodel.transform(xs[120:]),
                               atol=ATOL, rtol=RTOL)
    assert ported.score(xs[120:], ys[120:]) == \
        jmodel.score(xs[120:], ys[120:])
    # sklearn-style params, as JAX's
    assert est.get_params() == JEstimator(
        _estimator_factory(), epochs=100, normalize=True).get_params()
    est.set_params(epochs=7)
    assert est.epochs == 7
    with pytest.raises(ValueError, match="bogus"):
        est.set_params(bogus=1)


def test_estimator_mesh_fit_as_two_ranks(tmp_path):
    from deeplearning4j_tpu_torch.ml import NetworkEstimator
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    xs, ys = iris_data()
    np.savez(tmp_path / "estimator.npz", x=xs[:120], y=ys[:120],
             xt=xs[120:])
    worker.launch(2, tmp_path, ["estimator"])
    ranks = worker.load(tmp_path, "estimator", 2)
    np.testing.assert_array_equal(ranks[0]["flat"], ranks[1]["flat"])
    acc = (ranks[0]["probs"].argmax(-1) == ys[120:].argmax(-1)).mean()
    assert acc > 0.85
    # one process over the same global batches
    one = NetworkEstimator(worker.estimator_conf, epochs=60, batch_size=40,
                           mesh=build_mesh(MeshSpec(data=1)),
                           device="cpu").fit(xs[:120], ys[:120])
    np.testing.assert_allclose(ranks[0]["probs"], one.transform(xs[120:]),
                               atol=1e-3)


# -------------------------------------------------------------- results

def test_result_wrappers_equal_jax():
    probs = np.array([[0.8, 0.2], [0.3, 0.7], [0.5, 0.5]])
    for arg in (probs, torch.from_numpy(probs)):
        r, j = (tres.BinaryClassificationResult(arg),
                jres.BinaryClassificationResult(probs))
        np.testing.assert_array_equal(r.predicted(), j.predicted())
        assert r.probability_of(1) == j.probability_of(1)
    three = np.array([[0.1, 0.7, 0.2], [0.5, 0.2, 0.3]])
    r = tres.RankClassificationResult(torch.from_numpy(three),
                                      labels=["a", "b", "c"])
    j = jres.RankClassificationResult(three, labels=["a", "b", "c"])
    assert r.max_outcome(0) == "b" and r.ranked_classes(0) == ["b", "c", "a"]
    assert r.max_outcomes() == j.max_outcomes()
    assert tres.RankClassificationResult(three).labels == ["0", "1", "2"]


def test_serve_knn_verb_answers_and_stops_on_sigint(knn_verb):
    line = knn_verb.stdout.readline()
    port = int(re.search(r"on port (\d+) \(200 points, cpu\)",
                         line).group(1))
    res = tnn.NearestNeighborsClient(port=port).knn_index(7, k=3)
    assert res["indices"][0] == 7
    knn_verb.send_signal(signal.SIGINT)
    assert knn_verb.wait(timeout=30) == 0, knn_verb.stdout.read()
