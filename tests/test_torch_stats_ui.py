"""The port's training UI against the JAX package's: ``ui/stats.py``
(StatsReport, the storages, StatsListener), ``ui/convolutional.py``,
``ui/server.py`` (the dashboard and its routes), the ``storage=`` bridges
of the profiler and of the serving metrics, and the ``ui`` CLI verb.

The listener's histograms are ``np.histogram``'s counts exactly, held
bit for bit on values placed at and beside numpy's float32 edges and on
every report of a fit (against numpy on the same parameters). Against
the JAX listener on the same iris fit (weights crossing by zip), each
report's mean magnitudes, update:param ratios and learning rates agree
within 1e-5 relative (float32 steps summed in another order) and the
histograms' counts are equal. The stats files are one format: a JAX
file loads in the port's storage and the other way round. The server's
routes are the JAX server's cases (tests/test_ui_services.py,
tests/test_health.py, tests/test_request_tracing.py).
"""

import base64
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.ui import convolutional as jconv
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.observability.alerts import (AlertManager,
                                                           AlertRule)
from deeplearning4j_tpu_torch.observability.health import HealthMonitor
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry
from deeplearning4j_tpu_torch.observability.slo import (SLO, BurnWindow,
                                                        SLOMonitor)
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui import convolutional as tconv
from deeplearning4j_tpu_torch.ui import stats as tstats
from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.util import model_serializer as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


# ------------------------------------------------------------ histograms

def _edge_values(lo, hi, rng):
    """Values at, one ulp below and one ulp above each of numpy's
    float32 edges of [lo, hi], plus uniform draws, all within range."""
    lo, hi = np.float32(lo), np.float32(hi)
    edges = np.histogram_bin_edges(np.array([lo, hi], np.float32), 20)
    vals = [edges, rng.uniform(lo, hi, 500).astype(np.float32)]
    for e in edges:
        vals.append(np.nextafter(e, np.float32(np.inf)).reshape(1))
        vals.append(np.nextafter(e, np.float32(-np.inf)).reshape(1))
    x = np.concatenate(vals).astype(np.float32)
    return np.clip(x, lo, hi)


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-3.7e-4, 2.9e-4),
                                   (0.1, 0.30000001), (-1e6, 3.3e5),
                                   (2.5, 2.5)])
def test_histogram_counts_equal_numpy_at_the_edges(lo, hi):
    x = _edge_values(lo, hi, np.random.default_rng(int(abs(lo) * 7) + 1))
    want, edges = np.histogram(x, bins=20)
    # split over two tensors: a group's counts are those of the whole
    parts = [torch.from_numpy(x[:100]), torch.from_numpy(x[100:])]
    got = tstats.device_histograms([parts], [(x.min(), x.max())])[0]
    assert got["counts"] == want.tolist()
    assert (got["min"], got["max"]) == (float(edges[0]), float(edges[-1]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_card_histograms_equal_numpy_at_the_edges(card):
    """The same edge cases binned on the card, in one call (the division
    by a device scalar must stay a true float32 division there)."""
    cases = [(-1.0, 1.0), (-3.7e-4, 2.9e-4), (0.1, 0.30000001),
             (-1e6, 3.3e5), (2.5, 2.5)]
    xs = [_edge_values(lo, hi, np.random.default_rng(i))
          for i, (lo, hi) in enumerate(cases)]
    got = tstats.device_histograms(
        [[torch.from_numpy(x).to(card)] for x in xs],
        [(x.min(), x.max()) for x in xs])
    for x, h in zip(xs, got):
        assert h["counts"] == np.histogram(x, bins=20)[0].tolist()


def test_a_range_that_is_not_finite_raises_as_numpy_does():
    x = torch.tensor([0.0, float("nan")])
    with pytest.raises(ValueError, match="not finite"):
        tstats.device_histograms([[x]], [(0.0, float("nan"))])


# --------------------------------------------- the listener against JAX

def _conf(sched=None, lr=0.05):
    upd = (jupd.sgd(0.1, schedule=sched) if sched else jupd.adam(lr))
    return (JaxBuilder.builder().updater(upd).list()
            .layer(jl.DenseLayer(n_out=8, activation="relu"))
            .layer(jl.OutputLayer(n_out=3))
            .set_input_type(JIT.feed_forward(4)).build())


class _Snap(TrainingListener):
    """Host copies of the parameters at each reporting iteration (runs
    before the StatsListener in the chain)."""

    def __init__(self):
        self.params = []

    def iteration_done(self, model, iteration, score, batch_size):
        self.params.append({f"{i}_{k}": p.detach().cpu().numpy().ravel().copy()
                            for i, lp in enumerate(model.params)
                            for k, p in lp.items()})


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The same iris fit in both packages (weights by zip), a
    StatsListener at frequency 1 on each; and a scheduled-LR fit."""
    tmp = tmp_path_factory.mktemp("stats")
    xs, ys = iris_data()
    out = {}
    for name, conf, kw in (("adam", _conf(), dict(epochs=4, batch_size=40)),
                           ("sched", _conf({"type": "step",
                                            "decay_rate": 0.5, "step": 2}),
                            dict(epochs=6, batch_size=120))):
        jn = JNet(conf).init()
        path = str(tmp / f"{name}.zip")
        jser.write_model(jn, path)
        tn = tser.restore_model(path, device="cpu")
        js, ts = jstats.InMemoryStatsStorage(), tstats.InMemoryStatsStorage()
        snap = _Snap()
        jn.set_listeners(jstats.StatsListener(js, frequency=1,
                                              session_id="s1"))
        tn.set_listeners(snap, tstats.StatsListener(ts, frequency=1,
                                                    session_id="s1"))
        jn.fit(xs[:120], ys[:120], **kw)
        tn.fit(xs[:120], ys[:120], **kw)
        out[name] = (js, ts, snap, tn)
    # the ui verb over the port's stats file, started here so that it
    # boots while the module's other tests run
    path = str(tmp / "stats.jsonl")
    store = tstats.FileStatsStorage(path)
    for u in out["adam"][1].get_all_updates("s1"):
        store.put_update(u)
    out["verb"] = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "ui", "--port",
         "0", "--stats-file", path], cwd=str(tmp),
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield out
    if out["verb"].poll() is None:
        out["verb"].kill()
        out["verb"].wait()


def test_reports_follow_the_jax_listener(fits):
    js, ts, _, _ = fits["adam"]
    assert ts.list_session_ids() == js.list_session_ids() == ["s1"]
    jups, tups = js.get_all_updates("s1"), ts.get_all_updates("s1")
    assert [u.iteration for u in tups] == [u.iteration for u in jups]
    assert len(tups) >= 4
    for j, t in zip(jups, tups):
        assert t.score == pytest.approx(j.score, rel=RTOL)
        assert t.learning_rate == pytest.approx(j.learning_rate)
        for field in ("param_mean_magnitudes", "update_mean_magnitudes",
                      "update_ratios"):
            a, b = getattr(t, field), getattr(j, field)
            assert list(a) == list(b), field
            np.testing.assert_allclose(list(a.values()), list(b.values()),
                                       rtol=RTOL, err_msg=field)
        assert list(t.histograms) == list(j.histograms)
        for key, h in t.histograms.items():
            assert h["counts"] == j.histograms[key]["counts"], key
            assert h["min"] == pytest.approx(j.histograms[key]["min"],
                                             rel=RTOL, abs=1e-7)
    last = tups[-1]
    assert set(last.update_ratios) == {"0", "1"}
    assert all(0 < v < 1.0 for v in last.update_ratios.values())
    assert "all" in last.update_mean_magnitudes
    assert "update/all" in last.histograms


def test_every_histogram_is_numpys_on_the_same_parameters(fits):
    _, ts, snap, _ = fits["adam"]
    ups = ts.get_all_updates("s1")
    assert len(snap.params) == len(ups)
    for i, (u, params) in enumerate(zip(ups, snap.params)):
        for name, arr in params.items():
            counts, _ = np.histogram(arr, bins=20)
            assert u.histograms[f"param/{name}"]["counts"] == \
                counts.tolist()
            assert u.param_mean_magnitudes[name] == pytest.approx(
                float(np.mean(np.abs(arr))), rel=RTOL)
        if i:
            prev = snap.params[i - 1]
            upd = np.concatenate([params[n] - prev[n] for n in params])
            counts, _ = np.histogram(upd, bins=20)
            assert u.histograms["update/all"]["counts"] == counts.tolist()


def test_scheduled_lr_is_reported_as_jax_reports_it(fits):
    js, ts, _, _ = fits["sched"]
    jl_ = [u.learning_rate for u in js.get_all_updates("s1")]
    tl = [u.learning_rate for u in ts.get_all_updates("s1")]
    np.testing.assert_allclose(tl, jl_, rtol=1e-7)
    assert tl[0] == pytest.approx(0.1) and tl[-1] < tl[0]


# ------------------------------------------------------------ the storage

_GOLDEN = dict(
    session_id="sess", worker_id="w7", iteration=42,
    timestamp=123.25, score=0.625,
    param_mean_magnitudes={"0_W": 0.5},
    gradient_mean_magnitudes={"0_W": 0.25},
    update_mean_magnitudes={"0": 0.125},
    update_ratios={"0": 1e-3},
    learning_rate=0.01,
    histograms={"param/0_W": {"min": -1.0, "max": 1.0,
                              "counts": [1, 2, 3]}},
    activation_images={"conv0": "aGVsbG8="},
    duration_ms=12.5, samples_per_sec=800.0,
    memory_bytes=1024,
    profile={"data_wait_ms": 1.5, "mfu": 0.42},
    gradient_norm=3.5, update_norm=0.007, param_norm=11.0,
    health={"finite_bits": 0, "worst_dead_fraction": 0.125},
)


def test_report_fields_and_json_are_jaxs():
    assert [f.name for f in dataclasses.fields(tstats.StatsReport)] == \
        [f.name for f in dataclasses.fields(jstats.StatsReport)]
    assert set(_GOLDEN) == {f.name for f in
                            dataclasses.fields(tstats.StatsReport)}
    assert tstats.StatsReport(**_GOLDEN).to_json() == \
        jstats.StatsReport(**_GOLDEN).to_json()
    d = dict(_GOLDEN, some_future_field={"x": 1})
    r = tstats.StatsReport.from_json(json.dumps(d))
    assert r.iteration == 42 and r.health["finite_bits"] == 0
    with pytest.raises(ValueError):
        tstats.StatsReport.from_json("[1, 2]")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stats_files_load_in_either_package(tmp_path, fits, writer):
    path = str(tmp_path / "stats.jsonl")
    src_pkg, dst_pkg = ((jstats, tstats) if writer == "jax"
                        else (tstats, jstats))
    store = src_pkg.FileStatsStorage(path)
    store.put_update(src_pkg.StatsReport(**_GOLDEN))
    ups = fits["adam"][1 if writer == "port" else 0].get_all_updates("s1")
    for u in ups:
        store.put_update(src_pkg.StatsReport(**dataclasses.asdict(u)))
    back = dst_pkg.FileStatsStorage(path)
    assert dataclasses.asdict(back.get_latest_update("sess")) == _GOLDEN
    assert [dataclasses.asdict(u) for u in back.get_all_updates("s1")] == \
        [dataclasses.asdict(u) for u in ups]


# ----------------------------------------------------------- the listeners

def _conv_pair(tmp_path):
    conf = (JaxBuilder.builder().updater(jupd.adam(0.01)).list()
            .layer(jl.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                       activation="relu"))
            .layer(jl.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(jl.DenseLayer(n_out=8, activation="relu"))
            .layer(jl.OutputLayer(n_out=3))
            .set_input_type(JIT.convolutional_flat(8, 8, 1)).build())
    jn = JNet(conf).init()
    path = str(tmp_path / "conv.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def test_convolutional_listener_images(tmp_path):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    assert tconv.encode_png_gray(img) == jconv.encode_png_gray(img)
    act = np.random.default_rng(0).normal(size=(6, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(tconv.tile_channels(act),
                                  jconv.tile_channels(act))
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, (16, 64)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jn, tn = _conv_pair(tmp_path)
    stores = []
    for net, pkg, conv in ((jn, jstats, jconv), (tn, tstats, tconv)):
        storage = pkg.InMemoryStatsStorage()
        net.set_listeners(conv.ConvolutionalIterationListener(
            storage, xs[:1], frequency=1, session_id="conv"))
        net.fit(xs, ys, epochs=2, batch_size=16)
        stores.append(storage.get_all_updates("conv"))
    jups, tups = stores
    assert [u.iteration for u in tups] == [u.iteration for u in jups]
    for j, t in zip(jups, tups):
        assert list(t.activation_images) == list(j.activation_images)
        for b64 in t.activation_images.values():
            assert base64.b64decode(b64).startswith(b"\x89PNG")


def _mlp_pair(tmp_path):
    jn = JNet(_conf()).init()
    path = str(tmp_path / "mlp.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def test_profiler_reports_flow_into_stats_storage(tmp_path):
    from deeplearning4j_tpu_torch.observability.step_profile import (
        ProfilerListener)
    _, tn = _mlp_pair(tmp_path)
    storage = tstats.InMemoryStatsStorage()
    p = ProfilerListener(frequency=2, storage=storage, session_id="prof",
                         report=False)
    tn.set_listeners(p)
    xs, ys = iris_data()
    tn.fit(xs[:96], ys[:96], epochs=2, batch_size=16)
    reports = storage.get_all_updates("prof")
    assert reports and len(reports) == len(p.reports)
    assert reports[-1].profile == p.reports[-1]
    assert reports[-1].profile["dispatch_ms"] > 0
    assert reports[-1].samples_per_sec > 0


def test_serving_metrics_publish_to_stats_storage():
    from deeplearning4j_tpu.serving.metrics import (
        ServingMetrics as JServingMetrics)
    from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
    got = []
    for metrics, pkg in ((JServingMetrics(), jstats),
                         (ServingMetrics(), tstats)):
        ep = metrics.endpoint("predict")
        ep.observe(0.004)
        ep.observe(0.006)
        storage = pkg.InMemoryStatsStorage()
        metrics.publish_to(storage, session_id="serving")
        metrics.publish_to(storage, session_id="serving")
        got.append(storage.get_all_updates("serving"))
    for j, t in zip(*got):
        assert (t.iteration, t.score, t.duration_ms, t.worker_id) == \
            (j.iteration, j.score, j.duration_ms, j.worker_id)
    assert got[1][-1].iteration == 2 and got[1][-1].score == 2.0
    assert got[1][-1].duration_ms > 0


# --------------------------------------------------------------- the server

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _post(url, data):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def server():
    s = UIServer(port=0)
    s.start()
    yield s, f"http://127.0.0.1:{s.port}"
    s.stop()


def test_dashboard_routes_serve_what_jax_serves(server, fits):
    s, base = server
    s.attach(fits["adam"][1])
    code, page = _get(base + "/")
    assert code == 200 and page == jserver._PAGE
    assert json.loads(_get(base + "/api/sessions")[1]) == ["s1"]
    ups = json.loads(_get(base + "/api/updates?session=s1")[1])
    assert ups == [dataclasses.asdict(u)
                   for u in fits["adam"][1].get_all_updates("s1")]
    # the latest session without ?session=
    assert json.loads(_get(base + "/api/updates")[1]) == ups
    report = tstats.StatsReport(session_id="remote", worker_id="w9",
                                iteration=1, timestamp=0.0, score=1.5,
                                gradient_norm=2.5,
                                health={"finite_bits": 0})
    code, doc = _post(base + "/api/remote", report.to_json().encode())
    assert code == 200 and doc == {"ok": True}
    assert "remote" in json.loads(_get(base + "/api/sessions")[1])
    back = json.loads(_get(base + "/api/updates?session=remote")[1])
    assert back[0]["gradient_norm"] == 2.5
    assert back[0]["health"] == {"finite_bits": 0}
    assert _post(base + "/nope", b"{}")[0] == 404
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nope")


def test_bad_posts_are_400s(server):
    _, base = server
    code, doc = _post(base + "/api/remote", b"{not json!")
    assert code == 400 and "bad request" in doc["error"]
    assert _post(base + "/api/remote", b'{"score": 1}')[0] == 400
    assert _post(base + "/api/tsne", b"[1, 2, 3]")[0] == 400
    small = UIServer(port=0, max_body_bytes=64)
    small.start()
    try:
        code, doc = _post(f"http://127.0.0.1:{small.port}/api/remote",
                          b'{"x": "' + b"a" * 500 + b'"}')
        assert code == 400 and "too large" in doc["error"]
    finally:
        small.stop()


def test_health_panel(server):
    s, base = server
    assert json.loads(_get(base + "/api/health")[1]) == {
        "status": "ok", "alerts": [], "monitor": None}
    reg = MetricsRegistry()
    am = AlertManager(reg, rules=[AlertRule(name="loss_stuck", metric="g",
                                            threshold=1.0)])
    mon = HealthMonitor(policy="warn")
    mon.iteration_done(types.SimpleNamespace(), 4, float("nan"), 8)
    s.attach_health(monitor=mon, alerts=am)
    doc = json.loads(_get(base + "/api/health")[1])
    assert doc["status"] == "degraded"
    assert doc["monitor"]["anomaly_count"] == 1
    reg.gauge("g").set(5.0)
    doc = json.loads(_get(base + "/api/health")[1])
    assert doc["alerts"][0]["name"] == "loss_stuck"


def test_health_payload_degrades_on_an_slo_breach():
    reg = MetricsRegistry()
    h = reg.histogram("serving_latency_seconds", help="t",
                      labels={"endpoint": "predict"})
    clock = [0.0]
    mon = SLOMonitor(
        reg, [SLO(name="ui_slo", objective=0.9, threshold_s=0.05,
                  labels={"endpoint": "predict"}, window_s=60.0,
                  windows=[BurnWindow(short_s=5.0, long_s=10.0,
                                      factor=2.0)])],
        clock=lambda: clock[0], min_eval_interval_s=0.0)
    ui = UIServer(port=0)
    ui.attach_health(slos=mon)
    payload = ui.health_payload()
    assert payload["status"] == "ok" and payload["slos"][0]["name"] == \
        "ui_slo"
    for _ in range(20):
        h.record(0.01)
    clock[0] = 1.0
    mon.evaluate()
    for _ in range(20):
        h.record(0.5)
    clock[0] = 2.0
    payload = ui.health_payload()
    assert payload["status"] == "degraded" and payload["slos"][0]["breached"]


def test_tsne_and_activation_routes(server, monkeypatch):
    s, base = server
    pts = [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    code, doc = _post(base + "/api/tsne", json.dumps(
        {"points": pts, "labels": [0, 1, 0]}).encode())
    assert code == 200 and doc["ok"]
    assert json.loads(_get(base + "/api/tsne")[1]) == {
        "points": pts, "labels": [0, 1, 0]}
    png = base64.b64encode(tconv.encode_png_gray(
        np.zeros((4, 4), np.uint8))).decode()
    s.storage.put_update(tstats.StatsReport(
        session_id="s", worker_id="w", iteration=0, timestamp=0.0,
        score=1.0, activation_images={"layer_0": png}))
    assert json.loads(_get(base + "/api/activations")[1]) == \
        {"layer_0": png}
    # 2-d points go up as they are; wider ones through the port's
    # Barnes-Hut t-SNE (clustering/tsne.py, held against JAX's in
    # tests/test_torch_clustering_trees.py), stubbed here for its time
    s.upload_tsne(np.asarray(pts), labels=np.array([1, 0, 1]))
    assert s._tsne == {"points": pts, "labels": [1, 0, 1]}
    from deeplearning4j_tpu_torch.clustering import tsne
    seen = []

    class Tsne:
        def __init__(self, n_components):
            seen.append(n_components)

        def fit_transform(self, data):
            seen.append(data.shape)
            return data[:, :2] * 2
    monkeypatch.setattr(tsne, "BarnesHutTsne", Tsne)
    wide = np.arange(30, dtype=np.float32).reshape(3, 10)
    s.upload_tsne(wide)
    assert seen == [2, (3, 10)]
    assert s._tsne == {"points": (wide[:, :2] * 2).tolist(),
                       "labels": None}


@pytest.mark.parametrize("graph", [False, True])
def test_flow_view_equals_jax(tmp_path, graph):
    from deeplearning4j_tpu.models.computation_graph import (
        ComputationGraph as JGraph)
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    if graph:
        g = (JaxBuilder.builder().set_seed(0).updater(jupd.adam(0.01))
             .graph_builder().add_inputs("in")
             .add_layer("a", jl.DenseLayer(n_out=4, activation="relu"),
                        "in")
             .add_layer("b", jl.DenseLayer(n_out=4, activation="relu"),
                        "in")
             .add_vertex("m", MergeVertex(), "a", "b")
             .add_layer("out", jl.OutputLayer(n_out=3), "m")
             .set_outputs("out")
             .set_input_types(JIT.feed_forward(4)).build())
        jn = JGraph(g).init()
        path = str(tmp_path / "g.zip")
        jser.write_model(jn, path)
        tn = tser.restore_model(path, device="cpu")
    else:
        jn, tn = _mlp_pair(tmp_path)
    js, ts = jserver.UIServer(port=0), UIServer(port=0)
    js.attach_model(jn)
    ts.attach_model(tn)
    assert ts._flow == js._flow
    if graph:
        rows = {n["name"]: n["row"] for n in ts._flow["nodes"]}
        assert rows == {"in": 0, "a": 1, "b": 1, "m": 2, "out": 3}


def test_get_instance_is_one_server():
    s = UIServer.get_instance(port=0)
    try:
        assert UIServer.get_instance() is s and s.port > 0
    finally:
        s.stop()
    assert UIServer._instance is None


def test_ui_verb_serves_a_stats_file_and_stops_on_sigint(fits):
    proc = fits["verb"]
    line = proc.stdout.readline()
    port = int(re.search(r"localhost:(\d+)/", line).group(1))
    assert json.loads(_get(f"http://127.0.0.1:{port}/api/sessions")[1]) \
        == ["s1"]
    proc.send_signal(signal.SIGINT)
    assert proc.wait(timeout=30) == 0, proc.stdout.read()
