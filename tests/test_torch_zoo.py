"""The rest of the model zoo, every layer type, transfer learning, the
pretrained-weights manifest and the smoke's FLOP counter, against the
JAX package on the CPU.

- Every ``@type`` the JAX package's layers export loads in the port.
- AlexNet, GoogLeNet, InceptionResNetV1, FaceNetNN4Small2, Darknet19,
  TinyYOLO and UNet at ``tests/zoo_golden_spec.py``'s sizes: a zip the
  JAX package writes restores in the port and its forward is within
  atol=1e-5, rtol=1e-4 of the JAX package's and of
  ``tests/fixtures/zoo_goldens.npz``.
- One nesterovs fit step of the center-loss, YOLO and UNet models: the
  loss, the gradients, the params and the state (batch-norm statistics
  and the centers) held to JAX's. Batch norm over few values a channel
  amplifies f32 rounding, so each leaf's tolerance is derived as in
  ``tests/test_torch_graph.py``: 8x the JAX step's own largest
  difference over two reorderings of the batch rows, plus 1e-5 of the
  leaf's largest value.
- A zip holding every layer type this slice brings crosses both ways.
- Transfer learning mirrors the JAX package's tests: config JSON equal
  to JAX's, frozen params bit-equal after fine-tuning.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JaxNet)
from deeplearning4j_tpu.nn import transfer_learning as jtl
from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.layers.base import (
    LAYER_REGISTRY as JAX_REGISTRY)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn import transfer_learning as ttl
from deeplearning4j_tpu_torch.nn.conf import graph as tgraph
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (FrozenLayer,
                                                     LAYER_REGISTRY,
                                                     layer_from_dict)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import (params_from_jax,
                                                            restore_model,
                                                            write_model)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import zoo_golden_spec as spec  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
NEW_MODELS = ["alexnet", "googlenet", "inception_resnet_v1",
              "facenet_nn4_small2", "darknet19", "tinyyolo", "unet"]


def _np(a):
    return np.asarray(a, np.float32)


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            jser._flatten_with_paths(tree).items()}


def _tflat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in tser._flatten(tree).items()}


def _port_of(jn):
    """The port net of ``jn``'s config JSON with ``jn``'s params and
    state, on the CPU."""
    graph = isinstance(jn, JaxGraph)
    conf = (ComputationGraphConfiguration if graph
            else MultiLayerConfiguration).from_json(jn.conf.to_json())
    tn = (ComputationGraph if graph else MultiLayerNetwork)(
        conf, device="cpu").init()
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    tn.state = params_from_jax(jax.device_get(jn.state), device="cpu")
    tn._build_optimizer()
    return tn


# -------------------------------------------------------- layer types

@pytest.mark.parametrize("name", sorted(
    n for n in jl.__all__ if n in JAX_REGISTRY))
def test_every_jax_layer_type_loads_in_the_port(name):
    kw = ({"inner": jl.DenseLayer(n_out=3)} if name == "FrozenLayer"
          else {})
    d = JAX_REGISTRY[name](**kw).to_dict()
    assert name in LAYER_REGISTRY
    assert layer_from_dict(d).to_dict() == d


# ---------------------------------------------------------- forwards

_JAX_NETS = {}


def _jax_zoo(key):
    """The JAX zoo model of golden spec ``key`` (seed 123), built once."""
    if key not in _JAX_NETS:
        cls, kw, _ = spec.SPECS[key]
        _JAX_NETS[key] = getattr(jzoo, cls)(**kw).init()
    return _JAX_NETS[key]


@pytest.fixture(scope="module")
def goldens():
    return np.load(os.path.join(HERE, "fixtures", "zoo_goldens.npz"))


@pytest.mark.parametrize("key", NEW_MODELS)
def test_new_zoo_forward_through_a_jax_zip_matches_jax(key, goldens,
                                                       tmp_path):
    jn = _jax_zoo(key)
    path = str(tmp_path / f"{key}.zip")
    jser.write_model(jn, path)
    tn = restore_model(path, device="cpu")
    assert type(tn).__name__ == type(jn).__name__
    x = spec.make_input(key, spec.SPECS[key][2])
    out = tn.output(x).numpy()
    np.testing.assert_allclose(out, _np(jn.output(x)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, goldens[key], atol=ATOL, rtol=RTOL)
    cls, kw, _ = spec.SPECS[key]
    assert tn.conf.to_json() == getattr(tzoo, cls)(**kw).conf().to_json()


# ----------------------------------------------------------- fit step

FIT_B = 4
FIT_MODELS = {  # golden key -> (classes of the labels, kind)
    "inception_resnet_v1": "classes", "facenet_nn4_small2": "classes",
    "tinyyolo": "yolo", "unet": "mask"}


def _yolo_labels(rng, shape, n_anchors, n_classes):
    """One object an image at a random cell and anchor."""
    t = np.zeros(shape, np.float32)
    depth = 5 + n_classes
    for i in range(shape[0]):
        gx, gy = rng.integers(0, shape[1], 2)
        base = rng.integers(0, n_anchors) * depth
        t[i, gy, gx, base:base + 2] = rng.random(2)
        t[i, gy, gx, base + 2:base + 4] = 0.5 + rng.random(2)
        t[i, gy, gx, base + 4] = 1.0
        t[i, gy, gx, base + 5 + rng.integers(0, n_classes)] = 1.0
    return t


def zoo_batch(key, out_shape, seed=0):
    """(x, labels) of FIT_B rows for golden model ``key`` whose output
    rows have ``out_shape``."""
    cls, kw, shape = spec.SPECS[key]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((FIT_B,) + tuple(shape)).astype(np.float32)
    kind = FIT_MODELS[key]
    if kind == "classes":
        y = np.eye(kw["n_classes"], dtype=np.float32)[
            rng.integers(0, kw["n_classes"], FIT_B)]
    elif kind == "mask":
        y = (rng.random((FIT_B,) + tuple(out_shape)) > 0.5).astype(
            np.float32)
    else:
        y = _yolo_labels(rng, (FIT_B,) + tuple(out_shape), 5,
                         kw["n_classes"])
    return x, y


def _jax_step(jn, p0, s0, x, y):
    """(loss, grads, params, state) of one JAX fit step from p0, s0."""
    jn.params = jax.tree_util.tree_map(jnp.asarray, p0)
    jn.state = jax.tree_util.tree_map(jnp.asarray, s0)
    jn.opt_state = jn._optimizer.init(jn.params)
    graph = isinstance(jn, JaxGraph)
    batch = (((jnp.asarray(x),), (jnp.asarray(y),), None, None) if graph
             else (jnp.asarray(x), jnp.asarray(y), None, None))
    grads = jax.jit(jax.grad(lambda p, s, b: jn._loss(p, s, b, None)[0]))(
        jn.params, jn.state, batch)
    jn.fit(JaxDataSet(x, y))
    return (float(jn.score_value), _flat(grads), _flat(jn.params),
            _flat(jn.state))


def _port_step(jn, x, y):
    """(loss, grads, params, state) of one port fit step from ``jn``'s
    params and state."""
    tn = _port_of(jn)
    ds = DataSet(x, y)
    batch = tn._batch_tuple(tn._as_multi(ds) if isinstance(
        tn, ComputationGraph) else ds)
    _, grads, _ = tn._gradients(batch)
    tn.fit(ds)
    return (float(tn.score_value), _tflat(grads), _tflat(tn.params),
            _tflat(tn.state))


@pytest.mark.parametrize("key", sorted(FIT_MODELS))
def test_zoo_fit_step_matches_jax(key):
    """Each leaf in L2 norm: |port - jax| <= 8 x the largest difference
    of either package's step from itself over two reorderings of the
    batch rows + 1e-5 |jax|."""
    jn = _jax_zoo(key)
    p0 = jax.tree_util.tree_map(np.array, jax.device_get(jn.params))
    s0 = jax.tree_util.tree_map(np.array, jax.device_get(jn.state))
    out_shape = tuple(jn.output(spec.make_input(
        key, spec.SPECS[key][2])[:1]).shape[1:])
    x, y = zoo_batch(key, out_shape)
    orders = (np.arange(FIT_B), np.array([2, 0, 3, 1]),
              np.array([3, 2, 1, 0]))
    runs = [_jax_step(jn, p0, s0, x[o], y[o]) for o in orders]
    jn.params = jax.tree_util.tree_map(jnp.asarray, p0)
    jn.state = jax.tree_util.tree_map(jnp.asarray, s0)
    ports = [_port_step(jn, x[o], y[o]) for o in orders]
    ref, port = runs[0], ports[0]
    others = runs[1:] + ports[1:]
    noise = max(abs(ref[0] - others[0][0]), abs(port[0] - ports[1][0]),
                *(abs(r[0] - ref[0]) for r in runs[1:]))
    assert abs(port[0] - ref[0]) <= 8 * noise + 1e-5 * abs(ref[0])
    for i in (1, 2, 3):
        assert sorted(port[i]) == sorted(ref[i])
        for k, a in ref[i].items():
            own = max([np.linalg.norm(a - r[i][k]) for r in runs[1:]]
                      + [np.linalg.norm(port[i][k] - p[i][k])
                         for p in ports[1:]])
            err = np.linalg.norm(port[i][k] - a)
            assert err <= 8 * own + 1e-5 * np.linalg.norm(a) + 1e-7, (
                k, err, own)
    if FIT_MODELS[key] == "classes":   # the centers moved (held above)
        assert np.abs(port[3]["out/centers"]).max() > 0


# --------------------------------------------------------------- zips

def _every_new_type_graph(B, L, G, IT):
    """A three-input, two-output graph with every layer type this slice
    brings (``B``: builder, ``L``: layers, ``G``: graph vertices)."""
    return (B.builder().set_seed(3).updater(
        (jupd if B is JaxBuilder else tupd).nesterovs(1e-2, 0.9))
        .graph_builder().add_inputs("ids", "seq", "img")
        .set_input_types(IT.feed_forward(9), IT.recurrent(4, 5),
                         IT.convolutional(4, 4, 3))
        .add_layer("emb", L.EmbeddingLayer(n_in=9, n_out=6), "ids")
        .add_layer("rbm", L.RBM(n_out=5), "emb")
        .add_layer("ae", L.AutoEncoder(n_out=5, activation="tanh"), "rbm")
        .add_layer("rae", L.RecursiveAutoEncoder(n_out=4,
                                                 activation="tanh"), "seq")
        .add_vertex("cat", G.MergeVertex(), "ae", "rae")
        .add_layer("vae", L.VariationalAutoencoder(
            n_out=4, encoder_layer_sizes=(6,), decoder_layer_sizes=(6,)),
            "cat")
        .add_layer("frozen", L.FrozenLayer(
            inner=L.DenseLayer(n_out=5, activation="tanh")), "vae")
        .add_layer("out", L.CenterLossOutputLayer(n_out=3, alpha=0.5,
                                                  lambda_=0.1), "frozen")
        .add_layer("conv", L.ConvolutionLayer(
            n_out=2 * 7, kernel=(1, 1), convolution_mode="same"), "img")
        .add_layer("yolo", L.Yolo2OutputLayer(
            anchors=((1.0, 1.5), (2.0, 1.0))), "conv")
        .set_outputs("out", "yolo").build())


def _every_new_type_data(n=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, 9, (n, 1)).astype(np.float32),
          rng.standard_normal((n, 5, 4)).astype(np.float32),
          rng.standard_normal((n, 4, 4, 3)).astype(np.float32)]
    ys = [np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)],
          _yolo_labels(rng, (n, 4, 4, 14), 2, 2)]
    return xs, ys


def test_a_zip_of_every_new_layer_type_crosses_both_ways(tmp_path):
    jc = _every_new_type_graph(JaxBuilder, jl, jgraph, JIT)
    tc = _every_new_type_graph(NeuralNetConfiguration, tl, tgraph,
                               InputType)
    assert tc.to_json() == jc.to_json()
    jg = JaxGraph(jc).init()
    xs, ys = _every_new_type_data()
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jser.write_model(jg, jpath)
    tg = restore_model(jpath, device="cpu")
    for a, b in zip(tg.output(*xs), jg.output(*xs)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL, rtol=RTOL)
    # train both one step, the port's zip back into JAX
    jg.fit(JaxMDS(xs, ys))
    tg.fit(MultiDataSet(xs, ys))
    np.testing.assert_allclose(float(tg.score_value), float(jg.score_value),
                               atol=ATOL, rtol=RTOL)
    write_model(tg, tpath)
    back = jser.restore_model(tpath)
    for a, b in zip(back.output(*xs), jg.output(*xs)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_flat(back.state)["out/centers"],
                               _flat(jg.state)["out/centers"], atol=ATOL,
                               rtol=RTOL)
    assert np.abs(_flat(back.state)["out/centers"]).max() > 0
    # the frozen vertex did not move in either package
    np.testing.assert_array_equal(_flat(back.params)["frozen/W"],
                                  _flat(jser.restore_model(jpath).params)
                                  ["frozen/W"])


# ---------------------------------------------------- transfer learning

def _iris_mln(B, L, U, seed=0):
    return (B.builder().set_seed(seed).updater(U.adam(0.05)).list()
            .layer(L.DenseLayer(n_out=10, activation="relu"))
            .layer(L.DenseLayer(n_out=8, activation="relu"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type((JIT if B is JaxBuilder else InputType)
                            .feed_forward(4)).build())


def _trained_pair(graph=False):
    """A JAX net trained on iris and the port net with its params."""
    xs, ys = iris_data()
    if graph:
        jn = JaxGraph(_iris_graph(JaxBuilder, jl, jupd)).init()
        jn.fit(JaxDataSet(xs[:120], ys[:120]), epochs=20)
    else:
        jn = JaxNet(_iris_mln(JaxBuilder, jl, jupd)).init()
        jn.fit(xs[:120], ys[:120], epochs=5, batch_size=32)
    return jn, _port_of(jn), xs, ys


def _iris_graph(B, L, U):
    return (B.builder().set_seed(0).updater(U.adam(0.05))
            .graph_builder().add_inputs("in")
            .add_layer("h1", L.DenseLayer(n_out=12, activation="relu"), "in")
            .add_layer("h2", L.DenseLayer(n_out=8, activation="relu"), "h1")
            .add_layer("out", L.OutputLayer(n_out=3), "h2")
            .set_outputs("out")
            .set_input_types((JIT if B is JaxBuilder else InputType)
                             .feed_forward(4)).build())


def _fine_tune_both(jt, tt, data, **fit):
    """Give the port net JAX's params (a re-initialized layer draws
    differently in the two packages), fine-tune both on ``data`` and
    hold the port's params to JAX's."""
    tt.set_params(params_from_jax(jax.device_get(jt.params), device="cpu"))
    tt._build_optimizer()
    xs, ys = data
    if isinstance(jt, JaxGraph):
        jt.fit(JaxDataSet(xs, ys), **fit)
    else:
        jt.fit(xs, ys, **fit)
    tt.fit(DataSet(xs, ys), **fit)
    ref = _flat(jt.params)
    got = _tflat(tt.params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_transfer_learning_freeze_and_replace_head_matches_jax():
    jn, tn, xs, ys = _trained_pair()

    def surgery(tlmod, net, L, U):
        return (tlmod.TransferLearning.builder(net)
                .fine_tune_configuration(
                    tlmod.FineTuneConfiguration(updater=U.adam(0.02)))
                .set_feature_extractor(1).remove_output_layer()
                .add_layer(L.OutputLayer(n_out=3)).build())
    jt = surgery(jtl, jn, jl, jupd)
    tt = surgery(ttl, tn, tl, tupd)
    assert tt.conf.to_json() == jt.conf.to_json()
    assert isinstance(tt.layers[0], FrozenLayer)
    assert isinstance(tt.layers[1], FrozenLayer)
    frozen = {k: v.detach().clone() for k, v in tt.params[0].items()}
    np.testing.assert_array_equal(frozen["W"].numpy(),
                                  np.asarray(jn.params[0]["W"]))
    head = np.asarray(jt.params[2]["W"]).copy()
    _fine_tune_both(jt, tt, (xs[:120], ys[:120]), epochs=5, batch_size=32)
    for k, v in frozen.items():
        assert torch.equal(tt.params[0][k], v)
    assert not np.allclose(tt.params[2]["W"].detach().numpy(), head)
    assert tt.evaluate(DataSet(xs[120:], ys[120:])).accuracy() == \
        jt.evaluate(xs[120:], ys[120:]).accuracy()


def test_transfer_learning_n_out_replace_matches_jax():
    jn, tn, xs, ys = _trained_pair()
    jt = jtl.TransferLearning.builder(jn).n_out_replace(1, 12).build()
    tt = ttl.TransferLearning.builder(tn).n_out_replace(1, 12).build()
    assert tt.conf.to_json() == jt.conf.to_json()
    assert tuple(tt.params[1]["W"].shape) == (10, 12)
    assert tuple(tt.params[2]["W"].shape) == (12, 3)
    np.testing.assert_array_equal(tt.params[0]["W"].detach().numpy(),
                                  np.asarray(jn.params[0]["W"]))


def test_graph_transfer_learning_freeze_until_vertex_matches_jax():
    jg, tg, xs, ys = _trained_pair(graph=True)

    def surgery(tlmod, g, U):
        return (tlmod.TransferLearningGraph.builder(g)
                .fine_tune_configuration(
                    tlmod.FineTuneConfiguration(updater=U.adam(0.01)))
                .set_feature_extractor("h1").build())
    jt, tt = surgery(jtl, jg, jupd), surgery(ttl, tg, tupd)
    assert tt.conf.to_json() == jt.conf.to_json()
    assert isinstance(tt.conf.vertices["h1"][0], FrozenLayer)
    assert not isinstance(tt.conf.vertices["h2"][0], FrozenLayer)
    w1 = tt.params["h1"]["W"].detach().clone()
    w2 = tt.params["h2"]["W"].detach().clone()
    _fine_tune_both(jt, tt, (xs[:120], ys[:120]), epochs=10)
    assert torch.equal(tt.params["h1"]["W"], w1)
    assert not torch.equal(tt.params["h2"]["W"], w2)
    assert not isinstance(tg.conf.vertices["h1"][0], FrozenLayer)
    with pytest.raises(ValueError, match="unknown vertex"):
        ttl.TransferLearningGraph.builder(tg).set_feature_extractor(
            "nope").build()


def test_graph_transfer_learning_replace_head_and_n_out_match_jax():
    jg, tg, xs, ys = _trained_pair(graph=True)
    ys5 = np.zeros((xs.shape[0], 5), np.float32)
    ys5[:, :3] = ys

    def head(tlmod, g, L):
        return (tlmod.TransferLearningGraph.builder(g)
                .set_feature_extractor("h2")
                .remove_vertex_keep_connections("out")
                .add_layer("out", L.OutputLayer(n_out=5), "h2").build())
    jt, tt = head(jtl, jg, jl), head(ttl, tg, tl)
    assert tt.conf.to_json() == jt.conf.to_json()
    assert tuple(tt.params["out"]["W"].shape) == (8, 5)
    stem = tt.params["h1"]["W"].detach().clone()
    _fine_tune_both(jt, tt, (xs[:120], ys5[:120]), epochs=60)
    assert tt.evaluate(DataSet(xs[120:], ys5[120:])).accuracy() > 0.7
    assert torch.equal(tt.params["h1"]["W"], stem)
    jt = jtl.TransferLearningGraph.builder(jg).n_out_replace("h2", 16).build()
    tt = ttl.TransferLearningGraph.builder(tg).n_out_replace("h2", 16).build()
    assert tt.conf.to_json() == jt.conf.to_json()
    assert tuple(tt.params["out"]["W"].shape) == (16, 3)
    np.testing.assert_array_equal(tt.params["h1"]["W"].detach().numpy(),
                                  np.asarray(jg.params["h1"]["W"]))


def test_graph_transfer_learning_remove_vertex_and_connections():
    def build(B, L, G, U):
        return (B.builder().set_seed(0).updater(U.adam(0.05))
                .graph_builder().add_inputs("in")
                .add_layer("a", L.DenseLayer(n_out=6, activation="relu"),
                           "in")
                .add_layer("b", L.DenseLayer(n_out=6, activation="relu"),
                           "in")
                .add_vertex("m", G.MergeVertex(), "a", "b")
                .add_layer("out", L.OutputLayer(n_out=3), "m")
                .set_outputs("out")
                .set_input_types((JIT if B is JaxBuilder else InputType)
                                 .feed_forward(4)).build())
    jg = JaxGraph(build(JaxBuilder, jl, jgraph, jupd)).init()
    tg = _port_of(jg)
    jp = jtl.TransferLearningGraph.builder(jg).remove_vertex_and_connections(
        "b").build()
    tp = ttl.TransferLearningGraph.builder(tg).remove_vertex_and_connections(
        "b").build()
    assert tp.conf.to_json() == jp.conf.to_json()
    assert "b" not in tp.conf.vertices
    assert tp.conf.vertices["m"][1] == ["a"]
    assert tuple(tp.params["out"]["W"].shape) == (6, 3)
    xs, ys = iris_data()
    _fine_tune_both(jp, tp, (xs[:120], ys[:120]), epochs=80)
    assert tp.evaluate(DataSet(xs[120:], ys[120:])).accuracy() == \
        jp.evaluate(JaxDataSet(xs[120:], ys[120:])).accuracy()


# ------------------------------------------------------------ manifest

@pytest.fixture
def manifest_env(tmp_path, monkeypatch):
    monkeypatch.setattr(tzoo.models, "_PRETRAINED_MANIFEST", {})
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(tmp_path / "cache"))
    return tmp_path


def test_manifest_export_fetch_round_trip(manifest_env):
    store = manifest_env / "store"
    zm = tzoo.LeNet(n_classes=10)
    net = zm.init(device="cpu")
    entry = tzoo.export_pretrained(net, zm.name, str(store))
    assert entry["url"].startswith("file://")
    assert (store / f"{zm.name}.zip.sha256").read_text().strip() == \
        entry["sha256"]
    tzoo.load_manifest(str(store / "manifest.json"))
    loaded = tzoo.LeNet(n_classes=10).init_pretrained(device="cpu")
    assert (manifest_env / "cache" / f"{zm.name}.zip").exists()
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(loaded.output(x).numpy(),
                                  net.output(x).numpy())
    # a manifest the JAX package wrote points at a zip the port restores
    jstore = manifest_env / "jstore"
    jnet = jzoo.LeNet(n_classes=10).init()
    jzoo.export_pretrained(jnet, "jax_lenet", str(jstore))
    entries = tzoo.load_manifest(str(jstore / "manifest.json"))
    assert "jax_lenet" in entries


def test_manifest_checksum_mismatch_is_refused(manifest_env):
    store = manifest_env / "store"
    zm = tzoo.LeNet(n_classes=10)
    entry = tzoo.export_pretrained(zm.init(device="cpu"), zm.name,
                                   str(store))
    tzoo.register_pretrained(zm.name, entry["url"], "0" * 64)
    with pytest.raises(IOError, match="Checksum mismatch"):
        tzoo.LeNet(n_classes=10).init_pretrained(device="cpu")
    # the corrupt fetch was deleted, not cached
    assert not (manifest_env / "cache" / f"{zm.name}.zip").exists()
    tzoo.register_pretrained(zm.name, entry["url"], entry["sha256"])
    tzoo.LeNet(n_classes=10).init_pretrained(device="cpu")
    with pytest.raises(IOError, match="Checksum mismatch"):
        tzoo.LeNet(n_classes=10).init_pretrained(checksum="1" * 64,
                                                 device="cpu")


def test_missing_pretrained_weights_name_the_expected_path(manifest_env):
    with pytest.raises(FileNotFoundError, match="register_pretrained"):
        tzoo.UNet().init_pretrained(device="cpu")


# ---------------------------------------------------- the FLOP counter

def test_flop_counter_prices_deconv_at_its_input_and_divides_groups():
    import chip_smoke
    b = NeuralNetConfiguration.builder().list()
    net = MultiLayerNetwork(
        b.layer(tl.Deconvolution2DLayer(n_out=4, kernel=(2, 2),
                                        stride=(2, 2)))
        .layer(tl.DepthwiseConvolution2DLayer(kernel=(3, 3),
                                              depth_multiplier=2,
                                              convolution_mode="same"))
        .layer(tl.SeparableConvolution2DLayer(n_out=5, kernel=(3, 3)))
        .layer(tl.ConvolutionLayer(n_out=3, kernel=(1, 1)))
        .set_input_type(InputType.convolutional(6, 6, 3)).build(),
        device="cpu")
    deconv = 2 * 6 * 6 * 3 * 4 * 4            # input 6x6, not output 12x12
    depthwise = 2 * 12 * 12 * 8 * 9            # groups = C_in = 4
    separable = 2 * 10 * 10 * 8 * (9 + 5)      # 3x3 depthwise + 1x1 to 5
    conv = 2 * 10 * 10 * 5 * 3
    assert chip_smoke.sequential_flops(net) == (deconv + depthwise
                                                + separable + conv)
    g = tzoo.UNet(n_classes=1, input_shape=(32, 32, 3)).conf()
    up0 = g.vertices["up0"][0]
    t = g.vertex_input_type("up0")
    assert chip_smoke.layer_flops(up0, t) == (2 * 16 * 16 * up0.n_in
                                              * up0.n_out * 4)
    assert chip_smoke.conv_dense_flops(g) == sum(
        chip_smoke.layer_flops(g.vertices[n][0], g.vertex_input_type(n))
        for n in g.topological_order() if g.vertex_input_type(n))


# ------------------------------------------------------------ card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(FIT_MODELS))
def test_zoo_fit_step_on_the_card_is_near_the_cpu(cuda_device, key):
    jn = _jax_zoo(key)
    cpu = _port_of(jn)
    card = _port_of(jn)
    card = card.to("cuda")
    card.device = torch.device("cuda")
    card.state = {n: {k: v.cuda() for k, v in s.items()}
                  for n, s in card.state.items()} \
        if isinstance(card.state, dict) else \
        [{k: v.cuda() for k, v in s.items()} for s in card.state]
    card._build_optimizer()
    x, y = zoo_batch(key, cpu.output(spec.make_input(
        key, spec.SPECS[key][2])[:1]).shape[1:])
    cpu.fit(DataSet(x, y))
    card.fit(DataSet(x, y))
    assert abs(float(card.score_value) - float(cpu.score_value)) <= \
        1e-3 * abs(float(cpu.score_value)) + 1e-4
    assert np.isfinite(card.output(x).cpu().numpy()).all()
