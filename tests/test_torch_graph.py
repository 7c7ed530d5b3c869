"""The port's ComputationGraph and ResNet50 against the JAX package, on
the CPU.

Every vertex type, a hand-built graph holding all 14 (config JSON,
output, two fit steps with a per-vertex updater override and global
gradient clipping, masks routed to a sequence output), ResNet50's
config, its inference output, one ``fit`` step, its dtypes under
``tpu_bf16()``, zips both ways and ``/v1/predict``. Seeded numpy inputs
go through both packages. Tolerance, unless a test derives another:
float32 with sums in another order, atol=1e-5, rtol=1e-4.

ResNet50's training step is held to a tolerance derived from the JAX
package itself: batch normalization over few values a channel (16 in
the last stage at 64x64, B=4) amplifies float32 rounding, so the JAX
step computed on the same batch in another row order already differs
from itself by far more than 1e-5. The port is held to 8 times the
largest such self-difference of each leaf (two reorderings), plus a
float32 floor.
"""

import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.nn.conf import graph as jg
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.nn.conf import graph as tg
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import (params_from_jax,
                                                            restore_model)

ATOL, RTOL = 1e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    return np.asarray(a, np.float32)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            jser._flatten_with_paths(tree).items()}


def _assert_trees(port, ref, atol, rtol):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_of(jn, cls=ComputationGraph):
    """The port net of ``jn``'s config JSON with ``jn``'s params and
    state, on the CPU."""
    conf = ComputationGraphConfiguration.from_json(jn.conf.to_json())
    tn = cls(conf, device="cpu").init()
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    tn.state = params_from_jax(jax.device_get(jn.state), device="cpu")
    tn._build_optimizer()
    return tn


# ---------------------------------------------------------- vertices

_VERTEX_CASES = [
    ("ElementWiseVertex", dict(op="add"), [(3, 4), (3, 4), (3, 4)]),
    ("ElementWiseVertex", dict(op="subtract"), [(3, 4), (3, 4)]),
    ("ElementWiseVertex", dict(op="product"), [(3, 4), (3, 4)]),
    ("ElementWiseVertex", dict(op="average"), [(3, 4), (3, 4), (3, 4)]),
    ("ElementWiseVertex", dict(op="max"), [(3, 4), (3, 4)]),
    ("MergeVertex", {}, [(3, 2, 2, 4), (3, 2, 2, 3)]),
    ("SubsetVertex", dict(from_=1, to_=3), [(3, 5)]),
    ("StackVertex", {}, [(3, 4), (2, 4)]),
    ("UnstackVertex", dict(from_=1, stack_size=3), [(6, 4)]),
    ("ScaleVertex", dict(scale=2.5), [(3, 4)]),
    ("ShiftVertex", dict(shift=-0.5), [(3, 4)]),
    ("L2NormalizeVertex", {}, [(3, 2, 2, 4)]),
    ("L2Vertex", {}, [(3, 5), (3, 5)]),
    ("PreprocessorVertex",
     dict(preprocessor={"@type": "CnnToFeedForwardPreProcessor",
                        "height": 2, "width": 2, "channels": 3}),
     [(3, 2, 2, 3)]),
    ("ReshapeVertex", dict(shape=(2, 6)), [(3, 12)]),
    ("PoolHelperVertex", {}, [(3, 4, 4, 2)]),
    ("LastTimeStepVertex", {}, [(3, 5, 2)]),
    ("DuplicateToTimeSeriesVertex", {}, [(3, 4), (3, 6, 2)]),
]


@pytest.mark.parametrize("name,kw,shapes", _VERTEX_CASES)
def test_vertex_matches_jax(name, kw, shapes):
    jv = getattr(jg, name)(**kw)
    tv = tg.vertex_from_dict(json.loads(json.dumps(jv.to_dict())))
    assert tv.to_dict() == json.loads(json.dumps(jv.to_dict()))
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    ref = _np(jv.apply([jnp.asarray(x) for x in xs]))
    got = tv.apply([torch.tensor(x) for x in xs])
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_last_time_step_takes_the_masked_last_step():
    x = _x((3, 5, 2))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [0, 0, 0, 0, 0]],
                    np.float32)
    ref = _np(jg.LastTimeStepVertex().apply([jnp.asarray(x)],
                                            mask=jnp.asarray(mask)))
    got = tg.LastTimeStepVertex().apply([torch.tensor(x)],
                                        mask=torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("masks", [
    [None, None], [np.ones((3, 5), np.float32), None],
    [np.array([[1, 0, 0, 1, 1]] * 3, np.float32),
     np.array([[0, 1, 0, 0, 1]] * 3, np.float32)],
])
@pytest.mark.parametrize("name", ["ElementWiseVertex", "MergeVertex",
                                  "StackVertex"])
def test_mask_routing_matches_jax(name, masks):
    xs = [_x((3, 5, 2)), _x((3, 5, 2), 1)]
    jv, tv = getattr(jg, name)(), getattr(tg, name)()
    ref = jv.propagate_mask([None if m is None else jnp.asarray(m)
                             for m in masks], [jnp.asarray(x) for x in xs])
    got = tv.propagate_mask([None if m is None else torch.tensor(m)
                             for m in masks], [torch.tensor(x) for x in xs])
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_unknown_vertex_type_is_named():
    with pytest.raises(ValueError, match="'Nope'"):
        tg.vertex_from_dict({"@type": "Nope"})


# ------------------------------------- a graph of every vertex type

def _every_vertex_graph(B, L, G, IT, U):
    """inputs a: ff(6), seq: rnn(4, 5), img: cnn(3, 3, 2); two outputs:
    ``out`` (softmax, 3 classes) and ``seq_out`` (per timestep, 2)."""
    g = (B.builder().set_seed(3).updater(U.nesterovs(0.05, 0.9))
         .clip_gradient_norm(2.0).graph_builder()
         .add_inputs("a", "seq", "img")
         .set_input_types(IT.feed_forward(6), IT.recurrent(4, 5),
                          IT.convolutional(3, 3, 2)))
    g.add_layer("d1", L.DenseLayer(n_out=6, activation="tanh"), "a")
    g.add_vertex("ew", G.ElementWiseVertex(op="add"), "a", "d1")
    g.add_vertex("merge", G.MergeVertex(), "ew", "d1")
    g.add_vertex("subset", G.SubsetVertex(from_=2, to_=9), "merge")
    g.add_vertex("scale", G.ScaleVertex(scale=2.0), "subset")
    g.add_vertex("shift", G.ShiftVertex(shift=0.5), "scale")
    g.add_vertex("l2n", G.L2NormalizeVertex(), "shift")
    g.add_vertex("stack", G.StackVertex(), "l2n", "subset")
    g.add_vertex("unstack", G.UnstackVertex(from_=1, stack_size=2), "stack")
    g.add_vertex("l2", G.L2Vertex(), "unstack", "l2n")
    g.add_vertex("r1", G.ReshapeVertex(shape=(4, 2)), "subset")
    g.add_vertex("r2", G.ReshapeVertex(shape=(8,)), "r1")
    g.add_vertex("ph", G.PoolHelperVertex(), "img")
    g.add_vertex("pp", G.PreprocessorVertex(preprocessor={
        "@type": "CnnToFeedForwardPreProcessor", "height": 2, "width": 2,
        "channels": 2}), "ph")
    g.add_vertex("last", G.LastTimeStepVertex(mask_input="seq"), "seq")
    g.add_vertex("feat", G.MergeVertex(), "l2", "last", "pp", "r2",
                 "unstack")
    g.add_layer("d2", L.DenseLayer(n_out=5, activation="relu",
                                   updater=U.adam(1e-2)), "feat")
    g.add_layer("out", L.OutputLayer(n_out=3), "d2")
    g.add_vertex("dup", G.DuplicateToTimeSeriesVertex(ts_input="seq"),
                 "last", "seq")
    g.add_layer("seq_out", L.RnnOutputLayer(n_out=2), "dup")
    return g.set_outputs("out", "seq_out").build()


def _every_vertex_data(seed=0, n=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 6)).astype(np.float32)
    seq = rng.standard_normal((n, 5, 4)).astype(np.float32)
    img = rng.standard_normal((n, 3, 3, 2)).astype(np.float32)
    m = np.ones((n, 5), np.float32)
    m[1, 3:] = 0
    m[2, 1:] = 0
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    ys = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, 5))]
    return [a, seq, img], [y, ys], [None, m, None], [None, m]


@pytest.fixture(scope="module")
def every_vertex_pair():
    jn = JaxGraph(_every_vertex_graph(JaxBuilder, jl, jg, JIT, jupd)).init()
    return jn, _port_of(jn)


def test_every_vertex_graph_config_equals_jax(every_vertex_pair):
    jn, _ = every_vertex_pair
    tc = _every_vertex_graph(NeuralNetConfiguration, tl, tg, InputType, tupd)
    assert tc.to_json() == jn.conf.to_json()
    kinds = {type(obj).__name__ for obj, _ in tc.vertices.values()
             if not isinstance(obj, tl.Layer)}
    assert len(kinds) == 14
    assert tc.topological_order() == jn.conf.topological_order()
    assert ComputationGraphConfiguration.from_json(tc.to_json()).to_json() \
        == tc.to_json()


def test_every_vertex_graph_output_and_score_match_jax(every_vertex_pair):
    jn, tn = every_vertex_pair
    xs, ys, fm, lm = _every_vertex_data()
    ref = jn.output(*xs, input_masks=fm)
    got = tn.output(*xs, input_masks=fm)
    assert len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tn.score(MultiDataSet(xs, ys, fm, lm)),
        jn.score(JaxMultiDataSet(xs, ys, fm, lm)), atol=ATOL, rtol=RTOL)
    acts = tn.feed_forward(*xs, input_masks=fm)
    jacts = jn.feed_forward(*xs, input_masks=fm)
    assert sorted(acts) == sorted(jacts)
    for k in jacts:
        np.testing.assert_allclose(acts[k].numpy(), _np(jacts[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_every_vertex_graph_two_fit_steps_match_jax():
    jn = JaxGraph(_every_vertex_graph(JaxBuilder, jl, jg, JIT, jupd)).init()
    tn = _port_of(jn)
    for step in range(2):
        xs, ys, fm, lm = _every_vertex_data(seed=step)
        jn.fit(JaxMultiDataSet(xs, ys, fm, lm))
        tn.fit(MultiDataSet(xs, ys, fm, lm))
        np.testing.assert_allclose(float(tn.score_value),
                                   float(jn.score_value), atol=ATOL,
                                   rtol=RTOL)
    # d2's Adam override moves an element by up to ~lr whatever its
    # gradient's size: params are held to lr / 20 (1e-2 / 20)
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), 5e-4, RTOL)
    _assert_trees(tser._flatten(tn.opt_state), _flat(jn.opt_state),
                  ATOL, RTOL)
    np.testing.assert_allclose(tn.params_flat(), jn.params_flat(),
                               atol=5e-4, rtol=RTOL)


# ------------------------------------------------------------ ResNet50

def test_resnet50_config_and_size_equal_jax():
    jc = jzoo.models.ResNet50().conf()
    tc = tzoo.ResNet50().conf()
    assert tc.to_json() == jc.to_json()
    assert ComputationGraphConfiguration.from_json(jc.to_json()).to_json() \
        == jc.to_json()
    assert tc.topological_order() == jc.topological_order()
    net = tzoo.ResNet50().init(device="cpu")
    assert net.num_params() == 25_557_032
    assert "total params: 25557032" in net.summary()


HW, NCLS, BATCH = 64, 3, 4


@pytest.fixture(scope="module")
def resnet():
    """The JAX ResNet50 at 64x64, 3 classes, nesterovs(0.1, 0.9), with
    its initial params and state as numpy."""
    jn = jzoo.models.ResNet50(n_classes=NCLS, input_shape=(HW, HW, 3),
                              updater=jupd.nesterovs(0.1, 0.9)).init()
    p0 = jax.tree_util.tree_map(np.array, jax.device_get(jn.params))
    s0 = jax.tree_util.tree_map(np.array, jax.device_get(jn.state))
    return jn, p0, s0


def _reset(jn, p0, s0):
    jn.params = jax.tree_util.tree_map(jnp.asarray, p0)
    jn.state = jax.tree_util.tree_map(jnp.asarray, s0)
    jn.opt_state = jn._optimizer.init(jn.params)


def _resnet_batch(seed=0, n=BATCH, hw=HW):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, 3)).astype(np.float32)
    y = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, n)]
    return x, y


def test_resnet50_output_matches_jax(resnet):
    jn, p0, s0 = resnet
    _reset(jn, p0, s0)
    tn = _port_of(jn)
    x, _ = _resnet_batch(1)
    np.testing.assert_allclose(tn.output(x).numpy(), _np(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tn.params_flat(), jn.params_flat())


def test_resnet50_fit_step_matches_jax(resnet):
    jn, p0, s0 = resnet
    x, y = _resnet_batch()
    runs = []
    for order in (np.arange(BATCH), np.array([2, 0, 3, 1]),
                  np.array([3, 2, 1, 0])):
        _reset(jn, p0, s0)
        jn.fit(JaxDataSet(x[order], y[order]))
        runs.append((float(jn.score_value), _flat(jn.params),
                     _flat(jn.state)))
    _reset(jn, p0, s0)
    tn = _port_of(jn)
    tn.fit(DataSet(x, y))
    port = (float(tn.score_value), tser._flatten(tn.params),
            tser._flatten(tn.state))
    ref, others = runs[0], runs[1:]

    def tol(key, i):
        a = ref[i][key]
        noise = max(np.abs(a - o[i][key]).max() for o in others)
        return 8 * noise + 1e-5 * np.abs(a).max() + 1e-6

    noise = max(abs(ref[0] - o[0]) for o in others)
    assert abs(port[0] - ref[0]) <= 8 * noise + 1e-5 * abs(ref[0])
    for i in (1, 2):
        assert sorted(port[i]) == sorted(ref[i])
        for k in ref[i]:
            np.testing.assert_allclose(port[i][k], ref[i][k],
                                       atol=tol(k, i), rtol=0, err_msg=k)
    assert len(port[2]) == 2 * 53          # mean, var of 53 BN vertices
    assert tn.iteration_count == 1


def test_resnet50_bf16_dtypes_match_jax(resnet):
    jn, p0, s0 = resnet
    _reset(jn, p0, s0)
    tn = _port_of(jn)
    x, _ = _resnet_batch(2, n=2, hw=32)
    ref32 = _np(jn.output(x))
    with jdtypes.policy_scope(jdtypes.tpu_bf16()):
        jacts = jn.feed_forward(x)
    with tdtypes.policy_scope(tdtypes.tpu_bf16()):
        acts = tn.feed_forward(x)
    got = {k: str(v.dtype).replace("torch.", "") for k, v in acts.items()}
    assert got == {k: str(v.dtype) for k, v in jacts.items()}
    assert got["stem_conv"] == got["s0b0_a_conv"] == "bfloat16"
    assert got["stem_bn"] == got["s0b0_c_bn"] == got["out"] == "float32"
    # the port under bf16 is held to twice the distance bf16 puts the
    # JAX package from its own float32 result
    tol = 2 * float(np.abs(_np(jacts["out"]) - ref32).max())
    np.testing.assert_allclose(acts["out"].numpy(), _np(jacts["out"]),
                               atol=tol, rtol=0)


def test_resnet50_zips_cross_both_ways(resnet, tmp_path):
    jn, p0, s0 = resnet
    _reset(jn, p0, s0)
    x, y = _resnet_batch(3)
    jn.fit(JaxDataSet(x, y))
    jzip = str(tmp_path / "jax.zip")
    jser.write_model(jn, jzip)
    port = restore_model(jzip, device="cpu")
    assert isinstance(port, ComputationGraph)
    _assert_trees(tser._flatten(port.params), _flat(jn.params), 0, 0)
    _assert_trees(tser._flatten(port.state), _flat(jn.state), 0, 0)
    _assert_trees(tser._flatten(port.opt_state), _flat(jn.opt_state), 0, 0)
    assert port.iteration_count == jn.iteration_count
    xo, _ = _resnet_batch(4)
    np.testing.assert_allclose(port.output(xo).numpy(), _np(jn.output(xo)),
                               atol=ATOL, rtol=RTOL)
    tzip = str(tmp_path / "port.zip")
    tser.write_model(port, tzip)
    back = jser.restore_model(tzip)
    assert isinstance(back, JaxGraph)
    _assert_trees(_flat(back.params), _flat(jn.params), 0, 0)
    _assert_trees(_flat(back.state), _flat(jn.state), 0, 0)
    _assert_trees(_flat(back.opt_state), _flat(jn.opt_state), 0, 0)


def test_resnet50_predict_through_a_port_server(resnet, tmp_path):
    jn, p0, s0 = resnet
    _reset(jn, p0, s0)
    path = str(tmp_path / "resnet.zip")
    jser.write_model(jn, path)
    reg = ModelRegistry()
    net = restore_model(path, device="cpu")
    reg.register("resnet", net)
    server = ModelServer(reg, wait_ms=5.0).start()
    x, _ = _resnet_batch(5, n=3, hw=32)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/predict",
            data=json.dumps({"model": "resnet",
                             "inputs": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            code, body = r.status, json.loads(r.read())
    finally:
        server.stop()
    assert code == 200
    out = np.asarray(body["outputs"], np.float32)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, net.output(x).numpy(), atol=1e-7,
                               rtol=1e-6)
    np.testing.assert_allclose(out, _np(jn.output(x)), atol=ATOL, rtol=RTOL)


def test_cli_serves_a_resnet50_zip(resnet, tmp_path):
    jn, p0, s0 = resnet
    _reset(jn, p0, s0)
    path = str(tmp_path / "resnet.zip")
    jser.write_model(jn, path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--model", f"resnet={path}", "--device", "cpu", "--port", "0"],
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
        x, _ = _resnet_batch(6, n=2, hw=32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/predict",
            data=json.dumps({"model": "resnet",
                             "inputs": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        np.testing.assert_allclose(np.asarray(body["outputs"], np.float32),
                                   _np(jn.output(x)), atol=ATOL, rtol=RTOL)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_graph_evaluate_clone_and_flat_params(every_vertex_pair):
    jn, tn = every_vertex_pair
    xs, ys, fm, lm = _every_vertex_data(seed=7, n=12)
    je = jn.evaluate(JaxMultiDataSet(xs, ys, fm, lm))
    te = tn.evaluate(MultiDataSet(xs, ys, fm, lm))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    c = tn.clone()
    np.testing.assert_array_equal(c.params_flat(), tn.params_flat())
    c.set_params_flat(np.zeros_like(tn.params_flat()))
    assert not c.params_flat().any() and tn.params_flat().any()
    assert tn.num_params() == jn.num_params()
    assert tn.summary().splitlines()[1:-1] == jn.summary().splitlines()[1:-1]


# ---------------------------------------------- what is not ported

def test_unported_graph_features_raise(every_vertex_pair):
    _, tn = every_vertex_pair
    xs, ys, _, _ = _every_vertex_data()
    # rnn_time_step and streaming_session are ported (A5b-1,
    # tests/test_torch_rnn_stream.py), and pretrain (A5b-2,
    # tests/test_torch_pretrain.py): with no pretrainable vertex it
    # returns the graph
    assert tn.pretrain([]) is tn
    # listeners are ported (A5b-3, tests/test_torch_listeners.py)
    marker = object()
    assert tn.set_listeners(marker) is tn and tn.listeners == [marker]
    assert tn.add_listeners(marker).listeners == [marker, marker]
    tn.set_listeners()
    # k-step fusion and warmup are ported (A7, tests/test_torch_kstep.py):
    # on a clone, so the module's shared graph keeps its weights
    tc = tn.clone()
    assert set(tc.warmup(MultiDataSet(xs, ys), steps_per_device_call=2)) \
        == {"train_step", "kstep_2"}
    tc.fit(MultiDataSet(xs, ys), steps_per_device_call=2)
    assert tc.iteration_count == 1
    # data and tensor parallelism are ported (tests/test_torch_parallel.py,
    # tests/test_torch_tensor_parallel.py): dp=2 and tp=2 need two ranks;
    # sp trains through ParallelWrapper, as in JAX
    with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR"):
        tn.fit(MultiDataSet(xs, ys), mesh_spec="dp=2")
    with pytest.raises(ValueError, match="DL4J_TPU_COORDINATOR"):
        tn.fit(MultiDataSet(xs, ys), mesh_spec="tp=2")
    with pytest.raises(NotImplementedError, match="ParallelWrapper"):
        tn.fit(MultiDataSet(xs, ys), mesh_spec="sp=2")


def test_cuda_graph_without_a_card_raises(every_vertex_pair, tmp_path,
                                          monkeypatch):
    jn, _ = every_vertex_pair
    path = str(tmp_path / "g.zip")
    jser.write_model(jn, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_model(path, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(jn.conf, device="cuda")


# -------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_vertex_runs_on_the_card(cuda_device, every_vertex_pair):
    jn, tn = every_vertex_pair
    conf = ComputationGraphConfiguration.from_json(jn.conf.to_json())
    net = ComputationGraph(conf, device="cuda").init()
    net.set_params(tn.params)
    xs, ys, fm, lm = _every_vertex_data()
    acts = net.feed_forward(*xs, input_masks=fm)
    assert all(a.device.type == "cuda" for a in acts.values())
    net.fit(MultiDataSet(xs, ys, fm, lm))
    assert all(p.device.type == "cuda" for p in net.parameters())
    assert all(t.device.type == "cuda" for s in net.state.values()
               for t in s.values())
    got = net.output(*xs, input_masks=fm)
    assert all(g.device.type == "cuda" for g in got)
