"""Layer-named errors of the port's executors against the JAX package's
(``nn/errors.py``; the cases of tests/test_error_ergonomics.py).

A wrong-width ``output``, ``fit`` or graph forward must raise the port's
``NetworkExecutionError`` (a ValueError) whose message names the same
place, layer class and input shape and dtype as the JAX message, word
for word up to the underlying exception, which is each framework's own
(torch's ``RuntimeError``, jax's ``TypeError``).

A device failure inside a layer (out of memory, an accelerator error, a
failed collective) is no input error: it passes through unchanged, so
the serving path answers it with a 500 that the router counts against
the replica, while a wrong width stays a 400.
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.errors import (
    NetworkExecutionError as JNetworkExecutionError)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.nn.errors import (_PASSED_THROUGH,
                                                NetworkExecutionError,
                                                layer_error_context)
from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
from deeplearning4j_tpu_torch.serving.router import Router
from deeplearning4j_tpu_torch.util import model_serializer as tser


def _mln():
    return JNet(JaxBuilder.builder().set_seed(0)
                .updater(jupd.adam(0.01)).list()
                .layer(jl.DenseLayer(n_out=8, activation="relu"))
                .layer(jl.OutputLayer(n_out=3))
                .set_input_type(JIT.feed_forward(4)).build()).init()


def _graph():
    return JGraph(JaxBuilder.builder().set_seed(0)
                  .updater(jupd.adam(0.01)).graph_builder()
                  .add_inputs("in")
                  .add_layer("hidden", jl.DenseLayer(n_out=8,
                                                     activation="relu"),
                             "in")
                  .add_layer("out", jl.OutputLayer(n_out=3), "hidden")
                  .set_outputs("out")
                  .set_input_types(JIT.feed_forward(4)).build()).init()


def _pair(tmp_path, make):
    jn = make()
    path = str(tmp_path / "net.zip")
    jser.write_model(jn, path)
    return jn, tser.restore_model(path, device="cpu")


def _head(msg):
    """The message up to the underlying exception's type name."""
    return re.match(r"(.*?\)): \w+: ", msg).group(1)


def _output(net, x):
    return net.output(x)


def _fit(net, x):
    ys = np.eye(3, dtype=np.float32)[np.zeros(len(x), int)]
    return net.fit(x, ys)


CASES = {
    # name: (network, call, input, the place and shape the message names)
    "mln_output": (_mln, _output, (5, 7), "layer 0", "DenseLayer"),
    "graph_output": (_graph, _output, (5, 9), "vertex 'hidden'",
                     "DenseLayer"),
    "mln_fit": (_mln, _fit, (6, 5), "layer 0", "DenseLayer"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrong_width_names_the_layer_as_jax_does(tmp_path, case):
    make, call, shape, where, cls = CASES[case]
    jn, tn = _pair(tmp_path, make)
    x = np.zeros(shape, np.float32)
    with pytest.raises(JNetworkExecutionError) as jei:
        call(jn, x)
    with pytest.raises(NetworkExecutionError) as tei:
        call(tn, x)
    jmsg, tmsg = str(jei.value), str(tei.value)
    assert where in tmsg and cls in tmsg and str(shape) in tmsg, tmsg
    assert "(float32)" in tmsg
    assert _head(tmsg) == _head(jmsg), (tmsg, jmsg)
    assert isinstance(tei.value, ValueError)
    assert isinstance(tei.value.__cause__, RuntimeError)


def test_a_graph_vertex_failure_is_named(tmp_path):
    """A non-layer vertex (MergeVertex of mismatched batches) fails
    inside the graph's interpreter: named as the JAX executor names it."""
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    g = (JaxBuilder.builder().set_seed(0).graph_builder()
         .add_inputs("a", "b")
         .add_vertex("m", MergeVertex(), "a", "b")
         .add_layer("out", jl.OutputLayer(n_out=2), "m")
         .set_outputs("out")
         .set_input_types(JIT.feed_forward(3), JIT.feed_forward(3))
         .build())
    jn, tn = _pair(tmp_path, lambda: JGraph(g).init())
    a, b = np.zeros((4, 3), np.float32), np.zeros((5, 3), np.float32)
    with pytest.raises(JNetworkExecutionError) as jei:
        jn.output(a, b)
    with pytest.raises(NetworkExecutionError) as tei:
        tn.output(a, b)
    assert "vertex 'm' (MergeVertex) with input shape (4, 3)" in \
        str(tei.value)
    assert _head(str(tei.value)) == _head(str(jei.value))


def test_nested_annotation_is_kept_and_other_exits_pass():
    """An already-annotated error passes through an outer context
    unchanged (nested graphs), a clean exit and a non-Exception
    (KeyboardInterrupt) are left alone."""
    inner = NetworkExecutionError("Error executing layer 1 (X): ...")
    with pytest.raises(NetworkExecutionError) as ei:
        with layer_error_context("vertex 'outer'", object(),
                                 torch.zeros(2)):
            raise inner
    assert ei.value is inner
    with layer_error_context("layer 0", object(), None):
        pass
    with pytest.raises(KeyboardInterrupt):
        with layer_error_context("layer 0", object(), None):
            raise KeyboardInterrupt
    with pytest.raises(NetworkExecutionError,
                       match=r"^Error executing layer 2 \(object\): "
                             r"KeyError: 'k'$"):
        with layer_error_context("layer 2", object(), None):
            raise KeyError("k")


@pytest.mark.parametrize("cls", _PASSED_THROUGH,
                         ids=lambda c: c.__name__)
def test_device_failures_pass_through_unchanged(cls):
    err = cls("device failure")
    with pytest.raises(cls) as ei:
        with layer_error_context("layer 0", object(), torch.zeros(2)):
            raise err
    assert ei.value is err and not isinstance(ei.value,
                                              NetworkExecutionError)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serving_answers_oom_500_and_wrong_width_400(tmp_path):
    """Through the router to one replica: a layer that runs out of
    memory gives a 500 that the router notes as the replica's failure;
    a wrong-width input gives the layer-named 400, a success for the
    replica."""
    _, good = _pair(tmp_path, _mln)
    _, bad = _pair(tmp_path, _mln)

    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")

    bad.layers[0].apply = oom
    with pytest.raises(torch.OutOfMemoryError):
        bad.output(np.zeros((2, 4), np.float32))
    fleet = ReplicaFleet(lambda: {"good": good, "bad": bad}, n=1,
                         device="cpu",
                         server_kwargs=dict(wait_ms=1.0)).start()
    router = Router(fleet, probe_interval_s=30.0, hedge_after_s=None,
                    eject_consecutive=5).start()
    try:
        view = router._views[fleet.replica(0).id]
        code, reply = _post(router.port, {"model": "bad",
                                          "inputs": [[0.0] * 4]})
        assert code == 500 and "out of memory" in reply["error"]
        assert view.consecutive_failures == 1
        code, reply = _post(router.port, {"model": "good",
                                          "inputs": [[0.0] * 7]})
        assert code == 400, reply
        assert reply["error"].startswith(
            "Error executing layer 0 (DenseLayer) with input shape (1, 7)")
        assert view.consecutive_failures == 0
        code, reply = _post(router.port, {"model": "good",
                                          "inputs": [[0.0] * 4]})
        assert code == 200 and np.asarray(reply["outputs"]).shape == (1, 3)
    finally:
        router.stop()
        fleet.stop(drain=False, timeout=2.0)
