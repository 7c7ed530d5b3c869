"""The port's recurrent layers and their training against the JAX
package, on the CPU.

Every recurrent layer (LSTM, GravesLSTM, SimpleRnn, Bidirectional in
the four merge modes, GravesBidirectionalLSTM, LastTimeStep,
RnnLossLayer) with and without a ragged mask; the char-RNN (two
GravesLSTM and an RnnOutputLayer, RMSProp, as ``bench.py``'s leg at a
small width) on both executors: score, gradients, three RMSProp steps,
and a tBPTT ``fit`` (each chunk's loss, params after the batch,
``iteration_count``); zips both ways with the updater state; configs,
``TextGenerationLSTM``'s JSON and the preprocessor rule. Networks are
built with the JAX builder and cross by checkpoint zip; seeded numpy
inputs go to both packages.

Tolerance: float32 on both sides with sums in another order (the port
computes ``x @ Wx + b`` for every step in one GEMM before the loop):
atol 2e-5, rtol 2e-4. Parameters after RMSProp steps: a first step is
about lr * g / sqrt(0.05 g^2) = 4.5 lr sign(g), so a gradient that
differs in its last bits moves a parameter by a small fraction of lr;
they are held to atol lr/20 (a twentieth of one step) and rtol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.train.listeners import TrainingListener
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.util import model_serializer as tser

N_IN, HID, V, T, B = 7, 12, 10, 9, 3
LR = 1e-3
ATOL, RTOL = 2e-5, 2e-4
P_ATOL = LR / 20


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _ragged_mask(b=B, t=T):
    m = np.ones((b, t), np.float32)
    m[0, t - 4:] = 0                     # tail padding
    m[b - 1, t // 2:] = 0
    return m


def _port_of(jnet, tmp_path, name="net.zip"):
    path = str(tmp_path / name)
    jser.write_model(jnet, path)
    return tser.restore_model(path, device="cpu")


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            jser._flatten_with_paths(tree).items()}


def _assert_trees(port, ref, atol, rtol):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ the layers

def _layer(kind):
    """(JAX layer config, whether its output is a sequence)."""
    if kind == "LSTM":
        return jl.LSTM(n_out=HID), True
    if kind == "GravesLSTM":
        return jl.GravesLSTM(n_out=HID, activation="tanh"), True
    if kind == "SimpleRnn":
        return jl.SimpleRnn(n_out=HID), True
    if kind.startswith("Bidirectional-"):
        return jl.Bidirectional(fwd=jl.GravesLSTM(n_out=HID),
                                mode=kind.split("-")[1]), True
    if kind == "GravesBidirectionalLSTM":
        return jl.GravesBidirectionalLSTM(n_out=HID), True
    if kind == "LastTimeStep":
        return jl.LastTimeStep(underlying=jl.LSTM(n_out=HID)), False
    raise ValueError(kind)


LAYERS = ["LSTM", "GravesLSTM", "SimpleRnn", "Bidirectional-concat",
          "Bidirectional-add", "Bidirectional-mul", "Bidirectional-ave",
          "GravesBidirectionalLSTM", "LastTimeStep"]


def _layer_net(kind, seed=0):
    layer, seq = _layer(kind)
    head = (jl.RnnOutputLayer(n_out=V, loss="mcxent") if seq
            else jl.OutputLayer(n_out=V, loss="mcxent"))
    conf = (JaxBuilder.builder().set_seed(seed).updater(jupd.rmsprop(LR))
            .list().layer(layer).layer(head)
            .set_input_type(JIT.recurrent(N_IN, T)).build())
    return JaxNet(conf).init()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", LAYERS)
def test_layer_forward_matches_jax(tmp_path, kind, masked):
    jn = _layer_net(kind)
    tn = _port_of(jn, tmp_path)
    x = _x((B, T, N_IN), 1)
    m = _ragged_mask() if masked else None
    ref, _ = jn.layers[0].apply(jn.params[0], jn.state[0], jnp.asarray(x),
                                mask=None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got, _ = tn.layers[0].apply(
            tn.params[0], tn.state[0], torch.from_numpy(x),
            mask=None if m is None else torch.from_numpy(m))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # the whole network (no mask: output() takes none)
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["LSTM", "GravesLSTM", "SimpleRnn"])
def test_apply_rnn_threads_a_carry_like_jax(tmp_path, kind, masked):
    jn = _layer_net(kind, seed=2)
    tn = _port_of(jn, tmp_path)
    x = _x((B, T, N_IN), 3)
    h0, c0 = _x((B, HID), 4), _x((B, HID), 5)
    m = _ragged_mask() if masked else None
    ref, (rh, rc) = jn.layers[0].apply_rnn(
        jn.params[0], jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
        mask=None if m is None else jnp.asarray(m))
    with torch.no_grad():
        got, (gh, gc) = tn.layers[0].apply_rnn(
            tn.params[0], torch.from_numpy(x),
            (torch.from_numpy(h0), torch.from_numpy(c0)),
            mask=None if m is None else torch.from_numpy(m))
    for a, b in ((got, ref), (gh, rh), (gc, rc)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def test_zero_state_is_distinct_and_float32_under_bf16():
    from deeplearning4j_tpu_torch import dtypes
    layer = tl.GravesLSTM(n_in=3, n_out=4)
    with dtypes.policy_scope(dtypes.tpu_bf16()):
        h, c = layer.zero_state(2)
        params, _ = layer.initialize(torch.Generator().manual_seed(0),
                                     InputType.recurrent(3))
        y, _ = layer.apply(params, {}, torch.ones(2, 5, 3,
                                                  dtype=torch.bfloat16))
    assert h.dtype == c.dtype == torch.float32
    assert h.data_ptr() != c.data_ptr()
    assert y.dtype == torch.float32 and params["Wx"].dtype == torch.float32


def test_init_layout_and_forget_gate_bias():
    layer = tl.GravesLSTM(n_in=5, n_out=4, forget_gate_bias_init=0.7)
    p, _ = layer.initialize(torch.Generator().manual_seed(0),
                            InputType.recurrent(5))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "Wx": (5, 16), "Wh": (4, 16), "b": (16,), "wc": (12,)}
    np.testing.assert_array_equal(
        _np(p["b"]), np.float32([0] * 4 + [0.7] * 4 + [0] * 8))
    assert not p["wc"].any()
    bi, _ = tl.Bidirectional(fwd=tl.LSTM(n_out=4)).initialize(
        torch.Generator().manual_seed(0), InputType.recurrent(5))
    assert sorted(bi) == ["bwd", "fwd"]
    assert not torch.equal(bi["fwd"]["Wx"], bi["bwd"]["Wx"])


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_loss_layer_matches_jax(tmp_path, masked):
    conf = (JaxBuilder.builder().set_seed(0).updater(jupd.rmsprop(LR))
            .list().layer(jl.LSTM(n_out=V))
            .layer(jl.RnnLossLayer(activation="softmax", loss="mcxent"))
            .set_input_type(JIT.recurrent(N_IN, T)).build())
    jn = JaxNet(conf).init()
    tn = _port_of(jn, tmp_path)
    assert isinstance(tn.layers[1], tl.RnnLossLayer)
    x = _x((B, T, N_IN), 6)
    y = np.eye(V, dtype=np.float32)[
        np.random.default_rng(7).integers(0, V, (B, T))]
    fm = _ragged_mask() if masked else None
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tn.score(DataSet(x, y, fm)),
                               jn.score(JaxDataSet(x, y, fm)),
                               atol=ATOL, rtol=RTOL)
    jn.fit(JaxDataSet(x, y, fm))
    tn.fit(DataSet(x, y, fm))
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), P_ATOL, RTOL)


# ------------------------------------------------------------ the char-RNN

def _char_builder(seed=0, tbptt=None):
    b = JaxBuilder.builder().set_seed(seed).updater(jupd.rmsprop(LR))
    if tbptt is not None:
        b = b.backprop_type("tbptt", fwd_length=tbptt)
    return b


def _char_mln(seed=0, tbptt=None):
    conf = (_char_builder(seed, tbptt).list()
            .layer(jl.GravesLSTM(n_out=HID, activation="tanh"))
            .layer(jl.GravesLSTM(n_out=HID, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(V, T)).build())
    return JaxNet(conf).init()


def _char_graph(seed=0, tbptt=None):
    conf = (_char_builder(seed, tbptt).graph_builder()
            .add_inputs("in").set_input_types(JIT.recurrent(V, T))
            .add_layer("l1", jl.GravesLSTM(n_out=HID, activation="tanh"),
                       "in")
            .add_layer("l2", jl.GravesLSTM(n_out=HID, activation="tanh"),
                       "l1")
            .add_layer("out", jl.RnnOutputLayer(n_out=V, loss="mcxent"),
                       "l2")
            .set_outputs("out").build())
    return JaxGraph(conf).init()


def _char_data(seed=0, t=T, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, t + 1))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    fm = lm = None
    if masked:
        fm = _ragged_mask(B, t)
        lm = fm.copy()
        lm[1, :2] = 0                    # unscored leading steps
    return x, y, fm, lm


def _ds(graph, x, y, fm, lm, jax_side):
    if not graph:
        return (JaxDataSet if jax_side else DataSet)(x, y, fm, lm)
    cls = JaxMultiDataSet if jax_side else MultiDataSet
    return cls([x], [y], None if fm is None else [fm],
               None if lm is None else [lm])


EXECUTORS = [False, True]               # graph?


def _char_pair(tmp_path, graph, tbptt=None):
    jn = (_char_graph if graph else _char_mln)(tbptt=tbptt)
    return jn, _port_of(jn, tmp_path)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("graph", EXECUTORS)
def test_char_rnn_score_and_gradients_match_jax(tmp_path, graph, masked):
    jn, tn = _char_pair(tmp_path, graph)
    assert isinstance(tn, ComputationGraph if graph else MultiLayerNetwork)
    x, y, fm, lm = _char_data(1, masked=masked)
    np.testing.assert_allclose(tn.score(_ds(graph, x, y, fm, lm, False)),
                               jn.score(_ds(graph, x, y, fm, lm, True)),
                               atol=ATOL, rtol=RTOL)
    jds = _ds(graph, x, y, fm, lm, True)
    batch = jn._batch_tuple(jn._as_multi(jds) if graph else jds)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jn._loss(p, jn.state, batch, None, training=True),
        has_aux=True)(jn.params)
    tds = _ds(graph, x, y, fm, lm, False)
    tloss, tgrads, _ = tn._gradients(
        tn._batch_tuple(tn._as_multi(tds) if graph else tds))
    np.testing.assert_allclose(float(tloss), float(loss), atol=ATOL,
                               rtol=RTOL)
    _assert_trees(tser._flatten(tgrads), _flat(grads), ATOL, RTOL)


@pytest.mark.parametrize("graph", EXECUTORS)
def test_char_rnn_three_rmsprop_steps_match_jax(tmp_path, graph):
    jn, tn = _char_pair(tmp_path, graph)
    x, y, fm, lm = _char_data(2, masked=True)
    for _ in range(3):
        jn.fit(_ds(graph, x, y, fm, lm, True))
        tn.fit(_ds(graph, x, y, fm, lm, False))
    assert tn.iteration_count == jn.iteration_count == 3
    np.testing.assert_allclose(float(tn.score_value), float(jn.score_value),
                               atol=ATOL, rtol=RTOL)
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), P_ATOL, RTOL)
    _assert_trees(tser._flatten(tn.opt_state), _flat(jn.opt_state), 1e-6,
                  1e-3)


class _Losses(TrainingListener):
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, score, batch_size):
        self.losses.append(float(score))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("graph", EXECUTORS)
def test_tbptt_fit_matches_jax(tmp_path, monkeypatch, graph, masked):
    """T=10 in chunks of 4: three updater steps (4, 4, 2 timesteps), the
    carries crossing each boundary; the loss of every chunk, the params
    after the batch and ``iteration_count`` equal the JAX package's."""
    jn, tn = _char_pair(tmp_path, graph, tbptt=4)
    assert tn.conf.conf.tbptt == {"fwd_length": 4, "bwd_length": 20}
    x, y, fm, lm = _char_data(3, t=10, masked=masked)
    rec = _Losses()
    jn.set_listeners(rec)
    seen = []
    step = tn._train_step

    def spy(batch, carries=None):
        assert carries is not None
        assert all(t.grad_fn is None for c in (
            carries.values() if graph else carries) if c is not None
            for t in c)
        out = step(batch, carries)
        seen.append(float(out[0]))
        return out
    monkeypatch.setattr(tn, "_train_step", spy)
    jn.fit(_ds(graph, x, y, fm, lm, True))
    tn.fit(_ds(graph, x, y, fm, lm, False))
    assert tn.iteration_count == jn.iteration_count == 3
    assert len(rec.losses) == 3
    np.testing.assert_allclose(seen, rec.losses, atol=ATOL, rtol=RTOL)
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), P_ATOL, RTOL)


def test_tbptt_carries_cross_chunks_detached_and_are_dropped(tmp_path,
                                                           monkeypatch):
    """Chunk 1 starts from zero carries; chunk 2 from chunk 1's final
    (h, c), nonzero and cut from the graph; none is kept after the
    batch."""
    _, tn = _char_pair(tmp_path, False, tbptt=5)
    x, y, _, _ = _char_data(4, t=10)
    given = []
    step = tn._train_step

    def spy(batch, carries=None):
        given.append(carries)
        return step(batch, carries)
    monkeypatch.setattr(tn, "_train_step", spy)
    tn.fit(DataSet(x, y))
    assert tn.iteration_count == 2 and len(given) == 2
    assert given[0][2] is None and given[1][2] is None   # the output layer
    for i in (0, 1):
        assert all(not t.any() for t in given[0][i])
        assert all(t.any() and t.grad_fn is None for t in given[1][i])
    assert tn._rnn_state is None


# ------------------------------------------------------------ zips, configs

def _zip_net(seed=0):
    conf = (JaxBuilder.builder().set_seed(seed).updater(jupd.rmsprop(LR))
            .list()
            .layer(jl.LSTM(n_out=HID))
            .layer(jl.GravesLSTM(n_out=HID))
            .layer(jl.Bidirectional(fwd=jl.LSTM(n_out=6), mode="concat"))
            .layer(jl.RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(N_IN, T)).build())
    return JaxNet(conf).init()


def test_zips_cross_both_ways_with_updater_state(tmp_path):
    jn = _zip_net()
    x = _x((B, T, N_IN), 8)
    y = np.eye(V, dtype=np.float32)[
        np.random.default_rng(9).integers(0, V, (B, T))]
    jn.fit(JaxDataSet(x, y))                       # nonzero RMSProp state
    tn = _port_of(jn, tmp_path, "jax.zip")
    flat = tser._flatten(tn.params)
    assert {"0/Wx", "1/wc", "2/fwd/Wh", "2/bwd/b"} <= set(flat)
    _assert_trees(flat, _flat(jn.params), 0, 0)
    _assert_trees(tser._flatten(tn.opt_state), _flat(jn.opt_state), 0, 0)
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    # a step in each package from the restored state, then back to JAX
    jn.fit(JaxDataSet(x, y))
    tn.fit(DataSet(x, y))
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), P_ATOL, RTOL)
    path = str(tmp_path / "port.zip")
    tser.write_model(tn, path)
    back = jser.restore_model(path)
    _assert_trees(_flat(back.params), tser._flatten(tn.params), 0, 0)
    _assert_trees(_flat(back.opt_state), tser._flatten(tn.opt_state), 0, 0)
    assert back.iteration_count == tn.iteration_count == 2
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               _np(tn.output(x)), atol=ATOL, rtol=RTOL)


def test_params_from_jax_keeps_the_nested_bidirectional_params(tmp_path):
    jn = _zip_net(seed=3)
    tn = _port_of(jn, tmp_path)
    fresh = MultiLayerNetwork(tn.conf, device="cpu").init(seed=99)
    fresh.set_params(tser.params_from_jax(jax.device_get(jn.params),
                                          device="cpu"))
    assert sorted(fresh.params[2]) == ["bwd", "fwd"]
    x = _x((B, T, N_IN), 10)
    np.testing.assert_allclose(_np(fresh.output(x)), np.asarray(jn.output(x)),
                               atol=ATOL, rtol=RTOL)


def test_configs_round_trip_the_jax_json():
    """A config holding every recurrent type and tBPTT loads into the
    port and writes the JAX package's JSON back (the builder's
    backprop_type included); so does a graph."""
    jconf = (JaxBuilder.builder().set_seed(1).updater(jupd.rmsprop(LR))
             .backprop_type("tbptt", fwd_length=8, bwd_length=8).list()
             .layer(jl.LSTM(n_out=6, forget_gate_bias_init=0.5))
             .layer(jl.GravesLSTM(n_out=6))
             .layer(jl.SimpleRnn(n_out=6))
             .layer(jl.Bidirectional(fwd=jl.LSTM(n_out=4), mode="ave"))
             .layer(jl.GravesBidirectionalLSTM(n_out=4))
             .layer(jl.RnnLossLayer(activation="softmax"))
             .set_input_type(JIT.recurrent(N_IN, T)).build())
    text = jconf.to_json()
    tconf = MultiLayerConfiguration.from_json(text)
    assert tconf.to_json() == text
    assert [type(l).__name__ for l in tconf.layers] == [
        "LSTM", "GravesLSTM", "SimpleRnn", "Bidirectional", "Bidirectional",
        "RnnLossLayer"]
    port = (NeuralNetConfiguration.builder().set_seed(1)
            .updater(tupd.rmsprop(LR))
            .backprop_type("tbptt", fwd_length=8, bwd_length=8).list()
            .layer(tl.LSTM(n_out=6, forget_gate_bias_init=0.5))
            .layer(tl.GravesLSTM(n_out=6))
            .layer(tl.SimpleRnn(n_out=6))
            .layer(tl.Bidirectional(fwd=tl.LSTM(n_out=4), mode="ave"))
            .layer(tl.GravesBidirectionalLSTM(n_out=4))
            .layer(tl.RnnLossLayer(activation="softmax"))
            .set_input_type(InputType.recurrent(N_IN, T)).build())
    assert port.to_json() == text
    gtext = _char_graph(tbptt=4).conf.to_json()
    assert ComputationGraphConfiguration.from_json(gtext).to_json() == gtext


def test_a_conv_before_a_recurrent_layer_gets_the_jax_preprocessor():
    jconf = (JaxBuilder.builder().set_seed(0).list()
             .layer(jl.ConvolutionLayer(n_out=3, kernel=(2, 2)))
             .layer(jl.LSTM(n_out=5))
             .layer(jl.LastTimeStep(underlying=jl.SimpleRnn(n_out=4)))
             .layer(jl.OutputLayer(n_out=2))
             .set_input_type(JIT.convolutional(5, 4, 2)).build())
    port = (NeuralNetConfiguration.builder().set_seed(0).list()
            .layer(tl.ConvolutionLayer(n_out=3, kernel=(2, 2)))
            .layer(tl.LSTM(n_out=5))
            .layer(tl.LastTimeStep(underlying=tl.SimpleRnn(n_out=4)))
            .layer(tl.OutputLayer(n_out=2))
            .set_input_type(InputType.convolutional(5, 4, 2)).build())
    assert port.to_json() == jconf.to_json()
    assert type(port.preprocessors[1]).__name__ == "CnnToRnnPreProcessor"
    x = _x((2, 5, 4, 2), 11)
    jn = JaxNet(jconf).init()
    tn = MultiLayerNetwork(port, device="cpu").init()
    tn.set_params(tser.params_from_jax(jax.device_get(jn.params),
                                       device="cpu"))
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               atol=ATOL, rtol=RTOL)


def test_text_generation_lstm_config_equals_jax():
    for kw in ({}, {"vocab_size": 80, "max_length": 64}):
        zm = tzoo.TextGenerationLSTM(**kw)
        assert zm.conf().to_json() == jzoo.TextGenerationLSTM(
            **kw).conf().to_json()
    net = tzoo.TextGenerationLSTM(vocab_size=11, max_length=6).init(
        device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert [tuple(v.shape) for v in net.params[1].values()] == [
        (256, 1024), (256, 1024), (1024,), (768,)]
    x = np.eye(11, dtype=np.float32)[np.arange(12).reshape(2, 6) % 11]
    probs = _np(net.output(x))
    np.testing.assert_allclose(probs.sum(-1), 1, rtol=1e-5)


def test_graph_pretrain_names_the_slice_that_ports_it(tmp_path):
    # layerwise pretraining is ported (A5b-2, tests/test_torch_pretrain.py):
    # a graph without a pretrainable vertex pretrains nothing, as in JAX
    jn, tn = _char_pair(tmp_path, True)
    before = tn.params_flat()
    assert tn.pretrain(MultiDataSet([np.zeros((1, T, V), np.float32)],
                                    [np.zeros((1, T, V), np.float32)])) is tn
    np.testing.assert_array_equal(tn.params_flat(), before)
    np.testing.assert_array_equal(before, jn.params_flat())


# ------------------------------------------------------------ card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_char_rnn_fit_step_on_card_matches_cpu_with_tf32_off(cuda_device,
                                                             tmp_path):
    """One char-RNN step at the bench leg's width (2 x GravesLSTM(256),
    vocab 80, T=64) with TF32 allowed by the caller: the layers turn it
    off, and the card's loss and params equal the CPU's within float32
    tolerance (TF32's 10-bit mantissa would miss it by orders)."""
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(tupd.rmsprop(LR)).list()
            .layer(tl.GravesLSTM(n_out=256, activation="tanh"))
            .layer(tl.GravesLSTM(n_out=256, activation="tanh"))
            .layer(tl.RnnOutputLayer(n_out=80, loss="mcxent"))
            .set_input_type(InputType.recurrent(80, 64)).build())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 80, (4, 65))
    x = np.eye(80, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(80, dtype=np.float32)[ids[:, 1:]]
    nets = {}
    for dev in ("cpu", "cuda"):
        torch.backends.cuda.matmul.allow_tf32 = True
        net = MultiLayerNetwork(conf, device=dev).init()
        net.fit(DataSet(x, y))
        nets[dev] = net
    assert torch.backends.cuda.matmul.allow_tf32 is False
    np.testing.assert_allclose(float(nets["cuda"].score_value),
                               float(nets["cpu"].score_value), rtol=1e-5)
    _assert_trees(tser._flatten(nets["cuda"].params),
                  tser._flatten(nets["cpu"].params), P_ATOL, RTOL)
