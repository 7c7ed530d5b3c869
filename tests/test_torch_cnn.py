"""The port's convolutional layers and LeNet on MultiLayerNetwork
against the JAX package, on the CPU.

Seeded numpy inputs go through the JAX layer and the port's layer built
from the same config JSON: forward, and the gradients of the input and
of every param under one seeded cotangent. Tolerance, unless a test
derives another: float32 on both sides with sums in another order,
atol=1e-5, rtol=1e-4. Under ``tpu_bf16()`` each layer's output dtype
must equal the JAX layer's. LeNet: config JSON, ``output``, ``score``,
three Adam steps (params and updater state), ``evaluate``, a zip both
ways and ``/v1/predict`` on a JAX and a port ``ModelServer``. The card
tests (``cuda`` marker) hold the f32 conv to TF32 off through ``fit``,
``output`` and a served predict, and train a batch-normalized network
with every tensor on the card.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdtypes
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.evaluation.classification import (
    Evaluation as JaxEvaluation)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JaxNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import dtypes as tdtypes
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.evaluation.classification import Evaluation
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                     DenseLayer,
                                                     OutputLayer,
                                                     SubsamplingLayer,
                                                     layer_from_dict)
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import same_pads
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.model_serializer import (params_from_jax,
                                                            restore_model)

ATOL, RTOL = 1e-5, 1e-4
LR = 1e-3
# Adam moves each element by up to ~lr a step whatever its gradient's
# size, so an element whose gradient is at rounding level may step
# either way: params after Adam steps are held to lr / 20
P_ATOL = LR / 20


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


def _pair(jax_layer, input_type, seed=0):
    """The JAX layer (shape-inferred, initialized) and the port layer
    built from its JSON, with the JAX params and state as numpy."""
    jax_layer.set_n_in(input_type)
    p, s = jax_layer.initialize(jax.random.PRNGKey(seed), input_type)
    port_layer = layer_from_dict(json.loads(json.dumps(jax_layer.to_dict())))
    return (jax_layer, port_layer, jax.tree_util.tree_map(_np, p),
            jax.tree_util.tree_map(_np, s))


def _jax_vjp(layer, params, state, x, ct, training=False):
    def f(p, xx):
        return layer.apply(p, state, xx, training=training)[0]
    y, vjp = jax.vjp(f, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    return _np(y), jax.tree_util.tree_map(_np, gp), _np(gx)


def _port_vjp(layer, params, state, x, ct, training=False):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    st = {k: torch.tensor(v) for k, v in state.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = layer.apply(p, st, xt, training=training)
    leaves = [xt] + list(p.values())
    grads = torch.autograd.grad(y, leaves, torch.tensor(ct))
    return (y.detach().numpy(), dict(zip(p, (g.numpy() for g in grads[1:]))),
            grads[0].numpy())


def _check_layer(jax_layer, input_type, x, *, training=False, atol=ATOL,
                 rtol=RTOL):
    jlay, tlay, p, s = _pair(jax_layer, input_type)
    y_ref = _np(jlay.apply(p, s, jnp.asarray(x), training=training)[0])
    ct = np.random.default_rng(1).standard_normal(y_ref.shape).astype(
        np.float32)
    y, gp, gx = _jax_vjp(jlay, p, s, x, ct, training)
    ty, tgp, tgx = _port_vjp(tlay, p, s, x, ct, training)
    np.testing.assert_allclose(ty, y, atol=atol, rtol=rtol)
    np.testing.assert_allclose(tgx, gx, atol=atol, rtol=rtol)
    assert sorted(tgp) == sorted(gp)
    for k in gp:
        np.testing.assert_allclose(tgp[k], gp[k], atol=atol, rtol=rtol,
                                   err_msg=k)
    return ty


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------- padding

@pytest.mark.parametrize("size,k,s,d", [
    (224, 7, 2, 1), (112, 3, 2, 1), (32, 7, 2, 1), (16, 3, 2, 1),
    (64, 1, 2, 1), (15, 3, 1, 1), (15, 5, 3, 1), (13, 3, 1, 2)])
def test_same_pads_equal_xla(size, k, s, d):
    keff = k + (k - 1) * (d - 1)
    ref = jax.lax.padtype_to_pads((size,), (keff,), (s,), "SAME")[0]
    assert same_pads(size, k, s, d) == tuple(ref)


def test_stem_pads_are_asymmetric():
    assert same_pads(224, 7, 2) == (2, 3)     # ResNet50 stem conv
    assert same_pads(112, 3, 2) == (0, 1)     # ResNet50 stem pool


# ---------------------------------------------------------- layers

@pytest.mark.parametrize("mode,kernel,stride,pad,bias,hw", [
    ("truncate", 5, 1, 0, True, (12, 12)),
    ("truncate", 3, 2, 1, False, (11, 12)),
    ("truncate", 1, 1, 0, True, (8, 8)),
    ("same", 3, 1, 0, True, (9, 10)),
    ("same", 3, 2, 0, False, (16, 16)),
    ("same", 1, 2, 0, False, (16, 16)),
    ("same", 5, 2, 0, True, (13, 13)),
    ("same", 7, 2, 0, False, (32, 32)),      # the stem: pads (2, 3)
])
def test_convolution_matches_jax(mode, kernel, stride, pad, bias, hw):
    layer = jl.ConvolutionLayer(n_out=6, kernel=kernel, stride=stride,
                                padding=pad, convolution_mode=mode,
                                has_bias=bias, activation="relu",
                                bias_init=0.1)
    x = _x((2,) + hw + (3,))
    y = _check_layer(layer, JIT.convolutional(hw[0], hw[1], 3), x)
    out_t = layer.output_type(JIT.convolutional(hw[0], hw[1], 3))
    assert y.shape == (2, out_t.height, out_t.width, 6)


def test_dilated_convolution_matches_jax():
    layer = jl.ConvolutionLayer(n_out=4, kernel=3, dilation=2,
                                convolution_mode="same")
    _check_layer(layer, JIT.convolutional(9, 9, 2), _x((2, 9, 9, 2)))


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode,kernel,stride,pad,hw", [
    ("truncate", 2, 2, 0, (8, 8)),
    ("truncate", 3, 2, 1, (9, 9)),
    ("same", 3, 2, 0, (16, 16)),             # the stem pool: pads (0, 1)
    ("same", 3, 1, 0, (7, 6)),
    ("same", 2, 2, 0, (7, 7)),
])
def test_subsampling_matches_jax(pooling, mode, kernel, stride, pad, hw):
    layer = jl.SubsamplingLayer(pooling=pooling, kernel=kernel,
                                stride=stride, padding=pad,
                                convolution_mode=mode, pnorm=3)
    _check_layer(layer, JIT.convolutional(hw[0], hw[1], 4),
                 _x((2,) + hw + (4,)))


def test_batch_norm_training_state_and_inference_match_jax():
    # a well-conditioned batch (mean 0, std 1): the biased variance
    # E[x^2] - E[x]^2 cancels little, so float32 sums in another order
    # stay within the default tolerance
    it = JIT.convolutional(6, 5, 8)
    x = _x((4, 6, 5, 8))
    layer = jl.BatchNormalization(activation="relu", decay=0.8)
    jlay, tlay, p, s = _pair(layer, it)
    p = {"gamma": _x((8,), 3) * 0.1 + 1.0, "beta": _x((8,), 4) * 0.1}
    s = {"mean": _x((8,), 5) * 0.1, "var": np.abs(_x((8,), 6)) + 0.5}
    ct = _x((4, 6, 5, 8), 7)
    for training in (True, False):
        y, gp, gx = _jax_vjp(jlay, p, s, x, ct, training)
        ty, tgp, tgx = _port_vjp(tlay, p, s, x, ct, training)
        np.testing.assert_allclose(ty, y, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tgx, gx, atol=ATOL, rtol=RTOL)
        for k in gp:
            np.testing.assert_allclose(tgp[k], gp[k], atol=ATOL, rtol=RTOL)
        _, js = jlay.apply(p, s, jnp.asarray(x), training=training)
        _, ts = tlay.apply({k: torch.tensor(v) for k, v in p.items()},
                           {k: torch.tensor(v) for k, v in s.items()},
                           torch.tensor(x), training=training)
        for k in ("mean", "var"):
            assert ts[k].dtype == torch.float32
            assert not ts[k].requires_grad
            np.testing.assert_allclose(ts[k].numpy(), _np(js[k]),
                                       atol=ATOL, rtol=RTOL)


def test_batch_norm_state_uses_the_biased_variance():
    layer = layer_from_dict(jl.BatchNormalization(n_out=3).to_dict())
    p, s = layer.initialize(None, InputType.feed_forward(3))
    x = torch.tensor(_x((5, 3)))
    _, new = layer.apply(p, s, x, training=True)
    biased = x.var(dim=0, unbiased=False)
    torch.testing.assert_close(new["var"], 0.9 + 0.1 * biased)
    torch.testing.assert_close(new["mean"], 0.1 * x.mean(dim=0))


def test_batch_norm_on_feed_forward_input_and_locked_gamma_beta():
    _check_layer(jl.BatchNormalization(), JIT.feed_forward(7), _x((5, 7)),
                 training=True)
    _check_layer(jl.BatchNormalization(lock_gamma_beta=True, gamma=2.0,
                                       beta=0.5),
                 JIT.feed_forward(7), _x((5, 7)), training=True)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_cnn_matches_jax(pooling):
    _check_layer(jl.GlobalPoolingLayer(pooling=pooling, pnorm=3),
                 JIT.convolutional(5, 4, 6), _x((3, 5, 4, 6)))


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_masked_rnn_matches_jax(pooling):
    layer = jl.GlobalPoolingLayer(pooling=pooling)
    x = _x((3, 6, 4))
    mask = np.array([[1] * 6, [1] * 3 + [0] * 3, [1] + [0] * 5],
                    np.float32)
    jlay, tlay, p, s = _pair(layer, JIT.recurrent(4, 6))
    ref = _np(jlay.apply(p, s, jnp.asarray(x), mask=jnp.asarray(mask))[0])
    got, _ = tlay.apply(p, s, torch.tensor(x), mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,it", [
    ((4, 7), JIT.feed_forward(7)),
    ((2, 5, 7), JIT.recurrent(7, 5)),
    ((2, 3, 3, 2), JIT.convolutional(3, 3, 2)),   # flattens in H.W.C order
])
def test_dense_matches_jax(shape, it):
    _check_layer(jl.DenseLayer(n_out=5, activation="tanh", bias_init=0.2),
                 it, _x(shape))


def test_activation_and_dropout_layers_match_jax():
    _check_layer(jl.ActivationLayer(activation="relu"), JIT.feed_forward(6),
                 _x((3, 6)))
    _check_layer(jl.DropoutLayer(dropout=0.5), JIT.feed_forward(6),
                 _x((3, 6)))   # identity at inference


def test_dropout_layer_drops_at_training():
    layer = layer_from_dict(jl.DropoutLayer(dropout=0.5).to_dict())
    g = torch.Generator().manual_seed(0)
    x = torch.ones(64, 64)
    y, _ = layer.apply({}, {}, x, training=True, generator=g)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("name,kw,shape,it", [
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=4, channels=2),
     (2, 3, 4, 2), JIT.convolutional(3, 4, 2)),
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 24), JIT.convolutional_flat(3, 4, 2)),
    ("RnnToFeedForwardPreProcessor", {}, (2, 5, 3), JIT.recurrent(3, 5)),
    ("FeedForwardToRnnPreProcessor", dict(timesteps=5), (10, 3),
     JIT.feed_forward(3)),
    ("CnnToRnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 3, 4, 2), JIT.convolutional(3, 4, 2)),
    ("RnnToCnnPreProcessor", dict(height=2, width=3, channels=2),
     (2, 4, 3), JIT.recurrent(3, 4)),
])
def test_preprocessors_match_jax(name, kw, shape, it):
    jp = getattr(jpp, name)(**kw)
    tp = tpp.preprocessor_from_dict(jp.to_dict())
    assert tp.to_dict() == jp.to_dict()
    x = _x(shape)
    np.testing.assert_array_equal(tp(torch.tensor(x)).numpy(),
                                  _np(jp(jnp.asarray(x))))
    assert tp.output_type(InputType.from_dict(it.to_dict())).to_dict() \
        == jp.output_type(it).to_dict()


def test_unknown_preprocessor_is_named():
    with pytest.raises(ValueError, match="'Nope'"):
        tpp.preprocessor_from_dict({"@type": "Nope"})


# ------------------------------------------------------ bf16 policy

@pytest.mark.parametrize("jax_layer,it,shape", [
    (jl.ConvolutionLayer(n_out=4, kernel=3, has_bias=False),
     JIT.convolutional(6, 6, 3), (2, 6, 6, 3)),
    (jl.ConvolutionLayer(n_out=4, kernel=3), JIT.convolutional(6, 6, 3),
     (2, 6, 6, 3)),
    (jl.DenseLayer(n_out=4, has_bias=False), JIT.feed_forward(5), (3, 5)),
    (jl.DenseLayer(n_out=4), JIT.feed_forward(5), (3, 5)),
    (jl.BatchNormalization(), JIT.convolutional(4, 4, 3), (2, 4, 4, 3)),
    (jl.SubsamplingLayer(convolution_mode="same"),
     JIT.convolutional(5, 5, 3), (2, 5, 5, 3)),
    (jl.OutputLayer(n_out=3), JIT.feed_forward(5), (3, 5)),
])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_bf16_policy_dtype_flow_matches_jax(jax_layer, it, shape, in_dtype):
    jlay, tlay, p, s = _pair(jax_layer, it)
    x = _x(shape)
    with jdtypes.policy_scope(jdtypes.tpu_bf16()):
        jy, _ = jlay.apply(p, s, jnp.asarray(x, in_dtype), training=True)
    with tdtypes.policy_scope(tdtypes.tpu_bf16()):
        ty, _ = tlay.apply({k: torch.tensor(v) for k, v in p.items()},
                           {k: torch.tensor(v) for k, v in s.items()},
                           torch.tensor(x).to(getattr(torch, in_dtype)),
                           training=True)
    assert str(ty.dtype).replace("torch.", "") == str(jy.dtype)
    # bf16 keeps 8 significant bits: a product rounded to bf16 is within
    # 2^-8 of its value, relative to the output's scale
    scale = float(np.abs(_np(jy)).max()) + 1e-6
    np.testing.assert_allclose(ty.float().numpy(), _np(jy),
                               atol=2 ** -7 * scale, rtol=2 ** -7)
    assert tdtypes.policy() == tdtypes.default_policy()


def test_policy_api():
    p = tdtypes.tpu_bf16()
    assert (p.param_dtype, p.compute_dtype, p.output_dtype) == (
        torch.float32, torch.bfloat16, torch.bfloat16)
    assert tdtypes.highest_precision() == tdtypes.default_policy()
    x = torch.ones(2)
    assert p.cast_to_compute(x).dtype == torch.bfloat16
    try:
        tdtypes.set_policy(p)
        assert tdtypes.policy() is p
    finally:
        tdtypes.set_policy(tdtypes.default_policy())
    assert tdtypes.promote_half(x.bfloat16()).dtype == torch.float32


# ---------------------------------------------------------- configs

def test_builder_config_equals_jax():
    def build(b, L, IT, upd):
        return (b.builder().set_seed(7).updater(upd.adam(1e-3))
                .weight_init("relu").activation("tanh").l2(1e-4)
                .drop_out(0.1)
                .list()
                .layer(L.ConvolutionLayer(n_out=4, kernel=(3, 3)))
                .layer(L.SubsamplingLayer(pooling="avg"))
                .layer(L.DenseLayer(n_out=8))
                .layer(L.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(IT.convolutional_flat(10, 10, 1))
                .build())
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    jc = build(JaxBuilder, jl, JIT, jupd)
    tc = build(NeuralNetConfiguration, tl, InputType, tupd)
    assert tc.to_json() == jc.to_json()
    assert sorted(tc.preprocessors) == [0, 2]
    assert MultiLayerConfiguration.from_json(tc.to_json()).to_json() \
        == tc.to_json()


@pytest.mark.parametrize("name", [
    "LeNet", "SimpleCNN", "VGG16", "VGG19", "AlexNet", "ResNet50",
    "GoogLeNet", "InceptionResNetV1", "FaceNetNN4Small2",
    "TextGenerationLSTM", "TinyYOLO", "Darknet19", "UNet"])
def test_zoo_config_equals_jax(name):
    # all thirteen zoo models (A5b-2), on either executor
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    kw = {} if name == "TextGenerationLSTM" else {"n_classes": 10}
    jc = getattr(jzoo.models, name)(**kw).conf()
    tc = getattr(tzoo, name)(**kw).conf()
    assert tc.to_json() == jc.to_json()
    cls = (MultiLayerConfiguration if isinstance(tc, MultiLayerConfiguration)
           else ComputationGraphConfiguration)
    assert cls.from_json(jc.to_json()).to_json() == jc.to_json()
    assert set(tzoo.available_models()) == set(jzoo.available_models())


def test_simple_cnn_output_matches_jax():
    jn = jzoo.models.SimpleCNN(n_classes=4, input_shape=(12, 12, 3)).init()
    tn = tzoo.SimpleCNN(n_classes=4, input_shape=(12, 12, 3)).init(
        device="cpu")
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    x = _x((2, 12, 12, 3))
    np.testing.assert_allclose(tn.output(x).numpy(), _np(jn.output(x)),
                               atol=ATOL, rtol=RTOL)


# ----------------------------------------------------- LeNet on MLN

@pytest.fixture(scope="module")
def lenet_pair():
    jn = jzoo.models.LeNet(n_classes=10, updater=jupd.adam(LR)).init()
    tn = tzoo.LeNet(n_classes=10, updater=tupd.adam(LR)).init(device="cpu")
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    return jn, tn


def _digits(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def test_lenet_output_and_score_match_jax(lenet_pair):
    jn, tn = lenet_pair
    x, y = _digits()
    np.testing.assert_allclose(tn.output(x).numpy(), _np(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tn.score(DataSet(x, y)),
                               jn.score(JaxDataSet(x, y)), atol=ATOL,
                               rtol=RTOL)
    assert tn.output(x.astype(np.float64)).dtype == torch.float32
    assert tn.num_params() == sum(int(np.size(v)) for v in
                                  jax.tree_util.tree_leaves(jn.params))
    np.testing.assert_array_equal(tn.params_flat(), jn.params_flat())


def test_lenet_three_adam_steps_match_jax():
    jn = jzoo.models.LeNet(n_classes=10, updater=jupd.adam(LR)).init()
    tn = tzoo.LeNet(n_classes=10, updater=tupd.adam(LR)).init(device="cpu")
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    tn._build_optimizer()
    for step in range(3):
        x, y = _digits(seed=step)
        jn.fit(JaxDataSet(x, y))
        tn.fit(DataSet(x, y))
        np.testing.assert_allclose(float(tn.score_value),
                                   float(jn.score_value), atol=ATOL,
                                   rtol=RTOL)
    _assert_trees(tser._flatten(tn.params), _flat(jn.params), P_ATOL, RTOL)
    _assert_trees(tser._flatten(tn.opt_state), _flat(jn.opt_state),
                  ATOL, RTOL)
    assert tn.iteration_count == jn.iteration_count == 3


def test_lenet_evaluate_matches_jax(lenet_pair):
    jn, tn = lenet_pair
    x, y = _digits(32, seed=5)
    je = jn.evaluate(JaxDataSet(x, y))
    te = tn.evaluate(DataSet(x, y))
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    for m in ("accuracy", "precision", "recall", "f1"):
        assert getattr(te, m)() == getattr(je, m)()


def test_evaluation_metrics_match_jax():
    rng = np.random.default_rng(3)
    labels = np.eye(5)[rng.integers(0, 5, 40)]
    preds = rng.random((40, 5))
    je, te = JaxEvaluation(), Evaluation()
    je.eval(labels, preds, top_n=2)
    te.eval(labels, preds, top_n=2)
    np.testing.assert_array_equal(te.confusion.matrix, je.confusion.matrix)
    for m in ("accuracy", "precision", "recall", "f1", "top_n_accuracy"):
        assert getattr(te, m)() == getattr(je, m)()
    assert te.f1(2) == je.f1(2) and te.stats() == je.stats()


def test_lenet_set_params_flat_round_trip(lenet_pair):
    _, tn = lenet_pair
    net = tzoo.LeNet(n_classes=10).init(device="cpu")
    net.set_params_flat(tn.params_flat())
    np.testing.assert_array_equal(net.params_flat(), tn.params_flat())


def test_lenet_bf16_output_within_derived_tolerance(lenet_pair):
    jn, tn = lenet_pair
    x, _ = _digits()
    ref32 = _np(jn.output(x))
    with jdtypes.policy_scope(jdtypes.tpu_bf16()):
        jb = _np(jax.jit(lambda p, s, xx: jn._forward(
            p, s, xx, training=False, rng=None)[0])(jn.params, jn.state,
                                                     jnp.asarray(x)))
        jacts = jn.feed_forward(x)
    with tdtypes.policy_scope(tdtypes.tpu_bf16()):
        tb = tn.output(x)
        h = torch.tensor(x)
        tdt = []
        for i, layer in enumerate(tn.layers):
            if i in tn.conf.preprocessors:
                h = tn.conf.preprocessors[i](h)
            h, _ = layer.apply(tn.params[i], tn.state[i], h)
            tdt.append(str(h.dtype).replace("torch.", ""))
    assert tdt == [str(a.dtype) for a in jacts]
    assert tb.dtype == torch.float32
    # the port under bf16 is held to twice the distance bf16 puts the
    # JAX package from its own float32 result (and never closer than a
    # bf16 rounding of a probability, 2^-8)
    tol = max(2 * float(np.abs(jb - ref32).max()), 2 ** -8)
    np.testing.assert_allclose(tb.numpy(), jb, atol=tol, rtol=0)


# ------------------------------------------------ zips and serving

def test_lenet_zip_crosses_both_ways(lenet_pair, tmp_path):
    jn, tn = lenet_pair
    x, y = _digits()
    jn.fit(JaxDataSet(x, y))
    jzip = str(tmp_path / "jax.zip")
    jser.write_model(jn, jzip)
    port = restore_model(jzip, device="cpu")
    assert isinstance(port, MultiLayerNetwork)
    np.testing.assert_allclose(port.output(x).numpy(), _np(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    _assert_trees(tser._flatten(port.opt_state), _flat(jn.opt_state), 0, 0)
    tzip = str(tmp_path / "port.zip")
    tser.write_model(port, tzip)
    back = jser.restore_model(tzip)
    assert isinstance(back, JaxNet)
    np.testing.assert_allclose(_np(back.output(x)), _np(jn.output(x)),
                               atol=ATOL, rtol=RTOL)
    _assert_trees(_flat(back.opt_state), _flat(jn.opt_state), 0, 0)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_lenet_predict_on_jax_and_port_servers(lenet_pair, tmp_path):
    jn, _ = lenet_pair
    path = str(tmp_path / "lenet.zip")
    jser.write_model(jn, path)
    jr, tr = JaxRegistry(), ModelRegistry()
    jr.register("lenet", jser.restore_model(path))
    tr.register("lenet", restore_model(path, device="cpu"))
    js = JaxServer(jr, wait_ms=5.0).start()
    ts = ModelServer(tr, wait_ms=5.0).start()
    try:
        x, _ = _digits(4, seed=9)
        body = {"model": "lenet", "inputs": x.tolist()}
        jc, jb = _post(js.port, body)
        tc, tb = _post(ts.port, body)
    finally:
        js.stop()
        ts.stop()
    assert jc == tc == 200
    out = np.asarray(tb["outputs"], np.float32)
    assert out.shape == (4, 10)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jb["outputs"], np.float32),
                               atol=ATOL, rtol=RTOL)


# -------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_f32_conv_runs_with_tf32_off_through_fit_output_and_serve(
        cuda_device, tmp_path):
    # a wide reduction (C_in = 256 at 3x3) where TF32's 10-bit mantissa
    # would show: f32 on the CUDA cores stays within 1e-5 of float64
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(tupd.sgd(1e-3)).list()
            .layer(ConvolutionLayer(n_out=32, kernel=3))
            .layer(SubsamplingLayer(pooling="avg", kernel=2, stride=2))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4))
            .set_input_type(InputType.convolutional(8, 8, 256)).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    x = _x((4, 8, 8, 256), 11)
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]

    def reference(net):
        w = net.params[0]["W"].detach().double().cpu()
        xd = torch.tensor(x, dtype=torch.float64).permute(0, 3, 1, 2)
        return torch.nn.functional.conv2d(
            xd, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1) \
            + net.params[0]["b"].detach().double().cpu()

    for call in ("output", "fit", "serve"):
        torch.backends.cudnn.allow_tf32 = True
        if call == "output":
            net.output(x)
        elif call == "fit":
            net.fit(DataSet(x, y))
        else:
            path = str(tmp_path / "net.zip")
            tser.write_model(net, path)
            reg = ModelRegistry()
            reg.register("m", restore_model(path, device="cuda"))
            s = ModelServer(reg, wait_ms=1.0).start()
            try:
                code, _ = _post(s.port, {"model": "m",
                                         "inputs": x[:2].tolist()})
            finally:
                s.stop()
            assert code == 200
        assert torch.backends.cudnn.allow_tf32 is False, call
        conv = net.layers[0]
        with torch.no_grad():
            got = conv.apply(net.params[0], {}, torch.tensor(x).cuda())[0]
        torch.testing.assert_close(got.double().cpu(), reference(net),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_batch_norm_network_trains_on_the_card(cuda_device):
    # SimpleCNN on MultiLayerNetwork: conv, BN state, dropout, global
    # pooling, all on the card
    net = tzoo.SimpleCNN(n_classes=4, input_shape=(12, 12, 3)).init(
        device="cuda")
    x = _x((16, 12, 12, 3), 12)
    y = np.eye(4, dtype=np.float32)[np.arange(16) % 4]
    before = [{k: v.clone() for k, v in s.items()} for s in net.state]
    net.fit(DataSet(x, y))
    assert np.isfinite(float(net.score_value))
    moved = 0
    for old, new in zip(before, net.state):
        for k, v in new.items():
            assert v.device.type == "cuda"
            moved += int(not torch.equal(v, old[k]))
    assert moved == 6                 # mean and var of three BN layers
    assert net.output(x).device.type == "cuda"
