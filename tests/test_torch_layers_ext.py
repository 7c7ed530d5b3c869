"""The port's conv-family, 1-d pooling and normalization layers that
Keras import maps to (``Convolution1DLayer``, ``Deconvolution2DLayer``,
``DepthwiseConvolution2DLayer``, ``SeparableConvolution2DLayer``,
``ZeroPaddingLayer``, ``ZeroPadding1DLayer``, ``UpsamplingLayer``,
``CroppingLayer``, ``SpaceToDepthLayer``, ``SpaceToBatchLayer``,
``Subsampling1DLayer``, ``LayerNormalization``,
``LocalResponseNormalization``) against the JAX package, on the CPU.

Each layer is built from the JAX layer's JSON and fed the same seeded
numpy input: the forward, the input gradient and every parameter
gradient under one seeded cotangent, float32 on both sides with sums in
another order: atol=1e-5, rtol=1e-4 (``test_torch_cnn._check_layer``).
The cases run over kernel parity, stride, dilation, ``same`` /
``truncate`` and ``depth_multiplier``. One checkpoint zip written by the
JAX package holds every new ``@type`` in a two-input graph and restores
in the port with the same config JSON and outputs.
"""

import json

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.models.multi_layer_network import (
    MultiLayerNetwork as JaxNet)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers import (LAYER_REGISTRY,
                                                     layer_from_dict)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.util.model_serializer import (params_from_jax,
                                                            restore_model)
from test_torch_cnn import ATOL, RTOL, _check_layer, _x

NEW_TYPES = ("Convolution1DLayer", "Deconvolution2DLayer",
             "DepthwiseConvolution2DLayer", "SeparableConvolution2DLayer",
             "ZeroPaddingLayer", "ZeroPadding1DLayer", "UpsamplingLayer",
             "CroppingLayer", "SpaceToDepthLayer", "SpaceToBatchLayer",
             "Subsampling1DLayer", "LayerNormalization",
             "LocalResponseNormalization")

MODES = ("truncate", "same")


def test_every_layer_class_of_the_three_files_is_registered():
    from deeplearning4j_tpu.nn.conf.layers import (convolutional,
                                                   normalization, pooling)
    names = set()
    for mod in (convolutional, normalization, pooling):
        names |= {n for n in mod.__all__ if n != "PoolingType"}
    assert names - set(LAYER_REGISTRY) == set()
    assert set(NEW_TYPES) <= names


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,s,d", [(2, 1, 1), (3, 1, 1), (3, 2, 1),
                                   (2, 2, 1), (3, 1, 2), (4, 3, 1)])
def test_convolution1d(k, s, d, mode):
    layer = jl.Convolution1DLayer(n_out=5, kernel=k, stride=s, dilation=d,
                                  convolution_mode=mode, activation="tanh")
    _check_layer(layer, JIT.recurrent(4, 11), _x((2, 11, 4)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,s,p", [(1, 2, 0), (2, 1, 0), (2, 2, 0),
                                   (3, 1, 0), (3, 2, 0), (3, 2, 1),
                                   (4, 2, 1), (2, 3, 0), (5, 3, 2)])
def test_deconvolution2d(k, s, p, mode):
    layer = jl.Deconvolution2DLayer(n_out=3, kernel=k, stride=s, padding=p,
                                    convolution_mode=mode,
                                    activation="identity")
    y = _check_layer(layer, JIT.convolutional(5, 6, 4), _x((2, 5, 6, 4)))
    if mode == "same":
        assert y.shape == (2, 5 * s, 6 * s, 3)


def test_deconvolution2d_rectangular_kernel_and_stride():
    layer = jl.Deconvolution2DLayer(n_out=2, kernel=(2, 3), stride=(1, 2),
                                    convolution_mode="same")
    _check_layer(layer, JIT.convolutional(4, 5, 3), _x((2, 4, 5, 3)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,s,d,mult", [(3, 1, 1, 1), (2, 1, 1, 2),
                                        (3, 2, 1, 2), (3, 1, 2, 1),
                                        (2, 2, 1, 3)])
def test_depthwise(k, s, d, mult, mode):
    layer = jl.DepthwiseConvolution2DLayer(
        kernel=k, stride=s, dilation=d, depth_multiplier=mult,
        convolution_mode=mode, activation="relu")
    _check_layer(layer, JIT.convolutional(9, 8, 3), _x((2, 9, 8, 3)))
    assert layer.n_out == 3 * mult


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,s,d,mult", [(3, 1, 1, 1), (2, 1, 1, 2),
                                        (3, 2, 1, 2), (3, 1, 2, 1)])
def test_separable(k, s, d, mult, mode):
    layer = jl.SeparableConvolution2DLayer(
        n_out=4, kernel=k, stride=s, dilation=d, depth_multiplier=mult,
        convolution_mode=mode, activation="elu")
    _check_layer(layer, JIT.convolutional(9, 8, 3), _x((2, 9, 8, 3)))


@pytest.mark.parametrize("layer,shape", [
    (jl.ZeroPaddingLayer(pad=1), (2, 4, 5, 3)),
    (jl.ZeroPaddingLayer(pad=((1, 2), (0, 3))), (2, 4, 5, 3)),
    (jl.ZeroPadding1DLayer(pad=(2, 1)), (2, 6, 3)),
    (jl.UpsamplingLayer(size=(2, 3)), (2, 3, 4, 2)),
    (jl.CroppingLayer(crop=((1, 0), (2, 1))), (2, 6, 7, 3)),
    (jl.CroppingLayer(crop=1), (2, 6, 7, 3)),
    (jl.SpaceToDepthLayer(block_size=2), (2, 4, 6, 3)),
    (jl.SpaceToBatchLayer(block_size=2), (2, 4, 6, 3)),
    (jl.LocalResponseNormalization(), (2, 3, 4, 7)),
    (jl.LocalResponseNormalization(n=3, k=1.0, alpha=0.5, beta=0.5),
     (2, 3, 4, 5)),
], ids=lambda v: type(v).__name__ if not isinstance(v, tuple) else
    "x".join(map(str, v)))
def test_shape_layers(layer, shape):
    """Element for element (the block order of SpaceToDepth and
    SpaceToBatch included): float32 and no sums but LRN's."""
    it = (JIT.recurrent(shape[-1], shape[1]) if len(shape) == 3
          else JIT.convolutional(*shape[1:]))
    y = _check_layer(layer, it, _x(shape))
    if len(shape) == 4 and not isinstance(
            layer, (jl.LocalResponseNormalization, jl.SpaceToBatchLayer)):
        assert layer.output_type(it).array_shape()[1:] == y.shape[1:]


@pytest.mark.parametrize("pooling", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k,s", [(2, 2), (3, 1), (3, 2)])
def test_subsampling1d(pooling, mode, k, s):
    layer = jl.Subsampling1DLayer(pooling=pooling, kernel=k, stride=s,
                                  convolution_mode=mode)
    x = _x((2, 9, 4))
    if pooling == "pnorm":
        x = x + np.sign(x) * 0.1      # |x|^p has no gradient at 0
    _check_layer(layer, JIT.recurrent(4, 9), x)


@pytest.mark.parametrize("shape", [(3, 7, 6), (4, 6)])
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_layer_normalization(shape, eps):
    layer = jl.LayerNormalization(eps=eps)
    it = (JIT.recurrent(shape[-1], shape[1]) if len(shape) == 3
          else JIT.feed_forward(shape[-1]))
    layer.set_n_in(it)
    _check_layer(layer, it, 1.5 * _x(shape) + 0.7)


def test_layer_normalization_defaults_match():
    assert layer_from_dict(jl.LayerNormalization().to_dict()).eps == 1e-5


# ------------------------------------------- one JAX zip, every new type

def _every_new_type_graph():
    g = (JaxBuilder.builder().set_seed(3).graph_builder()
         .add_inputs("img", "seq")
         .set_input_types(JIT.convolutional(8, 8, 3), JIT.recurrent(5, 10))
         .add_layer("zp", jl.ZeroPaddingLayer(pad=1), "img")
         .add_layer("dw", jl.DepthwiseConvolution2DLayer(
             kernel=3, depth_multiplier=2, activation="relu"), "zp")
         .add_layer("sep", jl.SeparableConvolution2DLayer(
             n_out=4, kernel=3, convolution_mode="same"), "dw")
         .add_layer("lrn", jl.LocalResponseNormalization(n=3), "sep")
         .add_layer("up", jl.UpsamplingLayer(size=2), "lrn")
         .add_layer("crop", jl.CroppingLayer(crop=2), "up")
         .add_layer("deconv", jl.Deconvolution2DLayer(
             n_out=3, kernel=2, stride=2), "crop")
         .add_layer("s2d", jl.SpaceToDepthLayer(block_size=2), "deconv")
         .add_layer("s2b", jl.SpaceToBatchLayer(block_size=2), "s2d")
         .add_layer("gp", jl.GlobalPoolingLayer(pooling="avg"), "s2b")
         .add_layer("out_img", jl.OutputLayer(n_out=2), "gp")
         .add_layer("zp1", jl.ZeroPadding1DLayer(pad=(1, 2)), "seq")
         .add_layer("c1", jl.Convolution1DLayer(
             n_out=6, kernel=3, activation="tanh"), "zp1")
         .add_layer("p1", jl.Subsampling1DLayer(kernel=2, stride=2), "c1")
         .add_layer("ln", jl.LayerNormalization(), "p1")
         .add_layer("out_seq", jl.RnnOutputLayer(n_out=3), "ln")
         .set_outputs("out_img", "out_seq")
         .build())
    return JaxGraph(g).init()


def test_jax_zip_with_every_new_type_restores_in_the_port(tmp_path):
    jn = _every_new_type_graph()
    types = {v["config"]["@type"] for v in json.loads(jn.conf.to_json())[
        "vertices"].values() if v["kind"] == "layer"}
    assert set(NEW_TYPES) <= types, set(NEW_TYPES) - types
    path = str(tmp_path / "every.zip")
    jser.write_model(jn, path)
    tn = restore_model(path, device="cpu")
    assert tn.conf.to_json() == jn.conf.to_json()
    assert ComputationGraphConfiguration.from_json(
        jn.conf.to_json()).to_json() == jn.conf.to_json()
    img, seq = _x((3, 8, 8, 3)), _x((3, 10, 5), seed=1)
    for t, j in zip(tn.output(img, seq), jn.output(img, seq)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=RTOL)
    assert tn.output(img, seq)[0].shape == (12, 2)


def test_sequential_conf_inserts_the_jax_preprocessors():
    """The auto-inserted preprocessors around the new layers (a dense
    input reshaped for upsampling, a conv output flattened after
    SpaceToDepth, Conv1D and 1-d pooling taking sequences) are the JAX
    builder's."""
    conf = (JaxBuilder.builder().set_seed(1).list()
            .layer(jl.UpsamplingLayer(size=2))
            .layer(jl.SpaceToDepthLayer(block_size=2))
            .layer(jl.DenseLayer(n_out=4))
            .layer(jl.OutputLayer(n_out=2))
            .set_input_type(JIT.convolutional_flat(4, 4, 2)).build())
    seq = (JaxBuilder.builder().set_seed(1).list()
           .layer(jl.ConvolutionLayer(n_out=3, kernel=1))
           .layer(jl.Convolution1DLayer(n_out=4, kernel=2))
           .layer(jl.Subsampling1DLayer(kernel=2))
           .layer(jl.RnnOutputLayer(n_out=2))
           .set_input_type(JIT.convolutional(6, 1, 2)).build())
    for c in (conf, seq):
        js = c.to_json()
        assert MultiLayerConfiguration.from_json(js).to_json() == js
        assert json.loads(js)["preprocessors"]
    jn = JaxNet(conf).init()
    x = _x((2, 32))
    tn = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu").init()
    tn.set_params(params_from_jax(jax.device_get(jn.params), device="cpu"))
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x)), atol=ATOL,
                               rtol=RTOL)
