"""Model zoo (counterpart of ``deeplearning4j_tpu/zoo/models.py``): the
same configs, built with the port's builder, so a zoo model's JSON
equals the JAX package's. All image models are NHWC.

Ported: ``LeNet``, ``SimpleCNN``, ``VGG16``, ``VGG19``,
``TextGenerationLSTM`` (on MultiLayerNetwork) and ``ResNet50`` (on
ComputationGraph). The models that need layers not ported yet (AlexNet's
LRN, GoogLeNet, InceptionResNetV1, FaceNetNN4Small2, TinyYOLO,
Darknet19, UNet) and the pretrained-weights manifest
(``init_pretrained``, which downloads) are not (ROADMAP A5b-2).
"""

from __future__ import annotations

from typing import Optional, Tuple

from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf import updaters
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, GlobalPoolingLayer, GravesLSTM, OutputLayer, PoolingType,
    RnnOutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "VGG16", "VGG19",
           "TextGenerationLSTM", "ResNet50"]


class ZooModel:
    """Base (zoo/ZooModel.java): ``conf()`` builds the configuration,
    ``init(device=...)`` the initialized network."""

    name: str = "zoo"

    def __init__(self, n_classes: int = 1000, seed: int = 123,
                 input_shape: Optional[Tuple[int, ...]] = None,
                 updater: Optional[dict] = None):
        self.n_classes = n_classes
        self.seed = seed
        self.input_shape = input_shape or self.default_input_shape()
        self.updater = updater or updaters.nesterovs(1e-2, 0.9)

    def default_input_shape(self) -> Tuple[int, ...]:
        return (224, 224, 3)

    def conf(self):
        raise NotImplementedError

    def init(self, device="cuda"):
        c = self.conf()
        if isinstance(c, MultiLayerConfiguration):
            return MultiLayerNetwork(c, device=device).init(self.seed)
        return ComputationGraph(c, device=device).init(self.seed)

    def _builder(self):
        return (NeuralNetConfiguration.builder()
                .set_seed(self.seed)
                .updater(self.updater))


class LeNet(ZooModel):
    """(zoo/model/LeNet.java)."""

    name = "lenet"

    def default_input_shape(self):
        return (28, 28, 1)

    def conf(self):
        h, w, c = self.input_shape
        return (self._builder().list()
                .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.n_classes, loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """(zoo/model/SimpleCNN.java)."""

    name = "simplecnn"

    def default_input_shape(self):
        return (48, 48, 3)

    def conf(self):
        h, w, c = self.input_shape
        b = self._builder().list()
        for n_out in (16, 32):
            b = (b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                          convolution_mode="same"))
                 .layer(BatchNormalization(activation="relu"))
                 .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2))))
        b = (b.layer(ConvolutionLayer(n_out=64, kernel=(3, 3),
                                      convolution_mode="same"))
             .layer(BatchNormalization(activation="relu"))
             .layer(DropoutLayer(dropout=0.3))
             .layer(GlobalPoolingLayer(pooling=PoolingType.AVG))
             .layer(OutputLayer(n_out=self.n_classes, loss="mcxent")))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


def _vgg_blocks(b, plan):
    for n_convs, n_out in plan:
        for _ in range(n_convs):
            b = b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                         convolution_mode="same",
                                         activation="relu"))
        b = b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
    return b


class VGG16(ZooModel):
    """(zoo/model/VGG16.java)."""

    name = "vgg16"
    plan = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def conf(self):
        h, w, c = self.input_shape
        b = _vgg_blocks(self._builder().list(), self.plan)
        return (b.layer(DenseLayer(n_out=4096, activation="relu",
                                   dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_out=self.n_classes, loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """(zoo/model/VGG19.java)."""

    name = "vgg19"
    plan = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


def _conv_bn(g, name, inp, n_out, kernel=(3, 3), stride=(1, 1),
             mode="same", activation="relu"):
    g.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                 convolution_mode=mode, has_bias=False),
                inp)
    g.add_layer(f"{name}_bn", BatchNormalization(activation=activation),
                f"{name}_conv")
    return f"{name}_bn"


class TextGenerationLSTM(ZooModel):
    """Char-level LSTM (zoo/model/TextGenerationLSTM.java): two stacked
    GravesLSTM(256) and an RnnOutputLayer, one-hot vocabulary in and
    out."""

    name = "textgenlstm"

    def __init__(self, vocab_size: int = 77, seed: int = 123,
                 updater: Optional[dict] = None, max_length: int = 40):
        self.vocab_size = vocab_size
        self.max_length = max_length
        super().__init__(n_classes=vocab_size, seed=seed,
                         input_shape=(max_length, vocab_size),
                         updater=updater or updaters.rmsprop(1e-2))

    def default_input_shape(self):
        return (40, 77)

    def conf(self):
        return (self._builder().list()
                .layer(GravesLSTM(n_out=256, activation="tanh"))
                .layer(GravesLSTM(n_out=256, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.vocab_size, loss="mcxent"))
                .set_input_type(InputType.recurrent(self.vocab_size,
                                                    self.max_length))
                .build())


class ResNet50(ZooModel):
    """(zoo/model/ResNet50.java): bottleneck-block ResNet-50, NHWC,
    identity and projection shortcuts through ElementWiseVertex(add)."""

    name = "resnet50"

    def conf(self):
        h, w, c = self.input_shape
        g = (self._builder().graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))
        last = _conv_bn(g, "stem", "in", 64, kernel=(7, 7), stride=(2, 2))
        g.add_layer("stem_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                     convolution_mode="same"), last)
        last = "stem_pool"

        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                  (3, 512, 2048, 2)]
        for si, (blocks, mid, out_ch, first_stride) in enumerate(stages):
            for bi in range(blocks):
                stride = (first_stride, first_stride) if bi == 0 else (1, 1)
                pre = f"s{si}b{bi}"
                a = _conv_bn(g, f"{pre}_a", last, mid, kernel=(1, 1),
                             stride=stride)
                b = _conv_bn(g, f"{pre}_b", a, mid, kernel=(3, 3))
                cb = _conv_bn(g, f"{pre}_c", b, out_ch, kernel=(1, 1),
                              activation="identity")
                if bi == 0:
                    sc = _conv_bn(g, f"{pre}_sc", last, out_ch,
                                  kernel=(1, 1), stride=stride,
                                  activation="identity")
                else:
                    sc = last
                g.add_vertex(f"{pre}_add", ElementWiseVertex(op="add"),
                             cb, sc)
                g.add_layer(f"{pre}_relu", ActivationLayer(
                    activation="relu"), f"{pre}_add")
                last = f"{pre}_relu"

        g.add_layer("avgpool", GlobalPoolingLayer(pooling=PoolingType.AVG),
                    last)
        g.add_layer("out", OutputLayer(n_out=self.n_classes, loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        return g.build()
