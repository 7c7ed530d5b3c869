"""Model zoo (counterpart of ``deeplearning4j_tpu/zoo/models.py``): the
same thirteen configs, built with the port's builder, so a zoo model's
JSON equals the JAX package's. All image models are NHWC.

On MultiLayerNetwork: ``LeNet``, ``SimpleCNN``, ``AlexNet`` (with LRN),
``VGG16``, ``VGG19``, ``TextGenerationLSTM``, ``Darknet19`` and
``TinyYOLO`` (a ``Yolo2OutputLayer`` head). On ComputationGraph:
``ResNet50``, ``GoogLeNet``, ``InceptionResNetV1`` and
``FaceNetNN4Small2`` (center-loss heads) and ``UNet`` (transposed
convolutions, a ``LossLayer``).

The pretrained-weights manifest: ``register_pretrained`` /
``load_manifest`` name a (url, sha256) a model, ``export_pretrained``
writes a model's zip, its checksum and a ``file://`` manifest entry,
and ``ZooModel.init_pretrained`` fetches a missing artifact into the
cache (``DL4J_TPU_ZOO_DIR``), checks its sha256 and restores it onto a
device. No URL is built in.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf import updaters
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex,
                                                    L2NormalizeVertex,
                                                    MergeVertex, ScaleVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, CenterLossOutputLayer,
    ConvolutionLayer, Deconvolution2DLayer, DenseLayer, DropoutLayer,
    GlobalPoolingLayer, GravesLSTM, LocalResponseNormalization, LossLayer,
    OutputLayer, PoolingType, RnnOutputLayer, SubsamplingLayer,
    Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "GoogLeNet", "InceptionResNetV1",
           "FaceNetNN4Small2", "TextGenerationLSTM", "TinyYOLO",
           "Darknet19", "UNet", "available_models",
           "register_pretrained", "load_manifest", "export_pretrained"]


_PRETRAINED_MANIFEST: dict = {}


def register_pretrained(name: str, url: str, sha256: str) -> None:
    """Register a weights artifact for ``name`` (a ZooModel.name): any
    URL urllib opens (``file://``, ...)."""
    _PRETRAINED_MANIFEST[name] = {"url": url, "sha256": sha256}


def load_manifest(path: str) -> dict:
    """Merge a manifest JSON file ``{name: {"url":…, "sha256":…}}``
    into the registry; returns the merged registry."""
    import json
    with open(path) as f:
        entries = json.load(f)
    for name, e in entries.items():
        register_pretrained(name, e["url"], e["sha256"])
    return dict(_PRETRAINED_MANIFEST)


def _sha256_file(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def export_pretrained(net, name: str, out_dir: str) -> dict:
    """Write ``net`` as a zoo weights artifact: ``<name>.zip`` (the
    checkpoint zip), a ``<name>.zip.sha256`` sidecar, and its entry
    with a ``file://`` URL in ``out_dir/manifest.json``. Returns the
    entry."""
    import json

    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.zip")
    write_model(net, path)
    digest = _sha256_file(path)
    with open(path + ".sha256", "w") as f:
        f.write(digest + "\n")
    entry = {"url": "file://" + os.path.abspath(path), "sha256": digest}
    mpath = os.path.join(out_dir, "manifest.json")
    manifest = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    manifest[name] = entry
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, mpath)
    logger.info("exported %s -> %s (sha256 %s)", name, path, digest)
    return entry


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

    def pretrained_path(self) -> str:
        base = os.environ.get(
            "DL4J_TPU_ZOO_DIR",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "deeplearning4j_tpu", "zoo"))
        return os.path.join(base, f"{self.name}.zip")

    def init_pretrained(self, checksum: Optional[str] = None,
                        device="cuda"):
        """The cached pretrained weights restored onto ``device``. A
        missing artifact is fetched from the manifest's URL first. The
        sha256 expected is, in order: ``checksum``, the manifest entry's,
        a ``<name>.zip.sha256`` sidecar's, the class attribute
        ``pretrained_checksum``; a mismatch raises (and deletes a file
        just fetched); with none the file loads unverified."""
        path = self.pretrained_path()
        manifest = _PRETRAINED_MANIFEST.get(self.name)
        fetched = False
        if not os.path.exists(path):
            if manifest is None:
                raise FileNotFoundError(
                    f"No pretrained weights for {self.name}: expected "
                    f"{path} and no manifest entry — register one via "
                    f"zoo.register_pretrained()/load_manifest(), or "
                    f"place the checkpoint there manually")
            self._fetch(manifest["url"], path)
            fetched = True
        expected = checksum
        if expected is None and manifest is not None:
            expected = manifest["sha256"]
        sidecar = path + ".sha256"
        if expected is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                parts = f.read().split()
            if not parts:
                raise IOError(f"Malformed checksum sidecar {sidecar}: "
                              f"empty file")
            expected = parts[0].strip()
        if expected is None:
            expected = getattr(self, "pretrained_checksum", None)
        if expected:
            actual = _sha256_file(path)
            if actual != expected:
                if fetched:
                    os.remove(path)
                raise IOError(
                    f"Checksum mismatch for {path}: expected {expected}, "
                    f"got {actual} — corrupt or stale artifact"
                    + ("; the fetched file was deleted — fix the "
                       "manifest source and retry" if fetched else
                       "; delete it and re-fetch"))
        else:
            logger.warning("loading %s without checksum verification "
                           "(no sidecar %s)", path, sidecar)
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model)
        return restore_model(path, device=device)

    @staticmethod
    def _fetch(url: str, path: str):
        """Copy a manifest URL into the cache through a temporary file
        and a rename, so a failed fetch leaves no partial artifact."""
        import shutil
        import urllib.request
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".fetch{os.getpid()}"
        logger.info("fetching pretrained weights: %s -> %s", url, path)
        try:
            with urllib.request.urlopen(url, timeout=60) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

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


class AlexNet(ZooModel):
    """(zoo/model/AlexNet.java), with the LRN layers."""

    name = "alexnet"

    def conf(self):
        h, w, c = self.input_shape
        return (self._builder().list()
                .layer(ConvolutionLayer(n_out=96, kernel=(11, 11),
                                        stride=(4, 4), activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel=(5, 5),
                                        padding=(2, 2), activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(ConvolutionLayer(n_out=256, kernel=(3, 3),
                                        padding=(1, 1), activation="relu"))
                .layer(SubsamplingLayer(kernel=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu",
                                  dropout=0.5))
                .layer(OutputLayer(n_out=self.n_classes, loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


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


class GoogLeNet(ZooModel):
    """(zoo/model/GoogLeNet.java) — Inception-v1 with 3x3/5x5/pool
    branches merged channel-wise."""

    name = "googlenet"

    def _inception(self, g, name, inp, c1, c3r, c3, c5r, c5, pp):
        b1 = _conv_bn(g, f"{name}_1x1", inp, c1, kernel=(1, 1))
        r3 = _conv_bn(g, f"{name}_3r", inp, c3r, kernel=(1, 1))
        b3 = _conv_bn(g, f"{name}_3x3", r3, c3, kernel=(3, 3))
        r5 = _conv_bn(g, f"{name}_5r", inp, c5r, kernel=(1, 1))
        b5 = _conv_bn(g, f"{name}_5x5", r5, c5, kernel=(5, 5))
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(1, 1),
                                     convolution_mode="same"), inp)
        bp = _conv_bn(g, f"{name}_pp", f"{name}_pool", pp, kernel=(1, 1))
        g.add_vertex(f"{name}_cat", MergeVertex(), b1, b3, b5, bp)
        return f"{name}_cat"

    def conf(self):
        h, w, c = self.input_shape
        g = (self._builder().graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))
        last = _conv_bn(g, "c1", "in", 64, kernel=(7, 7), stride=(2, 2))
        g.add_layer("p1", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), last)
        last = _conv_bn(g, "c2", "p1", 192, kernel=(3, 3))
        g.add_layer("p2", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), last)
        last = "p2"
        specs = [("3a", 64, 96, 128, 16, 32, 32),
                 ("3b", 128, 128, 192, 32, 96, 64)]
        for s in specs:
            last = self._inception(g, s[0], last, *s[1:])
        g.add_layer("p3", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), last)
        last = "p3"
        specs = [("4a", 192, 96, 208, 16, 48, 64),
                 ("4b", 160, 112, 224, 24, 64, 64),
                 ("4c", 128, 128, 256, 24, 64, 64),
                 ("4d", 112, 144, 288, 32, 64, 64),
                 ("4e", 256, 160, 320, 32, 128, 128)]
        for s in specs:
            last = self._inception(g, s[0], last, *s[1:])
        g.add_layer("p4", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), last)
        last = "p4"
        for s in [("5a", 256, 160, 320, 32, 128, 128),
                  ("5b", 384, 192, 384, 48, 128, 128)]:
            last = self._inception(g, s[0], last, *s[1:])
        g.add_layer("avgpool", GlobalPoolingLayer(pooling=PoolingType.AVG),
                    last)
        g.add_layer("drop", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("out", OutputLayer(n_out=self.n_classes,
                                       loss="mcxent"), "drop")
        g.set_outputs("out")
        return g.build()


class InceptionResNetV1(ZooModel):
    """(zoo/model/InceptionResNetV1.java:104-316 + helper/
    InceptionResNetHelper.java) — FULL architecture: 7-conv stem,
    5x Inception-ResNet-A (scale 0.17), Reduction-A, 10x B (scale
    0.10), Reduction-B, 5x C (scale 0.20), then the reference head
    (128-d bottleneck -> L2-normalized embeddings -> center-loss
    softmax, InceptionResNetV1.java:77-92). Deviations from the
    reference, chosen deliberately: conv->BN->activation ordering
    (the reference's global RELU applies activations both on convs and
    BNs — a double-activation quirk of that snapshot), block output
    activation kept ReLU (reference uses TANH there, another snapshot
    quirk), and global average pooling before the bottleneck instead
    of flattening the 2x2 spatial grid (head width 1344 vs reference
    5376)."""

    name = "inception_resnet_v1"

    def default_input_shape(self):
        return (160, 160, 3)

    def _residual_block(self, g, name, inp, branches, up_channels,
                        up_kernel, scale):
        """Shared A/B/C skeleton (InceptionResNetHelper: branch convs
        -> merge -> up-conv -> ScaleVertex -> residual add ->
        activation)."""
        ends = []
        for bi, branch in enumerate(branches):
            last = inp
            for li, (n_out, kernel) in enumerate(branch):
                last = _conv_bn(g, f"{name}_b{bi}_{li}", last, n_out,
                                kernel=kernel)
            ends.append(last)
        g.add_vertex(f"{name}_cat", MergeVertex(), *ends)
        up = _conv_bn(g, f"{name}_up", f"{name}_cat", up_channels,
                      kernel=up_kernel, activation="identity")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), up)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), inp,
                     f"{name}_scale")
        g.add_layer(f"{name}_act", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_act"

    def _block_a(self, g, name, inp):
        # 1x1->32 | 1x1->32,3x3->32 | 1x1->32,3x3->32,3x3->32; up 3x3->192
        return self._residual_block(
            g, name, inp,
            [[(32, (1, 1))],
             [(32, (1, 1)), (32, (3, 3))],
             [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]],
            192, (3, 3), 0.17)

    def _block_b(self, g, name, inp):
        # 1x1->128 | 1x1->128,1x3->128,3x1->128; up 1x1->576
        return self._residual_block(
            g, name, inp,
            [[(128, (1, 1))],
             [(128, (1, 1)), (128, (1, 3)), (128, (3, 1))]],
            576, (1, 1), 0.10)

    def _block_c(self, g, name, inp):
        # 1x1->192 | 1x1->192,1x3->192,3x1->192; up 1x1->1344
        return self._residual_block(
            g, name, inp,
            [[(192, (1, 1))],
             [(192, (1, 1)), (192, (1, 3)), (192, (3, 1))]],
            1344, (1, 1), 0.20)

    def conf(self):
        h, w, c = self.input_shape
        g = (self._builder().graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))
        # stem (InceptionResNetV1.java:114-166); 'truncate' = the
        # reference's default ConvolutionMode for this model
        last = _conv_bn(g, "s1", "in", 32, kernel=(3, 3), stride=(2, 2),
                        mode="truncate")
        last = _conv_bn(g, "s2", last, 32, kernel=(3, 3), mode="truncate")
        last = _conv_bn(g, "s3", last, 64, kernel=(3, 3), mode="same")
        g.add_layer("s_pool", SubsamplingLayer(kernel=(3, 3),
                                               stride=(2, 2)), last)
        last = _conv_bn(g, "s5", "s_pool", 80, kernel=(1, 1),
                        mode="truncate")
        last = _conv_bn(g, "s6", last, 128, kernel=(3, 3),
                        mode="truncate")
        last = _conv_bn(g, "s7", last, 192, kernel=(3, 3), stride=(2, 2),
                        mode="truncate")
        # 5x Inception-ResNet-A (InceptionResNetV1.java:169)
        for i in range(5):
            last = self._block_a(g, f"a{i + 1}", last)
        # Reduction-A (:173-221): 3x3s2->192 | 1x1->128,3x3->128,
        # 3x3s2->192 | maxpool3x3s2  => 576 channels
        ra0 = _conv_bn(g, "rA_c1", last, 192, kernel=(3, 3),
                       stride=(2, 2), mode="truncate")
        ra1 = _conv_bn(g, "rA_c2", last, 128, kernel=(1, 1))
        ra1 = _conv_bn(g, "rA_c3", ra1, 128, kernel=(3, 3))
        ra1 = _conv_bn(g, "rA_c4", ra1, 192, kernel=(3, 3),
                       stride=(2, 2), mode="truncate")
        g.add_layer("rA_pool", SubsamplingLayer(kernel=(3, 3),
                                                stride=(2, 2)), last)
        g.add_vertex("reduceA", MergeVertex(), ra0, ra1, "rA_pool")
        last = "reduceA"
        # 10x Inception-ResNet-B (:222)
        for i in range(10):
            last = self._block_b(g, f"b{i + 1}", last)
        # Reduction-B (:226-300): maxpool | 1x1->256,3x3s2->256 |
        # 1x1->256,3x3s2->256 | 1x1->256,3x3->256,3x3s2->256  => 1344
        g.add_layer("rB_pool", SubsamplingLayer(kernel=(3, 3),
                                                stride=(2, 2)), last)
        rb1 = _conv_bn(g, "rB_c2", last, 256, kernel=(1, 1))
        rb1 = _conv_bn(g, "rB_c3", rb1, 256, kernel=(3, 3),
                       stride=(2, 2), mode="truncate")
        rb2 = _conv_bn(g, "rB_c4", last, 256, kernel=(1, 1))
        rb2 = _conv_bn(g, "rB_c5", rb2, 256, kernel=(3, 3),
                       stride=(2, 2), mode="truncate")
        rb3 = _conv_bn(g, "rB_c6", last, 256, kernel=(1, 1))
        rb3 = _conv_bn(g, "rB_c7", rb3, 256, kernel=(3, 3))
        rb3 = _conv_bn(g, "rB_c8", rb3, 256, kernel=(3, 3),
                       stride=(2, 2), mode="truncate")
        g.add_vertex("reduceB", MergeVertex(), "rB_pool", rb1, rb2, rb3)
        last = "reduceB"
        # 5x Inception-ResNet-C (:304)
        for i in range(5):
            last = self._block_c(g, f"c{i + 1}", last)
        # head (:77-92)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling=PoolingType.AVG),
                    last)
        g.add_layer("bottleneck", DenseLayer(n_out=128,
                                             activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(eps=1e-10),
                     "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.n_classes, loss="mcxent", alpha=0.9,
            lambda_=1e-4), "embeddings")
        g.set_outputs("out")
        return g.build()


class FaceNetNN4Small2(ZooModel):
    """(zoo/model/FaceNetNN4Small2.java:80-341 + helper/
    FaceNetHelper.java:148-244) — FULL NN4.small2 inception stack:
    7x7 stem + LRN, inception-2, modules 3a/3b (4-branch), 3c
    (stride-2, 3-branch), 4a, 4e (stride-2), 5a (pnorm pool), 5b (max
    pool), then 128-d bottleneck -> L2-normalized embeddings ->
    center-loss SQUARED_LOSS softmax head. Deviation: global average
    pooling before the bottleneck instead of the reference's 3x3s3
    avg-pool + flatten (head width 736 vs 2944), for any input size."""

    name = "facenet_nn4_small2"

    def default_input_shape(self):
        return (96, 96, 3)

    def _inception(self, g, name, inp, kernels, outputs, reduces,
                   pool_type, pool_pnorm=2):
        """FaceNetHelper.appendGraph (:148-244): per-kernel
        1x1-reduce -> NxN conv branches, then optional pool->1x1
        branch (reduces[len(kernels)]) and optional bare 1x1 branch
        (reduces[len(kernels)+1])."""
        ends = []
        for i, (k, n_out, red) in enumerate(zip(kernels, outputs,
                                                reduces)):
            b = _conv_bn(g, f"{name}_r{i}", inp, red, kernel=(1, 1))
            b = _conv_bn(g, f"{name}_k{i}", b, n_out, kernel=(k, k))
            ends.append(b)
        idx = len(kernels)
        if len(reduces) > idx:
            g.add_layer(f"{name}_pool",
                        SubsamplingLayer(pooling=pool_type, kernel=(3, 3),
                                         stride=(1, 1), pnorm=pool_pnorm,
                                         convolution_mode="same"), inp)
            ends.append(_conv_bn(g, f"{name}_poolr", f"{name}_pool",
                                 reduces[idx], kernel=(1, 1)))
        if len(reduces) > idx + 1:
            ends.append(_conv_bn(g, f"{name}_1x1", inp, reduces[idx + 1],
                                 kernel=(1, 1)))
        g.add_vertex(name, MergeVertex(), *ends)
        return name

    def _reduction(self, g, name, inp, reduce1, out1, reduce2, out2):
        """The 3c/4e stride-2 modules (FaceNetNN4Small2.java:148-232):
        1x1->3x3s2 | 1x1->5x5s2 | maxpool3x3s2."""
        b0 = _conv_bn(g, f"{name}_r0", inp, reduce1, kernel=(1, 1))
        b0 = _conv_bn(g, f"{name}_k0", b0, out1, kernel=(3, 3),
                      stride=(2, 2))
        b1 = _conv_bn(g, f"{name}_r1", inp, reduce2, kernel=(1, 1))
        b1 = _conv_bn(g, f"{name}_k1", b1, out2, kernel=(5, 5),
                      stride=(2, 2))
        g.add_layer(f"{name}_pool",
                    SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                     convolution_mode="same"), inp)
        g.add_vertex(name, MergeVertex(), b0, b1, f"{name}_pool")
        return name

    def conf(self):
        h, w, c = self.input_shape
        g = (self._builder().graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))
        # stem (:85-103): 7x7s2 conv + BN + relu, maxpool, LRN
        last = _conv_bn(g, "stem_c1", "in", 64, kernel=(7, 7),
                        stride=(2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel=(3, 3), stride=(2, 2), padding=(1, 1)), last)
        g.add_layer("stem_lrn", LocalResponseNormalization(
            k=1, n=5, alpha=1e-4, beta=0.75), "stem_pool")
        # inception-2 (:105-133): 1x1->64, 3x3->192, LRN, maxpool
        last = _conv_bn(g, "i2_c1", "stem_lrn", 64, kernel=(1, 1))
        last = _conv_bn(g, "i2_c2", last, 192, kernel=(3, 3))
        g.add_layer("i2_lrn", LocalResponseNormalization(
            k=1, n=5, alpha=1e-4, beta=0.75), last)
        g.add_layer("i2_pool", SubsamplingLayer(
            kernel=(3, 3), stride=(2, 2), padding=(1, 1)), "i2_lrn")
        # 3a (:136): 192 -> [3x3:96->128, 5x5:16->32, maxpool->32,
        # 1x1->64] = 256
        last = self._inception(g, "i3a", "i2_pool", [3, 5], [128, 32],
                               [96, 16, 32, 64], PoolingType.MAX)
        # 3b (:140): 256 -> [128, 64, 64, 64] = 320, pnorm pool
        last = self._inception(g, "i3b", last, [3, 5], [128, 64],
                               [96, 32, 64, 64], PoolingType.PNORM)
        # 3c (:148-184): stride-2 reduction -> 256+64+320 = 640
        last = self._reduction(g, "i3c", last, 128, 256, 32, 64)
        # 4a (:187): 640 -> [192, 64, 128, 256] = 640, pnorm pool
        last = self._inception(g, "i4a", last, [3, 5], [192, 64],
                               [96, 32, 128, 256], PoolingType.PNORM)
        # 4e (:196-232): stride-2 reduction -> 256+128+640 = 1024
        last = self._reduction(g, "i4e", last, 160, 256, 64, 128)
        # 5a (:239-276): [1x1->256, 3x3:96->384, pnorm-pool->96] = 736
        last = self._inception(g, "i5a", last, [3], [384], [96, 96, 256],
                               PoolingType.PNORM)
        # 5b (:283-322): same shape with max pool = 736
        last = self._inception(g, "i5b", last, [3], [384], [96, 96, 256],
                               PoolingType.MAX)
        # head (:324-338)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling=PoolingType.AVG),
                    last)
        g.add_layer("bottleneck", DenseLayer(n_out=128,
                                             activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(eps=1e-6),
                     "bottleneck")
        g.add_layer("out", CenterLossOutputLayer(
            n_out=self.n_classes, loss="squared_loss", alpha=0.9,
            lambda_=1e-4), "embeddings")
        g.set_outputs("out")
        return g.build()


class Darknet19(ZooModel):
    """(zoo/model/Darknet19.java)."""

    name = "darknet19"

    def conf(self):
        h, w, c = self.input_shape
        b = self._builder().list()
        plan = [(32,), "M", (64,), "M", (128, 64, 128), "M",
                (256, 128, 256), "M", (512, 256, 512, 256, 512), "M",
                (1024, 512, 1024, 512, 1024)]
        for item in plan:
            if item == "M":
                b = b.layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            else:
                for i, n_out in enumerate(item):
                    k = (1, 1) if (len(item) > 1 and i % 2 == 1) else (3, 3)
                    b = (b.layer(ConvolutionLayer(n_out=n_out, kernel=k,
                                                  convolution_mode="same",
                                                  has_bias=False))
                         .layer(BatchNormalization(
                             activation="leakyrelu")))
        b = (b.layer(ConvolutionLayer(n_out=self.n_classes, kernel=(1, 1),
                                      convolution_mode="same"))
             .layer(GlobalPoolingLayer(pooling=PoolingType.AVG))
             .layer(OutputLayer(n_out=self.n_classes, loss="mcxent")))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class TinyYOLO(ZooModel):
    """(zoo/model/TinyYOLO.java) — Darknet-tiny trunk + Yolo2OutputLayer."""

    name = "tinyyolo"

    def __init__(self, n_classes: int = 20, seed: int = 123,
                 input_shape=None, updater=None,
                 anchors=((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                          (9.42, 5.11), (16.62, 10.52))):
        super().__init__(n_classes, seed, input_shape or (416, 416, 3),
                         updater)
        self.anchors = anchors

    def conf(self):
        h, w, c = self.input_shape
        b = self._builder().list()
        n_out_seq = [16, 32, 64, 128, 256, 512]
        for i, n_out in enumerate(n_out_seq):
            b = (b.layer(ConvolutionLayer(n_out=n_out, kernel=(3, 3),
                                          convolution_mode="same",
                                          has_bias=False))
                 .layer(BatchNormalization(activation="leakyrelu")))
            stride = (2, 2) if i < 5 else (1, 1)
            b = b.layer(SubsamplingLayer(kernel=(2, 2), stride=stride,
                                         convolution_mode="same"))
        b = (b.layer(ConvolutionLayer(n_out=1024, kernel=(3, 3),
                                      convolution_mode="same",
                                      has_bias=False))
             .layer(BatchNormalization(activation="leakyrelu"))
             .layer(ConvolutionLayer(
                 n_out=len(self.anchors) * (5 + self.n_classes),
                 kernel=(1, 1), convolution_mode="same"))
             .layer(Yolo2OutputLayer(anchors=tuple(self.anchors))))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


class UNet(ZooModel):
    """U-Net encoder/decoder with skip connections (capability parity
    with later-reference zoo; exercises Deconvolution + Merge)."""

    name = "unet"

    def default_input_shape(self):
        return (128, 128, 3)

    def conf(self):
        h, w, c = self.input_shape
        g = (self._builder().graph_builder()
             .add_inputs("in")
             .set_input_types(InputType.convolutional(h, w, c)))
        skips = []
        last = "in"
        chans = [32, 64, 128]
        for i, ch in enumerate(chans):
            last = _conv_bn(g, f"e{i}", last, ch)
            skips.append(last)
            g.add_layer(f"ep{i}", SubsamplingLayer(kernel=(2, 2),
                                                   stride=(2, 2)), last)
            last = f"ep{i}"
        last = _conv_bn(g, "mid", last, 256)
        for i, ch in reversed(list(enumerate(chans))):
            g.add_layer(f"up{i}", Deconvolution2DLayer(
                n_out=ch, kernel=(2, 2), stride=(2, 2)), last)
            g.add_vertex(f"cat{i}", MergeVertex(), f"up{i}", skips[i])
            last = _conv_bn(g, f"d{i}", f"cat{i}", ch)
        g.add_layer("head", ConvolutionLayer(n_out=self.n_classes,
                                             kernel=(1, 1),
                                             activation="sigmoid"), last)
        g.add_layer("out", LossLayer(loss="xent", activation="identity"),
                    "head")
        g.set_outputs("out")
        return g.build()


def available_models():
    return {cls.name: cls for cls in
            (LeNet, SimpleCNN, AlexNet, VGG16, VGG19, ResNet50, GoogLeNet,
             InceptionResNetV1, FaceNetNN4Small2, TextGenerationLSTM,
             TinyYOLO, Darknet19, UNet)}
