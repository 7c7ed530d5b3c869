"""The port's data pipeline against the JAX package, on the CPU.

Every iterator, normalizer, record reader and fetcher gets the same
seeded numpy inputs (or the same files, written to a temp directory) in
both packages, and the batches, statistics and arrays must be equal:
exactly where the arithmetic is the same numpy code (tolerance 0), and
the zips with a normalizer cross both ways. The port's native loader
(``deeplearning4j_tpu_torch/csrc/host/dataloader.cpp``, its own PNG
decoder over zlib) is held bit-equal to the JAX package's libpng loader
on a PNG tree of 3 classes x 5 images (32x32, written by the port's
standard-library PNG writer, which PIL decodes back to the same
pixels) and on a CSV file, at 1 and 4 threads, trailing partial batch
included; and it raises, naming what is missing, where it cannot be
built. The card test (``cuda`` marker) feeds a small conv net's step
on the card from the PNG loader and holds it against the CPU.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from deeplearning4j_tpu import chaos as jchaos
from deeplearning4j_tpu.data import fetchers as jf
from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.data import native_loader as jnl
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data import records as jrec
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos as tchaos
from deeplearning4j_tpu_torch.data import fetchers as tf
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data import native_loader as tnl
from deeplearning4j_tpu_torch.data import normalizers as tnorm
from deeplearning4j_tpu_torch.data import records as trec
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.util import model_serializer as tser


def _arrays(ds):
    return [None if a is None else np.asarray(a) for a in
            (ds.features, ds.labels, ds.features_mask, ds.labels_mask)]


def _assert_batches(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for a, b in zip(_arrays(p), _arrays(r)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _xy(n=23, f=3, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return x, y


# ----------------------------------------------------------- iterators

def _make(pkg, kind, tmp_path):
    x, y = _xy()
    mod = jit if pkg == "jax" else tit
    ds = (JDataSet if pkg == "jax" else TDataSet)(x, y)
    base = lambda: mod.ArrayDataSetIterator(x, y, 5, shuffle=True, seed=3)
    if kind == "async":
        return mod.AsyncDataSetIterator(base(), prefetch=2)
    if kind == "multiple_epochs":
        return mod.MultipleEpochsIterator(base(), 3)
    if kind == "early_termination":
        return mod.EarlyTerminationDataSetIterator(base(), 2)
    if kind == "sampling":
        return mod.SamplingDataSetIterator(ds, 4, 6, seed=11)
    if kind == "benchmark":
        return mod.BenchmarkDataSetIterator(ds, 3)
    if kind == "joint":
        return mod.JointParallelDataSetIterator(
            base(), mod.ArrayDataSetIterator(x[:7], y[:7], 3))
    if kind == "file_split":
        files = []
        for i in range(2):
            path = tmp_path / f"part{i}.csv"
            rows = np.concatenate([x[i::2], y[i::2].argmax(1)[:, None]], 1)
            np.savetxt(path, rows, delimiter=",", fmt="%.6f")
            files.append(str(path))
        return mod.FileSplitParallelDataSetIterator(
            files, 4, label_index=3, num_classes=4)
    raise ValueError(kind)


KINDS = ["async", "multiple_epochs", "early_termination", "sampling",
         "benchmark", "joint", "file_split"]


@pytest.mark.parametrize("kind", KINDS)
def test_iterator_batches_equal_jax(kind, tmp_path):
    """Two passes each (the second after reset, as fit's next epoch
    does): every batch equal, array for array."""
    j, t = _make("jax", kind, tmp_path), _make("port", kind, tmp_path)
    for _ in range(2):
        _assert_batches(t, j)
    assert t.batch_size() == j.batch_size()


def test_sampling_state_resume_equals_jax():
    x, y = _xy()
    ref = list(jit.SamplingDataSetIterator(JDataSet(x, y), 4, 6, seed=2))
    it = tit.SamplingDataSetIterator(TDataSet(x, y), 4, 6, seed=2)
    got = iter(it)
    first = [next(got) for _ in range(2)]
    state = it.state_dict()
    resumed = tit.SamplingDataSetIterator(TDataSet(x, y), 4, 6, seed=2)
    resumed.load_state_dict(state)
    _assert_batches(first + list(resumed), ref)
    assert state["source"] == jit.SamplingDataSetIterator(
        JDataSet(x, y), 4, 6, seed=2)._source_signature()


def test_async_keeps_order_and_raises_the_producers_error():
    class Boom(tit.DataSetIterator):
        def reset(self):
            pass

        def _iterate(self):
            for i in range(3):
                yield TDataSet(np.full((2, 1), i, np.float32))
            raise ValueError("source failed at batch 3")

    seen = []
    with pytest.raises(ValueError, match="batch 3"):
        for ds in tit.AsyncDataSetIterator(Boom(), prefetch=1):
            seen.append(float(ds.features[0, 0]))
    assert seen == [0.0, 1.0, 2.0]


# --------------------------------------------------------- normalizers

def _norm_pair(kind):
    if kind == "standardize":
        return (jnorm.NormalizerStandardize(fit_labels=True),
                tnorm.NormalizerStandardize(fit_labels=True))
    if kind == "minmax":
        return (jnorm.NormalizerMinMaxScaler(-1.0, 2.0),
                tnorm.NormalizerMinMaxScaler(-1.0, 2.0))
    return (jnorm.ImagePreProcessingScaler(0.0, 1.0),
            tnorm.ImagePreProcessingScaler(0.0, 1.0))


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
@pytest.mark.parametrize("by_iterator", [False, True])
def test_normalizer_fit_transform_revert_equal_jax(kind, by_iterator):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (30, 2, 5)).astype(np.float32)
    y = rng.normal(3, 2, (30, 2)).astype(np.float32)
    jn, tn = _norm_pair(kind)
    if by_iterator:
        jn.fit(jit.ArrayDataSetIterator(x, y, 7))
        tn.fit(tit.ArrayDataSetIterator(x, y, 7))
    else:
        jn.fit(JDataSet(x, y))
        tn.fit(TDataSet(x, y))
    assert tn.to_dict() == jn.to_dict()
    ref, got = jn.transform(JDataSet(x, y)), tn.transform(TDataSet(x, y))
    _assert_batches([got], [ref])
    np.testing.assert_array_equal(tn.revert_features(got.features),
                                  jn.revert_features(ref.features))
    if kind == "standardize":
        np.testing.assert_array_equal(tn.revert_labels(got.labels),
                                      jn.revert_labels(ref.labels))
    back = tnorm.normalizer_from_dict(jn.to_dict())
    assert type(back) is type(tn) and back.to_dict() == jn.to_dict()
    assert tnorm.normalizer_from_dict(None) is None


def _small_jax_net():
    return (JaxBuilder.builder().set_seed(1).updater(jupd.sgd(0.1)).list()
            .layer(jl.DenseLayer(n_out=4, activation="tanh"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.feed_forward(5)).build())


def test_zip_normalizer_crosses_both_ways(tmp_path):
    from deeplearning4j_tpu.models.multi_layer_network import (
        MultiLayerNetwork as JaxNet)
    x = np.random.default_rng(0).normal(2, 3, (20, 5)).astype(np.float32)
    jnormer = jnorm.NormalizerStandardize().fit(JDataSet(x))
    jn = JaxNet(_small_jax_net()).init()
    jzip = str(tmp_path / "jax.zip")
    jser.write_model(jn, jzip, normalizer=jnormer.to_dict())
    tnormer = tser.restore_normalizer(jzip)
    assert isinstance(tnormer, tnorm.NormalizerStandardize)
    assert tnormer.to_dict() == jnormer.to_dict()
    tn = tser.restore_model(jzip, device="cpu")
    tzip = str(tmp_path / "port.zip")
    tser.write_model(tn, tzip, normalizer=tnorm.NormalizerMinMaxScaler()
                     .fit(TDataSet(x)).to_dict())
    back = jser.restore_normalizer(tzip)
    assert isinstance(back, jnorm.NormalizerMinMaxScaler)
    np.testing.assert_array_equal(back.min, x.min(0))
    tser.write_model(tn, tzip)
    assert tser.restore_normalizer(tzip) is None
    assert jser.restore_normalizer(tzip) is None


# ------------------------------------------------------ record readers

def _csv(tmp_path, name, rows):
    path = tmp_path / name
    path.write_text("\n".join(",".join(str(v) for v in r) for r in rows)
                    + "\n")
    return str(path)


@pytest.mark.parametrize("regression", [False, True])
def test_csv_record_reader_iterator_equal_jax(tmp_path, regression):
    rng = np.random.default_rng(5)
    rows = [["h1", "h2", "h3", "h4"]] + [
        [round(float(v), 4) for v in rng.normal(size=3)]
        + [int(rng.integers(0, 3))] for _ in range(11)]
    path = _csv(tmp_path, "d.csv", rows)
    kw = dict(label_index=3, num_classes=3, regression=regression)
    j = jrec.RecordReaderDataSetIterator(
        jrec.CSVRecordReader(skip_lines=1).initialize(path), 4, **kw)
    t = trec.RecordReaderDataSetIterator(
        trec.CSVRecordReader(skip_lines=1).initialize(path), 4, **kw)
    _assert_batches(t, j)
    assert t.num_examples() == j.num_examples() == 11
    # state resume after one batch
    it = iter(t)
    next(it)
    state = t.state_dict()
    t2 = trec.RecordReaderDataSetIterator(
        trec.CSVRecordReader(skip_lines=1).initialize(path), 4, **kw)
    t2.load_state_dict(state)
    _assert_batches(t2, list(j)[1:])


def test_csv_sequence_reader_pads_and_masks_like_jax(tmp_path):
    rng = np.random.default_rng(6)
    d = tmp_path / "seqs"
    d.mkdir()
    for i, T in enumerate([3, 5, 2, 4, 1]):
        _csv(d, f"s{i}.csv", [[round(float(v), 3) for v in rng.normal(
            size=2)] + [int(rng.integers(0, 2))] for _ in range(T)])
    for regression in (False, True):
        kw = dict(label_index=2, num_classes=2, regression=regression)
        j = jrec.SequenceRecordReaderDataSetIterator(
            jrec.CSVSequenceRecordReader().initialize(str(d)), 2, **kw)
        t = trec.SequenceRecordReaderDataSetIterator(
            trec.CSVSequenceRecordReader().initialize(str(d)), 2, **kw)
        _assert_batches(t, j)


def _png_tree(root, n_classes=3, per_class=5, hw=32, gray=False):
    """Noise images from ``default_rng(0)``, one directory a class."""
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            shape = (hw, hw) if gray else (hw, hw, 3)
            tnl.write_png(os.path.join(d, f"im{i}.png"),
                          rng.integers(0, 256, shape, dtype=np.uint8))
    return str(root)


@pytest.mark.parametrize("channels", [1, 3])
def test_image_record_reader_equal_jax(tmp_path, channels):
    root = _png_tree(tmp_path / "tree")
    j = jrec.RecordReaderDataSetIterator(
        jrec.ImageRecordReader(16, 12, channels).initialize(root), 4)
    t = trec.RecordReaderDataSetIterator(
        trec.ImageRecordReader(16, 12, channels).initialize(root), 4)
    _assert_batches(t, j)
    reader = trec.ImageRecordReader(16, 12, channels).initialize(root)
    ref = list(jrec.ImageRecordReader(16, 12, channels).initialize(root)
               .iter_from(7))
    got = list(reader.iter_from(7))
    assert [li for _, li in got] == [li for _, li in ref]
    for (a, _), (b, _) in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_png_writer_decodes_back_through_pil(tmp_path):
    rng = np.random.default_rng(9)
    for shape in [(7, 5, 3), (4, 9), (1, 1, 3)]:
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / "a.png")
        tnl.write_png(path, a)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    with pytest.raises(ValueError, match="pixels"):
        tnl.write_png(path, np.zeros((2, 2, 4), np.uint8))


def test_png_tree_is_the_bench_legs_tree(tmp_path):
    """``ensure_png_tree`` writes ``bench.py``'s ``_ensure_png_tree``
    pixels (same rng, same order), here at a small size."""
    root = tnl.ensure_png_tree(str(tmp_path / "leg"), n_classes=2,
                               per_class=3, hw=8)
    rng = np.random.default_rng(0)
    for c in range(2):
        for i in range(3):
            want = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
            got = np.asarray(Image.open(f"{root}/class{c}/im{i}.png"))
            np.testing.assert_array_equal(got, want)
    stamp = os.path.getmtime(f"{root}/class0/im0.png")
    assert tnl.ensure_png_tree(root, 2, 3, 8) == root
    assert os.path.getmtime(f"{root}/class0/im0.png") == stamp


# ------------------------------------------------------------ fetchers

@pytest.fixture
def empty_data_dir(tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(d))
    return d


FETCHES = {
    "mnist": lambda m: m.mnist_data(n=40),
    "mnist_test_2d": lambda m: m.mnist_data(train=False, flatten=False,
                                            n=16),
    "iris": lambda m: m.iris_data(),
    "cifar10": lambda m: m.cifar10_data(n=12),
    "classification": lambda m: m.synthetic_classification(30, 4, 3,
                                                           seed=2),
    "images": lambda m: m.synthetic_images(6, 8, 8, 2, 3, seed=1),
    "sequences": lambda m: m.synthetic_sequences(5, 7, 3, 2, seed=4),
}


@pytest.mark.parametrize("name", sorted(FETCHES))
def test_fetcher_surrogates_equal_jax(empty_data_dir, name):
    for a, b in zip(FETCHES[name](tf), FETCHES[name](jf)):
        np.testing.assert_array_equal(a, b)


ITERS = {
    "mnist": lambda m: m.MnistDataSetIterator(16, n=40),
    "emnist": lambda m: m.EmnistDataSetIterator("letters", 512,
                                                train=False),
    "iris": lambda m: m.IrisDataSetIterator(50),
    "cifar10": lambda m: m.Cifar10DataSetIterator(8, n=20),
    "tiny_imagenet": lambda m: m.TinyImageNetDataSetIterator(
        8, n=16, n_classes=5),
    "lfw": lambda m: m.LFWDataSetIterator(4, shape=(16, 16, 3), n=10,
                                          n_labels=3),
}


@pytest.mark.parametrize("name", sorted(ITERS))
def test_fetcher_iterators_equal_jax(empty_data_dir, name):
    _assert_batches(ITERS[name](tf), ITERS[name](jf))


def _write_idx(d, prefix, images, labels):
    import struct
    (d / f"{prefix}-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
    (d / f"{prefix}-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def test_real_file_parsers_and_image_tree_equal_jax(empty_data_dir):
    rng = np.random.default_rng(8)
    mnist = empty_data_dir / "mnist"
    mnist.mkdir()
    _write_idx(mnist, "train", rng.integers(0, 256, (6, 28, 28),
                                            dtype=np.uint8),
               rng.integers(0, 10, 6, dtype=np.uint8))
    cifar = empty_data_dir / "cifar-10-batches-bin"
    cifar.mkdir()
    raw = rng.integers(0, 256, (3, 3073), dtype=np.uint8)
    raw[:, 0] %= 10
    raw.tofile(str(cifar / "test_batch.bin"))
    _png_tree(empty_data_dir / "lfw", n_classes=2, per_class=3, hw=20)
    for a, b in zip(tf.mnist_data(), jf.mnist_data()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.cifar10_data(train=False),
                    jf.cifar10_data(train=False)):
        np.testing.assert_array_equal(a, b)
    _assert_batches(tf.LFWDataSetIterator(2, shape=(10, 10, 3), n=5),
                    jf.LFWDataSetIterator(2, shape=(10, 10, 3), n=5))


def _load_run(chaos_mod, fetch_mod, seed):
    chaos_mod.install({"faults": [{"site": "data.load", "kind": "error",
                                   "p": 0.5}]}, seed=seed)
    try:
        xs, ys = fetch_mod.mnist_data()
        return xs.sum(), ys.sum(), chaos_mod.current().hits("data.load")
    finally:
        chaos_mod.uninstall()


@pytest.mark.parametrize("seed", [0, 5])
def test_data_load_site_retries_like_jax(empty_data_dir, seed):
    mnist = empty_data_dir / "mnist"
    mnist.mkdir()
    rng = np.random.default_rng(1)
    _write_idx(mnist, "train", rng.integers(0, 256, (4, 28, 28),
                                            dtype=np.uint8),
               rng.integers(0, 10, 4, dtype=np.uint8))
    got = _load_run(tchaos, tf, seed)
    assert got == _load_run(jchaos, jf, seed)
    assert got[2] >= 2


# ------------------------------------------------------- native loader

@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("channels,hw", [(3, (32, 32)), (3, (20, 24)),
                                         (1, (32, 32))])
def test_native_png_loader_bit_equal_jax(tmp_path, threads, channels, hw):
    """3 classes x 5 images, batches of 4: three full batches and a
    trailing one of 3, at the tree's size and resized (bilinear)."""
    root = _png_tree(tmp_path / "tree", gray=channels == 1)
    kw = dict(channels=channels, n_threads=threads, queue_capacity=2)
    j = jnl.NativeImageDataSetIterator(root, 4, *hw, **kw)
    t = tnl.NativeImageDataSetIterator(root, 4, *hw, **kw)
    assert t.labels() == j.labels() == ["class0", "class1", "class2"]
    assert t.num_examples() == 15
    got = list(t)
    assert [b.num_examples() for b in got] == [4, 4, 4, 3]
    _assert_batches(got, list(j))
    assert t.skipped == 0


def test_native_png_decoder_converts_like_pil(tmp_path):
    """Filtered rows (PIL picks the filters), gray + alpha and RGBA,
    to gray and RGB, against PIL's ``convert`` (the ImageRecordReader
    path)."""
    d = tmp_path / "tree" / "a"
    d.mkdir(parents=True)
    rng = np.random.default_rng(3)
    ramp = np.add.outer(np.arange(13), np.arange(11))
    for i, mode in enumerate(["RGB", "RGBA", "LA", "L"]):
        c = len(mode)
        x = ramp[..., None] * np.arange(3, 3 + 2 * c, 2) \
            + rng.integers(0, 30, (13, 11, c))
        x = (x % 256).astype(np.uint8)
        Image.fromarray(x[..., 0] if c == 1 else x, mode).save(
            str(d / f"im{i}.png"))
    for channels in (1, 3):
        got = next(iter(tnl.NativeImageDataSetIterator(
            str(tmp_path / "tree"), 4, 13, 11, channels, n_threads=2)))
        for i in range(4):
            ref = np.asarray(Image.open(str(d / f"im{i}.png")).convert(
                "L" if channels == 1 else "RGB"), np.float32)
            np.testing.assert_array_equal(
                got.features[i], ref.reshape(got.features[i].shape))


def test_native_png_loader_skips_what_it_cannot_decode(tmp_path, caplog):
    root = _png_tree(tmp_path / "tree", n_classes=1, per_class=3, hw=8)
    with open(os.path.join(root, "class0", "im1.png"), "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff")              # breaks the IDAT's CRC
    Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(
        os.path.join(root, "class0", "im3.png"))   # palette: not read
    it = tnl.NativeImageDataSetIterator(root, 8, 8, 8, 3, n_threads=2)
    with caplog.at_level(logging.WARNING):
        (batch,) = list(it)
    assert batch.num_examples() == 2 and it.skipped == 2
    assert "skipped 2" in caplog.text


@pytest.mark.parametrize("threads", [1, 4])
def test_native_csv_loader_and_word_counts_equal_jax(tmp_path, threads):
    rng = np.random.default_rng(2)
    rows = [[round(float(v), 5) for v in rng.normal(size=4)]
            + [int(rng.integers(0, 3))] for _ in range(13)]
    path = _csv(tmp_path, "d.csv", rows)
    for label_index, classes in ((4, 3), (-1, 0), (0, 0)):
        kw = dict(label_index=label_index, num_classes=classes,
                  n_threads=threads)
        n_feat = 5 if label_index < 0 else 4
        j = list(jnl.NativeCSVDataSetIterator(path, 5, n_feat, **kw))
        t = tnl.NativeCSVDataSetIterator(path, 5, n_feat, **kw)
        # the pool's workers claim whole batches: hold them as sets
        key = lambda b: np.asarray(b.features).tobytes()
        got, ref = sorted(list(t), key=key), sorted(j, key=key)
        _assert_batches(got, ref)
        assert t.num_examples() == 13
    text = tmp_path / "words.txt"
    text.write_text("The cat, the CAT! a dog's day -- well-known\n" * 7)
    assert tnl.native_count_words(str(text), threads) == \
        jnl.native_count_words(str(text), threads)


def test_native_loader_raises_naming_what_is_missing(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnl, "_libs", {})
    monkeypatch.setattr(tnl, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        tnl.NativeImageDataSetIterator(str(tmp_path), 2, 8, 8)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tnl.NativeCSVDataSetIterator(str(tmp_path / "x.csv"), 2, 1)
    assert not tnl.native_available()
    monkeypatch.setattr(tnl, "CXX", "g++")
    monkeypatch.setattr(tnl, "ZLIB", ["-lno_such_zlib"])
    with pytest.raises(RuntimeError, match="zlib \\(-lno_such_zlib\\)"):
        tnl.NativeImageDataSetIterator(str(tmp_path), 2, 8, 8)
    assert tnl.native_available() and not tnl.native_image_available()
    path = _csv(tmp_path, "d.csv", [[1, 2, 0], [3, 4, 1]])
    (batch,) = list(tnl.NativeCSVDataSetIterator(path, 2, 2, 2, 2))
    np.testing.assert_array_equal(batch.features, [[1, 2], [3, 4]])
    # a failed compile leaves no temporary file behind
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".tmp")]


def test_concurrent_builds_make_one_library(tmp_path):
    """Six processes ask for the loader at once, as six test workers do:
    one compiles under the file lock, the others load its library, and
    no temporary file is left."""
    build = str(tmp_path / "build")
    code = ("import sys\n"
            "from deeplearning4j_tpu_torch.data import native_loader as n\n"
            "n.BUILD_DIR = sys.argv[1]\n"
            "n._get()\n"
            "print(n._target([]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code, build], cwd=repo,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    targets = {o.strip() for o, _ in outs}
    assert len(targets) == 1
    files = sorted(os.listdir(build))
    assert files == sorted([".lock", os.path.basename(targets.pop())])


def test_native_build_is_keyed_and_kept_under_build(tmp_path):
    tnl.NativeImageDataSetIterator(_png_tree(tmp_path / "t", 1, 1, 4),
                                   1, 4, 4)
    built = [f for f in os.listdir(tnl.BUILD_DIR) if f.endswith(".so")]
    assert os.path.basename(tnl._target([])) in built
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # build/native/, never the JAX package's native/
    assert tnl.BUILD_DIR == os.path.join(repo, "build", "native")


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_png_loader_feeds_a_conv_step_on_the_card(cuda_device, tmp_path):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters as U
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    root = _png_tree(tmp_path / "tree")
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(U.sgd(1e-4)).list()
            .layer(L.ConvolutionLayer(n_out=4, kernel=3))
            .layer(L.SubsamplingLayer(pooling="max"))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(32, 32, 3)).build())
    nets = {d: MultiLayerNetwork(conf, device=d).init()
            for d in ("cpu", "cuda")}
    for d, net in nets.items():
        net.fit(tnl.NativeImageDataSetIterator(root, 8, 32, 32, 3,
                                               n_threads=4))
        assert net.iteration_count == 2
    card = nets["cuda"].params_flat()
    cpu = nets["cpu"].params_flat()
    # f32 on both (the layers keep TF32 off); sums in another order
    np.testing.assert_allclose(card, cpu, atol=1e-4, rtol=1e-4)
