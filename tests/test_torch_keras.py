"""Keras HDF5 import in the port against the JAX package's importer, on
the CPU.

Keras writes every model of ``tests/test_keras_import.py`` (and the
Keras-1 files that test writes by hand) in one subprocess per module:
TensorFlow and torch stay out of one process. Each ``.h5`` then goes
through the JAX importer and the port's (``device="cpu"``): the config
JSON must be equal and the outputs within rtol 1e-5 / atol 1e-6 (both
float32; sums in another order). The refusals must raise the same
``KerasImportError`` message in both. A VGG16 (bench.py's layer names,
64x64 input, narrowed widths) is imported from Keras's file and from
``chip_smoke.py``'s in-memory helper at the same widths, so the helper's
config is held to what Keras writes; so is its transformer block.
``load_model_guess``, ``summary()`` and the ``summary`` CLI verb are
held to the JAX package's.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

import chip_smoke  # noqa: E402
from deeplearning4j_tpu.keras import importer as jimp  # noqa: E402
from deeplearning4j_tpu.nn.conf import updaters as jupd  # noqa: E402
from deeplearning4j_tpu.util import model_guesser as jguess  # noqa: E402
from deeplearning4j_tpu.util import model_serializer as jser  # noqa: E402
from deeplearning4j_tpu_torch import cli  # noqa: E402
from deeplearning4j_tpu_torch.data.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.keras import importer as timp  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import updaters as tupd  # noqa: E402
from deeplearning4j_tpu_torch.util import (  # noqa: E402
    model_guesser as tguess)

RTOL, ATOL = 1e-5, 1e-6

# Each model of tests/test_keras_import.py, written by Keras 3 (legacy
# h5), with its input; the Keras-1 files as that test writes them; the
# refusals; and the smoke helper's twins at small widths.
_KERAS_SCRIPT = r'''
import json, os, sys
import numpy as np
import h5py
import keras
from keras import layers

out = sys.argv[1]
rng = np.random.default_rng(0)
inputs = {}


def save(name, m, x):
    m.save(os.path.join(out, name + ".h5"))
    inputs[name] = x


def normal(shape, loc=0.0, scale=1.0):
    return rng.normal(loc, scale, shape).astype(np.float32)


def seq(*ls):
    return keras.Sequential(list(ls))


save("mlp", seq(keras.Input((8,)), layers.Dense(16, activation="relu"),
                layers.Dense(12, activation="tanh"),
                layers.Dense(3, activation="softmax")), normal((5, 8)))
save("cnn", seq(keras.Input((12, 12, 3)),
                layers.Conv2D(8, 3, activation="relu", padding="same"),
                layers.MaxPooling2D(2),
                layers.Conv2D(16, 3, activation="relu", padding="valid"),
                layers.AveragePooling2D(2), layers.Flatten(),
                layers.Dense(10, activation="softmax")),
     normal((4, 12, 12, 3)))
save("cnn_strided_dilated", seq(
    keras.Input((16, 16, 2)), layers.Conv2D(4, 3, strides=2, padding="same"),
    layers.Conv2D(6, 3, dilation_rate=2, padding="valid", activation="elu"),
    layers.GlobalAveragePooling2D(), layers.Dense(5, activation="softmax")),
    normal((3, 16, 16, 2)))
bn = seq(keras.Input((6,)), layers.Dense(8), layers.BatchNormalization(),
         layers.Activation("relu"), layers.Dense(3, activation="softmax"))
bn.compile("adam", "categorical_crossentropy")
bn.fit(normal((64, 6), 2, 3),
       np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)], epochs=2,
       verbose=0)
save("batchnorm", bn, normal((5, 6), 2, 3))
save("layernorm", seq(keras.Input((7, 6)), layers.Dense(8),
                      layers.LayerNormalization(),
                      layers.Dense(3, activation="softmax")),
     normal((4, 7, 6), 1, 2))
save("lstm_sequences", seq(keras.Input((7, 4)),
                           layers.LSTM(6, return_sequences=True),
                           layers.Dense(3, activation="softmax")),
     normal((2, 7, 4)))
save("lstm_last_step", seq(keras.Input((5, 3)), layers.LSTM(8),
                           layers.Dense(2, activation="softmax")),
     normal((3, 5, 3)))
save("embedding", seq(keras.Input((6,)), layers.Embedding(20, 8),
                      layers.GlobalAveragePooling1D(),
                      layers.Dense(3, activation="softmax")),
     rng.integers(0, 20, (4, 6)).astype(np.float32))
save("depthwise_separable", seq(
    keras.Input((10, 10, 4)),
    layers.DepthwiseConv2D(3, padding="same", depth_multiplier=2),
    layers.SeparableConv2D(6, 3, padding="valid", activation="relu"),
    layers.GlobalMaxPooling2D(), layers.Dense(2, activation="softmax")),
    normal((2, 10, 10, 4)))
save("conv1d_pool1d", seq(
    keras.Input((11, 4)),
    layers.Conv1D(6, 3, strides=2, padding="same", activation="relu"),
    layers.MaxPooling1D(2), layers.Conv1D(5, 2, padding="valid"),
    layers.AveragePooling1D(2, strides=1),
    layers.GlobalMaxPooling1D(), layers.Dense(3, activation="softmax")),
    normal((3, 11, 4)))
save("zeropad_upsample", seq(
    keras.Input((5, 6, 3)), layers.ZeroPadding2D(((1, 2), (0, 1))),
    layers.Conv2D(4, 3, activation="relu"), layers.UpSampling2D((2, 3)),
    layers.Flatten(), layers.Dense(3, activation="softmax")),
    normal((2, 5, 6, 3)))

inp = keras.Input((8,))
a = layers.Dense(16, activation="relu", name="a")(inp)
b = layers.Dense(16, activation="tanh", name="b")(inp)
o = layers.Dense(3, activation="softmax", name="out")(
    layers.Add(name="add")([a, b]))
save("two_branch_add", keras.Model(inp, o), normal((4, 8)))

inp = keras.Input((8, 8, 3))
c1 = layers.Conv2D(4, 3, padding="same", activation="relu", name="c1")(inp)
c2 = layers.Conv2D(4, 3, padding="same", name="c2")(inp)
pooled = layers.GlobalAveragePooling2D(name="gap")(
    layers.Concatenate(name="cat")([c1, c2]))
save("concat_residual", keras.Model(
    inp, layers.Dense(2, activation="softmax", name="out")(pooled)),
    normal((3, 8, 8, 3)))

d, T, H = 16, 12, 4
inp = keras.Input((T, d))
h = layers.LayerNormalization()(inp)
x1 = layers.Add()([inp, layers.MultiHeadAttention(
    num_heads=H, key_dim=d // H)(h, h)])
m2 = layers.Dense(d)(layers.Dense(4 * d, activation="gelu")(
    layers.LayerNormalization()(x1)))
o = layers.Dense(3, activation="softmax")(
    layers.GlobalAveragePooling1D()(layers.Add()([x1, m2])))
save("transformer_block", keras.Model(inp, o), normal((3, T, d)))

inp = keras.Input((10, 8))
att = layers.MultiHeadAttention(num_heads=2, key_dim=4)(
    inp, inp, use_causal_mask=True)
save("causal_mha", keras.Model(inp, layers.Dense(2, activation="softmax")(
    layers.GlobalAveragePooling1D()(att))), normal((3, 10, 8)))

# chip_smoke.py's transformer block, named as its helper names it
d, T, H = 16, 12, 4
inp = keras.Input((T, d), name="inp")
h = layers.LayerNormalization(name="ln1")(inp)
x1 = layers.Add(name="add1")([inp, layers.MultiHeadAttention(
    num_heads=H, key_dim=d // H, name="mha")(h, h)])
m2 = layers.Dense(d, name="ff2")(layers.Dense(
    4 * d, activation="gelu", name="ff1")(
        layers.LayerNormalization(name="ln2")(x1)))
o = layers.Dense(5, activation="softmax", name="pred")(
    layers.GlobalAveragePooling1D(name="gap")(
        layers.Add(name="add2")([x1, m2])))
save("smoke_block", keras.Model(inp, o), normal((2, T, d)))

# bench.py's VGG16 (_KERAS_VGG16_SCRIPT) at 64x64, narrowed
vgg = keras.Sequential(name="vgg16")
vgg.add(keras.Input((64, 64, 3)))
for block, (n, reps) in enumerate(((4, 2), (6, 2), (8, 3), (8, 3),
                                   (8, 3))):
    for r in range(reps):
        vgg.add(layers.Conv2D(n, 3, padding="same", activation="relu",
                              name=f"b{block}c{r}"))
    vgg.add(layers.MaxPooling2D(2, 2, name=f"b{block}p"))
vgg.add(layers.Flatten(name="flat"))
vgg.add(layers.Dense(12, activation="relu", name="fc1"))
vgg.add(layers.Dense(12, activation="relu", name="fc2"))
vgg.add(layers.Dense(7, activation="softmax", name="pred"))
save("vgg16_small", vgg, normal((2, 64, 64, 3)))


# Keras-1 files (tests/test_keras_import.py's _write_k1)
def write_k1(name, cfg, weights, x):
    with h5py.File(os.path.join(out, name + ".h5"), "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        f.attrs["keras_version"] = "1.2.2"
        mw = f.create_group("model_weights")
        for lname, arrays in weights.items():
            grp = mw.create_group(lname)
            names = []
            for i, arr in enumerate(arrays):
                grp.create_dataset(f"{lname}_param_{i}", data=arr)
                names.append(f"{lname}_param_{i}".encode())
            grp.attrs["weight_names"] = names
    inputs[name] = x


m2 = seq(keras.Input((4,)), layers.Dense(8, activation="relu", name="d1"),
         layers.Dense(3, activation="softmax", name="d2"))
write_k1("k1_mlp", {"class_name": "Sequential", "config": [
    {"class_name": "Dense", "config": {
        "name": "d1", "output_dim": 8, "activation": "relu",
        "batch_input_shape": [None, 4], "init": "glorot_uniform",
        "bias": True}},
    {"class_name": "Dropout", "config": {"name": "drop", "p": 0.25}},
    {"class_name": "Dense", "config": {
        "name": "d2", "output_dim": 3, "activation": "softmax",
        "init": "glorot_uniform", "bias": True}}]},
    {"d1": m2.get_layer("d1").get_weights(),
     "d2": m2.get_layer("d2").get_weights()}, normal((6, 4)))
m2 = seq(keras.Input((12, 12, 3)),
         layers.Conv2D(4, 3, padding="valid", activation="relu", name="c1"),
         layers.MaxPooling2D(2, 2, name="p1"), layers.Flatten(name="fl"),
         layers.Dense(5, activation="softmax", name="d1"))
write_k1("k1_cnn", {"class_name": "Sequential", "config": [
    {"class_name": "Convolution2D", "config": {
        "name": "c1", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
        "border_mode": "valid", "subsample": [1, 1], "dim_ordering": "tf",
        "activation": "relu", "batch_input_shape": [None, 12, 12, 3],
        "bias": True}},
    {"class_name": "MaxPooling2D", "config": {
        "name": "p1", "pool_size": [2, 2], "strides": [2, 2],
        "border_mode": "valid", "dim_ordering": "tf"}},
    {"class_name": "Flatten", "config": {"name": "fl"}},
    {"class_name": "Dense", "config": {
        "name": "d1", "output_dim": 5, "activation": "softmax",
        "bias": True}}]},
    {"c1": m2.get_layer("c1").get_weights(),
     "d1": m2.get_layer("d1").get_weights()}, normal((3, 12, 12, 3)))
m2 = seq(keras.Input((5, 4)),
         layers.LSTM(6, activation="tanh", recurrent_activation="sigmoid",
                     return_sequences=False, name="l1"),
         layers.Dense(3, activation="softmax", name="d1"))
kernel, recurrent, bias = m2.get_layer("l1").get_weights()
sl = {g: slice(i * 6, (i + 1) * 6) for i, g in enumerate("ifco")}
per_gate = []
for g in "icfo":
    per_gate += [kernel[:, sl[g]], recurrent[:, sl[g]], bias[sl[g]]]
write_k1("k1_lstm_per_gate", {"class_name": "Sequential", "config": [
    {"class_name": "LSTM", "config": {
        "name": "l1", "output_dim": 6, "activation": "tanh",
        "inner_activation": "sigmoid", "return_sequences": False,
        "batch_input_shape": [None, 5, 4]}},
    {"class_name": "Dense", "config": {
        "name": "d1", "output_dim": 3, "activation": "softmax",
        "bias": True}}]},
    {"l1": per_gate, "d1": m2.get_layer("d1").get_weights()},
    normal((4, 5, 4)))

# refusals
write_k1("refuse_th_ordering", {"class_name": "Sequential", "config": [
    {"class_name": "Convolution2D", "config": {
        "name": "c1", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
        "border_mode": "valid", "dim_ordering": "th",
        "batch_input_shape": [None, 3, 12, 12]}}]}, {}, None)
a, b = keras.Input((6, 8)), keras.Input((6, 8))
att = layers.MultiHeadAttention(num_heads=2, key_dim=4)(a, b)
save("refuse_cross_attention", keras.Model([a, b], layers.Dense(
    2, activation="softmax")(layers.GlobalAveragePooling1D()(att))), None)
inp = keras.Input((6, 8))
att = layers.MultiHeadAttention(num_heads=2, key_dim=4, value_dim=8)(
    inp, inp)
save("refuse_value_dim", keras.Model(inp, layers.Dense(
    2, activation="softmax")(layers.GlobalAveragePooling1D()(att))), None)
save("refuse_rms_scaling", seq(keras.Input((7, 6)),
                               layers.LayerNormalization(rms_scaling=True),
                               layers.Dense(3, activation="softmax")), None)
save("refuse_ln_axis", seq(keras.Input((7, 6)),
                           layers.LayerNormalization(axis=1),
                           layers.Dense(3, activation="softmax")), None)
save("refuse_gru", seq(keras.Input((8, 4)), layers.GRU(6),
                       layers.Dense(2, activation="softmax")), None)
with h5py.File(os.path.join(out, "refuse_no_model_config.h5"), "w") as f:
    f.create_dataset("x", data=np.zeros(3))
m = seq(keras.Input((8,)), layers.Dense(4, name="d1"),
        layers.Dense(2, activation="softmax", name="d2"))
m.save(os.path.join(out, "refuse_no_weight_names.h5"))
with h5py.File(os.path.join(out, "refuse_no_weight_names.h5"), "a") as f:
    del f["model_weights"]["d1"].attrs["weight_names"]

np.savez(os.path.join(out, "inputs.npz"),
         **{k: v for k, v in inputs.items() if v is not None})
'''

MODELS = ("mlp", "cnn", "cnn_strided_dilated", "batchnorm", "layernorm",
          "lstm_sequences", "lstm_last_step", "embedding",
          "depthwise_separable", "conv1d_pool1d", "zeropad_upsample",
          "two_branch_add", "concat_residual", "transformer_block",
          "causal_mha", "smoke_block", "vgg16_small", "k1_mlp", "k1_cnn",
          "k1_lstm_per_gate")
REFUSALS = ("refuse_th_ordering", "refuse_cross_attention",
            "refuse_value_dim", "refuse_rms_scaling", "refuse_ln_axis",
            "refuse_gru", "refuse_no_model_config",
            "refuse_no_weight_names")


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("keras")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "KERAS_BACKEND": "tensorflow", "TF_CPP_MIN_LOG_LEVEL": "3"}
    subprocess.run([sys.executable, "-c", _KERAS_SCRIPT, str(out)],
                   check=True, timeout=600, env=env, capture_output=True)
    with np.load(out / "inputs.npz") as z:
        inputs = dict(z)
    return out, inputs


def _pair(path):
    """(the JAX importer's network, the port's on the CPU)."""
    return (jimp.import_keras_model_and_weights(str(path)),
            timp.import_keras_model_and_weights(str(path), device="cpu"))


def _outputs(net, x):
    y = net.output(x)
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


@pytest.mark.parametrize("name", MODELS)
def test_port_import_equals_jax_import(keras_files, name):
    out, inputs = keras_files
    jn, tn = _pair(out / f"{name}.h5")
    assert tn.conf.to_json() == jn.conf.to_json()
    x = inputs[name]
    np.testing.assert_allclose(_outputs(tn, x), _outputs(jn, x), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match(keras_files, name):
    out, _ = keras_files
    path = str(out / f"{name}.h5")
    with pytest.raises(jimp.KerasImportError) as jerr:
        jimp.import_keras_model_and_weights(path)
    with pytest.raises(timp.KerasImportError) as terr:
        timp.import_keras_model_and_weights(path, device="cpu")
    assert str(terr.value) == str(jerr.value)


def _archive_of(path):
    """The model_config and every layer's arrays of a Keras h5 file."""
    with h5py.File(path, "r") as f:
        cfg = json.loads(f.attrs["model_config"])
        weights = {}
        for name, grp in f["model_weights"].items():
            names = [n.decode() if isinstance(n, bytes) else n
                     for n in grp.attrs.get("weight_names", [])]
            weights[name] = [np.asarray(grp[n]) for n in names]
    return cfg, weights


@pytest.mark.parametrize("name,helper", [
    ("vgg16_small", lambda: chip_smoke.keras_vgg16(
        hw=64, widths=(4, 6, 8, 8, 8), dense=12, classes=7)),
    ("smoke_block", lambda: chip_smoke.keras_transformer_block(
        T=12, d=16, H=4, classes=5))])
def test_smoke_helpers_are_held_to_what_keras_writes(keras_files, name,
                                                     helper):
    """chip_smoke.py's hand-written model_config imports to the same
    network as Keras's own file; with the file's arrays in its in-memory
    stand-in (and in a real h5 written from it) the outputs equal the
    file's, in the port and in the JAX importer; its weight shapes are
    Keras's."""
    out, inputs = keras_files
    path = out / f"{name}.h5"
    cfg, shapes = helper()
    _, weights = _archive_of(path)
    assert {k: [s for s, _ in v] for k, v in shapes.items()} == \
        {k: [a.shape for a in v] for k, v in weights.items() if v}
    archive = chip_smoke.H5Like(cfg, weights)
    build = (timp._import_sequential if cfg["class_name"] == "Sequential"
             else timp._import_functional)
    jbuild = (jimp._import_sequential if cfg["class_name"] == "Sequential"
              else jimp._import_functional)
    jn, tn = _pair(path)
    from_helper = build(cfg, archive, device="cpu")
    assert from_helper.conf.to_json() == tn.conf.to_json()
    x = inputs[name]
    want = _outputs(tn, x)
    np.testing.assert_array_equal(_outputs(from_helper, x), want)
    np.testing.assert_allclose(_outputs(jbuild(cfg, archive), x),
                               _outputs(jn, x), rtol=0, atol=0)
    h5 = out / f"{name}_helper.h5"
    chip_smoke.write_keras_h5(str(h5), cfg, weights)
    np.testing.assert_array_equal(_outputs(_pair(h5)[1], x), want)


def test_smoke_weights_are_keras_default_init():
    _, shapes = chip_smoke.keras_vgg16(hw=64, widths=(4, 6, 8, 8, 8),
                                       dense=12, classes=7)
    w = chip_smoke.keras_weights(shapes, seed=0)
    again = chip_smoke.keras_weights(shapes, seed=0)
    kernel, bias = w["b1c0"]
    assert kernel.shape == (3, 3, 4, 6) and kernel.dtype == np.float32
    limit = np.sqrt(6.0 / (9 * 4 + 9 * 6))
    assert np.abs(kernel).max() <= limit and kernel.std() > limit / 3
    assert not bias.any()
    assert all(np.array_equal(a, b) for k in w for a, b in zip(w[k], again[k]))


def test_imported_model_trains_like_jax(keras_files):
    """tests/test_keras_import.py's trainable check, held step for step:
    the imported MLP with Adam, three fit steps in each package."""
    out, _ = keras_files
    jn, tn = _pair(out / "mlp.h5")
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jn.conf.conf.updater_cfg = jupd.adam(0.05)
    tn.conf.conf.updater_cfg = tupd.adam(0.05)
    jn._build_optimizer()
    tn._build_optimizer()
    for _ in range(3):
        jn.fit(x, y)
        tn.fit(DataSet(x, y))
    np.testing.assert_allclose(tn.params_flat(), np.asarray(
        jn.params_flat()), rtol=1e-4, atol=1e-5)


def test_load_model_guess_and_summary(keras_files, tmp_path, capsys):
    out, inputs = keras_files
    h5 = str(out / "vgg16_small.h5")
    assert tguess.guess_format(h5) == jguess.guess_format(h5) == "keras_h5"
    jn = jguess.load_model_guess(h5)
    tn = tguess.load_model_guess(h5, device="cpu")
    assert tn.summary() == jn.summary()
    x = inputs["vgg16_small"]
    np.testing.assert_allclose(_outputs(tn, x), _outputs(jn, x), rtol=RTOL,
                               atol=ATOL)
    zp = str(tmp_path / "vgg.zip")
    jser.write_model(jn, zp)
    assert tguess.guess_format(zp) == "checkpoint"
    restored = tguess.load_model_guess(zp, device="cpu")
    np.testing.assert_allclose(_outputs(restored, x), _outputs(jn, x),
                               rtol=RTOL, atol=ATOL)
    g = str(out / "transformer_block.h5")
    assert (tguess.load_model_guess(g, device="cpu").summary()
            == jguess.load_model_guess(g).summary())
    cli.main(["summary", "--model", zp, "--device", "cpu"])
    assert capsys.readouterr().out == (
        "format: checkpoint\n" + jser.restore_model(zp).summary() + "\n")
    wv = tmp_path / "vectors.txt"
    wv.write_text("2 3\nthe 0.1 0.2 0.3\nof 0.4 0.5 0.6\n")
    assert tguess.guess_format(str(wv)) == "word_vectors"
    t_vocab, t_vecs = tguess.load_model_guess(str(wv), device="cpu")
    j_vocab, j_vecs = jguess.load_model_guess(str(wv))
    assert [w.word for w in t_vocab.words] == \
        [w.word for w in j_vocab.words] == ["the", "of"]
    np.testing.assert_array_equal(t_vecs, j_vecs)
    cli.main(["summary", "--model", str(wv), "--device", "cpu"])
    assert capsys.readouterr().out == "format: word_vectors\n"
    junk = tmp_path / "junk.bin"
    shutil.copy(h5, junk)
    with open(junk, "r+b") as f:
        f.write(b"\x00" * 8)
    with pytest.raises(ValueError, match="Cannot determine"):
        tguess.load_model_guess(str(junk), device="cpu")

