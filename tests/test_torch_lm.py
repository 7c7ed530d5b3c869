"""The port's transformer-LM path against the JAX package, on the CPU.

Layer functions (layer norm, activations, embedding) and the whole
slice: an LM built with the JAX builder and saved with its
``write_model`` is restored by the port and must give the same
``output()``; a zip the port writes must restore in JAX. Inputs are
seeded numpy arrays fed to both packages. Tolerance: float32 on both
sides with sums in another order, atol=2e-5, rtol=2e-4.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               SelfAttentionLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.nn.conf.layers.normalization import (
    layer_norm as jax_layer_norm)
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.layers.core import embedding_lookup
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import (
    layer_norm)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.weights import init_weight
from deeplearning4j_tpu_torch.util import model_serializer as tser

ATOL, RTOL = 2e-5, 2e-4
V, D, L, H, T = 64, 32, 2, 4, 16


def _jax_lm(causal=True, seed=0):
    b = (NeuralNetConfiguration.builder().set_seed(seed).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=causal))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V, T)).build())
    return JaxNet(conf).init()


@pytest.fixture(scope="module")
def jax_lm():
    return _jax_lm()


@pytest.fixture(scope="module")
def jax_zip(jax_lm, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    jser.write_model(jax_lm, path)
    return path


def _ids(n=3, seed=0):
    return np.random.default_rng(seed).integers(0, V, (n, T)).astype(
        np.float32)


# --------------------------------------------------------------- layers

def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(2, 3, (2, 5, 32)).astype(np.float32)
    g = rng.normal(1, 0.1, (32,)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    ref = np.asarray(jax_layer_norm(x, g, b))
    out = layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.default_rng(1).normal(0, 2, (4, 33)).astype(np.float32)
    ref = np.asarray(jact.get(name)(jnp.asarray(x)))
    out = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-3, 3, 61)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tact.get("gelu")(x).numpy(), ref,
                               atol=1e-6)
    assert not torch.allclose(tact.get("gelu")(x),
                              torch.nn.functional.gelu(x), atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        tact.get("nope")


def test_embedding_matches_jnp_take():
    W = np.random.default_rng(2).normal(0, 1, (6, 3)).astype(np.float32)
    ids = np.array([[0, 5, 6, -1, -6], [-7, 100, 2.7, -0.5, -1.2]],
                   np.float32)
    ref = np.asarray(jnp.take(jnp.asarray(W),
                              jnp.asarray(ids).astype(jnp.int32), axis=0))
    out = embedding_lookup(torch.from_numpy(W), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), ref)      # NaN rows too
    assert np.isnan(ref[0, 2]).all() and np.isnan(ref[1, 1]).all()
    np.testing.assert_array_equal(ref[0, 3], W[5])        # -1 wraps


def test_embedding_layer_squeezes_trailing_axis():
    layer = tlayers.EmbeddingSequenceLayer(n_in=6, n_out=3)
    W = torch.randn(6, 3)
    ids = torch.tensor([[1.0, 2.0, 3.0]])
    a, _ = layer.apply({"W": W}, {}, ids)
    b, _ = layer.apply({"W": W}, {}, ids[..., None])
    assert torch.equal(a, b) and a.shape == (1, 3, 3)


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_layer_matches_jax(masked):
    rng = np.random.default_rng(3)
    jl = SelfAttentionLayer(n_in=16, n_out=16, n_heads=4, causal=True,
                            qkv_bias=True)
    params, _ = jl.initialize(jax.random.PRNGKey(0),
                              JaxInputType.recurrent(16))
    params = {k: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
        np.float32) for k, v in params.items()}
    x = rng.normal(0, 1, (2, 12, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 12), np.float32)
        mask[1, 7:] = 0
    ref, _ = jl.apply(params, {}, x, mask=mask)
    tl = tlayers.layer_from_dict(jl.to_dict())
    out, _ = tl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      {}, torch.from_numpy(x),
                      mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("scheme,std", [("xavier", (2 / 96) ** 0.5),
                                        ("relu", (2 / 32) ** 0.5),
                                        ("normal", (1 / 32) ** 0.5)])
def test_init_weight_scale_and_seed(scheme, std):
    w = init_weight(torch.Generator().manual_seed(0), (32, 64), scheme,
                    32, 64)
    again = init_weight(torch.Generator().manual_seed(0), (32, 64), scheme,
                        32, 64)
    assert torch.equal(w, again) and w.shape == (32, 64)
    assert abs(w.std().item() - std) < 0.1 * std


# --------------------------------------------------------------- configs

def test_config_json_round_trips_unchanged(jax_lm):
    js = jax_lm.conf.to_json()
    assert MultiLayerConfiguration.from_json(js).to_json() == js


def test_unported_layer_type_is_named(jax_lm):
    d = json.loads(jax_lm.conf.to_json())
    d["layers"][1]["@type"] = "LSTM"
    with pytest.raises(ValueError, match="'LSTM'"):
        MultiLayerConfiguration.from_dict(d)


def test_preprocessor_is_not_ported_yet(jax_lm):
    d = json.loads(jax_lm.conf.to_json())
    d["preprocessors"] = {"1": {"@type": "RnnToFeedForwardPreProcessor"}}
    with pytest.raises(NotImplementedError,
                       match="RnnToFeedForwardPreProcessor"):
        MultiLayerConfiguration.from_dict(d)


def test_newer_format_version_refused(jax_lm):
    d = json.loads(jax_lm.conf.to_json())
    d["format_version"] = 99
    with pytest.raises(ValueError, match="newer"):
        MultiLayerConfiguration.from_dict(d)


# ---------------------------------------------------------- the slice

def test_restored_jax_zip_matches_jax_output(jax_lm, jax_zip):
    ids = _ids()
    ref = np.asarray(jax_lm.output(ids))
    net = tser.restore_model(jax_zip, device="cpu")
    out = net.output(ids)
    assert out.shape == (3, T, V) and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_params_from_jax_matches_jax_output(jax_lm):
    ids = _ids(seed=1)
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jax_lm.conf.to_json()),
        device="cpu")
    net.set_params(tser.params_from_jax(jax_lm.params, device="cpu"))
    np.testing.assert_allclose(net.output(ids).numpy(),
                               np.asarray(jax_lm.output(ids)),
                               atol=ATOL, rtol=RTOL)
    assert net.params[1]["attn"]["Wq"].shape == (D, D)


def test_port_zip_restores_in_jax(jax_lm, tmp_path):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jax_lm.conf.to_json()),
        device="cpu").init(seed=5)
    path = str(tmp_path / "port.zip")
    tser.write_model(net, path)
    # the fresh updater state too, as the JAX package writes it at init
    assert set(tser.verify_checkpoint(path)["crc32"]) == {
        "configuration.json", "coefficients.npz", "state.npz",
        "metadata.json", "updater_state.npz"}
    jax_net = jser.restore_model(path)
    ids = _ids(seed=2)
    np.testing.assert_allclose(np.asarray(jax_net.output(ids)),
                               net.output(ids).numpy(), atol=ATOL,
                               rtol=RTOL)
    again = tser.restore_model(path, device="cpu")
    assert torch.equal(again.output(ids), net.output(ids))


def test_non_causal_lm_matches_jax(tmp_path):
    jnet = _jax_lm(causal=False, seed=3)
    path = str(tmp_path / "nc.zip")
    jser.write_model(jnet, path)
    ids = _ids(2, seed=3)
    np.testing.assert_allclose(
        tser.restore_model(path, device="cpu").output(ids).numpy(),
        np.asarray(jnet.output(ids)), atol=ATOL, rtol=RTOL)


def test_corrupt_zip_is_caught(jax_zip, tmp_path):
    bad = tmp_path / "bad.zip"
    data = bytearray(open(jax_zip, "rb").read())
    data[len(data) // 2] ^= 0xFF
    bad.write_bytes(bytes(data))
    with pytest.raises(tser.CheckpointIntegrityError):
        tser.verify_checkpoint(str(bad))


def test_checkpoint_shape_mismatch_is_named(jax_zip, tmp_path):
    with zipfile.ZipFile(jax_zip) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    cfg = json.loads(entries["configuration.json"])
    cfg["layers"][0]["n_out"] = D + 1
    entries["configuration.json"] = json.dumps(cfg).encode()
    path = str(tmp_path / "mismatch.zip")
    with zipfile.ZipFile(path, "w") as z:
        for n, data in entries.items():
            z.writestr(n, data)
    with pytest.raises(ValueError, match="0/W"):
        tser.restore_model(path, device="cpu")


def test_default_device_is_cuda_and_refuses_without_card(
        jax_lm, jax_zip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = MultiLayerConfiguration.from_json(jax_lm.conf.to_json())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tser.restore_model(jax_zip)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import deeplearning4j_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'deeplearning4j_tpu' or m.startswith("
        "'deeplearning4j_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=repo)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 39
