"""The port's public surface against the JAX package's.

Every name in each JAX module's ``__all__`` resolves in the port's
module at the same path, but the jax-only names of ``JAX_ONLY`` (one
reason each); the README quickstart runs through both packages'
top-level names (equal ``to_json``; with the JAX weights crossed by
checkpoint, outputs within 1e-5); and the smaller names: every layer
type's ``num_params``, ``activations.register``, the npz helpers on
either package's bytes, and ``import deeplearning4j_tpu_torch`` building
and loading no kernel.
"""

import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deeplearning4j_tpu as jpkg
import deeplearning4j_tpu_torch as tpkg
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.layers.base import LAYER_REGISTRY as JAX_LAYERS
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf.layers import (LAYER_REGISTRY,
                                                     layer_from_dict)
from deeplearning4j_tpu_torch.util import model_serializer as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "deeplearning4j_tpu")

# (JAX module, name): why the port has no counterpart. Each wraps jax
# itself (tracing, jit, optax, Pallas, XLA platforms or shardings).
JAX_ONLY = {
    ("deeplearning4j_tpu.parallel.compat", "*"):
        "jax version shims (the whole module)",
    ("deeplearning4j_tpu.observability", "CompileWatcher"):
        "counts XLA compiles of jax.jit functions",
    ("deeplearning4j_tpu.observability", "RecompileStormError"):
        "raised by CompileWatcher on jit recompiles",
    ("deeplearning4j_tpu.observability", "watch"):
        "wraps a function in jax.jit under CompileWatcher",
    ("deeplearning4j_tpu.observability.compile_watch", "CompileWatcher"):
        "counts XLA compiles of jax.jit functions",
    ("deeplearning4j_tpu.observability.compile_watch",
     "RecompileStormError"): "raised by CompileWatcher on jit recompiles",
    ("deeplearning4j_tpu.observability.compile_watch", "CompileEvent"):
        "one XLA compile as CompileWatcher logs it",
    ("deeplearning4j_tpu.observability.compile_watch", "watch"):
        "wraps a function in jax.jit under CompileWatcher",
    ("deeplearning4j_tpu.nn.conf.updaters", "to_optax"):
        "builds an optax transformation",
    ("deeplearning4j_tpu.ops", "pallas_flash_attention"):
        "the Pallas TPU kernel (ported as ops.attention's CUDA kernels)",
    ("deeplearning4j_tpu.ops.attention", "pallas_flash_attention"):
        "the Pallas TPU kernel (ported as flash_attention_fwd_cuda)",
    ("deeplearning4j_tpu.ops.attention", "pallas_flash_attention_bwd"):
        "the Pallas TPU kernels (ported as flash_attention_bwd_cuda)",
    ("deeplearning4j_tpu.util.platform", "pin_cpu_platform"):
        "pins jax's platform (the port takes device=)",
    ("deeplearning4j_tpu.parallel.mesh", "replicated"):
        "a jax NamedSharding",
    ("deeplearning4j_tpu.parallel.mesh", "data_sharding"):
        "a jax NamedSharding",
    ("deeplearning4j_tpu.models.kstep", "canonical_np"):
        "canonicalizes arrays for jax's AOT lowering",
    ("deeplearning4j_tpu.models.kstep", "make_kstep_fn"):
        "a jax.lax.scan of k jitted steps (the port captures CUDA graphs)",
    ("deeplearning4j_tpu.models.kstep", "aot_compile"):
        "jax AOT lowering and compilation",
    ("deeplearning4j_tpu.serving", "pow2_pad_rows"):
        "XLA's shape buckets; the port's scheduler does not pad batches",
    ("deeplearning4j_tpu.serving.scheduler", "pow2_pad_rows"):
        "XLA's shape buckets; the port's scheduler does not pad batches",
}


def _jax_modules():
    """(module name, its literal ``__all__`` or None if computed) of
    every JAX module that defines one."""
    out = []
    for dp, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dp, f)
            names = None
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, ast.Assign) and any(
                        getattr(t, "id", None) == "__all__"
                        for t in node.targets):
                    try:
                        names = ast.literal_eval(node.value)
                    except ValueError:
                        names = None
                    break
            else:
                continue
            mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            out.append((mod[:-len(".__init__")] if mod.endswith("__init__")
                        else mod, names))
    return sorted(out)


JAX_MODULES = _jax_modules()


def test_the_walk_found_the_packages():
    mods = dict(JAX_MODULES)
    assert len(mods) > 100
    for m in ("deeplearning4j_tpu", "deeplearning4j_tpu.nn.conf",
              "deeplearning4j_tpu.observability", "deeplearning4j_tpu.chaos",
              "deeplearning4j_tpu.serving"):
        assert m in mods


@pytest.mark.parametrize("module", [m for m, _ in JAX_MODULES])
def test_every_exported_name_resolves_in_the_port(module):
    names = dict(JAX_MODULES)[module]
    if names is None:      # computed __all__: ask the module itself
        names = importlib.import_module(module).__all__
    if (module, "*") in JAX_ONLY:
        return
    port = importlib.import_module(
        module.replace("deeplearning4j_tpu", "deeplearning4j_tpu_torch", 1))
    missing = [n for n in names if not hasattr(port, n)
               and (module, n) not in JAX_ONLY]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_every_jax_only_name_is_still_exported_by_jax():
    """The exception list stays honest: each entry names a real export."""
    mods = dict(JAX_MODULES)
    for (module, name), why in JAX_ONLY.items():
        assert why
        if name != "*":
            names = mods[module] or importlib.import_module(module).__all__
            assert name in names, (module, name)


def test_top_level_names_equal_the_jax_package():
    assert tpkg.__all__ == jpkg.__all__
    assert tpkg.MultiLayerNetwork.__module__.startswith(
        "deeplearning4j_tpu_torch.")


def test_package_names_resolve_at_first_use():
    """Importing the packages with package-level names imports no torch:
    light modules (chaos, serving.errors, the CLI) stay light in the
    processes that import only them."""
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch, deeplearning4j_tpu_torch.cli\n"
            "from deeplearning4j_tpu_torch import (chaos, models, nn, "
            "observability, ops, train)\n"
            "import deeplearning4j_tpu_torch.nn.conf\n"
            "import deeplearning4j_tpu_torch.serving.errors\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "from deeplearning4j_tpu_torch import MultiLayerNetwork\n"
            "assert 'torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_import_builds_and_loads_no_kernel():
    code = ("import deeplearning4j_tpu_torch as p, sys\n"
            "from deeplearning4j_tpu_torch.ops import native\n"
            "from deeplearning4j_tpu_torch import (MultiLayerNetwork,"
            " NeuralNetConfiguration, ComputationGraph, dtypes)\n"
            "from deeplearning4j_tpu_torch.ops import flash_attention\n"
            "assert native._libs == {}, native._libs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'deeplearning4j_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


# --------------------------------------------------- the README quickstart

def _quickstart(pkg):
    """README.md's quickstart through ``pkg``'s top-level names (the
    DSL modules at the same paths in both packages)."""
    updaters = importlib.import_module(f"{pkg.__name__}.nn.conf.updaters")
    inputs = importlib.import_module(f"{pkg.__name__}.nn.conf.inputs")
    layers = importlib.import_module(f"{pkg.__name__}.nn.conf.layers")
    return (pkg.NeuralNetConfiguration.builder()
            .set_seed(12345)
            .updater(updaters.adam(1e-3))
            .list()
            .layer(layers.ConvolutionLayer(n_out=20, kernel=(5, 5),
                                           activation="relu"))
            .layer(layers.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(layers.DenseLayer(n_out=500, activation="relu"))
            .layer(layers.OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(inputs.InputType.convolutional_flat(28, 28, 1))
            .build())


def test_readme_quickstart_through_both_packages(tmp_path):
    from deeplearning4j_tpu.data.fetchers import MnistDataSetIterator
    from deeplearning4j_tpu_torch.data.fetchers import (
        MnistDataSetIterator as TMnist)
    jconf, tconf = _quickstart(jpkg), _quickstart(tpkg)
    assert tconf.to_json() == jconf.to_json()
    jnet = jpkg.MultiLayerNetwork(jconf).init()
    jnet.fit(MnistDataSetIterator(64, train=True, n=128), epochs=1)
    path = str(tmp_path / "quickstart.zip")
    jser.write_model(jnet, path)
    tnet = tser.restore_model(path, device="cpu")
    assert isinstance(tnet, tpkg.MultiLayerNetwork)
    x = np.random.default_rng(0).random((4, 784), dtype=np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5)
    tnet.fit(TMnist(64, train=True, n=128), epochs=1)
    assert tnet.evaluate(TMnist(64, train=False, n=128,
                                shuffle=False)).accuracy() >= 0.0


# ------------------------------------------------------- smaller names

_LAYER_KW = {
    "FrozenLayer": {"inner": jl.DenseLayer(n_out=3)},
    "Bidirectional": {"fwd": jl.LSTM(n_out=4).to_dict()},
    "LastTimeStep": {"underlying": jl.LSTM(n_out=4).to_dict()},
    "EmbeddingLayer": {"n_in": 10, "n_out": 4},
    "EmbeddingSequenceLayer": {"n_in": 10, "n_out": 4},
    "SelfAttentionLayer": {"n_out": 8, "n_heads": 2},
    "TransformerEncoderLayer": {"n_heads": 2},
}
_TYPES = {"ff": lambda m: m.feed_forward(8),
          "rnn": lambda m: m.recurrent(8, 5),
          "cnn": lambda m: m.convolutional(6, 6, 4)}


@pytest.mark.parametrize("name", sorted(JAX_LAYERS))
def test_num_params_equals_jax_for_every_layer_type(name):
    """For every input kind the JAX layer accepts, the port's layer of
    the same config counts the same parameters."""
    cls = JAX_LAYERS[name]
    kw = dict(_LAYER_KW.get(name, {}))
    if "n_out" in {f.name for f in dataclasses.fields(cls)} \
            and name != "TransformerEncoderLayer":
        kw.setdefault("n_out", 4)
    assert name in LAYER_REGISTRY
    checked = 0
    for kind, make in _TYPES.items():
        j = cls(**kw)
        d = j.to_dict()
        try:
            j.set_n_in(make(JIT))
            want = j.num_params(make(JIT))
        except Exception:       # an input kind this layer does not take
            continue
        t = layer_from_dict(d)
        t.set_n_in(make(TIT))
        assert t.num_params(make(TIT)) == want, (name, kind)
        checked += 1
    assert checked, f"{name}: no input kind checked"


def test_activations_register_resolves_through_get_and_configs():
    tact.register("TwiceRelu", lambda x: 2 * torch.relu(x))
    try:
        fn = tact.get("twice_relu")     # get drops "_", as JAX's does
        assert torch.equal(fn(torch.tensor([-1.0, 2.0])),
                           torch.tensor([0.0, 4.0]))
        layer = layer_from_dict({"@type": "DenseLayer", "n_in": 2,
                                 "n_out": 1, "activation": "twicerelu"})
        assert layer.activation_fn()(torch.tensor([3.0])).item() == 6.0
    finally:
        tact.ACTIVATIONS.pop("twicerelu", None)


def _tree(rng):
    return [{"W": rng.normal(0, 1, (3, 2)).astype(np.float32),
             "b": rng.normal(0, 1, (2,)).astype(np.float32)},
            {"attn": {"Wq": rng.normal(0, 1, (2, 2)).astype(np.float32)},
             "g": np.arange(4, dtype=np.float32)}]


def test_npz_helpers_are_byte_compatible_with_jax():
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    as_tensors = [{k: (torch.from_numpy(v) if not isinstance(v, dict)
                       else {kk: torch.from_numpy(vv)
                             for kk, vv in v.items()})
                   for k, v in layer.items()} for layer in tree]
    jbytes = jser.save_pytree_npz(tree)
    assert tser.save_pytree_npz(as_tensors) == jbytes
    assert tser.save_pytree_npz(tree) == jbytes
    template = [{k: (torch.zeros_like(v) if not isinstance(v, dict)
                     else {kk: torch.zeros_like(vv) for kk, vv in v.items()})
                 for k, v in layer.items()} for layer in as_tensors]
    back = tser.load_pytree_npz(jbytes, template)
    assert torch.equal(back[1]["attn"]["Wq"], as_tensors[1]["attn"]["Wq"])
    assert isinstance(back[0]["W"], torch.Tensor)
    # a numpy template gives numpy leaves; JAX reads the port's bytes
    np_back = tser.load_pytree_npz(jbytes, tree)
    np.testing.assert_array_equal(np_back[0]["b"], tree[0]["b"])
    jback = jser.load_pytree_npz(tser.save_pytree_npz(as_tensors), tree)
    np.testing.assert_array_equal(np.asarray(jback[1]["g"]), tree[1]["g"])


def test_npz_helpers_read_the_zip_entries(tmp_path):
    """A zip's coefficients.npz (written by the JAX package) loads into
    the port net's params through load_pytree_npz."""
    import zipfile
    from deeplearning4j_tpu import MultiLayerNetwork as JNet
    jnet = JNet(_quickstart(jpkg)).init()
    path = str(tmp_path / "m.zip")
    jser.write_model(jnet, path)
    tnet = tser.restore_model(path, device="cpu")
    with zipfile.ZipFile(path) as z:
        data = z.read("coefficients.npz")
    back = tser.load_pytree_npz(data, tnet.params)
    for a, b in zip(tser._flatten(back).values(),
                    tser._flatten(tnet.params).values()):
        np.testing.assert_array_equal(a, b)
    assert tser.save_pytree_npz(tnet.params) == \
        jser.save_pytree_npz(jnet.params)
