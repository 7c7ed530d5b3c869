"""The port's sequence-parallel training against the JAX package's, on
the CPU.

``ParallelWrapper`` over meshes with a ``seq`` axis, as gloo ranks
(``tests/torch_mp_worker.py``): each rank feeds its rows and its chunk
of time, attention rides the ring, a masked loss divides by the global
mask total, a pooling layer combines over the ring. Held against the
JAX package's single-device training on the same numpy inputs from the
same zip: the config transformer (plain, masked and variable-length),
the attention ComputationGraph and the pooled classifier at dp=2 x
sp=2, the embedding LM at dp=2 x tp=2 x sp=2 (8 ranks), and at dp=2 x
sp=4 with and without the int8 compressed reduce. Tolerances are the
JAX dryrun's (``__graft_entry__.py``): rtol 2e-4, atol 2e-5 on the
parameters; the compressed run's loss within rtol 2e-3 of the JAX
package's own compressed run.
"""

import json
import sys

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import (ComputationGraph, MultiLayerNetwork,
                                NeuralNetConfiguration)
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               GlobalPoolingLayer,
                                               LSTM, OutputLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.parallel.mesh import MeshSpec, build_mesh
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu.util.model_serializer import write_model

import torch_dp_worker as worker
import torch_mp_worker as mp

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 8,
                                 reason="needs 8 virtual devices")]

RTOL, ATOL = 2e-4, 2e-5
B, T, C, V = 4, 16, 16, 11


def transformer(seed=13):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(1e-2)).list()
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(C, T)).build())
    return MultiLayerNetwork(conf).init()


def cg_lm(seed=17):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(1e-2)).graph_builder()
            .add_inputs("in")
            .add_layer("t1", TransformerEncoderLayer(n_heads=4, causal=True),
                       "in")
            .add_layer("t2", TransformerEncoderLayer(n_heads=4, causal=True),
                       "t1")
            .add_vertex("res", ElementWiseVertex(op="add"), "t1", "t2")
            .add_layer("out", RnnOutputLayer(n_out=V, loss="mcxent"), "res")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(C, T)).build())
    return ComputationGraph(conf).init()


def classifier(seed=19, pooling="avg"):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.adam(1e-2)).list()
            .layer(TransformerEncoderLayer(n_heads=4))
            .layer(GlobalPoolingLayer(pooling=pooling))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(C, T)).build())
    return MultiLayerNetwork(conf).init()


def lm(seed=6, t=8):
    b = (NeuralNetConfiguration.builder().set_seed(seed)
         .updater(updaters.adam(1e-2)).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=C)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=4, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, t)).build())
    return MultiLayerNetwork(conf).init()


def _data():
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (B, T))]
    fm = np.ones((B, T), np.float32)
    fm[0, T // 2:] = 0.0
    fm[1, T // 4:] = 0.0
    rng_e = np.random.default_rng(37)
    xe = rng_e.normal(0, 1, (B, T, C)).astype(np.float32)
    ye = np.eye(3, dtype=np.float32)[rng_e.integers(0, 3, B)]
    fme = np.ones((B, T), np.float32)
    fme[0, T // 2:] = 0.0
    rng_l = np.random.default_rng(41)
    ids = rng_l.integers(0, V, (8, 8)).astype(np.float32)
    ids_y = np.eye(V, dtype=np.float32)[rng_l.integers(0, V, (8, 8))]
    return {"seq": dict(x=x, y=y), "seqm": dict(x=x, y=y, fm=fm, lm=fm),
            "seqcg": dict(x=x, y=y), "clf": dict(x=xe, y=ye, fm=fme),
            "clfmax": dict(x=xe, y=ye, fm=fme), "lm": dict(x=ids, y=ids_y)}


MAKERS = {"seq": transformer, "seqm": transformer, "seqcg": cg_lm,
          "clf": classifier, "clfmax": lambda: classifier(pooling="max"),
          "lm": lm}
EPOCHS = {"seq": 2, "seqm": 2, "seqcg": 1, "clf": 1, "clfmax": 1, "lm": 2}
MESHES = {
    4: {"data=2,seq=2": [["seq", 2, False], ["seqm", 2, False],
                         ["seqcg", 1, False], ["clf", 1, False],
                         ["clfmax", 1, False]]},
    8: {"data=2,model=2,seq=2": [["lm", 2, False]],
        "data=2,seq=4": [["lm", 3, False], ["lm", 3, True]]},
}


def _ds(name):
    d = _data()[name]
    return DataSet(d["x"], d["y"], d.get("fm"), d.get("lm"))


def _jax_single(name, epochs):
    net = MAKERS[name]()
    for _ in range(epochs):
        net.fit(_ds(name))
    return net


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _data()
    out = {}
    for world, meshes in MESHES.items():
        d = tmp_path_factory.mktemp(f"sp{world}")
        names = {job[0] for jobs in meshes.values() for job in jobs}
        for name in names:
            np.savez(d / f"{name}.npz", **data[name])
            write_model(MAKERS[name](), str(d / f"{name}.zip"))
        with open(d / "sp.json", "w") as f:
            json.dump(meshes, f)
        scenarios = [f"sp:{m}" for m in meshes]
        worker.launch(world, d, scenarios, timeout=180,
                      argv=[sys.executable, mp.__file__, str(d)] + scenarios)
        for m in meshes:
            out[m] = worker.load(d, mp.result_name(f"sp:{m}"), world)
    return out


@pytest.mark.parametrize("name", ["seq", "seqm", "seqcg", "clf",
                                  "clfmax"])
def test_dp2_sp2_matches_jax_single_device(runs, name):
    """The config transformer (plain and variable-length: the key-mask
    chunk rotates with its k/v, the masked loss divides by the global
    mask total), the attention graph with a residual vertex, and the
    masked pooled classifier (avg and max pooling combined over the
    ring)."""
    want = _jax_single(name, EPOCHS[name]).params_flat()
    ranks = runs["data=2,seq=2"]
    for r in ranks:
        np.testing.assert_allclose(r[name], want, rtol=RTOL, atol=ATOL)
    assert len({r[name].tobytes() for r in ranks}) == 1


def test_dp2_tp2_sp2_matches_jax_single_device(runs):
    """Three axes on one mesh: tp's head split inside the ring, the
    bucket over data x seq (8 ranks)."""
    want = _jax_single("lm", 2).params_flat()
    ranks = runs["data=2,model=2,seq=2"]
    for r in ranks:
        np.testing.assert_allclose(r["lm"], want, rtol=RTOL, atol=ATOL)
    desc = json.loads(str(ranks[0]["lm_describe"]))
    assert desc["axes"] == {"dp": 2, "tp": 2, "pp": 1, "sp": 2}


def test_dp2_sp4_plain_and_int8_compressed(runs):
    """dp=2 x sp=4: the full-precision reduce matches JAX's single
    device; the int8 + error-feedback reduce over the data axis (seq in
    full precision first) ends at the JAX package's compressed loss."""
    ranks = runs["data=2,seq=4"]
    want = _jax_single("lm", 3)
    for r in ranks:
        np.testing.assert_allclose(r["lm"], want.params_flat(), rtol=RTOL,
                                   atol=ATOL)
    mesh = build_mesh(MeshSpec(data=2, seq=4), jax.devices()[:8])
    comp = lm()
    ParallelWrapper(comp, mesh, prefetch_buffer=0,
                    dcn_compression={"threshold": 0.0}).fit(
        ListDataSetIterator([_ds("lm")]), epochs=3)
    got = float(ranks[0]["lm_int8_loss"])
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(comp.score_value), rtol=2e-3)
    assert "int8" in json.loads(str(ranks[0]["lm_int8_describe"]))["reduce"]


def test_seq_validation_refuses_what_jax_refuses(tmp_path):
    """Layers that are not pointwise in time (an LSTM) and non-temporal
    inputs refuse a seq mesh, as the JAX wrapper does."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec as TSpec
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import (
        ParallelWrapper as TWrapper)
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    conf = (NeuralNetConfiguration.builder().set_seed(1).list()
            .layer(LSTM(n_out=8))
            .layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(4, 8)).build())
    path = str(tmp_path / "lstm.zip")
    write_model(MultiLayerNetwork(conf).init(), path)
    net = restore_model(path, device="cpu")
    mesh = Mesh(np.arange(2).reshape(TSpec(data=1, seq=2).resolve(2)))
    jmesh = build_mesh(MeshSpec(data=1, seq=2), jax.devices()[:2])
    jnet = MultiLayerNetwork(conf).init()
    with pytest.raises(ValueError) as want:
        ParallelWrapper(jnet, jmesh, prefetch_buffer=0)._validate_seq_model()
    with pytest.raises(ValueError) as got:
        TWrapper(net, mesh, prefetch_buffer=0)
    assert "LSTM" in str(want.value) and "LSTM" in str(got.value)
    assert "not pointwise in time" in str(got.value)
    # the int8 reduce composes with data x seq only, in both packages
    path = str(tmp_path / "seq.zip")
    write_model(transformer(), path)
    jm3 = build_mesh(MeshSpec(data=2, model=2, seq=2), jax.devices()[:8])
    with pytest.raises(NotImplementedError, match="dcn_compression") as w:
        ParallelWrapper(transformer(), jm3, prefetch_buffer=0,
                        dcn_compression={"threshold": 0.0}
                        )._validate_seq_model()
    tm3 = Mesh(np.arange(8).reshape(TSpec(data=2, model=2, seq=2)
                                    .resolve(8)))
    with pytest.raises(NotImplementedError, match="dcn_compression") as g:
        TWrapper(restore_model(path, device="cpu"), tm3, prefetch_buffer=0,
                 dcn_compression={"threshold": 0.0})
    assert "'data' x 'seq'" in str(w.value) and "'data' x 'seq'" in str(
        g.value)
