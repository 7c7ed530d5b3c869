"""The port's pipelines against the JAX package's, on the CPU.

``NetworkSpmdPipeline`` runs one gloo rank a stage
(``tests/torch_mp_worker.py``): the config transformer at pp=2 and
pp=4 (4 microbatches) against the JAX package's single-device steps
(``__graft_entry__.py`` regime 9; tolerance its ``PP_SINGLE_DEVICE_TOL``
on a jax with ``lax.pcast``, rtol 2e-4, atol 2e-5), and a batch-norm +
dropout conv net at pp=4 against pp=1 in the port (regime 10: the same
microbatch schedule, dropout on). ``PipelineParallel`` (stages on the
devices of one process) against ``tests/test_parallel.py``'s pipeline
cases: rtol 1e-5, atol 1e-6 for one step.
"""

import json
import sys

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (BatchNormalization,
                                               ConvolutionLayer, DenseLayer,
                                               EmbeddingSequenceLayer,
                                               OutputLayer, RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

import torch_dp_worker as worker
import torch_mp_worker as mp

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 8,
                                 reason="needs 8 virtual devices")]

V, T, C = 11, 8, 16


def lm(seed=5):
    b = (NeuralNetConfiguration.builder().set_seed(seed)
         .updater(updaters.adam(1e-2)).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=C)))
    for _ in range(8):
        b = b.layer(TransformerEncoderLayer(n_heads=4, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return MultiLayerNetwork(conf).init()


def cnn(seed=7):
    b = (NeuralNetConfiguration.builder().set_seed(seed)
         .updater(updaters.adam(1e-2)).list()
         .layer(ConvolutionLayer(n_out=8, kernel=(3, 3),
                                 convolution_mode="same",
                                 activation="relu")))
    for _ in range(4):
        b = b.layer(ConvolutionLayer(n_out=8, kernel=(3, 3),
                                     convolution_mode="same",
                                     activation="relu", dropout=0.2))
    conf = (b.layer(BatchNormalization())
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    return MultiLayerNetwork(conf).init()


def _data():
    rng = np.random.default_rng(31)
    x = rng.integers(0, V, (8, T)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (8, T))]
    rng_c = np.random.default_rng(33)
    xc = rng_c.normal(0, 1, (8, 8, 8, 1)).astype(np.float32)
    yc = np.eye(3, dtype=np.float32)[rng_c.integers(0, 3, 8)]
    return {"lm": (x, y), "cnn": (xc, yc)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _data()
    out = {}
    for world, names in ((2, ["lm"]), (4, ["lm", "cnn"])):
        d = tmp_path_factory.mktemp(f"pp{world}")
        for name in names:
            np.savez(d / f"{name}.npz", x=data[name][0], y=data[name][1])
        write_model(lm(), str(d / "lm.zip"))
        write_model(cnn(), str(d / "cnn.zip"))
        with open(d / "pp.json", "w") as f:
            json.dump([[n, 2] for n in names], f)
        worker.launch(world, d, ["pp"], timeout=150,
                      argv=[sys.executable, mp.__file__, str(d), "pp"])
        out[world] = worker.load(d, "pp", world)
        out[world + 100] = d
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_transformer_pipeline_matches_jax_single_device(runs, world):
    x, y = _data()["lm"]
    ref = lm()
    ref.fit(DataSet(x, y))
    ref.fit(DataSet(x, y))
    for r in runs[world]:
        np.testing.assert_allclose(r["lm"], ref.params_flat(), rtol=2e-4,
                                   atol=2e-5)
    descs = [json.loads(str(r["lm_describe"])) for r in runs[world]]
    # the embedding on the first stage, the head on the last, the eight
    # blocks split evenly
    assert descs[0]["layers"][0] == 0
    assert descs[-1]["layers"][1] == 10
    assert [d["stage"] for d in descs] == list(range(world))
    assert all(d["folded_run"] == [1, 9] for d in descs)
    losses = [r["lm_losses"] for r in runs[world]]
    assert all(np.array_equal(losses[0], l) for l in losses)


def test_bn_dropout_cnn_pp4_equals_pp1(runs):
    """Batch-norm state threaded through the microbatches and dropout
    seeded by (step, layer, microbatch): pp=4 equals pp=1 in the port."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_spmd import (
        NetworkSpmdPipeline)
    from deeplearning4j_tpu_torch.util.tree import tree_flat_vector
    x, y = _data()["cnn"]
    net = restore_model(str(runs[104] / "cnn.zip"), device="cpu")
    bridge = NetworkSpmdPipeline(
        net, build_mesh(MeshSpec(data=1, pipe=1), [0]), n_microbatches=4)
    losses = [bridge.train_batch(x, y) for _ in range(2)]
    bridge.collect_params()
    for r in runs[4]:
        np.testing.assert_allclose(r["cnn_losses"], losses, rtol=2e-5)
        np.testing.assert_allclose(r["cnn"], net.params_flat(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(
            r["cnn_state"], np.asarray(tree_flat_vector(net.state)),
            rtol=2e-4, atol=2e-5)
    assert np.abs(runs[4][0]["cnn_state"]).sum() > 0


def test_pipeline_refuses_what_jax_refuses(runs):
    """No run long enough for the stages, and l2, refuse as in JAX."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.pipeline_spmd import (
        NetworkSpmdPipeline)
    net = restore_model(str(runs[104] / "cnn.zip"), device="cpu")
    mesh = build_mesh(MeshSpec(data=1, pipe=1), [0])
    bridge = NetworkSpmdPipeline(net, mesh, n_microbatches=2)
    assert bridge.describe()["folded_run"] == [1, 5]
    conf = (NeuralNetConfiguration.builder().set_seed(1).l2(1e-2).list()
            .layer(DenseLayer(n_out=4)).layer(DenseLayer(n_out=4))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    path = str(runs[104] / "l2.zip")
    write_model(MultiLayerNetwork(conf).init(), path)
    with pytest.raises(ValueError, match="l1/l2"):
        NetworkSpmdPipeline(restore_model(path, device="cpu"), mesh)


# ---- PipelineParallel: stages on the devices of one process

def _net(seed=0, lr=0.1):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.sgd(lr)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _port(jn, tmp_path, name):
    path = str(tmp_path / f"{name}.zip")
    write_model(jn, path)
    return restore_model(path, device="cpu")


def test_pipeline_parallel_trains(tmp_path):
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel
    xs, ys = iris_data()
    conf = (NeuralNetConfiguration.builder().set_seed(5)
            .updater(updaters.adam(0.05)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    net = _port(MultiLayerNetwork(conf).init(), tmp_path, "p")
    pp = PipelineParallel(net, devices=["cpu"] * 4, n_microbatches=4)
    assert pp.boundaries == [0, 1, 2, 3]
    losses = [pp.train_batch(xs[:64], ys[:64]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    pp.collect_params()
    assert net.evaluate(xs[120:], ys[120:]).accuracy() > 0.6


@pytest.mark.parametrize("l2", [False, True])
def test_pipeline_parallel_matches_jax_single_step(tmp_path, l2):
    """One microbatch, two stages: one step equals JAX's ``fit`` (with
    l2 and a max-norm constraint too)."""
    from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallel
    if l2:
        def make():
            conf = (NeuralNetConfiguration.builder().set_seed(13)
                    .updater(updaters.sgd(0.1)).l2(1e-2).list()
                    .layer(DenseLayer(
                        n_out=16, activation="tanh",
                        constraints=({"type": "max_norm",
                                      "max_norm": 0.8},)))
                    .layer(OutputLayer(n_out=3))
                    .set_input_type(InputType.feed_forward(4)).build())
            return MultiLayerNetwork(conf).init()
    else:
        def make():
            return _net(seed=11)
    xs, ys = iris_data()
    single = make()
    single.fit(DataSet(xs[:32], ys[:32]))
    net = _port(make(), tmp_path, "s")
    pp = PipelineParallel(net, devices=["cpu", "cpu"], n_microbatches=1)
    pp.train_batch(xs[:32], ys[:32])
    pp.collect_params()
    np.testing.assert_allclose(net.params_flat(), single.params_flat(),
                               rtol=1e-5, atol=1e-6)
