"""Global-batch statistics of the port's data-parallel step against the
JAX package's ``fit(mesh_spec="dp=2")``, on the CPU.

The JAX step is one GSPMD program over the global batch, so a masked
recurrent loss divides by the whole batch's present timesteps, batch
norm normalizes with the whole batch's statistics and a center-loss
head moves its centers toward the whole batch's class means. The port's
two gloo ranks (``tests/torch_dp_worker.py``) each hold half the batch:
the masked case gives the ranks DIFFERENT mask counts, which is what
separates the global denominator from a mean of the ranks' means. The
compressed reduce is the JAX wrapper's per-device ``shard_map`` step
(local statistics), held within a quantum of the int8 codec a step.
"""

import json

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (BatchNormalization,
                                               CenterLossOutputLayer,
                                               ConvolutionLayer, DenseLayer,
                                               OutputLayer, RnnOutputLayer,
                                               SimpleRnn)
from deeplearning4j_tpu.parallel.mesh import MeshSpec, build_mesh
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu.util.model_serializer import write_model

import torch_dp_worker as worker

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 2,
                                 reason="needs 2 virtual devices")]

RTOL, ATOL = 1e-5, 1e-6
WORLD = 2


def _builder(seed):
    return (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.sgd(0.1)).list())


def _rnn():
    conf = (_builder(1).layer(SimpleRnn(n_out=6, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.recurrent(4, 5)).build())
    return MultiLayerNetwork(conf).init()


def _bn():
    conf = (_builder(2)
            .layer(ConvolutionLayer(n_out=4, kernel=(3, 3),
                                    activation="tanh"))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional(6, 6, 2)).build())
    return MultiLayerNetwork(conf).init()


def _center():
    conf = (_builder(3).layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(CenterLossOutputLayer(n_out=3, alpha=0.5, lambda_=0.1))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _sgd():
    conf = (_builder(3).layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _inputs():
    rng = np.random.default_rng(11)

    def onehot(*shape):
        return np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape)]
    m = np.zeros((4, 5), np.float32)
    m[:2] = 1.0                    # rank 0: every step of both rows
    m[2, :2] = 1.0                 # rank 1: 2 + 1 present steps
    m[3, :1] = 1.0
    data = {
        "rnn": {"x": rng.normal(size=(4, 5, 4)).astype(np.float32),
                "y": onehot(4, 5), "m": m},
        "bn": {"x": rng.normal(size=(8, 6, 6, 2)).astype(np.float32),
               "y": onehot(8)},
        "center": {"x": rng.normal(size=(8, 4)).astype(np.float32),
                   "y": onehot(8)},
        "sgd": {f"{k}{i}": a for i in range(3) for k, a in
                (("x", rng.normal(size=(8, 4)).astype(np.float32)),
                 ("y", onehot(8)))},
    }
    return data


MAKERS = {"rnn": _rnn, "bn": _bn, "center": _center, "sgd": _sgd}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_layers")
    for name, arrays in _inputs().items():
        np.savez(d / f"{name}.npz", **arrays)
        write_model(MAKERS[name](), str(d / f"{name}.zip"))
    scenarios = ["rnn", "bn", "center", "compressed"]
    worker.launch(WORLD, d, scenarios)
    return {s: worker.load(d, s, WORLD) for s in scenarios}


def _state(net):
    leaves = jax.tree_util.tree_leaves(net.state)
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in leaves]) if leaves else np.zeros(0)


def _two_jax_steps(name):
    a = _inputs()[name]
    net = MAKERS[name]()
    ds = DataSet(a["x"], a["y"])
    net.fit(ds, mesh_spec=f"dp={WORLD}")
    net.fit(ds)
    return net


def test_masked_rnn_divides_by_the_global_mask_total(ranks):
    a = _inputs()["rnn"]
    ref = MAKERS["rnn"]()
    ds = DataSet(a["x"], a["y"], None, a["m"])
    ref.fit(ds, mesh_spec=f"dp={WORLD}")
    loss1 = float(ref.score_value)
    ref.fit(ds)
    for rank in ranks["rnn"]:
        np.testing.assert_allclose(rank["loss1"], loss1, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["p"], ref.params_flat(), rtol=RTOL,
                                   atol=ATOL)
    # the ranks' own means would weigh 10 present steps like 3
    per_rank_mean = MAKERS["rnn"]()
    per_rank_mean.fit(DataSet(a["x"][:2], a["y"][:2], None, a["m"][:2]))
    assert not np.allclose(per_rank_mean.params_flat(),
                           ranks["rnn"][0]["p"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["bn", "center"])
def test_batch_statistics_are_the_global_batch(ranks, name):
    ref = _two_jax_steps(name)
    for rank in ranks[name]:
        np.testing.assert_allclose(rank["p"], ref.params_flat(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(rank["state"], _state(ref), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(ranks[name][0]["p"], ranks[name][1]["p"])
    np.testing.assert_array_equal(ranks[name][0]["state"],
                                  ranks[name][1]["state"])
    assert str(ranks[name][0]["reduce"]) == "gloo: eager steps on the CPU"


def test_compressed_reduce_matches_the_jax_shard_map_step(ranks):
    """dp=2 with ``dcn_compression``: the parameters within a quantum
    of the codec a step (the int8 scale of the largest gradient times
    the learning rate, three steps), every rank's float32 residual
    against the JAX rank's within the same bound."""
    a = _inputs()["sgd"]
    net = MAKERS["sgd"]()
    pw = ParallelWrapper(net, build_mesh(MeshSpec(data=WORLD),
                                         jax.devices()[:WORLD]),
                         prefetch_buffer=0,
                         dcn_compression={"threshold": 0.0})
    pw.fit(ListDataSetIterator([DataSet(a[f"x{i}"], a[f"y{i}"])
                                for i in range(3)]), epochs=1)
    res = [np.concatenate([np.asarray(r[i], np.float32).reshape(-1)
                           for r in jax.tree_util.tree_leaves(pw._residual)])
           for i in range(WORLD)]
    scale = np.abs(np.concatenate(res)).max() * 2
    for r, rank in enumerate(ranks["compressed"]):
        np.testing.assert_allclose(rank["p"], net.params_flat(), rtol=0,
                                   atol=3 * 0.1 * scale + ATOL)
        np.testing.assert_allclose(rank["residual"], res[r], rtol=0,
                                   atol=scale + ATOL)
        np.testing.assert_allclose(rank["loss"], float(net.score_value),
                                   rtol=1e-4)
        desc = json.loads(str(rank["describe"]))
        assert "int8" in desc["reduce"] and desc["active"]
    np.testing.assert_array_equal(ranks["compressed"][0]["p"],
                                  ranks["compressed"][1]["p"])
