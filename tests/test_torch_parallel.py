"""The port's data-parallel training against the JAX package's, on the
CPU.

The port's ranks are gloo subprocesses (``tests/torch_dp_worker.py``),
each on its own slice of the global batch; the JAX package runs
``fit(mesh_spec="dp=N")`` in this process over the 8 virtual CPU
devices ``tests/conftest.py`` forces. Initial weights cross by a zip the
JAX package writes. Tolerances are ``tests/test_multihost.py``'s (rtol
1e-5, atol 1e-6): the port sums the ranks' mean gradients, GSPMD takes
the mean over the global batch.
"""

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.fetchers import iris_data
from deeplearning4j_tpu.data.iterators import ListDataSetIterator
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.util.model_serializer import write_model

import torch_dp_worker as worker

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 8,
                                 reason="needs 8 virtual devices")]

RTOL, ATOL = 1e-5, 1e-6
N_BATCHES = 11


def _net(seed=0, lr=0.1):
    """``tests/test_parallel.py``'s net: 4 -> 16 tanh -> 3, SGD."""
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.sgd(lr)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _graph(seed=2):
    from test_kstep import tiny_graph
    return tiny_graph(seed=seed)


def _data():
    xs, ys = iris_data()
    x, y = xs[:64].astype(np.float32), ys[:64].astype(np.float32)
    rng = np.random.default_rng(5)
    batches = {}
    for i in range(N_BATCHES):
        idx = rng.permutation(64)[:8]
        batches[f"x{i}"], batches[f"y{i}"] = x[idx], y[idx]
    return x, y, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, by world size: dp=2 runs every scenario of
    this file, dp=4 the parity, the shrink drill and a spec given again,
    dp=8 the parity."""
    x, y, batches = _data()
    out = {}
    for world, scenarios in ((2, ["sgd", "graph", "kstep", "uneven"]),
                             (4, ["sgd", "respec", "shrink"]),
                             (8, ["sgd"])):
        d = tmp_path_factory.mktemp(f"dp{world}")
        np.savez(d / "sgd.npz", x=x, y=y, **batches)
        np.savez(d / "graph.npz", **batches)
        write_model(_net(seed=3), str(d / "sgd.zip"))
        write_model(_graph(), str(d / "graph.zip"))
        worker.launch(world, d, scenarios)
        out[world] = {s: worker.load(d, s, world) for s in scenarios}
    return out


def _jax_batches(n):
    _, _, b = _data()
    return [DataSet(b[f"x{i}"], b[f"y{i}"]) for i in range(n)]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_dp_matches_jax_after_1_and_3_steps(runs, world):
    x, y, _ = _data()
    ref = _net(seed=3)
    ref.fit(DataSet(x, y), mesh_spec=f"dp={world}")
    p1 = ref.params_flat()
    ref.fit(DataSet(x, y))
    ref.fit(DataSet(x, y))
    for rank in runs[world]["sgd"]:
        np.testing.assert_allclose(rank["p1"], p1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank["p3"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank["loss"], float(ref.score_value),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_replicas_are_bit_equal(runs, world):
    first = runs[world]["sgd"][0]
    for rank in runs[world]["sgd"][1:]:
        np.testing.assert_array_equal(rank["p1"], first["p1"])
        np.testing.assert_array_equal(rank["p3"], first["p3"])


def test_backend_and_route_are_stated(runs):
    import json
    desc = json.loads(str(runs[2]["sgd"][0]["describe"]))
    assert desc["backend"] == "gloo" and desc["ranks"] == [0, 1]
    assert desc["spec"] == "dp=2" and "eager steps on the CPU" in \
        desc["reduce"]


def test_graph_executor_dp2_matches_jax(runs):
    ref = _graph()
    ref.fit(_jax_batches(6), epochs=1, mesh_spec="dp=2",
            steps_per_device_call=3)
    for rank in runs[2]["graph"]:
        np.testing.assert_allclose(rank["p"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)
        assert int(rank["it"]) == 6


def test_k8_window_bit_identical_to_k1(runs):
    ref = _net(seed=3)
    ref.fit(ListDataSetIterator(_jax_batches(N_BATCHES)), epochs=2,
            mesh_spec="dp=2", steps_per_device_call=8)
    for rank in runs[2]["kstep"]:
        np.testing.assert_array_equal(rank["k8"], rank["k1"])
        assert int(rank["it1"]) == int(rank["it8"]) == 2 * N_BATCHES
        np.testing.assert_allclose(rank["k8"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)


def test_uneven_shards_trim_to_the_shortest_and_drop_empty_steps(runs):
    """Rank r holds 8 - r rows: every rank trains on its first
    8 - (N-1) rows; the second step (the last rank's shard empty) is
    dropped everywhere. Equal to JAX on the trimmed shards, concatenated
    in rank order."""
    x, y, _ = _data()
    world = 2
    n = 8 - (world - 1)
    idx = np.concatenate([np.arange(r * 8, r * 8 + n) for r in range(world)])
    ref = _net(seed=3)
    ref.fit(DataSet(x[idx], y[idx]), mesh_spec="dp=1")
    for rank in runs[world]["uneven"]:
        assert int(rank["it"]) == 1
        np.testing.assert_allclose(rank["p"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)


def test_device_loss_shrinks_to_dp2_and_regrow_restores_dp4(runs):
    """dp=4, a ``parallel.device`` loss at the second batch: ranks 0 and
    1 train batches 2 and 3 on their own shards, ranks 2 and 3 leave the
    loop; the regrow broadcasts rank 0's replica and all four train
    batch 4. Held against JAX on the same rows: batch 1 at dp=4, the
    survivors' half of batches 2 and 3 at dp=2, batch 4 at dp=4."""
    b = _jax_batches(4)
    ref = _net(seed=3)
    ref.fit(b[0], mesh_spec="dp=4")
    for ds in b[1:3]:
        ref.fit(DataSet(ds.features[:4], ds.labels[:4]), mesh_spec="dp=2")
    shrunk = ref.params_flat()
    ref.fit(b[3], mesh_spec="dp=4")
    res = runs[4]["shrink"]
    for r, rank in enumerate(res):
        assert int(rank["dp_shrunk"]) == 2 and int(rank["dp_final"]) == 4
        assert float(rank["shrinks"]) == 1.0
        assert float(rank["regrows"]) == 1.0
        want = [True, True, True, True] if r < 2 else [True, False, False,
                                                        True]
        assert rank["trained"].tolist() == want
        np.testing.assert_allclose(rank["p"], ref.params_flat(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(rank["p"], res[0]["p"])
    for rank in res[:2]:
        np.testing.assert_allclose(rank["after_shrink"], shrunk, rtol=RTOL,
                                   atol=ATOL)
    assert int(res[0]["it"]) == 4


def test_same_spec_again_makes_no_new_group(runs):
    """dp=2 over 4 ranks: the first build makes the subset's group (one
    ``dist.new_group`` on every rank, gloo reducing and staging on the
    one group); a second build and every ``fit(mesh_spec="dp=2")`` after
    the first reuse it, and a member keeps its installed context."""
    for rank, r in enumerate(runs[4]["respec"]):
        assert int(r["after_first"]) == 1 and int(r["total"]) == 1, rank
        assert bool(r["same_groups"]) and bool(r["kept"]), rank
