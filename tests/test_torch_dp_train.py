"""The port's data-parallel trainer and ``train`` verb across gloo ranks
against the JAX package's, on the CPU.

``ElasticTrainer(mesh_spec="dp=2")`` interrupted by a ``train.step``
crash and resumed from the coordinator's checkpoint must equal the
uninterrupted run bit for bit, and both the JAX trainer's run within
``tests/test_multihost.py``'s tolerances. ``python -m
deeplearning4j_tpu_torch train --mesh dp=2`` runs as two processes with
the multihost variables; its model (written by the coordinator alone)
is held against the JAX ``train --mesh dp=2`` on the same zip and CSV.
"""

import os
import sys
import time

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu.data.dataset import DataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator
from deeplearning4j_tpu.nn.conf import updaters
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.train.fault_tolerance import ElasticTrainer
from deeplearning4j_tpu.util.model_serializer import (restore_model,
                                                      write_model)

import torch_dp_worker as worker

pytestmark = [pytest.mark.mesh,
              pytest.mark.skipif(jax.device_count() < 2,
                                 reason="needs 2 virtual devices")]

RTOL, ATOL = 1e-5, 1e-6


def _net(seed=3):
    conf = (NeuralNetConfiguration.builder().set_seed(seed)
            .updater(updaters.sgd(0.1)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init()


def _batches():
    rng = np.random.default_rng(23)
    out = {}
    for i in range(8):
        out[f"x{i}"] = rng.normal(size=(8, 4)).astype(np.float32)
        out[f"y{i}"] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    return out


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    np.savez(d / "sgd.npz", **_batches())
    write_model(_net(), str(d / "sgd.zip"))
    worker.launch(2, d, ["elastic", "elastic_wrapper"])
    return {s: worker.load(d, s, 2) for s in ("elastic", "elastic_wrapper")}


def _jax_batches():
    b = _batches()
    return [DataSet(b[f"x{i}"], b[f"y{i}"]) for i in range(8)]


def test_elastic_trainer_dp2_resume_equals_uninterrupted(elastic, tmp_path):
    ref = _net()
    ElasticTrainer(ref, str(tmp_path / "jax"), save_every=2,
                   handle_sigterm=False, mesh_spec="dp=2").fit(
        ListDataSetIterator(_jax_batches()), epochs=1)
    ranks = elastic["elastic"]
    for rank in ranks:
        np.testing.assert_array_equal(rank["resumed"], rank["free"])
        np.testing.assert_allclose(rank["free"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)
        assert int(rank["it"]) == 8
        assert int(rank["zips"]) > 0
    np.testing.assert_array_equal(ranks[0]["free"], ranks[1]["free"])


def test_elastic_trainer_wrapper_windows_equal_batches(elastic, tmp_path):
    """``wrapper=``: k=4 windows bit-identical to k=1 batches, both the
    JAX trainer's wrapper run within tolerance."""
    from deeplearning4j_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper
    ref = _net()
    pw = ParallelWrapper(ref, build_mesh(MeshSpec(data=2),
                                         jax.devices()[:2]),
                         prefetch_buffer=0)
    ElasticTrainer(ref, str(tmp_path / "jax"), save_every=4,
                   handle_sigterm=False, wrapper=pw,
                   steps_per_device_call=4).fit(
        ListDataSetIterator(_jax_batches()), epochs=1)
    for rank in elastic["elastic_wrapper"]:
        np.testing.assert_array_equal(rank["k4"], rank["k1"])
        assert int(rank["it1"]) == int(rank["it4"]) == 8
        np.testing.assert_allclose(rank["k4"], ref.params_flat(),
                                   rtol=RTOL, atol=ATOL)


def _csv(path, n=48):
    rng = np.random.default_rng(17)
    with open(path, "w") as f:
        for _ in range(n):
            feats = rng.normal(size=4)
            f.write(",".join(f"{v:.5f}" for v in feats)
                    + f",{rng.integers(0, 3)}\n")


def test_cli_train_mesh_dp2_matches_jax(tmp_path, capsys):
    from deeplearning4j_tpu.cli import main as jax_main
    mpath = str(tmp_path / "m.zip")
    write_model(_net(seed=15), mpath)
    data = str(tmp_path / "d.csv")
    _csv(data)
    args = ["train", "--model", mpath, "--data", data, "--label-index",
            "4", "--classes", "3", "--batch-size", "8", "--epochs", "2",
            "--mesh", "dp=2", "--k-step", "2", "--aot-warmup"]
    # the ranks' own budget: two CLI processes import torch, warm the
    # k-step programs up and train 12 steps; ~9 s alone and under 24 s
    # beside the port's other test files on six loaded workers, with
    # room for the whole suite's heavier mix
    logs = worker.launch(2, tmp_path, [], timeout=180, argv=[
        sys.executable, "-m", "deeplearning4j_tpu_torch"] + args + [
        "--output", str(tmp_path / "port.zip"), "--device", "cpu"])
    assert "mesh: dp=2 over 2 device(s); backend gloo" in logs[0]
    assert "saved to" in logs[0] and "the coordinator saves" in logs[1]
    jax_main(args + ["--output", str(tmp_path / "jax.zip")])
    assert "mesh: dp=2" in capsys.readouterr().out
    port = restore_model(str(tmp_path / "port.zip"))
    want = restore_model(str(tmp_path / "jax.zip"))
    assert port.iteration_count == want.iteration_count == 12
    np.testing.assert_allclose(port.params_flat(), want.params_flat(),
                               rtol=RTOL, atol=ATOL)
    assert os.listdir(tmp_path).count("port.zip") == 1


def test_free_ports_come_from_this_workers_block(monkeypatch):
    """Ports for the ranks' rendezvous come from below the kernel's
    ephemeral range, a block a pytest-xdist worker, and are never handed
    out twice in a row."""
    for name, idx in (("gw0", 0), ("gw5", 5), ("master", 0)):
        monkeypatch.setenv("PYTEST_XDIST_WORKER", name)
        base = worker._PORT_BASE + idx * worker._PORT_BLOCK
        ports = [worker.free_port() for _ in range(5)]
        assert len(set(ports)) == 5
        assert all(base <= p < base + worker._PORT_BLOCK for p in ports)


def test_two_processes_of_one_worker_name_start_apart():
    """Two runs on one machine name their workers alike and so share
    blocks: two processes of the same worker name, started one after
    the other, are not handed the same first port."""
    import subprocess
    env = dict(os.environ, PYTEST_XDIST_WORKER="gw3",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    code = "import torch_dp_worker as w; print(w.free_port())"
    port0, port1 = (int(subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True, timeout=60).stdout) for _ in range(2))
    base = worker._PORT_BASE + 3 * worker._PORT_BLOCK
    assert all(base <= p < base + worker._PORT_BLOCK
               for p in (port0, port1))
    assert port0 != port1


def test_launch_stops_the_ranks_when_one_fails(tmp_path):
    """Rank 1 exits at once; rank 0, which would wait for it, is
    stopped, and the failure carries both ranks' logs."""
    argv = [sys.executable, "-c",
            "import os, sys, time\n"
            "if os.environ['DL4J_TPU_PROCESS_ID'] == '1':\n"
            "    print('rank 1 gives up'); sys.exit(3)\n"
            "time.sleep(120)\n"]
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as failed:
        worker.launch(2, tmp_path, [], timeout=120, argv=argv)
    assert time.monotonic() - t0 < 60
    msg = str(failed.value)
    assert "--- rank 0 (exit -9)" in msg
    assert "--- rank 1 (exit 3):\nrank 1 gives up" in msg
