"""The port's two rank examples (``deeplearning4j_tpu_torch/examples/
data_parallel_resnet.py`` and ``long_context_lm.py``) on the CPU.

Each runs as the command a user types (``main``), which starts its own
gloo ranks (4, and data=2 x seq=2), at the JAX package's
``tests/test_examples.py`` settings and with the lines it asserts; the
rendezvous port comes from ``torch_dp_worker.free_port``. The
long-context training is also held against the JAX package: from the
JAX example's ``make_net(seed=3)`` parameters, carried across, data=2 x
seq=2 over 4 gloo ranks (``torch_dp_worker.py``'s ``long_context``
scenario) against the JAX package's single-device ``fit`` for the same
epochs, at the example's own tolerance (rtol 2e-4, atol 2e-5). On a
card, ``chip_smoke.py`` runs both examples with ``--device cuda``.
"""

import importlib.util
import os

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu_torch.examples import (data_parallel_resnet,
                                               long_context_lm)

import torch_dp_worker as worker

pytestmark = pytest.mark.mesh

EPOCHS = 8         # tests/test_examples.py's --epochs


def _run(capsys, monkeypatch, module, *args):
    monkeypatch.setenv("DL4J_TPU_COORDINATOR",
                       f"127.0.0.1:{worker.free_port()}")
    for name in ("DL4J_TPU_PROCESS_ID", "RANK"):
        monkeypatch.delenv(name, raising=False)
    rc = module.main([*args, "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-4000:]
    return out.out


def test_data_parallel_resnet(capsys, monkeypatch):
    out = _run(capsys, monkeypatch, data_parallel_resnet, "--img", "32",
               "--steps", "3")
    assert "4 devices" in out
    assert "final loss" in out


def test_long_context_lm(capsys, monkeypatch):
    out = _run(capsys, monkeypatch, long_context_lm, "--epochs",
               str(EPOCHS))
    assert "data=2 x seq=2" in out
    assert "matches single-device params: True" in out


def _jax_example():
    path = os.path.join(worker.REPO, "examples", "long_context_lm.py")
    spec = importlib.util.spec_from_file_location("jax_long_context_lm",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_long_context_matches_jax_single_device(tmp_path):
    jex = _jax_example()
    for got, want in zip(long_context_lm.make_data(), jex.make_data()):
        np.testing.assert_array_equal(got, want)
    write_model(jex.make_net(seed=3), str(tmp_path / "long_context.zip"))
    np.savez(tmp_path / "long_context.npz", epochs=EPOCHS)
    worker.launch(4, tmp_path, ["long_context"], timeout=240)
    single = jex.make_net(seed=3)
    x, y, mask = jex.make_data()
    for _ in range(EPOCHS):
        single.fit(JaxDataSet(x, y, mask, mask))
    want = np.asarray(single.params_flat())
    ranks = worker.load(tmp_path, "long_context", 4)
    for r in ranks:
        np.testing.assert_allclose(r["flat"], want, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["loss"], float(single.score_value),
                                   rtol=2e-4, atol=2e-5)
    assert len({r["flat"].tobytes() for r in ranks}) == 1
