"""The data-parallel step's routes on the card, against the eager step.

Under ``nccl`` (one rank a card) the all-reduce is captured in the
window's CUDA graph; under ``gloo`` (ranks sharing one card) every step
runs eagerly, its bucket all-reduced through the host. Each is held bit
for bit, under cuBLAS's and cuDNN's deterministic algorithms, to the
eager data-parallel step (``_train_step`` in the step's scope) on the
same shards: 16 steps through ``fit`` at k=1 and in windows of k=8.
The ranks are subprocesses (``tests/torch_dp_worker.py``'s ``card``
scenario). Needs a card: skipped without one.
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as worker

pytestmark = [pytest.mark.mesh, pytest.mark.cuda]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _ranks(tmp_path, world):
    worker.launch(world, tmp_path, ["card"], timeout=90)
    return worker.load(tmp_path, "card", world)


def test_nccl_captured_windows_equal_the_eager_step(tmp_path, cuda_device):
    (r,) = _ranks(tmp_path, 1)
    assert str(r["backend"]) == "nccl"
    assert "captured in the window's CUDA graph" in str(r["route"])
    # k=1: the first step eager + its capture, 15 replays; k=8: the
    # first window eager + its capture, 1 replay
    assert (int(r["captures_k1"]), int(r["replays_k1"])) == (1, 15)
    assert (int(r["captures_k8"]), int(r["replays_k8"])) == (1, 1)
    for k in (1, 8):
        assert int(r[f"it_k{k}"]) == 16
        np.testing.assert_array_equal(r[f"fit_k{k}"], r["eager"],
                                      err_msg=f"k={k}")


def test_gloo_ranks_sharing_a_card_step_eagerly(tmp_path, cuda_device):
    ranks = _ranks(tmp_path, 2)
    for r in ranks:
        assert str(r["backend"]) == "gloo"
        assert "gloo: eager steps" in str(r["route"])
        for k in (1, 8):
            assert int(r[f"captures_k{k}"]) == 0
            assert int(r[f"replays_k{k}"]) == 0
            assert int(r[f"it_k{k}"]) == 16
            np.testing.assert_array_equal(r[f"fit_k{k}"], r["eager"],
                                          err_msg=f"k={k}")
    np.testing.assert_array_equal(ranks[1]["fit_k8"], ranks[0]["fit_k8"])
