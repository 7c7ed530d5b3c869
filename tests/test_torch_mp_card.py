"""Tensor and sequence parallelism on the card.

Two gloo ranks share card 0 (``tests/torch_mp_worker.py``'s ``card``
scenario): the ring's kernel path (every chunk through the flash
forward and the dq / dk-dv kernels) against the flash attention's
plain versions over the whole sequence on the same CUDA inputs,
forward and gradients, causal and not, with a key mask (tolerance
2e-5, the kernels' f32 tolerance in ``tests/test_torch_attention.py``);
the ring's plain chunks refused on the card; and the tp=2 eager step
of a small LM (3 SGD steps) against the one-rank step on the same card
(2e-5 of the parameters' largest entry). Needs a card: skipped without
one.
"""

import sys

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
import torch_mp_worker as mp

pytestmark = [pytest.mark.mesh, pytest.mark.cuda]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_lm(path):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    layer = {"@type": "TransformerEncoderLayer", "n_heads": 4,
             "causal": True}
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": 3, "updater": updaters.sgd(0.1)},
           "input_type": {"kind": "rnn", "size": 64, "timesteps": 128},
           "layers": [{"@type": "EmbeddingSequenceLayer", "n_in": 64,
                       "n_out": 128}, layer, layer,
                      {"@type": "RnnOutputLayer", "n_out": 64,
                       "loss": "mcxent"}],
           "preprocessors": {}}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                            device="cpu").init()
    write_model(net, path)


def test_ring_kernels_and_tp_step_on_the_card(tmp_path, cuda_device):
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.normal(size=(2, 256, 4, 64)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((2, 256), np.float32)
    mask[0, 200:] = 0.0
    mask[1, :100] = 0.0
    ids = rng.integers(0, 64, (4, 128)).astype(np.float32)
    y = np.eye(64, dtype=np.float32)[rng.integers(0, 64, (4, 128))]
    np.savez(tmp_path / "card.npz", q=q, k=k, v=v, do=do, mask=mask,
             ids=ids, y=y)
    _card_lm(str(tmp_path / "card.zip"))
    worker.launch(2, tmp_path, ["card"], timeout=240,
                  argv=[sys.executable, mp.__file__, str(tmp_path), "card"])
    for r in worker.load(tmp_path, "card", 2):
        for causal in (0, 1):
            errs = r[f"ring_c{causal}"]
            assert (errs <= 2e-5).all(), (causal, errs)
        assert "CPU tensors only" in str(r["refused"])
        assert int(r["fwd_launches"]) > 0
        assert float(r["tp_vs_one"]) <= 2e-5 * float(r["scale"]), \
            (float(r["tp_vs_one"]), float(r["scale"]))
