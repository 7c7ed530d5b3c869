"""The port's examples (``deeplearning4j_tpu_torch/examples``) run, in
this process, with ``--device cpu`` and the settings and asserted lines
of the JAX package's ``tests/test_examples.py``. On a card,
``chip_smoke.py``'s ``surface_phase`` runs them with ``--device cuda``.
"""

import json
import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu_torch.examples import (elastic_transformer,
                                               lenet_mnist,
                                               streaming_generation,
                                               tpu_transformer_generate,
                                               word2vec_text)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(capsys, module, *args):
    module.main([*args, "--device", "cpu"])
    return capsys.readouterr().out


def test_lenet_mnist(capsys):
    out = _run(capsys, lenet_mnist, "--epochs", "2", "--batch", "128")
    assert "Accuracy" in out
    assert "checkpoint round trip OK" in out


def test_word2vec(capsys):
    out = _run(capsys, word2vec_text)
    assert "nearest(king):" in out
    assert "vectors written" in out


def test_elastic_transformer(capsys):
    out = _run(capsys, elastic_transformer, "--epochs", "4")
    assert "restart == uninterrupted: OK" in out
    assert "Accuracy after resume" in out


def test_streaming_generation(capsys):
    out = _run(capsys, streaming_generation, "--epochs", "1",
               "--gen-tokens", "8")
    assert "bounded session matches eager decode OK" in out
    assert "fused single-call generate matches stepped loop OK" in out


def test_tpu_transformer_generate_on_the_cpu(capsys, tmp_path):
    trace_path = str(tmp_path / "t.json")
    out = _run(capsys, tpu_transformer_generate, "--epochs", "1",
               "--gen-tokens", "8", "--trace", trace_path)
    assert "running on CPU (--device cpu was requested explicitly)" in out
    assert "generated:" in out
    assert "step profile:" in out
    assert "compile watch:" in out
    with open(trace_path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train", "generate", "train_step"} <= names


def test_tpu_transformer_generate_without_a_card_exits_nonzero(tmp_path):
    """No fallback: asked for the card (the default) where torch sees
    none, it exits non-zero naming the missing card."""
    r = subprocess.run(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.examples.tpu_transformer_generate",
         "--trace", str(tmp_path / "t.json")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "no NVIDIA card" in r.stderr
    assert "generated:" not in r.stdout
    assert not os.path.exists(tmp_path / "t.json")


@pytest.mark.slow
def test_keras_import_finetune():
    """keras builds the .h5 (in its own process: TensorFlow and the
    port's torch stay apart, as in tests/test_torch_keras.py)."""
    pytest.importorskip("keras")
    r = subprocess.run(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.examples.keras_import_finetune",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "max |keras - ours|" in r.stdout
    assert "fine-tuned accuracy" in r.stdout
