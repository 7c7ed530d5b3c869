"""The port's AOT warmup (``serving/warmup.py``, ``ModelServer.warmup``,
``serve --aot-warmup``) and its steady-state capture accounting
(``observability/compile_watch.py``) against the JAX package's, on the
CPU.

One small causal transformer LM (V=64, D=32, L=2, H=4, capacity 64,
page_size 8) is built and saved by the JAX package and restored by the
port. Both servers warm it and report the same buckets, generate flag
and skips; a burst after warmup gives the same greedy ids. On the CPU no
CUDA graph is captured: the capture itself, and a burst inside
``zero_compile_scope`` after it, run on the card (``chip_smoke.py``
``warmup_phase``; ``tests/test_torch_generate.py``'s card tests).
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.observability import compile_watch
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, D, H, CAP, PS = 64, 32, 4, 64, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _zip(tmp_path_factory, input_size):
    """A JAX LM whose InputType is ``recurrent(input_size, CAP)``, saved;
    (jax net, zip path)."""
    b = (NeuralNetConfiguration.builder().set_seed(0).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(2):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(input_size, CAP)).build())
    jnet = JaxNet(conf).init()
    path = str(tmp_path_factory.mktemp("warm") / "lm.zip")
    jser.write_model(jnet, path)
    return jnet, path


@pytest.fixture(scope="module")
def lm_ids(tmp_path_factory):
    """One id a timestep: the predict buckets are the shapes /v1/predict
    takes, and warmup runs them."""
    return _zip(tmp_path_factory, 1)


@pytest.fixture(scope="module")
def lm_vocab(tmp_path_factory):
    """InputType.recurrent(V, CAP): the per-item shape warmup derives is
    not one an id-input model takes, so both packages skip predict."""
    return _zip(tmp_path_factory, V)


def _servers(jnet, path):
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register("lm", jnet)
    treg.register("lm", restore_model(path, device="cpu"))
    kw = dict(slots=2, capacity=CAP, page_size=PS, max_batch_size=8)
    return JaxServer(jreg, **kw), ModelServer(treg, **kw)


def _warm_both(jnet, path):
    js, ts = _servers(jnet, path)
    return js, ts, js.warmup()["lm"], ts.warmup()["lm"]


def test_warmup_report_equals_jax(lm_ids):
    js, ts, jr, tr = _warm_both(*lm_ids)
    try:
        assert set(tr) == set(jr)
        assert tr["predict_buckets"] == jr["predict_buckets"] == \
            [1, 2, 4, 8]
        assert tr["generate"] is jr["generate"] is True
        assert tr["skipped"] == jr["skipped"] == []
        assert tr["version"] == jr["version"] == 1
    finally:
        js.stop(drain=False)
        ts.stop(drain=False)


def test_warmup_skips_the_same_as_jax(lm_vocab):
    """Where the derived shape does not fit the model, both packages
    record one predict skip (the error text is each package's own) and
    still warm generate."""
    js, ts, jr, tr = _warm_both(*lm_vocab)
    try:
        assert set(tr) == set(jr)
        assert tr["predict_buckets"] == jr["predict_buckets"] == []
        assert tr["generate"] is jr["generate"] is True
        assert [s.split(":")[0] for s in tr["skipped"]] == \
            [s.split(":")[0] for s in jr["skipped"]] == ["predict"]
    finally:
        js.stop(drain=False)
        ts.stop(drain=False)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_burst_after_warmup_equals_jax(lm_ids):
    """Four concurrent greedy requests after warmup: the port's ids equal
    the JAX server's."""
    js, ts, _, _ = _warm_both(*lm_ids)
    rng = np.random.default_rng(7)
    bodies = [{"model": "lm", "prompt": rng.integers(1, V, n).tolist(),
               "n_tokens": 6} for n in (5, 11, 3, 17)]
    try:
        out = {}
        for name, server in (("jax", js), ("port", ts)):
            server.start()
            replies = [None] * len(bodies)

            def client(i, port=server.port, replies=replies):
                replies[i] = _post(port, bodies[i])["ids"]

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(bodies))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert not any(th.is_alive() for th in threads)
            out[name] = replies
        assert out["port"] == out["jax"]
        assert all(len(ids) == 6 for ids in out["port"])
    finally:
        js.stop(drain=False)
        ts.stop(drain=False)


def test_zero_compile_scope_raises_on_a_capture_and_passes_on_none():
    stats = compile_watch.GlobalCompileStats(registry=MetricsRegistry())
    assert stats.cache_hit is None              # nothing ran yet
    with stats.zero_compile_scope("replays only"):
        stats.on_replay()
        stats.on_replay()
    assert stats.summary()["graph_replays"] == 2
    assert stats.cache_hit is True
    with pytest.raises(compile_watch.SteadyStateCompileError) as ei:
        with stats.zero_compile_scope("a burst"):
            stats.on_capture(0.25)
            stats.on_replay()
    assert ei.value.stats["graph_captures"] == 1
    assert ei.value.stats["capture_secs"] == 0.25
    assert ei.value.stats["cache_hit"] is False
    assert "a burst" in str(ei.value)


def test_global_watch_counts_only_once_installed():
    """``record_capture`` / ``record_replay`` (what the paged session
    calls) count into the process-wide stats and its registry counters
    once ``install_global_watch`` ran, idempotently."""
    reg = MetricsRegistry()
    saved = compile_watch._GLOBAL_STATS
    compile_watch._GLOBAL_STATS = None
    try:
        compile_watch.record_capture(1.0)       # not installed: dropped
        stats = compile_watch.install_global_watch(registry=reg)
        assert compile_watch.install_global_watch() is stats
        mark = stats.mark()
        compile_watch.record_capture(0.5)
        compile_watch.record_replay()
        assert stats.summary(mark) == {"graph_captures": 1,
                                       "capture_secs": 0.5,
                                       "graph_replays": 1,
                                       "cache_hit": False}
        assert reg.get("cuda_graph_captures_total").value == 1
        assert reg.get("cuda_graph_replays_total").value == 1
    finally:
        compile_watch._GLOBAL_STATS = saved


def test_cpu_generate_warmup_captures_nothing(lm_ids):
    """On the CPU the step runs its eager body: warmup's generate and a
    burst after it record no capture and no replay."""
    jnet, path = lm_ids
    reg = MetricsRegistry()
    saved = compile_watch._GLOBAL_STATS
    compile_watch._GLOBAL_STATS = None
    treg = ModelRegistry()
    treg.register("lm", restore_model(path, device="cpu"))
    server = ModelServer(treg, slots=2, capacity=CAP, page_size=PS)
    try:
        stats = compile_watch.install_global_watch(registry=reg)
        with stats.zero_compile_scope("cpu"):
            assert server.warmup(prompt_tokens=4, n_tokens=3)["lm"][
                "generate"] is True
            batcher, _ = server.batcher_for("lm")
            assert len(batcher.generate(np.arange(1, 6), 4)) == 4
        assert stats.summary()["graph_replays"] == 0
        assert batcher.session._graph is None
    finally:
        compile_watch._GLOBAL_STATS = saved
        server.stop(drain=False)


def test_cli_serve_aot_warmup_prints_the_report(lm_ids):
    _, path = lm_ids
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--model", f"lm={path}", "--device", "cpu", "--port", "0",
         "--slots", "2", "--capacity", str(CAP), "--page-size", str(PS),
         "--max-batch-size", "4", "--aot-warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "serving on" in line:
                break
        text = "".join(lines)
        assert re.search(r"aot warmup: lm v1 — predict buckets \[1, 2, 4\], "
                         r"generate=True \(\d+\.\ds\)\n", text), text
        # the report comes before the listener opens
        assert text.index("aot warmup:") < text.index("serving on")
        proc.send_signal(2)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
