"""The port's recurrent streaming against the JAX package's, on the CPU.

``rnn_time_step`` on both executors, ``StreamingSession``,
``SlotStreamingSession`` (slot reuse after ``reset_slot``, with the
slot's carries zeroed), ``GraphStreamingSession`` (steps and greedy
``generate``), a mixed GravesLSTM + transformer stack (carries and KV
caches in one session), and the continuous batcher over an embedding
LSTM LM (``tests/test_decode_paged.py``'s ``_rnn_lm``), whose
``kv_mode="auto"`` picks the dense slot session. Networks are built by
the JAX package and cross by checkpoint zip; seeded numpy inputs go to
both packages, and each stream is also held against ``output`` of the
whole sequence.

Tolerance: float32 on both sides with sums in another order: atol 2e-5,
rtol 2e-4. The batcher and ``generate`` are held by their ids (greedy,
and the batcher's numpy temperature sampling).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JaxGraph)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import updaters as jupd
from deeplearning4j_tpu.nn.conf.builder import (
    NeuralNetConfiguration as JaxBuilder)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.serving import ContinuousBatcher as JaxBatcher
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.models.computation_graph import (
    ComputationGraph)
from deeplearning4j_tpu_torch.models.streaming import (GraphStreamingSession,
                                                       SlotStreamingSession)
from deeplearning4j_tpu_torch.serving.continuous import ContinuousBatcher
from deeplearning4j_tpu_torch.util import model_serializer as tser

V, HID, T, B, CAP = 11, 9, 14, 3, 40
ATOL, RTOL = 2e-5, 2e-4


def _port_of(jnet, tmp_path, name="net.zip"):
    path = str(tmp_path / name)
    jser.write_model(jnet, path)
    return tser.restore_model(path, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=RTOL)


def _onehot(seed, b=B, t=T):
    ids = np.random.default_rng(seed).integers(0, V, (b, t))
    return np.eye(V, dtype=np.float32)[ids]


def _char_layers():
    return [jl.GravesLSTM(n_out=HID, activation="tanh"),
            jl.LSTM(n_out=HID),
            jl.RnnOutputLayer(n_out=V, loss="mcxent")]


def _char_mln(seed=0, first=None):
    b = (JaxBuilder.builder().set_seed(seed).updater(jupd.rmsprop(1e-3))
         .list())
    for layer in ([first] if first is not None else []) + _char_layers():
        b = b.layer(layer)
    return JaxNet(b.set_input_type(JIT.recurrent(V, CAP)).build()).init()


def _char_graph(seed=0, embed=False):
    """in -> [emb] -> GravesLSTM -> LSTM -> out, plus a SimpleRnn branch
    merged in before the output."""
    g = (JaxBuilder.builder().set_seed(seed).updater(jupd.rmsprop(1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(JIT.recurrent(V, CAP)))
    src = "in"
    if embed:
        g = g.add_layer("emb", jl.EmbeddingSequenceLayer(n_in=V, n_out=6),
                        "in")
        src = "emb"
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    g = (g.add_layer("l1", jl.GravesLSTM(n_out=HID), src)
         .add_layer("l2", jl.LSTM(n_out=HID), "l1")
         .add_layer("side", jl.SimpleRnn(n_out=4), src)
         .add_vertex("merge", MergeVertex(), "l2", "side")
         .add_layer("out", jl.RnnOutputLayer(n_out=V, loss="mcxent"),
                    "merge")
         .set_outputs("out"))
    return JaxGraph(g.build()).init()


# ---------------------------------------------------------- rnn_time_step

@pytest.mark.parametrize("graph", [False, True])
def test_rnn_time_step_matches_jax_and_output(tmp_path, graph):
    jn = _char_graph() if graph else _char_mln()
    tn = _port_of(jn, tmp_path)
    x = _onehot(0)
    full = tn.output(x)
    _close(full, jn.output(x))
    steps = [tn.rnn_time_step(x[:, t]) for t in range(6)]
    ref = [jn.rnn_time_step(x[:, t]) for t in range(6)]
    chunk = tn.rnn_time_step(x[:, 6:])            # (B, t, C) chunk
    _close(chunk, jn.rnn_time_step(x[:, 6:]))
    for t, (a, b) in enumerate(zip(steps, ref)):
        assert a.shape == (B, V)
        _close(a, b)
        _close(a, full[:, t])
    _close(chunk, full[:, 6:])
    tn.rnn_clear_previous_state()
    _close(tn.rnn_time_step(x[:, :1])[:, 0], full[:, 0])


@pytest.mark.parametrize("first", ["Bidirectional", "LastTimeStep"])
def test_wrappers_see_each_call_alone_as_in_jax(tmp_path, first):
    """Bidirectional and LastTimeStep go through ``apply`` in
    rnn_time_step: each call's chunk alone, as in the JAX package."""
    if first == "Bidirectional":
        layers = [jl.Bidirectional(fwd=jl.LSTM(n_out=5), mode="add"),
                  jl.GravesLSTM(n_out=HID),
                  jl.RnnOutputLayer(n_out=V, loss="mcxent")]
    else:
        layers = [jl.GravesLSTM(n_out=HID),
                  jl.LastTimeStep(underlying=jl.LSTM(n_out=5)),
                  jl.OutputLayer(n_out=V, loss="mcxent")]
    b = JaxBuilder.builder().set_seed(4).list()
    for layer in layers:
        b = b.layer(layer)
    jn = JaxNet(b.set_input_type(JIT.recurrent(V, CAP)).build()).init()
    tn = _port_of(jn, tmp_path)
    x = _onehot(1)
    for a, c in ((0, 3), (3, 4), (4, 9)):
        _close(tn.rnn_time_step(x[:, a:c]), jn.rnn_time_step(x[:, a:c]))


# ---------------------------------------------------------- sessions

def test_streaming_session_matches_jax_output_and_resets(tmp_path):
    jn = _char_mln()
    tn = _port_of(jn, tmp_path)
    x = _onehot(2)
    full = tn.output(x)
    js = jn.streaming_session(capacity=CAP, batch=B)
    ts = tn.streaming_session(capacity=CAP, batch=B)
    parts = []
    for a, b in ((0, 1), (1, 5), (5, 6), (6, T)):
        got = ts.step(x[:, a:b])
        _close(got, js.step(x[:, a:b]))
        parts.append(_np(got))
    _close(np.concatenate(parts, 1), full)
    # reset zeroes the carries: the same stream again gives the same
    ts.reset()
    assert all(not t.any() for t in ts._states[0])
    _close(ts.step(x[:, :4]), full[:, :4])
    _close(ts.step(x[:, 4]), full[:, 4])              # (B, C) squeezes


def test_slot_session_matches_jax_with_slot_reuse(tmp_path):
    """Three slots, one free for a while (its carry advances on the dummy
    input, as in JAX), one recycled mid-stream: every active slot's
    output equals the JAX slot session's, and ``reset_slot`` zeroes the
    slot's carries and nobody else's."""
    jn = _char_mln(seed=1)
    tn = _port_of(jn, tmp_path)
    js = jn.slot_streaming_session(capacity=CAP, slots=3)
    ts = tn.slot_streaming_session(capacity=CAP, slots=3)
    assert isinstance(ts, SlotStreamingSession)
    rng = np.random.default_rng(5)
    active = np.array([True, False, True])
    for step in range(12):
        if step == 3:
            active[1] = True
        if step == 7:                 # recycle slot 0 for a new stream
            js.reset_slot(0)
            ts.reset_slot(0)
            for h in ts._states[0] + ts._states[1]:
                assert not h[0].any() and h[2].any()
        x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (3, 1))]
        ref = np.asarray(js.step_slots(x.copy(), active))
        out = ts.step_slots(x.copy(), active)
        _close(out[active], ref[active])
        np.testing.assert_array_equal(ts.slot_pos, js.slot_pos)
    ts.reinit_states()
    assert ts.slot_pos.tolist() == [0, 0, 0]
    assert all(not t.any() for t in ts._states[1])


def test_graph_session_matches_jax_rnn_time_step_and_output(tmp_path):
    jn = _char_graph(seed=2)
    tn = _port_of(jn, tmp_path)
    x = _onehot(3)
    full = tn.output(x)
    js = jn.streaming_session(capacity=CAP, batch=B)
    ts = tn.streaming_session(capacity=CAP, batch=B)
    assert isinstance(ts, GraphStreamingSession)
    for a, b in ((0, 1), (1, 6), (6, T)):
        got = ts.step(x[:, a:b])
        _close(got, js.step(x[:, a:b]))
        _close(got, full[:, a:b])
    ts.reset()
    _close(ts.step(x[:, 0]), full[:, 0])
    with pytest.raises(ValueError, match="overflow"):
        ts.step(np.zeros((B, CAP, V), np.float32))


def test_graph_session_generate_equals_jax(tmp_path):
    jn = _char_graph(seed=3, embed=True)
    tn = _port_of(jn, tmp_path)
    prompt = np.random.default_rng(6).integers(1, V, (2, 5))
    ref = np.asarray(jn.streaming_session(capacity=CAP, batch=2).generate(
        prompt, 8))
    for fused in (False, True):
        got = tn.streaming_session(capacity=CAP, batch=2).generate(
            prompt, 8, fused=fused)
        np.testing.assert_array_equal(_np(got), ref)


def test_graph_rnn_time_step_on_a_two_input_graph(tmp_path):
    from deeplearning4j_tpu.nn.conf.graph import MergeVertex
    g = (JaxBuilder.builder().set_seed(5).graph_builder()
         .add_inputs("a", "b")
         .set_input_types(JIT.recurrent(V, CAP), JIT.recurrent(4, CAP))
         .add_layer("la", jl.LSTM(n_out=HID), "a")
         .add_layer("lb", jl.GravesLSTM(n_out=3), "b")
         .add_vertex("m", MergeVertex(), "la", "lb")
         .add_layer("out", jl.RnnOutputLayer(n_out=V, loss="mcxent"), "m")
         .set_outputs("out"))
    jn = JaxGraph(g.build()).init()
    tn = _port_of(jn, tmp_path)
    assert isinstance(tn, ComputationGraph)
    xa = _onehot(7)
    xb = np.random.default_rng(8).normal(0, 1, (B, T, 4)).astype(np.float32)
    full = tn.output(xa, xb)
    for t in range(4):
        got = tn.rnn_time_step(xa[:, t], xb[:, t])
        _close(got, jn.rnn_time_step(xa[:, t], xb[:, t]))
        _close(got, full[:, t])
    ts = tn.streaming_session(capacity=CAP, batch=B)
    _close(ts.step(xa, xb), full)
    with pytest.raises(ValueError, match="every input"):
        ts.step(xa[:, :2], xb[:, :3])


def test_mixed_graves_lstm_transformer_session(tmp_path):
    """GravesLSTM -> causal TransformerEncoderLayer -> RnnOutputLayer:
    recurrent carries and KV caches in one session, step by step, equal
    ``output`` and the JAX session."""
    conf = (JaxBuilder.builder().set_seed(3).updater(jupd.adam(1e-3)).list()
            .layer(jl.GravesLSTM(n_out=16, activation="tanh"))
            .layer(jl.TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(jl.RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(6, T)).build())
    jn = JaxNet(conf).init()
    tn = _port_of(jn, tmp_path)
    x = np.random.default_rng(9).normal(0, 1, (B, T, 6)).astype(np.float32)
    full = tn.output(x)
    _close(full, jn.output(x))
    js = jn.streaming_session(capacity=T, batch=B)
    ts = tn.streaming_session(capacity=T, batch=B)
    stepped = []
    for t in range(T):
        got = ts.step(x[:, t])
        _close(got, js.step(x[:, t]))
        stepped.append(_np(got))
    _close(np.stack(stepped, 1), full)
    # and through rnn_time_step (KV cache grown by concatenation)
    _close(tn.rnn_time_step(x[:, :5]), full[:, :5])
    _close(tn.rnn_time_step(x[:, 5]), full[:, 5])


# ---------------------------------------------------------- the batcher

def _rnn_lm(seed=0):
    """tests/test_decode_paged.py's ``_rnn_lm``."""
    conf = (JaxBuilder.builder().set_seed(seed)
            .updater(jupd.adam(1e-3)).list()
            .layer(jl.EmbeddingSequenceLayer(n_in=V, n_out=8))
            .layer(jl.LSTM(n_out=8))
            .layer(jl.RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(V, CAP)).build())
    return JaxNet(conf).init()


def _run(cb, prompts, n, temperature=0.0):
    try:
        hs = [cb.submit(p, n, temperature=temperature, seed=i)
              for i, p in enumerate(prompts)]
        return [np.asarray(cb.wait(h)) for h in hs]
    finally:
        assert cb.shutdown(drain=True)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batcher_over_an_rnn_lm_matches_jax(tmp_path, temperature):
    """Six requests through two slots (slot reuse, so admission must zero
    the carries): every stream equals the JAX batcher's, and
    ``kv_mode="auto"`` took the dense slot session in both packages."""
    jn = _rnn_lm()
    tn = _port_of(jn, tmp_path)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, V, (m,)) for m in (5, 3, 9, 4, 12, 6)]
    jb = JaxBatcher(jn, slots=2, capacity=CAP, name="jax")
    assert not jb._paged
    ref = _run(jb, prompts, 10, temperature)
    cb = ContinuousBatcher(tn, slots=2, capacity=CAP, name="port")
    assert not cb._paged
    assert isinstance(cb.session, SlotStreamingSession)
    got = _run(cb, prompts, 10, temperature)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if temperature == 0.0:
        # each equals a lone decode of its prompt
        for a, p in zip(got, prompts):
            lone = tn.streaming_session(capacity=CAP, batch=1).generate(
                p[None], 10)
            np.testing.assert_array_equal(a, _np(lone)[0])


# ---------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_dense_session_decode_on_card_matches_cpu(cuda_device, tmp_path):
    """The mixed GravesLSTM + transformer stack (head dim 64, the decode
    kernel's width) stepped token by token through the dense session on
    the card, where every attention is the decode kernel, against the
    same session on the CPU's plain attention."""
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    conf = (JaxBuilder.builder().set_seed(3).list()
            .layer(jl.GravesLSTM(n_out=128, activation="tanh"))
            .layer(jl.TransformerEncoderLayer(n_heads=2, causal=True))
            .layer(jl.RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(6, 32)).build())
    path = str(tmp_path / "mixed.zip")
    jser.write_model(JaxNet(conf).init(), path)
    x = np.random.default_rng(11).normal(0, 1, (2, 32, 6)).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        net = tser.restore_model(path, device=dev)
        sess = net.streaming_session(capacity=32, batch=2)
        before = da.decode_attention_cuda.launches
        outs[dev] = np.stack([_np(sess.step(x[:, t])) for t in range(32)], 1)
        if dev == "cuda":
            assert da.decode_attention_cuda.launches - before == 32
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=ATOL,
                               rtol=RTOL)
