"""The port's generate path against the JAX package's, on the CPU.

One small causal transformer LM (V=64, D=32, L=2, H=4, capacity 64,
page_size 8) is built and saved by the JAX package; the port restores
the same zip. Seeded prompts then go through both packages' streaming
sessions, slot and paged sessions, speculative decoder, continuous
batcher and ``/v1/generate``: greedy ids must be equal, and where the
port samples with numpy exactly as the JAX batcher does (the batcher,
``/v1/generate``) temperature ids too. Session-level temperature
sampling draws from a ``torch.Generator`` and is held only within the
port (fused equals unfused). Probabilities and KV contents are held to
atol=1e-5, rtol=1e-5 (float32 on both sides, sums in another order).
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.models.paged_kv import PagedSlotSession as JaxPaged
from deeplearning4j_tpu.models.speculative import (
    SpeculativeDecoder as JaxSpeculative)
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.serving import ContinuousBatcher as JaxBatcher
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.models import paged_kv as tpaged
from deeplearning4j_tpu_torch.models.speculative import SpeculativeDecoder
from deeplearning4j_tpu_torch.serving.continuous import ContinuousBatcher
from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     KVLeaseCorruptError,
                                                     KVLeaseVersionError,
                                                     KVPagePoolExhaustedError,
                                                     QueueFullError,
                                                     ServerClosedError)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-5
V, D, L, H, CAP, PS = 64, 32, 2, 4, 64, 8


def _jax_lm(seed=0, width=D, layers=L):
    b = (NeuralNetConfiguration.builder().set_seed(seed).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=width)))
    for _ in range(layers):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    return JaxNet(conf).init()


def _pair(tmp_path_factory, seed=0, width=D, layers=L):
    jnet = _jax_lm(seed, width, layers)
    path = str(tmp_path_factory.mktemp("gen") / "lm.zip")
    jser.write_model(jnet, path)
    return jnet, restore_model(path, device="cpu"), path


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(jax net, port net, zip path) of one LM."""
    return _pair(tmp_path_factory)


def _prompts(n, seed=3, lengths=(5, 3, 9, 4, 17, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, (m,)) for m in lengths[:n]]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- streaming sessions

def test_chunked_streaming_equals_full_output(lm):
    _, net, _ = lm
    ids = np.random.default_rng(0).integers(0, V, (2, 20)).astype(np.float32)
    full = _np(net.output(ids))
    sess = net.streaming_session(capacity=CAP, batch=2)
    parts = [_np(sess.step(ids[:, a:b, None]))
             for a, b in ((0, 7), (7, 8), (8, 20))]
    np.testing.assert_allclose(np.concatenate(parts, 1), full, atol=ATOL,
                               rtol=RTOL)
    # the single-step (B, C) form squeezes the time axis
    sess.reset()
    sess.step(ids[:, :19, None])
    np.testing.assert_allclose(_np(sess.step(ids[:, 19:20])), full[:, -1],
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="overflow"):
        sess.step(np.zeros((2, CAP, 1), np.float32))


def test_rnn_time_step_equals_full_output_and_jax(lm):
    jnet, net, _ = lm
    ids = np.random.default_rng(1).integers(0, V, (2, 12)).astype(np.float32)
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    outs, refs = [], []
    for a, b in ((0, 5), (5, 6), (6, 12)):
        outs.append(_np(net.rnn_time_step(ids[:, a:b, None])))
        refs.append(np.asarray(jnet.rnn_time_step(ids[:, a:b, None])))
    np.testing.assert_allclose(np.concatenate(outs, 1),
                               _np(net.output(ids)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.concatenate(outs, 1),
                               np.concatenate(refs, 1), atol=ATOL, rtol=RTOL)
    net.rnn_clear_previous_state()
    assert net._rnn_state is None


@pytest.mark.parametrize("batch", [1, 3])
def test_generate_greedy_ids_equal_jax(lm, batch):
    jnet, net, _ = lm
    prompt = np.random.default_rng(batch).integers(1, V, (batch, 6))
    ref = np.asarray(jnet.streaming_session(capacity=CAP, batch=batch)
                     .generate(prompt.astype(np.float32), 20))
    for fused in (False, True):
        sess = net.streaming_session(capacity=CAP, batch=batch)
        ids = _np(sess.generate(prompt, 20, fused=fused))
        np.testing.assert_array_equal(ids, ref)
        assert sess.pos == 6 + 20 - (0 if fused else 1)


def test_fused_equals_unfused_under_temperature(lm):
    _, net, _ = lm
    prompt = np.array([[1, 2, 3], [4, 5, 6]])
    got = []
    for fused in (False, True):
        g = torch.Generator().manual_seed(11)
        sess = net.streaming_session(capacity=CAP, batch=2)
        got.append(_np(sess.generate(prompt, 12, temperature=0.8,
                                     generator=g, fused=fused)))
    np.testing.assert_array_equal(got[0], got[1])
    # a sampled stream is not the greedy one (the draw is live)
    greedy = _np(net.streaming_session(capacity=CAP, batch=2)
                 .generate(prompt, 12))
    assert not np.array_equal(got[0], greedy)
    with pytest.raises(ValueError, match="capacity"):
        net.streaming_session(capacity=10, batch=2).generate(
            prompt, 8, fused=True)


def test_slot_session_matches_jax_with_slot_reuse(lm):
    """Three slots stepping at their own positions, one recycled
    mid-stream: each active slot's probabilities equal the JAX slot
    session's."""
    jnet, net, _ = lm
    js = jnet.slot_streaming_session(capacity=CAP, slots=3)
    ts = net.slot_streaming_session(capacity=CAP, slots=3)
    rng = np.random.default_rng(4)
    active = np.array([True, False, True])
    for step in range(14):
        if step == 3:
            active[1] = True
        if step == 8:                 # recycle slot 0 for a new stream
            js.reset_slot(0)
            ts.reset_slot(0)
        x = rng.integers(0, V, (3, 1, 1)).astype(np.float32)
        ref = np.asarray(js.step_slots(x.copy(), active))
        out = _np(ts.step_slots(x.copy(), active))
        np.testing.assert_allclose(out[active], ref[active], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_array_equal(ts.slot_pos, js.slot_pos)
    ts.reinit_states()
    assert ts.slot_pos.tolist() == [0, 0, 0]


def test_paged_session_matches_jax_with_slot_reuse(lm):
    jnet, net, _ = lm
    js = jnet.paged_slot_streaming_session(capacity=CAP, slots=2,
                                           page_size=PS)
    ts = net.paged_slot_streaming_session(capacity=CAP, slots=2,
                                          page_size=PS)
    rng = np.random.default_rng(5)
    streams = [(0, rng.integers(1, V, (11,))), (1, rng.integers(1, V, (4,))),
               (1, rng.integers(1, V, (9,)))]      # slot 1 reused
    for slot, toks in streams:
        for s in (js, ts):
            s.bind(slot, s.reserve(toks, 4))
        active = np.zeros(2, bool)
        active[slot] = True
        x = np.zeros((2, 1, 1), np.float32)
        for tok in toks:
            x[slot, 0, 0] = tok
            ref = np.asarray(js.step_slots(x.copy(), active))
            out = _np(ts.step_slots(x.copy(), active))
            np.testing.assert_allclose(out[slot], ref[slot], atol=ATOL,
                                       rtol=RTOL)
        assert ts.pages_in_use() == js.pages_in_use()
        if slot == 1:
            for s in (js, ts):
                s.release(1)
    for s in (js, ts):
        s.release_all()
    assert ts.pages_in_use() == 0


# ----------------------------------------- allocator, prefix cache, leases

class TestPagedAllocator:
    def test_alloc_free_refcount(self):
        a = tpaged.PagedKVAllocator(n_pages=4, page_size=8)
        pages = a.alloc(3)
        assert len(set(pages)) == 3 and 0 not in pages
        assert a.in_use() == 3 and a.free_count() == 1
        a.incref(pages[:1])
        a.decref(pages)
        assert a.in_use() == 1
        a.decref(pages[:1])
        assert a.in_use() == 0 and a.free_count() == 4

    def test_double_free_and_use_after_free_guarded(self):
        a = tpaged.PagedKVAllocator(n_pages=2, page_size=8)
        (p,) = a.alloc(1)
        a.decref([p])
        with pytest.raises(ValueError, match="double free"):
            a.decref([p])
        with pytest.raises(ValueError, match="use-after-free"):
            a.incref([p])

    def test_oom_is_typed_admission_error_with_retry_after(self):
        a = tpaged.PagedKVAllocator(n_pages=2, page_size=8)
        a.alloc(2)
        with pytest.raises(KVPagePoolExhaustedError) as ei:
            a.alloc(1)
        assert isinstance(ei.value, QueueFullError)
        assert ei.value.retry_after_s and ei.value.retry_after_s > 0
        assert a.free_count() == 0 and a.in_use() == 2

    def test_prefix_register_lookup_and_lru_eviction(self):
        a = tpaged.PagedKVAllocator(n_pages=6, page_size=4)
        pc = tpaged.PrefixCache(a)
        toks = np.arange(8)
        pages = a.alloc(2)
        pc.register(toks, pages)
        a.decref(pages)
        assert a.in_use() == 2
        hit = pc.lookup(toks)
        assert hit == pages and pc.hits_total == 1
        a.decref(hit)
        hit1 = pc.lookup(np.concatenate([toks[:4], [9, 9, 9, 9]]))
        assert hit1 == pages[:1]
        a.decref(hit1)
        assert pc.lookup(np.arange(4) + 1) == []
        got = a.alloc(5, evictor=pc)
        assert len(got) == 5
        assert pc.evictions_total == 1
        assert a.in_use() == 6 and len(pc) == 1
        assert a.refcount(pages[0]) == 1

    def test_fingerprints_match_jax(self):
        from deeplearning4j_tpu.models import paged_kv as jpaged
        toks = np.arange(1, 30)
        assert tpaged.prefix_fingerprints(toks, 8) == \
            jpaged.prefix_fingerprints(toks, 8)
        assert tpaged.prefix_fingerprint(toks, 16) == \
            jpaged.prefix_fingerprint(toks, 16)


def _feed_prompt(sess, slot, toks, n_tokens=4):
    # every step gets its own x: the JAX session may read its input after
    # step_slots returns (asynchronous dispatch over a zero-copy array)
    lease = sess.reserve(toks, n_tokens)
    sess.bind(slot, lease)
    x = np.zeros((sess.slots, 1, 1), np.float32)
    active = np.arange(sess.slots) == slot
    out = None
    for t in toks:
        x[slot, 0, 0] = t
        out = sess.step_slots(x.copy(), active)
    return lease, _np(out)[slot, 0]


def test_reserve_cow_on_full_prompt_hit(lm):
    _, net, _ = lm
    sess = net.paged_slot_streaming_session(capacity=CAP, slots=2,
                                            page_size=4)
    prompt = (np.arange(8) % (V - 1)) + 1            # 2 full pages
    _, first = _feed_prompt(sess, 0, prompt)
    sess.release(0, register_prompt=prompt)
    shared = sess.prefix_cache.lookup(prompt)
    sess.allocator.decref(shared)
    lease = sess.reserve(prompt, 4)
    assert lease.resume_pos == len(prompt) - 1
    assert lease.pages[0] == shared[0]                # shared
    assert lease.pages[1] != shared[1]                # copy-on-write
    assert sess.allocator.refcount(shared[1]) >= 1
    # the copy holds the shared page's rows, so re-feeding the last prompt
    # token gives the cold stream's output
    sess.bind(1, lease)
    x = np.zeros((2, 1, 1), np.float32)
    x[1, 0, 0] = prompt[-1]
    again = _np(sess.step_slots(x, np.array([False, True])))[1, 0]
    np.testing.assert_allclose(again, first, atol=ATOL, rtol=RTOL)
    sess.release(1)


def test_lease_exchange_between_packages(lm):
    """A lease exported by the JAX session imports into the port and the
    reverse, continuing to the same greedy ids; re-exported from the
    importer it is the same bytes."""
    jnet, net, _ = lm
    prompt = np.random.default_rng(6).integers(1, V, (19,))
    sessions = {}
    for name, n in (("jax", jnet), ("torch", net)):
        s = n.paged_slot_streaming_session(capacity=CAP, slots=2,
                                           page_size=PS)
        _feed_prompt(s, 0, prompt[:-1], 8)
        sessions[name] = s
    extra = {"prompt": prompt.tolist(), "n_tokens": 8}
    blobs = {k: s.export_lease(0, extra=extra) for k, s in sessions.items()}
    importers = {"torch": net.paged_slot_streaming_session(
        capacity=CAP, slots=2, page_size=PS),
        "jax": jnet.paged_slot_streaming_session(capacity=CAP, slots=2,
                                                 page_size=PS)}
    continued = {}
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        sess = importers[dst]
        lease, got = sess.import_lease(blobs[src], 27)
        assert got == extra and lease.resume_pos == 18
        sess.bind(1, lease)
        assert sess.export_lease(1, extra=extra) == blobs[src]
        x = np.zeros((2, 1, 1), np.float32)
        active = np.array([False, True])
        tok, ids = int(prompt[-1]), []
        for _ in range(6):
            x[1, 0, 0] = tok
            tok = int(np.argmax(_np(sess.step_slots(x.copy(), active))[1, 0]))
            ids.append(tok)
        continued[dst] = ids
    assert continued["torch"] == continued["jax"]


def test_lease_errors_are_typed(lm):
    _, net, _ = lm
    s = net.paged_slot_streaming_session(capacity=CAP, slots=1, page_size=PS)
    _feed_prompt(s, 0, np.arange(1, 12), 4)
    blob = s.export_lease(0)
    bad = bytearray(blob)
    bad[20] ^= 0xFF
    with pytest.raises(KVLeaseCorruptError):
        tpaged.parse_lease(bytes(bad))
    with pytest.raises(KVLeaseCorruptError):
        tpaged.parse_lease(b"nope")
    other = net.paged_slot_streaming_session(capacity=CAP, slots=1,
                                             page_size=4)
    with pytest.raises(KVLeaseVersionError, match="page_size"):
        other.import_lease(blob, 20)
    assert other.pages_in_use() == 0


# ------------------------------------------------------------- speculative

def test_speculative_greedy_parity_perfect_and_poor_draft(tmp_path_factory,
                                                          lm):
    jnet, target, _ = lm
    _, poor, _ = _pair(tmp_path_factory, seed=9, width=16, layers=1)
    prompt = np.array([[1, 2, 3, 4, 5]])
    ref = np.asarray(jnet.streaming_session(capacity=CAP, batch=1)
                     .generate(prompt.astype(np.float32), 20))[0]
    for draft, lo, hi in ((target, 0.99, 1.01), (poor, 0.0, 0.9)):
        sd = SpeculativeDecoder(target, draft, k=4, capacity=CAP)
        np.testing.assert_array_equal(sd.generate(prompt, 20), ref)
        assert lo <= sd.acceptance_rate <= hi
        assert sd.tokens_proposed >= 20
    jsd = JaxSpeculative(jnet, jnet, k=4, capacity=CAP)
    np.testing.assert_array_equal(jsd.generate(prompt, 20), ref)


def test_speculative_registry_waits_for_metrics(tmp_path_factory, lm):
    """The ``registry=`` acceptance counters (once refused, waiting for
    the serving metrics) count what the JAX decoder's count on the same
    target, draft and prompt, and equal the plain-int tallies."""
    from deeplearning4j_tpu.observability.registry import (
        MetricsRegistry as JaxMetricsRegistry)
    from deeplearning4j_tpu_torch.observability.registry import (
        MetricsRegistry)
    jnet, net, _ = lm
    jpoor, poor, _ = _pair(tmp_path_factory, seed=9, width=16, layers=1)
    prompt = np.array([[1, 2, 3, 4, 5]])
    reg, jreg = MetricsRegistry(), JaxMetricsRegistry()
    sd = SpeculativeDecoder(net, poor, k=4, capacity=CAP, registry=reg)
    jsd = JaxSpeculative(jnet, jpoor, k=4, capacity=CAP, registry=jreg)
    np.testing.assert_array_equal(sd.generate(prompt, 20),
                                  jsd.generate(prompt, 20))
    lbl = {"endpoint": "speculative"}
    counts = [(r.get("spec_tokens_proposed_total", lbl).value,
               r.get("spec_tokens_accepted_total", lbl).value)
              for r in (reg, jreg)]
    assert counts[0] == counts[1] == (sd.tokens_proposed,
                                      sd.tokens_accepted)
    assert reg.prometheus_text() == jreg.prometheus_text()
    with pytest.raises(ValueError, match="headroom"):
        SpeculativeDecoder(net, net, k=4, capacity=CAP).generate(
            np.arange(1, 60), 4)


# --------------------------------------------------------- the batcher

def _run(cb, prompts, n, temperature=0.0):
    try:
        hs = [cb.submit(p, n, temperature=temperature, seed=i)
              for i, p in enumerate(prompts)]
        return [np.asarray(cb.wait(h)) for h in hs]
    finally:
        assert cb.shutdown(drain=True)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_batcher_matches_jax_batcher(lm, temperature):
    """Six requests through two slots (slot reuse, neighbours at other
    positions), on both KV modes: every stream equals the JAX batcher's,
    temperature included (the same numpy sampling)."""
    jnet, net, _ = lm
    prompts = _prompts(6)
    ref = _run(JaxBatcher(jnet, slots=2, capacity=CAP, kv_mode="paged",
                          page_size=PS, name="jax"), prompts, 10,
               temperature)
    for mode in ("paged", "dense"):
        cb = ContinuousBatcher(net, slots=2, capacity=CAP, kv_mode=mode,
                               page_size=PS, name=mode)
        assert cb._paged == (mode == "paged")
        for a, b in zip(_run(cb, prompts, 10, temperature), ref):
            np.testing.assert_array_equal(a, b)


def test_batcher_slot_reuse_equals_sequential_and_session(lm):
    _, net, _ = lm
    prompts = _prompts(5, seed=8)
    cb = ContinuousBatcher(net, slots=2, capacity=CAP, queue_limit=16)
    got = _run(cb, prompts, 6)
    assert cb.device_steps > 0
    seq = ContinuousBatcher(net, slots=2, capacity=CAP)
    try:
        ref = [seq.generate(p, 6) for p in prompts]
    finally:
        assert seq.shutdown(drain=True)
    for a, b, p in zip(got, ref, prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _np(
            net.streaming_session(capacity=CAP, batch=1).generate(
                p[None], 6))[0])


def test_batcher_admission_control(lm):
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=1, capacity=CAP, queue_limit=2)
    try:
        for prompt, n in ((np.arange(1, 5), CAP), (np.array([]), 4),
                          (np.array([1]), 0), (np.ones((2, 3)), 2)):
            with pytest.raises(ValueError):
                cb.submit(prompt, n)
        handles, shed = [cb.submit(np.array([1, 2]), CAP - 2)], 0
        for _ in range(8):
            try:
                handles.append(cb.submit(np.array([1, 2]), 4))
            except QueueFullError:
                shed += 1
        assert shed >= 1
        assert [len(cb.wait(h)) for h in handles] == \
            [CAP - 2] + [4] * (len(handles) - 1)
    finally:
        assert cb.shutdown(drain=True)
    with pytest.raises(ServerClosedError):
        cb.submit(np.array([1]), 2)


def test_batcher_deadline_expires_while_slots_busy(lm):
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=1, capacity=CAP)
    try:
        long = cb.submit(np.array([1, 2]), CAP - 2)
        doomed = cb.submit(np.array([1, 2]), 4, timeout=-0.001)
        with pytest.raises(DeadlineExceededError):
            cb.wait(doomed)
        assert len(cb.wait(long)) == CAP - 2
    finally:
        assert cb.shutdown(drain=True)


def test_batcher_prefix_hit_skips_prefill(lm):
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=2, capacity=CAP, page_size=PS)
    prompt = np.arange(1, 21)                        # 2 full pages of 8
    try:
        first = cb.generate(prompt, 6)
        steps = cb.device_steps
        second = cb.generate(prompt, 6)
        assert cb.prefix_hits == 1
        np.testing.assert_array_equal(first, second)
        # the second stream resumed after the 16 cached positions
        assert cb.device_steps - steps == len(prompt) - 16 + 6 - 1
        # the streaming histograms: one cold and one prefix-hit first
        # token, 5 inter-token gaps a stream
        st = cb._stream
        assert (st.ttft.count, st.ttft_hit.count, st.itl.count) == (1, 1, 10)
    finally:
        assert cb.shutdown(drain=True)
    # only the prefix cache holds pages once the streams are done
    assert cb.session.pages_in_use() == 2


def test_batcher_pool_exhaustion_is_typed_and_waits(lm):
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=2, capacity=CAP, kv_mode="paged",
                           page_size=8, kv_pages=4)
    try:
        # 4 pages x 8 tokens = a 32-token pool < a 40-token worst case
        with pytest.raises(ValueError, match="whole pool"):
            cb.submit(np.arange(8) % V, 32)
        # two 3-page requests cannot both hold pages: the second waits for
        # the first to finish (sticky head), then completes
        a = cb.submit(np.arange(1, 9), 12)
        b = cb.submit(np.arange(2, 10), 12)
        assert len(cb.wait(a)) == 12 and len(cb.wait(b)) == 12
    finally:
        assert cb.shutdown(drain=True)
    sess = net.paged_slot_streaming_session(capacity=CAP, slots=1,
                                            page_size=8, n_pages=2)
    with pytest.raises(KVPagePoolExhaustedError):
        sess.reserve(np.arange(1, 10), 10)
    assert sess.pages_in_use() == 0 and not sess.can_ever_fit(10, 10)


def test_failed_step_leaks_no_pages_and_recovers(lm, monkeypatch):
    """A step that raises fails the streams it carried, rebuilds the
    session (no page refcount survives), and the batcher serves the
    next request correctly."""
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=2, capacity=CAP, page_size=PS)
    try:
        ref = cb.generate(np.arange(1, 12), 5)
        real = type(cb.session).step_slots
        calls = {"n": 0}

        def flaky(self, x, active):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("device fault")
            return real(self, x, active)

        monkeypatch.setattr(type(cb.session), "step_slots", flaky)
        doomed = cb.submit(np.arange(1, 12), 5)
        with pytest.raises(RuntimeError, match="device fault"):
            cb.wait(doomed)
        # the session is rebuilt just after the failure is delivered; the
        # prefix cache is flushed with it
        for _ in range(200):
            if cb.session.pages_in_use() == 0:
                break
            time.sleep(0.005)
        assert cb.session.pages_in_use() == 0
        np.testing.assert_array_equal(cb.generate(np.arange(1, 12), 5), ref)
    finally:
        assert cb.shutdown(drain=True)


def test_worker_crash_fails_in_flight_and_restarts(lm, monkeypatch):
    _, net, _ = lm
    cb = ContinuousBatcher(net, slots=1, capacity=CAP, page_size=PS)
    try:
        real = ContinuousBatcher._admit
        crashed = []

        def crashing(self):
            # once a stream is in a slot, the loop crashes (once)
            if self.active_slots() and not crashed:
                crashed.append(True)
                raise RuntimeError("loop crash")
            return real(self)

        monkeypatch.setattr(ContinuousBatcher, "_admit", crashing)
        first = cb.submit(np.array([1, 2, 3]), 30)
        with pytest.raises(RuntimeError, match="loop crash"):
            cb.wait(first)
        assert len(cb.generate(np.array([4, 5]), 3)) == 3   # restarted
        for _ in range(200):
            if cb.session.pages_in_use() == 0:
                break
            time.sleep(0.005)
        assert cb.session.pages_in_use() == 0
    finally:
        assert cb.shutdown(drain=True)


# ------------------------------------------------------------- /v1/generate

def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_v1_generate_equals_jax_server(lm):
    jnet, net, path = lm
    jreg, treg = JaxRegistry(), ModelRegistry()
    jreg.register("lm", jser.restore_model(path))
    treg.register("lm", restore_model(path, device="cpu"))
    servers = [JaxServer(jreg, slots=2, capacity=CAP, page_size=PS).start(),
               ModelServer(treg, slots=2, capacity=CAP,
                           page_size=PS).start()]
    bodies = [{"model": "lm", "prompt": [1, 2, 3, 4, 5], "n_tokens": 8},
              {"model": "lm", "prompt": list(range(1, 20)), "n_tokens": 6,
               "temperature": 0.8, "seed": 3},
              {"model": "lm", "prompt": list(range(1, 20)), "n_tokens": 6,
               "temperature": 0.8, "seed": 4, "version": 1}]
    try:
        replies = [[_post(s.port, b) for b in bodies] for s in servers]
        for (jc, jr), (tc, tr) in zip(*replies):
            assert jc == tc == 200
            assert tr == jr and tr["model_version"] == 1
        assert replies[1][1][1]["ids"] != replies[1][2][1]["ids"]
        # errors: bad body 400, unknown model 404, over capacity 400
        port = servers[1].port
        assert _post(port, {"model": "lm"})[0] == 400
        assert _post(port, {"model": "nope", "prompt": [1]})[0] == 404
        assert _post(port, {"model": "lm", "prompt": [1] * 60,
                            "n_tokens": 10})[0] == 400
        b, _ = servers[1].batcher_for("lm")
        assert b._paged and b.session.page_size == PS
    finally:
        for s in servers:
            s.stop()
    assert b._stop.is_set()                        # drained with the server


def test_cli_serves_generate(lm):
    _, net, path = lm
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--model", f"lm={path}", "--device", "cpu", "--port", "0",
         "--slots", "3", "--capacity", str(CAP), "--kv-mode", "dense"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)/", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server did not start"
        code, body = _post(port, {"model": "lm", "prompt": [3, 1, 4],
                                  "n_tokens": 5})
        assert code == 200
        assert body["ids"] == _np(net.streaming_session(
            capacity=CAP, batch=1).generate(np.array([[3, 1, 4]]), 5))[
            0].tolist()
        proc.send_signal(2)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# ------------------------------------------------------------- card only

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the step's CUDA graph and the "
                    "decode kernel run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_lm(tmp_path_factory):
    """The zip of an LM whose head dim the decode kernel takes (width
    128 over 4 heads: Dh = 32)."""
    return _pair(tmp_path_factory, seed=1, width=128)[2]


def _card_session(path, slots=3):
    """A paged session of the zip's LM on the card, its slots bound to
    seeded prompts of 13, 7 and 20 ids (8 tokens of room each)."""
    net = restore_model(path, device="cuda")
    sess = net.paged_slot_streaming_session(capacity=CAP, slots=slots,
                                            page_size=PS)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, V, n) for n in (13, 7, 20)][:slots]
    for i, p in enumerate(prompts):
        sess.bind(i, sess.reserve(p, 8))
    return sess, prompts


def _run_steps(sess, prompts, n_steps, eager=False):
    """Teacher-force each slot's prompt, then feed back its greedy id;
    returns the steps' probabilities (n_steps, slots, V) and ids."""
    step = sess._step_eager if eager else sess.step_slots
    active = np.ones(sess.slots, bool)
    x = np.zeros((sess.slots, 1, 1), np.float32)
    nxt = np.zeros(sess.slots, np.int64)
    outs, ids = [], []
    for k in range(n_steps):
        for i, p in enumerate(prompts):
            x[i, 0, 0] = p[k] if k < len(p) else nxt[i]
        probs = step(x, active)[:, 0].cpu().numpy()
        nxt = probs.argmax(-1)
        outs.append(probs)
        ids.append(nxt)
    return np.stack(outs), np.stack(ids)


@pytest.mark.cuda
def test_replayed_step_equals_eager_body_on_card(cuda_device, card_lm):
    """The replayed CUDA graph against the eager body it captured, on two
    sessions of one zip: greedy ids equal, probabilities within 1e-6."""
    path = card_lm
    graphed, prompts = _card_session(path)
    eager, _ = _card_session(path)
    out, ids = _run_steps(graphed, prompts, 26)
    ref, ref_ids = _run_steps(eager, prompts, 26, eager=True)
    assert graphed._graph is not None and eager._graph is None
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_replay_counts_the_captured_launches_on_card(cuda_device, card_lm):
    """Each replay adds the launches its capture recorded: decode
    launches = layers x steps, the capture itself adding none."""
    from deeplearning4j_tpu_torch.ops import decode_attention as tda
    path = card_lm
    sess, prompts = _card_session(path)
    before = tda.decode_attention_cuda.launches
    _run_steps(sess, prompts, 10)
    assert tda.decode_attention_cuda.launches - before == L * 10
    assert sess._graph_launches == {tda.decode_attention_cuda: L}


@pytest.mark.cuda
def test_capture_beside_another_thread_on_card(cuda_device, card_lm):
    """The capture is thread-local: another thread's eager forwards on
    the card run through it, and the replayed steps still equal the
    eager body."""
    import threading
    path = card_lm
    other = restore_model(path, device="cuda")
    stop, errors = threading.Event(), []

    def busy():
        x = np.tile(np.arange(1, 17, dtype=np.int64), (2, 1))
        try:
            while not stop.is_set():
                other.output(x).cpu()
        except Exception as e:        # reported below
            errors.append(repr(e))

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        time.sleep(0.2)
        graphed, prompts = _card_session(path)
        out, ids = _run_steps(graphed, prompts, 20)
    finally:
        stop.set()
        worker.join(60)
    assert not worker.is_alive() and not errors, errors
    eager, _ = _card_session(path)
    ref, ref_ids = _run_steps(eager, prompts, 20, eager=True)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_replay_after_reinit_states_on_card(cuda_device, card_lm):
    """reinit_states zeroes the pools in place, so the graph captured
    before it replays correctly after it."""
    path = card_lm
    sess, prompts = _card_session(path)
    _run_steps(sess, prompts, 12)
    graph = sess._graph
    sess.reinit_states()
    assert sess.pages_in_use() == 0
    for i, p in enumerate(prompts):
        sess.bind(i, sess.reserve(p, 8))
    out, ids = _run_steps(sess, prompts, 26)
    assert sess._graph is graph
    eager, _ = _card_session(path)
    ref, ref_ids = _run_steps(eager, prompts, 26, eager=True)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
