"""The port's KV-stream methods (disaggregated prefill/decode and drain
migration) against the JAX package's, on the CPU.

One small causal transformer LM (V=64, D=32, L=2, H=4, capacity 64,
page_size 4) is built and saved by the JAX package; the port restores
the same zip. A stream split into ``prefill_export`` on one batcher and
``import_stream`` on another must give exactly the ids the whole request
gives on one batcher, greedy and at temperature (the numpy rng state
rides the lease), within the port and across the two packages in both
directions. A lease's pages cross byte for byte; the port's own export
of a prompt matches the JAX export within atol 2e-5, rtol 2e-4 (float32
on both sides, sums in another order). Migration offers, acks and
resumes, and the ``serving.kv.migrate`` chaos site, follow the JAX
package's tests (tests/test_disagg.py).
"""

import base64
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu import NeuralNetConfiguration
from deeplearning4j_tpu.models.paged_kv import parse_lease as jax_parse
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                               RnnOutputLayer,
                                               TransformerEncoderLayer)
from deeplearning4j_tpu.serving import ContinuousBatcher as JaxBatcher
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.models.paged_kv import parse_lease
from deeplearning4j_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                         MigrationOffer)
from deeplearning4j_tpu_torch.serving.errors import (KVLeaseCorruptError,
                                                     ServingError)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, D, L, H, CAP, PS = 64, 32, 2, 4, 64, 4
ATOL, RTOL = 2e-5, 2e-4
TIME_LIMIT_S = 120
PROMPT = np.random.default_rng(7).integers(1, V, 11).tolist()


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: SIGALRM fails it past TIME_LIMIT_S."""
    def expire(*_):
        raise TimeoutError(f"test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    chaos.uninstall()


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(jax net, port net, zip path) of the small LM."""
    b = (NeuralNetConfiguration.builder().set_seed(0).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, CAP)).build())
    jnet = JaxNet(conf).init()
    path = str(tmp_path_factory.mktemp("disagg") / "lm.zip")
    jser.write_model(jnet, path)
    return jnet, restore_model(path, device="cpu"), path


def _batcher(net, name, slots=2, delay=0.0):
    b = ContinuousBatcher(net, slots=slots, capacity=CAP, kv_mode="paged",
                          page_size=PS, name=name)
    if delay:
        step = b.session.step_slots

        def slow(x, active):
            time.sleep(delay)
            return step(x, active)

        b.session.step_slots = slow
    return b


def _jax_batcher(jnet, name):
    return JaxBatcher(jnet, slots=2, capacity=CAP, kv_mode="paged",
                      page_size=PS, name=name)


def _ids(x):
    return np.asarray(x).tolist()


@pytest.fixture(scope="module")
def whole(lm):
    """Whole-run ids on one JAX batcher: greedy at 12 and 40 tokens, and
    12 at temperature 0.8, seed 42."""
    jnet = lm[0]
    cb = _jax_batcher(jnet, "whole")
    try:
        return {"greedy12": _ids(cb.generate(PROMPT, 12)),
                "greedy40": _ids(cb.generate(PROMPT, 40)),
                "temp12": _ids(cb.generate(PROMPT, 12, temperature=0.8,
                                           seed=42))}
    finally:
        cb.shutdown(drain=False)


# ---------------------------------------------------------------- batchers

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_split_equals_whole_in_port(lm, temperature):
    net = lm[1]
    a, b, c = (_batcher(net, n) for n in ("pA", "pB", "pC"))
    try:
        ref = _ids(c.generate(PROMPT, 12, temperature=temperature, seed=42))
        blob = a.prefill_export(PROMPT, 12, temperature=temperature,
                                seed=42)
        assert isinstance(blob, bytes)
        ids = _ids(b.wait(b.import_stream(blob)))
        assert ids == ref
        assert a._kv_exports.value == 1 and b._kv_imports.value == 1
        # the exporter donated the written prompt pages to its prefix
        # cache, and the importer's pages come back to its cache too
        assert a.session.prefix_cache.fingerprints()
    finally:
        for x in (a, b, c):
            x.shutdown(drain=False)


def test_split_ids_equal_jax_whole_run(lm, whole):
    net = lm[1]
    a, b = _batcher(net, "gA"), _batcher(net, "gB")
    try:
        ids = _ids(b.wait(b.import_stream(a.prefill_export(PROMPT, 12))))
        assert ids == whole["greedy12"]
        ids = _ids(b.wait(b.import_stream(a.prefill_export(
            PROMPT, 12, temperature=0.8, seed=42))))
        assert ids == whole["temp12"]
    finally:
        a.shutdown(drain=False)
        b.shutdown(drain=False)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lease_crosses_packages(lm, whole, direction, temperature):
    jnet, net, _ = lm
    jb, pb = _jax_batcher(jnet, "jx"), _batcher(net, "px")
    exporter, importer = (jb, pb) if direction == "jax_to_port" \
        else (pb, jb)
    try:
        blob = exporter.prefill_export(PROMPT, 12, temperature=temperature,
                                       seed=42)
        ids = _ids(importer.wait(importer.import_stream(blob)))
        assert ids == whole["temp12" if temperature else "greedy12"]
    finally:
        jb.shutdown(drain=False)
        pb.shutdown(drain=False)


def test_imported_pages_equal_jax_bytes(lm):
    jnet, net, _ = lm
    jb, pb = _jax_batcher(jnet, "jbytes"), _batcher(net, "pbytes")
    try:
        jblob = jb.prefill_export(PROMPT, 12)
        pblob = pb.prefill_export(PROMPT, 12)
    finally:
        jb.shutdown(drain=False)
        pb.shutdown(drain=False)
    jhdr, jpay = jax_parse(jblob)
    # rebuilt into a port pool, the pages hold the JAX bytes exactly
    sess = net.paged_slot_streaming_session(capacity=CAP, slots=2,
                                            page_size=PS)
    lease, extra = sess.import_lease(jblob, len(PROMPT) + 12)
    sess.bind(1, lease)
    rhdr, rpay = parse_lease(sess.export_lease(1, extra=extra))
    assert rpay == jpay and rhdr == jhdr
    # the port's own export of the same prompt: the same header but the
    # CRC, the payload within float32 tolerance
    phdr, ppay = parse_lease(pblob)
    assert {k: v for k, v in phdr.items() if k != "payload_crc"} == \
        {k: v for k, v in jhdr.items() if k != "payload_crc"}
    np.testing.assert_allclose(np.frombuffer(ppay, np.float32),
                               np.frombuffer(jpay, np.float32),
                               atol=ATOL, rtol=RTOL)


def test_prefill_export_needs_paged(lm):
    dense = ContinuousBatcher(lm[1], slots=2, capacity=CAP,
                              kv_mode="dense", name="dense")
    try:
        with pytest.raises(ServingError):
            dense.prefill_export(PROMPT, 4)
        assert dense.request_migration() == 0
        assert dense.prefix_digest() is None
    finally:
        dense.shutdown(drain=False)


def _offer(batcher, n_tokens=40, after=3):
    """Start a stream, wait until it has emitted ``after`` tokens, arm
    migration and return the offer it completes with."""
    req = batcher.submit(PROMPT, n_tokens)
    t_end = time.monotonic() + 30
    while not any(s is not None and len(s.out) >= after
                  for s in batcher._slots):
        assert time.monotonic() < t_end, "stream never started decoding"
        time.sleep(0.005)
    assert batcher.request_migration() == 1
    offer = batcher.wait(req)
    assert isinstance(offer, MigrationOffer)
    assert offer.tokens_out >= after and offer.pos >= len(PROMPT)
    return offer


def _wait_pages(batcher, n):
    t_end = time.monotonic() + 10
    while batcher.session.pages_in_use() != n:
        assert time.monotonic() < t_end, batcher.session.pages_in_use()
        time.sleep(0.005)


def test_migration_offer_import_and_ack_free_the_pages(lm, whole):
    net = lm[1]
    a, b = _batcher(net, "mA", delay=0.01), _batcher(net, "mB")
    try:
        offer = _offer(a)
        assert a.has_migration(offer.handle)
        assert a.slots_debug()[0]["state"] == "parked"
        held = a.session.pages_in_use()
        assert held > 0                      # the parked slot keeps them
        ids = _ids(b.wait(b.import_stream(offer.blob)))
        assert ids == whole["greedy40"]
        assert a.ack_migration(offer.handle)
        assert not a.ack_migration(offer.handle)     # claimed once
        _wait_pages(a, 0)
        assert a._kv_exports.value == 1 and b._kv_imports.value == 1
    finally:
        a.shutdown(drain=False)
        b.shutdown(drain=False)


def test_resume_finishes_the_stream_in_place(lm, whole):
    a = _batcher(lm[1], "rA", delay=0.01)
    try:
        offer = _offer(a)
        ids = _ids(a.resume_stream(offer.handle))
        assert ids == whole["greedy40"]
        with pytest.raises(ValueError):
            a.resume_stream(offer.handle)
    finally:
        a.shutdown(drain=False)


def test_unclaimed_offer_resumes_after_the_failsafe(lm):
    a = _batcher(lm[1], "fA", delay=0.01)
    a.migrate_resume_timeout_s = 0.2
    try:
        offer = _offer(a, n_tokens=20)
        t_end = time.monotonic() + 30
        while a.active_slots():
            assert time.monotonic() < t_end
            time.sleep(0.01)
        assert not a.has_migration(offer.handle)
    finally:
        a.shutdown(drain=False)


def test_migrate_chaos_error_keeps_the_stream(lm, whole):
    """serving.kv.migrate error: the export fails, no offer is made, and
    the stream finishes on the incumbent."""
    a = _batcher(lm[1], "eA", delay=0.01)
    try:
        req = a.submit(PROMPT, 40)
        while not any(s is not None and s.out for s in a._slots):
            time.sleep(0.005)
        chaos.install({"faults": [{"site": "serving.kv.migrate",
                                   "kind": "error", "p": 1.0}]}, seed=5)
        a.request_migration()
        assert _ids(a.wait(req)) == whole["greedy40"]
        assert a._kv_exports.value == 0
    finally:
        a.shutdown(drain=False)


# ------------------------------------------------------------------- HTTP

def _post(port, path, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def servers(lm):
    """Two port servers on one zip (a prefill and a decode side)."""
    built = []
    for _ in range(2):
        reg = ModelRegistry()
        reg.register("lm", restore_model(lm[2], device="cpu"))
        built.append(ModelServer(reg, slots=2, capacity=CAP,
                                 page_size=PS).start())
    yield built
    for s in built:
        s.stop(drain=False, timeout=2.0)


def test_http_export_import_and_prefixes(servers, whole):
    pre, dec = servers
    code, out = _post(pre.port, "/v1/kv/export",
                      {"model": "lm", "prompt": PROMPT, "n_tokens": 12})
    assert code == 200 and out["model_version"] == 1
    code, got = _post(dec.port, "/v1/kv/import", {"blob": out["blob"]})
    assert (code, got["ids"]) == (200, whole["greedy12"])
    with urllib.request.urlopen(
            f"http://127.0.0.1:{pre.port}/v1/kv/prefixes", timeout=10) as r:
        ad = json.loads(r.read())
    assert ad["page_size"] == PS and ad["prefixes"]
    with urllib.request.urlopen(
            f"http://127.0.0.1:{pre.port}/debug/modules", timeout=10) as r:
        mods = json.loads(r.read())
    assert mods["deeplearning4j_tpu_torch"] and "jax" in mods


def test_http_corrupt_blob_is_422(servers):
    """serving.kv.migrate corrupt flips a byte after the CRC: the import
    fails typed (422), and so does a blob that is not base64."""
    pre, dec = servers
    _, out = _post(pre.port, "/v1/kv/export",
                   {"model": "lm", "prompt": PROMPT, "n_tokens": 12})
    chaos.install({"faults": [{"site": "serving.kv.migrate",
                               "kind": "corrupt", "p": 1.0}]}, seed=3)
    code, err = _post(dec.port, "/v1/kv/import", {"blob": out["blob"]})
    assert code == 422 and "trace_id" in err
    chaos.uninstall()
    assert _post(dec.port, "/v1/kv/import", {"blob": "@@"})[0] == 422
    bad = bytearray(base64.b64decode(out["blob"]))
    bad[-10] ^= 0xFF
    with pytest.raises(KVLeaseCorruptError):
        dec.batcher_for("lm")[0].import_stream(bytes(bad))


def test_http_drain_control_plane(servers, whole):
    """/v1/kv/migrate turns a live /v1/generate into a 202 offer; a
    survivor imports it and /v1/kv/ack frees the pages; the control
    plane answers while the incumbent drains."""
    old, new = servers
    b, _ = old.batcher_for("lm")
    step = b.session.step_slots
    b.session.step_slots = lambda x, a: (time.sleep(0.01), step(x, a))[1]
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("r", _post(
        old.port, "/v1/generate",
        {"model": "lm", "prompt": PROMPT, "n_tokens": 40})))
    t.start()
    t_end = time.monotonic() + 30
    while not any(s is not None and len(s.out) >= 3 for s in b._slots):
        assert time.monotonic() < t_end
        time.sleep(0.005)
    assert _post(old.port, "/v1/kv/migrate", {}) == (200, {"parked": 1})
    t.join(30)
    code, offer = res["r"]
    assert code == 202 and offer["migration"]["model_version"] == 1
    mig = offer["migration"]
    code, got = _post(new.port, "/v1/kv/import", {"blob": mig["blob"]})
    assert (code, got["ids"]) == (200, whole["greedy40"])
    stopper = threading.Thread(target=old.stop, kwargs={"timeout": 20})
    stopper.start()                 # draining: only the control plane
    assert _post(old.port, "/v1/kv/ack", {"handle": mig["handle"]}) == \
        (200, {"acked": True})
    assert _post(old.port, "/v1/kv/resume", {"handle": mig["handle"]})[0] \
        == 404
    stopper.join(30)
    assert b.session.pages_in_use() == 0
