"""The port's asynchronous parameter server against the JAX package's,
on the CPU.

- Frames: a port frame is byte for byte the JAX frame for the same
  header and payload, and each package's ``read_frame`` reads the
  other's; the JAX suite's CRC, truncation, magic, header-bound and
  fuzz cases run on the port.
- Server and worker: the port's counterparts of the JAX suite's server
  ops, worker churn, durable restart, chaos drills and in-process
  training (``tests/test_paramserver.py``), at its sizes. They assert
  the loss target and the push accounting, never a time.
- Across the packages: a JAX ``PSWorker`` against a port
  ``ParameterServer`` and a port ``PSWorker`` against a JAX server, one
  worker at max_staleness 0, each held to the all-JAX run within
  ``lr * scale`` per element (``scale`` the leaf's largest pushed
  quantum: gradients that differ by float32 rounding can move one int8
  code by one at a rounding boundary, and error feedback carries that
  quantum into a later push); each server's durable generation restores
  in the other.
- The slice: a 2-layer narrow transformer LM trained through a port PS
  worker against a port server, held against the same through JAX.
- The ``train-ps`` verb: its flags against the JAX verb's, and a
  launcher run with 2 CPU workers.
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import chaos as jchaos
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.parallel import paramserver as jps
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.parallel.paramserver import (
    ParameterServer, PSClient, PSFrameError, PSProtocolError,
    PSTimeoutError, PSWorker, StalenessExceededError, pack_frame,
    read_frame, run_async_training)
from deeplearning4j_tpu_torch.util import model_serializer as tser
from fixtures import tiny_classifier

pytestmark = pytest.mark.ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    chaos.uninstall()
    jchaos.uninstall()


def _tiny_params():
    return {"w": np.ones((3, 2), np.float32),
            "b": np.zeros((2,), np.float32)}


def _tiny(seed=0, n_in=4, n_out=3, hidden=8):
    """The port's counterpart of the JAX suite's ``tiny_classifier``: a
    2-layer MLP on the CPU."""
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": seed},
           "input_type": {"kind": "ff", "size": n_in},
           "layers": [{"@type": "DenseLayer", "n_out": hidden,
                       "activation": "relu"},
                      {"@type": "OutputLayer", "n_out": n_out}],
           "preprocessors": {}}
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device="cpu").init()


def _noise_batches(n_batches, batch=8, n_in=4, n_out=3, seed=0):
    """``fixtures.make_batches``' data as port DataSets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(batch, n_in)).astype(np.float32)
        y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, batch)]
        out.append(DataSet(x, y))
    return out


def _clustered(n_batches, batch=8, seed=0):
    """Learnable 3-class data (cluster-shifted gaussians) as numpy
    (x, y) pairs, for either package's DataSet."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        c = rng.integers(0, 3, batch)
        x = (rng.normal(size=(batch, 4)) + c[:, None] * 1.5).astype(
            np.float32)
        out.append((x, np.eye(3, dtype=np.float32)[c]))
    return out


def _eval_loss(model, batches):
    with torch.no_grad():
        return float(np.mean([
            float(model._loss(model._batch_tuple(ds), training=False)[0])
            for ds in batches]))


def _sgd_baseline(model, batches, lr, epochs):
    """Plain synchronous SGD over exact gradients, in place."""
    for _ in range(epochs):
        for ds in batches:
            _, grads, _ = model._gradients(model._batch_tuple(ds))
            with torch.no_grad():
                new = [{k: p - lr * g[k] for k, p in layer.items()}
                       for layer, g in zip(model.params, grads)]
            model.set_params(new)


# ---------------------------------------------------------------------------
# wire framing
# ---------------------------------------------------------------------------

_HEADERS = [
    ({"op": "pull"}, b""),
    ({"op": "push", "seq": 7, "worker_id": "w3", "base_version": 12,
      "leaves": [{"shape": [3, 2], "scale": 0.0123456789},
                 {"shape": [], "scale": 1.0}]}, bytes(range(7))),
    ({"op": "hello", "worker_id": "wörker-∆", "nested": {"a": [1, 2.5,
                                                              None]}},
     b"\x00\xff" * 33),
    ({"op": "error", "error": "StalenessExceededError",
      "message": "push base version 3 trails", "max_staleness": None,
      "base_version": 3, "server_version": 9}, b""),
]


def _roundtrip(raw, reader=read_frame):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)   # sender done (or dead)
        b.settimeout(0.5)
        return reader(b, deadline=time.monotonic() + 2.0)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", range(len(_HEADERS)))
def test_pack_frame_byte_equal_to_jax(case):
    header, payload = _HEADERS[case]
    assert pack_frame(header, payload) == jps.pack_frame(header, payload)


@pytest.mark.parametrize("case", range(len(_HEADERS)))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_others_frames(direction, case):
    header, payload = _HEADERS[case]
    if direction == "jax_to_port":
        raw, reader = jps.pack_frame(header, payload), read_frame
    else:
        raw, reader = pack_frame(header, payload), jps.read_frame
    got_header, got_payload = _roundtrip(raw, reader)
    assert got_payload == payload
    assert got_header == dict(header, payload_len=len(payload))


class TestWireFrames:
    def test_frame_round_trip(self):
        hdr, payload = _roundtrip(
            pack_frame({"op": "push", "seq": 7}, b"\x01\x02\x03"))
        assert hdr["op"] == "push" and hdr["seq"] == 7
        assert payload == b"\x01\x02\x03"

    def test_bit_flip_anywhere_fails_crc(self):
        raw = bytearray(pack_frame({"op": "pull"}, b"payload-bytes"))
        for pos in (6, len(raw) // 2, len(raw) - 6):
            bad = bytearray(raw)
            bad[pos] ^= 0x40
            with pytest.raises(PSFrameError):
                _roundtrip(bytes(bad))

    def test_truncation_mid_frame_fails_typed(self):
        raw = pack_frame({"op": "push"}, b"x" * 64)
        with pytest.raises(PSFrameError, match="short of a complete"):
            _roundtrip(raw[:len(raw) - 10])

    def test_bad_magic_rejected(self):
        raw = b"NOPE" + pack_frame({"op": "pull"})[4:]
        with pytest.raises(PSFrameError, match="magic"):
            _roundtrip(raw)

    def test_insane_header_length_bounded(self):
        raw = b"DPS1" + struct.pack("<I", 1 << 24) + b"{}"
        with pytest.raises(PSFrameError, match="sanity bound"):
            _roundtrip(raw)

    def test_non_object_header_and_bad_payload_len_typed(self):
        for hdr in (b"[1, 2]", b'{"payload_len": "x"}',
                    b'{"payload_len": -3}', b"\xff\xfe"):
            raw = b"DPS1" + struct.pack("<I", len(hdr)) + hdr
            with pytest.raises(PSFrameError):
                _roundtrip(raw + b"\x00" * 4)


class TestWireFuzz:
    """Seeded random corruption and truncation of valid DPS1 frames
    against a LIVE port server: every mutation comes back typed (or as
    a typed error reply, or a dropped connection), and the server keeps
    serving afterwards."""

    _TYPED = (PSFrameError, PSProtocolError, PSTimeoutError, OSError)

    def _mutations(self, rng, n):
        base = [
            pack_frame({"op": "hello", "worker": "fuzz"}),
            pack_frame({"op": "pull", "worker_id": "w0"}),
            pack_frame({"op": "push", "worker_id": "w0", "seq": 1,
                        "base_version": 0,
                        "leaves": [{"shape": [64], "scale": 1.0}]},
                       b"\x01" * 64),
            pack_frame({"op": "hb", "worker_id": "w0"}),
        ]
        for _ in range(n):
            raw = bytearray(base[int(rng.integers(len(base)))])
            if rng.random() < 0.5:
                for _ in range(int(rng.integers(1, 5))):
                    pos = int(rng.integers(len(raw)))
                    raw[pos] ^= int(rng.integers(1, 256))
            else:
                raw = raw[:int(rng.integers(len(raw)))]
            yield bytes(raw)

    @pytest.mark.filterwarnings(
        "error::pytest.PytestUnhandledThreadExceptionWarning")
    def test_fuzzed_frames_never_kill_the_server(self):
        server = ParameterServer(_tiny_params(), lr=0.5,
                                 heartbeat_timeout_s=30.0).start()
        rng = np.random.default_rng(0xD151)
        try:
            for raw in self._mutations(rng, 80):
                with socket.create_connection(server.address,
                                              timeout=2.0) as s:
                    try:
                        s.sendall(raw)
                        s.shutdown(socket.SHUT_WR)
                        hdr, _ = read_frame(
                            s, deadline=time.monotonic() + 1.0)
                    except self._TYPED:
                        continue
                    if hdr.get("op") == "error":
                        assert hdr["error"].startswith("PS") \
                            or hdr["error"].endswith("Error")
            c = PSClient(server.address)
            try:
                leaves, version = c.pull()
                assert len(leaves) == 2 and version == 0
            finally:
                c.close()
            assert server.stats["restarts"] == 0
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# server ops over a live socket
# ---------------------------------------------------------------------------

class TestServerOps:
    @pytest.fixture()
    def server(self):
        s = ParameterServer(_tiny_params(), lr=0.5,
                            heartbeat_timeout_s=30.0).start()
        yield s
        s.stop()

    def test_hello_assigns_ids_and_pull_returns_params(self, server):
        c = PSClient(server.address)
        try:
            leaves, version = c.pull()
            assert version == 0
            assert c.worker_id == "w0"
            # jax.tree_util leaf order: dict keys sorted -> b then w
            np.testing.assert_array_equal(leaves[0],
                                          np.zeros((2,), np.float32))
            np.testing.assert_array_equal(leaves[1],
                                          np.ones((3, 2), np.float32))
        finally:
            c.close()

    def test_push_applies_sgd_update(self, server):
        c = PSClient(server.address)
        try:
            _, version = c.pull()
            q = [np.full((2,), 10, np.int8), np.full((3, 2), -20, np.int8)]
            ack = c.push([(q[0], 0.1), (q[1], 0.05)], version)
            assert ack["applied"] is True and ack["version"] == 1
            got = server.params_tree()
            assert isinstance(got["b"], torch.Tensor)
            # b: 0 - 0.5*(10*0.1) = -0.5 ; w: 1 - 0.5*(-20*0.05) = 1.5
            np.testing.assert_allclose(got["b"].numpy(), -0.5, atol=1e-6)
            np.testing.assert_allclose(got["w"].numpy(), 1.5, atol=1e-6)
        finally:
            c.close()

    def test_duplicate_seq_discarded_idempotently(self, server):
        c = PSClient(server.address)
        try:
            _, version = c.pull()
            q = [(np.ones((2,), np.int8), 1.0),
                 (np.ones((3, 2), np.int8), 1.0)]
            c.push(q, version)
            before = server.params_tree()
            c._seq -= 1             # simulate a retry after a lost ack
            ack = c.push(q, version)
            assert ack.get("duplicate") is True
            assert ack["applied"] is False
            assert server.version == 1          # applied exactly once
            assert server.stats["pushes_duplicate"] == 1
            np.testing.assert_array_equal(before["w"].numpy(),
                                          server.params_tree()["w"].numpy())
        finally:
            c.close()

    def test_bounded_staleness_refusal_is_typed(self):
        server = ParameterServer(_tiny_params(), lr=0.1, max_staleness=1,
                                 heartbeat_timeout_s=30.0).start()
        a, b = PSClient(server.address), PSClient(server.address)
        try:
            _, va = a.pull()
            _, vb = b.pull()
            q = [(np.ones((2,), np.int8), 0.1),
                 (np.ones((3, 2), np.int8), 0.1)]
            a.push(q, va)                  # v1
            a.push(q, a.server_version)    # v2: b is now 2 behind
            with pytest.raises(StalenessExceededError) as ei:
                b.push(q, vb)
            assert ei.value.base_version == 0
            assert ei.value.server_version == 2
            assert ei.value.max_staleness == 1
            _, vb = b.pull()               # a fresh pull unblocks it
            assert b.push(q, vb)["applied"] is True
        finally:
            a.close()
            b.close()
            server.stop()

    def test_leaf_count_mismatch_is_protocol_error(self, server):
        c = PSClient(server.address)
        try:
            _, version = c.pull()
            with pytest.raises(PSProtocolError, match="leaves"):
                c.push([(np.ones((2,), np.int8), 0.1)], version)
        finally:
            c.close()

    def test_leaf_shape_mismatch_is_protocol_error(self, server):
        c = PSClient(server.address)
        try:
            _, version = c.pull()
            with pytest.raises(PSProtocolError, match="shape"):
                c.push([(np.ones((2,), np.int8), 0.1),
                        (np.ones((2, 3), np.int8), 0.1)], version)
        finally:
            c.close()

    def test_unknown_op_is_protocol_error(self, server):
        c = PSClient(server.address)
        try:
            with pytest.raises(PSProtocolError, match="unknown op"):
                c._request({"op": "frobnicate"})
        finally:
            c.close()

    def test_version_vector_tracks_workers(self, server):
        a, b = PSClient(server.address), PSClient(server.address)
        try:
            a.pull()
            b.pull()
            vv = server.worker_versions()
            assert set(vv) == {"w0", "w1"}
            assert all(v == 0 for v in vv.values())
        finally:
            a.close()
            b.close()

    def test_wait_version_and_counters(self, server):
        from deeplearning4j_tpu_torch.observability.registry import REGISTRY

        def applied():
            return REGISTRY.snapshot().get("ps_pushes_applied_total", 0.0)

        before = applied()
        c = PSClient(server.address)
        try:
            _, version = c.pull()
            assert server.wait_version(1, timeout=0.05) is False
            c.push([(np.ones((2,), np.int8), 0.1),
                    (np.ones((3, 2), np.int8), 0.1)], version)
            assert server.wait_version(1, timeout=5.0) is True
        finally:
            c.close()
        assert applied() == before + 1


# ---------------------------------------------------------------------------
# churn: heartbeats, the reaper, replacement workers
# ---------------------------------------------------------------------------

class TestWorkerChurn:
    def test_silent_worker_reaped_and_replacement_joins(self):
        server = ParameterServer(_tiny_params(),
                                 heartbeat_timeout_s=0.3).start()
        try:
            dead = PSClient(server.address)
            dead.pull()
            assert server.live_workers() == ["w0"]
            dead._drop()            # vanish without a bye (SIGKILL)
            deadline = time.monotonic() + 5.0
            while server.live_workers() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert server.live_workers() == []
            assert server.stats["workers_reaped"] == 1
            repl = PSClient(server.address)
            try:
                leaves, _ = repl.pull()
                assert len(leaves) == 2
            finally:
                repl.close()
        finally:
            server.stop()

    def test_bye_deregisters_without_reap(self):
        server = ParameterServer(_tiny_params(),
                                 heartbeat_timeout_s=0.3).start()
        try:
            c = PSClient(server.address)
            c.pull()
            c.close()               # polite exit
            deadline = time.monotonic() + 5.0
            while server.live_workers() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert server.live_workers() == []
            assert server.stats["workers_reaped"] == 0
        finally:
            server.stop()

    def test_worker_heartbeats_keep_it_live(self):
        """A worker's heartbeat thread refreshes membership while it
        trains slower than the reaper's timeout."""
        server = ParameterServer(_tiny(0).params, lr=0.1,
                                 heartbeat_timeout_s=0.4).start()
        model = _tiny(0)
        slow = _noise_batches(3)
        real = model._gradients

        def slow_grads(batch, carries=None):
            time.sleep(0.5)
            return real(batch, carries)

        model._gradients = slow_grads
        c = PSClient(server.address)
        try:
            stats = PSWorker(model, c, heartbeat_s=0.05).run(slow)
            assert stats["steps"] == 3
            assert server.stats["workers_reaped"] == 0
        finally:
            c.close()
            server.stop()


# ---------------------------------------------------------------------------
# durable generations + crash-restart
# ---------------------------------------------------------------------------

class TestDurableRestart:
    def _push_n(self, client, n):
        client.pull()                    # learn the base version
        q = [(np.ones((2,), np.int8), 0.01),
             (np.ones((3, 2), np.int8), 0.01)]
        for _ in range(n):
            client.push(q, client.server_version)

    def test_new_server_resumes_from_newest_generation(self, tmp_path):
        d = str(tmp_path / "ckpts")
        server = ParameterServer(_tiny_params(), lr=0.1, checkpoint_dir=d,
                                 save_every=2).start()
        c = PSClient(server.address)
        self._push_n(c, 5)
        c.close()
        server.stop()               # final durable write at v5
        expect = server.params_tree()
        resumed = ParameterServer(_tiny_params(), lr=0.1,
                                  checkpoint_dir=d, save_every=2)
        assert resumed.version == 5
        np.testing.assert_array_equal(resumed.params_tree()["w"].numpy(),
                                      expect["w"].numpy())
        assert server.stats["checkpoints"] >= 2

    def test_corrupt_newest_generation_quarantined(self, tmp_path):
        d = str(tmp_path / "ckpts")
        server = ParameterServer(_tiny_params(), lr=0.1, checkpoint_dir=d,
                                 save_every=2).start()
        c = PSClient(server.address)
        self._push_n(c, 4)
        c.close()
        server.stop()
        zips = sorted(f for f in os.listdir(d) if f.endswith(".zip"))
        newest = os.path.join(d, zips[-1])
        with open(newest, "r+b") as f:   # flip a payload bit
            f.seek(200)
            b = f.read(1)
            f.seek(200)
            f.write(bytes([b[0] ^ 0xFF]))
        resumed = ParameterServer(_tiny_params(), lr=0.1,
                                  checkpoint_dir=d, save_every=2)
        assert resumed.version < 4           # fell back a generation
        assert any(f.endswith(".corrupt") for f in os.listdir(d))

    def test_push_ahead_of_restarted_server_refused_typed(self, tmp_path):
        d = str(tmp_path / "ckpts")
        server = ParameterServer(_tiny_params(), lr=0.1, checkpoint_dir=d,
                                 save_every=100).start()
        c = PSClient(server.address)
        try:
            self._push_n(c, 3)               # v3, nothing durable yet
            server._restart_req.set()        # crash-restart drill
            deadline = time.monotonic() + 5.0
            while server.version != 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert server.version == 0       # rolled back (no ckpt)
            q = [(np.ones((2,), np.int8), 0.01),
                 (np.ones((3, 2), np.int8), 0.01)]
            with pytest.raises(StalenessExceededError,
                               match="ahead of the server"):
                c.push(q, 3)
            _, v = c.pull()
            assert v == 0
            assert c.push(q, v)["applied"] is True
        finally:
            c.close()
            server.stop()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_generation_restores_in_the_other_package(self, tmp_path,
                                                      writer):
        d = str(tmp_path / "ckpts")
        make = ParameterServer if writer == "port" else jps.ParameterServer
        client = PSClient if writer == "port" else jps.PSClient
        server = make(_tiny_params(), lr=0.1, checkpoint_dir=d,
                      save_every=2).start()
        c = client(server.address)
        c.pull()
        q = [(np.full((2,), 3, np.int8), 0.02),
             (np.full((3, 2), -5, np.int8), 0.03)]
        for _ in range(3):
            c.push(q, c.server_version)
        c.close()
        server.stop()
        want = [np.array(a) for a in server._leaves]
        other = (jps.ParameterServer if writer == "port"
                 else ParameterServer)(_tiny_params(), checkpoint_dir=d)
        assert other.version == 3
        for got, w in zip(other._leaves, want):
            np.testing.assert_array_equal(got, w)


# ---------------------------------------------------------------------------
# chaos drills
# ---------------------------------------------------------------------------

class TestChaosDrills:
    def test_push_drop_retried_and_applied_exactly_once(self):
        chaos.install({"faults": [{"site": "ps.push.drop", "kind": "drop",
                                   "at": [1]}]}, seed=0)
        server = ParameterServer(_tiny_params(), lr=0.1,
                                 heartbeat_timeout_s=30.0).start()
        c = PSClient(server.address, op_timeout_s=0.4)
        try:
            _, version = c.pull()
            q = [(np.ones((2,), np.int8), 0.1),
                 (np.ones((3, 2), np.int8), 0.1)]
            ack = c.push(q, version)         # dropped once, retried
            assert ack["applied"] is True
            assert server.version == 1       # exactly once
            assert server.stats["pushes_applied"] == 1
            assert server.stats["pushes_duplicate"] == 0
            assert chaos.current().fired_total == 1
            assert chaos.current().counts()["ps.push.drop"] == 2
        finally:
            c.close()
            server.stop()

    def test_pull_timeout_retried(self):
        chaos.install({"faults": [{"site": "ps.pull.timeout",
                                   "kind": "timeout", "at": [1]}]}, seed=0)
        server = ParameterServer(_tiny_params(),
                                 heartbeat_timeout_s=30.0).start()
        c = PSClient(server.address, op_timeout_s=0.4)
        try:
            leaves, version = c.pull()       # reply swallowed once
            assert version == 0 and len(leaves) == 2
            assert server.stats["pulls"] == 1
        finally:
            c.close()
            server.stop()

    def test_server_restart_mid_training_recovers(self, tmp_path):
        """Restart the server after the 6th applied push: the run
        completes, versions rolled back to a durable generation, and
        the workers' ahead pushes were refused typed and refolded."""
        chaos.install({"faults": [{"site": "ps.server.restart",
                                   "kind": "restart", "at": [6]}]}, seed=0)
        batches = _noise_batches(8, batch=8)
        model, sstats, wstats = run_async_training(
            _tiny, batches, n_workers=2, epochs=4, lr=0.2,
            max_staleness=None, checkpoint_dir=str(tmp_path / "ck"),
            save_every=4)
        assert sstats["restarts"] == 1
        assert sstats["pushes_applied"] > 6  # kept training after
        total_steps = sum(w["steps"] for w in wstats)
        assert total_steps == 2 * 4 * 4      # nobody lost their loop


# ---------------------------------------------------------------------------
# end-to-end training (in-process)
# ---------------------------------------------------------------------------

class TestAsyncTraining:
    def test_three_workers_reach_sync_target(self):
        """The async PS run reaches 80% of the loss drop a synchronous
        SGD loop gets over the same batches at the same rate (int8+EF
        compression and staleness included)."""
        batches = [DataSet(x, y) for x, y in _clustered(12, batch=8)]
        lr, epochs = 0.2, 8
        sync = _tiny(0)
        init = _eval_loss(sync, batches)
        _sgd_baseline(sync, batches, lr, epochs)
        sync_final = _eval_loss(sync, batches)
        assert sync_final < init             # baseline actually learns

        model, sstats, wstats = run_async_training(
            _tiny, batches, n_workers=3, epochs=epochs, lr=lr,
            max_staleness=4)
        ps_final = _eval_loss(model, batches)
        target = init - 0.8 * (init - sync_final)
        assert ps_final <= target, (
            f"async PS final {ps_final:.4f} vs sync {sync_final:.4f} "
            f"(target {target:.4f}, init {init:.4f})")
        total_steps = sum(w["steps"] for w in wstats)
        assert (sstats["pushes_applied"] + sstats["pushes_stale"]
                == total_steps)

    def test_staleness_zero_forces_fresh_pulls(self):
        batches = _noise_batches(6, batch=8)
        model, sstats, wstats = run_async_training(
            _tiny, batches, n_workers=2, epochs=3, lr=0.1,
            max_staleness=0)
        total_steps = sum(w["steps"] for w in wstats)
        assert total_steps == 2 * 3 * 3
        assert (sstats["pushes_applied"] + sstats["pushes_stale"]
                == total_steps)

    def test_one_device_copy_a_push(self, monkeypatch):
        """The worker reads the codes and scales of a push in one
        device-to-host copy: one ``.cpu()`` of one int8 buffer whose
        tail holds the float32 scales."""
        worker = PSWorker(_tiny(0), client=None)
        _, g_leaves = worker._gradients(_noise_batches(1)[0])
        residual = [torch.zeros_like(g) for g in g_leaves]
        calls = []
        real_cpu = torch.Tensor.cpu

        def counting_cpu(self, *a, **k):
            calls.append((self.dtype, self.numel()))
            return real_cpu(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
        quantized, codes = worker.encode(g_leaves, residual)
        monkeypatch.undo()
        n = sum(g.numel() for g in g_leaves)
        assert calls == [(torch.int8, n + 4 * len(g_leaves))]
        for (q, s), (dq, ds), g in zip(quantized, codes, g_leaves):
            assert q.dtype == np.int8 and q.shape == tuple(g.shape)
            np.testing.assert_array_equal(q, dq.numpy())
            assert s == ds.numpy()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _record_scales(client, into):
    """Wrap ``client.push`` to keep each leaf's largest pushed scale."""
    push = client.push

    def recording(quantized, base_version):
        for i, (_, s) in enumerate(quantized):
            into[i] = max(into.get(i, 0.0), float(s))
        return push(quantized, base_version)

    client.push = recording


def _one_worker_run(server_pkg, worker_pkg, jax_model, port_model,
                    batches_np, lr, scales, steps=None):
    """One worker at max_staleness 0 over ``batches_np``; returns the
    server's final leaves."""
    make_server = (jps.ParameterServer if server_pkg == "jax"
                   else ParameterServer)
    server = make_server(jax_model.params, lr=lr, max_staleness=0,
                         heartbeat_timeout_s=30.0).start()
    try:
        if worker_pkg == "jax":
            client = jps.PSClient(server.address)
            worker = jps.PSWorker(jax_model, client)
            data = [JDataSet(x, y) for x, y in batches_np]
        else:
            client = PSClient(server.address)
            worker = PSWorker(port_model, client)
            data = [DataSet(x, y) for x, y in batches_np]
        _record_scales(client, scales)
        try:
            stats = worker.run(data, max_steps=steps)
        finally:
            client.close()
        assert stats["pushes_applied"] == len(batches_np) \
            and stats["stale_rejects"] == 0
        return [np.array(a) for a in server._leaves]
    finally:
        server.stop()


@pytest.mark.parametrize("mix", ["jax_worker_port_server",
                                 "port_worker_jax_server"])
def test_cross_package_one_worker_within_one_quantum(tmp_path, mix):
    lr = 0.2
    path = str(tmp_path / "m.zip")
    jser.write_model(tiny_classifier(seed=0), path)
    batches = _clustered(12, batch=8)
    ref_scales, mix_scales = {}, {}
    ref = _one_worker_run("jax", "jax", jser.restore_model(path), None,
                          batches, lr, ref_scales)
    server_pkg, worker_pkg = (("port", "jax") if mix.startswith("jax")
                              else ("jax", "port"))
    got = _one_worker_run(server_pkg, worker_pkg, jser.restore_model(path),
                          tser.restore_model(path, device="cpu"), batches,
                          lr, mix_scales)
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = lr * max(ref_scales[i], mix_scales[i])
        np.testing.assert_allclose(g, r, rtol=0, atol=tol,
                                   err_msg=f"leaf {i}")
    if worker_pkg == "jax":
        # the JAX worker's pushes are the all-JAX run's: the port server
        # applied them with the JAX server's arithmetic
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def _jax_lm(V, D, H, T, L):
    from deeplearning4j_tpu import MultiLayerNetwork as JNet
    from deeplearning4j_tpu import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf import updaters as jupd
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import (EmbeddingSequenceLayer,
                                                   RnnOutputLayer,
                                                   TransformerEncoderLayer)
    b = (NeuralNetConfiguration.builder().set_seed(0)
         .updater(jupd.sgd(0.1)).list()
         .layer(EmbeddingSequenceLayer(n_in=V, n_out=D)))
    for _ in range(L):
        b = b.layer(TransformerEncoderLayer(n_heads=H, causal=True))
    conf = (b.layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(JIT.recurrent(V, T)).build())
    return JNet(conf).init()


def test_slice_lm_trains_through_port_ps_like_jax(tmp_path):
    """The slice on the CPU: a 2-layer narrow transformer LM, one port
    PS worker against a port server (the worker's gradient through the
    attention layers' plain path), against the same through JAX."""
    V, D, H, T, B, L, lr, steps = 32, 16, 2, 8, 4, 2, 0.5, 6
    path = str(tmp_path / "lm.zip")
    jser.write_model(_jax_lm(V, D, H, T, L), path)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(steps):
        ids = rng.integers(0, V, (B, T))
        nxt = (ids + 1) % V              # learnable: the next id
        batches.append((ids.astype(np.float32),
                        np.eye(V, dtype=np.float32)[nxt]))
    ref_scales, port_scales = {}, {}
    ref = _one_worker_run("jax", "jax", jser.restore_model(path), None,
                          batches, lr, ref_scales)
    port_model = tser.restore_model(path, device="cpu")
    got = _one_worker_run("port", "port", jser.restore_model(path),
                          port_model, batches, lr, port_scales)
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = lr * max(ref_scales[i], port_scales[i])
        np.testing.assert_allclose(g, r, rtol=0, atol=tol,
                                   err_msg=f"leaf {i}")
    data = [DataSet(x, y) for x, y in batches]
    before = _eval_loss(tser.restore_model(path, device="cpu"), data)
    after = tser.restore_model(path, device="cpu")
    from deeplearning4j_tpu_torch.parallel.paramserver import _unflatten
    after.set_params(_unflatten(after.params, got))
    assert _eval_loss(after, data) < before


# ---------------------------------------------------------------------------
# the train-ps verb
# ---------------------------------------------------------------------------

def _flags(main, capsys):
    with pytest.raises(SystemExit) as ei:
        main(["train-ps", "--help"])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    return {tok.strip("[],") for tok in out.split()
            if tok.startswith(("--", "[--"))}


def test_train_ps_help_has_every_jax_flag(capsys):
    from deeplearning4j_tpu.cli import main as jmain
    from deeplearning4j_tpu_torch.cli import main
    jax_flags = _flags(jmain, capsys)
    port_flags = _flags(main, capsys)
    assert {"--max-staleness", "--push-threshold", "--ps-workers",
            "--role", "--heartbeat-timeout", "--chaos",
            "--net-chaos"} <= jax_flags
    assert port_flags == jax_flags | {"--device"}


def _write_fixtures(tmp_path, rows=96):
    model_zip = str(tmp_path / "m.zip")
    tser.write_model(_tiny(0), model_zip)
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(rows):
        c = int(rng.integers(0, 3))
        x = rng.normal(size=4) + c * 1.5
        lines.append(",".join(f"{v:.4f}" for v in x) + f",{c}")
    csv = str(tmp_path / "d.csv")
    with open(csv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return model_zip, csv


def _csv_batches(csv):
    from deeplearning4j_tpu_torch.data.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    return list(RecordReaderDataSetIterator(
        CSVRecordReader().initialize(csv), 8, label_index=4,
        num_classes=3))


def test_train_ps_launcher_two_cpu_workers(tmp_path):
    model_zip, csv = _write_fixtures(tmp_path)
    out_zip = str(tmp_path / "out.zip")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "train-ps",
         "--model", model_zip, "--data", csv, "--label-index", "4",
         "--classes", "3", "--batch-size", "8", "--epochs", "2",
         "--ps-workers", "2", "--lr", "0.2", "--max-staleness", "4",
         "--save-every", "5", "--output", out_zip, "--device", "cpu",
         "--chaos", '{"faults": [{"site": "ps.push.drop", "kind": '
         '"drop", "at": [3]}]}'],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        out = proc.communicate(timeout=120)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, out
    assert "parameter server on" in out and "chaos: fault plan" in out
    assert out.count("pushes applied") == 3      # 2 workers + summary
    batches = _csv_batches(csv)
    final = tser.restore_model(out_zip, device="cpu")
    fresh = tser.restore_model(model_zip, device="cpu")
    assert _eval_loss(final, batches) < _eval_loss(fresh, batches)
    assert os.listdir(out_zip + ".ps-ckpts")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
class TestMultiProcessSoak:
    def test_sigkill_worker_and_server_training_completes(self, tmp_path):
        """3 worker processes against a server process; SIGKILL worker 0
        mid-run and start a replacement; SIGKILL the server mid-run and
        restart it on the same port + checkpoint dir. Every surviving
        process exits 0 and the final model trains below its starting
        loss; every wait is bounded."""
        model_zip, csv = _write_fixtures(tmp_path)
        port = _free_port()
        ck = str(tmp_path / "ck")
        out_zip = str(tmp_path / "out.zip")
        env = dict(os.environ, PYTHONPATH=REPO)
        base = [sys.executable, "-m", "deeplearning4j_tpu_torch",
                "train-ps", "--model", model_zip, "--data", csv,
                "--label-index", "4", "--classes", "3", "--device", "cpu"]

        def start_server():
            return subprocess.Popen(
                base + ["--role", "server", "--host", "127.0.0.1",
                        "--ps-port", str(port), "--ckpt-dir", ck,
                        "--save-every", "5", "--lr", "0.2",
                        "--heartbeat-timeout", "2.0", "--output",
                        out_zip], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        def start_worker(i):
            return subprocess.Popen(
                base + ["--role", "worker", "--connect",
                        f"127.0.0.1:{port}", "--batch-size", "8",
                        "--epochs", "10", "--worker-index", str(i),
                        "--num-workers", "3", "--op-timeout", "2.0"],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)

        procs = []
        server = start_server()
        procs.append(server)
        try:
            deadline = time.monotonic() + 60
            up = False
            while time.monotonic() < deadline:
                line = server.stdout.readline().decode()
                if "parameter server on" in line:
                    up = True
                    break
                if server.poll() is not None:
                    break
            assert up, "server never came up"
            workers = [start_worker(i) for i in range(3)]
            procs += workers
            time.sleep(8.0)          # let everyone join and push
            workers[0].kill()
            workers[0].wait(timeout=30)
            time.sleep(1.0)
            replacement = start_worker(0)
            procs.append(replacement)
            time.sleep(2.0)
            server.kill()
            server.wait(timeout=30)
            server2 = start_server()
            procs.append(server2)
            for name, p in (("w1", workers[1]), ("w2", workers[2]),
                            ("repl", replacement)):
                try:
                    out, _ = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"{name} hung")
                assert p.returncode == 0, \
                    f"{name} exited {p.returncode}:\n{out.decode()}"
                assert "pushes applied" in out.decode()
            server2.send_signal(signal.SIGINT)
            out2, _ = server2.communicate(timeout=60)
            assert server2.returncode == 0, out2.decode()
            assert os.path.exists(out_zip)
            batches = _csv_batches(csv)
            final = tser.restore_model(out_zip, device="cpu")
            fresh = tser.restore_model(model_zip, device="cpu")
            assert _eval_loss(final, batches) \
                < _eval_loss(fresh, batches) - 0.1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
