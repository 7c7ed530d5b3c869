"""Asynchronous parameter-server training (counterpart of
``deeplearning4j_tpu/parallel/paramserver.py``).

The reference's second distributed-training strategy: asynchronous
compressed gradient sharing over a parameter server (the Aeron
``VoidParameterServer`` of ``nd4j-parameter-server-node``; the
parameter-server architecture of TensorFlow's distributed design,
PAPERS.md 1603.04467 §3). A server task holds the authoritative
parameters; worker tasks pull a (possibly stale) snapshot, compute
gradients locally, and push compressed deltas back, with no global
barrier anywhere.

The wire, the server and its semantics are the JAX package's, so a
worker of either package trains against a server of either package,
and either server's durable generations restore in the other:

- **Wire protocol (DPS1)**: ``magic | u32 header-len | JSON header |
  payload | u32 frame-CRC``. A truncated or bit-flipped frame fails the
  CRC and raises a typed :class:`PSFrameError`; it can never
  half-apply. Server-side refusals travel as ``op: "error"`` frames
  naming the exception class.
- :class:`ParameterServer`: the authoritative float32 leaves on the
  host (numpy, as in the JAX package), pushed int8 deltas applied as
  SGD updates, **bounded staleness** (a push whose ``base_version``
  trails the server by more than ``max_staleness``, or leads it after a
  restart rolled versions back, is refused typed), a per-worker dedupe
  table, a heartbeat reaper, and durable generations through the
  ElasticTrainer's async writer (``train/fault_tolerance.
  CheckpointWriter``) into CRC-manifested zips (``ps_%08d.zip``, leaves
  ``leaf_%04d``, ``ps_version`` in ``metadata.json``); corrupt
  generations are quarantined ``*.corrupt``.
- :class:`PSClient`: reconnecting and deadline-bounded; a retried push
  reuses its sequence number, so the server applies it exactly once.
- :class:`PSWorker`: the gradient from the model's own ``_gradients``
  on the model's device, every leaf quantized there with the int8 +
  error-feedback codec of ``parallel/compression.py``, the codes and
  scales brought to the host in ONE copy a push, a pull applied with
  ``set_params`` on the model's device. A staleness refusal folds the
  refused delta back into the residual before re-pulling.
- :func:`run_async_training`: server + N worker threads in one process;
  ``cli.py train-ps`` runs the multi-process topology.

Leaf order: a tree is visited as ``jax.tree_util`` visits one (list
items in order, dict keys sorted, as ``util/tree.py`` does), so leaf
*i* on the wire is the same parameter in both packages.

Chaos sites (``chaos/injector.py``): ``ps.push.drop`` swallows a
received push unacked (worker deadline, retry, dedupe),
``ps.pull.timeout`` swallows a pull reply (the worker re-pulls),
``ps.server.restart`` crash-restarts the server from its newest durable
generation mid-run (workers reconnect and re-pull).

Every blocking call here (accepts, recvs, waits, joins) carries a
timeout: a dead peer costs a bounded wait, never a wedged thread.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import socket
import struct
import threading
import time
import zipfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.observability.registry import safe_inc
from deeplearning4j_tpu_torch.parallel.compression import int8_quantize_ef
from deeplearning4j_tpu_torch.util.tree import _sorted_leaves as _leaves

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ParameterServer", "PSClient", "PSWorker",
           "run_async_training", "PSError", "PSFrameError",
           "PSProtocolError", "PSTimeoutError", "PSClosedError",
           "StalenessExceededError", "pack_frame", "read_frame"]


# ---------------------------------------------------------------------------
# typed errors (wire-mapped)
# ---------------------------------------------------------------------------

class PSError(RuntimeError):
    """Base class for parameter-server failures. Server-side
    refusals cross the wire as ``op: "error"`` frames naming the
    concrete class, so workers handle types, not strings."""


class PSFrameError(PSError):
    """A frame failed its CRC / magic / length checks: truncated by a
    dying peer or corrupted in flight. Never half-applied."""


class PSProtocolError(PSError):
    """A well-formed frame the receiver cannot honor (unknown op,
    wrong leaf count, unknown worker)."""


class PSTimeoutError(PSError, TimeoutError):
    """A client-side deadline expired waiting for the server."""


class PSClosedError(PSError):
    """The server is stopping and refuses new work."""


class StalenessExceededError(PSError):
    """Bounded-staleness refusal: the push's base version trails the
    server by more than ``max_staleness`` versions (or LEADS it, after
    a server restart rolled back to the last durable generation). The
    worker must pull a fresh snapshot."""

    def __init__(self, msg: str, *, base_version: int = -1,
                 server_version: int = -1,
                 max_staleness: Optional[int] = None):
        super().__init__(msg)
        self.base_version = base_version
        self.server_version = server_version
        self.max_staleness = max_staleness


_WIRE_ERRORS = {cls.__name__: cls for cls in (
    PSError, PSFrameError, PSProtocolError, PSTimeoutError,
    PSClosedError, StalenessExceededError)}


# ---------------------------------------------------------------------------
# wire framing
# ---------------------------------------------------------------------------

_MAGIC = b"DPS1"
_U32 = struct.Struct("<I")
_MAX_HEADER = 1 << 20          # 1 MiB of JSON header is already a bug
_MAX_PAYLOAD = 1 << 31


def pack_frame(header: dict, payload: bytes = b"") -> bytes:
    """``magic | u32 hdr_len | hdr JSON | payload | u32 crc``: the CRC
    covers everything before it, so truncation and corruption both fail
    typed. Byte for byte the JAX package's frame for the same header
    and payload (built with one copy of the payload)."""
    hdr = dict(header)
    hdr["payload_len"] = len(payload)
    raw = json.dumps(hdr, separators=(",", ":")).encode()
    head = _MAGIC + _U32.pack(len(raw)) + raw
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    return b"".join((head, payload, _U32.pack(crc)))


# the most one receive asks for: a multi-MiB pull arrives in as many
# receives as the socket's buffer needs, not one per 64 KiB (each
# receive may wait a GIL switch interval behind a busy worker thread)
_RECV_CHUNK = 16 << 20


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    """Read exactly ``n`` bytes or raise: :class:`PSTimeoutError` at
    the deadline, :class:`PSFrameError` on EOF mid-frame (the
    SIGKILL'd-worker signature). The socket must carry a timeout
    (every caller sets one) so each recv is itself bounded."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None and time.monotonic() > deadline:
            raise PSTimeoutError(
                f"deadline expired {n - got} byte(s) short of a "
                "complete frame")
        try:
            k = sock.recv_into(view[got:], min(n - got, _RECV_CHUNK))
        except socket.timeout:
            continue           # bounded per-recv wait; re-check clock
        if not k:
            raise PSFrameError(
                f"connection closed {n - got} byte(s) short of a "
                "complete frame (peer died mid-send?)")
        got += k
    view.release()
    return bytes(buf)


def read_frame(sock: socket.socket,
               deadline: Optional[float] = None) -> Tuple[dict, bytes]:
    """Read one CRC-framed message; returns ``(header, payload)``.
    Raises :class:`PSFrameError` on any integrity failure."""
    head = _recv_exact(sock, len(_MAGIC) + 4, deadline)
    if head[:len(_MAGIC)] != _MAGIC:
        raise PSFrameError(
            f"bad frame magic {head[:len(_MAGIC)]!r} (expected "
            f"{_MAGIC!r}) — not a PS peer, or a desynced stream")
    (hdr_len,) = _U32.unpack(head[len(_MAGIC):])
    if hdr_len > _MAX_HEADER:
        raise PSFrameError(f"frame header length {hdr_len} exceeds "
                           f"the {_MAX_HEADER} sanity bound")
    raw = _recv_exact(sock, hdr_len, deadline)
    try:
        header = json.loads(raw)
    except ValueError as e:
        # JSONDecodeError and UnicodeDecodeError both: corrupted header
        # bytes must surface typed, not kill the reader
        raise PSFrameError(f"frame header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise PSFrameError("frame header is not a JSON object: "
                           f"{type(header).__name__}")
    try:
        payload_len = int(header.get("payload_len", 0))
    except (TypeError, ValueError) as e:
        raise PSFrameError(f"frame payload length unreadable: "
                           f"{header.get('payload_len')!r}") from e
    if not 0 <= payload_len <= _MAX_PAYLOAD:
        raise PSFrameError(f"frame payload length {payload_len} out "
                           "of bounds")
    payload = _recv_exact(sock, payload_len, deadline)
    (crc,) = _U32.unpack(_recv_exact(sock, 4, deadline))
    computed = zlib.crc32(payload, zlib.crc32(raw, zlib.crc32(head)))
    computed &= 0xFFFFFFFF
    if computed != crc:
        raise PSFrameError(
            f"frame CRC mismatch (stored {crc:#010x}, computed "
            f"{computed:#010x}) — corrupted or truncated in flight")
    return header, payload


def _raise_wire_error(header: dict) -> None:
    """Map an ``op: "error"`` frame back to its typed exception."""
    name = header.get("error", "PSError")
    msg = header.get("message", "parameter-server error")
    cls = _WIRE_ERRORS.get(name, PSError)
    if cls is StalenessExceededError:
        raise StalenessExceededError(
            msg, base_version=int(header.get("base_version", -1)),
            server_version=int(header.get("server_version", -1)),
            max_staleness=header.get("max_staleness"))
    raise cls(msg)


def _error_header(exc: PSError, **extra) -> dict:
    out = {"op": "error", "error": type(exc).__name__,
           "message": str(exc)}
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# leaf (de)serialization
# ---------------------------------------------------------------------------

def _structure(tree):
    """The tree with every leaf replaced by None (the treedef). Leaves
    are visited by ``util/tree._sorted_leaves`` (``jax.tree_util``
    order)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _unflatten(treedef, leaves: Sequence):
    """Inverse of :func:`_flatten`: ``leaves`` (in ``_leaves`` order)
    placed into ``treedef``'s structure (dicts keep its key order)."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return next(it)

    return fill(treedef)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(tree) -> Tuple[List[np.ndarray], object]:
    """``(host leaves in jax.tree_util order, treedef)`` of a params
    tree of tensors or arrays."""
    return [_host(x) for x in _leaves(tree)], _structure(tree)


def _leaf_meta(leaves: Sequence[np.ndarray]) -> List[dict]:
    return [{"shape": list(a.shape), "dtype": str(a.dtype)}
            for a in leaves]


def _concat_bytes(leaves: Sequence[np.ndarray]) -> bytes:
    return b"".join(np.ascontiguousarray(a).tobytes() for a in leaves)


def _split_bytes(payload: bytes, meta: List[dict]) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    off = 0
    payload = memoryview(payload)      # slices without copies
    for m in meta:
        dt = np.dtype(m["dtype"])
        shape = tuple(m["shape"])
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        chunk = payload[off:off + n]
        if len(chunk) != n:
            raise PSFrameError(
                f"payload too short for leaf {m} (need {n} bytes, "
                f"have {len(chunk)})")
        out.append(np.frombuffer(chunk, dtype=dt).reshape(shape).copy())
        off += n
    if off != len(payload):
        raise PSFrameError(f"payload has {len(payload) - off} "
                           "trailing byte(s) beyond the leaf table")
    return out


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

_PS_CKPT_RE = re.compile(r"ps_(\d+)\.zip$")


class ParameterServer:
    """Authoritative float32 parameter store + async SGD applier.

    ``params`` is a params tree (a model's ``.params``: tensors on any
    device, or numpy arrays); the server keeps it as float32 numpy
    leaves on the host and serves them by index. One applied push = one
    version increment; ``max_staleness`` bounds how far behind a push's
    base version may trail (None = unbounded, the classic fully-async
    regime; 0 = every push must be based on the current version).

    With ``checkpoint_dir`` set, every ``save_every`` applied pushes a
    durable generation rides the ElasticTrainer's async-checkpoint
    writer (one in-flight write, newest-wins coalescing); a restart
    (chaos-driven, or a new process pointed at the same directory)
    resumes from the newest generation that passes the CRC manifest.
    """

    def __init__(self, params, *, lr: float = 0.05,
                 max_staleness: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 save_every: int = 50, keep: int = 3,
                 heartbeat_timeout_s: float = 3.0,
                 conf_json: Optional[str] = None):
        leaves, treedef = _flatten(params)
        # np.array (a copy): the apply path updates leaves in place
        self._leaves = [np.array(a, np.float32) for a in leaves]
        # the constructor params, pre-restore: what a relaunched process
        # would reload from its model file when no durable generation
        # exists yet; the crash-restart drill falls back to the same
        self._init_leaves = [a.copy() for a in self._leaves]
        self._treedef = treedef
        self._meta = _leaf_meta(self._leaves)
        self.lr = float(lr)
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 or None "
                             f"(unbounded), got {max_staleness}")
        self.max_staleness = max_staleness
        self.version = 0
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self.checkpoint_dir = checkpoint_dir
        self.save_every = max(1, int(save_every))
        self.keep = max(1, int(keep))
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._conf_json = conf_json or "{}"
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._restart_req = threading.Event()
        self._restart_lock = threading.Lock()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._reaper_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._workers: Dict[str, float] = {}     # worker_id -> last_seen
        self._worker_versions: Dict[str, int] = {}  # the version vector
        self._applied_seq: Dict[str, int] = {}   # worker_id -> last seq
        self._next_worker = 0
        self._writer = None
        self.stats = {"pushes_applied": 0, "pushes_stale": 0,
                      "pushes_duplicate": 0, "pulls": 0,
                      "workers_reaped": 0, "restarts": 0,
                      "checkpoints": 0}
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            self._restore_latest_intact()

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        if self.port is None:
            raise PSClosedError("server is not started")
        return self.host, self.port

    def start(self) -> "ParameterServer":
        with self._lock:
            self._listener = self._open_listener()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ps-accept", daemon=True)
        self._accept_thread.start()
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, name="ps-reaper", daemon=True)
        self._reaper_thread.start()
        logger.info("parameter server up on %s:%d (%d leaves, "
                    "max_staleness=%s, lr=%g)", self.host, self.port,
                    len(self._leaves), self.max_staleness, self.lr)
        return self

    def _open_listener(self) -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            port = (self._requested_port if self.port is None
                    else self.port)
            s.bind((self.host, port))
            s.listen(64)
            s.settimeout(0.2)      # heartbeat accept: stop stays live
        except OSError:
            s.close()
            raise
        self.port = s.getsockname()[1]
        return s

    def stop(self, timeout: float = 10.0) -> None:
        """Drain: final durable checkpoint, close the listener and every
        connection, join every thread (bounded)."""
        self._stop.set()
        at, self._accept_thread = self._accept_thread, None
        if at is not None:
            at.join(timeout)
        rt, self._reaper_thread = self._reaper_thread, None
        if rt is not None:
            rt.join(timeout)
        with self._lock:
            listener, self._listener = self._listener, None
        if listener is not None:
            listener.close()
        self._close_conns()
        with self._lock:
            conn_threads, self._conn_threads = list(self._conn_threads), []
        for ct in conn_threads:
            ct.join(timeout)
        with self._lock:
            w, self._writer = self._writer, None
        if w is not None:
            try:
                w.barrier(timeout)
            finally:
                w.close(timeout)
        if self.checkpoint_dir:
            with self._lock:
                snap = [a.copy() for a in self._leaves]
                v = self.version
            self._write_generation(snap, v)

    def _close_conns(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -- durable checkpoints (the ElasticTrainer async path) -----------------
    def _writer_obj(self):
        if self._writer is None:
            from deeplearning4j_tpu_torch.train.fault_tolerance import (
                CheckpointWriter)
            self._writer = CheckpointWriter()
        return self._writer

    def _maybe_checkpoint_locked(self) -> None:
        """Called with the lock held after an applied push: every
        ``save_every`` versions, hand a snapshot to the background
        writer; the serving path pays a leaf copy, not a zip."""
        if not self.checkpoint_dir or self.version % self.save_every != 0:
            return
        snap = [a.copy() for a in self._leaves]
        v = self.version
        try:
            self._writer_obj().submit(
                lambda: self._write_generation(snap, v))
        except Exception:
            logger.exception("ps: checkpoint submit failed (a missed "
                             "checkpoint, not a dead server)")

    def _write_generation(self, leaves: List[np.ndarray],
                          version: int) -> None:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_snapshot)
        snap = {
            "conf_json": self._conf_json,
            "params": {f"leaf_{i:04d}": a for i, a in enumerate(leaves)},
            "state": {},
            "opt_state": None,
            "meta": {"format_version": 1,
                     "network_type": "ParameterServer",
                     "iteration_count": version, "epoch_count": 0,
                     "normalizer": None, "ps_version": version},
        }
        final = os.path.join(self.checkpoint_dir, f"ps_{version:08d}.zip")
        tmp = final + f".tmp{os.getpid()}"
        try:
            write_snapshot(snap, tmp)
            os.replace(tmp, final)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            logger.warning("ps: checkpoint write at version %d failed "
                           "(%r); continuing on the previous "
                           "generation", version, e)
            return
        with self._lock:
            self.stats["checkpoints"] += 1
        for _, path in self._ckpts()[:-self.keep]:
            try:
                os.remove(path)
            except OSError:
                pass
        logger.info("ps: durable generation v%d -> %s", version, final)

    def _ckpts(self) -> List[Tuple[int, str]]:
        out = []
        if not self.checkpoint_dir:
            return out
        for f in os.listdir(self.checkpoint_dir):
            m = _PS_CKPT_RE.match(f)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.checkpoint_dir, f)))
        return sorted(out)

    def _restore_latest_intact(self) -> Optional[str]:
        """Newest generation that passes the CRC manifest, corrupt ones
        quarantined ``*.corrupt`` on the way down: the same fallback
        ladder as ElasticTrainer's resume."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            CheckpointIntegrityError, verify_checkpoint)
        while True:
            cks = self._ckpts()
            if not cks:
                return None
            version, path = cks[-1]
            try:
                verify_checkpoint(path)
                with zipfile.ZipFile(path, "r") as z:
                    arch = np.load(io.BytesIO(z.read("coefficients.npz")))
                    leaves = [np.array(arch[f"leaf_{i:04d}"], np.float32)
                              for i in range(len(self._leaves))]
                    meta = json.loads(z.read("metadata.json"))
            except (CheckpointIntegrityError, zipfile.BadZipFile,
                    OSError, KeyError, ValueError) as e:
                q = path + ".corrupt"
                logger.warning("ps: checkpoint %s failed integrity/"
                               "restore (%r): quarantining as %s",
                               path, e, q)
                try:
                    os.replace(path, q)
                except OSError:
                    try:
                        os.remove(path)
                    except OSError:
                        return None
                continue
            with self._lock:
                self._leaves = leaves
                self.version = int(meta.get("ps_version", version))
            logger.info("ps: restored durable generation v%d from %s",
                        self.version, path)
            return path

    # -- accept / reaper loops ------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            self._maybe_restart()
            listener = self._listener
            if listener is None:
                return
            try:
                conn, addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._stop.is_set():
                    return
                continue
            conn.settimeout(0.5)
            with self._lock:
                self._conns.append(conn)
                # reap finished handler threads so a long-lived server
                # doesn't accumulate thread objects
                self._conn_threads = [t for t in self._conn_threads
                                      if t.is_alive()]
                t = threading.Thread(
                    target=self._handle_conn, args=(conn,),
                    name=f"ps-conn-{addr[1]}", daemon=True)
                self._conn_threads.append(t)
            t.start()

    def _reaper_loop(self) -> None:
        """Heartbeat sweep: a worker silent past the timeout is retired
        from membership; its half-sent push already died on the frame
        CRC, and its sequence entry keeps any straggler retry
        idempotent."""
        while not self._stop.wait(min(0.5, self.heartbeat_timeout_s / 4)):
            now = time.monotonic()
            with self._lock:
                dead = [w for w, seen in self._workers.items()
                        if now - seen > self.heartbeat_timeout_s]
                for w in dead:
                    del self._workers[w]
                    self.stats["workers_reaped"] += 1
            for w in dead:
                logger.warning("ps: worker %s missed heartbeats for "
                               "%.1fs — retired (its in-flight work is "
                               "discarded idempotently)", w,
                               self.heartbeat_timeout_s)
                self._count("ps_workers_reaped_total")

    # -- the in-place crash-restart drill -------------------------------------
    def _maybe_restart(self) -> None:
        """Service a pending crash-restart exactly once, whichever
        thread gets here first (the handler that triggered it, right
        after its ack, or the accept loop's next tick)."""
        if not self._restart_req.is_set():
            return
        with self._restart_lock:
            if not self._restart_req.is_set():
                return
            self._restart_req.clear()
            self._do_restart()

    def _do_restart(self) -> None:
        """Crash-restart in place: drop all connections AND all
        in-memory state, restore the newest durable generation, keep
        serving: what a killed-and-relaunched PS process does. Versions
        since the last durable write are lost and workers' next pushes
        are refused typed until they re-pull."""
        logger.warning("ps: crash-restart drill — dropping %d "
                       "connection(s) and restoring the last durable "
                       "generation", len(self._conns))
        self._close_conns()
        with self._lock:
            w = self._writer
        if w is not None:
            # whatever the writer already has in flight is what "made it
            # to disk before the crash": let it land, then restore
            try:
                w.barrier(10.0)
            except Exception:
                logger.exception("ps: writer error during restart")
        with self._lock:
            self._workers.clear()
            self._applied_seq.clear()
            self._worker_versions.clear()
        pre = self.version
        if self._restore_latest_intact() is None:
            with self._lock:
                self._leaves = [a.copy() for a in self._init_leaves]
                self.version = 0
        with self._lock:
            self.stats["restarts"] += 1
        self._count("ps_server_restarts_total")
        logger.warning("ps: restarted at version %d (was %d; %d "
                       "version(s) rolled back to the durable "
                       "generation)", self.version, pre,
                       pre - self.version)

    # -- request handling ------------------------------------------------------
    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    header, payload = read_frame(
                        conn, deadline=time.monotonic() + 30.0)
                except PSTimeoutError:
                    continue       # idle connection; re-check stop
                except (PSFrameError, OSError):
                    return         # peer died / desynced: drop conn
                try:
                    reply = self._dispatch(header, payload)
                except PSError as e:
                    reply = (_error_header(e, **getattr(
                        e, "__dict__", {})), b"")
                except Exception as e:
                    # a handler bug must not silently kill the
                    # connection thread: surface it typed
                    logger.exception("ps: internal error handling %r",
                                     header.get("op"))
                    reply = (_error_header(
                        PSError(f"internal server error: {e!r}")), b"")
                if reply is None:
                    continue       # chaos swallowed the response
                try:
                    conn.sendall(pack_frame(*reply))
                except OSError:
                    return
                # a chaos push triggered a crash-restart: its ack is out
                # (the "applied but died before checkpointing" window),
                # now crash; this handler's own conn dies with the rest
                self._maybe_restart()
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _touch(self, worker_id: Optional[str]) -> None:
        if worker_id:
            with self._lock:
                self._workers[worker_id] = time.monotonic()

    def _dispatch(self, header: dict, payload: bytes):
        """Returns ``(reply_header, reply_payload)`` or None when a
        chaos drill swallowed the reply."""
        op = header.get("op")
        self._touch(header.get("worker_id"))
        if self._stop.is_set():
            raise PSClosedError("parameter server is stopping")
        if op == "hello":
            return self._op_hello(header)
        if op == "pull":
            return self._op_pull(header)
        if op == "push":
            return self._op_push(header, payload)
        if op == "hb":
            return {"op": "hb_ok", "version": self.version}, b""
        if op == "bye":
            with self._lock:
                self._workers.pop(header.get("worker_id"), None)
            return {"op": "bye_ok"}, b""
        raise PSProtocolError(f"unknown op {op!r}")

    def _op_hello(self, header: dict):
        want = header.get("worker_id")
        with self._lock:
            if not want:
                want = f"w{self._next_worker}"
                self._next_worker += 1
            self._workers[want] = time.monotonic()
            self._applied_seq.setdefault(want, 0)
        logger.info("ps: worker %s joined (%d live)", want,
                    len(self._workers))
        return {"op": "hello_ok", "worker_id": want,
                "version": self.version,
                "max_staleness": self.max_staleness,
                "n_leaves": len(self._leaves),
                "heartbeat_timeout_s": self.heartbeat_timeout_s}, b""

    def _op_pull(self, header: dict):
        f = chaos.hit("ps.pull.timeout")
        if f is not None and f.kind == "timeout":
            # the snapshot reply, lost on the wire: send NOTHING; the
            # worker's deadline expires and it re-pulls
            logger.warning("ps: [chaos] swallowing pull reply for %s",
                           header.get("worker_id"))
            return None
        with self._lock:
            payload = _concat_bytes(self._leaves)
            v = self.version
            self.stats["pulls"] += 1
            wid = header.get("worker_id")
            if wid:
                self._worker_versions[wid] = v
        return {"op": "pull_ok", "version": v,
                "leaves": self._meta}, payload

    def _op_push(self, header: dict, payload: bytes):
        wid = header.get("worker_id")
        seq = int(header.get("seq", 0))
        base = int(header.get("base_version", -1))
        leaves_meta = header.get("leaves")
        if not wid or leaves_meta is None or base < 0:
            raise PSProtocolError(
                "push needs worker_id, base_version and a leaf table")
        if len(leaves_meta) != len(self._leaves):
            raise PSProtocolError(
                f"push has {len(leaves_meta)} leaves; the server "
                f"holds {len(self._leaves)}")
        with self._lock:
            last = self._applied_seq.get(wid, 0)
            if seq <= last:
                # a retry of a push that already landed (its first ack
                # was lost): discard idempotently, ack success
                self.stats["pushes_duplicate"] += 1
                self._count("ps_pushes_duplicate_total")
                return {"op": "push_ok", "applied": False,
                        "duplicate": True,
                        "version": self.version}, b""
            if base > self.version:
                # the worker is AHEAD: we restarted and rolled back
                self.stats["pushes_stale"] += 1
                self._count("ps_pushes_stale_total")
                raise StalenessExceededError(
                    f"push base version {base} is ahead of the "
                    f"server ({self.version}) — the server restarted "
                    "from an older durable generation; pull a fresh "
                    "snapshot", base_version=base,
                    server_version=self.version,
                    max_staleness=self.max_staleness)
            if self.max_staleness is not None \
                    and self.version - base > self.max_staleness:
                self.stats["pushes_stale"] += 1
                self._count("ps_pushes_stale_total")
                raise StalenessExceededError(
                    f"push base version {base} trails the server "
                    f"({self.version}) by more than max_staleness="
                    f"{self.max_staleness}; pull a fresh snapshot",
                    base_version=base, server_version=self.version,
                    max_staleness=self.max_staleness)
            f = chaos.hit("ps.push.drop")
            if f is not None and f.kind == "drop":
                # the worker's packet, lost on the wire: neither apply
                # nor ack; the retry (same seq) lands next time
                logger.warning("ps: [chaos] dropping push seq %d from "
                               "%s", seq, wid)
                return None
            q_leaves = _split_bytes(payload, [
                {"shape": m["shape"], "dtype": "int8"}
                for m in leaves_meta])
            for target, m, q in zip(self._leaves, leaves_meta, q_leaves):
                if tuple(m["shape"]) != target.shape:
                    raise PSProtocolError(
                        f"push leaf shape {m['shape']} != server leaf "
                        f"shape {list(target.shape)}")
                # SGD apply: params -= lr * dequant(delta)
                target -= self.lr * (
                    q.astype(np.float32) * np.float32(m["scale"]))
            self.version += 1
            self._applied_seq[wid] = seq
            self._worker_versions[wid] = base
            self.stats["pushes_applied"] += 1
            v = self.version
            self._maybe_checkpoint_locked()
        self._count("ps_pushes_applied_total")
        f = chaos.hit("ps.server.restart")
        if f is not None and f.kind == "restart":
            # crash AFTER the apply: the accept loop or this handler
            # runs the restart (single owner of listener + state swap);
            # this handler's ack still goes out: exactly the "applied
            # but the server died before checkpointing" window
            self._restart_req.set()
        return {"op": "push_ok", "applied": True, "version": v}, b""

    # -- introspection ----------------------------------------------------------
    def params_tree(self):
        """The authoritative params as float32 CPU tensors, in the tree
        structure the server was constructed with (``set_params`` takes
        it on any device)."""
        with self._lock:
            leaves = [torch.from_numpy(a.copy()) for a in self._leaves]
        return _unflatten(self._treedef, leaves)

    def worker_versions(self) -> Dict[str, int]:
        """The version vector: each live worker's last synced version
        (pull) / last applied base (push)."""
        with self._lock:
            return {w: self._worker_versions.get(w, -1)
                    for w in self._workers}

    def live_workers(self) -> List[str]:
        with self._lock:
            return sorted(self._workers)

    def wait_version(self, version: int, timeout: float = 10.0) -> bool:
        """Block (bounded) until the server has applied at least
        ``version`` pushes."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self.version >= version:
                    return True
            time.sleep(0.01)
        return False

    @staticmethod
    def _count(name: str) -> None:
        safe_inc(name, help="parameter-server event counter")


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------

class PSClient:
    """Reconnecting, deadline-bounded PS connection.

    Every op carries ``op_timeout_s``; a lost reply (dead server, chaos
    drop) costs a bounded wait, then the client reconnects
    (re-``hello``\\ ing under its existing worker id) and retries the
    SAME request (same sequence number for pushes, which is what makes
    retry-after-drop idempotent server-side). Typed server refusals
    (:class:`StalenessExceededError`) are raised, never retried: they
    are the protocol, not a failure."""

    def __init__(self, address: Tuple[str, int], *,
                 worker_id: Optional[str] = None,
                 op_timeout_s: float = 2.0, max_retries: int = 8,
                 backoff_s: float = 0.05):
        self.address = tuple(address)
        self.worker_id = worker_id
        self.op_timeout_s = float(op_timeout_s)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.server_version = -1
        self.max_staleness: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._seq = 0
        self._lock = threading.RLock()

    # -- connection -------------------------------------------------------------
    def _ensure_connected(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        sock = socket.create_connection(self.address,
                                        timeout=self.op_timeout_s)
        sock.settimeout(0.25)       # per-recv bound; deadline governs
        try:
            hello = {"op": "hello"}
            if self.worker_id:
                hello["worker_id"] = self.worker_id
            sock.sendall(pack_frame(hello))
            header, _ = read_frame(
                sock, deadline=time.monotonic() + self.op_timeout_s)
            if header.get("op") == "error":
                _raise_wire_error(header)
            if header.get("op") != "hello_ok":
                raise PSProtocolError(
                    f"expected hello_ok, got {header.get('op')!r}")
        except BaseException:
            sock.close()
            raise
        self.worker_id = header["worker_id"]
        self.server_version = int(header["version"])
        self.max_staleness = header.get("max_staleness")
        self._sock = sock
        return sock

    def close(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            if sock is None:
                return
            try:
                sock.sendall(pack_frame({"op": "bye",
                                         "worker_id": self.worker_id}))
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _drop(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- request core -------------------------------------------------------------
    def _request(self, header: dict, payload: bytes = b""
                 ) -> Tuple[dict, bytes]:
        """Send one request, await its reply; reconnect + retry on
        transport failure (bounded). Typed server errors raise."""
        last: Optional[Exception] = None
        with self._lock:
            for attempt in range(self.max_retries):
                if attempt:
                    time.sleep(min(self.backoff_s * (2 ** attempt), 1.0))
                try:
                    sock = self._ensure_connected()
                    hdr = dict(header)
                    hdr["worker_id"] = self.worker_id
                    sock.sendall(pack_frame(hdr, payload))
                    rhdr, rpayload = read_frame(
                        sock, deadline=time.monotonic() + self.op_timeout_s)
                except (PSTimeoutError, PSFrameError, OSError,
                        ConnectionError) as e:
                    last = e
                    self._drop()
                    continue
                if rhdr.get("op") == "error":
                    _raise_wire_error(rhdr)
                return rhdr, rpayload
        raise PSTimeoutError(
            f"no reply from {self.address} after {self.max_retries} "
            f"attempt(s); last failure: {last!r}")

    # -- ops -------------------------------------------------------------------
    def pull(self) -> Tuple[List[np.ndarray], int]:
        header, payload = self._request({"op": "pull"})
        leaves = _split_bytes(payload, header["leaves"])
        self.server_version = int(header["version"])
        return leaves, self.server_version

    def push(self, quantized: Sequence[Tuple[np.ndarray, float]],
             base_version: int) -> dict:
        """Push one compressed delta: ``quantized`` is a list of
        ``(q_int8_array, scale)`` per leaf. Returns the ack header;
        raises :class:`StalenessExceededError` when refused. The scale
        travels as a JSON float (a float32's exact value)."""
        self._seq += 1
        meta = [{"shape": list(np.shape(q)), "scale": float(s)}
                for q, s in quantized]
        payload = _concat_bytes([np.asarray(q, np.int8)
                                 for q, _ in quantized])
        header, _ = self._request(
            {"op": "push", "seq": self._seq,
             "base_version": int(base_version), "leaves": meta}, payload)
        self.server_version = int(header["version"])
        return header

    def heartbeat(self) -> int:
        header, _ = self._request({"op": "hb"})
        self.server_version = int(header["version"])
        return self.server_version


# ---------------------------------------------------------------------------
# the worker-side trainer
# ---------------------------------------------------------------------------

class PSWorker:
    """Pull -> local grads -> int8+EF compressed push, forever.

    ``model`` is a port MultiLayerNetwork or ComputationGraph on its
    device (cuda unless the caller built it on the CPU): its
    ``_gradients`` gives the gradient (the layers' new states are
    discarded, as the JAX package's worker discards them), the codec
    runs on that device, and a pull lands there through
    ``set_params``. The server's float32 copy is the only authoritative
    one. The EF residual (float32, per leaf, on the device) carries
    quantization error across pushes; a staleness refusal folds the
    refused delta back into the residual before re-pulling, so bounded
    staleness never LOSES gradient signal, it only delays it."""

    def __init__(self, model, client: PSClient, *,
                 threshold: float = 0.0,
                 pull_every: Optional[int] = None,
                 heartbeat_s: float = 0.5, name: str = "ps-worker"):
        self.model = model
        self.client = client
        self.threshold = float(threshold)
        self.pull_every = pull_every
        self.heartbeat_s = float(heartbeat_s)
        self.name = name
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self.stats = {"steps": 0, "pushes_applied": 0,
                      "stale_rejects": 0, "pulls": 0,
                      "last_loss": float("nan")}

    # -- model plumbing -----------------------------------------------------------
    def _apply_pull(self, leaves: List[np.ndarray]) -> None:
        params = self.model.params
        n_local = sum(1 for _ in _leaves(params))
        if len(leaves) != n_local:
            raise PSProtocolError(
                f"pull returned {len(leaves)} leaves; the local model "
                f"has {n_local}")
        self.model.set_params(_unflatten(_structure(params), leaves))

    def _gradients(self, ds):
        """(loss as a device scalar, gradient leaves in wire order)."""
        model = self.model
        loss, grads, _ = model._gradients(model._batch_tuple(ds))
        return loss, list(_leaves(grads))

    def encode(self, g_leaves, residual):
        """Quantize every gradient leaf on its device with error
        feedback (``residual`` is updated in place) and bring the codes
        and scales to the host in ONE copy. Returns ``(quantized,
        codes)``: ``quantized`` the push's ``[(q_int8 host array,
        scale), ...]``, ``codes`` the device ``[(q, scale), ...]`` that a
        refused push folds back into the residual."""
        codes = []
        for i, g in enumerate(g_leaves):
            q, scale, residual[i] = int8_quantize_ef(g, residual[i],
                                                     self.threshold)
            codes.append((q, scale))
        scales = torch.stack([s for _, s in codes])
        host = torch.cat([q.reshape(-1) for q, _ in codes]
                         + [scales.view(torch.int8)]).cpu().numpy()
        n_codes = host.size - 4 * len(codes)
        scale_host = np.frombuffer(host[n_codes:].tobytes(), np.float32)
        quantized, off = [], 0
        for (q, _), s in zip(codes, scale_host):
            quantized.append((host[off:off + q.numel()].reshape(q.shape),
                              s))
            off += q.numel()
        return quantized, codes

    # -- heartbeats ------------------------------------------------------------
    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_s):
            try:
                self.client.heartbeat()
            except PSError:
                pass               # reconnect happens on the next op

    def _start_heartbeats(self) -> None:
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"{self.name}-hb", daemon=True)
        self._hb_thread.start()

    def _stop_heartbeats(self) -> None:
        self._hb_stop.set()
        t, self._hb_thread = self._hb_thread, None
        if t is not None:
            t.join(5.0)

    # -- the loop ---------------------------------------------------------------
    def run(self, batches, *, epochs: int = 1,
            max_steps: Optional[int] = None) -> dict:
        """Train over ``batches`` (a list / iterable re-iterated per
        epoch) pushing one compressed delta per batch. Returns the
        stats dict. Transport failures retry inside the client;
        staleness refusals fold into the residual and re-pull."""
        if self.model.params is None:
            self.model.init()
        leaves, version = self.client.pull()
        self._apply_pull(leaves)
        self.stats["pulls"] += 1
        residual = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                    for p in _leaves(self.model.params)]
        pull_gap = self.pull_every if self.pull_every is not None else 1
        self._start_heartbeats()
        try:
            for _ in range(max(1, epochs)):
                for ds in batches:
                    if max_steps is not None \
                            and self.stats["steps"] >= max_steps:
                        return self.stats
                    # bounded staleness, worker side: block on a fresh
                    # pull before computing on params the server is
                    # guaranteed to refuse
                    gap = self.client.server_version - version
                    ms = self.client.max_staleness
                    if (ms is not None and gap > ms) or gap >= pull_gap:
                        leaves, version = self.client.pull()
                        self._apply_pull(leaves)
                        self.stats["pulls"] += 1
                    loss, g_leaves = self._gradients(ds)
                    quantized, codes = self.encode(g_leaves, residual)
                    del g_leaves
                    try:
                        self.client.push(quantized, version)
                        self.stats["pushes_applied"] += 1
                    except StalenessExceededError:
                        # fold the refused delta back into the residual
                        # (no signal lost), then pull fresh
                        for i, (q, scale) in enumerate(codes):
                            residual[i] += q.to(torch.float32) * scale
                        self.stats["stale_rejects"] += 1
                        leaves, version = self.client.pull()
                        self._apply_pull(leaves)
                        self.stats["pulls"] += 1
                    self.stats["steps"] += 1
                    self.stats["last_loss"] = float(loss)
            return self.stats
        finally:
            self._stop_heartbeats()


# ---------------------------------------------------------------------------
# in-process harness (tests + the ps_async_training leg)
# ---------------------------------------------------------------------------

def run_async_training(model_factory: Callable[[int], object],
                       batches: Sequence, *, n_workers: int = 2,
                       epochs: int = 1, lr: float = 0.05,
                       max_staleness: Optional[int] = None,
                       threshold: float = 0.0,
                       checkpoint_dir: Optional[str] = None,
                       save_every: int = 50,
                       heartbeat_timeout_s: float = 3.0,
                       server: Optional[ParameterServer] = None,
                       join_timeout_s: float = 120.0):
    """Server + N worker threads in one process; each worker trains the
    round-robin shard ``batches[i::n_workers]``. Returns ``(model,
    server_stats, worker_stats)`` where ``model`` is
    ``model_factory(0)`` holding the server's final params.

    Pass ``server`` to reuse (and keep) an externally-managed server;
    otherwise one is created and stopped here."""
    m0 = model_factory(0)
    if m0.params is None:
        m0.init()
    own_server = server is None
    if own_server:
        server = ParameterServer(
            m0.params, lr=lr, max_staleness=max_staleness,
            checkpoint_dir=checkpoint_dir, save_every=save_every,
            heartbeat_timeout_s=heartbeat_timeout_s).start()
    results: List[Optional[dict]] = [None] * n_workers
    errors: List[Optional[BaseException]] = [None] * n_workers

    def _run(i: int) -> None:
        model = m0 if i == 0 else model_factory(i)
        if model.params is None:
            model.init()
        client = PSClient(server.address)
        try:
            worker = PSWorker(model, client, threshold=threshold,
                              name=f"ps-worker-{i}")
            results[i] = worker.run(batches[i::n_workers], epochs=epochs)
        except BaseException as e:       # surfaced after join
            errors[i] = e
        finally:
            client.close()

    threads = [threading.Thread(target=_run, args=(i,),
                                name=f"ps-worker-{i}", daemon=True)
               for i in range(n_workers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout_s
    try:
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()))
            if t.is_alive():
                raise PSTimeoutError(
                    f"worker thread {t.name} still running after "
                    f"{join_timeout_s}s")
        for e in errors:
            if e is not None:
                raise e
        m0.set_params(server.params_tree())
        return m0, dict(server.stats), [r for r in results
                                        if r is not None]
    finally:
        if own_server:
            server.stop()
