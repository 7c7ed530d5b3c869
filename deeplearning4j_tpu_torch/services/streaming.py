"""Streaming inference routes (counterpart of
``deeplearning4j_tpu/services/streaming.py``).

Mirrors dl4j-streaming (streaming/routes/DL4jServeRouteBuilder.java —
Camel routes wiring Kafka topics to model inference;
streaming/kafka/NDArrayPublisher/NDArrayKafkaClient): a
consume → predict → publish pipeline over pluggable transports. Kafka
itself isn't in this environment, so the broker abstraction has an
in-process implementation (the reference's own tests run an
EmbeddedKafkaCluster for the same reason); a real Kafka transport plugs
into the same Publisher/Consumer SPI.

The brokers, the frame format (4-byte length + JSON with base64
payloads) and the ndarray payload (JSON shape + data) are the JAX
package's, byte for byte, so a JAX publisher, a port route and a JAX
consumer can share one broker. ``InferenceRoute`` runs the port's
``model.output`` on the model's device and publishes the result from
the host.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["InProcessBroker", "SocketBroker", "SocketBrokerServer",
           "NDArrayPublisher", "NDArrayConsumer", "InferenceRoute"]


class InProcessBroker:
    """Topic → subscriber queues (EmbeddedKafkaCluster stand-in)."""

    def __init__(self):
        self._topics: Dict[str, List[queue.Queue]] = {}
        self._lock = threading.Lock()

    def publish(self, topic: str, payload: bytes):
        with self._lock:
            subs = list(self._topics.get(topic, []))
        for q in subs:
            q.put(payload)

    def subscribe(self, topic: str) -> "queue.Queue[bytes]":
        q: "queue.Queue[bytes]" = queue.Queue()
        with self._lock:
            self._topics.setdefault(topic, []).append(q)
        return q


class SocketBrokerServer:
    """A real network pub/sub broker over TCP (the embedded-Kafka
    analog the reference tests against, EmbeddedKafkaCluster — here a
    self-contained server, no external install). Wire format per
    message: 4-byte length + JSON {op: publish|subscribe, topic,
    payload_b64?}. Subscribers hold their connection open and receive
    length-prefixed {topic, payload_b64} frames."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import socket
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        # deadline discipline (GL008): accept() and per-connection
        # recv() run on heartbeats, so close() reclaims every broker
        # thread instead of leaving them wedged in blocking reads
        self._srv.settimeout(0.5)
        self.host, self.port = self._srv.getsockname()
        self._subs: Dict[str, List] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    @staticmethod
    def _recv_frame(conn, stop=None) -> Optional[bytes]:
        """One length-prefixed frame, or None at EOF (or once
        ``stop`` is set, for connections carrying a recv timeout —
        the heartbeat that lets a closing server reclaim its
        connection threads)."""
        import socket
        import struct

        def read_n(n: int) -> Optional[bytes]:
            buf = b""
            while len(buf) < n:
                try:
                    chunk = conn.recv(n - len(buf))
                except socket.timeout:
                    if stop is not None and stop.is_set():
                        return None
                    continue
                if not chunk:
                    return None
                buf += chunk
            return buf

        head = read_n(4)
        if head is None:
            return None
        (n,) = struct.unpack(">I", head)
        return read_n(n)

    @staticmethod
    def _send_frame(conn, payload: bytes):
        import struct
        conn.sendall(struct.pack(">I", len(payload)) + payload)

    def _accept_loop(self):
        import socket
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue              # heartbeat: re-check stop
            except OSError:
                return
            conn.settimeout(0.5)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        import base64
        while not self._stop.is_set():
            frame = self._recv_frame(conn, stop=self._stop)
            if frame is None:
                return
            msg = json.loads(frame.decode())
            if msg["op"] == "subscribe":
                # the connection is WRITE-only from here on: drop the
                # read heartbeat so a merely-slow subscriber (its TCP
                # send buffer filling mid-burst) blocks the publisher
                # briefly instead of raising socket.timeout — an
                # OSError the publish fan-out would misread as a dead
                # peer and silently unsubscribe
                conn.settimeout(None)
                # each subscriber gets a dedicated send lock:
                # concurrent publishers would otherwise interleave
                # partial sendall() writes and corrupt the framing
                entry = (conn, threading.Lock())
                with self._lock:
                    self._subs.setdefault(msg["topic"],
                                          []).append(entry)
                # ack AFTER registration so the client's subscribe()
                # returning guarantees delivery of later publishes
                self._send_frame(conn, b'{"op": "subscribed"}')
                # connection now belongs to the subscription
                return
            if msg["op"] == "publish":
                payload = base64.b64decode(msg["payload_b64"])
                out = json.dumps({
                    "topic": msg["topic"],
                    "payload_b64": base64.b64encode(
                        payload).decode()}).encode()
                with self._lock:
                    subs = list(self._subs.get(msg["topic"], []))
                for s, send_lock in subs:
                    try:
                        with send_lock:
                            self._send_frame(s, out)
                    except OSError:
                        with self._lock:
                            try:
                                self._subs[msg["topic"]].remove(
                                    (s, send_lock))
                            except ValueError:
                                pass

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        # the accept loop exits within one heartbeat; joining it
        # (GL007) makes close() mean "the broker is gone", not
        # "the broker will eventually be gone"
        self._thread.join(timeout=5.0)


class SocketBroker:
    """Client side of SocketBrokerServer with the same publish/
    subscribe surface as InProcessBroker, so every route/publisher/
    consumer works unchanged over a real network transport."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port

    def _connect(self):
        import socket
        c = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        c.connect((self.host, self.port))
        return c

    def publish(self, topic: str, payload: bytes):
        import base64
        c = self._connect()
        try:
            SocketBrokerServer._send_frame(c, json.dumps({
                "op": "publish", "topic": topic,
                "payload_b64": base64.b64encode(payload).decode()}
            ).encode())
        finally:
            c.close()

    def subscribe(self, topic: str) -> "queue.Queue[bytes]":
        import base64
        c = self._connect()
        SocketBrokerServer._send_frame(c, json.dumps(
            {"op": "subscribe", "topic": topic}).encode())
        # block for the server's ack: after subscribe() returns, any
        # later publish is guaranteed to reach this queue — the same
        # synchronous contract InProcessBroker.subscribe has
        ack = SocketBrokerServer._recv_frame(c)
        if ack is None or json.loads(ack.decode()).get("op") != \
                "subscribed":
            raise IOError("broker did not acknowledge subscription")
        q: "queue.Queue[bytes]" = queue.Queue()

        def pump():
            while True:
                frame = SocketBrokerServer._recv_frame(c)
                if frame is None:
                    return
                msg = json.loads(frame.decode())
                q.put(base64.b64decode(msg["payload_b64"]))

        threading.Thread(target=pump, daemon=True).start()
        return q


def _encode(arr: np.ndarray) -> bytes:
    return json.dumps({"shape": list(arr.shape),
                       "data": arr.ravel().tolist()}).encode()


def _host(y) -> np.ndarray:
    """A model output (a tensor on any device, or a tuple of them) as
    host numpy."""
    if isinstance(y, torch.Tensor):
        return y.detach().float().cpu().numpy()
    if isinstance(y, (tuple, list)):
        return np.asarray([_host(t) for t in y])
    return np.asarray(y)


def _decode(payload: bytes) -> np.ndarray:
    obj = json.loads(payload.decode())
    return np.asarray(obj["data"], np.float32).reshape(obj["shape"])


class NDArrayPublisher:
    """(streaming/kafka/NDArrayPublisher.java)."""

    def __init__(self, broker: InProcessBroker, topic: str):
        self.broker = broker
        self.topic = topic

    def publish(self, arr: np.ndarray):
        self.broker.publish(self.topic, _encode(np.asarray(arr)))


class NDArrayConsumer:
    """(streaming/kafka/NDArrayConsumer.java)."""

    def __init__(self, broker: InProcessBroker, topic: str):
        self.queue = broker.subscribe(topic)

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        return _decode(self.queue.get(timeout=timeout))


class InferenceRoute:
    """consume(in_topic) → model.output → publish(out_topic)
    (DL4jServeRouteBuilder semantics). ``start`` spawns the worker;
    errors are published to ``<out_topic>.errors`` instead of killing
    the route."""

    def __init__(self, broker: InProcessBroker, model,
                 in_topic: str, out_topic: str,
                 transform: Optional[Callable] = None):
        self.broker = broker
        self.model = model
        self.in_q = broker.subscribe(in_topic)
        self.out_topic = out_topic
        self.transform = transform
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "InferenceRoute":
        def run():
            while not self._stop.is_set():
                try:
                    payload = self.in_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    x = _decode(payload)
                    if self.transform is not None:
                        x = self.transform(x)
                    y = _host(self.model.output(x))
                    self.broker.publish(self.out_topic, _encode(y))
                except Exception as e:        # route stays alive
                    logger.warning("inference route error: %s", e)
                    self.broker.publish(
                        self.out_topic + ".errors",
                        json.dumps({"error": str(e)}).encode())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
