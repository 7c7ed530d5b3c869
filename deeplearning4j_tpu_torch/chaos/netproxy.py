"""Seeded, deterministic TCP fault proxy — network chaos as a plan
(counterpart of ``deeplearning4j_tpu/chaos/netproxy.py``, copied with
the imports renamed; stdlib sockets only).

Every chaos drill so far is in-process call-site injection
(`chaos/injector.py`): partitions, connection resets mid-body,
truncated responses, corrupted streams and half-open peers have never
actually crossed a socket. This module closes that gap: a
:class:`NetChaosProxy` fronts any TCP listener (a fleet replica's
HTTP port, the DPS1 parameter-server wire, the collector's scrape
path) and applies a declarative JSON **network plan** — same shape,
same determinism contract and same audit trail as the fault plans.

Topology::

    client ──TCP──> NetChaosProxy(listen_port) ──TCP──> upstream
                     │  per-connection fault evaluation (seeded)
                     │  net_chaos_faults_fired_total{site,kind}
                     └─ flight-recorder "net_chaos_fault" events

Proxy sites (where a proxy sits — one name per TCP hop, linted
against the README table by graftlint GL011):

==================== ====================================================
``net.replica``      the router↔replica HTTP hop: one proxy fronts
                     one replica listener (``serve-fleet
                     --net-chaos PLAN`` boots every subprocess
                     replica behind one)
``net.ps``           the DPS1 parameter-server wire (``train-ps
                     --net-chaos PLAN`` hands workers the proxy's
                     address instead of the server's)
``net.collector``    the collector→member scrape hop, proxied
                     INDEPENDENTLY of the router's path to the same
                     replica — asymmetric partitions
==================== ====================================================

Fault kinds (validated at plan-parse time; a typo'd kind fails
loudly instead of installing a plan that silently injects nothing):

``partition``  blackhole the hop for ``args.duration_s`` (default
               5.0) in ``args.direction`` ``both`` / ``inbound``
               (client→upstream) / ``outbound`` (upstream→client).
               In-flight connections stall while dark and are closed
               at heal (their bytes are gone — exactly what a real
               partition does to an open TCP stream); new
               connections hang unanswered until heal.
``reset``      a real RST (``SO_LINGER(1,0)`` close) after
               ``args.after_bytes`` bytes of the ``args.when``
               stream (``response`` default / ``request``).
``truncate``   clean FIN after ``args.after_bytes`` (default 64)
               response bytes — Content-Length now lies.
``corrupt``    seeded bit flips: ``args.n_flips`` (default 3) bit
               positions drawn from the per-connection rng over the
               first ``args.window`` (default 4096) bytes of the
               ``args.when`` stream. Offsets are ABSOLUTE stream
               offsets, so TCP chunking cannot perturb the flips.
``delay``      sleep ``args.delay_s`` (default 0.05) before
               forwarding each chunk of the ``args.when`` stream.
``throttle``   cap the ``args.when`` stream at ``args.bytes_per_s``
               (default 8192).
``half_open``  accept the connection, read and discard the request,
               never connect upstream, never answer — the classic
               wedged peer that only bounded read deadlines survive.

Determinism contract (mirrors the injector): each plan spec draws
from its OWN rng stream (``seed ^ crc32(site#spec_idx)``) exactly
once per connection whether or not an earlier spec fired, per-proxy
connection ordinals are assigned under a lock, and per-connection
byte mutations derive from ``seed ^ crc32(site#spec_idx#conn{n})``
— so the fired-fault log is a pure function of (plan, seed,
connection count) and replays from the recorded seed.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["NetFault", "NetSpec", "NetworkPlan", "NetChaosProxy",
           "NET_SITES", "NET_KINDS", "parse_net_plan"]


# the hop table docs cite; registered here so every name exists as a
# code literal in exactly one authoritative place (GL011 lints the
# README table against this dict)
NET_SITES: Dict[str, str] = {
    "net.replica": "the router↔replica HTTP hop (one proxy per "
                   "replica listener)",
    "net.ps": "the DPS1 parameter-server wire (workers dial the "
              "proxy instead of the server)",
    "net.collector": "the collector→member scrape hop, proxied "
                     "independently of the router's path "
                     "(asymmetric partitions)",
}

# every kind any NetChaosProxy interprets — validated at plan-parse
# time and linted three-way by GL011 (this dict vs the `.kind`
# comparisons in the proxy vs the README kind table)
NET_KINDS: Dict[str, str] = {
    "partition": "blackhole the hop for duration_s (direction: "
                 "both/inbound/outbound); heal dooms in-flight "
                 "connections",
    "reset": "RST after after_bytes bytes of the when-stream",
    "truncate": "clean FIN after after_bytes response bytes",
    "corrupt": "seeded bit flips at absolute stream offsets",
    "delay": "sleep delay_s before forwarding each chunk",
    "throttle": "cap the stream at bytes_per_s",
    "half_open": "accept, swallow the request, never answer",
}

_DIRECTIONS = frozenset({"both", "inbound", "outbound"})
_WHEN = frozenset({"request", "response"})


class _CloseConn(Exception):
    """Internal: a shaper decided this connection dies now, after
    ``flush`` (the allowed prefix of the current chunk) is sent."""

    def __init__(self, rst: bool, flush: bytes = b""):
        self.rst = rst
        self.flush = flush


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

class NetSpec:
    """One declarative rule: WHERE (``site`` — which hop's proxies
    apply it, optionally narrowed to one proxy ``instance`` by
    name), WHAT (``kind``), WHEN (``p`` per-connection probability
    or ``at`` — explicit 1-based connection ordinals), bounded by
    ``max_fires``; ``args`` parameterizes the kind."""

    __slots__ = ("site", "kind", "p", "at", "max_fires", "args",
                 "instance")

    def __init__(self, site: str, kind: str, p: float = 0.0,
                 at: Optional[List[int]] = None,
                 max_fires: Optional[int] = None,
                 args: Optional[dict] = None,
                 instance: Optional[str] = None):
        if site not in NET_SITES:
            raise ValueError(
                f"unknown network-chaos site {site!r}; known sites: "
                f"{sorted(NET_SITES)}")
        if kind not in NET_KINDS:
            raise ValueError(
                f"unknown network-fault kind {kind!r}; known kinds: "
                f"{sorted(NET_KINDS)}")
        if not (at or p > 0.0):
            raise ValueError(
                f"network-fault spec for {site!r}/{kind!r} can never "
                "fire: give it p > 0 or an 'at' schedule")
        args = dict(args or {})
        d = args.get("direction", "both")
        if d not in _DIRECTIONS:
            raise ValueError(
                f"bad direction {d!r}; one of {sorted(_DIRECTIONS)}")
        w = args.get("when", "response")
        if w not in _WHEN:
            raise ValueError(
                f"bad when {w!r}; one of {sorted(_WHEN)}")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.at = None if at is None else {int(n) for n in at}
        self.max_fires = max_fires
        self.args = args
        self.instance = instance

    @classmethod
    def from_dict(cls, d: dict) -> "NetSpec":
        known = {"site", "kind", "p", "at", "max_fires", "args",
                 "instance"}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"unknown network-fault spec key(s) {sorted(extra)}; "
                f"known: {sorted(known)}")
        return cls(d["site"], d["kind"], p=d.get("p", 0.0),
                   at=d.get("at"), max_fires=d.get("max_fires"),
                   args=d.get("args"), instance=d.get("instance"))

    def to_dict(self) -> dict:
        out = {"site": self.site, "kind": self.kind}
        if self.p:
            out["p"] = self.p
        if self.at is not None:
            out["at"] = sorted(self.at)
        if self.max_fires is not None:
            out["max_fires"] = self.max_fires
        if self.args:
            out["args"] = dict(self.args)
        if self.instance is not None:
            out["instance"] = self.instance
        return out


class NetworkPlan:
    def __init__(self, faults: List[NetSpec],
                 seed: Optional[int] = None):
        self.faults = list(faults)
        self.seed = seed

    def to_dict(self) -> dict:
        out = {"faults": [f.to_dict() for f in self.faults]}
        if self.seed is not None:
            out["seed"] = self.seed
        return out


def parse_net_plan(plan) -> NetworkPlan:
    """Accepts a :class:`NetworkPlan`, a list of spec dicts, a dict
    ``{"seed": ..., "faults": [...]}``, a JSON string of either, or
    a path to a JSON file — the same input forms as the injector's
    ``parse_plan``."""
    if isinstance(plan, NetworkPlan):
        return plan
    if isinstance(plan, str):
        text = plan.strip()
        if not text.startswith(("{", "[")):
            with open(plan) as f:
                text = f.read()
        plan = json.loads(text)
    if isinstance(plan, list):
        plan = {"faults": plan}
    if not isinstance(plan, dict):
        raise TypeError(f"cannot parse a network plan from "
                        f"{type(plan).__name__}")
    faults = [s if isinstance(s, NetSpec) else NetSpec.from_dict(s)
              for s in plan.get("faults", [])]
    seed = plan.get("seed")
    return NetworkPlan(faults, None if seed is None else int(seed))


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------

class NetFault:
    """One fired network fault, shaping one connection (or, for
    ``partition``, the whole proxy)."""

    __slots__ = ("site", "kind", "args", "ordinal", "spec_idx")

    def __init__(self, site: str, kind: str, args: dict,
                 ordinal: int, spec_idx: int):
        self.site = site
        self.kind = kind
        self.args = args
        self.ordinal = ordinal
        self.spec_idx = spec_idx

    def __repr__(self):
        return (f"NetFault(site={self.site!r}, kind={self.kind!r}, "
                f"conn#{self.ordinal})")


class _Shaper:
    """Per-connection stream mutator for one fired fault. Tracks
    absolute stream offsets per direction so TCP chunk boundaries
    cannot perturb where a reset/truncate/corrupt lands."""

    def __init__(self, fault: NetFault, rng: random.Random):
        self.fault = fault
        self.when = fault.args.get("when", "response")
        self.after = int(fault.args.get("after_bytes",
                                        64 if fault.kind == "truncate"
                                        else 0))
        self.delay_s = float(fault.args.get("delay_s", 0.05))
        self.bps = float(fault.args.get("bytes_per_s", 8192.0))
        self._sent = {"request": 0, "response": 0}
        self._flips: Dict[int, int] = {}
        if fault.kind == "corrupt":
            window = int(fault.args.get("window", 4096))
            n_flips = int(fault.args.get("n_flips", 3))
            for _ in range(n_flips):
                off = rng.randrange(max(1, window))
                self._flips[off] = rng.randrange(8)

    def shape(self, stream: str, data: bytes) -> bytes:
        """Mutate (or gate) one chunk of ``stream`` ("request" |
        "response"); raises :class:`_CloseConn` when the fault says
        the connection dies here."""
        f = self.fault
        start = self._sent[stream]
        self._sent[stream] = start + len(data)
        if stream != self.when:
            return data
        if f.kind == "delay":
            time.sleep(self.delay_s)
        elif f.kind == "throttle":
            time.sleep(len(data) / max(1.0, self.bps))
        elif f.kind == "corrupt":
            buf = bytearray(data)
            for off, bit in self._flips.items():
                if start <= off < start + len(buf):
                    buf[off - start] ^= (1 << bit)
            data = bytes(buf)
        elif f.kind == "truncate":
            if start + len(data) > self.after:
                keep = max(0, self.after - start)
                raise _CloseConn(rst=False, flush=data[:keep])
        elif f.kind == "reset":
            if start + len(data) >= self.after:
                keep = max(0, self.after - start)
                raise _CloseConn(rst=True, flush=data[:keep])
        return data


class NetChaosProxy:
    """A TCP proxy fronting ``upstream`` that applies a
    :class:`NetworkPlan` deterministically, one evaluation per
    accepted connection.

    Mirrors :class:`chaos.injector.FaultInjector`'s contract:
    per-spec rng streams, per-proxy connection counter, first
    matching spec wins, every matching p-spec draws exactly once per
    connection, ``max_fires`` budgets live on the proxy. Fired
    faults count as ``net_chaos_faults_fired_total{site,kind}``,
    land in the flight recorder, and append to :attr:`fault_log` —
    two runs with the same (plan, seed, connection count) produce
    identical logs.
    """

    def __init__(self, upstream: Tuple[str, int], plan=None,
                 seed: Optional[int] = None, site: str = "net.replica",
                 name: Optional[str] = None,
                 listen_host: str = "127.0.0.1",
                 listen_port: int = 0):
        if site not in NET_SITES:
            raise ValueError(
                f"unknown network-chaos site {site!r}; known sites: "
                f"{sorted(NET_SITES)}")
        self.upstream = (upstream[0], int(upstream[1]))
        self.plan = parse_net_plan(plan if plan is not None else [])
        if seed is None:
            seed = self.plan.seed
        if seed is None:
            import os
            seed = int.from_bytes(os.urandom(4), "big")
        self.seed = int(seed)
        self.site = site
        # the name keys the rng streams: the fleet names proxies
        # "replica-<id>" so each replica's fire pattern is distinct
        # AND replayable (an ephemeral upstream port would be neither)
        self.name = name or site
        self.listen_host = listen_host
        self._listen_port = int(listen_port)
        self._lock = threading.Lock()
        self._rngs: Dict[int, random.Random] = {}
        self._spec_fired: List[int] = [0] * len(self.plan.faults)
        self.hits = 0
        self.fired_total = 0
        self.fault_log: List[dict] = []
        self._partition_until = 0.0
        self._partition_dir = "both"
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        if self._listener is None:
            raise RuntimeError("proxy not started")
        return self._listener.getsockname()[1]

    def start(self) -> "NetChaosProxy":
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.listen_host, self._listen_port))
        ls.listen(128)
        ls.settimeout(0.2)
        # a FRESH stop event per generation, handed to every thread
        # this generation spawns: a restart can never revive a
        # stopping predecessor's pumps
        stop = threading.Event()
        with self._lock:
            self._listener = ls
            self._stop = stop
            t = threading.Thread(
                target=self._accept_loop, args=(ls, stop),
                name=f"netchaos-{self.name}", daemon=True)
            self._accept_thread = t
        t.start()
        logger.warning(
            "net-chaos: proxy %s up on %s:%d -> %s:%d (%d spec(s), "
            "seed=%d — replay with this seed)", self.name,
            self.listen_host, self.port, self.upstream[0],
            self.upstream[1], len(self.plan.faults), self.seed)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._accept_thread = self._accept_thread, None
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            ls, self._listener = self._listener, None
            conns = list(self._conns)
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        for s in conns:
            try:
                s.close()
            except OSError:
                pass

    # -- manual triggers (tests drive partitions on a wall clock, not
    # -- a connection ordinal) ---------------------------------------------

    def partition(self, duration_s: float,
                  direction: str = "both") -> None:
        """Blackhole the hop for ``duration_s`` starting NOW, as if a
        ``partition`` spec had fired on this connection ordinal."""
        if direction not in _DIRECTIONS:
            raise ValueError(
                f"bad direction {direction!r}; one of "
                f"{sorted(_DIRECTIONS)}")
        with self._lock:
            n = self.hits
        f = NetFault(self.site, "partition",
                     {"duration_s": float(duration_s),
                      "direction": direction}, n, -1)
        self._apply_partition(f)
        self._account(f)

    def heal(self) -> None:
        """End an active partition early."""
        with self._lock:
            self._partition_until = 0.0

    def partitioned(self) -> bool:
        with self._lock:
            return time.monotonic() < self._partition_until

    # -- plan evaluation ---------------------------------------------------

    def _rng(self, spec_idx: int) -> random.Random:
        rng = self._rngs.get(spec_idx)
        if rng is None:
            rng = random.Random(self.seed ^ zlib.crc32(
                f"{self.name}#{spec_idx}".encode()))
            self._rngs[spec_idx] = rng
        return rng

    def _conn_rng(self, spec_idx: int, ordinal: int) -> random.Random:
        return random.Random(self.seed ^ zlib.crc32(
            f"{self.name}#{spec_idx}#conn{ordinal}".encode()))

    def _hit(self) -> Tuple[int, Optional[NetFault]]:
        """One accepted connection: first matching spec wins; every
        matching p-spec draws exactly once so each spec's stream is a
        pure function of the connection count."""
        with self._lock:
            self.hits += 1
            n = self.hits
            fired: Optional[NetFault] = None
            for i, spec in enumerate(self.plan.faults):
                if spec.site != self.site:
                    continue
                if spec.instance is not None \
                        and spec.instance != self.name:
                    continue
                if spec.at is not None:
                    want = n in spec.at
                else:
                    want = self._rng(i).random() < spec.p
                if not want:
                    continue
                if (spec.max_fires is not None
                        and self._spec_fired[i] >= spec.max_fires):
                    continue
                if fired is None:
                    self._spec_fired[i] += 1
                    fired = NetFault(self.site, spec.kind, spec.args,
                                     n, i)
            if fired is not None:
                self.fired_total += 1
        if fired is not None:
            self._account(fired)
        return n, fired

    def _account(self, fault: NetFault) -> None:
        with self._lock:
            self.fault_log.append({"conn": fault.ordinal,
                                   "kind": fault.kind,
                                   "spec": fault.spec_idx})
        logger.warning(
            "net-chaos: %s fault fired on %s (conn #%d)",
            fault.kind, self.name, fault.ordinal)
        try:
            from deeplearning4j_tpu_torch.observability.registry import (
                safe_inc)
            safe_inc("net_chaos_faults_fired_total",
                     help="network faults fired by the chaos proxy",
                     labels={"site": fault.site, "kind": fault.kind})
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.observability import flight_recorder
            rec = flight_recorder.get_recorder()
            if rec is not None:
                rec.record("net_chaos_fault", site=fault.site,
                           kind=fault.kind, ordinal=fault.ordinal,
                           proxy=self.name)
        except Exception:
            pass

    # -- data path ---------------------------------------------------------

    def _apply_partition(self, fault: NetFault) -> None:
        dur = float(fault.args.get("duration_s", 5.0))
        with self._lock:
            self._partition_until = time.monotonic() + dur
            self._partition_dir = fault.args.get("direction", "both")

    def _blocked(self, stream: str) -> bool:
        with self._lock:
            if time.monotonic() >= self._partition_until:
                return False
            d = self._partition_dir
        if d == "both":
            return True
        return (d == "inbound") if stream == "request" \
            else (d == "outbound")

    def _accept_loop(self, ls: socket.socket,
                     stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                conn, _addr = ls.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            n, fault = self._hit()
            if fault is not None and fault.kind == "partition":
                self._apply_partition(fault)
            threading.Thread(
                target=self._handle, args=(conn, n, fault, stop),
                name=f"netchaos-conn-{self.name}-{n}",
                daemon=True).start()

    def _track(self, sock: socket.socket, add: bool) -> None:
        with self._lock:
            if add:
                self._conns.add(sock)
            else:
                self._conns.discard(sock)

    def _handle(self, client: socket.socket, ordinal: int,
                fault: Optional[NetFault],
                stop: threading.Event) -> None:
        self._track(client, True)
        upstream: Optional[socket.socket] = None
        try:
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                              1)
            if fault is not None and fault.kind == "half_open":
                # the wedged peer: swallow the request, never answer
                self._drain_until_stop(client, stop)
                return
            # a partition (this connection's own fault, or one already
            # active) blackholes the dial when the request direction
            # is dark: hang, then die at heal — the client's bounded
            # deadline is what saves it. An outbound-only partition
            # still lets the request REACH upstream; the response
            # pump stalls instead.
            if self._blocked("request"):
                self._stall_through_partition(stop)
                return
            upstream = socket.create_connection(self.upstream,
                                                timeout=5.0)
            upstream.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            self._track(upstream, True)
            shaper = None
            if fault is not None and fault.kind not in ("partition",
                                                        "half_open"):
                shaper = _Shaper(fault, self._conn_rng(
                    fault.spec_idx, ordinal))
            done = threading.Event()
            rst = [False]
            t = threading.Thread(
                target=self._pump,
                args=(client, upstream, "request", shaper, done, rst,
                      stop),
                daemon=True)
            t.start()
            self._pump(upstream, client, "response", shaper, done,
                       rst, stop)
            done.set()
            t.join(timeout=5.0)
            if rst[0]:
                # a real RST, not a FIN: discard the send buffer
                try:
                    client.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
                except OSError:
                    pass
        except OSError:
            pass
        finally:
            for s in (upstream, client):
                if s is None:
                    continue
                self._track(s, False)
                try:
                    s.close()
                except OSError:
                    pass

    def _drain_until_stop(self, sock: socket.socket,
                          stop: threading.Event) -> None:
        sock.settimeout(0.2)
        while not stop.is_set():
            try:
                if not sock.recv(65536):
                    return
            except socket.timeout:
                continue
            except OSError:
                return

    def _stall_through_partition(self,
                                 stop: threading.Event) -> None:
        while not stop.is_set() and self._blocked("request"):
            time.sleep(0.05)
        # heal dooms the connection: fall through to close

    def _pump(self, src: socket.socket, dst: socket.socket,
              stream: str, shaper: Optional[_Shaper],
              done: threading.Event, rst: List[bool],
              stop: threading.Event) -> None:
        src.settimeout(0.2)
        while not stop.is_set() and not done.is_set():
            if self._blocked(stream):
                # stall while dark; the connection is doomed at heal
                while not stop.is_set() and self._blocked(stream):
                    time.sleep(0.05)
                break
            try:
                data = src.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            if shaper is not None:
                try:
                    data = shaper.shape(stream, data)
                except _CloseConn as c:
                    if c.flush:
                        try:
                            dst.sendall(c.flush)
                        except OSError:
                            pass
                    if c.rst:
                        rst[0] = True
                    break
            try:
                dst.sendall(data)
            except OSError:
                break
        done.set()
        # half-close toward the destination so well-behaved peers see
        # EOF promptly even if the other pump is still mid-stream
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass
