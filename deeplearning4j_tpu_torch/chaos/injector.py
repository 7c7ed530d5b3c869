"""Deterministic, seed-driven fault injection (counterpart of
``deeplearning4j_tpu/chaos/injector.py``).

A declarative **fault plan** names injection sites threaded through
the stack and what should go wrong there; a process-wide
:class:`FaultInjector` (``chaos.install(plan, seed=...)``) decides,
deterministically, when each fault fires; every fired fault is counted
on the unified MetricsRegistry (``chaos_faults_fired_total``) and
recorded by the flight recorder.

Determinism contract: each site draws from its OWN rng stream
(derived from ``seed`` + the site name), and each site keeps its own
hit counter, so the fire pattern at one site is a pure function of
(plan, seed, number of hits at that site) — thread interleaving
ACROSS sites cannot perturb it. Replaying a recorded seed replays
the faults.

The site table and the kinds each site allows are the JAX package's,
so a plan it accepts is accepted here. The port wires the sites whose
code it has: ``checkpoint.write`` / ``checkpoint.read``
(``util/model_serializer.py``), ``data.fetch`` (``data/iterators.py``)
``serving.worker.step`` (``serving/scheduler.py``,
``serving/continuous.py``), ``serving.kv.migrate``
(``serving/continuous.py``), ``serving.replica`` (``serving/router.py``),
``serving.replica.boot`` (``serving/fleet.py``), ``serving.rollout``
(``serving/rollout.py``) and ``ps.push.drop`` / ``ps.pull.timeout`` /
``ps.server.restart`` (``parallel/paramserver.py``). The others wait
for their modules (ROADMAP A6, A8); a plan naming them installs and
never fires.

==================== ====================================================
``checkpoint.write`` ``util/model_serializer.write_model`` — after the
                     zip is written (kinds: ``truncate``, ``corrupt``,
                     ``enospc``, ``error``)
``checkpoint.read``  ``util/model_serializer.restore_model`` — before
                     the zip is opened (``truncate``/``corrupt`` rot the
                     file at rest; ``error`` raises a transient IOError)
``data.fetch``       batch production in ``data/iterators.py``
                     (``error``, ``slow``) — retried by the shared
                     retry policy
``data.load``        real-file reads in ``data/fetchers.py``
                     (``error``, ``slow``)
``train.step``       ``train/fault_tolerance.ElasticTrainer`` right
                     before the train step (``crash``, ``hang``,
                     ``nan`` — the nan_injection fixture's poison, as a
                     plan-driven site — and ``sigterm``, which delivers
                     a REAL ``SIGTERM`` to the process at the seeded
                     ordinal: preemption as a replayable plan entry)
``serving.worker.step`` the serving backends' device step in
                     ``serving/scheduler.py`` / ``serving/continuous.py``
                     (``crash``, ``hang``, ``poison``)
``serving.replica``  one request routed by ``serving/router.py`` —
                     the WHOLE-replica fault site (``kill``: hard-stop
                     the replica at ``args.replica`` mid-load, the
                     seed-replayable SIGKILL; ``hang``/``slow``: stall
                     every handler on it by ``args.delay_s``, auto-
                     recovering after ``args.for_s`` when given)
``serving.replica.boot`` one replica BOOT in ``serving/fleet.py``
                     (``boot_fail``: the boot raises before the
                     listener opens — ``fleet.grow()`` retries with
                     bounded exponential backoff so the autoscaler's
                     control loop never wedges; ``boot_slow``: the
                     boot stalls ``args.delay_s`` first)
``parallel.device``  ``parallel/wrapper.ParallelWrapper`` right before
                     each data-parallel mesh step (``crash``, and
                     ``loss`` — simulate losing one mesh device; the
                     wrapper shrinks the mesh and continues)
``ps.push.drop``     one compressed-delta push received by the
                     parameter server (``drop``: swallow it unacked —
                     the worker retries the same sequence number and
                     the dedupe table keeps the retry idempotent)
``ps.pull.timeout``  one parameter pull served by the PS
                     (``timeout``: swallow the reply — the worker's
                     deadline expires and it re-pulls)
``ps.server.restart`` one PS push applied (``restart``:
                     crash-restart the server from its newest
                     durable checkpoint; workers reconnect)
``serving.rollout``  one RolloutController deployment step in
                     ``serving/rollout.py`` — canary boot and each
                     expansion replace (``bad_version``: the candidate
                     serves NaN-poisoned outputs, the gate must catch
                     it; ``slow_version``: the candidate's predict path
                     stalls ``args.delay_s`` per call, the latency gate
                     must catch it; ``stall``: the expansion step hangs
                     ``args.delay_s`` — operator ``abort`` still works)
==================== ====================================================

Generic kinds every site understands via :func:`step_fault`:
``crash`` (raise :class:`SimulatedCrashError`), ``hang`` / ``slow``
(sleep ``args.delay_s``), ``error`` (raise :class:`ChaosIOError` — an
``IOError``, so retry policies treat it as transient), ``enospc``
(raise :class:`ChaosOSError` with ``errno.ENOSPC``). File kinds
handled by :func:`file_fault`: ``truncate`` (cut the file to
``args.keep_frac``, default 0.5) and ``corrupt`` (overwrite a window
of bytes mid-file). Site-specific kinds (``nan``, ``poison``) are
returned to the call site to interpret.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["Fault", "FaultSpec", "FaultPlan", "FaultInjector",
           "ChaosError", "SimulatedCrashError", "ChaosIOError",
           "ChaosOSError", "SITES", "parse_plan", "install",
           "uninstall", "current", "hit", "step_fault", "file_fault"]


# ---------------------------------------------------------------------------
# typed injected failures
# ---------------------------------------------------------------------------

class ChaosError(RuntimeError):
    """Marker base for every injected failure: handlers can always
    tell a drill from a real incident."""


class SimulatedCrashError(ChaosError):
    """An injected process/worker crash (kind ``crash``)."""


class ChaosIOError(ChaosError, IOError):
    """An injected transient I/O failure (kind ``error``). Subclasses
    ``IOError`` so retry policies that retry ``OSError`` treat it
    exactly like the real thing."""


class ChaosOSError(ChaosError, OSError):
    """An injected OS-level failure with a real errno (kind
    ``enospc``). The MRO routes ``__init__`` through RuntimeError,
    which would leave ``errno`` unset — set it explicitly so handlers
    that branch on it see the real thing."""

    def __init__(self, err: int, msg: str):
        super().__init__(err, msg)
        self.errno = err
        self.strerror = msg


# the site table docs cite; registered here so every name exists as a
# code literal in exactly one authoritative place
SITES: Dict[str, str] = {
    "checkpoint.write": "model zip written to disk",
    "checkpoint.read": "model zip opened for restore",
    "data.fetch": "one minibatch produced by an iterator",
    "data.load": "one dataset file read by a fetcher",
    "train.step": "one ElasticTrainer train step",
    "serving.worker.step": "one serving-backend device step",
    "serving.replica": "one request routed to a fleet replica",
    "serving.replica.boot": "one fleet replica boot (scale-up / "
                            "replace successor)",
    "serving.kv.migrate": "one KV lease serialized or rebuilt "
                          "(prefill export, drain migration, import)",
    "parallel.device": "one ParallelWrapper data-parallel mesh step",
    "ps.push.drop": "one compressed-delta push received by the "
                    "parameter server (the worker's packet, lost "
                    "on the wire)",
    "ps.pull.timeout": "one parameter pull served by the parameter "
                       "server (the snapshot reply, lost on the "
                       "wire)",
    "ps.server.restart": "one parameter-server push applied "
                         "(crash-restart the PS from its last "
                         "durable checkpoint)",
    "serving.rollout": "one rollout deployment step (canary boot or "
                       "expansion replace) by the RolloutController",
}

# kinds every site understands via step_fault(), plus the
# site-specific ones its call site interprets — a typo'd or
# site-incompatible kind must fail at plan-parse time, not install
# cleanly and silently inject nothing while counting as fired
_GENERIC_KINDS = frozenset({"crash", "hang", "slow", "error",
                            "enospc"})
SITE_KINDS: Dict[str, frozenset] = {
    "checkpoint.write": _GENERIC_KINDS | {"truncate", "corrupt"},
    "checkpoint.read": _GENERIC_KINDS | {"truncate", "corrupt"},
    "data.fetch": _GENERIC_KINDS,
    "data.load": _GENERIC_KINDS,
    "train.step": _GENERIC_KINDS | {"nan", "sigterm"},
    "serving.worker.step": _GENERIC_KINDS | {"poison"},
    # whole-replica faults are interpreted by the FLEET, not
    # step_fault: kill hard-stops a replica, hang/slow stall all its
    # handlers (the generic kinds would fault the ROUTER's own
    # dispatch thread, which is not what a replica fault means)
    "serving.replica": frozenset({"kill", "hang", "slow"}),
    # boot faults are interpreted by ReplicaFleet._boot_replica:
    # boot_fail raises ReplicaBootError BEFORE the replica starts
    # (the autoscaler's grow() retries with bounded exponential
    # backoff instead of wedging the control loop), boot_slow
    # sleeps args.delay_s first (a replica importing jax forever)
    "serving.replica.boot": frozenset({"boot_fail", "boot_slow"}),
    # KV-migration faults are interpreted by ContinuousBatcher's
    # export/import paths: corrupt flips a payload byte AFTER the
    # CRC is stamped (the importer's integrity check must catch it
    # and the router must fall back), error raises a transient
    # ChaosIOError (the exporting slot stays put and finishes on the
    # incumbent), slow stalls the hop by args.delay_s
    "serving.kv.migrate": frozenset({"corrupt", "slow", "error"}),
    "parallel.device": _GENERIC_KINDS | {"loss"},
    # parameter-server faults are interpreted by ParameterServer's
    # request handlers (parallel/paramserver.py): drop swallows a
    # received push without applying OR acking it (the worker's
    # deadline expires and it retries the SAME sequence number — the
    # dedupe table makes the retry idempotent), timeout swallows a
    # pull reply the same way (the worker re-pulls), restart
    # crash-restarts the server in place from its newest durable
    # checkpoint (workers reconnect, re-hello and re-pull; versions
    # roll back to the last durable generation)
    "ps.push.drop": frozenset({"drop"}),
    "ps.pull.timeout": frozenset({"timeout"}),
    "ps.server.restart": frozenset({"restart"}),
    # rollout faults are interpreted by RolloutController's deploy
    # steps (serving/rollout.py): bad_version wraps the candidate's
    # models so predict returns NaN-poisoned outputs (the comparative
    # gate's error/shadow checks must catch it and roll back),
    # slow_version wraps them to stall args.delay_s per call (the
    # p99 gate must catch it), stall hangs the expansion step itself
    # for args.delay_s while still honoring operator abort
    "serving.rollout": frozenset({"bad_version", "slow_version",
                                  "stall"}),
}


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

class FaultSpec:
    """One declarative rule: WHERE (site), WHAT (kind), WHEN (``p``
    per-hit probability, or ``at`` — explicit 1-based hit ordinals),
    bounded by ``max_fires``; ``args`` parameterizes the kind
    (``delay_s``, ``keep_frac``, ...)."""

    __slots__ = ("site", "kind", "p", "at", "max_fires", "args")

    def __init__(self, site: str, kind: str, p: float = 0.0,
                 at: Optional[List[int]] = None,
                 max_fires: Optional[int] = None,
                 args: Optional[dict] = None):
        if site not in SITES:
            raise ValueError(
                f"unknown chaos site {site!r}; known sites: "
                f"{sorted(SITES)}")
        if kind not in SITE_KINDS[site]:
            raise ValueError(
                f"chaos site {site!r} does not support kind "
                f"{kind!r}; supported: {sorted(SITE_KINDS[site])}")
        if not (at or p > 0.0):
            raise ValueError(
                f"fault spec for {site!r}/{kind!r} can never fire: "
                "give it p > 0 or an 'at' schedule")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.at = None if at is None else {int(n) for n in at}
        self.max_fires = max_fires
        self.args = dict(args or {})

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        known = {"site", "kind", "p", "at", "max_fires", "args"}
        extra = set(d) - known
        if extra:
            raise ValueError(
                f"unknown fault-spec key(s) {sorted(extra)}; known: "
                f"{sorted(known)}")
        return cls(d["site"], d["kind"], p=d.get("p", 0.0),
                   at=d.get("at"), max_fires=d.get("max_fires"),
                   args=d.get("args"))

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
        return out


class FaultPlan:
    def __init__(self, faults: List[FaultSpec],
                 seed: Optional[int] = None):
        self.faults = list(faults)
        self.seed = seed

    def to_dict(self) -> dict:
        out = {"faults": [f.to_dict() for f in self.faults]}
        if self.seed is not None:
            out["seed"] = self.seed
        return out


def parse_plan(plan) -> FaultPlan:
    """Accepts a :class:`FaultPlan`, a list of spec dicts, a dict
    ``{"seed": ..., "faults": [...]}``, a JSON string of either, or a
    path to a JSON file."""
    if isinstance(plan, FaultPlan):
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
        raise TypeError(f"cannot parse a fault plan from "
                        f"{type(plan).__name__}")
    faults = [s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
              for s in plan.get("faults", [])]
    seed = plan.get("seed")
    return FaultPlan(faults, None if seed is None else int(seed))


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

class Fault:
    """One fired fault, handed to the call site."""

    __slots__ = ("site", "kind", "args", "ordinal")

    def __init__(self, site: str, kind: str, args: dict, ordinal: int):
        self.site = site
        self.kind = kind
        self.args = args
        self.ordinal = ordinal

    def __repr__(self):
        return (f"Fault(site={self.site!r}, kind={self.kind!r}, "
                f"ordinal={self.ordinal})")


class FaultInjector:
    """Evaluates a :class:`FaultPlan` deterministically.

    Per-site rng streams + per-site hit counters make the fire
    pattern at each site independent of thread interleaving across
    sites; ``seed`` (recorded and logged at install) replays it.
    """

    def __init__(self, plan, seed: Optional[int] = None):
        self.plan = parse_plan(plan)
        if seed is None:
            seed = self.plan.seed
        if seed is None:
            # no seed anywhere: draw one and RECORD it, so any chaotic
            # run is replayable after the fact
            seed = int.from_bytes(os.urandom(4), "big")
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[int, random.Random] = {}
        # per-spec fire counts live on the INJECTOR, not the spec: a
        # caller re-installing the same FaultPlan object for a replay
        # must start with fresh max_fires budgets
        self._spec_fired: List[int] = [0] * len(self.plan.faults)
        self.fired_total = 0

    def _rng(self, spec_idx: int, site: str) -> random.Random:
        # one stream per SPEC (stable crc32 of site + spec index), so
        # two p-specs on one site don't perturb each other either
        key = spec_idx
        rng = self._rngs.get(key)
        if rng is None:
            rng = random.Random(
                self.seed ^ zlib.crc32(f"{site}#{spec_idx}".encode()))
            self._rngs[key] = rng
        return rng

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def hit(self, site: str) -> Optional[Fault]:
        """Register one hit at ``site``; returns the fired
        :class:`Fault` (first matching spec wins) or None. Every
        matching p-spec draws its rng exactly once per hit whether or
        not an earlier spec fired, keeping each spec's stream a pure
        function of the site hit count."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            fired: Optional[Fault] = None
            for i, spec in enumerate(self.plan.faults):
                if spec.site != site:
                    continue
                if spec.at is not None:
                    want = n in spec.at
                else:
                    want = self._rng(i, site).random() < spec.p
                if not want:
                    continue
                if (spec.max_fires is not None
                        and self._spec_fired[i] >= spec.max_fires):
                    continue
                if fired is None:
                    self._spec_fired[i] += 1
                    fired = Fault(site, spec.kind, spec.args, n)
            if fired is not None:
                self.fired_total += 1
        if fired is not None:
            self._account(fired)
        return fired

    def _account(self, fault: Fault) -> None:
        logger.warning("chaos: fault fired at %s (kind=%s, hit #%d)",
                       fault.site, fault.kind, fault.ordinal)
        try:
            from deeplearning4j_tpu_torch.observability.registry import (
                safe_inc)
            safe_inc("chaos_faults_fired_total",
                     help="injected faults fired by the chaos harness",
                     labels={"site": fault.site, "kind": fault.kind})
        except Exception:
            pass
        try:
            from deeplearning4j_tpu_torch.observability import flight_recorder
            rec = flight_recorder.get_recorder()
            if rec is not None:
                rec.record("chaos_fault", site=fault.site,
                           kind=fault.kind, ordinal=fault.ordinal)
        except Exception:
            pass

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hits)


# ---------------------------------------------------------------------------
# process-wide install + call-site helpers
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None
_INSTALL_LOCK = threading.Lock()


def install(plan, seed: Optional[int] = None) -> FaultInjector:
    """Install a process-wide injector; returns it. The effective
    seed is logged so any run is replayable."""
    global _ACTIVE
    inj = FaultInjector(plan, seed=seed)
    with _INSTALL_LOCK:
        _ACTIVE = inj
    logger.warning(
        "chaos: installed fault plan (%d spec(s), seed=%d — replay "
        "with this seed)", len(inj.plan.faults), inj.seed)
    return inj


def uninstall() -> None:
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


def current() -> Optional[FaultInjector]:
    return _ACTIVE


def hit(site: str) -> Optional[Fault]:
    """Hot-path entry: ~one attribute read when no injector is
    installed."""
    inj = _ACTIVE
    return None if inj is None else inj.hit(site)


def step_fault(site: str) -> Optional[Fault]:
    """Hit ``site`` and APPLY the generic kinds: ``crash`` raises,
    ``hang``/``slow`` sleep, ``error`` raises a transient
    :class:`ChaosIOError`, ``enospc`` raises :class:`ChaosOSError`.
    Any other kind is returned for the call site to interpret."""
    f = hit(site)
    if f is None:
        return None
    if f.kind == "crash":
        raise SimulatedCrashError(
            f"[chaos] simulated crash at {site} (hit #{f.ordinal})")
    if f.kind in ("hang", "slow"):
        time.sleep(float(f.args.get("delay_s", 0.05)))
        return f
    if f.kind == "error":
        raise ChaosIOError(
            f"[chaos] transient I/O fault at {site} "
            f"(hit #{f.ordinal})")
    if f.kind == "enospc":
        raise ChaosOSError(
            errno.ENOSPC,
            f"[chaos] no space left on device at {site} "
            f"(hit #{f.ordinal})")
    return f


def file_fault(site: str, path: str) -> Optional[Fault]:
    """:func:`step_fault` plus the file kinds, applied to ``path``:
    ``truncate`` keeps only ``args.keep_frac`` (default 0.5) of the
    file; ``corrupt`` overwrites a byte window in the middle."""
    f = step_fault(site)
    if f is None:
        return None
    try:
        size = os.path.getsize(path)
    except OSError:
        return f
    if f.kind == "truncate":
        keep = max(0, int(size * float(f.args.get("keep_frac", 0.5))))
        with open(path, "r+b") as fh:
            fh.truncate(keep)
        logger.warning("chaos: truncated %s to %d/%d bytes", path,
                       keep, size)
    elif f.kind == "corrupt":
        n = min(64, max(1, size // 4))
        pos = max(0, size // 2 - n // 2)
        junk = random.Random((f.ordinal * 2654435761)
                             & 0xFFFFFFFF).randbytes(n)
        with open(path, "r+b") as fh:
            fh.seek(pos)
            fh.write(junk)
        logger.warning("chaos: corrupted %d bytes of %s at offset %d",
                       n, path, pos)
    return f
