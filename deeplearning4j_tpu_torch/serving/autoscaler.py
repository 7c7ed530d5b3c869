"""SLO-driven autoscaler: the closed loop that makes the fleet run

(Counterpart of ``deeplearning4j_tpu/serving/autoscaler.py``, copied with the
imports renamed: host code, no device tensor.)
itself.

Every sensor and actuator already existed — ``observability/slo.py``
multi-window burn rates, the router's probed queue-depth and paged-KV
pressure gauges, ``fleet.grow()`` / ``fleet.retire()`` — but a human
had to turn the knobs, so a traffic spike or a SIGKILL burned the SLO
until someone noticed. :class:`Autoscaler` closes the loop (the
TF-Serving operational story, PAPERS.md 1605.08695): each tick it
reads three signals and actuates the fleet —

- **SLO burn** — ``SLOMonitor.any_breached()``: the user-facing
  objective is the primary scale-up trigger;
- **queue pressure** — mean OUTSTANDING work per serving replica
  (probed backend queue depth + router-side in-flight; a queued
  request appears in both, so the watermarks are calibrated to
  outstanding work, not pure backlog), against high/low marks;
- **KV pressure** — fleet-wide paged-KV pool utilisation (a decode
  fleet can be latency-fine and still one admission away from 429s).

Decisions are deliberately boring, because boring is what keeps a
control loop from oscillating:

- **boot-first scale-up** through ``fleet.grow()``: the successor is
  serving before it is counted as capacity, and a failed boot
  retries under bounded exponential backoff inside ``grow`` (chaos
  ``serving.replica.boot``) — a boot crash-loop costs the tick a
  typed error, never a wedge;
- **drain-based scale-down** through ``fleet.retire()``: the victim
  is the serving replica with the FEWEST pinned generate sessions
  (tie: shallowest queue), it stops receiving new sends at the very
  next router pick, and its pinned streams finish — scale-down
  drops nothing. The drain runs on a worker thread so a slow stream
  cannot stall the control loop;
- **hysteresis**: a direction must hold for ``up_consecutive`` /
  ``down_consecutive`` ticks before it actuates — one noisy sample
  cannot flap the pool;
- **per-direction cooldowns**: after an up, further ups wait
  ``up_cooldown_s`` and downs wait ``down_cooldown_s`` (capacity
  just added must prove itself before being taken away);
- **min/max bounds**, with draining members excluded from the
  serving count.

Everything is injectable (``clock``, duck-typed fleet/router/SLO
monitor), so the decision logic unit-tests under a fake clock with
zero sleeps. Verdicts are published on the registry:
``autoscaler_scale_events_total{direction}``,
``autoscaler_replicas`` / ``autoscaler_target_replicas``,
``autoscaler_ticks_total``, ``autoscaler_boot_failures_total``, and
``autoscaler_pressure`` (-1 / 0 / +1, the raw per-tick vote).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.serving.errors import ReplicaBootError
from deeplearning4j_tpu_torch.serving.fleet import UP

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["Autoscaler"]


class Autoscaler:
    """Closed control loop over a :class:`~.fleet.ReplicaFleet` and
    its :class:`~.router.Router`.

    ``slos`` is an optional
    :class:`~deeplearning4j_tpu_torch.observability.slo.SLOMonitor`
    (typically over the ROUTER's registry, so the objective covers
    what clients actually experienced — failover and hedging
    included). ``tick()`` is the whole decision function and is
    public: tests drive it directly under a fake ``clock``;
    ``start()`` runs it on a daemon thread every
    ``tick_interval_s``.
    """

    def __init__(self, fleet, router, slos=None,
                 registry=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 tick_interval_s: float = 1.0,
                 queue_high: float = 8.0, queue_low: float = 1.0,
                 kv_high: float = 0.9,
                 up_consecutive: int = 2, down_consecutive: int = 10,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 30.0,
                 boot_retries: int = 3,
                 drain_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 collector=None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        if queue_low >= queue_high:
            raise ValueError(
                f"queue_low ({queue_low}) must sit below queue_high "
                f"({queue_high}) — the hysteresis band between them "
                "is what stops flapping")
        self.fleet = fleet
        self.router = router
        self.slos = slos
        # optional FleetCollector: when attached, signals() prefers
        # its MERGED per-replica series (the fleet-level view) and
        # falls back to the router's direct probes the moment the
        # collector's data is stale or errors — the collector is an
        # observer, never a dependency
        self.collector = collector
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.tick_interval_s = float(tick_interval_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.kv_high = float(kv_high)
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.boot_retries = int(boot_retries)
        self.drain_timeout_s = float(drain_timeout_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._up_ticks = 0
        self._down_ticks = 0
        self._no_up_until = -float("inf")
        self._no_down_until = -float("inf")
        self._boot_backoff_until = -float("inf")
        self._boot_failures = 0
        self._retire_threads: List[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # hold tokens: while any are present the control loop holds
        # the pool steady (no actuation, no hysteresis accrual) — a
        # RolloutController pauses scaling so grow/retire can't
        # fight its one-replica-at-a-time replace ladder
        self._paused: set = set()
        if registry is None:
            registry = getattr(router, "registry", None)
        if registry is None:
            from deeplearning4j_tpu_torch.observability.registry import (
                MetricsRegistry)
            registry = MetricsRegistry()
        self.registry = registry
        # instruments created ONCE at init (GL006)
        self._scale_events = {
            d: registry.counter(
                "autoscaler_scale_events_total",
                help="fleet size changes actuated by the autoscaler",
                labels={"direction": d})
            for d in ("up", "down")}
        self._ticks = registry.counter(
            "autoscaler_ticks_total",
            help="autoscaler control-loop evaluations")
        self._boot_failures_c = registry.counter(
            "autoscaler_boot_failures_total",
            help="scale-up attempts abandoned after the boot retry "
                 "budget (re-attempted next tick)")
        self._replicas_g = registry.gauge(
            "autoscaler_replicas",
            help="serving replicas (draining members excluded)",
            fn=self._serving_count)
        self._target_g = registry.gauge(
            "autoscaler_target_replicas",
            help="the autoscaler's current target fleet size")
        self._pressure_g = registry.gauge(
            "autoscaler_pressure",
            help="last tick's raw vote: +1 scale-up pressure, "
                 "-1 scale-down pressure, 0 in the dead band")
        self._target_g.set(self._serving_count())

    # ------------------------------------------------------------------
    # sensors
    # ------------------------------------------------------------------
    def _serving_count(self) -> int:
        """Pool members that count as capacity: draining replicas
        are already on their way out."""
        try:
            return self.fleet.size() - self.fleet.draining_count()
        except AttributeError:
            return self.fleet.size()

    def signals(self) -> dict:
        """One coherent sensor read: SLO breach, mean queue depth
        per serving replica, fleet KV utilisation, eligible count.
        ``sensors_ok`` False means a sensor read itself FAILED (the
        router load read, or the SLO evaluation when one is
        configured) — missing data, which must hold the pool
        steady: not be mistaken for a starved fleet and scaled
        into, and not read as "no breach" and scaled down during a
        real one."""
        breached = False
        sensors_ok = True
        if self.slos is not None:
            try:
                breached = bool(self.slos.any_breached())
            except Exception:
                sensors_ok = False
                logger.exception("autoscaler: SLO evaluation failed")
        loads = None
        if self.collector is not None:
            try:
                loads = self.collector.load_signals()
            except Exception:
                # stale or broken merged view: NOT a sensor failure —
                # the router's direct probes below still answer
                loads = None
        if loads is None:
            loads = []
            try:
                loads = self.router.load_signals()
            except Exception:
                sensors_ok = False
                logger.exception(
                    "autoscaler: router load read failed")
        eligible = [v for v in loads if v.get("eligible")]
        if eligible:
            queue_mean = sum(v["queue_depth"] + v["inflight"]
                             for v in eligible) / len(eligible)
        else:
            queue_mean = 0.0
        kv_total = sum(v["kv_pages_total"] for v in loads)
        kv_used = sum(v["kv_pages_in_use"] for v in loads)
        kv_frac = (kv_used / kv_total) if kv_total > 0 else 0.0
        return {"slo_breached": breached,
                "queue_mean": queue_mean,
                "kv_frac": kv_frac,
                "eligible": len(eligible),
                # views the prober has actually classified: a fresh
                # replica is "unprobed", which is booting, not dead
                "probed": sum(1 for v in loads
                              if v.get("health") != "unprobed"),
                "serving": self._serving_count(),
                "sensors_ok": sensors_ok}

    # ------------------------------------------------------------------
    # the decision function
    # ------------------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One control-loop evaluation: read sensors, update the
        hysteresis counters, actuate when a direction has earned it.
        Returns ``"up"`` / ``"down"`` when the fleet was actuated,
        None otherwise."""
        self._ticks.inc()
        with self._lock:
            paused = bool(self._paused)
        if paused:
            # an active rollout owns the pool: scaling mid-rollout
            # would race the controller's capacity-neutral replace
            # ladder (a scale-down could drain the canary; a
            # scale-up would boot off-plan incumbents mid-
            # expansion). Held exactly like a failed sensor read —
            # hysteresis counters included.
            self._pressure_g.set(0.0)
            return None
        now = self.clock()
        s = self.signals()
        if not s["sensors_ok"]:
            # a failed sensor read is indistinguishable from a
            # starved fleet on the numbers alone — but actuating on
            # MISSING data is how an autoscaler runs away to
            # max_replicas on a dead prober. Hold everything,
            # including the hysteresis counters.
            self._pressure_g.set(0.0)
            return None
        serving = s["serving"]
        # a fleet with capacity but nothing eligible (mass ejection,
        # unannounced deaths the prober has SEEN) is the loudest
        # scale-up signal there is — but only once at least one view
        # has actually been probed: a fresh pool whose replicas are
        # all still "unprobed" is booting, and scaling into it would
        # boot spurious capacity on an idle fleet whenever the probe
        # interval outlasts the hysteresis window
        starved = (serving > 0 and s["eligible"] == 0
                   and s["probed"] > 0)
        pressure_up = (s["slo_breached"]
                       or s["queue_mean"] >= self.queue_high
                       or s["kv_frac"] >= self.kv_high
                       or starved
                       or serving < self.min_replicas)
        # scale-down needs POSITIVE evidence of idleness (an
        # eligible replica whose queue is shallow) — an all-unprobed
        # pool's queue_mean is 0.0 by construction, not by idleness
        pressure_down = (not s["slo_breached"]
                         and not starved
                         and s["eligible"] > 0
                         and s["queue_mean"] <= self.queue_low
                         and s["kv_frac"] < self.kv_high
                         and serving > self.min_replicas)
        with self._lock:
            self._up_ticks = self._up_ticks + 1 if pressure_up else 0
            self._down_ticks = (self._down_ticks + 1
                                if pressure_down else 0)
            up_ready = (self._up_ticks >= self.up_consecutive
                        and now >= self._no_up_until
                        and now >= self._boot_backoff_until
                        and serving < self.max_replicas)
            # below-min is an integrity repair, not a judgement call:
            # it skips hysteresis (but still honours the boot
            # backoff, or a failing boot path would hot-loop)
            if (serving < self.min_replicas
                    and now >= self._boot_backoff_until):
                up_ready = True
            down_ready = (self._down_ticks >= self.down_consecutive
                          and now >= self._no_down_until
                          and serving > self.min_replicas)
        self._pressure_g.set(
            1.0 if pressure_up else (-1.0 if pressure_down else 0.0))
        if up_ready:
            return self._scale_up(now, s)
        if down_ready:
            return self._scale_down(now, s)
        return None

    # ------------------------------------------------------------------
    # actuators
    # ------------------------------------------------------------------
    def _scale_up(self, now: float, s: dict) -> Optional[str]:
        try:
            replica = self.fleet.grow(
                max_boot_retries=self.boot_retries)
        except ReplicaBootError as e:
            # the retry budget inside grow() is spent: log, count,
            # arm a bounded backoff, and let the NEXT tick try again
            # — the control loop must never wedge on a bad boot path
            with self._lock:
                self._boot_failures += 1
                delay = min(30.0, 1.0 * (2.0 ** min(
                    self._boot_failures - 1, 5)))
                self._boot_backoff_until = now + delay
            self._boot_failures_c.inc()
            logger.error(
                "autoscaler: scale-up boot failed after retries "
                "(%r); re-attempting in %.1fs", e, delay)
            return None
        with self._lock:
            self._boot_failures = 0
            self._boot_backoff_until = -float("inf")
            self._up_ticks = 0
            self._down_ticks = 0
            self._no_up_until = now + self.up_cooldown_s
            # fresh capacity must prove itself before any scale-down
            self._no_down_until = max(self._no_down_until,
                                      now + self.down_cooldown_s)
        self._scale_events["up"].inc()
        self._target_g.set(self._serving_count())
        logger.warning(
            "autoscaler: scaled UP to %d (replica %d booted; "
            "slo_breached=%s queue_mean=%.1f kv=%.0f%%)",
            self._serving_count(), replica.id, s["slo_breached"],
            s["queue_mean"], 100 * s["kv_frac"])
        return "up"

    def _pick_scale_down_victim(self) -> Optional[int]:
        """The replica whose drain breaks the least: fewest pinned
        generate sessions first (their streams finish during the
        drain, but future requests of those sessions must re-pin),
        then shallowest probed queue. Only fleet-``up`` members
        qualify — never one already draining."""
        try:
            pins = self.router.pinned_sessions()
        except Exception:
            pins = {}
        try:
            loads = {v["rid"]: v
                     for v in self.router.load_signals()}
        except Exception:
            # same policy as signals(): a failed sensor read must
            # not crash the tick — fall back to pins-only selection
            loads = {}
        candidates = [r.id for r in self.fleet.snapshot()
                      if r.fleet_state == UP]
        if len(candidates) <= self.min_replicas:
            return None
        return min(candidates,
                   key=lambda rid: (pins.get(rid, 0),
                                    loads.get(rid, {}).get(
                                        "queue_depth", 0.0),
                                    -rid))

    def _scale_down(self, now: float, s: dict) -> Optional[str]:
        victim = self._pick_scale_down_victim()
        if victim is None:
            return None
        with self._lock:
            self._up_ticks = 0
            self._down_ticks = 0
            self._no_down_until = now + self.down_cooldown_s
        self._scale_events["down"].inc()
        logger.warning(
            "autoscaler: scaling DOWN — retiring replica %d "
            "(fewest pinned sessions; queue_mean=%.1f)", victim,
            s["queue_mean"])
        # the drain lets pinned streams finish, which can take as
        # long as the longest stream: run it off the control thread
        # so ticks (and a scale-up reversal) stay live meanwhile
        t = threading.Thread(
            target=self.fleet.retire, args=(victim,),
            kwargs={"drain_timeout": self.drain_timeout_s},
            daemon=True, name=f"autoscaler-retire-{victim}")
        t.start()
        with self._lock:
            self._retire_threads = [x for x in self._retire_threads
                                    if x.is_alive()]
            self._retire_threads.append(t)
        # the DECIDED target, not a re-read: the retire thread may
        # not have flipped the victim to draining yet, and the gauge
        # must show where the pool is headed the moment the decision
        # lands
        self._target_g.set(max(self.min_replicas, s["serving"] - 1))
        return "down"

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed")

    def start(self) -> "Autoscaler":
        # each loop generation gets its OWN stop event (GL007 — the
        # AlertManager revive bug class): clear()ing a shared event
        # can race the previous, still-stopping generation — the
        # clear lands before that loop observes the set, reviving it
        # with no handle on it
        stop = threading.Event()
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt = stop
            self._thread = threading.Thread(
                target=self._loop, args=(stop,), daemon=True,
                name="autoscaler")
            self._thread.start()
        logger.info(
            "autoscaler: control loop up (bounds %d..%d, tick "
            "%.1fs, queue watermarks %.1f/%.1f, cooldowns "
            "up=%.0fs down=%.0fs)", self.min_replicas,
            self.max_replicas, self.tick_interval_s, self.queue_low,
            self.queue_high, self.up_cooldown_s,
            self.down_cooldown_s)
        return self

    def stop(self, wait_retires: bool = True) -> None:
        # set under the SAME lock as the thread swap: set outside, a
        # racing start() could swap in a fresh event between our set
        # and our swap
        with self._lock:
            self._stop_evt.set()
            t, self._thread = self._thread, None
            retires = list(self._retire_threads)
        if t is not None:
            t.join(timeout=5.0)
        if wait_retires:
            for rt in retires:
                rt.join(timeout=self.drain_timeout_s + 5.0)

    # ------------------------------------------------------------------
    # external coordination
    # ------------------------------------------------------------------
    def pause(self, token: str = "rollout") -> None:
        """Hold all scaling while ``token`` is outstanding (tokens
        are a set: two concurrent holders each resume their own)."""
        with self._lock:
            self._paused.add(str(token))

    def resume(self, token: str = "rollout") -> None:
        with self._lock:
            self._paused.discard(str(token))

    @property
    def paused(self) -> bool:
        with self._lock:
            return bool(self._paused)

    def debug(self) -> dict:
        """The operator's one-look payload (also what the soak
        asserts on)."""
        with self._lock:
            state = {"up_ticks": self._up_ticks,
                     "down_ticks": self._down_ticks,
                     "boot_failures": self._boot_failures,
                     "paused_by": sorted(self._paused)}
        s = self.signals()
        return {"signals": s,
                "bounds": [self.min_replicas, self.max_replicas],
                "scale_ups": int(self._scale_events["up"].value),
                "scale_downs": int(self._scale_events["down"].value),
                **state}
