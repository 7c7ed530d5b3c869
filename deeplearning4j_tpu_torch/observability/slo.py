"""Service-level objectives as multi-window burn rates.

Counterpart of ``deeplearning4j_tpu/observability/slo.py``
(host code, stdlib only).

A threshold alert ("p99 > 250 ms") pages on blips and sleeps through
slow burns; an SLO pages on **budget consumption velocity**. An
:class:`SLO` declares an objective over a window — "99% of predicts
under 50 ms over 30 minutes" — and :class:`SLOMonitor` evaluates it
the way the SRE workbook prescribes: the **burn rate** is the ratio
of the observed bad fraction to the budget (``1 - objective``), and
a breach requires BOTH a long window (enough evidence) and a short
window (still happening right now) to exceed the factor — a spike
that already recovered cannot page, and neither can a stale incident.

Good/total counts come straight off the metrics registry:

- **latency SLOs** (``threshold_s`` set): good = requests at or under
  the threshold, read from the cumulative buckets of a registered
  histogram (``serving_latency_seconds`` by default);
- **availability SLOs** (no threshold): good = total - errors, read
  from the ``serving_requests_total`` / ``serving_errors_total``
  counter pair.

The monitor keeps a ring of ``(t, good, total)`` samples per SLO (the
registry's instruments are cumulative, so windowed rates are sample
deltas), and publishes its verdicts back onto the registry:
``slo_burn_rate{slo,window}`` gauges plus a 0/1 ``slo_breach{slo}``
pull gauge whose read triggers a (rate-limited) evaluation — so an
``AlertManager`` rule over ``slo_breach`` (see :meth:`install`) stays
fresh whether it is polled by ``/healthz``, the background alert
thread, or a scraper. On a fresh breach the monitor captures the
**offending trace ids** (the exemplars sitting in the buckets above
the threshold) into the flight recorder and dumps a bundle: the page
arrives with the traces that burned the budget.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.observability.registry import (
    Counter, Histogram, MetricsRegistry)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["SLO", "BurnWindow", "SLOMonitor", "compare_cohorts"]


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate condition: fire when burn exceeds
    ``factor`` over BOTH the long and the short window."""

    short_s: float
    long_s: float
    factor: float
    severity: str = "page"


def default_burn_windows(window_s: float) -> List[BurnWindow]:
    """The SRE-workbook pairs, scaled to the SLO window: a fast-burn
    page (budget gone in ~window/14 at this rate) and a slow-burn
    ticket."""
    w = float(window_s)
    return [BurnWindow(short_s=max(15.0, w / 30.0),
                       long_s=max(60.0, w / 6.0),
                       factor=14.4, severity="page"),
            BurnWindow(short_s=max(60.0, w / 6.0), long_s=w,
                       factor=6.0, severity="ticket")]


@dataclasses.dataclass
class SLO:
    """One declarative objective.

    ``threshold_s`` set → latency SLO over a histogram; unset →
    availability SLO over the good/total counter pair."""

    name: str
    objective: float = 0.99
    threshold_s: Optional[float] = None
    metric: str = "serving_latency_seconds"
    labels: Optional[Dict[str, str]] = None
    window_s: float = 1800.0
    total_metric: str = "serving_requests_total"
    bad_metric: str = "serving_errors_total"
    windows: Optional[List[BurnWindow]] = None
    description: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        if self.windows is None:
            self.windows = default_burn_windows(self.window_s)

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @classmethod
    def from_config(cls, cfg: dict) -> "SLO":
        """Build from the JSON rule schema (see README "Request
        tracing & SLOs"): ``threshold_ms``/``window_m`` are the
        human-units spellings; ``endpoint`` is shorthand for
        ``labels={"endpoint": ...}``."""
        cfg = dict(cfg)
        if "threshold_ms" in cfg:
            cfg["threshold_s"] = float(cfg.pop("threshold_ms")) / 1e3
        if "window_m" in cfg:
            cfg["window_s"] = float(cfg.pop("window_m")) * 60.0
        if "endpoint" in cfg:
            labels = dict(cfg.get("labels") or {})
            labels["endpoint"] = cfg.pop("endpoint")
            cfg["labels"] = labels
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(
                f"unknown SLO config key(s) {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls(**cfg)


def compare_cohorts(baseline: dict, candidate: dict, *,
                    min_requests: int = 50,
                    max_p99_ratio: float = 1.5,
                    max_error_rate_delta: float = 0.02,
                    p99_floor_ms: float = 5.0) -> dict:
    """Comparative two-cohort SLO evaluation — the rollout gate.

    Each cohort is ``{"requests": int, "errors": int, "p99_ms":
    float}`` (a FleetCollector ``cohort_stats`` row). The verdict is
    evidence-based, never wall-clock-only:

    - ``hold``: the candidate has fewer than ``min_requests``
      requests — not enough evidence to promote OR to roll back;
    - ``fail``: candidate error rate exceeds the baseline's by more
      than ``max_error_rate_delta`` (gate ``error_rate``), or
      candidate p99 exceeds ``max_p99_ratio`` x the baseline p99
      (gate ``p99`` — the baseline is floored at ``p99_floor_ms``
      so a sub-millisecond baseline cannot flunk a healthy
      candidate on noise);
    - ``pass``: both checks clear with sufficient evidence.

    Returns ``{"verdict", "gate", "detail", "baseline",
    "candidate"}`` — ``gate`` names the failed (or held) check,
    None on pass."""
    base_n = int(baseline.get("requests", 0) or 0)
    cand_n = int(candidate.get("requests", 0) or 0)
    out = {"verdict": "pass", "gate": None, "detail": "",
           "baseline": dict(baseline), "candidate": dict(candidate)}
    if cand_n < int(min_requests):
        out.update(verdict="hold", gate="min_requests",
                   detail=f"candidate has {cand_n} request(s), "
                          f"gate needs {int(min_requests)} — "
                          f"holding, not promoting")
        return out
    base_rate = (float(baseline.get("errors", 0) or 0) / base_n
                 if base_n else 0.0)
    cand_rate = float(candidate.get("errors", 0) or 0) / cand_n
    if cand_rate > base_rate + float(max_error_rate_delta):
        out.update(verdict="fail", gate="error_rate",
                   detail=f"candidate error rate {cand_rate:.4f} "
                          f"exceeds baseline {base_rate:.4f} + "
                          f"delta {float(max_error_rate_delta)}")
        return out
    base_p99 = max(float(baseline.get("p99_ms", 0.0) or 0.0),
                   float(p99_floor_ms))
    cand_p99 = float(candidate.get("p99_ms", 0.0) or 0.0)
    if cand_p99 > float(max_p99_ratio) * base_p99:
        out.update(verdict="fail", gate="p99",
                   detail=f"candidate p99 {cand_p99:.1f}ms exceeds "
                          f"{float(max_p99_ratio)}x baseline "
                          f"{base_p99:.1f}ms")
        return out
    out["detail"] = (f"candidate ok over {cand_n} request(s): "
                     f"error rate {cand_rate:.4f} vs baseline "
                     f"{base_rate:.4f}, p99 {cand_p99:.1f}ms vs "
                     f"baseline {base_p99:.1f}ms")
    return out


class _SloState:
    __slots__ = ("samples", "breached", "burns", "last_change",
                 "gauges")

    def __init__(self):
        # (t, good, total) — cumulative readings; windowed rates are
        # deltas between samples
        self.samples: collections.deque = collections.deque(
            maxlen=4096)
        self.breached = False
        self.burns: Dict[str, float] = {}
        self.last_change: Optional[float] = None
        # burn-rate gauges, pre-created at add() time (window names
        # are known up front; instruments are never created inside
        # the evaluation loop)
        self.gauges: Dict[str, object] = {}


class SLOMonitor:
    """Evaluate SLO burn rates against one registry.

    ``evaluate()`` is cheap (a handful of counter reads) and
    rate-limited, so /healthz handlers, gauge pulls and the alert
    thread can all trigger it without stacking samples. ``clock`` is
    injectable for deterministic tests."""

    def __init__(self, registry: MetricsRegistry,
                 slos: Sequence[SLO] = (),
                 clock: Callable[[], float] = time.monotonic,
                 min_eval_interval_s: float = 1.0,
                 on_breach: Optional[Callable[[dict], None]] = None):
        self.registry = registry
        self.clock = clock
        self.min_eval_interval_s = min_eval_interval_s
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._slos: Dict[str, SLO] = {}
        self._state: Dict[str, _SloState] = {}
        self._last_eval = -float("inf")
        for s in slos:
            self.add(s)

    @classmethod
    def from_config(cls, registry: MetricsRegistry, config,
                    **kw) -> "SLOMonitor":
        """``config`` is a list of rule dicts, a JSON string, a path
        to a JSON file holding either, or ``@path`` (CLI idiom)."""
        if isinstance(config, str):
            if config.startswith("@"):
                with open(config[1:], encoding="utf-8") as f:
                    data = json.load(f)
            else:
                try:
                    data = json.loads(config)
                except ValueError:
                    with open(config, encoding="utf-8") as f:
                        data = json.load(f)
        else:
            data = config
        if isinstance(data, dict):
            data = data.get("slos", [data])
        return cls(registry, [SLO.from_config(c) for c in data], **kw)

    def add(self, slo: SLO) -> SLO:
        st = _SloState()
        with self._lock:
            self._slos[slo.name] = slo
            self._state[slo.name] = st
        # verdict gauges: breach is a PULL gauge so any reader (the
        # alert thread, a scraper) gets a fresh, rate-limited
        # evaluation; burn rates are SET gauges pre-created here and
        # updated by evaluate()
        self.registry.gauge(
            "slo_breach",
            help="1 while the SLO's multi-window burn-rate condition "
                 "holds", labels={"slo": slo.name},
            fn=lambda name=slo.name: self._breach_value(name))
        for w in slo.windows:
            for wname in (f"{int(w.long_s)}s", f"{int(w.short_s)}s"):
                st.gauges[wname] = self.registry.gauge(
                    "slo_burn_rate",
                    help="error-budget burn rate (bad fraction / "
                         "budget) over the trailing window",
                    labels={"slo": slo.name, "window": wname})
        return slo

    def remove(self, name: str) -> None:
        """Drop one SLO and unregister its verdict gauges — the
        pairing half of ``add``: a monitor whose SLO set is
        reconfigured (or a discarded monitor, via :meth:`close`)
        must not leave breach/burn gauges whose callbacks pin it on
        the shared registry."""
        with self._lock:
            slo = self._slos.pop(name, None)
            self._state.pop(name, None)
        if slo is None:
            return
        self.registry.unregister("slo_breach",
                                 labels={"slo": slo.name})
        for w in slo.windows:
            for wname in (f"{int(w.long_s)}s", f"{int(w.short_s)}s"):
                self.registry.unregister(
                    "slo_burn_rate",
                    labels={"slo": slo.name, "window": wname})

    def close(self) -> None:
        """Unregister every SLO's gauges (see :meth:`remove`)."""
        with self._lock:
            names = list(self._slos)
        for name in names:
            self.remove(name)

    # ------------------------------------------------------------------
    # readings
    # ------------------------------------------------------------------
    def _read(self, slo: SLO) -> Optional[Tuple[float, float]]:
        """(good, total) cumulative counts, or None when the metric
        is not registered yet (no traffic — nothing to burn)."""
        if slo.threshold_s is not None:
            m = self.registry.get(slo.metric, slo.labels)
            if not isinstance(m, Histogram):
                return None
            edges, counts, count, _ = m.bucket_counts()
            good = 0
            for edge, c in zip(edges, counts):
                # bucket i holds observations <= edges[i]; a bucket
                # straddling the threshold counts as bad
                # (conservative)
                if edge <= slo.threshold_s * (1 + 1e-9):
                    good += c
            return float(good), float(count)
        total = self.registry.get(slo.total_metric, slo.labels)
        bad = self.registry.get(slo.bad_metric, slo.labels)
        if not isinstance(total, Counter):
            return None
        t = float(total.value)
        b = float(bad.value) if isinstance(bad, Counter) else 0.0
        return t - b, t

    @staticmethod
    def _window_delta(samples, now: float, window_s: float,
                      current: Tuple[float, float]
                      ) -> Tuple[float, float]:
        """good/total delta between now and the newest sample at
        least ``window_s`` old (falling back to the oldest sample —
        early in a run the window is simply shorter)."""
        base = None
        for t, g, tot in samples:          # oldest → newest
            if t <= now - window_s:
                base = (g, tot)
            else:
                break
        if base is None and samples:
            _, g, tot = samples[0]
            base = (g, tot)
        if base is None:
            return 0.0, 0.0
        return current[0] - base[0], current[1] - base[1]

    def _burn(self, slo: SLO, samples, now: float,
              window_s: float, current) -> float:
        d_good, d_total = self._window_delta(samples, now, window_s,
                                             current)
        if d_total <= 0:
            return 0.0
        bad_frac = (d_total - d_good) / d_total
        return bad_frac / slo.budget

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _breach_value(self, name: str) -> float:
        self.evaluate()
        with self._lock:
            st = self._state.get(name)
            return 1.0 if st is not None and st.breached else 0.0

    def evaluate(self, force: bool = False) -> List[dict]:
        """One (rate-limited) evaluation pass; returns breach /
        recovery transitions as dicts."""
        now = self.clock()
        with self._lock:
            if not force and now - self._last_eval \
                    < self.min_eval_interval_s:
                return []
            self._last_eval = now
            slos = list(self._slos.values())
        changes = []
        for slo in slos:
            ch = self._evaluate_one(slo, now)
            if ch is not None:
                changes.append(ch)
        return changes

    def _evaluate_one(self, slo: SLO, now: float) -> Optional[dict]:
        current = self._read(slo)
        st = self._state.get(slo.name)
        if current is None or st is None:
            return None
        burns: Dict[str, float] = {}
        breached_by = None
        for w in slo.windows:
            b_long = self._burn(slo, st.samples, now, w.long_s,
                                current)
            b_short = self._burn(slo, st.samples, now, w.short_s,
                                 current)
            burns[f"{int(w.long_s)}s"] = round(b_long, 3)
            burns[f"{int(w.short_s)}s"] = round(b_short, 3)
            if b_long > w.factor and b_short > w.factor \
                    and breached_by is None:
                breached_by = {"severity": w.severity,
                               "factor": w.factor,
                               "long_s": w.long_s,
                               "short_s": w.short_s,
                               "burn_long": round(b_long, 3),
                               "burn_short": round(b_short, 3)}
        st.samples.append((now, current[0], current[1]))
        for wname, b in burns.items():
            g = st.gauges.get(wname)
            if g is not None:
                g.set(b)
        with self._lock:
            st.burns = burns
            was = st.breached
            st.breached = breached_by is not None
            if st.breached != was:
                st.last_change = now
        if breached_by is not None and not was:
            change = {"event": "breach", "slo": slo.name,
                      "objective": slo.objective,
                      "threshold_s": slo.threshold_s,
                      "window_s": slo.window_s, **breached_by}
            self._on_breach(slo, change)
            return change
        if breached_by is None and was:
            logger.warning("SLO recovered: %s", slo.name)
            return {"event": "recover", "slo": slo.name}
        return None

    def _on_breach(self, slo: SLO, change: dict) -> None:
        traces = self.offending_traces(slo)
        change["traces"] = traces
        logger.warning(
            "SLO BREACH: %s — burning %.1fx budget over %ss "
            "(%.1fx over %ss); offending traces: %s",
            slo.name, change["burn_long"], int(change["long_s"]),
            change["burn_short"], int(change["short_s"]),
            ", ".join(traces) or "<none sampled>")
        # ship the offending trace ids with the page: the flight
        # recorder bundle is the artifact the on-call opens first
        try:
            from deeplearning4j_tpu_torch.observability import (
                flight_recorder)
            rec = flight_recorder.get_recorder()
            if rec is not None:
                rec.record("slo_breach", **change)
                rec.dump(reason=f"slo_breach_{slo.name}", force=False)
        except Exception:
            logger.exception("flight-recorder SLO capture failed")
        if self.on_breach is not None:
            try:
                self.on_breach(change)
            except Exception:
                logger.exception("on_breach callback failed")

    def offending_traces(self, slo: SLO, limit: int = 10
                         ) -> List[str]:
        """Trace ids sitting as exemplars in the buckets past the
        latency threshold (for availability SLOs: every exemplar of
        the latency histogram sharing the SLO's labels) — concrete
        requests that burned the budget."""
        m = self.registry.get(
            slo.metric if slo.threshold_s is not None
            else "serving_latency_seconds", slo.labels)
        if not isinstance(m, Histogram):
            return []
        out = []
        for ex in m.exemplars():
            if slo.threshold_s is not None \
                    and ex["value"] <= slo.threshold_s:
                continue
            tid = ex["labels"].get("trace_id")
            if tid and tid not in out:
                out.append(tid)
        return out[-limit:]

    def any_breached(self, evaluate: bool = True) -> bool:
        """True while ANY registered SLO's multi-window burn-rate
        condition holds — the autoscaler's scale-up trigger (one
        rate-limited evaluation per call by default, so a fast
        control loop cannot stack samples)."""
        if evaluate:
            self.evaluate()
        with self._lock:
            return any(st.breached for st in self._state.values())

    # ------------------------------------------------------------------
    def status(self) -> List[dict]:
        """Per-SLO verdict for /healthz and the UI."""
        with self._lock:
            slos = dict(self._slos)
            states = {n: (st.breached, dict(st.burns))
                      for n, st in self._state.items()}
        out = []
        for name, slo in slos.items():
            breached, burns = states.get(name, (False, {}))
            out.append({"name": name, "objective": slo.objective,
                        "threshold_ms":
                            None if slo.threshold_s is None
                            else slo.threshold_s * 1e3,
                        "window_s": slo.window_s,
                        "burn_rates": burns, "breached": breached,
                        "description": slo.description})
        return out

    def install(self, manager) -> None:
        """Register one ``AlertRule`` per SLO on the ``slo_breach``
        gauge: the AlertManager's for-duration/debounce/callback
        machinery (and /healthz's degraded state) now covers SLO
        breaches with zero new wiring."""
        from deeplearning4j_tpu_torch.observability.alerts import AlertRule
        with self._lock:
            slos = list(self._slos.values())
        for slo in slos:
            manager.add_rule(AlertRule(
                name=f"slo_burn:{slo.name}",
                metric="slo_breach", labels={"slo": slo.name},
                op=">=", threshold=1.0,
                severity="critical",
                description=slo.description
                or f"SLO {slo.name} burn-rate breach "
                   f"(objective {slo.objective:g}, window "
                   f"{slo.window_s:g}s)"))
