"""Declarative threshold alerting over the metrics registry.

Counterpart of ``deeplearning4j_tpu/observability/alerts.py``
(host code, stdlib only).

Every subsystem reports into one metrics pipe (``MetricsRegistry``);
this module watches that pipe. An :class:`AlertRule` names any registered
metric — counter value, gauge value, or a histogram quantile — and a
condition; :class:`AlertManager` evaluates the rules (on demand, or on
a background interval) with Prometheus-style semantics:

- **for-duration**: the condition must hold continuously for
  ``for_seconds`` before the alert fires (a one-scrape p99 blip does
  not page);
- **debounce**: after an alert resolves, it cannot re-fire for
  ``debounce_seconds`` (a metric oscillating around the threshold
  fires once per incident, not once per evaluation);
- firing/resolution goes to the log and a pluggable callback, and is
  counted on the registry (``alerts_fired_total``), so alerts are
  themselves observable.

Consumers: ``ModelServer /healthz`` reports ``degraded`` plus the
firing rules instead of an unconditional ``ok``; operators embed the
manager anywhere a ``MetricsRegistry`` exists.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, MetricsRegistry,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["AlertRule", "AlertManager"]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}


@dataclasses.dataclass
class AlertRule:
    """``value(metric{labels}) <op> threshold`` sustained for
    ``for_seconds``. For histograms, ``quantile`` selects the value
    (default p99 — "serving p99 over 250 ms" is one rule)."""

    name: str
    metric: str
    threshold: float
    op: str = ">"
    labels: Optional[Dict[str, str]] = None
    quantile: Optional[float] = None
    for_seconds: float = 0.0
    debounce_seconds: float = 0.0
    severity: str = "warning"
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(
                f"op must be one of {sorted(_OPS)}, got {self.op!r}")
        if self.quantile is not None \
                and not 0.0 < self.quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")


class _RuleState:
    __slots__ = ("pending_since", "firing", "fired_at", "resolved_at",
                 "value")

    def __init__(self):
        self.pending_since: Optional[float] = None
        self.firing = False
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.value: Optional[float] = None


class AlertManager:
    """Evaluate alert rules against one registry.

    ``evaluate()`` is cheap and safe to call from a request handler
    (that is exactly what ``/healthz`` does); ``start(interval)``
    runs it on a daemon thread for push-style ``on_fire`` callbacks.
    ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, registry: MetricsRegistry,
                 rules: Optional[List[AlertRule]] = None,
                 on_fire: Optional[Callable[[dict], None]] = None,
                 on_resolve: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.on_fire = on_fire
        self.on_resolve = on_resolve
        self.clock = clock
        self._lock = threading.Lock()
        # serializes whole evaluation passes: /healthz handlers, the
        # UI and the background thread may all call evaluate()
        # concurrently, and the fire/resolve state machine must step
        # once per crossing, not once per caller. Separate from
        # self._lock so an on_fire callback may call firing().
        self._eval_lock = threading.Lock()
        self._rules: Dict[str, AlertRule] = {}
        self._state: Dict[str, _RuleState] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._fired_counter = registry.counter(
            "alerts_fired_total", help="alert rule firings")
        registry.gauge("alerts_firing",
                       help="currently-firing alert rules",
                       fn=lambda: float(len(self.firing())))
        for r in rules or []:
            self.add_rule(r)

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._lock:
            self._rules[rule.name] = rule
            self._state[rule.name] = _RuleState()
        return rule

    def remove_rule(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)
            self._state.pop(name, None)

    # ------------------------------------------------------------------
    def _value(self, rule: AlertRule) -> Optional[float]:
        m = self.registry.get(rule.metric, rule.labels)
        if m is None:
            return None
        try:
            if isinstance(m, Histogram):
                return float(m.quantile(rule.quantile or 0.99))
            if isinstance(m, Gauge):
                v = m.value()
                return None if v is None else float(v)
            if isinstance(m, Counter):
                return float(m.value)
        except Exception:
            logger.exception("alert rule %r: reading %r failed",
                             rule.name, rule.metric)
        return None

    def evaluate(self) -> List[dict]:
        """One evaluation pass; returns the state CHANGES as
        ``{"event": "fire"|"resolve", ...alert}`` dicts."""
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> List[dict]:
        now = self.clock()
        changes: List[dict] = []
        with self._lock:
            rules = list(self._rules.values())
        for rule in rules:
            st = self._state.get(rule.name)
            if st is None:
                continue
            v = self._value(rule)
            st.value = v
            cond = (v is not None
                    and _OPS[rule.op](v, rule.threshold))
            if cond:
                if st.firing:
                    continue
                if st.resolved_at is not None and \
                        now - st.resolved_at < rule.debounce_seconds:
                    continue              # debounced
                if st.pending_since is None:
                    st.pending_since = now
                if now - st.pending_since >= rule.for_seconds:
                    st.firing = True
                    st.fired_at = now
                    st.pending_since = None
                    self._fired_counter.inc()
                    alert = self._alert_dict(rule, st)
                    alert["event"] = "fire"
                    changes.append(alert)
                    logger.warning(
                        "ALERT firing: %s — %s{%s} = %s %s %g%s",
                        rule.name, rule.metric, rule.labels or "",
                        v, rule.op, rule.threshold,
                        f" ({rule.description})" if rule.description
                        else "")
                    if self.on_fire is not None:
                        try:
                            self.on_fire(alert)
                        except Exception:
                            logger.exception("on_fire callback failed")
            else:
                st.pending_since = None
                if st.firing:
                    st.firing = False
                    st.resolved_at = now
                    alert = self._alert_dict(rule, st)
                    alert["event"] = "resolve"
                    changes.append(alert)
                    logger.warning("ALERT resolved: %s", rule.name)
                    if self.on_resolve is not None:
                        try:
                            self.on_resolve(alert)
                        except Exception:
                            logger.exception(
                                "on_resolve callback failed")
        return changes

    def _alert_dict(self, rule: AlertRule, st: _RuleState) -> dict:
        return {"name": rule.name, "metric": rule.metric,
                "labels": rule.labels, "op": rule.op,
                "threshold": rule.threshold,
                "quantile": rule.quantile, "value": st.value,
                "severity": rule.severity,
                "description": rule.description,
                "fired_at": st.fired_at}

    def firing(self) -> List[dict]:
        """Currently-firing alerts (does NOT evaluate — pair with
        ``evaluate()`` or a running background thread)."""
        with self._lock:
            return [self._alert_dict(self._rules[n], st)
                    for n, st in self._state.items()
                    if st.firing and n in self._rules]

    # ------------------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "AlertManager":
        # each loop generation gets its OWN stop event, captured by
        # the closure: a shared event that start() clears could be
        # cleared before the previous (stopping) loop has observed
        # it, orphaning that loop with no handle
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:
                    logger.exception("alert evaluation failed")

        # check-then-spawn under the lock: two racing start() calls
        # must not each launch an evaluation loop (every on_fire
        # callback would fire twice)
        with self._lock:
            if self._thread is not None:
                return self
            self._stop = stop
            self._thread = threading.Thread(target=loop, daemon=True,
                                            name="alert-manager")
            self._thread.start()
        return self

    def stop(self) -> None:
        # the flag must flip under the SAME lock as the thread swap:
        # set outside, a racing start() could swap in a fresh event
        # between our set and our swap
        with self._lock:
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None:                   # join OUTSIDE the lock:
            t.join(timeout=5.0)             # the loop's evaluate()
        #                                     briefly takes _lock
