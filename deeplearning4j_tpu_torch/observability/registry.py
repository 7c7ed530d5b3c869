"""Unified metrics registry: counters, gauges, histograms, Prometheus.

Counterpart of ``deeplearning4j_tpu/observability/registry.py``
(host code, stdlib only).

One process-wide pipe for every subsystem's numbers. Before this
module, metrics code was scattered: ``train/listeners.py`` logged,
``ui/stats.py`` stored, ``serving/metrics.py`` owned its own
histogram/quantile code. The histogram here IS that code, lifted out
of serving so training and serving share one implementation, plus the
Prometheus text exposition every scraper expects.

Metrics are keyed by (name, labels): ``registry.counter("x_total",
labels={"endpoint": "predict"})`` is get-or-create, so concurrent
callers converge on one instrument. ``prometheus_text()`` renders the
standard exposition format (# TYPE/# HELP headers, cumulative
``_bucket`` counts with ``le`` labels, ``_sum``/``_count``).
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "default_latency_buckets", "safe_inc"]


def default_latency_buckets(lo: float = 1e-4, hi: float = 60.0,
                            factor: float = 1.45) -> List[float]:
    """Log-spaced bucket edges in seconds (the serving latency
    default: O(1) recording, quantiles interpolated in-bucket)."""
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return edges


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sane_name(name: str) -> str:
    """Coerce to a legal Prometheus metric name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Optional[Dict[str, str]],
                extra: Optional[Dict[str, str]] = None) -> str:
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v != v:                                    # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else None
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self, openmetrics: bool = False) -> List[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self.value)}"]


class Gauge(_Metric):
    """Settable value OR pull callback sampled at exposition time
    (queue depths must be read when scraped, not when registered)."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None,
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help, labels)
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def value(self) -> Optional[float]:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return None        # a dead callback must not kill /metrics
        with self._lock:
            return self._value

    def expose(self, openmetrics: bool = False) -> List[str]:
        v = self.value()
        if v is None:
            return []
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(v)}"]


class Histogram(_Metric):
    """Fixed-bucket histogram with interpolated quantiles — the code
    previously private to ``serving/metrics.py``, now shared.
    Recording is O(#buckets) scan + one locked multi-field update."""

    kind = "histogram"

    def __init__(self, name, help="", labels=None,
                 buckets: Optional[List[float]] = None):
        super().__init__(name, help, labels)
        self.edges = list(buckets) if buckets is not None \
            else default_latency_buckets()
        self.counts = [0] * (len(self.edges) + 1)   # +1 overflow
        self.count = 0
        self.sum = 0.0
        # per-bucket exemplars: bucket index -> (labels, value, unix
        # ts). An exemplar links an aggregate bucket back to ONE
        # concrete observation (a sampled trace id), so a p99 spike
        # on a dashboard resolves to a trace in the flight recorder.
        self._exemplars: Dict[int, Tuple[Dict[str, str], float,
                                         float]] = {}

    def record(self, v: float,
               exemplar: Optional[Dict[str, str]] = None) -> None:
        i = 0
        edges = self.edges
        while i < len(edges) and v > edges[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if exemplar:
                self._exemplars[i] = (dict(exemplar), float(v),
                                      time.time())

    # alias matching prometheus client naming
    observe = record

    def bucket_counts(self) -> Tuple[List[float], List[int], int,
                                     float]:
        """Consistent snapshot of ``(edges, counts, count, sum)`` —
        the SLO layer derives good/total counts from the buckets."""
        with self._lock:
            return (list(self.edges), list(self.counts), self.count,
                    self.sum)

    def exemplars(self) -> List[dict]:
        """Current per-bucket exemplars: ``{le, labels, value, ts}``
        (``le`` is the bucket's upper edge; ``inf`` for overflow)."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out = []
        for i, (labels, v, ts) in items:
            le = self.edges[i] if i < len(self.edges) else math.inf
            out.append({"le": le, "labels": labels, "value": v,
                        "ts": ts})
        return out

    def quantile(self, q: float) -> float:
        """Approximate quantile: linear interpolation inside the
        bucket holding the q-th sample (0 if empty)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        edges = self.edges
        for i, c in enumerate(counts):
            if seen + c >= rank:
                lo = 0.0 if i == 0 else edges[i - 1]
                hi = edges[min(i, len(edges) - 1)]
                frac = (rank - seen) / c if c else 0.0
                return lo + (hi - lo) * min(1.0, frac)
            seen += c
        return edges[-1]

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
        return {"count": count,
                "sum": total,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    @staticmethod
    def _exemplar_suffix(ex) -> str:
        # OpenMetrics exemplar syntax: `... # {trace_id="abc"} v ts`.
        # Exemplars are ONLY legal in the OpenMetrics exposition —
        # the classic text format (text/plain; version=0.0.4) allows
        # nothing after the value but an integer timestamp, and a real
        # Prometheus scrape of a classic payload with this tail fails
        # to parse ENTIRELY — so expose() emits it only when asked
        # for openmetrics output.
        if ex is None:
            return ""
        labels, v, ts = ex
        return (f" # {_fmt_labels(None, labels)} {_fmt_value(v)} "
                f"{ts:.3f}")

    def expose(self, openmetrics: bool = False) -> List[str]:
        with self._lock:
            counts = list(self.counts)
            count, total = self.count, self.sum
            exemplars = (dict(self._exemplars) if openmetrics else {})
        out = []
        cum = 0
        for i, (edge, c) in enumerate(zip(self.edges, counts)):
            cum += c
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.labels, {'le': f'{edge:.6g}'})}"
                f" {cum}"
                f"{self._exemplar_suffix(exemplars.get(i))}")
        out.append(f"{self.name}_bucket"
                   f"{_fmt_labels(self.labels, {'le': '+Inf'})}"
                   f" {count}"
                   f"{self._exemplar_suffix(exemplars.get(len(self.edges)))}")
        out.append(f"{self.name}_sum{_fmt_labels(self.labels)} "
                   f"{_fmt_value(total)}")
        out.append(f"{self.name}_count{_fmt_labels(self.labels)} "
                   f"{count}")
        return out


def _key(name: str,
         labels: Optional[Dict[str, str]]) -> Tuple[str, tuple]:
    return (name, tuple(sorted((labels or {}).items())))


class MetricsRegistry:
    """Get-or-create instrument store with Prometheus exposition.

    One process-wide instance (``REGISTRY``) is the default pipe;
    subsystems that need isolation (each ``ServingMetrics`` in a test
    suite) instantiate their own.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], _Metric] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        name = _sane_name(name)
        k = _key(name, labels)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[k] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{labels!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help, labels)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[List[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def register(self, metric: _Metric) -> _Metric:
        """Adopt an externally-constructed instrument (e.g. serving's
        LatencyHistogram subclass) into this registry's exposition."""
        metric.name = _sane_name(metric.name)
        k = _key(metric.name, metric.labels)
        with self._lock:
            existing = self._metrics.get(k)
            if existing is not None and existing is not metric:
                raise ValueError(
                    f"metric {metric.name!r}{metric.labels!r} already "
                    "registered")
            self._metrics[k] = metric
        return metric

    def adopt(self, metric: _Metric) -> _Metric:
        """Get-or-register for externally-constructed instruments:
        atomically returns the already-registered instrument for this
        (name, labels) if one exists, else registers ``metric``. The
        shared-registry analogue of counter()/gauge()'s get-or-create
        — concurrent constructors converge on one instrument instead
        of racing register() into a ValueError."""
        metric.name = _sane_name(metric.name)
        k = _key(metric.name, metric.labels)
        with self._lock:
            existing = self._metrics.get(k)
            if existing is not None:
                return existing
            self._metrics[k] = metric
            return metric

    def unregister(self, name: str,
                   labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._metrics.pop(_key(_sane_name(name), labels), None)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None):
        with self._lock:
            return self._metrics.get(_key(_sane_name(name), labels))

    def collect(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-friendly dump (name{labels} -> value/summary)."""
        out = {}
        for m in self.collect():
            key = m.name + _fmt_labels(m.labels)
            if isinstance(m, Counter):
                out[key] = m.value
            elif isinstance(m, Gauge):
                out[key] = m.value()
            elif isinstance(m, Histogram):
                out[key] = m.snapshot()
        return out

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """The standard exposition format (text/plain; version=0.0.4),
        or — with ``openmetrics=True`` — OpenMetrics text
        (application/openmetrics-text): same families plus per-bucket
        exemplars and the mandatory ``# EOF`` terminator. Exemplars
        are NOT emitted in the classic format, where they are a
        parse error that would kill the whole scrape. Families are
        grouped so a name shared by many label sets gets one # TYPE
        header."""
        families: Dict[str, List[_Metric]] = {}
        order: List[str] = []
        for m in self.collect():
            if m.name not in families:
                families[m.name] = []
                order.append(m.name)
            families[m.name].append(m)
        lines: List[str] = []
        for name in order:
            members = families[name]
            head = members[0]
            family = name
            if openmetrics and head.kind == "counter" \
                    and family.endswith("_total"):
                # OpenMetrics counter families are named WITHOUT the
                # _total suffix (the sample keeps it); declaring the
                # family as `foo_total` makes the bare `foo_total`
                # sample a clashing name that strict parsers reject,
                # killing the whole scrape
                family = family[:-len("_total")]
            if head.help:
                lines.append(f"# HELP {family} {head.help}")
            lines.append(f"# TYPE {family} {head.kind}")
            for m in members:
                lines.extend(m.expose(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + ("\n" if lines else "")


# The process-wide default registry (training, compile watchdog,
# ParallelInference). Serving stacks default to per-instance
# registries so parallel test servers don't share counters; pass
# ``registry=REGISTRY`` to join the global pipe.
REGISTRY = MetricsRegistry()


def safe_inc(name: str, help: str = "",
             labels: Optional[Dict[str, str]] = None,
             registry: Optional[MetricsRegistry] = None) -> None:
    """Best-effort counter increment (default: the process-wide
    registry): NEVER raises — instrumentation on a failure path must
    not take down the path it measures. The one copy of the
    try/counter/except pattern the resilience call sites share."""
    try:
        (registry if registry is not None else REGISTRY).counter(
            name, help=help, labels=labels).inc()
    except Exception:
        pass
