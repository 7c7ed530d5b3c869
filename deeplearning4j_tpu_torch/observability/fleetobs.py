"""Fleet observability plane: one collector over N processes.

(Counterpart of ``deeplearning4j_tpu/observability/fleetobs.py``, copied with the
imports renamed: host code, no device tensor.)

Every observability primitive in this repo — the metrics registry,
the tracer ring, SLO burn rates, the flight recorder — is process
local. A serving fleet is not: a trace id spans router -> prefill ->
decode yet its spans are stranded in three separate ring buffers, and
"fleet p99" exists nowhere until someone hand-merges N ``/metrics``
payloads. This module is that someone.

:class:`FleetCollector` runs a pull loop over every fleet member (the
router plus each replica) and provides four things:

- **Merged metrics.** Each member's OpenMetrics exposition is parsed
  and folded into one fleet-level :class:`MetricsRegistry`: every
  series is re-published twice, once under its original key with a
  ``replica`` label (per-member view) and once under the original
  key unchanged (the fleet aggregate — counters/gauges summed,
  histograms merged **bucket-wise**, which is exact because every
  process builds its buckets from the same
  ``default_latency_buckets`` edges). The merged registry re-exposes
  Prometheus/OpenMetrics text and a JSON snapshot, and a bounded
  downsampled ring keeps a headline time series in memory.
- **Fleet SLOs.** The existing :class:`SLOMonitor` burn-rate
  machinery is pointed at the merged registry unchanged — its exact
  ``(name, labels)`` reads hit the aggregate series, so availability
  and latency objectives are judged at the FLEET level. Breaches feed
  an :class:`AlertManager` and, via :meth:`fleet_health`, the
  router's ``/healthz``.
- **Distributed traces.** Each member's ``/debug/trace-export`` is
  drained incrementally (a per-target ``seq`` cursor); spans are
  stitched by trace id into cross-process trees, each span stamped
  with its source ``replica`` and an absolute wall-clock timestamp
  (``origin_unix * 1e6 + ts_us``) so one request renders as one
  timeline: router root span, replica subtrees under it.
- **Incident bundles.** On a fleet-SLO breach or a member death the
  collector pulls a flight-recorder style bundle from every live
  member into ``incident-<stamp>-<reason>/<member>/`` with one
  cross-process MANIFEST.

The collector is an OBSERVER: it holds no lock any serving thread
takes, and every interaction with the fleet is a plain HTTP GET with
a short timeout. Killing the collector mid-soak must cause zero
serving failures — nothing in the data plane ever waits on it.

Fleet-level metric names exported by the collector itself:
``fleet_scrapes_total``, ``fleet_scrape_errors_total``,
``fleet_targets_up``, ``fleet_incidents_total``,
``fleet_trace_spans_total``, ``fleet_scrape_duration_seconds``.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import re
import socket
import sys
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, \
    Tuple

from deeplearning4j_tpu_torch.observability.registry import (
    MetricsRegistry, Histogram)
from deeplearning4j_tpu_torch.observability.slo import SLO, SLOMonitor
from deeplearning4j_tpu_torch.observability.alerts import AlertManager

logger = logging.getLogger(__name__)

__all__ = ["FleetCollector", "parse_exposition", "merge_histograms",
           "render_status", "local_bundle_payload"]


# --------------------------------------------------------------------
# exposition parsing
# --------------------------------------------------------------------

def _unescape(s: str) -> str:
    out, i, n = [], 0, len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ('"', "\\"):
                out.append(nxt)
            else:
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(tok: str) -> float:
    t = tok.strip()
    if t in ("+Inf", "Inf"):
        return math.inf
    if t == "-Inf":
        return -math.inf
    if t == "NaN":
        return math.nan
    return float(t)


# fast path for the overwhelmingly common series shape: every label
# value quoted, no escapes. The slow char-scan below only runs when
# a value contains a backslash escape (the greedy `\{.*\}` still
# pairs the braces correctly when a VALUE contains '{'/'}' — the
# tail after the last '}' is always numeric tokens)
_SERIES_FAST_RE = re.compile(
    r"([a-zA-Z_:][a-zA-Z0-9_:.]*)\{(.*)\}\s*(.*)")
_LABEL_FAST_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"\\]*)"(?:,|\Z)')

# one-regex-per-line sample parser — the scrape loop shares the
# serving process's GIL, so parse cost is directly serving cost.
# Groups: name, label blob, value, timestamp, exemplar blob,
# exemplar value, exemplar ts. Non-greedy label blobs mis-split on
# values containing '}' — the quote-count check below catches that
# (and escapes) and falls back to the char-scan.
_SAMPLE_RE = re.compile(
    r'([a-zA-Z_:][a-zA-Z0-9_:.]*)'
    r'(?:\{(.*?)\})?'
    r'[ \t]+([^ \t#]+)'
    r'(?:[ \t]+([^ \t#]+))?'
    r'(?:[ \t]*#[ \t]+\{(.*?)\}[ \t]+([^ \t]+)(?:[ \t]+([^ \t]+))?)?'
    r'[ \t\r]*$')

# label blobs repeat verbatim across series lines and scrape cycles
# (every bucket of a histogram, every cycle of a stable fleet) —
# memoize blob -> labels dict. Bounded: pathological cardinality
# (ids in label values) clears rather than grows without limit.
_LABELS_CACHE: Dict[str, Dict[str, str]] = {}


def _parse_label_blob(blob: str) -> Optional[Dict[str, str]]:
    """Labels for a regex-split blob, or None when the blob smells
    mis-split (escapes, or a '}' inside a quoted value truncated the
    non-greedy match) — the caller then re-parses the WHOLE line with
    the char-scan, which cannot mis-pair braces."""
    cached = _LABELS_CACHE.get(blob)
    if cached is None:
        pairs = _LABEL_FAST_RE.findall(blob)
        if blob.count('"') != 2 * len(pairs):
            return None
        cached = dict(pairs)
        if len(_LABELS_CACHE) > 20_000:
            _LABELS_CACHE.clear()
        _LABELS_CACHE[blob] = cached
    return dict(cached)


def _split_series(line: str) -> Tuple[str, Dict[str, str], str]:
    """``name{labels} rest`` -> (name, labels dict, rest). The label
    block is scanned character-wise so quoted values may contain
    commas, spaces, or escaped quotes."""
    brace = line.find("{")
    sp = line.find(" ")
    if brace == -1 or (sp != -1 and sp < brace):
        name, _, rest = line.partition(" ")
        return name, {}, rest.strip()
    if "\\" not in line:
        m = _SERIES_FAST_RE.match(line)
        if m is not None:
            blob = m.group(2)
            pairs = _LABEL_FAST_RE.findall(blob)
            # only trust the fast parse when the pair regex consumed
            # the whole blob (leftovers mean an exotic shape)
            if _LABEL_FAST_RE.sub("", blob).strip(", \t") == "":
                return m.group(1), dict(pairs), m.group(3).strip()
    name = line[:brace]
    labels: Dict[str, str] = {}
    i = brace + 1
    n = len(line)
    key = []
    while i < n and line[i] != "}":
        if line[i] in (",", " "):
            i += 1
            continue
        key = []
        while i < n and line[i] not in ("=",):
            key.append(line[i])
            i += 1
        i += 1                                  # '='
        if i < n and line[i] == '"':
            i += 1
            val = []
            while i < n:
                c = line[i]
                if c == "\\" and i + 1 < n:
                    val.append(c)
                    val.append(line[i + 1])
                    i += 2
                    continue
                if c == '"':
                    i += 1
                    break
                val.append(c)
                i += 1
            labels["".join(key).strip()] = _unescape("".join(val))
    rest = line[i + 1:].strip()                 # past '}'
    return name, labels, rest


def _labels_key(labels: Dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def parse_exposition(text: str) -> Dict[str, Any]:
    """Parse a Prometheus classic / OpenMetrics text payload into

    ``{"counters": {(name, lk): value},
       "gauges":   {(name, lk): value},
       "histograms": {(name, lk): {edges, counts, count, sum,
                                   exemplars}},
       "help": {name: help_text}}``

    where ``lk`` is the sorted label tuple (``le`` stripped for
    histogram buckets) and ``counts`` is per-bucket (DE-cumulated,
    overflow last) — the shape :func:`merge_histograms` sums
    exactly. Exemplars (OpenMetrics ``# {...} v ts`` tails) are kept
    per bucket.
    """
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    counters: Dict[tuple, float] = {}
    gauges: Dict[tuple, float] = {}
    raw_h: Dict[tuple, dict] = {}

    for line in text.split("\n"):
        if not line:
            continue
        if line[0] in " \t":
            line = line.strip()
            if not line:
                continue
        if line[0] == "#":
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip() \
                    if len(parts) > 3 else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue                           # comments, # EOF
        exemplar = None
        name = None
        # fast path: the whole sample line in one regex pass — the
        # scrape loop shares a GIL with serving threads, and the
        # char-scan path costs several times more per line
        m = _SAMPLE_RE.match(line)
        if m is not None:
            blob = m.group(2)
            labels = _parse_label_blob(blob) if blob else {}
            if labels is not None:
                try:
                    value = _parse_value(m.group(3))
                    name = m.group(1)
                except ValueError:
                    continue
                exblob = m.group(5)
                if exblob is not None:
                    # exemplar label values rotate (trace ids) — skip
                    # the memo cache to keep it from churning
                    pairs = _LABEL_FAST_RE.findall(exblob)
                    el = dict(pairs) \
                        if exblob.count('"') == 2 * len(pairs) \
                        else _split_series("x{" + exblob + "} 0")[1]
                    try:
                        exemplar = (el, _parse_value(m.group(6)),
                                    float(m.group(7))
                                    if m.group(7) else 0.0)
                    except ValueError:
                        exemplar = None
        if name is None:
            # slow path: escapes or exotic shapes — OpenMetrics
            # exemplar rides after ' # '
            body = line
            if " # " in line:
                body, _, extail = line.partition(" # ")
                ename, elabels, erest = _split_series("x" + extail)
                etoks = erest.split()
                if etoks:
                    try:
                        exemplar = (elabels, _parse_value(etoks[0]),
                                    float(etoks[1]) if len(etoks) > 1
                                    else 0.0)
                    except ValueError:
                        exemplar = None
            name, labels, rest = _split_series(body)
            toks = rest.split()
            if not toks:
                continue
            try:
                value = _parse_value(toks[0])
            except ValueError:
                continue

        base = None
        part = None
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) \
                    and types.get(name[:-len(suf)]) == "histogram":
                base, part = name[:-len(suf)], suf
                break
        if part is not None:
            le = labels.pop("le", None)
            hk = (base, _labels_key(labels))
            h = raw_h.setdefault(hk, {"buckets": [], "sum": 0.0,
                                      "count": 0, "exemplars": {}})
            if part == "_bucket":
                h["buckets"].append((_parse_value(le)
                                     if le is not None else math.inf,
                                     value))
                if exemplar is not None and le is not None:
                    h["exemplars"][_parse_value(le)] = exemplar
            elif part == "_sum":
                h["sum"] = value
            else:
                h["count"] = int(value)
            continue

        kind = types.get(name)
        if kind is None and name.endswith("_total"):
            # OpenMetrics: the counter family header drops _total
            kind = types.get(name[:-len("_total")])
            if kind == "counter":
                helps.setdefault(name,
                                 helps.get(name[:-len("_total")], ""))
        if kind is None:
            kind = "counter" if name.endswith("_total") else "gauge"
        sk = (name, _labels_key(labels))
        if kind == "counter":
            counters[sk] = value
        else:
            gauges[sk] = value

    hists: Dict[tuple, dict] = {}
    for hk, h in raw_h.items():
        buckets = sorted(h["buckets"], key=lambda b: b[0])
        edges = [le for le, _ in buckets if not math.isinf(le)]
        counts: List[int] = []
        prev = 0.0
        for le, cum in buckets:
            if math.isinf(le):
                continue
            counts.append(int(cum - prev))
            prev = cum
        total = h["count"]
        counts.append(int(total - prev))            # overflow
        exemplars: Dict[int, tuple] = {}
        for le, ex in h["exemplars"].items():
            if math.isinf(le):
                exemplars[len(edges)] = ex
            else:
                for i, e in enumerate(edges):
                    if abs(e - le) <= 1e-9 * max(abs(e), abs(le), 1.0):
                        exemplars[i] = ex
                        break
        hists[hk] = {"edges": edges, "counts": counts,
                     "count": total, "sum": h["sum"],
                     "exemplars": exemplars}
    return {"counters": counters, "gauges": gauges,
            "histograms": hists, "help": helps}


def merge_histograms(parts: Sequence[dict]) -> dict:
    """Bucket-wise sum of parsed histograms — EXACT, not an
    approximation, because identical edges mean each merged bucket
    count is the plain integer sum of the members' bucket counts
    (merge is associative and order-independent; any quantile of the
    merged histogram brackets between the members' extremes).
    Raises ``ValueError`` on mismatched edges."""
    if not parts:
        raise ValueError("nothing to merge")
    edges = list(parts[0]["edges"])
    counts = [0] * (len(edges) + 1)
    count = 0
    total = 0.0
    exemplars: Dict[int, tuple] = {}
    for p in parts:
        if list(p["edges"]) != edges:
            raise ValueError(
                f"histogram edge mismatch: {len(p['edges'])} edges "
                f"vs {len(edges)}")
        for i, c in enumerate(p["counts"]):
            counts[i] += int(c)
        count += int(p["count"])
        total += float(p["sum"])
        for i, ex in p.get("exemplars", {}).items():
            # exactly one source survives per bucket: the freshest
            cur = exemplars.get(i)
            if cur is None or ex[2] >= cur[2]:
                exemplars[i] = ex
    return {"edges": edges, "counts": counts, "count": count,
            "sum": total, "exemplars": exemplars}


def _hist_quantile(edges: List[float], counts: List[int],
                   q: float) -> float:
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= rank:
            lo = 0.0 if i == 0 else edges[i - 1]
            hi = edges[min(i, len(edges) - 1)]
            frac = (rank - seen) / c if c else 0.0
            return lo + (hi - lo) * min(1.0, frac)
        seen += c
    return edges[-1] if edges else 0.0


# --------------------------------------------------------------------
# bounded downsampled time-series ring
# --------------------------------------------------------------------

class _DownsampledRing:
    """Append-only series bounded at ``capacity`` points: when full,
    every second retained point is dropped and the keep-stride
    doubles, so the ring always spans the WHOLE history at halving
    resolution instead of forgetting the past like a plain deque."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(4, int(capacity))
        self._items: List[Any] = []
        self._stride = 1
        self._n = 0

    def append(self, item: Any) -> None:
        if self._n % self._stride == 0:
            self._items.append(item)
            if len(self._items) >= self.capacity:
                self._items = self._items[::2]
                self._stride *= 2
        self._n += 1

    def items(self) -> List[Any]:
        return list(self._items)

    @property
    def stride(self) -> int:
        return self._stride


# --------------------------------------------------------------------
# bundle payload (served by every member's /debug/bundle)
# --------------------------------------------------------------------

def local_bundle_payload(registry=None, tracer=None,
                         reason: str = "incident",
                         max_spans: int = 2000) -> dict:
    """The JSON form of a flight-recorder bundle, built in-process so
    a collector can pull it over HTTP instead of reading the member's
    filesystem: ``{"reason", "files": {name: content}}`` where
    ``events.jsonl`` content is a list of event dicts and everything
    else is a JSON object. Works with or without an installed
    :class:`FlightRecorder` — a member that never installed one still
    contributes metrics + traces + env."""
    files: Dict[str, Any] = {}
    files["env.json"] = {
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
        "ts_unix": time.time(),
    }
    if registry is not None:
        try:
            files["metrics.json"] = registry.snapshot()
        except Exception:
            files["metrics.json"] = {"error": "snapshot failed"}
    if tracer is not None:
        try:
            evs = tracer.events()[-max_spans:]
            files["trace.json"] = {"events": evs,
                                   "dropped": tracer.dropped,
                                   "origin_unix":
                                       getattr(tracer, "_origin_unix",
                                               0.0)}
        except Exception:
            pass
    try:
        from deeplearning4j_tpu_torch.observability import flight_recorder
        rec = flight_recorder.get_recorder()
        if rec is not None:
            files["events.jsonl"] = rec.events()
            files["recorder_env.json"] = rec.env_snapshot()
    except Exception:
        pass
    files["MANIFEST.json"] = {
        "reason": reason,
        "pid": os.getpid(),
        "ts_unix": time.time(),
        "files": sorted(k for k in files),
    }
    return {"reason": reason, "files": files}


# --------------------------------------------------------------------
# the collector
# --------------------------------------------------------------------

def _http_get(url: str, timeout: float) -> bytes:
    req = urllib.request.Request(url, method="GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise OSError(f"GET {url} -> {resp.status}")
        return resp.read()


class FleetCollector:
    """Scrape loop + merged registry + trace store + incident writer.

    ``fleet``/``router`` targets are re-enumerated every cycle so
    replica churn (autoscaling, chaos kills, drains) is followed
    without re-configuration; ``targets`` adds static
    ``(name, base_url)`` members (a PS server, a remote fleet).

    The collector NEVER touches serving state: every member
    interaction is an HTTP GET with ``scrape_timeout_s``, failures
    only mark the target down. Instruments the collector did not
    create itself (its own SLO gauges, alert counters) are never
    overwritten by a scrape — the merge only mutates series it owns.
    """

    def __init__(self, fleet=None, router=None,
                 targets: Optional[Sequence[Tuple[str, str]]] = None,
                 interval_s: float = 1.0,
                 host: str = "127.0.0.1", port: int = 0,
                 slos: Sequence[SLO] = (),
                 incident_dir: Optional[str] = None,
                 incident_min_interval_s: float = 30.0,
                 scrape_timeout_s: float = 2.0,
                 ring_capacity: int = 512,
                 trace_capacity: int = 2048,
                 span_capacity: int = 100_000,
                 registry: Optional[MetricsRegistry] = None,
                 on_incident: Optional[Callable[[dict], None]] = None,
                 url_rewrite: Optional[Callable[[str, str],
                                                str]] = None):
        self.fleet = fleet
        self.router = router
        # (name, url) -> url hook: the collector's OWN network path
        # to each member. Network-chaos soaks route scrapes through
        # their own NetChaosProxy, independent of the router's hop
        # to the same replica — an asymmetric partition in one line.
        self.url_rewrite = url_rewrite
        self._static_targets = list(targets or [])
        self.interval_s = float(interval_s)
        self.host = host
        self.port = port
        self.incident_dir = incident_dir or os.getcwd()
        self.incident_min_interval_s = float(incident_min_interval_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.trace_capacity = int(trace_capacity)
        self.span_capacity = int(span_capacity)
        self.on_incident = on_incident

        self.registry = registry or MetricsRegistry()
        self._lock = threading.Lock()
        # (name, label-tuple) -> instrument the collector created;
        # the merge only ever mutates instruments recorded here
        self._made: Dict[tuple, Any] = {}
        self._scraped_keys: set = set()
        self._ring = _DownsampledRing(ring_capacity)
        self._down: Dict[str, str] = {}       # target -> last error
        self._up: set = set()
        self._last_cycle_unix = 0.0
        self._cycles = 0

        # trace store: trace id -> list of spans (insertion-ordered
        # LRU; eviction drops whole traces oldest-first). _trace_seen
        # holds each trace's span ids so a re-export (cursor reset,
        # or members sharing one tracer in-process) never duplicates
        self._traces: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self._trace_seen: Dict[str, set] = {}
        self._span_total = 0
        self._trace_cursors: Dict[str, int] = {}

        self._incidents: List[dict] = []
        self._last_incident_unix = -float("inf")
        self._breached_prev = False

        # fixed self-instruments, created ONCE (GL006)
        self._m_scrapes = self.registry.counter(
            "fleet_scrapes_total",
            help="collector scrape cycles completed")
        self._m_scrape_errors = self.registry.counter(
            "fleet_scrape_errors_total",
            help="failed member scrapes (any endpoint)")
        self._m_targets_up = self.registry.gauge(
            "fleet_targets_up",
            help="members whose last scrape succeeded")
        self._m_incidents = self.registry.counter(
            "fleet_incidents_total",
            help="incident bundles written")
        self._m_spans = self.registry.counter(
            "fleet_trace_spans_total",
            help="spans drained from member tracer rings")
        self._m_scrape_dur = self.registry.histogram(
            "fleet_scrape_duration_seconds",
            help="wall time of one full scrape cycle",
            buckets=[0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0])
        self._m_scrape_partitions = self.registry.counter(
            "fleet_scrape_partitions_total",
            help="members unreachable on the scrape path while the "
                 "fleet declared them up (asymmetric partition; "
                 "no incident written)")

        self.alerts = AlertManager(self.registry)
        self.slo_monitor: Optional[SLOMonitor] = None
        if slos:
            self.slo_monitor = SLOMonitor(
                self.registry, slos, on_breach=self._note_breach)
            self.slo_monitor.install(self.alerts)

        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._pending_breach: Optional[dict] = None

    # ---- targets ----
    def _targets(self) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = list(self._static_targets)
        if self.router is not None:
            out.append(("router",
                        f"http://{self.router.host}:"
                        f"{self.router.port}"))
        if self.fleet is not None:
            for r in self.fleet.snapshot():
                if getattr(r, "fleet_state", "up") == "dead":
                    continue
                out.append((f"replica-{r.id}",
                            f"http://{r.host}:{r.port}"))
        if self.url_rewrite is not None:
            out = [(name, self.url_rewrite(name, url))
                   for name, url in out]
        return out

    # ---- merge helpers (registry calls live here, outside any
    # loop body, and the created instrument is retained — the
    # GL006-sanctioned pattern) ----
    def _counter_abs(self, name: str, labels: Dict[str, str],
                     value: float, help_: str = "") -> Optional[tuple]:
        key = (name, _labels_key(labels))
        inst = self._made.get(key)
        if inst is None:
            if self.registry.get(name, labels) is not None:
                return None       # never clobber a local instrument
            inst = self.registry.counter(name, help=help_,
                                         labels=dict(labels) or None)
            self._made[key] = inst
        with inst._lock:
            inst._value = float(value)
        return key

    def _gauge_abs(self, name: str, labels: Dict[str, str],
                   value: float, help_: str = "") -> Optional[tuple]:
        key = (name, _labels_key(labels))
        inst = self._made.get(key)
        if inst is None:
            if self.registry.get(name, labels) is not None:
                return None
            inst = self.registry.gauge(name, help=help_,
                                       labels=dict(labels) or None)
            self._made[key] = inst
        inst.set(float(value))
        return key

    def _hist_abs(self, name: str, labels: Dict[str, str],
                  merged: dict, help_: str = "") -> Optional[tuple]:
        key = (name, _labels_key(labels))
        inst = self._made.get(key)
        if inst is not None and list(inst.edges) != \
                list(merged["edges"]):
            self.registry.unregister(name, dict(labels) or None)
            self._made.pop(key, None)
            inst = None
        if inst is None:
            if self.registry.get(name, labels) is not None:
                return None
            inst = self.registry.histogram(
                name, help=help_, labels=dict(labels) or None,
                buckets=merged["edges"])
            self._made[key] = inst
        with inst._lock:
            inst.counts = [int(c) for c in merged["counts"]]
            inst.count = int(merged["count"])
            inst.sum = float(merged["sum"])
            inst._exemplars = {
                int(i): (dict(ex[0]), float(ex[1]), float(ex[2]))
                for i, ex in merged.get("exemplars", {}).items()}
        return key

    # ---- one scrape cycle ----
    def scrape_once(self) -> dict:
        """One full pull: metrics merge, trace drain, SLO eval,
        incident check. Returns a cycle summary (targets up/down)."""
        t0 = time.perf_counter()
        targets = self._targets()
        parsed: Dict[str, dict] = {}
        errors: Dict[str, str] = {}
        for tname, url in targets:
            try:
                raw = _http_get(url + "/metrics?format=openmetrics",
                                self.scrape_timeout_s)
                parsed[tname] = parse_exposition(raw.decode())
            except Exception as e:
                errors[tname] = repr(e)
        self._merge(parsed)
        self._drain_traces(targets)
        died = self._note_liveness(targets, parsed, errors)
        if self.slo_monitor is not None:
            try:
                self.slo_monitor.evaluate(force=True)
            except Exception:
                logger.exception("fleet SLO evaluation failed")
        try:
            self.alerts.evaluate()
        except Exception:
            pass
        self._check_incidents(targets, died)
        self._append_ring_sample(targets, errors)
        self._m_scrapes.inc()
        if errors:
            self._m_scrape_errors.inc(len(errors))
        self._m_targets_up.set(len(parsed))
        self._m_scrape_dur.record(time.perf_counter() - t0)
        with self._lock:
            self._cycles += 1
            self._last_cycle_unix = time.time()
        return {"up": sorted(parsed), "down": errors}

    def _merge(self, parsed: Dict[str, dict]) -> None:
        new_keys: set = set()
        helps: Dict[str, str] = {}
        agg_c: Dict[tuple, float] = {}
        agg_g: Dict[tuple, float] = {}
        agg_h: Dict[tuple, List[dict]] = {}
        for tname, fam in parsed.items():
            helps.update(fam.get("help", {}))
            for (name, lk), v in fam["counters"].items():
                labels = dict(lk)
                agg_c[(name, lk)] = agg_c.get((name, lk), 0.0) + v
                labels["replica"] = tname
                k = self._counter_abs(name, labels, v,
                                      helps.get(name, ""))
                if k:
                    new_keys.add(k)
            for (name, lk), v in fam["gauges"].items():
                labels = dict(lk)
                agg_g[(name, lk)] = agg_g.get((name, lk), 0.0) + v
                labels["replica"] = tname
                k = self._gauge_abs(name, labels, v,
                                    helps.get(name, ""))
                if k:
                    new_keys.add(k)
            for (name, lk), h in fam["histograms"].items():
                labels = dict(lk)
                agg_h.setdefault((name, lk), []).append(h)
                labels["replica"] = tname
                k = self._hist_abs(name, labels, h,
                                   helps.get(name, ""))
                if k:
                    new_keys.add(k)
        for (name, lk), v in agg_c.items():
            k = self._counter_abs(name, dict(lk), v,
                                  helps.get(name, ""))
            if k:
                new_keys.add(k)
        for (name, lk), v in agg_g.items():
            k = self._gauge_abs(name, dict(lk), v,
                                helps.get(name, ""))
            if k:
                new_keys.add(k)
        for (name, lk), hs in agg_h.items():
            try:
                merged = merge_histograms(hs)
            except ValueError:
                logger.warning("fleet: skipping %s — edge mismatch "
                               "across members", name)
                continue
            k = self._hist_abs(name, dict(lk), merged,
                               helps.get(name, ""))
            if k:
                new_keys.add(k)
        with self._lock:
            stale = self._scraped_keys - new_keys
            self._scraped_keys = new_keys
        for (name, lk) in stale:
            self.registry.unregister(name, dict(lk) or None)
            self._made.pop((name, lk), None)

    # ---- traces ----
    # pages drained per member per cycle before giving up: a member
    # whose backlog outruns this is lagged, not wedged — the next
    # cycle resumes from the cursor
    _TRACE_PAGES_PER_CYCLE = 64

    def _drain_traces(self,
                      targets: List[Tuple[str, str]]) -> None:
        for tname, url in targets:
            for _ in range(self._TRACE_PAGES_PER_CYCLE):
                if not self._drain_trace_page(tname, url):
                    break

    def _drain_trace_page(self, tname: str, url: str) -> bool:
        """One ``trace-export`` page from one member; True when the
        member reported more backlog past the new cursor (drain the
        next page this same cycle). A scrape must catch the collector
        up to the member's head, not advance one page per cycle —
        paging once meant a backlog of N pages took N scrape
        intervals to surface a trace that was already complete."""
        since = self._trace_cursors.get(tname, 0)
        try:
            raw = _http_get(
                f"{url}/debug/trace-export?since={since}"
                f"&limit=5000", self.scrape_timeout_s)
            data = json.loads(raw.decode())
        except Exception:
            return False
        nxt = int(data.get("next", since))
        head = int(data.get("head", nxt))
        if head < since:
            # the member restarted (its seq space reset under
            # our cursor) — resync from zero on the next poll
            self._trace_cursors[tname] = 0
            return False
        self._trace_cursors[tname] = nxt
        origin = float(data.get("origin_unix", 0.0))
        spans = data.get("spans", [])
        if spans:
            self._merge_trace_page(tname, origin, spans)
        return bool(spans) and nxt < head

    def _merge_trace_page(self, tname: str, origin: float,
                          spans: List[dict]) -> None:
        with self._lock:
            for ev in spans:
                tid = ev.get("trace_id")
                if not tid:
                    continue
                bucket = self._traces.get(tid)
                if bucket is None:
                    bucket = self._traces[tid] = []
                    self._trace_seen[tid] = set()
                else:
                    self._traces.move_to_end(tid)
                sid = ev.get("span_id")
                if sid is not None:
                    if sid in self._trace_seen[tid]:
                        continue
                    self._trace_seen[tid].add(sid)
                ev = dict(ev)
                ev["replica"] = tname
                ev["ts_unix_us"] = origin * 1e6 + \
                    float(ev.get("ts_us", 0.0))
                bucket.append(ev)
                self._span_total += 1
                self._m_spans.inc()
            while (len(self._traces) > self.trace_capacity
                   or self._span_total > self.span_capacity) \
                    and self._traces:
                old, dropped = self._traces.popitem(last=False)
                self._trace_seen.pop(old, None)
                self._span_total -= len(dropped)

    def trace_ids(self, limit: int = 100) -> List[dict]:
        with self._lock:
            ids = list(self._traces.items())[-limit:]
        out = []
        for tid, spans in ids:
            root = next((s for s in spans
                         if not s.get("parent_id")), spans[0])
            out.append({"trace_id": tid, "spans": len(spans),
                        "root": root.get("name"),
                        "replicas": sorted({s.get("replica")
                                            for s in spans})})
        return out

    def trace_tree(self, trace_id: str) -> Optional[dict]:
        """The stitched cross-process span list for one trace id
        (prefix match accepted), spans ordered on the absolute
        wall-clock axis and ``ts_us`` REBASED to it so offline
        renderers see one timeline."""
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                for tid, sp in self._traces.items():
                    if tid.startswith(trace_id):
                        trace_id, spans = tid, sp
                        break
            if spans is None:
                return None
            spans = [dict(s) for s in spans]
        spans.sort(key=lambda s: s.get("ts_unix_us", 0.0))
        for s in spans:
            s["ts_us"] = s.get("ts_unix_us", s.get("ts_us", 0.0))
        return {"trace_id": trace_id, "spans": spans}

    # ---- liveness / incidents ----
    def _note_liveness(self, targets, parsed, errors) -> List[str]:
        up_now = set(parsed)
        with self._lock:
            prev_up = set(self._up)
            self._up = up_now
            self._down = dict(errors)
        # death = a member that answered last cycle and now either
        # fails its scrape or vanished from the pool entirely
        return sorted(prev_up - up_now)

    def _note_breach(self, info: dict) -> None:
        # called by SLOMonitor mid-evaluate; defer the bundle pull to
        # the cycle loop so the breach callback stays cheap
        with self._lock:
            self._pending_breach = dict(info)

    def _confirmed_deaths(self, died: List[str]) -> List[str]:
        """An unreachable replica is only a DEATH when the fleet
        agrees it is gone. A member the fleet still declares up is a
        scrape-PATH partition (the collector's hop is dark while the
        router's is fine — the asymmetric case): log and count it,
        never fabricate a replica-death incident bundle from it.
        Serving is untouched, so the incident would be noise that
        buries a real page. Likewise a PLANNED departure — a retire
        or a rollout's replace drained it out on purpose — is churn,
        not a death: paging on it would bury the one incident a
        rolled-back deploy actually writes."""
        if self.fleet is None or not died:
            return died
        fleet_up = {f"replica-{r.id}"
                    for r in self.fleet.snapshot()
                    if getattr(r, "fleet_state", "up") == "up"}
        try:
            planned = {f"replica-{rid}"
                       for rid in self.fleet.departed_rids()}
        except AttributeError:
            planned = set()
        confirmed = []
        for name in died:
            if name in planned:
                logger.info(
                    "fleetobs: %s left the pool by plan (retire/"
                    "replace drain) — churn, not a death; no "
                    "incident", name)
                continue
            if name in fleet_up:
                logger.warning(
                    "fleetobs: %s unreachable on the scrape path "
                    "but the fleet declares it up — asymmetric "
                    "partition, not a death; no incident", name)
                self._m_scrape_partitions.inc()
                continue
            confirmed.append(name)
        return confirmed

    def _check_incidents(self, targets, died: List[str]) -> None:
        died = self._confirmed_deaths(died)
        reason = None
        breached = False
        if self.slo_monitor is not None:
            try:
                breached = self.slo_monitor.any_breached(
                    evaluate=False)
            except Exception:
                breached = False
        with self._lock:
            if breached and not self._breached_prev:
                slo_name = (self._pending_breach
                            or {}).get("slo", "slo")
                reason = f"slo-breach-{slo_name}"
            elif died:
                reason = f"replica-death-{died[0]}"
            self._breached_prev = breached
            self._pending_breach = None
        if reason is None:
            return
        self.write_incident(reason, targets)

    def write_incident(self, reason: str,
                       targets: Optional[List[Tuple[str, str]]] = None
                       ) -> Optional[str]:
        """Pull a bundle from every LIVE member into one incident
        directory with a cross-process MANIFEST. Rate-limited so a
        flapping SLO cannot fill the disk. Returns the directory (or
        None when suppressed)."""
        now = time.time()
        with self._lock:
            if now - self._last_incident_unix \
                    < self.incident_min_interval_s:
                return None
            self._last_incident_unix = now
        if targets is None:
            targets = self._targets()
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:80]
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
        iid = f"incident-{stamp}-{safe}"
        root = os.path.join(self.incident_dir, iid)
        os.makedirs(root, exist_ok=True)
        members: Dict[str, str] = {}
        for tname, url in targets:
            try:
                raw = _http_get(
                    f"{url}/debug/bundle?reason={safe}",
                    max(self.scrape_timeout_s, 5.0))
                payload = json.loads(raw.decode())
                mdir = os.path.join(root, tname)
                os.makedirs(mdir, exist_ok=True)
                for fname, content in (payload.get("files")
                                       or {}).items():
                    fname = os.path.basename(fname)
                    fpath = os.path.join(mdir, fname)
                    with open(fpath, "w", encoding="utf-8") as f:
                        if fname.endswith(".jsonl") \
                                and isinstance(content, list):
                            for ev in content:
                                f.write(json.dumps(ev) + "\n")
                        else:
                            json.dump(content, f, indent=2,
                                      default=str)
                members[tname] = "ok"
            except Exception as e:
                members[tname] = f"error: {e!r}"
        with self._lock:
            recent_traces = list(self._traces)[-16:]
            down = dict(self._down)
        manifest = {
            "incident": iid,
            "reason": reason,
            "ts_unix": now,
            "members": members,
            "targets_down": down,
            "recent_trace_ids": recent_traces,
        }
        if self.slo_monitor is not None:
            try:
                manifest["slo"] = self.slo_monitor.status()
            except Exception:
                pass
        with open(os.path.join(root, "MANIFEST.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, default=str)
        self._m_incidents.inc()
        with self._lock:
            self._incidents.append({"incident": iid,
                                    "reason": reason,
                                    "ts_unix": now,
                                    "dir": root})
        logger.warning("fleet: incident bundle written: %s", root)
        if self.on_incident is not None:
            try:
                self.on_incident(manifest)
            except Exception:
                pass
        return root

    # ---- derived views ----
    def fleet_health(self) -> dict:
        """The router's fleet-health hook: affirmative SLO breaches
        degrade, a dead/stopped collector must NOT (the router treats
        any exception here as 'no fleet signal')."""
        breaches: List[str] = []
        if self.slo_monitor is not None:
            try:
                breaches = [s["name"] for s in
                            self.slo_monitor.status()
                            if s.get("breached")]
            except Exception:
                breaches = []
        with self._lock:
            down = sorted(self._down)
            last = self._last_cycle_unix
        return {"ok": not breaches,
                "slo_breaches": breaches,
                "targets_down": down,
                "last_scrape_unix": last}

    def load_signals(self) -> List[dict]:
        """Per-replica load in the router's ``load_signals`` shape,
        derived from the MERGED per-replica series — the autoscaler
        reads these when wired to the collector. Raises when the last
        successful cycle is stale so the caller falls back to the
        router's direct probes."""
        with self._lock:
            last = self._last_cycle_unix
            up = set(self._up)
        if time.time() - last > max(3 * self.interval_s, 5.0):
            raise RuntimeError("fleet scrape data is stale")
        out: List[dict] = []
        for tname in sorted(up):
            if not tname.startswith("replica-"):
                continue
            rid = tname[len("replica-"):]
            sig = {"rid": rid, "health": "ok", "eligible": True,
                   "queue_depth": 0.0, "inflight": 0.0,
                   "kv_pages_in_use": 0.0, "kv_pages_total": 0.0,
                   "prefix_cache_hits_total": 0.0,
                   "prefix_cache_evictions_total": 0.0}
            for inst in self.registry.collect():
                labels = inst.labels or {}
                if labels.get("replica") != tname:
                    continue
                if inst.name == "serving_gauge":
                    gname = labels.get("name", "")
                    v = inst.value() or 0.0
                    if gname.endswith("_queue_depth"):
                        sig["queue_depth"] += v
                    elif gname.endswith("_slots_in_use"):
                        sig["inflight"] += v
                    elif gname.endswith("_kv_pages_in_use"):
                        sig["kv_pages_in_use"] += v
                    elif gname.endswith("_kv_pages_total"):
                        sig["kv_pages_total"] += v
                elif inst.name == "prefix_cache_hits_total":
                    sig["prefix_cache_hits_total"] += inst.value
                elif inst.name == "prefix_cache_evictions_total":
                    sig["prefix_cache_evictions_total"] += inst.value
            out.append(sig)
        return out

    def replica_raw(self, rids: List[int]) -> Dict[int, dict]:
        """Per-replica raw gate-evidence counters: requests, errors,
        latency bucket counts (edges + counts), and exemplar trace
        ids from the slowest buckets, read off the REPLICA-LABELED
        merged series. Raises when the last successful scrape cycle
        is stale — same discipline as :meth:`cohort_stats`. The
        rollout controller snapshots this when it opens its gate
        window and hands it back as ``cohort_stats(..., since=...)``
        so the comparison covers only window-era traffic."""
        with self._lock:
            last = self._last_cycle_unix
        if time.time() - last > max(3 * self.interval_s, 5.0):
            raise RuntimeError("fleet scrape data is stale")
        want = {f"replica-{int(r)}": int(r) for r in rids}
        out: Dict[int, dict] = {
            int(r): {"requests": 0, "errors": 0, "edges": None,
                     "counts": None, "trace_ids": []}
            for r in rids}
        for inst in self.registry.collect():
            labels = inst.labels or {}
            rid = want.get(labels.get("replica", ""))
            if rid is None:
                continue
            d = out[rid]
            if inst.name == "serving_requests_total":
                d["requests"] += int(inst.value)
            elif inst.name == "serving_errors_total":
                d["errors"] += int(inst.value)
            elif inst.name == "serving_latency_seconds" \
                    and isinstance(inst, Histogram):
                edges, counts, _c, _s = inst.bucket_counts()
                if d["edges"] is None:
                    d["edges"] = list(edges)
                    d["counts"] = [int(c) for c in counts]
                elif d["edges"] == list(edges):
                    for i, c in enumerate(counts):
                        d["counts"][i] += int(c)
                for _i, ex in sorted(
                        getattr(inst, "_exemplars", {}).items(),
                        reverse=True):
                    tid = (ex[0] or {}).get("trace_id") \
                        if isinstance(ex, tuple) else None
                    if tid:
                        d["trace_ids"].append(tid)
        return out

    def cohort_stats(self, cohorts: Dict[str, List[int]],
                     since: Optional[Dict[int, dict]] = None
                     ) -> Dict[str, dict]:
        """Comparative-gate evidence: per cohort (name → replica
        ids), requests/errors summed and latency bucket-merged over
        the members' REPLICA-LABELED serving series, plus up to 8
        exemplar trace ids from the slowest merged buckets. Raises
        when the last successful scrape cycle is stale — the rollout
        controller must HOLD on a dead/stale collector (the
        autoscaler's sensors_ok discipline): promotion needs fresh
        affirmative evidence, and rollback needs fresh affirmative
        evidence too.

        ``since`` (a prior :meth:`replica_raw` snapshot) windows the
        evidence: each member's counters are diffed against its
        snapshot entry before aggregation, so a canary's cold-start
        calls and the incumbents' pre-rollout history drop out and
        both cohorts are compared over the SAME traffic window.
        Members absent from the snapshot (booted after it) count
        from zero, which for rollout cohorts is exactly their
        window-era total."""
        all_rids = sorted({int(r) for rids in cohorts.values()
                           for r in rids})
        raws = self.replica_raw(all_rids)
        out: Dict[str, dict] = {}
        for name, rids in cohorts.items():
            d = {"requests": 0, "errors": 0, "p99_ms": 0.0,
                 "replicas": sorted(int(r) for r in rids),
                 "trace_ids": []}
            edges: Optional[List[float]] = None
            counts: Optional[List[int]] = None
            tids: List[str] = []
            for rid in d["replicas"]:
                raw = raws.get(rid)
                if raw is None:
                    continue
                req, err = raw["requests"], raw["errors"]
                r_counts = raw["counts"]
                prev = (since or {}).get(rid)
                if prev is not None:
                    req = max(0, req - int(prev.get("requests", 0)))
                    err = max(0, err - int(prev.get("errors", 0)))
                    if r_counts is not None \
                            and prev.get("edges") == raw["edges"]:
                        r_counts = [
                            max(0, a - int(b)) for a, b in
                            zip(r_counts, prev.get("counts") or [])]
                d["requests"] += req
                d["errors"] += err
                if r_counts is not None:
                    if edges is None:
                        edges = raw["edges"]
                        counts = list(r_counts)
                    elif edges == raw["edges"]:
                        for i, c in enumerate(r_counts):
                            counts[i] += c
                tids.extend(raw["trace_ids"])
            if edges is not None and counts is not None:
                d["p99_ms"] = round(
                    _hist_quantile(edges, counts, .99) * 1e3, 3)
            d["trace_ids"] = tids[:8]
            out[name] = d
        return out

    def fleet_snapshot(self) -> dict:
        """The JSON dashboard payload ``fleet-status`` renders."""
        with self._lock:
            down = dict(self._down)
            up = sorted(self._up)
            last = self._last_cycle_unix
            cycles = self._cycles
            incidents = list(self._incidents[-8:])
            n_traces = len(self._traces)
            ring = self._ring.items()
            stride = self._ring.stride
        endpoints: Dict[str, dict] = {}
        phases: Dict[str, float] = {}
        for inst in self.registry.collect():
            labels = inst.labels or {}
            if "replica" in labels:
                continue                      # aggregates only
            if inst.name == "serving_latency_seconds" \
                    and isinstance(inst, Histogram):
                ep = labels.get("endpoint", "?")
                edges, counts, count, _ = inst.bucket_counts()
                d = endpoints.setdefault(
                    ep, {"count": 0, "errors": 0,
                         "p50_ms": 0.0, "p99_ms": 0.0})
                d["count"] = count
                d["p50_ms"] = _hist_quantile(edges, counts, .5) * 1e3
                d["p99_ms"] = _hist_quantile(edges, counts, .99) * 1e3
            elif inst.name == "serving_errors_total":
                ep = labels.get("endpoint", "?")
                endpoints.setdefault(
                    ep, {"count": 0, "errors": 0,
                         "p50_ms": 0.0, "p99_ms": 0.0})["errors"] = \
                    int(inst.value)
            elif inst.name == "serving_phase_seconds" \
                    and isinstance(inst, Histogram):
                ph = labels.get("phase", "?")
                edges, counts, _, _ = inst.bucket_counts()
                phases[ph] = max(
                    phases.get(ph, 0.0),
                    _hist_quantile(edges, counts, .99) * 1e3)
        signals = None
        try:
            signals = self.load_signals()
        except Exception:
            pass
        snap = {"ts_unix": last, "cycles": cycles,
                "interval_s": self.interval_s,
                "targets": {t: "up" for t in up},
                "endpoints": endpoints,
                "phases_p99_ms": phases,
                "replicas": signals,
                "incidents": incidents,
                "traces": {"count": n_traces,
                           "recent": self.trace_ids(5)},
                "ring": ring, "ring_stride": stride}
        for t, err in down.items():
            snap["targets"][t] = f"down ({err})"
        if self.slo_monitor is not None:
            try:
                snap["slo"] = self.slo_monitor.status()
            except Exception:
                pass
        try:
            snap["alerts"] = self.alerts.firing()
        except Exception:
            pass
        # per-replica model version + rollout state, read off the
        # in-process router's debug surface: an operator watching
        # fleet-status sees the canary (and which gate it is
        # waiting on) at a glance
        if self.router is not None:
            try:
                fd = self.router.fleet_debug()
            except Exception:
                fd = None
            if fd is not None:
                snap["versions"] = {
                    str(r["id"]): r.get("model_version", 1)
                    for r in fd.get("replicas", [])}
                if fd.get("rollout") is not None:
                    snap["rollout"] = fd["rollout"]
        return snap

    def _append_ring_sample(self, targets, errors) -> None:
        sample = {"ts_unix": time.time(),
                  "up": len(targets) - len(errors),
                  "targets": len(targets)}
        # headline: the busiest aggregate latency family this cycle
        busiest = None
        for inst in self.registry.collect():
            if inst.name != "serving_latency_seconds" \
                    or not isinstance(inst, Histogram) \
                    or "replica" in (inst.labels or {}):
                continue
            if busiest is None or inst.count > busiest.count:
                busiest = inst
        if busiest is not None:
            edges, counts, count, _ = busiest.bucket_counts()
            sample["endpoint"] = \
                (busiest.labels or {}).get("endpoint", "?")
            sample["count"] = count
            sample["p99_ms"] = \
                _hist_quantile(edges, counts, .99) * 1e3
        with self._lock:
            self._ring.append(sample)

    # ---- lifecycle ----
    def start(self) -> "FleetCollector":
        """Open the collector listener and start the scrape loop."""
        from deeplearning4j_tpu_torch.serving.http import (
            _JsonRequestHandler, _make_listener)
        from urllib.parse import urlparse, parse_qs
        collector = self

        class Handler(_JsonRequestHandler):
            def do_GET(self):
                parsed = urlparse(self.path)
                q = parse_qs(parsed.query)
                path = parsed.path
                try:
                    if path == "/metrics":
                        mode = self._metrics_mode()
                        if mode == "openmetrics":
                            self._send_text(
                                200,
                                collector.registry.prometheus_text(
                                    openmetrics=True),
                                "application/openmetrics-text; "
                                "version=1.0.0; charset=utf-8")
                        elif mode == "text":
                            self._send_text(
                                200,
                                collector.registry.prometheus_text(),
                                "text/plain; version=0.0.4; "
                                "charset=utf-8")
                        else:
                            self._send(
                                200, collector.registry.snapshot())
                    elif path == "/healthz":
                        h = collector.fleet_health()
                        h["status"] = "ok" if h["ok"] else "degraded"
                        self._send(200, h)
                    elif path == "/fleet/snapshot":
                        self._send(200, collector.fleet_snapshot())
                    elif path == "/fleet/signals":
                        try:
                            self._send(200,
                                       {"signals":
                                        collector.load_signals()})
                        except RuntimeError as e:
                            self._send(503, {"error": str(e)})
                    elif path == "/traces":
                        limit = int((q.get("limit") or ["100"])[0])
                        self._send(200,
                                   {"traces":
                                    collector.trace_ids(limit)})
                    elif path == "/debug/trace":
                        tid = (q.get("trace_id") or [""])[0]
                        tree = collector.trace_tree(tid) if tid \
                            else None
                        if tree is None:
                            self._send(404,
                                       {"error": "unknown trace id"})
                        else:
                            self._send(200, tree)
                    else:
                        self._send(404, {"error": "not found"})
                except (BrokenPipeError, ConnectionResetError):
                    pass

        httpd = _make_listener(self.host, self.port, Handler)
        http_thread = threading.Thread(
            target=httpd.serve_forever,
            name="fleet-collector-http", daemon=True)
        # a fresh Event per generation: clearing the old one could
        # revive a previous (still-stopping) loop with no handle
        stop_evt = threading.Event()
        thread = threading.Thread(
            target=self._loop, args=(stop_evt,),
            name="fleet-collector", daemon=True)
        with self._lock:
            self._httpd = httpd
            self._http_thread = http_thread
            self._stop_evt = stop_evt
            self._thread = thread
        self.port = httpd.server_address[1]
        http_thread.start()
        thread.start()
        return self

    def _loop(self, stop_evt: threading.Event) -> None:
        while not stop_evt.is_set():
            try:
                self.scrape_once()
            except Exception:
                logger.exception("fleet scrape cycle failed")
            stop_evt.wait(self.interval_s)

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            thread, self._thread = self._thread, None
            httpd, self._httpd = self._httpd, None
            http_thread, self._http_thread = self._http_thread, None
        if thread is not None:
            thread.join(timeout=10.0)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if http_thread is not None:
            http_thread.join(timeout=5.0)
        if self.slo_monitor is not None:
            self.slo_monitor.close()
        self.alerts.stop()


# --------------------------------------------------------------------
# text dashboard
# --------------------------------------------------------------------

def render_status(snap: dict) -> str:
    """``cli.py fleet-status``'s text dashboard over a
    :meth:`FleetCollector.fleet_snapshot` payload."""
    lines: List[str] = []
    ts = snap.get("ts_unix") or 0
    when = time.strftime("%Y-%m-%dT%H:%M:%S",
                         time.localtime(ts)) if ts else "never"
    lines.append(f"fleet-status  (last scrape {when}, "
                 f"interval {snap.get('interval_s', '?')}s, "
                 f"cycles {snap.get('cycles', 0)})")
    targets = snap.get("targets") or {}
    tparts = []
    for name in sorted(targets):
        state = targets[name]
        tparts.append(f"{name} {'UP' if state == 'up' else 'DOWN'}")
    lines.append("members : " + (", ".join(tparts) or "(none)"))
    eps = snap.get("endpoints") or {}
    if eps:
        lines.append("merged latency by endpoint:")
        lines.append(f"  {'endpoint':<14}{'count':>8}{'errors':>8}"
                     f"{'p50 ms':>9}{'p99 ms':>9}")
        for ep in sorted(eps):
            d = eps[ep]
            lines.append(f"  {ep:<14}{d.get('count', 0):>8}"
                         f"{d.get('errors', 0):>8}"
                         f"{d.get('p50_ms', 0.0):>9.2f}"
                         f"{d.get('p99_ms', 0.0):>9.2f}")
    phases = snap.get("phases_p99_ms") or {}
    if phases:
        lines.append("phase p99 (ms): "
                     + "  ".join(f"{k}={v:.2f}"
                                 for k, v in sorted(phases.items())))
    for s in snap.get("slo") or []:
        burns = s.get("burn_rates") or {}
        burn = "  ".join(f"{w}={b:.2f}"
                         for w, b in sorted(burns.items()))
        state = "BREACH" if s.get("breached") else "ok"
        lines.append(f"slo {s.get('name')}: {state}  {burn}")
    reps = snap.get("replicas")
    versions = snap.get("versions") or {}
    if reps:
        for r in reps:
            kvt = r.get("kv_pages_total") or 0
            kv = (100.0 * r.get("kv_pages_in_use", 0) / kvt) \
                if kvt else 0.0
            ver = versions.get(str(r.get("rid")))
            vcol = f" v{ver}" if ver is not None else ""
            lines.append(f"replica {r.get('rid')}:{vcol} "
                         f"queue={r.get('queue_depth', 0):.0f} "
                         f"inflight={r.get('inflight', 0):.0f} "
                         f"kv={kv:.0f}%")
    ro = snap.get("rollout")
    if ro:
        gate = ro.get("last_gate")
        lines.append(
            f"rollout : {ro.get('state', '?')} "
            f"v{ro.get('incumbent_version', '?')}"
            f"->v{ro.get('candidate_version', '?')} "
            f"updated {ro.get('updated', 0)}/{ro.get('total', 0)}"
            + (f"  gate={gate}" if gate else "")
            + (f"  holds={ro.get('holds')}" if ro.get("holds")
               else ""))
    tr = snap.get("traces") or {}
    if tr:
        recent = ", ".join(t["trace_id"][:12]
                           for t in tr.get("recent") or [])
        lines.append(f"traces  : {tr.get('count', 0)} collected"
                     + (f"  recent: {recent}" if recent else ""))
    inc = snap.get("incidents") or []
    if inc:
        lines.append("incidents: "
                     + ", ".join(i["incident"] for i in inc))
    alerts = snap.get("alerts") or []
    if alerts:
        lines.append("alerts  : "
                     + ", ".join(a.get("name", "?") for a in alerts))
    return "\n".join(lines)
