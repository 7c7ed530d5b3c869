"""Training stats collection + storage (counterpart of
``deeplearning4j_tpu/ui/stats.py``).

Mirrors deeplearning4j-ui-model's BaseStatsListener (iterationDone ->
memory/timings -> histograms & mean magnitudes of params/updates) and
the StatsStorage API (in-memory + file impls). The wire format is the
JAX package's JSON lines: ``StatsReport``, the storages and their files
are the same, field for field, so a stats file written by either
package loads in the other's dashboard.

On the card the listener keeps the work there: the JAX listener pulls
every parameter to the host each report (420 MB a report at the
transformer LM's 105M parameters) and keeps the previous ones as host
copies; this one keeps the previous parameters as a device copy,
computes the mean magnitudes, the update:param ratios and the histogram
counts on the device, and fetches only those small results (two reads a
report: the sums and ranges, then the counts).

The histograms are ``np.histogram(arr, bins=20)``'s, count for count.
numpy takes the edges from the data's range (``linspace`` of min and
max, in the data's float32), bins each value by ``(x - first) /
(last - first) * 20`` in float32, and then moves an index down where
``x`` falls below its bin's float32 edge and up where it reaches the
next one. The device does the same arithmetic (true float32 division by
a device scalar; ``torch.histc`` bins differently at the edges), and the
edges themselves come from numpy on the host, from the fetched range.
Mean magnitudes are float32 sums on the device (one fused reduction a
tensor): they agree with numpy's float32 means within float32 summation
order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.listeners import TrainingListener

__all__ = ["StatsReport", "StatsListener", "InMemoryStatsStorage",
           "FileStatsStorage"]

BINS = 20


@dataclasses.dataclass
class StatsReport:
    """One iteration's stats (SbeStatsReport equivalent)."""

    session_id: str
    worker_id: str
    iteration: int
    timestamp: float
    score: float
    # per-param-group summaries: name -> value
    param_mean_magnitudes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    gradient_mean_magnitudes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    update_mean_magnitudes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per-layer mean|update|/mean|param| — TrainModule's update:param
    # ratio chart (healthy training ~1e-3)
    update_ratios: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    learning_rate: Optional[float] = None
    histograms: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # layer name -> base64 PNG of tiled conv activations
    activation_images: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    duration_ms: float = 0.0
    samples_per_sec: float = 0.0
    memory_bytes: Optional[int] = None
    # step decomposition from observability.step_profile
    # (data_wait_ms / dispatch_ms / device_fence_ms / mfu ...): the
    # dashboard and remote-POST route carry the profiler's reports
    # through the same storage pipe as training stats
    profile: Dict[str, float] = dataclasses.field(default_factory=dict)
    # training-health fields (observability/health.py): global L2
    # norms from the fused in-step check, plus detector outputs
    # (finite_bits, worst_dead_fraction, ...) stamped by a chained
    # HealthMonitor
    gradient_norm: Optional[float] = None
    update_norm: Optional[float] = None
    param_norm: Optional[float] = None
    health: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "StatsReport":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError("StatsReport JSON must be an object, "
                             f"got {type(d).__name__}")
        # tolerate unknown keys (a newer writer's extra fields) but
        # keep every known one — the round-trip contract is pinned by
        # the golden tests in tests/test_health.py and
        # tests/test_torch_stats_ui.py
        known = {f.name for f in dataclasses.fields(StatsReport)}
        return StatsReport(**{k: v for k, v in d.items()
                              if k in known})


class InMemoryStatsStorage:
    """(api/storage/impl/InMemoryStatsStorage.java)."""

    def __init__(self):
        self._reports: Dict[str, List[StatsReport]] = {}

    def put_update(self, report: StatsReport):
        self._reports.setdefault(report.session_id, []).append(report)

    def list_session_ids(self) -> List[str]:
        return sorted(self._reports)

    def get_all_updates(self, session_id: str) -> List[StatsReport]:
        return list(self._reports.get(session_id, []))

    def get_latest_update(self, session_id: str) -> Optional[StatsReport]:
        r = self._reports.get(session_id)
        return r[-1] if r else None


class FileStatsStorage(InMemoryStatsStorage):
    """JSON-lines file persistence (FileStatsStorage.java equivalent)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        super().put_update(StatsReport.from_json(line))

    def put_update(self, report: StatsReport):
        super().put_update(report)
        with open(self.path, "a") as f:
            f.write(report.to_json() + "\n")


def _histogram(arr: np.ndarray, bins: int = BINS) -> dict:
    """The JAX package's histogram of a host array."""
    counts, edges = np.histogram(arr, bins=bins)
    return {"min": float(edges[0]), "max": float(edges[-1]),
            "counts": counts.tolist()}


def _numpy_edges(lo, hi, bins: int = BINS):
    """(edges as float32, first edge, last - first) as ``np.histogram``
    takes them for float32 data whose range is [lo, hi]: numpy's own
    code on a two-value array, so the degenerate range (lo == hi, widened
    by 0.5 each way) and any numpy version's promotion rules come out as
    numpy's. Raises numpy's ValueError on a range that is not finite."""
    a = np.array([lo, hi], np.float32)
    edges = np.histogram_bin_edges(a, bins=bins)
    first, last = a.min(), a.max()
    if first == last:
        first = first - 0.5
        last = last + 0.5
    return (edges.astype(np.float32), np.float32(first),
            np.float32(last - first))


# values a histogram pass bins at once: its temporaries (the values'
# group ids, first edges, widths and bins) stay under ~0.5 GB
CHUNK = 1 << 23


def _bins(x: torch.Tensor, seg: torch.Tensor,
          table: torch.Tensor) -> torch.Tensor:
    """numpy's bin of each float32 value of ``x``, offset by its group:
    ``seg`` gives each value's group (a row of ``table``: 21 float32
    edges, the first edge, last - first). The division is by a device
    tensor: a host scalar would turn it into a product by the
    reciprocal, which rounds differently."""
    first, denom = table[:, BINS + 1][seg], table[:, BINS + 2][seg]
    idx = ((x - first) / denom * BINS).to(torch.int64)
    idx -= (idx == BINS).to(torch.int64)
    base = seg * (BINS + 1)
    edges = table[:, :BINS + 1].reshape(-1)
    idx -= (x < edges[base + idx]).to(torch.int64)
    idx += ((x >= edges[base + idx + 1])
            & (idx != BINS - 1)).to(torch.int64)
    return seg * BINS + idx


def device_histograms(groups: List[List[torch.Tensor]], ranges) -> List[dict]:
    """The histogram of each group of flat float32 tensors (one device),
    as ``np.histogram`` of their concatenation gives it: ``ranges`` holds
    each group's (min, max), already on the host. The tensors of all
    groups are binned together in chunks of up to CHUNK values (a few
    dozen launches for the LM's 107 tensors, not a few per tensor), and
    the counts are read once."""
    if not groups:
        return []
    host = [_numpy_edges(lo, hi) for lo, hi in ranges]
    parts = [(g, x) for g, xs in enumerate(groups) for x in xs
             if x.numel()]
    if not parts:
        return [_histogram(np.zeros(0, np.float32)) for _ in groups]
    dev = parts[0][1].device
    table = torch.from_numpy(np.stack(
        [np.concatenate([e, [f, d]]) for e, f, d in host])).to(dev)
    sizes = [x.numel() for _, x in parts]
    gid = torch.tensor([g for g, _ in parts], device=dev)
    offs = torch.tensor(np.cumsum([0] + sizes[:-1]), device=dev)
    total = len(groups) * BINS
    counts = torch.zeros(total, dtype=torch.int64, device=dev)
    a = 0
    while a < len(parts):
        b, n = a + 1, sizes[a]
        while b < len(parts) and n + sizes[b] <= CHUNK:
            n += sizes[b]
            b += 1
        x = (torch.cat([v for _, v in parts[a:b]]) if b - a > 1
             else parts[a][1])
        # each value's group: the part it falls in, by its position
        pos = torch.arange(n, device=dev)
        part = torch.searchsorted(offs[a:b] - offs[a], pos, right=True) - 1
        ids = _bins(x, gid[a:b][part], table).to(torch.float32)
        # counted in shared memory on a card (exact: whole numbers under
        # 2^24, each at the middle of its unit bin); neither bincount,
        # which reads its largest index back (a host sync a call), nor
        # a scatter_add_, whose atomics on 20 addresses a tensor queue
        counts += torch.histc(ids, bins=total, min=-0.5,
                              max=total - 0.5).to(torch.int64)
        a = b
    counts = counts.view(len(groups), BINS).cpu().numpy()
    return [{"min": float(e[0]), "max": float(e[-1]),
             "counts": c.tolist()} for (e, _, _), c in zip(host, counts)]


class StatsListener(TrainingListener):
    """(BaseStatsListener.java:44). Collects score + per-layer param/
    update summaries every ``frequency`` iterations into a StatsStorage,
    computed on the parameters' device (see the module docstring):
    ``param_mean_magnitudes`` and ``histograms["param/<i>_<name>"]`` for
    every parameter, and from the second report on the per-layer
    ``update_mean_magnitudes`` and ``update_ratios`` (mean |update| over
    mean |param|) with ``"all"`` and ``histograms["update/all"]`` over
    every layer whose shapes did not change. A tensor-parallel model's
    report reads its full parameters (gathered over the model group, a
    collective): every rank of the group attaches the listener."""

    def __init__(self, storage, frequency: int = 10,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker_0",
                 collect_histograms: bool = True):
        self.storage = storage
        self.freq = max(1, frequency)
        self.session_id = session_id or f"session_{int(time.time())}"
        self.worker_id = worker_id
        self.collect_histograms = collect_histograms
        self._last_time = None
        # the previous report's parameters, device copies by name
        self._prev: Optional[Dict[str, torch.Tensor]] = None

    @staticmethod
    def _current_lr(model, iteration) -> Optional[float]:
        """Schedule-aware current learning rate (TrainModule's LR
        chart)."""
        try:
            cfg = model.conf.conf.updater_cfg
            if cfg is None:
                return None
            lr = cfg.get("lr")
            sched = cfg.get("schedule")
            if sched:
                from deeplearning4j_tpu_torch.nn.conf import updaters
                fn = updaters.make_schedule(lr, sched)
                if not callable(fn):
                    return float(fn)
                return float(fn(torch.tensor(iteration, dtype=torch.int32)))
            return float(lr) if lr is not None else None
        except Exception:
            return None

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration % self.freq != 0:
            return
        now = time.perf_counter()
        duration = 0.0 if self._last_time is None else \
            (now - self._last_time) * 1000 / self.freq
        self._last_time = now
        report = StatsReport(
            session_id=self.session_id, worker_id=self.worker_id,
            iteration=iteration, timestamp=time.time(),
            score=float(score), duration_ms=duration,
            samples_per_sec=(batch_size * 1000.0 / duration
                             if duration > 0 else 0.0),
            learning_rate=self._current_lr(model, iteration))
        flat: Dict[str, torch.Tensor] = {}
        per_layer: Dict[str, List[str]] = {}
        for layer, name, p in self.named_params(model):
            flat[name] = p.detach().reshape(-1)
            per_layer.setdefault(layer, []).append(name)
        if flat:
            self._summarize(report, flat, per_layer)
        self.storage.put_update(report)

    def _summarize(self, report, flat, per_layer) -> None:
        prev = self._prev
        if prev is not None and set(prev) != set(flat):
            prev = None
        # skip a whole layer if ANY param changed shape (e.g.
        # transfer-learning surgery): a partial ratio would mislead
        layers = [] if prev is None else [
            (layer, names) for layer, names in per_layer.items()
            if all(prev[n].shape == flat[n].shape for n in names)]
        names = list(flat)
        upd = {n: flat[n] - prev[n] for _, ns in layers for n in ns}
        # one read: sum|p|, min, max of every parameter, then the same
        # of every update (two launches a tensor)
        sums, los, his = [], [], []
        for t in list(flat.values()) + list(upd.values()):
            sums.append(torch.linalg.vector_norm(t, 1))
            lo, hi = (torch.aminmax(t) if t.numel()
                      else (t.new_zeros(()), t.new_zeros(())))
            los.append(lo)
            his.append(hi)
        stats = torch.stack([torch.stack(sums), torch.stack(los),
                             torch.stack(his)], 1).double().cpu().numpy()
        pstats = dict(zip(names, stats[:len(names)]))
        ustats = dict(zip(upd, stats[len(names):]))
        for n in names:
            report.param_mean_magnitudes[n] = float(
                pstats[n][0] / flat[n].numel()) if flat[n].numel() \
                else float("nan")
        groups, ranges, keys = [], [], []
        if self.collect_histograms:
            for n in names:
                if flat[n].numel():
                    groups.append([flat[n]])
                    ranges.append((pstats[n][1], pstats[n][2]))
                    keys.append(f"param/{n}")
                else:
                    report.histograms[f"param/{n}"] = _histogram(
                        np.zeros(0, np.float32))
        if layers:
            tot_u = tot_n = 0.0
            for layer, ns in layers:
                n_el = sum(flat[n].numel() for n in ns)
                su = sum(ustats[n][0] for n in ns)
                sp = sum(pstats[n][0] for n in ns)
                mu, mp = su / n_el, sp / n_el
                report.update_mean_magnitudes[layer] = float(mu)
                report.update_ratios[layer] = float(
                    mu / mp) if mp > 0 else 0.0
                tot_u, tot_n = tot_u + su, tot_n + n_el
            report.update_mean_magnitudes["all"] = float(tot_u / tot_n)
            if self.collect_histograms:
                live = [n for n in upd if upd[n].numel()]
                if live:
                    groups.append([upd[n] for n in live])
                    ranges.append((min(ustats[n][1] for n in live),
                                   max(ustats[n][2] for n in live)))
                    keys.append("update/all")
                else:
                    report.histograms["update/all"] = _histogram(
                        np.zeros(0, np.float32))
        for key, h in zip(keys, device_histograms(groups, ranges)):
            report.histograms[key] = h
        if self._prev is None or prev is None:
            self._prev = {n: t.clone() for n, t in flat.items()}
        else:
            for n, t in flat.items():
                if prev[n].shape == t.shape:
                    prev[n].copy_(t)
                else:
                    prev[n] = t.clone()

    @staticmethod
    def _iter_params(model):
        # a tensor-parallel model's full parameters, gathered over its
        # model group: every rank of the group reports alike
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            full_params)
        params = full_params(model)
        if isinstance(params, dict):
            return [params[k] for k in sorted(params)]
        return params

    @classmethod
    def named_params(cls, model):
        """(layer index as a string, report name, tensor) of every
        parameter: ``<i>_<key>`` as in the JAX listener; a nested dict or
        list (the transformer block's ``attn``) joins its keys with
        ``_`` (``<i>_attn_Wq``), where the JAX listener, which casts each
        value to one array, fails."""
        def leaves(prefix, value):
            if isinstance(value, dict):
                for k, v in value.items():
                    yield from leaves(f"{prefix}_{k}", v)
            elif isinstance(value, (list, tuple)):
                for j, v in enumerate(value):
                    yield from leaves(f"{prefix}_{j}", v)
            else:
                yield prefix, value
        for i, layer_params in enumerate(cls._iter_params(model)):
            for name, p in leaves(str(i), layer_params):
                yield str(i), name, p
