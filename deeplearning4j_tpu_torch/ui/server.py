"""Training visualization web UI (counterpart of
``deeplearning4j_tpu/ui/server.py``; host code, copied with the imports
renamed: the page, the routes and their JSON are the JAX package's).

Mirrors deeplearning4j-play's PlayUIServer (ui/play/PlayUIServer.java:53,
default port 9000) + the train module (module/train/TrainModule.java):
a web dashboard showing score-vs-iteration, throughput, and per-layer
parameter mean magnitudes. Stdlib http.server + a self-contained HTML
page (inline SVG charts — zero external assets), instead of the
Play framework + JS bundles.

Endpoints: ``/`` (dashboard), ``/api/sessions``, ``/api/updates?session=``.
POST ``/api/remote`` accepts remote stats (the remote-listener path,
deeplearning4j-ui-remote-iterationlisteners).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.ui.stats import InMemoryStatsStorage, StatsReport

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["UIServer"]

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j-tpu training UI</title>
<style>
 body { font-family: sans-serif; margin: 2em; background: #fafafa; }
 h1 { font-size: 1.3em; } h2 { font-size: 1.05em; color: #444; }
 .chart { background: white; border: 1px solid #ddd; margin: 1em 0;
          padding: 0.5em; }
 text { font-size: 10px; fill: #666; }
 .meta { color: #888; font-size: 0.9em; }
</style></head>
<body>
<h1>Training dashboard</h1>
<div class="meta" id="meta"></div>
<div class="chart"><h2>Training health</h2>
  <div id="health"><span class="meta">no health data</span></div></div>
<div class="chart"><h2>Score vs iteration</h2>
  <svg id="score" width="800" height="220"></svg></div>
<div class="chart"><h2>Samples/sec</h2>
  <svg id="tput" width="800" height="160"></svg></div>
<div class="chart"><h2>Learning rate</h2>
  <svg id="lr" width="800" height="120"></svg></div>
<div class="chart"><h2>Mean |param| per layer</h2>
  <svg id="params" width="800" height="220"></svg></div>
<div class="chart"><h2>log10 update:param ratio per layer
  (healthy ~ -3)</h2>
  <svg id="ratios" width="800" height="220"></svg></div>
<div class="chart"><h2>Parameter histograms (latest report)</h2>
  <div id="hists"></div></div>
<div class="chart"><h2>Conv activations (latest report)</h2>
  <div id="acts"></div></div>
<div class="chart"><h2>Network flow</h2>
  <svg id="flow" width="800" height="10"></svg></div>
<div class="chart"><h2>t-SNE</h2>
  <svg id="tsne" width="500" height="500"></svg></div>
<script>
function histogram(container, name, h) {
  const W = 240, H = 110, n = h.counts.length;
  const max = Math.max(...h.counts, 1);
  let bars = '';
  for (let i = 0; i < n; i++) {
    const bh = h.counts[i] / max * (H - 30);
    bars += `<rect x="${6 + i * (W - 12) / n}" y="${H - 16 - bh}"
             width="${(W - 14) / n}" height="${bh}" fill="#69b"/>`;
  }
  container.innerHTML +=
    `<svg width="${W}" height="${H}" style="margin:4px">${bars}
     <text x="6" y="12">${name}</text>
     <text x="6" y="${H-4}">${h.min.toPrecision(3)}</text>
     <text x="${W-60}" y="${H-4}">${h.max.toPrecision(3)}</text></svg>`;
}
</script>
<script>
function line(svg, xs, ys, color) {
  const el = document.getElementById(svg);
  const W = el.getAttribute('width'), H = el.getAttribute('height');
  if (xs.length < 2) return;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const yv = ys.filter(v => isFinite(v));
  const ymin = Math.min(...yv), ymax = Math.max(...yv);
  const sx = x => 40 + (x - xmin) / Math.max(xmax - xmin, 1e-9) * (W - 60);
  const sy = y => H - 20 - (y - ymin) / Math.max(ymax - ymin, 1e-9) * (H - 40);
  const pts = xs.map((x, i) => `${sx(x)},${sy(ys[i])}`).join(' ');
  el.innerHTML += `<polyline points="${pts}" fill="none" stroke="${color}"
                   stroke-width="1.5"/>` +
    `<text x="4" y="14">${ymax.toPrecision(4)}</text>` +
    `<text x="4" y="${H-22}">${ymin.toPrecision(4)}</text>`;
}
async function refreshHealth() {
  const h = await (await fetch('/api/health')).json();
  const colors = {ok: '#2a2', degraded: '#c80', diverged: '#c22'};
  let html = `<span style="display:inline-block;padding:2px 10px;
    border-radius:10px;color:white;background:${colors[h.status]||'#888'}">
    ${h.status.toUpperCase()}</span>`;
  if (h.alerts && h.alerts.length) {
    html += '<ul>' + h.alerts.map(a =>
      `<li><b>${a.name}</b> (${a.severity}): ${a.metric} = ` +
      `${a.value === null ? '?' : Number(a.value).toPrecision(4)} ` +
      `${a.op} ${a.threshold}</li>`).join('') + '</ul>';
  }
  const m = h.monitor;
  if (m) {
    const last = m.last || {};
    html += `<div class="meta">iteration ${last.iteration ?? '—'},
      loss ${last.loss === undefined ? '—' :
             Number(last.loss).toPrecision(5)},
      |grad| ${last.grad_norm == null ? '—' :
               Number(last.grad_norm).toPrecision(4)},
      anomalies: ${m.anomaly_count}</div>`;
    if (m.anomalies && m.anomalies.length) {
      html += '<ul>' + m.anomalies.slice(-8).reverse().map(a =>
        `<li>[${a.policy}] <b>${a.kind}</b> @${a.iteration}:
         ${a.message}</li>`).join('') + '</ul>';
    }
  }
  document.getElementById('health').innerHTML = html;
}
async function refresh() {
  try { await refreshHealth(); } catch (e) {}
  const sessions = await (await fetch('/api/sessions')).json();
  if (!sessions.length) return;
  const sid = sessions[sessions.length - 1];
  const updates = await (await fetch('/api/updates?session=' + sid)).json();
  document.getElementById('meta').textContent =
    `session ${sid} — ${updates.length} reports`;
  for (const id of ['score', 'tput', 'lr', 'params', 'ratios'])
    document.getElementById(id).innerHTML = '';
  const it = updates.map(u => u.iteration);
  line('score', it, updates.map(u => u.score), '#d33');
  line('tput', it, updates.map(u => u.samples_per_sec), '#36c');
  line('lr', it, updates.map(u => u.learning_rate || 0), '#a50');
  const colors = ['#283', '#c63', '#639', '#366', '#933', '#369'];
  const names = Object.keys(updates[updates.length-1]
                            .param_mean_magnitudes || {});
  names.forEach((n, i) => line('params', it,
    updates.map(u => u.param_mean_magnitudes[n] || 0),
    colors[i % colors.length]));
  const rnames = Object.keys(updates[updates.length-1]
                             .update_ratios || {});
  rnames.forEach((n, i) => line('ratios', it,
    updates.map(u => Math.log10((u.update_ratios || {})[n] || 1e-12)),
    colors[i % colors.length]));
  const hd = document.getElementById('hists');
  hd.innerHTML = '';
  const hs = updates[updates.length-1].histograms || {};
  Object.keys(hs).slice(0, 12).forEach(n => histogram(hd, n, hs[n]));
  // conv activations: newest report in any session carrying images
  const ad = document.getElementById('acts');
  ad.innerHTML = '';
  const imgs = await (await fetch('/api/activations')).json();
  Object.keys(imgs).forEach(n => { ad.innerHTML +=
    `<div style="display:inline-block;margin:4px;text-align:center">
     <img src="data:image/png;base64,${imgs[n]}"/><br/>
     <small>${n}</small></div>`; });
  // network-flow diagram: layered DAG of the attached model
  const flow = await (await fetch('/api/flow')).json();
  const fsvg = document.getElementById('flow');
  if (flow.nodes && flow.nodes.length) {
    const ROWH = 54, BW = 130, BH = 34;
    const rows = Math.max(...flow.nodes.map(n => n.row)) + 1;
    fsvg.setAttribute('height', rows * ROWH + 10);
    const pos = {};
    const byRow = {};
    flow.nodes.forEach(n => {
      (byRow[n.row] = byRow[n.row] || []).push(n); });
    let body = '';
    Object.values(byRow).forEach(ns => {
      ns.forEach((n, i) => {
        const x = 20 + i * (BW + 24), y = 8 + n.row * ROWH;
        pos[n.name] = [x + BW / 2, y, y + BH];
      });
    });
    flow.edges.forEach(([a, b]) => {
      if (pos[a] && pos[b]) body +=
        `<line x1="${pos[a][0]}" y1="${pos[a][2]}" x2="${pos[b][0]}"
         y2="${pos[b][1]}" stroke="#aaa"/>`;
    });
    Object.values(byRow).forEach(ns => {
      ns.forEach((n, i) => {
        const x = 20 + i * (BW + 24), y = 8 + n.row * ROWH;
        const col = n.kind === 'input' ? '#def' :
                    (n.kind === 'vertex' ? '#efe' : '#fff');
        body += `<rect x="${x}" y="${y}" width="${BW}" height="${BH}"
                 fill="${col}" stroke="#888" rx="4"/>
                 <text x="${x+6}" y="${y+14}">${n.name}</text>
                 <text x="${x+6}" y="${y+28}" fill="#999">${n.type}</text>`;
      });
    });
    fsvg.innerHTML = body;
  }
  const ts = await (await fetch('/api/tsne')).json();
  const tsvg = document.getElementById('tsne');
  tsvg.innerHTML = '';
  if (ts.points && ts.points.length) {
    const xs2 = ts.points.map(p => p[0]), ys2 = ts.points.map(p => p[1]);
    const xmin = Math.min(...xs2), xmax = Math.max(...xs2);
    const ymin = Math.min(...ys2), ymax = Math.max(...ys2);
    let dots = '';
    ts.points.forEach((p, i) => {
      const x = 10 + (p[0] - xmin) / Math.max(xmax - xmin, 1e-9) * 480;
      const y = 10 + (p[1] - ymin) / Math.max(ymax - ymin, 1e-9) * 480;
      const c = colors[(ts.labels ? ts.labels[i] : 0) % colors.length];
      dots += `<circle cx="${x}" cy="${y}" r="2.5" fill="${c}"/>`;
    });
    tsvg.innerHTML = dots;
  }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


class UIServer:
    """(PlayUIServer equivalent). ``UIServer.get_instance().attach(
    storage)`` then browse http://localhost:<port>/ ."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000,
                 max_body_bytes: int = 8 * 1024 * 1024):
        self.port = port
        self.storage = InMemoryStatsStorage()
        # bound on POST bodies (/api/remote, /api/tsne): oversized or
        # malformed payloads get a 400 JSON error, never a 500
        self.max_body_bytes = max_body_bytes
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._tsne = {"points": [], "labels": None}
        self._flow = {"nodes": [], "edges": []}
        self._health_monitor = None
        self._alerts = None
        self._slos = None

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
            cls._instance.start()
        return cls._instance

    def attach(self, storage) -> None:
        self.storage = storage

    def attach_health(self, monitor=None, alerts=None,
                      slos=None) -> None:
        """Feed the dashboard's health panel (``/api/health``):
        ``monitor`` is an ``observability.HealthMonitor`` (status +
        anomaly history), ``alerts`` an ``observability.AlertManager``
        (evaluated on each request, firing rules listed), ``slos`` an
        ``observability.SLOMonitor`` (burn rates + breach state), the
        port's own (``deeplearning4j_tpu_torch.observability``)."""
        if monitor is not None:
            self._health_monitor = monitor
        if alerts is not None:
            self._alerts = alerts
        if slos is not None:
            self._slos = slos

    def health_payload(self) -> dict:
        monitor = self._health_monitor
        alerts = self._alerts
        slos = getattr(self, "_slos", None)
        mstatus = monitor.status() if monitor is not None else None
        firing = []
        if alerts is not None:
            try:
                alerts.evaluate()
                firing = alerts.firing()
            except Exception:
                logger.exception("alert evaluation failed")
        slo_status = None
        if slos is not None:
            try:
                slos.evaluate()
                slo_status = slos.status()
            except Exception:
                logger.exception("SLO evaluation failed")
        breached = [s for s in (slo_status or [])
                    if s.get("breached")]
        if mstatus is not None and mstatus["status"] == "diverged":
            status = "diverged"
        elif firing or breached or (mstatus is not None
                                    and mstatus["status"] != "ok"):
            status = "degraded"
        else:
            status = "ok"
        out = {"status": status, "alerts": firing,
               "monitor": mstatus}
        if slo_status is not None:
            out["slos"] = slo_status
        return out

    def attach_model(self, model) -> None:
        """Feed the network-flow view (the Play UI's flow module /
        FlowIterationListener: an architecture diagram). Accepts either
        executor; rows = longest-path depth in the DAG."""
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph)
        nodes, edges = [], []
        if isinstance(model, ComputationGraph):
            conf = model.conf
            depth = {n: 0 for n in conf.network_inputs}
            for name in conf.network_inputs:
                nodes.append({"name": name, "type": "Input",
                              "kind": "input", "row": 0})
            from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer
            for name in conf.topological_order():
                obj, ins = conf.vertices[name]
                depth[name] = 1 + max((depth.get(i, 0) for i in ins),
                                      default=0)
                nodes.append({
                    "name": name, "type": type(obj).__name__,
                    "kind": ("layer" if isinstance(obj, Layer)
                             else "vertex"),
                    "row": depth[name]})
                edges.extend([i, name] for i in ins)
        else:
            nodes.append({"name": "input", "type": "Input",
                          "kind": "input", "row": 0})
            prev = "input"
            for i, layer in enumerate(model.layers):
                name = f"layer_{i}"
                nodes.append({"name": name,
                              "type": type(layer).__name__,
                              "kind": "layer", "row": i + 1})
                edges.append([prev, name])
                prev = name
        self._flow = {"nodes": nodes, "edges": edges}

    def upload_tsne(self, data, labels=None, *, already_2d=None):
        """Feed the t-SNE tab (the Play UI's tsne module, reusing
        clustering/tsne.py). ``data``: (N, D) features — reduced to 2-d
        with Barnes-Hut t-SNE unless D == 2 (override via
        ``already_2d``)."""
        import numpy as np
        data = np.asarray(data)
        if already_2d is None:
            already_2d = data.shape[1] == 2
        if not already_2d:
            from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne
            data = BarnesHutTsne(n_components=2).fit_transform(data)
        self._tsne = {
            "points": np.asarray(data).tolist(),
            "labels": (None if labels is None
                       else [int(l) for l in np.asarray(labels)])}

    def start(self) -> None:
        storage_ref = lambda: self.storage      # noqa: E731
        server_ref = lambda: self               # noqa: E731

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body, ctype="application/json"):
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                storage = storage_ref()
                if url.path in ("/", "/train", "/train/overview"):
                    self._send(200, _PAGE, "text/html")
                elif url.path == "/api/sessions":
                    self._send(200,
                               json.dumps(storage.list_session_ids()))
                elif url.path == "/api/updates":
                    q = parse_qs(url.query)
                    sid = q.get("session", [None])[0]
                    if sid is None:
                        ids = storage.list_session_ids()
                        sid = ids[-1] if ids else ""
                    ups = [dataclasses.asdict(u)
                           for u in storage.get_all_updates(sid)]
                    self._send(200, json.dumps(ups))
                elif url.path == "/api/activations":
                    # newest report (any session) carrying conv images
                    imgs = {}
                    for sid in reversed(storage.list_session_ids()):
                        for u in reversed(storage.get_all_updates(sid)):
                            if u.activation_images:
                                imgs = u.activation_images
                                break
                        if imgs:
                            break
                    self._send(200, json.dumps(imgs))
                elif url.path == "/api/tsne":
                    self._send(200, json.dumps(server_ref()._tsne))
                elif url.path == "/api/flow":
                    self._send(200, json.dumps(server_ref()._flow))
                elif url.path == "/api/health":
                    self._send(200,
                               json.dumps(server_ref().health_payload()))
                else:
                    self._send(404, json.dumps({"error": "not found"}))

            def _read_body(self) -> str:
                """Bounded body read; raises ValueError on a missing/
                bogus Content-Length or an oversized payload."""
                limit = server_ref().max_body_bytes
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except (TypeError, ValueError):
                    raise ValueError("invalid Content-Length header")
                if n < 0:
                    raise ValueError("invalid Content-Length header")
                if n > limit:
                    raise ValueError(
                        f"payload too large: {n} bytes "
                        f"(limit {limit})")
                return self.rfile.read(n).decode("utf-8", "strict")

            def do_POST(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/api/remote":
                        report = StatsReport.from_json(
                            self._read_body())
                        storage_ref().put_update(report)
                        self._send(200, json.dumps({"ok": True}))
                    elif url.path == "/api/tsne":
                        body = json.loads(self._read_body())
                        if not isinstance(body, dict):
                            raise ValueError(
                                "tsne body must be a JSON object")
                        server_ref()._tsne = {
                            "points": body.get("points", []),
                            "labels": body.get("labels")}
                        self._send(200, json.dumps({"ok": True}))
                    else:
                        self._send(404,
                                   json.dumps({"error": "not found"}))
                except (ValueError, TypeError, KeyError,
                        UnicodeDecodeError,
                        json.JSONDecodeError) as e:
                    # malformed / oversized payloads are CLIENT
                    # errors: a structured 400, never a stack trace
                    self._send(400, json.dumps(
                        {"error": f"bad request: {e}"}))
                except Exception as e:    # keep the listener alive
                    logger.exception("UI POST handler error")
                    self._send(500, json.dumps({"error": str(e)}))

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("UI server on http://localhost:%d/", self.port)

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            # release the bound port now, not at GC (GL009): a UI
            # restarted on the same port would hit EADDRINUSE
            httpd.server_close()
        if thread is not None:
            # join the listener thread (GL007): stop() returning
            # while serve_forever still winds down leaks a
            # generation per attach/detach cycle
            thread.join(timeout=5.0)
        UIServer._instance = None
