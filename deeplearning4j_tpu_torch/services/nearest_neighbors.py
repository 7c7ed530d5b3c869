"""Nearest-neighbors REST service + client (legacy compat shim;
counterpart of ``deeplearning4j_tpu/services/nearest_neighbors.py``).

Mirrors deeplearning4j-nearestneighbor-server
(NearestNeighborsServer.java — Play REST over a serialized VPTree, CLI
via JCommander) and the Java client. Wire model: JSON (the reference
wraps base64 NDArrays; plain float lists here).

.. deprecated::
    This server is the LEGACY surface. The k-NN data path now rides
    the retrieval subsystem's :class:`~..retrieval.index.BruteForceIndex`
    (device matmul top-k instead of the host VPTree walk), and new
    callers should use ``serve --index`` + ``/v1/search`` — batching,
    deadlines, IVF, fleet failover. This module only keeps the old
    ``/knn`` / ``/knnindex`` / ``/status`` wire contract alive on top
    of the same index; the answers agree with the old VPTree ones
    (regression-tested in tests/test_retrieval.py).

Endpoints:
  POST /knn          {"vector": [...], "k": 5} → {"indices", "distances"}
  POST /knnindex     {"index": 12, "k": 5}
  GET  /status       {"points": N, "dims": D}
CLI: python -m deeplearning4j_tpu_torch.services.nearest_neighbors
     --points data.npy --port 9200 [--device cpu]
     (or the ``serve-knn`` verb of ``python -m deeplearning4j_tpu_torch``)

The index lives on ``device`` (default ``"cuda"``): the top-k is the
port's ``BruteForceIndex`` matmul + ``topk`` on the card, and the k
candidates' distances are recomputed in float64 on the host from the
server's float64 copy of the points, as the JAX shim does.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.retrieval.index import BruteForceIndex
from deeplearning4j_tpu_torch.serving.http import (_JsonRequestHandler,
                                                   _make_listener)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["NearestNeighborsServer", "NearestNeighborsClient"]

# legacy clients send one vector per request; anything bigger than
# this is not a k-NN query and must not be buffered
_MAX_BODY = 1 << 20


class NearestNeighborsServer:
    """The legacy wire contract over the new device index.

    Scores come back in the index's higher-is-better convention and
    convert to the distances the old clients expect: euclidean
    ``sqrt(-score)``, cosine ``1 - score`` (exactly the old VPTree
    report, which returned 1-cos).
    """

    def __init__(self, points: np.ndarray, port: int = 0,
                 distance: str = "euclidean", device="cuda"):
        self.points = np.asarray(points, np.float64)
        if self.points.ndim != 2:
            raise ValueError("points must be (N, D); got "
                             f"{self.points.shape}")
        if distance not in ("euclidean", "cosine"):
            raise ValueError(f"unsupported distance: {distance!r}")
        self.distance = distance
        self.index = BruteForceIndex(int(self.points.shape[1]),
                                     metric=distance, device=device)
        self.index.add(np.arange(self.points.shape[0]),
                       self.points.astype(np.float32))
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def _exact_distances(self, vec: np.ndarray,
                         rows: np.ndarray) -> np.ndarray:
        """float64 distances for the candidate rows: the device
        top-k picks the neighbors, but its float32 score loses the
        low bits near zero — the legacy contract promises a true 0.0
        self-distance, so the reported numbers recompute exactly."""
        pts = self.points[rows]
        if self.distance == "euclidean":
            return np.linalg.norm(pts - vec[None, :], axis=1)
        qn = vec / max(np.linalg.norm(vec), 1e-12)
        norms = np.linalg.norm(pts, axis=1)
        pn = pts / np.maximum(norms, 1e-12)[:, None]
        return 1.0 - pn @ qn

    def _knn(self, vec: np.ndarray, k: int):
        k = max(1, min(int(k), len(self.index)))
        vec = np.asarray(vec, np.float64)
        ids, _ = self.index.search(
            vec.astype(np.float32)[None, :], k=k)
        rows = ids[0][ids[0] >= 0]
        dists = self._exact_distances(vec, rows)
        order = np.argsort(dists, kind="stable")
        return rows[order].tolist(), dists[order].tolist()

    def start(self) -> "NearestNeighborsServer":
        server = self

        class Handler(_JsonRequestHandler):
            def do_GET(self):
                if self.path == "/status":
                    self._send(200,
                               {"points": int(server.points.shape[0]),
                                "dims": int(server.points.shape[1])})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = self._content_length()
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                    return
                if n > _MAX_BODY:
                    self._send(413, {"error": "request body over "
                                              f"{_MAX_BODY} bytes"})
                    return
                try:
                    body = json.loads(
                        self.rfile.read(n).decode() or "{}")
                except (json.JSONDecodeError, UnicodeDecodeError):
                    self._send(400, {"error": "invalid JSON"})
                    return
                try:
                    k = int(body.get("k", 5))
                except (TypeError, ValueError):
                    self._send(400, {"error": "k must be an integer"})
                    return
                if self.path == "/knn":
                    vec = np.asarray(body.get("vector"), np.float64)
                    if vec.shape != (server.points.shape[1],):
                        self._send(400, {"error":
                                         f"vector must have dim "
                                         f"{server.points.shape[1]}"})
                        return
                elif self.path == "/knnindex":
                    try:
                        idx = int(body["index"])
                    except (KeyError, TypeError, ValueError):
                        self._send(400,
                                   {"error": "index must be an int"})
                        return
                    if not 0 <= idx < server.points.shape[0]:
                        self._send(400,
                                   {"error": "index out of range"})
                        return
                    vec = server.points[idx]
                else:
                    self._send(404, {"error": "not found"})
                    return
                ids, dists = server._knn(vec, k)
                self._send(200, {"indices": ids,
                                 "distances": dists})

        self._httpd = _make_listener("127.0.0.1", self.port, Handler)
        self.port = self._httpd.server_address[1]
        # stored, not anonymous (GL007): stop() joins it
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("NearestNeighborsServer on port %d (legacy shim "
                    "over BruteForceIndex; prefer serve --index + "
                    "/v1/search)", self.port)
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            # release the bound port now, not at GC (GL009)
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


class NearestNeighborsClient:
    def __init__(self, host: str = "localhost", port: int = 9200):
        self.base = f"http://{host}:{port}"

    def _post(self, path: str, payload: dict) -> dict:
        import urllib.request
        req = urllib.request.Request(
            self.base + path, json.dumps(payload).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read().decode())

    def knn(self, vector, k: int = 5) -> dict:
        return self._post("/knn", {"vector": list(map(float, vector)),
                                   "k": k})

    def knn_index(self, index: int, k: int = 5) -> dict:
        return self._post("/knnindex", {"index": index, "k": k})


def main(argv=None):
    p = argparse.ArgumentParser(description="k-NN REST server")
    p.add_argument("--points", required=True,
                   help=".npy file of shape (N, D)")
    p.add_argument("--port", type=int, default=9200)
    p.add_argument("--distance", default="euclidean",
                   choices=["euclidean", "cosine"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the index (default cuda; cpu "
                        "runs without a card)")
    args = p.parse_args(argv)
    from deeplearning4j_tpu_torch.cli import _cmd_serve_knn
    _cmd_serve_knn(args)


if __name__ == "__main__":
    main()
