"""The port's retrieval slice (``retrieval/{index,embedder}.py``,
``clustering/kmeans.py``, ``nlp/tokenization.py``,
``serving/retrieval_backend.py``, the ``/v1/embed``, ``/v1/search`` and
``/v1/index/*`` routes and the ``index build`` / ``serve --index`` CLI)
against the JAX package's, on the CPU, over one seeded corpus.

Tolerances: float32 scores within atol 1e-5 / rtol 1e-4, except the
euclidean metric, whose expanded form ``2 q.m - |m|^2 - |q|^2`` cancels
terms of magnitude ~dim: there atol is 1e-4. Ids are held equal under
the tie rule: where two neighbouring scores lie within the tolerance,
the two packages may order them differently (``lax.top_k`` and
``torch.topk`` break ties differently), so there the ids are compared
as sets. k-means centroids are held within the f32 tolerance (the
port's per-cell sums are ``index_add_``, JAX's ``onehot.T @ points``:
the same sums in another order); the k-means++ picks are equal bit for
bit. Card-only cases carry the ``cuda`` marker and decide in a fixture.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.clustering.kmeans import KMeansClustering as JaxKM
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.retrieval import BruteForceIndex as JaxBrute
from deeplearning4j_tpu.retrieval import IVFIndex as JaxIVF
from deeplearning4j_tpu.retrieval import TextEmbedder as JaxEmbedder
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu.serving.retrieval_backend import (
    RetrievalService as JaxService)
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.clustering import KMeansClustering
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex, IVFIndex,
                                                TextEmbedder, pow2_bucket)
from deeplearning4j_tpu_torch.serving.http import ModelServer
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.retrieval_backend import (
    RetrievalService)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DIM, CLUSTERS, NLIST, K = 2048, 32, 16, 16, 10
METRICS = ("cosine", "dot", "euclidean")


def _clustered(n=N, dim=DIM, clusters=CLUSTERS, seed=0):
    """The JAX retrieval tests' corpus recipe: gaussian blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    vecs = (centers[assign]
            + 0.15 * rng.normal(size=(n, dim))).astype(np.float32)
    return np.arange(n, dtype=np.int64), vecs


def _queries(vecs, b=32, seed=1):
    rng = np.random.default_rng(seed)
    rows = rng.choice(vecs.shape[0], b, replace=False)
    return (vecs[rows] + 0.05 * rng.normal(size=(b, vecs.shape[1]))
            ).astype(np.float32)


def _tols(metric):
    return dict(atol=1e-4 if metric == "euclidean" else 1e-5, rtol=1e-4)


def _assert_topk_equal(ids_a, s_a, ids_b, s_b, atol, rtol):
    """Scores within tolerance; ids equal wherever a score is apart from
    both neighbours by more than the tolerance, else equal as sets over
    the tied run. -inf pads (id -1) must agree exactly."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    assert ids_a.shape == ids_b.shape
    np.testing.assert_array_equal(np.isfinite(s_a), np.isfinite(s_b))
    fin = np.isfinite(s_a)
    np.testing.assert_allclose(s_a[fin], s_b[fin], atol=atol, rtol=rtol)
    np.testing.assert_array_equal(ids_a[~fin], ids_b[~fin])
    tol = atol + rtol * np.abs(s_a)
    for r in range(ids_a.shape[0]):
        j = 0
        row = s_a[r]
        while j < row.size:
            e = j + 1
            while e < row.size and np.isfinite(row[e]) and \
                    abs(row[e - 1] - row[e]) <= tol[r, e - 1]:
                e += 1
            if e == row.size and e - j > 1:
                # a tie run reaching the k-th column: the packages may
                # cut it at different members
                break
            assert set(ids_a[r, j:e]) == set(ids_b[r, j:e]), (r, j, e)
            j = e


def _build(kind, metric, ids, vecs, nlist=NLIST):
    if kind == "ivf":
        j = JaxIVF(DIM, nlist=nlist, metric=metric).build(ids, vecs)
        t = IVFIndex(DIM, nlist=nlist, metric=metric,
                     device="cpu").build(ids, vecs)
    else:
        j = JaxBrute(DIM, metric=metric)
        j.add(ids, vecs)
        t = BruteForceIndex(DIM, metric=metric, device="cpu")
        t.add(ids, vecs)
    return j, t


def _post(base, path, body, timeout=30.0):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _get(base, path, timeout=10.0):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode())


# ---------------------------------------------------------------------------
# indexes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_search_matches_jax(kind, metric):
    ids, vecs = _clustered()
    j, t = _build(kind, metric, ids, vecs)
    q = _queries(vecs)
    for nprobe in ([None] if kind == "brute" else [1, 4, None]):
        ji, js = j.search(q, k=K + 1, nprobe=nprobe)
        ti, ts = t.search(q, k=K + 1, nprobe=nprobe)
        _assert_topk_equal(ji, js, ti, ts, **_tols(metric))
    assert j.stats() == t.stats()


def test_brute_force_matches_float64_oracle():
    ids, vecs = _clustered()
    _, t = _build("brute", "cosine", ids, vecs)
    q = _queries(vecs, b=8)
    got, scores = t.search(q, k=K)
    vn = vecs.astype(np.float64)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    qn = q.astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    exact = qn @ vn.T
    want = np.argsort(-exact, axis=1, kind="stable")[:, :K]
    np.testing.assert_allclose(
        scores, np.take_along_axis(exact, want, axis=1), atol=1e-5)
    np.testing.assert_array_equal(got, ids[want])


@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_tombstones_compaction_and_stats_match_jax(kind):
    ids, vecs = _clustered(n=512)
    j, t = _build(kind, "cosine", ids, vecs)
    rng = np.random.default_rng(3)
    q = _queries(vecs, b=8)
    steps = [("remove", rng.choice(512, 40, replace=False)),
             ("add", np.arange(600, 620)),
             ("add", np.arange(0, 10)),          # upserts replace
             ("remove", np.arange(100, 400)),    # tombstones > live
             ("remove", [99999]),                # unknown id
             ("compact", None),
             ("add", np.arange(1000, 1100))]    # capacity growth
    for verb, arg in steps:
        if verb == "remove":
            assert j.remove(arg) == t.remove(arg)
        elif verb == "compact":
            assert j.compact() == t.compact()
        else:
            new = rng.normal(size=(len(arg), DIM)).astype(np.float32)
            assert j.add(arg, new) == t.add(arg, new)
        assert j.stats() == t.stats()
        assert len(j) == len(t) and j.generation == t.generation
        ji, js = j.search(q, k=K + 1, nprobe=NLIST)
        ti, ts = t.search(q, k=K + 1, nprobe=NLIST)
        _assert_topk_equal(ji, js, ti, ts, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(j.get(1000), t.get(1000))
    assert t.get(150) is None and j.get(150) is None


@pytest.mark.parametrize("metric", METRICS)
def test_filtered_search_matches_jax(metric):
    ids, vecs = _clustered(n=512)
    j, t = _build("ivf", metric, ids, vecs)
    allow = list(range(0, 512, 7)) + [5000]
    q = _queries(vecs, b=4)
    ji, js = j.search(q, k=K, allow_ids=allow)
    ti, ts = t.search(q, k=K, allow_ids=allow)
    _assert_topk_equal(ji, js, ti, ts, **_tols(metric))
    ji, js = j.search(q, k=K, allow_ids=[99999])
    ti, ts = t.search(q, k=K, allow_ids=[99999])
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(js, ts)


@pytest.mark.parametrize("nprobe", [1, 2, NLIST])
def test_estimate_recall_matches_jax(nprobe):
    ids, vecs = _clustered(n=4096, clusters=32)
    j, t = _build("ivf", "cosine", ids, vecs)
    rj = j.estimate_recall(k=K, sample=32, nprobe=nprobe, seed=5)
    rt = t.estimate_recall(k=K, sample=32, nprobe=nprobe, seed=5)
    assert rj == rt
    if nprobe == NLIST:
        assert rt >= 0.99


def test_empty_and_small_corpus_results():
    for cls in (BruteForceIndex, JaxBrute):
        kw = {"device": "cpu"} if cls is BruteForceIndex else {}
        idx = cls(4, metric="dot", **kw)
        ids, scores = idx.search(np.ones((2, 4), np.float32), k=3)
        assert (ids == -1).all() and np.isneginf(scores).all()
        idx.add([7, 8], np.eye(4, dtype=np.float32)[:2])
        ids, scores = idx.search(np.ones((1, 4), np.float32), k=4)
        assert sorted(ids[0, :2].tolist()) == [7, 8]
        assert (ids[0, 2:] == -1).all()
    with pytest.raises(ValueError, match="untrained"):
        IVFIndex(4, device="cpu").add([1], np.ones((1, 4), np.float32))
    assert pow2_bucket(5) == 8 and pow2_bucket(3, lo=64) == 64


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_kmeans_matches_jax(distance):
    _, vecs = _clustered(n=1024, clusters=8)
    jk = JaxKM(8, max_iterations=30, seed=4, distance=distance)
    tk = KMeansClustering(8, max_iterations=30, seed=4,
                          distance=distance, device="cpu")
    ja = jk.apply_to(vecs)
    ta = tk.apply_to(vecs)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_allclose(jk.centroids, tk.centroids,
                               atol=1e-5, rtol=1e-4)
    assert tk.inertia == pytest.approx(jk.inertia, rel=1e-4)
    q = _queries(vecs, b=16)
    np.testing.assert_array_equal(jk.predict(q), tk.predict(q))


def test_kmeans_plus_plus_picks_equal_jax_bitwise():
    _, vecs = _clustered(n=777, clusters=12, seed=2)
    jk = JaxKM(12, seed=9)
    tk = KMeansClustering(12, seed=9, device="cpu")
    want = jk._init_centroids(vecs, np.random.default_rng(9))
    got = tk._init_centroids(vecs, torch.from_numpy(vecs),
                             np.random.default_rng(9))
    assert want.tobytes() == got.tobytes()


def test_kmeans_lloyd_blocks_equal_one_block(monkeypatch):
    """The row-blocked assignment is the unblocked one."""
    from deeplearning4j_tpu_torch.clustering import kmeans
    _, vecs = _clustered(n=300, clusters=5)
    whole = KMeansClustering(5, seed=1, device="cpu")
    a = whole.apply_to(vecs)
    monkeypatch.setattr(kmeans, "_BLOCK_ELEMS", 7 * 5)   # 7 rows a block
    blocked = KMeansClustering(5, seed=1, device="cpu")
    np.testing.assert_array_equal(a, blocked.apply_to(vecs))
    np.testing.assert_array_equal(whole.centroids, blocked.centroids)


# ---------------------------------------------------------------------------
# embedder + tokenizers
# ---------------------------------------------------------------------------

VOCAB_WORDS = ["alpha", "beta", "gamma", "delta", "north", "capital",
               "北京", "大学", "北京大学"]
TEXTS = ["alpha beta", "Alpha, BETA gamma!", "", "zzzz unknown",
         "north capital " * 40, "delta", "beta beta beta alpha"]


def _table(v=len(VOCAB_WORDS) + 3, d=12, seed=6):
    return np.random.default_rng(seed).normal(size=(v, d)).astype(
        np.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_embedder_matches_jax(normalize):
    vocab = {w: i for i, w in enumerate(VOCAB_WORDS)}
    table = _table()
    je = JaxEmbedder(vocab, table, normalize=normalize, max_tokens=32)
    te = TextEmbedder(vocab, table, normalize=normalize, max_tokens=32,
                      device="cpu")
    packed = je.encode(TEXTS)
    np.testing.assert_array_equal(packed, te.encode(TEXTS))
    np.testing.assert_allclose(je.embed(TEXTS), te.embed(TEXTS),
                               atol=1e-5, rtol=1e-4)
    # junk ids clamp into the table on both sides
    bad = packed.copy()
    bad[:, 0, :] = 1e6
    np.testing.assert_allclose(np.asarray(je.output(bad)),
                               te.output(bad).numpy(), atol=1e-5,
                               rtol=1e-4)
    assert je.info() == te.info()
    # from_word2vec on a trained model: the JAX model's tables carried
    # across, and the port's own fit of the same configuration
    from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxW2V
    from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                       vectors_from_jax)
    corpus = [" ".join(VOCAB_WORDS[i % len(VOCAB_WORDS)]
                       for i in range(s, s + 12)) for s in range(40)]
    jw = JaxW2V.builder().iterate(corpus).layer_size(16) \
        .min_word_frequency(1).epochs(2).seed(0).build()
    jw.fit()
    tw = Word2Vec.builder().iterate(corpus).layer_size(16) \
        .min_word_frequency(1).epochs(2).seed(0).device("cpu").build()
    tw.fit()
    words = [w.word for w in jw.vocab.words]
    carried = vectors_from_jax({"syn0": jw.syn0, "syn1": jw.syn1}, words,
                               [w.count for w in jw.vocab.words],
                               device="cpu")
    want = JaxEmbedder.from_word2vec(jw, normalize=normalize).embed(TEXTS)
    for model, atol in ((carried, 1e-5), (tw, 1e-4)):
        emb = TextEmbedder.from_word2vec(model, normalize=normalize)
        assert emb.device.type == "cpu"
        np.testing.assert_allclose(emb.embed(TEXTS), want, atol=atol,
                                   rtol=1e-4)


def test_embedder_mean_pool_oracle():
    """The masked mean pool against numpy's, on a wide table."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(5000, 64)).astype(np.float32)
    vocab = {f"t{i}": i for i in range(5000)}
    texts = [" ".join(f"t{i}" for i in rng.integers(0, 5000, n))
             for n in rng.integers(0, 40, 64)]
    te = TextEmbedder(vocab, table, normalize=False, device="cpu")
    packed = te.encode(texts)
    ids = packed[:, 0, :].astype(np.int64)
    mask = packed[:, 1, :].astype(np.float64)
    want = (table[ids] * mask[..., None]).sum(1) / np.maximum(
        mask.sum(1, keepdims=True), 1.0)
    np.testing.assert_allclose(te.embed(texts), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("factory", ["default", "ngram", "cjk", "common"])
def test_tokenizers_match_jax(factory):
    texts = ["The quick brown fox's tail.", "北京大学的学生 visited 北京",
             "  multiple   spaces\tand\nlines ", "running jumped cats",
             "", "Ünïcödé wörds, 123 numbers!"]

    def make(mod):
        if factory == "default":
            return mod.DefaultTokenizerFactory()
        if factory == "ngram":
            return mod.NGramTokenizerFactory(1, 3)
        if factory == "cjk":
            return mod.CJKTokenizerFactory(dictionary=["北京", "大学",
                                                       "北京大学"])
        f = mod.DefaultTokenizerFactory()
        f.set_token_pre_processor(mod.CommonPreprocessor())
        return f

    jf, tf = make(jtok), make(ttok)
    for text in texts:
        assert jf.create(text).get_tokens() == tf.create(text).get_tokens()
    assert jtok.STOP_WORDS == ttok.STOP_WORDS
    end = ttok.EndingPreProcessor()
    for w in ("running", "cats", "jumped", "quickly"):
        assert end.pre_process(w) == jtok.EndingPreProcessor().pre_process(w)


# ---------------------------------------------------------------------------
# HTTP: a port server and a JAX server over one corpus
# ---------------------------------------------------------------------------

def _services(n=256, dim=8, nlist=8, seed=10):
    ids, vecs = _clustered(n, dim, nlist, seed=seed)
    vocab = {f"w{i}": i for i in range(n)}
    jsvc = JaxService(JaxIVF(dim, nlist=nlist, seed=0).build(ids, vecs),
                      embedder=JaxEmbedder(vocab, vecs), max_batch_size=8,
                      wait_ms=1.0)
    tsvc = RetrievalService(
        IVFIndex(dim, nlist=nlist, seed=0, device="cpu").build(ids, vecs),
        embedder=TextEmbedder(vocab, vecs, device="cpu"),
        max_batch_size=8, wait_ms=1.0)
    return jsvc, tsvc, vecs


@pytest.fixture(scope="module")
def servers():
    jsvc, tsvc, vecs = _services()
    js = JaxServer(JaxRegistry(), port=0, retrieval=jsvc).start()
    ts = ModelServer(ModelRegistry(), port=0, retrieval=tsvc).start()
    yield (f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ts.port}",
           vecs, ts)
    ts.stop(drain=False, timeout=5.0)
    js.stop(drain=False, timeout=5.0)


def _assert_same_json(a, b, path=""):
    """Equal JSON, floats within the f32 tolerance; search results
    compared by the tie rule."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            if k == "results":
                for ra, rb in zip(a[k], b[k]):
                    assert len(ra) == len(rb)
                    _assert_topk_equal(
                        [[r["id"] for r in ra]], [[r["score"] for r in ra]],
                        [[r["id"] for r in rb]], [[r["score"] for r in rb]],
                        atol=1e-5, rtol=1e-4)
                assert len(a[k]) == len(b[k])
            else:
                _assert_same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-5, rel=1e-4), path
    else:
        assert a == b, path


HTTP_CASES = [
    ("/v1/embed", {"texts": ["w7", "w3 w4 zzz", ""]}),
    ("/v1/embed", {"text": "w12"}),
    ("/v1/search", {"query": "w12", "k": 5, "nprobe": 8}),
    ("/v1/search", {"queries": ["w1 w2", "w200"], "k": 3}),
    ("/v1/search", {"vector": "ROW0", "k": 4, "nprobe": 2}),
    ("/v1/search", {"vectors": "ROWS", "k": 6}),
    ("/v1/search", {"vector": "ROW0", "k": 4, "filter_ids": [3, 4, 5]}),
    ("/v1/search", {"vector": "ROW0", "k": 0}),
    ("/v1/search", {"vector": "ROW0", "query": "w1"}),
    ("/v1/search", {"k": 5}),
    ("/v1/index/stats", {}),
    ("/v1/index/upsert", {"vectors": [[1.0] * 8]}),
]


@pytest.mark.parametrize("case", range(len(HTTP_CASES)))
def test_http_routes_match_jax_server(servers, case):
    jbase, tbase, vecs, _ = servers
    path, body = HTTP_CASES[case]
    body = {k: (vecs[0].tolist() if v == "ROW0" else
                vecs[:3].tolist() if v == "ROWS" else v)
            for k, v in body.items()}
    sj, bj = _post(jbase, path, body)
    st, bt = _post(tbase, path, body)
    assert sj == st, (bj, bt)
    if sj == 200:
        _assert_same_json(bj, bt)
    else:
        assert "error" in bt


def test_http_index_admin_sequence_matches_jax(servers):
    jbase, tbase, vecs, ts = servers
    seq = [("/v1/index/upsert", {"ids": [9001], "vectors": [[9.0] * 8]}),
           ("/v1/search", {"vector": [9.0] * 8, "k": 1, "nprobe": 8}),
           ("/v1/index/upsert", {"ids": [7777], "texts": ["w3 w4"]}),
           ("/v1/index/delete", {"ids": [9001, 123456]}),
           ("/v1/index/stats", {}),
           ("/v1/index/compact", {}),
           ("/v1/index/delete", {"ids": [7777]}),
           ("/v1/index/compact", {}),
           ("/v1/index/stats", {})]
    for path, body in seq:
        sj, bj = _post(jbase, path, body)
        st, bt = _post(tbase, path, body)
        assert sj == st == 200, (path, bj, bt)
        _assert_same_json(bj, bt, path)
    _, hj = _get(jbase, "/healthz")
    _, ht = _get(tbase, "/healthz")
    assert hj["index"] == ht["index"]
    assert ht["index"]["vectors"] == 256
    # warmup drives the default search bucket; no capture on the CPU
    rep = ts.warmup(generate=False)
    assert rep["_search"]["buckets"] == ["search/k16"]
    _, m = _get(tbase, "/metrics")
    assert "search/k16" in json.dumps(m)


def test_search_without_index_is_404():
    server = ModelServer(ModelRegistry(), port=0).start()
    try:
        st, body = _post(f"http://127.0.0.1:{server.port}", "/v1/search",
                         {"vector": [0.0] * 4, "k": 1})
        assert st == 404 and "serve --index" in body["error"]
    finally:
        server.stop(drain=False, timeout=5.0)


def test_service_close_releases_metrics():
    from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
    _, tsvc, vecs = _services(n=64, nlist=4)
    metrics = ServingMetrics()
    tsvc.attach_metrics(metrics)
    ids, _ = tsvc.search(vecs[:2], k=3)
    assert ids[0, 0] == 0 and ids[1, 0] == 1
    names = metrics.registry.snapshot()
    assert "index_vectors_total" in json.dumps(names)
    assert tsvc.estimate_recall(k=3, sample=8) is not None
    assert tsvc.close(drain=True, timeout=5.0)
    assert "index_vectors_total" not in json.dumps(
        metrics.registry.snapshot())


# ---------------------------------------------------------------------------
# CLI: index build / serve --index
# ---------------------------------------------------------------------------

def test_index_build_npz_loads_in_jax_serve(tmp_path, capsys):
    out = tmp_path / "corpus.npz"
    cli.main(["index", "build", "--corpus",
              "random:n=512,dim=16,seed=3,clusters=8", "--index-kind",
              "ivf", "--nlist", "8", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "built ivf/cosine on cpu: 512 vector(s)" in text
    assert "recall@10 nprobe=8: 1.000" in text
    # the JAX package's serve --index path loads the port's file
    args = SimpleNamespace(index=str(out), index_kind="brute",
                           index_metric="cosine", nlist=8, nprobe=None,
                           max_batch_size=8, queue_limit=16, wait_ms=1.0)
    from deeplearning4j_tpu.serving.metrics import ServingMetrics
    svc = jcli._retrieval_factory(args)(ServingMetrics())
    try:
        assert len(svc.index) == 512 and svc.embedder is not None
        ids, vecs, _, _ = cli._load_corpus(str(out))
        got, _ = svc.search(vecs[:4], k=1)
        np.testing.assert_array_equal(got[:, 0], ids[:4])
    finally:
        svc.close(drain=False, timeout=5.0)
    jids, jvecs, jvocab, jtable = jcli._load_corpus(
        "random:n=512,dim=16,seed=3,clusters=8")
    ids, vecs, vocab, table = cli._load_corpus(
        "random:n=512,dim=16,seed=3,clusters=8")
    np.testing.assert_array_equal(jvecs, vecs)
    assert jvocab == vocab


def test_serve_index_subprocess_answers_search():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
         "--index", "random:n=256,dim=8,seed=0,clusters=4", "--port", "0",
         "--device", "cpu", "--aot-warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        lines = []
        deadline = time.monotonic() + 120
        base = None
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on "):
                base = line.split()[2].rstrip("/")
                break
        assert base is not None, "".join(lines)
        text = "".join(lines)
        assert "index: brute_force/cosine on cpu: 256 vector(s)" in text
        assert "aot warmup: search buckets ['search/k16']" in text
        st, body = _post(base, "/v1/search", {"query": "w5", "k": 2})
        assert st == 200 and body["results"][0][0]["id"] == 5
        _, mods = _get(base, "/debug/modules")
        assert not mods["jax"] and not mods["deeplearning4j_tpu"]
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "draining" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_serve_needs_model_or_index():
    with pytest.raises(SystemExit, match="--model and/or --index"):
        cli.main(["serve", "--device", "cpu"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["brute", "ivf"])
def test_index_on_card_matches_cpu(cuda_device, kind):
    ids, vecs = _clustered()
    q = _queries(vecs)
    for metric in METRICS:
        if kind == "ivf":
            c = IVFIndex(DIM, nlist=NLIST, metric=metric,
                         device="cpu").build(ids, vecs)
            g = IVFIndex(DIM, nlist=NLIST, metric=metric,
                         device=cuda_device).build(ids, vecs)
            np.testing.assert_allclose(c._centroids, g._centroids,
                                       atol=1e-4)
        else:
            c = BruteForceIndex(DIM, metric=metric, device="cpu")
            g = BruteForceIndex(DIM, metric=metric, device=cuda_device)
            c.add(ids, vecs)
            g.add(ids, vecs)
        ci, cs = c.search(q, k=K + 1, nprobe=4)
        gi, gs = g.search(q, k=K + 1, nprobe=4)
        _assert_topk_equal(ci, cs, gi, gs, **_tols(metric))
        assert g._snap.mat.is_cuda
