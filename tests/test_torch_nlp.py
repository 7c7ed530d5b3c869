"""The port's Word2Vec family (``deeplearning4j_tpu_torch/nlp/{vocab,
word2vec,paragraph_vectors,glove,deepwalk}.py``) against the JAX
package's, on the CPU, on seeded numpy inputs.

The port draws every random number with numpy in the JAX package's
order, so the same seed gives the same pairs, batches, negatives and
walks: those streams are held EQUAL. What remains is float summation
order. Tolerances:

- one step (skip-gram NS / HS, CBOW NS / HS, PV-DBOW / DM, a GloVe
  epoch, an inference step) against the JAX jitted step on the same
  tables and indices: ``STEP_ATOL`` = 1e-6 absolute on every table
  entry (entries ~0.1-2), the loss to ``rtol`` 1e-5; rows the batch
  does not name are held bit-equal to the input;
- a whole fit (tests/test_nlp.py's configurations, 2-150 steps):
  ``FIT_ATOL`` = 1e-4 absolute on every table (rounding compounds
  over the steps), and ``words_nearest`` equal;
- ``fit(mesh=)`` at dp=2 (two gloo ranks) against JAX's single-device
  fit: rtol 1e-3, atol 1e-4, JAX's own limits for its mesh fit.
"""

import ast
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from deeplearning4j_tpu.nlp import deepwalk as jdw
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import deepwalk as tdw
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ATOL = 1e-6
FIT_ATOL = 1e-4


def _corpus(n_sent=300, seed=0):
    """tests/test_nlp.py's corpus recipe: two topic clusters (fruit and
    tech words) with glue words."""
    rng = np.random.default_rng(seed)
    fruit = ["apple", "banana", "cherry", "mango", "grape"]
    tech = ["cpu", "gpu", "ram", "disk", "cache"]
    glue = ["the", "a", "is", "was", "and"]
    sents = []
    for i in range(n_sent):
        topic = fruit if i % 2 == 0 else tech
        words = []
        for _ in range(8):
            words.append(topic[rng.integers(0, len(topic))])
            if rng.random() < 0.3:
                words.append(glue[rng.integers(0, len(glue))])
        sents.append(" ".join(words))
    return sents


def _docs(n_sent=300):
    tf = jtok.DefaultTokenizerFactory()
    return [tf.create(s).get_tokens() for s in _corpus(n_sent)]


def _zipf_sequences(V=60, n=40, length=15, seed=0):
    """Sequences over ``V`` words with a Zipf-like head, plus a few
    out-of-vocabulary tokens (``oov*``, seen once each)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    seqs = []
    for s in range(n):
        seq = [f"w{i}" for i in rng.choice(V, length, p=p)]
        seq.insert(int(rng.integers(0, length)), f"oov{s}")
        seqs.append(seq)
    return seqs


def _assert_tables(t, j, atol, names=("syn0", "syn1")):
    for name in names:
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   atol=atol, rtol=0, err_msg=name)


# ----------------------------------------------------------- no jax here

PORT_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), os.path.join(REPO,
                                                     "deeplearning4j_tpu_torch"))
    for sub in ("nlp", "clustering")
    for d, _, files in os.walk(os.path.join(REPO, "deeplearning4j_tpu_torch",
                                            sub))
    for f in files if f.endswith(".py"))


@pytest.mark.parametrize("rel", PORT_MODULES)
def test_module_imports_neither_jax_nor_the_jax_package(rel):
    path = os.path.join(REPO, "deeplearning4j_tpu_torch", rel)
    names = []
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax",
                           "deeplearning4j_tpu"), (rel, name)


def test_importing_the_slice_loads_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.nlp as n\n"
            "import deeplearning4j_tpu_torch.clustering as c\n"
            "from deeplearning4j_tpu_torch.nlp import (annotation, deepwalk,"
            " lattice, serializer)\n"
            "from deeplearning4j_tpu_torch.clustering import tsne\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'deeplearning4j_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))


# ------------------------------------------------------ vocab + Huffman

VOCAB_CASES = {
    "topics_min3": (lambda: _docs(), 3, ()),
    "topics_stop": (lambda: _docs(), 1, ("the", "a", "is")),
    "zipf_min1": (lambda: _zipf_sequences(), 1, ()),
    "zipf_min2": (lambda: _zipf_sequences(seed=3), 2, ("w0",)),
    "ties": (lambda: [["a"] * 8 + ["b"] * 4 + ["c"] * 2 + ["d"]
                      + ["e"] * 2 + ["f"]], 1, ()),
}


@pytest.mark.parametrize("case", sorted(VOCAB_CASES))
def test_vocab_and_huffman_match_jax(case):
    make, min_freq, stop = VOCAB_CASES[case]
    seqs = make()
    jc = jvocab.VocabConstructor(min_freq, stop).build_joint_vocabulary(seqs)
    tc = tvocab.VocabConstructor(min_freq, stop).build_joint_vocabulary(seqs)
    assert [(w.word, w.count, w.index) for w in tc.words] == \
        [(w.word, w.count, w.index) for w in jc.words]
    assert tc.total_count == jc.total_count
    np.testing.assert_array_equal(tc.frequencies(), jc.frequencies())
    jh, th = jvocab.Huffman(jc), tvocab.Huffman(tc)
    assert [(w.codes, w.points) for w in tc.words] == \
        [(w.codes, w.points) for w in jc.words]
    for a, b in zip(th.padded_arrays(), jh.padded_arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- streams

def _pair_models(**kw):
    kw.setdefault("min_word_frequency", 1)
    j = jw2v.SequenceVectors(**kw)
    t = tw2v.SequenceVectors(device="cpu", **kw)
    return j, t


STREAM_CASES = [(2, 0.0, 0), (4, 0.0, 1), (5, 1e-3, 2), (3, 1e-2, 3),
                (1, 0.05, 4)]


@pytest.mark.parametrize("window,subsampling,seed", STREAM_CASES)
def test_pair_stream_matches_jax(window, subsampling, seed):
    """The same (center, context) pairs in the same order, and each
    generator left at the same state: the port draws the same numbers."""
    seqs = _zipf_sequences(seed=seed) + [[], ["oov_only"]] + _docs(40)
    j, t = _pair_models(window=window, subsampling=subsampling, seed=seed,
                        stop_words=("the",))
    j.build_vocab(seqs)
    t.build_vocab(seqs)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    want = np.array(list(j._training_pairs(seqs, jr)), np.int64)
    got = t._training_pairs(seqs, tr)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tr.random() == jr.random()
    assert tr.integers(0, 7) == jr.integers(0, 7)


@pytest.mark.parametrize("window,subsampling,seed", STREAM_CASES)
def test_cbow_stream_matches_jax(window, subsampling, seed):
    seqs = _zipf_sequences(seed=seed) + [[], ["w1"]] + _docs(40)
    j, t = _pair_models(window=window, subsampling=subsampling, seed=seed)
    j.build_vocab(seqs)
    t.build_vocab(seqs)
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    want = j._cbow_batches(seqs, jr)
    got = t._cbow_batches(seqs, tr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == np.float32
    assert tr.random() == jr.random()


@pytest.mark.parametrize("n,B", [(1000, 64), (50, 64), (64, 64), (130, 7)])
def test_epoch_draws_match_the_jax_loop(n, B):
    """An epoch's permutation and negatives drawn at once equal the JAX
    loop's permutation and one ``choice`` a step."""
    _, t = _pair_models(negative=3, batch_size=B)
    t.build_vocab(_zipf_sequences())
    jr, tr = np.random.default_rng(n), np.random.default_rng(n)
    order = jr.permutation(n)
    if n < B:
        order = np.resize(order, B)
    want_sel, want_negs = [], []
    for s in range(0, len(order) - B + 1, B):
        want_sel.append(order[s:s + B])
        want_negs.append(jr.choice(len(t.vocab), size=(B, 3),
                                   p=t._unigram_table))
    got_order, got_negs = t._epoch(n, B, tr)
    np.testing.assert_array_equal(got_order.numpy(), np.stack(want_sel))
    np.testing.assert_array_equal(got_negs.numpy(), np.stack(want_negs))
    assert tr.random() == jr.random()


def _cliques(G, n=8, joins=((0, 8),)):
    g = G(2 * n)
    for base in (0, n):
        for i in range(n):
            for k in range(i + 1, n):
                g.add_edge(base + i, base + k)
    for a, b in joins:
        g.add_edge(a, b)
    return g


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec", "directed"])
def test_walk_stream_matches_jax(kind):
    if kind == "node2vec":
        kw = dict(p=0.5, q=2.0, walk_length=12, walks_per_vertex=3, seed=11)
        j, t = jdw.Node2Vec(**kw), tdw.Node2Vec(device="cpu", **kw)
    else:
        kw = dict(walk_length=12, walks_per_vertex=3, seed=6)
        j, t = jdw.DeepWalk(**kw), tdw.DeepWalk(device="cpu", **kw)
    if kind == "directed":      # dead ends stop a walk early
        jg, tg = jdw.Graph(6, undirected=False), tdw.Graph(6, undirected=False)
        for a, b in ((0, 1), (1, 2), (2, 0), (3, 4)):
            jg.add_edge(a, b)
            tg.add_edge(a, b)
    else:
        jg, tg = _cliques(jdw.Graph), _cliques(tdw.Graph)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    assert t._walks(tg, tr) == j._walks(jg, jr)
    assert tr.random() == jr.random()


# --------------------------------------------------------------- steps

def _step_setup(seed, V=40, D=16, B=64, K=5, scale=1.0):
    """A vocab of V words (Zipf counts), random tables, a batch with
    repeated rows (so several occurrences sum into one row) and some
    rows the batch never names."""
    rng = np.random.default_rng(seed)
    counts = (1000 / np.arange(1, V + 1)).astype(int) + 1
    seqs = [[f"w{i}"] * int(c) for i, c in enumerate(counts)]
    jv = jvocab.VocabConstructor(1).build_joint_vocabulary(seqs)
    syn0 = (rng.normal(size=(V, D)) * scale).astype(np.float32)
    syn1 = (rng.normal(size=(V, D)) * 0.5 * scale).astype(np.float32)
    hi = V - 6                                   # rows hi.. stay untouched
    centers = rng.integers(0, hi, B)
    centers[:8] = 3                               # one frequent row
    contexts = rng.integers(0, hi, B)
    negatives = rng.integers(0, hi, (B, K))
    return dict(jv=jv, syn0=syn0, syn1=syn1, centers=centers,
                contexts=contexts, negatives=negatives, lr=0.025,
                hi=hi, rng=rng)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
    return torch.tensor(a, dtype=dtype)


def _check_step(got, want, before, hi):
    for g, w, b in zip(got, want, before):
        g = g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=STEP_ATOL, rtol=0)
        # the rows no index names are bit-unchanged
        np.testing.assert_array_equal(g[hi:], b[hi:])


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 8.0), (2, 0.05)])
def test_ns_step_matches_jax(seed, scale):
    s = _step_setup(seed, scale=scale)
    j = jw2v.SequenceVectors(negative=5)
    js0, js1, jloss = j._make_ns_step()(
        jnp.asarray(s["syn0"]), jnp.asarray(s["syn1"]),
        jnp.asarray(s["centers"], jnp.int32),
        jnp.asarray(s["contexts"], jnp.int32),
        jnp.asarray(s["negatives"], jnp.int32), jnp.float32(s["lr"]))
    t0, t1 = _t(s["syn0"]), _t(s["syn1"])
    loss = tw2v.ns_step(t0, t1, _t(s["centers"]), _t(s["contexts"]),
                        _t(s["negatives"]), s["lr"])
    _check_step((t0, t1), (js0, js1), (s["syn0"], s["syn1"]), s["hi"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def _hs(jv):
    return tuple(_t(a) for a in jvocab.Huffman(jv).padded_arrays())


@pytest.mark.parametrize("seed,scale", [(3, 1.0), (4, 8.0)])
def test_hs_step_matches_jax(seed, scale):
    s = _step_setup(seed, scale=scale)
    j = jw2v.SequenceVectors(hs=True)
    j._hs_arrays = jvocab.Huffman(s["jv"]).padded_arrays()
    js0, js1, jloss = j._make_hs_step()(
        jnp.asarray(s["syn0"]), jnp.asarray(s["syn1"]),
        jnp.asarray(s["centers"], jnp.int32),
        jnp.asarray(s["contexts"], jnp.int32), jnp.float32(s["lr"]))
    t0, t1 = _t(s["syn0"]), _t(s["syn1"])
    loss = tw2v.hs_step(t0, t1, _hs(s["jv"]), _t(s["centers"]),
                        _t(s["contexts"]), s["lr"])
    # syn1's inner nodes are 0..V-2 and the paths reach most of them:
    # only syn0's untouched rows are held bit-equal here
    _check_step((t0,), (js0,), (s["syn0"],), s["hi"])
    np.testing.assert_allclose(t1.numpy(), np.asarray(js1),
                               atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("hs", [False, True])
@pytest.mark.parametrize("seed", [5, 6])
def test_cbow_step_matches_jax(hs, seed):
    s = _step_setup(seed, scale=2.0)
    rng, B, W = s["rng"], 64, 3
    ctx = rng.integers(0, s["hi"], (B, 2 * W))
    n_valid = rng.integers(0, 2 * W + 1, B)
    mask = (np.arange(2 * W)[None, :] < n_valid[:, None]).astype(np.float32)
    ctx = np.where(mask > 0, ctx, 0)
    j = jw2v.SequenceVectors(hs=hs, window=W)
    j._hs_arrays = jvocab.Huffman(s["jv"]).padded_arrays()
    js0, js1, jloss = j._make_cbow_step()(
        jnp.asarray(s["syn0"]), jnp.asarray(s["syn1"]),
        jnp.asarray(ctx, jnp.int32), jnp.asarray(mask),
        jnp.asarray(s["centers"], jnp.int32),
        jnp.asarray(s["negatives"], jnp.int32), jnp.float32(s["lr"]))
    t0, t1 = _t(s["syn0"]), _t(s["syn1"])
    loss = tw2v.cbow_step(t0, t1, _t(ctx), _t(mask), _t(s["centers"]),
                          _t(s["negatives"]), s["lr"],
                          _hs(s["jv"]) if hs else None)
    _check_step((t0,), (js0,), (s["syn0"],), s["hi"])
    np.testing.assert_allclose(t1.numpy(), np.asarray(js1),
                               atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("dm", [False, True])
def test_doc_step_matches_jax(dm):
    s = _step_setup(7, scale=2.0)
    rng, B, W, n_docs = s["rng"], 64, 4, 20
    docs = rng.normal(size=(n_docs + 3, 16)).astype(np.float32)
    doc_idx = rng.integers(0, n_docs, B)
    ctx = rng.integers(0, s["hi"], (B, W)) if dm else None
    j = jpv.ParagraphVectors(dm=dm, window=W)
    jd, js0, js1, jloss = j._make_doc_step()(
        jnp.asarray(docs), jnp.asarray(s["syn0"]), jnp.asarray(s["syn1"]),
        jnp.asarray(doc_idx, jnp.int32),
        jnp.asarray(s["centers"], jnp.int32),
        None if ctx is None else jnp.asarray(ctx, jnp.int32),
        jnp.asarray(s["negatives"], jnp.int32), jnp.float32(s["lr"]))
    td, t0, t1 = _t(docs), _t(s["syn0"]), _t(s["syn1"])
    loss = tpv.doc_step(td, t0, t1, _t(doc_idx), _t(s["centers"]),
                        None if ctx is None else _t(ctx),
                        _t(s["negatives"]), s["lr"])
    _check_step((td, t0, t1), (jd, js0, js1),
                (docs, s["syn0"], s["syn1"]), s["hi"])
    np.testing.assert_array_equal(td.numpy()[n_docs:], docs[n_docs:])
    if not dm:
        np.testing.assert_array_equal(t0.numpy(), s["syn0"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def _dense_ns_reference(syn0, syn1, centers, contexts, negatives, lr):
    """The JAX step's form in torch: autograd of the summed loss over
    the WHOLE tables, every row clipped and moved."""
    s0 = syn0.clone().requires_grad_()
    s1 = syn1.clone().requires_grad_()
    c, pos, neg = s0[centers], s1[contexts], s1[negatives]
    loss = (torch.nn.functional.softplus(-(c * pos).sum(-1)).sum()
            + torch.nn.functional.softplus(
                torch.einsum("bd,bkd->bk", c, neg)).sum())
    g0, g1 = torch.autograd.grad(loss, (s0, s1))
    return (syn0 - lr * tw2v.clip_rows(g0), syn1 - lr * tw2v.clip_rows(g1))


@pytest.mark.parametrize("seed", [8, 9])
def test_touched_rows_update_equals_dense(seed):
    """The touched-rows update against autograd over the whole tables,
    every row clipped and moved (the JAX step's form)."""
    s = _step_setup(seed, scale=4.0)
    args = (_t(s["centers"]), _t(s["contexts"]), _t(s["negatives"]))
    want0, want1 = _dense_ns_reference(_t(s["syn0"]), _t(s["syn1"]), *args,
                                       s["lr"])
    t0, t1 = _t(s["syn0"]), _t(s["syn1"])
    tw2v.ns_step(t0, t1, *args, s["lr"])
    # the same sums in another order: within two float32 ulps
    for got, want in ((t0, want0), (t1, want1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7,
                                   rtol=2.4e-7)
    np.testing.assert_array_equal(t0.numpy()[s["hi"]:], s["syn0"][s["hi"]:])


def test_glove_epoch_step_matches_jax():
    """One full-batch epoch from the same init, then a second (the
    AdaGrad accumulators carried)."""
    docs = _docs()
    for epochs in (1, 2):
        kw = dict(layer_size=24, min_word_frequency=3, epochs=epochs,
                  seed=5, window=4)
        j = jglove.Glove(**kw).fit(docs)
        t = tglove.Glove(device="cpu", **kw).fit(docs)
        _assert_tables(t, j, STEP_ATOL, ("syn0", "syn1", "bias_w",
                                         "bias_c"))


@pytest.mark.parametrize("dm", [False, True])
def test_infer_step_matches_jax(dm):
    """infer_vector over the JAX model's own tables (carried across):
    one step, then the whole 50-step decay."""
    kw = dict(layer_size=24, min_word_frequency=3, epochs=2, seed=4,
              learning_rate=0.025, subsampling=0.0, dm=dm)
    j = jpv.ParagraphVectors(**kw).fit_documents(_docs(100))
    t = _carry(j, dm=dm, seed=4, negative=5)
    toks = ["apple", "banana", "zzz_unknown", "cherry", "apple"]
    for steps in (1, 50):
        np.testing.assert_allclose(t.infer_vector(toks, steps=steps),
                                   j.infer_vector(toks, steps=steps),
                                   atol=STEP_ATOL, rtol=0)
    assert not t.infer_vector(["zzz_unknown"]).any()


# ---------------------------------------------------------------- fits

W2V_FITS = {
    # tests/test_nlp.py's configurations
    "ns": dict(hs=False, algo="skipgram", seed=1),
    "hs": dict(hs=True, algo="skipgram", seed=2),
    "cbow": dict(hs=False, algo="cbow", seed=9),
    "cbow_hs": dict(hs=True, algo="cbow", seed=9),
    "ns_subsampled": dict(hs=False, algo="skipgram", seed=3,
                          sampling=1e-2),
}


def _w2v(W, cfg, **extra):
    b = (W.builder().layer_size(32).window_size(4).negative_sample(5)
         .min_word_frequency(3).epochs(5).seed(cfg["seed"])
         .learning_rate(0.025).sampling(cfg.get("sampling", 0.0))
         .elements_learning_algorithm(cfg["algo"])
         .iterate(jtok.ListSentenceIterator(_corpus())))
    if cfg["hs"]:
        b = b.use_hierarchic_softmax()
    for k, v in extra.items():
        getattr(b, k)(v)
    return b.build()


@pytest.mark.parametrize("name", sorted(W2V_FITS))
def test_word2vec_fit_matches_jax(name):
    cfg = W2V_FITS[name]
    j = _w2v(jw2v.Word2Vec, cfg)
    j.fit()
    t = _w2v(tw2v.Word2Vec, cfg, device="cpu")
    t.fit()
    assert t.syn0.dtype == t.syn1.dtype == np.float32
    assert isinstance(t.syn0, np.ndarray)
    _assert_tables(t, j, FIT_ATOL)
    words = [w.word for w in j.vocab.words]
    assert t.words_nearest_batch(words, n=3) == \
        j.words_nearest_batch(words, n=3)
    assert t.similarity("apple", "banana") > t.similarity("apple", "cpu")
    np.testing.assert_allclose(t.similarity("apple", "cpu"),
                               j.similarity("apple", "cpu"), atol=1e-3)


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_matches_jax(dm):
    kw = dict(layer_size=24, min_word_frequency=3, epochs=20, seed=3,
              learning_rate=0.05, subsampling=0.0, dm=dm)
    docs = _docs(200)
    labels = [f"d{i}" for i in range(len(docs))]
    j = jpv.ParagraphVectors(**kw).fit_documents(docs, labels)
    t = tpv.ParagraphVectors(device="cpu", **kw).fit_documents(docs, labels)
    _assert_tables(t, j, FIT_ATOL, ("syn0", "syn1", "doc_vectors"))
    np.testing.assert_array_equal(t.get_doc_vector("d7"),
                                  t.doc_vectors[7])
    assert t.get_doc_vector("nope") is None
    toks = ["apple", "banana", "cherry"]
    np.testing.assert_allclose(t.infer_vector(toks), j.infer_vector(toks),
                               atol=FIT_ATOL, rtol=0)
    np.testing.assert_allclose(t.similarity_to_label(toks, "d0"),
                               j.similarity_to_label(toks, "d0"),
                               atol=1e-3)
    assert np.isnan(t.similarity_to_label(toks, "nope"))


def test_paragraph_vectors_tiny_batch_matches_jax():
    """Fewer pairs than the batch: B shrinks to the pair count."""
    docs = [["a", "b", "c"], ["c", "d"]]
    kw = dict(layer_size=8, min_word_frequency=1, epochs=3, seed=0,
              batch_size=512, dm=True, window=2)
    j = jpv.ParagraphVectors(**kw).fit_documents(docs)
    t = tpv.ParagraphVectors(device="cpu", **kw).fit_documents(docs)
    _assert_tables(t, j, STEP_ATOL, ("syn0", "syn1", "doc_vectors"))
    assert t.doc_labels == ["doc_0", "doc_1"]


def test_glove_fit_matches_jax():
    kw = dict(layer_size=24, min_word_frequency=3, epochs=150, seed=5,
              window=4)
    docs = _docs()
    j = jglove.Glove(**kw).fit(docs)
    t = tglove.Glove(device="cpu", **kw).fit(docs)
    _assert_tables(t, j, FIT_ATOL, ("syn0", "syn1", "bias_w", "bias_c"))
    assert t.similarity("apple", "banana") > t.similarity("apple", "cpu")
    assert t.words_nearest("apple", 3) == j.words_nearest("apple", 3)


def test_glove_asymmetric_matches_jax():
    kw = dict(layer_size=8, min_word_frequency=1, epochs=4, seed=2,
              window=3, symmetric=False, x_max=2.0, alpha=0.5)
    docs = _docs(60)
    j = jglove.Glove(**kw).fit(docs)
    t = tglove.Glove(device="cpu", **kw).fit(docs)
    _assert_tables(t, j, STEP_ATOL, ("syn0", "syn1", "bias_w", "bias_c"))
    with pytest.raises(ValueError, match="co-occurrences"):
        tglove.Glove(device="cpu", min_word_frequency=1).fit([["x"], ["y"]])


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec", "deepwalk_hs"])
def test_graph_embedding_fit_matches_jax(kind):
    kw = dict(vector_size=16, walk_length=20, walks_per_vertex=8,
              window_size=4, epochs=2)
    if kind == "node2vec":
        kw.update(p=0.5, q=2.0, seed=11)
        j, t = jdw.Node2Vec(**kw), tdw.Node2Vec(device="cpu", **kw)
    else:
        kw.update(seed=6, hs=kind == "deepwalk_hs")
        j, t = jdw.DeepWalk(**kw), tdw.DeepWalk(device="cpu", **kw)
    j.fit(_cliques(jdw.Graph))
    t.fit(_cliques(tdw.Graph))
    _assert_tables(t._sv, j._sv, FIT_ATOL)
    assert t.similarity(1, 2) > t.similarity(1, 9)
    for v in (1, 9):
        assert t.verts_nearest(v, 3) == j.verts_nearest(v, 3)
    np.testing.assert_array_equal(t.get_vertex_vector(3), t._sv.syn0[
        t._sv.vocab.index_of("3")])


def test_cjk_factory_word2vec_matches_jax():
    from deeplearning4j_tpu_torch.nlp.tokenization import (
        CJKTokenizerFactory as TCJK)
    corpus = ["我喜欢机器学习", "我喜欢深度学习", "机器学习和深度学习"] * 20
    dic = ["机器学习", "深度学习", "喜欢"]

    def build(W, tf, **kw):
        b = (W.builder().iterate(corpus).tokenizer_factory(tf)
             .layer_size(16).min_word_frequency(1).epochs(2).seed(0))
        for k, v in kw.items():
            getattr(b, k)(v)
        return b.build()
    j = build(jw2v.Word2Vec, jtok.CJKTokenizerFactory(dictionary=dic))
    j.fit()
    t = build(tw2v.Word2Vec, TCJK(dictionary=dic), device="cpu")
    t.fit()
    assert [w.word for w in t.vocab.words] == [w.word for w in j.vocab.words]
    assert t.get_word_vector("机器学习") is not None
    _assert_tables(t, j, FIT_ATOL)


NEAREST_CORPUS = ["the quick brown fox jumps over the lazy dog",
                  "the quick red fox runs past the lazy cat"] * 30


def test_words_nearest_batch_matches_jax():
    def build(W, **kw):
        b = (W.builder().iterate(NEAREST_CORPUS).layer_size(16)
             .min_word_frequency(1).epochs(3).seed(0))
        for k, v in kw.items():
            getattr(b, k)(v)
        return b.build()
    j = build(jw2v.Word2Vec)
    j.fit()
    t = build(tw2v.Word2Vec, device="cpu")
    t.fit()
    _assert_tables(t, j, FIT_ATOL)
    queries = ["fox", "lazy", "zzz_missing", "the", "cat", "fox"]
    single = [t.words_nearest(w, n=3) for w in queries]
    assert t.words_nearest_batch(queries, n=3) == single
    assert t.words_nearest_batch(queries, n=3, chunk=2) == single
    assert single == j.words_nearest_batch(queries, n=3)
    assert single[2] == []
    # k = min(n, V - 1): every other word, self excluded
    V = len(t.vocab)
    for w in ("fox", "dog"):
        got = t.words_nearest(w, n=100)
        assert len(got) == V - 1 and w not in got
        assert set(got) == set(j.words_nearest(w, n=100))


def _carry(j, **kw):
    """The port's model over the JAX model's tables (vectors_from_jax)."""
    state = {"syn0": j.syn0, "syn1": j.syn1,
             "doc_vectors": getattr(j, "doc_vectors", None),
             "bias_w": getattr(j, "bias_w", None),
             "bias_c": getattr(j, "bias_c", None)}
    return tw2v.vectors_from_jax(
        state, [w.word for w in j.vocab.words],
        [w.count for w in j.vocab.words],
        labels=getattr(j, "doc_labels", None), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["word2vec", "hs", "paragraph", "glove"])
def test_vectors_from_jax(kind):
    docs = _docs(120)
    if kind == "paragraph":
        j = jpv.ParagraphVectors(layer_size=16, min_word_frequency=3,
                                 epochs=2, seed=1).fit_documents(docs)
    elif kind == "glove":
        j = jglove.Glove(layer_size=16, min_word_frequency=3, epochs=3,
                         seed=1).fit(docs)
    else:
        j = jw2v.SequenceVectors(layer_size=16, min_word_frequency=3,
                                 hs=kind == "hs", seed=1).fit(docs)
    t = _carry(j, hs=kind == "hs")
    assert type(t).__name__ == {"paragraph": "ParagraphVectors",
                                "glove": "Glove"}.get(kind, "Word2Vec")
    assert [(w.word, w.count, w.index) for w in t.vocab.words] == \
        [(w.word, w.count, w.index) for w in j.vocab.words]
    np.testing.assert_array_equal(t._unigram_table, j._unigram_table)
    for a, b in zip(t._hs_arrays,
                    jvocab.Huffman(j.vocab).padded_arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.syn0, j.syn0)
    words = [w.word for w in j.vocab.words] + ["zzz"]
    assert t.words_nearest_batch(words, n=4) == \
        j.words_nearest_batch(words, n=4)
    if kind == "paragraph":
        np.testing.assert_array_equal(t.get_doc_vector("doc_3"),
                                      j.get_doc_vector("doc_3"))
    if kind == "glove":
        np.testing.assert_array_equal(t.bias_c, j.bias_c)


BUILDER_CALLS = [("layer_size", 7), ("window_size", 3), ("negative_sample", 2),
                 ("use_hierarchic_softmax", True), ("min_word_frequency", 4),
                 ("learning_rate", 0.5), ("epochs", 3), ("seed", 9),
                 ("sampling", 0.01), ("batch_size", 17),
                 ("stop_words", ("x",)),
                 ("elements_learning_algorithm", "CBOW")]


@pytest.mark.parametrize("call,value", BUILDER_CALLS)
def test_builder_matches_jax(call, value):
    j = getattr(jw2v.Word2Vec.builder(), call)(value).build()
    t = getattr(tw2v.Word2Vec.builder().device("cpu"), call)(value).build()
    for attr in ("layer_size", "window", "negative", "hs", "learning_rate",
                 "min_learning_rate", "min_word_frequency", "subsampling",
                 "epochs", "batch_size", "seed", "stop_words", "algorithm"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.device == torch.device("cpu")


def test_errors_match_jax():
    with pytest.raises(ValueError, match="algorithm"):
        tw2v.Word2Vec(algorithm="glove-ish", device="cpu")
    with pytest.raises(ValueError, match="iterator"):
        tw2v.Word2Vec(device="cpu").fit()
    with pytest.raises(ValueError, match="Empty vocabulary"):
        tw2v.Word2Vec(device="cpu").fit([["a", "b"]])
    with pytest.raises(ValueError, match="CBOW"):
        tw2v.Word2Vec(device="cpu", algorithm="cbow",
                      min_word_frequency=1).fit([["a"]])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    for make in (tw2v.Word2Vec, tpv.ParagraphVectors, tglove.Glove,
                 tdw.DeepWalk, lambda: tw2v.Word2Vec.builder().build()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_tiny_corpus_wraps_to_one_batch():
    """Fewer pairs than the batch: the order wraps to one full batch
    (the same permutation and negatives as JAX)."""
    seqs = [["a", "b", "c"]]
    kw = dict(layer_size=8, min_word_frequency=1, batch_size=64, epochs=2,
              seed=4)
    j = jw2v.SequenceVectors(**kw).fit(seqs)
    t = tw2v.SequenceVectors(device="cpu", **kw).fit(seqs)
    _assert_tables(t, j, STEP_ATOL)


# ------------------------------------------------------- data parallel

DP_CORPUS = ["the quick brown fox jumps over the lazy dog",
             "a quick red fox runs past a lazy cat",
             "dogs and cats and foxes run fast"] * 20


@pytest.mark.mesh
@pytest.mark.parametrize("hs", [False, True])
def test_mesh_fit_matches_jax_single_device(tmp_path, hs):
    """JAX's TestDataParallelEmbeddings at dp=2 (and its hierarchical
    softmax variant): two gloo ranks each compute half of every batch;
    the result is the single-device fit."""
    cfg = dict(corpus=DP_CORPUS, layer_size=16, epochs=2, batch_size=64,
               seed=0, query="fox", hs=hs)
    (tmp_path / "word2vec.json").write_text(json.dumps(cfg))
    worker.launch(2, tmp_path, ["word2vec"], timeout=120)
    ranks = worker.load(tmp_path, "word2vec", 2)
    single = (jw2v.Word2Vec.builder().iterate(DP_CORPUS).layer_size(16)
              .min_word_frequency(1).epochs(2).batch_size(64).seed(0)
              .use_hierarchic_softmax(hs).build())
    single.fit()
    for r in ranks:
        np.testing.assert_allclose(r["syn0"], single.syn0, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(r["syn1"], single.syn1, rtol=1e-3,
                                   atol=1e-4)
        assert json.loads(str(r["nearest"])) == \
            single.words_nearest("fox", n=3)
    # every rank applies the same reduced update
    np.testing.assert_array_equal(ranks[0]["syn0"], ranks[1]["syn0"])


def test_mesh_fit_indivisible_batch_raises():
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(np.arange(4).reshape(4, 1, 1, 1))
    w = (tw2v.Word2Vec.builder().iterate(["a b c d e"] * 5).layer_size(8)
         .min_word_frequency(1).batch_size(30).seed(0).device("cpu")
         .build())
    with pytest.raises(ValueError, match="not divisible"):
        w.fit(mesh=mesh)


def test_mesh_of_one_rank_is_the_single_fit():
    """A one-rank mesh with no process group: the data group is None
    and the fit equals the plain one bit for bit."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    def build():
        return (tw2v.Word2Vec.builder().iterate(DP_CORPUS).layer_size(8)
                .min_word_frequency(1).epochs(1).batch_size(32).seed(1)
                .device("cpu").build())
    a, b = build(), build()
    a.fit()
    b.fit(mesh=build_mesh(MeshSpec(data=1)))
    np.testing.assert_array_equal(a.syn0, b.syn0)
    np.testing.assert_array_equal(a.syn1, b.syn1)
