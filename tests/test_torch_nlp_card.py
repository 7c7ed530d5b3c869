"""The Word2Vec family's steps on the card against the same plain torch
functions on the CPU (``deeplearning4j_tpu_torch/nlp/{word2vec,glove}.py``).
This file imports nothing of JAX: the card's machine runs it alone
(``-m cuda``), and on the CPU its one test skips.

Tolerance: every table within 1e-5 of its largest entry (the card sums
the occurrences' gradients with atomics, in another order than the CPU).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def _docs(n_sent=300, seed=0):
    """tests/test_nlp.py's two-topic corpus, tokenized."""
    rng = np.random.default_rng(seed)
    fruit = ["apple", "banana", "cherry", "mango", "grape"]
    tech = ["cpu", "gpu", "ram", "disk", "cache"]
    glue = ["the", "a", "is", "was", "and"]
    tf = ttok.DefaultTokenizerFactory()
    docs = []
    for i in range(n_sent):
        topic = fruit if i % 2 == 0 else tech
        words = []
        for _ in range(8):
            words.append(topic[rng.integers(0, len(topic))])
            if rng.random() < 0.3:
                words.append(glue[rng.integers(0, len(glue))])
        docs.append(tf.create(" ".join(words)).get_tokens())
    return docs


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(a).max()


@pytest.mark.cuda
def test_card_steps_match_cpu(card):
    """Skip-gram NS and HS steps (V=5000, D=128, B=4096, K=5) and a
    20-epoch GloVe fit on the card against the CPU."""
    rng = np.random.default_rng(11)
    V, D, B, K = 5000, 128, 4096, 5
    counts = (1000 / np.arange(1, V + 1)).astype(int) + 1
    vocab = tvocab.VocabConstructor(1).build_joint_vocabulary(
        [[f"w{i}"] * int(c) for i, c in enumerate(counts)])
    hs = [torch.from_numpy(np.asarray(a)) for a in
          tvocab.Huffman(vocab).padded_arrays()]
    hs[0] = hs[0].long()
    syn0 = rng.normal(size=(V, D)).astype(np.float32)
    syn1 = (rng.normal(size=(V, D)) * 0.5).astype(np.float32)
    idx = [torch.from_numpy(a) for a in (rng.integers(0, V, B),
                                         rng.integers(0, V, B),
                                         rng.integers(0, V, (B, K)))]
    out = {}
    for dev in ("cpu", card):
        t0 = torch.tensor(syn0, device=dev)
        t1 = torch.tensor(syn1, device=dev)
        tw2v.ns_step(t0, t1, *[a.to(dev) for a in idx], 0.025)
        tw2v.hs_step(t0, t1, tuple(a.to(dev) for a in hs), idx[0].to(dev),
                     idx[1].to(dev), 0.025)
        out[dev] = (t0.cpu().numpy(), t1.cpu().numpy())
    for a, b, before in zip(out["cpu"], out[card], (syn0, syn1)):
        assert (a != before).any()
        assert _rel(a, b) <= TOL
    docs = _docs()
    kw = dict(layer_size=24, min_word_frequency=3, epochs=20, seed=5)
    want = tglove.Glove(device="cpu", **kw).fit(docs)
    got = tglove.Glove(device=card, **kw).fit(docs)
    for name in ("syn0", "syn1", "bias_w", "bias_c"):
        assert _rel(getattr(want, name), getattr(got, name)) <= TOL, name
