"""The port's host trees and Barnes-Hut t-SNE (``deeplearning4j_tpu_torch/
clustering/{vptree,kdtree,quadtree,tsne}.py``) against the JAX
package's, on the CPU. They are numpy host code copied from the JAX
package: every answer is held EQUAL (neighbour ids and distances, the
trees' cell masses and centres, the forces, the t-SNE embedding bit for
bit), and each against a brute-force oracle where there is one.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.clustering import kdtree as jkd
from deeplearning4j_tpu.clustering import quadtree as jqt
from deeplearning4j_tpu.clustering import tsne as jtsne
from deeplearning4j_tpu.clustering import vptree as jvp
from deeplearning4j_tpu_torch import clustering as tclust
from deeplearning4j_tpu_torch.clustering import kdtree as tkd
from deeplearning4j_tpu_torch.clustering import quadtree as tqt
from deeplearning4j_tpu_torch.clustering import tsne as ttsne
from deeplearning4j_tpu_torch.clustering import vptree as tvp


def _blobs(rng, n_per=30, dim=10, sep=8.0):
    centers = rng.normal(0, sep, (3, dim))
    x = np.concatenate([c + rng.normal(0, 1, (n_per, dim))
                        for c in centers])
    return x, np.repeat(np.arange(3), n_per)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,dim,k", [(200, 8, 5), (64, 3, 1), (300, 16, 12)])
def test_vptree_matches_jax_and_brute_force(distance, n, dim, k):
    rng = np.random.default_rng(n + dim)
    x = rng.normal(0, 1, (n, dim))
    t, j = tvp.VPTree(x, distance=distance), jvp.VPTree(x, distance=distance)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    for _ in range(8):
        q = rng.normal(0, 1, dim)
        ids, dists = t.search(q, k)
        assert (ids, dists) == j.search(q, k)
        if distance == "cosine":
            want = 1.0 - xn @ (q / np.linalg.norm(q))
        else:
            want = np.linalg.norm(x - q, axis=1)
        assert set(ids) == set(np.argsort(want)[:k].tolist())
        assert dists == sorted(dists)


@pytest.mark.parametrize("n,dim,k", [(150, 4, 3), (40, 2, 7), (500, 6, 1)])
def test_kdtree_matches_jax_and_brute_force(n, dim, k):
    rng = np.random.default_rng(dim)
    x = rng.normal(0, 1, (n, dim))
    t, j = tkd.KDTree(x), jkd.KDTree(x)
    for _ in range(8):
        q = rng.normal(0, 1, dim)
        ids, dists = t.knn(q, k)
        assert (ids, dists) == j.knn(q, k)
        brute = np.argsort(np.linalg.norm(x - q, axis=1))[:k]
        assert set(ids) == set(brute.tolist())
        assert t.nearest(q) == j.nearest(q)
    far = np.full(dim, 100.0)
    t.insert(far)
    j.insert(far)
    assert t.nearest(far - 1) == j.nearest(far - 1)
    assert t.nearest(far - 1)[0] == n


def _cells(tree):
    """Every cell's (count, centre of mass) in visiting order."""
    out = [(tree.count, tuple(np.round(tree.cum_center, 12)))]
    for c in tree.children or []:
        out += _cells(c)
    return out


@pytest.mark.parametrize("dim,n", [(2, 64), (3, 64), (2, 200)])
def test_sptree_matches_jax(dim, n):
    rng = np.random.default_rng(dim * n)
    pts = rng.normal(0, 1, (n, dim))
    t, j = tqt.SpTree.build(pts), jqt.SpTree.build(pts)
    assert t.count == n
    np.testing.assert_allclose(t.cum_center, pts.mean(0), atol=1e-8)
    assert _cells(t) == _cells(j)
    for theta in (0.0, 0.5, 1.2):
        for i in range(0, n, 7):
            ta, ja = np.zeros(dim), np.zeros(dim)
            zt = t.compute_non_edge_forces(pts[i], theta, ta)
            zj = j.compute_non_edge_forces(pts[i], theta, ja)
            assert zt == zj
            np.testing.assert_array_equal(ta, ja)


def test_quadtree_duplicates_match_jax():
    pts = np.zeros((10, 2))
    t, j = tqt.QuadTree.build(pts), jqt.QuadTree.build(pts)
    assert t.count == j.count == 10
    assert _cells(t) == _cells(j)


@pytest.mark.parametrize("n_components,theta", [(2, 0.5), (3, 0.8)])
def test_tsne_matches_jax(n_components, theta):
    rng = np.random.default_rng(0)
    x, y = _blobs(rng, n_per=20)
    kw = dict(perplexity=8, n_iter=60, exaggeration_iters=30, seed=1,
              n_components=n_components, theta=theta)
    got = ttsne.BarnesHutTsne(**kw).fit(x)
    np.testing.assert_array_equal(got, jtsne.BarnesHutTsne(**kw).fit(x))
    assert got.shape == (60, n_components)


def test_exports_match_jax():
    from deeplearning4j_tpu import clustering as jclust
    assert sorted(tclust.__all__) == sorted(jclust.__all__)
    for name in ("VPTree", "KDTree", "QuadTree", "SpTree"):
        assert getattr(tclust, name).__module__.startswith(
            "deeplearning4j_tpu_torch.clustering")
