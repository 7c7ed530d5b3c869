"""Dataset fetchers: MNIST / EMNIST / CIFAR-10 / Iris / TinyImageNet / LFW
(counterpart of ``deeplearning4j_tpu/data/fetchers.py``).

Mirrors deeplearning4j-core datasets/fetchers/* + iterator impls
(MnistDataSetIterator etc., datasets/iterator/impl/). The reference
downloads + caches archives (base/MnistFetcher.downloadAndUntar());
here, if a local cache is present (``~/.cache/deeplearning4j_tpu`` or
``DL4J_TPU_DATA_DIR``) the real files are used; otherwise a
**deterministic synthetic surrogate** with the same shapes/classes is
generated (this build environment has no network egress). Synthetic
data is class-structured (template + noise) so models actually learn —
tests assert real convergence, not just shape plumbing.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.chaos.retry import retrying_io
from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator


def _load_with_retry(read):
    """One dataset-file read through the ``data.load`` chaos site and
    the shared retry policy (an NFS blip mid-epoch-0 costs a backoff,
    not the run)."""
    return retrying_io("data.load", read)

__all__ = ["mnist_data", "MnistDataSetIterator", "iris_data",
           "IrisDataSetIterator", "cifar10_data", "Cifar10DataSetIterator",
           "EmnistDataSetIterator", "TinyImageNetDataSetIterator",
           "LFWDataSetIterator", "synthetic_classification",
           "synthetic_images", "synthetic_sequences"]


def _data_dir() -> str:
    return os.environ.get(
        "DL4J_TPU_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "deeplearning4j_tpu"))


# ---------------------------------------------------------------------------
# synthetic surrogates (deterministic, learnable)
# ---------------------------------------------------------------------------

def synthetic_classification(n: int, n_features: int, n_classes: int,
                             seed: int = 0, noise: float = 0.5,
                             template_seed: int = 7777):
    """Gaussian blobs: one center per class (centers fixed by
    template_seed so different seeds draw from one distribution)."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(
        template_seed + n_features).normal(0, 2.0, (n_classes, n_features))
    ys = rng.integers(0, n_classes, n)
    xs = centers[ys] + rng.normal(0, noise, (n, n_features))
    onehot = np.eye(n_classes, dtype=np.float32)[ys]
    return xs.astype(np.float32), onehot


def synthetic_images(n: int, h: int, w: int, c: int, n_classes: int,
                     seed: int = 0, noise: float = 0.25,
                     template_seed: int = 7777):
    """Per-class smooth templates + pixel noise → learnable by a CNN.

    Templates depend only on ``template_seed`` + geometry, so train and
    test splits (different ``seed``) share one underlying distribution.
    """
    rng = np.random.default_rng(seed)
    template_rng = np.random.default_rng(template_seed + h * 1000 + c)
    base = template_rng.normal(0, 1, (n_classes, h, w, c))
    # smooth the templates so convs with small kernels can pick them up
    for _ in range(2):
        base = (base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
                + np.roll(base, 1, 2) + np.roll(base, -1, 2)) / 5.0
    base = (base - base.min()) / (base.max() - base.min() + 1e-9)
    ys = rng.integers(0, n_classes, n)
    xs = base[ys] + rng.normal(0, noise, (n, h, w, c))
    xs = np.clip(xs, 0, 1).astype(np.float32)
    onehot = np.eye(n_classes, dtype=np.float32)[ys]
    return xs, onehot


def synthetic_sequences(n: int, t: int, n_features: int, n_classes: int,
                        seed: int = 0):
    """Class-dependent frequency sine sequences — learnable by an RNN."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, n_classes, n)
    time = np.arange(t)[None, :, None]
    freq = (ys[:, None, None] + 1) * (np.pi / t)
    phase = rng.uniform(0, np.pi, (n, 1, 1))
    chan = rng.normal(1, 0.1, (1, 1, n_features))
    xs = np.sin(freq * time + phase) * chan \
        + rng.normal(0, 0.1, (n, t, n_features))
    onehot = np.eye(n_classes, dtype=np.float32)[ys]
    return xs.astype(np.float32), onehot


# ---------------------------------------------------------------------------
# MNIST (real-file loader + surrogate)
# ---------------------------------------------------------------------------

def _load_idx_images(path: str) -> np.ndarray:
    def read():
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)
    return _load_with_retry(read)


def _load_idx_labels(path: str) -> np.ndarray:
    def read():
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), dtype=np.uint8)
    return _load_with_retry(read)


def mnist_data(train: bool = True, flatten: bool = True,
               n: Optional[int] = None, seed: int = 123
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features, one-hot labels); features in [0,1].

    Real MNIST if cached locally (idx files under <data_dir>/mnist/),
    synthetic surrogate otherwise.
    """
    d = os.path.join(_data_dir(), "mnist")
    prefix = "train" if train else "t10k"
    img_candidates = [os.path.join(d, f"{prefix}-images-idx3-ubyte"),
                      os.path.join(d, f"{prefix}-images-idx3-ubyte.gz")]
    lbl_candidates = [os.path.join(d, f"{prefix}-labels-idx1-ubyte"),
                      os.path.join(d, f"{prefix}-labels-idx1-ubyte.gz")]
    img_path = next((p for p in img_candidates if os.path.exists(p)), None)
    lbl_path = next((p for p in lbl_candidates if os.path.exists(p)), None)
    if img_path and lbl_path:
        xs = _load_idx_images(img_path).astype(np.float32) / 255.0
        ys = _load_idx_labels(lbl_path)
        onehot = np.eye(10, dtype=np.float32)[ys]
        xs = xs[..., None]                      # (N,28,28,1)
    else:
        count = n or (60000 if train else 10000)
        count = min(count, 8192)                # synthetic: keep it light
        xs, onehot = synthetic_images(count, 28, 28, 1, 10,
                                      seed=seed if train else seed + 1)
    if n is not None:
        xs, onehot = xs[:n], onehot[:n]
    if flatten:
        xs = xs.reshape(xs.shape[0], -1)
    return xs, onehot


class MnistDataSetIterator(ArrayDataSetIterator):
    """(datasets/iterator/impl/MnistDataSetIterator.java)."""

    def __init__(self, batch_size: int, train: bool = True,
                 flatten: bool = True, n: Optional[int] = None,
                 shuffle: bool = True, seed: int = 123):
        xs, ys = mnist_data(train=train, flatten=flatten, n=n, seed=seed)
        super().__init__(xs, ys, batch_size, shuffle=shuffle, seed=seed)


class EmnistDataSetIterator(ArrayDataSetIterator):
    """(datasets/iterator/impl/EmnistDataSetIterator.java). Synthetic
    surrogate uses the requested class count (e.g. 'letters' → 26)."""

    SETS = {"complete": 62, "merge": 47, "balanced": 47, "letters": 26,
            "digits": 10, "mnist": 10}

    def __init__(self, dataset: str, batch_size: int, train: bool = True,
                 seed: int = 123):
        n_classes = self.SETS.get(dataset, 10)
        xs, ys = synthetic_images(4096 if train else 1024, 28, 28, 1,
                                  n_classes, seed=seed)
        xs = xs.reshape(xs.shape[0], -1)
        super().__init__(xs, ys, batch_size, shuffle=train, seed=seed)


# ---------------------------------------------------------------------------
# Iris
# ---------------------------------------------------------------------------

def iris_data(seed: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """150×4, 3 classes (datasets/iterator/impl/IrisDataSetIterator). A
    compact statistically-faithful regeneration (per-class Gaussian fit
    of the classic data), deterministic."""
    means = np.array([[5.006, 3.428, 1.462, 0.246],
                      [5.936, 2.770, 4.260, 1.326],
                      [6.588, 2.974, 5.552, 2.026]])
    stds = np.array([[0.352, 0.379, 0.174, 0.105],
                     [0.516, 0.314, 0.470, 0.198],
                     [0.636, 0.322, 0.552, 0.275]])
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(3):
        xs.append(means[c] + rng.normal(0, 1, (50, 4)) * stds[c])
        ys.extend([c] * 50)
    xs = np.concatenate(xs).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[np.array(ys)]
    idx = rng.permutation(150)
    return xs[idx], onehot[idx]


class IrisDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 150, n: int = 150, seed: int = 6):
        xs, ys = iris_data(seed)
        super().__init__(xs[:n], ys[:n], batch_size)


# ---------------------------------------------------------------------------
# CIFAR-10
# ---------------------------------------------------------------------------

def cifar10_data(train: bool = True, n: Optional[int] = None,
                 seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    d = os.path.join(_data_dir(), "cifar-10-batches-bin")
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    paths = [os.path.join(d, f) for f in files]
    if all(os.path.exists(p) for p in paths):
        xs_list, ys_list = [], []
        for p in paths:
            raw = _load_with_retry(
                lambda p=p: np.fromfile(p, dtype=np.uint8)
            ).reshape(-1, 3073)
            ys_list.append(raw[:, 0])
            imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            xs_list.append(imgs)
        xs = np.concatenate(xs_list).astype(np.float32) / 255.0
        ys = np.concatenate(ys_list)
        onehot = np.eye(10, dtype=np.float32)[ys]
    else:
        count = min(n or (50000 if train else 10000), 8192)
        xs, onehot = synthetic_images(count, 32, 32, 3, 10,
                                      seed=seed if train else seed + 1)
    if n is not None:
        xs, onehot = xs[:n], onehot[:n]
    return xs, onehot


class Cifar10DataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int, train: bool = True,
                 n: Optional[int] = None, seed: int = 42):
        xs, ys = cifar10_data(train=train, n=n, seed=seed)
        super().__init__(xs, ys, batch_size, shuffle=train, seed=seed)


def _image_tree_or_synthetic(root, h, w, c, n_classes, n, seed,
                             max_synth):
    """Load a dir-per-label image tree if present (decoding at most
    ``n`` images — never the whole tree), else synthesize."""
    if os.path.isdir(root):
        from deeplearning4j_tpu_torch.data.records import ImageRecordReader
        rr = ImageRecordReader(h, w, c).initialize(root)
        if n is not None:
            rr._items = rr._items[:n]       # truncate BEFORE decoding
        xs, ys = [], []
        for arr, li in rr:
            xs.append(arr / 255.0)
            ys.append(li)
        xs = np.stack(xs).astype(np.float32)
        onehot = np.eye(len(rr.labels), dtype=np.float32)[ys]
    else:
        count = min(n or max_synth, max_synth)
        xs, onehot = synthetic_images(count, h, w, c, n_classes,
                                      seed=seed)
    if n is not None:
        xs, onehot = xs[:n], onehot[:n]
    return xs, onehot


class TinyImageNetDataSetIterator(ArrayDataSetIterator):
    """(datasets/iterator/impl/TinyImageNetDataSetIterator.java):
    64x64x3, 200 classes. Real files via ImageRecordReader on a local
    cache (<data_dir>/tiny-imagenet-200/train as a dir-per-label tree;
    the standard val/ split — val/images + val_annotations.txt — is NOT
    a label tree, so train=False with a real cache falls back to
    synthetic unless a relabeled val tree is provided at val_tree/);
    synthetic surrogate otherwise."""

    def __init__(self, batch_size: int, train: bool = True,
                 n: Optional[int] = None, seed: int = 99,
                 n_classes: int = 200):
        base = os.path.join(_data_dir(), "tiny-imagenet-200")
        root = os.path.join(base, "train" if train else "val_tree")
        xs, onehot = _image_tree_or_synthetic(
            root, 64, 64, 3, n_classes, n,
            seed if train else seed + 1, max_synth=4096)
        super().__init__(xs, onehot, batch_size, shuffle=train, seed=seed)


class LFWDataSetIterator(ArrayDataSetIterator):
    """(datasets/iterator/impl/LFWDataSetIterator.java): face images,
    dir-per-person tree under <data_dir>/lfw; synthetic surrogate
    otherwise."""

    def __init__(self, batch_size: int, shape=(64, 64, 3),
                 n: Optional[int] = None, n_labels: int = 40,
                 train: bool = True, seed: int = 17):
        h, w, c = shape
        xs, onehot = _image_tree_or_synthetic(
            os.path.join(_data_dir(), "lfw"), h, w, c, n_labels, n,
            seed if train else seed + 1, max_synth=2048)
        super().__init__(xs, onehot, batch_size, shuffle=train, seed=seed)
