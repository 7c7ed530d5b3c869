"""ctypes binding for the port's native host data loader (counterpart of
``deeplearning4j_tpu/data/native_loader.py``).

The source is ``deeplearning4j_tpu_torch/csrc/host/dataloader.cpp``: the
JAX package's ``native/src/dataloader.cpp`` with the same C ABI, its
libpng decode replaced by a decoder of its own over zlib (the card's
machine has zlib and no libpng headers). It is built with ``g++`` at
first use into ``build/native/`` at the root of the checkout, keyed by a
hash of the source and the flags, never when a module is imported. The
build is atomic: it holds a file lock, compiles to a temporary file and
renames it into place, so several processes may ask for it at once.
Exposed:

- :class:`NativeCSVDataSetIterator`: CSV parsed into ready batches by a
  worker pool (the native counterpart of ``records.CSVRecordReader`` +
  ``RecordReaderDataSetIterator``).
- :class:`NativeImageDataSetIterator`: a directory-per-label PNG tree
  decoded and resized (bilinear) by a worker pool, outside the GIL,
  ahead of the device; the batches equal the JAX loader's bit for bit
  on 8-bit RGB and gray trees.
- :func:`native_count_words`: parallel word counting for vocab builds.
- :func:`write_png` and :func:`ensure_png_tree`: a PNG writer from the
  standard library (``zlib`` and ``struct``: 8-bit gray or RGB, filter
  0) and the ``resnet_native_etl`` bench leg's noise tree written with
  it, so a machine without PIL writes the same tree.

There is no fallback. Without ``g++`` every entry point raises, naming
it; without zlib the library is built with ``-DDL4J_NO_PNG``, the CSV
loader and the word counter work, and the image iterator raises, naming
zlib and the compiler's message.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import logging
import os
import shutil
import struct
import subprocess
import threading
import zlib
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["native_available", "native_image_available",
           "NativeCSVDataSetIterator", "NativeImageDataSetIterator",
           "native_count_words", "write_png", "ensure_png_tree", "SOURCE",
           "BUILD_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host", "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
# the PNG decoder's one dependency; without it the build drops PNG
ZLIB = ["-lz"]

_lock = threading.Lock()
_libs: Dict[str, "_Built"] = {}


class _Built:
    """A loaded build and, where the PNG decoder was left out, why."""

    def __init__(self, lib: ctypes.CDLL, no_png_reason: Optional[str]):
        self.lib = lib
        self.no_png_reason = no_png_reason


def _target(defines) -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join([CXX, *CXX_FLAGS, *defines]).encode())
    return os.path.join(BUILD_DIR, f"dataloader-{digest.hexdigest()[:16]}.so")


def _compile(target: str, extra) -> Optional[str]:
    """Compile the source into ``target`` (via a temporary file and a
    rename); returns None, or the compiler's message on failure. Raises
    when the compiler itself is missing."""
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SOURCE, *extra],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"the native data loader needs a C++ compiler: {CXX!r} not "
            f"found ({e}); it is built from {SOURCE} at first use") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return (proc.stderr or proc.stdout).strip()[-2000:]
    os.replace(tmp, target)
    return None


def _build() -> _Built:
    """The loaded library, built first if needed (under a file lock, so
    concurrent processes build it once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    full, no_png = _target([]), _target(["-DDL4J_NO_PNG"])
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        reason = None
        if not os.path.exists(full):
            reason = _compile(full, ZLIB)
        path = full
        if reason is not None:
            failed = reason
            if not os.path.exists(no_png):
                failed = _compile(no_png, ["-DDL4J_NO_PNG"])
                if failed is not None:
                    raise RuntimeError(
                        f"the native data loader does not build from "
                        f"{SOURCE}:\n{failed}")
            reason = (f"the PNG decoder needs zlib ({' '.join(ZLIB)}), and "
                      f"the build with it failed:\n{reason}")
            logger.warning("native loader built without PNG: %s", reason)
            path = no_png
    return _Built(_declare(ctypes.CDLL(path)), reason)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dl4j_csv_loader_create.restype = ctypes.c_void_p
    lib.dl4j_csv_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dl4j_loader_num_lines.restype = ctypes.c_int64
    lib.dl4j_loader_num_lines.argtypes = [ctypes.c_void_p]
    lib.dl4j_loader_skipped_rows.restype = ctypes.c_int64
    lib.dl4j_loader_skipped_rows.argtypes = [ctypes.c_void_p]
    lib.dl4j_loader_next.restype = ctypes.c_int
    lib.dl4j_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.dl4j_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.dl4j_image_loader_create.restype = ctypes.c_void_p
    lib.dl4j_image_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dl4j_image_loader_available.restype = ctypes.c_int
    lib.dl4j_image_loader_available.argtypes = []
    lib.dl4j_image_loader_num_items.restype = ctypes.c_int64
    lib.dl4j_image_loader_num_items.argtypes = [ctypes.c_void_p]
    lib.dl4j_image_loader_num_classes.restype = ctypes.c_int
    lib.dl4j_image_loader_num_classes.argtypes = [ctypes.c_void_p]
    lib.dl4j_image_loader_class_name.restype = ctypes.c_char_p
    lib.dl4j_image_loader_class_name.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    lib.dl4j_image_loader_skipped.restype = ctypes.c_int64
    lib.dl4j_image_loader_skipped.argtypes = [ctypes.c_void_p]
    lib.dl4j_image_loader_next.restype = ctypes.c_int
    lib.dl4j_image_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.dl4j_image_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.dl4j_count_words.restype = ctypes.c_void_p
    lib.dl4j_count_words.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dl4j_counts_size.restype = ctypes.c_int64
    lib.dl4j_counts_size.argtypes = [ctypes.c_void_p]
    lib.dl4j_counts_word.restype = ctypes.c_char_p
    lib.dl4j_counts_word.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dl4j_counts_count.restype = ctypes.c_int64
    lib.dl4j_counts_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.dl4j_counts_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _get() -> _Built:
    """The build for the current source and flags, loaded once a
    process."""
    key = _target([])
    with _lock:
        built = _libs.get(key)
        if built is None:
            built = _libs[key] = _build()
    return built


def _image_lib() -> ctypes.CDLL:
    built = _get()
    if built.no_png_reason is not None:
        raise RuntimeError("NativeImageDataSetIterator is unavailable: "
                           + built.no_png_reason)
    return built.lib


def native_available() -> bool:
    """Whether the loader builds here (the CSV loader and the word
    counter need only a C++ compiler)."""
    try:
        _get()
    except RuntimeError:
        return False
    return True


def native_image_available() -> bool:
    """Whether the PNG loader builds here (a C++ compiler and zlib)."""
    try:
        _image_lib()
    except RuntimeError:
        return False
    return True


class NativeCSVDataSetIterator(DataSetIterator):
    """CSV → DataSet batches parsed by the C++ worker pool."""

    def __init__(self, path: str, batch_size: int, n_features: int,
                 label_index: int = -1, num_classes: int = 0,
                 n_threads: int = 2, queue_capacity: int = 4):
        self._lib = _get().lib
        self.path = path
        self._bs = batch_size
        self.n_features = n_features
        self.label_index = label_index
        self.num_classes = num_classes
        self.n_threads = n_threads
        self.queue_capacity = queue_capacity
        self._handle = None
        self._n_lines = None
        self.skipped_rows = 0

    def _open(self):
        h = self._lib.dl4j_csv_loader_create(
            self.path.encode(), self._bs, self.n_features,
            self.label_index, self.num_classes, self.n_threads,
            self.queue_capacity)
        if not h:
            raise IOError(f"cannot open {self.path}")
        self._handle = h
        self._n_lines = int(self._lib.dl4j_loader_num_lines(h))

    def reset(self):
        self._close()

    def _close(self):
        if self._handle:
            skipped = int(self._lib.dl4j_loader_skipped_rows(
                self._handle))
            if skipped and skipped != self.skipped_rows:
                logger.warning(
                    "native CSV loader skipped %d unparseable row(s) of "
                    "%s (bad numeric fields, wrong column count for "
                    "n_features=%d, or out-of-range labels)", skipped,
                    self.path, self.n_features)
            self.skipped_rows = skipped
            self._lib.dl4j_loader_destroy(self._handle)
            self._handle = None

    def _iterate(self):
        # a handle may already be open from num_examples(); destroy it
        # (it owns worker threads and queued batches) before a fresh pass
        self._close()
        self._open()
        lab_width = (0 if self.label_index < 0
                     else (self.num_classes or 1))
        try:
            while True:
                if self._handle is None:
                    return      # reset() mid-iteration: stop cleanly
                # fresh arrays per batch: handed off as they are
                feat = np.empty((self._bs, self.n_features), np.float32)
                lab = np.empty((self._bs, lab_width), np.float32) \
                    if lab_width else None
                n = self._lib.dl4j_loader_next(
                    self._handle,
                    feat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    lab.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
                    if lab is not None else None)
                if n <= 0:
                    return
                if n == self._bs:
                    yield DataSet(feat, lab)
                else:
                    yield DataSet(feat[:n].copy(),
                                  lab[:n].copy() if lab is not None
                                  else None)
        finally:
            self._close()

    def batch_size(self):
        return self._bs

    def num_examples(self):
        if self._n_lines is None:
            self._open()
            self._close()
        return self._n_lines

    def __del__(self):
        try:
            self._close()
        except Exception:
            pass


def native_count_words(path: str, n_threads: int = 4) -> Dict[str, int]:
    """Parallel token counting: lowercased tokens, ASCII punctuation
    dropped, as the JAX package's counter."""
    lib = _get().lib
    h = lib.dl4j_count_words(path.encode(), n_threads)
    if not h:
        raise IOError(f"cannot open {path}")
    try:
        n = lib.dl4j_counts_size(h)
        return {lib.dl4j_counts_word(h, i).decode():
                int(lib.dl4j_counts_count(h, i)) for i in range(n)}
    finally:
        lib.dl4j_counts_destroy(h)


class NativeImageDataSetIterator(DataSetIterator):
    """Directory-per-label PNG tree → (B,H,W,C) float DataSet batches of
    raw 0-255 pixels, decoded and resized (bilinear) by the C++ worker
    pool: one coordinator walks the batches in order and splits each
    batch's decodes over ``n_threads``, so the batch order (trailing
    partial batch included) does not depend on the thread count."""

    def __init__(self, root: str, batch_size: int, height: int,
                 width: int, channels: int = 3, n_threads: int = 4,
                 queue_capacity: int = 4):
        self._lib = _image_lib()
        self.root = root
        self._bs = batch_size
        self.height = height
        self.width = width
        self.channels = 1 if channels == 1 else 3
        self.n_threads = n_threads
        self.queue_capacity = queue_capacity
        self._handle = None
        self._n_items = None
        self._classes = None
        self.skipped = 0

    def _open(self):
        h = self._lib.dl4j_image_loader_create(
            self.root.encode(), self._bs, self.height, self.width,
            self.channels, self.n_threads, self.queue_capacity)
        if not h:
            raise IOError(f"no PNG image tree at {self.root}")
        self._handle = h
        self._n_items = int(self._lib.dl4j_image_loader_num_items(h))
        n = int(self._lib.dl4j_image_loader_num_classes(h))
        self._classes = [
            self._lib.dl4j_image_loader_class_name(h, i).decode()
            for i in range(n)]

    def labels(self):
        if self._classes is None:
            self._open()
        return list(self._classes)

    def reset(self):
        self._close()

    def _close(self):
        if self._handle:
            self.skipped = int(
                self._lib.dl4j_image_loader_skipped(self._handle))
            if self.skipped:
                logger.warning("native image loader skipped %d "
                               "undecodable file(s) under %s",
                               self.skipped, self.root)
            self._lib.dl4j_image_loader_destroy(self._handle)
            self._handle = None

    def _iterate(self):
        # destroy any handle opened by num_examples()/labels() first:
        # it owns a coordinator thread and queued decoded batches
        self._close()
        self._open()
        n_classes = len(self._classes)
        try:
            while True:
                if self._handle is None:
                    return      # reset() mid-iteration: stop cleanly
                # fresh arrays per batch: the native side copies once
                # (GIL released during the ctypes call) and the arrays
                # are handed off as they are
                feat = np.empty((self._bs, self.height, self.width,
                                 self.channels), np.float32)
                lab = np.empty((self._bs, n_classes), np.float32)
                n = self._lib.dl4j_image_loader_next(
                    self._handle,
                    feat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    lab.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if n <= 0:
                    return
                if n == self._bs:
                    yield DataSet(feat, lab)
                else:           # trailing partial batch
                    yield DataSet(feat[:n].copy(), lab[:n].copy())
        finally:
            self._close()

    def batch_size(self):
        return self._bs

    def num_examples(self):
        if self._n_items is None:
            self._open()
        return self._n_items

    def __iter__(self):
        return self._iterate()

    def __del__(self):
        try:
            self._close()
        except Exception:
            pass


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 3) uint8 array as an 8-bit gray or RGB
    PNG: filter 0 on every row, one zlib stream in one IDAT chunk."""
    a = np.ascontiguousarray(pixels, dtype=np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"want (H, W) or (H, W, 3) pixels, got {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if a.ndim == 3 else 0,
                         0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def ensure_png_tree(root: str, n_classes: int = 10, per_class: int = 52,
                    hw: int = 224) -> str:
    """The ``resnet_native_etl`` leg's directory-per-label tree of RGB
    noise images (``bench.py``'s ``_ensure_png_tree``: ``class{c}/im{i}
    .png`` from ``default_rng(0)`` in the same order, the same pixels;
    kept across runs under a stamp of its shape). Noise compresses
    worst, so its decode cost is an upper bound."""
    stamp = os.path.join(root, "stamp.json")
    want = {"n_classes": n_classes, "per_class": per_class, "hw": hw}
    if os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == want:
                return root
    if os.path.isdir(root):
        shutil.rmtree(root)     # stale or half written
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            write_png(os.path.join(d, f"im{i}.png"),
                      rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
    with open(stamp, "w") as f:
        json.dump(want, f)
    return root
