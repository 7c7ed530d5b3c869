"""Convolutional activation visualization (counterpart of
``deeplearning4j_tpu/ui/convolutional.py``).

Mirrors deeplearning4j-ui's ConvolutionalIterationListener
(ui/weights/ConvolutionalIterationListener.java:38: renders each conv
layer's activations as a tiled grayscale image for the web UI's
convolutional module). Here: every ``frequency`` iterations the
listener runs a forward pass on a fixed probe batch, tiles the first
example's channels into a grid, and stores base64 PNGs in a
StatsReport (``activation_images``) that the dashboard's activations
tab renders. PNG encoding is stdlib-only (zlib). The probe's
activations come from the port's ``feed_forward`` on the network's
device; only the 4-D maps of the first example reach the host."""

from __future__ import annotations

import base64
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.stats import StatsReport

__all__ = ["encode_png_gray", "tile_channels",
           "ConvolutionalIterationListener"]


def encode_png_gray(img: np.ndarray) -> bytes:
    """Minimal 8-bit grayscale PNG encoder (stdlib only)."""
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError("expect uint8 (H, W)")
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        raw = tag + data
        return (struct.pack(">I", len(data)) + raw
                + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # gray, 8-bit
    scanlines = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(scanlines))
            + chunk(b"IEND", b""))


def tile_channels(act: np.ndarray, max_channels: int = 16,
                  pad: int = 1) -> np.ndarray:
    """(H, W, C) activation → uint8 tile grid of the first
    ``max_channels`` channels, each min-max normalized."""
    h, w, c = act.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    out = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad),
                   np.uint8)
    for i in range(c):
        a = act[:, :, i]
        lo, hi = float(a.min()), float(a.max())
        norm = ((a - lo) / (hi - lo) * 255.0 if hi > lo
                else np.zeros_like(a))
        r, col = divmod(i, cols)
        out[pad + r * (h + pad):pad + r * (h + pad) + h,
            pad + col * (w + pad):pad + col * (w + pad) + w] = \
            norm.astype(np.uint8)
    return out


class ConvolutionalIterationListener(TrainingListener):
    """(ConvolutionalIterationListener.java:38). ``probe_input``: a
    fixed small batch whose conv activations get imaged."""

    def __init__(self, storage, probe_input, frequency: int = 10,
                 max_channels: int = 16,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker_0"):
        self.storage = storage
        self.probe = np.asarray(probe_input)[:1]     # one example
        self.freq = max(1, frequency)
        self.max_channels = max_channels
        self.session_id = session_id or f"conv_{int(time.time())}"
        self.worker_id = worker_id

    def _conv_activations(self, model) -> Dict[str, np.ndarray]:
        acts = model.feed_forward(self.probe)
        out: Dict[str, np.ndarray] = {}
        if isinstance(acts, dict):          # ComputationGraph
            items = acts.items()
        else:                               # MultiLayerNetwork list
            items = ((f"layer_{i}", a) for i, a in enumerate(acts))
        for name, a in items:
            if a.dim() == 4:                # (B, H, W, C)
                out[str(name)] = a[0].float().cpu().numpy()
        return out

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration % self.freq != 0:
            return
        images = {}
        for name, act in self._conv_activations(model).items():
            tiled = tile_channels(act, self.max_channels)
            images[name] = base64.b64encode(
                encode_png_gray(tiled)).decode()
        if not images:
            return
        self.storage.put_update(StatsReport(
            session_id=self.session_id, worker_id=self.worker_id,
            iteration=iteration, timestamp=time.time(),
            score=float(score), activation_images=images))
