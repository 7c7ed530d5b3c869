"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU. Without a card the
default raises instead of quietly running somewhere slower.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_device_tensor"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "PyTorch port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def as_device_tensor(a, device: torch.device):
    """A batch array (numpy or tensor; None passes) as a tensor on
    ``device``; numpy floats other than float32 become float32, as JAX
    canonicalizes float64."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)
