"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU. Without a card the
default raises instead of quietly running somewhere slower.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "PyTorch port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
