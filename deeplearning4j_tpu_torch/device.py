"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port
runs on the card unless the caller asks for the CPU. Without a card the
default raises instead of quietly running somewhere slower.

Float32 stays float32 on the card, as the JAX package computes it:
every layer that multiplies or convolves (dense, output, attention and
the transformer block's MLP, conv family, recurrent) calls
``keep_float32`` on its input before its cuBLAS or cuDNN call, so a
caller's ``allow_tf32 = True`` does not reach them. That is
process-wide (see there).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_device_tensor", "keep_float32"]


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


def keep_float32(x: torch.Tensor) -> None:
    """Before a cuBLAS or cuDNN call on ``x``: on a card, TF32 off for
    both, so float32 products run in float32. The two flags are
    process-wide and cannot be scoped to the call, because PyTorch reads
    them again when autograd runs the backward after the layer has
    returned: once a layer has run on a card, every other float32
    matmul and convolution in the process is float32 too, whoever calls
    it. Nothing here turns TF32 back on."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
