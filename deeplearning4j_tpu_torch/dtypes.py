"""Dtype policy (counterpart of ``deeplearning4j_tpu/dtypes.py``).

The JAX package splits parameters, compute and activations across
dtypes; only its convolution and dense layers cast to
``compute_dtype``. The ported layers (the transformer LM's path) run in
float32 end to end, so the port keeps the float32 default and adds no
autocast.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Policy", "policy", "promote_half"]


def promote_half(x: torch.Tensor) -> torch.Tensor:
    """float32 if ``x`` is half precision (bf16/f16), otherwise
    unchanged: loss and softmax heads promote before exp/log."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32


_DEFAULT = Policy()


def policy() -> Policy:
    """The active policy: the float32 default (no other is ported)."""
    return _DEFAULT
