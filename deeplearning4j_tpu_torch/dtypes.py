"""Dtype policy (counterpart of ``deeplearning4j_tpu/dtypes.py``).

A :class:`Policy` splits parameters, compute and hidden activations
across dtypes. As in the JAX package, only the convolution and dense
layers cast to ``compute_dtype`` (and their results to
``output_dtype``); parameters stay in ``param_dtype``, batch-norm
statistics are float32, and output layers promote half-precision
logits before softmax and loss. The attention layers read only
``param_dtype``, so the transformer LM computes in float32 under either
policy, in both packages.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

__all__ = ["Policy", "policy", "set_policy", "policy_scope",
           "default_policy", "tpu_bf16", "highest_precision",
           "promote_half"]


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

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.output_dtype)


_DEFAULT = Policy()
_active = _DEFAULT


def default_policy() -> Policy:
    return _DEFAULT


def tpu_bf16() -> Policy:
    """bf16 compute and bf16 conv/dense outputs, float32 parameters: the
    JAX package's mixed-precision training policy (the name is kept for
    API parity; on the card the bf16 products run on the tensor
    cores)."""
    return Policy(compute_dtype=torch.bfloat16,
                  output_dtype=torch.bfloat16)


def highest_precision() -> Policy:
    return Policy()


def policy() -> Policy:
    """The active policy (float32 everywhere unless set)."""
    return _active


def set_policy(p: Policy) -> None:
    global _active
    _active = p


@contextmanager
def policy_scope(p: Policy):
    """``p`` is the active policy inside the block."""
    global _active
    prev = _active
    _active = p
    try:
        yield p
    finally:
        _active = prev
