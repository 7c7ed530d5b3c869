"""Normalization (counterpart of
``deeplearning4j_tpu/nn/conf/layers/normalization.py``). Only the
last-axis ``layer_norm`` that the transformer blocks inline is ported
so far."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Last-axis layer norm with the biased variance and eps inside the
    square root, as the JAX package computes it."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
