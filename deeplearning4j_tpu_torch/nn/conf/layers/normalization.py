"""Normalization (counterpart of
``deeplearning4j_tpu/nn/conf/layers/normalization.py``):
``BatchNormalization`` and the last-axis ``layer_norm`` that the
transformer blocks inline.

Batch normalization follows the JAX layer exactly, not
``F.batch_norm``: the batch statistics are float32 whatever the input
dtype, the variance is the biased ``E[x²] − E[x]²`` clamped at 0, the
running state becomes ``decay·old + (1 − decay)·batch`` with that same
biased variance (``F.batch_norm`` would update it with the unbiased
one), and ``(x − mean)`` promotes a bf16 input against the float32
statistics, so the layer's output is float32 under the bf16 policy as
in the JAX package. The state is a plain ``{"mean", "var"}`` dict
returned by ``apply``, computed under ``no_grad``.
``LocalResponseNormalization`` and the ``LayerNormalization`` layer are
not ported yet (ROADMAP A5b-2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          register_layer)

__all__ = ["BatchNormalization", "layer_norm"]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Last-axis layer norm with the biased variance and eps inside the
    square root, as the JAX package computes it."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


@register_layer
@dataclasses.dataclass
class BatchNormalization(BaseLayer):
    """(nn/conf/layers/BatchNormalization.java). Normalizes over the
    batch (and H, W for NHWC input); ``gamma``/``beta`` are trained
    unless ``lock_gamma_beta``."""

    n_out: Optional[int] = None      # inferred from input type
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    gamma: float = 1.0
    beta: float = 0.0

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_out is None:
            if input_type.kind == "cnn":
                self.n_out = input_type.channels
            else:
                self.n_out = input_type.flat_size()

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        n = self.n_out
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((n,), float(self.gamma), dtype=pd),
                      "beta": torch.full((n,), float(self.beta), dtype=pd)}
        state = {"mean": torch.zeros((n,), dtype=torch.float32),
                 "var": torch.ones((n,), dtype=torch.float32)}
        return params, state

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        axes = tuple(range(x.dim() - 1))   # all but the channel axis
        if training:
            xs = x.float()
            mean = xs.mean(dim=axes)
            var = torch.clamp(xs.square().mean(dim=axes) - mean.square(),
                              min=0.0)
            with torch.no_grad():
                new_state = {
                    "mean": (self.decay * state["mean"]
                             + (1 - self.decay) * mean),
                    "var": (self.decay * state["var"]
                            + (1 - self.decay) * var),
                }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            y = y * params["gamma"] + params["beta"]
        else:
            y = y * self.gamma + self.beta
        return self.activation_fn()(y), new_state
