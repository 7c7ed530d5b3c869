"""Normalization (counterpart of
``deeplearning4j_tpu/nn/conf/layers/normalization.py``):
``BatchNormalization``, ``LocalResponseNormalization``,
``LayerNormalization`` and the last-axis ``layer_norm`` that it and the
transformer blocks share.

Batch normalization follows the JAX layer exactly, not
``F.batch_norm``: the batch statistics are float32 whatever the input
dtype, the variance is the biased ``E[x²] − E[x]²`` clamped at 0, the
running state becomes ``decay·old + (1 − decay)·batch`` with that same
biased variance (``F.batch_norm`` would update it with the unbiased
one), and ``(x − mean)`` promotes a bf16 input against the float32
statistics, so the layer's output is float32 under the bf16 policy as
in the JAX package. The state is a plain ``{"mean", "var"}`` dict
returned by ``apply``, computed under ``no_grad``. Inside a
data-parallel step (``parallel/global_batch.py``) the statistics are the
global batch's, from all-reduced float32 sums, as the JAX package's
GSPMD step computes them.

Local response normalization sums the squares over a window of ``n``
channels zero-padded by ``n // 2`` on each side, as the JAX layer's
``lax.reduce_window`` does, and divides by ``(k + alpha·sum)^beta``:
``alpha`` is not divided by ``n`` (``F.local_response_norm`` divides
it), so the sum is a window sum (``avg_pool2d`` with a divisor of 1)
over the channel axis instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer, Layer,
                                                          register_layer)
from deeplearning4j_tpu_torch.parallel import global_batch

__all__ = ["BatchNormalization", "LayerNormalization",
           "LocalResponseNormalization", "layer_norm"]


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
            gb = global_batch.active()
            if gb is None:
                mean = xs.mean(dim=axes)
                ex2 = xs.square().mean(dim=axes)
            else:
                # the global batch's statistics: all-reduced float32
                # sums over equal shards, the gradient through them
                c = xs.shape[-1]
                sums = global_batch.all_reduce_sum(torch.cat(
                    [xs.sum(dim=axes), xs.square().sum(dim=axes)]))
                n = (xs.numel() // c) * gb.ctx.world
                mean, ex2 = sums[:c] / n, sums[c:] / n
            var = torch.clamp(ex2 - mean.square(), min=0.0)
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


@register_layer
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    """Across-channel LRN (nn/conf/layers/LocalResponseNormalization.java):
    y = x / (k + alpha * sum_{j in window} x_j^2)^beta."""

    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75
    n: int = 5

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        half = self.n // 2
        # channels last: the squares as (rows, 1, C, 1), zero-padded on C
        sq = F.pad((x * x).reshape(-1, 1, x.shape[-1], 1),
                   (0, 0, half, half))
        ssum = F.avg_pool2d(sq, (self.n, 1), 1,
                            divisor_override=1).reshape(x.shape)
        return x / (self.k + self.alpha * ssum) ** self.beta, state


@register_layer
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Per-example normalization over the last axis with learned
    ``gamma``/``beta`` (Ba et al. 2016); stateless."""

    n_in: Optional[int] = None
    eps: float = 1e-5

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        return {"gamma": torch.ones((self.n_in,), dtype=pd),
                "beta": torch.zeros((self.n_in,), dtype=pd)}, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return layer_norm(x, params["gamma"], params["beta"],
                          self.eps), state
