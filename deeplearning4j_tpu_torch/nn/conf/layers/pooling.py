"""Pooling layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/pooling.py``): ``SubsamplingLayer``
(max, avg, sum and pnorm windows in ``truncate`` and ``same`` mode) and
``Subsampling1DLayer`` (the same windows over the time axis of (B, T, C)
input, viewed as width-1 NHWC) and ``GlobalPoolingLayer`` (over H, W of
NHWC input, or over the time axis of (B, T, C) input with the JAX
package's masked reductions).

The windows run on torch's pooling ops over the NHWC input viewed as
channels_last NCHW. ``same`` mode pads as XLA's ``"SAME"`` does, which
may be asymmetric (the ResNet50 stem's 3×3 stride-2 max pool on 112
pads (0, 1)); such an input is padded explicitly, with −inf for max
and zeros for the sums, and ``same``-mode averages divide by the count
of real elements in each window, as the JAX layer does.
``GlobalPoolingLayer.apply_stream`` pools a stream chunk by chunk over
a running statistic (max, sum and count, sum, or sum of |x|^p), so each
step returns the pool of the stream so far. The sequence-parallel
combine waits for ROADMAP A6b.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
    _conv_padding, _first, _out_dim, _pair)

__all__ = ["PoolingType", "SubsamplingLayer", "Subsampling1DLayer",
           "GlobalPoolingLayer"]


class PoolingType:
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _pad_nhwc(x, pads, fill):
    """NHWC ``x`` padded on H and W by ``pads`` ((lo, hi) each) with
    ``fill``; ``x`` itself when there is nothing to pad."""
    (h_lo, h_hi), (w_lo, w_hi) = pads
    if not (h_lo or h_hi or w_lo or w_hi):
        return x
    return F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=fill)


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """2-d pooling (nn/conf/layers/SubsamplingLayer.java)."""

    pooling: str = PoolingType.MAX
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        h = _out_dim(input_type.height, self.kernel[0], self.stride[0],
                     self.padding[0], self.convolution_mode)
        w = _out_dim(input_type.width, self.kernel[1], self.stride[1],
                     self.padding[1], self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def _window_sum(self, x, pads):
        """Window sums of NHWC ``x`` zero-padded by ``pads`` (an NCHW
        view)."""
        return F.avg_pool2d(_pad_nhwc(x, pads, 0.0).permute(0, 3, 1, 2),
                            self.kernel, self.stride, divisor_override=1)

    def _window_pool(self, x):
        pads = _conv_padding(self.convolution_mode, self.padding,
                             self.kernel, (x.shape[1], x.shape[2]),
                             self.stride)
        if self.pooling == PoolingType.MAX:
            x = _pad_nhwc(x, pads, float("-inf"))
            y = F.max_pool2d(x.permute(0, 3, 1, 2), self.kernel, self.stride)
        elif self.pooling in (PoolingType.AVG, PoolingType.SUM):
            y = self._window_sum(x, pads)
            if self.pooling == PoolingType.AVG:
                if self.convolution_mode == "same":
                    ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,),
                                      dtype=x.dtype, device=x.device)
                    y = y / self._window_sum(ones, pads)
                else:
                    y = y / (self.kernel[0] * self.kernel[1])
        elif self.pooling == PoolingType.PNORM:
            p = float(self.pnorm)
            y = self._window_sum(torch.abs(x) ** p, pads) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {self.pooling}")
        return y.permute(0, 2, 3, 1)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return self._window_pool(x), state


@register_layer
@dataclasses.dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """1-d pooling over (B,T,C) (nn/conf/layers/Subsampling1DLayer.java)."""

    def __post_init__(self):
        self.kernel = (int(_first(self.kernel)), 1)
        self.stride = (int(_first(self.stride)), 1)
        self.padding = (int(_first(self.padding)), 0)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = _out_dim(t, self.kernel[0], self.stride[0], self.padding[0],
                         self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return self._window_pool(x[:, :, None, :])[:, :, 0, :], state


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over H, W (NHWC) or T (NTC), excluding masked
    timesteps as the reference's MaskedReductionUtil does."""

    pooling: str = PoolingType.AVG
    pnorm: int = 2
    collapse_dimensions: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply_stream(self, params, cache, x):
        """The pool over time of the stream so far, given the next
        (B, t, C) chunk and the running statistic ``cache`` (None at
        the stream's start): the max (max), a sum and a step count
        (avg, sum), or the sum of |x|^p (pnorm). Returns (pool, the new
        statistic); the last step equals ``apply`` over the whole
        sequence."""
        if x.dim() != 3:
            raise ValueError("apply_stream pools over TIME: input "
                             f"must be (B, t, C), got {tuple(x.shape)}")
        if self.pooling == PoolingType.MAX:
            cur = torch.amax(x, dim=1)
            m = cur if cache is None else torch.maximum(cache, cur)
            return m, m
        if self.pooling in (PoolingType.AVG, PoolingType.SUM):
            s_new = torch.sum(x, dim=1)
            n_new = x.shape[1]
            if cache is not None:
                s_new = s_new + cache["sum"]
                n_new = n_new + cache["count"]
            cache = {"sum": s_new, "count": n_new}
            if self.pooling == PoolingType.SUM:
                return s_new, cache
            return s_new / n_new, cache
        if self.pooling == PoolingType.PNORM:
            p = float(self.pnorm)
            s_new = torch.sum(torch.abs(x) ** p, dim=1)
            if cache is not None:
                s_new = s_new + cache
            return s_new ** (1.0 / p), s_new
        raise ValueError(self.pooling)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        if x.dim() == 4:
            axes = (1, 2)
        elif x.dim() == 3:
            axes = (1,)
        else:
            return x, state
        if mask is not None and x.dim() == 3:
            m = mask[..., None]
            if self.pooling == PoolingType.MAX:
                big_neg = torch.finfo(x.dtype).min
                return torch.amax(torch.where(m > 0, x, big_neg),
                                  dim=1), state
            if self.pooling == PoolingType.SUM:
                return torch.sum(x * m, dim=1), state
            if self.pooling == PoolingType.AVG:
                return (torch.sum(x * m, dim=1)
                        / torch.clamp(torch.sum(m, dim=1), min=1.0)), state
            if self.pooling == PoolingType.PNORM:
                p = float(self.pnorm)
                s = torch.sum((torch.abs(x) * m) ** p, dim=1)
                return s ** (1.0 / p), state
        if self.pooling == PoolingType.MAX:
            return torch.amax(x, dim=axes), state
        if self.pooling == PoolingType.AVG:
            return torch.mean(x, dim=axes), state
        if self.pooling == PoolingType.SUM:
            return torch.sum(x, dim=axes), state
        if self.pooling == PoolingType.PNORM:
            p = float(self.pnorm)
            return torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p), state
        raise ValueError(self.pooling)
