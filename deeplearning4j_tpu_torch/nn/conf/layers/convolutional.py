"""2-d convolution (counterpart of the ``ConvolutionLayer`` of
``deeplearning4j_tpu/nn/conf/layers/convolutional.py``).

Activations are NHWC between layers and the kernel is HWIO in the
parameter tree, as in the JAX package, so params, updater state and
checkpoints agree with it index for index. Each call lays the kernel
out as OIHW in channels_last memory (one copy a weight a call) and
views the NHWC input as channels_last NCHW (no copy), which is what
cuDNN takes; the result, viewed back, is contiguous NHWC.

``same`` mode pads as XLA's ``"SAME"`` does: ``total = max((out-1)·s +
k_eff − in, 0)``, ``lo = total // 2``, ``hi = total − lo``. Where lo and
hi differ (the ResNet50 stem's 7×7 stride-2 conv on 224 pads (2, 3))
the input is zero-padded explicitly; torch's symmetric padding would
shift every window by one pixel.

Float32 convolutions on the card run with cuDNN's TF32 off, as the JAX
package computes them: the layer calls ``device.keep_float32`` before
each CUDA call, so a conv reached through ``fit``, ``output`` or a
server is float32 whoever called it (the flag is process-wide, and is
read again when autograd runs the backward).

Not ported yet (ROADMAP A5b-2): ``Convolution1DLayer``,
``Deconvolution2DLayer``, the separable and depthwise convolutions,
zero padding, upsampling, cropping, space-to-depth and space-to-batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          register_layer)

__all__ = ["ConvolutionLayer", "conv_weight_oihw", "same_pads"]


def _pair(v):
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_dim(size, k, s, p, mode, dilation=1):
    keff = k + (k - 1) * (dilation - 1)
    if mode == "same":
        return -(-size // s)
    return (size + 2 * p - keff) // s + 1


def same_pads(size: int, k: int, s: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(lo, hi) padding of one spatial axis under XLA's ``"SAME"``."""
    keff = k + (k - 1) * (dilation - 1)
    out = -(-size // s)
    total = max((out - 1) * s + keff - size, 0)
    return total // 2, total - total // 2


def _conv_padding(mode, pad, kernel, size, stride, dilation=(1, 1)):
    """((lo, hi) of H, (lo, hi) of W) for an input of spatial ``size``."""
    if mode == "same":
        return tuple(same_pads(size[i], kernel[i], stride[i], dilation[i])
                     for i in range(2))
    return tuple((p, p) for p in pad)


def conv_weight_oihw(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The HWIO kernel ``w`` as OIHW in channels_last memory and
    ``dtype``: one copy, the per-call weight re-layout."""
    return w.permute(3, 2, 0, 1).to(dtype, memory_format=torch.channels_last)


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(BaseLayer):
    """2-d convolution (nn/conf/layers/ConvolutionLayer.java)."""

    n_in: Optional[int] = None        # channels in (inferred)
    n_out: Optional[int] = None       # filters
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True
    activation: str = "identity"

    def __post_init__(self):
        self.kernel = _pair(self.kernel)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind not in ("cnn", "cnnflat"):
            raise ValueError(f"ConvolutionLayer needs CNN input, got "
                             f"{input_type}")
        h = _out_dim(input_type.height, self.kernel[0], self.stride[0],
                     self.padding[0], self.convolution_mode, self.dilation[0])
        w = _out_dim(input_type.width, self.kernel[1], self.stride[1],
                     self.padding[1], self.convolution_mode, self.dilation[1])
        return InputType.convolutional(h, w, self.n_out)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        kh, kw = self.kernel
        fan_in = self.n_in * kh * kw
        fan_out = self.n_out * kh * kw
        p = {"W": self._sample_w(generator, (kh, kw, self.n_in, self.n_out),
                                 fan_in, fan_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtypes.policy().param_dtype)
        return p, {}

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` (*) HWIO ``w`` -> NHWC, in the compute dtype, cast
        to the output dtype after the conv (as the JAX layer does)."""
        pol = dtypes.policy()
        keep_float32(x)
        x = pol.cast_to_compute(x)
        (h_lo, h_hi), (w_lo, w_hi) = _conv_padding(
            self.convolution_mode, self.padding, self.kernel,
            (x.shape[1], x.shape[2]), self.stride, self.dilation)
        if h_lo != h_hi or w_lo != w_hi:
            x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
            h_lo = w_lo = 0
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     conv_weight_oihw(w, pol.compute_dtype), None,
                     self.stride, (h_lo, w_lo), self.dilation)
        return pol.cast_to_output(y.permute(0, 2, 3, 1))

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        y = self._conv(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state
