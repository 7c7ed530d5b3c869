"""Convolutional layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/convolutional.py``): the 2-d and
1-d convolutions, the transposed, depthwise and separable
convolutions, zero padding (2-d and 1-d), nearest upsampling, cropping,
space-to-depth and space-to-batch.

Activations are NHWC between layers and the kernel is HWIO in the
parameter tree, as in the JAX package, so params, updater state and
checkpoints agree with it index for index. Each call lays the kernel
out as OIHW in channels_last memory (one copy a weight a call) and
views the NHWC input as channels_last NCHW (no copy), which is what
cuDNN takes; the result, viewed back, is contiguous NHWC. A 1-d
convolution views its (B, T, C) input as width-1 NHWC with a (k, 1)
kernel. The depthwise kernel ``(kh, kw, 1, n_in·mult)`` is OIHW
``(n_in·mult, 1, kh, kw)`` for ``groups=n_in``: output channel ``o``
belongs to group ``o // mult`` in both packages. The transposed
convolution's ``(kh, kw, n_out, n_in)`` kernel is ``F.conv_transpose2d``'s
``(n_in, n_out, kh, kw)`` by the same permute, unflipped: with
``transpose_kernel=True`` the JAX layer computes the exact transpose of
a convolution, which is what ``F.conv_transpose2d`` computes.

``same`` mode pads as XLA's ``"SAME"`` does: ``total = max((out-1)·s +
k_eff − in, 0)``, ``lo = total // 2``, ``hi = total − lo``. Where lo and
hi differ (the ResNet50 stem's 7×7 stride-2 conv on 224 pads (2, 3))
the input is zero-padded explicitly; torch's symmetric padding would
shift every window by one pixel. The transposed convolution pads as
``lax.conv_transpose`` does (``_transpose_pads``), by cropping the full
transposed output, or extending it with ``output_padding``.

Float32 convolutions on the card run with cuDNN's TF32 off, as the JAX
package computes them: every convolution calls ``device.keep_float32``
before its CUDA call (see there).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer, Layer,
                                                          register_layer)
from deeplearning4j_tpu_torch.parallel import tensor_parallel

__all__ = ["ConvolutionLayer", "Convolution1DLayer", "Deconvolution2DLayer",
           "SeparableConvolution2DLayer", "DepthwiseConvolution2DLayer",
           "ZeroPaddingLayer", "ZeroPadding1DLayer", "UpsamplingLayer",
           "CroppingLayer", "SpaceToDepthLayer", "SpaceToBatchLayer",
           "conv_weight_oihw", "same_pads"]


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


def _conv_nhwc(x, w, mode, padding, kernel, stride, dilation, groups=1):
    """NHWC ``x`` (*) HWIO ``w`` -> NHWC in ``x``'s dtype, padded by
    ``mode`` (XLA's "SAME", or ``padding`` a side)."""
    keep_float32(x)
    (h_lo, h_hi), (w_lo, w_hi) = _conv_padding(
        mode, padding, kernel, (x.shape[1], x.shape[2]), stride, dilation)
    if h_lo != h_hi or w_lo != w_hi:
        x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
        h_lo = w_lo = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), conv_weight_oihw(w, x.dtype), None,
                 stride, (h_lo, w_lo), dilation, groups)
    return y.permute(0, 2, 3, 1)


def _first(v):
    return v[0] if isinstance(v, (tuple, list)) else v


def _bias(n: int, value: float) -> torch.Tensor:
    return torch.full((n,), float(value), dtype=dtypes.policy().param_dtype)


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
            p["b"] = _bias(self.n_out, self.bias_init)
        return p, {}

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` (*) HWIO ``w`` -> NHWC, in the compute dtype, cast
        to the output dtype after the conv (as the JAX layer does)."""
        pol = dtypes.policy()
        return pol.cast_to_output(_conv_nhwc(
            pol.cast_to_compute(x), w, self.convolution_mode, self.padding,
            self.kernel, self.stride, self.dilation))

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        tp = tensor_parallel.current_mode()
        if tp is not None and tp[0] == tensor_parallel.TPRule.COLUMN:
            # tensor parallelism: this rank's output channels
            x = tensor_parallel.copy_to_model(x, tp[1])
        y = self._conv(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@register_layer
@dataclasses.dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-d convolution over sequences (nn/conf/layers/Convolution1DLayer
    .java). Input (B,T,C) treated as width-1 2-d conv on time axis."""

    kernel: Tuple[int, int] = (3, 1)

    def __post_init__(self):
        self.kernel = (int(_first(self.kernel)), 1)
        self.stride = (int(_first(self.stride)), 1)
        self.padding = (int(_first(self.padding)), 0)
        self.dilation = (int(_first(self.dilation)), 1)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = _out_dim(t, self.kernel[0], self.stride[0], self.padding[0],
                         self.convolution_mode, self.dilation[0])
        return InputType.recurrent(self.n_out, t)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        y = self._conv(x[:, :, None, :], params["W"])[:, :, 0, :]
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


def _transpose_pads(k: int, s: int, mode: str) -> Tuple[int, int]:
    """(lo, hi) padding of the stride-dilated input that
    ``lax.conv_transpose`` applies on one axis ("SAME" or "VALID")."""
    if mode == "same":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, total - lo


@register_layer
@dataclasses.dataclass
class Deconvolution2DLayer(ConvolutionLayer):
    """Transposed convolution (capability parity with later-DL4J
    Deconvolution2D; Keras Conv2DTranspose import target). The kernel's
    dilation is not applied, as in the JAX layer."""

    def output_type(self, input_type: InputType) -> InputType:
        def _od(size, k, s, p):
            if self.convolution_mode == "same":
                return size * s
            return s * (size - 1) + k - 2 * p
        h = _od(input_type.height, self.kernel[0], self.stride[0],
                self.padding[0])
        w = _od(input_type.width, self.kernel[1], self.stride[1],
                self.padding[1])
        return InputType.convolutional(h, w, self.n_out)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        kh, kw = self.kernel
        fan_in = self.n_in * kh * kw
        fan_out = self.n_out * kh * kw
        p = {"W": self._sample_w(generator, (kh, kw, self.n_out, self.n_in),
                                 fan_in, fan_out)}
        if self.has_bias:
            p["b"] = _bias(self.n_out, self.bias_init)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        w = params["W"]
        keep_float32(x)
        # the full transpose pads the dilated input by k - 1 a side;
        # lax's padding crops that (lo, hi <= k - 1) or extends its end
        # by rows of zero contributions (hi > k - 1: output_padding)
        (h_lo, h_hi), (w_lo, w_hi) = (
            _transpose_pads(k, s, self.convolution_mode)
            for k, s in zip(self.kernel, self.stride))
        kh, kw = self.kernel
        # contiguous operands: the CPU backward of conv_transpose2d on
        # the permuted views crashed under 8 OpenMP threads
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2).contiguous(),
            conv_weight_oihw(w, x.dtype).contiguous(), None,
            self.stride, 0, (max(h_hi - kh + 1, 0), max(w_hi - kw + 1, 0)))
        rows, cols = y.shape[2], y.shape[3]
        y = y[:, :, kh - 1 - h_lo:rows - max(kh - 1 - h_hi, 0),
              kw - 1 - w_lo:cols - max(kw - 1 - w_hi, 0)].permute(0, 2, 3, 1)
        if self.convolution_mode != "same" and any(self.padding):
            ph, pw = self.padding
            rows, cols = y.shape[1], y.shape[2]
            y = y[:, ph:rows - ph or None, pw:cols - pw or None, :]
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@register_layer
@dataclasses.dataclass
class DepthwiseConvolution2DLayer(ConvolutionLayer):
    """Depthwise conv (Keras DepthwiseConv2D target)."""

    depth_multiplier: int = 1

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.channels
        self.n_out = self.n_in * self.depth_multiplier

    def output_type(self, input_type: InputType) -> InputType:
        base = super().output_type(input_type)
        return InputType.convolutional(base.height, base.width,
                                       self.n_in * self.depth_multiplier)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        kh, kw = self.kernel
        p = {"W": self._sample_w(generator, (kh, kw, 1, self.n_out),
                                 kh * kw, kh * kw * self.depth_multiplier)}
        if self.has_bias:
            p["b"] = _bias(self.n_out, self.bias_init)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        y = _conv_nhwc(x, params["W"], self.convolution_mode, self.padding,
                       self.kernel, self.stride, self.dilation,
                       groups=self.n_in)
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@register_layer
@dataclasses.dataclass
class SeparableConvolution2DLayer(ConvolutionLayer):
    """Depthwise-separable conv (reference SeparableConvolution2D /
    Keras SeparableConv2D): depthwise then 1x1 pointwise."""

    depth_multiplier: int = 1

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        kh, kw = self.kernel
        mult = self.depth_multiplier
        p = {
            "dW": self._sample_w(generator, (kh, kw, 1, self.n_in * mult),
                                 kh * kw, kh * kw * mult),
            "pW": self._sample_w(generator,
                                 (1, 1, self.n_in * mult, self.n_out),
                                 self.n_in * mult, self.n_out),
        }
        if self.has_bias:
            p["b"] = _bias(self.n_out, self.bias_init)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        y = _conv_nhwc(x, params["dW"], self.convolution_mode, self.padding,
                       self.kernel, self.stride, self.dilation,
                       groups=self.n_in)
        y = _conv_nhwc(y, params["pW"], "truncate", (0, 0), (1, 1), (1, 1),
                       (1, 1))
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


def _pad_pairs(p):
    """An int, (a, b) or ((t, b), (l, r)) as ((t, b), (l, r))."""
    if isinstance(p, int):
        return ((p, p), (p, p))
    if len(p) == 2 and all(isinstance(e, int) for e in p):
        return ((p[0], p[0]), (p[1], p[1]))
    return tuple(tuple(int(x) for x in e) for e in p)


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """(nn/conf/layers/ZeroPaddingLayer.java). pad = ((top,bottom),
    (left,right)) or a single int."""

    pad: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))

    def __post_init__(self):
        self.pad = _pad_pairs(self.pad)

    def output_type(self, input_type: InputType) -> InputType:
        (t, b), (l, r) = self.pad
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        (t, b), (l, r) = self.pad
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    """(nn/conf/layers/ZeroPadding1DLayer.java)."""

    pad: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        if isinstance(self.pad, int):
            self.pad = (self.pad, self.pad)
        else:
            self.pad = tuple(int(x) for x in self.pad)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return InputType.recurrent(
            input_type.size,
            None if t is None else t + self.pad[0] + self.pad[1])

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return F.pad(x, (0, 0) + self.pad), state


@register_layer
@dataclasses.dataclass
class UpsamplingLayer(Layer):
    """Nearest-neighbor 2-d upsampling (reference Upsampling2D)."""

    size: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.size = _pair(self.size)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        y = x.repeat_interleave(self.size[0], dim=1).repeat_interleave(
            self.size[1], dim=2)
        return y, state


@register_layer
@dataclasses.dataclass
class CroppingLayer(Layer):
    """2-d cropping (reference Cropping2D)."""

    crop: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0), (0, 0))

    def __post_init__(self):
        self.crop = _pad_pairs(self.crop)

    def output_type(self, input_type: InputType) -> InputType:
        (t, b), (l, r) = self.crop
        return InputType.convolutional(input_type.height - t - b,
                                       input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        (t, b), (l, r) = self.crop
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b or None, l:w - r or None, :], state


@register_layer
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """(reference SpaceToDepthLayer; used by YOLO9000-style nets): each
    b x b block becomes b·b·C channels, in (row, column, channel)
    order."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.block_size
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels * b * b)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b,
                                                b * b * c)
        return y, state


@register_layer
@dataclasses.dataclass
class SpaceToBatchLayer(Layer):
    """(reference SpaceToBatchLayer): the b·b offsets of each block
    become batch blocks, offset-major (row offset, column offset,
    example)."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.block_size
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c)
        y = y.permute(2, 4, 0, 1, 3, 5).reshape(n * b * b, h // b,
                                                w // b, c)
        return y, state
