"""Output layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/output.py``). Ported so far: the
inference forward of ``OutputLayer`` and ``RnnOutputLayer`` (dense +
activation, softmax in float32). Losses belong to the training
slice."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          register_layer)

__all__ = ["OutputLayer", "RnnOutputLayer"]


@register_layer
@dataclasses.dataclass
class OutputLayer(FeedForwardLayer):
    """Dense + activation (+ loss, in training)."""

    loss: str = "mcxent"
    activation: str = "softmax"

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        p = {"W": self._sample_w(generator, (self.n_in, self.n_out),
                                 self.n_in, self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtypes.policy().param_dtype)
        return p, {}

    def _pre_output(self, params, x):
        if x.dim() > 2 and not isinstance(self, RnnOutputLayer):
            x = x.reshape(x.shape[0], -1)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, state, x, *, mask=None):
        z = dtypes.promote_half(self._pre_output(params, x))
        return self.activation_fn()(z), state


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Time-distributed output layer: (B, T, F) -> (B, T, n_out)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)
