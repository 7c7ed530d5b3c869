"""Core layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/core.py``): ``DenseLayer``,
``ActivationLayer``, ``DropoutLayer`` and the transformer LM's
``EmbeddingSequenceLayer``. The dense product casts its operands to the
policy's compute dtype and its result to the output dtype, as the JAX
layer does; the float32 bias then promotes a bf16 result back to
float32. The product runs with TF32 off on the card
(``device.keep_float32``). ``EmbeddingLayer``, ``AutoEncoder`` and
``RBM`` are not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          FeedForwardLayer,
                                                          Layer,
                                                          register_layer)

__all__ = ["DenseLayer", "ActivationLayer", "DropoutLayer",
           "EmbeddingSequenceLayer", "embedding_lookup"]


@register_layer
@dataclasses.dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer; on (B, T, C) input the product is per
    timestep, on a 4-d input it flattens first."""

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        p = {"W": self._sample_w(generator, (self.n_in, self.n_out),
                                 self.n_in, self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtypes.policy().param_dtype)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        if x.dim() > 2 and x.shape[-1] != params["W"].shape[0]:
            x = x.reshape(x.shape[0], -1)
        keep_float32(x)
        pol = dtypes.policy()
        y = pol.cast_to_output(pol.cast_to_compute(x)
                               @ pol.cast_to_compute(params["W"]))
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state


@register_layer
@dataclasses.dataclass
class ActivationLayer(BaseLayer):
    """The activation alone."""

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return self.activation_fn()(x), state


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Inverted dropout of its input at training time, identity
    otherwise."""

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return self.apply_input_dropout(x, training=training,
                                        generator=generator), state


def embedding_lookup(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rows of ``W`` for the ids ``x`` with ``jnp.take``'s semantics:
    float ids are truncated toward zero, an id in [-V, 0) wraps as in
    numpy, and an id outside [-V, V) gives a row of NaN."""
    idx = x if not torch.is_floating_point(x) else x.to(torch.int64)
    V = W.shape[0]
    valid = (idx >= -V) & (idx < V)
    rows = W[torch.remainder(idx, V)]
    return rows.masked_fill(~valid[..., None], float("nan"))


@register_layer
@dataclasses.dataclass
class EmbeddingSequenceLayer(FeedForwardLayer):
    """Sequence of ids (B, T) -> (B, T, n_out); a trailing (B, T, 1)
    axis is squeezed."""

    def initialize(self, generator, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size
        return {"W": self._sample_w(generator, (self.n_in, self.n_out),
                                    self.n_in, self.n_out)}, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        # no input dropout: ids are not activations (as in the JAX layer)
        if x.dim() == 3 and x.shape[-1] == 1:
            x = x[..., 0]
        return embedding_lookup(params["W"], x), state

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)
