"""Core layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/core.py``). Ported so far: the
transformer LM's ``EmbeddingSequenceLayer``."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          register_layer)

__all__ = ["EmbeddingSequenceLayer", "embedding_lookup"]


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
