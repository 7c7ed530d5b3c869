"""Base layer config classes + serde registry (counterpart of
``deeplearning4j_tpu/nn/conf/layers/base.py``).

The config dataclasses carry the JAX package's fields and ``@type``
names, so one config JSON drives both packages. Functional protocol,
on tensors:

- ``output_type(input_type)``: config-time shape inference;
- ``initialize(generator, input_type)``: ``(params, state)``, dicts of
  CPU tensors sampled from a ``torch.Generator``;
- ``apply(params, state, x, *, mask=None)``: inference forward,
  returns ``(out, state)``. Training (dropout, losses) is not ported
  yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "register_layer",
           "layer_from_dict", "LAYER_REGISTRY"]

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: register for JSON round-trip by type name."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict) -> "Layer":
    d = dict(d)
    tname = d.pop("@type")
    if tname not in LAYER_REGISTRY:
        raise ValueError(f"Unknown or not yet ported layer type '{tname}' "
                         f"(ported: {sorted(LAYER_REGISTRY)})")
    return LAYER_REGISTRY[tname].from_dict(d)


@dataclasses.dataclass
class Layer:
    """Root of the layer-config hierarchy."""

    name: Optional[str] = None
    # probability of DROPPING an input activation (identity at
    # inference, the only mode ported so far)
    dropout: float = 0.0
    constraints: Tuple[dict, ...] = ()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType) -> None:
        """Infer nIn-style geometry from the incoming type (override)."""

    def initialize(self, generator: torch.Generator,
                   input_type: InputType):
        return {}, {}

    def apply(self, params, state, x, *, mask=None):
        raise NotImplementedError

    # ---- serde ----
    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Layer":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                if isinstance(v, list):
                    v = tuple(tuple(e) if isinstance(e, list) else e
                              for e in v)
                kw[f.name] = v
        return cls(**kw)


@dataclasses.dataclass
class BaseLayer(Layer):
    """Layers with weights: activation, weight init, and the training
    hyperparameters the JSON carries (kept for round-trip)."""

    activation: str = "identity"
    weight_init: str = "xavier"
    weight_distribution: Optional[dict] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    updater: Optional[dict] = None
    bias_updater: Optional[dict] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0

    def activation_fn(self):
        return activations.get(self.activation)

    def _sample_w(self, generator, shape, fan_in, fan_out):
        return init_weight(generator, shape, self.weight_init, fan_in,
                           fan_out, distribution=self.weight_distribution,
                           dtype=dtypes.policy().param_dtype)


@dataclasses.dataclass
class FeedForwardLayer(BaseLayer):
    """Adds nIn/nOut geometry."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.flat_size()
        if self.n_out is None:
            raise ValueError(f"{type(self).__name__} requires n_out")

    def output_type(self, input_type: InputType) -> InputType:
        if self.n_out is None:
            raise ValueError(f"{type(self).__name__} requires n_out")
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)
