"""Base layer config classes + serde registry (counterpart of
``deeplearning4j_tpu/nn/conf/layers/base.py``).

The config dataclasses carry the JAX package's fields and ``@type``
names, so one config JSON drives both packages. Functional protocol,
on tensors:

- ``output_type(input_type)``: config-time shape inference;
- ``initialize(generator, input_type)``: ``(params, state)``, dicts of
  CPU tensors sampled from a ``torch.Generator``;
- ``apply(params, state, x, *, training=False, generator=None,
  mask=None)``: forward, returns ``(out, state)``; with ``training`` a
  layer drops its input (``dropout``) with bits drawn from the
  ``torch.Generator`` it is given, where the JAX layer folds an rng key;
- ``regularization_loss(params)``: L1/L2 terms added to the score;
- ``has_loss()``: output layers (``output.py``) carry a loss.
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
           "layer_from_dict", "LAYER_REGISTRY", "dropout_keep_mask"]

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


def dropout_keep_mask(shape, keep: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """Bernoulli(keep) bits for inverted dropout, from ``generator`` (on
    ``device``). torch and jax.random give different bits from one seed;
    a parity test replaces this function to feed both the same mask."""
    return torch.rand(shape, generator=generator, device=device) < keep


@dataclasses.dataclass
class Layer:
    """Root of the layer-config hierarchy."""

    name: Optional[str] = None
    # probability of DROPPING an input activation (inverted-dropout
    # scaling at train time, identity at inference)
    dropout: float = 0.0
    constraints: Tuple[dict, ...] = ()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType) -> None:
        """Infer nIn-style geometry from the incoming type (override)."""

    def initialize(self, generator: torch.Generator,
                   input_type: InputType):
        return {}, {}

    def num_params(self, input_type: InputType) -> int:
        """The count of this layer's parameters for ``input_type``: the
        entries of the params ``initialize`` gives (as in the JAX
        package)."""
        from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
        params, _ = self.initialize(torch.Generator().manual_seed(0),
                                    input_type)
        return sum(p.numel() for p in tree_leaves(params)
                   if isinstance(p, torch.Tensor))

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        raise NotImplementedError

    def has_loss(self) -> bool:
        return False

    def regularization_loss(self, params):
        return 0.0

    # DL4J applies a layer's dropout to its input (BaseLayer
    # preOutputWithPreNorm -> Dropout.applyDropout)
    def apply_input_dropout(self, x, *, training, generator):
        if not training or self.dropout <= 0.0 or generator is None:
            return x
        keep = 1.0 - self.dropout
        m = dropout_keep_mask(x.shape, keep, generator, x.device)
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

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

    def regularization_loss(self, params):
        reg = 0.0
        for k, p in params.items():
            is_bias = k == "b"
            l1 = self.l1_bias if is_bias else self.l1
            l2 = self.l2_bias if is_bias else self.l2
            if l1:
                reg = reg + l1 * p.abs().sum()
            if l2:
                # DL4J convention: 0.5 * l2 * ||w||^2
                reg = reg + 0.5 * l2 * (p * p).sum()
        return reg


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
