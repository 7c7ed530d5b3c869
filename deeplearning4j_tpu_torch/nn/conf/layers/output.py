"""Output layers: loss-bearing heads (counterpart of
``deeplearning4j_tpu/nn/conf/layers/output.py``).

``OutputLayer`` and ``RnnOutputLayer``: dense + activation (softmax in
float32) for inference, and ``loss_from_input`` for training, with the
fused softmax/sigmoid cross entropy where the activation and loss pair
allows it and ``nn/losses.py`` otherwise. ``RnnOutputLayer`` averages a
masked loss over the present timesteps. ``LossLayer``,
``CenterLossOutputLayer`` and the sequence-parallel loss are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          register_layer)

__all__ = ["OutputLayer", "RnnOutputLayer"]


def _stable_ce(logits, labels, mask, kind):
    """Fused log-softmax / log-sigmoid cross entropy, per example (summed
    over every axis but the first). Half-precision logits are promoted
    to float32 first."""
    logits = dtypes.promote_half(logits)
    labels = dtypes.promote_half(labels)
    if kind == "softmax":
        per = -labels * F.log_softmax(logits, dim=-1)
    else:  # sigmoid + binary xent
        per = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-torch.abs(logits))))
    if mask is not None:
        per = per * mask
    return per.sum(dim=tuple(range(1, per.dim())))


@register_layer
@dataclasses.dataclass
class OutputLayer(FeedForwardLayer):
    """Dense + activation + loss."""

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

    def _pre_output(self, params, x, *, training=False, generator=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        if x.dim() > 2 and not isinstance(self, RnnOutputLayer):
            x = x.reshape(x.shape[0], -1)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        z = dtypes.promote_half(self._pre_output(
            params, x, training=training, generator=generator))
        return self.activation_fn()(z), state

    def has_loss(self) -> bool:
        return True

    def _fused_kind(self):
        a, l = self.activation.lower(), self.loss.lower()
        if a == "softmax" and l in ("mcxent", "negativeloglikelihood"):
            return "softmax"
        if a == "sigmoid" and l == "xent":
            return "sigmoid"
        return None

    def _per_example(self, z, labels, mask):
        kind = self._fused_kind()
        if kind is not None:
            return _stable_ce(z, labels, mask, kind)
        preds = self.activation_fn()(dtypes.promote_half(z))
        return losses_mod.get(self.loss)(labels, preds, mask)

    def loss_from_input(self, params, x, labels, *, training=False,
                        generator=None, mask=None):
        """Mean per-example score given the layer *input* (pre-dense)."""
        z = self._pre_output(params, x, training=training,
                             generator=generator)
        return self._per_example(z, labels, mask).mean()


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Time-distributed output layer: (B, T, F) -> (B, T, n_out); the
    loss is masked per timestep."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def loss_from_input(self, params, x, labels, *, training=False,
                        generator=None, mask=None):
        z = self._pre_output(params, x, training=training,
                             generator=generator)
        # mask: (B, T) -> broadcast over features
        m = mask[..., None] if (mask is not None and mask.dim() == 2) \
            else mask
        per = self._per_example(z, labels, m)      # (B,) summed over T, F
        if mask is not None:
            # DL4J averages over *present* timesteps across the batch
            return per.sum() / torch.clamp(mask.sum(), min=1.0)
        return per.mean() / z.shape[1]
