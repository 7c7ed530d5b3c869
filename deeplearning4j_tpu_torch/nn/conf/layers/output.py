"""Output layers: loss-bearing heads (counterpart of
``deeplearning4j_tpu/nn/conf/layers/output.py``).

``OutputLayer`` and ``RnnOutputLayer``: dense + activation (softmax in
float32) for inference, and ``loss_from_input`` for training, with the
fused softmax/sigmoid cross entropy where the activation and loss pair
allows it and ``nn/losses.py`` otherwise; the product runs with TF32 off
on the card (``device.keep_float32``). ``RnnOutputLayer`` averages a
masked loss over the present timesteps. ``LossLayer`` is the loss
alone, without weights. ``CenterLossOutputLayer`` adds the center loss:
its per-class feature centers are layer *state*, and both executors add
``lambda_ * center_loss`` to the loss and take ``update_centers`` as the
new state. Inside a data-parallel step (``parallel/global_batch.py``)
the masked recurrent loss divides by the global batch's mask total and
the centers move toward the global batch's class means, as in the JAX
package's GSPMD step. In a sequence-parallel step the global batch is
split over data x seq: the mask total is taken over those ranks (by the
data-parallel scope's host reduce, or else by an all-reduce over
``seq_context.current_loss_axes``) and scaled by their count, so the
mean of the ranks' losses is the global masked mean.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          register_layer)
from deeplearning4j_tpu_torch.parallel import (collectives, global_batch,
                                               seq_context)

__all__ = ["OutputLayer", "RnnOutputLayer", "LossLayer",
           "CenterLossOutputLayer"]


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
        W = params["W"]
        if x.dtype != W.dtype:
            # jnp's promotion: a bf16 input meets float32 weights in
            # float32 (torch's matmul takes one dtype)
            dt = torch.promote_types(x.dtype, W.dtype)
            x, W = x.to(dt), W.to(dt)
        keep_float32(x)
        z = x @ W
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
            # DL4J averages over *present* timesteps across the batch:
            # the global batch's under data parallelism, where the mean
            # of the ranks' losses is the step's loss
            total = global_batch.mask_total(mask)
            if total is not None:
                return (per.sum() * global_batch.world()
                        / torch.clamp(total, min=1.0))
            axes = seq_context.current_loss_axes()
            if axes is not None:
                # a sequence-parallel step outside the data-parallel
                # scope: the mask total over the ranks the batch is
                # split over, scaled by their count
                total = collectives.all_reduce_(
                    mask.sum().detach().float().clone(), axes, kind="seq")
                return per.sum() * axes.size / torch.clamp(total, min=1.0)
            return per.sum() / torch.clamp(mask.sum(), min=1.0)
        return per.mean() / z.shape[1]


@register_layer
@dataclasses.dataclass
class LossLayer(OutputLayer):
    """Loss without weights: the input passes through the activation
    straight to the loss."""

    def set_n_in(self, input_type: InputType) -> None:
        # weightless: n_out is the input width, never user-required
        if self.n_in is None:
            self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        self.n_out = self.n_in
        return {}, {}

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def _pre_output(self, params, x, *, training=False, generator=None):
        return self.apply_input_dropout(x, training=training,
                                        generator=generator)


@register_layer
@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """Softmax + center loss. The per-class feature centers live in the
    layer's state and move toward each batch's class means (rate
    ``alpha``); the executor weights the center term by ``lambda_``."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def initialize(self, generator, input_type: InputType):
        params, _ = super().initialize(generator, input_type)
        centers = torch.zeros((self.n_out, self.n_in),
                              dtype=dtypes.policy().param_dtype)
        return params, {"centers": centers}

    def center_loss(self, state, x, labels):
        """0.5 * mean over rows of |x - its class center|^2 (x the
        layer's input features, labels one-hot), in float32 at least."""
        x = dtypes.promote_half(x)
        labels = dtypes.promote_half(labels)
        keep_float32(x)
        assigned = labels @ state["centers"]
        return 0.5 * torch.mean(torch.sum((x - assigned) ** 2, dim=-1))

    def update_centers(self, state, x, labels):
        """The state with each class's center moved by ``alpha`` toward
        the batch's mean of that class (classes absent keep theirs)."""
        dt = torch.promote_types(x.dtype, labels.dtype)
        x, labels = x.to(dt), labels.to(dt)
        keep_float32(x)
        counts = torch.sum(labels, dim=0)[:, None]
        sums = labels.T @ x
        if global_batch.active() is not None:
            # the global batch's class counts and sums
            both = global_batch.all_reduce_sum(
                torch.cat([counts, sums], dim=1))
            counts, sums = both[:, :1], both[:, 1:]
        mean_per_class = sums / torch.clamp(counts, min=1.0)
        centers = state["centers"]
        new = torch.where(counts > 0, (1 - self.alpha) * centers
                          + self.alpha * mean_per_class, centers)
        return {**state, "centers": new}
