"""Core layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/core.py``): ``DenseLayer``,
``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer``, the
transformer LM's ``EmbeddingSequenceLayer`` and the pretraining layers
``RBM``, ``AutoEncoder`` and ``RecursiveAutoEncoder``. The dense product
casts its operands to the policy's compute dtype and its result to the
output dtype, as the JAX layer does; the float32 bias then promotes a
bf16 result back to float32. Products run with TF32 off on the card
(``device.keep_float32``).

A pretraining layer's ``pretrain_loss(params, x, generator)`` draws its
randomness (the RBM's CD-k Bernoulli hiddens, the AutoEncoder's
corruption mask) from a ``torch.Generator`` and hands it to a
deterministic loss (``_cd_loss``, ``_recon_loss``), which a parity test
calls with draws of its own: torch cannot replay ``jax.random``. Both
draw their uniforms through ``uniform_draws``, which a parity test
replaces to feed the two packages the same bits, as ``dropout_keep_mask``
does for dropout."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          FeedForwardLayer,
                                                          Layer,
                                                          register_layer)

__all__ = ["DenseLayer", "ActivationLayer", "DropoutLayer",
           "EmbeddingLayer", "EmbeddingSequenceLayer", "embedding_lookup",
           "RBM", "AutoEncoder", "RecursiveAutoEncoder", "uniform_draws"]


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
class EmbeddingLayer(FeedForwardLayer):
    """Id -> vector lookup: int ids of shape (B,) or (B, 1) give
    (B, n_out), then the bias and the activation."""

    def initialize(self, generator, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.flat_size()
        p = {"W": self._sample_w(generator, (self.n_in, self.n_out),
                                 self.n_in, self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtypes.policy().param_dtype)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        if x.dim() == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        y = embedding_lookup(params["W"], x)
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)


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


def uniform_draws(shape, generator, device) -> torch.Tensor:
    """U[0, 1) float32 draws from ``generator``: a Bernoulli(p) sample is
    ``u < p``, as ``jax.random.bernoulli`` draws it."""
    return torch.rand(shape, generator=generator, device=device)


def _affine(x, W, b):
    keep_float32(x)
    return x @ W + b


@register_layer
@dataclasses.dataclass
class RBM(FeedForwardLayer):
    """Restricted Boltzmann machine. The supervised forward is the
    hidden activations (sigmoid propup); pretraining is contrastive
    divergence: the free-energy difference F(x) - F(v~) with the CD-k
    reconstruction v~ held constant, whose gradient is the CD update."""

    k: int = 1                      # CD-k Gibbs steps
    activation: str = "sigmoid"
    visible_unit: str = "binary"    # 'binary' | 'gaussian'
    hidden_unit: str = "binary"

    def __post_init__(self):
        # the softplus free energy is that of sigmoid-binary hiddens
        if self.activation != "sigmoid":
            raise ValueError("RBM supports only sigmoid hidden "
                             "activation (free-energy objective)")
        if self.visible_unit not in ("binary", "gaussian"):
            raise ValueError(f"RBM visible_unit must be 'binary' or "
                             f"'gaussian', got '{self.visible_unit}'")
        if self.hidden_unit != "binary":
            raise ValueError(f"RBM hidden_unit supports only 'binary', "
                             f"got '{self.hidden_unit}'")

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        return {
            "W": self._sample_w(generator, (self.n_in, self.n_out),
                                self.n_in, self.n_out),
            "b": torch.full((self.n_out,), float(self.bias_init), dtype=pd),
            "vb": torch.zeros((self.n_in,), dtype=pd),
        }, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        return torch.sigmoid(_affine(x, params["W"], params["b"])), state

    def _free_energy(self, params, v):
        """F(v) = -v.vb - sum softplus(v W + b), one a row."""
        vis = torch.sum(v * params["vb"], dim=-1)
        hid = torch.sum(F.softplus(_affine(v, params["W"], params["b"])),
                        dim=-1)
        return -vis - hid

    def _gibbs(self, params, v, generator=None, h=None):
        """One Gibbs step v -> h -> v's mean. ``h``: the Bernoulli
        hidden sample, drawn from ``generator`` when not given."""
        ph = torch.sigmoid(_affine(v, params["W"], params["b"]))
        if h is None:
            h = (uniform_draws(ph.shape, generator, ph.device)
                 < ph).to(v.dtype)
        pv = _affine(h, params["W"].T, params["vb"])
        if self.visible_unit == "binary":
            pv = torch.sigmoid(pv)
        return pv

    def _cd_loss(self, params, x, v_model):
        """mean(F(x) - F(v_model)), v_model held constant."""
        return torch.mean(self._free_energy(params, x)
                          - self._free_energy(params, v_model.detach()))

    def pretrain_loss(self, params, x, generator):
        v_model = x
        with torch.no_grad():
            for _ in range(max(self.k, 1)):
                v_model = self._gibbs(params, v_model, generator)
        return self._cd_loss(params, x, v_model)

    def reconstruction_error(self, params, x, generator):
        recon = self._gibbs(params, x, generator)
        return torch.mean((x - recon) ** 2)


@register_layer
@dataclasses.dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder. The supervised forward encodes;
    pretraining corrupts the input (each value kept with probability
    1 - ``corruption_level``), encodes, decodes with the tied weights and
    scores the reconstruction of the clean input."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        return {
            "W": self._sample_w(generator, (self.n_in, self.n_out),
                                self.n_in, self.n_out),
            "b": torch.full((self.n_out,), float(self.bias_init), dtype=pd),
            "vb": torch.zeros((self.n_in,), dtype=pd),
        }, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        return self.activation_fn()(_affine(x, params["W"], params["b"])), \
            state

    def _recon_loss(self, params, x, keep=None):
        """The mean reconstruction loss of ``x`` from its corruption by
        the bool mask ``keep`` (None: uncorrupted)."""
        act = self.activation_fn()
        xc = x if keep is None else torch.where(keep, x, torch.zeros_like(x))
        h = act(_affine(xc, params["W"], params["b"]))
        recon = act(_affine(h, params["W"].T, params["vb"]))
        return torch.mean(losses_mod.get(self.loss)(x, recon, None))

    def pretrain_loss(self, params, x, generator):
        keep = None
        if self.corruption_level > 0 and generator is not None:
            keep = (uniform_draws(x.shape, generator, x.device)
                    < 1.0 - self.corruption_level)
        return self._recon_loss(params, x, keep)


@register_layer
@dataclasses.dataclass
class RecursiveAutoEncoder(FeedForwardLayer):
    """Recursive autoencoder over sequences: the code folds (B, T, C)
    left to right, each step encoding [carry; x_t] and reconstructing it
    from the code. The supervised forward is the final code (B, n_out);
    pretraining minimises the mean reconstruction loss over the steps.
    The fold is a Python loop over T of plain ops (the JAX layer's
    ``lax.scan``); a (B, T) 0/1 mask keeps the carry and drops the loss
    at padded steps, by ``torch.where``, with no host sync."""

    loss: str = "mse"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def set_n_in(self, input_type: InputType) -> None:
        self.n_in = input_type.size

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        z = self.n_out + self.n_in          # [carry; x_t]
        return {
            "W": self._sample_w(generator, (z, self.n_out), z, self.n_out),
            "b": torch.full((self.n_out,), float(self.bias_init), dtype=pd),
            "Wd": self._sample_w(generator, (self.n_out, z), self.n_out, z),
            "vb": torch.zeros((z,), dtype=pd),
        }, {}

    def _fold(self, params, x, mask=None):
        """x (B, T, C) -> (the final code (B, n_out), the mean
        reconstruction loss over the present steps)."""
        act = self.activation_fn()
        loss_fn = losses_mod.get(self.loss)
        B, T = x.shape[0], x.shape[1]
        h = torch.zeros((B, self.n_out), dtype=x.dtype, device=x.device)
        m = (torch.ones((B, T), dtype=x.dtype, device=x.device)
             if mask is None else mask.to(x.dtype))
        lsum = torch.zeros((), dtype=x.dtype, device=x.device)
        for t in range(T):
            mt = m[:, t]
            z = torch.cat([h, x[:, t]], dim=-1)
            code = act(_affine(z, params["W"], params["b"]))
            recon = act(_affine(code, params["Wd"], params["vb"]))
            h = torch.where(mt[:, None] > 0, code, h)
            per_ex = loss_fn(z, recon, None).reshape(B, -1).mean(dim=-1)
            lsum = lsum + torch.sum(per_ex * mt)
        return h, lsum / torch.clamp(torch.sum(m), min=1.0)

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        h, _ = self._fold(params, x, mask)
        return h, state

    def pretrain_loss(self, params, x, generator=None, mask=None):
        return self._fold(params, x, mask)[1]
