"""Special layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/special.py``): ``FrozenLayer``,
``VariationalAutoencoder`` and ``Yolo2OutputLayer``.

- ``FrozenLayer`` wraps any layer: its params are detached (the JAX
  layer's ``stop_gradient``; the executors turn the missing gradients
  into zeros, so the updater moves nothing) and the inner layer runs
  with ``training=False``. Transfer learning's feature extractor
  creates it.
- ``VariationalAutoencoder``: MLP encoder -> diagonal-Gaussian latent ->
  MLP decoder -> a reconstruction distribution ('bernoulli',
  'gaussian', 'exponential'). The supervised forward is the encoder's
  mean; pretraining minimises the negative ELBO. The reparameterised
  draws come from ``normal_draws`` on a ``torch.Generator`` (a parity
  test replaces that function) or are given (``eps``).
- ``Yolo2OutputLayer``: the YOLOv2 loss over anchor-box grid
  predictions, in float32 at least.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          Layer,
                                                          layer_from_dict,
                                                          register_layer)
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["FrozenLayer", "VariationalAutoencoder", "Yolo2OutputLayer",
           "normal_draws"]


def normal_draws(shape, generator, device) -> torch.Tensor:
    """Standard-normal float32 draws from ``generator``."""
    return torch.randn(shape, generator=generator, device=device)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


@register_layer
@dataclasses.dataclass
class FrozenLayer(Layer):
    """A layer whose params receive no updates; it runs in inference
    mode (no dropout, batch-norm statistics not updated)."""

    inner: Optional[dict] = None

    def __post_init__(self):
        if isinstance(self.inner, Layer):
            self._inner = self.inner
            self.inner = self._inner.to_dict()
        elif self.inner is not None:
            self._inner = layer_from_dict(self.inner)
        else:
            self._inner = None

    @property
    def wrapped(self) -> Layer:
        return self._inner

    def set_n_in(self, input_type: InputType) -> None:
        self._inner.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return self._inner.output_type(input_type)

    def initialize(self, generator, input_type: InputType):
        p, s = self._inner.initialize(generator, input_type)
        self.inner = self._inner.to_dict()
        return p, s

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        return self._inner.apply(_detached(params), state, x, training=False,
                                 generator=generator, mask=mask)

    def has_loss(self):
        return self._inner.has_loss()

    def to_dict(self) -> dict:
        return {"@type": "FrozenLayer", "name": self.name,
                "dropout": self.dropout, "inner": self.inner}


def _mlp_init(generator, sizes, weight_init, dtype):
    return [{"W": init_weight(generator, (nin, nout), weight_init, nin, nout,
                              dtype=dtype),
             "b": torch.zeros((nout,), dtype=dtype)}
            for nin, nout in zip(sizes[:-1], sizes[1:])]


def _linear(x, lay):
    keep_float32(x)
    return x @ lay["W"] + lay["b"]


def _mlp_apply(layers, x, act):
    for lay in layers:
        x = act(_linear(x, lay))
    return x


@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """``encoder_layer_sizes`` / ``decoder_layer_sizes`` are the hidden
    MLPs, ``n_out`` the latent size, ``num_samples`` the Monte Carlo
    draws of the ELBO."""

    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    reconstruction_distribution: str = "bernoulli"
    pzx_activation: str = "identity"
    num_samples: int = 1
    activation: str = "tanh"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        pd = dtypes.policy().param_dtype
        enc_sizes = (self.n_in,) + tuple(self.encoder_layer_sizes)
        dec_sizes = (self.n_out,) + tuple(self.decoder_layer_sizes)
        eh, dh = enc_sizes[-1], dec_sizes[-1]
        # gaussian reconstruction: a mean and a log-variance a unit
        rec_out = (2 * self.n_in
                   if self.reconstruction_distribution == "gaussian"
                   else self.n_in)

        def dense(nin, nout):
            return {"W": init_weight(generator, (nin, nout),
                                     self.weight_init, nin, nout, dtype=pd),
                    "b": torch.zeros((nout,), dtype=pd)}
        return {
            "enc": _mlp_init(generator, enc_sizes, self.weight_init, pd),
            "mu": dense(eh, self.n_out),
            "logvar": dense(eh, self.n_out),
            "dec": _mlp_init(generator, dec_sizes, self.weight_init, pd),
            "out": dense(dh, rec_out),
        }, {}

    def _encode(self, params, x):
        h = _mlp_apply(params["enc"], x, self.activation_fn())
        return _linear(h, params["mu"]), _linear(h, params["logvar"])

    def _decode(self, params, z):
        h = _mlp_apply(params["dec"], z, self.activation_fn())
        return _linear(h, params["out"])

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        mu, _ = self._encode(params, x)
        return activations.get(self.pzx_activation)(mu), state

    def _reconstruction_logprob(self, dec_out, x):
        d = self.reconstruction_distribution
        if d == "bernoulli":
            p = torch.sigmoid(dec_out)
            eps = 1e-7
            return torch.sum(x * torch.log(p + eps)
                             + (1 - x) * torch.log(1 - p + eps), dim=-1)
        if d == "gaussian":
            mean, logvar = torch.chunk(dec_out, 2, dim=-1)
            var = torch.exp(logvar)
            return torch.sum(-0.5 * (math.log(2 * math.pi) + logvar
                                     + (x - mean) ** 2 / var), dim=-1)
        if d == "exponential":
            lam = torch.exp(torch.clamp(dec_out, -20, 20))
            return torch.sum(torch.log(lam) - lam * x, dim=-1)
        raise ValueError(f"Unknown reconstruction distribution '{d}'")

    def _draws(self, n, rows, generator, device):
        """n draws of the (rows, n_out) latent noise."""
        return torch.stack([normal_draws((rows, self.n_out), generator,
                                         device) for _ in range(n)])

    def _elbo(self, params, x, eps):
        """The negative ELBO (mean over the batch) with the
        reparameterisation noise ``eps`` (num_samples, B, n_out) given."""
        x = dtypes.promote_half(x)
        mu, logvar = self._encode(params, x)
        kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar),
                              dim=-1)
        rec = 0.0
        for e in eps:
            z = mu + torch.exp(0.5 * logvar) * e
            rec = rec + self._reconstruction_logprob(self._decode(params, z),
                                                     x)
        rec = rec / len(eps)
        return torch.mean(kl - rec)

    def pretrain_loss(self, params, x, generator):
        """The negative ELBO, Monte Carlo over ``num_samples`` draws."""
        return self._elbo(params, x, self._draws(
            self.num_samples, x.shape[0], generator, x.device))

    def reconstruction_probability(self, params, x, generator=None,
                                   num_samples=5, *, eps=None):
        """Monte Carlo estimate of log p(x) a row (anomaly scores)."""
        mu, logvar = self._encode(params, x)
        if eps is None:
            eps = self._draws(num_samples, x.shape[0], generator, x.device)
        logps = torch.stack([
            self._reconstruction_logprob(
                self._decode(params, mu + torch.exp(0.5 * logvar) * e), x)
            for e in eps])
        return torch.logsumexp(logps, dim=0) - math.log(float(len(eps)))

    def generate(self, params, z):
        """The visible-space means decoded from latent samples ``z``."""
        dec_out = self._decode(params, z)
        if self.reconstruction_distribution == "bernoulli":
            return torch.sigmoid(dec_out)
        if self.reconstruction_distribution == "gaussian":
            return torch.chunk(dec_out, 2, dim=-1)[0]
        return torch.exp(torch.clamp(dec_out, -20, 20))


@register_layer
@dataclasses.dataclass
class Yolo2OutputLayer(Layer):
    """YOLOv2 output: input (B, H, W, A*(5+C)) conv activations, labels
    of the same layout; ``anchors`` (A, 2) prior box sizes in grid
    units. The loss: coordinate SSE (sqrt w/h, ``lambda_coord``),
    object / no-object confidence SSE, class cross entropy."""

    anchors: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5

    def __post_init__(self):
        self.anchors = tuple(tuple(float(v) for v in a) for a in self.anchors)

    def has_loss(self):
        return True

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    @staticmethod
    def _split(y):
        """(B, H, W, A, 5+C) -> sigmoid xy offsets, raw wh, sigmoid
        confidence, class logits."""
        return (torch.sigmoid(y[..., 0:2]), y[..., 2:4],
                torch.sigmoid(y[..., 4]), y[..., 5:])

    def _anchors(self, like):
        """The anchors as a tensor on ``like``'s device and dtype, made
        once for each (a host-to-device copy cannot run inside a
        captured training step; the eager run before a capture makes
        it)."""
        cache = self.__dict__.setdefault("_anchor_cache", {})
        key = (like.device, like.dtype)
        if key not in cache:
            # a normal tensor even when first made under inference mode
            # (``output``), so a later training step can save it
            with torch.inference_mode(False):
                cache[key] = torch.tensor(self.anchors, dtype=like.dtype,
                                          device=like.device)
        return cache[key]

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        b, h, w, c = x.shape
        a = len(self.anchors)
        y = x.reshape(b, h, w, a, c // a)
        xy, wh, conf, cls = self._split(y)
        wh = torch.exp(torch.clamp(wh, -10, 10)) * self._anchors(x)
        out = torch.cat([xy, wh, conf[..., None],
                         torch.softmax(cls, dim=-1)], dim=-1)
        return out.reshape(b, h, w, c), state

    def loss_from_input(self, params, x, labels, *, training=False,
                        generator=None, mask=None):
        x = dtypes.promote_half(x)
        labels = dtypes.promote_half(labels)
        b, h, w, c = x.shape
        a = len(self.anchors)
        y = x.reshape(b, h, w, a, c // a)
        t = labels.reshape(b, h, w, a, c // a)
        xy, wh_raw, conf, cls = self._split(y)
        wh = torch.exp(torch.clamp(wh_raw, -10, 10)) * self._anchors(x)
        t_xy, t_wh, t_obj, t_cls = (t[..., 0:2], t[..., 2:4], t[..., 4],
                                    t[..., 5:])
        coord = torch.sum(
            t_obj[..., None] * ((xy - t_xy) ** 2
                                + (torch.sqrt(wh + 1e-8)
                                   - torch.sqrt(t_wh + 1e-8)) ** 2),
            dim=-1)
        obj_loss = t_obj * (conf - 1.0) ** 2
        noobj_loss = (1.0 - t_obj) * conf ** 2
        cls_loss = -torch.sum(t_cls * F.log_softmax(cls, dim=-1),
                              dim=-1) * t_obj
        total = (self.lambda_coord * coord + obj_loss
                 + self.lambda_no_obj * noobj_loss + cls_loss)
        return torch.mean(torch.sum(total, dim=(1, 2, 3)))
