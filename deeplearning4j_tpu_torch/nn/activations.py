"""Activation function registry (counterpart of
``deeplearning4j_tpu/nn/activations.py``): name -> function on
tensors, with the JAX package's names and semantics. ``gelu`` is the
tanh approximation (``jax.nn.gelu``'s default); ``softmax`` is over the
last axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get", "ACTIVATIONS", "softmax"]


def softmax(x, dim=-1):
    return torch.softmax(x, dim=dim)


def _rational_tanh(x):
    # ND4J RationalTanh: 1.7159 * tanh_approx(2x/3)
    a = 2.0 * x / 3.0
    aa = a.abs()
    approx = torch.sign(a) * (1.0 - 1.0 / (1.0 + aa + a * a
                                           + 1.41645 * a ** 4))
    return 1.7159 * approx


ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rational_tanh,
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "softmax": softmax,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x ** 3,
    "threshold": lambda x: (x > 0).to(x.dtype),
}


def get(name):
    """Resolve an activation by name (or pass through a callable)."""
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
