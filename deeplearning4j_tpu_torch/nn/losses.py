"""Loss function registry (counterpart of
``deeplearning4j_tpu/nn/losses.py``).

Every loss is ``fn(labels, preds, mask) -> per-example score``, averaged
to a scalar by the caller; ``mask`` is an optional broadcastable 0/1
tensor. As in the JAX package (and DL4J): losses take *post-activation*
output (MCXENT expects softmax output, XENT sigmoid output); per-output
scores are summed over the output dimensions and averaged over
examples. Output layers use a fused softmax/sigmoid cross entropy where
the activation and loss pair allows it (``output.py``).
"""

from __future__ import annotations

import torch

__all__ = ["get", "register", "LOSSES", "score"]

_EPS = 1e-10


def _reduce(per_output, mask):
    # sum over feature axes -> per-example score
    if mask is not None:
        per_output = per_output * mask
    return per_output.sum(dim=tuple(range(1, per_output.dim())))


def mcxent(labels, preds, mask=None):
    """Multi-class cross entropy against probabilities (post-softmax)."""
    return _reduce(-labels * torch.log(preds + _EPS), mask)


def negativeloglikelihood(labels, preds, mask=None):
    return mcxent(labels, preds, mask)


def xent(labels, preds, mask=None):
    """Binary cross entropy (post-sigmoid), summed over outputs."""
    p = torch.clamp(preds, _EPS, 1.0 - _EPS)
    return _reduce(-(labels * torch.log(p)
                     + (1 - labels) * torch.log1p(-p)), mask)


def mse(labels, preds, mask=None):
    # DL4J SQUARED_LOSS: mean over output dim of squared error
    d = (preds - labels) ** 2
    return _reduce(d, mask) / d.shape[-1]


def l2(labels, preds, mask=None):
    return _reduce((preds - labels) ** 2, mask)


def mae(labels, preds, mask=None):
    d = torch.abs(preds - labels)
    return _reduce(d, mask) / d.shape[-1]


def l1(labels, preds, mask=None):
    return _reduce(torch.abs(preds - labels), mask)


def hinge(labels, preds, mask=None):
    # labels in {-1, +1} or {0, 1} (converted)
    y = torch.where(labels > 0, 1.0, -1.0)
    return _reduce(torch.clamp(1.0 - y * preds, min=0.0), mask)


def squared_hinge(labels, preds, mask=None):
    y = torch.where(labels > 0, 1.0, -1.0)
    return _reduce(torch.clamp(1.0 - y * preds, min=0.0) ** 2, mask)


def kl_divergence(labels, preds, mask=None):
    p = torch.clamp(preds, _EPS, 1.0)
    t = torch.clamp(labels, _EPS, 1.0)
    return _reduce(labels * (torch.log(t) - torch.log(p)), mask)


def poisson(labels, preds, mask=None):
    return _reduce(preds - labels * torch.log(preds + _EPS), mask)


def cosine_proximity(labels, preds, mask=None):
    if mask is not None:
        labels = labels * mask
        preds = preds * mask
    ln = torch.linalg.vector_norm(labels, dim=-1)
    pn = torch.linalg.vector_norm(preds, dim=-1)
    out = -(labels * preds).sum(-1) / (ln * pn + _EPS)
    axes = tuple(range(1, out.dim()))
    return out.sum(dim=axes) if axes else out


def mean_squared_logarithmic_error(labels, preds, mask=None):
    d = (torch.log1p(torch.clamp(preds, min=-1 + _EPS))
         - torch.log1p(labels)) ** 2
    return _reduce(d, mask) / d.shape[-1]


def mean_absolute_percentage_error(labels, preds, mask=None):
    d = torch.abs((labels - preds) / (torch.abs(labels) + _EPS)) * 100.0
    return _reduce(d, mask) / d.shape[-1]


LOSSES = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "mse": mse,
    "squared_loss": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "msle": mean_squared_logarithmic_error,
    "mape": mean_absolute_percentage_error,
}


def register(name: str, fn) -> None:
    LOSSES[name.lower()] = fn


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]


def score(name, labels, preds, mask=None, average: bool = True):
    """Total (or mean) score, DL4J-style: sum of per-example scores / N."""
    per_ex = get(name)(labels, preds, mask)
    return per_ex.mean() if average else per_ex.sum()
