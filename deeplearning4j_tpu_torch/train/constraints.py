"""Parameter constraints: post-update projections (counterpart of
``deeplearning4j_tpu/train/constraints.py``).

MaxNorm, MinMaxNorm, NonNegative and UnitNorm, applied after each
updater step to a layer's weight params ("W"-like keys of two or more
dimensions; biases only with ``apply_to_biases``). Config form:
``{"type": "max_norm", "max_norm": 2.0}`` in a layer's ``constraints``.
"""

from __future__ import annotations

import torch

__all__ = ["apply_constraint", "apply_layer_constraints"]

_EPS = 1e-8


def _norms(w, axis):
    return torch.sqrt((w * w).sum(dim=axis, keepdim=True))


def apply_constraint(w, cfg: dict):
    t = cfg["type"]
    # norm over all axes but the last (output dim), the reference's
    # convention for dense/conv weights
    axis = tuple(range(w.dim() - 1)) or (0,)
    if t == "max_norm":
        n = _norms(w, axis)
        target = torch.clamp(n, max=cfg.get("max_norm", 2.0))
        return w * target / (n + _EPS)
    if t == "min_max_norm":
        lo = cfg.get("min_norm", 0.0)
        hi = cfg.get("max_norm", 2.0)
        rate = cfg.get("rate", 1.0)
        n = _norms(w, axis)
        clipped = torch.clamp(n, lo, hi)
        return w * (rate * clipped / (n + _EPS) + (1 - rate))
    if t == "non_negative":
        return torch.clamp(w, min=0.0)
    if t == "unit_norm":
        return w / (_norms(w, axis) + _EPS)
    raise ValueError(f"Unknown constraint type '{t}'")


def apply_layer_constraints(layer_cfg, layer_params: dict) -> dict:
    """The layer's constraints over its top-level params, as new
    tensors (a dict of the same keys)."""
    if not getattr(layer_cfg, "constraints", None):
        return layer_params
    out = dict(layer_params)
    for cfg in layer_cfg.constraints:
        apply_b = cfg.get("apply_to_biases", False)
        apply_w = cfg.get("apply_to_weights", True)
        for k, v in out.items():
            is_bias = k in ("b", "vb", "beta")
            if (is_bias and apply_b) or (not is_bias and apply_w
                                         and v.dim() >= 2):
                out[k] = apply_constraint(v, cfg)
    return out
