"""Per-layer gradient normalization (counterpart of
``deeplearning4j_tpu/train/gradnorm.py``).

The reference's GradientNormalization modes: RenormalizeL2PerLayer,
RenormalizeL2PerParamType, ClipElementWiseAbsoluteValue, ClipL2PerLayer,
ClipL2PerParamType. Applied to the raw gradients of each layer before
the updater, where the reference applies it.
"""

from __future__ import annotations

import torch

__all__ = ["normalize_layer_gradients", "apply_gradient_normalization"]

_EPS = 1e-8


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _global_norm(tree):
    return torch.sqrt(sum((g * g).sum() for g in _leaves(tree)) + _EPS)


def normalize_layer_gradients(grads, kind: str, threshold: float):
    """grads: one layer's param dict. Returns the transformed dict."""
    k = (kind or "").lower()
    if not k or k == "none":
        return grads
    if k == "renormalize_l2_per_layer":
        n = _global_norm(grads)
        return _map(lambda g: g / n, grads)
    if k == "renormalize_l2_per_param_type":
        return {key: g / (torch.sqrt((g * g).sum()) + _EPS)
                for key, g in grads.items()}
    if k == "clip_element_wise_absolute_value":
        return _map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if k == "clip_l2_per_layer":
        scale = torch.clamp(threshold / _global_norm(grads), max=1.0)
        return _map(lambda g: g * scale, grads)
    if k == "clip_l2_per_param_type":
        out = {}
        for key, g in grads.items():
            n = torch.sqrt((g * g).sum()) + _EPS
            out[key] = g * torch.clamp(threshold / n, max=1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{kind}'")


def apply_gradient_normalization(layers, grads):
    """Each layer's configured normalization on its grad dict.
    ``layers``: layer configs, a list (a network's) or a dict by vertex
    name (a graph's); ``grads``: the matching list or dict of per-layer
    dicts."""
    def one(cfg, g):
        kind = getattr(cfg, "gradient_normalization", None)
        if kind:
            g = normalize_layer_gradients(
                g, kind,
                getattr(cfg, "gradient_normalization_threshold", 1.0))
        return g

    if isinstance(grads, dict):
        return {name: one(layers[name], g) for name, g in grads.items()}
    return [one(cfg, g) for cfg, g in zip(layers, grads)]
