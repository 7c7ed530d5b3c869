"""Per-layer gradient normalization (counterpart of
``deeplearning4j_tpu/train/gradnorm.py``).

The reference's GradientNormalization modes: RenormalizeL2PerLayer,
RenormalizeL2PerParamType, ClipElementWiseAbsoluteValue, ClipL2PerLayer,
ClipL2PerParamType. Applied to the raw gradients of each layer before
the updater, where the reference applies it. Under tensor parallelism
(the update inside ``tensor_parallel.sharded_norms``) the L2 norms are
the full arrays', as the JAX package's GSPMD takes them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel import tensor_parallel

__all__ = ["normalize_layer_gradients", "apply_gradient_normalization"]

_EPS = 1e-8


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _global_norm(tree, dims):
    return torch.sqrt(tensor_parallel.tree_sq_sum(tree, dims) + _EPS)


def _leaf_norm(g, dim):
    return torch.sqrt(tensor_parallel.sq_sum(g, dim)) + _EPS


def normalize_layer_gradients(grads, kind: str, threshold: float,
                              dims=None):
    """grads: one layer's param dict. Returns the transformed dict.
    ``dims``: the split dim of each of its tensor-parallel shards (a
    dict like ``grads``), None when the layer is whole."""
    k = (kind or "").lower()
    if not k or k == "none":
        return grads
    split = dims if dims is not None else dict.fromkeys(grads)
    if k == "renormalize_l2_per_layer":
        n = _global_norm(grads, dims)
        return _map(lambda g: g / n, grads)
    if k == "renormalize_l2_per_param_type":
        return {key: g / _leaf_norm(g, split[key])
                for key, g in grads.items()}
    if k == "clip_element_wise_absolute_value":
        return _map(lambda g: torch.clamp(g, -threshold, threshold), grads)
    if k == "clip_l2_per_layer":
        scale = torch.clamp(threshold / _global_norm(grads, dims), max=1.0)
        return _map(lambda g: g * scale, grads)
    if k == "clip_l2_per_param_type":
        out = {}
        for key, g in grads.items():
            n = _leaf_norm(g, split[key])
            out[key] = g * torch.clamp(threshold / n, max=1.0)
        return out
    raise ValueError(f"Unknown gradient normalization '{kind}'")


def apply_gradient_normalization(layers, grads):
    """Each layer's configured normalization on its grad dict.
    ``layers``: layer configs, a list (a network's) or a dict by vertex
    name (a graph's); ``grads``: the matching list or dict of per-layer
    dicts. Under ``tensor_parallel.sharded_norms`` the norms are the
    full arrays'."""
    dims = tensor_parallel.norm_dims()

    def one(key, cfg, g):
        kind = getattr(cfg, "gradient_normalization", None)
        if kind:
            g = normalize_layer_gradients(
                g, kind,
                getattr(cfg, "gradient_normalization_threshold", 1.0),
                None if dims is None else dims[key])
        return g

    if isinstance(grads, dict):
        return {name: one(name, layers[name], g)
                for name, g in grads.items()}
    return [one(i, cfg, g) for i, (cfg, g) in enumerate(zip(layers, grads))]
