"""Parameter-tree helpers (counterpart of
``deeplearning4j_tpu/util/tree.py``).

A tree is nested lists and dicts of tensors. Leaves are visited as
``jax.tree_util`` visits them (list items in order, dict keys sorted),
so a flat vector holds the same values, index for index, as the JAX
package's for the same params.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["tree_copy", "tree_to_device", "tree_flat_vector",
           "tree_from_flat_vector", "ordered_leaves", "flat_views",
           "substituted_params"]


def _sorted_leaves(tree):
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _sorted_leaves(v)
    else:
        yield tree


def tree_copy(tree):
    """Copies of every tensor leaf (detached, same device)."""
    if isinstance(tree, dict):
        return {k: tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_copy(v) for v in tree]
    return tree.detach().clone()


def tree_to_device(tree, device):
    """The tree with every tensor leaf moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_device(v, device) for v in tree]
    return tree.to(device)


def tree_flat_vector(tree) -> np.ndarray:
    """All leaves concatenated into one flat host vector (the
    reference's flat params view)."""
    leaves = [np.asarray(l.detach().cpu()).ravel()
              for l in _sorted_leaves(tree)]
    if not leaves:
        return np.zeros((0,))
    return np.concatenate(leaves)


def tree_from_flat_vector(tree, flat):
    """Inverse of :func:`tree_flat_vector`: a tree with the template's
    structure, shapes, dtypes and devices, filled from ``flat``."""
    flat = np.asarray(flat)
    off = 0

    def fill(t):
        nonlocal off
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [fill(v) for v in t]
        n = t.numel()
        out = torch.as_tensor(flat[off:off + n], dtype=t.dtype,
                              device=t.device).reshape(t.shape)
        off += n
        return out

    return fill(tree)


def ordered_leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's flat order."""
    return list(_sorted_leaves(tree))


def flat_views(flat: torch.Tensor, like) -> list:
    """Views of the flat vector ``flat``, one a tensor of ``like`` and of
    its shape, in order (the inverse of concatenating them)."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape))
        off += n
    return out


@contextmanager
def substituted_params(model, leaves):
    """Within the block, ``model.params`` holds ``leaves`` (tensors, in
    :func:`ordered_leaves` order, each of its parameter's shape) in
    place of the model's registered parameters, so the executors'
    ``_loss`` computes on them (of another dtype, or views of one flat
    vector that autograd differentiates). The live parameters are back
    on exit, untouched."""
    live = ordered_leaves(model.params)
    if len(live) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(live)} parameters")
    for p, t in zip(live, leaves):
        if t.shape != p.shape:
            raise ValueError(f"leaf of shape {tuple(t.shape)} for a "
                             f"parameter of {tuple(p.shape)}")
    by_id = {id(p): t for p, t in zip(live, leaves)}
    swapped = [(mod, name, p) for mod in model.modules()
               for name, p in mod._parameters.items()
               if p is not None and id(p) in by_id]
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = by_id[id(p)]
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p
