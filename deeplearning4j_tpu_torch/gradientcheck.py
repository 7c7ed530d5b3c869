"""Gradient checking: central differences against autograd (counterpart
of ``deeplearning4j_tpu/gradientcheck.py``).

Mirrors gradientcheck/GradientCheckUtil.java (the backbone of the
reference's test strategy): the numerical gradient (C(w+ε) − C(w−ε)) /
2ε against the analytic gradient for every parameter, or a seeded
subset. It validates the whole loss pipeline (layer math, masking,
regularization, the fused cross-entropy paths) against autograd.

Runs in float64 on the network's own device (the card by default), with
the JAX package's eps and error limits. The parameters, the layers'
state and the batch are float64 copies; the dtype policy is float64
throughout, and float64 attention takes its plain formulation on either
device (``ops/attention.py``: the kernels are float32). The analytic
gradient is autograd's over the float64 copy, never a captured training
step (whose buffers are float32). The flat order is the JAX package's
(``util/tree.py``), so ``subset=n, seed=s`` draws the same parameters
(``np.random.default_rng(seed).choice``) in both packages. The perturbed
losses stay on the device until the loop ends and are read at once.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn.conf import updaters
from deeplearning4j_tpu_torch.util.tree import (flat_views, ordered_leaves,
                                                substituted_params)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["check_gradients", "check_gradients_graph", "flat_loss",
           "gradient_check_report"]

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-3
DEFAULT_MIN_ABS_ERROR = 1e-8

_F64 = dtypes.Policy(torch.float64, torch.float64, torch.float64)


def _rel_error(a: float, n: float, min_abs: float) -> float:
    if abs(a - n) < min_abs:
        return 0.0
    denom = abs(a) + abs(n)
    return abs(a - n) / denom if denom > 0 else 0.0


def _f64(a, device):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


@contextmanager
def _state(net, state):
    """``net.state`` is ``state`` within the block. Through the private
    slot: the ``state`` setter copies the tree and drops the model's
    captured training programs, which a check must not do."""
    saved, net._state = net._state, state
    try:
        yield
    finally:
        net._state = saved


def flat_loss(net, ds):
    """(flat0, loss_of) of a network and a full batch, in float64 on the
    network's device: ``flat0`` every parameter in the JAX flat order,
    ``loss_of(flat)`` the training loss (dropout off, as ``_loss(...,
    training=False)``) at the parameters ``flat``, differentiable in
    ``flat``. Works for both executors (a DataSet or MultiDataSet for a
    ComputationGraph)."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    dev = net.device
    if isinstance(net, ComputationGraph):
        mds = net._as_multi(ds)
        batch = (tuple(_f64(f, dev) for f in mds.features),
                 tuple(_f64(y, dev) for y in mds.labels), None, None)
    else:
        batch = tuple(_f64(a, dev) for a in (
            ds.features, ds.labels, ds.features_mask, ds.labels_mask))
    live = ordered_leaves(net.params)
    flat0 = torch.cat([p.detach().to(torch.float64).reshape(-1)
                       for p in live])
    state64 = updaters.tree_map(
        lambda t: (t.detach().to(torch.float64)
                   if isinstance(t, torch.Tensor) and t.is_floating_point()
                   else t), net.state)

    def loss_of(flat):
        with substituted_params(net, flat_views(flat, live)), \
                _state(net, state64), dtypes.policy_scope(_F64):
            loss, _ = net._loss(batch, training=False)
        return loss

    return flat0, loss_of


def _run_subset_check(loss_of, flat0, idx, eps, max_rel, min_abs,
                      print_all) -> dict:
    flat = flat0.clone().requires_grad_(True)
    grad = torch.autograd.grad(loss_of(flat), flat)[0]
    analytic = grad.cpu().numpy()
    losses = []
    with torch.no_grad():
        for i in idx:
            fp = flat0.clone()
            fp[int(i)] += eps
            fm = flat0.clone()
            fm[int(i)] -= eps
            losses.append(torch.stack([loss_of(fp), loss_of(fm)]))
    losses = torch.stack(losses).cpu().numpy() if losses else []
    fails = 0
    max_rel_seen = 0.0
    for i, (lp, lm) in zip(idx, losses):
        num = (float(lp) - float(lm)) / (2 * eps)
        rel = _rel_error(float(analytic[i]), num, min_abs)
        max_rel_seen = max(max_rel_seen, rel)
        if rel > max_rel:
            fails += 1
            if print_all or fails <= 10:
                logger.warning(
                    "param %d FAILED: analytic=%.8g numeric=%.8g rel=%.4g",
                    i, float(analytic[i]), num, rel)
    logger.info("gradient check (%d params): %d failures, max rel %.4g",
                len(idx), fails, max_rel_seen)
    return {"ok": fails == 0, "params": len(idx), "failures": fails,
            "max_rel_error": max_rel_seen}


def gradient_check_report(net, ds, *, eps: float = DEFAULT_EPS,
                          max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                          min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                          print_all: bool = False,
                          subset: Optional[int] = None,
                          seed: int = 0) -> dict:
    """The check of either executor with its figures: ``{"ok",
    "params" (checked), "failures", "max_rel_error"}``."""
    flat0, loss_of = flat_loss(net, ds)
    n = flat0.shape[0]
    if subset is not None and subset < n:
        idx = np.random.default_rng(seed).choice(n, subset, replace=False)
    else:
        idx = np.arange(n)
    return _run_subset_check(loss_of, flat0, idx, eps, max_rel_error,
                             min_abs_error, print_all)


def check_gradients(net, ds, *, eps: float = DEFAULT_EPS,
                    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                    print_all: bool = False,
                    subset: Optional[int] = None,
                    seed: int = 0) -> bool:
    """Check a MultiLayerNetwork's d(loss)/d(params).

    ``subset``: check only N randomly chosen parameters (the reference
    checks all; tiny nets keep 'all' feasible, subset makes larger
    configs tractable).
    """
    return gradient_check_report(
        net, ds, eps=eps, max_rel_error=max_rel_error,
        min_abs_error=min_abs_error, print_all=print_all, subset=subset,
        seed=seed)["ok"]


def check_gradients_graph(cg, mds, *, eps: float = DEFAULT_EPS,
                          max_rel_error: float = DEFAULT_MAX_REL_ERROR,
                          min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
                          subset: Optional[int] = None,
                          seed: int = 0) -> bool:
    """Check a ComputationGraph (reference GradientCheckUtil :276)."""
    return gradient_check_report(
        cg, mds, eps=eps, max_rel_error=max_rel_error,
        min_abs_error=min_abs_error, subset=subset, seed=seed)["ok"]
