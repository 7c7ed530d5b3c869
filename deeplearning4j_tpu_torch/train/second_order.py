"""Second-order / line-search optimization algorithms (counterpart of
``deeplearning4j_tpu/train/second_order.py``).

The reference's OptimizationAlgorithm enum (nn/api/
OptimizationAlgorithm.java:26) lists STOCHASTIC_GRADIENT_DESCENT,
LINE_GRADIENT_DESCENT, CONJUGATE_GRADIENT, and LBFGS, driven by
BackTrackLineSearch (optimize/solvers/BackTrackLineSearch.java) over
the flat parameter view: full-batch optimizers over the executor's flat
parameter vector, for both executors.

The flat vector, the gradient, the search directions and the L-BFGS
(s, y) history stay on the network's device as float32 tensors; only
the scalars (dot products, losses) reach the host, as in the JAX
package, whose solver loop does the same bookkeeping around its jitted
oracle. The oracle is autograd over views of one flat device vector
substituted for the live parameters (``util/tree.substituted_params``):
on a card each evaluation is a forward and backward through the
network's kernels (the transformer LM's three flash-attention kernels),
run eagerly. At the LM's 105M parameters a vector is 420 MB, and
``history=10`` holds twenty of them.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.util.tree import (flat_views, ordered_leaves,
                                                substituted_params)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["BackTrackLineSearch", "optimize", "lbfgs", "conjugate_gradient",
           "line_gradient_descent"]


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def _maximum(a: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.clamp(a, min=floor)


def _flat_oracle(net, ds) -> Tuple[Callable, torch.Tensor]:
    """(value_and_grad, x0) of a model and a full batch: ``x0`` the
    parameters as one float32 vector on the network's device, in the
    JAX flat order; ``value_and_grad(flat)`` -> (the loss as a device
    scalar, its gradient as a flat device vector), dropout off."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    if isinstance(net, ComputationGraph):
        batch = net._batch_tuple(net._as_multi(ds))
    else:
        batch = net._batch_tuple(ds)
    live = ordered_leaves(net.params)

    def value_and_grad(flat):
        flat = flat.detach().requires_grad_(True)
        with substituted_params(net, flat_views(flat, live)):
            loss, _ = net._loss(batch, training=False)
        grad, = torch.autograd.grad(loss, flat)
        return loss.detach(), grad

    x0 = torch.cat([p.detach().reshape(-1) for p in live]).to(torch.float32)
    return value_and_grad, x0


class BackTrackLineSearch:
    """Armijo backtracking (optimize/solvers/BackTrackLineSearch.java:
    sufficient-decrease condition with geometric step shrink)."""

    def __init__(self, c1: float = 1e-4, shrink: float = 0.5,
                 max_steps: int = 20, initial_step: float = 1.0):
        self.c1 = c1
        self.shrink = shrink
        self.max_steps = max_steps
        self.initial_step = initial_step

    def search(self, value_and_grad, x, f0, g0, direction):
        """Returns (step, x_new, f_new, g_new, ok)."""
        d_dot_g = float(_vdot(direction, g0))
        if d_dot_g >= 0:       # not a descent direction
            return 0.0, x, f0, g0, False
        step = self.initial_step
        for _ in range(self.max_steps):
            x_new = x + step * direction
            f_new, g_new = value_and_grad(x_new)
            if float(f_new) <= float(f0) + self.c1 * step * d_dot_g:
                return step, x_new, f_new, g_new, True
            step *= self.shrink
        return 0.0, x, f0, g0, False


def line_gradient_descent(value_and_grad, x0, *, iterations: int = 100,
                          tol: float = 1e-8,
                          line_search: Optional[BackTrackLineSearch]
                          = None):
    """LINE_GRADIENT_DESCENT: steepest descent + line search."""
    ls = line_search or BackTrackLineSearch()
    x = x0
    f, g = value_and_grad(x)
    history = [float(f)]
    for _ in range(iterations):
        step, x, f, g, ok = ls.search(value_and_grad, x, f, g, -g)
        history.append(float(f))
        if not ok or abs(history[-2] - history[-1]) < tol:
            break
    return x, history


def conjugate_gradient(value_and_grad, x0, *, iterations: int = 100,
                       tol: float = 1e-8,
                       line_search: Optional[BackTrackLineSearch] = None):
    """CONJUGATE_GRADIENT (Polak-Ribière with automatic restart,
    optimize/solvers/ConjugateGradient.java)."""
    ls = line_search or BackTrackLineSearch()
    x = x0
    f, g = value_and_grad(x)
    d = -g
    history = [float(f)]
    for it in range(iterations):
        step, x, f_new, g_new, ok = ls.search(value_and_grad, x, f, g, d)
        history.append(float(f_new))
        if not ok or abs(float(f) - float(f_new)) < tol:
            break
        # Polak-Ribière beta; restart on non-descent / every n dims
        beta = float(_vdot(g_new, g_new - g)
                     / _maximum(_vdot(g, g), 1e-20))
        beta = max(beta, 0.0)                      # PR+
        d = -g_new + beta * d
        if float(_vdot(d, g_new)) >= 0:
            d = -g_new                             # restart
        f, g = f_new, g_new
    return x, history


def lbfgs(value_and_grad, x0, *, iterations: int = 100, history: int = 10,
          tol: float = 1e-8,
          line_search: Optional[BackTrackLineSearch] = None):
    """LBFGS (optimize/solvers/LBFGS.java): limited-memory two-loop
    recursion over (s, y) pairs + backtracking line search."""
    ls = line_search or BackTrackLineSearch()
    x = x0
    f, g = value_and_grad(x)
    S: List = []
    Y: List = []
    losses = [float(f)]
    for it in range(iterations):
        # two-loop recursion
        q = g
        alphas = []
        for s, y in zip(reversed(S), reversed(Y)):
            rho = 1.0 / float(_maximum(_vdot(y, s), 1e-20))
            a = rho * float(_vdot(s, q))
            alphas.append((a, rho, s, y))
            q = q - a * y
        if S:
            s, y = S[-1], Y[-1]
            gamma = float(_vdot(s, y)
                          / _maximum(_vdot(y, y), 1e-20))
            q = gamma * q
        for (a, rho, s, y) in reversed(alphas):
            b = rho * float(_vdot(y, q))
            q = q + (a - b) * s
        d = -q
        step, x_new, f_new, g_new, ok = ls.search(value_and_grad, x, f,
                                                  g, d)
        losses.append(float(f_new))
        if not ok:
            # fall back to steepest descent once before giving up
            step, x_new, f_new, g_new, ok = ls.search(
                value_and_grad, x, f, g, -g)
            if not ok:
                break
        S.append(x_new - x)
        Y.append(g_new - g)
        if len(S) > history:
            S.pop(0)
            Y.pop(0)
        if abs(float(f) - float(f_new)) < tol:
            x, f, g = x_new, f_new, g_new
            break
        x, f, g = x_new, f_new, g_new
    return x, losses


_ALGOS = {"lbfgs": lbfgs,
          "conjugate_gradient": conjugate_gradient,
          "line_gradient_descent": line_gradient_descent}


def optimize(net, ds, *, algorithm: str = "lbfgs",
             iterations: int = 100, **kw) -> List[float]:
    """Full-batch second-order fit of a model in place (the Solver
    facade for non-SGD OptimizationAlgorithm values): the result is
    copied into the live parameters (the updater state is kept).
    Returns the loss history."""
    if algorithm not in _ALGOS:
        raise ValueError(f"Unknown algorithm '{algorithm}'; "
                         f"choose from {sorted(_ALGOS)}")
    value_and_grad, x0 = _flat_oracle(net, ds)
    x, history = _ALGOS[algorithm](value_and_grad, x0,
                                   iterations=iterations, **kw)
    live = ordered_leaves(net.params)
    with torch.no_grad():
        for p, v in zip(live, flat_views(x, live)):
            p.copy_(v)
    logger.info("%s: %d evals, loss %.6f -> %.6f", algorithm,
                len(history), history[0], history[-1])
    return history
