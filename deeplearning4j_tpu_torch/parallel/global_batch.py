"""Global-batch semantics for a data-parallel step.

The JAX package's ``fit(mesh_spec="dp=N")`` is one GSPMD program over
the global batch, so every statistic over the batch is global. The
port's ranks each hold a shard; while a data-parallel training step
runs, :func:`scope` makes the step's :class:`MeshContext` visible to the
layers, which then take their batch statistics over the mesh:

- batch norm's training mean and ``E[x²] − E[x]²`` from all-reduced
  float32 sums (:func:`all_reduce_sum`, whose backward all-reduces the
  cotangent, so the gradient flows through the statistics of every
  shard);
- center loss's class counts and class sums (no gradient);
- a masked recurrent loss's denominator: the global mask total of the
  step's output, computed on the host before the step
  (:func:`mask_total`).

"The mesh" is the data x seq group of the step's ``MeshContext``: the
ranks of one model group (tensor parallelism) hold the same rows.

:func:`reduce_gradients` is the executors' hook between the backward
and gradient normalization: the loss and every gradient as one flat
float32 bucket, all-reduced and averaged. Outside a scope (one device,
or the compressed step, which keeps local statistics as the JAX
package's ``shard_map`` step does) all of these are identities.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

__all__ = ["scope", "active", "set_output", "mask_total", "all_reduce_sum",
           "world", "reduce_gradients", "flatten_bucket", "unflatten_bucket"]


class _Step:
    __slots__ = ("ctx", "totals", "output")

    def __init__(self, ctx, totals):
        self.ctx = ctx
        self.totals = totals
        self.output = 0


# the step in scope, per thread: a model that trains on another thread
# (a parameter-server worker, a server's warmup) is outside it
_LOCAL = threading.local()


@contextlib.contextmanager
def scope(ctx, totals: Optional[torch.Tensor] = None):
    """The layers and :func:`reduce_gradients` see ``ctx`` (a
    ``MeshContext``, or None for a no-op scope) on this thread for the
    duration; ``totals``: the step's global mask total of each
    output. A mesh with a seq axis also installs its ring
    (``seq_context.sequence_parallel_gspmd``)."""
    prev = active()
    _LOCAL.step = None if ctx is None else _Step(ctx, totals)
    try:
        if ctx is not None and ctx.plan.sp > 1:
            from deeplearning4j_tpu_torch.parallel.seq_context import (
                sequence_parallel_gspmd)
            with sequence_parallel_gspmd(ctx):
                yield
        else:
            yield
    finally:
        _LOCAL.step = prev


def active() -> Optional[_Step]:
    """This thread's data-parallel step, or None."""
    return getattr(_LOCAL, "step", None)


def set_output(i: int) -> None:
    """The graph executor names the output whose loss comes next."""
    step = active()
    if step is not None:
        step.output = i


def mask_total(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """The global mask total of the current output, or None outside a
    data-parallel step."""
    step = active()
    if step is None or step.totals is None:
        return None
    return step.totals[step.output].to(mask.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh_ctx):
        ctx.mesh_ctx = mesh_ctx
        y = x.clone()
        mesh_ctx.all_reduce_(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh_ctx.all_reduce_(g)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active step's mesh, differentiably (the
    backward sums the cotangent over the mesh too); ``x`` itself
    outside a step."""
    step = active()
    if step is None:
        return x
    return _AllReduceSum.apply(x, step.ctx)


def world() -> int:
    step = active()
    return 1 if step is None else step.ctx.world


def flatten_bucket(loss: torch.Tensor, leaves) -> torch.Tensor:
    """The loss and the gradient leaves as one flat float32 vector."""
    return torch.cat([loss.reshape(1).float()]
                     + [g.reshape(-1).float() for g in leaves])


def unflatten_bucket(bucket: torch.Tensor, templates):
    """(loss, [gradient leaves]) back from :func:`flatten_bucket`'s
    layout, each leaf in its template's shape and dtype."""
    out, off = [], 1
    for t in templates:
        n = t.numel()
        out.append(bucket[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return bucket[0], out


def reduce_gradients(loss, grads):
    """Inside a data-parallel step: (the mean loss, the mean gradients)
    over the mesh, through one all-reduced float32 bucket. Else the
    arguments unchanged."""
    step = active()
    if step is None or step.ctx.group is None:
        return loss, grads
    from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod
    leaves = list(updaters_mod.tree_leaves(grads))
    bucket = flatten_bucket(loss, leaves)
    step.ctx.all_reduce_(bucket)
    bucket = bucket / step.ctx.world
    loss_r, reduced = unflatten_bucket(bucket, leaves)
    it = iter(reduced)
    return loss_r.to(loss.dtype), updaters_mod.tree_map(
        lambda _: next(it), grads)

