"""Sequence-parallel context (counterpart of
``deeplearning4j_tpu/parallel/seq_context.py``).

When a step trains over a mesh with a ``seq`` axis, each rank holds
the LOCAL time chunk of every (B, T, ...) activation: rank i of the seq
ring holds steps ``[i * T/n, (i + 1) * T/n)``. Layers whose math spans
timesteps must then compute over the distributed sequence rather than
their chunk. This module is the signal: the executors' step activates
it, and

- ``SelfAttentionLayer.apply`` routes through the ring
  (``parallel/ring_attention.ring_self_attention``) over
  :func:`current_seq_axis`;
- ``RnnOutputLayer``'s masked loss divides by the mask total over
  :func:`current_loss_axes` (the ranks the batch is split over), times
  their count, so the mean of the ranks' losses is the global masked
  mean;
- ``GlobalPoolingLayer`` pools its chunk, then combines over the ring,
  so every rank holds the pool of the whole sequence.

The JAX package has two modes: a manual ``shard_map`` step
(``sequence_parallel``) and a GSPMD step with ring islands
(``sequence_parallel_gspmd``, which lets seq compose with tensor
parallelism). The port has one process a rank and writes every
collective out, so there is one mode: :func:`sequence_parallel_gspmd`
installs the same state as :func:`sequence_parallel`, from a mesh
context that may also carry data and model axes.

The state is per thread: only the thread that runs the step sees it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.collectives import RankGroup

__all__ = ["sequence_parallel", "sequence_parallel_gspmd",
           "current_seq_axis", "current_seq_mesh", "current_loss_axes",
           "seq_sum", "seq_max"]

_tls = threading.local()


def current_seq_axis() -> Optional[RankGroup]:
    """The seq ring the time dimension is split over, or None."""
    return getattr(_tls, "axis", None)


def current_seq_mesh():
    """The mesh context of the active sequence-parallel step (None
    outside one, or when the ring was installed without one)."""
    return getattr(_tls, "mesh", None)


def current_loss_axes() -> Optional[RankGroup]:
    """The ranks the BATCH is split over (data x seq), or None outside
    a sequence-parallel step: a masked time-distributed loss sums its
    mask over them and scales by their count, so the mean of the
    ranks' losses is the global masked mean."""
    return getattr(_tls, "loss_axes", None)


@contextlib.contextmanager
def _install(axis, loss_axes, mesh):
    prev = (getattr(_tls, "axis", None), getattr(_tls, "loss_axes", None),
            getattr(_tls, "mesh", None))
    _tls.axis, _tls.loss_axes, _tls.mesh = axis, loss_axes, mesh
    try:
        yield
    finally:
        _tls.axis, _tls.loss_axes, _tls.mesh = prev


def sequence_parallel(axis_name: RankGroup, loss_axes=None):
    """Route the layers over the ring ``axis_name`` (a :class:`RankGroup`)
    for the duration; ``loss_axes``: the :class:`RankGroup` the batch is
    split over (default: the ring itself)."""
    return _install(axis_name, loss_axes if loss_axes is not None
                    else axis_name, None)


def sequence_parallel_gspmd(mesh, axis_name: str = "seq"):
    """The same routing from a ``MeshContext`` (``mesh``) whose mesh
    has a seq axis, and possibly data and model axes too: the ring is
    its seq group, the loss axes its data x seq group. ``axis_name``
    must be ``"seq"`` (the JAX signature's axis)."""
    if axis_name != "seq":
        raise ValueError(f"the port's rings run over the 'seq' axis, "
                         f"not {axis_name!r}")
    return _install(mesh.seq_group(), mesh.loss_group(), mesh)


# ---- the ring's reductions, differentiable: every rank holds the
#      combined value, so the cotangent of it is summed over the ring

class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return collectives.all_reduce_(x.contiguous().clone(), grp,
                                       kind="seq")

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_(g.contiguous().clone(), ctx.grp,
                                       kind="seq"), None


class _SeqMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        y = collectives.all_reduce_(x.contiguous().clone(), grp, op="max",
                                    kind="seq")
        ctx.grp = grp
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, g):
        (won,) = ctx.saved_tensors
        g = collectives.all_reduce_(g.contiguous().clone(), ctx.grp,
                                    kind="seq")
        return g * won.to(g.dtype), None


def seq_sum(x, grp: RankGroup):
    """``x`` summed over the ring (forward and, for the cotangent,
    backward); ``x`` itself on a ring of one."""
    if grp is None or grp.size == 1:
        return x
    return _SeqSum.apply(x, grp)


def seq_max(x, grp: RankGroup):
    """The elementwise max of ``x`` over the ring; the gradient goes to
    the ranks that hold the max."""
    if grp is None or grp.size == 1:
        return x
    return _SeqMax.apply(x, grp)
