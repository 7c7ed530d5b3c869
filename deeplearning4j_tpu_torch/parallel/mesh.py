"""The data-parallel mesh over a ``torch.distributed`` process group
(counterpart of ``deeplearning4j_tpu/parallel/mesh.py``).

A JAX mesh is one device a mesh position, inside one process. Here one
mesh position is one RANK of a process group, and each rank drives one
device: ``device_count()`` is the group's world size, and a
:class:`Mesh` is a set of ranks shaped over the standard axes
(``data``, ``model``, ``pipe``, ``seq``) with the process group that
reduces over them.

Backend rule (:func:`choose_backend`): ``nccl`` when every rank has a
card of its own, ``gloo`` when two or more ranks share one card or the
model is on the CPU (NCCL refuses two ranks on one device; gloo takes
CUDA tensors and stages them through the host). The compute stays on
the device either way; the reduce's route is what differs. A group
asked for ``nccl`` that cannot be built raises: it is never rebuilt on
gloo behind the caller's back.

The rank grid is laid out in the JAX axis order: rank ``devices[d, m,
p, s]`` sits at data index d, model index m, pipe index p and seq
index s. :meth:`Mesh.axis_group` gives the process group over the ranks
that share this rank's position on every axis but the named ones (the
model group of tensor parallelism, the seq ring, the data x seq group
the gradients reduce over); every such group of every position is made
once, by every rank in the same order, and cached by its ranks.

Not here: JAX's ``data_sharding`` and ``replicated``. Each rank is
handed its own shard of the batch (``multihost.local_batch_slice``,
``MeshContext.local_shard``) and holds its own shard of the parameters
(replicated under data parallelism, sliced by the tensor-parallel rules
under ``model``), so there is no placement to state.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["MeshSpec", "Mesh", "build_mesh", "device_count",
           "shrink_data_mesh", "largest_pow2", "choose_backend", "AXES"]

AXES = ("data", "model", "pipe", "seq")


def device_count() -> int:
    """Ranks in the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def choose_backend(device, local_ranks: int = 1) -> str:
    """``nccl`` when each of the host's ``local_ranks`` ranks can have a
    card of its own, else ``gloo`` (ranks sharing a card, or a model on
    the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= max(1, int(local_ranks)):
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 on one axis means 'all remaining ranks'."""
    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1

    def resolve(self, n_devices: Optional[int] = None) -> Tuple[int, ...]:
        n = n_devices or device_count()
        dims = [self.data, self.model, self.pipe, self.seq]
        fixed = 1
        for d in dims:
            if d != -1:
                fixed *= d
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed mesh "
                             f"dims {dims}")
        return tuple(n // fixed if d == -1 else d for d in dims)


class Mesh:
    """Ranks shaped over :data:`AXES`, and the process groups over them:
    ``group`` for the gradient reduce (the backend rule's), and
    ``host_group`` (gloo) for the small host-side collectives a step
    needs before it runs (batch counts, mask totals). ``group`` is None
    when the mesh is one rank with no process group at all."""

    def __init__(self, ranks: np.ndarray, group=None, host_group=None,
                 backend: Optional[str] = None):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = AXES
        self.shape = dict(zip(AXES, self.devices.shape))
        self.group = group
        self.host_group = host_group
        self.backend = backend
        self._axis_groups: dict = {}

    @property
    def ranks(self) -> list:
        return [int(r) for r in self.devices.flat]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def contains(self, rank: Optional[int] = None) -> bool:
        return (_rank() if rank is None else rank) in self.ranks

    def group_rank(self, rank: Optional[int] = None) -> int:
        """This (or ``rank``'s) position in the mesh's flat rank list."""
        return self.ranks.index(_rank() if rank is None else rank)

    def coords(self, rank: Optional[int] = None) -> dict:
        """This (or ``rank``'s) index on each axis."""
        r = _rank() if rank is None else rank
        pos = np.argwhere(self.devices == r)
        if not len(pos):
            raise ValueError(f"rank {r} is not in {self!r}")
        return dict(zip(AXES, (int(i) for i in pos[0])))

    def axis_ranks(self, axes: Sequence[str],
                   rank: Optional[int] = None) -> list:
        """The ranks that share this (or ``rank``'s) index on every axis
        but ``axes``, in grid order (the first named axis slowest)."""
        c = self.coords(rank)
        idx = tuple(slice(None) if a in axes else c[a] for a in AXES)
        return [int(r) for r in self.devices[idx].flat]

    def axis_group(self, axes: Sequence[str]):
        """(process group, host group, ranks) over :meth:`axis_ranks`;
        (None, None, ranks) when that is one rank. The first call for a
        set of axes makes the groups of every position of the grid:
        collective, as :func:`build_mesh` (every rank calls it, in the
        same order)."""
        axes = tuple(axes)
        if axes not in self._axis_groups:
            by_pos = {}
            others = [a for a in AXES if a not in axes]
            shape = [self.shape[a] for a in others]
            for pos in np.ndindex(*shape):
                sel = dict(zip(others, pos))
                idx = tuple(slice(None) if a in axes else sel[a]
                            for a in AXES)
                ranks = [int(r) for r in self.devices[idx].flat]
                if len(ranks) > 1:
                    g, h, _ = _groups(ranks)
                else:
                    g = h = None
                by_pos[tuple(ranks)] = (g, h)
            self._axis_groups[axes] = by_pos
        ranks = self.axis_ranks(axes) if self.contains() else []
        g, h = self._axis_groups[axes].get(tuple(ranks), (None, None))
        return g, h, ranks

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; ranks {self.ranks}; {self.backend})"


# (reduce group, host group, backend) by tuple of ranks, for the default
# group they were made under: a mesh built again over the same ranks
# takes them from here, with no collective and no new connections
_GROUPS: dict = {"world": None, "by_ranks": {}}


def _groups(ranks: Sequence[int]):
    """(reduce group, host group, backend) over ``ranks``. The first
    time a set of ranks needs a new group, every rank of the default
    group must call this in the same order (``new_group`` is collective
    over it), members or not."""
    if not (dist.is_available() and dist.is_initialized()):
        if list(ranks) != [0]:
            raise ValueError(
                f"a mesh over ranks {list(ranks)} needs a process group: "
                "call parallel.multihost.initialize_distributed first")
        return None, None, None
    if _GROUPS["world"] is not dist.group.WORLD:
        _GROUPS["world"] = dist.group.WORLD
        _GROUPS["by_ranks"] = {}
    key = tuple(int(r) for r in ranks)
    if key in _GROUPS["by_ranks"]:
        return _GROUPS["by_ranks"][key]
    backend = dist.get_backend()
    world = dist.get_world_size()
    if list(key) == list(range(world)):
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(key), backend=backend)
    if backend == "gloo":
        host = group
    else:
        host = dist.new_group(list(key), backend="gloo")
    _GROUPS["by_ranks"][key] = (group, host, backend)
    return group, host, backend


def build_mesh(spec: MeshSpec = MeshSpec(),
               devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``devices`` (ranks; default every rank of the
    default group), shaped by ``spec``, with the process groups of its
    axes when it has a model, pipe or seq axis. Collective when a
    process group is up: every rank calls it with the same
    arguments."""
    ranks = list(devices if devices is not None
                 else range(device_count()))
    shape = spec.resolve(len(ranks))
    arr = np.array(ranks, dtype=np.int64).reshape(shape)
    group, host, backend = _groups(ranks)
    mesh = Mesh(arr, group, host, backend)
    if group is not None and any(mesh.shape[a] > 1
                                 for a in ("model", "pipe", "seq")):
        # every group a step of this mesh may use, made here while every
        # rank is in the call
        for axes in (("data", "seq"), ("data",), ("model",), ("seq",),
                     ("pipe",)):
            mesh.axis_group(axes)
    return mesh


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (the usable data-parallel degree
    over a survivor set: batch splits stay even and re-divisible)."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    return 1 << (n.bit_length() - 1)


def shrink_data_mesh(mesh: Mesh, lost) -> Mesh:
    """Shrink the DATA axis of a mesh over the ranks surviving ``lost``
    (an iterable of ranks), at the largest power-of-two dp that fits:
    dp=8 with one rank lost becomes dp=4, over the first four survivors.

    Two shapes shrink, as in the JAX package:

    - pure data-parallel: parameters are replicated over 'data', so
      every survivor holds a complete copy;
    - data x model (dp x tp): every dp ROW of the (data, model) grid
      holds one complete set of tp shards, so a lost rank costs its
      whole row, and the mesh rebuilds over the largest power-of-two
      count of intact rows, the tp axis kept.

    Meshes sharding 'pipe' or 'seq' do not shrink: that state died with
    the rank; restart from a checkpoint. Collective, as
    :func:`build_mesh`."""
    for ax in ("pipe", "seq"):
        if mesh.shape.get(ax, 1) > 1:
            raise NotImplementedError(
                f"elastic shrink supports data / data x model "
                f"meshes; axis {ax!r} has size {mesh.shape[ax]} — "
                "sharded state died with the device, restart from a "
                "checkpoint instead")
    lost = set(int(r) for r in lost)
    tp = mesh.shape.get("model", 1)
    if tp > 1:
        grid = mesh.devices.reshape(mesh.shape.get("data", 1), tp)
        rows = [[int(r) for r in row] for row in grid
                if not any(int(r) in lost for r in row)]
        if not rows:
            raise RuntimeError("no intact dp row survives the loss")
        dp = largest_pow2(len(rows))
        return build_mesh(MeshSpec(data=dp, model=tp),
                          [r for row in rows[:dp] for r in row])
    survivors = [r for r in mesh.ranks if r not in lost]
    if not survivors:
        raise RuntimeError("no surviving devices to shrink onto")
    dp = largest_pow2(len(survivors))
    return build_mesh(MeshSpec(data=dp), survivors[:dp])
