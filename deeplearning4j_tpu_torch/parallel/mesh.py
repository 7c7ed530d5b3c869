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

Not here: JAX's ``data_sharding`` and ``replicated``. Under data
parallelism the parameters are replicated by construction (every rank
holds and updates its own full copy from the same reduced gradient)
and each rank is handed its own shard of the batch
(``multihost.local_batch_slice`` / ``per_host_iterator``), so there is
no placement to state. Meshes with a ``model``, ``pipe`` or ``seq``
axis above 1 wait for ROADMAP A6b.
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
    default group), shaped by ``spec``. Collective when a process group
    is up: every rank calls it with the same arguments."""
    ranks = list(devices if devices is not None
                 else range(device_count()))
    shape = spec.resolve(len(ranks))
    arr = np.array(ranks, dtype=np.int64).reshape(shape)
    group, host, backend = _groups(ranks)
    return Mesh(arr, group, host, backend)


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (the usable data-parallel degree
    over a survivor set: batch splits stay even and re-divisible)."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    return 1 << (n.bit_length() - 1)


def shrink_data_mesh(mesh: Mesh, lost) -> Mesh:
    """Shrink a pure data-parallel mesh over the ranks surviving
    ``lost`` (an iterable of ranks), at the largest power-of-two dp
    that fits: dp=8 with one rank lost becomes dp=4, over the first
    four survivors. Parameters are replicated over 'data', so every
    survivor holds a complete copy. Meshes that shard 'model', 'pipe'
    or 'seq' do not shrink (ROADMAP A6b). Collective, as
    :func:`build_mesh`."""
    for ax in ("model", "pipe", "seq"):
        if mesh.shape.get(ax, 1) > 1:
            raise NotImplementedError(
                f"elastic shrink supports data-parallel meshes; axis "
                f"{ax!r} has size {mesh.shape[ax]} (tensor, pipeline and "
                f"sequence parallelism wait for ROADMAP A6b)")
    lost = set(int(r) for r in lost)
    survivors = [r for r in mesh.ranks if r not in lost]
    if not survivors:
        raise RuntimeError("no surviving devices to shrink onto")
    dp = largest_pow2(len(survivors))
    return build_mesh(MeshSpec(data=dp), survivors[:dp])
