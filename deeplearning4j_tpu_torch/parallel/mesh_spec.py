"""Declarative mesh specs -> the executors' data-parallel fit path
(counterpart of ``deeplearning4j_tpu/parallel/mesh_spec.py``).

A spec (``"dp=4"``, a ``{"dp": 4}`` dict, or JSON) is parsed and
checked exactly as in the JAX package (:class:`MeshPlan`,
:func:`parse_mesh_spec`), then resolved against the process group into
a :class:`MeshContext`: the ranks, the reduce group and its backend,
and the collectives a data-parallel step needs.

What a JAX ``fit(mesh_spec="dp=N")`` is, and how the port keeps it: the
JAX step is one GSPMD program over the global batch, so every
statistic over the batch is global. Here each of the N ranks holds its
own shard of the global batch (``multihost.local_batch_slice``) and a
replica of the parameters, and one step

- trims every rank's shard to the shortest (an all-reduced count; a
  step where any shard is empty is dropped on every rank);
- computes the global mask totals of masked recurrent losses before it
  runs (they depend on the batch alone), so a rank's loss is
  ``sum(per_local) * N / max(global sum(mask), 1)``;
- computes batch-norm statistics and center-loss class means from
  all-reduced sums (``parallel/global_batch.py``), with the gradient
  flowing back through the all-reduce;
- all-reduces the gradients and the loss as ONE flat float32 bucket
  and averages it, between the backward and gradient normalization:
  clipping, normalization and the updater run on the global gradient,
  and every rank applies the same bucket, so the replicas stay equal
  bit for bit.

How the reduce runs on a card (``models/kstep.py``): under ``nccl``
the all-reduce is captured in the window's CUDA graph; under ``gloo``
(ranks sharing a card) every step runs eagerly and its bucket is
all-reduced through the host, because gloo's collectives cannot be
captured. :meth:`MeshContext.describe` says which.

``tp`` (tensor parallelism) composes with ``dp`` here: the bucket
reduces over the data axis alone (the ranks of one model group hold
different shards), and :meth:`MeshContext.place_model` slices each
rank's shards out of the broadcast full parameters by the tensor-
parallel rules (``parallel/tensor_parallel.py``). ``sp`` (sequence
parallelism) trains through ``ParallelWrapper`` (``allow_sp=True``
here): the bucket reduces over data x seq, and the step runs under the
ring (``parallel/seq_context.py``). ``pp`` meshes raise and point to
``parallel/pipeline_spmd.py``, as the JAX package's do.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, MeshSpec, _rank,
                                                    build_mesh, device_count)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["MeshPlan", "parse_mesh_spec", "MeshContext",
           "resolve_mesh_spec", "build_mesh_context", "LAUNCH_RECIPE"]

_KEYS = ("dp", "tp", "pp", "sp")

LAUNCH_RECIPE = (
    "launch one process a rank with DL4J_TPU_COORDINATOR=HOST:PORT "
    "DL4J_TPU_NUM_PROCESSES=N DL4J_TPU_PROCESS_ID=i (or torchrun "
    "--nproc-per-node N), then call "
    "parallel.multihost.initialize_distributed() (the README "
    "'Data-parallel training' recipe)")
PP_ROUTE = (
    "pp (pipeline) meshes do not run through the single-program fit "
    "path — the GPipe schedule needs the staged executor in "
    "parallel/pipeline_spmd.py (NetworkSpmdPipeline, one rank a "
    "stage); drop pp from the spec or use that module directly")
SP_ROUTE = (
    "sp (sequence-parallel) meshes train through ParallelWrapper's "
    "sequence-parallel step (per batch: the ring's rotations do not "
    "compose with the fused k-step windows): build the mesh with "
    "parallel.mesh.build_mesh(MeshSpec(seq=...)) and wrap the model in "
    "ParallelWrapper, or drop sp from the spec")


class MeshPlan:
    """A parsed, validated mesh spec: one int per axis, product
    checked against the visible device count at resolve time."""

    __slots__ = ("dp", "tp", "pp", "sp")

    def __init__(self, dp: int = 1, tp: int = 1, pp: int = 1,
                 sp: int = 1):
        for k, v in (("dp", dp), ("tp", tp), ("pp", pp), ("sp", sp)):
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ValueError(
                    f"mesh spec axis {k!r} must be a positive int; "
                    f"got {v!r}")
        self.dp, self.tp, self.pp, self.sp = (int(dp), int(tp),
                                              int(pp), int(sp))

    def n_devices(self) -> int:
        return self.dp * self.tp * self.pp * self.sp

    def to_mesh_spec(self) -> MeshSpec:
        return MeshSpec(data=self.dp, model=self.tp, pipe=self.pp,
                        seq=self.sp)

    def describe(self) -> dict:
        """JSON-able shape summary (the /healthz + /metrics form)."""
        return {"spec": str(self),
                "axes": {"dp": self.dp, "tp": self.tp,
                         "pp": self.pp, "sp": self.sp},
                "devices": self.n_devices()}

    def __str__(self) -> str:
        parts = [f"{k}={getattr(self, k)}" for k in _KEYS
                 if getattr(self, k) > 1]
        return ",".join(parts) or "dp=1"

    def __repr__(self) -> str:
        return f"MeshPlan({str(self)})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, MeshPlan)
                and all(getattr(self, k) == getattr(other, k)
                        for k in _KEYS))


def parse_mesh_spec(spec) -> MeshPlan:
    """``"dp=4,tp=2"`` | ``{"dp": 4, "tp": 2}`` | JSON text |
    :class:`MeshPlan` → validated :class:`MeshPlan`. Unknown keys
    and non-positive sizes fail loudly — a typo'd axis silently
    training single-device would be the worst outcome."""
    if isinstance(spec, MeshPlan):
        return spec
    if isinstance(spec, str):
        text = spec.strip()
        if text.startswith("{"):
            try:
                spec = json.loads(text)
            except json.JSONDecodeError as e:
                raise ValueError(f"mesh spec is not valid JSON: {e}")
        else:
            spec = {}
            for part in filter(None,
                               (p.strip() for p in text.split(","))):
                key, sep, val = part.partition("=")
                if not sep:
                    raise ValueError(
                        f"mesh spec entry {part!r} is not KEY=N "
                        f"(expected e.g. 'dp=4,tp=2')")
                try:
                    spec[key.strip()] = int(val)
                except ValueError:
                    raise ValueError(
                        f"mesh spec axis {key.strip()!r} has "
                        f"non-integer size {val!r}")
    if not isinstance(spec, dict):
        raise TypeError(
            f"mesh spec must be a 'dp=4,tp=2' string, a dict, or "
            f"JSON; got {type(spec).__name__}")
    unknown = sorted(set(spec) - set(_KEYS))
    if unknown:
        raise ValueError(
            f"unknown mesh spec axis(es) {unknown}; valid axes are "
            f"{list(_KEYS)} (dp=data, tp=tensor, pp=pipeline, "
            f"sp=sequence)")
    return MeshPlan(**{k: spec.get(k, 1) for k in _KEYS})


def _flat(tensors):
    return torch.cat([t.reshape(-1).float() for t in tensors])


class MeshContext:
    """A resolved mesh for one model: the plan, the
    :class:`~deeplearning4j_tpu_torch.parallel.mesh.Mesh` (ranks and
    groups), this rank's place in it, and the step's collectives.

    The gradient bucket, the batch trim and the mask totals reduce over
    the data x seq group of this rank (:meth:`loss_group`; ``world`` is
    its size); tensor parallelism runs over :meth:`model_group`, the
    ring over :meth:`seq_group`, a pipeline over :meth:`pipe_group`."""

    def __init__(self, plan: MeshPlan, mesh: Mesh):
        self.plan = plan
        self.mesh = mesh
        self.member = mesh.contains()
        self.rank = mesh.group_rank() if self.member else -1
        self.backend = mesh.backend
        self._groups = {}
        loss = self.loss_group()
        self.world = loss.size
        self.group = loss.group
        self.host_group = loss.host_group
        # the dropout offset: the ranks of one model group draw the same
        # masks (their activations are replicas), the others their own
        self.data_rank = loss.index if self.member else -1

    def _axis(self, axes) -> RankGroup:
        """The :class:`RankGroup` over ``axes`` through this rank."""
        axes = tuple(axes)
        if axes not in self._groups:
            if not self.member:
                self._groups[axes] = RankGroup(None, None, [], 0,
                                              self.backend)
            else:
                g, h, ranks = self.mesh.axis_group(axes)
                if len(ranks) == self.mesh.size:
                    g, h = self.mesh.group, self.mesh.host_group
                self._groups[axes] = RankGroup(
                    g, h, ranks, ranks.index(_rank()), self.backend)
        return self._groups[axes]

    def loss_group(self) -> RankGroup:
        """The ranks the batch is split over: data x seq."""
        return self._axis(("data", "seq"))

    def data_group(self) -> RankGroup:
        return self._axis(("data",))

    def model_group(self) -> RankGroup:
        return self._axis(("model",))

    def seq_group(self) -> RankGroup:
        return self._axis(("seq",))

    def pipe_group(self) -> RankGroup:
        return self._axis(("pipe",))

    def local_shard(self, a, *, temporal: bool = True):
        """This rank's part of a GLOBAL batch array: its data index's
        rows and, under sequence parallelism with ``temporal``, its seq
        index's chunk of axis 1 (time). What each rank feeds a step."""
        c = self.mesh.coords()
        dp, sp = self.plan.dp, self.plan.sp
        n = a.shape[0]
        if n % dp:
            raise ValueError(f"batch of {n} rows is not divisible by "
                             f"dp={dp}")
        a = a[c["data"] * (n // dp):(c["data"] + 1) * (n // dp)]
        if sp > 1 and temporal:
            t = a.shape[1]
            if t % sp:
                raise ValueError(f"{t} timesteps are not divisible by "
                                 f"sp={sp}")
            a = a[:, c["seq"] * (t // sp):(c["seq"] + 1) * (t // sp)]
        return a

    @staticmethod
    def from_mesh(mesh: Mesh) -> "MeshContext":
        shape = dict(mesh.shape)
        plan = MeshPlan(dp=shape.get("data", 1), tp=shape.get("model", 1),
                        pp=shape.get("pipe", 1), sp=shape.get("seq", 1))
        return MeshContext(plan, mesh)

    def same_as(self, other: "MeshContext") -> bool:
        return (self.plan == other.plan
                and self.mesh.ranks == other.mesh.ranks)

    def eager_steps(self, device) -> bool:
        """Whether a step on ``device`` runs eagerly instead of as a
        captured CUDA graph: under gloo on a card (its collectives
        cannot be captured), and under sequence parallelism (the ring's
        sends are per batch)."""
        return (torch.device(device).type == "cuda"
                and self.mesh.group is not None
                and (self.backend != "nccl" or self.plan.sp > 1))

    def reduce_route(self, model=None, device=None) -> str:
        """Which step design a model's captured training takes here."""
        dev = torch.device(device if device is not None
                           else getattr(model, "device", "cpu"))
        if self.mesh.group is None:
            return "one rank: no collective"
        if dev.type != "cuda":
            return f"{self.backend}: eager steps on the CPU"
        if self.backend == "nccl" and not self.eager_steps(dev):
            return "nccl: all-reduce captured in the window's CUDA graph"
        if self.backend == "nccl":
            return ("nccl: eager steps (the ring's sends run per batch), "
                    "collectives on the device")
        return ("gloo: eager steps, the bucket all-reduced through the "
                "host (gloo's collectives cannot be captured)")

    def describe(self, model=None) -> dict:
        out = self.plan.describe()
        out.update({"ranks": self.mesh.ranks, "backend": self.backend,
                    "rank": self.rank,
                    "reduce": self.reduce_route(model)})
        tp = getattr(model, "_tp", None)
        if tp is not None:
            out["tensor_parallel"] = tp.describe()
        return out

    # ---- placement ----
    def place_model(self, model, src: Optional[int] = None, *,
                    training: bool = True) -> None:
        """Make every rank's model equal to rank ``src``'s (default the
        mesh's first rank): parameters, layer state and updater state
        broadcast from it; then, under ``tp``, each rank keeps its shards
        of the parameters and the updater state
        (``tensor_parallel.shard_model``). A model placed on an earlier
        mesh is gathered back to full parameters first (collective over
        that mesh's model group). A model placed to train under ``tp``
        is refused first, on every rank alike, when its update takes a
        norm over split parameters
        (``tensor_parallel.refuse_norm_updates``).
        Each rank's dropout generator is offset by its index in the
        data x seq group (JAX folds the axis index into the key), so the
        shards draw different masks and the ranks of one model group the
        same."""
        from deeplearning4j_tpu_torch.parallel import tensor_parallel
        if model.params is None:
            model.init()
        if not self.member:
            return
        if training and self.plan.tp > 1:
            tensor_parallel.refuse_norm_updates(model)
        tensor_parallel.unshard_model(model)
        if self.mesh.group is not None and self.mesh.size > 1:
            src = self.mesh.ranks[0] if src is None else src
            leaves = [t for t in _tree_tensors(
                (model.params, model.state, model.opt_state))]
            self.broadcast(leaves, src)
        if self.plan.tp > 1:
            tensor_parallel.shard_model(model, self.model_group())
        if model._generator is not None and self.data_rank > 0:
            model._generator.manual_seed(
                int(model.conf.conf.seed) + self.data_rank)

    def broadcast(self, leaves, src: int) -> None:
        """Copy ``src``'s values of ``leaves`` into every member's of the
        mesh, as one flat float32 buffer (integer leaves are counters;
        ``collectives.broadcast_``, under ``STATS["dp"]``)."""
        if not leaves:
            return
        m = self.mesh
        grp = RankGroup(m.group, m.host_group, m.ranks,
                        m.ranks.index(_rank()), self.backend)
        with torch.no_grad():
            flat = _flat(leaves)
            collectives.broadcast_(flat, grp, m.ranks.index(src),
                                   kind="dp")
            off = 0
            for t in leaves:
                n = t.numel()
                t.copy_(flat[off:off + n].reshape(t.shape).to(t.dtype))
                off += n

    # ---- host-side collectives, before a step ----
    def host_all_reduce(self, values, op="sum") -> np.ndarray:
        """All-reduce a small host array over the mesh (on the host
        group: no device sync)."""
        a = np.asarray(values, dtype=np.float64)
        if self.group is None or self.world == 1:
            return a
        t = torch.from_numpy(a.copy())
        dist.all_reduce(t, op=(dist.ReduceOp.MIN if op == "min"
                               else dist.ReduceOp.SUM),
                        group=self.mesh.host_group)
        return t.numpy()

    # ---- the gradient bucket ----
    def all_reduce_(self, bucket: torch.Tensor) -> torch.Tensor:
        """Sum ``bucket`` over the mesh's data x seq group in place
        (``collectives.all_reduce_``: on a card under gloo through one
        pinned host buffer; its bytes and seconds under
        ``STATS["dp"]``). A mesh of one rank in a process group still
        calls the collective, so dp=1 runs the route dp=N does."""
        return collectives.all_reduce_(bucket, self.loss_group(),
                                       kind="dp")

    def barrier(self) -> None:
        if self.mesh.group is not None and self.mesh.size > 1:
            dist.barrier(group=self.mesh.host_group)


def _tree_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def resolve_mesh_spec(mesh_spec, devices: Optional[Sequence[int]] = None,
                      *, allow_sp: bool = False):
    """(the validated :class:`MeshPlan`, the ranks its mesh takes: the
    first ``n_devices()`` of ``devices``, default every rank of the
    process group). ``pp`` raises and points to
    ``parallel/pipeline_spmd.py``; ``sp`` raises unless ``allow_sp`` and
    points to ``ParallelWrapper``, as the JAX package routes them. No
    collective."""
    plan = parse_mesh_spec(mesh_spec)
    if plan.pp > 1:
        raise NotImplementedError(PP_ROUTE)
    if plan.sp > 1 and not allow_sp:
        raise NotImplementedError(SP_ROUTE)
    ranks = (list(devices) if devices is not None
             else list(range(device_count())))
    need = plan.n_devices()
    if need > len(ranks):
        raise ValueError(
            f"mesh spec {plan} needs {need} device(s) but only "
            f"{len(ranks)} rank(s) are in the process group — "
            f"{LAUNCH_RECIPE}")
    return plan, ranks[:need]


def build_mesh_context(mesh_spec, model=None,
                       devices: Optional[Sequence[int]] = None,
                       *, allow_sp: bool = False) -> MeshContext:
    """Parse + validate ``mesh_spec`` against the process group's ranks
    and build the :class:`MeshContext` over the first ``n_devices()`` of
    them (``devices``: the ranks to use, default all). Collective the
    first time a subset of the group (or, under nccl, any set) is
    meshed, and when the mesh has a model or seq axis (its groups are
    made): every rank calls it."""
    plan, ranks = resolve_mesh_spec(mesh_spec, devices, allow_sp=allow_sp)
    mesh = build_mesh(plan.to_mesh_spec(), ranks)
    ctx = MeshContext(plan, mesh)
    logger.info("mesh spec %s resolved over ranks %s, backend %s; %s",
                plan, mesh.ranks, mesh.backend,
                ctx.reduce_route(model))
    return ctx
