"""ParallelWrapper: data-parallel training over a process group
(counterpart of ``deeplearning4j_tpu/parallel/wrapper.py``).

The JAX wrapper shards one global batch over a device mesh and lets
GSPMD insert the gradient ``psum``. Here each rank of the mesh
(``parallel/mesh.py``: one process, one device) is given its own shard
of every batch, holds a replica of the parameters, and runs the model's
own data-parallel step (``use_mesh``: batch statistics over the global
batch, one all-reduced bucket of loss and gradients, the same update on
every rank; ``parallel/mesh_spec.py``). ``fit_batches`` runs k-step
windows through the model's captured programs.

Equivalences to the reference, as in the JAX package: AVERAGING mode
-> an all-reduce every step (``averaging_frequency`` warns and is
ignored); ``workers(n)`` -> the mesh's data axis over the first n ranks;
``prefetchBuffer`` -> ``AsyncDataSetIterator``; SHARED_GRADIENTS'
threshold encoding -> ``dcn_compression``: the per-rank step of the JAX
package's ``shard_map`` (local batch statistics; the local gradients
over the rank count through ``compression.make_compressed_psum_ef``
with a float32 error-feedback residual a rank; the layer state's
floats averaged and integers maxed over the ranks; the loss averaged).

ELASTIC MESH SHRINK: the ``parallel.device`` chaos site is consulted
before every step (``crash`` raises; ``loss`` loses the rank at
``args.device``, default the last), and :meth:`lose_device` is the
programmatic entry. Every rank installs the same seeded plan, so every
rank sees the fault at the same step; all of them build the new group
over the survivors at the largest power of two (``dist.new_group`` is
collective over the default group), and the lost rank, with any
survivor beyond the power of two, leaves the loop: its ``fit_batch``
trains nothing until a regrow. Survivors keep their own shards, so the
global batch shrinks with the mesh (the JAX wrapper re-splits one
global batch instead). :meth:`regrow` rebuilds over the ranks that were
there at the start (every rank calls it) and broadcasts the current
parameters and updater state from a survivor. Counted as
``elastic_mesh_{shrinks,regrows}_total`` and recorded by the flight
recorder. The compression residual re-zeroes on a rebuild, as in JAX.

TENSOR AND SEQUENCE MESHES: a mesh with a ``model`` axis places the
model's shards by the tensor-parallel rules
(``MeshContext.place_model``); its bucket reduces over the data axis.
A mesh with a ``seq`` axis runs the JAX wrapper's sequence-parallel step
(``_validate_seq_model`` first: every layer must be exact on a local
time chunk, or collapse time through a pooling layer): each rank is
given its data index's rows and its seq index's chunk of time
(``MeshContext.local_shard``), the step runs under the ring
(``parallel/seq_context.py``: attention over the whole sequence, the
masked loss over the global mask total, pooling combined over the
ring), and the bucket reduces over data x seq. data x model x seq
composes both. A seq step runs per batch and eagerly (the ring's sends
are not captured); with ``dcn_compression`` the seq part of the
gradient reduces in full precision first and the data part through the
int8 reduce, as the JAX wrapper compresses the data axis alone. Pipe
meshes raise and point to ``parallel/pipeline_spmd.py``. A shrink of a
data x model mesh drops every dp row that lost a rank
(``mesh.shrink_data_mesh``): the shards are gathered back to full
parameters over the old model groups first, and placed again over the
new mesh.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator,
                                                     DataSetIterator)
from deeplearning4j_tpu_torch.nn.conf.updaters import tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (Mesh, MeshSpec,
                                                    build_mesh, largest_pow2,
                                                    shrink_data_mesh)
from deeplearning4j_tpu_torch.parallel.mesh_spec import (PP_ROUTE,
                                                         MeshContext)

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ParallelWrapper", "GraphParallelWrapper"]

# what is exact on a local time chunk (the JAX layers' and vertices'
# ``seq_parallelizable``), and what collapses time with a collective
_SEQ_POINTWISE = {"DenseLayer", "ActivationLayer", "DropoutLayer",
                  "EmbeddingSequenceLayer", "RnnOutputLayer",
                  "SelfAttentionLayer", "TransformerEncoderLayer",
                  "LayerNormalization", "ElementWiseVertex", "MergeVertex",
                  "SubsetVertex", "ScaleVertex", "ShiftVertex"}
_SEQ_COLLAPSES = {"GlobalPoolingLayer"}


class ParallelWrapper:
    def __init__(self, model, mesh: Optional[Mesh] = None,
                 prefetch_buffer: int = 2,
                 dcn_compression: Optional[dict] = None):
        """``dcn_compression``: None for the full-precision all-reduce
        (the default), or ``{"threshold": t}`` for the int8 + threshold
        + error-feedback reduce (the reference's SharedTrainingMaster /
        EncodingHandler threshold encoding)."""
        self.model = model
        self.mesh = mesh if mesh is not None else build_mesh(MeshSpec())
        if self.mesh.shape.get("pipe", 1) > 1:
            raise NotImplementedError(PP_ROUTE)
        if dcn_compression is not None and (
                self.mesh.shape.get("model", 1) > 1
                or (self.mesh.shape.get("seq", 1) > 1
                    and self.mesh.shape.get("data", 1) == 1)):
            # the int8 reduce runs over the data axis alone
            raise NotImplementedError(
                "dcn_compression composes with 'data' x 'seq' meshes of "
                f"dp > 1; this mesh is {self.mesh.shape}")
        self._seq_collapses = False
        if self.mesh.shape.get("seq", 1) > 1:
            self._validate_seq_model()
        self.prefetch = prefetch_buffer
        self.dcn_compression = dcn_compression
        self._residual = None
        self._ctx: Optional[MeshContext] = None
        # elastic bookkeeping: the ranks the wrapper was built over (the
        # regrow target) and the ranks declared lost so far
        self._initial_ranks = self.mesh.ranks
        self._initial_dp = self.mesh.shape.get("data", 1)
        self._lost: set = set()
        self.mesh_shrinks = 0
        self.mesh_regrows = 0

    # ---- sequence parallelism ----
    def _validate_seq_model(self):
        """Sequence parallelism splits TIME: every layer (vertex) must be
        exact on a local chunk (pointwise in time, or riding the ring as
        attention does), or collapse time with a collective (global
        pooling) and feed only deterministic layers after it. Raises
        otherwise, as the JAX wrapper does."""
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph)
        model = self.model
        if isinstance(model, ComputationGraph):
            bad = [f"vertex '{n}' ({type(obj).__name__})"
                   for n, (obj, _) in model.conf.vertices.items()
                   if type(obj).__name__ not in _SEQ_POINTWISE]
            if bad:
                raise ValueError(
                    "these graph vertices cannot train over a 'seq' "
                    "mesh axis (not pointwise in time): " + ", ".join(bad)
                    + " — or drop the seq axis from the mesh")
            in_types = getattr(model.conf, "input_types", None)
            if not in_types:
                raise ValueError(
                    "sequence-parallel graphs need set_input_types("
                    "InputType.recurrent(...)) so the wrapper can prove "
                    "every input is temporal before splitting axis 1 "
                    "over 'seq'")
            non_rnn = [f"input {i} ({t.kind})"
                       for i, t in enumerate(in_types) if t.kind != "rnn"]
            if non_rnn:
                raise ValueError("sequence-parallel graphs need recurrent "
                                 "(B, T, ...) inputs; got "
                                 + ", ".join(non_rnn))
            return
        in_t = getattr(model.conf, "input_type", None)
        if in_t is None or in_t.kind != "rnn":
            raise ValueError(
                "sequence-parallel training needs set_input_type("
                "InputType.recurrent(...)) — got "
                f"{getattr(in_t, 'kind', None)!r}; the wrapper splits "
                "axis 1 over 'seq', which is only time for recurrent "
                "inputs")
        bad, collapsed = [], False
        for i, layer in enumerate(model.layers):
            name = type(layer).__name__
            if collapsed:
                if getattr(layer, "dropout", 0.0):
                    bad.append(f"layer {i} ({name}: dropout after the "
                               "time collapse)")
                continue
            if name in _SEQ_COLLAPSES:
                collapsed = True
            elif name not in _SEQ_POINTWISE:
                bad.append(f"layer {i} ({name})")
        if bad:
            raise ValueError(
                "these layers cannot train over a 'seq' mesh axis (not "
                "pointwise in time): " + ", ".join(bad)
                + " — use attention/dense/time-distributed layers "
                  "(optionally a GlobalPoolingLayer collapse), or drop "
                  "the seq axis from the mesh")
        self._seq_collapses = collapsed
        pps = getattr(model.conf, "preprocessors", None) or {}
        if pps:
            names = ", ".join(f"layer {i}: {type(p).__name__}"
                              for i, p in sorted(pps.items()))
            raise ValueError(
                "input preprocessors are not supported under sequence "
                f"parallelism ({names}) — they reshape with global "
                "timestep counts; restructure the net so activations "
                "stay (B, T, ...) end to end, or drop the seq axis")

    def local_shard(self, a, *, temporal: Optional[bool] = None):
        """This rank's part of a GLOBAL batch array (rows by its data
        index; time by its seq index, unless ``temporal`` is False: the
        labels of a net that pools time away are (B, K))."""
        ctx = self._ctx or MeshContext.from_mesh(self.mesh)
        if temporal is None:
            temporal = not self._seq_collapses
        return ctx.local_shard(a, temporal=temporal)

    # ---- builder parity ----
    class Builder:
        def __init__(self, model):
            self._model = model
            self._workers = None
            self._prefetch = 2
            self._compression = None

        def workers(self, n: int):
            self._workers = n
            return self

        def prefetch_buffer(self, n: int):
            self._prefetch = n
            return self

        def averaging_frequency(self, n: int):
            if n not in (0, 1):
                logger.warning(
                    "averaging_frequency(%d) requested, but the mesh "
                    "trainer synchronizes gradients EVERY step (an "
                    "all-reduce over the process group) — strictly "
                    "stronger consistency than periodic parameter "
                    "averaging; the value is ignored", n)
            return self

        def dcn_compression(self, threshold: float = 0.0):
            """Enable the int8 + residual-error-feedback gradient reduce
            (see ParallelWrapper dcn_compression)."""
            self._compression = {"threshold": threshold}
            return self

        def build(self) -> "ParallelWrapper":
            if self._workers is not None:
                mesh = build_mesh(MeshSpec(data=self._workers),
                                  list(range(self._workers)))
            else:
                mesh = build_mesh(MeshSpec())
            return ParallelWrapper(self._model, mesh, self._prefetch,
                                   self._compression)

    @staticmethod
    def builder(model) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(model)

    # ---- state ----
    @property
    def active(self) -> bool:
        """Whether this rank trains on the current mesh."""
        return self.mesh.contains()

    def describe(self) -> dict:
        """The mesh, the backend and the reduce's route for this model,
        whether this rank trains, compression and the elastic counts."""
        ctx = self._ctx or MeshContext.from_mesh(self.mesh)
        out = ctx.describe(self.model)
        if self.dcn_compression is not None:
            out["reduce"] = (f"{ctx.backend}: int8 + error-feedback "
                             f"compressed all-reduce, eager steps")
        out.update({"active": self.active,
                    "dcn_compression": self.dcn_compression,
                    "prefetch_buffer": self.prefetch,
                    "mesh_shrinks": self.mesh_shrinks,
                    "mesh_regrows": self.mesh_regrows})
        return out

    def _place_model(self, src: Optional[int] = None) -> None:
        """Install this mesh's context on the model (replicas made
        equal to ``src``'s, default the mesh's first rank) once."""
        m = self.model
        if m.params is None:
            m.init()
        if self._ctx is not None and self._ctx.mesh is self.mesh:
            return
        self._ctx = MeshContext.from_mesh(self.mesh)
        if not self.active:
            m._mesh_ctx = None
            m._flush_compiled_programs()
            return
        m._mesh_ctx = None
        if m._optimizer is None:
            m._build_optimizer()
        if m._generator is None:
            m._generator = m._new_generator(m.conf.conf.seed)
        m._mesh_ctx = self._ctx
        self._ctx.place_model(m, src=src)
        m._flush_compiled_programs()
        logger.info("ParallelWrapper: %s", self.describe())

    # ---- the compressed step ----
    def _init_residual(self):
        # float32 whatever the parameters' dtype: the residual carries
        # the exact quantization error (compression._ef_carry)
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        self.model.params)

    def _compressed_step(self, ds) -> torch.Tensor:
        """One per-rank step with the compressed reduce (the JAX
        wrapper's ``shard_map`` step): local statistics, local gradients
        over the rank count, the int8 + EF all-reduce, then the common
        update; float state averaged and integer state maxed over the
        ranks, the loss averaged."""
        from deeplearning4j_tpu_torch.parallel.compression import (
            make_compressed_psum_ef)
        from deeplearning4j_tpu_torch.parallel import (collectives,
                                                       seq_context)
        m = self.model
        ctx = self._ctx
        n = ctx.world
        if ctx.plan.sp > 1:
            with seq_context.sequence_parallel_gspmd(ctx):
                loss, grads, (new_state, _) = m._gradients(
                    m._batch_tuple(ds))
            # the seq part in full precision, the data part compressed
            seq = ctx.seq_group()
            grads = tree_map(lambda g: collectives.all_reduce_(
                g.clone(), seq, kind="seq"), grads)
        else:
            loss, grads, (new_state, _) = m._gradients(m._batch_tuple(ds))
        grads = tree_map(lambda g: g / n, grads)
        if self._residual is None:
            self._residual = self._init_residual()
        psum_ef = make_compressed_psum_ef(
            float(self.dcn_compression.get("threshold", 0.0)))
        data = ctx.data_group()
        grads, self._residual = psum_ef(grads, self._residual, data.group)
        with torch.no_grad():
            def merge(s):
                s = s.clone()
                if s.is_floating_point():
                    dist.all_reduce(s, group=ctx.group)
                    return s / n
                dist.all_reduce(s, op=dist.ReduceOp.MAX, group=ctx.group)
                return s
            new_state = tree_map(merge, new_state)
            loss = loss.clone()
            dist.all_reduce(loss, group=ctx.group)
            loss = loss / n
        loss, _, _ = m._apply_step(loss, grads, (new_state, None))
        return loss

    # ---- one batch ----
    def _train_batch(self, ds) -> bool:
        """One batch through the mesh step: chaos site, the ranks'
        shards trimmed to the shortest, the step, the listeners. Returns
        False when no step ran here (a dropped batch, or this rank is
        off the mesh)."""
        f = chaos.step_fault("parallel.device")
        if f is not None and f.kind == "loss":
            self._on_device_loss(f)
        self._place_model()
        if not self.active:
            return False
        m = self.model
        ds = m._coerce_fit_batch(ds)
        if self.dcn_compression is None:
            return m._fit_one(ds)
        ds = m._dp_trim([ds])[0]
        if ds is None:
            return False
        loss = self._compressed_step(ds)
        m.score_value = loss
        for lst in m.listeners:
            lst.iteration_done(m, m.iteration_count, loss,
                               m._global_examples(ds))
        m.iteration_count += 1
        return True

    def fit_batch(self, ds):
        """Train exactly ONE batch on the mesh with no epoch bookkeeping
        (ElasticTrainer's integration point: the trainer owns the epoch
        loop, the wrapper the mesh step)."""
        if self.model.params is None:
            self.model.init()
        self.model._prepare_fit()
        self._train_batch(ds)
        return self.model

    def supports_fused_windows(self) -> bool:
        """Whether k-step windows run as the model's captured programs:
        the full-precision reduce. The compressed reduce threads a
        per-rank residual through an eager step: per batch."""
        return self.dcn_compression is None

    def fit_batches(self, batches, *, steps_per_device_call: int = 1):
        """A window of batches through the model's k-step programs on
        this mesh (ElasticTrainer's k>1 entry point). The
        ``parallel.device`` site is consulted once a window: a loss
        shrinks the mesh first and the whole window trains on the
        survivors. Returns the per-step losses (none off the mesh)."""
        if not self.supports_fused_windows():
            raise ValueError(
                "fused k-step windows need the full-precision reduce; "
                "this wrapper's dcn_compression trains per-batch — use "
                "fit_batch or steps_per_device_call=1")
        if self.model.params is None:
            self.model.init()
        f = chaos.step_fault("parallel.device")
        if f is not None and f.kind == "loss":
            self._on_device_loss(f)
        self._place_model()
        if not self.active:
            return np.zeros(0)
        return self.model.fit_batches(
            batches, steps_per_device_call=steps_per_device_call)

    def fit(self, iterator: DataSetIterator, *, epochs: int = 1):
        model = self.model
        if model.params is None:
            model.init()
        model._prepare_fit()
        self._place_model()
        it = AsyncDataSetIterator(iterator, self.prefetch) \
            if self.prefetch > 0 else iterator
        for _ in range(epochs):
            for lst in model.listeners:
                lst.on_epoch_start(model)
            for ds in it:
                self._train_batch(ds)
            for lst in model.listeners:
                lst.on_epoch_end(model)
            model.epoch_count += 1
        return model

    # ---- elastic mesh shrink / regrow ----
    def lose_device(self, index: int = -1) -> None:
        """Declare the rank at ``index`` (into the current mesh's rank
        list) lost and shrink onto the survivors. Every rank calls it."""
        ranks = self.mesh.ranks
        self._shrink({ranks[index % len(ranks)]})

    def _on_device_loss(self, fault) -> None:
        ranks = self.mesh.ranks
        idx = int(fault.args.get("device", len(ranks) - 1))
        self._shrink({ranks[idx % len(ranks)]})

    def _rebuild_on(self, new_mesh: Mesh, exclude=()) -> None:
        """Move training onto ``new_mesh``: the replicas made equal to a
        rank of the current mesh (outside ``exclude``), which holds the
        last committed step; the programs and the compression residual
        dropped (rebuilt for the new group)."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            unshard_model)
        holders = [r for r in self.mesh.ranks if r not in exclude]
        src = next((r for r in new_mesh.ranks if r in holders),
                   new_mesh.ranks[0])
        # tp shards back to full parameters over the old model groups
        unshard_model(self.model)
        self.mesh = new_mesh
        self._ctx = None
        self._residual = None
        self._place_model(src=src)

    def _shrink(self, lost: set) -> None:
        old_dp = self.mesh.shape.get("data", 1)
        new_mesh = shrink_data_mesh(self.mesh, lost)
        self._lost |= set(lost)
        self._rebuild_on(new_mesh, exclude=self._lost)
        self.mesh_shrinks += 1
        new_dp = self.mesh.shape.get("data", 1)
        logger.warning(
            "device loss: mesh shrunk dp=%d -> dp=%d over ranks %s; "
            "this rank %s; training continues (regrow is explicit via "
            "wrapper.regrow())", old_dp, new_dp, self.mesh.ranks,
            "trains" if self.active else "leaves the loop")
        self._account_elastic("elastic_mesh_shrinks_total",
                              "mesh shrinks after a device loss",
                              "mesh_shrink", old_dp, new_dp)

    def regrow(self, devices=None) -> Mesh:
        """Explicitly rebuild the mesh after capacity returns: over
        ``devices`` (ranks; an explicit list vouches for ranks declared
        lost), default the wrapper's initial ranks less the lost ones,
        at the initial dp or the largest power of two that fits. Every
        rank calls it. Returns the new mesh."""
        if devices is not None:
            devices = [int(r) for r in devices]
            self._lost.clear()
        else:
            devices = [r for r in self._initial_ranks
                       if r not in self._lost]
        old_dp = self.mesh.shape.get("data", 1)
        tp = self.mesh.shape.get("model", 1)
        dp = min(self._initial_dp, largest_pow2(len(devices) // tp))
        self._rebuild_on(build_mesh(MeshSpec(data=dp, model=tp),
                                    devices[:dp * tp]))
        self.mesh_regrows += 1
        logger.warning("mesh regrown dp=%d -> dp=%d over ranks %s",
                       old_dp, dp, self.mesh.ranks)
        self._account_elastic("elastic_mesh_regrows_total",
                              "explicit mesh regrows after a shrink",
                              "mesh_regrow", old_dp, dp)
        return self.mesh

    @staticmethod
    def _account_elastic(counter: str, help: str, event: str,
                         dp_from: int, dp_to: int) -> None:
        from deeplearning4j_tpu_torch.observability.registry import safe_inc
        safe_inc(counter, help=help)
        try:
            from deeplearning4j_tpu_torch.observability import (
                flight_recorder)
            rec = flight_recorder.get_recorder()
            if rec is not None:
                rec.record(event, dp_from=dp_from, dp_to=dp_to)
        except Exception:
            pass


# graph and sequential models share the wrapper; alias for readability
GraphParallelWrapper = ParallelWrapper
