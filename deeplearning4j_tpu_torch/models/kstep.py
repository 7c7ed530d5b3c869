"""The captured training step, k-step fusion and AOT training warmup
(counterpart of ``deeplearning4j_tpu/models/kstep.py``).

The JAX package runs each training step as one jitted XLA program, k
steps as one ``lax.scan`` program, and compiles both ahead of time in
``warmup``. The port's counterpart of a jitted program is a CUDA graph:

- :class:`TrainProgram` is one training program for one batch
  signature. On a card it is a CUDA graph of k steps (k >= 1), captured
  at the signature's first sight, as ``jit`` traces at its first call:
  one eager run on the executor's own training stream (the step the
  caller asked for; it also makes cuBLAS's and cuDNN's workspaces for
  that stream), then ``capture_begin(capture_error_mode=
  "thread_local")`` around the same body. The window is read from
  static ``[k, ...]`` input buffers, filled by ``copy_`` on that stream
  from double-buffered pinned staging before each replay; the k losses,
  and the ``[k, 5]`` health block when a health listener is attached,
  land in static output buffers. Parameters are updated in place; the
  layer state (batch-norm statistics, center-loss centers) and the
  updater state are copied back into the executor's own tensors inside
  the graph (the executors never rebind them in a step), so every
  address the graph baked stays valid. The dropout generator is
  registered with each graph, so each replay draws new bits. The
  attention kernels' launches are recorded at capture and counted on
  every replay (``ops/native.count_replay``). A capture that fails
  raises, naming the layer it was in: there is no eager fallback on a
  card.
- A tBPTT chunk program is a graph of one chunk step whose recurrent
  carries live in static buffers (one set for each batch size, shared
  by the chunk lengths), copied back inside the graph and zeroed at
  each sequence's start.
- On the CPU the same bodies run eagerly, one call a step, and are
  held against the JAX package by the tests.

:class:`KStepExecutorMixin` is the window plumbing both executors
share, as in the JAX package: ``_fit_epoch`` (k-batch windows, the
epoch tail through the k=1 program, tBPTT entries flushing the
window), ``fit_batches`` (ElasticTrainer's window entry point),
``warmup`` (:func:`warmup_train_programs`: capture the k graph and the
k=1 graph without advancing the parameters) and
``_flush_compiled_programs`` (drop every graph and its memory pool
wherever an address or a constant the graphs baked changes).

Data parallelism (``use_mesh``, ``fit(mesh_spec=)``,
``warmup(mesh_spec=)``; ``parallel/mesh_spec.py``): before a step or a
window every rank's batches are trimmed to the shortest rank's and
steps with an empty shard dropped (one host all-reduce), and the
window carries each step's global mask totals. The program's step
reduces the loss and gradients over the mesh (``parallel/global_batch.
py``). On a card under ``nccl`` the all-reduce is captured in the
window's graph; under ``gloo`` (ranks sharing a card) every step runs
eagerly, its bucket all-reduced through the host, and captures
nothing: gloo's collectives cannot be captured. A data x model mesh
(``dp=..,tp=..``) reduces the bucket over the data axis; each layer's
tensor-parallel collectives run inside the step (captured under nccl,
eager under gloo; ``parallel/tensor_parallel.py``).
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.observability import compile_watch
from deeplearning4j_tpu_torch.observability.tracing import trace
from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.parallel import global_batch

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["signature", "stack_batches", "host_batch", "TrainProgram",
           "warmup_train_programs", "KStepExecutorMixin", "assign_tree"]


# ---- batch trees: tuples (and lists) of tensors, None for a missing slot

def _tmap(fn, *trees):
    """``fn`` over the tensor leaves of same-structure batch trees;
    None slots stay None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return tuple(_tmap(fn, *(t[i] for t in trees))
                     for i in range(len(first)))
    return fn(*trees)


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def signature(tree) -> Tuple:
    """Hashable structure, shapes and dtypes of a batch tree (a None
    slot differs from a tensor): the program-cache key and the check
    that decides whether a window of batches may be fused."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(signature(t) for t in tree)
    return (tuple(tree.shape), str(tree.dtype))


def _host_leaf(a):
    """A batch array as a tensor where it lies (numpy becomes a CPU
    tensor, float64 and other floats float32, as ``as_device_tensor``
    and JAX's canonical dtypes do); None passes."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def host_batch(tree):
    """A batch tree of numpy arrays or tensors as tensors, without a
    device transfer (numpy is wrapped, not copied)."""
    return _tmap(_host_leaf, tree)


def stack_batches(batch_tuples: Sequence):
    """k same-signature batch trees stacked into one ``[k, ...]``
    window, leaf by leaf (None slots must be None in every batch:
    callers compare :func:`signature` first). Stacking where the
    batches lie means one transfer a leaf for the window."""
    if len(batch_tuples) < 2:
        raise ValueError("a window needs at least 2 batches")
    return _tmap(lambda *xs: torch.stack(xs), *batch_tuples)


def assign_tree(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the leaf of ``dst`` at the
    same path, in place (the same tensor is left alone): how a step
    writes a new state tree into tensors whose addresses a captured
    graph baked."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            assign_tree(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            assign_tree(d, s)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        dst.copy_(src)


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_clone(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


class TrainProgram:
    """One training program of an executor for one batch signature: k
    training steps over a ``[k, ...]`` window (``tbptt=False``), or one
    tBPTT chunk step over the recurrent carries ``carries``
    (``tbptt=True``, k = 1). On a card, a CUDA graph captured at the
    first :meth:`run` (or by :meth:`warm`) and replayed after; on the
    CPU, the eager body at every call."""

    def __init__(self, model, example, k: int, *, health: bool,
                 tbptt: bool = False, carries=None):
        # weak: a model's programs die with it (no cycle to wait for the
        # collector while a graph's pool holds device memory)
        self._model = weakref.ref(model)
        self.k = int(k)
        self.health = bool(health)
        self.tbptt = tbptt
        self.cuda = model.device.type == "cuda"
        self.carries = carries
        # data parallelism (``use_mesh``): the window is (batches, the
        # steps' global mask totals) and each step reduces over the mesh
        self.dp = model._mesh_ctx
        # gloo's collectives cannot be captured: under gloo on a card
        # every step runs eagerly (its bucket staged through the host),
        # and so does a sequence-parallel step (the ring's sends)
        self.eager = (self.cuda and self.dp is not None
                      and self.dp.eager_steps(model.device))
        self.graph = None
        self.tally: dict = {}
        self.capture_seconds: Optional[float] = None
        self.replays = 0
        self._out = None
        if self.cuda and not self.eager:
            dev = model.device
            self._static = _tmap(
                lambda a: torch.empty((self.k,) + tuple(a.shape),
                                      dtype=a.dtype, device=dev), example)
            # two pinned staging sets, used in turns: the host fills one
            # while the copy out of the other may still be queued
            self._stage = [_tmap(lambda s: torch.empty(
                s.shape, dtype=s.dtype, pin_memory=True), self._static)
                for _ in range(2)]
            self._staged = [None, None]
            self._turn = 0

    @property
    def model(self):
        return self._model()

    # ---- the body: what the graph captures, and the CPU's step ----
    def _body(self, window, carries):
        """k steps over ``window`` (leaves ``[k, ...]``); returns (the
        ``[k]`` losses, the ``[k, 5]`` health block or None, the new
        carries)."""
        m = self.model
        if self.tbptt:
            batch = _tmap(lambda a: a[0], window)
            loss, new = m._train_step(batch, carries)
            if self.cuda:
                # the carries stay where the graph reads them
                with torch.no_grad():
                    assign_tree(carries, new)
                new = carries
            return loss.reshape(1), None, new
        totals = None
        if self.dp is not None:
            window, totals = window
        losses, healths = [], []
        for i in range(self.k):
            batch = _tmap(lambda a: a[i], window)
            with global_batch.scope(self.dp,
                                    None if totals is None else totals[i]):
                loss, vec, _ = m._step_body(batch, None, health=self.health)
            losses.append(loss)
            healths.append(vec)
        return (torch.stack(losses),
                torch.stack(healths) if self.health else None, None)

    # ---- inputs ----
    def _fill(self, window) -> None:
        """Copy the host (or device) window into the static inputs, on
        the current stream (the training stream): host leaves through a
        pinned staging buffer, asynchronously."""
        turn = self._turn
        self._turn ^= 1
        if self._staged[turn] is not None:
            self._staged[turn].synchronize()     # its last copy is done
        stage = self._stage[turn]

        def put(static, st, a):
            if a.is_cuda:
                static.copy_(a.reshape(static.shape))
            else:
                st.copy_(a.reshape(st.shape))
                static.copy_(st, non_blocking=True)
        _tmap(put, self._static, stage, window)
        ev = self._staged[turn] or torch.cuda.Event()
        ev.record()
        self._staged[turn] = ev

    # ---- running ----
    def run(self, window, carries=None):
        """One call of the program on ``window`` (a batch tree with a
        leading k axis; on a card its leaves may be host or device
        tensors). Returns (losses, healths or None, new carries): on a
        card, clones of the static outputs, taken on the caller's
        stream after the replay, so a later replay cannot overwrite what
        a listener holds."""
        if not self.cuda or self.eager:
            window = _tmap(lambda a: a.to(self.model.device), window)
            return self._body(window, carries)
        stream = self.model._training_stream()
        current = torch.cuda.current_stream(self.model.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._fill(window)
            if self.graph is None:
                out = self._capture()
            else:
                self.graph.replay()
                native.count_replay(self.tally)
                compile_watch.record_replay()
                self.replays += 1
                out = self._out
        current.wait_stream(stream)
        losses, healths, new = out
        return (losses.clone(),
                None if healths is None else healths.clone(), new)

    def warm(self, window) -> float:
        """Build the program without advancing the model: on a card,
        capture it around one eager run whose effects (parameters,
        layer state, updater state, carries, the dropout generator) are
        undone afterwards; on the CPU, run the body once the same way.
        Returns the seconds it took."""
        t0 = time.perf_counter()
        m = self.model
        saved = (_tree_clone(m.params), _tree_clone(m.state),
                 _tree_clone(m.opt_state), _tree_clone(self.carries),
                 m._generator.get_state())
        try:
            if self.cuda and not self.eager:
                stream = m._training_stream()
                current = torch.cuda.current_stream(m.device)
                stream.wait_stream(current)
                with torch.cuda.stream(stream):
                    self._fill(window)
                    self._capture()
                current.wait_stream(stream)
            else:
                self.run(window, self.carries)
        finally:
            with torch.no_grad():
                assign_tree(m.params, saved[0])
                assign_tree(m.state, saved[1])
                assign_tree(m.opt_state, saved[2])
                assign_tree(self.carries, saved[3])
            m._generator.set_state(saved[4])
        return time.perf_counter() - t0

    def _capture(self):
        """On the training stream, with the window in the static
        inputs: the eager body once (a real step: :meth:`warm` undoes
        it), then the capture of the same body. Returns the eager run's
        outputs. Raises, naming the layer, if the capture fails."""
        t0 = time.perf_counter()
        m = self.model
        out = self._body(self._static, self.carries)
        graph = torch.cuda.CUDAGraph()
        gen = m._generator
        if gen is not None and gen.device.type == "cuda":
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "this torch cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state): the "
                    "captured training step could not draw new dropout "
                    "bits on each replay")
            register(gen)
        stream = torch.cuda.current_stream(m.device)
        m._where = "the training step"
        with native.capture_launches(stream) as tally:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static = self._body(self._static, self.carries)
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass          # the capture was invalidated
                raise RuntimeError(
                    f"capturing the training step of "
                    f"{type(m).__name__} failed in {m._where}: {e}") from e
            graph.capture_end()
        self.graph, self._out, self.tally = graph, static, tally
        self.capture_seconds = time.perf_counter() - t0
        compile_watch.record_capture(self.capture_seconds)
        return out

    def close(self) -> None:
        """Drop the graph and its outputs, so its memory pool can be
        freed."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self._out = None


def warmup_train_programs(model, example, k: int) -> Dict[str, float]:
    """Build a model's training programs for one batch signature
    without advancing it: the k=1 program (also the epoch tail's) and,
    for ``k > 1``, the k-step program (the JAX package's
    ``warmup_train_programs``). Returns ``{program: seconds}`` for
    what was built; programs already built are skipped."""
    out: Dict[str, float] = {}
    batch = host_batch(example)
    window = model._dp_window(_tmap(lambda a: a[None], batch), [batch])
    prog, built = model._program_for(window, 1)
    if built:
        out["train_step"] = prog.warm(window)
    if k > 1:
        window = model._dp_window(stack_batches([batch] * k), [batch] * k)
        prog, built = model._program_for(window, k)
        if built:
            out[f"kstep_{k}"] = prog.warm(window)
    return out


class KStepExecutorMixin:
    """The executor-side window plumbing both executors share (the JAX
    package's ``KStepExecutorMixin``). The executor supplies
    ``_step_body(batch, carries, health=)``, ``_train_step(batch,
    carries)``, ``_batch_tuple(ds)`` (device tensors),
    ``_host_tuple(ds)`` (host tensors), ``_coerce_fit_batch``,
    ``_batch_is_tbptt``, ``_tbptt_chunks(ds, fwd)`` and
    ``_zero_carries(B)``; batches need ``num_examples()``."""

    # the installed MeshContext (None = one device) and the tensor-
    # parallel plan of the parameters this rank holds (None = full
    # parameters); class defaults so both executors inherit them
    _mesh_ctx = None
    _tp = None

    def use_mesh(self, mesh_spec, devices=None):
        """Install a declarative mesh spec (``"dp=4"`` | dict | JSON | a
        prebuilt ``MeshContext``) on this executor: every replica made
        equal to the mesh's first rank's, each rank's dropout generator
        offset by its rank, and every training program dropped so the
        next step builds the data-parallel one. The same spec over the
        same ranks keeps the installed context and its programs
        (``warmup(mesh_spec=X)`` then ``fit(mesh_spec=X)`` captures
        nothing new). Collective: every rank calls it."""
        from deeplearning4j_tpu_torch.parallel.mesh_spec import (
            MeshContext, build_mesh_context, resolve_mesh_spec)
        if mesh_spec is None:
            return self
        if self.conf.conf.tbptt is not None:
            raise NotImplementedError(
                "tBPTT does not compose with mesh_spec yet (the chunked "
                "step threads recurrent carries the data-parallel "
                "program does not hold); drop tbptt or the mesh spec")
        if self.params is None:
            self.init()
        cur = self._mesh_ctx
        if isinstance(mesh_spec, MeshContext):
            ctx = mesh_spec
            if cur is not None and cur.same_as(ctx):
                return self
        else:
            # the installed context is kept without a collective when the
            # spec resolves to the same plan over the same ranks
            plan, ranks = resolve_mesh_spec(mesh_spec, devices)
            if (cur is not None and cur.plan == plan
                    and cur.mesh.ranks == ranks):
                return self
            ctx = build_mesh_context(plan, self, ranks)
        if not ctx.member:
            raise ValueError(
                f"this process is not one of the mesh's ranks "
                f"{ctx.mesh.ranks}: only they train on it")
        if self._optimizer is None:
            self._build_optimizer()
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        ctx.place_model(self)
        self._mesh_ctx = ctx
        self._flush_compiled_programs()
        logger.info("data parallel: %s", ctx.describe(self))
        return self

    def _layer_objects(self):
        if hasattr(self, "_layer_configs"):
            return list(self._layer_configs().values())
        return list(self.layers)

    def _masked_outputs(self) -> bool:
        from deeplearning4j_tpu_torch.nn.conf.layers.output import (
            RnnOutputLayer)
        outs = getattr(self.conf, "network_outputs", None)
        objs = ([self.conf.vertices[n][0] for n in outs] if outs
                else self._layer_objects()[-1:])
        return any(isinstance(o, RnnOutputLayer) for o in objs)

    def _dp_window(self, window, tups):
        """Under a mesh, the program's window is (the batches, each
        step's global mask total of each output, ``[k, n_outputs]``)."""
        ctx = self._mesh_ctx
        if ctx is None:
            return window
        outs = len(getattr(self.conf, "network_outputs", None) or [0])
        rows = np.zeros((len(tups), outs))
        if self._masked_outputs():
            for i, tup in enumerate(tups):
                masks = tup[3]
                if not isinstance(masks, (tuple, list)):
                    masks = [masks] * outs
                for j, mk in enumerate(masks):
                    if mk is not None:
                        rows[i, j] = float(mk.sum())
            rows = ctx.host_all_reduce(rows)
        return window, torch.as_tensor(rows, dtype=torch.float32)

    def _dp_trim(self, items):
        """Under a mesh: every rank's batches trimmed to the shortest
        rank's (one host all-reduce for the list); None for a step in
        which some rank's shard is empty, dropped on every rank."""
        ctx = self._mesh_ctx
        if ctx is None:
            return items
        local = [m.num_examples() for m in items]
        mins = ctx.host_all_reduce(local, op="min")
        return [None if int(lo) == 0 else
                (m if int(lo) == n else truncate_batch(m, int(lo)))
                for m, n, lo in zip(items, local, mins)]

    def _global_examples(self, ds) -> int:
        ctx = self._mesh_ctx
        return ds.num_examples() * (1 if ctx is None else ctx.world)

    def _init_programs(self) -> None:
        self._programs: Dict[tuple, TrainProgram] = {}
        self._carry_buffers: Dict[int, object] = {}
        self._stream = None
        self._health_enabled = False
        self._last_health = None
        self._last_batch = None
        self._window_batch_index = 0
        self._where = None

    # The training programs bake these trees' addresses: rebinding one
    # drops them (a step copies into them instead). The model keeps its
    # own copy of what it is given: a step updates it in place, which
    # must not reach a tree another model or a caller still holds.
    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        self._state = _tree_clone(value)
        self._flush_compiled_programs()

    @property
    def opt_state(self):
        return self._opt_state

    @opt_state.setter
    def opt_state(self, value):
        self._opt_state = _tree_clone(value)
        self._flush_compiled_programs()

    def _training_stream(self) -> torch.cuda.Stream:
        """The stream every capture and replay of this model runs on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _flush_compiled_programs(self) -> None:
        """Drop every training program and free its memory: wherever an
        address or a constant the graphs baked changes (a new
        optimizer, rebound params or state, a health listener attached
        or removed, frozen layers)."""
        progs = getattr(self, "_programs", None)
        if not progs:
            return
        cuda = any(p.cuda for p in progs.values())
        for p in progs.values():
            p.close()
        progs.clear()
        self._carry_buffers.clear()
        if cuda:
            torch.cuda.empty_cache()

    def _sync_health_mode(self) -> None:
        """Build the fused health vector into the step iff a listener
        wants device health (one flush a toggle, not a fit)."""
        want = any(getattr(lst, "wants_device_health", False)
                   for lst in self.listeners)
        if want != self._health_enabled:
            self._health_enabled = want
            self._flush_compiled_programs()
            if not want:
                self._last_health = None

    def _program_for(self, window, k: int, *, tbptt: bool = False,
                     carries=None):
        """(the program for this window's signature under the active
        dtype policy, whether it was built now)."""
        key = (k, tbptt, self._health_enabled, signature(window),
               dtypes.policy())
        prog = self._programs.get(key)
        if prog is not None:
            return prog, False
        prog = TrainProgram(self, _tmap(lambda a: a[0], window), k,
                            health=self._health_enabled and not tbptt,
                            tbptt=tbptt, carries=carries)
        self._programs[key] = prog
        return prog, True

    def _apply(self, fn, *args, **kwargs):
        # ``.to()`` / ``.cuda()`` move the tensors the graphs baked
        self._flush_compiled_programs()
        return super()._apply(fn, *args, **kwargs)

    def _prepare_fit(self) -> None:
        if self.params is None:
            self.init()
        if self._optimizer is None:
            self._build_optimizer()
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        self._sync_health_mode()

    # ---- one step ----
    def _fit_one(self, ds, data_wait_s: float = 0.0, *,
                 trimmed: bool = False) -> bool:
        """One step through the k=1 program, then the listeners. Under a
        mesh the batch is first trimmed to the shortest rank's; returns
        False for a step dropped on every rank (an empty shard)."""
        if not trimmed:
            ds = self._dp_trim([ds])[0]
            if ds is None:
                return False
        t1 = time.perf_counter()
        with trace.span("train_step"):
            batch = self._host_tuple(ds)
            window = self._dp_window(_tmap(lambda a: a[None], batch),
                                     [batch])
            prog, _ = self._program_for(window, 1)
            losses, healths, _ = prog.run(window)
        self._last_health = None if healths is None else healths[0]
        self._last_batch = batch
        self.score_value = losses[0]
        self._step_timing = (data_wait_s, time.perf_counter() - t1)
        with trace.span("listeners"):
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.score_value,
                                   self._global_examples(ds))
        self.iteration_count += 1
        return True

    def _run_tbptt(self, ds, tbptt, data_wait_s: float = 0.0) -> None:
        """Truncated BPTT (the JAX package's ``_fit_tbptt``): the
        executor's chunks of ``fwd_length`` steps, one updater step and
        one listener iteration each; the recurrent carries start at
        zero and cross each chunk boundary detached. On the CPU each
        chunk is one ``_train_step`` on the previous chunk's carries;
        on a card, one replay of the chunk program over static carries.
        ``bwd_length`` is not read, as in the JAX package. The batch's
        data wait is billed to the first chunk's ``_step_timing``."""
        self._last_health = None
        carries = None
        first = True
        for sub in self._tbptt_chunks(ds, tbptt["fwd_length"]):
            t_chunk = time.perf_counter()
            batch = self._host_tuple(sub)
            if carries is None:
                carries = self._chunk_carries(batch)
            window = _tmap(lambda a: a[None], batch)
            prog, _ = self._program_for(window, 1, tbptt=True,
                                        carries=carries)
            losses, _, carries = prog.run(window, carries)
            self.score_value = losses[0]
            self._step_timing = (data_wait_s if first else 0.0,
                                 time.perf_counter() - t_chunk)
            first = False
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration_count,
                                   self.score_value, sub.num_examples())
            self.iteration_count += 1

    def _chunk_carries(self, batch):
        """The carries a sequence starts from: fresh zeros on the CPU;
        on a card, the static buffers of its batch size, zeroed."""
        B = next(_leaves(batch)).shape[0]
        if self.device.type != "cuda":
            return self._zero_carries(B)
        buf = self._carry_buffers.get(B)
        if buf is None:
            buf = self._carry_buffers[B] = self._zero_carries(B)
        else:
            stream = self._training_stream()
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for t in _carry_leaves(buf):
                    t.zero_()
        return buf

    # ---- windows ----
    def _fit_epoch(self, data_iter, k: int, tbptt) -> None:
        """One epoch's batch loop: the data wait timed apart from the
        step, k-batch windows collected (k > 1), the window flushed
        before a tBPTT entry so step order holds, the tail flushed at
        exhaustion."""
        pending = []
        while True:
            t0 = time.perf_counter()
            with trace.span("data_wait"):
                ds = next(data_iter, None)
            if ds is None:
                break
            wait = time.perf_counter() - t0
            m = self._coerce_fit_batch(ds)
            if self._batch_is_tbptt(m, tbptt):
                self._flush_window(pending, k)
                with trace.span("train_step_tbptt"):
                    self._run_tbptt(m, tbptt, data_wait_s=wait)
                continue
            if k == 1:
                self._fit_one(m, wait)
                continue
            pending.append((m, wait))
            if len(pending) == k:
                self._flush_window(pending, k)
        self._flush_window(pending, k)

    def fit_batches(self, batches, *, steps_per_device_call: int = 1):
        """Train on a list of batches in one listener-visible pass with
        no epoch bookkeeping (ElasticTrainer's window entry point). When
        ``len(batches) == steps_per_device_call > 1`` and the batches
        share one signature, the window runs as one k-step program;
        otherwise each batch runs through the k=1 program. Returns the
        per-step losses as a host numpy array."""
        k = int(steps_per_device_call)
        if k < 1:
            raise ValueError("steps_per_device_call must be >= 1")
        self._prepare_fit()
        items = [m for m in self._dp_trim(
            [self._coerce_fit_batch(d) for d in batches]) if m is not None]
        tbptt = self.conf.conf.tbptt
        if k > 1 and len(items) == k and not any(
                self._batch_is_tbptt(m, tbptt) for m in items):
            tups = [self._host_tuple(m) for m in items]
            if len({signature(t) for t in tups}) == 1:
                return self._dispatch_window(tups, items, [0.0] * k, k)
        out = []
        for i, m in enumerate(items):
            # which window entry is live (a tBPTT entry spans several
            # iterations: ElasticTrainer maps a rollback through this)
            self._window_batch_index = i
            if self._batch_is_tbptt(m, tbptt):
                with trace.span("train_step_tbptt"):
                    self._run_tbptt(m, tbptt)
            else:
                self._fit_one(m, trimmed=True)
            out.append(float(self.score_value))
        return np.asarray(out, dtype=np.float64)

    def _flush_window(self, pending, k: int) -> None:
        """Run the collected window: one k-step program when it is full
        and of one signature; anything else (the epoch tail, a batch of
        another shape) batch by batch through the k=1 program."""
        if not pending:
            return
        kept = [(d, w) for d, (_, w) in zip(
            self._dp_trim([d for d, _ in pending]), pending) if d is not None]
        del pending[:]
        batches = [d for d, _ in kept]
        waits = [w for _, w in kept]
        if len(batches) == k and k > 1:
            tups = [self._host_tuple(d) for d in batches]
            if len({signature(t) for t in tups}) == 1:
                self._dispatch_window(tups, batches, waits, k)
                return
        for d, w in zip(batches, waits):
            self._fit_one(d, w, trimmed=True)

    def _dispatch_window(self, tups, batches, waits, k: int):
        """One k-step program call, then the listener pass over its
        outputs: the losses (and the health block) are fetched once a
        window, and every step is still seen by the listeners."""
        window = self._dp_window(stack_batches(tups), tups)
        prog, _ = self._program_for(window, k)
        t1 = time.perf_counter()
        with trace.span("train_step_fused"):
            losses, healths, _ = prog.run(window)
        loss_host = losses.cpu().numpy()
        health_host = None if healths is None else healths.cpu().numpy()
        per_step_s = (time.perf_counter() - t1) / k
        self._last_batch = tups[-1]
        with trace.span("listeners"):
            for i in range(k):
                self._window_batch_index = i
                self._last_health = (None if health_host is None
                                     else health_host[i])
                self.score_value = loss_host[i]
                self._step_timing = (waits[i], per_step_s)
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count,
                                       loss_host[i],
                                       self._global_examples(batches[i]))
                self.iteration_count += 1
        return loss_host

    def warmup(self, example, *, steps_per_device_call: int = 1,
               mesh_spec=None) -> Dict[str, float]:
        """AOT warmup: build the training programs this batch signature
        will need (the k-step program for ``steps_per_device_call > 1``
        and the k=1 step and tail program) without advancing the
        parameters, so a later ``fit``/``fit_batches`` steady state
        captures nothing (``compile_watch.zero_compile_scope`` can
        assert it). Attach listeners (a HealthMonitor in particular)
        first: the health toggle rebuilds the programs. Returns
        ``{program: seconds}``."""
        self.use_mesh(mesh_spec)
        self._prepare_fit()
        return warmup_train_programs(
            self, self._host_tuple(self._coerce_fit_batch(example)),
            int(steps_per_device_call))


def truncate_batch(ds, target: int):
    """Trim a batch to its first ``target`` examples (DataSet or
    MultiDataSet; the JAX wrapper's ``_truncate_batch``): the ranks'
    shards stay equal without the gradient bias padding by repetition
    would cause."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

    def take(a):
        return None if a is None else a[:target]

    if isinstance(ds, MultiDataSet):
        def take_list(lst):
            return None if lst is None else [take(a) for a in lst]
        return MultiDataSet(take_list(ds.features), take_list(ds.labels),
                            take_list(ds.features_masks),
                            take_list(ds.labels_masks))
    return DataSet(take(ds.features), take(ds.labels),
                   take(ds.features_mask), take(ds.labels_mask))


def _carry_leaves(carries):
    items = carries.values() if isinstance(carries, dict) else carries
    for c in items:
        if c is not None:
            yield from _leaves(c)
