"""Pipeline parallelism, one rank a stage (counterpart of
``deeplearning4j_tpu/parallel/pipeline_spmd.py``).

The JAX package stacks the stages' parameters on a leading axis sharded
over the mesh's ``pipe`` axis and runs the whole microbatch loop as one
``shard_map`` program, ``ppermute`` moving activations between devices.
The port has one process a rank: rank s of the pipe group holds stage s
and runs the GPipe schedule (:class:`SpmdPipeline`): every microbatch
forward, stage by stage, the activations sent to the next stage's rank;
then every microbatch backward, the activation gradients sent back; one
optimizer step a batch on each stage's own layers. The sends are
``dist.send`` / ``dist.recv`` over the pipe group (on the device under
nccl, through the host under gloo; ``parallel/collectives.py`` counts
the bytes under ``STATS["pipe"]``), and each stage's time blocked in a
receive is its share of the pipeline bubble (``idle_seconds``).

:class:`NetworkSpmdPipeline` bridges a config-built MultiLayerNetwork:
the longest run of structurally identical layers (a transformer stack;
``_layer_signature``, ``_longest_identical_run``) is folded N/S a stage,
the layers before it (the embedding) go on the first stage, the layers
after it and the loss head on the last. The batch loss is the mean of
the microbatch losses, so with uniform microbatches a step equals the
single-device step. Layer state (batch-norm statistics) is threaded
through the microbatches in order on each stage, and dropout draws
from a generator seeded by (the step, the ABSOLUTE layer index, the
microbatch), so pp=S training equals pp=1 on the same microbatch
schedule, dropout on. Limits, as in the JAX package (they raise): the
net ends in a loss layer and has no gradient normalization, clipping,
l1/l2, constraints or per-layer updaters, and no preprocessor inside the
folded run.

``train_batch(x, y)`` takes the GLOBAL batch on every rank (the first
stage reads the features, the last the labels) and returns the batch's
mean loss on every rank. ``collect_params`` broadcasts each layer's
parameters and state from the rank that owns it, so every rank's model
holds the trained network.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import collectives

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["SpmdPipeline", "NetworkSpmdPipeline"]


def _pipe_group(mesh, axis: str):
    from deeplearning4j_tpu_torch.parallel.mesh_spec import MeshContext
    if axis != "pipe":
        raise ValueError(f"pipelines run over the 'pipe' axis, not "
                         f"{axis!r}")
    ctx = mesh if isinstance(mesh, MeshContext) else \
        MeshContext.from_mesh(mesh)
    return ctx.pipe_group()


class SpmdPipeline:
    """The GPipe schedule over the pipe group of ``mesh`` (a port
    ``Mesh`` or ``MeshContext``), this rank being stage
    ``group.index``.

    ``stage_forward(h, y, m)``: this stage's compute on microbatch
    ``m``: the first stage gets the features, later stages the previous
    stage's activation; the last stage returns the microbatch's scalar
    mean loss (it gets the labels ``y``), the others an activation.
    ``params``: the tensors this stage's gradients are taken for.
    """

    def __init__(self, mesh, stage_forward: Callable, params, *,
                 axis: str = "pipe", n_microbatches: int = 8):
        self.grp = _pipe_group(mesh, axis)
        self.S = self.grp.size
        self.stage = self.grp.index
        self.M = int(n_microbatches)
        self.stage_forward = stage_forward
        self.params = list(params)
        self.idle_seconds = 0.0        # blocked in receives: the bubble

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.S - 1

    def _peer(self, d: int) -> int:
        return self.grp.ranks[self.stage + d]

    def _recv(self, shape, device, d: int):
        t0 = time.perf_counter()
        out = collectives.recv(shape, torch.float32, device, self._peer(d),
                               self.grp)
        self.idle_seconds += time.perf_counter() - t0
        return out

    def _send_shape(self, t, d: int):
        head = torch.zeros(9, dtype=torch.int64)
        head[0] = t.dim()
        head[1:1 + t.dim()] = torch.tensor(t.shape)
        collectives.send(head, self._peer(d), self.grp)

    def _recv_shape(self, d: int):
        t0 = time.perf_counter()
        head = collectives.recv((9,), torch.int64, "cpu", self._peer(d),
                                self.grp)
        self.idle_seconds += time.perf_counter() - t0
        return tuple(int(v) for v in head[1:1 + int(head[0])])

    def run(self, xs, ys, device):
        """One batch: ``xs`` / ``ys`` are the M microbatches (lists).
        Returns (the mean of the microbatch losses, a float on every
        rank; the gradients of ``params``, summed over the
        microbatches of the mean)."""
        M = self.M
        ins: List[Optional[torch.Tensor]] = [None] * M
        outs: List[torch.Tensor] = [None] * M
        grads = [torch.zeros_like(p) for p in self.params]
        shape = None
        # ---- every microbatch forward
        for m in range(M):
            if self.first:
                h = xs[m]
            else:
                if shape is None:
                    shape = self._recv_shape(-1)
                h = self._recv(shape, device, -1).requires_grad_(True)
                ins[m] = h
            out = self.stage_forward(h, ys[m] if self.last else None, m)
            if not self.last:
                if m == 0:
                    self._send_shape(out, +1)
                collectives.send(out.detach(), self._peer(+1), self.grp)
            outs[m] = out
        # ---- every microbatch backward
        losses = []
        for m in range(M):
            if self.last:
                losses.append(outs[m].detach())
                target, g_out = outs[m] / M, None
            else:
                target = outs[m]
                g_out = self._recv(outs[m].shape, device, +1)
            wrt = self.params + ([ins[m]] if not self.first else [])
            got = torch.autograd.grad(target, wrt, grad_outputs=g_out,
                                      allow_unused=True)
            for i, g in enumerate(got[:len(self.params)]):
                if g is not None:
                    grads[i] += g
            if not self.first:
                g_in = got[-1]
                collectives.send(torch.zeros_like(ins[m]) if g_in is None
                                 else g_in, self._peer(-1), self.grp)
            outs[m] = ins[m] = None
        loss = torch.zeros((), dtype=torch.float32,
                           device=device if self.grp.backend == "nccl"
                           else "cpu")
        if self.last:
            loss += torch.stack(losses).mean().to(loss.device)
        collectives.broadcast_(loss, self.grp, self.S - 1, kind="pipe")
        return float(loss), grads


def _layer_signature(layer, params):
    """Structural identity of a layer: config + param tree + shapes.
    Two layers with equal signatures compute the same function
    shape-wise, so their params can fold into one stage run."""
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves

    def structure(t):
        if isinstance(t, dict):
            return tuple((k, structure(t[k])) for k in sorted(t))
        if isinstance(t, (list, tuple)):
            return tuple(structure(v) for v in t)
        return "*"

    return (type(layer).__name__,
            tuple(sorted(layer.to_dict().items(), key=lambda kv: kv[0]))
            if hasattr(layer, "to_dict") else (),
            structure(params),
            tuple((tuple(a.shape), str(a.dtype))
                  for a in tree_leaves(params)))


def _longest_identical_run(sigs):
    best = (0, 0)
    i = 0
    while i < len(sigs):
        j = i
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best


def _refuse_unsupported(model):
    layers = model.layers
    if not layers[-1].has_loss():
        raise ValueError("last layer has no loss — the pipeline head "
                         "needs one")
    for i, l in enumerate(layers):
        name = type(l).__name__
        if getattr(l, "gradient_normalization", None):
            raise ValueError(
                f"layer {i} ({name}) configures gradient normalization — "
                "not supported on the pipeline bridge")
        if (getattr(l, "l1", 0.0) or getattr(l, "l2", 0.0)
                or getattr(l, "l1_bias", 0.0) or getattr(l, "l2_bias", 0.0)):
            raise ValueError(
                f"layer {i} ({name}) configures l1/l2 regularization — "
                "the bridge's partitioned loss does not add the "
                "regularization term; remove it or use the GPipe "
                "scheduler")
        if getattr(l, "constraints", ()):
            raise ValueError(
                f"layer {i} ({name}) configures parameter constraints — "
                "not applied by the bridge's partitioned update; remove "
                "them or use the GPipe scheduler")
        if getattr(l, "updater", None) is not None:
            raise ValueError(
                f"layer {i} ({name}) overrides the updater — use one "
                "network-level updater on the pipeline bridge")
    if getattr(model.conf.conf, "gradient_clip", None) is not None:
        raise ValueError(
            "network-level gradient clipping is not supported on the "
            "pipeline bridge: the stages update separately, so a global "
            "norm would be computed per stage")


class NetworkSpmdPipeline:
    """A config-built MultiLayerNetwork over the pipe group of ``mesh``
    (module docstring). Every rank builds it from the same model (same
    weights) and calls :meth:`train_batch` with the same batch."""

    def __init__(self, model, mesh, *, axis: str = "pipe",
                 n_microbatches: int = 8):
        from deeplearning4j_tpu_torch.models.multi_layer_network import (
            MultiLayerNetwork)
        if not isinstance(model, MultiLayerNetwork):
            raise NotImplementedError(
                "NetworkSpmdPipeline bridges MultiLayerNetwork stacks; "
                f"got {type(model).__name__}")
        if model.params is None:
            model.init()
        _refuse_unsupported(model)
        grp = _pipe_group(mesh, axis)
        S = grp.size
        layers = model.layers
        params = model.params
        sigs = [_layer_signature(l, p) for l, p in zip(layers, params)]
        start, end = _longest_identical_run(sigs)
        n_run = ((end - start) // S) * S     # trailing extras -> suffix
        if n_run < S:
            raise ValueError(
                f"no run of >= {S} structurally identical layers to "
                f"pipeline over {S} stages (longest: {end - start}) — "
                "use the GPipe scheduler (parallel/pipeline.py) for "
                "heterogeneous stacks")
        end = start + n_run
        pre = dict(getattr(model.conf, "preprocessors", None) or {})
        for p in pre:
            if start < p < end:
                raise ValueError(
                    f"input preprocessor at layer {p} sits inside the "
                    f"folded stage run [{start}, {end}) — not supported; "
                    "use the GPipe scheduler")
        self.model = model
        self.mesh = mesh
        self._start, self._end = start, end
        self._n_per = n_per = n_run // S
        self._S = S
        s = grp.index
        lo = 0 if s == 0 else start + s * n_per
        hi = len(layers) if s == S - 1 else start + (s + 1) * n_per
        self.layer_range = (lo, hi)
        # the owner stage of every layer, for collect_params
        self._owner = [0 if i < start + n_per else
                       (S - 1 if i >= end - n_per else
                        (i - start) // n_per) for i in range(len(layers))]
        if model._optimizer is None:
            model._build_optimizer()
        self._step_seed = int(model.conf.conf.seed)
        self._states = None
        self.pipe = SpmdPipeline(
            mesh, self._stage_forward,
            [t for i in range(lo, hi) for t in _leaves(model.params[i])],
            axis=axis, n_microbatches=n_microbatches)

    # ---- one stage on one microbatch
    def _generator(self, layer_idx: int, m: int):
        if not any(getattr(l, "dropout", 0.0) for l in self.model.layers):
            return None
        seed = ((self._step_seed * 1000003 + self.model.iteration_count)
                * 1009 + layer_idx) * 1013 + m
        return torch.Generator(device=self.model.device).manual_seed(
            seed % (1 << 63))

    def _stage_forward(self, h, y, m):
        model = self.model
        lo, hi = self.layer_range
        params = model.params
        pre = model.conf.preprocessors
        last = len(model.layers) - 1
        for i in range(lo, hi):
            layer = model.layers[i]
            if i in pre:
                h = pre[i](h)
            gen = self._generator(i, m)
            if i == last:
                return layer.loss_from_input(params[i], h, y, training=True,
                                             generator=gen)
            h, new = layer.apply(params[i], self._states[i], h,
                                 training=True, generator=gen)
            self._states[i] = _detach(new)
        return h

    def train_batch(self, x, y) -> float:
        """One optimizer step over the GLOBAL (B, ...) arrays (B divides
        by n_microbatches); returns the batch mean loss."""
        from deeplearning4j_tpu_torch.device import as_device_tensor
        from deeplearning4j_tpu_torch.nn.conf.updaters import tree_map
        model = self.model
        M = self.pipe.M
        x, y = np.asarray(x), np.asarray(y)
        if x.shape[0] % M:
            raise ValueError(f"batch of {x.shape[0]} rows does not divide "
                             f"into {M} microbatches")
        xs = [as_device_tensor(a, model.device) for a in np.split(x, M)] \
            if self.pipe.first else [None] * M
        ys = [as_device_tensor(a, model.device) for a in np.split(y, M)] \
            if self.pipe.last else [None] * M
        self._states = list(model.state)
        loss, grads = self.pipe.run(xs, ys, model.device)
        # this stage's gradients into the params structure (zeros for the
        # layers other stages own: they are not this rank's to keep)
        it = iter(grads)
        lo, hi = self.layer_range
        full = [tree_map(lambda p: next(it), model.params[i])
                if lo <= i < hi else tree_map(torch.zeros_like,
                                              model.params[i])
                for i in range(len(model.layers))]
        loss_t = torch.tensor(loss, device=model.device)
        model._apply_step(loss_t, full, (self._states, None))
        model.iteration_count += 1
        model.score_value = loss_t
        return loss

    def collect_params(self, updater: bool = False):
        """Every layer's parameters and state (and with ``updater`` its
        updater state: the moments of Adam and the like) broadcast from
        the stage that owns it: every rank's model holds the trained
        network."""
        from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
        model, grp = self.model, self.pipe.grp
        per_layer = [list(tree_leaves(model.params[i]))
                     + list(tree_leaves(model.state[i]))
                     for i in range(len(model.layers))]
        if updater and model.opt_state is not None:
            for moments in _param_like(model.opt_state, model.params):
                for i, sub in enumerate(moments):
                    per_layer[i] += list(tree_leaves(sub))
        with torch.no_grad():
            for i, leaves in enumerate(per_layer):
                for t in leaves:
                    if t.is_floating_point():
                        collectives.broadcast_(t, grp, self._owner[i],
                                               kind="pipe")
        return model

    def describe(self) -> dict:
        return {"stages": self._S, "stage": self.pipe.stage,
                "layers": list(self.layer_range),
                "microbatches": self.pipe.M,
                "folded_run": [self._start, self._end],
                "idle_ms": self.pipe.idle_seconds * 1e3}


def _param_like(tree, params):
    """The subtrees of an updater state shaped like ``params`` (a
    moment a parameter), in order."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        _same_structure)
    if _same_structure(tree, params):
        return [tree]
    if isinstance(tree, dict):
        return [m for v in tree.values() for m in _param_like(v, params)]
    if isinstance(tree, (list, tuple)):
        return [m for v in tree for m in _param_like(v, params)]
    return []


def _leaves(tree):
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
    return list(tree_leaves(tree))


def _detach(tree):
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_map
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, tree)
