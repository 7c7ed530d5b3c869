"""Pipeline parallelism in one process: GPipe-style staged training
(counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``).

A MultiLayerNetwork's layer stack is split into S contiguous stages,
each stage's parameters on its own device (on one card every stage is
on ``cuda:0``); a batch is split into M microbatches that flow through
the stages, the activations moved between devices with ``.to`` (which
autograd follows back). GPipe schedule: every microbatch forward, then
one backward of the example-weighted sum of the microbatch losses plus
each stage's regularization terms; each stage's own updater (the
network's rule) steps once a batch, then the layers' constraints.
Stage boundaries are data (layer indices); the default balances them by
parameter count (:func:`_balance_boundaries`, the JAX package's rule).
For the rank-a-stage pipeline see ``parallel/pipeline_spmd.py``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["PipelineParallel"]


def _balance_boundaries(params, n_stages: int) -> List[int]:
    """Contiguous stage boundaries balanced by PARAM COUNT: a greedy
    cumulative split at multiples of total / n_stages."""
    sizes = [sum(int(np.prod(tuple(a.shape)))
                 for a in updaters_mod.tree_leaves(p)) or 1
             for p in params]
    total = sum(sizes)
    target = total / n_stages
    boundaries = [0]
    acc = 0.0
    for i, s in enumerate(sizes):
        if (len(boundaries) < n_stages
                and acc + s / 2 >= target * len(boundaries)
                and i > boundaries[-1]):
            boundaries.append(i)
        acc += s
    return boundaries


class PipelineParallel:
    """Split a MultiLayerNetwork across ``devices`` by layer ranges.
    ``boundaries``: the layer indices starting each stage, e.g. [0, 3,
    6] for 3 stages; default balanced by parameter count over the
    devices."""

    def __init__(self, net, devices: Optional[Sequence] = None,
                 boundaries: Optional[List[int]] = None,
                 n_microbatches: int = 4):
        self.net = net
        if devices is None:
            devices = [net.device]
        self.devices = [torch.device(d) for d in devices]
        if net.params is None:
            net.init()
        n_layers = len(net.layers)
        if boundaries is None:
            boundaries = _balance_boundaries(net.params, len(self.devices))
        self.boundaries = list(boundaries)
        self.n_microbatches = n_microbatches
        self._stage_ranges = [
            (b, boundaries[i + 1] if i + 1 < len(boundaries) else n_layers)
            for i, b in enumerate(boundaries)]
        self.stage_params = []
        self.stage_state = []
        for (lo, hi), dev in zip(self._stage_ranges, self.devices):
            self.stage_params.append([_to(p, dev, grad=True)
                                      for p in net.params[lo:hi]])
            self.stage_state.append([_to(s, dev) for s in net.state[lo:hi]])
        # one updater per stage: its params live on its device
        cfg = net.conf.conf.updater_cfg or updaters_mod.sgd()
        self._opts = [updaters_mod.to_transform(cfg)
                      for _ in self._stage_ranges]
        self.opt_states = [opt.init(sp) for opt, sp in
                           zip(self._opts, self.stage_params)]
        self.iteration_count = 0

    def _stage_forward(self, s, x, labels, m):
        lo, hi = self._stage_ranges[s]
        net = self.net
        h = x
        new_state = list(self.stage_state[s])
        for j, li in enumerate(range(lo, hi)):
            layer = net.layers[li]
            if li in net.conf.preprocessors:
                h = net.conf.preprocessors[li](h)
            gen = self._generator(li, m)
            if li == len(net.layers) - 1 and layer.has_loss():
                return layer.loss_from_input(self.stage_params[s][j], h,
                                             labels, training=True,
                                             generator=gen), new_state
            h, new_state[j] = layer.apply(self.stage_params[s][j],
                                          self.stage_state[s][j], h,
                                          training=True, generator=gen)
        return h, new_state

    def _generator(self, layer_idx: int, m: int):
        layer = self.net.layers[layer_idx]
        if not getattr(layer, "dropout", 0.0):
            return None
        seed = ((int(self.net.conf.conf.seed) * 1000003
                 + self.iteration_count) * 1009 + layer_idx) * 1013 + m
        return torch.Generator(
            device=self.devices[self._stage_of(layer_idx)]).manual_seed(
                seed % (1 << 63))

    def _stage_of(self, layer_idx: int) -> int:
        return next(s for s, (lo, hi) in enumerate(self._stage_ranges)
                    if lo <= layer_idx < hi)

    def train_batch(self, features, labels) -> float:
        """One GPipe batch: every microbatch through every stage, then
        one backward and one updater step a stage. Returns the
        example-weighted mean loss."""
        from deeplearning4j_tpu_torch.device import as_device_tensor
        from deeplearning4j_tpu_torch.train.constraints import (
            apply_layer_constraints)
        M = self.n_microbatches
        features = np.asarray(features)
        total = features.shape[0]
        xs = np.array_split(features, M)
        ys = np.array_split(np.asarray(labels), M)
        weights = [c.shape[0] / total for c in xs]
        S = len(self._stage_ranges)
        objective = 0.0
        losses = []
        new_states = [None] * S
        for m in range(M):
            h = as_device_tensor(xs[m], self.devices[0])
            for s in range(S):
                h = h.to(self.devices[s])
                y = as_device_tensor(ys[m], self.devices[s])
                h, st = self._stage_forward(s, h, y, m)
                new_states[s] = st       # the last microbatch's state
            losses.append(h.detach())
            objective = objective + h.to(self.devices[0]) * weights[m]
        for s in range(S):
            lo, hi = self._stage_ranges[s]
            reg = sum(self.net.layers[li].regularization_loss(p)
                      for li, p in zip(range(lo, hi),
                                       self.stage_params[s]))
            if isinstance(reg, torch.Tensor):
                objective = objective + reg.to(self.devices[0])
        leaves = [list(updaters_mod.tree_leaves(sp))
                  for sp in self.stage_params]
        flat = [t for ls in leaves for t in ls]
        got = torch.autograd.grad(objective, flat, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, got)])
        with torch.no_grad():
            for s in range(S):
                lo, hi = self._stage_ranges[s]
                grads = updaters_mod.tree_map(lambda _: next(it),
                                              self.stage_params[s])
                upd, self.opt_states[s] = self._opts[s].update(
                    grads, self.opt_states[s], self.stage_params[s])
                updaters_mod.apply_updates(self.stage_params[s], upd)
                for j, li in enumerate(range(lo, hi)):
                    p = self.stage_params[s][j]
                    for k, v in apply_layer_constraints(
                            self.net.layers[li], p).items():
                        if v is not p[k]:
                            p[k].copy_(v)
                self.stage_state[s] = [_to(t, self.devices[s])
                                       for t in new_states[s]]
        self.iteration_count += 1
        loss = float(sum(float(l) * w for l, w in zip(losses, weights)))
        self.net.score_value = loss
        return loss

    def collect_params(self):
        """Write the stages' params and state back into the network
        (on its own device), for evaluation or a checkpoint."""
        flat, flat_state = [], []
        for sp, ss in zip(self.stage_params, self.stage_state):
            flat.extend(_to(p, self.net.device) for p in sp)
            flat_state.extend(_to(s, self.net.device) for s in ss)
        self.net.set_params(flat)
        self.net.state = flat_state
        return self.net


def _to(tree, device, grad: bool = False):
    """A copy of ``tree`` on ``device`` (leaves requiring grad when
    ``grad``)."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().to(device).clone()
        return t.requires_grad_(True) if grad and t.is_floating_point() \
            else t
    return updaters_mod.tree_map(leaf, tree)
