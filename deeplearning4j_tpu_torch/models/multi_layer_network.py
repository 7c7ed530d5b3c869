"""MultiLayerNetwork: the sequential-stack executor (counterpart of
``deeplearning4j_tpu/models/multi_layer_network.py``), as an
``nn.Module`` on an explicit device.

Parameters keep the JAX package's structure: ``net.params`` is a list
with one ``{name: tensor}`` dict per layer index (nested for the
transformer block's ``attn``), and the same ``"1/attn/Wq"`` paths name
them in the checkpoint. Weights keep the JAX layout, ``W`` as
``(n_in, n_out)`` for ``x @ W``.

Training is the JAX package's ``_train_core`` written eagerly: the loss
(forward to the output layer's input, the layer's loss, L1/L2 terms),
``torch.autograd.grad``, per-layer gradient normalization, the updater
(``nn/conf/updaters.py``, optax's rules and state layout, per-layer
overrides and ``gradient_clip``), then the layer constraints. The
parameters are updated in place. ``output`` runs under
``torch.inference_mode``. Not ported yet (ROADMAP queue A7): tBPTT,
k-step fusion, AOT warmup, listeners, health and meshes; asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (ArrayDataSetIterator,
                                                     DataSetIterator,
                                                     ListDataSetIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.train.constraints import (
    apply_layer_constraints)
from deeplearning4j_tpu_torch.train.gradnorm import (
    apply_gradient_normalization)

__all__ = ["MultiLayerNetwork"]

_NOT_PORTED = "is not ported to deeplearning4j_tpu_torch yet (ROADMAP A7)"


def _as_iterator(data, labels=None, batch_size=None) -> DataSetIterator:
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        if batch_size is None:
            return ListDataSetIterator([data])
        return ListDataSetIterator(data.batch_by(batch_size))
    if labels is not None:
        return ArrayDataSetIterator(data, labels,
                                    batch_size or data.shape[0])
    raise TypeError(f"Cannot build iterator from {type(data)}")


class _ParamTree(nn.Module):
    """One layer's nested ``{name: tensor}`` dict as registered
    parameters, so ``.to()``, ``state_dict()`` and device placement
    work as for any module."""

    def __init__(self, tree: Dict[str, object], device: torch.device):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value, device))
            else:
                t = torch.as_tensor(value, dtype=torch.float32)
                self.register_parameter(name, nn.Parameter(
                    t.detach().to(device).clone()))

    def tree(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = child.tree()
        return out


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration, *, device="cuda"):
        super().__init__()
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.layer_params = nn.ModuleList()
        self.state: Optional[List[dict]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.opt_state = None
        self.score_value: object = float("nan")
        self._optimizer: Optional[updaters_mod.Transform] = None
        self._generator: Optional[torch.Generator] = None

    # ---- parameters ----
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Sample every layer's parameters from a CPU ``torch.Generator``
        seeded with ``seed`` (default: the config's), then place them on
        the network's device."""
        seed = self.conf.conf.seed if seed is None else seed
        params, self.state = self._sample_params(seed)
        self.set_params(params)
        self._generator = self._new_generator(seed)
        self._build_optimizer()
        return self

    def _new_generator(self, seed: int) -> torch.Generator:
        """The dropout bits' generator, on the network's device (where
        the JAX package folds a PRNG key per step and layer)."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _sample_params(self, seed: int):
        """(params, states) as CPU tensors, in layer order."""
        g = torch.Generator().manual_seed(int(seed))
        params, states = [], []
        t = self.conf.input_type
        for layer in self.layers:
            if t is not None:
                layer.set_n_in(t)
            p, s = layer.initialize(g, t)
            params.append(p)
            states.append(s)
            if t is not None:
                t = layer.output_type(t)
        return params, states

    @property
    def params(self) -> Optional[List[Dict[str, object]]]:
        if len(self.layer_params) == 0 and self.layers:
            return None
        return [p.tree() for p in self.layer_params]

    def set_params(self, params: List[Dict[str, object]]) -> None:
        """Replace every layer's parameters (tensors or numpy arrays,
        in the ``params`` structure) with copies on the network's
        device. The updater state is kept."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(self.layers)} layers")
        self.layer_params = nn.ModuleList(
            _ParamTree(p, self.device) for p in params)
        if self.state is None:
            self.state = [{} for _ in self.layers]

    def _build_optimizer(self):
        """The updater of the config (``_build_optimizer`` of the JAX
        package): the global rule, per-layer ``updater`` overrides
        through a multi-transform, ``gradient_clip`` chained in front;
        and its fresh state."""
        global_cfg = self.conf.conf.updater_cfg or updaters_mod.sgd()
        overrides = [getattr(l, "updater", None) for l in self.layers]
        if any(o is not None for o in overrides):
            transforms = {"__global__": updaters_mod.to_transform(global_cfg)}
            labels = []
            for i, o in enumerate(overrides):
                name = "__global__"
                if o is not None:
                    name = f"layer{i}"
                    transforms[name] = updaters_mod.to_transform(o)
                labels.append(name)
            opt = updaters_mod.multi_transform(transforms, labels)
        else:
            opt = updaters_mod.to_transform(global_cfg)
        clip = self.conf.conf.gradient_clip
        if clip is not None:
            if clip["type"] == "norm":
                pre = updaters_mod.clip_by_global_norm(clip["v"])
            elif clip["type"] == "value":
                pre = updaters_mod.clip(clip["v"])
            else:
                raise ValueError(clip)
            opt = updaters_mod.chain(pre, opt)
        self._optimizer = opt
        self.opt_state = opt.init(self.params)

    # ---- forward ----
    def _forward(self, x, *, training, generator=None, fmask=None,
                 upto: Optional[int] = None):
        """Layers ``[0, upto)`` on ``x``; returns (activations, the
        layers' new states)."""
        params = self.params
        n = len(self.layers) if upto is None else upto
        new_states = list(self.state)
        for i in range(n):
            x, new_states[i] = self.layers[i].apply(
                params[i], self.state[i], x, training=training,
                generator=generator, mask=fmask)
        return x, new_states

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x, training=False)[0]

    def output(self, x) -> torch.Tensor:
        """Inference on numpy or tensor input (moved to the network's
        device); returns a tensor on that device."""
        if self.params is None:
            self.init()
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = torch.as_tensor(x, device=self.device)
        with torch.inference_mode():
            return self(x)

    # ---- training ----
    def _to_device(self, a):
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        if a.dtype.kind == "f" and a.dtype != np.float32:
            a = a.astype(np.float32)       # as JAX canonicalizes f64
        return torch.from_numpy(a).to(self.device)

    def _batch_tuple(self, ds: DataSet):
        return tuple(self._to_device(a) for a in
                     (ds.features, ds.labels, ds.features_mask,
                      ds.labels_mask))

    def _loss(self, batch, *, training=True, generator=None):
        """(loss + L1/L2 terms, the layers' new states)."""
        x, labels, fmask, lmask = batch
        out_idx = len(self.layers) - 1
        out_layer = self.layers[out_idx]
        if not out_layer.has_loss():
            raise ValueError("Last layer has no loss; use an OutputLayer/"
                             "LossLayer for fit()")
        h, new_states = self._forward(x, training=training,
                                      generator=generator, fmask=fmask,
                                      upto=out_idx)
        params = self.params
        loss = out_layer.loss_from_input(params[out_idx], h, labels,
                                         training=training,
                                         generator=generator, mask=lmask)
        for layer, p in zip(self.layers, params):
            loss = loss + layer.regularization_loss(p)
        return loss, new_states

    def _gradients(self, batch):
        """(loss, grads in the params structure, new states) of one
        training forward."""
        params = self.params
        leaves = list(updaters_mod.tree_leaves(params))
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        loss, new_states = self._loss(batch, training=True,
                                      generator=self._generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        return (loss.detach(), updaters_mod.tree_map(lambda _: next(grads),
                                                     params), new_states)

    def _train_step(self, batch) -> torch.Tensor:
        """loss -> grads -> gradient normalization -> updater ->
        constraints (``_train_core`` of the JAX package). Returns the
        loss as a device scalar, without a host sync."""
        loss, grads, new_states = self._gradients(batch)
        grads = apply_gradient_normalization(self.layers, grads)
        params = self.params
        with torch.no_grad():
            updates, self.opt_state = self._optimizer.update(
                grads, self.opt_state, params)
            updaters_mod.apply_updates(params, updates)
            for layer, p in zip(self.layers, params):
                for k, v in apply_layer_constraints(layer, p).items():
                    if v is not p[k]:
                        p[k].copy_(v)
        self.state = new_states
        return loss

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None,
            steps_per_device_call: int = 1, mesh_spec=None):
        """Train over a DataSet, an iterator, or (features, labels)
        arrays, one updater step per batch."""
        if int(steps_per_device_call) != 1:
            raise NotImplementedError(f"k-step fusion {_NOT_PORTED}")
        if mesh_spec is not None:
            raise NotImplementedError(f"mesh training {_NOT_PORTED}")
        if self.params is None:
            self.init()
        if self._optimizer is None:
            self._build_optimizer()
        it = _as_iterator(data, labels, batch_size)
        tbptt = self.conf.conf.tbptt
        for _ in range(epochs):
            for ds in it:
                if tbptt is not None and ds.features.ndim == 3:
                    raise NotImplementedError(f"tBPTT {_NOT_PORTED}")
                self.score_value = self._train_step(self._batch_tuple(ds))
                self.iteration_count += 1
            self.epoch_count += 1
        return self

    def score(self, ds: DataSet) -> float:
        """The loss (with L1/L2 terms) on ``ds``, dropout off."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(self._batch_tuple(ds), training=False)
        return float(loss)

    def set_listeners(self, *listeners):
        raise NotImplementedError(f"training listeners {_NOT_PORTED}")

    add_listeners = set_listeners
