"""ComputationGraph: the DAG executor (counterpart of
``deeplearning4j_tpu/models/computation_graph.py``), as an
``nn.Module`` on an explicit device.

The forward walks the configuration's cached topological order; each
layer vertex consumes its wired input's mask and each graph vertex
routes masks by its own rule (``GraphVertex.propagate_mask``), as in
the JAX package. Training sums the output layers' losses and the L1/L2
terms, then runs the JAX package's ``_train_core`` eagerly:
``torch.autograd.grad``, per-vertex gradient normalization, the updater
(``nn/conf/updaters.py``: the global rule, per-vertex ``updater``
overrides through a multi-transform, ``gradient_clip`` chained in
front), the constraints. Parameters are updated in place.

Params and state are dicts keyed by vertex name (every layer vertex,
``{}`` for one without params), so checkpoints, ``updater_state`` and
``params_flat`` agree with the JAX package's key for key. Dropout bits
come from the network's ``torch.Generator`` (the JAX package folds the
vertex's topological index into its key), so the two agree with
dropout off.

Not ported yet, and raising ``NotImplementedError`` when asked for:
tBPTT, ``rnn_time_step``, ``streaming_session`` and ``pretrain``
(ROADMAP A5b), meshes (A6), k-step fusion, ``warmup`` and listeners
(A7).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import as_device_tensor, resolve_device
from deeplearning4j_tpu_torch.models.multi_layer_network import _ParamTree
from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod
from deeplearning4j_tpu_torch.nn.conf.graph import (LastTimeStepVertex,
                                                    combine_masks_or)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer
from deeplearning4j_tpu_torch.train.constraints import (
    apply_layer_constraints)
from deeplearning4j_tpu_torch.train.gradnorm import (
    apply_gradient_normalization)
from deeplearning4j_tpu_torch.util.tree import (tree_copy,
                                                tree_flat_vector,
                                                tree_from_flat_vector,
                                                tree_to_device)

__all__ = ["ComputationGraph"]

_NOT_PORTED = "is not ported to deeplearning4j_tpu_torch yet (ROADMAP {})"


class ComputationGraph(nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device="cuda"):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        # one _ParamTree a layer vertex, in topological order
        self.vertex_params = nn.ModuleList()
        self._param_names: List[str] = [
            n for n in conf.topological_order()
            if isinstance(conf.vertices[n][0], Layer)]
        self.state: Optional[Dict[str, dict]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.opt_state = None
        self.score_value: object = float("nan")
        self._optimizer: Optional[updaters_mod.Transform] = None
        self._generator: Optional[torch.Generator] = None

    # ---- parameters ----
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Sample every layer vertex's parameters, in topological order,
        from a CPU ``torch.Generator`` seeded with ``seed`` (default:
        the config's), then place them on the network's device."""
        seed = self.conf.conf.seed if seed is None else seed
        params, states = self._sample_params(seed)
        self.set_params(params)
        self.state = tree_to_device(states, self.device)
        self._generator = self._new_generator(seed)
        self._build_optimizer()
        return self

    def _new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _sample_params(self, seed: int):
        """(params, states) as CPU tensors, by vertex name."""
        g = torch.Generator().manual_seed(int(seed))
        params, states = {}, {}
        for name in self._param_names:
            obj = self.conf.vertices[name][0]
            p, s = obj.initialize(g, self.conf.vertex_input_type(name))
            params[name] = p
            states[name] = s
        return params, states

    @property
    def params(self) -> Optional[Dict[str, dict]]:
        if len(self.vertex_params) == 0 and self._param_names:
            return None
        return {name: p.tree()
                for name, p in zip(self._param_names, self.vertex_params)}

    def set_params(self, params: Dict[str, dict]) -> None:
        """Replace every layer vertex's parameters (tensors or numpy
        arrays, by vertex name) with copies on the network's device.
        The updater state is kept."""
        missing = set(self._param_names) - set(params)
        if missing:
            raise ValueError(f"no params for vertices {sorted(missing)}")
        self.vertex_params = nn.ModuleList(
            _ParamTree(params[n], self.device) for n in self._param_names)
        if self.state is None:
            self.state = {n: {} for n in self._param_names}

    def _layer_configs(self) -> Dict[str, Layer]:
        return {n: self.conf.vertices[n][0] for n in self._param_names}

    def _build_optimizer(self):
        """The updater of the config (the JAX package's
        ``_build_optimizer``) and its fresh state."""
        global_cfg = self.conf.conf.updater_cfg or updaters_mod.sgd()
        overrides = {n: obj.updater for n, obj in
                     self._layer_configs().items()
                     if getattr(obj, "updater", None) is not None}
        if overrides:
            transforms = {"__global__": updaters_mod.to_transform(global_cfg)}
            labels = {}
            for name in self._param_names:
                if name in overrides:
                    transforms[name] = updaters_mod.to_transform(
                        overrides[name])
                    labels[name] = name
                else:
                    labels[name] = "__global__"
            opt = updaters_mod.multi_transform(transforms, labels)
        else:
            opt = updaters_mod.to_transform(global_cfg)
        self._optimizer = updaters_mod.with_gradient_clip(
            opt, self.conf.conf.gradient_clip)
        self.opt_state = self._optimizer.init(self.params)

    # ---- forward ----
    def _forward(self, inputs, *, training, generator=None, fmasks=None,
                 exclude_outputs: bool = False):
        """The topological-order interpreter. Returns (activations by
        vertex name, the layer vertices' new states). With
        ``exclude_outputs`` an output layer with a loss passes its input
        through, for the loss to take."""
        params = self.params
        acts: Dict[str, torch.Tensor] = dict(
            zip(self.conf.network_inputs, inputs))
        masks: Dict[str, Optional[torch.Tensor]] = {
            n: None for n in self.conf.network_inputs}
        if fmasks is not None:
            masks.update(zip(self.conf.network_inputs, fmasks))
        new_state = {}
        for name in self.conf.topological_order():
            obj, ins = self.conf.vertices[name]
            xs = [acts[i] for i in ins]
            in_masks = [masks.get(i) for i in ins]
            if isinstance(obj, Layer):
                in_mask = in_masks[0]
                if exclude_outputs and name in self.conf.network_outputs \
                        and obj.has_loss():
                    acts[name] = xs[0]
                    new_state[name] = self.state[name]
                    masks[name] = in_mask
                    continue
                y, new_state[name] = obj.apply(
                    params[name], self.state[name], xs[0],
                    training=training, generator=generator, mask=in_mask)
                acts[name] = y
                # a layer that collapses time nulls the (B, T) mask
                if in_mask is not None and (y.dim() < 3
                                            or y.shape[1] != in_mask.shape[1]):
                    masks[name] = None
                else:
                    masks[name] = in_mask
            else:
                if isinstance(obj, LastTimeStepVertex) and \
                        obj.mask_input is not None:
                    use_mask = masks.get(obj.mask_input)
                else:
                    use_mask = combine_masks_or(in_masks)
                acts[name] = obj.apply(xs, mask=use_mask)
                masks[name] = obj.propagate_mask(in_masks, xs,
                                                 mask_env=masks)
        return acts, new_state

    def forward(self, *inputs):
        acts, _ = self._forward(inputs, training=False)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs if len(outs) > 1 else outs[0]

    def _tensors(self, arrays):
        if arrays is None:
            return None
        return tuple(as_device_tensor(a, self.device) for a in arrays)

    def output(self, *inputs, training: bool = False, input_masks=None):
        """Inference on numpy or tensor inputs (moved to the network's
        device): the output vertices' activations, one tensor for a
        single output."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            acts, _ = self._forward(
                self._tensors(inputs), training=training,
                generator=self._generator if training else None,
                fmasks=self._tensors(input_masks))
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs if len(outs) > 1 else outs[0]

    def feed_forward(self, *inputs, training: bool = False,
                     input_masks=None) -> Dict[str, torch.Tensor]:
        """Every vertex's activation, by name."""
        with torch.inference_mode():
            acts, _ = self._forward(
                self._tensors(inputs), training=training,
                generator=self._generator if training else None,
                fmasks=self._tensors(input_masks))
        return acts

    # ---- training ----
    @staticmethod
    def _as_multi(ds) -> MultiDataSet:
        if isinstance(ds, MultiDataSet):
            return ds
        if isinstance(ds, DataSet):
            return MultiDataSet(
                [ds.features], [ds.labels],
                [ds.features_mask] if ds.features_mask is not None else None,
                [ds.labels_mask] if ds.labels_mask is not None else None)
        raise TypeError(type(ds))

    def _batch_tuple(self, mds: MultiDataSet):
        return (self._tensors(mds.features), self._tensors(mds.labels),
                self._tensors(mds.features_masks),
                self._tensors(mds.labels_masks))

    def _loss(self, batch, *, training=True, generator=None):
        """(the outputs' summed losses + L1/L2 terms, new states)."""
        inputs, labels, fmasks, lmasks = batch
        acts, new_state = self._forward(inputs, training=training,
                                        generator=generator, fmasks=fmasks,
                                        exclude_outputs=True)
        params = self.params
        total = torch.zeros((), device=self.device)
        for i, out_name in enumerate(self.conf.network_outputs):
            obj = self.conf.vertices[out_name][0]
            if not (isinstance(obj, Layer) and obj.has_loss()):
                raise ValueError(f"Output vertex '{out_name}' has no loss")
            total = total + obj.loss_from_input(
                params[out_name], acts[out_name], labels[i],
                training=training, generator=generator,
                mask=lmasks[i] if lmasks is not None else None)
        for name, obj in self._layer_configs().items():
            total = total + obj.regularization_loss(params[name])
        return total, new_state

    def _gradients(self, batch):
        """(loss, grads by vertex name, new states) of one training
        forward."""
        params = self.params
        leaves = list(updaters_mod.tree_leaves(params))
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        loss, new_state = self._loss(batch, training=True,
                                     generator=self._generator)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        return (loss.detach(),
                updaters_mod.tree_map(lambda _: next(grads), params),
                new_state)

    def _train_step(self, batch) -> torch.Tensor:
        """loss -> grads -> gradient normalization -> updater ->
        constraints. Returns the loss as a device scalar, without a
        host sync."""
        loss, grads, new_state = self._gradients(batch)
        grads = apply_gradient_normalization(self._layer_configs(), grads)
        params = self.params
        with torch.no_grad():
            updates, self.opt_state = self._optimizer.update(
                grads, self.opt_state, params)
            updaters_mod.apply_updates(params, updates)
            for name, obj in self._layer_configs().items():
                p = params[name]
                for k, v in apply_layer_constraints(obj, p).items():
                    if v is not p[k]:
                        p[k].copy_(v)
        self.state = new_state
        return loss

    def fit(self, data, *, epochs: int = 1,
            steps_per_device_call: int = 1, mesh_spec=None):
        """Train over a DataSet, a MultiDataSet, or an iterable of
        either, one updater step per batch."""
        if int(steps_per_device_call) != 1:
            raise NotImplementedError(
                f"k-step fusion {_NOT_PORTED.format('A7')}")
        if mesh_spec is not None:
            raise NotImplementedError(
                f"mesh training {_NOT_PORTED.format('A6')}")
        if self.params is None:
            self.init()
        if self._optimizer is None:
            self._build_optimizer()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif not isinstance(data, (list, tuple)) and \
                not hasattr(data, "reset"):
            data = list(data)     # a generator would be spent after epoch 1
        tbptt = self.conf.conf.tbptt
        for _ in range(epochs):
            for ds in data:
                mds = self._as_multi(ds)
                if tbptt is not None and any(np.ndim(f) == 3
                                             for f in mds.features):
                    raise NotImplementedError(
                        f"tBPTT {_NOT_PORTED.format('A5b')}")
                self.score_value = self._train_step(self._batch_tuple(mds))
                self.iteration_count += 1
            self.epoch_count += 1
        return self

    def score(self, ds) -> float:
        """The summed loss (with L1/L2 terms) on ``ds``, dropout off."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(self._batch_tuple(self._as_multi(ds)),
                                 training=False)
        return float(loss)

    def evaluate(self, data, output_index: int = 0):
        """Classification metrics of output ``output_index`` over a
        DataSet, a MultiDataSet or an iterable of either."""
        from deeplearning4j_tpu_torch.evaluation.classification import (
            Evaluation)
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        ev = Evaluation()
        for ds in data:
            mds = self._as_multi(ds)
            preds = self.output(*mds.features,
                                input_masks=mds.features_masks)
            if not isinstance(preds, tuple):
                preds = (preds,)
            lmask = (mds.labels_masks[output_index]
                     if mds.labels_masks is not None else None)
            ev.eval(mds.labels[output_index],
                    preds[output_index].float().cpu().numpy(), mask=lmask)
        return ev

    # ---- flat params, copies, summary ----
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params_flat(self) -> np.ndarray:
        return tree_flat_vector(self.params)

    def set_params_flat(self, flat: np.ndarray) -> None:
        self.set_params(tree_from_flat_vector(self.params, flat))

    def clone(self) -> "ComputationGraph":
        g = ComputationGraph(self.conf.clone(), device=self.device)
        if self.params is not None:
            g.init()
            g.set_params(self.params)
            g.state = tree_copy(self.state)
        return g

    def summary(self) -> str:
        lines = ["name                 type                      inputs"]
        for name in self.conf.topological_order():
            obj, ins = self.conf.vertices[name]
            lines.append(f"{name:<20} {type(obj).__name__:<25} {ins}")
        if self.params is not None:
            lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

    # ---- not ported yet ----
    def rnn_time_step(self, *inputs):
        raise NotImplementedError(
            f"ComputationGraph.rnn_time_step {_NOT_PORTED.format('A5b')}")

    def streaming_session(self, capacity: int, batch: int):
        raise NotImplementedError(
            f"GraphStreamingSession {_NOT_PORTED.format('A5b')}")

    def pretrain(self, data, *, epochs: int = 1):
        raise NotImplementedError(
            f"layerwise pretraining {_NOT_PORTED.format('A5b')}")

    def warmup(self, example, *, steps_per_device_call: int = 1,
               mesh_spec=None):
        raise NotImplementedError(
            f"training warmup {_NOT_PORTED.format('A7')}")

    def set_listeners(self, *listeners):
        raise NotImplementedError(
            f"training listeners {_NOT_PORTED.format('A7')}")

    add_listeners = set_listeners
