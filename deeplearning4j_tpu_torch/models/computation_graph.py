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

tBPTT splits every time-series array of a MultiDataSet into
``fwd_length`` chunks and threads the recurrent vertices' carries across
them detached; ``rnn_time_step`` and ``streaming_session``
(``models/streaming.py``'s ``GraphStreamingSession``) step the graph
over recurrent carries and KV caches, as on MultiLayerNetwork.

A ``CenterLossOutputLayer`` output adds ``lambda_ * center_loss`` and
moves its centers, as on MultiLayerNetwork. ``pretrain`` trains each
layer vertex that has a ``pretrain_loss``, in topological order, on its
input computed by the ancestor subgraph of that input alone.

``fit`` runs MultiLayerNetwork's loop (``fit_epochs``: the data wait
timed apart from the step, the tracer's spans, the listeners, the flight
recorder) over the same training programs (``models/kstep.py``: a CUDA
graph a batch signature on a card, k steps a program with
``steps_per_device_call=k``; ``fit_batches`` and ``warmup`` as on
MultiLayerNetwork); ``evaluate``, ``evaluate_regression`` and
``evaluate_roc`` score one output, ``evaluate_outputs`` every output in
one pass. ``fit(mesh_spec="dp=N")`` trains data-parallel as
MultiLayerNetwork does (each output's masked loss over the global
batch's mask total), and ``fit(mesh_spec="dp=N,tp=M")`` tensor-parallel
with the rules keyed by vertex name (``tensor_parallel.graph_tp_rules``;
an op vertex takes full features). Sequence meshes train through
``ParallelWrapper``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.device import as_device_tensor, resolve_device
from deeplearning4j_tpu_torch.models.kstep import (KStepExecutorMixin,
                                                   assign_tree, host_batch)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    _detach, _ParamTree, check_fit_args, eval_one, fit_epochs, grads_of,
    pretrain_step)
from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod
from deeplearning4j_tpu_torch.nn.conf.graph import (LastTimeStepVertex,
                                                    combine_masks_or)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer
from deeplearning4j_tpu_torch.nn.conf.layers.output import (
    CenterLossOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
    BaseRecurrentLayer)
from deeplearning4j_tpu_torch.nn.errors import layer_error_context
from deeplearning4j_tpu_torch.observability.health import fused_health
from deeplearning4j_tpu_torch.parallel import global_batch, tensor_parallel
from deeplearning4j_tpu_torch.train.constraints import (
    apply_layer_constraints)
from deeplearning4j_tpu_torch.train.gradnorm import (
    apply_gradient_normalization)
from deeplearning4j_tpu_torch.util.tree import (tree_copy,
                                                tree_flat_vector,
                                                tree_from_flat_vector,
                                                tree_to_device)

__all__ = ["ComputationGraph"]


class ComputationGraph(KStepExecutorMixin, nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration, *,
                 device="cuda"):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self._init_programs()
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
        self._rnn_state: Optional[dict] = None
        self.listeners: list = []
        # (data_wait_s, dispatch_s) of the latest fit iteration
        self._step_timing = None

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
        self._flush_compiled_programs()
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
                 exclude_outputs: bool = False, carries=None, only=None):
        """The topological-order interpreter. Returns (activations by
        vertex name, the layer vertices' new states, the new carries).
        With ``exclude_outputs`` an output layer with a loss passes its
        input through, for the loss to take. ``carries``: recurrent
        (h, c) initial states by vertex name (missing: zeros), which
        tBPTT threads across chunks; without it the new carries are
        None. ``only``: the set of vertices to run (None: all). A
        failure in a vertex raises ``NetworkExecutionError`` naming it
        (``nn/errors.py``)."""
        params = self.params
        acts: Dict[str, torch.Tensor] = dict(
            zip(self.conf.network_inputs, inputs))
        masks: Dict[str, Optional[torch.Tensor]] = {
            n: None for n in self.conf.network_inputs}
        if fmasks is not None:
            masks.update(zip(self.conf.network_inputs, fmasks))
        new_state = {}
        new_carries = None if carries is None else {}
        # tensor parallelism: which activations hold feature shards
        tp, sharded = self._tp, {}
        for name in self.conf.topological_order():
            if only is not None and name not in only:
                continue
            obj, ins = self.conf.vertices[name]
            self._where = f"vertex {name!r} ({type(obj).__name__})"
            xs = [acts[i] for i in ins]
            in_masks = [masks.get(i) for i in ins]
            if tp is not None:
                if isinstance(obj, Layer):
                    xs[0] = tp.prepare(name, xs[0], sharded.get(ins[0],
                                                                False))
                    sharded[name] = tp.out_sharded(name)
                else:
                    xs = [tp.full(x, sharded.get(i, False))
                          for x, i in zip(xs, ins)]
            if isinstance(obj, Layer):
                in_mask = in_masks[0]
                if exclude_outputs and name in self.conf.network_outputs \
                        and obj.has_loss():
                    acts[name] = xs[0]
                    new_state[name] = self.state[name]
                    masks[name] = in_mask
                    continue
                with layer_error_context(f"vertex '{name}'", obj, xs[0]):
                    if carries is not None and isinstance(
                            obj, BaseRecurrentLayer):
                        c0 = carries.get(name)
                        if c0 is None:
                            c0 = obj.zero_state(xs[0].shape[0],
                                                device=xs[0].device)
                        xd = obj.apply_input_dropout(
                            xs[0], training=training, generator=generator)
                        y, new_carries[name] = obj.apply_rnn(
                            params[name], xd, c0, training=training,
                            generator=generator, mask=in_mask)
                        new_state[name] = self.state[name]
                    elif tp is not None:
                        with tp.layer(name):
                            y, new_state[name] = obj.apply(
                                params[name], self.state[name], xs[0],
                                training=training, generator=generator,
                                mask=in_mask)
                    else:
                        y, new_state[name] = obj.apply(
                            params[name], self.state[name], xs[0],
                            training=training, generator=generator,
                            mask=in_mask)
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
                with layer_error_context(f"vertex '{name}'", obj,
                                         xs[0] if xs else None):
                    acts[name] = obj.apply(xs, mask=use_mask)
                masks[name] = obj.propagate_mask(in_masks, xs,
                                                 mask_env=masks)
        if tp is not None:
            acts = {n: tp.full(a, sharded.get(n, False))
                    for n, a in acts.items()}
        return acts, new_state, new_carries

    def forward(self, *inputs):
        acts, _, _ = self._forward(inputs, training=False)
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
            acts, _, _ = self._forward(
                self._tensors(inputs), training=training,
                generator=self._generator if training else None,
                fmasks=self._tensors(input_masks))
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        return outs if len(outs) > 1 else outs[0]

    def feed_forward(self, *inputs, training: bool = False,
                     input_masks=None) -> Dict[str, torch.Tensor]:
        """Every vertex's activation, by name."""
        with torch.inference_mode():
            acts, _, _ = self._forward(
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

    def _loss(self, batch, *, training=True, generator=None, carries=None):
        """(the outputs' summed losses + L1/L2 terms, (new states, the new
        carries: None without ``carries``))."""
        inputs, labels, fmasks, lmasks = batch
        acts, new_state, new_carries = self._forward(
            inputs, training=training, generator=generator, fmasks=fmasks,
            exclude_outputs=True, carries=carries)
        params = self.params
        total = torch.zeros((), device=self.device)
        for i, out_name in enumerate(self.conf.network_outputs):
            global_batch.set_output(i)
            obj = self.conf.vertices[out_name][0]
            if not (isinstance(obj, Layer) and obj.has_loss()):
                raise ValueError(f"Output vertex '{out_name}' has no loss")
            total = total + obj.loss_from_input(
                params[out_name], acts[out_name], labels[i],
                training=training, generator=generator,
                mask=lmasks[i] if lmasks is not None else None)
            if isinstance(obj, CenterLossOutputLayer):
                h = acts[out_name]
                total = total + obj.lambda_ * obj.center_loss(
                    self.state[out_name], h, labels[i])
                new_state[out_name] = obj.update_centers(
                    self.state[out_name], h.detach(), labels[i])
        for name, obj in self._layer_configs().items():
            total = total + obj.regularization_loss(params[name])
        return total, (new_state, new_carries)

    def _gradients(self, batch, carries=None):
        """(loss, grads by vertex name, (new states, new carries)) of one
        training forward, as ``_loss`` returns them."""
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        loss, aux = self._loss(batch, training=True,
                               generator=self._generator, carries=carries)
        self._where = "the backward pass"
        return loss.detach(), grads_of(loss, self.params), aux

    def _step_body(self, batch, carries=None, *, health: bool = False):
        """loss -> grads -> gradient normalization -> updater ->
        constraints, with no host read: what a training program
        captures (MultiLayerNetwork's ``_step_body``, by vertex name).
        Returns (the loss, the fused health vector or None, the new
        carries detached)."""
        loss, grads, aux = self._gradients(batch, carries)
        loss, grads = global_batch.reduce_gradients(loss, grads)
        return self._apply_step(loss, grads, aux, health)

    def _apply_step(self, loss, grads, aux, health: bool = False):
        """The update half of ``_step_body`` (MultiLayerNetwork's)."""
        new_state, new_carries = aux
        self._where = "the updater"
        with tensor_parallel.sharded_norms(self):
            grads = apply_gradient_normalization(self._layer_configs(),
                                                 grads)
            params = self.params
            dims = tensor_parallel.norm_dims() or {}
            with torch.no_grad():
                updates, new_opt = self._optimizer.update(
                    grads, self.opt_state, params)
                updaters_mod.apply_updates(params, updates)
                for name, obj in self._layer_configs().items():
                    p = params[name]
                    for k, v in apply_layer_constraints(
                            obj, p, dims.get(name)).items():
                        if v is not p[k]:
                            p[k].copy_(v)
                vec = (fused_health(loss, grads, updates, params)
                       if health else None)
                assign_tree(self.opt_state, new_opt)
                assign_tree(self.state, new_state)
        return loss, vec, _detach(new_carries)

    def _train_step(self, batch, carries=None):
        """One eager training step: the loss as a device scalar, without
        a host sync, and the new carries."""
        loss, _, new_carries = self._step_body(batch, carries)
        return loss, new_carries

    def fit(self, data, *, epochs: int = 1,
            steps_per_device_call: int = 1, mesh_spec=None):
        """Train over a DataSet, a MultiDataSet, or an iterable of
        either, one updater step per batch; ``steps_per_device_call=k``
        as on MultiLayerNetwork."""
        k = check_fit_args(self, steps_per_device_call, mesh_spec)
        self._prepare_fit()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif not isinstance(data, (list, tuple)) and \
                not hasattr(data, "reset"):
            data = list(data)     # a generator would be spent after epoch 1
        fit_epochs(self, data, epochs, k)
        return self

    # KStepExecutorMixin adapters
    def _coerce_fit_batch(self, ds) -> MultiDataSet:
        return self._as_multi(ds)

    def _batch_is_tbptt(self, mds: MultiDataSet, tbptt) -> bool:
        return tbptt is not None and any(np.ndim(f) == 3
                                         for f in mds.features)

    def _host_tuple(self, mds: MultiDataSet):
        def group(arrays):
            return None if arrays is None else tuple(arrays)
        return host_batch((group(mds.features), group(mds.labels),
                           group(mds.features_masks),
                           group(mds.labels_masks)))

    def _zero_carries(self, B: int):
        return {name: obj.zero_state(B, device=self.device)
                for name, obj in self._layer_configs().items()
                if isinstance(obj, BaseRecurrentLayer)}

    def _tbptt_chunks(self, mds: MultiDataSet, fwd: int):
        """Every time-series array (3-d features and labels, and masks
        of the series' length) in ``fwd``-step chunks."""
        series = [f for f in mds.features if np.ndim(f) == 3]
        T = series[0].shape[1]

        def chunks(arrays, start, ndim):
            if arrays is None:
                return None
            return [a if a is None or a.ndim != ndim
                    or (ndim == 2 and a.shape[1] != T)
                    else a[:, start:start + fwd] for a in arrays]
        for start in range(0, T, fwd):
            yield MultiDataSet(chunks(mds.features, start, 3),
                               chunks(mds.labels, start, 3),
                               chunks(mds.features_masks, start, 2),
                               chunks(mds.labels_masks, start, 2))

    def score(self, ds) -> float:
        """The summed loss (with L1/L2 terms) on ``ds``, dropout off."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(self._batch_tuple(self._as_multi(ds)),
                                 training=False)
        return float(loss)

    def _iter_pred_batches(self, data):
        """One forward a batch, every output as host numpy."""
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        for ds in data:
            mds = self._as_multi(ds)
            preds = self.output(*mds.features,
                                input_masks=mds.features_masks)
            if not isinstance(preds, tuple):
                preds = (preds,)
            yield mds, [p.float().cpu().numpy() for p in preds]

    def _eval_with(self, data, ev, output_index: int = 0):
        for mds, preds in self._iter_pred_batches(data):
            lmask = (mds.labels_masks[output_index]
                     if mds.labels_masks is not None else None)
            eval_one(ev, mds.labels[output_index], preds[output_index],
                     lmask)
        return ev

    def evaluate(self, data, output_index: int = 0):
        """Classification metrics of output ``output_index`` over a
        DataSet, a MultiDataSet or an iterable of either."""
        from deeplearning4j_tpu_torch.evaluation.classification import (
            Evaluation)
        return self._eval_with(data, Evaluation(), output_index)

    def evaluate_outputs(self, data, eval_factory=None):
        """Every output scored in one pass over the data:
        ``{output_name: evaluator}``, one ``eval_factory()`` (default
        ``Evaluation``) an output."""
        if eval_factory is None:
            from deeplearning4j_tpu_torch.evaluation.classification import (
                Evaluation)
            eval_factory = Evaluation
        evs = [eval_factory() for _ in self.conf.network_outputs]
        for mds, preds in self._iter_pred_batches(data):
            for i, ev in enumerate(evs):
                lmask = (mds.labels_masks[i]
                         if mds.labels_masks is not None else None)
                eval_one(ev, mds.labels[i], preds[i], lmask)
        return dict(zip(self.conf.network_outputs, evs))

    def evaluate_regression(self, data, output_index: int = 0):
        from deeplearning4j_tpu_torch.evaluation.regression import (
            RegressionEvaluation)
        return self._eval_with(data, RegressionEvaluation(), output_index)

    def evaluate_roc(self, data, threshold_steps: int = 0,
                     output_index: int = 0):
        from deeplearning4j_tpu_torch.evaluation.roc import ROC
        return self._eval_with(data, ROC(threshold_steps), output_index)

    # ---- flat params, copies, summary ----
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params_flat(self) -> np.ndarray:
        """Every parameter in one flat vector (the full parameters under
        tensor parallelism: collective over the model group)."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            full_params)
        return tree_flat_vector(full_params(self))

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
        if self.params:
            lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

    # ---- stateful streaming inference (reference rnnTimeStep) ----
    def rnn_time_step(self, *inputs):
        """Feed the next (B, C) step or (B, t, C) chunk of each network
        input and return the outputs for it, carrying each recurrent
        vertex's (h, c) and each attention vertex's KV cache (grown by
        concatenation) to the next call."""
        if self.params is None:
            self.init()
        xs = [as_device_tensor(x, self.device) for x in inputs]
        squeeze = xs[0].dim() == 2
        if squeeze:
            xs = [x[:, None, :] for x in xs]
        if self._rnn_state is None:
            self._rnn_state = {}
        params = self.params
        acts = dict(zip(self.conf.network_inputs, xs))
        with torch.inference_mode():
            for name in self.conf.topological_order():
                obj, ins = self.conf.vertices[name]
                xin = [acts[i] for i in ins]
                if isinstance(obj, BaseRecurrentLayer):
                    carry = self._rnn_state.get(name)
                    if carry is None:
                        carry = obj.zero_state(xin[0].shape[0],
                                               device=self.device)
                    acts[name], self._rnn_state[name] = obj.apply_rnn(
                        params[name], xin[0], carry)
                elif hasattr(obj, "apply_stream"):
                    acts[name], self._rnn_state[name] = obj.apply_stream(
                        params[name], self._rnn_state.get(name), xin[0])
                elif isinstance(obj, Layer):
                    acts[name], _ = obj.apply(params[name], self.state[name],
                                              xin[0], training=False)
                else:
                    acts[name] = obj.apply(xin)
        outs = tuple(acts[o] for o in self.conf.network_outputs)
        if squeeze:
            outs = tuple(o[:, -1, :] if o.dim() == 3 else o for o in outs)
        return outs if len(outs) > 1 else outs[0]

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    def streaming_session(self, capacity: int, batch: int):
        """Bounded-cache streaming inference over the graph (see
        ``models/streaming.py``'s ``GraphStreamingSession``):
        fixed-capacity KV caches for attention vertices, carries for
        recurrent ones. ``capacity`` is the longest sequence the session
        can stream before ``reset()``."""
        from deeplearning4j_tpu_torch.models.streaming import (
            GraphStreamingSession)
        if self.params is None:
            self.init()
        return GraphStreamingSession(self, capacity, batch)

    # ---- layerwise pretraining ----
    def pretrain(self, data, *, epochs: int = 1):
        """Pretrain every layer vertex that has a ``pretrain_loss``, in
        topological order, over a DataSet, a MultiDataSet or an
        iterable of either."""
        if self.params is None:
            self.init()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif not isinstance(data, (list, tuple)):
            data = list(data)
        for name in self.conf.topological_order():
            obj = self.conf.vertices[name][0]
            if isinstance(obj, Layer) and hasattr(obj, "pretrain_loss"):
                self._pretrain_vertex(name, data, epochs)
        return self

    def _ancestors(self, name: str) -> set:
        """``name`` and every vertex upstream of it."""
        needed, stack = set(), [name]
        while stack:
            cur = stack.pop()
            if cur in needed or cur not in self.conf.vertices:
                continue
            needed.add(cur)
            stack.extend(self.conf.vertices[cur][1])
        return needed

    def _pretrain_vertex(self, name: str, data, epochs: int):
        """Steps of the vertex's own loss on its parameters alone; its
        input is computed by the ancestor subgraph of that input only.
        The vertex's updater, else the network's, else sgd()."""
        obj = self.conf.vertices[name][0]
        opt = updaters_mod.to_transform(
            getattr(obj, "updater", None) or self.conf.conf.updater_cfg
            or updaters_mod.sgd())
        params = self.params[name]
        opt_state = opt.init(params)
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        for _ in range(epochs):
            for ds in data:
                _, opt_state = pretrain_step(
                    obj, params, opt, opt_state,
                    self._pretrain_input(ds, name), self._generator)

    def _pretrain_input(self, ds, name: str) -> torch.Tensor:
        """Vertex ``name``'s input for the batch's features: the
        ancestor subgraph of that input alone, at inference."""
        mds = self._as_multi(ds)
        source = self.conf.vertices[name][1][0]
        with torch.no_grad():
            acts, _, _ = self._forward(
                self._tensors(mds.features), training=False,
                fmasks=self._tensors(mds.features_masks),
                only=self._ancestors(source))
        return acts[source]

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

