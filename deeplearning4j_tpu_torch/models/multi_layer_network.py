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
parameters are updated in place. Preprocessors
(``nn/conf/preprocessors.py``) reshape a layer's input where the config
placed them. ``output`` runs under ``torch.inference_mode``;
``evaluate``, ``evaluate_regression`` and ``evaluate_roc`` score the
outputs on the host (``evaluation/``);
``summary`` prints the JAX package's table of layers. A
``CenterLossOutputLayer`` head adds ``lambda_ * center_loss`` to the
loss, and its centers (layer state) move with each step. ``pretrain``
trains each layer that has a ``pretrain_loss`` (RBM, AutoEncoder,
RecursiveAutoEncoder, VariationalAutoencoder) in order, on its input fed
through the layers below, with the layer's own updater or else the
network's.
With ``backprop_type("tbptt", fwd_length=n)`` a batch of sequences is
split into chunks of n steps, one updater step each, with the recurrent
layers' carries crossing the chunk boundaries detached (``_fit_tbptt``).
``rnn_time_step`` and the streaming sessions (``streaming_session``,
``slot_streaming_session``, ``paged_slot_streaming_session``) decode
step by step over recurrent carries and KV caches
(``models/streaming.py``, ``models/paged_kv.py``).
``fit``'s loop is the JAX package's (:func:`fit_epochs` and
``models/kstep.KStepExecutorMixin``): the data wait is timed apart from
the step (``_step_timing = (data_wait_s, dispatch_s)``), the tracer's
``epoch``, ``data_wait``, ``train_step`` (``train_step_fused`` for a
window, ``train_step_tbptt``) and ``listeners`` spans open as in JAX,
the listeners' epoch hooks and ``iteration_done`` fire (with the loss as
a device tensor: a listener that never reads it costs no host sync), and
an escaping exception reaches the flight recorder. Every step runs
through a training program (``models/kstep.TrainProgram``): on a card a
CUDA graph, captured at a batch signature's first sight and replayed
after; on the CPU the eager step. ``fit(steps_per_device_call=k)`` and
``fit_batches`` run k steps a program call, ``warmup`` builds the
programs ahead of time, and a ``HealthMonitor`` listener gets the fused
health vector of every step (``observability/health.py``). The step
never rebinds the layer state or the updater state: it copies the new
trees into them, so the graphs' addresses stay valid; rebinding either
(or the params, or a new optimizer) drops every program.
``fit(mesh_spec="dp=N")`` (or ``use_mesh``) trains data-parallel over a
``torch.distributed`` process group, each rank on its own shard of the
global batch (``parallel/mesh_spec.py``): the gradients and the loss
are all-reduced between the backward and gradient normalization
(``_step_body``'s hook; ``_apply_step`` is the update half).
``fit(mesh_spec="dp=N,tp=M")`` also splits the layers by the tensor-
parallel rules (``parallel/tensor_parallel.py``): each rank holds its
shards, ``_forward`` runs every layer under its mode (``self._tp``),
and ``params_flat`` / ``write_model`` gather the full parameters.
Sequence meshes train through ``ParallelWrapper``, pipelines through
``parallel/pipeline_spmd.py``.
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
from deeplearning4j_tpu_torch.device import as_device_tensor, resolve_device
from deeplearning4j_tpu_torch.models.kstep import (KStepExecutorMixin,
                                                   assign_tree, host_batch)
from deeplearning4j_tpu_torch.nn.conf import updaters as updaters_mod
from deeplearning4j_tpu_torch.nn.conf.layers.output import (
    CenterLossOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
    BaseRecurrentLayer)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.errors import layer_error_context
from deeplearning4j_tpu_torch.observability.flight_recorder import (
    on_fit_exception)
from deeplearning4j_tpu_torch.observability.health import fused_health
from deeplearning4j_tpu_torch.observability.tracing import trace
from deeplearning4j_tpu_torch.parallel import global_batch, tensor_parallel
from deeplearning4j_tpu_torch.train.constraints import (
    apply_layer_constraints)
from deeplearning4j_tpu_torch.train.gradnorm import (
    apply_gradient_normalization)
from deeplearning4j_tpu_torch.util.tree import (tree_copy,
                                                tree_flat_vector,
                                                tree_from_flat_vector,
                                                tree_to_device)

__all__ = ["MultiLayerNetwork", "fit_epochs", "eval_one"]

def _detach(carries):
    """Recurrent carries (a list or dict of (h, c) or None, or None) cut
    from the autograd graph: the gradient stops at a tBPTT chunk
    boundary."""
    if carries is None:
        return None
    items = carries.items() if isinstance(carries, dict) else \
        enumerate(carries)
    out = dict(carries) if isinstance(carries, dict) else list(carries)
    for k, c in items:
        if c is not None:
            out[k] = tuple(t.detach() for t in c)
    return out


def grads_of(loss, params):
    """d loss / d params in the params structure; a param the loss does
    not reach (a frozen layer's) gets zeros, as ``jax.grad`` gives."""
    leaves = list(updaters_mod.tree_leaves(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return updaters_mod.tree_map(lambda _: next(grads), params)


def pretrain_step(layer, params, opt, opt_state, x, generator):
    """One update of a layer's ``params`` (a live tree of tensors) by
    ``opt`` on its ``pretrain_loss`` at ``x``; returns (the loss as a
    device scalar, the new optimizer state)."""
    loss = layer.pretrain_loss(params, x, generator)
    grads = grads_of(loss, params)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        updaters_mod.apply_updates(params, updates)
    return loss.detach(), opt_state


def fit_epochs(model, data, epochs: int, k: int = 1) -> None:
    """The fit loop of both executors (the JAX package's ``fit``): per
    epoch, the listeners' ``on_epoch_start``, the batches through
    ``model._fit_epoch`` (k steps a program call), ``on_epoch_end``. An
    exception escaping the loop goes to the flight recorder, then on."""
    try:
        for _ in range(epochs):
            with trace.span("epoch"):
                for lst in model.listeners:
                    lst.on_epoch_start(model)
                model._fit_epoch(iter(data), k, model.conf.conf.tbptt)
                for lst in model.listeners:
                    lst.on_epoch_end(model)
            model.epoch_count += 1
    except Exception as e:
        on_fit_exception(model, e)
        raise


def check_fit_args(model, steps_per_device_call, mesh_spec) -> int:
    """k, checked; a ``mesh_spec`` is installed on ``model``
    (``use_mesh``) and stays for later fits, as in the JAX package."""
    k = int(steps_per_device_call)
    if k < 1:
        raise ValueError("steps_per_device_call must be >= 1")
    if mesh_spec is not None:
        model.use_mesh(mesh_spec)
    return k


def eval_one(ev, labels, preds, mask) -> None:
    """One batch into an evaluator, with the labels' mask where the
    evaluator takes one (ROC does not)."""
    try:
        ev.eval(labels, preds, mask=mask)
    except TypeError:
        ev.eval(labels, preds)


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
    """One layer's nested ``{name: tensor}`` dict (lists inside it too,
    as the VAE's MLPs) as registered parameters, so ``.to()``,
    ``state_dict()`` and device placement work as for any module."""

    def __init__(self, tree, device: torch.device):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = (((str(i), v) for i, v in enumerate(tree)) if self._is_list
                 else tree.items())
        for name, value in items:
            if isinstance(value, (dict, list, tuple)):
                self.add_module(name, _ParamTree(value, device))
            else:
                t = torch.as_tensor(value, dtype=torch.float32)
                self.register_parameter(name, nn.Parameter(
                    t.detach().to(device).clone()))

    def tree(self):
        out: Dict[str, object] = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = child.tree()
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


class MultiLayerNetwork(KStepExecutorMixin, nn.Module):
    def __init__(self, conf: MultiLayerConfiguration, *, device="cuda"):
        super().__init__()
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self._init_programs()
        self.layer_params = nn.ModuleList()
        self.state: Optional[List[dict]] = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.opt_state = None
        self.score_value: object = float("nan")
        self._optimizer: Optional[updaters_mod.Transform] = None
        self._generator: Optional[torch.Generator] = None
        self._rnn_state: Optional[list] = None
        self.listeners: list = []
        # (data_wait_s, dispatch_s) of the latest fit iteration
        self._step_timing = None

    # ---- parameters ----
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Sample every layer's parameters from a CPU ``torch.Generator``
        seeded with ``seed`` (default: the config's), then place them on
        the network's device."""
        seed = self.conf.conf.seed if seed is None else seed
        params, states = self._sample_params(seed)
        self.set_params(params)
        self.state = tree_to_device(states, self.device)
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
        for i, layer in enumerate(self.layers):
            if t is not None and i in self.conf.preprocessors:
                t = self.conf.preprocessors[i].output_type(t)
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
        self._flush_compiled_programs()
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
        self._optimizer = updaters_mod.with_gradient_clip(
            opt, self.conf.conf.gradient_clip)
        self.opt_state = self._optimizer.init(self.params)

    # ---- forward ----
    def _forward(self, x, *, training, generator=None, fmask=None,
                 upto: Optional[int] = None, carries=None, collect=None):
        """Layers ``[0, upto)`` on ``x``; returns (activations, the
        layers' new states, the new carries). ``carries``: a per-layer
        list of recurrent (h, c) initial states (None: zeros), which
        tBPTT threads across chunks; without it the new carries are
        None. ``collect``: a list that gets every layer's output. A
        failure in a preprocessor or layer raises
        ``NetworkExecutionError`` naming it (``nn/errors.py``)."""
        params = self.params
        n = len(self.layers) if upto is None else upto
        new_states = list(self.state)
        new_carries = None if carries is None else [None] * len(self.layers)
        tp, sharded = self._tp, False
        for i in range(n):
            layer = self.layers[i]
            self._where = f"layer {i} ({type(layer).__name__})"
            if tp is not None:
                # tensor parallelism: the layout this layer's mode takes
                x = tp.prepare(i, x, sharded)
                sharded = tp.out_sharded(i)
            if i in self.conf.preprocessors:
                pre = self.conf.preprocessors[i]
                with layer_error_context(f"preprocessor before layer {i}",
                                         pre, x):
                    x = pre(x)
            with layer_error_context(f"layer {i}", layer, x):
                if tp is not None:
                    with tp.layer(i):
                        x, new_states[i] = layer.apply(
                            params[i], self.state[i], x, training=training,
                            generator=generator, mask=fmask)
                elif carries is not None and isinstance(layer,
                                                        BaseRecurrentLayer):
                    c0 = carries[i]
                    if c0 is None:
                        c0 = layer.zero_state(x.shape[0], device=x.device)
                    x = layer.apply_input_dropout(x, training=training,
                                                  generator=generator)
                    x, new_carries[i] = layer.apply_rnn(
                        params[i], x, c0, training=training,
                        generator=generator, mask=fmask)
                else:
                    x, new_states[i] = layer.apply(
                        params[i], self.state[i], x, training=training,
                        generator=generator, mask=fmask)
            if collect is not None:
                collect.append(x if tp is None else tp.full(x, sharded))
        if tp is not None:
            x = tp.full(x, sharded)
        return x, new_states, new_carries

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x, training=False)[0]

    def output(self, x) -> torch.Tensor:
        """Inference on numpy or tensor input (moved to the network's
        device); returns a tensor on that device."""
        if self.params is None:
            self.init()
        if isinstance(x, np.ndarray):
            x = self._to_device(x)      # float64 -> float32, as JAX does
        x = torch.as_tensor(x, device=self.device)
        with torch.inference_mode():
            return self(x)

    def feed_forward(self, x, training: bool = False) -> List[torch.Tensor]:
        """Every layer's activation, in order (the reference's
        ``feedForward``)."""
        if self.params is None:
            self.init()
        acts: List[torch.Tensor] = []
        with torch.inference_mode():
            self._forward(self._to_device(x), training=training,
                          generator=self._generator if training else None,
                          collect=acts)
        return acts

    # ---- training ----
    def _to_device(self, a):
        return as_device_tensor(a, self.device)

    def _batch_tuple(self, ds: DataSet):
        return tuple(self._to_device(a) for a in
                     (ds.features, ds.labels, ds.features_mask,
                      ds.labels_mask))

    def _loss(self, batch, *, training=True, generator=None, carries=None):
        """(loss + L1/L2 terms, (the layers' new states, the new carries:
        None without ``carries``))."""
        x, labels, fmask, lmask = batch
        out_idx = len(self.layers) - 1
        out_layer = self.layers[out_idx]
        if not out_layer.has_loss():
            raise ValueError("Last layer has no loss; use an OutputLayer/"
                             "LossLayer for fit()")
        h, new_states, new_carries = self._forward(
            x, training=training, generator=generator, fmask=fmask,
            upto=out_idx, carries=carries)
        if out_idx in self.conf.preprocessors:
            h = self.conf.preprocessors[out_idx](h)
        self._where = f"layer {out_idx} ({type(out_layer).__name__})"
        params = self.params
        loss = out_layer.loss_from_input(params[out_idx], h, labels,
                                         training=training,
                                         generator=generator, mask=lmask)
        if isinstance(out_layer, CenterLossOutputLayer):
            loss = loss + out_layer.lambda_ * out_layer.center_loss(
                self.state[out_idx], h, labels)
            new_states[out_idx] = out_layer.update_centers(
                self.state[out_idx], h.detach(), labels)
        for layer, p in zip(self.layers, params):
            loss = loss + layer.regularization_loss(p)
        return loss, (new_states, new_carries)

    def _gradients(self, batch, carries=None):
        """(loss, grads in the params structure, (new states, new
        carries)) of one training forward, as ``_loss`` returns them."""
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        loss, aux = self._loss(batch, training=True,
                               generator=self._generator, carries=carries)
        self._where = "the backward pass"
        return loss.detach(), grads_of(loss, self.params), aux

    def _step_body(self, batch, carries=None, *, health: bool = False):
        """loss -> grads -> gradient normalization -> updater ->
        constraints (``_train_core`` of the JAX package), with no host
        read: what a training program captures. The parameters are
        updated in place, and the new layer state and updater state are
        copied into the live trees. Returns (the loss as a device
        scalar, the fused health vector or None, the new carries
        detached: None without ``carries``)."""
        loss, grads, aux = self._gradients(batch, carries)
        # data parallelism: the mean loss and gradients over the mesh
        loss, grads = global_batch.reduce_gradients(loss, grads)
        return self._apply_step(loss, grads, aux, health)

    def _apply_step(self, loss, grads, aux, health: bool = False):
        """The update half of ``_step_body``: gradient normalization ->
        updater -> constraints on ``grads``, the new layer state copied
        into the live tree; returns (loss, health vector or None, the
        new carries detached)."""
        new_states, new_carries = aux
        self._where = "the updater"
        # under tensor parallelism every norm below is the full arrays'
        with tensor_parallel.sharded_norms(self):
            grads = apply_gradient_normalization(self.layers, grads)
            params = self.params
            dims = tensor_parallel.norm_dims() or [None] * len(params)
            with torch.no_grad():
                updates, new_opt = self._optimizer.update(
                    grads, self.opt_state, params)
                updaters_mod.apply_updates(params, updates)
                for layer, p, d in zip(self.layers, params, dims):
                    for k, v in apply_layer_constraints(layer, p,
                                                        d).items():
                        if v is not p[k]:
                            p[k].copy_(v)
                vec = (fused_health(loss, grads, updates, params)
                       if health else None)
                assign_tree(self.opt_state, new_opt)
                assign_tree(self.state, new_states)
        return loss, vec, _detach(new_carries)

    def _train_step(self, batch, carries=None):
        """One eager training step (the reference the captured step is
        held to, and the body of a tBPTT chunk program): the loss as a
        device scalar, without a host sync, and the new carries."""
        loss, _, new_carries = self._step_body(batch, carries)
        return loss, new_carries

    def fit(self, data, labels=None, *, epochs: int = 1,
            batch_size: Optional[int] = None,
            steps_per_device_call: int = 1, mesh_spec=None):
        """Train over a DataSet, an iterator, or (features, labels)
        arrays, one updater step per batch; ``steps_per_device_call=k``
        runs each full window of k batches as one k-step program (the
        epoch's tail through the k=1 program) and hands the listeners
        every step's loss from one fetch a window."""
        k = check_fit_args(self, steps_per_device_call, mesh_spec)
        self._prepare_fit()
        fit_epochs(self, _as_iterator(data, labels, batch_size), epochs, k)
        return self

    # KStepExecutorMixin adapters
    def _coerce_fit_batch(self, ds: DataSet) -> DataSet:
        return ds

    def _batch_is_tbptt(self, ds: DataSet, tbptt) -> bool:
        return tbptt is not None and np.ndim(ds.features) == 3

    def _host_tuple(self, ds: DataSet):
        return host_batch((ds.features, ds.labels, ds.features_mask,
                           ds.labels_mask))

    def _zero_carries(self, B: int):
        return [layer.zero_state(B, device=self.device)
                if isinstance(layer, BaseRecurrentLayer) else None
                for layer in self.layers]

    def _tbptt_chunks(self, ds: DataSet, fwd: int):
        """Features, labels and masks in ``fwd``-step chunks along
        time."""
        T = ds.features.shape[1]

        def chunk(a, start):
            return None if a is None else a[:, start:start + fwd]
        for start in range(0, T, fwd):
            yield DataSet(chunk(ds.features, start), chunk(ds.labels, start),
                          chunk(ds.features_mask, start),
                          chunk(ds.labels_mask, start))

    def score(self, ds: DataSet) -> float:
        """The loss (with L1/L2 terms) on ``ds``, dropout off."""
        if self.params is None:
            self.init()
        with torch.no_grad():
            loss, _ = self._loss(self._batch_tuple(ds), training=False)
        return float(loss)

    def _eval_with(self, ev, data, labels=None):
        for ds in _as_iterator(data, labels):
            preds = self.output(ds.features).float().cpu().numpy()
            eval_one(ev, ds.labels, preds, ds.labels_mask)
        return ev

    def evaluate(self, data, labels=None):
        """Classification metrics of ``output`` over a DataSet, an
        iterator or (features, labels) arrays."""
        from deeplearning4j_tpu_torch.evaluation.classification import (
            Evaluation)
        return self._eval_with(Evaluation(), data, labels)

    def evaluate_regression(self, data, labels=None):
        """Per-column regression metrics of ``output``."""
        from deeplearning4j_tpu_torch.evaluation.regression import (
            RegressionEvaluation)
        return self._eval_with(RegressionEvaluation(), data, labels)

    def evaluate_roc(self, data, labels=None, threshold_steps: int = 0):
        """Binary ROC of ``output`` (exact at ``threshold_steps=0``)."""
        from deeplearning4j_tpu_torch.evaluation.roc import ROC
        return self._eval_with(ROC(threshold_steps), data, labels)

    # ---- layerwise pretraining ----
    def pretrain(self, data, *, epochs: int = 1,
                 batch_size: Optional[int] = None):
        """Pretrain every layer that has a ``pretrain_loss``, first to
        last, over a DataSet or an iterator (labels are not read)."""
        if self.params is None:
            self.init()
        it = _as_iterator(data, None, batch_size)
        for idx, layer in enumerate(self.layers):
            if hasattr(layer, "pretrain_loss"):
                self._pretrain_layer(idx, it, epochs)
        return self

    def _pretrain_layer(self, idx: int, it: DataSetIterator, epochs: int):
        """Steps of the layer's own loss on its parameters alone, the
        input fed forward through the layers below it; the layer's
        updater, else the network's."""
        layer = self.layers[idx]
        opt = updaters_mod.to_transform(
            getattr(layer, "updater", None) or self.conf.conf.updater_cfg)
        params = self.params[idx]
        opt_state = opt.init(params)
        if self._generator is None:
            self._generator = self._new_generator(self.conf.conf.seed)
        for _ in range(epochs):
            for ds in it:
                _, opt_state = pretrain_step(
                    layer, params, opt, opt_state,
                    self._pretrain_input(ds, idx), self._generator)

    def _pretrain_input(self, ds: DataSet, idx: int) -> torch.Tensor:
        """Layer ``idx``'s input for the batch's features: the layers
        below it at inference."""
        x = self._to_device(ds.features)
        if idx > 0:
            with torch.no_grad():
                x = self._forward(x, training=False, upto=idx)[0]
        return x

    # ---- flat params (the reference's params() view) ----
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def params_flat(self) -> np.ndarray:
        """Every parameter in one flat vector, in the JAX package's
        order; under tensor parallelism the full parameters (gathered
        over the model group: every rank of it calls this)."""
        from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
            full_params)
        return tree_flat_vector(full_params(self))

    def set_params_flat(self, flat: np.ndarray) -> None:
        self.set_params(tree_from_flat_vector(self.params, flat))

    # ---- stateful streaming inference (reference rnnTimeStep) ----
    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed the next (B, C) step or (B, t, C) chunk and return the
        output for it, carrying each recurrent layer's (h, c) and each
        attention layer's KV cache (grown by concatenation) to the next
        call. Wrappers (Bidirectional, LastTimeStep) see each call's
        input alone, as in the JAX package."""
        if self.params is None:
            self.init()
        x = self._to_device(x)
        squeeze = x.dim() == 2
        if squeeze:                      # (B, C) -> one timestep
            x = x[:, None, :]
        if self._rnn_state is None:
            self._rnn_state = [None] * len(self.layers)
        params = self.params
        h = x
        with torch.inference_mode():
            for i, layer in enumerate(self.layers):
                if i in self.conf.preprocessors:
                    h = self.conf.preprocessors[i](h)
                if isinstance(layer, BaseRecurrentLayer):
                    carry = self._rnn_state[i]
                    if carry is None:
                        carry = layer.zero_state(h.shape[0], device=h.device)
                    h, self._rnn_state[i] = layer.apply_rnn(params[i], h,
                                                            carry)
                elif hasattr(layer, "apply_stream"):
                    h, self._rnn_state[i] = layer.apply_stream(
                        params[i], self._rnn_state[i], h)
                else:
                    h, _ = layer.apply(params[i], self.state[i], h,
                                       training=False)
        if squeeze and h.dim() == 3:
            h = h[:, -1, :]
        return h

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    def streaming_session(self, capacity: int, batch: int):
        """Bounded-cache streaming inference: the counterpart of the
        eager ``rnn_time_step`` with fixed-capacity KV caches updated in
        place (see models/streaming.py). ``capacity`` is the longest
        sequence the session can stream before ``reset()``."""
        from deeplearning4j_tpu_torch.models.streaming import (
            StreamingSession)
        if self.params is None:
            self.init()
        return StreamingSession(self, capacity, batch)

    def slot_streaming_session(self, capacity: int, slots: int):
        """Per-slot-position streaming session for continuous batching:
        each of the ``slots`` rows is an independent decode stream (see
        ``serving.continuous.ContinuousBatcher``)."""
        from deeplearning4j_tpu_torch.models.streaming import (
            SlotStreamingSession)
        if self.params is None:
            self.init()
        return SlotStreamingSession(self, capacity, slots)

    def paged_slot_streaming_session(self, capacity: int, slots: int,
                                     page_size: int = 16, n_pages=None):
        """Paged-KV continuous-batching session: per-slot page tables
        into one refcounted page pool, so concurrent slot count is
        bounded by total KV memory (``n_pages * page_size`` tokens),
        plus prompt-prefix sharing between slots (see
        ``models/paged_kv.py``)."""
        from deeplearning4j_tpu_torch.models.paged_kv import (
            PagedSlotSession)
        if self.params is None:
            self.init()
        return PagedSlotSession(self, slots=slots, capacity=capacity,
                                page_size=page_size, n_pages=n_pages)

    def summary(self) -> str:
        """One line a layer (index, type, parameter count, output type)
        and the total: the JAX package's text for the same network."""
        params = self.params
        lines = ["idx  type                      params    out_type"]
        t = self.conf.input_type
        for i, layer in enumerate(self.layers):
            if t is not None and i in self.conf.preprocessors:
                t = self.conf.preprocessors[i].output_type(t)
            n = (sum(p.numel() for p in updaters_mod.tree_leaves(params[i]))
                 if params else 0)
            t = layer.output_type(t) if t is not None else None
            lines.append(f"{i:<4} {type(layer).__name__:<25} {n:<9} {t}")
        lines.append(f"total params: {self.num_params() if params else 0}")
        return "\n".join(lines)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def clone(self) -> "MultiLayerNetwork":
        """A new network of a copy of the config, on the same device,
        with copies of the params and state (a fresh updater)."""
        m = MultiLayerNetwork(self.conf.clone(), device=self.device)
        if self.params is not None:
            m.init()
            m.set_params(self.params)
            m.state = tree_copy(self.state)
        return m
