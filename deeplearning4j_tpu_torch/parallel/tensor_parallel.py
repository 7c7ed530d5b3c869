"""Tensor parallelism over the ``model`` axis of a mesh (counterpart of
``deeplearning4j_tpu/parallel/tensor_parallel.py``).

The rule table is the JAX package's, rule for rule: Megatron's
column / row split for consecutive Dense layers, the Megatron attention
split for SelfAttention / TransformerEncoder layers (Wq, Wk, Wv and the
block's W1 by columns, so the heads are partitioned; Wo and W2 by rows;
valid when n_heads divides by the shard count), conv layers by output
channels, output layers replicated (:func:`default_tp_rules`,
:func:`graph_tp_rules`, :func:`_spec_for`).

The JAX package states these as sharding annotations and lets GSPMD
insert the collectives. The port has one process a rank, so the math is
written out. :func:`shard_params` slices each rank's shard out of the
full parameters, and the executors run each layer under its mode
(:class:`TPPlan`):

- a COLUMN layer takes the full input through :func:`copy_to_model`
  (identity forward, all-reduce of the gradient backward) and gives
  its shard of the output features;
- a ROW layer takes its shard of the input features and sums the
  partial products with :func:`reduce_from_model` (all-reduce forward,
  identity backward) BEFORE its bias and activation;
- an attention layer does both: q, k and v of its H/tp heads, attention
  over them (the flash kernels, or the ring under sequence
  parallelism), the output projection row-reduced;
- every other layer wants the full features: a sharded activation is
  gathered first (:func:`gather_from_model`: all-gather forward, this
  rank's slice of the gradient backward). A ROW layer given full
  features takes its slice (:func:`scatter_to_model`).

Replicated parameters then get equal gradients on every rank of the
model group, and sharded ones their own shard's, so nothing else is
reduced over ``model``. A layer whose shards would not divide evenly,
or whose layout the port does not split (conv subclasses), runs
replicated, as the JAX package replicates a parameter that does not
divide.

:func:`full_params` gathers the shards back into the full parameters
(and :func:`full_opt_state` the updater state), which is what
``params_flat``, ``write_model`` and the checkpoint zip hold: a tp=2
checkpoint has exactly the layout the JAX package writes. They are
collective over the model group.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["TPRule", "default_tp_rules", "graph_tp_rules", "shard_params",
           "shard_graph_params", "replicate_params", "TPPlan",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "scatter_to_model", "current_mode", "full_params",
           "full_opt_state", "shard_model", "unshard_model",
           "local_trees", "refuse_norm_updates"]


class TPRule:
    COLUMN = "column"     # split output dim  (Megatron first linear)
    ROW = "row"           # split input dim   (Megatron second linear)
    ATTENTION = "attention_heads"   # Megatron MHA: qkv column, out row
    REPLICATE = "replicate"


def _rule_for_layer(layer, parity: int):
    """(rule, new_parity) for one layer object."""
    from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
        SelfAttentionLayer, TransformerEncoderLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
        ConvolutionLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.core import DenseLayer
    from deeplearning4j_tpu_torch.nn.conf.layers.output import OutputLayer

    if isinstance(layer, OutputLayer):
        return TPRule.REPLICATE, parity
    if isinstance(layer, (SelfAttentionLayer, TransformerEncoderLayer)):
        return TPRule.ATTENTION, 0      # attn block resets the pairing
    if isinstance(layer, DenseLayer):
        return (TPRule.COLUMN if parity == 0 else TPRule.ROW), parity ^ 1
    if isinstance(layer, ConvolutionLayer):
        return TPRule.COLUMN, parity
    return TPRule.REPLICATE, parity


def default_tp_rules(layers) -> Dict[int, str]:
    """Alternate column/row splits over consecutive Dense layers (the
    Megatron pairing); conv layers by output channels; attention layers
    the head split; output layers replicate."""
    rules: Dict[int, str] = {}
    parity = 0
    for i, layer in enumerate(layers):
        rules[i], parity = _rule_for_layer(layer, parity)
    return rules


def graph_tp_rules(graph) -> Dict[str, str]:
    """TP rules for a ComputationGraph, keyed by VERTEX NAME, walked in
    topological order so consecutive dense vertices pair up."""
    from deeplearning4j_tpu_torch.nn.conf.layers.base import BaseLayer
    rules: Dict[str, str] = {}
    parity = 0
    for name in graph.conf.topological_order():
        entry = graph.conf.vertices.get(name)
        if entry is None:
            continue                     # graph input: no params
        obj = entry[0]
        if not isinstance(obj, BaseLayer):
            continue                     # op vertex: no params
        rules[name], parity = _rule_for_layer(obj, parity)
    return rules


_ATTN_COLUMN = {"Wq", "Wk", "Wv", "W1"}      # W1/W2: transformer MLP
_ATTN_ROW = {"Wo", "W2"}


def _spec_for(param_name: str, ndim: int, rule: str, axis: str) -> tuple:
    """The JAX ``PartitionSpec`` of one parameter, as a tuple (``()`` is
    replicated)."""
    if rule == TPRule.REPLICATE:
        return ()
    if rule == TPRule.ATTENTION:
        if param_name in _ATTN_COLUMN:
            return (None, axis)
        if param_name in _ATTN_ROW:
            return (axis, None)
        if param_name in ("b1", "bq", "bk", "bv"):
            return (axis,)
        return ()
    if param_name in ("b", "beta", "gamma"):
        return (axis,) if rule == TPRule.COLUMN else ()
    if ndim == 2:                       # dense W (in, out)
        return (None, axis) if rule == TPRule.COLUMN else (axis, None)
    if ndim == 4:                       # conv W (kh, kw, in, out)
        return ((None, None, None, axis) if rule == TPRule.COLUMN
                else (None, None, axis, None))
    return ()


def _heads_divisible(layer, n_model: int) -> bool:
    n_heads = getattr(layer, "n_heads", None)
    return n_heads is None or n_heads % n_model == 0


def _dim_of(spec: tuple) -> Optional[int]:
    for d, ax in enumerate(spec):
        if ax is not None:
            return d
    return None


def _layer_dims(layer, params, rule: str, n: int):
    """(the mode this layer runs under, its tree of sharded dims: an int
    a sharded leaf, None a replicated one). A layer runs replicated
    when a parameter its mode needs split does not divide, or when the
    port does not split its layout."""
    from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
        ConvolutionLayer)

    def dims(tree, r):
        if isinstance(tree, dict):
            return {k: (dims(v, r) if isinstance(v, (dict, list))
                        else _dim_of(_spec_for(k, v.dim(), r, "model")))
                    for k, v in tree.items()}
        return [dims(v, r) for v in tree]

    rep = dims(params, TPRule.REPLICATE)
    if rule == TPRule.REPLICATE or n == 1:
        return TPRule.REPLICATE, rep
    if rule == TPRule.ATTENTION and not _heads_divisible(layer, n):
        logger.debug("%d heads not divisible by %d shards; replicating",
                     layer.n_heads, n)
        return TPRule.REPLICATE, rep
    if rule == TPRule.COLUMN and isinstance(layer, ConvolutionLayer) \
            and (type(layer) is not ConvolutionLayer
                 or params["W"].dim() != 4):
        return TPRule.REPLICATE, rep
    out = dims(params, rule)
    ok = True

    def check(tree, d):
        nonlocal ok
        if isinstance(tree, dict):
            for k in tree:
                check(tree[k], d[k])
        elif isinstance(tree, list):
            for a, b in zip(tree, d):
                check(a, b)
        elif d is not None and tree.shape[d] % n:
            ok = False
    check(params, out)
    if not ok:
        logger.debug("a parameter does not divide by %d; replicating", n)
        return TPRule.REPLICATE, rep
    return rule, out


def _slice_tree(tree, dims, n: int, r: int):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, dims[k], n, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_slice_tree(v, d, n, r) for v, d in zip(tree, dims)]
    if dims is None:
        return tree.detach().clone()
    return tree.detach().chunk(n, dim=dims)[r].clone()


def _gather_tree(tree, dims, grp):
    if isinstance(tree, dict):
        return {k: _gather_tree(v, dims[k], grp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_gather_tree(v, d, grp) for v, d in zip(tree, dims)]
    if dims is None:
        return tree.detach().clone()
    moved = tree.detach().movedim(dims, -1)
    return collectives.all_gather_last(moved, grp).movedim(-1, dims) \
        .contiguous()


class TPPlan:
    """How one model runs over its model group: each layer's (vertex's)
    mode and the sharded dim of each of its parameters, by layer index
    (MultiLayerNetwork) or vertex name (ComputationGraph)."""

    def __init__(self, grp, modes: dict, dims: dict):
        self.grp = grp
        self.n = grp.size
        self.rank = grp.index
        self.modes = modes
        self.dims = dims

    def mode(self, key) -> str:
        return self.modes.get(key, TPRule.REPLICATE)

    def prepare(self, key, x, sharded: bool):
        """Layer ``key``'s input in the layout its mode takes: sharded
        features for ROW, full features for everything else."""
        if self.mode(key) == TPRule.ROW:
            return x if sharded else scatter_to_model(x, self.grp)
        return gather_from_model(x, self.grp) if sharded else x

    def out_sharded(self, key) -> bool:
        return self.mode(key) == TPRule.COLUMN

    def full(self, x, sharded: bool):
        return gather_from_model(x, self.grp) if sharded else x

    @contextlib.contextmanager
    def layer(self, key):
        """Run layer ``key`` under its mode (the layers read it through
        :func:`current_mode`)."""
        prev = getattr(_tls, "active", None)
        _tls.active = (self.mode(key), self.grp)
        try:
            yield
        finally:
            _tls.active = prev

    def describe(self) -> dict:
        return {"model_ranks": self.grp.ranks, "rank": self.rank,
                "modes": {str(k): v for k, v in self.modes.items()
                          if v != TPRule.REPLICATE}}


_tls = threading.local()


def current_mode():
    """(mode, model group) of the layer running now under a
    :class:`TPPlan`, or None."""
    return getattr(_tls, "active", None)


# ---- Megatron's conjugate operators

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_(g.contiguous().clone(), ctx.grp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return collectives.all_reduce_(x.contiguous().clone(), grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp, ctx.width = grp, x.shape[-1]
        return collectives.all_gather_last(x, grp)

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.grp.index, ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.chunk(grp.size, dim=-1)[grp.index].contiguous()

    @staticmethod
    def backward(ctx, g):
        return collectives.all_gather_last(g.contiguous(), ctx.grp), None


def copy_to_model(x, grp=None):
    """Identity forward, gradient all-reduced over the model group
    backward: before a column split."""
    grp = grp if grp is not None else _grp()
    if grp is None or grp.size == 1:
        return x
    return _Copy.apply(x, grp)


def reduce_from_model(x, grp=None):
    """Partial products summed over the model group forward, identity
    backward: after a row split."""
    grp = grp if grp is not None else _grp()
    if grp is None or grp.size == 1:
        return x
    return _Reduce.apply(x, grp)


def gather_from_model(x, grp):
    """The ranks' feature shards concatenated (last dim); backward, this
    rank's slice of the gradient."""
    if grp is None or grp.size == 1:
        return x
    return _Gather.apply(x, grp)


def scatter_to_model(x, grp):
    """This rank's slice of full features (last dim); backward, the
    slices' gradients gathered."""
    if grp is None or grp.size == 1:
        return x
    return _Scatter.apply(x, grp)


def _grp():
    act = current_mode()
    return None if act is None else act[1]


# ---- placement

def _plan_entries(items, n):
    modes, dims = {}, {}
    for key, layer, params, rule in items:
        modes[key], dims[key] = _layer_dims(layer, params, rule, n)
    return modes, dims


def _model_items(model, rules=None):
    """(key, layer object, full params, rule) of every layer (vertex)."""
    if hasattr(model, "_layer_configs"):           # ComputationGraph
        rules = rules if rules is not None else graph_tp_rules(model)
        cfgs = model._layer_configs()
        params = model.params
        return [(name, cfgs[name], params[name],
                 rules.get(name, TPRule.REPLICATE)) for name in params]
    rules = rules if rules is not None else default_tp_rules(model.layers)
    pre = getattr(model.conf, "preprocessors", None) or {}
    out = []
    for i, (layer, p) in enumerate(zip(model.layers, model.params)):
        rule = rules.get(i, TPRule.REPLICATE)
        if rule == TPRule.ROW and i in pre:
            rule = TPRule.REPLICATE     # a reshape sees full features
        out.append((i, layer, p, rule))
    return out


# gradient normalizations that act on each entry alone: a shard's
# entries come out as the full tensor's would
_ENTRYWISE = ("", "none", "clip_element_wise_absolute_value")


def refuse_norm_updates(model) -> None:
    """Raise before a model trains tensor-parallel when its update takes
    a norm over a split layer's parameters: ``gradient_clip`` by norm,
    a split layer's L2 gradient normalization, or its norm constraints.
    Each rank holds only its shards, so such a norm would differ from
    rank to rank and the replicas drift apart (the JAX package's GSPMD
    takes it over the full arrays). Value clipping, element-wise gradient
    clipping and the non-negative constraint act on each entry alone
    and run as they are."""
    split = [(key, layer) for key, layer, _, rule in
             _model_items(model) if rule != TPRule.REPLICATE]
    if not split:
        return
    why = None
    clip = getattr(model.conf.conf, "gradient_clip", None)
    if clip is not None and clip.get("type") == "norm":
        why = "gradient_clip by norm (a global norm over every parameter)"
    for key, layer in split:
        kind = (getattr(layer, "gradient_normalization", None)
                or "").lower()
        if why is None and kind not in _ENTRYWISE:
            why = f"layer {key}'s gradient normalization {kind!r}"
        norms = [c["type"] for c in getattr(layer, "constraints", ())
                 if c["type"] != "non_negative"]
        if why is None and norms:
            why = f"layer {key}'s parameter constraints {norms}"
    if why is not None:
        raise NotImplementedError(
            f"{why} takes a norm over parameters tensor parallelism "
            f"splits, which the port does not reduce over the model "
            f"group yet (ROADMAP A6d); train this model without tp, or "
            f"drop the norm")


def make_plan(model, grp, rules=None) -> TPPlan:
    """The :class:`TPPlan` of ``model`` (with its FULL parameters) over
    the model group ``grp``."""
    modes, dims = _plan_entries(_model_items(model, rules), grp.size)
    return TPPlan(grp, modes, dims)


def _shard(params, plan: TPPlan, keys):
    if isinstance(params, dict):
        return {k: _slice_tree(params[k], plan.dims[k], plan.n, plan.rank)
                for k in keys}
    return [_slice_tree(p, plan.dims[k], plan.n, plan.rank)
            for k, p in zip(keys, params)]


def _group_of(mesh, axis: str):
    if hasattr(mesh, "model_group"):               # a MeshContext
        return mesh.model_group()
    raise TypeError("pass the MeshContext (parallel.mesh_spec."
                    "build_mesh_context) the shards are placed over")


def shard_params(params, model, mesh, *, axis: str = "model",
                 rules: Optional[Dict[int, str]] = None):
    """This rank's shards of a MultiLayerNetwork's FULL ``params`` list
    under the TP rules, over ``mesh``'s (a ``MeshContext``'s) model
    group."""
    plan = make_plan(model, _group_of(mesh, axis), rules)
    return _shard(params, plan, range(len(params)))


def shard_graph_params(params, graph, mesh, *, axis: str = "model",
                       rules: Optional[Dict[str, str]] = None):
    """This rank's shards of a ComputationGraph's FULL {vertex name:
    params} dict (rules keyed by vertex name; unknown names
    replicate)."""
    plan = make_plan(graph, _group_of(mesh, axis), rules)
    return _shard(params, plan, list(params))


def replicate_params(params, mesh=None):
    """Copies of ``params``: every rank holds them whole."""
    from deeplearning4j_tpu_torch.util.tree import tree_copy
    return tree_copy(params)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_structure(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_structure(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape
    return False


def _map_param_like(tree, like, fn):
    """``fn`` on every subtree of ``tree`` shaped like ``like`` (the
    updater's moments mirror the parameters); other leaves kept."""
    if _same_structure(tree, like):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_param_like(v, like, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_param_like(v, like, fn) for v in tree]
    return tree


def _keys(model):
    p = model.params
    return list(p) if isinstance(p, dict) else list(range(len(p)))


def _as_key_tree(params, keys):
    return {k: params[k] for k in keys} if isinstance(params, dict) \
        else list(params)


def _dims_tree(plan, keys, params):
    return ({k: plan.dims[k] for k in keys} if isinstance(params, dict)
            else [plan.dims[k] for k in keys])


def shard_model(model, grp, rules=None) -> TPPlan:
    """Slice ``model``'s full parameters and updater state into this
    rank's shards over the model group ``grp`` and install the plan
    (``model._tp``). Every rank of the group holds equal full trees
    before."""
    full = model.params
    plan = make_plan(model, grp, rules)
    keys = _keys(model)
    dims = _dims_tree(plan, keys, full)
    opt = model.opt_state
    model.set_params(_slice_tree(_as_key_tree(full, keys), dims, plan.n,
                                 plan.rank))
    if opt is not None:
        model.opt_state = _map_param_like(
            opt, full, lambda t: _slice_tree(t, dims, plan.n, plan.rank))
    model._tp = plan
    model._flush_compiled_programs()
    return plan


def full_params(model):
    """The FULL parameters of a model whose shards are spread over its
    model group (its own params when it has no plan). Collective over
    the model group."""
    plan = getattr(model, "_tp", None)
    params = model.params
    if plan is None:
        return params
    keys = _keys(model)
    return _gather_tree(params, _dims_tree(plan, keys, params), plan.grp)


def full_opt_state(model):
    """The updater state over the FULL parameters (collective, as
    :func:`full_params`)."""
    plan = getattr(model, "_tp", None)
    opt = model.opt_state
    if plan is None or opt is None:
        return opt
    params = model.params
    dims = _dims_tree(plan, _keys(model), params)
    return _map_param_like(opt, params,
                           lambda t: _gather_tree(t, dims, plan.grp))


def local_trees(model, params, opt_state=None):
    """This rank's shards of FULL ``params`` and ``opt_state`` trees (a
    checkpoint's) under ``model``'s plan."""
    plan = model._tp
    keys = _keys(model)
    dims = _dims_tree(plan, keys, params)
    local = _slice_tree(_as_key_tree(params, keys), dims, plan.n, plan.rank)
    if opt_state is not None:
        opt_state = _map_param_like(
            opt_state, params,
            lambda t: _slice_tree(t, dims, plan.n, plan.rank))
    return local, opt_state


def unshard_model(model) -> None:
    """Gather the shards back into full parameters and updater state on
    every rank of the model group and drop the plan (before the model is
    placed on another mesh). Collective over the model group."""
    if getattr(model, "_tp", None) is None:
        return
    params, opt = full_params(model), full_opt_state(model)
    model._tp = None
    model.set_params(params)
    if opt is not None:
        model.opt_state = opt
