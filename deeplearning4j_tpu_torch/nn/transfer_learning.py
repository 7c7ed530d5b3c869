"""Transfer learning: network surgery on trained models (counterpart of
``deeplearning4j_tpu/nn/transfer_learning.py``).

Mirrors nn/transferlearning/TransferLearning.java: freeze layers below
a boundary (``set_feature_extractor``, reference :84 — wraps them in
FrozenLayer), replace a layer's n_out with re-initialized weights
(``n_out_replace``, :98), remove/add output layers, and apply a
``FineTuneConfiguration`` (new global updater/lr for the unfrozen part).

``TransferLearning`` operates on MultiLayerNetwork;
``TransferLearningGraph`` is the vertex-name surgery builder for
ComputationGraph (reference TransferLearning.GraphBuilder :449:
setFeatureExtractor :501 freezes the named vertices and every vertex
on a path from an input to them, nOutReplace :520, removeVertex
:631/:642, addLayer/addVertex :655/:685, setOutputs :698).

Params the surgery keeps are copied onto the new network's device; a
layer that is re-initialized draws from a CPU ``torch.Generator`` seeded
from the configuration's seed and the layer's index.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer
from deeplearning4j_tpu_torch.nn.conf.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.util.tree import tree_copy

__all__ = ["TransferLearning", "TransferLearningGraph",
           "FineTuneConfiguration"]


class FineTuneConfiguration:
    """(nn/transferlearning/FineTuneConfiguration.java): overrides
    applied to the *unfrozen* part of the network."""

    def __init__(self, updater: Optional[dict] = None,
                 seed: Optional[int] = None,
                 dropout: Optional[float] = None):
        self.updater = updater
        self.seed = seed
        self.dropout = dropout


class TransferLearning:
    """Builder (nn/transferlearning/TransferLearning.java Builder)."""

    def __init__(self, net: MultiLayerNetwork):
        if net.params is None:
            raise ValueError("Transfer learning requires an initialized net")
        self._src = net
        self._freeze_until: Optional[int] = None
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._nout_replacements = {}       # idx -> (n_out, weight_init)
        self._remove_last = 0
        self._appended: List[Layer] = []

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearning":
        return TransferLearning(net)

    def fine_tune_configuration(self, cfg: FineTuneConfiguration):
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, layer_idx: int):
        """Freeze layers [0..layer_idx] (reference :84)."""
        self._freeze_until = layer_idx
        return self

    def n_out_replace(self, layer_idx: int, n_out: int,
                      weight_init: str = "xavier"):
        self._nout_replacements[layer_idx] = (n_out, weight_init)
        return self

    def remove_output_layer(self):
        self._remove_last += 1
        return self

    def remove_layers_from_output(self, n: int):
        self._remove_last += n
        return self

    def add_layer(self, layer: Layer):
        self._appended.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._src
        conf_dict = src.conf.to_dict()
        new_conf = MultiLayerConfiguration.from_dict(conf_dict)
        layers = new_conf.layers
        params = tree_copy(src.params)
        states = tree_copy(src.state)

        # 1. remove output layers
        for _ in range(self._remove_last):
            layers.pop()
            params.pop()
            states.pop()
            new_conf.preprocessors.pop(len(layers), None)

        # 2. append new layers (shapes inferred below at init of new ones)
        layers.extend(self._appended)

        # 3. apply fine-tune overrides
        if self._fine_tune is not None:
            if self._fine_tune.updater is not None:
                new_conf.conf.updater_cfg = self._fine_tune.updater
            if self._fine_tune.seed is not None:
                new_conf.conf.seed = self._fine_tune.seed
            if self._fine_tune.dropout is not None:
                # applies to layers that will remain trainable (frozen
                # layers run inference-mode anyway)
                start = (self._freeze_until + 1
                         if self._freeze_until is not None else 0)
                for lay in layers[start:]:
                    lay.dropout = self._fine_tune.dropout

        # 4. wrap frozen layers
        if self._freeze_until is not None:
            for i in range(self._freeze_until + 1):
                if not isinstance(layers[i], FrozenLayer):
                    layers[i] = FrozenLayer(inner=layers[i])

        # 5. rebuild net; re-init then copy/transplant params
        net = MultiLayerNetwork(new_conf, device=src.device)
        net.init(new_conf.conf.seed)
        new_params, new_states = net.params, list(net.state)
        n_copied = len(params)
        for i in range(len(layers)):
            if i in self._nout_replacements:
                continue                  # keep fresh init
            if i < n_copied:
                new_params[i] = params[i]
                new_states[i] = states[i]

        # 6. n_out replacement: re-init that layer AND the next (its
        #    n_in changed), reference nOutReplace semantics
        if self._nout_replacements:
            t = new_conf.input_type
            seed = new_conf.conf.seed or 0
            for idx, (n_out, w_init) in self._nout_replacements.items():
                lay = layers[idx]
                target = lay.wrapped if isinstance(lay, FrozenLayer) else lay
                target.n_out = n_out
                target.weight_init = w_init
            # recompute shapes & re-init affected layers
            t = new_conf.input_type
            for i, lay in enumerate(layers):
                if t is not None and i in new_conf.preprocessors:
                    t = new_conf.preprocessors[i].output_type(t)
                affected = (i in self._nout_replacements
                            or (i - 1) in self._nout_replacements)
                if affected:
                    target = lay.wrapped if isinstance(lay, FrozenLayer) \
                        else lay
                    if hasattr(target, "n_in"):
                        target.n_in = None
                    p, s = lay.initialize(
                        torch.Generator().manual_seed(int(seed) + i), t)
                    new_params[i] = p
                    new_states[i] = s
                elif t is not None:
                    lay.set_n_in(t)
                t = lay.output_type(t) if t is not None else None

        net.set_params(new_params)
        net.state = [{k: v.to(net.device) for k, v in st.items()}
                     for st in new_states]
        net._build_optimizer()
        return net


class TransferLearningGraph:
    """Vertex-name surgery on a trained ComputationGraph (reference
    TransferLearning.GraphBuilder, TransferLearning.java:449)."""

    def __init__(self, cg):
        if cg.params is None:
            raise ValueError("Transfer learning requires an initialized "
                             "graph")
        self._src = cg
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._frozen_at: List[str] = []
        self._nout_replacements: Dict[str, Tuple[int, str]] = {}
        self._removed: List[Tuple[str, bool]] = []   # (name, keep_conns)
        self._added: List[Tuple[str, object, List[str]]] = []
        self._new_outputs: Optional[List[str]] = None

    @staticmethod
    def builder(cg) -> "TransferLearningGraph":
        return TransferLearningGraph(cg)

    def fine_tune_configuration(self, cfg: FineTuneConfiguration):
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, *vertex_names: str):
        """Freeze the named vertices and every vertex on a path from an
        input to them (reference :501)."""
        self._frozen_at.extend(vertex_names)
        return self

    def n_out_replace(self, layer_name: str, n_out: int,
                      weight_init: str = "xavier"):
        """Change a layer vertex's n_out; the vertex AND its direct
        consumers are re-initialized (reference :520 — 'this will also
        affect the vertex layer that follows')."""
        self._nout_replacements[layer_name] = (n_out, weight_init)
        return self

    def remove_vertex_keep_connections(self, name: str):
        """Remove the vertex definition; downstream wiring referencing
        ``name`` is kept, expecting a new vertex added under the same
        name (reference removeVertexKeepConnections :631)."""
        self._removed.append((name, True))
        return self

    def remove_vertex_and_connections(self, name: str):
        """Remove the vertex and prune it from every consumer's input
        list (reference removeVertexAndConnections :642)."""
        self._removed.append((name, False))
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        self._added.append((name, layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        self._added.append((name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str):
        self._new_outputs = list(names)
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def _propagate_width_change(vertices, seed: str, affected: set):
        """Mark every vertex whose input width changes when ``seed``'s
        output width changes: direct consumers, and (transitively)
        consumers of parameter-less vertices, which pass width through."""
        frontier = [seed]
        seen = {seed}
        while frontier:
            cur = frontier.pop()
            for vname, (obj, ins) in vertices.items():
                if cur in ins and vname not in seen:
                    seen.add(vname)
                    affected.add(vname)
                    if not isinstance(obj, Layer):
                        frontier.append(vname)

    def _ancestors_inclusive(self, vertices, targets):
        """The named vertices plus everything upstream of them."""
        out = set()
        stack = [t for t in targets]
        while stack:
            n = stack.pop()
            if n in out or n not in vertices:
                continue
            out.add(n)
            stack.extend(vertices[n][1])
        return out

    def build(self):
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph)
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration)

        src = self._src
        conf = src.conf.clone()
        vertices = conf.vertices           # name -> (obj, ins)
        outputs = list(conf.network_outputs)

        # 1. removals; consumers of a pruned vertex see a width change
        rewired = set()
        removed_output_pos = {}
        for name, keep in self._removed:
            if name not in vertices:
                raise ValueError(f"Cannot remove unknown vertex '{name}'")
            del vertices[name]
            if not keep:
                for vname, (obj, ins) in list(vertices.items()):
                    if name in ins:
                        vertices[vname] = (obj,
                                           [i for i in ins if i != name])
                        rewired.add(vname)
            if name in outputs:
                removed_output_pos[name] = outputs.index(name)
                outputs = [o for o in outputs if o != name]

        # 2. additions (stamp global defaults like GraphBuilder.add_layer);
        #    re-adding a vertex under a removed output's name restores
        #    its output slot (the remove-head/add-head fine-tune flow)
        added_names = set()
        for name, obj, ins in self._added:
            if isinstance(obj, Layer):
                obj = conf.conf.stamp_defaults(obj)
                obj.name = name
            vertices[name] = (obj, list(ins))
            added_names.add(name)
            if name in removed_output_pos and name not in outputs:
                outputs.insert(min(removed_output_pos[name],
                                   len(outputs)), name)

        # 3. outputs
        if self._new_outputs is not None:
            outputs = list(self._new_outputs)

        # 4. fine-tune overrides
        if self._fine_tune is not None:
            if self._fine_tune.updater is not None:
                conf.conf.updater_cfg = self._fine_tune.updater
            if self._fine_tune.seed is not None:
                conf.conf.seed = self._fine_tune.seed

        # 5. n_out replacement: mutate the named layers; mark them and
        #    their direct consumers for re-init. Rewired vertices
        #    (pruned inputs) are width-change sources too.
        affected = set(added_names)
        for vname in rewired:
            obj2, _ = vertices[vname]
            affected.add(vname)
            if not isinstance(obj2, Layer):
                # parameter-less vertex: width change propagates to
                # its consumers
                self._propagate_width_change(vertices, vname, affected)
        for lname, (n_out, w_init) in self._nout_replacements.items():
            if lname not in vertices:
                raise ValueError(f"n_out_replace: unknown vertex "
                                 f"'{lname}'")
            obj, ins = vertices[lname]
            target = obj.wrapped if isinstance(obj, FrozenLayer) else obj
            if not isinstance(target, Layer):
                raise ValueError(f"n_out_replace: '{lname}' is not a "
                                 f"layer vertex")
            target.n_out = n_out
            target.weight_init = w_init
            affected.add(lname)
            # direct consumers change input width; a parameter-less
            # vertex (Merge/ElementWise/...) passes the width change on
            # to ITS consumers
            self._propagate_width_change(vertices, lname, affected)

        # 6. reset shape inference for affected vertices so the new
        #    widths propagate (set_n_in only fills n_in when unset)
        for vname in affected:
            obj, _ = vertices.get(vname, (None, None))
            if obj is None:
                continue
            target = obj.wrapped if isinstance(obj, FrozenLayer) else obj
            if hasattr(target, "n_in"):
                target.n_in = None

        # 7. freeze: named vertices + all their ancestors. Validate the
        #    names — a typo must not silently freeze nothing and let
        #    fine-tuning destroy the pretrained stem
        for name in self._frozen_at:
            if name not in vertices:
                raise ValueError(
                    f"set_feature_extractor: unknown vertex '{name}' "
                    f"(have {sorted(vertices)})")
        frozen = self._ancestors_inclusive(vertices, self._frozen_at)
        for vname in frozen:
            obj, ins = vertices[vname]
            if isinstance(obj, Layer) and not isinstance(obj, FrozenLayer):
                vertices[vname] = (FrozenLayer(inner=obj), ins)

        new_conf = ComputationGraphConfiguration(
            conf.conf, conf.network_inputs, vertices, outputs,
            conf.input_types)
        cg = ComputationGraph(new_conf, device=src.device)
        cg.init(new_conf.conf.seed)

        # 8. transplant surviving params (everything except affected)
        params, src_params = cg.params, src.params
        for vname in params:
            if vname in affected:
                continue
            if src_params is not None and vname in src_params:
                params[vname] = tree_copy(src_params[vname])
                cg.state[vname] = tree_copy(src.state[vname])
        cg.set_params(params)
        cg._build_optimizer()
        return cg
