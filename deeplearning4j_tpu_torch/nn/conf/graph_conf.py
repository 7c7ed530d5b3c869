"""ComputationGraphConfiguration and GraphBuilder (counterpart of
``deeplearning4j_tpu/nn/conf/graph_conf.py``, same JSON): named
inputs, vertices (layers or graph vertices) wired by name, named
outputs; the topological order (Kahn's algorithm, ties broken by name)
is computed once and cached, and each layer vertex's input type is
inferred along it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import GraphVertex, vertex_from_dict
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (FORMAT_VERSION,
                                                          migrate_config)

__all__ = ["ComputationGraphConfiguration", "GraphBuilder"]


class ComputationGraphConfiguration:
    def __init__(self, conf: NeuralNetConfiguration,
                 inputs: List[str],
                 vertices: Dict[str, Tuple[object, List[str]]],
                 outputs: List[str],
                 input_types: Optional[List[InputType]] = None):
        self.conf = conf
        self.network_inputs = list(inputs)
        self.vertices = dict(vertices)      # name -> (Layer|GraphVertex, ins)
        self.network_outputs = list(outputs)
        self.input_types = input_types
        self._topo: Optional[List[str]] = None
        self._vertex_input_types: Dict[str, InputType] = {}
        if input_types is not None:
            self._infer_shapes()

    # ---- topology ----
    def topological_order(self) -> List[str]:
        """Kahn's algorithm over vertex names; cached (reference
        ComputationGraph.java:1187)."""
        if self._topo is not None:
            return self._topo
        indeg = {}
        consumers: Dict[str, List[str]] = {}
        for name, (_, ins) in self.vertices.items():
            indeg[name] = 0
            for i in ins:
                if i not in self.network_inputs:
                    indeg[name] += 1
        for name, (_, ins) in self.vertices.items():
            for i in ins:
                if i in self.vertices:
                    consumers.setdefault(i, []).append(name)
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in consumers.get(n, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving {sorted(cyc)}")
        self._topo = order
        return order

    def _infer_shapes(self):
        types: Dict[str, InputType] = dict(zip(self.network_inputs,
                                               self.input_types))
        for name in self.topological_order():
            obj, ins = self.vertices[name]
            in_types = [types[i] for i in ins]
            if isinstance(obj, Layer):
                obj.set_n_in(in_types[0])
                self._vertex_input_types[name] = in_types[0]
                types[name] = obj.output_type(in_types[0])
            else:
                types[name] = obj.output_type(*in_types)
        self.activation_types = types

    def vertex_input_type(self, name: str) -> Optional[InputType]:
        return self._vertex_input_types.get(name)

    # ---- serde ----
    def to_dict(self) -> dict:
        vd = {}
        for name, (obj, ins) in self.vertices.items():
            vd[name] = {
                "kind": "layer" if isinstance(obj, Layer) else "vertex",
                "config": obj.to_dict(),
                "inputs": list(ins),
            }
        return {
            "format_version": FORMAT_VERSION,
            "network_type": "ComputationGraph",
            "global": self.conf.global_to_dict(),
            "inputs": self.network_inputs,
            "input_types": ([t.to_dict() for t in self.input_types]
                            if self.input_types else None),
            "vertices": vd,
            "outputs": self.network_outputs,
        }

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        d = migrate_config(d)
        conf = NeuralNetConfiguration.global_from_dict(d.get("global", {}))
        vertices = {}
        for name, vd in d["vertices"].items():
            obj = (layer_from_dict(vd["config"]) if vd["kind"] == "layer"
                   else vertex_from_dict(vd["config"]))
            vertices[name] = (obj, list(vd["inputs"]))
        its = d.get("input_types")
        return ComputationGraphConfiguration(
            conf, d["inputs"], vertices, d["outputs"],
            [InputType.from_dict(t) for t in its] if its else None)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        """The config as YAML: the JAX package's text (PyYAML, imported
        here so that the package needs it only for YAML)."""
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))

    def clone(self) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(self.to_dict())


class GraphBuilder:
    """ComputationGraphConfiguration.GraphBuilder equivalent."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._inputs: List[str] = []
        self._vertices: Dict[str, Tuple[object, List[str]]] = {}
        self._outputs: List[str] = []
        self._input_types: Optional[List[InputType]] = None

    def add_inputs(self, *names: str):
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType):
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        layer = self._conf.stamp_defaults(layer)
        layer.name = name
        self._vertices[name] = (layer, list(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        self._vertices[name] = (vertex, list(inputs))
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        for name, (_, ins) in self._vertices.items():
            for i in ins:
                if i not in self._vertices and i not in self._inputs:
                    raise ValueError(f"Vertex '{name}' references unknown "
                                     f"input '{i}'")
        for o in self._outputs:
            if o not in self._vertices:
                raise ValueError(f"Output '{o}' is not a vertex")
        return ComputationGraphConfiguration(
            self._conf, self._inputs, self._vertices, self._outputs,
            self._input_types)
