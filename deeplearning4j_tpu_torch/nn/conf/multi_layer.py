"""MultiLayerConfiguration: ordered layer stack, preprocessors and serde
(counterpart of ``deeplearning4j_tpu/nn/conf/multi_layer.py``), reading
and writing the same JSON with the same ``format_version`` check.
Preprocessors are inserted between layer families as the JAX package
inserts them (``preprocessors.auto_preprocessor``) and serialized under
the index of the layer whose input they reshape.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (Layer,
                                                          layer_from_dict)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor, auto_preprocessor, preprocessor_from_dict)

__all__ = ["MultiLayerConfiguration", "FORMAT_VERSION", "migrate_config"]

FORMAT_VERSION = 1


class MultiLayerConfiguration:
    def __init__(self, conf: NeuralNetConfiguration, layers: List[Layer],
                 input_type: Optional[InputType] = None,
                 preprocessors: Optional[Dict[int, InputPreProcessor]] = None):
        self.conf = conf
        self.layers = layers
        self.input_type = input_type
        # index -> preprocessor applied to that layer's INPUT
        self.preprocessors: Dict[int, InputPreProcessor] = \
            dict(preprocessors or {})
        if input_type is not None and not self.preprocessors:
            self._infer_shapes()

    def _infer_shapes(self):
        """Infer each layer's nIn and insert preprocessors (the JAX
        ListBuilder.build() shape pass)."""
        t = self.input_type
        for i, layer in enumerate(self.layers):
            pp = auto_preprocessor(t, layer)
            if pp is not None:
                self.preprocessors[i] = pp
                t = pp.output_type(t)
            layer.set_n_in(t)
            t = layer.output_type(t)

    def output_type(self) -> InputType:
        t = self.input_type
        for i, layer in enumerate(self.layers):
            if i in self.preprocessors:
                t = self.preprocessors[i].output_type(t)
            t = layer.output_type(t)
        return t

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    # ---- serde ----
    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "network_type": "MultiLayerNetwork",
            "global": self.conf.global_to_dict(),
            "input_type": (self.input_type.to_dict()
                           if self.input_type else None),
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {str(i): p.to_dict()
                              for i, p in self.preprocessors.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        d = migrate_config(d)
        conf = NeuralNetConfiguration.global_from_dict(d.get("global", {}))
        layers = [layer_from_dict(ld) for ld in d["layers"]]
        it = d.get("input_type")
        pps = {int(i): preprocessor_from_dict(p)
               for i, p in (d.get("preprocessors") or {}).items()}
        return MultiLayerConfiguration(
            conf, layers, InputType.from_dict(it) if it else None,
            preprocessors=pps)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def clone(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(self.to_dict())


def migrate_config(d: dict) -> dict:
    """The JAX package's version check: a config newer than
    ``FORMAT_VERSION`` is refused; version 1 needs no upgrade."""
    v = d.get("format_version", FORMAT_VERSION)
    if v > FORMAT_VERSION:
        raise ValueError(f"Config format_version {v} is newer than "
                         f"this build supports ({FORMAT_VERSION})")
    return d
