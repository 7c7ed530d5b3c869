"""MultiLayerConfiguration: ordered layer stack + serde (counterpart of
``deeplearning4j_tpu/nn/conf/multi_layer.py``), reading and writing the
same JSON with the same ``format_version`` check.

Preprocessors are not ported yet: a config that holds one, or a stack
that would need one inserted, raises ``NotImplementedError`` naming
it.
"""

from __future__ import annotations

import json
from typing import List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as _layers
from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (Layer,
                                                          layer_from_dict)

__all__ = ["MultiLayerConfiguration", "FORMAT_VERSION"]

FORMAT_VERSION = 1


def _needed_preprocessor(have: InputType, layer: Layer) -> Optional[str]:
    """The preprocessor the JAX package would insert before ``layer``
    (``auto_preprocessor``), restricted to the ported layer kinds."""
    if have.kind == "cnn":
        if isinstance(layer, _layers.RnnOutputLayer):
            return "CnnToRnnPreProcessor"
        return "CnnToFeedForwardPreProcessor"
    return None


class MultiLayerConfiguration:
    def __init__(self, conf: NeuralNetConfiguration, layers: List[Layer],
                 input_type: Optional[InputType] = None):
        self.conf = conf
        self.layers = layers
        self.input_type = input_type
        if input_type is not None:
            self._infer_shapes()

    def _infer_shapes(self):
        t = self.input_type
        for i, layer in enumerate(self.layers):
            pp = _needed_preprocessor(t, layer)
            if pp is not None:
                raise NotImplementedError(
                    f"layer {i} needs a {pp}, and preprocessors are not "
                    "ported to deeplearning4j_tpu_torch yet")
            layer.set_n_in(t)
            t = layer.output_type(t)

    # ---- serde ----
    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "network_type": "MultiLayerNetwork",
            "global": self.conf.global_to_dict(),
            "input_type": (self.input_type.to_dict()
                           if self.input_type else None),
            "layers": [l.to_dict() for l in self.layers],
            "preprocessors": {},
        }

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        v = d.get("format_version", FORMAT_VERSION)
        if v > FORMAT_VERSION:
            raise ValueError(f"Config format_version {v} is newer than "
                             f"this build supports ({FORMAT_VERSION})")
        for i, p in (d.get("preprocessors") or {}).items():
            raise NotImplementedError(
                f"preprocessor {p.get('@type', p)!r} before layer {i} is "
                "not ported to deeplearning4j_tpu_torch yet")
        conf = NeuralNetConfiguration.global_from_dict(d.get("global", {}))
        layers = [layer_from_dict(ld) for ld in d["layers"]]
        it = d.get("input_type")
        return MultiLayerConfiguration(
            conf, layers, InputType.from_dict(it) if it else None)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=kw.pop("indent", 2), **kw)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))
