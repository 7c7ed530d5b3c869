"""Global network configuration (counterpart of the part of
``deeplearning4j_tpu/nn/conf/builder.py`` that config JSON needs).

The fluent builder stays in the JAX package: a config is built there
(or written by hand) and its JSON drives both packages. Here the
``global`` block is read and written back unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["NeuralNetConfiguration"]


class NeuralNetConfiguration:
    """Global training/config defaults (one per network)."""

    def __init__(self):
        self.seed: int = 0
        self.updater_cfg: Optional[dict] = None
        self.defaults: Dict[str, Any] = {}
        self.dropout: float = 0.0
        self.optimization_algo: str = "stochastic_gradient_descent"
        self.gradient_clip: Optional[dict] = None
        self.tbptt: Optional[dict] = None

    def global_to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "updater": self.updater_cfg,
            "defaults": self.defaults,
            "dropout": self.dropout,
            "optimization_algo": self.optimization_algo,
            "gradient_clip": self.gradient_clip,
            "tbptt": self.tbptt,
        }

    @staticmethod
    def global_from_dict(d: dict) -> "NeuralNetConfiguration":
        c = NeuralNetConfiguration()
        c.seed = d.get("seed", 0)
        c.updater_cfg = d.get("updater")
        c.defaults = d.get("defaults", {}) or {}
        c.dropout = d.get("dropout", 0.0)
        c.optimization_algo = d.get("optimization_algo",
                                    "stochastic_gradient_descent")
        c.gradient_clip = d.get("gradient_clip")
        c.tbptt = d.get("tbptt")
        return c
