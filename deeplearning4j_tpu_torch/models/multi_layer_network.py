"""MultiLayerNetwork: the sequential-stack executor (counterpart of
``deeplearning4j_tpu/models/multi_layer_network.py``), as an
``nn.Module`` on an explicit device.

Parameters keep the JAX package's structure: ``net.params`` is a list
with one ``{name: tensor}`` dict per layer index (nested for the
transformer block's ``attn``), and the same ``"1/attn/Wq"`` paths name
them in the checkpoint. Weights keep the JAX layout, ``W`` as
``(n_in, n_out)`` for ``x @ W``. Ported so far: ``init`` and inference
(``output``); training is the training slice's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration)

__all__ = ["MultiLayerNetwork"]


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
                    t.to(device), requires_grad=False))

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

    # ---- parameters ----
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Sample every layer's parameters from a CPU ``torch.Generator``
        seeded with ``seed`` (default: the config's), then place them on
        the network's device."""
        seed = self.conf.conf.seed if seed is None else seed
        params, self.state = self._sample_params(seed)
        self.set_params(params)
        return self

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
        in the ``params`` structure) on the network's device."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} param dicts for "
                             f"{len(self.layers)} layers")
        self.layer_params = nn.ModuleList(
            _ParamTree(p, self.device) for p in params)
        if self.state is None:
            self.state = [{} for _ in self.layers]

    # ---- forward ----
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, p, s in zip(self.layers, self.params, self.state):
            x, _ = layer.apply(p, s, x)
        return x

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
