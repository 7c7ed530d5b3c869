"""Graph vertex configs for ComputationGraph DAGs (counterpart of
``deeplearning4j_tpu/nn/conf/graph.py``): the 14 vertex types, their
registry and JSON, and their mask routing.

A vertex is a (possibly multi-input) function without trainable
params; layers are wrapped as layer vertices by the graph builder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["GraphVertex", "vertex_from_dict", "ElementWiseVertex",
           "MergeVertex", "SubsetVertex", "StackVertex", "UnstackVertex",
           "ScaleVertex", "ShiftVertex", "L2NormalizeVertex", "L2Vertex",
           "PreprocessorVertex", "ReshapeVertex", "PoolHelperVertex",
           "LastTimeStepVertex", "DuplicateToTimeSeriesVertex"]

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def combine_masks_or(masks):
    """Reference mask-combination rule (MergeVertex.java:229-252,
    ElementWiseVertex.java:146-160): if ANY input mask is absent the
    output mask is null (missing = "all steps present"); otherwise
    element-wise OR."""
    if not masks or any(m is None for m in masks):
        return None
    out = masks[0]
    for m in masks[1:]:
        out = torch.maximum(out, m)
    return out


def vertex_from_dict(d: dict):
    d = dict(d)
    t = d.pop("@type")
    if t not in _VERTEX_REGISTRY:
        raise ValueError(f"Unknown vertex type '{t}' "
                         f"(known: {sorted(_VERTEX_REGISTRY)})")
    return _VERTEX_REGISTRY[t].from_dict(d)


@dataclasses.dataclass
class GraphVertex:
    def apply(self, inputs, *, mask=None):
        raise NotImplementedError

    def propagate_mask(self, in_masks, inputs, mask_env=None):
        """Per-vertex mask routing (reference
        GraphVertex.feedForwardMaskArrays). ``in_masks`` aligns with
        ``inputs``; ``mask_env`` maps every already-computed vertex /
        network-input name to its mask (needed by vertices that
        reference a named input, e.g. DuplicateToTimeSeriesVertex)."""
        return combine_masks_or(in_masks)

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @classmethod
    def from_dict(cls, d: dict):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                v = d[f.name]
                kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """(nn/conf/graph/ElementWiseVertex.java:42-43). op ∈ {add,
    subtract, product, average, max}."""

    op: str = "add"

    def apply(self, inputs, *, mask=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("subtract requires exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op == "product":
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "average":
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWise op '{self.op}'")


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature (last) axis
    (nn/conf/graph/MergeVertex.java — reference concatenates on dim 1 =
    channels under NCHW; channel-last here)."""

    def apply(self, inputs, *, mask=None):
        return torch.cat(inputs, dim=-1)

    def output_type(self, *ts: InputType) -> InputType:
        t0 = ts[0]
        if t0.kind == "cnn":
            return InputType.convolutional(t0.height, t0.width,
                                           sum(t.channels for t in ts))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in ts), t0.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in ts))


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Feature-range slice [from_, to_] inclusive
    (nn/conf/graph/SubsetVertex.java)."""

    from_: int = 0
    to_: int = 0

    def apply(self, inputs, *, mask=None):
        return inputs[0][..., self.from_:self.to_ + 1]

    def output_type(self, *ts: InputType) -> InputType:
        n = self.to_ - self.from_ + 1
        t = ts[0]
        if t.kind == "rnn":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "cnn":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack along batch axis (nn/conf/graph/StackVertex.java)."""

    def apply(self, inputs, *, mask=None):
        return torch.cat(inputs, dim=0)

    def propagate_mask(self, in_masks, inputs, mask_env=None):
        # reference StackVertex.java:165-194: vstack the masks; a
        # missing mask becomes all-ones with the present masks' width —
        # (B, T) for time series, (B, 1) for feed-forward inputs.
        # 1-D (B,) masks are normalized to (B, 1) first so every row
        # of the concat has rank 2.
        if all(m is None for m in in_masks):
            return None
        norm = [None if m is None
                else (m[:, None] if m.dim() == 1 else m)
                for m in in_masks]
        width = next(m.shape[1] for m in norm if m is not None)
        mats = []
        for m, x in zip(norm, inputs):
            if m is not None:
                mats.append(m)
            elif x.dim() == 3:
                mats.append(torch.ones(x.shape[:2], dtype=torch.float32,
                                       device=x.device))
            else:
                mats.append(torch.ones((x.shape[0], width),
                                       dtype=torch.float32, device=x.device))
        return torch.cat(mats, dim=0)


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Take slice ``from_`` of ``stack_size`` along batch
    (nn/conf/graph/UnstackVertex.java)."""

    from_: int = 0
    stack_size: int = 1

    def apply(self, inputs, *, mask=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_ * step:(self.from_ + 1) * step]

    def propagate_mask(self, in_masks, inputs, mask_env=None):
        m = in_masks[0]
        if m is None:
            return None
        step = m.shape[0] // self.stack_size
        return m[self.from_ * step:(self.from_ + 1) * step]


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """(nn/conf/graph/ScaleVertex.java)."""

    scale: float = 1.0

    def apply(self, inputs, *, mask=None):
        return inputs[0] * self.scale


@register_vertex
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """(nn/conf/graph/ShiftVertex.java)."""

    shift: float = 0.0

    def apply(self, inputs, *, mask=None):
        return inputs[0] + self.shift


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """x / ||x||_2 over feature axes (nn/conf/graph/L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def apply(self, inputs, *, mask=None):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        n = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / (n + self.eps)


@register_vertex
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """Pairwise L2 distance between two inputs
    (nn/conf/graph/L2Vertex.java) → (B,1)."""

    eps: float = 1e-8

    def apply(self, inputs, *, mask=None):
        a, b = inputs
        axes = tuple(range(1, a.dim()))
        return torch.sqrt(torch.sum((a - b) ** 2, dim=axes)
                          + self.eps)[:, None]

    def output_type(self, *ts: InputType) -> InputType:
        return InputType.feed_forward(1)


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """Wraps an InputPreProcessor (nn/conf/graph/PreprocessorVertex.java)."""

    preprocessor: Optional[dict] = None

    def _pp(self):
        from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
            preprocessor_from_dict)
        return preprocessor_from_dict(self.preprocessor)

    def apply(self, inputs, *, mask=None):
        return self._pp()(inputs[0])

    def output_type(self, *ts: InputType) -> InputType:
        return self._pp().output_type(ts[0])


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """(nn/conf/graph/ReshapeVertex.java). Shape excludes batch dim."""

    shape: Tuple[int, ...] = ()

    def apply(self, inputs, *, mask=None):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))


@register_vertex
@dataclasses.dataclass
class PoolHelperVertex(GraphVertex):
    """Strips the first row/col of a CNN activation — GoogLeNet
    compatibility shim (nn/conf/graph/PoolHelperVertex.java)."""

    def apply(self, inputs, *, mask=None):
        return inputs[0][:, 1:, 1:, :]

    def output_type(self, *ts: InputType) -> InputType:
        t = ts[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)


@register_vertex
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """Last unmasked timestep of a (B,T,C) input
    (nn/conf/graph/rnn/LastTimeStepVertex.java). ``mask_input`` names
    the graph input whose mask applies."""

    mask_input: Optional[str] = None

    def apply(self, inputs, *, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1, :]
        lengths = torch.sum(mask, dim=1).to(torch.int64)
        idx = torch.clamp(lengths - 1, min=0)
        return torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0, :]

    def propagate_mask(self, in_masks, inputs, mask_env=None):
        # after extracting the last step the mask is consumed
        # (reference rnn/LastTimeStepVertex.java:144-149)
        return None

    def output_type(self, *ts: InputType) -> InputType:
        return InputType.feed_forward(ts[0].size)


@register_vertex
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """Broadcast a (B,C) vector across T timesteps of a reference input
    (nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java). The second
    input supplies T."""

    ts_input: Optional[str] = None

    def apply(self, inputs, *, mask=None):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[1])

    def propagate_mask(self, in_masks, inputs, mask_env=None):
        # present as per the corresponding time-series input's mask
        # (reference rnn/DuplicateToTimeSeriesVertex.java:104-113)
        if self.ts_input is not None and mask_env is not None:
            return mask_env.get(self.ts_input)
        return None

    def output_type(self, *ts: InputType) -> InputType:
        return InputType.recurrent(ts[0].flat_size(),
                                   ts[1].timesteps if len(ts) > 1 else None)
