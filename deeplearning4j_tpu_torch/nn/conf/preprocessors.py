"""Input preprocessors: reshapes between layer families (counterpart of
``deeplearning4j_tpu/nn/conf/preprocessors.py``, same classes, fields
and JSON).

Convolutional activations are NHWC, as in the JAX package, so the
flattening preprocessors flatten in H·W·C order: the order the dense
weights that follow a conv stack expect.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["InputPreProcessor", "preprocessor_from_dict",
           "CnnToFeedForwardPreProcessor", "FeedForwardToCnnPreProcessor",
           "RnnToFeedForwardPreProcessor", "FeedForwardToRnnPreProcessor",
           "CnnToRnnPreProcessor", "RnnToCnnPreProcessor",
           "auto_preprocessor"]

_PP_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _PP_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d: Optional[dict]):
    if d is None:
        return None
    d = dict(d)
    t = d.pop("@type")
    if t not in _PP_REGISTRY:
        raise ValueError(f"Unknown preprocessor type '{t}' "
                         f"(known: {sorted(_PP_REGISTRY)})")
    return _PP_REGISTRY[t](**d)


@dataclasses.dataclass
class InputPreProcessor:
    def __call__(self, x):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        d.update(dataclasses.asdict(self))
        return d


@_register
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(B, H, W, C) -> (B, H·W·C)."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, t: InputType) -> InputType:
        return InputType.feed_forward(t.flat_size())


@_register
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(B, H·W·C) -> (B, H, W, C); a 4-d input passes unchanged."""
    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x):
        if x.dim() == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, t: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@_register
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(B, T, C) -> (B·T, C)."""

    def __call__(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, t: InputType) -> InputType:
        return InputType.feed_forward(t.size)


@_register
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(B·T, C) -> (B, T, C)."""
    timesteps: int = 0

    def __call__(self, x):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, t: InputType) -> InputType:
        return InputType.recurrent(t.size, self.timesteps or None)


@_register
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """(B, H, W, C) -> (B, T=H, W·C): rows are timesteps."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def __call__(self, x):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)

    def output_type(self, t: InputType) -> InputType:
        return InputType.recurrent(t.width * t.channels, t.height)


@_register
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """(B, T, C) -> (B, H, W, C)."""
    height: int = 0
    width: int = 0
    channels: int = 1

    def __call__(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, t: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


def auto_preprocessor(have: InputType, layer) -> Optional[InputPreProcessor]:
    """The preprocessor between activation type ``have`` and ``layer``,
    by the JAX package's rule (MultiLayerConfiguration.Builder's
    auto-insertion)."""
    from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
        Convolution1DLayer, ConvolutionLayer, CroppingLayer,
        SpaceToBatchLayer, SpaceToDepthLayer, UpsamplingLayer,
        ZeroPaddingLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.normalization import (
        BatchNormalization, LocalResponseNormalization)
    from deeplearning4j_tpu_torch.nn.conf.layers.output import (
        RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.pooling import (
        GlobalPoolingLayer, Subsampling1DLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
        BaseRecurrentLayer, Bidirectional, LastTimeStep)
    from deeplearning4j_tpu_torch.nn.conf.layers.special import (
        Yolo2OutputLayer)

    wants_cnn = isinstance(layer, (ConvolutionLayer, SubsamplingLayer,
                                   LocalResponseNormalization,
                                   ZeroPaddingLayer, UpsamplingLayer,
                                   CroppingLayer, SpaceToDepthLayer,
                                   SpaceToBatchLayer,
                                   Yolo2OutputLayer)) and not \
        isinstance(layer, (Convolution1DLayer, Subsampling1DLayer))
    wants_rnn = isinstance(layer, (BaseRecurrentLayer, Bidirectional,
                                   LastTimeStep, RnnOutputLayer,
                                   Convolution1DLayer, Subsampling1DLayer))

    if have.kind == "cnnflat" and wants_cnn:
        return FeedForwardToCnnPreProcessor(have.height, have.width,
                                            have.channels)
    if have.kind == "cnn" and not wants_cnn and not wants_rnn and not \
            isinstance(layer, (BatchNormalization, GlobalPoolingLayer)):
        return CnnToFeedForwardPreProcessor(have.height, have.width,
                                            have.channels)
    if have.kind == "cnn" and wants_rnn:
        return CnnToRnnPreProcessor(have.height, have.width, have.channels)
    return None
