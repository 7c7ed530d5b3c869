"""Layer configs: every ``@type`` the JAX package's layers export;
importing this package registers their names."""

from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
    SelfAttentionLayer, TransformerEncoderLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.base import (
    LAYER_REGISTRY, BaseLayer, FeedForwardLayer, Layer, layer_from_dict,
    register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
    Convolution1DLayer, ConvolutionLayer, CroppingLayer, Deconvolution2DLayer,
    DepthwiseConvolution2DLayer, SeparableConvolution2DLayer,
    SpaceToBatchLayer, SpaceToDepthLayer, UpsamplingLayer, ZeroPadding1DLayer,
    ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.core import (
    RBM, ActivationLayer, AutoEncoder, DenseLayer, DropoutLayer,
    EmbeddingLayer, EmbeddingSequenceLayer, RecursiveAutoEncoder)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import (
    BatchNormalization, LayerNormalization, LocalResponseNormalization)
from deeplearning4j_tpu_torch.nn.conf.layers.output import (
    CenterLossOutputLayer, LossLayer, OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.pooling import (
    GlobalPoolingLayer, PoolingType, Subsampling1DLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers.recurrent import (
    LSTM, BaseRecurrentLayer, Bidirectional, GravesBidirectionalLSTM,
    GravesLSTM, LastTimeStep, RnnLossLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.conf.layers.special import (
    FrozenLayer, VariationalAutoencoder, Yolo2OutputLayer)

__all__ = ["Layer", "BaseLayer", "FeedForwardLayer", "register_layer",
           "layer_from_dict", "LAYER_REGISTRY", "EmbeddingSequenceLayer",
           "SelfAttentionLayer", "TransformerEncoderLayer", "OutputLayer",
           "RnnOutputLayer", "DenseLayer", "ActivationLayer",
           "DropoutLayer", "ConvolutionLayer", "SubsamplingLayer",
           "GlobalPoolingLayer", "PoolingType", "BatchNormalization",
           "LossLayer", "BaseRecurrentLayer", "LSTM", "GravesLSTM",
           "GravesBidirectionalLSTM", "Bidirectional", "SimpleRnn",
           "LastTimeStep", "RnnLossLayer", "Convolution1DLayer",
           "Deconvolution2DLayer", "SeparableConvolution2DLayer",
           "DepthwiseConvolution2DLayer", "ZeroPaddingLayer",
           "ZeroPadding1DLayer", "UpsamplingLayer", "CroppingLayer",
           "SpaceToDepthLayer", "SpaceToBatchLayer", "Subsampling1DLayer",
           "LayerNormalization", "LocalResponseNormalization",
           "EmbeddingLayer", "RBM", "AutoEncoder", "RecursiveAutoEncoder",
           "CenterLossOutputLayer", "FrozenLayer", "VariationalAutoencoder",
           "Yolo2OutputLayer"]
