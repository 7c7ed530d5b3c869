"""Keras HDF5 model import (counterpart of
``deeplearning4j_tpu/keras/importer.py``).

Mirrors deeplearning4j-modelimport (KerasModelImport.java:50,74,103;
KerasModel.java; KerasLayer.java; layers/** 30 adapter classes;
Hdf5Archive.java native HDF5 binding — here h5py): parse the
``model_config`` JSON from a ``.h5`` file, map each Keras layer to a
framework layer config, build a MultiLayerConfiguration (Sequential) or
ComputationGraphConfiguration (Functional), then copy weights
dataset-by-dataset.

Version handling mirrors Keras1LayerConfiguration/Keras2...: field
names that moved across Keras versions are resolved by `_get` fallback
chains; both Keras 2 ``inbound_nodes`` list format and Keras 3
``__keras_tensor__``/keras_history format are parsed.

Layout notes (why import is exact, not approximate): Keras
channels_last == our NHWC; Keras Conv2D kernels are HWIO == ours;
Dense kernels (in,out) == ours. The permutations are the LSTM gate
order (Keras packs [i, f, c, o], we pack [i, f, o, g=c],
nn/conf/layers/recurrent.py) and reshapes: Conv1D (k, in, out) ->
(k, 1, in, out), depthwise (kh, kw, in, mult) -> (kh, kw, 1, in*mult),
MultiHeadAttention (d, H, kd) -> (d, d).

The network is built on ``device`` (default the card) and each array
becomes a tensor in the policy's ``param_dtype`` there (batch-norm
statistics in float32). ``h5py`` is imported only to open a file: the
builders read any object with the h5 file's layout (``attrs
["model_config"]``; ``["model_weights"][layer]`` with ``attrs
["weight_names"]`` and its datasets), so a config and arrays held in
memory import without it.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["KerasImportError", "import_keras_model_and_weights",
           "import_keras_sequential_model"]


class KerasImportError(Exception):
    pass


_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "softplus": "softplus", "softsign": "softsign", "elu": "elu",
    "selu": "selu", "gelu": "gelu", "swish": "swish", "silu": "swish",
    "hard_sigmoid": "hardsigmoid", "leaky_relu": "leakyrelu",
    "exponential": "identity",
}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if name not in _ACTIVATIONS:
        raise KerasImportError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATIONS[name]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _pad_mode(cfg) -> str:
    p = cfg.get("padding", "valid")
    if p == "same":
        return "same"
    if p == "valid":
        return "truncate"
    raise KerasImportError(f"Unsupported Keras padding '{p}'")


# ---------------------------------------------------------------------------
# per-layer mappers: keras config -> (our layer | 'skip' | input-type info)
# ---------------------------------------------------------------------------

def _map_dense(cfg, *, is_output=False, sequence_input=False):
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, OutputLayer,
                                                   RnnOutputLayer)
    act = _act(cfg.get("activation"))
    kw = dict(n_out=int(cfg["units"]), activation=act,
              has_bias=bool(cfg.get("use_bias", True)),
              name=cfg.get("name"))
    if is_output:
        loss = "mcxent" if act == "softmax" else (
            "xent" if act == "sigmoid" else "mse")
        cls = RnnOutputLayer if sequence_input else OutputLayer
        return cls(loss=loss, **kw)
    return DenseLayer(**kw)


def _map_conv2d(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer
    return ConvolutionLayer(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        dilation=_pair(cfg.get("dilation_rate", 1)),
        convolution_mode=_pad_mode(cfg),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))


def _map_conv1d(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import Convolution1DLayer
    k = cfg["kernel_size"]
    k = k[0] if isinstance(k, (list, tuple)) else k
    s = cfg.get("strides", 1)
    s = s[0] if isinstance(s, (list, tuple)) else s
    return Convolution1DLayer(
        n_out=int(cfg["filters"]), kernel=(int(k), 1),
        stride=(int(s), 1), convolution_mode=_pad_mode(cfg),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))


def _map_depthwise(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        DepthwiseConvolution2DLayer)
    return DepthwiseConvolution2DLayer(
        kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        convolution_mode=_pad_mode(cfg),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))


def _map_separable(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        SeparableConvolution2DLayer)
    return SeparableConvolution2DLayer(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        convolution_mode=_pad_mode(cfg),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), name=cfg.get("name"))


def _map_pool2d(cfg, pooling):
    from deeplearning4j_tpu_torch.nn.conf.layers import SubsamplingLayer
    return SubsamplingLayer(
        pooling=pooling, kernel=_pair(cfg.get("pool_size", 2)),
        stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
        convolution_mode=_pad_mode(cfg), name=cfg.get("name"))


def _map_pool1d(cfg, pooling):
    from deeplearning4j_tpu_torch.nn.conf.layers import Subsampling1DLayer
    k = cfg.get("pool_size", 2)
    k = k[0] if isinstance(k, (list, tuple)) else k
    s = cfg.get("strides") or k
    s = s[0] if isinstance(s, (list, tuple)) else s
    return Subsampling1DLayer(pooling=pooling, kernel=(int(k), 1),
                              stride=(int(s), 1),
                              convolution_mode=_pad_mode(cfg),
                              name=cfg.get("name"))


def _map_global_pool(cfg, pooling):
    from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer
    return GlobalPoolingLayer(pooling=pooling, name=cfg.get("name"))


def _map_batchnorm(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    # always import with learnable gamma/beta params; scale=False /
    # center=False become fixed 1/0 values at weight-assignment time
    # (our layer has no separate use_gamma/use_beta switches)
    return BatchNormalization(
        eps=float(cfg.get("epsilon", 1e-3)),
        decay=float(cfg.get("momentum", 0.99)),
        lock_gamma_beta=False,
        name=cfg.get("name"))


def _map_activation(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer
    return ActivationLayer(activation=_act(cfg.get("activation")),
                           name=cfg.get("name"))


def _map_dropout(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import DropoutLayer
    return DropoutLayer(dropout=float(cfg.get("rate", 0.5)),
                        name=cfg.get("name"))


def _map_lstm(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import LSTM, LastTimeStep
    lstm = LSTM(n_out=int(cfg["units"]),
                activation=_act(cfg.get("activation", "tanh")),
                gate_activation=_act(
                    cfg.get("recurrent_activation", "sigmoid")),
                name=cfg.get("name"))
    if not cfg.get("return_sequences", False):
        # Keras return_sequences=False → only the last timestep
        return LastTimeStep(underlying=lstm)
    return lstm


def _map_embedding(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import EmbeddingSequenceLayer
    return EmbeddingSequenceLayer(n_in=int(cfg["input_dim"]),
                                  n_out=int(cfg["output_dim"]),
                                  has_bias=False, name=cfg.get("name"))


def _map_zeropad2d(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import ZeroPaddingLayer
    p = cfg.get("padding", 1)
    return ZeroPaddingLayer(pad=tuple(tuple(int(x) for x in e)
                                      for e in p)
                            if isinstance(p, (list, tuple)) and
                            isinstance(p[0], (list, tuple))
                            else p, name=cfg.get("name"))


def _map_upsampling(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import UpsamplingLayer
    return UpsamplingLayer(size=_pair(cfg.get("size", 2)),
                           name=cfg.get("name"))


_SKIP = ("InputLayer", "Flatten", "Reshape")   # structural; handled by
                                               # auto-preprocessors


def _map_layernorm(cfg):
    from deeplearning4j_tpu_torch.nn.conf.layers import LayerNormalization
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)) and len(axis) == 1:
        axis = axis[0]
    if axis != -1:
        raise KerasImportError(
            f"LayerNormalization axis={cfg.get('axis')} unsupported "
            "(last-axis only)")
    if cfg.get("rms_scaling"):
        raise KerasImportError(
            "LayerNormalization rms_scaling=True unsupported (RMS "
            "norm skips the mean subtraction this layer performs)")
    return LayerNormalization(name=cfg.get("name"),
                              eps=float(cfg.get("epsilon", 1e-3)))


def _map_mha(cfg):
    """Keras MultiHeadAttention → SelfAttentionLayer. Exact for the
    standard transformer configuration: SELF-attention (the functional
    importer verifies query/key/value come from one tensor) with
    num_heads * key_dim == model dim (our internal dim and output dim
    coincide; Keras's defaults give exactly that in encoder blocks).
    Cross-attention, value_dim != key_dim, output_shape overrides, and
    non-time attention_axes are rejected loudly."""
    from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
    H = int(cfg["num_heads"])
    key_dim = int(cfg["key_dim"])
    value_dim = cfg.get("value_dim")
    if value_dim is not None and int(value_dim) != key_dim:
        raise KerasImportError(
            f"MultiHeadAttention value_dim={value_dim} != key_dim="
            f"{key_dim} unsupported")
    if cfg.get("output_shape") is not None:
        raise KerasImportError(
            "MultiHeadAttention output_shape overrides unsupported")
    ax = cfg.get("attention_axes")
    if ax not in (None, [1], (1,), 1):
        raise KerasImportError(
            f"MultiHeadAttention attention_axes={ax} unsupported "
            "(time-axis attention only)")
    if cfg.get("dropout"):
        logger.warning(
            "MultiHeadAttention '%s': attention-probability dropout "
            "%.3g is not modeled (inference identical; training "
            "differs)", cfg.get("name"), cfg.get("dropout"))
    use_bias = bool(cfg.get("use_bias", True))
    return SelfAttentionLayer(
        n_out=H * key_dim, n_heads=H,
        qkv_bias=use_bias, out_bias=use_bias,
        name=cfg.get("name"))


def map_keras_layer(class_name: str, cfg: dict, *, is_output=False,
                    sequence_input=False):
    """Returns a layer config, or None for structural layers."""
    if class_name in _SKIP:
        return None
    if class_name == "Dense":
        return _map_dense(cfg, is_output=is_output,
                          sequence_input=sequence_input)
    if class_name in ("Conv2D", "Convolution2D"):
        return _map_conv2d(cfg)
    if class_name in ("Conv1D", "Convolution1D"):
        return _map_conv1d(cfg)
    if class_name == "DepthwiseConv2D":
        return _map_depthwise(cfg)
    if class_name == "SeparableConv2D":
        return _map_separable(cfg)
    if class_name == "MaxPooling2D":
        return _map_pool2d(cfg, "max")
    if class_name in ("AveragePooling2D", "AvgPool2D"):
        return _map_pool2d(cfg, "avg")
    if class_name == "MaxPooling1D":
        return _map_pool1d(cfg, "max")
    if class_name == "AveragePooling1D":
        return _map_pool1d(cfg, "avg")
    if class_name == "GlobalAveragePooling2D":
        return _map_global_pool(cfg, "avg")
    if class_name == "GlobalMaxPooling2D":
        return _map_global_pool(cfg, "max")
    if class_name == "GlobalAveragePooling1D":
        return _map_global_pool(cfg, "avg")
    if class_name == "GlobalMaxPooling1D":
        return _map_global_pool(cfg, "max")
    if class_name == "BatchNormalization":
        return _map_batchnorm(cfg)
    if class_name == "LayerNormalization":
        return _map_layernorm(cfg)
    if class_name == "MultiHeadAttention":
        return _map_mha(cfg)
    if class_name == "Activation":
        return _map_activation(cfg)
    if class_name in ("Dropout", "SpatialDropout2D", "SpatialDropout1D"):
        return _map_dropout(cfg)
    if class_name == "LSTM":
        return _map_lstm(cfg)
    if class_name == "Embedding":
        return _map_embedding(cfg)
    if class_name == "ZeroPadding2D":
        return _map_zeropad2d(cfg)
    if class_name == "UpSampling2D":
        return _map_upsampling(cfg)
    raise KerasImportError(f"Unsupported Keras layer '{class_name}'")


# ---------------------------------------------------------------------------
# input type from InputLayer / batch_shape
# ---------------------------------------------------------------------------

def _input_type_from_shape(shape):
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        return InputType.convolutional(dims[0], dims[1], dims[2])
    raise KerasImportError(f"Unsupported input shape {shape}")


def _layer_input_shape(cfg):
    for key in ("batch_shape", "batch_input_shape"):
        if cfg.get(key):
            return cfg[key]
    return None


# ---------------------------------------------------------------------------
# weight copying
# ---------------------------------------------------------------------------

def _weight_arrays(h5file, layer_name: str) -> List[np.ndarray]:
    """All weight arrays for a keras layer, in weight_names order."""
    mw = h5file["model_weights"]
    if layer_name not in mw:
        return []
    grp = mw[layer_name]
    names = [n.decode() if isinstance(n, bytes) else n
             for n in grp.attrs.get("weight_names", [])]
    if names:
        return [np.asarray(grp[n]) for n in names]

    # count datasets (weightless layers have an empty group — fine)
    import h5py
    n_datasets = 0

    def count(g):
        nonlocal n_datasets
        for k in g:
            if isinstance(g[k], h5py.Group):
                count(g[k])
            else:
                n_datasets += 1
    count(grp)
    if n_datasets == 0:
        return []
    # Datasets but no weight_names: h5py iterates ALPHABETICALLY, which
    # would silently reorder e.g. [bias, kernel] or swap same-shaped
    # gamma/beta — refuse rather than corrupt.
    raise KerasImportError(
        f"Layer '{layer_name}' has {n_datasets} weight datasets but no "
        f"weight_names attribute; cannot determine weight order safely")


def _lstm_gate_permute(w: np.ndarray, units: int) -> np.ndarray:
    """Keras gate packing [i, f, c, o] → ours [i, f, o, g=c]."""
    i, f, c, o = (w[..., 0:units], w[..., units:2 * units],
                  w[..., 2 * units:3 * units], w[..., 3 * units:4 * units])
    return np.concatenate([i, f, o, c], axis=-1)


def _assign_weights(layer, params: dict, state: dict,
                    arrays: List[np.ndarray], class_name: str,
                    kcfg: Optional[dict] = None):
    """Replace entries of one layer's ``params`` and ``state`` dicts by
    the Keras arrays, as tensors on the entries' device; the caller
    hands ``params`` back to the network (``set_params``)."""
    import torch

    from deeplearning4j_tpu_torch import dtypes

    pd = dtypes.policy().param_dtype

    def put(target, key, arr, dtype=None):
        expect = target[key].shape
        if tuple(arr.shape) != tuple(expect):
            raise KerasImportError(
                f"{class_name} weight '{key}': shape {arr.shape} != "
                f"expected {tuple(expect)}")
        target[key] = torch.as_tensor(np.asarray(arr), dtype=dtype or pd,
                                      device=target[key].device)

    if class_name in ("Dense", "Conv2D", "Convolution2D", "Conv1D",
                      "Convolution1D", "DepthwiseConv2D"):
        arrs = list(arrays)
        if class_name in ("Conv1D", "Convolution1D"):
            arrs[0] = arrs[0][:, None, :, :]     # (k,in,out)→(k,1,in,out)
        elif class_name == "DepthwiseConv2D":
            # keras (kh,kw,in,mult) → ours (kh,kw,1,in*mult); C-order
            # reshape preserves the in-major output-channel ordering
            kh, kw, cin, mult = arrs[0].shape
            arrs[0] = arrs[0].reshape(kh, kw, 1, cin * mult)
        put(params, "W", arrs[0])
        if len(arrs) > 1 and "b" in params:
            put(params, "b", arrs[1])
    elif class_name == "SeparableConv2D":
        put(params, "dW", arrays[0].reshape(params["dW"].shape))
        put(params, "pW", arrays[1])
        if len(arrays) > 2 and "b" in params:
            put(params, "b", arrays[2])
    elif class_name == "BatchNormalization":
        # keras order: [gamma if scale][beta if center][mean, variance]
        arrs = list(arrays)
        kcfg = kcfg or {}
        scale = bool(kcfg.get("scale", True))
        center = bool(kcfg.get("center", True))
        expected = int(scale) + int(center) + 2
        if len(arrs) != expected:
            raise KerasImportError(
                f"BatchNormalization: {len(arrs)} weight arrays but "
                f"scale={scale}, center={center} implies {expected}")
        if scale:
            put(params, "gamma", arrs.pop(0))
        else:
            params["gamma"] = torch.ones_like(params["gamma"])
        if center:
            put(params, "beta", arrs.pop(0))
        else:
            params["beta"] = torch.zeros_like(params["beta"])
        put(state, "mean", arrs.pop(0), torch.float32)
        put(state, "var", arrs.pop(0), torch.float32)
    elif class_name == "LSTM":
        if len(arrays) == 12:    # Keras-1 per-gate layout
            from deeplearning4j_tpu_torch.keras.keras1 import (
                repack_keras1_lstm_weights)
            arrays = repack_keras1_lstm_weights(arrays)
        units = params["b"].shape[0] // 4
        put(params, "Wx", _lstm_gate_permute(arrays[0], units))
        put(params, "Wh", _lstm_gate_permute(arrays[1], units))
        put(params, "b", _lstm_gate_permute(arrays[2], units))
    elif class_name == "Embedding":
        put(params, "W", arrays[0])
    elif class_name == "MultiHeadAttention":
        # weight_names order: q/k/v kernel[,bias] each, then
        # attention_output kernel[,bias]. Kernels are (d_in, H, kd) /
        # (H, kd, d_out); head-major reshape matches our column-block
        # head split exactly.
        use_bias = bool((kcfg or {}).get("use_bias", True))
        arrs = list(arrays)
        d = params["Wo"].shape[0]
        din = arrs[0].shape[0]
        if arrs[0].shape[1] * arrs[0].shape[2] != d or din != d:
            raise KerasImportError(
                f"MultiHeadAttention: num_heads*key_dim="
                f"{arrs[0].shape[1] * arrs[0].shape[2]} must equal "
                f"the model dim {din} (Keras's internal dim != "
                f"output dim is unsupported)")

        def take():
            k = arrs.pop(0).reshape(din, d)
            b = arrs.pop(0).reshape(d) if use_bias else None
            return k, b

        for wname, bname in (("Wq", "bq"), ("Wk", "bk"), ("Wv", "bv")):
            kmat, bvec = take()
            put(params, wname, kmat)
            if bvec is not None:
                put(params, bname, bvec)
        put(params, "Wo", arrs.pop(0).reshape(d, d))
        if use_bias:
            put(params, "bo", arrs.pop(0))
    elif class_name == "LayerNormalization":
        # keras order: [gamma if scale][beta if center]
        arrs = list(arrays)
        kcfg = kcfg or {}
        if bool(kcfg.get("scale", True)) and arrs:
            put(params, "gamma", arrs.pop(0))
        if bool(kcfg.get("center", True)) and arrs:
            put(params, "beta", arrs.pop(0))
    elif arrays:
        raise KerasImportError(
            f"Don't know how to assign weights for '{class_name}'")


# ---------------------------------------------------------------------------
# model-level import
# ---------------------------------------------------------------------------

def _parse_inbound(nodes) -> List[str]:
    """Both Keras 2 ([[['name',0,0,{}], ...]]) and Keras 3
    (__keras_tensor__/keras_history) formats."""
    out: List[str] = []
    if not nodes:
        return out

    def from_hist(obj):
        if isinstance(obj, dict):
            if "keras_history" in obj.get("config", {}):
                out.append(obj["config"]["keras_history"][0])
            else:
                for v in obj.get("args", []) + list(
                        obj.get("kwargs", {}).values()):
                    from_hist(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                from_hist(v)

    first = nodes[0]
    if isinstance(first, dict):
        for node in nodes:
            from_hist(node)
    else:   # keras 2: nodes = [[[name, idx, tensor_idx, kwargs], ...]]
        for node in nodes:
            for ref in node:
                out.append(ref[0])
    return out


def _call_kwargs(nodes) -> dict:
    """Non-tensor CALL-time kwargs of a layer's (single) inbound node —
    e.g. MultiHeadAttention's use_causal_mask. Tensor-valued kwargs
    stay in _parse_inbound's tensor list; this collects the flags."""
    out: dict = {}
    if not nodes:
        return out

    def is_tensor(v):
        return isinstance(v, dict) and "keras_history" in v.get(
            "config", {})

    first = nodes[0]
    if isinstance(first, dict):            # keras 3
        for node in nodes:
            for k, v in node.get("kwargs", {}).items():
                if not is_tensor(v):
                    out[k] = v
    else:                                  # keras 2
        for node in nodes:
            for ref in node:
                if len(ref) > 3 and isinstance(ref[3], dict):
                    for k, v in ref[3].items():
                        if not is_tensor(v):
                            out[k] = v
    return out


def _parse_io_refs(refs) -> List[str]:
    """output_layers/input_layers: keras 3 single = ['name',0,0];
    keras 2 / multi = [['name',0,0], ...]."""
    if not refs:
        return []
    if isinstance(refs, list) and len(refs) == 3 \
            and isinstance(refs[0], str) and isinstance(refs[1], int):
        return [refs[0]]
    out = []
    for r in refs:
        out.append(r[0] if isinstance(r, list) else r)
    return out


def import_keras_sequential_model(path: str, *, enforce_training=False,
                                  device="cuda"):
    return import_keras_model_and_weights(path, device=device)


def import_keras_model_and_weights(path: str, *, device="cuda"):
    """Entry point (KerasModelImport.java:103). Returns
    MultiLayerNetwork (Sequential) or ComputationGraph (Functional) on
    ``device``."""
    import h5py

    with h5py.File(path, "r") as f:
        if "model_config" not in f.attrs:
            raise KerasImportError(
                f"{path}: no model_config attribute (weights-only file?)")
        raw = f.attrs["model_config"]
        if isinstance(raw, bytes):
            raw = raw.decode()
        model_cfg = json.loads(raw)
        keras_version = f.attrs.get("keras_version", b"unknown")
        if isinstance(keras_version, bytes):
            keras_version = keras_version.decode()
        logger.info("importing keras %s model (%s)",
                    model_cfg["class_name"], keras_version)
        from deeplearning4j_tpu_torch.keras.keras1 import (
            is_keras1, normalize_keras1_config)
        if is_keras1(model_cfg, keras_version):
            logger.info("normalizing Keras-1 legacy config fields")
            model_cfg = normalize_keras1_config(model_cfg)
        if model_cfg["class_name"] == "Sequential":
            return _import_sequential(model_cfg, f, device=device)
        if model_cfg["class_name"] in ("Functional", "Model"):
            return _import_functional(model_cfg, f, device=device)
        raise KerasImportError(
            f"Unsupported model class '{model_cfg['class_name']}'")


def _import_sequential(model_cfg, f, *, device="cuda"):
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
    layers_cfg = model_cfg["config"]["layers"]
    input_type = None
    mapped: List[Tuple[str, str, Optional[object]]] = []
    seq_mode = False     # activations currently (B,T,C)?
    for i, lc in enumerate(layers_cfg):
        cname, cfg = lc["class_name"], lc["config"]
        shape = _layer_input_shape(cfg)
        if shape is not None and input_type is None:
            input_type = _input_type_from_shape(shape)
            seq_mode = input_type.kind == "rnn"
        if cname == "InputLayer":
            continue
        is_output = (i == len(layers_cfg) - 1 and cname == "Dense")
        layer = map_keras_layer(cname, cfg, is_output=is_output,
                                sequence_input=seq_mode)
        # track whether activations remain sequence-shaped
        if cname in ("LSTM",):
            seq_mode = bool(cfg.get("return_sequences", False))
        elif cname == "Embedding":
            seq_mode = True
        elif cname in ("Flatten", "GlobalAveragePooling1D",
                       "GlobalMaxPooling1D", "GlobalAveragePooling2D",
                       "GlobalMaxPooling2D"):
            seq_mode = False
        if layer is not None:
            mapped.append((cfg.get("name", cname), cname, layer, cfg))
    if input_type is None:
        raise KerasImportError("Could not determine model input shape")

    b = NeuralNetConfiguration.builder().list()
    for _, _, layer, _ in mapped:
        b = b.layer(layer)
    conf = b.set_input_type(input_type).build()
    net = MultiLayerNetwork(conf, device=device).init()

    params = net.params
    for idx, (kname, cname, _, kcfg) in enumerate(mapped):
        arrays = _weight_arrays(f, kname)
        if arrays:
            _assign_weights(net.layers[idx], params[idx],
                            net.state[idx], arrays, cname, kcfg)
    net.set_params(params)
    return net


_MERGE_VERTICES = {"Add": ("ElementWiseVertex", "add"),
                   "Subtract": ("ElementWiseVertex", "subtract"),
                   "Multiply": ("ElementWiseVertex", "product"),
                   "Average": ("ElementWiseVertex", "average"),
                   "Maximum": ("ElementWiseVertex", "max"),
                   "Concatenate": ("MergeVertex", None)}


def _import_functional(model_cfg, f, *, device="cuda"):
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.nn.conf.builder import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex,
                                                  MergeVertex)

    cfg = model_cfg["config"]
    layers_cfg = cfg["layers"]
    output_refs = _parse_io_refs(cfg.get("output_layers"))
    if not output_refs:
        raise KerasImportError("Functional model lists no outputs")

    # pass 1: map layers, record input layers and structural aliases
    input_names: List[str] = []
    input_types = []
    weight_map: Dict[str, Tuple[str, object]] = {}
    alias: Dict[str, str] = {}     # structural (Flatten/Reshape) skip-through
    plan = []                      # (name, vertex_or_layer, inbound)
    for lc in layers_cfg:
        cname = lc["class_name"]
        lcfg = lc["config"]
        name = lc.get("name", lcfg.get("name"))
        inbound = [alias.get(n, n) for n in
                   _parse_inbound(lc.get("inbound_nodes"))]
        if cname == "InputLayer":
            input_names.append(name)
            input_types.append(
                _input_type_from_shape(_layer_input_shape(lcfg)))
            continue
        if cname in _MERGE_VERTICES:
            vkind, op = _MERGE_VERTICES[cname]
            vert = (ElementWiseVertex(op=op)
                    if vkind == "ElementWiseVertex" else MergeVertex())
            plan.append((name, vert, inbound, True))
            continue
        if cname == "MultiHeadAttention":
            # self-attention only: query/value(/key) must PROVABLY be
            # one tensor — the call serializes >= 2 tensor args, so a
            # single surfaced tensor means the rest hid somewhere we
            # did not parse (reject rather than guess)
            if len(inbound) < 2 or len(set(inbound)) != 1:
                raise KerasImportError(
                    f"MultiHeadAttention '{name}' attends across "
                    f"different tensors ({inbound}) — cross-attention "
                    "import is unsupported (self-attention only)")
            ckw = _call_kwargs(lc.get("inbound_nodes"))
            unsupported = {k: v for k, v in ckw.items()
                           if k not in ("use_causal_mask",) and v}
            if unsupported:
                raise KerasImportError(
                    f"MultiHeadAttention '{name}' call kwargs "
                    f"{sorted(unsupported)} unsupported (an "
                    "attention_mask tensor has no import analog)")
            inbound = inbound[:1]
            mha_causal = bool(ckw.get("use_causal_mask", False))
        else:
            mha_causal = False
        layer = map_keras_layer(
            cname, lcfg,
            is_output=(name in output_refs and cname == "Dense"))
        if layer is None:
            alias[name] = inbound[0]
            continue
        if mha_causal:
            layer.causal = True        # call-time use_causal_mask
        plan.append((name, layer, inbound, False))
        weight_map[name] = (cname, lcfg)

    # pass 2: build the graph config
    gb = NeuralNetConfiguration.builder().graph_builder()
    gb.add_inputs(*input_names)
    gb.set_input_types(*input_types)
    for name, obj, inbound, is_vertex in plan:
        if is_vertex:
            gb.add_vertex(name, obj, *inbound)
        else:
            gb.add_layer(name, obj, *inbound)
    gb.set_outputs(*[alias.get(o, o) for o in output_refs])
    cg = ComputationGraph(gb.build(), device=device).init()

    params = cg.params
    for name, (cname, kcfg) in weight_map.items():
        arrays = _weight_arrays(f, name)
        if arrays:
            obj, _ = cg.conf.vertices[name]
            _assign_weights(obj, params[name], cg.state[name],
                            arrays, cname, kcfg)
    cg.set_params(params)
    return cg
