"""Keras 1.x legacy-config support (counterpart of
``deeplearning4j_tpu/keras/keras1.py``; numpy and json only).

The reference keeps one mapper codebase with per-version field tables
(deeplearning4j-modelimport config/Keras1LayerConfiguration.java vs
Keras2LayerConfiguration.java); here the Keras-1 table is applied as a
NORMALIZATION pass that rewrites a Keras-1 model_config into the
Keras-2 shape the mappers in importer.py consume:

- Sequential ``config`` is a bare list in Keras 1 → wrapped to
  ``{"layers": [...]}``.
- Field renames per layer class (output_dim→units, nb_filter→filters,
  nb_row/nb_col→kernel_size, subsample→strides, border_mode→padding,
  inner_activation→recurrent_activation, p→rate, dim_ordering→
  data_format, ...).
- Keras-1 LSTM stores 12 per-gate weight arrays (W_i,U_i,b_i, W_c,U_c,
  b_c, W_f,U_f,b_f, W_o,U_o,b_o) instead of Keras-2's packed 3; they
  are repacked into kernel/recurrent/bias in Keras-2 [i,f,c,o] gate
  order so the importer's gate permutation applies
  (importer._assign_weights).

``dim_ordering='th'`` (channels-first) is rejected with a clear error;
TensorFlow-ordering ('tf') Keras-1 files import exactly.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["is_keras1", "normalize_keras1_config",
           "repack_keras1_lstm_weights"]

# per-class rename tables (Keras1LayerConfiguration field names on the
# left, their Keras-2 spellings on the right)
_COMMON = {"init": "kernel_initializer",
           "W_regularizer": "kernel_regularizer",
           "b_regularizer": "bias_regularizer",
           "W_constraint": "kernel_constraint",
           "b_constraint": "bias_constraint",
           "bias": "use_bias"}

_RENAMES = {
    "Dense": {"output_dim": "units", **_COMMON},
    "Convolution2D": {"nb_filter": "filters", "subsample": "strides",
                      "border_mode": "padding",
                      "dim_ordering": "data_format", **_COMMON},
    "Convolution1D": {"nb_filter": "filters",
                      "filter_length": "kernel_size",
                      "subsample_length": "strides",
                      "border_mode": "padding", **_COMMON},
    "MaxPooling2D": {"border_mode": "padding",
                     "dim_ordering": "data_format"},
    "AveragePooling2D": {"border_mode": "padding",
                         "dim_ordering": "data_format"},
    "MaxPooling1D": {"border_mode": "padding",
                     "pool_length": "pool_size",
                     "stride": "strides"},
    "AveragePooling1D": {"border_mode": "padding",
                         "pool_length": "pool_size",
                         "stride": "strides"},
    "LSTM": {"output_dim": "units",
             "inner_activation": "recurrent_activation",
             "dropout_W": "dropout", "dropout_U": "recurrent_dropout",
             "inner_init": "recurrent_initializer", **_COMMON},
    "SimpleRNN": {"output_dim": "units",
                  "inner_init": "recurrent_initializer", **_COMMON},
    "Dropout": {"p": "rate"},
    "Embedding": {**_COMMON},
    "BatchNormalization": {"beta_init": "beta_initializer",
                           "gamma_init": "gamma_initializer"},
    "GlobalAveragePooling2D": {"dim_ordering": "data_format"},
    "GlobalMaxPooling2D": {"dim_ordering": "data_format"},
    "Flatten": {}, "Activation": {}, "ZeroPadding2D":
        {"dim_ordering": "data_format"},
}


def is_keras1(model_cfg: dict, keras_version: str) -> bool:
    # trust the keras_version attribute when the file carries one —
    # Keras 2.0-2.1 ALSO saved Sequential configs as bare lists, so the
    # structural hint alone would misroute early-Keras-2 files through
    # the Keras-1 rename pass
    v = str(keras_version)
    if v and v[0].isdigit():
        return v.startswith("1")
    # no/unparseable version attribute: fall back to the structural hint
    return (model_cfg.get("class_name") == "Sequential"
            and isinstance(model_cfg.get("config"), list))


def _normalize_layer(lc: dict) -> dict:
    from deeplearning4j_tpu_torch.keras.importer import KerasImportError
    cname = lc.get("class_name")
    cfg = dict(lc.get("config", {}))
    table = _RENAMES.get(cname, {})
    for old, new in table.items():
        if old in cfg and new not in cfg:
            cfg[new] = cfg.pop(old)
        else:
            cfg.pop(old, None)
    if cname == "Convolution2D":
        if "nb_row" in cfg or "nb_col" in cfg:
            cfg["kernel_size"] = [int(cfg.pop("nb_row")),
                                  int(cfg.pop("nb_col"))]
    if cfg.get("data_format") in ("th", "channels_first"):
        raise KerasImportError(
            f"{cname}: channels-first layout (Keras-1 "
            f"dim_ordering='th' / early-Keras-2 "
            f"data_format='channels_first') is not supported; re-save "
            f"the model with channels-last ('tf') ordering")
    if cfg.get("data_format") == "tf":
        cfg["data_format"] = "channels_last"
    out = dict(lc)
    out["config"] = cfg
    return out


def normalize_keras1_config(model_cfg: dict) -> dict:
    """Rewrite a Keras-1 model_config dict into Keras-2 shape."""
    out = dict(model_cfg)
    if model_cfg.get("class_name") == "Sequential":
        layers = model_cfg["config"]
        if isinstance(layers, dict):      # already keras-2 shaped
            layers = layers.get("layers", [])
        out["config"] = {"layers": [_normalize_layer(l)
                                    for l in layers]}
        return out
    if model_cfg.get("class_name") in ("Model", "Functional"):
        cfg = dict(model_cfg["config"])
        cfg["layers"] = [_normalize_layer(l)
                         for l in cfg.get("layers", [])]
        out["config"] = cfg
        return out
    return out


def repack_keras1_lstm_weights(arrays: List[np.ndarray]
                               ) -> List[np.ndarray]:
    """Keras-1 LSTM per-gate arrays → Keras-2 packed [i,f,c,o] order.

    Keras-1 ``get_weights()`` order is
    [W_i, U_i, b_i, W_c, U_c, b_c, W_f, U_f, b_f, W_o, U_o, b_o]
    (KerasLstm's Keras-1 branch in the reference handles the same
    layout)."""
    if len(arrays) != 12:
        return list(arrays)
    W_i, U_i, b_i, W_c, U_c, b_c, W_f, U_f, b_f, W_o, U_o, b_o = arrays
    kernel = np.concatenate([W_i, W_f, W_c, W_o], axis=1)
    recurrent = np.concatenate([U_i, U_f, U_c, U_o], axis=1)
    bias = np.concatenate([b_i, b_f, b_c, b_o], axis=0)
    return [kernel, recurrent, bias]
