"""Attention layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/attention.py``): multi-head
self-attention on the flash-attention forward (``ops/attention.py``:
the CUDA kernel on the card, its plain version on the CPU) and the
pre-LN transformer block.

Ported so far: the full-sequence ``apply`` of both layers, for
inference and training (the attention is differentiable through the
backward kernels). The sequence-parallel branches and the streaming /
decode methods are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import (
    layer_norm)

__all__ = ["SelfAttentionLayer", "TransformerEncoderLayer"]


@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(BaseLayer):
    """Multi-head self-attention, (B, T, C) -> (B, T, n_out)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 4
    causal: bool = False
    qkv_bias: bool = False
    out_bias: bool = True

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out or input_type.size,
                                   input_type.timesteps)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by "
                             f"n_heads {self.n_heads}")
        d = self.n_out
        p = {
            "Wq": self._sample_w(generator, (self.n_in, d), self.n_in, d),
            "Wk": self._sample_w(generator, (self.n_in, d), self.n_in, d),
            "Wv": self._sample_w(generator, (self.n_in, d), self.n_in, d),
            "Wo": self._sample_w(generator, (d, d), d, d),
        }
        if self.out_bias:
            p["bo"] = torch.zeros(d)
        if self.qkv_bias:
            for name in ("bq", "bk", "bv"):
                p[name] = torch.zeros(d)
        return p, {}

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        """``mask``: optional (B, T) 0/1. Padded keys leave the softmax
        (the kernel's kv_mask); padded query rows are zeroed here, the
        caller's side of the masking contract."""
        from deeplearning4j_tpu_torch.ops.attention import flash_attention
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        B, T, _ = x.shape
        q, k, v = self._project_qkv(params, x)
        if mask is not None:
            out = flash_attention(q, k, v, causal=self.causal,
                                  kv_mask=mask)
            out = out * mask[:, :, None, None].to(out.dtype)
        else:
            out = flash_attention(q, k, v, causal=self.causal)
        proj = out.reshape(B, T, self.n_out) @ params["Wo"]
        if self.out_bias:
            proj = proj + params["bo"]
        return proj, state

    def _project_qkv(self, params, x):
        B, T, _ = x.shape
        H = self.n_heads
        Dh = self.n_out // H
        q = x @ params["Wq"]
        k = x @ params["Wk"]
        v = x @ params["Wv"]
        if self.qkv_bias:
            q = q + params["bq"]
            k = k + params["bk"]
            v = v + params["bv"]
        return (q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
                v.reshape(B, T, H, Dh))


@register_layer
@dataclasses.dataclass
class TransformerEncoderLayer(BaseLayer):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 4
    ffn_multiplier: int = 4
    causal: bool = False
    activation: str = "gelu"

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        if self.n_in != self.n_out:
            raise ValueError("TransformerEncoderLayer requires "
                             "n_in == n_out (residual)")
        d = self.n_out
        dff = d * self.ffn_multiplier
        attn_p, _ = self._ensure_attn().initialize(
            generator, InputType.recurrent(d))
        p = {
            "attn": attn_p,
            "ln1_g": torch.ones(d), "ln1_b": torch.zeros(d),
            "ln2_g": torch.ones(d), "ln2_b": torch.zeros(d),
            "W1": self._sample_w(generator, (d, dff), d, dff),
            "b1": torch.zeros(dff),
            "W2": self._sample_w(generator, (dff, d), dff, d),
            "b2": torch.zeros(d),
        }
        return p, {}

    def _ensure_attn(self) -> SelfAttentionLayer:
        if not hasattr(self, "_attn"):
            self._attn = SelfAttentionLayer(
                n_in=self.n_in, n_out=self.n_out, n_heads=self.n_heads,
                causal=self.causal, weight_init=self.weight_init)
        return self._attn

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        # the block drops nothing itself; its inner attention layer is
        # built without dropout (as in the JAX package)
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        a, _ = self._ensure_attn().apply(params["attn"], {}, h,
                                         training=training,
                                         generator=generator, mask=mask)
        x = x + a
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        act = self.activation_fn()
        return x + act(h @ params["W1"] + params["b1"]) @ params["W2"] \
            + params["b2"], state
