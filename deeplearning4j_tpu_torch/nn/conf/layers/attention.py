"""Attention layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/attention.py``): multi-head
self-attention on the flash-attention forward (``ops/attention.py``:
the CUDA kernel on the card, its plain version on the CPU) and the
pre-LN transformer block.

Ported: the full-sequence ``apply`` of both layers, for inference and
training (the attention is differentiable through the backward
kernels), and the streaming / decode methods: the eager
``apply_stream`` (a cache grown by concatenation, for
``rnn_time_step``), the fixed-capacity ``zero_stream_cache`` /
``apply_stream_bounded`` and the paged ``zero_page_pool`` /
``apply_stream_paged``. Every decode method writes the new k/v into its
cache in place and attends through ``ops/decode_attention.py`` (the
paged decode kernel on the card): a dense cache is the paged call with
one page per row. Positions are host data, as in the sessions that own
them; the paged session uploads them once a step, inside its captured
graph, as a :class:`PagedIndex` that every layer reads. The projections
and the block's MLP run with TF32 off on the card
(``device.keep_float32``).

Under sequence parallelism (``parallel/seq_context.py``) ``apply``
attends over the whole sequence through the ring
(``parallel/ring_attention.ring_self_attention``: the same flash
kernels a chunk, the key-mask chunk rotating with its k/v), and zeroes
the padded query rows. Under tensor parallelism
(``parallel/tensor_parallel.py``) a rank holds the columns of Wq, Wk,
Wv (its H/tp heads) and W1 and the rows of Wo and W2: the input enters
through ``copy_to_model``, the row products are summed with
``reduce_from_model`` before their bias.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (BaseLayer,
                                                          register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers.normalization import (
    layer_norm)
from deeplearning4j_tpu_torch.parallel import seq_context, tensor_parallel

__all__ = ["SelfAttentionLayer", "TransformerEncoderLayer", "PagedIndex",
           "paged_index"]


def _tp_group():
    """The model group when this layer runs under the tensor-parallel
    head split, else None."""
    act = tensor_parallel.current_mode()
    if act is not None and act[0] == tensor_parallel.TPRule.ATTENTION:
        return act[1]
    return None


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to a card through pinned memory and
    without a sync, so a step's small index uploads do not stall it."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _row_table(n: int, device) -> torch.Tensor:
    """The page table of a dense cache: row b is page b."""
    return torch.arange(n, dtype=torch.int32, device=device)[:, None]


class PagedIndex(NamedTuple):
    """The indices of one paged decode step of t new tokens, computed
    once and shared by every attention layer of the step (the paged
    session builds it inside its captured graph, from its static
    buffers)."""

    pos: torch.Tensor       # (S,) int32 on the step's device
    host_pos: torch.Tensor  # (S,) int32 on the host: what checks read
    page: torch.Tensor      # (S, t) int64: the page each new token writes
    offset: torch.Tensor    # (S, t) int64: its row in that page


def paged_index(table: torch.Tensor, pos, t: int, page_size: int,
                host_pos=None) -> PagedIndex:
    """A :class:`PagedIndex` over ``table`` (S, P) on the step's device.
    ``pos``: host positions (uploaded here, once), or an int32 (S,)
    tensor on the table's device with ``host_pos``, its host copy. Token
    i of slot s goes to position ``pos[s] + i``: page ``table[s, p //
    page_size]``, row ``p % page_size``. No host sync."""
    from deeplearning4j_tpu_torch.ops.decode_attention import (
        host_positions)
    S = table.shape[0]
    if isinstance(pos, torch.Tensor) and pos.device.type != "cpu":
        if host_pos is None:
            raise ValueError("device positions need their host copy "
                             "(host_pos)")
        host = host_positions(host_pos, S)
    else:
        host = host_positions(pos, S)
        pos = _to_device(host, table.device)
    wpos = (pos.long()[:, None]
            + torch.arange(t, device=table.device)[None, :])      # (S, t)
    page = table.long().gather(
        1, torch.div(wpos, page_size, rounding_mode="floor"))
    return PagedIndex(pos, host, page, torch.remainder(wpos, page_size))


def _write_kv(cache, idx: PagedIndex, k, v) -> None:
    """Write the t new keys/values of every row s at positions
    ``pos[s] .. pos[s] + t - 1`` of its virtual cache (``idx.page``,
    ``idx.offset``), IN PLACE: the counterpart of the JAX session's
    donated buffers (``dynamic_update_slice`` / ``.at[page_ids,
    offs].set``), so a step moves O(t) cache bytes and never copies the
    cache. Rows written by several slots at once (inactive slots all on
    the scratch page) keep one of the writes, as in JAX."""
    cache["k"][idx.page, idx.offset] = k
    cache["v"][idx.page, idx.offset] = v


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
        grp = _tp_group()
        if grp is not None:
            # tensor parallelism: this rank's heads (Wq/Wk/Wv columns)
            x = tensor_parallel.copy_to_model(x, grp)
        q, k, v = self._project_qkv(params, x)
        ring = seq_context.current_seq_axis()
        if ring is not None:
            # sequence parallelism: x is this rank's time chunk; the
            # attention spans the whole sequence through the ring (the
            # key-mask chunk rotates with its k/v)
            from deeplearning4j_tpu_torch.parallel.ring_attention import (
                ring_self_attention)
            out = ring_self_attention(q, k, v, group=ring,
                                      causal=self.causal, kv_mask=mask)
            if mask is not None:
                out = out * mask[:, :, None, None].to(out.dtype)
        elif mask is not None:
            out = flash_attention(q, k, v, causal=self.causal,
                                  kv_mask=mask)
            out = out * mask[:, :, None, None].to(out.dtype)
        else:
            out = flash_attention(q, k, v, causal=self.causal)
        return self._out_proj(params, out, grp), state

    def _project_qkv(self, params, x):
        """The shared q/k/v projection and head split: one
        implementation for apply and every streaming method."""
        B, T, _ = x.shape
        Dh = self.n_out // self.n_heads
        H = params["Wq"].shape[1] // Dh      # H / tp under tensor parallel
        keep_float32(x)
        q = x @ params["Wq"]
        k = x @ params["Wk"]
        v = x @ params["Wv"]
        if self.qkv_bias:
            q = q + params["bq"]
            k = k + params["bk"]
            v = v + params["bv"]
        return (q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
                v.reshape(B, T, H, Dh))

    def _out_proj(self, params, out, grp=None):
        """The output projection; ``grp``: the model group whose head
        shards' partial products are summed (Wo by rows) before the
        bias."""
        B, T = out.shape[:2]
        proj = out.reshape(B, T, -1) @ params["Wo"]
        if grp is not None:
            proj = tensor_parallel.reduce_from_model(proj, grp)
        if self.out_bias:
            proj = proj + params["bo"]
        return proj

    def _require_causal(self, method: str) -> None:
        if not self.causal:
            raise ValueError(
                f"{method} requires causal=True: streaming non-causal "
                "attention would need future timesteps — use output() on "
                "the full sequence instead")

    # ---- stateful streaming inference (rnnTimeStep contract): the
    #      attention analog of a recurrent carry is the KV cache ----
    def apply_stream(self, params, cache, x):
        """Incremental decode: ``x`` is the NEW (B, t, C) chunk;
        ``cache`` holds the k/v history (None at sequence start).
        Returns (out, new_cache); feeding chunks sequentially equals one
        full-sequence causal forward. The eager path: the cache grows by
        concatenation, no static length."""
        self._require_causal("apply_stream")
        q, k, v = self._project_qkv(params, x)
        if cache is None:
            n_cached = 0
            k_full, v_full = k, v
        else:
            n_cached = cache["k"].shape[1]
            k_full = torch.cat([cache["k"], k], dim=1)
            v_full = torch.cat([cache["v"], v], dim=1)
        out = _stream_attention(q, k_full, v_full, n_cached)
        return self._out_proj(params, out), {"k": k_full, "v": v_full}

    def zero_stream_cache(self, batch: int, capacity: int, device="cpu"):
        """A fixed-capacity float32 {'k', 'v'} cache, (batch, capacity,
        H, Dh) each: two distinct buffers, written in place. On the card,
        at a head dim the decode kernel is not built for, each is the
        Dh-wide view
        of a buffer padded to the kernel's width
        (``ops.decode_attention.zero_kv_pool``), which the kernel reads in
        place."""
        from deeplearning4j_tpu_torch.ops.decode_attention import (
            zero_kv_pool)
        H = self.n_heads
        Dh = self.n_out // H
        return {"k": zero_kv_pool(batch, capacity, H, Dh, device),
                "v": zero_kv_pool(batch, capacity, H, Dh, device)}

    def apply_stream_bounded(self, params, cache, x, pos):
        """One decode step over a fixed-capacity cache: ``x`` is the new
        (B, t, C) chunk, ``cache`` a {'k', 'v'} of (B, CAP, H, Dh),
        ``pos`` the count of valid cached tokens (an int, or one per row:
        the slot session's per-slot positions), host data. Writes the
        chunk at [pos, pos + t) in place and attends the new queries over
        the cache: query i (global pos + i) sees keys k_pos <= pos + i,
        which hides unwritten and stale positions and in-chunk future
        tokens. Returns (out, cache); the caller advances pos and keeps
        pos + t <= CAP."""
        self._require_causal("apply_stream_bounded")
        table = _row_table(x.shape[0], x.device)
        return self.apply_stream_paged(params, cache, table, pos, x)

    # ---- paged (block) KV cache: one physical pool of fixed-size pages
    #      per layer; each slot sees a VIRTUAL contiguous cache through
    #      its page table (models/paged_kv.py) ----
    def zero_page_pool(self, n_pages: int, page_size: int, device="cpu"):
        """Physical page pool for this layer: ``zero_stream_cache`` with
        (batch, capacity) = (n_pages, page_size); a page IS a
        page_size-token cache row."""
        return self.zero_stream_cache(n_pages, page_size, device)

    def apply_stream_paged(self, params, pool, table, pos, x):
        """One decode step over paged caches for ALL slots at once.
        ``x`` is the new (S, t, C) chunk (one row per slot), ``pool``
        the physical {'k', 'v'} pages of (n_pages, page_size, H, Dh),
        ``table`` the (S, P) per-slot page table (a tensor on x's
        device), ``pos`` the (S,) per-slot positions: host data, or the
        step's :class:`PagedIndex`, computed once for every layer (the
        paged session's step). Writes each slot's new k/v at its (page,
        offset) in place (written pages are slot-exclusive; shared
        prefix pages are read-only and diverge by copy-on-write at
        admission, host-side), then attends each slot's queries over its
        virtual cache of P * page_size positions. Returns (out, pool)."""
        self._require_causal("apply_stream_paged")
        from deeplearning4j_tpu_torch.ops.decode_attention import (
            decode_attention)
        q, k, v = self._project_qkv(params, x)
        idx = pos if isinstance(pos, PagedIndex) else paged_index(
            table, pos, x.shape[1], pool["k"].shape[1])
        _write_kv(pool, idx, k, v)
        out = decode_attention(q, pool["k"], pool["v"], table, idx.pos,
                               host_pos=idx.host_pos)
        return self._out_proj(params, out), pool


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
        return x + self._mlp_half(params, x), state

    def _mlp_half(self, params, x):
        """Pre-LN MLP residual branch, shared by apply and every
        streaming method (per token, so streaming needs no carry)."""
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        keep_float32(h)
        act = self.activation_fn()
        grp = _tp_group()
        if grp is None:
            return act(h @ params["W1"] + params["b1"]) @ params["W2"] \
                + params["b2"]
        # tensor parallelism: W1 by columns, W2 by rows
        h = tensor_parallel.copy_to_model(h, grp)
        y = act(h @ params["W1"] + params["b1"]) @ params["W2"]
        return tensor_parallel.reduce_from_model(y, grp) + params["b2"]

    def _stream_block(self, params, x, attend):
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        a, carry = attend(self._ensure_attn(), params["attn"], h)
        x = x + a
        return x + self._mlp_half(params, x), carry

    def apply_stream(self, params, cache, x):
        """Incremental decode through the block: the inner attention
        carries the KV cache (see SelfAttentionLayer.apply_stream)."""
        return self._stream_block(
            params, x, lambda attn, p, h: attn.apply_stream(p, cache, h))

    def zero_stream_cache(self, batch: int, capacity: int, device="cpu"):
        return self._ensure_attn().zero_stream_cache(batch, capacity,
                                                     device)

    def apply_stream_bounded(self, params, cache, x, pos):
        """Bounded-cache decode step through the block (see
        SelfAttentionLayer.apply_stream_bounded)."""
        return self._stream_block(
            params, x,
            lambda attn, p, h: attn.apply_stream_bounded(p, cache, h, pos))

    def zero_page_pool(self, n_pages: int, page_size: int, device="cpu"):
        return self._ensure_attn().zero_page_pool(n_pages, page_size,
                                                  device)

    def apply_stream_paged(self, params, pool, table, pos, x):
        """Paged-cache decode step through the block (see
        SelfAttentionLayer.apply_stream_paged)."""
        return self._stream_block(
            params, x,
            lambda attn, p, h: attn.apply_stream_paged(p, pool, table, pos,
                                                       h))


def _stream_attention(q, k_full, v_full, n_cached: int):
    """Attention of the NEW chunk's queries over the full cached + new
    history, causal within the chunk: new position i (global n_cached +
    i) sees keys [0, n_cached + i]. The history is a dense cache: one
    page per row, so it goes through the same decode attention."""
    from deeplearning4j_tpu_torch.ops.decode_attention import (
        decode_attention)
    return decode_attention(q, k_full, v_full,
                            _row_table(q.shape[0], q.device), n_cached)
