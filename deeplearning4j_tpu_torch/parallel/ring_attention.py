"""Ring attention: sequence parallelism over a ring of ranks
(counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py``).

Rank i of a seq ring of n holds the LOCAL (B, T/n, H, D) chunk i of q,
k and v. Each of n steps computes its q chunk against the k/v chunk it
holds, then k, v (and the key-mask chunk) rotate one rank on; per-chunk
(o, lse) pairs merge exactly by their logsumexp weights
(:func:`_merge_chunks`), so the result is exact attention over the
whole sequence at O(T/n) memory a rank.

Each chunk runs the flash-attention kernels of ``ops/attention.py``
(the CUDA kernels on a card, their plain versions on the CPU), forward
AND backward: :func:`ring_self_attention` is an autograd Function whose
backward ring calls ``flash_attention_bwd`` (the dq and dk/dv kernels)
on every chunk with the GLOBAL o and lse, so p = exp(s - lse) is the
global softmax weight and delta = rowsum(do * o) the global one; the
dk/dv accumulators rotate with their k/v chunks and arrive home after
the full cycle. Under a causal mask a chunk from a later rank is
skipped (no launch), the diagonal chunk runs the kernel's causal mask,
an earlier chunk runs unmasked.

Sentinels: a skipped chunk carries lse = -inf (the JAX ring's), a row
that saw no live key in a chunk gets the kernel's lse = -1e30 and o =
0; the merge gives either weight 0, so a query row whose keys are all
masked in one chunk and live in another comes out exact, never NaN.

The rotation is ``dist.batch_isend_irecv``: on the device under nccl,
through one host buffer under gloo (``parallel/collectives.rotate``,
which counts the bytes and the host-staged seconds under
``STATS["ring"]``).

Also here, as in the JAX package: :func:`attention_reference` (plain
softmax attention, the oracle) and :func:`blockwise_attention`
(single-device chunked attention). :func:`make_ring_attention_fn` and
:func:`ring_attention` take this rank's LOCAL shard (where the JAX
functions take the global array and shard it); at a scale other than
the kernels' 1/sqrt(D), or with ``use_kernels='never'``, they run plain
chunks, which take CPU tensors only: on a card they raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.collectives import RankGroup
from deeplearning4j_tpu_torch.parallel.seq_context import current_seq_axis

__all__ = ["ring_attention", "blockwise_attention", "attention_reference",
           "make_ring_attention_fn", "ring_self_attention"]


def attention_reference(q, k, v, *, causal: bool = False, scale=None):
    """Plain softmax attention (B, T, H, D): the correctness oracle."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                     device=q.device), diagonal=tk - tq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, scale=None):
    """Single-device chunked attention: exact, O(block) memory; the
    running (max, numerator, denominator) in float32."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    B, T, H, D = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    m = torch.full((B, H, T), float("-inf"), dtype=acc, device=q.device)
    num = torch.zeros((B, H, T, D), dtype=acc, device=q.device)
    den = torch.zeros((B, H, T), dtype=acc, device=q.device)
    q_idx = torch.arange(T, device=q.device)
    for start in range(0, T, block_size):
        kb = k[:, start:start + block_size].to(acc)
        vb = v[:, start:start + block_size].to(acc)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kb) * scale
        if causal:
            k_idx = start + torch.arange(kb.shape[1], device=q.device)
            s = s.masked_fill(k_idx[None, :] > q_idx[:, None],
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new),
                             torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isneginf(m), torch.zeros_like(m),
                           torch.exp(m - m_safe))
        num = num * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        den = den * corr + p.sum(-1)
        m = m_new
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---- one chunk: the flash kernels (or, on the CPU at another scale,
# plain math)

def _merge_chunks(o_a, lse_a, o_b, lse_b):
    """Merge two partial attention results (o: (B, T, H, D), lse:
    (B, H, T)). Exact: o = sum_i o_i * exp(lse_i - lse_total), in
    float32; a chunk whose lse is -inf (skipped) or -1e30 (no live key)
    gets weight 0 against a live one, never NaN."""
    lse = torch.logaddexp(lse_a, lse_b)
    zero = torch.zeros((), dtype=lse.dtype, device=lse.device)
    wa = torch.where(torch.isneginf(lse_a), zero, torch.exp(lse_a - lse))
    wb = torch.where(torch.isneginf(lse_b), zero, torch.exp(lse_b - lse))
    to_bth = lambda w: w.permute(0, 2, 1)[..., None]      # (B, T, H, 1)
    o = (o_a.float() * to_bth(wa) + o_b.float() * to_bth(wb))
    return o.to(o_a.dtype), lse


def _scores(q, k, kmask, causal, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        s = s.masked_fill(~torch.tril(torch.ones(
            (T, T), dtype=torch.bool, device=q.device)), float("-inf"))
    if kmask is not None:
        s = s.masked_fill(~(kmask > 0)[:, None, None, :], float("-inf"))
    return s


def _plain_chunk(q, k, v, kmask, causal, scale):
    """(o, lse) of one chunk at any ``scale``, dead rows at lse = -inf
    (the JAX ring's ``_jnp_chunk``)."""
    s = _scores(q, k, kmask, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - safe[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _plain_chunk_bwd(q, k, v, o, lse, do, kmask, causal, scale):
    """The chunk's (dq, dk, dv) with the GLOBAL lse (``_jnp_chunk_bwd``)."""
    s = _scores(q, k, kmask, causal, scale)
    safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - safe[..., None])
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype)
    return dq, dk, dv


def _chunk_fwd(q, k, v, kmask, causal, scale):
    """One chunk's (o, lse): the flash forward (its plain version on CPU
    tensors) at ``scale`` None, else plain math at ``scale`` (CPU
    tensors only, :func:`_plain_scale`)."""
    if scale is None:
        from deeplearning4j_tpu_torch.ops.attention import (
            flash_attention_fwd)
        return flash_attention_fwd(q, k, v, kmask, causal=causal)
    return _plain_chunk(q, k, v, kmask, causal, scale)


def _chunk_bwd(q, k, v, o, lse, do, kmask, causal, scale):
    if scale is None:
        from deeplearning4j_tpu_torch.ops.attention import (
            flash_attention_bwd)
        return flash_attention_bwd(q, k, v, o, lse, do, kmask,
                                   causal=causal)
    return _plain_chunk_bwd(q, k, v, o, lse, do, kmask, causal, scale)


def _plain_scale(q, scale, use_kernels: str = "auto"):
    """None when the chunks run the flash kernels (their scale is
    1/sqrt(D)); else the scale plain chunks run at: another ``scale``,
    or ``use_kernels='never'``. Plain chunks take CPU tensors only: on a
    card the kernels run or the call raises."""
    default = 1.0 / math.sqrt(q.shape[-1])
    if use_kernels == "auto" and (scale is None
                                  or math.isclose(scale, default)):
        return None
    if q.device.type != "cpu":
        why = ("use_kernels='never'" if use_kernels != "auto"
               else f"scale {scale} (the kernels' is 1/sqrt(D) = "
                    f"{default})")
        raise ValueError(f"ring attention on {q.device} runs the flash "
                         f"kernels; {why} has plain chunks, which run "
                         f"on CPU tensors only")
    return default if scale is None else float(scale)


def _kind(src: int, idx: int, causal: bool) -> str:
    """'full', 'diag' or 'skip': where chunk ``src`` sits against the
    queries of rank ``idx``."""
    if not causal or src < idx:
        return "full"
    return "diag" if src == idx else "skip"


def _ring_forward(q, k, v, kmask, grp: RankGroup, causal, scale):
    n, idx = grp.size, grp.index
    B, Tl, H, _ = q.shape
    o = torch.zeros_like(q)
    lse = torch.full((B, H, Tl), float("-inf"), dtype=torch.float32,
                     device=q.device)
    k_cur, v_cur, km_cur = k, v, kmask
    for step in range(n):
        kind = _kind((idx - step) % n, idx, causal)
        if kind != "skip":
            o_c, lse_c = _chunk_fwd(q, k_cur, v_cur, km_cur,
                                    kind == "diag", scale)
            o, lse = _merge_chunks(o, lse, o_c, lse_c)
        if step < n - 1:
            k_cur, v_cur, km_cur = collectives.rotate(
                [k_cur, v_cur, km_cur], grp)
    return o, lse


def _ring_backward(q, k, v, o, lse, do, kmask, grp: RankGroup, causal,
                   scale):
    n, idx = grp.size, grp.index
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    k_cur, v_cur, km_cur = k, v, kmask
    for step in range(n):
        kind = _kind((idx - step) % n, idx, causal)
        if kind != "skip":
            dq_c, dk_c, dv_c = _chunk_bwd(q, k_cur, v_cur, o, lse, do,
                                          km_cur, kind == "diag", scale)
            dq = dq + dq_c
            dk = dk + dk_c
            dv = dv + dv_c
        # dk/dv rotate with their chunk: after n rotations they are home
        if step < n - 1:
            k_cur, v_cur, km_cur, dk, dv = collectives.rotate(
                [k_cur, v_cur, km_cur, dk, dv], grp)
        else:
            dk, dv = collectives.rotate([dk, dv], grp)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """The ring forward, keeping the merged (o, lse); the ring backward.
    The key mask is data: no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, grp, causal, scale):
        o, lse = _ring_forward(q, k, v, kmask, grp, causal, scale)
        ctx.save_for_backward(q, k, v, kmask, o, lse)
        ctx.grp, ctx.causal, ctx.scale = grp, causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, kmask, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do.contiguous(),
                                    kmask, ctx.grp, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _as_mask(kv_mask):
    if kv_mask is None:
        return None
    return (kv_mask > 0).to(torch.float32)


def _ring(q, k, v, km, grp, causal, scale):
    """The ring, differentiable when q, k or v needs a gradient;
    ``scale`` None runs the flash kernels (:func:`_plain_scale`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, km, grp, causal, scale)
    return _ring_forward(q, k, v, km, grp, causal, scale)[0]


def ring_self_attention(q, k, v, *, group: Optional[RankGroup] = None,
                        causal: bool = False, kv_mask=None):
    """Exact attention over a sequence split across the ring ``group``
    (default: the active ``seq_context`` ring): q, k, v are this rank's
    LOCAL (B, T/n, H, D) chunks, ``kv_mask`` its optional (B, T/n)
    key-padding chunk (it rotates with its k/v; padded QUERY rows stay
    the caller's to zero). Returns the local chunk of the output,
    differentiable (the ring backward). Every chunk runs the flash
    kernels (their plain versions on CPU tensors)."""
    grp = group if group is not None else current_seq_axis()
    if grp is None:
        raise ValueError("ring_self_attention needs a seq group (pass "
                         "group= or run inside seq_context."
                         "sequence_parallel)")
    return _ring(q, k, v, _as_mask(kv_mask), grp, causal, None)


def make_ring_attention_fn(mesh, *, axis: str = "seq",
                           causal: bool = False, scale=None,
                           use_kernels: str = "auto"):
    """A ring-attention function over ``mesh`` (a ``MeshContext``, or a
    :class:`RankGroup`): ``fn(q, k, v)`` takes this rank's LOCAL
    (B, T/n, H, D) chunks and returns the local chunk of the output.
    ``use_kernels``: 'auto' runs the flash kernels per chunk at the
    default 1/sqrt(D) scale; 'never', or another ``scale``, runs plain
    chunks, on CPU tensors only (a CUDA tensor raises)."""
    if axis != "seq":
        raise ValueError(f"rings run over the 'seq' axis, not {axis!r}")
    if use_kernels not in ("auto", "never"):
        raise ValueError(f"use_kernels must be 'auto' or 'never', got "
                         f"{use_kernels!r}")
    grp = mesh if isinstance(mesh, RankGroup) else mesh.seq_group()

    def fn(q, k, v):
        return _ring(q, k, v, None, grp, causal,
                     _plain_scale(q, scale, use_kernels))

    return fn


def ring_attention(q, k, v, mesh, *, axis: str = "seq",
                   causal: bool = False, scale=None):
    """One-shot :func:`make_ring_attention_fn` on this rank's local
    chunks."""
    return make_ring_attention_fn(mesh, axis=axis, causal=causal,
                                  scale=scale)(q, k, v)
