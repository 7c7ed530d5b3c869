"""Gradient compression (counterpart of
``deeplearning4j_tpu/parallel/compression.py``).

Two halves, as in the JAX package:

- **Point-to-point** (:func:`int8_quantize_ef`, :func:`int8_dequantize`):
  one tensor to int8 with a per-tensor absmax scale and error feedback,
  no collective. The parameter-server worker pushes these codes over
  TCP (``parallel/paramserver.py``); it runs on the worker's device.
- **Collective** (:func:`int8_all_reduce`, :func:`int8_all_reduce_ef`,
  :func:`make_compressed_psum`, :func:`make_compressed_psum_ef`): the
  int8 quantized all-reduce, over a ``torch.distributed`` process group
  where the JAX package takes a ``shard_map`` axis name: ``all_reduce``
  with ``MAX`` for ``lax.pmax`` and an int32 ``all_reduce`` with
  ``SUM`` for ``lax.psum``. ``group=None`` is the default group.

:class:`ThresholdCompressor` keeps the reference's threshold encoding
with residual carry for parity tests.

The JAX package computes all of this with ``jnp`` ops and no Pallas
kernel, so these are plain torch ops. The error-feedback arithmetic
runs in float32 in the JAX package's order (``absmax / 127``, ``round(g / scale)``
half to even, ``clip(-127, 127)``, then ``residual = g - q * scale``),
so on the CPU the codes, scales and residuals of a float32 input equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.conf.updaters import tree_map

__all__ = ["ThresholdCompressor", "int8_all_reduce",
           "int8_all_reduce_ef", "int8_quantize_ef",
           "int8_dequantize", "make_compressed_psum",
           "make_compressed_psum_ef"]


class ThresholdCompressor:
    """Reference-parity threshold encoding (EncodingHandler.java:139
    thresholdEncode): values |g| >= t are quantized to ±t and removed
    from the residual; the rest stay as residual for future steps
    (error feedback). Adaptive threshold decay mirrors :149-158."""

    def __init__(self, threshold: float = 1e-3, decay: float = 0.95,
                 min_threshold: float = 1e-5):
        self.threshold = threshold
        self.decay = decay
        self.min_threshold = min_threshold

    def encode(self, grads, residual):
        """Returns (quantized, new_residual, density)."""
        g = grads + residual
        t = self.threshold
        mask = g.abs() >= t
        quantized = torch.where(mask, torch.sign(g) * t,
                                torch.zeros((), dtype=g.dtype,
                                            device=g.device))
        new_residual = g - quantized
        density = mask.to(torch.float32).mean()
        return quantized, new_residual, density

    def maybe_adapt(self, density: float) -> None:
        """Bitmap-fallback analog: if too dense, raise threshold; if
        nothing passes, decay it (host-side control, like the
        reference's adaptive handler)."""
        if density > 0.1:
            self.threshold = min(self.threshold / self.decay, 1.0)
        elif density == 0.0:
            self.threshold = max(self.threshold * self.decay,
                                 self.min_threshold)


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127``, or 1 for an all-zero tensor, in absmax's
    dtype."""
    return torch.where(absmax > 0, absmax / 127.0,
                       torch.ones((), dtype=absmax.dtype,
                                  device=absmax.device))


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def int8_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantize to int8 (per-tensor absmax scale, MAX-reduced over
    ``group``), sum the codes as int32 over ``group``, dequantize. As
    in the JAX package the scale is computed in ``x``'s dtype. 8x less
    traffic than float32."""
    absmax = x.abs().max()
    wire = absmax.to(torch.float32)          # a max is exact either way
    dist.all_reduce(wire, op=dist.ReduceOp.MAX, group=group)
    scale = _scale_of(wire.to(x.dtype))
    q = _quantize(x, scale)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(x.dtype) * scale


def _ef_carry(x, residual, threshold: float):
    """EF pre-quantization: fold the carried residual in and apply the
    sparsification threshold, ALL in float32 (a bf16 input's
    quantization error is itself below bf16's resolution; rounding the
    carry would lose signal, the one thing error feedback exists to
    prevent). Returns ``(g, g_kept)``."""
    g = x.to(torch.float32) + residual.to(torch.float32)
    if threshold > 0.0:
        g_kept = torch.where(g.abs() >= threshold, g,
                             torch.zeros((), dtype=g.dtype,
                                         device=g.device))
    else:
        g_kept = g
    return g, g_kept


def _ef_encode(g, g_kept, absmax):
    """Quantize ``g_kept`` against ``absmax`` (the local max for the
    point-to-point path, MAX-reduced for the collective) and compute the
    float32 residual. Returns ``(q_int8, scale, new_residual)``."""
    scale = _scale_of(absmax)
    q = _quantize(g_kept, scale)
    sent = q.to(torch.float32) * scale
    return q, scale, g - sent          # exact quantization error (f32)


def int8_quantize_ef(x: torch.Tensor, residual: torch.Tensor,
                     threshold: float = 0.0):
    """Point-to-point half of :func:`int8_all_reduce_ef`: ONE tensor to
    int8 with error feedback, no collective. Returns ``(q_int8, scale,
    new_residual)``, all on ``x``'s device; ``scale`` is a float32
    scalar tensor (no host read) and ``new_residual`` is ALWAYS float32,
    equal to ``(x + residual) - dequant(q)`` computed in float32. Decode
    with :func:`int8_dequantize`."""
    g, g_kept = _ef_carry(x, residual, threshold)
    return _ef_encode(g, g_kept, g_kept.abs().max())


def int8_dequantize(q: torch.Tensor, scale, dtype=torch.float32):
    """Decode :func:`int8_quantize_ef`'s wire pair back to values."""
    return (q.to(torch.float32) * scale).to(dtype)


def int8_all_reduce_ef(x: torch.Tensor, residual: torch.Tensor,
                       group=None, threshold: float = 0.0):
    """int8 quantized all-reduce WITH residual error feedback (the
    reference's threshold encoding with residual carry,
    EncodingHandler.java:116-181): the local quantization error
    becomes the next step's residual, carried in float32. Returns
    ``(reduced_sum in x's dtype, new_residual)``."""
    g, g_kept = _ef_carry(x, residual, threshold)
    absmax = g_kept.abs().max()
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    q, scale, new_residual = _ef_encode(g, g_kept, absmax)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.to(torch.float32) * scale).to(x.dtype), new_residual


def make_compressed_psum_ef(threshold: float = 0.0):
    """Tree version of :func:`int8_all_reduce_ef`:
    ``psum_fn(grad_tree, residual_tree, group) -> (reduced_tree,
    new_residual_tree)``: what a compressed data-parallel step calls.
    Every rank must hold trees of one structure (the collectives run
    leaf by leaf in the tree's order)."""

    def psum_fn(tree, residuals, group=None):
        return _split_pairs(tree_map(
            lambda g, r: int8_all_reduce_ef(g, r, group, threshold),
            tree, residuals))

    return psum_fn


def _split_pairs(pairs):
    """A tree (lists and dicts) of ``(a, b)`` leaves as the pair of
    trees ``(A, B)``."""
    if isinstance(pairs, dict):
        split = {k: _split_pairs(v) for k, v in pairs.items()}
        return ({k: v[0] for k, v in split.items()},
                {k: v[1] for k, v in split.items()})
    if isinstance(pairs, list):
        split = [_split_pairs(v) for v in pairs]
        return [v[0] for v in split], [v[1] for v in split]
    return pairs


def make_compressed_psum(threshold: float = 0.0):
    """Returns ``psum_fn(tree, group)`` for gradient trees: int8
    quantized all-reduce, with hard threshold sparsification first when
    ``threshold`` > 0 (values |g| < threshold are dropped pre-reduce).
    No residual here: error feedback is :func:`make_compressed_psum_ef`
    or :class:`ThresholdCompressor`."""

    def _one(g, group):
        if threshold > 0.0:
            g = torch.where(g.abs() >= threshold, g,
                            torch.zeros((), dtype=g.dtype, device=g.device))
        return int8_all_reduce(g, group)

    def psum_fn(tree, group=None):
        return tree_map(lambda g: _one(g, group), tree)

    return psum_fn
