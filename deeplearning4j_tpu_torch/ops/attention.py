"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/attention.py``. The TPU kernels
it replaces are ``_fwd_kernel`` (launched by ``pallas_flash_attention``)
and ``_dq_kernel`` / ``_dkv_kernel`` (launched by
``pallas_flash_attention_bwd``); the Hopper kernels are
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``,
which state their designs and bounds. At the LM shape (B=8, T=1024,
H=16, D=64, causal) all three are bound by operations on an H100: the
forward does 4*D FLOPs per live (query, key) pair, dq 6*D and dk/dv
8*D, at least 0.10 / 0.16 / 0.21 ms at 165 TFLOP/s, the rate of
f32-accurate products on the tensor cores (three TF32 passes).

Layout is the JAX package's: q, k, v, o, do are (B, T, H, D); lse and
delta are (B, H, T) float32. The optional ``kv_mask`` is a (B, T) 0/1
key-padding mask: masked keys leave the softmax (-1e30 before the max),
a row that sees no key outputs 0 with lse = -1e30 (and gets dq = 0),
and padded QUERY rows are the caller's to zero.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel or an error. There is no fallback from one to the other.

Head dims: the kernels are instantiated at D = 32, 64 and 128
(``native.HEAD_DIMS``). Any other D up to 128 runs at the next of those,
Dp: the wrappers zero-pad q, k, v (and o, do) along D into contiguous
(B, T, H, Dp) buffers, launch with the scale of the TRUE D, and slice
o, dq, dk, dv back to D (lse and delta need no slicing: zero columns
change no q.k and no rowsum(do * o)). D > 128 is refused
(``native.kernel_head_dim``). The LM's D = 64 takes the kernels as it
is, without a copy.

Both ``precision`` values give float32 results here ('highest'
semantics): inputs are f32; all three kernels multiply on the tensor
cores in three TF32 passes (csrc/tf32_mma.cuh), accumulating in f32,
and agree with the plain versions within f32 tolerances. 'default' is
accepted for the JAX signature; the TPU's bf16 passes and bf16 inputs
are not ported yet.

``flash_attention`` is differentiable: with grad enabled it runs through
an autograd Function that keeps (o, lse) from the forward and calls the
backward kernels; the mask gets no gradient, as the JAX package's
custom VJP gives it a zero cotangent.

float64 (the gradient check's type, ``gradientcheck.py``): the kernels
are float32, as the TPU kernels are, and the JAX package computes
float64 attention with its plain jnp formulation, never Pallas. So
``flash_attention`` routes float64 q, k, v to the forward's plain
version, differentiated by autograd, on the CPU and on a card alike:
the route is keyed on the dtype alone. A float32 CUDA tensor
still takes the kernels or raises; nothing falls back from a failed
launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import native

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_cuda", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv_cuda",
           "flash_attention_bwd_dkv_plain", "pad_head_dim"]

_NEG_INF = -1e30
_PRECISIONS = ("default", "highest")


def _check(q, k, v, kv_mask, precision, dtypes=(torch.float32,)):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in dtypes or t.dtype != q.dtype:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"q, k, v must share one dtype, {names}; "
                            f"{name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kv_mask is not None:
        B, T = q.shape[:2]
        if tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"kv_mask must be (B, T) = {(B, T)}, got "
                             f"{tuple(kv_mask.shape)}")
        if kv_mask.device != q.device:
            raise ValueError(f"kv_mask is on {kv_mask.device}, q on "
                             f"{q.device}")


def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def flash_attention_fwd_plain(q, k, v, kv_mask=None, *, causal=False,
                              precision="default", scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: an explicit einsum, the
    masks as -1e30, a softmax, fully masked rows zeroed, and lse =
    logsumexp (-1e30 for a row that saw no key). Materializes the (B,
    H, T, T) scores. Returns (o, lse). Takes float32, the kernel's
    type, or float64 (``flash_attention``'s float64 route), and
    computes in that type. ``scale`` defaults to 1/sqrt(D), as the
    kernels' (a padded launch passes its true D's)."""
    _check(q, k, v, kv_mask, precision, (torch.float32, torch.float64))
    T, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
        _scale(D) if scale is None else scale)
    live = torch.ones((1, 1, T, T), dtype=torch.bool, device=q.device)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    s = s.masked_fill(~live, _NEG_INF)
    alive = live.any(dim=-1)                            # (B|1, 1, T)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o = o * alive.permute(0, 2, 1)[..., None].to(o.dtype)
    lse = torch.where(alive, torch.logsumexp(s, dim=-1),
                      torch.full((), _NEG_INF, device=q.device))
    return o, lse


def pad_head_dim(t: torch.Tensor, Dp: int) -> torch.Tensor:
    """``t`` (..., D) zero-padded to (..., Dp) in a fresh contiguous
    buffer; ``t`` itself when D == Dp."""
    D = t.shape[-1]
    return t if D == Dp else torch.nn.functional.pad(t, (0, Dp - D))


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    """A padded launch's (..., Dp) output back at the true D, contiguous
    as an unpadded launch's."""
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _kernel_inputs(q, tensors):
    """The CUDA kernels' checks and operand layout: CUDA tensors, a head
    dim up to the kernels' limit, a grid they can launch, and every (B,
    T, H, Dp) operand with a contiguous last dimension and 16-byte
    aligned rows: at a head dim the kernels are built for, copied only
    where that does not hold already; at any other, zero-padded to
    ``native.kernel_head_dim(D)`` (a fresh buffer, so aligned)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    B, T, H, D = q.shape
    Dp = native.kernel_head_dim(D)
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's 65535")
    out = []
    for t in tensors:
        if Dp != D:
            t = pad_head_dim(t, Dp)
        elif t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            t = t.contiguous()
        out.append(t)
    return out


def _entry(source: str, symbol: str, n_ptr: int, n_strides: int):
    """The C entry ``symbol`` of ``csrc/<source>.cu``, with its argument
    types set: pointers, B/T/H/D, strides, scale, causal, stream."""
    fn = getattr(native.load(source), symbol)
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float, ctypes.c_int, ptr])
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, name, q, pointers, tensors, causal, scale):
    """Call ``fn`` on q's current stream at q's (kernel) head dim and
    ``scale``; raise on a launch error."""
    B, T, H, D = q.shape
    strides = [s for t in tensors for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*pointers, B, T, H, D, *strides, scale,
                 int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd_cuda(q, k, v, kv_mask=None, *, causal=False,
                             precision="default"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream
    (at a head dim it is not built for, on zero-padded operands).
    Returns (o, lse). ``flash_attention_fwd_cuda.launches`` counts the
    launches."""
    _check(q, k, v, kv_mask, precision)
    D = q.shape[3]
    q, k, v = _kernel_inputs(q, (q, k, v))
    o, lse = _fwd_launch(q, k, v, kv_mask, causal, _scale(D))
    return _unpad(o, D), lse


def _fwd_launch(q, k, v, kv_mask, causal, scale):
    """The forward kernel on operands ``_kernel_inputs`` laid out."""
    B, T, H, D = q.shape
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fn = _entry("flash_attention_fwd", "dl4j_flash_attention_fwd_f32",
                6, 12)
    _launch(fn, "flash_attention_fwd", q,
            [_ptr(t) for t in (q, k, v, kv_mask, o, lse)], (q, k, v, o),
            causal, scale)
    native.count_launch(flash_attention_fwd_cuda)
    return o, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_fwd(q, k, v, kv_mask=None, *, causal: bool = False,
                        precision: str = "default",
                        return_lse: bool = True):
    """Counterpart of ``pallas_flash_attention``: (B, T, H, D) q, k, v
    -> o [, lse (B, H, T)]. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if q.device.type == "cuda":
        o, lse = flash_attention_fwd_cuda(q, k, v, kv_mask, causal=causal,
                                          precision=precision)
    elif q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, kv_mask,
                                           causal=causal,
                                           precision=precision)
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (o, lse) if return_lse else o


# --------------------------------------------------------------- backward

def _check_bwd(q, k, v, lse, do, kv_mask, o=None):
    _check(q, k, v, kv_mask, "default")
    B, T, H, _ = q.shape
    operands = [("do", do, q.shape), ("lse", lse, (B, H, T))]
    if o is not None:
        operands.append(("o", o, q.shape))
    for name, t, shape in operands:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _recompute_p(q, k, lse, kv_mask, causal, scale):
    """The TPU kernels' p: exp(q.k * scale - lse), 0 where the row saw no
    key (lse <= -1e30/2) and where causal or kv_mask hides the key.
    (B, H, Tq, Tk)."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    live = torch.ones((1, 1, T, T), dtype=torch.bool, device=q.device)
    if causal:
        live = torch.tril(live)
    if kv_mask is not None:
        live = live & (kv_mask > 0)[:, None, None, :]
    live = live & (lse > _NEG_INF / 2)[..., None]
    return torch.where(live, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=q.device))


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, kv_mask=None, *,
                                 causal=False, scale=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dq_kernel``'s function in plain PyTorch: delta = rowsum(do·o),
    p recomputed from lse, ds = p·(do·vᵀ − delta)·scale, dq = ds·k.
    Returns (dq, delta (B, H, T)). ``scale`` as the forward's."""
    _check_bwd(q, k, v, lse, do, kv_mask, o)
    scale = _scale(q.shape[3]) if scale is None else scale
    delta = (do * o).sum(-1).permute(0, 2, 1)
    p = _recompute_p(q, k, lse, kv_mask, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, k), delta


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, kv_mask=None,
                                  *, causal=False, scale=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dkv_kernel``'s function in plain PyTorch: dv = pᵀ·do and
    dk = dsᵀ·q, with the dq pass's delta. Returns (dk, dv). ``scale``
    as the forward's."""
    _check_bwd(q, k, v, lse, do, kv_mask)
    scale = _scale(q.shape[3]) if scale is None else scale
    p = _recompute_p(q, k, lse, kv_mask, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bqhd->bkhd", ds, q), dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_mask=None, *,
                              causal=False):
    """The backward in plain PyTorch, as the two TPU kernels compute it
    (each recomputes p from lse). Returns (dq, dk, dv)."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, kv_mask,
                                             causal=causal)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                           kv_mask, causal=causal)
    return dq, dk, dv


def flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, kv_mask=None, *,
                                causal=False
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dq kernel of ``csrc/flash_attention_bwd.cu``, which
    also writes delta, on the current stream (at a head dim it is not
    built for, on zero-padded operands). Returns (dq, delta).
    ``flash_attention_bwd_dq_cuda.launches`` counts the launches."""
    _check_bwd(q, k, v, lse, do, kv_mask, o)
    D = q.shape[3]
    q, k, v, o, do = _kernel_inputs(q, (q, k, v, o, do))
    dq, delta = _dq_launch(q, k, v, o, lse, do, kv_mask, causal, _scale(D))
    return _unpad(dq, D), delta


def _dq_launch(q, k, v, o, lse, do, kv_mask, causal, scale):
    """The dq kernel on operands ``_kernel_inputs`` laid out."""
    B, T, H, D = q.shape
    lse = lse.contiguous()
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    dq = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    fn = _entry("flash_attention_bwd", "dl4j_flash_attention_bwd_dq_f32",
                9, 18)
    _launch(fn, "flash_attention_bwd_dq", q,
            [_ptr(t) for t in (q, k, v, o, do, lse, kv_mask, dq, delta)],
            (q, k, v, o, do, dq), causal, scale)
    native.count_launch(flash_attention_bwd_dq_cuda)
    return dq, delta


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do, kv_mask=None,
                                 *, causal=False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of ``csrc/flash_attention_bwd.cu`` on the
    current stream, with the dq pass's delta (at a head dim it is not
    built for, on zero-padded operands). Returns (dk, dv).
    ``flash_attention_bwd_dkv_cuda.launches`` counts the launches."""
    _check_bwd(q, k, v, lse, do, kv_mask)
    if tuple(delta.shape) != tuple(lse.shape) \
            or delta.dtype != torch.float32 or delta.device != q.device:
        raise ValueError(f"delta must be float32 {tuple(lse.shape)} on "
                         f"{q.device}")
    D = q.shape[3]
    q, k, v, do = _kernel_inputs(q, (q, k, v, do))
    dk, dv = _dkv_launch(q, k, v, lse, delta, do, kv_mask, causal,
                         _scale(D))
    return _unpad(dk, D), _unpad(dv, D)


def _dkv_launch(q, k, v, lse, delta, do, kv_mask, causal, scale):
    """The dk/dv kernel on operands ``_kernel_inputs`` laid out."""
    B, T, H, D = q.shape
    lse, delta = lse.contiguous(), delta.contiguous()
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    dk = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    if dk.numel() == 0:
        return dk, dv
    fn = _entry("flash_attention_bwd", "dl4j_flash_attention_bwd_dkv_f32",
                9, 18)
    _launch(fn, "flash_attention_bwd_dkv", q,
            [_ptr(t) for t in (q, k, v, do, lse, delta, kv_mask, dk, dv)],
            (q, k, v, do, dk, dv), causal, scale)
    native.count_launch(flash_attention_bwd_dkv_cuda)
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_mask=None, *,
                             causal=False):
    """Both backward kernels: dq (with delta), then dk/dv, on operands
    padded once for both. Returns (dq, dk, dv)."""
    _check_bwd(q, k, v, lse, do, kv_mask, o)
    D = q.shape[3]
    q, k, v, o, do = _kernel_inputs(q, (q, k, v, o, do))
    dq, delta = _dq_launch(q, k, v, o, lse, do, kv_mask, causal, _scale(D))
    dk, dv = _dkv_launch(q, k, v, lse, delta, do, kv_mask, causal,
                         _scale(D))
    return _unpad(dq, D), _unpad(dk, D), _unpad(dv, D)


def flash_attention_bwd(q, k, v, o, lse, do, kv_mask=None, *,
                        causal: bool = False):
    """Counterpart of ``pallas_flash_attention_bwd``: (q, k, v, o, lse,
    do) -> (dq, dk, dv). CPU tensors take the plain version, CUDA
    tensors the kernels."""
    if q.device.type == "cuda":
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, kv_mask,
                                        causal=causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, kv_mask,
                                         causal=causal)
    raise ValueError(f"flash attention runs on cuda or cpu, not "
                     f"{q.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_attention_fwd``, keeping (o, lse);
    backward through ``flash_attention_bwd``. The mask is data: it gets
    no gradient (the JAX package's zero cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, precision):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                                     precision=precision)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask)
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, kv_mask,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """The layers' entry point, as in the JAX package: (B, T, H, D) ->
    (B, T, H, D). An int or bool ``kv_mask`` is taken as 0/1. With grad
    enabled and an input that requires it, the call goes through the
    autograd Function (forward and backward kernels); otherwise (e.g.
    under ``torch.inference_mode``) it is the forward alone. float64
    q, k, v take the plain forward on either device (the module
    docstring says why)."""
    if q.dtype == torch.float64:
        return flash_attention_fwd_plain(q, k, v, kv_mask, causal=causal,
                                         precision=precision)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal, precision)
    return flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                               precision=precision, return_lse=False)
