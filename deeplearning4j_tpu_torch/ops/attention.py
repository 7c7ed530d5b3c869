"""Flash-attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``deeplearning4j_tpu/ops/attention.py``. The TPU kernel
it replaces is ``_fwd_kernel`` there (launched by
``pallas_flash_attention``); the Hopper kernel is
``csrc/flash_attention_fwd.cu``, which states its design and bound. At
the LM shape (B=8, T=1024, H=16, D=64, causal) one call is ~1.7e10
FLOPs against ~134 MB, so on an H100 it is bound by operations: at
least 0.26 ms at the 67 TFLOP/s CUDA-core f32 rate.

Layout is the JAX package's: q, k, v are (B, T, H, D); o is (B, T, H,
D) and lse is (B, H, T) float32. The optional ``kv_mask`` is a (B, T)
0/1 key-padding mask: masked keys leave the softmax (-1e30 before the
max), a row that sees no key outputs 0 with lse = -1e30, and padded
QUERY rows are the caller's to zero.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel or an error. There is no fallback from one to the other.

Both ``precision`` values give exact float32 here: inputs are f32 and
products accumulate in f32 on the CUDA cores ('highest' semantics).
'default' is accepted for the JAX signature; the TPU's bf16 passes, TF32
and bf16 inputs are not ported yet.

Forward only: the backward kernels (``_dq_kernel``, ``_dkv_kernel``)
and the autograd wiring belong to the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_cuda", "flash_attention_fwd_plain"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_PRECISIONS = ("default", "highest")


def _check(q, k, v, kv_mask, precision):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q, k, v must share one (B, T, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (the only dtype "
                            f"ported so far), got {t.dtype}")
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


def flash_attention_fwd_plain(q, k, v, kv_mask=None, *, causal=False,
                              precision="default"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: an explicit einsum, the
    masks as -1e30, a float32 softmax, fully masked rows zeroed, and
    lse = logsumexp (-1e30 for a row that saw no key). Materializes
    the (B, H, T, T) scores. Returns (o, lse)."""
    _check(q, k, v, kv_mask, precision)
    T, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(D))
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


def flash_attention_fwd_cuda(q, k, v, kv_mask=None, *, causal=False,
                             precision="default"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream.
    Returns (o, lse). ``flash_attention_fwd_cuda.launches`` counts the
    launches."""
    _check(q, k, v, kv_mask, precision)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    B, T, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of the kernel's "
                         f"{_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's 65535")
    ins = []
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            t = t.contiguous()
        ins.append(t)
    q, k, v = ins
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    from deeplearning4j_tpu_torch.ops import native
    fn = native.load("flash_attention_fwd").dl4j_flash_attention_fwd_f32
    if fn.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = ([ptr] * 6 + [ctypes.c_int] * 4 + [i64] * 12
                       + [ctypes.c_float, ctypes.c_int, ptr])
        fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_mask is None else kv_mask.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), B, T, H, D, *strides,
                 1.0 / math.sqrt(D), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_fwd_cuda.launches += 1
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


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """The layers' entry point, as in the JAX package: (B, T, H, D) ->
    (B, T, H, D). An int or bool ``kv_mask`` is taken as 0/1."""
    return flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                               precision=precision, return_lse=False)
