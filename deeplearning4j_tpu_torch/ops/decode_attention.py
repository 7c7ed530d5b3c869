"""Paged decode attention: a hand-written CUDA kernel and its plain
PyTorch version.

The one attention function of every decode path in the port: the
batcher's step (t = 1), the speculative verify chunk (t = k), streaming
prefill chunks (t = T0) and the eager ``rnn_time_step``. A dense cache
is the same call with ``page_size = capacity`` and ``table =
arange(B)[:, None]``.

Inputs: ``q`` (S, t, H, Dh) float32; ``k_pool``, ``v_pool`` (N,
page_size, H, Dh) float32; ``table`` (S, P) integer page ids; ``pos``
(S,) the global position of each slot's first new query: host data (an
int, a sequence, a numpy array or a CPU tensor), or an int32 tensor on
q's device together with ``host_pos``, its host copy. The checks read
the host copy only, so checking costs no device sync and a launch inside
a CUDA graph capture reads its positions from the device buffer the
graph was captured with. For slot s, query i, head h::

    o[s, i, h] = softmax_j(q . k_j * Dh^-0.5) . v_j,  j <= pos[s] + i

with key j at ``k_pool[table[s, j // page_size], j % page_size, h]``.
That is the JAX package's masked full-capacity softmax
(``SelfAttentionLayer.apply_stream_paged`` / ``apply_stream_bounded``,
``_stream_attention``): a masked logit there is -1e30 and exp(-1e30 -
max) == 0 in f32, so reading only the live keys changes nothing.

It replaces no Pallas kernel but the XLA einsums of those methods; the
kernel is ``csrc/decode_attention.cu``, which states its design and
bound: the keys of each (slot, head) split over CTAs in chunks of
``KEY_CHUNK``, merged in a fixed order (``tests/test_torch_decode.py``
holds that split and merge, written in plain PyTorch, to the plain
version). Dispatch: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel or an error. There is no fallback from one to the
other.

Head dims: the kernel is instantiated at Dh = 32, 64 and 128
(``native.HEAD_DIMS``); any other Dh up to 128 runs at the next of
those, Dp, with the scale of the true Dh. Copying a pool to Dp every
step would cost more than the step, so the sessions' pools are
allocated padded from the start: on the card :func:`zero_kv_pool` gives
the Dh-wide view of a zeroed (N, page_size, H, Dp) buffer. Everything
that writes, copies, zeroes or ships pages goes through the view (the
lease wire carries Dh), the padding columns stay zero, and the kernel
reads the buffer under it in place. Per step only q is padded and o sliced. A
pool of another layout (the eager ``apply_stream``'s concatenated
cache) is padded by a copy a call.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import native

__all__ = ["decode_attention", "decode_attention_cuda",
           "decode_attention_plain", "host_positions", "n_key_splits",
           "zero_kv_pool", "KEY_CHUNK"]

_NEG_INF = -1e30
KEY_CHUNK = 128         # keys a CTA of the split kernel takes (kChunk)


def n_key_splits(span: int) -> int:
    """The kernel's chunks of a (slot, head): ceil(span / KEY_CHUNK) for a
    table spanning ``span`` = P * page_size positions. It depends on the
    span only, never on the positions, so a captured launch holds for
    every step."""
    return -(-int(span) // KEY_CHUNK)


def zero_kv_pool(n: int, rows: int, H: int, Dh: int, device="cpu",
                 padded=None) -> torch.Tensor:
    """A zeroed float32 (n, rows, H, Dh) k or v pool. On the card
    (``padded`` None and a CUDA ``device``, or ``padded`` True), one the
    kernel reads in place: at a head dim it is built for, a contiguous
    tensor; at any other up to its limit, the Dh-wide view of a zeroed
    (n, rows, H, Dp) buffer (``native.kernel_head_dim``). Otherwise, and
    past the limit (the kernel refuses it), a contiguous tensor: the
    plain version reads any Dh."""
    if padded is None:
        padded = torch.device(device).type == "cuda"
    Dp = native.kernel_head_dim(Dh) \
        if padded and Dh <= native.HEAD_DIMS[-1] else Dh
    buf = torch.zeros((n, rows, H, Dp), dtype=torch.float32, device=device)
    return buf if Dp == Dh else buf[..., :Dh]


def _kernel_pool(p: torch.Tensor, Dp: int) -> torch.Tensor:
    """A pool as the kernel reads it, at width Dp: the (N, rows, H, Dp)
    buffer under a :func:`zero_kv_pool` view (same address, no copy),
    or, for a pool of another layout, a zero-padded copy."""
    N, rows, H, D = p.shape
    if D == Dp:
        if not p.is_contiguous() or p.data_ptr() % 16:
            # the pools are written in place by the sessions: never copied
            raise ValueError("a pool must be contiguous and 16-byte "
                             "aligned")
        return p
    if p.stride() == (rows * H * Dp, H * Dp, Dp, 1) \
            and p.data_ptr() % 16 == 0:
        return p.as_strided((N, rows, H, Dp), p.stride())
    return torch.nn.functional.pad(p, (0, Dp - D))


def host_positions(pos, n: int) -> torch.Tensor:
    """``pos`` (an int for every row, or n of them: a sequence, numpy
    array or CPU tensor) as a contiguous (n,) int32 CPU tensor."""
    if isinstance(pos, torch.Tensor) and pos.device.type != "cpu":
        raise ValueError("decode positions for the checks are host data; "
                         f"got a tensor on {pos.device} (pass the "
                         "session's host copy as host_pos)")
    p = np.asarray(pos.numpy() if isinstance(pos, torch.Tensor) else pos)
    if p.ndim == 0:
        p = np.full((n,), int(p))
    if p.shape != (n,):
        raise ValueError(f"pos must be a scalar or ({n},), got {p.shape}")
    if p.dtype.kind not in "iu":
        raise TypeError(f"pos must be integer, got {p.dtype}")
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.int32))


def _positions(pos, host_pos, S: int, device):
    """(host copy, positions on ``device``) of ``pos``. A device tensor
    must come with its host copy: the checks never read the device."""
    if isinstance(pos, torch.Tensor) and pos.device.type != "cpu":
        if host_pos is None:
            raise ValueError("device positions need their host copy "
                             "(host_pos) for the checks")
        if pos.device != device:
            raise ValueError(f"pos is on {pos.device}, q on {device}")
        if pos.dtype != torch.int32 or pos.shape != (S,) \
                or not pos.is_contiguous():
            raise ValueError(f"device positions must be a contiguous "
                             f"({S},) int32 tensor, got {pos.dtype} "
                             f"{tuple(pos.shape)}")
        return host_positions(host_pos, S), pos
    host = host_positions(pos if host_pos is None else host_pos, S)
    return host, None


def _check(q, k_pool, v_pool, table, pos):
    """Shapes, dtypes, devices and the host positions ``pos`` (int32,
    from ``host_positions``)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (S, t, H, Dh), got {tuple(q.shape)}")
    S, t, H, D = q.shape
    for name, p in (("k_pool", k_pool), ("v_pool", v_pool)):
        if p.dim() != 4 or p.shape[2:] != (H, D):
            raise ValueError(f"{name} must be (N, page_size, {H}, {D}), "
                             f"got {tuple(p.shape)}")
        if p.device != q.device:
            raise ValueError(f"{name} is on {p.device}, q on {q.device}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} differ")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (the only dtype "
                            f"ported so far), got {x.dtype}")
    if table.dim() != 2 or table.shape[0] != S:
        raise ValueError(f"table must be ({S}, P), got {tuple(table.shape)}")
    if table.dtype.is_floating_point or table.dtype == torch.bool:
        raise TypeError(f"table must hold integer page ids, got "
                        f"{table.dtype}")
    if table.device != q.device:
        raise ValueError(f"table is on {table.device}, q on {q.device}")
    span = table.shape[1] * k_pool.shape[1]
    if S and t and (int(pos.min()) < 0 or int(pos.max()) + t > span):
        raise ValueError(
            f"positions [{int(pos.min())}, {int(pos.max())}] + t={t} leave "
            f"the page table's {table.shape[1]} x {k_pool.shape[1]} = "
            f"{span} positions")


def decode_attention_plain(q, k_pool, v_pool, table, pos,
                           host_pos=None, scale=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, the JAX step written out:
    gather each slot's virtual cache (S, P * page_size, H, Dh), einsum,
    ``where(k_pos <= q_pos, ., -1e30)``, softmax, einsum. With device
    positions it reads them on the device (no sync, graph-safe).
    ``scale`` defaults to Dh^-0.5, as the kernel's."""
    S = q.shape[0] if q.dim() == 4 else 0
    host, dev = _positions(pos, host_pos, S, q.device)
    _check(q, k_pool, v_pool, table, host)
    if dev is None:
        dev = host.to(q.device)
    S, t, H, D = q.shape
    ps = k_pool.shape[1]
    table = table.long()
    P = table.shape[1]
    k = k_pool[table].reshape(S, P * ps, H, D)
    v = v_pool[table].reshape(S, P * ps, H, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (
        D ** -0.5 if scale is None else scale)
    k_pos = torch.arange(P * ps, device=q.device)[None, None, :]
    q_pos = (dev.long()[:, None]
             + torch.arange(t, device=q.device)[None, :])[:, :, None]
    logits = torch.where((k_pos <= q_pos)[:, None], logits,
                         torch.full((), _NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _entry():
    fn = native.load("decode_attention").dl4j_decode_attention_f32
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = ([ptr] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, k_pool, v_pool, table, pos,
                          host_pos=None) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu`` (its split and merge kernels)
    on q's current stream. Returns o (S, t, H, Dh). Host positions are
    uploaded here; a device ``pos`` (with ``host_pos``) is read in
    place, so the call can be captured in a CUDA graph. At a head dim
    the kernel is not built for, q is zero-padded, the pools read at
    their padded width (:func:`zero_kv_pool`) and o sliced back.
    ``decode_attention_cuda.launches`` counts the calls."""
    S = q.shape[0] if q.dim() == 4 else 0
    host, dev = _positions(pos, host_pos, S, q.device)
    _check(q, k_pool, v_pool, table, host)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{q.device}")
    S, t, H, Dh = q.shape
    D = native.kernel_head_dim(Dh)
    k_pool, v_pool = _kernel_pool(k_pool, D), _kernel_pool(v_pool, D)
    if D != Dh:
        q = torch.nn.functional.pad(q, (0, D - Dh))
    q = q.contiguous()
    if q.data_ptr() % 16:
        # a contiguous view at an odd offset: the kernel reads q with
        # 16-byte loads, and a misaligned one would fault the context
        q = q.clone()
    table = table.to(torch.int32).contiguous()
    if dev is None:
        dev = host.pin_memory().to(q.device, non_blocking=True)
    o = torch.empty((S, t, H, D), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o[..., :Dh]
    P, ps = table.shape[1], k_pool.shape[1]
    n_split = n_key_splits(P * ps)
    partials = torch.empty(S * t * H * n_split * (D + 2),
                           dtype=torch.float32, device=q.device)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table.data_ptr(), dev.data_ptr(), o.data_ptr(),
                 partials.data_ptr(), S, t, H, D, ps, P, n_split,
                 1.0 / math.sqrt(Dh), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    native.count_launch(decode_attention_cuda)
    return o if D == Dh else o[..., :Dh].contiguous()


decode_attention_cuda.launches = 0


def decode_attention(q, k_pool, v_pool, table, pos,
                     host_pos=None) -> torch.Tensor:
    """(S, t, H, Dh) q over paged (N, page_size, H, Dh) k/v pools ->
    (S, t, H, Dh). CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_pool, v_pool, table, pos,
                                     host_pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_pool, v_pool, table, pos,
                                      host_pos)
    raise ValueError(f"decode attention runs on cuda or cpu, not "
                     f"{q.device}")
