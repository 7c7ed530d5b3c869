"""The collectives of tensor, sequence and pipeline parallelism, over a
:class:`RankGroup` (a mesh axis's ranks through this rank).

One process is one rank. Under ``nccl`` (each rank has a card of its
own) a collective runs on the device tensors. Under ``gloo`` (ranks
sharing a card, or the CPU) a CUDA tensor is staged through the host:
copied out (a sync), reduced or sent by gloo, copied back. Nothing here
can be captured in a CUDA graph under gloo, which is why the executors
run such steps eagerly.

Each collective adds its bytes and, where it staged through the host,
its seconds to :data:`STATS` under a kind (``"dp"`` for the gradient
bucket and the placement broadcast of ``parallel/mesh_spec.py``,
``"ring"``, ``"tp"``, ``"pipe"``, ``"seq"``), which the smoke and the
benchmarks read: ``STATS["ring"]["bytes"]`` and so on.
:func:`reset_stats` zeroes them. Whether a tensor is staged is decided
in one place, :func:`_staged`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["RankGroup", "STATS", "reset_stats", "all_reduce_",
           "all_gather_last", "broadcast_", "rotate", "send", "recv"]


class RankGroup:
    """A group of ranks a collective runs over: the torch process group
    (None for one rank), its gloo host group, its ranks in order, this
    rank's index in them, and the backend. Under ``gloo`` a CUDA tensor
    is staged through the host for every collective, in a pinned
    buffer the group keeps a device and dtype, with the event of its
    last copy back to the card."""

    __slots__ = ("group", "host_group", "ranks", "index", "backend",
                 "pinned")

    def __init__(self, group, host_group, ranks, index: int,
                 backend: Optional[str]):
        self.group = group
        self.host_group = host_group
        self.ranks = [int(r) for r in ranks]
        self.index = int(index)
        self.backend = backend
        self.pinned = {}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return (f"RankGroup(ranks {self.ranks}, index {self.index}, "
                f"{self.backend})")


STATS = {k: {"bytes": 0, "seconds": 0.0, "calls": 0}
         for k in ("dp", "ring", "tp", "pipe", "seq")}


def reset_stats() -> None:
    for v in STATS.values():
        v.update(bytes=0, seconds=0.0, calls=0)


def _count(kind: str, nbytes: int, seconds: float = 0.0) -> None:
    s = STATS[kind]
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds
    s["calls"] += 1


def _alone(grp) -> bool:
    """No process group to run over: nothing to do. (A mesh of one rank
    in a process group still has one, so dp=1 runs the route dp=N
    does.)"""
    return grp is None or grp.group is None


def _staged(grp, device) -> bool:
    """Whether a collective on a tensor on ``device`` goes through the
    host: a CUDA tensor under gloo. The one place that decides it."""
    return torch.device(device).type == "cuda" and grp.backend != "nccl"


def _stage_out(grp, t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in ``grp``'s pinned host buffer (one a device and
    dtype, grown to the largest tensor staged), with the current stream
    synchronized, so the host may read and write it."""
    key = (t.device, t.dtype)
    buf, done = grp.pinned.get(key, (None, None))
    if done is not None:
        done.synchronize()      # its last copy back has left the buffer
    if buf is None or buf.numel() < t.numel():
        buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
        grp.pinned[key] = (buf, None)
    host = buf[:t.numel()].view(t.shape)
    host.copy_(t.detach(), non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def _stage_in(grp, t: torch.Tensor, host: torch.Tensor) -> None:
    """Copy the staged values back into ``t`` on the current stream."""
    t.copy_(host, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    key = (t.device, t.dtype)
    grp.pinned[key] = (grp.pinned[key][0], ev)


def all_reduce_(t: torch.Tensor, grp, op: str = "sum",
                kind: str = "tp") -> torch.Tensor:
    """Reduce ``t`` over ``grp`` in place (``op``: sum or max); with no
    process group it stays as it is. A staged tensor goes through one
    pinned host buffer."""
    if _alone(grp):
        return t
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    nbytes = t.numel() * t.element_size()
    if _staged(grp, t.device):
        t0 = time.perf_counter()
        host = _stage_out(grp, t)
        dist.all_reduce(host, op=rop, group=grp.group)
        _stage_in(grp, t, host)
        _count(kind, nbytes, time.perf_counter() - t0)
        return t
    dist.all_reduce(t, op=rop, group=grp.group)
    _count(kind, nbytes)
    return t


def all_gather_last(t: torch.Tensor, grp, kind: str = "tp") -> torch.Tensor:
    """The ranks' ``t`` concatenated along the last dim, in group
    order."""
    if _alone(grp):
        return t
    t0 = time.perf_counter()
    staged = _staged(grp, t.device)
    src = t.detach().contiguous()
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(grp.size)]
    dist.all_gather(parts, src, group=grp.group)
    out = torch.cat(parts, dim=-1)
    if staged:
        out = out.to(t.device)
    _count(kind, src.numel() * src.element_size() * grp.size,
           time.perf_counter() - t0 if staged else 0.0)
    return out


def broadcast_(t: torch.Tensor, grp, src_index: int,
               kind: str = "tp") -> torch.Tensor:
    """``t`` on every rank of ``grp`` becomes group index
    ``src_index``'s (in place); a staged tensor goes through one pinned
    host buffer."""
    if _alone(grp):
        return t
    src = grp.ranks[src_index]
    nbytes = t.numel() * t.element_size()
    if _staged(grp, t.device):
        t0 = time.perf_counter()
        host = _stage_out(grp, t)
        dist.broadcast(host, src=src, group=grp.group)
        _stage_in(grp, t, host)
        _count(kind, nbytes, time.perf_counter() - t0)
        return t
    dist.broadcast(t, src=src, group=grp.group)
    _count(kind, nbytes)
    return t


def rotate(tensors: Sequence[Optional[torch.Tensor]], grp,
           kind: str = "ring") -> List[Optional[torch.Tensor]]:
    """Send each tensor to the next rank of the ring ``grp`` (group
    index i -> i + 1 mod n) and return what the previous rank sent, in
    the same shapes (None entries pass through). Under nccl each tensor
    goes on the device; under gloo they travel as one flat host
    buffer."""
    if _alone(grp) or grp.size == 1:
        return list(tensors)
    live = [t for t in tensors if t is not None]
    n = grp.size
    nxt = grp.ranks[(grp.index + 1) % n]
    prv = grp.ranks[(grp.index - 1) % n]
    if grp.backend == "nccl":
        ops, out = [], []
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            src = t.detach().contiguous()
            dst = torch.empty_like(src)
            ops += [dist.P2POp(dist.isend, src, nxt, grp.group),
                    dist.P2POp(dist.irecv, dst, prv, grp.group)]
            out.append(dst)
            _count(kind, src.numel() * src.element_size())
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return out
    t0 = time.perf_counter()
    staged = _staged(grp, live[0].device)
    flat = torch.cat([t.detach().reshape(-1).float().cpu() for t in live])
    got = torch.empty_like(flat)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, flat, nxt, grp.group),
        dist.P2POp(dist.irecv, got, prv, grp.group)])
    for r in reqs:
        r.wait()
    received, off = [], 0
    for t in live:
        k = t.numel()
        received.append(got[off:off + k].reshape(t.shape)
                        .to(device=t.device, dtype=t.dtype))
        off += k
    it = iter(received)
    _count(kind, flat.numel() * 4,
           time.perf_counter() - t0 if staged else 0.0)
    return [None if t is None else next(it) for t in tensors]


def send(t: torch.Tensor, peer: int, grp, kind: str = "pipe") -> None:
    """Send ``t`` to global rank ``peer`` (a matching :func:`recv`)."""
    t0 = time.perf_counter()
    staged = _staged(grp, t.device)
    src = t.detach().contiguous()
    if staged:
        src = src.cpu()
    dist.send(src, peer, group=grp.group)
    _count(kind, src.numel() * src.element_size(),
           time.perf_counter() - t0 if staged else 0.0)


def recv(shape, dtype, device, peer: int, grp,
         kind: str = "pipe") -> torch.Tensor:
    """Receive a tensor of ``shape`` / ``dtype`` from global rank
    ``peer`` onto ``device``."""
    staged = _staged(grp, device)
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, peer, group=grp.group)
    return buf.to(device) if staged else buf
