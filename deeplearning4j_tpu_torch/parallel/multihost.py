"""Multi-process runtime setup (counterpart of
``deeplearning4j_tpu/parallel/multihost.py``).

One process is one rank of a ``torch.distributed`` process group, and
each rank drives one device. Environment-variable driven, with the JAX
package's names: ``DL4J_TPU_COORDINATOR`` (``host:port`` of rank 0's
rendezvous), ``DL4J_TPU_NUM_PROCESSES`` and ``DL4J_TPU_PROCESS_ID``.
Launching N ranks on one host:

    for i in 0 1; do
      DL4J_TPU_COORDINATOR=127.0.0.1:29500 DL4J_TPU_NUM_PROCESSES=2 \\
      DL4J_TPU_PROCESS_ID=$i python train.py &
    done

Where the JAX package auto-discovers TPU-VM peers, the port reads the
variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_WORLD_SIZE``). The backend follows
``mesh.choose_backend``: ``nccl`` when each of a host's ranks has a
card of its own, ``gloo`` when ranks share a card or run on the CPU;
the choice is logged, and an explicit ``backend`` that fails raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import choose_backend

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["initialize_distributed", "is_coordinator", "local_batch_slice",
           "per_host_iterator", "rank_device", "process_index",
           "process_count"]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_ranks(default: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", default))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:i`` with i the local rank modulo the
    host's cards (ranks share a card when there are fewer cards than
    ranks), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group if configured. Returns True when
    multi-process mode is active; a no-op (False) when unconfigured,
    so single-process workflows need no variables. ``device`` is where
    this rank's model lives (it decides the backend unless ``backend``
    is given)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("DL4J_TPU_COORDINATOR")
    if coordinator is None:
        if not (os.environ.get("MASTER_ADDR") and "RANK" in os.environ
                and "WORLD_SIZE" in os.environ):
            return False
        world = int(os.environ["WORLD_SIZE"])
        backend = backend or choose_backend(device, _local_ranks(world))
        _init(backend, "env://", world, int(os.environ["RANK"]), device)
        return True
    num_processes = num_processes or int(
        os.environ.get("DL4J_TPU_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("DL4J_TPU_PROCESS_ID", "0"))
    backend = backend or choose_backend(device, _local_ranks(num_processes))
    _init(backend, f"tcp://{coordinator}", num_processes, process_id,
          device)
    return True


def _init(backend: str, init_method: str, world: int, rank: int,
          device) -> None:
    kwargs = {}
    dev = torch.device(device)
    if backend == "nccl":
        dev = rank_device(dev) if dev.index is None else dev
        torch.cuda.set_device(dev)
        # binds the communicator to this rank's card up front
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    # never silent: ranks sharing a card reduce through the host
    shared = backend == "gloo" and dev.type == "cuda"
    (logger.warning if shared else logger.info)(
        "distributed runtime up: process %d/%d, backend %s (device %s%s)",
        rank, world, backend, dev,
        "; ranks share a card, so gradients are all-reduced through the "
        "host" if shared else "")


def is_coordinator() -> bool:
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This rank's slice of a globally-indexed batch — the analog of
    the reference's per-executor RDD partitions (ExportSupport) and
    per-host sharded iterators.

    ``global_batch`` must divide evenly by the host count: silently
    truncating the remainder would drop ``global_batch % n`` examples
    from EVERY batch on every host — a data bug no loss curve would
    ever point back here."""
    n = process_count()
    per, rem = divmod(global_batch, n)
    if rem:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the "
            f"host count {n}: {rem} example(s) per batch would be "
            f"silently dropped — pad the batch to a multiple of "
            f"{n} or change the host count")
    i = process_index()
    return slice(i * per, (i + 1) * per)


def per_host_iterator(iterator_factory):
    """Build this rank's input pipeline: factory(process_index,
    process_count) -> DataSetIterator. Replaces Spark's RDD
    repartition/export machinery with explicit per-host sharding."""
    return iterator_factory(process_index(), process_count())
