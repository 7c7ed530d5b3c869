"""Ranks for the examples that train over a mesh (``data_parallel_resnet``,
``long_context_lm``).

The JAX examples run a mesh of devices in one process; the port runs one
process a rank (``parallel/multihost.py``). With the multihost variables
set (``DL4J_TPU_PROCESS_ID`` among them, or torchrun's ``RANK``), an
example is one rank. Without them it starts its own ranks: the same
module with the same arguments, the variables set, rendezvous at
``DL4J_TPU_COORDINATOR`` when that alone is set, else at a free local
port. Rank 0's output is relayed; the others' is shown when a rank
fails, and then the rest are stopped. The backend follows
``mesh.choose_backend``: gloo on the CPU and when ranks share a card,
nccl with a card a rank. On the CPU each rank runs one torch thread, so
a few ranks do not oversubscribe the cores.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import List

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def is_rank() -> bool:
    """Whether this process is one rank of a launch (the variables are
    set), rather than the command a user ran."""
    return "DL4J_TPU_PROCESS_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def launch(module: str, argv: List[str], world: int, device: str) -> int:
    """Run ``world`` ranks of ``python -m module argv`` and wait for them.
    Rank 0's output goes to this process's stdout as it comes. Returns 0
    when every rank exits 0, else the first failed rank's exit code,
    after stopping the others and writing every rank's log to stderr."""
    from deeplearning4j_tpu_torch.serving.fleet import free_port
    coordinator = (os.environ.get("DL4J_TPU_COORDINATOR")
                   or f"127.0.0.1:{free_port()}")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, DL4J_TPU_COORDINATOR=coordinator,
               DL4J_TPU_NUM_PROCESSES=str(world),
               PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs = [tempfile.TemporaryFile() for _ in range(world)]
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv],
                env=dict(env, DL4J_TPU_PROCESS_ID=str(rank)),
                stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE if rank == 0 else logs[rank],
                stderr=logs[rank], text=rank == 0))

        def relay():
            for line in procs[0].stdout:
                sys.stdout.write(line)
                sys.stdout.flush()
        relayer = threading.Thread(target=relay, daemon=True)
        relayer.start()
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.05)
        # the ranks that failed on their own, before any was stopped
        failed = [c for c in codes if c]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    relayer.join()
    if failed:
        for rank, log in enumerate(logs):
            log.seek(0)
            sys.stderr.write(f"--- rank {rank} (exit "
                             f"{procs[rank].returncode}):\n"
                             + log.read().decode(errors="replace"))
    for log in logs:
        log.close()
    return failed[0] if failed else 0
