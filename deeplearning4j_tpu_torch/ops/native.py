"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Builds run at first use,
into ``build/kernels/`` at the root of the checkout, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, and never
when a module is imported: the CPU
test suite imports every module on machines with no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "count_launch", "capture_launches", "count_replay",
           "launch_counts", "HEAD_DIMS", "kernel_head_dim"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the head dims every attention kernel (csrc/flash_attention_{fwd,bwd}.cu,
# csrc/decode_attention.cu) is instantiated for
HEAD_DIMS = (32, 64, 128)

_lock = threading.Lock()
_launch_lock = threading.Lock()
# per thread: the launches a CUDA graph capture on this thread recorded
_capturing = threading.local()
# per capturing stream (its handle): the same tallies, for launches made
# on that stream by another thread
_stream_tallies: Dict[int, dict] = {}


def kernel_head_dim(D: int) -> int:
    """The width an attention kernel runs head dim ``D`` at: ``D`` where
    the kernels are instantiated for it, else the next of
    :data:`HEAD_DIMS`, the operands zero-padded to it along D (a zero
    column changes no q.k, no rowsum(do * o) and no real column of o,
    dq, dk or dv; the wrappers pass the scale of the true D). Past the
    largest the kernels refuse it."""
    for Dp in HEAD_DIMS:
        if D <= Dp:
            return Dp
    raise ValueError(
        f"head dim {D} exceeds the attention kernels' limit of "
        f"{HEAD_DIMS[-1]} (they run every head dim from 1 to "
        f"{HEAD_DIMS[-1]}); the JAX package deeplearning4j_tpu runs it")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: the serving
    replicas' worker threads launch kernels concurrently, and a bare
    ``+= 1`` can lose counts between threads. Readers read the attribute
    and reset it by assignment, as before. Inside :func:`capture_launches`
    on this thread the launch is recorded, not counted: a captured launch
    runs only when the graph is replayed."""
    tally = getattr(_capturing, "tally", None)
    if tally is None and _stream_tallies:
        import torch
        tally = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
    if tally is not None:
        with _launch_lock:
            tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _launch_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def capture_launches(stream=None):
    """Within the block, this thread's ``count_launch`` calls fill the
    yielded dict (wrapper -> launches) instead of the counters: the
    launches a CUDA graph captures. With ``stream`` (the capturing
    stream), launches on that stream from any thread fill it too: a
    captured backward runs on autograd's device thread. Other launches
    count as usual. Pass the dict to :func:`count_replay` on every
    replay of the graph."""
    if getattr(_capturing, "tally", None) is not None:
        raise RuntimeError("capture_launches does not nest")
    _capturing.tally = tally = {}
    key = None if stream is None else stream.cuda_stream
    if key is not None:
        with _launch_lock:
            _stream_tallies[key] = tally
    try:
        yield tally
    finally:
        _capturing.tally = None
        if key is not None:
            with _launch_lock:
                _stream_tallies.pop(key, None)


def count_replay(tally) -> None:
    """Add one replay's captured launches to the counters."""
    with _launch_lock:
        for wrapper, n in tally.items():
            wrapper.launches += n


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches} of every hand-written kernel's wrapper in
    this process (a mesh rank prints them as it exits)."""
    from deeplearning4j_tpu_torch.ops import attention, decode_attention
    return {w.__name__: w.launches for w in (
        attention.flash_attention_fwd_cuda,
        attention.flash_attention_bwd_dq_cuda,
        attention.flash_attention_bwd_dkv_cuda,
        decode_attention.decode_attention_cuda)}


_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of deeplearning4j_tpu_torch are built "
                       "from source at first use")


def _target(name: str) -> str:
    """The build path of ``csrc/<name>.cu``: keyed by the source, every
    header in ``csrc/`` (any of them may be included) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            digest.update(f.encode() + b"\0" + src.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile every kernel source (or ``names``) that has no current
    build, one ``nvcc`` per source, all started together. Returns
    name -> the compiler's resource report (``-Xptxas -v``) for the
    sources built now. Raises with the compiler output on failure."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                       if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed, logs = [], {}
    for name, (proc, tmp, target) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(_target(name))
    return lib
