"""Layer-context error wrapping for the executors' forward and fit
(counterpart of ``deeplearning4j_tpu/nn/errors.py``).

The reference names the failing layer in config and runtime errors. A
wrong input shape otherwise surfaces as torch's bare ``RuntimeError``
(``mat1 and mat2 shapes cannot be multiplied``) with no hint of which
layer it hit: these helpers annotate the failure with the layer index
or vertex name, its class and name, and the input's shape and dtype,
in the JAX package's words.

Only input errors are named: shape and dtype checks, which torch makes
eagerly before it launches anything, on the CPU and on a card alike.
The JAX package wraps only while the forward is traced, so a failure of
the device at run time never reaches its wrapper. The port runs eagerly,
so it passes such failures through unchanged: out of memory, an
accelerator error that surfaces at a synchronization inside a layer, a
failed collective (``_PASSED_THROUGH``). They stay what they are, so a
server answers them as its own fault (500), not as a bad request. A
fault inside a kernel on the card (an embedding index out of range,
say) is asynchronous besides: it is reported at a later synchronization,
outside the layer that queued it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["NetworkExecutionError", "layer_error_context"]

# device and runtime failures, re-raised as they are (None where this
# torch lacks the class)
_PASSED_THROUGH = tuple(c for c in (
    torch.OutOfMemoryError, getattr(torch, "AcceleratorError", None),
    getattr(dist, "DistError", None)) if c is not None)


class NetworkExecutionError(ValueError):
    """A forward/fit failure annotated with the failing layer."""


def _dtype_name(dtype) -> str:
    # torch.float32 -> float32, as the JAX message prints numpy's name
    return str(dtype).replace("torch.", "")


class layer_error_context:
    """Context manager: re-raise a failure inside a layer's apply with
    the layer named, and a device failure (``_PASSED_THROUGH``) as it
    is. ``where``: e.g. "layer 3" or "vertex 'merge'". A class rather
    than a generator, so entering it costs two method calls a layer."""

    __slots__ = ("where", "layer", "x")

    def __init__(self, where: str, layer, x=None):
        self.where, self.layer, self.x = where, layer, x

    def __enter__(self):
        return self

    def __exit__(self, exc_type, e, tb):
        if e is None or not isinstance(e, Exception) \
                or isinstance(e, _PASSED_THROUGH):
            return False
        if isinstance(e, NetworkExecutionError):
            return False           # already annotated (nested graphs)
        shape = getattr(self.x, "shape", None)
        dtype = getattr(self.x, "dtype", None)
        desc = type(self.layer).__name__
        name = getattr(self.layer, "name", None)
        if name:
            desc += f" '{name}'"
        got = (f" with input shape {tuple(shape)} ({_dtype_name(dtype)})"
               if shape is not None else "")
        raise NetworkExecutionError(
            f"Error executing {self.where} ({desc}){got}: "
            f"{type(e).__name__}: {e}") from e
