"""Serving-side AOT warmup: zero post-startup captures (counterpart
of ``deeplearning4j_tpu/serving/warmup.py``, the imports renamed).

The TF-Serving pattern (arXiv:1605.08695): a replica that builds its
programs on its first real request serves that request late. In the
port the one program built at first use is the paged decode step's
CUDA graph (``models/paged_kv.PagedSlotSession``), captured at a
session's first step on the card. ``serve --aot-warmup`` runs
:func:`warmup_server` at boot, before the listener opens: every hosted
model is driven with representative zero inputs through the REAL
serving entry points —

- **predict**: ``model.output`` over every power-of-two batch bucket
  up to the scheduler's ``max_batch_size``, per-item shape derived
  from the model's configured ``InputType`` (the port's scheduler does
  not pad, and its forward is eager, so this warms the kernels' first
  loads and cuBLAS, not compiled programs);
- **generate**: one short dummy request through the continuous
  batcher: its first step captures the decode step's graph, for models
  that support streaming.

After warmup a steady-state request burst captures ZERO times —
``observability.compile_watch.zero_compile_scope`` proves it.

Predict warmup drives ``model.output`` directly (the scheduler's own
device call, bypassing its queue), so it leaves NO trace in serving
metrics; the generate pass goes through the continuous batcher's real
request path and does count — dashboards may see one boot-time
generate per streaming model.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["warmup_server"]


def _pow2_sizes(max_batch_size: int):
    """The JAX scheduler's batch buckets (its ``pow2_pad_rows``: every
    batch of 1..max rows padded up to the next power of two)."""
    return sorted({1 << max(0, n - 1).bit_length()
                   for n in range(1, max_batch_size + 1)})


def _per_item_shape(model) -> Optional[Tuple[int, ...]]:
    """The per-item feature shape a /v1/predict request carries,
    derived from the model's configured InputType; None when the
    config doesn't pin it (multi-input graphs, unknown-length
    sequences) — those models skip predict warmup with a log line."""
    conf = getattr(model, "conf", None)
    t = getattr(conf, "input_type", None)
    if t is None:
        types = getattr(conf, "input_types", None)
        if types and len(types) == 1:
            t = types[0]
    if t is None:
        return None
    try:
        shape = tuple(t.array_shape(1))[1:]
    except Exception:
        return None
    if any(d is None or d < 0 for d in shape):
        return None
    return shape


def warmup_server(server, *, generate: bool = True,
                  prompt_tokens: int = 8,
                  n_tokens: int = 16) -> Dict[str, dict]:
    """Pre-compile every hosted model's serving executables (see
    module docstring). ``server`` is a
    :class:`~deeplearning4j_tpu_torch.serving.http.ModelServer`; call
    before (or right after) ``start()``. Returns per-model
    ``{"version", "predict_buckets", "generate", "seconds",
    "skipped"}``."""
    report: Dict[str, dict] = {}
    for entry in server.registry.models():
        name = entry["name"]
        # the model as predict serves it (its tensor-parallel proxy on
        # a mesh server: each bucket then runs on every rank)
        model, version = server.resolve_serving_model(name)
        r = {"version": version, "predict_buckets": [],
             "generate": False, "seconds": 0.0, "skipped": []}
        t0 = time.perf_counter()
        shape = _per_item_shape(model)
        if shape is None:
            r["skipped"].append(
                "predict: per-item input shape not derivable from "
                "the model's InputType config")
            logger.info("aot warmup: skipping predict warmup for "
                        "%s (no concrete input shape)", name)
        else:
            server.scheduler_for(name)    # build the backend up front
            try:
                for b in _pow2_sizes(server.max_batch_size):
                    x = np.zeros((b,) + shape, np.float32)
                    # the scheduler's device call is model.output on
                    # the batch — drive it directly and block (the copy
                    # back of its device tensor) so the first launches
                    # land before traffic does
                    model.output(x).cpu()
                    r["predict_buckets"].append(b)
            except Exception as e:
                # e.g. integer-input (embedding/token-id) models
                # reject float zeros — a warmup miss must not stop
                # the server from booting
                r["skipped"].append(f"predict: {e}")
                logger.info("aot warmup: predict warmup skipped for "
                            "%s: %s", name, e)
        if generate and hasattr(model, "slot_streaming_session"):
            try:
                batcher, _ = server.batcher_for(name)
                n = max(1, min(prompt_tokens,
                               server.capacity - n_tokens - 1))
                toks = max(1, min(n_tokens, server.capacity - n - 1))
                batcher.generate(np.zeros(n, dtype=np.int64), toks)
                r["generate"] = True
            except Exception as e:
                # token-id streaming is model-shape-specific; a model
                # whose generate path can't take the dummy prompt
                # skips with the reason on record
                r["skipped"].append(f"generate: {e}")
                logger.info("aot warmup: generate warmup skipped for "
                            "%s: %s", name, e)
        r["seconds"] = round(time.perf_counter() - t0, 3)
        report[name] = r
    return report
