"""Steady-state compile accounting for the port: CUDA graph captures
(counterpart of ``GlobalCompileStats`` and ``SteadyStateCompileError``
in ``deeplearning4j_tpu/observability/compile_watch.py``).

In the JAX package a program is compiled by XLA at its first call, and
``zero_compile_scope`` proves that a post-warmup burst compiled nothing.
The port's compiled programs are CUDA graphs: the paged decode step
(``models/paged_kv.PagedSlotSession``) when serving, and the training
programs (``models/kstep.TrainProgram``: the step, the k-step window and
the tBPTT chunk step) when training, so here a capture is the compile and
a replay the cache hit. After ``ModelServer.warmup()`` or an executor's
``warmup``, a steady state that captures either kind raises.
:func:`install_global_watch` creates the process-wide
:class:`GlobalCompileStats`; the session reports each capture and replay
to it through :func:`record_capture` / :func:`record_replay`, which do
nothing until it is installed (as the JAX listeners see nothing until
they are registered). Installing registers its counters on the metrics
registry, so a default server's ``/metrics`` keeps the JAX server's
names.

Left out: ``watch()`` / ``CompileWatcher`` (per-function recompile-storm
trip-wires over ``jax.jit`` executable caches) and the
``jax.monitoring`` hooks (backend compiles, persistent-cache requests
and hits): PyTorch has no counterpart of either.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

__all__ = ["SteadyStateCompileError", "GlobalCompileStats",
           "install_global_watch", "record_capture", "record_replay"]


class SteadyStateCompileError(RuntimeError):
    """Raised by :meth:`GlobalCompileStats.zero_compile_scope` when a
    scope that promised zero captures (the post-warmup steady state)
    captured a graph anyway: a session escaped the warmup, or a new one
    was built after it (a new model version gets a new batcher)."""

    def __init__(self, msg: str, stats: dict):
        super().__init__(msg)
        self.stats = stats


class GlobalCompileStats:
    """Totals of the process's CUDA graph captures:

    - ``graph_captures`` / ``capture_secs``: graphs captured (the first
      step of each paged session, and each training program, on a card;
      the eager run before the capture included in the seconds);
    - ``graph_replays``: steps served by replaying a captured graph.

    ``cache_hit`` answers the JAX question "did this run reuse compiled
    programs?": True when steps replayed and nothing was captured."""

    def __init__(self, registry=None):
        if registry is None:
            from deeplearning4j_tpu_torch.observability.registry import (
                REGISTRY)
            registry = REGISTRY
        self._lock = threading.Lock()
        self.graph_captures = 0
        self.capture_secs = 0.0
        self.graph_replays = 0
        self._c_captures = registry.counter(
            "cuda_graph_captures_total",
            help="CUDA graph captures in this process")
        self._c_secs = registry.counter(
            "cuda_graph_capture_seconds_total",
            help="wall seconds spent capturing CUDA graphs")
        self._c_replays = registry.counter(
            "cuda_graph_replays_total",
            help="steps served by replaying a captured CUDA graph")

    def mark(self) -> dict:
        """Snapshot for delta accounting."""
        with self._lock:
            return {"graph_captures": self.graph_captures,
                    "capture_secs": self.capture_secs,
                    "graph_replays": self.graph_replays}

    def summary(self, since: Optional[dict] = None) -> dict:
        cur = self.mark()
        if since:
            cur = {k: (round(cur[k] - since[k], 3)
                       if isinstance(cur[k], float)
                       else cur[k] - since[k]) for k in cur}
        else:
            cur["capture_secs"] = round(cur["capture_secs"], 3)
        cur["cache_hit"] = self._cache_hit(cur)
        return cur

    @staticmethod
    def _cache_hit(s: dict) -> Optional[bool]:
        """True = steps ran on captured graphs with zero captures; None
        when nothing ran at all (no evidence either way)."""
        if s["graph_captures"] == 0 and s["graph_replays"] == 0:
            return None
        return s["graph_captures"] == 0

    @property
    def cache_hit(self) -> Optional[bool]:
        return self._cache_hit(self.mark())

    @contextlib.contextmanager
    def zero_compile_scope(self, what: str = "steady state"):
        """Assert that NOTHING in the scope captures a CUDA graph: the
        post-warmup contract. After ``ModelServer.warmup()`` captured
        every generate backend's step, a serving burst must run entirely
        on replays. Raises :class:`SteadyStateCompileError` with the
        deltas otherwise."""
        mark = self.mark()
        yield self
        s = self.summary(mark)
        if s["graph_captures"]:
            raise SteadyStateCompileError(
                f"{what}: {s['graph_captures']} CUDA graph capture(s) "
                f"({s['capture_secs']:.2f}s) inside a scope that "
                "promised zero after warmup — a session escaped the "
                "warmup or was rebuilt after it", s)

    def on_capture(self, secs: float) -> None:
        with self._lock:
            self.graph_captures += 1
            self.capture_secs += secs
        self._c_captures.inc()
        self._c_secs.inc(secs)

    def on_replay(self) -> None:
        with self._lock:
            self.graph_replays += 1
        self._c_replays.inc()


_GLOBAL_STATS: Optional[GlobalCompileStats] = None
_LOCK = threading.Lock()


def install_global_watch(registry=None) -> GlobalCompileStats:
    """Idempotently create and return the process-wide capture stats;
    captures and replays are counted from then on."""
    global _GLOBAL_STATS
    with _LOCK:
        if _GLOBAL_STATS is None:
            _GLOBAL_STATS = GlobalCompileStats(registry=registry)
        return _GLOBAL_STATS


def record_capture(secs: float) -> None:
    """A CUDA graph was captured in ``secs`` (no-op until installed)."""
    stats = _GLOBAL_STATS
    if stats is not None:
        stats.on_capture(secs)


def record_replay() -> None:
    """A step replayed a captured graph (no-op until installed)."""
    stats = _GLOBAL_STATS
    if stats is not None:
        stats.on_replay()
