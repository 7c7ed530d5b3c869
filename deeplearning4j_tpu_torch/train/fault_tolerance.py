"""Elastic, fault-tolerant training (counterpart of
``deeplearning4j_tpu/train/fault_tolerance.py``): :class:`ElasticTrainer`
around either executor of the port.

- periodic atomic checkpoints (tmp + rename; a kill mid-write never
  corrupts the latest checkpoint), pruned to ``keep`` newest;
- the data position (epoch, batch) and a rolling fingerprint chain of
  the batches consumed ride inside the checkpoint zip, so a resumed or
  rolled-back run fast-forwards the iterator to where the checkpointed
  model stopped, and a replay that differs fails loudly: kill at
  iteration k + resume equals the uninterrupted run;
- resume from the newest intact checkpoint on construction; every
  restore passes ``verify_checkpoint`` first, a corrupt generation is
  quarantined (``*.corrupt``, ``checkpoint_quarantined_total``) and the
  trainer falls back generation by generation; a failed write is a
  missed checkpoint (``checkpoint_write_failures_total``), not a dead
  run; stale ``*.tmp<pid>`` files of dead writers are swept on start;
- SIGTERM (handled on the main thread only) checkpoints and stops
  cleanly;
- a non-finite loss, or a HealthMonitor's rollback request, restores
  the last checkpoint, replays the batches in between and skips the one
  that diverged; the skip set is persisted, ``max_rollbacks`` bounds an
  incident and decays after ``heal_after`` healthy iterations, and
  ``lr_drop_on_rollback`` rebuilds the optimizer with a cooler rate
  (which drops the model's captured training programs);
- the ``train.step`` chaos site (the port's own ``chaos/``) fires
  before each step: crash, hang, nan poison, sigterm;
- ``async_checkpoint=True``: a save costs the train thread a
  device-to-host snapshot (``util/model_serializer.snapshot_model``);
  serialization, zip, manifest and rename run on one background writer
  (one write in flight, a newer save supersedes a queued one); ``fit``
  exit, the SIGTERM path and rollback barrier on it.
  ``checkpoint_write_seconds{phase="blocked"|"total"}`` splits what the
  train thread paid from what the write cost;
- ``steps_per_device_call=k`` (``_run_epoch_kstep``): windows of k
  batches through ``model.fit_batches`` (one k-step program call each),
  checkpoints only at window boundaries.

A restore copies the checkpoint's arrays into the model's live
parameter, state and updater tensors, so the model's captured training
programs stay valid across resumes and rollbacks. The checkpoints are
the JAX package's zips: a directory either package's trainer wrote
resumes in the other.

Data parallelism: ``mesh_spec=`` installs the spec on the model up front
(``use_mesh``, so a restore lands in the data-parallel replicas too) and
composes with ``steps_per_device_call``; ``wrapper=`` (a
``ParallelWrapper``) trains each batch through ``wrapper.fit_batch`` and
each window through ``wrapper.fit_batches``. Every rank runs its own
trainer over the same checkpoint directory: only the coordinator (rank
0) writes and sweeps it, every rank restores from it, and the ranks
meet at a barrier before a resume or a rollback reads it.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import re
import signal
import sys
import threading
import time
import zipfile
from typing import Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch import chaos
from deeplearning4j_tpu_torch.models.kstep import assign_tree

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ElasticTrainer", "CheckpointWriter"]

_CKPT_RE = re.compile(r"ckpt_(\d+)\.zip$")
_TMP_RE = re.compile(r"ckpt_\d+\.zip\.tmp(\d+)$")
_POS_ENTRY = "data_position.json"
_ITSTATE_ENTRY = "iterator_state.json"

# tmp files an async writer in THIS process is writing right now:
# the stale-tmp sweep must not treat a live same-pid write as a leak
# (a second trainer constructed in-process — the restart-in-process
# pattern — would otherwise delete it mid-write)
_LIVE_TMPS: set = set()
_LIVE_TMPS_LOCK = threading.Lock()


class _CheckpointWriter:
    """Single background checkpoint writer: at most ONE write in
    flight, with a depth-1 coalescing queue — a save submitted while
    a write is in flight SUPERSEDES any save still queued (the newest
    state is the only one worth persisting; an old queued snapshot is
    strictly stale). ``barrier()`` waits until both the in-flight and
    the queued write have drained and re-raises anything a write
    raised — the fit-exit / SIGTERM-grace / rollback sync point that
    turns "submitted" into "durable"."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = None          # the (single) queued job
        self._busy = False
        self._error: Optional[BaseException] = None
        self._closed = False
        self.superseded = 0           # queued saves dropped by newer
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, job) -> bool:
        """Queue ``job`` (a thunk); returns True when it replaced an
        older queued job. Raises any error a PREVIOUS write left
        behind, so a dying disk surfaces at the next save, not only
        at fit exit."""
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            if self._closed:
                raise RuntimeError("checkpoint writer is closed")
            replaced = self._pending is not None
            if replaced:
                self.superseded += 1
            self._pending = job
            self._cond.notify_all()
        return replaced

    def _run(self):
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    # heartbeat, not an unbounded block (GL008): the
                    # predicate loop re-checks closed/pending either
                    # way, and the writer thread stays interruptible
                    self._cond.wait(1.0)
                if self._pending is None:
                    return                      # closed and drained
                job, self._pending = self._pending, None
                self._busy = True
            try:
                job()
            except BaseException as e:          # surfaced at barrier
                with self._cond:
                    self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def idle(self) -> bool:
        with self._cond:
            return not self._busy and self._pending is None

    def barrier(self, timeout: Optional[float] = None) -> None:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._busy or self._pending is not None:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "checkpoint writer still busy after "
                        f"{timeout}s")
                self._cond.wait(remaining)
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def close(self, timeout: Optional[float] = None) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        with self._cond:
            if self._error is not None:
                err, self._error = self._error, None
                raise err


# public name for the async-checkpoint writer, as in the JAX package
CheckpointWriter = _CheckpointWriter


def _hash_array(h, a) -> None:
    a = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
         else np.asarray(a))
    flat = a.reshape(-1) if a.flags.c_contiguous else a.ravel()
    k = 256
    n = flat.size
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    for window in (flat[:k], flat[n // 2:n // 2 + k],
                   flat[max(0, n - k):]):
        h.update(np.ascontiguousarray(window).tobytes())


def _fingerprint(ds) -> str:
    """Cheap content fingerprint of a batch: shape + dtype + three
    sampled 1KB windows (head / middle / tail) of EVERY feature AND
    label array (all of them for a MultiDataSet). Labels are folded
    in deliberately: a replayed iterator that kept features but
    substituted or reordered labels would otherwise pass the
    determinism check and silently train on wrong targets. Sampling
    windows (not just the head) catches shared-BOS/padding layouts
    whose leading bytes are identical across batches; slicing views
    before ``tobytes`` keeps the copy small regardless of batch
    size."""
    h = hashlib.sha1()
    for group in (ds.features, getattr(ds, "labels", None)):
        if group is None:
            continue
        if not isinstance(group, (list, tuple)):
            group = (group,)
        h.update(b"|g%d" % len(group))
        for slot, a in enumerate(group):
            # per-slot marker even for None: [x, None, y] must not
            # fingerprint equal to [x, y, None]
            h.update(b"|s%d" % slot)
            if a is None:
                h.update(b"<none>")
            else:
                _hash_array(h, a)
    return h.hexdigest()


def _chain(prev: str, fp: str) -> str:
    """Rolling digest over consumed batches: order-sensitive, so a
    replay that reorders ANY prefix batch (not just the last one)
    mismatches."""
    return hashlib.sha1((prev + fp).encode()).hexdigest()


class ElasticTrainer:
    def __init__(self, model, checkpoint_dir: str, *,
                 save_every: int = 100, keep: int = 3,
                 max_rollbacks: int = 5, heal_after: Optional[int] = None,
                 handle_sigterm: bool = True, wrapper=None,
                 lr_drop_on_rollback: Optional[float] = None,
                 async_checkpoint: bool = False,
                 steps_per_device_call: int = 1,
                 mesh_spec=None):
        # async_checkpoint: take checkpoints OFF the train thread —
        # save_checkpoint snapshots params/opt-state device→host at
        # the step boundary (cheap) and hands serialization + zip +
        # manifest + atomic rename to a single background writer
        # (one in-flight write; a newer save supersedes a queued
        # one). fit() exit, the SIGTERM grace path, and rollback all
        # barrier on the writer, so "returned from fit" still means
        # "durable". checkpoint_write_seconds{phase=blocked|total}
        # makes the win measurable.
        # lr_drop_on_rollback: multiply the configured learning rate
        # by this factor (< 1) on every rollback — the standard
        # "restart from the last good checkpoint with a cooler LR"
        # move for repeated divergence. Rebuilding the optimizer
        # resets its state (momentum), which is exactly the restart
        # semantics wanted after a blow-up.
        # steps_per_device_call: k-step training (models/kstep.py) —
        # the trainer collects k batches per window (fingerprint /
        # skip-set / chaos still run PER LOGICAL STEP at collection
        # time), runs them as one k-step program via
        # ``model.fit_batches``, and
        # checkpoints only at window boundaries so the iterator
        # cursor always lands on a k-step boundary — preemption
        # resume stays bit-identical. Non-finite/rollback detection
        # lag is bounded by k (every step's loss still comes back).
        # NOTE on listener semantics: the k>1 path drives
        # ``model.fit_batches`` (no epoch hooks, ``epoch_count``
        # untouched), while the legacy k=1 path calls
        # ``model.fit(ds)`` per batch, which fires
        # on_epoch_start/on_epoch_end and bumps ``epoch_count`` once
        # PER BATCH — a historical quirk kept for checkpoint/test
        # compatibility. Params are unaffected either way; listeners
        # keying off epoch hooks see the (saner) windowed cadence
        # under k>1.
        self.model = model
        self.k = int(steps_per_device_call)
        if self.k < 1:
            # same contract as the executors' fit(): an invalid k
            # fails loudly everywhere instead of silently clamping
            # in one mode and crashing in another
            raise ValueError("steps_per_device_call must be >= 1")
        # mesh_spec: train data-parallel over a declarative mesh
        # ("dp=4" | dict | JSON — parallel/mesh_spec.py): the spec is
        # installed on the model up front (so a checkpoint restore lands
        # in the replicas too) and composes with steps_per_device_call.
        # Mutually exclusive with ``wrapper`` (two ways to state the
        # same parallelism).
        self.wrapper = wrapper
        if mesh_spec is not None:
            if wrapper is not None:
                raise ValueError(
                    "pass either mesh_spec (the executor's sharded "
                    "fit path) or wrapper (an explicit "
                    "ParallelWrapper), not both")
            model.use_mesh(mesh_spec)
        if wrapper is not None:
            if self.k > 1 and not wrapper.supports_fused_windows():
                # the compressed reduce has no fused k-step program —
                # failing loudly beats silently training with a
                # different cadence than the operator asked for
                raise ValueError(
                    "steps_per_device_call > 1 needs a wrapper mesh "
                    "that fuses (no dcn_compression); this wrapper's "
                    "mesh step is per-batch — drop the wrapper or use "
                    "steps_per_device_call=1")
            wrapper._place_model()
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.save_every = max(1, save_every)
        self.keep = max(1, keep)
        self.max_rollbacks = max_rollbacks
        self.heal_after = (save_every if heal_after is None
                           else max(1, heal_after))
        self.handle_sigterm = handle_sigterm
        self.lr_drop_on_rollback = lr_drop_on_rollback
        self.async_checkpoint = async_checkpoint
        self._writer_obj: Optional[_CheckpointWriter] = None
        self._active_iterator = None   # the fit() iterator, for state
        self._it_state: Optional[dict] = None  # restored, pending apply
        self.rollbacks = 0           # current incident (decays)
        self.total_rollbacks = 0     # lifetime (never decays)
        self._healthy_streak = 0
        self._stop_requested = False
        self._epoch = 0          # data position: epoch index
        self._batch = 0          # batches consumed within that epoch
        self._skip = set()       # (epoch, batch) ordinals to skip
        self._fp_chain = ""      # rolling digest of every batch
        #                          consumed this epoch (determinism
        #                          check on replay)
        self._sweep_stale_tmp()
        self._resume()

    # -- checkpoint plumbing ----------------------------------------------
    def _ckpts(self):
        out = []
        for f in os.listdir(self.dir):
            m = _CKPT_RE.match(f)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, f)))
        return sorted(out)

    def latest_checkpoint(self) -> Optional[str]:
        cks = self._ckpts()
        return cks[-1][1] if cks else None

    def _mesh(self):
        """The data-parallel context this trainer's steps run on (None
        on one device or off the mesh)."""
        ctx = (self.wrapper._ctx if self.wrapper is not None
               else getattr(self.model, "_mesh_ctx", None))
        return ctx if ctx is not None and ctx.member else None

    def _writes(self) -> bool:
        """Only the coordinator writes (and sweeps, and quarantines)
        the shared checkpoint directory under data parallelism."""
        if self._mesh() is None and self.wrapper is None:
            return True
        from deeplearning4j_tpu_torch.parallel.multihost import (
            is_coordinator)
        return is_coordinator()

    def _meet(self) -> None:
        """Every rank at one point: the coordinator's writes are on
        disk before any rank reads the directory."""
        ctx = self._mesh()
        if ctx is not None:
            ctx.barrier()

    def _sweep_stale_tmp(self) -> None:
        """A crash mid-``write_model`` leaks ``ckpt_N.zip.tmp<pid>``
        forever (the pid suffix means a restarted process never
        collides with, and so never cleans, the old name); sweep them
        on start — but only when the owning pid is dead, so a second
        trainer pointed at a shared directory can never delete a
        write another live process is mid-way through."""
        if not self._writes():
            return
        for f in os.listdir(self.dir):
            m = _TMP_RE.match(f)
            if not m:
                continue
            pid = int(m.group(1))
            path = os.path.join(self.dir, f)
            if pid != os.getpid():
                try:
                    os.kill(pid, 0)      # probe: is the owner alive?
                    continue             # yes — not ours to sweep
                except ProcessLookupError:
                    pass                 # dead owner: stale for sure
                except OSError:
                    continue             # EPERM etc.: assume alive
            else:
                with _LIVE_TMPS_LOCK:
                    if path in _LIVE_TMPS:
                        continue         # another trainer's writer is
                #                          mid-write IN THIS process
            try:
                os.remove(path)
                logger.info("swept stale checkpoint tmp %s", path)
            except OSError:
                pass

    def save_checkpoint(self):
        """Snapshot + persist the current generation. Sync mode
        returns the final path; async mode snapshots device→host,
        hands the write to the background writer and returns None
        (the path is knowable only after the rename — barrier via
        :meth:`checkpoint_barrier` when durability matters NOW).
        ``checkpoint_write_seconds{phase="blocked"}`` records what
        this call cost the train thread either way."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            snapshot_model)
        if not self._writes():
            return None             # the coordinator's replica is ours
        t0 = time.perf_counter()
        it = self.model.iteration_count
        # the data position rides in the same zip: one atomic artifact,
        # no model/position skew after a mid-write preemption; passing
        # it through the writer (not appending after) puts it under
        # the integrity manifest's CRC too
        pos = json.dumps(
            {"epoch": self._epoch, "batch": self._batch,
             # the poison-skip set rides in the checkpoint: a
             # restart after a rollback must not pay a second
             # rollback to rediscover a deterministic poison batch
             "skip": sorted(list(p) for p in self._skip),
             "fp_chain": self._fp_chain})
        extra = {_POS_ENTRY: pos}
        it_state = self._iterator_state()
        if it_state is not None:
            extra[_ITSTATE_ENTRY] = json.dumps(it_state)
        snap = snapshot_model(self.model)
        if self.async_checkpoint:
            # epoch/batch bound NOW: the writer runs later, when the
            # train thread has moved on
            self._writer().submit(
                lambda e=self._epoch, b=self._batch:
                self._write_generation(snap, extra, it, e, b))
            self._observe_write("blocked",
                                time.perf_counter() - t0)
            return None
        path = self._write_generation(snap, extra, it, self._epoch,
                                      self._batch)
        self._observe_write("blocked", time.perf_counter() - t0)
        return path

    def _iterator_state(self) -> Optional[dict]:
        """The active iterator's checkpointable state — persisted
        only when its cursor agrees with the trainer's batch ordinal
        (right after a rollback the iterator still sits at the crash
        position while the trainer has been restored; persisting that
        skew would corrupt a later resume — omit it and let that one
        generation fall back to replay)."""
        # a rollback re-checkpoints BEFORE the fit loop repositions
        # the iterator: the state restored from the rolled-back-to
        # zip (pending in _it_state) is the truthful position then —
        # persisting it keeps even that generation state-resumable
        if (self._it_state is not None
                and int(self._it_state.get("cursor", -1))
                == self._batch):
            return self._it_state
        src = self._active_iterator
        sd = getattr(src, "state_dict", None)
        if not callable(sd):
            return None
        try:
            st = sd()
        except Exception:
            logger.exception("iterator state_dict() failed; "
                             "checkpoint will resume via replay")
            return None
        if st is None or int(st.get("cursor", -1)) != self._batch:
            return None
        return st

    def _write_generation(self, snap, extra, it, epoch, batch):
        """Serialize + zip + manifest + atomic rename + prune: the
        shared tail of sync and async saves (async runs it on the
        writer thread). ``checkpoint_write_seconds{phase="total"}``
        records the full cost wherever it runs."""
        final = os.path.join(self.dir, f"ckpt_{it}.zip")
        tmp = final + f".tmp{os.getpid()}"
        t0 = time.perf_counter()
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_snapshot)
        with _LIVE_TMPS_LOCK:
            _LIVE_TMPS.add(tmp)
        try:
            try:
                write_snapshot(snap, tmp, extra_entries=extra)
                os.replace(tmp, final)      # atomic on POSIX
            finally:
                with _LIVE_TMPS_LOCK:
                    _LIVE_TMPS.discard(tmp)
        except OSError as e:
            # ENOSPC / quota / dying disk mid-write: a missed
            # checkpoint must not kill the run — clean the partial
            # tmp, count it, and keep training on the previous
            # generation
            try:
                os.remove(tmp)
            except OSError:
                pass
            self._count("checkpoint_write_failures_total",
                        "checkpoint writes that failed (ENOSPC, ...)")
            logger.warning("checkpoint write at iteration %d failed "
                           "(%r); continuing on the previous "
                           "generation", it, e)
            return None
        self._observe_write("total", time.perf_counter() - t0)
        # mark live trainer checkpoints protected so a co-attached
        # CheckpointListener's keep_last pruning can never delete the
        # file a rollback is about to restore
        from deeplearning4j_tpu_torch.train import listeners as _listeners
        _listeners.protect_checkpoint(final)
        # pruning runs on whichever thread wrote the generation (the
        # writer thread in async mode — the only thread touching
        # checkpoint files there, so keep-pruning can never race an
        # in-flight tmp); _CKPT_RE matches finals only, never tmps
        for _, path in self._ckpts()[:-self.keep]:
            try:
                os.remove(path)
            except OSError:
                pass
            _listeners.unprotect_checkpoint(path)
        logger.info("checkpoint at iteration %d (epoch %d, batch %d) "
                    "-> %s", it, epoch, batch, final)
        return final

    def _writer(self) -> _CheckpointWriter:
        if self._writer_obj is None:
            self._writer_obj = _CheckpointWriter()
        return self._writer_obj

    def checkpoint_barrier(self,
                           timeout: Optional[float] = None) -> None:
        """Wait until no checkpoint write is queued or in flight;
        re-raises writer errors. No-op in sync mode."""
        if self._writer_obj is not None:
            self._writer_obj.barrier(timeout)

    def close(self) -> None:
        """Drain and stop the background writer (if any)."""
        if self._writer_obj is not None:
            w, self._writer_obj = self._writer_obj, None
            w.close()

    @staticmethod
    def _observe_write(phase: str, seconds: float) -> None:
        try:
            from deeplearning4j_tpu_torch.observability.registry import (
                REGISTRY)
            REGISTRY.histogram(
                "checkpoint_write_seconds",
                help="checkpoint write time: phase=blocked is what "
                     "the train thread paid (snapshot + handoff in "
                     "async mode; the whole write in sync mode), "
                     "phase=total the full serialize+zip+rename",
                labels={"phase": phase}).record(seconds)
        except Exception:
            pass

    @staticmethod
    def _count(name: str, help: str) -> None:
        from deeplearning4j_tpu_torch.observability.registry import safe_inc
        safe_inc(name, help=help)

    def _restore_into_model(self, path: str):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model, verify_checkpoint)
        verify_checkpoint(path)    # CRC gate BEFORE trusting the zip
        loaded = restore_model(path, device="cpu")
        m = self.model
        if m.params is None:
            m.init()
        # copied INTO the live tensors (host to device), so the
        # model's captured training programs keep their addresses
        with torch.no_grad():
            assign_tree(m.params, loaded.params)
            assign_tree(m.state, loaded.state)
            assign_tree(m.opt_state, loaded.opt_state)
        m.iteration_count = loaded.iteration_count
        m.epoch_count = loaded.epoch_count
        self._it_state = None
        try:
            with zipfile.ZipFile(path, "r") as z:
                pos = json.loads(z.read(_POS_ENTRY))
                if _ITSTATE_ENTRY in z.namelist():
                    self._it_state = json.loads(z.read(_ITSTATE_ENTRY))
            self._epoch = int(pos["epoch"])
            self._batch = int(pos["batch"])
            # MERGE the persisted skip set (a rollback restores an
            # older checkpoint whose zip may predate the newest skip
            # entry — skips are monotone within an incident)
            self._skip |= {tuple(p) for p in pos.get("skip", [])}
            self._fp_chain = pos.get("fp_chain") or ""
        except (KeyError, json.JSONDecodeError):
            # pre-position checkpoint (older format): restart the epoch
            self._epoch, self._batch = 0, 0
            self._it_state = None

    def _quarantine(self, path: str, err: BaseException) -> None:
        """Rename a checkpoint that failed verification/restore to
        ``*.corrupt`` — out of the generation sequence (so fallback
        terminates) but kept on disk as evidence."""
        from deeplearning4j_tpu_torch.train import listeners as _listeners
        if not self._writes():
            return              # the coordinator quarantines it
        q = path + ".corrupt"
        logger.warning("checkpoint %s failed integrity/restore (%r): "
                       "quarantining as %s and falling back to the "
                       "previous generation", path, err, q)
        try:
            os.replace(path, q)
        except FileNotFoundError:
            return              # already gone — nothing to quarantine
        except OSError:
            # last resort: a file we can neither rename nor remove
            # would make the fallback loop spin forever
            try:
                os.remove(path)
            except FileNotFoundError:
                return
        _listeners.unprotect_checkpoint(path)
        self._count("checkpoint_quarantined_total",
                    "corrupt/truncated checkpoints quarantined on "
                    "restore")

    def _restore_latest_intact(self) -> Optional[str]:
        """Restore the newest checkpoint that passes verification,
        quarantining corrupt generations on the way down; None when
        no intact generation remains."""
        from deeplearning4j_tpu_torch.chaos.retry import DEFAULT_IO_RETRY
        from deeplearning4j_tpu_torch.util.model_serializer import (
            CheckpointIntegrityError)
        while True:
            path = self.latest_checkpoint()
            if path is None:
                return None
            try:
                # transient read errors (NFS blip, injected IOError)
                # get the shared retry policy FIRST — a healthy file
                # must not be quarantined for a flaky read
                DEFAULT_IO_RETRY.call(self._restore_into_model, path)
                return path
            except (CheckpointIntegrityError, zipfile.BadZipFile,
                    OSError, KeyError, ValueError) as e:
                # BadZipFile/OSError/ValueError: rot the CRC gate
                # could not see (or chaos injected mid-read);
                # KeyError: arrays missing vs this model's config
                self._quarantine(path, e)

    def _resume(self):
        self._meet()
        if not self._ckpts():
            return
        if self.model.params is None:
            self.model.init()
        path = self._restore_latest_intact()
        if path is None:
            logger.warning("no intact checkpoint in %s; starting "
                           "fresh", self.dir)
            return
        logger.info("resumed from %s (iteration %d, epoch %d, "
                    "batch %d)", path, self.model.iteration_count,
                    self._epoch, self._batch)

    # -- the loop -----------------------------------------------------------
    def fit(self, iterator, *, epochs: int = 1,
            until_epoch: Optional[int] = None) -> "ElasticTrainer":
        """``epochs`` is RELATIVE (train N more epochs from wherever
        the trainer is — a resumed trainer continues); ``until_epoch``
        is an ABSOLUTE target epoch index: rerunning the same
        ``fit(until_epoch=N)`` command after a kill produces exactly
        the uninterrupted run (restart == uninterrupted)."""
        target = (self._epoch + max(0, epochs)
                  if until_epoch is None else until_epoch)
        model = self.model
        if model.params is None:
            model.init()
        prev_handler = None
        if (self.handle_sigterm
                and threading.current_thread() is threading.main_thread()):
            def on_term(signum, frame):
                # preemption grace window: persist, then stop cleanly
                self._stop_requested = True
            prev_handler = signal.signal(signal.SIGTERM, on_term)
        elif self.handle_sigterm:
            logger.info("fit() on a non-main thread: SIGTERM handler "
                        "not installed (signal.signal would raise)")
        try:
            self._active_iterator = iterator
            if self.latest_checkpoint() is None:
                self.save_checkpoint()       # iteration-0 restart point
            while self._epoch < target and not self._stop_requested:
                # STATEFUL RESUME: an iterator implementing the
                # state_dict/load_state_dict protocol is repositioned
                # directly to the checkpointed cursor — O(1)-ish, no
                # batch replay, and no deterministic-iterator
                # requirement (the state pins the epoch's rng). The
                # fingerprint-replay fast-forward below remains the
                # fallback for stateless iterators.
                state_resumed = False
                if (self._batch and self._it_state is not None
                        and hasattr(iterator, "load_state_dict")):
                    try:
                        iterator.load_state_dict(self._it_state)
                        state_resumed = True
                        logger.info(
                            "iterator state restored (epoch %d, "
                            "cursor %d): resuming without replay",
                            self._epoch, self._batch)
                    except NotImplementedError:
                        pass
                elif hasattr(iterator, "load_state_dict"):
                    # PIN the iterator's epoch to the trainer's own
                    # counter: the shuffle permutation becomes a pure
                    # function of (seed, trainer epoch), identical in
                    # an uninterrupted run and in any restart — a
                    # fresh process's iterator would otherwise count
                    # resets from zero and replay old permutations
                    # (epoch-boundary restarts, replay after a
                    # rollback-skewed save)
                    try:
                        iterator.load_state_dict(
                            {"cursor": 0, "epoch": self._epoch + 1})
                    except NotImplementedError:
                        pass
                self._it_state = None
                if hasattr(iterator, "reset"):
                    iterator.reset()
                it = iter(iterator)
                # fast-forward a resumed/rolled-back run to the
                # checkpointed batch — restart == uninterrupted for a
                # deterministic iterator; the rolling fingerprint
                # chain CHECKS that contract over EVERY replayed
                # ordinal (any reorder or shortfall mismatches)
                fwd_chain = ""
                replayed = 0
                for k in range(0 if state_resumed else self._batch):
                    ds = next(it, None)
                    if ds is None:
                        fwd_chain = None
                        break
                    replayed = k + 1
                    fwd_chain = _chain(fwd_chain, _fingerprint(ds))
                if fwd_chain is None:
                    # a shortfall is ITS OWN failure mode — the
                    # iterator ran dry before reaching the
                    # checkpointed position (dataset shrank, wrong
                    # file, truncated shard); calling that
                    # "non-deterministic" sends the operator
                    # debugging shuffle seeds instead of the data
                    raise RuntimeError(
                        f"iterator shorter than checkpointed "
                        f"position: the resume fast-forward for "
                        f"epoch {self._epoch} needed {self._batch} "
                        f"batches but the iterator yielded only "
                        f"{replayed} — the data source shrank (or "
                        f"the wrong one was passed) since the "
                        f"checkpoint was written")
                if (not state_resumed and self._batch
                        and self._fp_chain
                        and fwd_chain != self._fp_chain):
                    raise RuntimeError(
                        f"iterator is not deterministic: the "
                        f"{self._batch} batches replayed for epoch "
                        f"{self._epoch} differ from the ones consumed "
                        f"before the restart — the replay "
                        f"fast-forward requires a same-order iterator "
                        f"(disable shuffling or seed it per-epoch)")
                if self.k > 1:
                    rolled_back = self._run_epoch_kstep(it)
                    if rolled_back or self._stop_requested:
                        continue
                    self._epoch += 1
                    self._batch = 0
                    self._fp_chain = ""
                    continue
                rolled_back = False
                while True:
                    # check BEFORE pulling: a batch fetched after the
                    # stop request would never train, but it would
                    # advance a stateful iterator's cursor past the
                    # trainer's position and cost the grace
                    # checkpoint its iterator state
                    if self._stop_requested:
                        break
                    ds = next(it, None)
                    if ds is None:
                        break
                    self._fp_chain = _chain(self._fp_chain,
                                            _fingerprint(ds))
                    if (self._epoch, self._batch) in self._skip:
                        self._batch += 1     # the poisoned batch
                        continue
                    # chaos site: crash raises (a simulated
                    # preemption — resume must reproduce the
                    # uninterrupted run), hang sleeps, nan poisons
                    # this one batch (exercising the rollback path)
                    ds = self._chaos_step(ds)
                    try:
                        if self.wrapper is not None:
                            # fit_batch, not fit([ds]): the trainer
                            # owns the epoch loop
                            self.wrapper.fit_batch(ds)
                        else:
                            model.fit(ds)
                    except Exception as e:
                        # HealthMonitor's rollback policy raises a
                        # rollback-flagged TrainingDivergedError from
                        # the listener chain: restore the last good
                        # checkpoint and continue, same as a
                        # non-finite loss. Anything else propagates.
                        if not getattr(e, "rollback", False):
                            raise
                        self._batch += 1     # batch was consumed
                        logger.warning(
                            "health monitor requested rollback: %s", e)
                        self._rollback()
                        rolled_back = True
                        break
                    self._batch += 1
                    loss = float(model.score_value)
                    if not np.isfinite(loss):
                        self._rollback()
                        rolled_back = True
                        break            # re-enter at restored position
                    self._healthy_streak += 1
                    if (self.rollbacks
                            and self._healthy_streak >= self.heal_after):
                        self.rollbacks = 0   # incident over
                    if model.iteration_count % self.save_every == 0:
                        self.save_checkpoint()
                if rolled_back or self._stop_requested:
                    continue
                self._epoch += 1
                self._batch = 0
                self._fp_chain = ""
            if self._stop_requested:
                # the preemption grace protocol: the snapshot is
                # taken HERE (immediately), the persist rides the
                # background writer (async mode), and the barrier in
                # the finally below guarantees durability before fit
                # returns — signal → snapshot → persist → clean stop
                self.save_checkpoint()
                logger.warning("stop requested (preemption?): "
                               "checkpointed at iteration %d",
                               model.iteration_count)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            self._active_iterator = None
            # returning from fit() means every submitted checkpoint
            # is durable (and surfaces any write error — a crash
            # injected into the writer thread re-raises here, dying
            # exactly as the preempted process would); when fit is
            # ALREADY unwinding an exception, the writer error must
            # not mask it
            if sys.exc_info()[0] is None:
                self.checkpoint_barrier()
            else:
                try:
                    self.checkpoint_barrier()
                except BaseException:
                    logger.exception("checkpoint writer failed "
                                     "during fit-exception unwind")
        return self

    def _run_epoch_kstep(self, it) -> bool:
        """Window-at-a-time epoch body for ``steps_per_device_call=k``:
        collect up to k batches (fingerprint chain, skip set and the
        ``train.step`` chaos site all run PER LOGICAL STEP, exactly as
        in the per-step loop), dispatch them as ONE fused device call
        via ``model.fit_batches``, then inspect every step's loss.
        Checkpoints happen only between windows — the iterator cursor
        always agrees with ``self._batch`` there. A SIGTERM closes
        the window under collection early (the partial window trains
        through the pre-compiled k=1 program), so the grace
        checkpoint lands within about one step of the signal, same as
        the per-step loop. Returns True when a rollback was taken
        (the caller restarts the epoch from the restored
        position)."""
        model = self.model
        k = self.k
        while True:
            if self._stop_requested:
                return False
            window = []                      # [(ordinal, ds)]
            exhausted = False
            while len(window) < k:
                # honor a SIGTERM mid-collection: close the window
                # early (a partial window trains through the k=1
                # program) so the grace checkpoint lands within ~one
                # step, like the per-step loop — the cursor still
                # equals the trained count and fused vs single-step
                # are bit-identical, so resume is unaffected
                if self._stop_requested:
                    break
                ds = next(it, None)
                if ds is None:
                    exhausted = True
                    break
                self._fp_chain = _chain(self._fp_chain,
                                        _fingerprint(ds))
                ordinal = self._batch
                self._batch += 1
                if (self._epoch, ordinal) in self._skip:
                    continue                 # the poisoned batch
                ds = self._chaos_step(ds)
                window.append((ordinal, ds))
            if window:
                it_before = model.iteration_count
                try:
                    # full windows run as one k-step program; the
                    # epoch tail (len < k) through the k=1 program
                    fit_batches = (self.wrapper.fit_batches
                                   if self.wrapper is not None
                                   else model.fit_batches)
                    losses = fit_batches([d for _, d in window],
                                         steps_per_device_call=k)
                except Exception as e:
                    if not getattr(e, "rollback", False):
                        raise
                    # HealthMonitor raised from the listener pass at
                    # some sub-step: the executor stamps the live
                    # window entry on _window_batch_index (NOT
                    # derivable from iteration deltas — a tBPTT entry
                    # advances the iteration counter once per chunk)
                    try:
                        idx = int(getattr(model, "_window_batch_index",
                                          0))
                    except (TypeError, ValueError):
                        idx = 0
                    idx = min(max(idx, 0), len(window) - 1)
                    logger.warning(
                        "health monitor requested rollback: %s", e)
                    self._rollback(
                        skip_ordinal=(self._epoch, window[idx][0]))
                    return True
                bad = np.flatnonzero(~np.isfinite(
                    np.asarray(losses, dtype=np.float64)))
                if bad.size:
                    # first non-finite step in the window: skip THAT
                    # ordinal on replay (later window steps trained on
                    # garbage params, but the rollback recomputes them
                    # from the restored checkpoint — same trajectory
                    # the per-step loop produces)
                    self._rollback(skip_ordinal=(
                        self._epoch, window[int(bad[0])][0]))
                    return True
                self._healthy_streak += len(window)
                if (self.rollbacks
                        and self._healthy_streak >= self.heal_after):
                    self.rollbacks = 0       # incident over
                if (it_before // self.save_every
                        != model.iteration_count // self.save_every):
                    # the save cadence was crossed inside the window:
                    # checkpoint at the boundary, where the iterator
                    # cursor equals self._batch and iterator state
                    # rides the zip
                    self.save_checkpoint()
            if exhausted:
                return False

    @staticmethod
    def _chaos_step(ds):
        f = chaos.step_fault("train.step")
        if f is not None and f.kind == "sigterm":
            # a REAL preemption drill: deliver SIGTERM to the process
            # at the seeded ordinal. Under fit()'s handler this takes
            # the grace path (snapshot → persist → clean stop); with
            # no handler installed it kills the process, exactly like
            # the cloud scheduler would
            os.kill(os.getpid(), signal.SIGTERM)
        if f is not None and f.kind == "nan":
            # poison one element of this batch's features (the
            # nan_injection drill, plan-driven): copy-on-write so the
            # source iterator's batch — which the rollback replay
            # will re-fetch — stays clean
            feats = ds.features
            arr = feats[0] if isinstance(feats, (list, tuple)) \
                else feats
            arr = np.array(arr)
            arr.flat[0] = np.nan
            ds = copy.copy(ds)
            if isinstance(feats, (list, tuple)):
                ds.features = type(feats)(
                    [arr] + list(feats[1:]))
            else:
                ds.features = arr
        return ds

    def _rollback(self, skip_ordinal=None):
        self.rollbacks += 1
        self.total_rollbacks += 1
        self._healthy_streak = 0
        if self.rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"non-finite loss persisted through "
                f"{self.max_rollbacks} rollbacks — aborting (bad data "
                f"or divergent learning rate)")
        logger.warning("non-finite loss at iteration %d: rolling back "
                       "(rollback %d/%d)",
                       self.model.iteration_count, self.rollbacks,
                       self.max_rollbacks)
        # the batch that produced the non-finite loss: skip it on
        # replay, replay everything else. Per-step callers leave the
        # default (the batch just consumed, ordinal _batch - 1); the
        # k-step window path passes the exact in-window ordinal.
        if skip_ordinal is None:
            skip_ordinal = (self._epoch, self._batch - 1)
        self._skip.add(skip_ordinal)
        # an async save may still be in flight — it IS the newest
        # generation; restoring before it lands would silently roll
        # back further than necessary
        self.checkpoint_barrier()
        self._meet()
        # generation-by-generation fallback: a corrupt newest
        # checkpoint must cost one quarantine, not the run
        path = self._restore_latest_intact()
        if path is None:
            raise RuntimeError("non-finite loss and no intact "
                               "checkpoint to roll back to")
        logger.warning("rolled back to %s", path)
        if self.lr_drop_on_rollback:
            self._drop_lr(self.lr_drop_on_rollback)
        # immediately persist the restored state WITH the new skip
        # entry (same iteration ordinal — overwrites in place): a kill
        # right after this rollback resumes skip-aware instead of
        # paying a second rollback to rediscover the poison batch
        self.save_checkpoint()

    def _drop_lr(self, factor: float) -> None:
        """Scale the configured learning rate and rebuild the
        optimizer (restart-with-cooler-LR; optimizer state resets by
        design — the restored momentum pointed at the blow-up)."""
        try:
            cfg = self.model.conf.conf.updater_cfg
            if cfg is None:
                # no explicit updater: the executor trains with the
                # default sgd() — materialize it so the drop applies
                # instead of silently doing nothing
                from deeplearning4j_tpu_torch.nn.conf import updaters
                cfg = updaters.sgd()
                self.model.conf.conf.updater_cfg = cfg
            if not cfg.get("lr"):
                logger.warning(
                    "rollback LR drop skipped: updater config %r has "
                    "no 'lr' to scale", cfg.get("type"))
                return
            old = cfg["lr"]
            cfg["lr"] = old * factor
            if hasattr(self.model, "_build_optimizer"):
                self.model._build_optimizer()
            logger.warning("rollback LR drop: %g -> %g", old,
                           cfg["lr"])
        except Exception:
            logger.exception("LR drop after rollback failed")
