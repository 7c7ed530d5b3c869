"""Training-health monitor: detect diverging runs and act on them
(counterpart of ``deeplearning4j_tpu/observability/health.py``).

Two detection planes, as in the JAX package:

1. **Device plane: the fused finite check.** :func:`fused_health` runs
   inside the training step (the captured CUDA graph on a card) and
   folds loss, gradients, updates and post-update params into one
   float32 vector ``[finite_bits, loss, grad_norm, update_norm,
   param_norm]``, with no host read. ``finite_bits`` is a bitmask
   (BIT_LOSS | BIT_GRADS | BIT_UPDATES | BIT_PARAMS), so a trip says
   which stage went non-finite. The monitor fetches the vector once a
   step; under k-step training (``fit(steps_per_device_call=k)``,
   ``models/kstep.py``) the executor fetches the ``[k, 5]`` block once
   a window and hands this listener one row a step, so every step is
   still inspected.

2. **Host plane: sliding-window detectors** over the scalar stream and
   a stats pipe (``put_update``): loss divergence and plateau,
   gradient-norm explosion and vanishing, the update:param ratio, the
   dead-activation fraction.

Each detector resolves to a **policy**: ``warn`` (log and record),
``raise`` (abort with :class:`TrainingDivergedError`) or ``rollback``
(a rollback-flagged error that ``train/fault_tolerance.ElasticTrainer``
catches to restore the last good checkpoint and continue). The host
code is the JAX package's, with the imports renamed.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.parallel import tensor_parallel
from deeplearning4j_tpu_torch.train.listeners import TrainingListener

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["TrainingDivergedError", "HealthMonitor", "fused_health",
           "BIT_LOSS", "BIT_GRADS", "BIT_UPDATES", "BIT_PARAMS"]

# fused_health vector layout
H_BITS, H_LOSS, H_GRAD_NORM, H_UPDATE_NORM, H_PARAM_NORM = range(5)

# finite_bits bitmask: which stage of the step went non-finite
BIT_LOSS, BIT_GRADS, BIT_UPDATES, BIT_PARAMS = 1, 2, 4, 8

_POLICIES = ("warn", "raise", "rollback")


class TrainingDivergedError(RuntimeError):
    """Training health check tripped (NaN/Inf, divergence, gradient
    blow-up...). ``rollback`` marks the error as a rollback request:
    ``ElasticTrainer.fit`` catches those, restores the last good
    checkpoint and continues; without a trainer it propagates."""

    def __init__(self, msg: str, anomaly: Optional[dict] = None,
                 rollback: bool = False):
        super().__init__(msg)
        self.anomaly = anomaly
        self.rollback = rollback


def fused_health(loss, grads, updates, params) -> torch.Tensor:
    """The health vector of one step, built on the device inside it:
    float32 ``[finite_bits, loss, |grads|, |updates|, |params|]``
    (global L2 norms). No host read: the executor copies it into the
    captured step's static output, and the monitor fetches the vector
    once (the JAX package's ``fused_health``).

    Under tensor parallelism (an update inside
    ``tensor_parallel.sharded_norms``) the norms and finiteness are the
    full arrays': the split leaves' squared sums and non-finite counts
    of the three trees go in one all-reduce over the model group, and
    each replicated leaf is counted once. Every rank of the group then
    builds the vector, so every rank attaches the listener that wants
    it."""
    loss = loss.detach().float()
    trees = (grads, updates, params)
    dims = tensor_parallel.norm_dims()
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    split = [[zero, zero] for _ in trees]
    whole = [[zero, zero] for _ in trees]
    for t, tree in enumerate(trees):
        for a, d in tensor_parallel.leaf_dims(tree, dims):
            if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
                continue
            acc = whole[t] if d is None else split[t]
            acc[0] = acc[0] + torch.sum(torch.square(a.float()))
            acc[1] = acc[1] + (~torch.isfinite(a)).sum().float()
    part = tensor_parallel.model_sum_(torch.stack(
        [v for pair in split for v in pair]))
    total = part + torch.stack([v for pair in whole for v in pair])
    sq, bad = total[0::2], total[1::2]

    def bit(ok, value):
        return torch.where(ok, 0.0, float(value))

    bits = (bit(torch.isfinite(loss), BIT_LOSS)
            + bit(bad[0] == 0, BIT_GRADS)
            + bit(bad[1] == 0, BIT_UPDATES)
            + bit(bad[2] == 0, BIT_PARAMS))
    return torch.stack([bits, loss, torch.sqrt(sq[0]), torch.sqrt(sq[1]),
                        torch.sqrt(sq[2])])


def _bit_names(bits: int) -> str:
    parts = [name for bit, name in ((BIT_LOSS, "loss"),
                                    (BIT_GRADS, "gradients"),
                                    (BIT_UPDATES, "updates"),
                                    (BIT_PARAMS, "params"))
             if bits & bit]
    return "+".join(parts) or "?"


class HealthMonitor(TrainingListener):
    """Training listener that watches, then acts.

    Attach with ``model.add_listeners(HealthMonitor(...))``; the
    executors see ``wants_device_health`` and compile the fused
    finite check into the train step. A tensor-parallel model's check
    is collective over its model group: every rank of the group
    attaches the monitor. Optionally chain it into the
    stats pipe (``storage=`` forwards every report after inspecting
    it) and hand it a ``recorder`` (FlightRecorder) so every anomaly
    lands in the post-mortem ring.

    ``policy`` is the default for the hard detectors (``non_finite``,
    ``loss_divergence``, ``grad_explosion``); advisory detectors
    (``loss_plateau``, ``grad_vanish``, ``update_ratio``,
    ``dead_activations``) default to ``warn``. Override any of them
    per-detector via ``policies={"loss_plateau": "raise", ...}``.
    """

    # executors check this flag to build the fused finite check into
    # the (captured) train step
    wants_device_health = True

    _ADVISORY = ("loss_plateau", "grad_vanish", "update_ratio",
                 "dead_activations")

    def __init__(self, policy: str = "warn", *,
                 policies: Optional[Dict[str, str]] = None,
                 window: int = 25,
                 divergence_factor: float = 4.0,
                 divergence_patience: int = 3,
                 plateau_window: int = 50, plateau_tol: float = 1e-5,
                 grad_explosion: float = 1e4,
                 grad_spike_factor: float = 100.0,
                 grad_vanish: float = 1e-10, vanish_patience: int = 5,
                 ratio_band=(1e-6, 1e-1), ratio_patience: int = 3,
                 dead_threshold: float = 0.9, dead_eps: float = 1e-7,
                 check_activations_every: int = 0,
                 warn_interval: Optional[int] = None,
                 heal_after: int = 100,
                 storage=None, recorder=None, registry=None,
                 history_limit: int = 256):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}")
        for k, v in (policies or {}).items():
            if v not in _POLICIES:
                raise ValueError(f"policy for {k!r} must be one of "
                                 f"{_POLICIES}, got {v!r}")
        self.policy = policy
        self.policies = dict(policies or {})
        self.window = max(2, window)
        self.divergence_factor = divergence_factor
        self.divergence_patience = max(1, divergence_patience)
        self.plateau_window = max(4, plateau_window)
        self.plateau_tol = plateau_tol
        self.grad_explosion = grad_explosion
        self.grad_spike_factor = grad_spike_factor
        self.grad_vanish = grad_vanish
        self.vanish_patience = max(1, vanish_patience)
        self.ratio_low, self.ratio_high = ratio_band
        self.ratio_patience = max(1, ratio_patience)
        self.dead_threshold = dead_threshold
        self.dead_eps = dead_eps
        self.check_activations_every = check_activations_every
        self.warn_interval = (self.window if warn_interval is None
                              else max(1, warn_interval))
        # a trip/anomaly stops coloring status() after this many
        # healthy iterations — a run that ElasticTrainer rolled back
        # and healed must not stay "diverged" on the dashboard
        self.heal_after = max(1, heal_after)
        self.storage = storage
        self.recorder = recorder
        if registry is None:
            from deeplearning4j_tpu_torch.observability.registry import REGISTRY
            registry = REGISTRY
        self.registry = registry
        # -- state --
        self.anomalies = collections.deque(maxlen=history_limit)
        self.last: Dict[str, object] = {}
        self.device_fetches = 0      # one per step with the fused path
        self.tripped = False         # a raise/rollback-level trip fired
        self._tripped_at: Optional[int] = None
        self._last_anomaly_at: Optional[int] = None
        self._losses = collections.deque(
            maxlen=max(self.window, self.plateau_window))
        self._gnorms = collections.deque(maxlen=self.window)
        self._best: Optional[float] = None
        self._div_streak = 0
        self._vanish_streak = 0
        self._ratio_streak = 0
        self._warn_mark: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # policy plumbing
    # ------------------------------------------------------------------
    def _policy_for(self, kind: str) -> str:
        if kind in self.policies:
            return self.policies[kind]
        if kind in self._ADVISORY:
            return "warn"
        return self.policy

    def _trip(self, kind: str, msg: str, iteration: int,
              value=None) -> None:
        pol = self._policy_for(kind)
        if pol == "warn":
            # de-spam: a plateaued loss stays plateaued every step —
            # one warning per warn_interval per detector
            mark = self._warn_mark.get(kind)
            if mark is not None and iteration - mark < self.warn_interval:
                return
            self._warn_mark[kind] = iteration
        anomaly = {"kind": kind, "iteration": int(iteration),
                   "message": msg, "value": value,
                   "policy": pol, "time": time.time()}
        self.anomalies.append(anomaly)
        self._last_anomaly_at = int(iteration)
        try:
            self.registry.counter(
                "training_anomalies_total",
                help="health-monitor anomalies by detector",
                labels={"type": kind}).inc()
        except Exception:
            pass
        if self.recorder is not None:
            try:
                self.recorder.on_anomaly(anomaly)
            except Exception:
                logger.exception("flight recorder rejected anomaly")
        if pol == "warn":
            logger.warning("health: %s", msg)
            return
        self.tripped = True
        self._tripped_at = int(iteration)
        raise TrainingDivergedError(msg, anomaly=anomaly,
                                    rollback=(pol == "rollback"))

    # ------------------------------------------------------------------
    # per-step path (listener chain)
    # ------------------------------------------------------------------
    def iteration_done(self, model, iteration, score, batch_size):
        vec = getattr(model, "_last_health", None)
        if vec is not None:
            # THE one extra device→host transfer for this step: the
            # whole fused vector in a single fetch. No per-leaf sync.
            arr = (vec.detach().cpu().numpy()
                   if isinstance(vec, torch.Tensor) else np.asarray(vec))
            self.device_fetches += 1
            bits = int(arr[H_BITS])
            loss = float(arr[H_LOSS])
            gnorm = float(arr[H_GRAD_NORM])
            unorm = float(arr[H_UPDATE_NORM])
            pnorm = float(arr[H_PARAM_NORM])
        else:
            # non-fused path (tBPTT chunks, foreign executors): the
            # score scalar is all we can check without extra syncs
            loss = float(score)
            bits = 0 if np.isfinite(loss) else BIT_LOSS
            gnorm = unorm = pnorm = None
        self.last = {"iteration": int(iteration), "loss": loss,
                     "finite_bits": bits, "grad_norm": gnorm,
                     "update_norm": unorm, "param_norm": pnorm,
                     "time": time.time()}
        if bits:
            self._trip(
                "non_finite",
                f"non-finite {_bit_names(bits)} at iteration "
                f"{iteration} (bits={bits})", iteration, value=bits)
            return    # windows would only accumulate garbage
        # heal: after a rollback the run may be healthy again — a
        # trip stops coloring status() once enough clean steps pass
        if self.tripped and self._tripped_at is not None \
                and iteration - self._tripped_at >= self.heal_after:
            self.tripped = False
        self._observe_loss(loss, iteration)
        if gnorm is not None:
            self._observe_grad_norm(gnorm, iteration)
        if (self.check_activations_every
                and iteration % self.check_activations_every == 0):
            self._check_dead_activations(model, iteration)

    def _observe_loss(self, loss: float, iteration: int) -> None:
        self._losses.append(loss)
        if self._best is None or loss < self._best:
            self._best = loss
        # divergence: loss rose far above the best seen, sustained
        threshold = self._best + self.divergence_factor * max(
            abs(self._best), 1.0)
        if len(self._losses) >= self.divergence_patience \
                and loss > threshold:
            self._div_streak += 1
            if self._div_streak >= self.divergence_patience:
                self._div_streak = 0
                self._trip(
                    "loss_divergence",
                    f"loss diverged: {loss:.6g} at iteration "
                    f"{iteration} vs best {self._best:.6g} "
                    f"(> best + {self.divergence_factor:g}x)",
                    iteration, value=loss)
                return
        else:
            self._div_streak = 0
        # plateau: no movement across the plateau window
        if len(self._losses) >= self.plateau_window:
            tail = list(self._losses)[-self.plateau_window:]
            span = max(tail) - min(tail)
            scale = max(abs(sum(tail) / len(tail)), 1e-12)
            if span / scale < self.plateau_tol:
                self._trip(
                    "loss_plateau",
                    f"loss plateaued: relative span "
                    f"{span / scale:.3g} over last "
                    f"{self.plateau_window} steps at iteration "
                    f"{iteration}", iteration, value=span / scale)

    def _observe_grad_norm(self, gnorm: float, iteration: int) -> None:
        spike = None
        if len(self._gnorms) >= self.window // 2:
            med = float(np.median(self._gnorms))
            if med > 0 and gnorm > self.grad_spike_factor * med:
                spike = med
        self._gnorms.append(gnorm)
        if gnorm > self.grad_explosion or spike is not None:
            self._trip(
                "grad_explosion",
                f"gradient norm exploded: {gnorm:.6g} at iteration "
                f"{iteration}"
                + (f" ({self.grad_spike_factor:g}x the window median "
                   f"{spike:.3g})" if spike is not None else
                   f" (> {self.grad_explosion:g})"),
                iteration, value=gnorm)
            return
        if gnorm < self.grad_vanish:
            self._vanish_streak += 1
            if self._vanish_streak >= self.vanish_patience:
                self._vanish_streak = 0
                self._trip(
                    "grad_vanish",
                    f"gradient norm vanished: {gnorm:.3g} for "
                    f"{self.vanish_patience} consecutive steps at "
                    f"iteration {iteration}", iteration, value=gnorm)
        else:
            self._vanish_streak = 0

    def _check_dead_activations(self, model, iteration: int) -> None:
        """Fraction of units whose mean |activation| over the last
        batch is ~0, per layer (the dead-ReLU detector). Costs one
        extra forward pass + host fetch — that's why it's off by
        default and rate-limited by ``check_activations_every``."""
        batch = getattr(model, "_last_batch", None)
        if batch is None or not hasattr(model, "feed_forward"):
            return
        feats = batch[0] if isinstance(batch, tuple) else None
        if feats is None or not hasattr(feats, "shape"):
            return
        try:
            acts = model.feed_forward(feats)
        except Exception:
            return
        if not acts:
            return
        # skip the output layer: a softmax/identity head is never
        # "dead" in the ReLU sense
        inspect = acts[:-1] if len(acts) > 1 else acts
        dead = {}
        for i, a in enumerate(inspect):
            arr = a.detach().float().cpu().numpy()
            flat = arr.reshape(arr.shape[0], -1)
            per_unit = np.mean(np.abs(flat), axis=0)
            dead[str(i)] = float(np.mean(per_unit < self.dead_eps))
        self.last["dead_fraction"] = dead
        worst_layer = max(dead, key=dead.get)
        worst = dead[worst_layer]
        if worst > self.dead_threshold:
            self._trip(
                "dead_activations",
                f"layer {worst_layer}: {worst:.0%} of units dead "
                f"(mean |act| < {self.dead_eps:g}) at iteration "
                f"{iteration}", iteration, value=worst)

    # ------------------------------------------------------------------
    # stats-pipe path (chainable storage)
    # ------------------------------------------------------------------
    def put_update(self, report) -> None:
        """Storage-protocol sink: inspect a StatsReport, stamp it with
        the latest device health, forward to the wrapped storage.
        Chain as ``StatsListener(storage=HealthMonitor(storage=real))``.
        """
        try:
            self._observe_report(report)
        finally:
            if self.storage is not None:
                self.storage.put_update(report)

    def _observe_report(self, report) -> None:
        # stamp the report with device-plane numbers so the health
        # fields ride the existing storage/remote-POST pipe
        if self.last:
            if getattr(report, "gradient_norm", None) is None:
                report.gradient_norm = self.last.get("grad_norm")
            if getattr(report, "update_norm", None) is None:
                report.update_norm = self.last.get("update_norm")
            if getattr(report, "param_norm", None) is None:
                report.param_norm = self.last.get("param_norm")
            health = dict(getattr(report, "health", None) or {})
            health.setdefault("finite_bits",
                              self.last.get("finite_bits", 0))
            dead = self.last.get("dead_fraction")
            if dead:
                health.setdefault("worst_dead_fraction",
                                  max(dead.values()))
            report.health = health
        ratios = getattr(report, "update_ratios", None) or {}
        out_of_band = {
            layer: r for layer, r in ratios.items()
            if r > 0 and not (self.ratio_low <= r <= self.ratio_high)}
        if out_of_band:
            self._ratio_streak += 1
            if self._ratio_streak >= self.ratio_patience:
                self._ratio_streak = 0
                worst = max(out_of_band.items(),
                            key=lambda kv: abs(np.log10(kv[1]) + 3))
                self._trip(
                    "update_ratio",
                    f"update:param ratio out of healthy band "
                    f"[{self.ratio_low:g}, {self.ratio_high:g}] for "
                    f"{self.ratio_patience} reports — layer "
                    f"{worst[0]}: {worst[1]:.3g} at iteration "
                    f"{report.iteration}", report.iteration,
                    value=worst[1])
        else:
            self._ratio_streak = 0

    # ------------------------------------------------------------------
    # introspection (the UI /api/health payload)
    # ------------------------------------------------------------------
    def status(self) -> dict:
        last_seen = int(self.last.get("iteration", 0) or 0)
        recent = (self._last_anomaly_at is not None
                  and last_seen - self._last_anomaly_at
                  < self.heal_after)
        if self.tripped:
            status = "diverged"
        elif self.anomalies and recent:
            status = "warning"
        else:
            status = "ok"     # history retained, incident healed
        return {"status": status,
                "policy": self.policy,
                "anomalies": list(self.anomalies)[-20:],
                "anomaly_count": len(self.anomalies),
                "last": dict(self.last),
                "device_fetches": self.device_fetches}
