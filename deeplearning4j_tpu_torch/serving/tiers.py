"""Per-tenant priority tiers for serving admission.

Counterpart of ``deeplearning4j_tpu/serving/tiers.py``
(host code, stdlib only).

Every request carries a **tier** — ``gold`` / ``standard`` /
``best_effort`` — and the serving stack spends its scarce resources
(queue slots, device time, Retry-After patience) in that order. The
contract:

- **Weighted-fair service.** Backlogged queues are drained
  weighted-fair across tiers (see ``lifecycle.TierQueue``): gold gets
  the lion's share of dequeues but best-effort is never starved
  outright — a backlogged best-effort request still sees ~1/12 of
  the service rate instead of waiting forever behind paid traffic.
- **Shed cheapest first.** When the bounded queue is full, an
  arriving higher-tier request EVICTS the newest queued request of
  the cheapest backlogged tier below it (the evicted waiter gets a
  typed ``QueueFullError``); an arriving request that cannot outrank
  anything queued is shed itself. A traffic spike therefore degrades
  best-effort traffic before it touches the paid SLO.
- **Retry-After priced by tier.** Backoff hints are multiplied by
  the tier's patience factor: a shed best-effort caller is told to
  come back 4x later than a gold caller, so the retry storm after a
  spike is itself tier-ordered.

This module is a dependency LEAF (stdlib only), like
``serving/errors.py``: the HTTP layer, the router, the backends and
the load generator all import the same three literals from here.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["GOLD", "STANDARD", "BEST_EFFORT", "TIERS", "PRIORITY",
           "WEIGHTS", "RETRY_AFTER_FACTOR", "DEFAULT_TIER",
           "parse_tier", "priced_retry_after_s",
           "WeightedFairPicker"]

GOLD = "gold"
STANDARD = "standard"
BEST_EFFORT = "best_effort"

# service order: lower number = served/protected first
TIERS = (GOLD, STANDARD, BEST_EFFORT)
PRIORITY = {GOLD: 0, STANDARD: 1, BEST_EFFORT: 2}

# weighted-fair dequeue shares for a fully backlogged queue
# (gold:standard:best_effort = 8:3:1 — best_effort is degraded, not
# starved)
WEIGHTS = {GOLD: 8, STANDARD: 3, BEST_EFFORT: 1}

# Retry-After price multipliers: how long each tier is told to stay
# away after a shed (gold callers are invited back soonest)
RETRY_AFTER_FACTOR = {GOLD: 1.0, STANDARD: 2.0, BEST_EFFORT: 4.0}

DEFAULT_TIER = STANDARD


def parse_tier(value: Optional[str]) -> str:
    """Validate a request's tier field (None -> the default).
    ``best-effort`` is accepted as a spelling of ``best_effort``;
    anything else unknown is a client error (HTTP 400)."""
    if value is None:
        return DEFAULT_TIER
    tier = str(value).replace("-", "_")
    if tier not in PRIORITY:
        raise ValueError(
            f"unknown tier {value!r}; known tiers: {list(TIERS)}")
    return tier


def priced_retry_after_s(base_s: float, tier: str) -> float:
    """Tier-priced backoff hint: the raiser's base estimate scaled
    by the tier's patience factor."""
    return float(base_s) * RETRY_AFTER_FACTOR.get(tier, 2.0)


class WeightedFairPicker:
    """Smooth weighted round-robin over whichever tiers are
    currently backlogged: each pick credits every competitor its
    weight, serves the richest (ties go to the higher tier), and
    charges it the round's total — long-run service converges on
    the ``WEIGHTS`` ratio with no bursts, and a lone tier is served
    directly without accumulating credit against absent rivals.

    One instance per service point (the ``TierQueue`` dequeue, the
    ``ContinuousBatcher`` slot grant), so both enforce the same
    contract from the same code. NOT thread-safe on its own — the
    owner calls ``pick`` under its own lock / from its one worker
    thread."""

    def __init__(self):
        self._credits = {t: 0.0 for t in TIERS}

    def pick(self, avail: Sequence[str]) -> str:
        """The tier to serve next, out of the non-empty ones."""
        if len(avail) == 1:
            return avail[0]
        for t in avail:
            self._credits[t] += WEIGHTS[t]
        chosen = max(avail, key=lambda t: (self._credits[t],
                                           -PRIORITY[t]))
        self._credits[chosen] -= sum(WEIGHTS[t] for t in avail)
        return chosen
