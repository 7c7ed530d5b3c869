"""Training utilities ported so far: per-layer gradient normalization and
parameter constraints."""
