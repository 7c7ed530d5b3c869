"""Training utilities: per-layer gradient normalization, parameter
constraints, training listeners and early stopping."""
