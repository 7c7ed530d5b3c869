"""Weight initialization schemes (counterpart of
``deeplearning4j_tpu/nn/weights.py``).

Same vocabulary and distributions as the JAX package, sampled from an
explicit ``torch.Generator`` on the CPU, so a seed gives the same
weights whatever device the model then moves to. (torch and
``jax.random`` streams differ, so the two packages' weights cross by
checkpoint, not by seed.)
"""

from __future__ import annotations

import math

import torch

__all__ = ["init_weight", "distribution_sample", "WEIGHT_INITS"]


def _normal(g, shape, dtype):
    return torch.randn(shape, generator=g, dtype=dtype)


def _uniform(g, shape, dtype, lo, hi):
    return torch.rand(shape, generator=g, dtype=dtype) * (hi - lo) + lo


def init_weight(generator: torch.Generator, shape, scheme, fan_in,
                fan_out, *, distribution=None, dtype=torch.float32):
    """Sample a weight tensor of ``shape`` under ``scheme`` (a
    lower-case WeightInit name, or 'distribution' with a distribution
    config dict)."""
    g = generator
    shape = tuple(shape)
    s = str(scheme).lower()
    fan_in = max(float(fan_in), 1.0)
    fan_out = max(float(fan_out), 1.0)

    if s == "zero":
        return torch.zeros(shape, dtype=dtype)
    if s == "ones":
        return torch.ones(shape, dtype=dtype)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-d shape")
        return torch.eye(shape[0], dtype=dtype)
    if s in ("normal", "xavier_fan_in", "lecun_normal"):
        return _normal(g, shape, dtype) / math.sqrt(fan_in)
    if s == "lecun_uniform":
        b = math.sqrt(3.0 / fan_in)
        return _uniform(g, shape, dtype, -b, b)
    if s == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(g, shape, dtype, -a, a)
    if s == "xavier":
        return _normal(g, shape, dtype) * math.sqrt(2.0 / (fan_in + fan_out))
    if s == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(g, shape, dtype, -a, a)
    if s == "xavier_legacy":
        return _normal(g, shape, dtype) * math.sqrt(1.0 / (fan_in + fan_out))
    if s == "relu":
        return _normal(g, shape, dtype) * math.sqrt(2.0 / fan_in)
    if s == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        return _uniform(g, shape, dtype, -a, a)
    if s == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(g, shape, dtype, -a, a)
    if s.startswith("var_scaling_") and s in WEIGHT_INITS:
        if s.endswith("fan_in"):
            n = fan_in
        elif s.endswith("fan_out"):
            n = fan_out
        else:
            n = 0.5 * (fan_in + fan_out)
        if "normal" in s:
            return _normal(g, shape, dtype) * math.sqrt(1.0 / n)
        a = math.sqrt(3.0 / n)
        return _uniform(g, shape, dtype, -a, a)
    if s == "distribution":
        if distribution is None:
            raise ValueError("WeightInit 'distribution' requires a "
                             "distribution config")
        return distribution_sample(g, shape, distribution, dtype=dtype)
    raise ValueError(f"Unknown weight init scheme '{scheme}'")


WEIGHT_INITS = [
    "zero", "ones", "identity", "normal", "lecun_normal", "lecun_uniform",
    "uniform", "xavier", "xavier_uniform", "xavier_fan_in", "xavier_legacy",
    "relu", "relu_uniform", "sigmoid_uniform", "distribution",
    "var_scaling_normal_fan_in", "var_scaling_normal_fan_out",
    "var_scaling_normal_fan_avg", "var_scaling_uniform_fan_in",
    "var_scaling_uniform_fan_out", "var_scaling_uniform_fan_avg",
]


def distribution_sample(generator: torch.Generator, shape, dist, *,
                        dtype=torch.float32):
    """Sample from a distribution config dict, as the JAX package reads
    it: normal/gaussian (mean, std), uniform (lower, upper), binomial
    (n, p), truncated_normal (mean, std; cut at 2 std), constant
    (value), log_normal (mean, std), orthogonal (gain)."""
    g = generator
    shape = tuple(shape)
    t = str(dist.get("type", "normal")).lower()
    if t in ("normal", "gaussian"):
        return dist.get("mean", 0.0) + dist.get("std", 1.0) * _normal(
            g, shape, dtype)
    if t == "uniform":
        return _uniform(g, shape, dtype, dist.get("lower", 0.0),
                        dist.get("upper", 1.0))
    if t == "binomial":
        n = int(dist.get("n", 1))
        p = torch.full((n,) + shape, float(dist.get("p", 0.5)))
        return torch.bernoulli(p, generator=g).sum(0).to(dtype)
    if t == "truncated_normal":
        out = torch.empty(shape, dtype=dtype)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=g)
        return dist.get("mean", 0.0) + dist.get("std", 1.0) * out
    if t == "constant":
        return torch.full(shape, dist.get("value", 0.0), dtype=dtype)
    if t == "log_normal":
        return torch.exp(dist.get("mean", 0.0) + dist.get("std", 1.0)
                         * _normal(g, shape, dtype))
    if t == "orthogonal":
        n_rows = shape[0]
        n_cols = math.prod(shape[1:])
        a = _normal(g, (max(n_rows, n_cols), min(n_rows, n_cols)),
                    torch.float32)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (dist.get("gain", 1.0)
                * q[:n_rows, :n_cols].reshape(shape)).to(dtype)
    raise ValueError(f"Unknown distribution type '{t}'")
