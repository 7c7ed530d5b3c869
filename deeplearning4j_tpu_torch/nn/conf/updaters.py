"""Updater (optimizer) configs, learning-rate schedules and the update
rules (counterpart of ``deeplearning4j_tpu/nn/conf/updaters.py``).

Configs are the JAX package's plain dicts (``adam(1e-3)`` ->
``{"type": "adam", ...}``). There, ``to_optax`` compiles one to an optax
GradientTransformation; here ``to_transform`` builds the same rule,
written out by hand after optax 0.2.6 (``scale_by_adam``, ``trace``,
``scale_by_rss``, ...), not mapped to ``torch.optim``: the two differ
(optax's adagrad starts its accumulator at 0.1, its rmsprop adds eps
inside the square root, its adadelta without a learning rate is not
negated, ...), and the checkpoint must hold optax's state.

A transform has ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``; ``apply_updates`` adds the updates to the
params. Params, grads and updates are the network's tree: a list of
per-layer nested ``{name: tensor}`` dicts. A state keeps optax's layout
as nested lists (a chain's elements, by index) and dicts (a state
tuple's fields, keyed ``".count"``, ``".mu"``, ...), so that flattening
it by path gives the keys of the JAX package's ``updater_state.npz``:
``0/.count``, ``0/.mu/1/attn/Wq``, ``1/.count`` for a schedule's step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

__all__ = ["to_transform", "make_schedule", "apply_updates", "tree_map",
           "tree_leaves", "multi_transform", "chain", "clip_by_global_norm",
           "clip", "with_gradient_clip",
           "sgd", "adam", "adamax", "nesterovs", "adagrad", "adadelta",
           "rmsprop", "noop", "amsgrad", "nadam"]

_INT32_MAX = 2 ** 31 - 1


# ---- config constructors (the JAX package's builder sugar) ----

def sgd(lr=0.1, schedule=None):
    return {"type": "sgd", "lr": lr, "schedule": schedule}


def adam(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, schedule=None):
    return {"type": "adam", "lr": lr, "beta1": beta1, "beta2": beta2,
            "eps": eps, "schedule": schedule}


def amsgrad(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, schedule=None):
    return {"type": "amsgrad", "lr": lr, "beta1": beta1, "beta2": beta2,
            "eps": eps, "schedule": schedule}


def nadam(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, schedule=None):
    return {"type": "nadam", "lr": lr, "beta1": beta1, "beta2": beta2,
            "eps": eps, "schedule": schedule}


def adamax(lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-8, schedule=None):
    return {"type": "adamax", "lr": lr, "beta1": beta1, "beta2": beta2,
            "eps": eps, "schedule": schedule}


def nesterovs(lr=0.1, momentum=0.9, schedule=None):
    return {"type": "nesterovs", "lr": lr, "momentum": momentum,
            "schedule": schedule}


def adagrad(lr=0.1, eps=1e-6, schedule=None):
    return {"type": "adagrad", "lr": lr, "eps": eps, "schedule": schedule}


def adadelta(rho=0.95, eps=1e-6):
    return {"type": "adadelta", "rho": rho, "eps": eps}


def rmsprop(lr=1e-3, decay=0.95, eps=1e-8, schedule=None):
    return {"type": "rmsprop", "lr": lr, "decay": decay, "eps": eps,
            "schedule": schedule}


def noop():
    return {"type": "noop"}


# ---- trees ----

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested lists/dicts (``tree`` gives the
    structure; ``rest`` are trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _count(params):
    """optax's int32 step counter, on the params' device."""
    dev = next(tree_leaves(params), torch.zeros(())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _inc(count):
    return torch.clamp(count + 1, max=_INT32_MAX).to(torch.int32)


def _decay_pow(decay: float, count):
    """``decay ** count`` in float32, as optax's bias correction takes
    it (a weakly typed float to an int32 power). The base is a Python
    scalar, so no host-to-device copy runs inside a captured step."""
    return torch.pow(decay, count.to(torch.float32))


def apply_updates(params, updates):
    """params + updates, in place (optax.apply_updates returns new
    arrays; the port updates the parameter tensors where they lie)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))
    return params


class Transform:
    """One optax GradientTransformation: ``init`` and ``update``."""

    def __init__(self, init: Callable, update: Callable):
        self.init = init
        self.update = update


def chain(*ts: Transform) -> Transform:
    """optax.chain: the state is the list of the elements' states."""
    def init(params):
        return [t.init(params) for t in ts]

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(ts, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state
    return Transform(init, update)


def _identity() -> Transform:
    return Transform(lambda params: {},
                     lambda g, s, params=None: (g, s))


def _scale(step: float) -> Transform:
    return Transform(lambda params: {},
                     lambda g, s, params=None: (tree_map(lambda x: step * x, g),
                                                s))


def _scale_by_schedule(fn) -> Transform:
    def update(g, state, params=None):
        count = state[".count"]
        step = fn(count)
        return (tree_map(lambda x: step.to(x.dtype) * x, g),
                {".count": _inc(count)})
    return Transform(lambda params: {".count": _count(params)}, update)


def _scale_by_learning_rate(lr) -> Transform:
    if lr is None:
        return _identity()
    if callable(lr):
        return _scale_by_schedule(lambda count: -lr(count))
    return _scale(-lr)


def _scale_by_adam(b1, b2, eps, eps_root=0.0, nesterov=False,
                   amsgrad=False) -> Transform:
    def init(params):
        s = {".count": _count(params), ".mu": _zeros(params),
             ".nu": _zeros(params)}
        if amsgrad:
            s[".nu_max"] = _zeros(params)
        return s

    def update(g, state, params=None):
        mu = tree_map(lambda x, m: (1 - b1) * x + b1 * m, g, state[".mu"])
        nu = tree_map(lambda x, v: (1 - b2) * x ** 2 + b2 * v, g, state[".nu"])
        count = _inc(state[".count"])
        bc1 = 1 - _decay_pow(b1, count)
        bc2 = 1 - _decay_pow(b2, count)
        if nesterov:
            bc1_next = 1 - _decay_pow(b1, _inc(count))
            mu_hat = tree_map(lambda m, x: b1 * (m / bc1_next)
                          + (1 - b1) * (x / bc1), mu, g)
        else:
            mu_hat = tree_map(lambda m: m / bc1, mu)
        nu_hat = tree_map(lambda v: v / bc2, nu)
        new = {".count": count, ".mu": mu, ".nu": nu}
        if amsgrad:
            nu_hat = tree_map(torch.maximum, state[".nu_max"], nu_hat)
            new[".nu_max"] = nu_hat
        u = tree_map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps),
                 mu_hat, nu_hat)
        return u, new
    return Transform(init, update)


def _scale_by_adamax(b1, b2, eps) -> Transform:
    def init(params):
        return {".count": _count(params), ".mu": _zeros(params),
                ".nu": _zeros(params)}

    def update(g, state, params=None):
        count = _inc(state[".count"])
        mu = tree_map(lambda x, m: (1 - b1) * x + b1 * m, g, state[".mu"])
        nu = tree_map(lambda x, v: torch.maximum(torch.abs(x) + eps, b2 * v),
                  g, state[".nu"])
        bc1 = 1 - _decay_pow(b1, count)
        u = tree_map(lambda m, v: (m / bc1) / v, mu, nu)
        return u, {".count": count, ".mu": mu, ".nu": nu}
    return Transform(init, update)


def _trace(decay, nesterov) -> Transform:
    def update(g, state, params=None):
        t = tree_map(lambda x, tr: x + decay * tr, g, state[".trace"])
        u = tree_map(lambda x, tr: x + decay * tr, g, t) if nesterov else t
        return u, {".trace": t}
    return Transform(lambda params: {".trace": _zeros(params)}, update)


def _scale_by_rss(initial, eps) -> Transform:
    def update(g, state, params=None):
        sos = tree_map(lambda x, t: x * x + t, g, state[".sum_of_squares"])
        u = tree_map(lambda x, t: torch.where(t > 0, torch.rsqrt(t + eps),
                                          torch.zeros_like(t)) * x, g, sos)
        return u, {".sum_of_squares": sos}
    return Transform(
        lambda params: {".sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial), params)}, update)


def _scale_by_adadelta(rho, eps) -> Transform:
    def update(g, state, params=None):
        e_g = tree_map(lambda x, t: (1 - rho) * x ** 2 + rho * t, g,
                   state[".e_g"])
        u = tree_map(lambda x, eg, ex: torch.sqrt(ex + eps)
                 / torch.sqrt(eg + eps) * x, g, e_g, state[".e_x"])
        e_x = tree_map(lambda x, t: (1 - rho) * x ** 2 + rho * t, u,
                   state[".e_x"])
        return u, {".e_g": e_g, ".e_x": e_x}
    return Transform(lambda params: {".e_g": _zeros(params),
                                     ".e_x": _zeros(params)}, update)


def _add_decayed_weights(weight_decay) -> Transform:
    def update(g, state, params=None):
        return tree_map(lambda x, p: x + weight_decay * p, g, params), state
    return Transform(lambda params: {}, update)


def _scale_by_rms(decay, eps) -> Transform:
    def update(g, state, params=None):
        nu = tree_map(lambda x, t: (1 - decay) * x ** 2 + decay * t, g,
                  state[".nu"])
        u = tree_map(lambda x, n: torch.rsqrt(n + eps) * x, g, nu)
        return u, {".nu": nu}
    return Transform(lambda params: {".nu": _zeros(params)}, update)


def _set_to_zero() -> Transform:
    return Transform(lambda params: {},
                     lambda g, s, params=None: (tree_map(torch.zeros_like, g),
                                                s))


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax's clip_by_global_norm. Under tensor parallelism (an update
    inside ``tensor_parallel.sharded_norms``) the norm is the full
    parameters': split leaves' partial sums all-reduced over the model
    group, replicated leaves counted once."""
    from deeplearning4j_tpu_torch.parallel import tensor_parallel

    def update(g, state, params=None):
        norm = torch.sqrt(tensor_parallel.tree_sq_sum(
            g, tensor_parallel.norm_dims()))
        keep = norm < max_norm
        return tree_map(lambda x: torch.where(keep, x, x / norm * max_norm),
                    g), state
    return Transform(lambda params: {}, update)


def clip(max_delta: float) -> Transform:
    return Transform(lambda params: {},
                     lambda g, s, params=None: (
                         tree_map(lambda x: torch.clamp(x, -max_delta,
                                                    max_delta), g), s))


def with_gradient_clip(opt: Transform, cfg: Optional[dict]) -> Transform:
    """``opt`` behind the config's ``gradient_clip`` (``{"type": "norm" |
    "value", "v": x}``), as the JAX executors chain optax's clip in
    front; ``opt`` itself without one."""
    if cfg is None:
        return opt
    if cfg["type"] == "norm":
        return chain(clip_by_global_norm(cfg["v"]), opt)
    if cfg["type"] == "value":
        return chain(clip(cfg["v"]), opt)
    raise ValueError(cfg)


def multi_transform(transforms: dict, labels) -> Transform:
    """optax.multi_transform with one label per layer: ``labels`` is a
    list (a network's per-layer list of params) or a dict (a graph's
    params by vertex name). Each transform sees only its layers' params
    (the others are empty dicts, where optax has masked leaves, so the
    flattened keys agree)."""
    keys = list(labels) if isinstance(labels, dict) else range(len(labels))

    def masked(tree, name):
        if isinstance(labels, dict):
            return {k: (tree[k] if labels[k] == name else {}) for k in keys}
        return [t if lab == name else {} for t, lab in zip(tree, labels)]

    def init(params):
        return {".inner_states": {
            name: {".inner_state": t.init(masked(params, name))}
            for name, t in transforms.items()}}

    def update(g, state, params=None):
        out = {k: {} for k in keys} if isinstance(labels, dict) \
            else [{} for _ in g]
        inner = {}
        for name, t in transforms.items():
            u, s = t.update(masked(g, name),
                            state[".inner_states"][name][".inner_state"],
                            None if params is None
                            else masked(params, name))
            inner[name] = {".inner_state": s}
            for k in keys:
                if labels[k] == name:
                    out[k] = u[k]
        return out, {".inner_states": inner}
    return Transform(init, update)


# ---- schedules (ISchedule / lr decay policies) ----

def make_schedule(base_lr: float, sched: Optional[dict]
                  ) -> Union[float, Callable]:
    """dict -> schedule, a function of the int32 step counter giving a
    float32 tensor (computed on the counter's device, as optax computes
    it in the update). Types: 'exponential' {gamma}, 'inverse' {gamma,
    power}, 'poly' {power, max_iter}, 'sigmoid' {gamma, step}, 'step'
    {decay_rate, step}, 'map' {values: {iter: lr}}, 'warmup_cosine'
    {warmup_steps, total_steps, [end_lr]}."""
    if sched is None:
        return base_lr
    t = sched["type"]

    def f32(x, like):
        # a fill on the device, not a copy from the host: the schedule
        # runs inside a captured training step
        return torch.full((), x, dtype=torch.float32, device=like.device)

    if t == "exponential":
        g = sched.get("gamma", 0.99)
        return lambda i: base_lr * torch.pow(g, i.to(torch.float32))
    if t == "inverse":
        g, p = sched.get("gamma", 1e-2), sched.get("power", 1.0)
        return lambda i: base_lr / (1 + g * i.to(torch.float32)) ** p
    if t == "poly":
        p = sched.get("power", 1.0)
        mx = sched.get("max_iter", 10000)
        return lambda i: base_lr * (
            1 - torch.clamp(i, max=mx).to(torch.float32) / mx) ** p
    if t == "sigmoid":
        g, s = sched.get("gamma", 0.5), sched.get("step", 10)
        return lambda i: base_lr / (
            1 + torch.exp(-g * (i.to(torch.float32) - s)))
    if t == "step":
        d, s = sched.get("decay_rate", 0.1), sched.get("step", 1000)
        return lambda i: base_lr * torch.pow(d, torch.floor(
            i.to(torch.float32) / s))
    if t == "map":
        pairs = sorted((int(k), float(v))
                       for k, v in sched["values"].items())

        def f(i):
            lr = f32(base_lr, i)
            for it, v in pairs:
                lr = torch.where(i >= it, f32(v, i), lr)
            return lr
        return f
    if t == "warmup_cosine":
        return _warmup_cosine(0.0, base_lr, sched.get("warmup_steps", 0),
                              sched.get("total_steps", 10000),
                              sched.get("end_lr", 0.0))
    raise ValueError(f"Unknown schedule type '{t}'")


def _warmup_cosine(init_value, peak_value, warmup_steps, total_steps,
                   end_value):
    """optax.warmup_cosine_decay_schedule: a linear ramp joined to a
    cosine decay at ``warmup_steps``."""
    decay_steps = total_steps - warmup_steps
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def linear(i):
        if warmup_steps <= 0:
            return torch.full((), init_value, dtype=torch.float32,
                              device=i.device)
        c = torch.clamp(i, 0, warmup_steps).to(torch.float32)
        frac = 1 - c / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(i):
        c = torch.clamp(i.to(torch.float32), max=float(decay_steps))
        decay = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    return lambda i: torch.where(i < warmup_steps, linear(i),
                                 cosine(i - warmup_steps))


def to_transform(cfg: Optional[dict]) -> Transform:
    """The update rule of an updater config (optax's, by hand)."""
    if cfg is None:
        cfg = sgd()
    t = cfg.get("type", "sgd")
    lr = make_schedule(cfg.get("lr", 0.1), cfg.get("schedule"))
    b1, b2 = cfg.get("beta1", 0.9), cfg.get("beta2", 0.999)
    eps = cfg.get("eps", 1e-8)
    if t == "sgd":
        return chain(_identity(), _scale_by_learning_rate(lr))
    if t in ("adam", "nadam", "amsgrad"):
        return chain(_scale_by_adam(b1, b2, eps, nesterov=t == "nadam",
                                    amsgrad=t == "amsgrad"),
                     _scale_by_learning_rate(lr))
    if t == "adamax":
        return chain(_scale_by_adamax(b1, b2, eps),
                     _scale_by_learning_rate(lr))
    if t == "nesterovs":
        return chain(_trace(cfg.get("momentum", 0.9), nesterov=True),
                     _scale_by_learning_rate(lr))
    if t == "adagrad":
        return chain(_scale_by_rss(0.1, cfg.get("eps", 1e-6)),
                     _scale_by_learning_rate(lr))
    if t == "adadelta":
        # optax.adadelta(learning_rate=None): no scaling, and so no sign
        # flip either (the JAX package builds it this way)
        return chain(_add_decayed_weights(0.0),
                     _scale_by_adadelta(cfg.get("rho", 0.95),
                                        cfg.get("eps", 1e-6)),
                     _scale_by_learning_rate(None))
    if t == "rmsprop":
        return chain(_scale_by_rms(cfg.get("decay", 0.95), eps),
                     _scale_by_learning_rate(lr), _identity())
    if t == "noop":
        return _set_to_zero()
    raise ValueError(f"Unknown updater type '{t}'")
