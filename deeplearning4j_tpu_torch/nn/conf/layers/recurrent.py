"""Recurrent layers (counterpart of
``deeplearning4j_tpu/nn/conf/layers/recurrent.py``).

The JAX cell runs as one ``lax.scan``; here the scan is a Python loop
over the timesteps of plain torch ops on the input's device, and the
backward is autograd through it. Nothing in the loop syncs with the
host: masks are applied with ``torch.where``. The input product
``x @ Wx + b`` of every timestep is one GEMM before the loop, and each
step adds ``h @ Wh`` to it in one ``addmm``; the JAX cell sums
``x_t @ Wx + h @ Wh + b`` per step, so the two add in another order
(within float32 rounding).

Gate packing order on the 4*n_out axis: [input, forget, output,
cell(g)]. ``Wx`` is (n_in, 4m), ``Wh`` (m, 4m), ``b`` (4m,) with the
forget block ``[m:2m]`` at ``forget_gate_bias_init``; GravesLSTM adds
the peepholes ``wc`` (3m,) as [ci, cf, co]: ci and cf read the carried
cell state, co the new one.

``apply_rnn(params, x, carry, mask=)`` takes and returns the carried
(h, c), which the executors thread through tBPTT chunks,
``rnn_time_step`` and the streaming sessions. At a masked timestep the
carry does not advance and the output is zero. The layers read the
policy's ``param_dtype`` only, so they stay float32 under the bf16
policy, as in the JAX package. On a card their GEMMs run in float32:
``device.keep_float32`` turns TF32 off before the input product, for
the whole process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.device import keep_float32
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers.base import (FeedForwardLayer,
                                                          Layer,
                                                          layer_from_dict,
                                                          register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers.output import LossLayer

__all__ = ["BaseRecurrentLayer", "LSTM", "GravesLSTM",
           "GravesBidirectionalLSTM", "Bidirectional", "SimpleRnn",
           "LastTimeStep", "RnnLossLayer"]


def _promote(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype jnp's promotion gives ``x @ w``."""
    return x.to(torch.promote_types(x.dtype, w.dtype))


@dataclasses.dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    activation: str = "tanh"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.size

    def zero_state(self, batch: int, device=None):
        """Distinct zero (h, c) tensors of (batch, n_out) in the policy's
        ``param_dtype``."""
        dt = dtypes.policy().param_dtype
        return (torch.zeros((batch, self.n_out), dtype=dt, device=device),
                torch.zeros((batch, self.n_out), dtype=dt, device=device))

    def apply_rnn(self, params, x, carry, *, training=False, generator=None,
                  mask=None):
        raise NotImplementedError

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        x = self.apply_input_dropout(x, training=training,
                                     generator=generator)
        # the carry in param_dtype: a half-precision input is promoted
        # by the input product (the JAX layer takes x's dtype, which
        # its scan refuses once the carry promotes)
        out, _ = self.apply_rnn(
            params, x, self.zero_state(x.shape[0], device=x.device),
            training=training, generator=generator, mask=mask)
        return out, state

    @staticmethod
    def _input_product(params, x):
        """(T, B, ·): ``x_t @ Wx + b`` of every step in one GEMM."""
        keep_float32(x)
        Wx = params["Wx"]
        return _promote(x, Wx).transpose(0, 1) @ Wx + params["b"]

    @staticmethod
    def _scan(xw, carry, mask, cell):
        """The loop over time: ``cell(xw_t, h, c) -> (h, c)`` on the
        precomputed input product (T, B, ·) of each step; a masked step
        keeps the carry and outputs zero. Returns ((B, T, m), (h, c))."""
        h, c = carry
        mt = None if mask is None else mask.to(xw.dtype).transpose(0, 1)
        outs = []
        for t in range(xw.shape[0]):
            h_new, c_new = cell(xw[t], h, c)
            if mt is not None:
                m = mt[t][:, None]
                h_new = torch.where(m > 0, h_new, h)
                c_new = torch.where(m > 0, c_new, c)
                outs.append(h_new * m)
            else:
                outs.append(h_new)
            h, c = h_new, c_new
        return torch.stack(outs, dim=1), (h, c)


@register_layer
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """Standard LSTM, no peepholes (nn/conf/layers/LSTM.java)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        n, m = self.n_in, self.n_out
        b = torch.zeros((4 * m,), dtype=dtypes.policy().param_dtype)
        b[m:2 * m] = float(self.forget_gate_bias_init)
        return {
            "Wx": self._sample_w(generator, (n, 4 * m), n + m, m),
            "Wh": self._sample_w(generator, (m, 4 * m), n + m, m),
            "b": b,
        }, {}

    def _cell(self, params, zx, h, c):
        m = self.n_out
        z = torch.addmm(zx, h, params["Wh"])
        gate = activations.get(self.gate_activation)
        act = self.activation_fn()
        i = gate(z[:, 0 * m:1 * m])
        f = gate(z[:, 1 * m:2 * m])
        o = gate(z[:, 2 * m:3 * m])
        g = act(z[:, 3 * m:4 * m])
        c_new = f * c + i * g
        return o * act(c_new), c_new

    def apply_rnn(self, params, x, carry, *, training=False, generator=None,
                  mask=None):
        xw = self._input_product(params, x)
        return self._scan(xw, carry, mask,
                          lambda zx, h, c: self._cell(params, zx, h, c))


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (nn/conf/layers/GravesLSTM.java;
    Graves 2013): w_ci, w_cf on the carried cell state, w_co on the new
    one."""

    def initialize(self, generator, input_type: InputType):
        params, state = super().initialize(generator, input_type)
        params["wc"] = torch.zeros((3 * self.n_out,),
                                   dtype=dtypes.policy().param_dtype)
        return params, state

    def _cell(self, params, zx, h, c):
        m = self.n_out
        z = torch.addmm(zx, h, params["Wh"])
        gate = activations.get(self.gate_activation)
        act = self.activation_fn()
        wc = params["wc"]
        i = gate(z[:, 0 * m:1 * m] + c * wc[0 * m:1 * m])
        f = gate(z[:, 1 * m:2 * m] + c * wc[1 * m:2 * m])
        g = act(z[:, 3 * m:4 * m])
        c_new = f * c + i * g
        o = gate(z[:, 2 * m:3 * m] + c_new * wc[2 * m:3 * m])
        return o * act(c_new), c_new


@register_layer
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h_t = act(x_t Wx + h_{t-1} Wh + b); the carry is
    (h, h)."""

    def initialize(self, generator, input_type: InputType):
        self.set_n_in(input_type)
        n, m = self.n_in, self.n_out
        return {
            "Wx": self._sample_w(generator, (n, m), n, m),
            "Wh": self._sample_w(generator, (m, m), m, m),
            "b": torch.full((m,), float(self.bias_init),
                            dtype=dtypes.policy().param_dtype),
        }, {}

    def apply_rnn(self, params, x, carry, *, training=False, generator=None,
                  mask=None):
        act = self.activation_fn()
        xw = self._input_product(params, x)

        def cell(zx, h, _c):
            h_new = act(torch.addmm(zx, h, params["Wh"]))
            return h_new, h_new

        out, (h, _) = self._scan(xw, (carry[0], carry[0]), mask, cell)
        return out, (h, h)


@register_layer
@dataclasses.dataclass
class Bidirectional(Layer):
    """Bidirectional wrapper (nn/conf/layers/recurrent/Bidirectional.java):
    the wrapped recurrent layer forward and, on a time-reversed copy,
    backward, merged by mode in {concat, add, mul, ave}. Its params nest
    as {"fwd": {...}, "bwd": {...}}."""

    fwd: Optional[dict] = None          # serialized wrapped-layer config
    mode: str = "concat"

    def __post_init__(self):
        if isinstance(self.fwd, Layer):
            self._fwd_layer = self.fwd
            self.fwd = self.fwd.to_dict()
        elif self.fwd is not None:
            self._fwd_layer = layer_from_dict(self.fwd)
        else:
            self._fwd_layer = None

    @property
    def wrapped(self) -> BaseRecurrentLayer:
        return self._fwd_layer

    def set_n_in(self, input_type: InputType) -> None:
        self.wrapped.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        base = self.wrapped.output_type(input_type)
        n = base.size * 2 if self.mode == "concat" else base.size
        return InputType.recurrent(n, base.timesteps)

    def initialize(self, generator, input_type: InputType):
        self.wrapped.set_n_in(input_type)
        pf, _ = self.wrapped.initialize(generator, input_type)
        pb, _ = self.wrapped.initialize(generator, input_type)
        self.fwd = self.wrapped.to_dict()   # capture the inferred n_in
        return {"fwd": pf, "bwd": pb}, {}

    @staticmethod
    def _reverse(x, mask):
        """``x`` reversed in time; under a mask only each row's valid
        prefix is reversed (DL4J reverses by the actual length)."""
        if mask is None:
            return torch.flip(x, dims=(1,))
        lengths = mask.sum(dim=1).to(torch.int64)            # (B,)
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        rev = lengths[:, None] - 1 - idx
        rev = torch.where(rev >= 0, rev, idx)
        return torch.gather(x, 1, rev[..., None].expand(-1, -1, x.shape[2]))

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        lay = self.wrapped
        z = lay.zero_state(x.shape[0], device=x.device)
        out_f, _ = lay.apply_rnn(params["fwd"], x, z, training=training,
                                 generator=generator, mask=mask)
        out_b, _ = lay.apply_rnn(params["bwd"], self._reverse(x, mask), z,
                                 training=training, generator=generator,
                                 mask=mask)
        out_b = self._reverse(out_b, mask)
        if self.mode == "concat":
            y = torch.cat([out_f, out_b], dim=-1)
        elif self.mode == "add":
            y = out_f + out_b
        elif self.mode == "mul":
            y = out_f * out_b
        elif self.mode == "ave":
            y = 0.5 * (out_f + out_b)
        else:
            raise ValueError(self.mode)
        return y, state

    def to_dict(self) -> dict:
        return {"@type": "Bidirectional", "name": self.name,
                "dropout": self.dropout, "fwd": self.fwd, "mode": self.mode}


@register_layer
@dataclasses.dataclass
class GravesBidirectionalLSTM(Bidirectional):
    """(nn/conf/layers/GravesBidirectionalLSTM.java): a bidirectional
    GravesLSTM with concat merge; it serializes as a Bidirectional, as
    in the JAX package."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: str = "tanh"
    weight_init: str = "xavier"
    forget_gate_bias_init: float = 1.0

    def __post_init__(self):
        if self.fwd is None and self.n_out is not None:
            self._fwd_layer = GravesLSTM(
                n_in=self.n_in, n_out=self.n_out, activation=self.activation,
                weight_init=self.weight_init,
                forget_gate_bias_init=self.forget_gate_bias_init)
            self.fwd = self._fwd_layer.to_dict()
        else:
            super().__post_init__()


@register_layer
@dataclasses.dataclass
class LastTimeStep(Layer):
    """The last (unmasked) timestep of the wrapped layer's output: a
    feed-forward activation (nn/conf/layers/recurrent/LastTimeStep.java)."""

    underlying: Optional[dict] = None

    def __post_init__(self):
        if isinstance(self.underlying, Layer):
            self._under = self.underlying
            self.underlying = self._under.to_dict()
        elif self.underlying is not None:
            self._under = layer_from_dict(self.underlying)
        else:
            self._under = None

    def set_n_in(self, input_type: InputType) -> None:
        self._under.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self._under.output_type(input_type).size)

    def initialize(self, generator, input_type: InputType):
        p, s = self._under.initialize(generator, input_type)
        self.underlying = self._under.to_dict()
        return p, s

    def apply(self, params, state, x, *, training=False, generator=None,
              mask=None):
        y, new_state = self._under.apply(params, state, x, training=training,
                                         generator=generator, mask=mask)
        if mask is None:
            return y[:, -1, :], new_state
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
        return torch.gather(y, 1, idx[:, None, None].expand(
            -1, 1, y.shape[2]))[:, 0, :], new_state


@register_layer
@dataclasses.dataclass
class RnnLossLayer(LossLayer):
    """Time-distributed loss layer without weights. The inherited loss
    SUMS over timesteps per example (the DL4J score convention), where
    RnnOutputLayer averages over them."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type
