"""Bounded-cache streaming inference (counterpart of
``deeplearning4j_tpu/models/streaming.py``).

``rnn_time_step`` grows attention KV caches by concatenation. The
sessions here carry fixed-capacity caches instead, written in place
(O(t) bytes a step), with positions kept on the host, and the recurrent
layers' (h, c) carries: a ``StreamingSession`` steps (B, t) chunks at
one shared position, a ``SlotStreamingSession`` steps every slot of a
continuous batch at its own position, and a ``GraphStreamingSession``
steps a ComputationGraph. The JAX sessions compile one XLA program per
chunk length and donate the caches; here each step is a plain function under
``torch.inference_mode`` that updates the caches in place, and the
attention of every step is the paged decode kernel
(``ops/decode_attention.py``; a dense cache is one page per row).

``generate`` prefills a (B, T0) id prompt as one chunk and decodes
greedily or by temperature sampling on the device, with no host sync
per token. ``fused=True`` keeps its JAX contract (one call, sampling on
the device, the last sampled token written too, the same ids as the
unfused path for the same generator); it is a device-side loop for now.
Temperature sampling draws from an explicit ``torch.Generator`` (Gumbel
max, as ``jax.random.categorical`` samples), so sampled ids differ from
the JAX package's; greedy ids do not.

A recurrent carry advances with every step, so ``reset`` zeroes it
(attention caches need no zeroing: positions past ``pos`` are masked
and overwritten), and ``SlotStreamingSession.reset_slot`` zeroes the
slot's row. A free slot steps on its dummy input, which advances its
carry as in the JAX package; admission zeroes it. A running-statistic
carry (``GlobalPoolingLayer.apply_stream``) starts at None and ``reset``
drops it; it has no per-row reset, so a ``SlotStreamingSession`` refuses
a model that has one, as the JAX session does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["StreamingSession", "SlotStreamingSession",
           "GraphStreamingSession"]


def _fresh_carry(layer, batch: int, capacity: int, device):
    """A layer's stream carry: a zeroed KV cache, a zero recurrent (h, c),
    or None for a stateless layer."""
    if hasattr(layer, "apply_stream_bounded"):
        return layer.zero_stream_cache(batch, capacity, device)
    if hasattr(layer, "zero_state"):
        return layer.zero_state(batch, device=device)
    return None


def _host_input(x, device) -> torch.Tensor:
    """A step's input as a float32 tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class _BoundedSession:
    """Position / capacity / batch bookkeeping and autoregressive
    generation, shared by the sessions."""

    def __init__(self, capacity: int, batch: int, device):
        self.capacity = int(capacity)
        self.batch = int(batch)
        self.device = device
        self.pos = 0

    def _check(self, B: int, t: int) -> None:
        if B != self.batch:
            raise ValueError(f"batch {B} != session batch {self.batch}")
        if self.pos + t > self.capacity:
            raise ValueError(
                f"stream overflow: pos {self.pos} + chunk {t} exceeds "
                f"capacity {self.capacity} — create the session with a "
                "larger capacity or reset()")

    def _feed(self, x: torch.Tensor, pos) -> torch.Tensor:
        """The network's step on a device (B, t, C) chunk at host
        position(s) ``pos``; advances nothing. Subclass hook."""
        raise NotImplementedError

    @staticmethod
    def _sample_greedy(last: torch.Tensor) -> torch.Tensor:
        return last.argmax(dim=-1)

    @staticmethod
    def _sample_temp(last: torch.Tensor, temp: float,
                     generator: torch.Generator) -> torch.Tensor:
        """One categorical draw per row from log(probs) / temp, by the
        Gumbel-max rule (output layers emit probabilities). The same
        function, in the same order, on both generate paths is what the
        fused / unfused id parity rests on."""
        u = torch.rand(last.shape, generator=generator, device=last.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (torch.log(last + 1e-9) / temp + gumbel).argmax(dim=-1)

    def _sample(self, last, temp, generator):
        if temp > 0:
            return self._sample_temp(last, temp, generator)
        return self._sample_greedy(last)

    def generate(self, prompt, n_tokens: int, *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 fused: bool = False) -> torch.Tensor:
        """Autoregressive generation for id-input (embedding-first)
        language models: prefill the (B, T0) integer prompt as one chunk,
        then decode ``n_tokens`` greedily (temperature=0) or by
        temperature sampling from ``generator`` (default: seeded 0, on
        the session's device). Returns the (B, n_tokens) int64 ids on
        the device. Needs ``capacity >= T0 + n_tokens`` fused (the last
        sampled token is written to the cache) and ``T0 + n_tokens - 1``
        unfused."""
        prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
            prompt, torch.Tensor) else prompt)
        if prompt.dim() != 2:
            raise ValueError(f"prompt must be (B, T0) token ids; got shape "
                             f"{tuple(prompt.shape)}")
        if fused and self.pos + prompt.shape[1] + n_tokens > self.capacity:
            raise ValueError(
                f"fused generate writes every sampled token: pos "
                f"{self.pos} + prompt {prompt.shape[1]} + n_tokens "
                f"{n_tokens} exceeds capacity {self.capacity}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        temp = float(temperature)
        with torch.inference_mode():
            # EmbeddingSequenceLayer reads (B, t, 1) id channels
            probs = self.step(prompt.to(torch.float32)[:, :, None])
            last = probs[:, -1]
            if fused:
                return self._generate_fused(last, n_tokens, temp, generator)
            out = []
            for i in range(n_tokens):
                nxt = self._sample(last, temp, generator)
                out.append(nxt)
                if i + 1 < n_tokens:
                    last = self.step(nxt[:, None, None].to(torch.float32)
                                     )[:, 0]
            return torch.stack(out, dim=1)

    def _generate_fused(self, last, n_tokens: int, temp: float,
                        generator) -> torch.Tensor:
        """The whole decode in one call: sampled ids stay on the device
        and feed the next step directly, every sampled token is written
        to the cache, and nothing syncs with the host."""
        with torch.inference_mode():
            ids = []
            for _ in range(n_tokens):
                nxt = self._sample(last, temp, generator)
                ids.append(nxt)
                h = self._feed(nxt[:, None, None].to(torch.float32),
                               self.pos)
                self.pos += 1
                last = h[:, 0]
            return torch.stack(ids, dim=1)


class StreamingSession(_BoundedSession):
    """Stateful token streaming over a ``MultiLayerNetwork``.

    Built via ``net.streaming_session(capacity=..., batch=...)``.
    ``step(x)`` accepts (B, C) single steps or (B, t, C) chunks and
    returns the network output for the new steps only; feeding chunks
    sequentially equals one full-sequence forward."""

    def __init__(self, net, capacity: int, batch: int):
        super().__init__(capacity, batch, net.device)
        self.net = net
        self._states = self._fresh_states()

    def _fresh_states(self):
        return [_fresh_carry(layer, self.batch, self.capacity, self.device)
                for layer in self.net.layers]

    def _feed(self, x, pos):
        params, states = self.net.params, self.net.state
        preprocessors = self.net.conf.preprocessors
        h = x
        for i, layer in enumerate(self.net.layers):
            if i in preprocessors:
                h = preprocessors[i](h)
            if hasattr(layer, "apply_stream_bounded"):
                h, self._states[i] = layer.apply_stream_bounded(
                    params[i], self._states[i], h, pos)
            elif hasattr(layer, "zero_state"):
                h, self._states[i] = layer.apply_rnn(params[i], h,
                                                     self._states[i])
            elif hasattr(layer, "apply_stream"):
                # a per-chunk apply would pool only the newest chunk
                h, self._states[i] = layer.apply_stream(
                    params[i], self._states[i], h)
            else:
                h, _ = layer.apply(params[i], states[i], h, training=False)
        return h

    def step(self, x) -> torch.Tensor:
        """Feed the next chunk; returns outputs for the new steps.
        (B, C) input -> (B, C) output (single step, squeezed);
        (B, t, C) -> (B, t, C)."""
        x = _host_input(x, self.device)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        B, t, _ = x.shape
        self._check(B, t)
        with torch.inference_mode():
            h = self._feed(x, self.pos)
        self.pos += t
        if squeeze and h.dim() == 3:
            h = h[:, -1, :]
        return h

    def reset(self):
        """Start a new sequence: rewind the position and zero the
        recurrent carries. Attention caches need no zeroing (positions
        past ``pos`` are masked and overwritten)."""
        self.pos = 0
        for i, layer in enumerate(self.net.layers):
            if hasattr(layer, "apply_stream_bounded"):
                continue
            if hasattr(layer, "zero_state"):
                self._states[i] = layer.zero_state(self.batch,
                                                   device=self.device)
            elif hasattr(layer, "apply_stream"):
                self._states[i] = None          # the running pool restarts


class SlotStreamingSession(StreamingSession):
    """Continuous-batching substrate: a StreamingSession whose position
    is PER SLOT (a (slots,) host vector), so each batch row is an
    independent decode stream that can be reset and re-admitted while
    its neighbours keep generating.

    The JAX session vmaps the B=1 step over the slots, which makes a
    slot's logits bitwise independent of its neighbours. Here the slots
    are one batch dimension with a per-slot position: the products over
    S rows need not give B=1's bits, so a slot's probabilities agree
    with a lone decode within float32 tolerance and greedy ids are held
    equal. The positional mask makes slot reuse free: a re-admitted slot
    starts at pos 0 and never sees the previous occupant's keys."""

    def __init__(self, net, capacity: int, slots: int):
        for i, layer in enumerate(net.layers):
            if (not hasattr(layer, "apply_stream_bounded")
                    and not hasattr(layer, "zero_state")
                    and hasattr(layer, "apply_stream")):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) carries a "
                    "running statistic (apply_stream) with no per-"
                    "slot reset; SlotStreamingSession cannot host it")
        super().__init__(net, capacity, slots)
        self.slots = slots
        self.slot_pos = np.zeros((slots,), np.int32)

    def step_slots(self, x, active) -> torch.Tensor:
        """One decode step for every slot at once. ``x`` is (slots, 1, C)
        — occupied slots carry their next token, free slots a dummy
        (their output is ignored, their position does not advance, and
        they step at position 0 of their own row, which admission
        overwrites). ``active`` is a (slots,) bool mask. Returns the
        (slots, 1, V) network output for the new step."""
        x = _host_input(x, self.device)
        active = np.asarray(active, bool)
        if x.shape[0] != self.slots:
            raise ValueError(f"x has {x.shape[0]} rows; session has "
                             f"{self.slots} slots")
        if active.any() and int(self.slot_pos[active].max()) >= \
                self.capacity:
            raise ValueError(
                f"slot overflow: an active slot is at pos "
                f"{int(self.slot_pos[active].max())} with capacity "
                f"{self.capacity} — admit shorter requests or build the "
                "session with a larger capacity")
        pos = np.where(active, self.slot_pos, 0).astype(np.int32)
        with torch.inference_mode():
            h = self._feed(x, pos)
        self.slot_pos = self.slot_pos + active.astype(self.slot_pos.dtype)
        return h

    def reset_slot(self, slot: int):
        """Recycle one slot for a new request: rewind its position and
        zero its row of every recurrent carry. Attention caches need no
        zeroing."""
        self.slot_pos[slot] = 0
        with torch.inference_mode():
            for i, layer in enumerate(self.net.layers):
                if hasattr(layer, "zero_state"):
                    for carry in self._states[i]:
                        carry[slot] = 0

    def reset(self):
        super().reset()
        self.slot_pos = np.zeros((self.slots,), np.int32)

    def reinit_states(self):
        """Rebuild every cache and carry from scratch (the recovery after
        a failed step, which may have written some layers and not
        others)."""
        self.slot_pos = np.zeros((self.slots,), np.int32)
        self._states = self._fresh_states()


class GraphStreamingSession(_BoundedSession):
    """The ComputationGraph counterpart of :class:`StreamingSession`:
    one step over the vertex topology, fixed-capacity KV caches for
    attention vertices, carries for recurrent ones. Built via
    ``graph.streaming_session(capacity=..., batch=...)``; ``step`` takes
    one array per network input and returns the network output(s) for
    the new steps. ``generate`` works for single-input graphs."""

    def __init__(self, graph, capacity: int, batch: int):
        super().__init__(capacity, batch, graph.device)
        self.graph = graph
        self._states = self._fresh_states()

    def _fresh_states(self):
        return {name: _fresh_carry(obj, self.batch, self.capacity,
                                   self.device)
                for name, (obj, _ins) in self.graph.conf.vertices.items()}

    def _feed_all(self, xs, pos):
        """Every output of the graph's step on device (B, t, C) inputs
        at host position ``pos``; advances nothing."""
        from deeplearning4j_tpu_torch.nn.conf.layers.base import Layer
        conf = self.graph.conf
        params, lstates = self.graph.params, self.graph.state
        acts = dict(zip(conf.network_inputs, xs))
        for name in conf.topological_order():
            obj, ins = conf.vertices[name]
            xin = [acts[i] for i in ins]
            if hasattr(obj, "apply_stream_bounded"):
                acts[name], self._states[name] = obj.apply_stream_bounded(
                    params[name], self._states[name], xin[0], pos)
            elif hasattr(obj, "zero_state"):
                acts[name], self._states[name] = obj.apply_rnn(
                    params[name], xin[0], self._states[name])
            elif hasattr(obj, "apply_stream"):
                acts[name], self._states[name] = obj.apply_stream(
                    params[name], self._states[name], xin[0])
            elif isinstance(obj, Layer):
                acts[name], _ = obj.apply(params[name], lstates[name],
                                          xin[0], training=False)
            else:
                acts[name] = obj.apply(xin)
        return tuple(acts[o] for o in conf.network_outputs)

    def _feed(self, x, pos):
        return self._feed_all((x,), pos)[0]

    def step(self, *inputs):
        """Feed the next chunk of every input; returns the outputs for
        the new steps ((B, C) inputs give squeezed (B, C) outputs)."""
        xs = [_host_input(x, self.device) for x in inputs]
        squeeze = xs[0].dim() == 2
        if squeeze:
            xs = [x[:, None, :] for x in xs]
        B, t = xs[0].shape[0], xs[0].shape[1]
        for i, x in enumerate(xs[1:], start=1):
            if x.shape[0] != B or x.shape[1] != t:
                raise ValueError(
                    f"input {i} has (batch, t)={tuple(x.shape[:2])}; every "
                    f"input must match input 0's ({B}, {t}) — pos "
                    "advances once per step")
        self._check(B, t)
        with torch.inference_mode():
            outs = self._feed_all(tuple(xs), self.pos)
        self.pos += t
        if squeeze:
            outs = tuple(o[:, -1, :] if o.dim() == 3 else o for o in outs)
        return outs if len(outs) > 1 else outs[0]

    def reset(self):
        """Start a new sequence: rewind the position and zero the
        recurrent carries (attention caches are kept, pos-masked)."""
        self.pos = 0
        for name, (obj, _ins) in self.graph.conf.vertices.items():
            if hasattr(obj, "apply_stream_bounded"):
                continue
            if hasattr(obj, "zero_state"):
                self._states[name] = obj.zero_state(self.batch,
                                                    device=self.device)
            elif hasattr(obj, "apply_stream"):
                self._states[name] = None       # the running pool restarts
