"""Draft-model speculative decoding with accept-prefix semantics
(counterpart of ``deeplearning4j_tpu/models/speculative.py``).

A small draft model proposes ``k`` tokens greedily from its own KV state
(one fused proposal, ``_generate_fused``), and the target verifies all of
them in ONE chunked step: it consumes ``[last_accepted] +
proposals[:-1]`` as a (1, k) chunk, giving its next-token argmax at
every position. The longest prefix of proposals that matches the
target's argmax chain is accepted; at the first mismatch the target's
own argmax is emitted instead. Every emitted token is the target's
greedy argmax given the emitted history, so the output equals plain
greedy decode of the target alone; the draft changes only how many
target steps that costs. Rejected proposals leave stale KV entries;
rewinding ``session.pos`` is the whole rollback (the sessions mask every
cache position past pos, and later writes overwrite them), which is why
only models whose streaming state is pure KV cache qualify.

The acceptance counters are plain ints (``tokens_proposed`` /
``tokens_accepted``) and, given ``registry=``, the
``spec_tokens_proposed_total`` / ``spec_tokens_accepted_total``
counters of a metrics registry (host adds, once per round).
"""

from __future__ import annotations

import numpy as np

__all__ = ["SpeculativeDecoder"]


def _reject_unrewindable(net, role: str) -> None:
    for i, layer in enumerate(net.layers):
        if hasattr(layer, "apply_stream_bounded"):
            continue
        if hasattr(layer, "zero_state") or hasattr(layer, "apply_stream"):
            raise ValueError(
                f"{role} model layer {i} ({type(layer).__name__}) carries "
                "non-KV streaming state (recurrent carry or running "
                "statistic); speculative decode rolls back by rewinding "
                "pos, which only KV caches support")


class SpeculativeDecoder:
    """Greedy speculative decoding over two bounded streaming sessions
    (target + draft). ``generate(prompt, n_tokens)`` returns the
    target's own greedy ids. ``capacity`` needs ``prompt + n_tokens +
    k`` headroom: a verify chunk may overshoot the final length by up to
    ``k`` rejected positions before the rewind."""

    def __init__(self, target_net, draft_net, k: int = 4,
                 capacity: int = 256, registry=None,
                 endpoint: str = "speculative"):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        _reject_unrewindable(target_net, "target")
        _reject_unrewindable(draft_net, "draft")
        self.k = int(k)
        self.capacity = int(capacity)
        self.target = target_net.streaming_session(capacity=capacity,
                                                   batch=1)
        self.draft = draft_net.streaming_session(capacity=capacity,
                                                 batch=1)
        # lifetime acceptance accounting: plain ints for in-process
        # callers, registry counters (created once, here) for scrapers
        self.tokens_proposed = 0
        self.tokens_accepted = 0
        self._proposed_ctr = self._accepted_ctr = None
        if registry is not None:
            lbl = {"endpoint": endpoint}
            self._proposed_ctr = registry.counter(
                "spec_tokens_proposed_total",
                help="draft tokens proposed for verification",
                labels=lbl)
            self._accepted_ctr = registry.counter(
                "spec_tokens_accepted_total",
                help="draft tokens accepted by the target "
                     "(acceptance rate = accepted / proposed)",
                labels=lbl)

    @property
    def acceptance_rate(self) -> float:
        if not self.tokens_proposed:
            return 0.0
        return self.tokens_accepted / self.tokens_proposed

    def _count(self, proposed: int, accepted: int) -> None:
        self.tokens_proposed += proposed
        self.tokens_accepted += accepted
        if self._proposed_ctr is not None:
            self._proposed_ctr.inc(proposed)
            self._accepted_ctr.inc(accepted)

    def generate(self, prompt, n_tokens: int) -> np.ndarray:
        """Greedy-decode ``n_tokens`` ids after ``prompt`` (a 1-d or
        (1, T0) id sequence). Returns a (n_tokens,) int64 array equal to
        the target's plain greedy decode."""
        prompt = np.asarray(prompt).reshape(1, -1)
        T0 = prompt.shape[1]
        n_tokens = int(n_tokens)
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        if T0 + n_tokens + self.k > self.capacity:
            raise ValueError(
                f"prompt ({T0}) + n_tokens ({n_tokens}) + k ({self.k}) "
                f"verify headroom exceeds capacity {self.capacity}")
        tgt, drf, k = self.target, self.draft, self.k
        tgt.reset()
        drf.reset()

        def feed(toks):
            return np.asarray(toks, np.float32).reshape(1, -1, 1)

        # prefill both; the FIRST token comes from the target alone
        p_t = tgt.step(feed(prompt[0])).cpu().numpy()
        drf.step(feed(prompt[0]))
        last_tok = int(np.argmax(p_t[0, -1]))
        emitted = [last_tok]
        while len(emitted) < n_tokens:
            # draft round: consume the last accepted token, then propose
            # k more in one fused call
            d_pos0 = drf.pos
            d_probs = drf.step(feed([last_tok]))
            props = [int(t) for t in drf._generate_fused(
                d_probs[:, 0], k, 0.0, None).cpu().numpy()[0]]
            # the target verifies the round in one chunked step: P[j] is
            # its next-token distribution after [last_tok] + props[:j]
            t_pos0 = tgt.pos
            P = tgt.step(feed([last_tok] + props[:-1])).cpu().numpy()[0]
            argmax = np.argmax(P, axis=-1)
            n_acc = 0
            while n_acc < k and props[n_acc] == int(argmax[n_acc]):
                n_acc += 1
            self._count(k, n_acc)
            if n_acc == k:
                # every proposal matched: all of the chunk's KV entries
                # are valid and the last proposal feeds the next round
                emitted.extend(props)
                last_tok = props[-1]
            else:
                # accept the matching prefix, emit the target's argmax at
                # the mismatch, rewind past the stale KV
                emitted.extend(props[:n_acc])
                last_tok = int(argmax[n_acc])
                emitted.append(last_tok)
                tgt.pos = t_pos0 + 1 + n_acc
            drf.pos = d_pos0 + 1 + min(n_acc, k - 1)
        return np.asarray(emitted[:n_tokens], np.int64)
