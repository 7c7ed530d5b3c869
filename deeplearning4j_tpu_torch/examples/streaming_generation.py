"""Streaming decode and autoregressive generation, end to end.

A small character LM (embedding + causal transformer blocks, head dim
8) trains briefly, then generates text two ways and checks they agree:

1. the eager ``rnn_time_step`` path (the reference's rnnTimeStep
   contract: a concatenation-grown KV cache, one call per token);
2. the bounded ``streaming_session``: fixed-capacity KV caches updated
   in place, and ``generate()`` sampling on the device with no
   per-token host sync (``fused=True``: the sampled ids feed the next
   step without leaving the device).

On a card, training runs the flash-attention forward and backward
kernels and both decode paths the paged decode-attention kernel
(``ops/``); the launch counts are printed.

Run: python -m deeplearning4j_tpu_torch.examples.streaming_generation
     [--epochs 3] [--device cuda|cpu]
"""

import argparse

import numpy as np

TEXT = ("the quick brown fox jumps over the lazy dog and the cat "
        "sat on the mat while the dog ran in the park ") * 40


def char_lm(V, T, device):
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import InputType, updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer, TransformerEncoderLayer)
    conf = (NeuralNetConfiguration.builder().set_seed(7)
            .updater(updaters.adam(3e-3)).list()
            .layer(EmbeddingSequenceLayer(n_in=V, n_out=32))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(RnnOutputLayer(n_out=V, loss="mcxent"))
            .set_input_type(InputType.recurrent(V, T)).build())
    return MultiLayerNetwork(conf, device=device).init()


def char_batches(ids, V, T, n=256, seed=0):
    """(x, y): ``n`` next-char windows of ``T`` ids, one-hot targets."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(ids) - T - 1, n)
    x = np.stack([ids[s:s + T] for s in starts]).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[
        np.stack([ids[s + 1:s + T + 1] for s in starts])]
    return x, y


def kernel_launches():
    """The attention kernels' launch counters (0 on the CPU)."""
    from deeplearning4j_tpu_torch.ops import attention, decode_attention
    return {"flash_fwd": attention.flash_attention_fwd_cuda.launches,
            "flash_bwd_dq": attention.flash_attention_bwd_dq_cuda.launches,
            "flash_bwd_dkv":
                attention.flash_attention_bwd_dkv_cuda.launches,
            "decode": decode_attention.decode_attention_cuda.launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.data.dataset import DataSet

    chars = sorted(set(TEXT))
    V = len(chars)
    idx = {c: i for i, c in enumerate(chars)}
    ids = np.array([idx[c] for c in TEXT], np.int32)
    T = args.seq_len
    net = char_lm(V, T, args.device)

    x, y = char_batches(ids, V, T)
    for epoch in range(args.epochs):
        for b in range(0, len(x), args.batch):
            net.fit(DataSet(x[b:b + args.batch], y[b:b + args.batch]))
        print(f"epoch {epoch}: loss {float(net.score_value):.4f}")

    prompt_txt = "the quick"
    prompt = np.array([[idx[c] for c in prompt_txt]], np.int32)
    n = args.gen_tokens
    cap = prompt.shape[1] + n

    # 1. the bounded session, greedy, step by step so that the per-step
    # probabilities are observable; sess.generate(prompt, n) and
    # generate(..., fused=True) run the same loop in one call
    sess = net.streaming_session(capacity=cap, batch=1)
    p = sess.step(prompt[:, :, None].astype(np.float32)).cpu().numpy()
    last = p[:, -1]
    gen, probs_fast = [], []
    for _ in range(n):
        probs_fast.append(last[0])
        nxt = last.argmax(axis=-1)
        gen.append(int(nxt[0]))
        last = sess.step(nxt[:, None, None].astype(np.float32)
                         ).cpu().numpy()[:, 0]
    text_fast = "".join(chars[i] for i in gen)

    # fused: the sampled ids never leave the device; same computation
    # as the stepped loop, so the ids match exactly
    sess.reset()
    ids_f = sess.generate(prompt, n, fused=True).cpu().numpy()[0]
    assert list(ids_f) == gen, "fused generate diverged"
    print("fused single-call generate matches stepped loop OK")

    # 2. eager reference: rnn_time_step + host argmax per token
    net.rnn_clear_previous_state()
    probs = net.rnn_time_step(prompt[:, :, None].astype(np.float32)
                              ).cpu().numpy()
    last = probs[:, -1]
    out, probs_eager = [], []
    for _ in range(n):
        probs_eager.append(last[0])
        nxt = last.argmax(axis=-1)
        out.append(int(nxt[0]))
        last = net.rnn_time_step(nxt[:, None, None].astype(np.float32)
                                 ).cpu().numpy()[:, 0]
    text_eager = "".join(chars[i] for i in out)

    print(f"prompt: {prompt_txt!r}")
    print(f"generated (bounded session): {text_fast!r}")
    print(f"generated (eager reference): {text_eager!r}")
    # the two paths reduce attention in different orders; a near-tied
    # argmax may flip one character and diverge after it, so the
    # contract is the per-step probabilities up to the first divergence
    if text_fast != text_eager:
        k = next(i for i, (a, b) in
                 enumerate(zip(text_fast, text_eager)) if a != b)
        np.testing.assert_allclose(probs_fast[k], probs_eager[k],
                                   atol=1e-4)
        print(f"paths diverged at a float-tied step {k} "
              "(probabilities equal to 1e-4) — OK")
    print("bounded session matches eager decode OK")
    print(f"attention kernel launches on {net.device}: "
          f"{kernel_launches()}")


if __name__ == "__main__":
    main()
