"""Guarded accelerator example: transformer-LM streaming generation,
traced.

The JAX script probes for a TPU and falls back to the CPU. This one
does not fall back: it runs on the NVIDIA card (``--device cuda``, the
default) or, when asked, on the CPU (``--device cpu``); asked for a card
where there is none, it exits non-zero naming the missing card.

It trains a small character LM briefly with the step profiler attached
(data wait / dispatch / device fence, ``observability/step_profile.py``),
counts every CUDA graph capture and replay through the process-wide
watch (``observability/compile_watch.py``: on a card each training
step after the first replays a captured graph), streams a generation
through the bounded KV-cache session, and writes a Chrome trace
(``--trace``, open in Perfetto) of the whole run.

Run: python -m deeplearning4j_tpu_torch.examples.tpu_transformer_generate
     [--trace trace.json] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

from deeplearning4j_tpu_torch.examples.streaming_generation import (
    TEXT, char_batches, char_lm, kernel_launches)


def probe_card(device: str):
    """(ok, reason): whether ``device`` can run here. The CPU always
    can; ``cuda`` needs a card torch can see."""
    import torch
    if device == "cpu":
        return True, "--device cpu was requested explicitly"
    if not torch.cuda.is_available():
        return False, ("no NVIDIA card: torch.cuda.is_available() is "
                       "False (pass --device cpu to run on the CPU)")
    return True, f"card found: {torch.cuda.get_device_name(0)}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=24)
    ap.add_argument("--trace", default="tpu_generate_trace.json",
                    help="Chrome trace-event output path")
    ap.add_argument("--probe-timeout", type=float, default=90.0,
                    help="kept for the JAX script's command line; the "
                         "card probe here is torch's, in this process, "
                         "and does not hang")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ok, reason = probe_card(args.device)
    if not ok:
        print(f"cannot run on {args.device}: {reason}", file=sys.stderr)
        return 1
    print(f"running on {args.device.upper()} ({reason})")

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observability import (
        ProfilerListener, install_global_watch, trace)

    trace.enable()
    compile_stats = install_global_watch()
    mark = compile_stats.mark()

    chars = sorted(set(TEXT))
    V = len(chars)
    idx = {c: i for i, c in enumerate(chars)}
    ids = np.array([idx[c] for c in TEXT], np.int32)
    T = args.seq_len
    net = char_lm(V, T, args.device)
    profiler = ProfilerListener(frequency=8, report=False)
    net.set_listeners(profiler)

    x, y = char_batches(ids, V, T)
    with trace.span("train"):
        for epoch in range(args.epochs):
            for b in range(0, len(x), args.batch):
                net.fit(DataSet(x[b:b + args.batch],
                                y[b:b + args.batch]))
            print(f"epoch {epoch}: loss {float(net.score_value):.4f}")
    if profiler.reports:
        rep = profiler.reports[-1]
        print("step profile: "
              f"{rep['samples_per_sec']:.0f} samples/sec — "
              f"data_wait {rep['data_wait_ms']:.2f} ms, dispatch "
              f"{rep['dispatch_ms']:.2f} ms, device fence "
              f"{rep['device_fence_ms']:.2f} ms per report window")

    prompt_txt = "the quick"
    prompt = np.array([[idx[c] for c in prompt_txt]], np.int32)
    n = args.gen_tokens
    sess = net.streaming_session(capacity=prompt.shape[1] + n, batch=1)
    with trace.span("generate"):
        out_ids = sess.generate(prompt, n).cpu().numpy()[0]
    text = "".join(chars[i] for i in out_ids)
    print(f"prompt: {prompt_txt!r}")
    print(f"generated: {text!r}")
    print(f"attention kernel launches on {net.device}: "
          f"{kernel_launches()}")

    s = compile_stats.summary(mark)
    print(f"compile watch: {s['graph_captures']} CUDA graph captures, "
          f"{s['capture_secs']:.1f}s capturing, "
          f"{s['graph_replays']} replays")
    n_ev = trace.export_chrome_trace(args.trace)
    trace.disable()
    print(f"trace written: {args.trace} ({n_ev} events) — open in "
          "Perfetto / chrome://tracing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
