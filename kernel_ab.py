#!/usr/bin/env python3
"""Time this checkout's hand-written kernels against another checkout's,
in turns, on one NVIDIA card.

    git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C build/other
    python3 kernel_ab.py build/other/deeplearning4j_tpu_torch/csrc

Builds every ``csrc/*.cu`` of this checkout and of the other directory
with the same ``nvcc`` flags, then times each kernel entry (the
flash-attention forward, dq and dk/dv) at the LM shape (B=8, T=1024,
H=16, D=64, causal, float32) and at head dim 256 (B=8, T=1024, H=16,
causal: the two-warpgroup kernels, or an older checkout's chunked wide
ones) with CUDA events, and the paged decode
attention at its decode shape (S=8 slots, t=1, H=16, D=64, every slot
at position 511 of 64 pages of 16 tokens) by its kernels' device time
(torch.profiler: a call's host work outlasts them), in the order other,
this, this, other, and prints one JSON line of the times in ms. The C
interfaces must be the same in both (they are each kernel's contract);
the other's outputs are held against this checkout's plain versions
first. It imports nothing of JAX or of the JAX package.
"""

import ctypes
import json
import os
import subprocess
import sys

B, T, H, D = 8, 1024, 16, 64
WIDE_D = 256      # the wide kernels' head dim, timed at (B, T, H)


def main(argv):
    import torch
    if len(argv) != 2 or not os.path.isdir(argv[1]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.ops import native
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    other_dir = os.path.abspath(argv[1])
    # the sources both checkouts have (an older one may lack a kernel)
    names = sorted(f[:-3] for f in os.listdir(native.CSRC_DIR)
                   if f.endswith(".cu")
                   and os.path.exists(os.path.join(other_dir, f)))
    native.build_all(names)
    out_dir = os.path.join(native.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {n: subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o",
         os.path.join(out_dir, n + ".so"), os.path.join(other_dir, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other {n}.cu:\n{log}")
        libs[n] = {"this": native.load(n),
                   "other": ctypes.CDLL(os.path.join(out_dir, n + ".so"))}

    def use(side):
        for n in names:
            native._libs[n] = libs[n][side]

    def time_ms(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    g = torch.Generator(device="cuda").manual_seed(0)

    def flash_entries(Dh, tag):
        """The three flash entries at (B, T, H, Dh), causal, named with
        ``tag``, and the plain versions' (o, lse, dq, dk, dv)."""
        q, k, v, do = (torch.randn(B, T, H, Dh, device="cuda", generator=g)
                       for _ in range(4))
        o, lse = attn.flash_attention_fwd_plain(q, k, v, causal=True)
        _, delta = attn.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                     causal=True)
        fns = {
            "flash_attention_fwd": lambda: attn.flash_attention_fwd_cuda(
                q, k, v, causal=True),
            "flash_attention_bwd_dq": lambda:
                attn.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do,
                                                 causal=True),
            "flash_attention_bwd_dkv": lambda:
                attn.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                  causal=True)}
        plain = (o, lse, *attn.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True))
        return {n + tag: fn for n, fn in fns.items()}, plain

    entries, plain = flash_entries(D, "")
    wide_entries, wide_plain = flash_entries(WIDE_D, f"@{WIDE_D}")
    S, P, PS = 8, 64, 16
    N = S * P + 1
    kp, vp = (torch.randn(N, PS, H, D, device="cuda", generator=g)
              for _ in range(2))
    q1 = torch.randn(S, 1, H, D, device="cuda", generator=g)
    table = (torch.randperm(N - 1, device="cuda", generator=g)[:S * P]
             .reshape(S, P).int() + 1)
    host = torch.full((S,), 511, dtype=torch.int32)
    pos = host.cuda()
    decode = lambda: da.decode_attention_cuda(q1, kp, vp, table, pos,
                                              host_pos=host)
    for side in ("other", "this"):
        use(side)
        for fns, want in ((entries, plain), (wide_entries, wide_plain)):
            fwd, dq, dkv = fns.values()
            got = (*fwd(), dq()[0], *dkv())
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4)
        torch.testing.assert_close(
            decode(), da.decode_attention_plain(q1, kp, vp, table, host),
            atol=2e-5, rtol=2e-4)

    def device_ms(fn, iters=50):
        from torch.profiler import ProfilerActivity, profile
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if "decode_" in e.key) / 1e3 / iters

    entries.update(wide_entries)
    times = {name: [] for name in entries}
    times["decode_attention"] = []
    order = ("other", "this", "this", "other")
    for side in order:
        use(side)
        for name, fn in entries.items():
            times[name].append(time_ms(fn))
        times["decode_attention"].append(device_ms(decode))
    use("this")
    print(json.dumps({"card": card, "shape": [B, T, H, D],
                      "wide_shape": [B, T, H, WIDE_D], "causal": True,
                      "order": order, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
