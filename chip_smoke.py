#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds every hand-written kernel of ``deeplearning4j_tpu_torch/csrc``
for sm_90a (and fails if ``ptxas`` reports a spill), counts the
tensor-core (HMMA) instructions of each kernel function in the built
libraries (and fails if any of the nine, three kernels at D = 32, 64
and 128, has none), holds each kernel
(the flash-attention forward, dq and dk/dv) against its plain PyTorch
version on the card, serves the full-width transformer LM (V=2048,
D=1024, L=8, H=16, T=1024; random weights from a seed) through
``ModelServer`` ``/v1/predict`` and checks what comes back, then trains
the same LM with Adam for a few steps through ``fit`` (B=8), holds one
step against the same step on the plain attention, and resumes it from
a checkpoint. It imports nothing of JAX or of the JAX package. Any
failure exits non-zero before the last line, which on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits 2 and prints no result.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

V, D_MODEL, LAYERS, HEADS, T = 2048, 1024, 8, 16, 1024
CLIENTS = 8              # concurrent one-row requests: one batch of B=8
TRAIN_B, TRAIN_STEPS = 8, 5   # the transformer_lm bench leg's batch
# Adam's rate. At the bench leg's 1e-3 the loss rises over five steps
# on one repeated batch at this width, in the JAX package as in the
# port (tests/test_torch_train.py::
# test_bench_leg_rate_diverges_at_full_width_in_both_packages, marked
# slow); at 1e-4 it falls.
TRAIN_LR = 1e-4
# kernel vs plain version, both float32 on the card (TF32 off): the
# sums run in another order, so allow a few ulps of accumulated error
ATOL, RTOL = 2e-5, 2e-4
# whole-model gradients, kernels vs plain attention: relative to each
# gradient's largest entry (f32 sums in another order through 8 layers)
GRAD_RTOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense TF32
# on the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 67e12, 495e12, 3.35e12
# An f32-accurate product on the tensor cores takes three TF32 passes
# (csrc/tf32_mma.cuh): 165 TFLOP/s, the fastest f32-accurate route on
# the card, so the bound every kernel is held to
PEAK_F32_ACCURATE_FLOPS = PEAK_TF32_FLOPS / 3


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch
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


def bound(flops, nbytes):
    """The least time for ``flops`` f32-accurate operations that move
    ``nbytes``: the larger of the operations over the 3xTF32 tensor-core
    rate and the bytes over HBM bandwidth. ``bound_cuda_core_ms`` takes
    the operations at the f32 CUDA-core rate instead (the bound of the
    kernels before they used the tensor cores)."""
    t_ops, t_bytes = flops / PEAK_F32_ACCURATE_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_cuda_core_ms": max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3}


def attention_bound(B, T_, H, D, causal, kv_mask=None):
    """``bound`` of one flash forward on these inputs: the bytes it must
    move (q, k, v, mask read once; o, lse written once) and the
    operations its live (query, key) pairs need (2D for q.k, 2D for
    p.v)."""
    import torch
    live = torch.ones(T_, T_, dtype=torch.bool)
    if causal:
        live = torch.tril(live)
    if kv_mask is None:
        pairs = float(live.sum()) * B * H
    else:
        keys = (kv_mask.cpu() > 0)[:, None, :] & live[None]
        pairs = float(keys.sum()) * H
    flops = 4.0 * D * pairs
    nbytes = 4.0 * (4 * B * T_ * H * D + B * H * T_
                    + (0 if kv_mask is None else B * T_))
    return bound(flops, nbytes)


def kernel_phase(attn):
    """Hold flash_attention_fwd against its plain version on the card;
    time it at the LM shape. Returns the kernel's record (without
    launches)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    pad = torch.ones(8, T, device="cuda")
    pad[0, T // 2:] = 0          # tail padding
    pad[3, T - 100:] = 0
    pad[5, :] = 0                # a fully masked row
    cases = [((8, T, HEADS, 64), True, None, "LM shape, causal"),
             ((8, T, HEADS, 64), False, None, "LM shape, non-causal"),
             ((8, T, HEADS, 64), True, pad, "kv_mask, causal"),
             ((8, T, HEADS, 64), False, pad, "kv_mask, non-causal"),
             ((4, 1000, HEADS, 64), True, None, "ragged T=1000"),
             ((2, T, HEADS, 128), True, None, "D=128"),
             ((2, 333, 4, 32), False, None, "D=32, ragged T=333")]
    max_err = 0.0
    for shape, causal, mask, what in cases:
        q, k, v = rand(*shape), rand(*shape), rand(*shape)
        o, lse = attn.flash_attention_fwd(q, k, v, mask, causal=causal)
        torch.cuda.synchronize()
        po, plse = attn.flash_attention_fwd_plain(q, k, v, mask,
                                                  causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, po, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)
        if mask is not None:
            assert torch.all(o[5] == 0) and torch.all(lse[5] == -1e30), \
                "a fully masked row must give o = 0 and lse = -1e30"
        err = max((o - po).abs().max().item(),
                  (lse - plse).abs().max().item())
        max_err = max(max_err, err)
        log(f"kernel case {what} {tuple(shape)}: max |kernel - plain| "
            f"= {err:.3e} (atol {ATOL}, rtol {RTOL})")
        del q, k, v, o, lse, po, plse

    B = 8
    q, k, v = rand(B, T, HEADS, 64), rand(B, T, HEADS, 64), \
        rand(B, T, HEADS, 64)
    ms = time_ms(lambda: attn.flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attn.flash_attention_fwd_plain(
        q, k, v, causal=True), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    b = attention_bound(B, T, HEADS, 64, True)
    log(f"flash_attention_fwd at (B={B}, T={T}, H={HEADS}, D=64) causal: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); kernel at "
        f"{100 * b['bound_ms'] / ms:.1f}% of the bound, "
        f"{100 * b['bound_cuda_core_ms'] / ms:.1f}% of the CUDA-core bound "
        f"{b['bound_cuda_core_ms']:.4f} ms")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "deeplearning4j_tpu/ops/attention.py:71",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def backward_bound(B, T_, H, D, causal, which):
    """``bound`` of one backward kernel on these inputs:
    dq does 6D FLOPs per live (query, key) pair (s, dp, dq) and reads
    q, k, v, o, do, lse (+ mask), writing dq and delta; dk/dv does 8D
    (s, dp, dv, dk) and reads q, k, v, do, lse, delta (+ mask), writing
    dk and dv."""
    live = T_ * (T_ + 1) / 2 if causal else T_ * T_
    flops = (6.0 if which == "dq" else 8.0) * D * live * B * H
    # six (B, T, H, D) operands and two (B, H, T) rows either way
    nbytes = 4.0 * (6 * B * T_ * H * D + 2 * B * H * T_)
    return bound(flops, nbytes)


def backward_kernel_phase(attn):
    """Hold the dq and dk/dv kernels against their plain versions on the
    card in the forward's seven cases; time them at the LM shape.
    Returns their records (without launches)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    pad = torch.ones(8, T, device="cuda")
    pad[0, T // 2:] = 0
    pad[3, T - 100:] = 0
    pad[5, :] = 0
    cases = [((8, T, HEADS, 64), True, None, "LM shape, causal"),
             ((8, T, HEADS, 64), False, None, "LM shape, non-causal"),
             ((8, T, HEADS, 64), True, pad, "kv_mask, causal"),
             ((8, T, HEADS, 64), False, pad, "kv_mask, non-causal"),
             ((4, 1000, HEADS, 64), True, None, "ragged T=1000"),
             ((2, T, HEADS, 128), True, None, "D=128"),
             ((2, 333, 4, 32), False, None, "D=32, ragged T=333")]
    err = {"dq": 0.0, "dkv": 0.0}
    for shape, causal, mask, what in cases:
        q, k, v, do = (rand(*shape) for _ in range(4))
        o, lse = attn.flash_attention_fwd(q, k, v, mask, causal=causal)
        dq, delta = attn.flash_attention_bwd_dq_cuda(
            q, k, v, o, lse, do, mask, causal=causal)
        dk, dv = attn.flash_attention_bwd_dkv_cuda(
            q, k, v, lse, delta, do, mask, causal=causal)
        torch.cuda.synchronize()
        pdq, pdelta = attn.flash_attention_bwd_dq_plain(
            q, k, v, o, lse, do, mask, causal=causal)
        pdk, pdv = attn.flash_attention_bwd_dkv_plain(
            q, k, v, lse, pdelta, do, mask, causal=causal)
        torch.cuda.synchronize()
        for a, b in ((dq, pdq), (delta, pdelta), (dk, pdk), (dv, pdv)):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
        if mask is not None:
            assert torch.all(dq[5] == 0), "a fully masked row must give dq = 0"
        e_dq = max((dq - pdq).abs().max().item(),
                   (delta - pdelta).abs().max().item())
        e_dkv = max((dk - pdk).abs().max().item(),
                    (dv - pdv).abs().max().item())
        err["dq"], err["dkv"] = max(err["dq"], e_dq), max(err["dkv"], e_dkv)
        log(f"backward case {what} {tuple(shape)}: max |kernel - plain| "
            f"dq/delta {e_dq:.3e}, dk/dv {e_dkv:.3e} (atol {ATOL}, rtol "
            f"{RTOL})")
        del q, k, v, do, o, lse, dq, delta, dk, dv, pdq, pdelta, pdk, pdv

    B = 8
    q, k, v, do = (rand(B, T, HEADS, 64) for _ in range(4))
    o, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    _, delta = attn.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do,
                                                causal=True)
    ms = {"dq": time_ms(lambda: attn.flash_attention_bwd_dq_cuda(
              q, k, v, o, lse, do, causal=True)),
          "dkv": time_ms(lambda: attn.flash_attention_bwd_dkv_cuda(
              q, k, v, lse, delta, do, causal=True))}
    plain_ms = {"dq": time_ms(lambda: attn.flash_attention_bwd_dq_plain(
                    q, k, v, o, lse, do, causal=True), iters=5),
                "dkv": time_ms(lambda: attn.flash_attention_bwd_dkv_plain(
                    q, k, v, lse, delta, do, causal=True), iters=5)}
    # the library yardstick: the whole backward of scaled_dot_product_
    # attention (f32, causal), its forward outside the timed window
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gout = do.transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), gout, retain_graph=True))
    records = []
    for which, name, line in (("dq", "flash_attention_bwd_dq", 263),
                              ("dkv", "flash_attention_bwd_dkv", 312)):
        b = backward_bound(B, T, HEADS, 64, True, which)
        log(f"{name} at (B={B}, T={T}, H={HEADS}, D=64) causal: kernel "
            f"{ms[which]:.4f} ms, plain {plain_ms[which]:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); kernel at "
            f"{100 * b['bound_ms'] / ms[which]:.1f}% of the bound, "
            f"{100 * b['bound_cuda_core_ms'] / ms[which]:.1f}% of the "
            f"CUDA-core bound {b['bound_cuda_core_ms']:.4f} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"deeplearning4j_tpu/ops/attention.py:{line}",
            "max_abs_err": err[which], "ms": ms[which],
            "plain_ms": plain_ms[which], **b, "library_ms": library_ms})
    log(f"whole backward: dq + dk/dv kernels {ms['dq'] + ms['dkv']:.4f} "
        f"ms; torch.autograd.grad through scaled_dot_product_attention "
        f"(f32, causal) {library_ms:.4f} ms (the library_ms of both "
        f"records)")
    return records


def lm_config(updater=None):
    """The transformer_lm bench leg's model as config JSON."""
    return {
        "format_version": 1,
        "network_type": "MultiLayerNetwork",
        "global": {"seed": 0, "updater": updater},
        "input_type": {"kind": "rnn", "size": V, "timesteps": T},
        "layers": ([{"@type": "EmbeddingSequenceLayer", "n_in": V,
                     "n_out": D_MODEL}]
                   + [{"@type": "TransformerEncoderLayer",
                       "n_heads": HEADS, "causal": True}] * LAYERS
                   + [{"@type": "RnnOutputLayer", "n_out": V,
                       "loss": "mcxent"}]),
        "preprocessors": {},
    }


def profile_forward(model, ids):
    """Device time of one warm ``model.output`` by kernel family, from
    torch.profiler: the flash kernel, GEMMs, everything else; and the
    share of the window the card sat idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model.output(ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.output(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"flash_attention_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        name = evt.key.lower()
        if "flash_fwd_kernel" in name:
            families["flash_attention_fwd"] += us
        elif any(s in name for s in ("gemm", "cutlass", "xmma")):
            families["gemm"] += us
        else:
            families["other"] += us
    busy_ms = sum(families.values()) / 1e3
    if busy_ms == 0:
        log("profiler: no device time recorded; breakdown not measured")
        return
    log("LM forward device time by kernel family (torch.profiler, one "
        "warm batch): " + ", ".join(
            f"{k} {v / 1e3:.2f} ms ({100 * v / 1e3 / busy_ms:.1f}%)"
            for k, v in families.items())
        + f"; busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, idle "
          f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def slice_phase(attn, card):
    """Build, save, restore and serve the full-width LM. Returns the
    main path's launch count."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, verify_checkpoint, write_model)

    t0 = time.perf_counter()
    conf = MultiLayerConfiguration.from_dict(lm_config())
    net = MultiLayerNetwork(conf, device="cuda").init(seed=0)
    n_params = sum(p.numel() for p in net.parameters())
    ids = np.random.default_rng(0).integers(
        0, V, (CLIENTS, T)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.zip")
        write_model(net, path)
        verify_checkpoint(path)
        served = restore_model(path, device="cuda")
    log(f"LM V={V} D={D_MODEL} L={LAYERS} H={HEADS} T={T}: {n_params} "
        f"params; init + write + verify + restore "
        f"{time.perf_counter() - t0:.1f} s")
    ref = net.output(ids[:2])
    assert torch.equal(served.output(ids[:2]), ref), \
        "restored model's output differs from the original's"
    del net

    registry = ModelRegistry()
    registry.register("lm", served)
    server = ModelServer(registry, max_batch_size=32, wait_ms=200.0)
    server.start()
    try:
        sched, _ = server.scheduler_for("lm")
        barrier = threading.Barrier(CLIENTS)
        replies, lat, errors = [None] * CLIENTS, [0.0] * CLIENTS, []

        def client(i):
            try:
                barrier.wait(timeout=60)
                t = time.perf_counter()
                replies[i] = post(server.port, {"model": "lm",
                                                "inputs": ids[i:i + 1]
                                                .tolist()})
                lat[i] = time.perf_counter() - t
            except Exception as e:       # reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CLIENTS)]
        attn.flash_attention_fwd_cuda.launches = 0     # main path only
        t_burst = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_burst
        launches = attn.flash_attention_fwd_cuda.launches
        assert not errors, f"requests failed: {errors}"
        assert not any(th.is_alive() for th in threads), "client hung"
        calls = sched.device_calls
        log(f"served {CLIENTS} concurrent /v1/predict requests (1 row x "
            f"{T} ids each) in {calls} batch(es), {sched.rows_served} "
            f"rows; flash_attention_fwd launches {launches}")
        assert launches == LAYERS * calls, \
            f"{launches} kernel launches for {calls} batches"
    finally:
        server.stop(drain=True)

    out = np.concatenate([np.asarray(r["outputs"], np.float32)
                          for r in replies])
    assert out.shape == (CLIENTS, T, V), out.shape
    assert np.isfinite(out).all(), "non-finite outputs"
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
    direct = served.output(ids)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out, direct.cpu().numpy(), atol=1e-6,
                               rtol=1e-4)
    device_ms = time_ms(lambda: served.output(ids), iters=3, warmup=1)
    profile_forward(served, ids)

    # the same model on the plain attention, on the card
    plain_attention = (lambda q, k, v, *, causal=False, kv_mask=None,
                       precision="default": attn.flash_attention_fwd_plain(
                           q, k, v, kv_mask, causal=causal)[0])
    kernel_attention = attn.flash_attention
    before = attn.flash_attention_fwd_cuda.launches
    attn.flash_attention = plain_attention
    try:
        plain_out = served.output(ids)
    finally:
        attn.flash_attention = kernel_attention
    assert attn.flash_attention_fwd_cuda.launches == before
    torch.testing.assert_close(direct, plain_out, atol=1e-6, rtol=1e-4)
    log(f"whole model, kernel vs plain attention on the card: max |diff| "
        f"{(direct - plain_out).abs().max().item():.3e} "
        f"(atol 1e-6, rtol 1e-4)")
    log(f"request latency s (host clock, {card}): "
        f"min {min(lat):.3f} median {sorted(lat)[CLIENTS // 2]:.3f} "
        f"max {max(lat):.3f}; burst wall {wall:.3f} s = "
        f"{CLIENTS * T / wall:.1f} tokens/s end to end; model.output "
        f"for the same {CLIENTS} rows {device_ms:.2f} ms = "
        f"{CLIENTS * T / device_ms * 1e3:.1f} tokens/s on the device "
        f"path (JSON of {V} probabilities per token is the rest)")
    return launches


def kernel_family(name):
    name = name.lower()
    for key, family in (("flash_fwd_kernel", "flash_attention_fwd"),
                        ("dkv_kernel", "flash_attention_bwd_dkv"),
                        ("dq_kernel", "flash_attention_bwd_dq")):
        if key in name:
            return family
    if any(s in name for s in ("gemm", "cutlass", "xmma")):
        return "gemm"
    return "other"


def profile_train_step(net, ds):
    """Device time of one warm training step by kernel family, from
    torch.profiler, and the share of the window the card sat idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = kernel_family(evt.key)
        families[fam] = families.get(fam, 0.0) + evt.self_device_time_total
    busy_ms = sum(families.values()) / 1e3
    if busy_ms == 0:
        log("profiler: no device time recorded; breakdown not measured")
        return
    log("LM training step device time by kernel family (torch.profiler, "
        "one warm step): " + ", ".join(
            f"{k} {v / 1e3:.2f} ms ({100 * v / 1e3 / busy_ms:.1f}%)"
            for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, idle "
          f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%")


class plain_attention:
    """Within the block, the LM's attention runs on the plain forward
    and backward (the kernels' reference), on the card."""

    def __init__(self, attn):
        self.attn = attn

    def __enter__(self):
        a = self.attn
        self.saved = a.flash_attention_fwd, a.flash_attention_bwd

        def fwd(q, k, v, kv_mask=None, *, causal=False,
                precision="default", return_lse=True):
            o, lse = a.flash_attention_fwd_plain(q, k, v, kv_mask,
                                                 causal=causal)
            return (o, lse) if return_lse else o
        a.flash_attention_fwd = fwd
        a.flash_attention_bwd = a.flash_attention_bwd_plain

    def __exit__(self, *exc):
        self.attn.flash_attention_fwd, self.attn.flash_attention_bwd = \
            self.saved


def train_phase(attn, card):
    """Train the full-width LM with Adam (TRAIN_LR) through ``fit``: one
    step held against the same step on the plain attention, TRAIN_STEPS
    steps with the loss falling and every kernel launched once per layer
    and step,
    a checkpoint round trip with the updater state, and one more step
    from the restored model equal to one from the original. Returns the
    main path's launch counts."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        _flatten, restore_model, write_model)

    conf = MultiLayerConfiguration.from_dict(
        lm_config(updaters.adam(TRAIN_LR)))
    net = MultiLayerNetwork(conf, device="cuda").init(seed=0)
    rng = np.random.default_rng(0)          # as bench.py's LM leg
    ids = rng.integers(0, V, (TRAIN_B, T)).astype("float32")
    y = np.eye(V, dtype="float32")[rng.integers(0, V, (TRAIN_B, T))]
    ds = DataSet(ids, y)

    # one step's loss and gradients: kernels vs the plain attention
    batch = net._batch_tuple(ds)
    loss_k, grads_k, _ = net._gradients(batch)
    with plain_attention(attn):
        loss_p, grads_p, _ = net._gradients(batch)
    torch.cuda.synchronize()
    # f32 sums in another order through 8 layers: each gradient within
    # GRAD_RTOL of its own largest entry, the loss within 1e-5 relative
    worst = 0.0
    flat_k, flat_p = _flatten(grads_k), _flatten(grads_p)
    assert flat_k.keys() == flat_p.keys()
    for path, gp in flat_p.items():
        scale = float(np.abs(gp).max())
        e = float(np.abs(flat_k[path] - gp).max())
        assert e <= GRAD_RTOL * scale + 1e-12, (path, e, scale)
        worst = max(worst, e / max(scale, 1e-30))
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    log(f"one training step, kernels vs plain attention on the card: loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst gradient "
        f"max|diff| / max|grad| {worst:.3e} (limit {GRAD_RTOL})")
    del grads_k, grads_p, flat_k, flat_p

    # the main path: TRAIN_STEPS steps through fit, counted and timed
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for fn in (attn.flash_attention_fwd_cuda,
               attn.flash_attention_bwd_dq_cuda,
               attn.flash_attention_bwd_dkv_cuda):
        fn.launches = 0
    for _ in range(TRAIN_STEPS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        net.fit(ds)
        t1.record()
        torch.cuda.synchronize()
        step_ms.append(t0.elapsed_time(t1))
        losses.append(float(net.score_value))
    launches = {"flash_attention_fwd": attn.flash_attention_fwd_cuda.launches,
                "flash_attention_bwd_dq":
                    attn.flash_attention_bwd_dq_cuda.launches,
                "flash_attention_bwd_dkv":
                    attn.flash_attention_bwd_dkv_cuda.launches}
    log(f"fit: {TRAIN_STEPS} Adam steps at B={TRAIN_B}, T={T}: losses "
        + ", ".join(f"{x:.6f}" for x in losses) + "; launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items()))
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    for name, n in launches.items():
        assert n == LAYERS * TRAIN_STEPS, (name, n)
    warm = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"training step time (CUDA events, {card}): steps "
        + ", ".join(f"{x:.2f}" for x in step_ms) + f" ms; warm median "
        f"{warm:.2f} ms = {TRAIN_B * T / warm * 1e3:.1f} tokens/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    profile_train_step(net, ds)

    # checkpoint with the updater state; one more step from each
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.zip")
        write_model(net, path)
        resumed = restore_model(path, device="cuda")
    assert resumed.iteration_count == net.iteration_count
    net.fit(ds)
    resumed.fit(ds)
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item() for a, b in
               zip(updaters.tree_leaves(net.params),
                   updaters.tree_leaves(resumed.params)))
    assert diff <= 1e-6, f"resumed step differs by {diff}"
    assert abs(float(net.score_value) - float(resumed.score_value)) <= 1e-6
    log(f"write_model -> restore_model with updater_state.npz, one more "
        f"step each: max |param diff| {diff:.3e} (limit 1e-6)")
    return launches


def tensor_core_ops(native):
    """HMMA (tensor-core) instructions in each kernel function of the
    built libraries, from ``cuobjdump -sass``: {"dq_kernel<64>": n, ...}.
    Fails unless all nine kernel functions (the forward, dq and dk/dv,
    each at D = 32, 64 and 128) are there and each has at least one (a
    build that fell back to FMA code has none)."""
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    counts = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", native._target(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            m = re.search(r"(flash_fwd_kernel|dkv_kernel|dq_kernel)ILi(\d+)E",
                          part.split("\n", 1)[0])
            counts[f"{m.group(1)}<{m.group(2)}>"] = len(
                re.findall(r"\bHMMA\b", part))
    log("tensor-core (HMMA) instructions per kernel function (cuobjdump "
        "-sass): " + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
    expected = {f"{kernel}<{d}>" for kernel in ("flash_fwd_kernel",
                                                "dq_kernel", "dkv_kernel")
                for d in (32, 64, 128)}
    assert set(counts) == expected, counts
    for k, n in counts.items():
        assert n > 0, f"{k} has no tensor-core instruction"
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.ops import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    for name, report in native.build_all().items():
        log(f"built {name}.cu for sm_90a:")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            assert not spills or spills.groups() == ("0", "0"), \
                f"{name}.cu spills registers: {line.strip()}"
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    hmma = tensor_core_ops(native)

    fwd = kernel_phase(attn)
    dq, dkv = backward_kernel_phase(attn)
    # the instantiations the main path launches (D = 64)
    fwd["tensor_core_ops"] = hmma["flash_fwd_kernel<64>"]
    dq["tensor_core_ops"] = hmma["dq_kernel<64>"]
    dkv["tensor_core_ops"] = hmma["dkv_kernel<64>"]
    # each path's launches: counts set to 0 just before it, read after
    fwd["launches"] = slice_phase(attn, card)
    train_launches = train_phase(attn, card)
    dq["launches"] = train_launches["flash_attention_bwd_dq"]
    dkv["launches"] = train_launches["flash_attention_bwd_dkv"]
    records = [fwd, dq, dkv]
    for record in records:
        assert record["launches"] > 0, record
        for key in ("ms", "plain_ms", "bound_ms", "bound_cuda_core_ms",
                    "library_ms", "max_abs_err"):
            assert math.isfinite(record[key]), (key, record[key])
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
