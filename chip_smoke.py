#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds every hand-written kernel of ``deeplearning4j_tpu_torch/csrc``
for sm_90a (and fails if ``ptxas`` reports a spill), counts the
tensor-core (HMMA) instructions of each kernel function in the built
libraries (and fails if any of the fifteen, three kernels at D = 32,
64 and 128, their chunked wide variants and the two-warpgroup kernels,
the forward's past 128 up to 256 and the backward's at 256, has none),
holds each kernel
(the flash-attention forward, dq and dk/dv, the paged decode attention)
against its plain PyTorch version on the card, at those head dims, at
4, 8, 16, 48 and 96, which the wrappers zero-pad to the next of them,
at 160, 192 and 256, which the forward reads in place and the backward
runs at 256, and (the flash kernels) at 384, where both keep their
chunked kernels (times and bounds at the true D, and over 4 heads at
the LM's width and at 384, beside
``scaled_dot_product_attention``'s forward and backward at each width;
every kernel time is held against its bound, and a time under it fails
the run),
serves the full-width
transformer LM (V=2048, D=1024, L=8, H=16, T=1024; random weights from
a seed) through ``ModelServer`` ``/v1/predict`` and checks what comes
back, trains the same LM with Adam for a few steps through ``fit``
(B=8), holds one step against the same step on the plain attention,
resumes it from a checkpoint, then generates with it through
``/v1/generate`` (continuous batching over paged KV, 8 slots, 16
concurrent requests and two prefix-cache repeats; greedy ids held
against the plain-attention reference; every decode step a replay of
the session's CUDA graph), times one decode step replayed against the
eager body it captured, and crashes the replaying worker once through
the ``serving.worker.step`` site (the next request's ids held against
the reference). On that same server it then drives the serving surface
(``serving_surface_phase``): predicts and generate bursts in mixed
priority tiers at trace sampling 1.0 and 0.0, ``/metrics`` counts and
the TTFT / inter-token histograms against what was sent, ``/readyz``,
``traceparent``, kernel launches against batches and steps, host syncs
per served step, and a circuit-breaker drill through the
``serving.worker.step`` chaos site on a second generate backend. Last
(``fleet_phase``) it serves the same model from a fleet of three port
servers behind the port's router: predicts with failover, the generate
burst split prefill -> decode across replicas through KV leases (lease
sizes, export, import and hop times, tokens/s against one server in the
same run), ``fleet.replace()`` migrating live streams, ``fleet.kill()``
under predicts, and a subprocess replica SIGKILLed. Between the two
(``warmup_phase``) a server booted through ``warmup()`` serves a burst
inside ``zero_compile_scope``, which must see no graph capture. Last
(``cnn_phase``) it holds one ResNet50 training step on the card against
the same step on the CPU (B=8, 64x64, f32 and bf16, with the bf16
dtype of every vertex), trains ResNet50 at the headline bench leg's
shape (B=128, 224x224, nesterovs) in f32 and then under the bf16
policy (step times, images/s, the bound from the config's FLOPs, a
profiled step by kernel family, batch norm, updater and weight
re-layout timed alone, peak memory), serves the trained ResNet50 from
a written and restored zip through ``/v1/predict``, and trains LeNet
on MultiLayerNetwork (step time, accuracy). Then (``rnn_phase``) it
trains ``bench.py``'s GravesLSTM char-RNN uncut (B=32, T=64, vocab 80,
2 x GravesLSTM(256), RMSProp): step time, chars/s, the share of the
bound, kernels a step, device time by family, idle share and peak
memory from a profiled step, the cuDNN LSTM beside one port GravesLSTM
layer, 200 steps on a learnable text to accuracy > 0.9; trains it under
tBPTT (4 chunks a batch) and holds a small tBPTT batch on the card
against the CPU; decodes it greedily three ways (``rnn_time_step``, a
streaming session, ``output``) to equal ids and through a zip; serves
it (``/v1/predict``) and an embedding char-RNN LM (``/v1/generate``, 16
concurrent requests on the dense slot session, greedy ids against lone
decodes); and streams a GravesLSTM + transformer stack through the
decode kernel against ``output`` on the flash forward kernel. Then
(``layers_phase``) every layer the Keras importer maps to and the port
had not (1-d, transposed, depthwise and separable convolutions, padding,
upsampling, cropping, space-to-depth/batch, 1-d pooling, layer and
local response normalization) runs forward and backward on the card
against the CPU, and (``keras_phase``) bench.py's ``vgg16_import`` leg
runs uncut: its Keras VGG16 config with Keras's default init drawn from
a seed, held in an in-memory stand-in of a Keras h5 file (the card's
machine has neither keras nor h5py; with h5py it also goes through a
real h5 file), imported onto the card by the Sequential builder (B=32,
224x224, f32: card vs CPU, warm ms, images/s, the share of the bound,
peak memory, a zip restored through the model guesser, the ``summary``
CLI), then a Keras transformer encoder block at the LM's width imported
onto ComputationGraph, its attention on the flash forward kernel (vs
the plain attention and the CPU). First of all (``tf32_phase``) both
TF32 flags are turned on, as a caller might, and the LM (2 layers) and
a dense net must still compute in float32 on the card: the flags are
off after their first layer, and the outputs within f32 tolerance of
the CPU's; every later phase runs with them off. After the Keras
phase, ``zoo_phase`` and ``pretrain_phase`` train the rest of the zoo and
the pretraining layers. Last (``etl_phase``) bench.py's
``resnet_native_etl`` leg: ResNet50 trained from a directory-per-label
tree of 520 noise PNGs (224x224, written by the port's standard-library
writer) through the port's native loader (its own PNG decoder over zlib,
built with g++): decode scaling by threads, the wait exposed under a
simulated step, the upload pageable and pinned, the warm step, e2e
images/s and the exposed ETL with the card's timeline a batch, then
``fit`` over ``AsyncDataSetIterator`` with a ``PerformanceListener``;
and (``eval_phase``) the evaluators and early stopping on the card
against the CPU: LeNet on the MNIST surrogate standardized by the
normalizer its zip carries (``evaluate``, ``evaluate_roc``), an MLP
regressor's ``evaluate_regression``, a two-output graph's
``evaluate_outputs``, and an ``EarlyStoppingTrainer`` on each device.
Every ``fit`` on the card runs through the captured training step (a
CUDA graph a batch signature). Then (``capture_phase``) the captured
step is held against the eager step on LeNet, ResNet50 at the headline
shape, the char-RNN under tBPTT and the full-width LM (its attention
kernels counted on every replay), with dropout's masks drawn anew on
each replay; ``kstep_phase`` runs bench.py's ``lenet_kstep`` leg
(steps/s and jitter at k = 1, 8, 64, every program warmed),
``aot_warmup_phase`` its ``aot_warmup`` leg (first calls cold and
warm, ``zero_compile_scope`` around the train and serve steady states)
and ``checkpoint_phase`` its ``checkpoint_async`` leg (sync and async
saves, a restore, and a JAX-written checkpoint resumed by the port's
``ElasticTrainer``). Then (``retrieval_phase``) the retrieval slice:
a 10^6 x 128 corpus (SIFT1M's shape, from a seed) built through
``index build``'s code into a brute-force index on the card (p50 / p99
and queries/s of B=32, k=10 batches through ``RetrievalService``, the
batch's device time against its byte bound, 64 queries against a
float64 oracle) and an IVF index of 1024 k-means cells (build seconds;
recall@10 against brute force, queries/s and the host / device split
at nprobe 1, 4, 16); ``/v1/search`` by text and by vector and the
``/v1/index`` verbs on a port server over that index inside
``zero_compile_scope`` after ``warmup()``; ``/v1/embed`` of 256 texts
over a 400,000 x 300 table against numpy's masked mean pool; and
bench.py's ``retrieval_serving`` soak (4 subprocess replicas behind the
router, replica 0 SIGKILLed mid-run, no request lost, recall@10 >= 0.9).
Last (``fleet_control_phase``) the fleet's control loops: a
``FleetCollector``'s QPS cost on an LM fleet, bench.py's ``rollout_soak``
on 4 full-width LM replicas (a good candidate promoted, a seeded
``bad_version`` one rolled back with one incident bundle, no gold
request lost, capacity never below 4), its ``autoscaler_soak`` shortened
(breach to recovery seconds, no gold request lost), and the autoscaler
growing a second LM replica under a generate stream and retiring it
with drain (boot seconds, first-request ms, every id as one server's).
Last of all (``ps_phase``) the asynchronous parameter server: bench.py's
``ps_async_training`` leg at its own size (3 worker threads on the card
against a synchronous SGD baseline, time to target at max_staleness 0 /
4 / 16 / unbounded, the push accounting), 2 PS workers training the LM
at full width and depth 2 through the attention kernels (counted under
``ps``; one push held against the CPU's within one quantum), and the
``train-ps`` launcher with 3 worker processes surviving one dropped push
and one server restart. After it (``dp_phase``) data parallelism over
``torch.distributed``, its ranks subprocesses of this script
(``chip_smoke.py dp-rank DIR PART...`` with the multihost variables): one
rank on nccl, then two ranks sharing the card on gloo; bench.py's
``multichip_dp_scaling`` leg uncut (dp 1 / 2 x k 1 / 8, every program
warmed, zero captures in the timed steady state; its first window
after the warmup at dp=2 against dp=1), the LM at full width and depth 2
through the attention kernels (3 Adam steps through ``fit`` on a global
batch of 8: Adam's moments after every step and the parameters at dp=2
against dp=1 within GRAD_RTOL (``dp_hold``), the replicas bit-equal,
the step and reduce times, the kernels' launches under ``dp``), a
ResNet50 step at dp=2 against
dp=1 (the batch-norm state from global statistics), the int8
compressed reduce against the full-precision one, and a device-loss
drill shrinking dp=2 to dp=1. Then (``tp_sp_pp_phase``) tensor,
sequence and pipeline parallelism, two rank processes sharing the card
(gloo): the LM at full width and depth 2, 3 Adam steps on dp_phase's
rows at sp=2 (each rank's half of the sequence, attention through the
ring on the flash kernels), tp=2 (8 heads a rank) and pp=2 (one encoder
layer a stage, 4 microbatches), each held against dp_phase's one-rank
run by ``dp_hold``, with the kernels' launches under each (``tp_sp_pp``),
the ring's, the tp all-reduces' and the pipeline's bytes and
host-staged ms a step and each stage's idle (bubble) ms; tp=2 again
with a global-norm gradient clip and a max_norm constraint on a
Megatron dense pair (``lm_tpn``: the norms over the full arrays, held
against the same config's one-rank run, every kernel launched on both
ranks, the clip's ms and share of the step); and ``serve --mesh tp=2``
as two CLI rank processes, rank 0's ``/v1/predict`` held against the
one-rank model's output. Then (``mesh_fleet_phase``) ``serve-fleet
--mesh tp=2 --replicas 2``, four rank processes on the card: a predict
burst through the router held against the one-rank model (QPS, p50), a
follower SIGKILLed under a client's predicts (its rank 0 gone, the
replica replaced, every request 200), every drained rank's
forward-kernel launches. Last (``nlp_phase``) the Word2Vec
family, which runs no kernel of the port's own (plain torch ops, as the
JAX package leaves it to XLA): skip-gram with negative sampling over
tests/test_nlp.py's 100,000-word corpus at D=300 (the step's warm ms
against its byte bound, the host's share, pairs/s) and 2048 nearest
queries; every step function (skip-gram and CBOW with negative sampling
and hierarchical softmax, PV-DBOW and PV-DM, GloVe's epoch) on the card
against its CPU run on the real streams; each other trainer fit once
(HS, CBOW, ParagraphVectors with ``infer_vector``, GloVe, DeepWalk and
Node2Vec on a two-community graph); ``TextEmbedder.from_word2vec``
behind ``/v1/embed`` and ``/v1/search``; the ``.vec`` round trip and
the ``summary`` CLI on it; ``fit(mesh=)`` at dp=2 as two gloo ranks
against one rank; and t-SNE of the 500 most frequent words. Last
(``library_phase``) the rest of the library: the full-width LM trained
4 Adam steps through ``fit`` with the stats pipeline (StatsListener ->
HealthMonitor -> FileStatsStorage, a ProfilerListener's storage, the
training UI's routes over HTTP; one report's histograms held equal to
``np.histogram``'s and its mean magnitudes and update:param ratios
within 1e-5 on the same parameters), the L-BFGS oracle against the
plain attention and 3 L-BFGS iterations on the LM (the loss falling),
every config of tests/test_gradientcheck.py and the transformer block
checked in float64 on the card, the legacy k-NN server over
retrieval_phase's 10^6 x 128 corpus (200 requests, 20 held against a
float64 brute force), the streaming route (4 (1, T) id messages
through the LM over a socket broker, published at once by a client
process, equal to ``net.output``), and the
``ui`` and ``serve-knn`` verbs as subprocesses stopped by SIGINT. Last
(``surface_phase``) the package's public surface: the README quickstart
through ``from deeplearning4j_tpu_torch import MultiLayerNetwork,
NeuralNetConfiguration`` (LeNet, 8 batches of the MNIST surrogate,
evaluated), the committed v1 checkpoint fixtures against their
``*_io.npz`` outputs, bench.py's disaggregation model (head dim 16)
trained one step and served through ``/v1/generate`` on the decode
kernel against the plain decode attention, the five card-runnable
examples at tests/test_examples.py's settings (the flash kernels
launched by the three attention ones), and ``evict_model`` on the
full-width LM served as v1 and v2 (v1's parameter and page-pool bytes
freed, v2 still answering). Then (``wide_head_phase``) the LM's config
over 4 heads (head dim 256) at depth 2: a predict and a step's
gradients against the plain attention, an Adam step, and greedy
``/v1/generate`` ids against the plain decode's; and
(``rank_examples_phase``) the two rank examples, ``data_parallel_resnet``
and ``long_context_lm``, their 4 ranks sharing the card under gloo
(the ring's flash launches counted in long_context_lm's ranks). The
fleet phases' replicas serve the LM
at full width and depth FLEET_LAYERS, and slice_phase's predicts send
SLICE_PREDICT_T ids a request (the smoke's time limit). Every phase's
wall time is logged. It imports nothing of JAX or of the
JAX package. Any
failure exits non-zero before the last line, which on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits 2 and prints no result.
"""

import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

V, D_MODEL, LAYERS, HEADS, T = 2048, 1024, 8, 16, 1024
CLIENTS = 8              # concurrent one-row requests: one batch of B=8
# ids a /v1/predict request of slice_phase: a reply is V floats an id as
# JSON (at T ids, 8 replies took 36.7 s of a burst whose forward takes
# 40.81 ms); the forward at the full T is timed, profiled and held
# against the plain attention on model.output
SLICE_PREDICT_T = 128
TRAIN_B, TRAIN_STEPS = 8, 5   # the transformer_lm bench leg's batch
# Adam's rate. At the bench leg's 1e-3 the loss rises over five steps
# on one repeated batch at this width, in the JAX package as in the
# port (tests/test_torch_train.py::
# test_bench_leg_rate_diverges_at_full_width_in_both_packages, marked
# slow); at 1e-4 it falls.
TRAIN_LR = 1e-4
# depth of the checkpoint round trips of slice_phase and train_phase
# (full width): at LAYERS the zip with the updater state (1.26 GB
# deflated) took 65.79 s to write and 12.76 s to restore of
# train_phase's 83.6 s, and slice_phase's zip of the L=8 LM 31.0 s; at
# depth 2 train_phase's write still took 17.23 s (deflate at ~20 MB/s
# on the host)
CKPT_RT_LAYERS = 1
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
# head dims the attention kernels are not instantiated for (they are at
# 32, 64 and 128): zero-padded to the next of those, at the true D's
# scale (ops/native.kernel_head_dim)
PAD_DIMS = (4, 8, 16, 48, 96)
# past 128: the two-warpgroup kernels, the forward's reading each of
# these in place (ops/native.forward_reads_in_place), the backward's at
# 256 with 160 and 192 zero-padded to it
WIDE_DIMS = (160, 192, 256)
# past 256 the forward and backward keep their chunked wide kernels
# (each CTA 128 of the output's columns, s and dp over the whole width):
# one such width checked (padded_cases) and timed over WIDE_LM_HEADS
# heads (kernel_phase, backward_kernel_phase, decode_kernel_phase)
CHUNKED_DIM = 384
# the widths timed a kernel: the padded ones and, beside them, 32 and 128
# unpadded (64 is the LM shape's, timed on its own), and the wide ones
TIMED_DIMS = (4, 8, 16, 32, 48, 96, 128) + WIDE_DIMS
# the LM's width over 4 heads: head dim D_MODEL / 4 = 256, timed at the
# LM's B and T, and driven end to end by wide_head_phase
WIDE_LM_HEADS = 4


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


def padded_cases(pad):
    """The head-dim cases of the flash kernels' checks at every PAD_DIMS
    and WIDE_DIMS width: causal at the LM's T, and a ragged T with a key
    mask (row 5 fully masked), causal and not; at CHUNKED_DIM the ragged,
    masked, causal case."""
    ragged = pad[:, :333]
    dims = PAD_DIMS + WIDE_DIMS
    return [((2, T, HEADS, D), True, None, f"D={D}, causal")
            for D in dims] + [
        ((8, 333, 4, D), causal, ragged,
         f"D={D}, ragged T=333, kv_mask, "
         + ("causal" if causal else "non-causal"))
        for D in dims for causal in (True, False)] + [
        ((8, 333, 4, CHUNKED_DIM), True, ragged,
         f"D={CHUNKED_DIM} (the chunked wide kernels), ragged T=333, "
         "kv_mask, causal")]


def kernel_phase(attn):
    """Hold flash_attention_fwd against its plain version on the card,
    at D = 32, 64, 128 and every PAD_DIMS and WIDE_DIMS width (and
    CHUNKED_DIM); time it at the LM shape, at each of those widths and,
    over WIDE_LM_HEADS heads, at the LM's width and at CHUNKED_DIM (the
    bound at the true D), each beside scaled_dot_product_attention on
    the same inputs (its backend logged), and name the kernel function
    each width ran. Returns the kernel's record (without launches)."""
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
             ((2, 333, 4, 32), False, None, "D=32, ragged T=333"),
             # the fleet phase's predicts (one-row batches of 128 ids)
             ((8, 128, HEADS, 64), True, None, "predict T=128, causal"),
             ((8, 128, HEADS, 64), False, None,
              "predict T=128, non-causal"),
             # rnn_phase's hybrid check (4 heads of 64)
             ((HYBRID_B, HYBRID_T, 4, 64), True, None,
              "hybrid T=256, 4 heads, causal")] + padded_cases(pad)
    max_err = 0.0
    err_by_dim = {}
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
        err_by_dim[shape[3]] = max(err_by_dim.get(shape[3], 0.0), err)
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
    by_dim = {}
    Hw = WIDE_LM_HEADS
    for H, D in ([(HEADS, D) for D in TIMED_DIMS]
                 + [(Hw, D_MODEL // Hw), (Hw, CHUNKED_DIM)]):
        qd, kd, vd = (rand(B, T, H, D) for _ in range(3))
        ms_d = time_ms(lambda: attn.flash_attention_fwd(qd, kd, vd,
                                                        causal=True))
        b_d = attention_bound(B, T, H, D, True)
        check_bound(ms_d, b_d, f"flash_attention_fwd at H={H}, D={D}")
        # the library yardstick at this width (the port never calls it)
        qt, kt, vt = (x.transpose(1, 2) for x in (qd, kd, vd))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        lib_d = time_ms(sdpa)
        backend = sdpa_backend(sdpa)
        key = str(D) if H == HEADS else f"{D}@H{H}"
        name = forward_kernel_name(D)
        by_dim[key] = {"kernel": name, "ms": ms_d,
                       "bound_ms": b_d["bound_ms"],
                       "bound_by": b_d["bound_by"],
                       "max_abs_err": err_by_dim[D], "library_ms": lib_d,
                       "library_kernel": backend}
        log(f"flash_attention_fwd at (B={B}, T={T}, H={H}, D={D}) "
            f"causal{forward_note(D)}: {name} {ms_d:.4f} ms a call, "
            f"bound at the true D {b_d['bound_ms']:.4f} ms "
            f"({b_d['bound_by']}); scaled_dot_product_attention "
            f"{lib_d:.4f} ms ({backend})")
        del qd, kd, vd, qt, kt, vt
    b = attention_bound(B, T, HEADS, 64, True)
    check_bound(ms, b, "flash_attention_fwd at D=64")
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
            "library_ms": library_ms, "by_head_dim": by_dim}


def native_head_dim(D):
    from deeplearning4j_tpu_torch.ops.native import kernel_head_dim
    return kernel_head_dim(D)


def forward_kernel_name(D):
    """The forward kernel function the C entry launches at head dim D
    (csrc/flash_attention_fwd.cu): the narrow kernel to 128, the
    two-warpgroup kernel past it up to 256 (in place, or at 256 on
    padded operands), the chunked wide kernel past 256."""
    Dp = native_head_dim(D)
    return ("flash_fwd_kernel" if Dp <= 128 else "flash_fwd_pair_kernel"
            if Dp <= 256 else "flash_fwd_wide_kernel")


def forward_note(D):
    from deeplearning4j_tpu_torch.ops.native import forward_reads_in_place
    if forward_reads_in_place(D):
        return ", read in place at the true D (no pad, no slice)"
    return padded_note(D)


def padded_note(D, once=False):
    Dp = native_head_dim(D)
    if Dp == D:
        return ""
    return (f", padded to {Dp} (one pad for both kernels, slices)" if once
            else f", padded to {Dp} (pad, kernel, slice)")


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


def backward_kernel_names(Dp):
    """{"dq": ..., "dkv": ...}: the backward kernel functions the C
    entries launch at padded head dim Dp (csrc/flash_attention_bwd.cu):
    the narrow kernels to 128, the two-warpgroup kernels at 256, the
    chunked wide kernels at the multiples of 128 past it."""
    kind = "_" if Dp <= 128 else "_pair_" if Dp == 256 else "_wide_"
    return {"dq": f"dq{kind}kernel", "dkv": f"dkv{kind}kernel"}


def sdpa_backend(fn, tries=3):
    """Which of scaled_dot_product_attention's backends one call of
    ``fn`` ran: the name of its longest device kernel (torch.profiler),
    with the backend it names (flash, memory-efficient / cutlass fmha,
    cuDNN; else the math route's GEMMs and softmax). A window that holds
    no device event (the profiler loses some) is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted(((e.self_device_time_total, e.key)
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        reverse=True)
        if events:
            name = events[0][1]
            low = " ".join(k for _, k in events).lower()
            kind = ("flash" if "flash" in low else "cudnn" if "cudnn" in low
                    else "memory-efficient" if ("fmha" in low
                                                or "efficient" in low)
                    else "math")
            return f"{kind}: {name[:80]}"
    return "not seen (the profiler lost the window's events)"


def backward_kernel_phase(attn):
    """Hold the dq and dk/dv kernels against their plain versions on the
    card in the forward's cases (the PAD_DIMS and WIDE_DIMS widths among
    them, and CHUNKED_DIM), and ``flash_attention_bwd_cuda`` (the path's
    route) against them; time them at the LM shape and, inside the
    path's route, at each width of TIMED_DIMS and, over WIDE_LM_HEADS
    heads, at the LM's width and at CHUNKED_DIM (the chunked kernels'
    profiler names), each width beside scaled_dot_product_attention's
    autograd backward (its backend logged). Returns their records (without
    launches)."""
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
             ((2, 333, 4, 32), False, None, "D=32, ragged T=333"),
             # the fleet phase's predicts (one-row batches of 128 ids)
             ((8, 128, HEADS, 64), True, None, "predict T=128, causal"),
             ((8, 128, HEADS, 64), False, None,
              "predict T=128, non-causal"),
             # rnn_phase's hybrid check (4 heads of 64)
             ((HYBRID_B, HYBRID_T, 4, 64), True, None,
              "hybrid T=256, 4 heads, causal")] + padded_cases(pad)
    err = {"dq": 0.0, "dkv": 0.0}
    err_by_dim = {"dq": {}, "dkv": {}}
    for shape, causal, mask, what in cases:
        q, k, v, do = (rand(*shape) for _ in range(4))
        o, lse = attn.flash_attention_fwd(q, k, v, mask, causal=causal)
        dq, delta = attn.flash_attention_bwd_dq_cuda(
            q, k, v, o, lse, do, mask, causal=causal)
        dk, dv = attn.flash_attention_bwd_dkv_cuda(
            q, k, v, lse, delta, do, mask, causal=causal)
        # the route autograd and the ring take (operands padded once for
        # both kernels): the same launches on the same values
        route = attn.flash_attention_bwd_cuda(q, k, v, o, lse, do, mask,
                                              causal=causal)
        torch.cuda.synchronize()
        for a, b in zip(route, (dq, dk, dv)):
            assert torch.equal(a, b), \
                f"flash_attention_bwd_cuda differs from dq, dk/dv: {what}"
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
        for which, e in (("dq", e_dq), ("dkv", e_dkv)):
            by = err_by_dim[which]
            by[shape[3]] = max(by.get(shape[3], 0.0), e)
        log(f"backward case {what} {tuple(shape)}: max |kernel - plain| "
            f"dq/delta {e_dq:.3e}, dk/dv {e_dkv:.3e} (atol {ATOL}, rtol "
            f"{RTOL}); flash_attention_bwd_cuda bit-identical")
        del q, k, v, do, o, lse, dq, delta, dk, dv, pdq, pdelta, pdk, pdv
        del route

    B = 8
    by_dim = {"dq": {}, "dkv": {}}
    Hw = WIDE_LM_HEADS
    for H, D in ([(HEADS, D) for D in TIMED_DIMS]
                 + [(Hw, D_MODEL // Hw), (Hw, CHUNKED_DIM)]):
        # at each width, the backward as the path runs it: one pad for
        # both kernels, dq, dk/dv, the slices; each kernel's device time
        # and the whole call's (past 128, the pair or chunked kernels')
        qd, kd, vd, dod = (rand(B, T, H, D) for _ in range(4))
        od, lsed = attn.flash_attention_fwd(qd, kd, vd, causal=True)
        names = backward_kernel_names(native_head_dim(D))
        route_ms, kern = device_times(
            lambda: attn.flash_attention_bwd_cuda(qd, kd, vd, od, lsed, dod,
                                                  causal=True),
            iters=20, kernels=tuple(names.values()))
        # the library yardstick at this width: scaled_dot_product_
        # attention's autograd backward, its forward outside the window
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (qd, kd, vd))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        grad = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dod.transpose(1, 2), retain_graph=True)
        lib_d = time_ms(grad)
        backend = sdpa_backend(grad)
        key = str(D) if H == HEADS else f"{D}@H{H}"
        for which in ("dq", "dkv"):
            b_d = backward_bound(B, T, H, D, True, which)
            ms_d = kern[names[which]]
            check_bound(ms_d, b_d,
                        f"flash_attention_bwd_{which} at H={H}, D={D}")
            by_dim[which][key] = {
                "kernel": names[which], "ms": ms_d, "route_ms": route_ms,
                "bound_ms": b_d["bound_ms"], "bound_by": b_d["bound_by"],
                "max_abs_err": err_by_dim[which][D], "library_ms": lib_d,
                "library_kernel": backend}
            log(f"flash_attention_bwd_{which} at (B={B}, T={T}, "
                f"H={H}, D={D}) causal{padded_note(D, once=True)}: "
                f"{names[which]} {ms_d:.4f} ms of device time a call "
                f"(torch.profiler) of flash_attention_bwd_cuda's "
                f"{route_ms:.4f} ms, bound at the true D "
                f"{b_d['bound_ms']:.4f} ms ({b_d['bound_by']})")
        log(f"scaled_dot_product_attention's backward at (B={B}, T={T}, "
            f"H={H}, D={D}) causal: {lib_d:.4f} ms a call ({backend}; the "
            f"library_ms of both records' width)")
        del qd, kd, vd, dod, od, lsed, qt, kt, vt, out
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
        check_bound(ms[which], b, f"{name} at D=64")
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
            "plain_ms": plain_ms[which], **b, "library_ms": library_ms,
            "by_head_dim": by_dim[which]})
    log(f"whole backward: dq + dk/dv kernels {ms['dq'] + ms['dkv']:.4f} "
        f"ms; torch.autograd.grad through scaled_dot_product_attention "
        f"(f32, causal) {library_ms:.4f} ms (the library_ms of both "
        f"records)")
    return records


def lm_config(updater=None, layers=None, heads=HEADS):
    """The transformer_lm bench leg's model as config JSON (``layers``
    transformer blocks, default LAYERS: depth is what a phase may
    cut; ``heads`` attention heads, default HEADS)."""
    return {
        "format_version": 1,
        "network_type": "MultiLayerNetwork",
        "global": {"seed": 0, "updater": updater},
        "input_type": {"kind": "rnn", "size": V, "timesteps": T},
        "layers": ([{"@type": "EmbeddingSequenceLayer", "n_in": V,
                     "n_out": D_MODEL}]
                   + [{"@type": "TransformerEncoderLayer",
                       "n_heads": heads, "causal": True}]
                     * (LAYERS if layers is None else layers)
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


def http(port, path, body=None, headers=None):
    """(status, parsed JSON body, headers) of one request; errors too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def slice_phase(attn, card):
    """Build and serve the full-width LM (its zip written, verified and
    restored at depth CKPT_RT_LAYERS). Returns the main path's launch
    count."""
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
    served = MultiLayerNetwork(conf, device="cuda").init(seed=0)
    n_params = sum(p.numel() for p in served.parameters())
    ids = np.random.default_rng(0).integers(
        0, V, (CLIENTS, T)).astype(np.float32)
    init_s = time.perf_counter() - t0
    # the zip round trip at depth CKPT_RT_LAYERS (the host's deflate)
    t0 = time.perf_counter()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        lm_config(layers=CKPT_RT_LAYERS)), device="cuda").init(seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.zip")
        write_model(net, path)
        verify_checkpoint(path)
        restored = restore_model(path, device="cuda")
    log(f"LM V={V} D={D_MODEL} L={LAYERS} H={HEADS} T={T}: {n_params} "
        f"params, init {init_s:.1f} s; write + verify + restore at depth "
        f"{CKPT_RT_LAYERS} {time.perf_counter() - t0:.1f} s")
    assert torch.equal(restored.output(ids[:2]), net.output(ids[:2])), \
        "restored model's output differs from the original's"
    del net, restored

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
                replies[i] = http(server.port, "/v1/predict", {
                    "model": "lm",
                    "inputs": ids[i:i + 1, :SLICE_PREDICT_T].tolist()})[1]
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
            f"{SLICE_PREDICT_T} ids each) in {calls} batch(es), "
            f"{sched.rows_served} "
            f"rows; flash_attention_fwd launches {launches}")
        assert launches == LAYERS * calls, \
            f"{launches} kernel launches for {calls} batches"
    finally:
        server.stop(drain=True)

    out = np.concatenate([np.asarray(r["outputs"], np.float32)
                          for r in replies])
    assert out.shape == (CLIENTS, SLICE_PREDICT_T, V), out.shape
    assert np.isfinite(out).all(), "non-finite outputs"
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        out, served.output(ids[:, :SLICE_PREDICT_T]).cpu().numpy(),
        atol=1e-6, rtol=1e-4)
    direct = served.output(ids)
    torch.cuda.synchronize()
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
        f"{CLIENTS * SLICE_PREDICT_T / wall:.1f} tokens/s end to end; "
        f"model.output of {CLIENTS} rows x {T} ids {device_ms:.2f} ms = "
        f"{CLIENTS * T / device_ms * 1e3:.1f} tokens/s on the device "
        f"path (JSON of {V} probabilities per token is the rest)")
    return launches


def kernel_family(name):
    name = name.lower()
    for key, family in ((r"flash_fwd_(wide_|pair_)?kernel",
                         "flash_attention_fwd"),
                        (r"dkv_(wide_|pair_)?kernel",
                         "flash_attention_bwd_dkv"),
                        (r"\bdq_(wide_|pair_)?kernel",
                         "flash_attention_bwd_dq")):
        if re.search(key, name):
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


class Parts:
    """Wall seconds of a phase's parts, each ending at a device sync:
    where a phase's time goes beyond what it measures."""

    def __init__(self):
        self.seconds = {}
        self.t0 = time.perf_counter()

    def __call__(self, name):
        import torch
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t0, 2)
        self.t0 = now


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
    and step; then, on the LM at depth CKPT_RT_LAYERS after one step, a
    checkpoint round trip with the updater state, and one more step
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

    part = Parts()
    conf = MultiLayerConfiguration.from_dict(
        lm_config(updaters.adam(TRAIN_LR)))
    net = MultiLayerNetwork(conf, device="cuda").init(seed=0)
    rng = np.random.default_rng(0)          # as bench.py's LM leg
    ids = rng.integers(0, V, (TRAIN_B, T)).astype("float32")
    y = np.eye(V, dtype="float32")[rng.integers(0, V, (TRAIN_B, T))]
    ds = DataSet(ids, y)

    part("init and data")
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
    part("gradients vs plain")

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
    part(f"{TRAIN_STEPS} fit steps")
    warm = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"training step time (CUDA events, {card}): steps "
        + ", ".join(f"{x:.2f}" for x in step_ms) + f" ms; warm median "
        f"{warm:.2f} ms = {TRAIN_B * T / warm * 1e3:.1f} tokens/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    profile_train_step(net, ds)
    part("profiled step")

    # checkpoint with the updater state; one more step from each
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(lm_config(
        updaters.adam(TRAIN_LR), layers=CKPT_RT_LAYERS)),
        device="cuda").init(seed=0)
    net.fit(ds)
    part(f"a step of the LM at depth {CKPT_RT_LAYERS}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.zip")
        write_model(net, path)
        part("write_model")
        resumed = restore_model(path, device="cuda")
        part("restore_model")
    assert resumed.iteration_count == net.iteration_count
    net.fit(ds)
    resumed.fit(ds)
    torch.cuda.synchronize()
    part("a step each (the resumed model's captured anew)")
    diff = max((a - b).abs().max().item() for a, b in
               zip(updaters.tree_leaves(net.params),
                   updaters.tree_leaves(resumed.params)))
    assert diff <= 1e-6, f"resumed step differs by {diff}"
    assert abs(float(net.score_value) - float(resumed.score_value)) <= 1e-6
    log(f"write_model -> restore_model with updater_state.npz (the LM at "
        f"depth {CKPT_RT_LAYERS}), one more step each: max |param diff| "
        f"{diff:.3e} (limit 1e-6)")
    log(f"train_phase parts, wall s ({card}): {json.dumps(part.seconds)}")
    return launches


PAGE, CAPACITY, SLOTS = 16, 1024, 8   # ModelServer's generate settings
GEN_REQUESTS, GEN_TOKENS = 16, 64
PROMPT_MIN, PROMPT_MAX = 16, 512       # prompt lengths, drawn uniformly
# greedy ids of the served path vs the plain-attention reference may part
# only where the reference's top two probabilities are this close
TIE_RTOL = 1e-5


def device_times(fn, iters=50, kernels=(), tries=5, fixed=True):
    """Device time of one call of ``fn``, from torch.profiler over a
    window of ``iters`` warm calls: (the CUDA events' ms a call, {each
    of ``kernels`` (name substrings): its ms a call}). The profiler
    loses events now and then (a process's first window, or one kernel
    of a window), so a window counts only if it holds ``iters`` of each
    of ``kernels`` and, where ``fn`` launches the same kernels every
    call (``fixed``), a multiple of ``iters`` device events; one that
    does not is logged and taken again, and after ``tries`` such
    windows the call fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        count = sum(c for _, c, _ in events)
        named = {k: [(c, us) for key, c, us in events if k in key]
                 for k in kernels}
        counts = {k: sum(c for c, _ in v) for k, v in named.items()}
        if count and (count % iters == 0 or not fixed) \
                and all(n == iters for n in counts.values()):
            return (sum(us for _, _, us in events) / 1e3 / iters,
                    {k: sum(us for _, us in v) / 1e3 / iters
                     for k, v in named.items()})
        log(f"device_times: window {attempt + 1} of {tries} holds {count} "
            f"device events for {iters} calls ({counts} of the named "
            "kernels); taken again")
    raise RuntimeError(f"torch.profiler lost device events in {tries} "
                       "windows")


def device_ms(fn, iters=50, kernels=(), fixed=True):
    """The device ms of one call of ``fn`` (``device_times``)."""
    return device_times(fn, iters, kernels, fixed=fixed)[0]


def check_bound(ms, b, what):
    """Fail on a time under its bound: no run of the work is faster, so
    such a reading lost some of it."""
    if not ms >= b["bound_ms"]:
        raise AssertionError(f"{what}: {ms} ms is under its bound "
                             f"{b['bound_ms']} ms ({b['bound_by']})")


# the decode wrapper's own launches a call (csrc/decode_attention.cu)
DECODE_KERNELS = ("decode_split_kernel", "decode_merge_kernel")


def decode_bound(S, t, H, D, pos, P):
    """``bound`` of one decode-attention call: the live k/v rows (each
    read once), q, the page table and o; 4D FLOPs per live (query, key)
    pair."""
    pairs = sum(p + i + 1 for p in pos for i in range(t)) * H
    live_rows = sum(p + t for p in pos)
    nbytes = 4.0 * (2 * live_rows * H * D + 2 * S * t * H * D + S * P)
    return bound(4.0 * D * pairs, nbytes)


def paged_inputs(g, S, t, D, pos, ps=PAGE, P=CAPACITY // PAGE, H=HEADS):
    """q, pools and a shuffled page table (pages 1..S*P; 0 is scratch) for
    slots at ``pos``, with H heads."""
    import torch
    N = S * P + 1
    kp = torch.randn(N, ps, H, D, device="cuda", generator=g)
    vp = torch.randn(N, ps, H, D, device="cuda", generator=g)
    q = torch.randn(S, t, H, D, device="cuda", generator=g)
    table = (torch.randperm(N - 1, device="cuda", generator=g)[:S * P]
             .reshape(S, P).int() + 1)
    return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32)


def session_pools(da, kp, vp):
    """``kp``, ``vp`` copied into pools laid out as the sessions allocate
    them (``zero_kv_pool``: at a padded head dim, the D-wide view of a
    buffer at the kernel's width, which the kernel reads in place)."""
    out = []
    for p in (kp, vp):
        pool = da.zero_kv_pool(*p.shape, device=p.device)
        pool.copy_(p)
        out.append(pool)
    return out


def decode_kernel_phase(da):
    """Hold the paged decode-attention kernel against its plain version
    on the card at D = 32, 64, 128 and every PAD_DIMS and WIDE_DIMS width
    (at a padded one on the sessions' padded pools, the dense case on a
    contiguous pool the wrapper pads by a copy)
    (page edges, chunk edges of the split
    kernel with positions read from device memory, t = 1, 4, 16 and 128,
    a shared prefix, a dense cache, an inactive slot, and at D = 64 the
    hybrid check's dense cache of 4 rows x 256, 4 heads), check that two
    launches on the same inputs give the same bits, and time it at the
    decode shape (S=8 slots, H=16, D=64, t=1, every slot at position 511
    of a 1024-token page table of 16-token pages), at each width of
    TIMED_DIMS and, over WIDE_LM_HEADS heads, at the LM's width and at
    CHUNKED_DIM (held against the plain version there first; the bound
    at the true D). Returns its record (without launches)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    err_by_dim = {}
    c = da.KEY_CHUNK
    for D in (32, 64, 128) + PAD_DIMS + WIDE_DIMS:
        cases = []
        q, kp, vp, table, pos = paged_inputs(
            g, 8, 1, D, [0, 1, 15, 16, 17, 511, 1023, 0])
        table[7] = 0                  # inactive slot: scratch page, pos 0
        cases.append(("t=1 paged, pages edges, one inactive slot",
                      q, kp, vp, table, pos))
        for t in (1, 16):
            # the split kernel's chunk edges, positions on the device
            q, kp, vp, table, pos = paged_inputs(
                g, 8, t, D, [0, 15, 16, c - 1, c, 511, 1024 - t, 0])
            table[7] = 0
            cases.append((f"t={t} chunk edges ({c} keys a CTA), device "
                          "positions, one inactive slot", q, kp, vp, table,
                          pos.cuda()))
        q, kp, vp, table, pos = paged_inputs(g, 2, 1, D, [40, 300])
        table[1, :2] = table[0, :2]   # a prefix shared by two slots
        cases.append(("shared prefix pages", q, kp, vp, table, pos))
        cases.append(("t=4 at 300", *paged_inputs(g, 1, 4, D, [300])))
        cases.append(("t=128 at 0 and 300",
                      *paged_inputs(g, 2, 128, D, [0, 300])))
        q, kp, vp, _, pos = paged_inputs(g, 3, 1, D, [1023, 5, 0],
                                         ps=CAPACITY, P=1)
        cases.append(("dense cache, page_size = capacity", q, kp, vp,
                      torch.arange(3, dtype=torch.int32,
                                   device="cuda")[:, None], pos))
        if D == 64:
            # rnn_phase's hybrid: its dense session's 4 rows, 4 heads
            for at in ([0] * 4, [HYBRID_T - 1] * 4, [0, 127, 128, 255]):
                q, kp, vp, _, pos = paged_inputs(
                    g, HYBRID_B, 1, D, at, ps=HYBRID_T, P=1, H=4)
                cases.append(("hybrid dense cache of 256, 4 heads", q, kp,
                              vp, torch.arange(HYBRID_B, dtype=torch.int32,
                                               device="cuda")[:, None], pos))
        if native_head_dim(D) != D:
            cases = [(what, q, *session_pools(da, kp, vp), table, pos)
                     if "dense" not in what else
                     (what + ", a contiguous pool (padded by a copy)", q,
                      kp, vp, table, pos)
                     for what, q, kp, vp, table, pos in cases]
        for what, q, kp, vp, table, pos in cases:
            host = pos.cpu()
            o = da.decode_attention_cuda(q, kp, vp, table, pos,
                                         host_pos=host)
            again = da.decode_attention_cuda(q, kp, vp, table, pos,
                                             host_pos=host)
            torch.cuda.synchronize()
            assert torch.equal(o, again), f"two launches differ: {what}"
            ref = da.decode_attention_plain(q, kp, vp, table, host)
            torch.cuda.synchronize()
            torch.testing.assert_close(o, ref, atol=ATOL, rtol=RTOL)
            err = (o - ref).abs().max().item()
            max_err = max(max_err, err)
            err_by_dim[D] = max(err_by_dim.get(D, 0.0), err)
            log(f"decode kernel D={D} {what} {tuple(q.shape)} pos "
                f"{host.tolist()}: max |kernel - plain| = {err:.3e} (atol "
                f"{ATOL}, rtol {RTOL}); a second launch bit-identical")
        del cases, q, kp, vp, table, o, again, ref

    S, P = SLOTS, CAPACITY // PAGE
    pos_list = [511] * S
    by_dim = {}
    Hw = WIDE_LM_HEADS
    for H, D in ([(HEADS, D) for D in TIMED_DIMS]
                 + [(Hw, D_MODEL // Hw), (Hw, CHUNKED_DIM)]):
        q, kp, vp, table, host = paged_inputs(g, S, 1, D, pos_list, H=H)
        kp, vp = session_pools(da, kp, vp)
        pos = host.cuda()
        if D not in err_by_dim:
            # a width the checks above do not reach (CHUNKED_DIM): the
            # timed inputs held against the plain version once
            o = da.decode_attention_cuda(q, kp, vp, table, pos,
                                         host_pos=host)
            ref = da.decode_attention_plain(q, kp, vp, table, host)
            torch.testing.assert_close(o, ref, atol=ATOL, rtol=RTOL)
            err_by_dim[D] = (o - ref).abs().max().item()
            max_err = max(max_err, err_by_dim[D])
            log(f"decode kernel D={D} (H={H}, S={S}, t=1, pos 511): max "
                f"|kernel - plain| = {err_by_dim[D]:.3e} (atol {ATOL}, "
                f"rtol {RTOL})")
            del o, ref
        ms_d = device_ms(lambda: da.decode_attention_cuda(
            q, kp, vp, table, pos, host_pos=host), kernels=DECODE_KERNELS)
        b_d = decode_bound(S, 1, H, D, pos_list, P)
        check_bound(ms_d, b_d, f"decode_attention at H={H}, D={D}")
        by_dim[str(D) if H == HEADS else f"{D}@H{H}"] = {
            "ms": ms_d, "bound_ms": b_d["bound_ms"],
            "bound_by": b_d["bound_by"], "max_abs_err": err_by_dim[D],
            "pool_bytes": 2 * kp.untyped_storage().nbytes()}
        log(f"decode_attention at (S={S}, t=1, H={H}, D={D}, pos 511) "
            f"on the sessions' pools{padded_note(D)}: {ms_d:.4f} ms of "
            f"device time a call (torch.profiler), bound at the true D "
            f"{b_d['bound_ms']:.4f} ms ({b_d['bound_by']}); k and v pools "
            f"{2 * kp.untyped_storage().nbytes()} bytes")
        del q, kp, vp, table

    D = 64
    q, kp, vp, table, host = paged_inputs(g, S, 1, D, pos_list)
    pos = host.cuda()                 # as the replayed step passes them
    # the library yardstick, never called by the port: gather each slot's
    # virtual cache and run scaled_dot_product_attention under the
    # positional mask (built once, outside the timed callable)
    k_pos = torch.arange(P * PAGE, device="cuda")
    mask = (k_pos[None, :] <= pos[:, None])[:, None, None, :]
    tl = table.long()

    def library():
        k = kp[tl].reshape(S, P * PAGE, HEADS, D).transpose(1, 2)
        v = vp[tl].reshape(S, P * PAGE, HEADS, D).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                              attn_mask=mask)

    torch.testing.assert_close(
        library().transpose(1, 2),
        da.decode_attention_cuda(q, kp, vp, table, pos, host_pos=host),
        atol=ATOL, rtol=RTOL)
    calls = {"kernel": lambda: da.decode_attention_cuda(
                 q, kp, vp, table, pos, host_pos=host),
             "plain": lambda: da.decode_attention_plain(
                 q, kp, vp, table, pos, host_pos=host),
             "library": library}
    # a call's host work (checks, ctypes) outlasts this kernel, so CUDA
    # events over back-to-back calls time the host; the device time per
    # call (the split and merge kernels together) comes from
    # torch.profiler
    per_call = {k: time_ms(fn, iters=100, warmup=10)
                for k, fn in calls.items()}
    ms, plain_ms, library_ms = (
        device_ms(calls[k], kernels=DECODE_KERNELS if k == "kernel" else ())
        for k in ("kernel", "plain", "library"))
    b = decode_bound(S, 1, HEADS, D, pos_list, P)
    for k, t in (("kernel", ms), ("plain", plain_ms), ("library", library_ms)):
        check_bound(t, b, f"decode_attention's {k} at D={D}")
    log(f"decode_attention at (S={S}, t=1, H={HEADS}, D={D}, pos 511, "
        f"page_size {PAGE}, {da.n_key_splits(P * PAGE)} key chunks a "
        f"(slot, head)), device time per call (torch.profiler): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, gather + "
        f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); kernel at "
        f"{100 * b['bound_ms'] / ms:.1f}% of the bound. CUDA events over "
        f"back-to-back calls: kernel {per_call['kernel']:.4f}, plain "
        f"{per_call['plain']:.4f}, library {per_call['library']:.4f} ms "
        "a call")
    return {"name": "decode_attention", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
            "replaces": "deeplearning4j_tpu/nn/conf/layers/attention.py:290",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms, "by_head_dim": by_dim}


class plain_decode_attention:
    """Within the block, every decode attention runs on the plain
    version (the kernel's reference), on the card."""

    def __init__(self, da):
        self.da = da

    def __enter__(self):
        self.saved = self.da.decode_attention
        self.da.decode_attention = self.da.decode_attention_plain

    def __exit__(self, *exc):
        self.da.decode_attention = self.saved


def check_greedy(net, da, prompt, ids, n_tokens=GEN_TOKENS,
                 capacity=CAPACITY):
    """Hold served greedy ids against ``streaming_session(capacity,
    batch=1).generate`` on the plain decode attention. A mismatch passes
    only at a step where the reference's top two probabilities are
    within TIE_RTOL of each other (then the comparison stops there).
    Returns the number of ids compared."""
    import numpy as np
    with plain_decode_attention(da):
        ref = net.streaming_session(capacity=capacity, batch=1).generate(
            np.asarray(prompt)[None], n_tokens)[0].cpu().numpy()
    ids = np.asarray(ids)
    bad = np.flatnonzero(ids != ref)
    if bad.size == 0:
        return ids.size
    m = int(bad[0])
    with plain_decode_attention(da):          # the reference at step m
        sess = net.streaming_session(capacity=capacity, batch=1)
        probs = sess.step(np.asarray(prompt, np.float32)[None, :, None])
        for tok in ref[:m]:
            probs = sess.step(np.full((1, 1, 1), tok, np.float32))
        top2 = probs[0, -1].double().topk(2).values.cpu().numpy()
    gap = (top2[0] - top2[1]) / top2[0]
    assert gap <= TIE_RTOL, (
        f"served ids part from the reference at step {m} ({ids[m]} vs "
        f"{ref[m]}), where its top two probabilities are {top2} (relative "
        f"gap {gap:.3e} > {TIE_RTOL})")
    log(f"near tie: served ids part from the reference at step {m} "
        f"({ids[m]} vs {ref[m]}); reference top two probabilities {top2}, "
        f"relative gap {gap:.3e} <= {TIE_RTOL}; comparison stops there")
    return m


SYNC_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize")
# the CUDA runtime / driver calls that launch work: a kernel each, or a
# whole captured graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
HOST_CALLS = LAUNCH_CALLS + SYNC_CALLS + ("cudaEventSynchronize",)


def sync_calls(prof, names=SYNC_CALLS):
    """How many times the window called each of ``names`` (CUDA runtime
    calls, recorded by the profiler for every thread of the process)."""
    counts = dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        if evt.key in counts:
            counts[evt.key] += evt.count
    return counts


def hist_since(h, before):
    """What histogram ``h`` recorded since ``before`` (an earlier
    ``h.bucket_counts()``), as a histogram of its own: one burst's
    counts and interpolated quantiles."""
    from deeplearning4j_tpu_torch.observability.registry import Histogram
    edges, counts, count, total = h.bucket_counts()
    d = Histogram(h.name, buckets=edges)
    d.counts = [a - b for a, b in zip(counts, before[1])]
    d.count, d.sum = count - before[2], total - before[3]
    return d


def profile_decode_step(step, x, active, what, n=5):
    """Device time of a warm decode step by kernel family, the share of
    the window the card sat idle, and the host's CUDA calls a step, from
    torch.profiler over ``n`` steps of ``step``, each with the
    probabilities' copy back (as the batcher serves a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(x, active).cpu()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    families, kernels, host = {}, 0, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append((evt.self_cpu_time_total, evt.key, evt.count))
            continue
        name = evt.key.lower()
        fam = ("decode_attention" if "decode_split_kernel" in name
               or "decode_merge_kernel" in name
               else "gemm" if any(k in name for k in (
                   "gemm", "gemv", "cutlass", "xmma", "splitk"))
               else "other")
        families[fam] = families.get(fam, 0.0) + \
            evt.self_device_time_total / n
        kernels += evt.count
    calls = {k: v / n for k, v in sync_calls(prof, HOST_CALLS).items() if v}
    busy_ms = sum(families.values()) / 1e3
    if busy_ms == 0:
        log(f"profiler: no device time recorded for the {what} step; "
            "breakdown not measured")
        return None
    idle = max(0.0, 1 - busy_ms / wall_ms)
    log(f"{what} decode step, torch.profiler over {n} warm steps at "
        f"{SLOTS} active slots ({kernels / n:.0f} device activities a "
        f"step), a step: " + ", ".join(
            f"{k} {v / 1e3:.4f} ms ({100 * v / 1e3 / busy_ms:.1f}%)"
            for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall, idle "
          f"{100 * idle:.1f}%; host CUDA calls a step: " + ", ".join(
              f"{k} x{v:g}" for k, v in calls.items()))
    log(f"{what} decode step host time, heaviest ops by self CPU time "
        "(under the profiler, a step): " + ", ".join(
            f"{k} {us / 1e3 / n:.3f} ms x{c / n:g}" for us, k, c in
            sorted(host, reverse=True)[:8]))
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "idle": idle,
            "calls": calls}


def time_decode_step(net, da, card):
    """One decode step at SLOTS active slots near position 512: the
    session's replayed CUDA graph against the eager body it captured,
    and the eager body on the plain decode attention (CUDA events over
    the step, host clock beside), their outputs held together, and each
    one's profiler breakdown and host calls."""
    import numpy as np
    import torch
    sess = net.paged_slot_streaming_session(capacity=CAPACITY, slots=SLOTS,
                                            page_size=PAGE)
    for s in range(SLOTS):
        # distinct prompts: no prefix sharing; the pages' contents do not
        # change the step's work
        sess.bind(s, sess.reserve(np.arange(512) * (s + 1) % V,
                                  GEN_TOKENS))
    active = np.ones(SLOTS, bool)
    x = np.ones((SLOTS, 1, 1), np.float32)

    def step_ms(step, n=20):
        sess.slot_pos[:] = 500
        for _ in range(3):
            step(x, active)
        torch.cuda.synchronize()
        ev, host = [], []
        for _ in range(n):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            t0.record()
            step(x, active)
            t1.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - h0) * 1e3)
            ev.append(t0.elapsed_time(t1))
        return sorted(ev)[n // 2], sorted(host)[n // 2]

    sess.slot_pos[:] = 511
    h0 = time.perf_counter()
    sess.step_slots(x, active)        # the first step: run and capture
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - h0) * 1e3
    sess.slot_pos[:] = 511
    replayed = sess.step_slots(x, active).clone()
    sess.slot_pos[:] = 511
    eager = sess._step_eager(x, active)
    torch.testing.assert_close(replayed, eager, atol=1e-6, rtol=0)
    diff = (replayed - eager).abs().max().item()
    graph = step_ms(sess.step_slots)
    body = step_ms(sess._step_eager)
    with plain_decode_attention(da):
        plain = step_ms(sess._step_eager)
    log(f"one decode step at {SLOTS} active slots, positions 503-523, "
        f"CUDA events (median of 20, {card}): replayed CUDA graph "
        f"{graph[0]:.4f} ms (host {graph[1]:.4f} ms), the eager body "
        f"{body[0]:.4f} ms (host {body[1]:.4f} ms), the eager body on the "
        f"plain decode attention {plain[0]:.4f} ms (host {plain[1]:.4f} "
        f"ms); the first step (eager run + capture) {capture_ms:.1f} ms; "
        f"replayed vs eager outputs at position 511: max |diff| "
        f"{diff:.3e} (atol 1e-6)")
    sess.slot_pos[:] = 511
    prof = {"replayed": profile_decode_step(sess.step_slots, x, active,
                                            "replayed")}
    sess.slot_pos[:] = 511
    prof["eager"] = profile_decode_step(sess._step_eager, x, active,
                                        "eager")
    for name, (_, host_ms) in (("replayed", graph), ("eager", body)):
        if prof[name] is not None:
            busy = prof[name]["busy_ms"]
            log(f"{name} decode step: device busy {busy:.4f} ms of the "
                f"unprofiled step's {host_ms:.4f} ms on the host clock: "
                f"idle {100 * (1 - busy / host_ms):.1f}%")
    # the same step again once the profiler has run: does a finished
    # torch.profiler session leave the host slower?
    after = step_ms(sess.step_slots)
    log(f"the same replayed decode step after the profiler ran ({card}): "
        f"{after[0]:.4f} ms (host {after[1]:.4f} ms)")
    return {"graph": graph, "eager": body, "plain": plain, "prof": prof}


def generate_bodies():
    """The generate burst: GEN_REQUESTS prompts of PROMPT_MIN-PROMPT_MAX
    ids from ``default_rng(0)``, GEN_TOKENS tokens each, every fourth at
    temperature 0.8 with a seed of its own."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, GEN_REQUESTS)
    bodies = []
    for i, n in enumerate(lengths):
        body = {"model": "lm", "prompt": rng.integers(0, V, n).tolist(),
                "n_tokens": GEN_TOKENS}
        if i % 4 == 3:                # 4 of 16 sample at temperature 0.8
            body.update(temperature=0.8, seed=100 + i)
        bodies.append(body)
    return bodies


def generate_phase(da, card):
    """Serve the full-width LM through ``/v1/generate``
    (ModelServer(slots=8, capacity=1024, page_size=16), the default 512
    pages): GEN_REQUESTS concurrent requests, then two that repeat a
    finished prompt (prefix-cache hits). Holds greedy ids against the
    plain-attention reference, counts the decode kernel's launches
    against the batcher's steps, checks the pages return to what the
    prefix cache holds, and times the path. Returns the launch count,
    the model, the running server (for serving_surface_phase, which
    stops it) and the request bodies."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(lm_config()),
                            device="cuda").init(seed=0)
    bodies = generate_bodies()
    lengths = [len(b["prompt"]) for b in bodies]
    repeat = next(b for b in bodies if "temperature" not in b
                  and len(b["prompt"]) >= 64)
    registry = ModelRegistry()
    registry.register("lm", net)
    server = ModelServer(registry, slots=SLOTS, capacity=CAPACITY,
                         page_size=PAGE)
    server.start()
    try:
        batcher, _ = server.batcher_for("lm")
        assert batcher._paged and batcher.session.pages_total() == \
            SLOTS * CAPACITY // PAGE          # the default pool
        http(server.port, "/v1/generate", {"model": "lm", "prompt": [1, 2, 3],
                                           "n_tokens": 2})       # warm
        replies = [None] * GEN_REQUESTS
        lat = [0.0] * GEN_REQUESTS
        errors = []
        barrier = threading.Barrier(GEN_REQUESTS)

        def client(i):
            try:
                barrier.wait(timeout=60)
                t = time.perf_counter()
                replies[i] = http(server.port, "/v1/generate",
                                  bodies[i])[:2]
                lat[i] = time.perf_counter() - t
            except Exception as e:       # reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(GEN_REQUESTS)]
        stream = batcher._stream
        before = [h.bucket_counts() for h in
                  (stream.ttft, stream.ttft_hit, stream.itl)]
        steps0 = batcher.device_steps
        da.decode_attention_cuda.launches = 0          # main path only
        t_burst = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t_burst
        assert not errors, f"requests failed: {errors}"
        assert not any(th.is_alive() for th in threads), "client hung"
        cold, hit, itl = (hist_since(h, b) for h, b in zip(
            (stream.ttft, stream.ttft_hit, stream.itl), before))
        assert (cold.count, hit.count, itl.count) == (
            GEN_REQUESTS, 0, GEN_REQUESTS * (GEN_TOKENS - 1)), \
            (cold.count, hit.count, itl.count)
        again = [http(server.port, "/v1/generate", repeat)[:2]
                 for _ in range(2)]
        launches = da.decode_attention_cuda.launches
        steps = batcher.device_steps - steps0
        for _ in range(500):          # slots release just after replying
            if batcher.active_slots() == 0:
                break
            time.sleep(0.01)
        sess = batcher.session
        cached = {p for chain in sess.prefix_cache._entries.values()
                  for p in chain}
        log(f"/v1/generate: {GEN_REQUESTS} concurrent requests (prompts "
            f"{min(lengths)}-{max(lengths)} ids, {GEN_TOKENS} "
            f"tokens each, 4 at temperature 0.8) + 2 repeats; {steps} "
            f"decode steps, decode_attention launches {launches}; prefix "
            f"hits {batcher.prefix_hits}; pages in use {sess.pages_in_use()}"
            f" = {len(cached)} held by the prefix cache")
        assert all(code == 200 for code, _ in replies + again)
        assert launches > 0 and launches == LAYERS * steps, (launches, steps)
        assert batcher.prefix_hits >= 1
        assert sess.pages_in_use() == len(cached)
    except BaseException:
        server.stop(drain=False)
        raise

    compared = 0
    for body, (_, reply) in zip(bodies + [repeat] * 2, replies + again):
        ids = reply["ids"]
        assert len(ids) == GEN_TOKENS and all(0 <= t < V for t in ids)
        if "temperature" not in body:
            compared += check_greedy(net, da, body["prompt"], ids)
    n_greedy = sum("temperature" not in b for b in bodies) + 2
    assert again[0][1]["ids"] == again[1][1]["ids"]
    log(f"greedy ids vs streaming_session.generate on the plain decode "
        f"attention: {compared} of {n_greedy * GEN_TOKENS} ids compared "
        "and equal")
    log(f"generate latency ({card}): {GEN_REQUESTS * GEN_TOKENS / wall:.1f} "
        f"generated tokens/s end to end over the burst ({wall:.3f} s); "
        f"request latency median {sorted(lat)[GEN_REQUESTS // 2]:.3f} s, max "
        f"{max(lat):.3f} s; time to first token p50 "
        f"{cold.quantile(0.5):.3f} s, p99 {cold.quantile(0.99):.3f} s; "
        f"inter-token p50 {1e3 * itl.quantile(0.5):.3f} ms (host clock; "
        f"interpolated in the serving_ttft_seconds / serving_itl_seconds "
        f"buckets)")
    time_decode_step(net, da, card)
    return launches, net, server, bodies


TIERS = ("gold", "standard", "best_effort")
SURFACE_PREDICT_T = 128   # ids a row: the reply's JSON stays a few MB
PROFILE_TOKENS = 32       # tokens a request in the profiled bursts
WARM_REQUESTS = 8         # greedy requests in the post-warmup burst


def warmup_phase(card):
    """A ModelServer booted through ``warmup()`` (the path of ``serve
    --aot-warmup``) on the LM with random weights from seed 0 and an
    InputType of one id a timestep (so the predict buckets are the
    shapes /v1/predict takes): its report, one capture during warmup,
    then a generate burst inside ``zero_compile_scope``, which must see
    no capture (every step replays the graph warmup captured), greedy
    ids held against the plain-decode reference."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

    conf = lm_config()
    conf["input_type"] = {"kind": "rnn", "size": 1, "timesteps": T}
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                            device="cuda").init(seed=0)
    stats = install_global_watch()
    registry = ModelRegistry()
    registry.register("lm", net)
    server = ModelServer(registry, slots=SLOTS, capacity=CAPACITY,
                         page_size=PAGE)
    mark = stats.mark()
    rep = server.warmup()["lm"]
    during = stats.summary(mark)
    log(f"aot warmup: lm v{rep['version']} — predict buckets "
        f"{rep['predict_buckets']}, generate={rep['generate']} "
        f"({rep['seconds']:.1f}s" + (f"; skipped: "
                                     f"{'; '.join(rep['skipped'])}"
                                     if rep["skipped"] else "")
        + f"); during warmup: {during}")
    assert rep["generate"] and not rep["skipped"], rep
    assert rep["predict_buckets"] == [1, 2, 4, 8, 16, 32], rep
    assert during["graph_captures"] == 1, during
    server.start()
    try:
        bodies = surface_bodies([PROMPT_MIN * (i + 1)
                                 for i in range(WARM_REQUESTS)], 31)
        with stats.zero_compile_scope("post-warmup generate burst"):
            m = stats.mark()
            replies, wall = burst(server.port, "/v1/generate", bodies)
            after = stats.summary(m)
        assert after["graph_captures"] == 0 and \
            after["graph_replays"] > 0, after
        compared = sum(check_greedy(net, da, b["prompt"], r[1]["ids"])
                       for b, r in zip(bodies, replies))
    finally:
        server.stop(drain=True)
    log(f"post-warmup burst of {WARM_REQUESTS} greedy /v1/generate inside "
        f"zero_compile_scope ({card}): {after}; "
        f"{WARM_REQUESTS * GEN_TOKENS / wall:.1f} tokens/s ({wall:.3f} s); "
        f"greedy ids vs the plain-decode reference: {compared} of "
        f"{WARM_REQUESTS * GEN_TOKENS} compared and equal")


def crash_drill(server, net, da):
    """The ``serving.worker.step`` crash site on the generate backend
    whose steps replay a captured graph: the request in flight fails,
    the worker restarts, the session keeps its graph, and the next
    greedy request's ids equal the plain-decode reference."""
    from deeplearning4j_tpu_torch import chaos
    batcher, _ = server.batcher_for("lm")
    graph = batcher.session._graph
    assert graph is not None, "the generate backend never captured a step"
    crashes = server.metrics.registry.get(
        "serving_worker_crashes_total", labels={"endpoint": "generate/lm/v1"})
    crashes0 = crashes.value if crashes is not None else 0
    body = {"model": "lm",
            "prompt": surface_bodies([3 * PROMPT_MIN], 41)[0]["prompt"],
            "n_tokens": GEN_TOKENS}
    chaos.install({"faults": [{"site": "serving.worker.step",
                               "kind": "crash", "p": 1.0,
                               "max_fires": 1}]}, seed=0)
    quiet = logging.getLogger("deeplearning4j_tpu_torch")
    quiet.disabled = True             # the crash's traceback is expected
    try:
        doomed = http(server.port, "/v1/generate", body)
    finally:
        chaos.uninstall()
        quiet.disabled = False
    code, reply, _ = http(server.port, "/v1/generate", body)
    crashed = server.metrics.registry.get(
        "serving_worker_crashes_total",
        labels={"endpoint": "generate/lm/v1"}).value - crashes0
    assert doomed[0] != 200 and code == 200, (doomed[:2], code)
    assert crashed == 1, crashed
    assert batcher.session._graph is graph
    compared = check_greedy(net, da, body["prompt"], reply["ids"])
    log(f"crash drill (serving.worker.step crash x1 on generate/lm/v1, "
        f"whose steps replay a CUDA graph): the request in flight got "
        f"{doomed[0]} ({str(doomed[1].get('error'))[:60]}...), "
        f"serving_worker_crashes_total +{crashed:g}; the next request "
        f"{code}, the same graph replaying, greedy ids vs the plain-decode "
        f"reference: {compared} of {GEN_TOKENS} compared and equal")


def burst(port, path, bodies, check=True):
    """Send ``bodies`` concurrently; returns (replies, wall seconds).
    With ``check``, every reply must be a 200."""
    replies, errors = [None] * len(bodies), []
    barrier = threading.Barrier(len(bodies))

    def client(i):
        try:
            barrier.wait(timeout=60)
            replies[i] = http(port, path, bodies[i])
        except Exception as e:       # reported and failed below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    assert not errors, f"requests failed: {errors}"
    assert not any(th.is_alive() for th in threads), "client hung"
    assert not check or all(r[0] == 200 for r in replies), \
        [r[:2] for r in replies if r[0] != 200]
    return replies, wall


def surface_bodies(lengths, seed):
    """The burst of serving_surface_phase: one greedy request per prompt
    length (ids drawn from ``seed``, GEN_TOKENS tokens, tiers in turn)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{"model": "lm", "prompt": rng.integers(0, V, int(n)).tolist(),
             "n_tokens": GEN_TOKENS, "tier": TIERS[i % 3]}
            for i, n in enumerate(lengths)]


def generate_burst(server, batcher, lengths, seed, rate):
    """One generate burst at trace sampling ``rate``: the bodies at once,
    then a repeat of the longest prompt (a prefix-cache hit). Checks the
    endpoint's counters and the streaming histograms against what was
    sent; returns its numbers."""
    server.sampler.rate = rate
    bodies = surface_bodies(lengths, seed)
    stream, ep = batcher._stream, batcher._endpoint
    hists = (stream.ttft, stream.ttft_hit, stream.itl)
    before = [h.bucket_counts() for h in hists]
    n0, e0 = ep.requests, ep.errors
    steps0 = batcher.device_steps
    _, wall = burst(server.port, "/v1/generate", bodies)
    steps = batcher.device_steps - steps0
    for _ in range(500):     # a slot registers its prompt just after replying
        if batcher.active_slots() == 0:
            break
        time.sleep(0.01)
    repeat = max(bodies, key=lambda b: len(b["prompt"]))
    code, _, _ = http(server.port, "/v1/generate", repeat)
    assert code == 200
    cold, hit, itl = (hist_since(h, b) for h, b in zip(hists, before))
    sent = len(bodies) + 1
    assert (ep.requests - n0, ep.errors - e0) == (sent, 0), \
        (ep.requests - n0, ep.errors - e0)
    assert (cold.count, hit.count) == (len(bodies), 1), \
        (cold.count, hit.count)
    assert itl.count == sent * (GEN_TOKENS - 1), itl.count
    return {"rate": rate, "tokens_s": len(bodies) * GEN_TOKENS / wall,
            "wall": wall, "steps": steps,
            "ttft_p50": cold.quantile(0.5), "itl_p50": itl.quantile(0.5)}


def profile_served_steps(server, batcher, rate):
    """cudaMemcpyAsync / cudaStreamSynchronize calls per step of the
    batcher serving SLOTS short greedy requests at trace sampling
    ``rate`` (torch.profiler over the whole burst: admission, every
    step, replies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    server.sampler.rate = rate
    bodies = surface_bodies([PAGE] * SLOTS, seed=17 + int(rate))
    for b in bodies:
        b["n_tokens"] = PROFILE_TOKENS
    steps0 = batcher.device_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        burst(server.port, "/v1/generate", bodies)
        torch.cuda.synchronize()
    steps = batcher.device_steps - steps0
    counts = sync_calls(prof)
    return {k: v / steps for k, v in counts.items()}, steps


def instrumentation_cost(server):
    """Host cost of the serving surface's instruments on this machine's
    CPU, microseconds a call (best of 3 runs of 20000 calls), and of one
    OpenMetrics scrape of the server's registry (ms, best of 5)."""
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.observability.registry import Histogram
    from deeplearning4j_tpu_torch.observability.tracing import (
        RequestContext, Sampler, Tracer)
    h = Histogram("x")
    tracer = Tracer()
    sampled = RequestContext.new("/v1/generate", Sampler(1.0), tracer=tracer)
    unsampled = RequestContext.new("/v1/generate", Sampler(0.0),
                                   tracer=tracer)
    ex = {"trace_id": sampled.trace_id}
    cases = {"histogram record": lambda: h.record(0.0065),
             "histogram record + exemplar": lambda: h.record(0.0065,
                                                             exemplar=ex),
             "phase mark, unsampled": lambda: unsampled.phase_done("decode"),
             "phase mark + span, sampled": lambda: sampled.phase_done(
                 "decode"),
             "chaos site, no plan": lambda: chaos.hit("serving.worker.step")}

    def best_us(fn, n=20000, runs=3):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append((time.perf_counter() - t0) / n * 1e6)
        return min(times)

    us = {k: best_us(fn) for k, fn in cases.items()}
    scrape_ms = best_us(lambda: server.metrics.prometheus_text(
        openmetrics=True), n=1, runs=5) / 1e3
    log("instrument host cost (this machine's CPU): " + ", ".join(
        f"{k} {v:.2f} us" for k, v in us.items())
        + f"; one OpenMetrics scrape of the server's registry "
          f"{scrape_ms:.3f} ms")
    return us


def serving_surface_phase(attn, da, card, net, server):
    """The serving surface of the generate phase's full-width server, on
    the card: 8 one-row /v1/predict requests and bursts of 8 greedy
    /v1/generate requests (+ one prefix repeat) in mixed tiers at trace
    sampling 1.0 and 0.0 (0.0, 1.0, 1.0, 0.0; the same prompt lengths,
    fresh ids each); /metrics counts against what was sent, /readyz,
    traceparent, kernel launches against batches and steps; the
    batcher's host syncs per step at both rates; then a chaos drill on a
    second generate backend (a serving.worker.step error plan opens its
    breaker, the half-open probe closes it, greedy ids and pages come
    back). Returns the launches of the forward and decode kernels in the
    predicts and bursts."""
    import numpy as np
    from deeplearning4j_tpu_torch import chaos

    port = server.port
    batcher, _ = server.batcher_for("lm")
    sched, _ = server.scheduler_for("lm")
    ids = np.random.default_rng(3).integers(0, V, (CLIENTS,
                                                   SURFACE_PREDICT_T))
    predicts = [{"model": "lm", "inputs": ids[i:i + 1].astype(
        float).tolist(), "tier": TIERS[i % 3]} for i in range(CLIENTS)]
    lengths = np.random.default_rng(0).integers(PROMPT_MIN, PROMPT_MAX + 1,
                                                SLOTS)
    # the main path: every count set to 0 just before, read just after
    calls0, steps0 = sched.device_calls, batcher.device_steps
    attn.flash_attention_fwd_cuda.launches = 0
    da.decode_attention_cuda.launches = 0
    server.sampler.rate = 1.0
    pred_ep = sched._endpoint
    p0 = pred_ep.requests
    replies, _ = burst(port, "/v1/predict", predicts)
    runs = [generate_burst(server, batcher, lengths, 100 + i, rate)
            for i, rate in enumerate((0.0, 1.0, 1.0, 0.0))]
    fwd_launches = attn.flash_attention_fwd_cuda.launches
    dec_launches = da.decode_attention_cuda.launches
    batches = sched.device_calls - calls0
    steps = batcher.device_steps - steps0
    log(f"serving surface: {CLIENTS} /v1/predict (1 x {SURFACE_PREDICT_T} "
        f"ids) in {batches} batch(es), flash_attention_fwd launches "
        f"{fwd_launches}; 4 generate bursts, {steps} decode steps, "
        f"decode_attention launches {dec_launches}")
    assert pred_ep.requests - p0 == CLIENTS
    assert fwd_launches == LAYERS * batches, (fwd_launches, batches)
    assert dec_launches == LAYERS * steps, (dec_launches, steps)
    for _, reply, hdrs in replies:
        out = np.asarray(reply["outputs"], np.float32)
        assert out.shape == (1, SURFACE_PREDICT_T, V) and \
            np.isfinite(out).all()
        assert hdrs["traceparent"].endswith("-01")
    for rate in (0.0, 1.0):
        mine = [r for r in runs if r["rate"] == rate]
        log(f"generate at trace sampling {rate} ({card}): "
            + "; ".join(f"{r['tokens_s']:.1f} tokens/s ({r['steps']} "
                        f"steps, {r['wall']:.3f} s), time to first token "
                        f"p50 {r['ttft_p50']:.3f} s, inter-token p50 "
                        f"{1e3 * r['itl_p50']:.3f} ms" for r in mine)
            + f"; mean {sum(r['tokens_s'] for r in mine) / 2:.1f} "
              "tokens/s (TTFT and ITL interpolated in the histograms' "
              "buckets)")

    # traces, readiness, the metrics exposition
    inbound = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00"
    code, _, hdrs = http(port, "/v1/predict", predicts[0],
                         {"traceparent": inbound})
    assert code == 200 and hdrs["traceparent"].split("-")[1] == \
        inbound.split("-")[1], hdrs.get("traceparent")
    code, health, _ = http(port, "/readyz")
    assert code == 200 and health["status"] == "ok", (code, health)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/metrics?format=openmetrics")
    with urllib.request.urlopen(req, timeout=60) as resp:
        text = resp.read().decode()
    assert text.endswith("# EOF\n") and 'trace_id="' in text
    for name in ("serving_ttft_seconds_count", "serving_itl_seconds_count",
                 "kv_pages_in_use", "prefix_cache_hits_total",
                 "circuit_state", "serving_phase_seconds_count"):
        assert name in text, name

    # the batcher's host syncs per step, at both rates
    per_step = {}
    for rate in (0.0, 1.0):
        per_step[rate], n = profile_served_steps(server, batcher, rate)
        log(f"served decode steps at trace sampling {rate}, torch.profiler "
            f"over {n} steps: " + ", ".join(
                f"{k} {v:.2f}" for k, v in per_step[rate].items())
            + " a step")
    if sum(per_step[0.0].values()) == 0:
        log("profiler recorded no CUDA runtime calls from the batcher "
            "thread: host syncs per served step not measured")
    # the same work at both rates; the step count may differ by a step
    # or two with arrival times, moving the per-request admission calls'
    # share, hence 2%
    for k in SYNC_CALLS:
        assert per_step[1.0][k] <= per_step[0.0][k] * 1.02, per_step
    server.sampler.rate = 0.01
    instrumentation_cost(server)

    # chaos on a second generate backend
    server.registry.register("lm2", net)
    b2, _ = server.batcher_for("lm2")
    b2.breaker.failure_threshold = 3
    b2.breaker.cooldown_s = 2.0
    probe = {"model": "lm2",
             "prompt": surface_bodies([4 * PROMPT_MIN], 9)[0]["prompt"],
             "n_tokens": GEN_TOKENS}
    chaos.install({"faults": [{"site": "serving.worker.step",
                               "kind": "error", "p": 1.0,
                               "max_fires": 3}]}, seed=0)
    # the drill's crashes are expected: keep their tracebacks out of the
    # log (the line below reports what happened)
    quiet = logging.getLogger("deeplearning4j_tpu_torch")
    quiet.disabled = True
    try:
        codes = [http(port, "/v1/generate", probe)[0] for _ in range(3)]
        t_end = time.monotonic() + 30
        while b2.breaker.state != "open":
            assert time.monotonic() < t_end, "breaker never opened"
            time.sleep(0.01)
        shed = http(port, "/v1/generate", probe)
        ready = http(port, "/readyz")
        health = http(port, "/healthz")[1]
        while b2.breaker.state != "half_open":
            assert time.monotonic() < t_end, "breaker never half-opened"
            time.sleep(0.01)
        code, reply, _ = http(port, "/v1/generate", probe)   # the probe
    finally:
        chaos.uninstall()
        quiet.disabled = False
    log(f"chaos drill (serving.worker.step error x3 on generate/lm2/v1): "
        f"codes {codes}, then {shed[0]} with Retry-After "
        f"{shed[2].get('Retry-After')} ({shed[1]['error'][:60]}...); "
        f"/readyz {ready[0]} Retry-After {ready[2].get('Retry-After')}; "
        f"/healthz {health['status']} {health.get('circuits')}; probe "
        f"{code}, breaker {b2.breaker.state}")
    assert codes == [500] * 3 and shed[0] == 503 and \
        "Retry-After" in shed[2] and "circuit" in shed[1]["error"]
    assert ready[0] == 503 and "Retry-After" in ready[2]
    assert health["circuits"] == {"generate/lm2/v1": "open"}
    assert code == 200 and b2.breaker.state == "closed"
    assert http(port, "/readyz")[0] == 200
    compared = check_greedy(net, da, probe["prompt"], reply["ids"])
    for _ in range(500):          # the slot releases just after replying
        if b2.active_slots() == 0:
            break
        time.sleep(0.01)
    sess = b2.session
    cached = {p for chain in sess.prefix_cache._entries.values()
              for p in chain}
    assert sess.pages_in_use() == len(cached), (sess.pages_in_use(),
                                                len(cached))
    crashes = server.metrics.registry.get(
        "serving_worker_crashes_total",
        labels={"endpoint": "generate/lm2/v1"}).value
    assert crashes == 3, crashes
    log(f"after the drill: probe's greedy ids vs the plain-decode "
        f"reference, {compared} of {GEN_TOKENS} compared and equal; pages "
        f"in use {sess.pages_in_use()} = {len(cached)} held by the prefix "
        f"cache; serving_worker_crashes_total {crashes}")
    return fwd_launches, dec_launches


FLEET_ROLES = ["prefill", "decode", "decode"]
# the fleet's replicas (and fleet_control_phase's) serve the LM at full
# width and this depth: the phases exercise the router, the leases and
# the control loops, host-bound, and took 126-207 s each at depth LAYERS
FLEET_LAYERS = 2
FLEET_PAGES = 512                 # KV pool pages per replica
# The drain drill's streams: 4 greedy 256-token streams on fresh prompts.
# A stream migrates only if it is still live once the successor has
# booted (its model restored beforehand) and the survivor decodes the
# rest of it within the router's offer import limit; ends staggered 128
# steps apart put a stream in that window whatever the boot takes
DRAIN_PROMPTS, DRAIN_TOKENS = (192, 320, 448, 576), 256
KILL_PREDICTS = 32
# The router's per-attempt limit on the path this phase asserts. An
# export returns once its prompt has been prefilled, one token a step,
# behind up to 8 others on the prefill replica; on one card shared by
# three replicas that outlasts the router's default of 10 s for long
# prompts, and the split falls back to one replica
# (router_kv_fallbacks_total). The phase shows those fallbacks in a
# burst of their own through a router at the defaults.
FLEET_ATTEMPT_TIMEOUT_S = 300.0
# A drain offer's survivor import returns once the rest of the stream
# has been decoded there. The default of 5 s and this both stay below
# the incumbent's 10 s failsafe.
FLEET_OFFER_IMPORT_TIMEOUT_S = 9.0
DEFAULT_BURST_TOKENS = 16         # tokens a request at the defaults


class HopClock:
    """Host-clock instruments on a fleet's KV hops. In-process replicas
    share one clock, so a lease's hop is: its ``export_lease`` on the
    prefill worker (first page gather to serialised blob), the gap from
    that blob to the decode replica's ``import_stream`` call (encode,
    HTTP to the router, the router's re-send, decode, CRC check), and
    ``import_lease`` on the decode worker. Keyed by prompt."""

    def __init__(self):
        self.lock = threading.Lock()
        self.exports, self.arrivals, self.imports = {}, {}, {}

    def attach(self, batcher):
        sess = batcher.session
        export, import_lease = sess.export_lease, sess.import_lease
        import_stream = batcher.import_stream

        def timed_export(slot, extra=None):
            t0 = time.perf_counter()
            blob = export(slot, extra=extra)
            t1 = time.perf_counter()
            with self.lock:
                self.exports[tuple(extra["prompt"])] = (
                    (t1 - t0) * 1e3, len(blob), t1)
            return blob

        def timed_import(blob, total_tokens):
            t0 = time.perf_counter()
            lease, extra = import_lease(blob, total_tokens)
            with self.lock:
                self.imports[tuple(extra["prompt"])] = (
                    time.perf_counter() - t0) * 1e3
            return lease, extra

        def arriving(blob, **kw):
            t = time.perf_counter()
            header = kw.get("header")
            if header is not None:
                with self.lock:
                    self.arrivals[tuple(header["extra"]["prompt"])] = t
            return import_stream(blob, **kw)

        sess.export_lease = timed_export
        sess.import_lease = timed_import
        batcher.import_stream = arriving

    def hops(self):
        """[(lease MB, export ms, import ms, hop ms)] of every lease
        that crossed."""
        with self.lock:
            out = []
            for key, (ex_ms, nbytes, t_done) in self.exports.items():
                if key in self.arrivals and key in self.imports:
                    im_ms = self.imports[key]
                    out.append((nbytes / 2 ** 20, ex_ms, im_ms, ex_ms
                                + (self.arrivals[key] - t_done) * 1e3
                                + im_ms))
            return out


def time_steps(sess, sink):
    """Each decode step's host time (launch and the probabilities'
    copy back, which the batcher makes anyway) into ``sink``."""
    step = sess.step_slots

    def timed(x, active):
        t0 = time.perf_counter()
        probs = step(x, active).cpu()
        sink.append((time.perf_counter() - t0) * 1e3)
        return probs

    sess.step_slots = timed


def stats(xs):
    xs = sorted(xs)
    return f"min {xs[0]:.3f} median {xs[len(xs) // 2]:.3f} max {xs[-1]:.3f}"


def replica_syncs(replica, path, bodies):
    """cudaStreamSynchronize / cudaMemcpyAsync calls per device step of
    one replica: torch.profiler over a burst sent to it alone (the other
    replicas idle, so every call in the window is its)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b = replica.server.batcher_for("lm")[0]
    steps0 = b.device_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        burst(replica.port, path, bodies)
        torch.cuda.synchronize()
    steps = b.device_steps - steps0
    return {k: v / steps for k, v in sync_calls(prof).items()}, steps


def wait_idle(batchers, limit_s=300.0):
    """Until no batcher holds a request (a router that gave up on an
    export leaves its prefill running on the replica)."""
    t_end = time.monotonic() + limit_s
    while any(b.active_slots() or b.queue_depth() for b in batchers):
        assert time.monotonic() < t_end, "replicas never went idle"
        time.sleep(0.05)


def free_ports(n):
    """``n`` consecutive free loopback ports (their first)."""
    import socket
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            socks = []
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def fleet_phase(attn, da, card, bodies):
    """Disaggregated prefill/decode and drain migration across a fleet
    of port servers on the card. A ReplicaFleet of 3 in-process
    replicas (roles prefill=1, decode=2; each slots=8, capacity=1024,
    page_size=16, 512 pages, loading the generate phase's model from one
    zip) behind the port's Router: 8 one-row predicts of 128 ids through
    the router (forward launches = 8 x served batches, outputs vs the
    same model on the plain attention); the generate phase's 16
    requests, each with its own session, split prefill -> decode (16
    handoffs, no fallback, 16 exports and imports, greedy ids vs the
    plain-decode reference, temperature ids vs one server, decode
    launches = 8 x the replicas' steps), with lease sizes, export,
    import and hop times, tokens/s against the same burst on one server,
    and each replica's step host time and syncs a step; the same lengths
    through a second router at serve-fleet's default timeouts (its
    fallbacks shown, not asserted); ``fleet.replace()`` of a decode
    replica under 4 pinned greedy 256-token streams (migrated, ids
    unchanged, the incumbent's pages back to its prefix cache before it
    leaves the pool), ``fleet.kill()`` of a decode replica under
    predicts (none fails, the router drops it); and one subprocess
    replica of the port: a predict through a router, its imports, then
    SIGKILL. The replicas serve the LM at full width and depth
    FLEET_LAYERS. Returns the launches of the forward and decode kernels
    in the predicts and the burst."""
    import shutil
    from collections import Counter
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.router import Router
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    part = Parts()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        lm_config(layers=FLEET_LAYERS)), device="cuda").init(seed=0)
    tmp = tempfile.mkdtemp(prefix="fleet-")
    path = os.path.join(tmp, "lm.zip")
    write_model(net, path)
    kw = dict(slots=SLOTS, capacity=CAPACITY, page_size=PAGE,
              kv_pages=FLEET_PAGES)

    spares = []

    def factory():
        # a model restored ahead of time (the drain drill's successor)
        # boots a replica without the ~5 s zip restore
        if spares:
            return {"lm": spares.pop()}
        return {"lm": restore_model(path, device="cuda")}

    burst_bodies = [dict(b, session=f"burst-{i}")
                    for i, b in enumerate(bodies)]
    warm = {"model": "lm", "prompt": [1, 2, 3], "n_tokens": 2}
    # the predicts, and the same model's outputs on the plain attention
    ids = np.random.default_rng(3).integers(0, V, (CLIENTS,
                                                   SURFACE_PREDICT_T))
    predicts = [{"model": "lm", "inputs": ids[i:i + 1].astype(
        float).tolist()} for i in range(CLIENTS)]
    before = attn.flash_attention_fwd_cuda.launches
    with plain_attention(attn):
        ref = net.output(ids.astype(np.float32)).cpu().numpy()
    assert attn.flash_attention_fwd_cuda.launches == before

    def check_predict(reply, row):
        out = np.asarray(reply["outputs"], np.float32)
        assert out.shape == (1, SURFACE_PREDICT_T, V), out.shape
        np.testing.assert_allclose(out[0], ref[row], atol=1e-6, rtol=1e-4)
        return float(np.abs(out[0] - ref[row]).max())

    # the same burst through one port server, in this run
    registry = ModelRegistry()
    registry.register("lm", factory()["lm"])
    single = ModelServer(registry, **kw).start()
    single_steps = []
    try:
        assert http(single.port, "/v1/generate", warm)[0] == 200
        time_steps(single.batcher_for("lm")[0].session, single_steps)
        single_replies, single_wall = burst(single.port, "/v1/generate",
                                            burst_bodies)
    finally:
        single.stop(drain=True)
    del registry, single
    single_tps = GEN_REQUESTS * GEN_TOKENS / single_wall

    part("the model, its zip and one server's burst")
    t0 = time.perf_counter()
    fleet = ReplicaFleet(factory, n=len(FLEET_ROLES), roles=FLEET_ROLES,
                         server_kwargs=kw).start()
    boot_s = time.perf_counter() - t0
    router = Router(fleet, hedge_after_s=None,
                    attempt_timeout_s=FLEET_ATTEMPT_TIMEOUT_S,
                    request_timeout_s=600.0).start()
    router.offer_import_timeout_s = FLEET_OFFER_IMPORT_TIMEOUT_S

    def counter(name, r=router):
        return r.registry.get(name).value

    def kv_count(r, name):
        return r.server.metrics.registry.get(
            name, labels={"endpoint": "generate/lm/v1"}).value

    try:
        replicas = fleet.snapshot()
        log(f"fleet: {len(replicas)} in-process replicas ("
            + ", ".join(f"{r.id}={r.role}" for r in replicas)
            + f") booted in {boot_s:.2f} s, router on port {router.port}")

        # predicts through the router
        def served_batches():
            return sum(s.device_calls for r in fleet.snapshot()
                       for s in r.server._schedulers.values())

        calls0 = served_batches()
        attn.flash_attention_fwd_cuda.launches = 0     # this path only
        replies, _ = burst(router.port, "/v1/predict", predicts)
        fwd_launches = attn.flash_attention_fwd_cuda.launches
        batches = served_batches() - calls0
        worst = max(check_predict(reply, i)
                    for i, (_, reply, _) in enumerate(replies))
        assert all("traceparent" in hdrs for _, _, hdrs in replies)
        log(f"fleet: {CLIENTS} /v1/predict (1 x {SURFACE_PREDICT_T} ids) "
            f"through the router in {batches} batch(es) on "
            f"{sum(1 for r in fleet.snapshot() if r.server._schedulers)} "
            f"replica(s), flash_attention_fwd launches {fwd_launches}; "
            f"outputs vs the same model on the plain attention: max "
            f"|diff| {worst:.3e} (atol 1e-6, rtol 1e-4)")
        assert batches > 0 and fwd_launches == FLEET_LAYERS * batches, \
            (fwd_launches, batches)

        # the disaggregated burst
        clock, steps_ms = HopClock(), {}
        batchers = {}
        for r in replicas:
            assert http(r.port, "/v1/generate", warm)[0] == 200
            b = batchers[r.id] = r.server.batcher_for("lm")[0]
            clock.attach(b)
            time_steps(b.session, steps_ms.setdefault(r.id, []))
        for sink in steps_ms.values():
            sink.clear()
        steps0 = {rid: b.device_steps for rid, b in batchers.items()}
        da.decode_attention_cuda.launches = 0          # this path only
        replies, wall = burst(router.port, "/v1/generate", burst_bodies)
        dec_launches = da.decode_attention_cuda.launches
        steps = {rid: b.device_steps - steps0[rid]
                 for rid, b in batchers.items()}
        handoffs = counter("router_kv_handoffs_total")
        fallbacks = counter("router_kv_fallbacks_total")
        exports = {r.role: 0 for r in replicas}
        imports = dict(exports)
        for r in replicas:
            exports[r.role] += kv_count(r, "kv_stream_exports_total")
            imports[r.role] += kv_count(r, "kv_stream_imports_total")
        log(f"fleet burst: {GEN_REQUESTS} /v1/generate ({GEN_TOKENS} "
            f"tokens each, 4 at temperature 0.8, a session each) through "
            f"the router: router_kv_handoffs_total {handoffs:g}, "
            f"router_kv_fallbacks_total {fallbacks:g}; "
            f"kv_stream_exports_total {exports}, kv_stream_imports_total "
            f"{imports}; device steps {steps}, decode_attention launches "
            f"{dec_launches}")
        assert (handoffs, fallbacks) == (GEN_REQUESTS, 0)
        assert exports == {"prefill": GEN_REQUESTS, "decode": 0}, exports
        assert imports == {"prefill": 0, "decode": GEN_REQUESTS}, imports
        assert dec_launches == FLEET_LAYERS * sum(steps.values()), \
            (dec_launches, steps)
        compared = 0
        for body, (_, reply, _), (_, alone, _) in zip(
                bodies, replies, single_replies):
            assert len(reply["ids"]) == GEN_TOKENS
            if "temperature" in body:
                assert reply["ids"] == alone["ids"], (body["seed"],)
            else:
                compared += check_greedy(net, da, body["prompt"],
                                         reply["ids"])
        hops = clock.hops()
        assert len(hops) == GEN_REQUESTS, len(hops)
        mb, ex, im, hop = (list(x) for x in zip(*hops))
        fleet_tps = GEN_REQUESTS * GEN_TOKENS / wall
        log(f"fleet burst greedy ids vs the plain-decode reference: "
            f"{compared} of {12 * GEN_TOKENS} compared and equal; the 4 "
            f"temperature replies equal one server's")
        log(f"fleet KV hops ({card}, host clock): lease MB {stats(mb)}; "
            f"export ms (export_lease on the prefill worker) {stats(ex)}; "
            f"import ms (import_lease on the decode worker) {stats(im)}; "
            f"hop ms (export + transfer through the router + import) "
            f"{stats(hop)}")
        log(f"generate throughput ({card}): fleet of 3 "
            f"{fleet_tps:.1f} generated tokens/s ({wall:.3f} s), one "
            f"server {single_tps:.1f} tokens/s ({single_wall:.3f} s), "
            f"the same 16 requests in this run")
        log(f"one server's decode step host ms over the same burst: "
            f"{stats(single_steps)} over {len(single_steps)} steps")
        for r in replicas:
            ms = steps_ms[r.id]
            log(f"replica {r.id} ({r.role}) decode step host ms with 3 "
                f"replicas live: {stats(ms)} over {len(ms)} steps")

        # the same lengths (fresh ids: no prefix cache helps) through a
        # router at the timeouts serve-fleet ships: shown, not asserted
        rng = np.random.default_rng(1)
        at_defaults = [dict(b, prompt=rng.integers(0, V, len(b["prompt"]))
                            .tolist(), n_tokens=DEFAULT_BURST_TOKENS,
                            session=f"defaults-{i}")
                       for i, b in enumerate(bodies)]
        drouter = Router(fleet).start()
        for sink in steps_ms.values():
            sink.clear()
        try:
            dreplies, dwall = burst(drouter.port, "/v1/generate",
                                    at_defaults, check=False)
            dcounts = [counter(n, drouter) for n in (
                "router_kv_handoffs_total", "router_kv_fallbacks_total")]
        finally:
            drouter.stop()
        failed = [reply.get("error") for code, reply, _ in dreplies
                  if code != 200]
        log(f"the same {GEN_REQUESTS} prompt lengths (fresh ids, "
            f"{DEFAULT_BURST_TOKENS} tokens) through a router at "
            f"serve-fleet's defaults (attempt_timeout_s "
            f"{drouter.attempt_timeout_s:g} s, request_timeout_s "
            f"{drouter.request_timeout_s:g} s; {card}): "
            f"router_kv_handoffs_total {dcounts[0]:g}, "
            f"router_kv_fallbacks_total {dcounts[1]:g}; statuses "
            f"{dict(Counter(r[0] for r in dreplies))} in {dwall:.3f} s; "
            f"errors {failed}")
        for r in replicas:
            ms = steps_ms[r.id]
            if ms:
                log(f"replica {r.id} ({r.role}) decode step host ms in "
                    f"the burst at the defaults: {stats(ms)} over "
                    f"{len(ms)} steps")
        wait_idle(batchers.values())

        # each replica's host syncs a step, in a window of its own (fresh
        # ids: a cached prefix would skip the steps)
        short = [{"model": "lm", "prompt": rng.integers(0, V, 48).tolist(),
                  "n_tokens": PROFILE_TOKENS} for _ in range(SLOTS)]
        for r in replicas:
            path_ = "/v1/kv/export" if r.role == "prefill" \
                else "/v1/generate"
            per, n = replica_syncs(r, path_, short)
            log(f"replica {r.id} ({r.role}) {path_} x{len(short)} alone, "
                f"torch.profiler over {n} steps: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in per.items()) + " a step")

        # drain migration under replace(); fresh ids, so that no prefix
        # cache shortens the streams. The successor's model is restored
        # first: on replayed steps (~1-3 ms) a 448-832-step stream ends
        # within the ~5 s a zip restore takes, before a drain could
        # offer it
        spares.append(restore_model(path, device="cuda"))
        drain = [{"model": "lm", "prompt": rng.integers(0, V, n).tolist(),
                  "n_tokens": DRAIN_TOKENS, "session": f"drain-{i}"}
                 for i, n in enumerate(DRAIN_PROMPTS)]
        target = next(r for r in fleet.snapshot() if r.role == "decode")
        tb = batchers[target.id]
        for body in drain:
            # pin every stream to the target: a pinned session decodes
            # where its pin points (no split)
            router._pin_to(body["session"], router._views[target.id])
        at_stop = {}
        stop = target.stop

        def recording_stop(drain=True, timeout=30.0):
            ok = stop(drain=drain, timeout=timeout)
            cached = {p for chain in tb.session.prefix_cache._entries
                      .values() for p in chain}
            at_stop.update(ok=ok, pages=tb.session.pages_in_use(),
                           cached=len(cached),
                           in_pool=target in fleet.snapshot())
            return ok

        target.stop = recording_stop
        mig0, res0, fb0, off0 = (
            counter("router_kv_migrations_total"),
            counter("router_kv_resumes_total"),
            counter("router_kv_fallbacks_total"),
            kv_count(target, "kv_stream_exports_total"))
        results = [None] * len(drain)

        def stream(i):
            results[i] = http(router.port, "/v1/generate", drain[i])

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(drain))]
        for th in threads:
            th.start()
        t_end = time.monotonic() + 120
        while tb.active_slots() < len(drain):
            assert time.monotonic() < t_end, "drain streams never slotted"
            time.sleep(0.005)
        pos = [r.id for r in fleet.snapshot()].index(target.id)
        t0 = time.perf_counter()
        successor = fleet.replace(pos, drain_timeout=120.0)
        replace_s = time.perf_counter() - t0
        for th in threads:
            th.join(timeout=600)
        migrations = counter("router_kv_migrations_total") - mig0
        resumes = counter("router_kv_resumes_total") - res0
        recomputes = counter("router_kv_fallbacks_total") - fb0
        offers = kv_count(target, "kv_stream_exports_total") - off0
        log(f"drain: fleet.replace() of replica {target.id} under "
            f"{len(drain)} pinned greedy {DRAIN_TOKENS}-token streams "
            f"(prompts {list(DRAIN_PROMPTS)} ids) took {replace_s:.2f} s "
            f"(successor {successor.id} booted first); streams offered "
            f"{offers:g}: router_kv_migrations_total +{migrations:g}, "
            f"router_kv_resumes_total +{resumes:g}, "
            f"router_kv_fallbacks_total +{recomputes:g} (recomputed on a "
            f"survivor); the incumbent at the "
            f"end of its drain: pages in use {at_stop.get('pages')} = "
            f"{at_stop.get('cached')} held by its prefix cache, still in "
            f"the pool {at_stop.get('in_pool')}")
        assert all(r is not None and r[0] == 200 for r in results), \
            [None if r is None else r[:2] for r in results]
        assert migrations >= 1
        assert at_stop["ok"] and at_stop["in_pool"]
        assert at_stop["pages"] == at_stop["cached"], at_stop
        compared = sum(check_greedy(net, da, body["prompt"], r[1]["ids"],
                                    n_tokens=DRAIN_TOKENS)
                       for body, r in zip(drain, results))
        log(f"drain streams' greedy ids vs the plain-decode reference: "
            f"{compared} of {len(drain) * DRAIN_TOKENS} compared and equal")

        # kill a decode replica under predicts
        victim = next(r for r in fleet.snapshot() if r.role == "decode")
        codes, lock, todo = [], threading.Lock(), list(range(KILL_PREDICTS))

        def work():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop()
                c = http(router.port, "/v1/predict",
                         predicts[i % CLIENTS])[0]
                with lock:
                    codes.append(c)

        workers = [threading.Thread(target=work) for _ in range(CLIENTS)]
        for th in workers:
            th.start()
        t_end = time.monotonic() + 120
        while len(codes) < CLIENTS:
            assert time.monotonic() < t_end, "predicts never completed"
            time.sleep(0.005)
        fleet.kill([r.id for r in fleet.snapshot()].index(victim.id))
        for th in workers:
            th.join(timeout=600)
        states = router.replica_states()
        log(f"kill drill: fleet.kill() of replica {victim.id} under "
            f"{KILL_PREDICTS} predicts: statuses {sorted(set(codes))} x"
            f"{len(codes)}; router replica states {states}, eligible "
            f"{router.health_payload()['eligible']}; "
            f"router_failovers_total {counter('router_failovers_total'):g}")
        assert codes == [200] * KILL_PREDICTS, codes
        assert victim.id not in states and len(states) == 2, states
    finally:
        router.stop()
        fleet.stop(drain=False, timeout=30.0)

    part("the in-process fleet's drills")
    # one subprocess replica of the port on the card: a predict through a
    # router, what the child imported, then SIGKILL
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    sub = ReplicaFleet(model_specs=[f"lm={path}"], n=1,
                       base_port=free_ports(1), device="cuda")
    t0 = time.perf_counter()
    sub.start()
    srouter = Router(sub, probe_interval_s=0.5, hedge_after_s=None,
                     request_timeout_s=600.0).start()
    try:
        child = sub.snapshot()[0]
        t_end = time.monotonic() + 300
        while srouter.health_payload()["eligible"] < 1:
            assert child.proc.poll() is None, "the subprocess replica died"
            assert time.monotonic() < t_end, "subprocess replica never up"
            time.sleep(0.2)
        up_s = time.perf_counter() - t0
        code, reply, _ = http(srouter.port, "/v1/predict", predicts[0])
        assert code == 200, (code, reply)
        err = check_predict(reply, 0)
        mods = http(child.port, "/debug/modules")[1]
        log(f"subprocess replica: `{' '.join(child.command()[1:])}` (pid "
            f"{child.proc.pid}) up in {up_s:.1f} s; a predict through the "
            f"router vs the plain attention: max |diff| {err:.3e}; its "
            f"/debug/modules {mods}")
        assert mods["jax"] is False and mods["deeplearning4j_tpu"] is False
        assert mods["cuda"] is True
        proc = child.proc
        sub.kill(0)
        log(f"subprocess replica {child.id} SIGKILLed: exit code "
            f"{proc.returncode}")
        assert proc.returncode == -9, proc.returncode
    finally:
        srouter.stop()
        sub.stop(drain=False)
        shutil.rmtree(tmp, ignore_errors=True)
    part("the subprocess replica")
    log(f"fleet_phase parts, wall s ({card}): {json.dumps(part.seconds)}")
    return fwd_launches, dec_launches


# --------------------------------------------------------------------
# cnn_phase: ResNet50 on ComputationGraph and LeNet on MultiLayerNetwork
# (no kernel of the port's own: conv, pooling and GEMMs are cuDNN's and
# cuBLAS's, batch norm and the rest plain torch ops)
# --------------------------------------------------------------------

RESNET_B, RESNET_HW, RESNET_CLASSES = 128, 224, 1000   # bench.py:162-170
RESNET_WARM_STEPS = 4      # timed warm steps a leg, after one untimed
CHECK_B, CHECK_HW = 8, 64  # the card-vs-CPU step
LENET_B, LENET_STEPS = 128, 200                          # bench.py:281-307
SERVE_ROWS = 8
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# the card-vs-CPU step, leaf by leaf (loss, gradients, BN state,
# params), in L2 norm, plus a floor of FLOOR_RTOL of the leaf's norm: in
# f32, within F32_FACTOR times the CPU's own largest difference over three
# reruns with its convs on another algorithm (oneDNN off: im2col + GEMM)
# and/or the batch rows in another order (batch norm over few values a
# channel amplifies f32 rounding, and a ReLU that flips moves a whole
# term of a gradient's sum, so one rerun's difference of one leaf is a
# poor estimate); in bf16, within BF16_FACTOR times the distance bf16
# puts the CPU step from its own f32 step (two bf16 paths round apart by
# about what either is from f32)
F32_FACTOR, BF16_FACTOR, FLOOR_RTOL = 8.0, 4.0, 1e-5


def layer_flops(layer, t_in):
    """Forward FLOPs an example of one conv or dense layer (2·MACs) on
    input type ``t_in``; 0 for other layers. A convolution is
    2·H_out·W_out·(C_in / groups)·C_out·k_h·k_w; a transposed one the same
    at its INPUT size (each input pixel scatters a k_h·k_w·C_out patch);
    a depthwise one has groups = C_in; a separable one is its depthwise
    part plus the 1x1 pointwise product; a 1-d one runs over T_out. A
    frozen layer counts as the layer it wraps."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        Convolution1DLayer, ConvolutionLayer, Deconvolution2DLayer,
        DenseLayer, DepthwiseConvolution2DLayer, FrozenLayer, OutputLayer,
        SeparableConvolution2DLayer)
    if isinstance(layer, FrozenLayer):
        layer = layer.wrapped
    if isinstance(layer, (DenseLayer, OutputLayer)):
        return 2 * layer.n_in * layer.n_out
    if not isinstance(layer, ConvolutionLayer):
        return 0
    kk = layer.kernel[0] * layer.kernel[1]
    out = layer.output_type(t_in)
    if isinstance(layer, Convolution1DLayer):
        return 2 * out.timesteps * layer.n_in * layer.n_out * layer.kernel[0]
    if isinstance(layer, Deconvolution2DLayer):
        return 2 * t_in.height * t_in.width * layer.n_in * layer.n_out * kk
    pixels = out.height * out.width
    if isinstance(layer, DepthwiseConvolution2DLayer):
        return 2 * pixels * layer.n_out * kk
    if isinstance(layer, SeparableConvolution2DLayer):
        mid = layer.n_in * layer.depth_multiplier
        return 2 * pixels * mid * (kk + layer.n_out)
    return 2 * pixels * layer.n_in * layer.n_out * kk


def conv_dense_flops(conf):
    """Forward FLOPs an example of a ComputationGraph's convs and dense
    layers, from its config (``layer_flops`` summed over the vertices)."""
    return sum(layer_flops(conf.vertices[n][0], conf.vertex_input_type(n))
               for n in conf.topological_order()
               if conf.vertex_input_type(n) is not None)


def cnn_family(name):
    """A CUDA kernel of the CNN step by family, from its name."""
    n = name.lower()
    if any(k in n for k in ("dgrad", "wgrad", "backward_data",
                            "backward_filter", "bwd_filter", "bwd_data")):
        return "conv bwd (cuDNN)"
    if any(k in n for k in ("fprop", "convolve", "conv2d", "xmma_fwd",
                            "implicit_gemm", "winograd", "fft")):
        return "conv fwd (cuDNN)"
    if "nchwtonhwc" in n or "nhwctonchw" in n or "transpose" in n:
        return "layout transforms"
    if "pool" in n:
        return "pooling"
    if any(k in n for k in ("gemm", "cutlass", "sm90_xmma", "cublas")):
        return "gemm (dense)"
    if "reduce" in n:
        return "reductions (BN statistics, loss)"
    if "copy" in n:
        return "copies (casts, weight re-layout)"
    if "elementwise" in n:
        return "elementwise (BN, ReLU, adds, updater)"
    return "other"


def profile_cnn_step(net, ds, label):
    """Device ms by kernel family of one warm step (torch.profiler) and
    the window's idle share; returns (families, busy_ms, wall_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, names = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = cnn_family(evt.key)
        fams[fam] = fams.get(fam, 0.0) + evt.self_device_time_total / 1e3
        if fam == "other":
            names[evt.key[:60]] = evt.self_device_time_total / 1e3
    busy = sum(fams.values())
    assert busy > 0, "profiler recorded no device time"
    log(f"{label} step device time by kernel family (torch.profiler, one "
        "warm step): " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
            for k, v in sorted(fams.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy:.3f} ms of {wall_ms:.3f} ms wall, idle "
          f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%")
    if names:
        log(f"{label} 'other' kernels: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(
                names.items(), key=lambda kv: -kv[1])[:6]))
    return fams, busy, wall_ms


def component_ms(net, ds, dtype, label):
    """CUDA-event ms of three parts of a ResNet50 step, each timed alone
    at the leg's shapes: the per-call weight re-layout of every conv
    kernel (HWIO -> OIHW channels_last, conv_weight_oihw), every batch
    norm's forward and backward, and the updater (nesterovs update +
    apply) on the step's gradients."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                         ConvolutionLayer)
    from deeplearning4j_tpu_torch.nn.conf.layers.convolutional import (
        conv_weight_oihw)
    conf, params = net.conf, net.params
    convs = [params[n]["W"] for n in net._param_names
             if isinstance(conf.vertices[n][0], ConvolutionLayer)]
    relayout = time_ms(lambda: [conv_weight_oihw(w, dtype) for w in convs],
                       iters=10, warmup=2)
    bns = [(n, conf.vertices[n][0]) for n in net._param_names
           if isinstance(conf.vertices[n][0], BatchNormalization)]
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}                       # one input tensor a distinct shape
    for n, _ in bns:
        t = conf.vertex_input_type(n)
        shape = (RESNET_B, t.height, t.width, t.channels)
        if shape not in inputs:
            inputs[shape] = torch.randn(shape, generator=g, device="cuda"
                                        ).to(dtype).requires_grad_()

    def bn_all():
        for n, layer in bns:
            t = conf.vertex_input_type(n)
            x = inputs[(RESNET_B, t.height, t.width, t.channels)]
            y, _ = layer.apply(params[n], net.state[n], x, training=True)
            torch.autograd.grad(y, [x] + list(params[n].values()),
                                torch.ones_like(y))
    bn = time_ms(bn_all, iters=3, warmup=1)
    del inputs
    _, grads, _ = net._gradients(net._batch_tuple(net._as_multi(ds)))
    scratch = updaters.tree_map(lambda p: p.detach().clone(), params)

    def upd():
        with torch.no_grad():
            u, _ = net._optimizer.update(grads, net.opt_state, scratch)
            updaters.apply_updates(scratch, u)
    opt = time_ms(upd, iters=5, warmup=1)
    del grads, scratch
    log(f"{label} parts timed alone (CUDA events): weight re-layout of "
        f"{len(convs)} conv kernels {relayout:.3f} ms; {len(bns)} batch "
        f"norms forward + backward {bn:.3f} ms; updater {opt:.3f} ms")
    return {"relayout_ms": relayout, "bn_ms": bn, "updater_ms": opt}


def resnet_leg(net, ds, label, peak, card):
    """RESNET_WARM_STEPS timed steps through ``fit`` after one untimed,
    one profiled step and the parts timed alone. Returns its numbers."""
    import torch
    from deeplearning4j_tpu_torch import dtypes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # PyTorch's default; the conv layer itself must turn TF32 off for f32
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    net.fit(ds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    assert torch.backends.cudnn.allow_tf32 is False
    losses, step_ms = [float(net.score_value)], []
    for _ in range(RESNET_WARM_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit(ds)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(net.score_value))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(math.isfinite(x) for x in losses), losses
    med = sorted(step_ms)[len(step_ms) // 2]
    flops = 3 * conv_dense_flops(net.conf) * RESNET_B
    bound = flops / peak * 1e3
    log(f"ResNet50 {label} training (B={RESNET_B}, {RESNET_HW}x{RESNET_HW}"
        f", nesterovs(0.1, 0.9), {card}): first step {first_s:.3f} s; warm "
        f"steps " + ", ".join(f"{x:.3f}" for x in step_ms) + f" ms, median "
        f"{med:.3f} ms = {RESNET_B / med * 1e3:.1f} images/s; losses "
        + ", ".join(f"{x:.6f}" for x in losses) + f"; peak device memory "
        f"{peak_gib:.2f} GiB; bound {bound:.3f} ms ({flops / 1e12:.4f} "
        f"TFLOP at {peak / 1e12:.0f} TFLOP/s): {100 * bound / med:.1f}% "
        "of it")
    fams, busy, wall = profile_cnn_step(net, ds, f"ResNet50 {label}")
    parts = component_ms(net, ds, dtypes.policy().compute_dtype,
                         f"ResNet50 {label}")
    return {"median_ms": med, "images_s": RESNET_B / med * 1e3,
            "losses": losses, "peak_gib": peak_gib, "bound_ms": bound,
            "busy_ms": busy, "wall_ms": wall, "families": fams, **parts}


def _leaf_errors(card, cpu, others, factor, floor_rtol=None):
    """‖card − cpu‖ / (factor · max over ``others`` of ‖cpu − other‖ +
    floor_rtol (default FLOOR_RTOL) · ‖cpu‖) of each leaf of flat dicts of
    arrays, L2 norms (<= 1 passes), worst first: [(ratio, leaf,
    ‖card − cpu‖, limit)]."""
    import numpy as np
    floor_rtol = FLOOR_RTOL if floor_rtol is None else floor_rtol
    rows = []
    for k, a in cpu.items():
        a = a.astype("float64")
        noise = max(float(np.linalg.norm(a - o[k])) for o in others)
        lim = factor * noise + floor_rtol * float(np.linalg.norm(a)) + 1e-12
        e = float(np.linalg.norm(card[k].astype("float64") - a))
        rows.append((e / lim, k, e, lim))
    return sorted(rows, reverse=True)


def resnet_card_vs_cpu():
    """One ResNet50 fit step (B=8, 64x64, 1000 classes, nesterovs) on the
    card held against the same step on the CPU, in f32 and under
    tpu_bf16(): loss, gradients, the new BN state and the updated params,
    leaf by leaf (F32_FACTOR, BF16_FACTOR). Under bf16 each vertex's
    output dtype on the card is also held to the JAX package's table
    (conv outputs bf16, everything after a batch norm float32)."""
    import contextlib

    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import dtypes, zoo
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (CHECK_B, CHECK_HW, CHECK_HW, 3)).astype("float32")
    y = np.eye(RESNET_CLASSES, dtype="float32")[
        rng.integers(0, RESNET_CLASSES, CHECK_B)]
    zm = zoo.ResNet50(n_classes=RESNET_CLASSES,
                      input_shape=(CHECK_HW, CHECK_HW, 3),
                      updater=updaters.nesterovs(0.1, 0.9))
    init = zm.init(device="cpu")
    params0, state0 = init.params, init.state

    def step(device, policy, roll=0, onednn=True):
        xx, yy = np.roll(x, roll, axis=0), np.roll(y, roll, axis=0)
        net = ComputationGraph(zm.conf(), device=device)
        net.set_params(params0)
        net.state = {n: {k: v.to(device) for k, v in s.items()}
                     for n, s in state0.items()}
        net._build_optimizer()
        seen = {}
        grads_of = net._gradients

        def spy(batch, carries=None):
            out = grads_of(batch, carries)
            # the eager step's (on the card a capture of the same body
            # follows it, whose tensors hold nothing until a replay)
            seen.setdefault("out", out)
            return out
        net._gradients = spy
        scope = (dtypes.policy_scope(dtypes.tpu_bf16()) if policy == "bf16"
                 else contextlib.nullcontext())
        with scope, torch.backends.mkldnn.flags(enabled=onednn):
            net.fit(DataSet(xx, yy))
            acts = net.feed_forward(xx[:2])
        loss, grads, (new_state, _) = seen["out"]
        return {"loss": np.array([loss.item()]),
                **{"grad/" + k: v for k, v in _flatten(grads).items()},
                **{"state/" + k: v for k, v in _flatten(new_state).items()},
                **{"param/" + k: v for k, v in
                   _flatten(net.params).items()}}, acts

    t0 = time.perf_counter()
    cpu32, _ = step("cpu", "f32")
    reruns = [step("cpu", "f32", roll, onednn)[0]
              for roll, onednn in ((3, False), (5, True), (0, False))]
    cpu16, _ = step("cpu", "bf16")
    cpu_s = time.perf_counter() - t0
    for policy, cpu, others, factor in (("f32", cpu32, reruns, F32_FACTOR),
                                        ("bf16", cpu16, [cpu32],
                                         BF16_FACTOR)):
        card, acts = step("cuda", policy)
        torch.cuda.synchronize()
        rows = _leaf_errors(card, cpu, others, factor)
        ref = ("largest rerun" if policy == "f32" else "bf16-vs-f32")
        log(f"ResNet50 {policy} step on the card vs the CPU (B={CHECK_B}, "
            f"{CHECK_HW}x{CHECK_HW}; five CPU steps {cpu_s:.1f} s): loss "
            f"{card['loss'][0]:.6f} vs {cpu['loss'][0]:.6f}; {len(cpu)} "
            f"leaves (loss, grads, BN state, params); L2 |card - cpu| / "
            f"({factor:g} x the CPU's {ref} difference + {FLOOR_RTOL:g} x "
            "|cpu|), worst three: " + "; ".join(
                f"{k} {r:.3f} ({e:.3e} of {lim:.3e})"
                for r, k, e, lim in rows[:3]) + " (limit 1)")
        assert rows[0][0] <= 1.0, (policy, rows[:3])
        assert all(a.device.type == "cuda" for a in acts.values())
        if policy == "bf16":
            bad = {n: str(a.dtype) for n, a in acts.items()
                   if n != "in" and (a.dtype == torch.bfloat16)
                   != n.endswith("_conv")}
            assert not bad, bad
            n_conv = sum(n.endswith("_conv") for n in acts)
            log(f"bf16 dtype table on the card: {n_conv} conv outputs "
                "bfloat16; every BN, pool, add, ReLU, avgpool and out "
                "float32 (as the JAX package)")


def lenet_phase(card):
    """LeNet through the builder (bench.py:281-307: convolutional_flat
    28x28x1, Adam 1e-3) on the card at B=128: LENET_STEPS steps on a
    seeded learnable set (each row one of 10 fixed random images plus
    unit noise, labelled by the image), warm step ms and images/s, and
    ``evaluate().accuracy()`` on a held-out seeded set."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                         DenseLayer,
                                                         OutputLayer,
                                                         SubsamplingLayer)
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updaters.adam(1e-3)).list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    rng = np.random.default_rng(0)
    protos = rng.normal(0, 1, (10, 784)).astype("float32")

    def data(n):
        labels = rng.integers(0, 10, n)
        x = protos[labels] + rng.normal(0, 1, (n, 784)).astype("float32")
        return x, np.eye(10, dtype="float32")[labels]
    train = [DataSet(*(torch.from_numpy(a).cuda() for a in data(LENET_B)))
             for _ in range(LENET_STEPS)]
    test_x, test_y = data(2048)
    before = net.evaluate(DataSet(test_x, test_y)).accuracy()
    net.fit(train[0])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for ds in train[1:]:
        net.fit(ds)
    e1.record()
    torch.cuda.synchronize()
    step = e0.elapsed_time(e1) / (LENET_STEPS - 1)
    acc = net.evaluate(DataSet(test_x, test_y)).accuracy()
    loss = float(net.score_value)
    assert math.isfinite(loss)
    assert acc > 0.9, (before, acc)
    flops = 3 * 2 * (24 * 24 * 1 * 20 * 25 + 8 * 8 * 20 * 50 * 25
                     + 800 * 500 + 500 * 10) * LENET_B
    log(f"LeNet on MultiLayerNetwork (B={LENET_B}, Adam 1e-3, f32, {card}):"
        f" {LENET_STEPS - 1} warm steps through fit, {step:.3f} ms a step "
        f"(CUDA events over the run) = {LENET_B / step * 1e3:.0f} images/s"
        f" (bound {flops / PEAK_F32_FLOPS * 1e3:.4f} ms); last loss "
        f"{loss:.4f}; evaluate().accuracy() on 2048 held-out rows "
        f"{before:.4f} before, {acc:.4f} after")
    return {"step_ms": step, "accuracy": acc}


def resnet_serve(net, card):
    """Write the trained ResNet50 (its parameters and batch-norm state:
    serving reads no updater state, and train_phase round-trips one),
    restore it, serve SERVE_ROWS rows through ModelServer /v1/predict:
    probabilities sum to 1 and equal ``output`` of the restored net on
    the same rows."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet.zip")
        t0 = time.perf_counter()
        write_model(net, path, save_updater=False)
        restored = restore_model(path, device="cuda")
        io_s = time.perf_counter() - t0
    assert isinstance(restored, ComputationGraph)
    x = np.random.default_rng(2).normal(
        0, 1, (SERVE_ROWS, RESNET_HW, RESNET_HW, 3)).astype("float32")
    reg = ModelRegistry()
    reg.register("resnet", restored)
    server = ModelServer(reg, wait_ms=5.0).start()
    try:
        t0 = time.perf_counter()
        code, body, _ = http(server.port, "/v1/predict",
                             {"model": "resnet", "inputs": x.tolist()})
        req_s = time.perf_counter() - t0
    finally:
        server.stop(drain=True)
    assert code == 200, body
    out = np.asarray(body["outputs"], np.float32)
    assert out.shape == (SERVE_ROWS, RESNET_CLASSES)
    assert np.isfinite(out).all()
    sums = np.abs(out.sum(-1) - 1).max()
    assert sums <= 1e-5, sums
    ref = restored.output(x).cpu().numpy()
    diff = float(np.abs(out - ref).max())
    assert diff <= 1e-6, diff
    torch.cuda.synchronize()
    log(f"ResNet50 served ({card}): write + restore {io_s:.2f} s; one "
        f"/v1/predict of {SERVE_ROWS} rows {req_s:.2f} s; probabilities "
        f"sum to 1 within {sums:.2e}; max |served - output| {diff:.2e}")


def cnn_phase(card):
    """ResNet50 training at the headline leg's shape in f32 then under
    tpu_bf16(), the card step held against the CPU in both, LeNet's
    steps and accuracy, and one served ResNet50 predict."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import dtypes, zoo
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import updaters

    t0 = time.perf_counter()
    resnet_card_vs_cpu()
    log(f"card-vs-CPU checks {time.perf_counter() - t0:.1f} s")

    net = zoo.ResNet50(n_classes=RESNET_CLASSES,
                       updater=updaters.nesterovs(0.1, 0.9)).init(
                           device="cuda")
    assert net.num_params() == 25_557_032
    params0 = updaters.tree_map(lambda p: p.detach().clone(), net.params)
    rng = np.random.default_rng(0)                    # bench.py:168-170
    x = rng.normal(0, 1, (RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(
        "float32")
    y = np.eye(RESNET_CLASSES, dtype="float32")[
        rng.integers(0, RESNET_CLASSES, RESNET_B)]
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    f32 = resnet_leg(net, ds, "f32", PEAK_F32_FLOPS, card)
    net.init()                       # the bf16 leg starts where f32 did
    net.set_params(params0)
    del params0
    with dtypes.policy_scope(dtypes.tpu_bf16()):
        bf16 = resnet_leg(net, ds, "bf16", PEAK_BF16_FLOPS, card)
    del ds
    resnet_serve(net, card)
    del net
    torch.cuda.empty_cache()
    lenet = lenet_phase(card)
    log("cnn_phase summary: " + json.dumps({
        "resnet50_f32": {k: v for k, v in f32.items() if k != "families"},
        "resnet50_bf16": {k: v for k, v in bf16.items()
                          if k != "families"},
        "lenet": lenet}))


CHAR_B, CHAR_T, CHAR_V, CHAR_H = 32, 64, 80, 256   # bench.py:381-386
CHAR_WARM_STEPS = 20       # timed warm steps, after one untimed
CHAR_LEARN_STEPS = 200     # steps on the learnable text
# the learnable text: a fixed random permutation of this many of the
# CHAR_V symbols, repeated. A permutation of all CHAR_V is run too, for
# CHAR_ALL_STEPS, and its accuracy printed: at the leg's RMSProp 1e-3
# neither the port nor the JAX package (rnn_learn_reference.py) learns it
# in 200 steps; the run is seeded, so its 200-step accuracy on the card
# is on record (PERF.md), and the smoke stops it at 100 steps to keep
# its wall time
LEARN_SYMBOLS = 20
CHAR_ALL_STEPS = 100
# forward FLOPs a character (bench.py:588-593): two GravesLSTM layers'
# gate products and the output layer; a training step is 3x that
CHAR_FLOPS_PER_CHAR = (2 * 4 * CHAR_H * (CHAR_V + CHAR_H)
                       + 2 * 4 * CHAR_H * (CHAR_H + CHAR_H)
                       + 2 * CHAR_H * CHAR_V)
TBPTT_FWD = 16             # 4 chunks of the leg's T=64
# the tBPTT step on the card vs the CPU: B, T, width (vocab CHAR_V)
RNN_CHECK_B, RNN_CHECK_T, RNN_CHECK_H = 8, 32, 64
STREAM_B, STREAM_CHARS, STREAM_CAPACITY = 4, 64, 128
RNN_SLOTS, RNN_CAPACITY = 8, 128           # the served char-RNN LM
RNN_PROMPT_MIN, RNN_PROMPT_MAX = 8, 48
HYBRID_B, HYBRID_T = 4, 256


def char_rnn_conf(hidden=None, tbptt=None, embed=False):
    """bench.py:395-401's char-RNN: two GravesLSTM(hidden, tanh) and an
    RnnOutputLayer (mcxent) over CHAR_V one-hot symbols, RMSProp 1e-3,
    seed 0; with ``embed``, ids in through an EmbeddingSequenceLayer
    (tests/test_decode_paged.py's ``_rnn_lm`` at the leg's widths)."""
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        EmbeddingSequenceLayer, GravesLSTM, RnnOutputLayer)
    hidden = hidden or CHAR_H
    b = (NeuralNetConfiguration.builder().set_seed(0)
         .updater(updaters.rmsprop(1e-3)))
    if tbptt is not None:
        b = b.backprop_type("tbptt", fwd_length=tbptt)
    b = b.list()
    if embed:
        b = b.layer(EmbeddingSequenceLayer(n_in=CHAR_V, n_out=hidden))
    return (b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
            .layer(GravesLSTM(n_out=hidden, activation="tanh"))
            .layer(RnnOutputLayer(n_out=CHAR_V, loss="mcxent"))
            .set_input_type(InputType.recurrent(CHAR_V, CHAR_T)).build())


def char_batch(ids, device):
    """(one-hot inputs, one-hot next-symbol labels) of (B, T + 1) ids."""
    import torch
    ids = torch.as_tensor(ids, device=device)
    oh = torch.nn.functional.one_hot(ids, CHAR_V).float()
    return oh[:, :-1], oh[:, 1:]


def rnn_family(name):
    """A CUDA kernel of the char-RNN step by family, from its name."""
    n = name.lower()
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "splitk")):
        return "gemm (cuBLAS)"
    if "reduce" in n:
        return "reductions (loss, bias grads)"
    if "copy" in n or "cat" in n:
        return "copies (stack, cat, slices)"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise (gates, updater)"
    return "other"


def profile_rnn_step(net, ds):
    """One warm char-RNN step under torch.profiler: device ms by kernel
    family, kernels and host launch calls a step, busy and wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, kernels = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = rnn_family(evt.key)
        fams[fam] = fams.get(fam, 0.0) + evt.self_device_time_total / 1e3
        kernels += evt.count
    launch_calls = sum(sync_calls(prof, LAUNCH_CALLS).values())
    busy = sum(fams.values())
    assert busy > 0, "profiler recorded no device time"
    return {"families": fams, "kernels": kernels,
            "launch_calls": launch_calls, "busy_ms": busy,
            "wall_ms": wall_ms, "idle": max(0.0, 1 - busy / wall_ms)}


def char_rnn_train(card):
    """bench.py:381-418's char-RNN uncut through ``fit``: 1 untimed,
    CHAR_WARM_STEPS timed (CUDA events) and 1 profiled step on
    ``default_rng(0)`` ids, and the cuDNN LSTM yardstick. Returns its
    numbers."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(char_rnn_conf(), device="cuda").init()
    n_params = net.num_params()
    rng = np.random.default_rng(0)                      # bench.py:398-401
    ids = rng.integers(0, CHAR_V, (CHAR_B, CHAR_T))
    x = np.eye(CHAR_V, dtype="float32")[ids]
    y = np.eye(CHAR_V, dtype="float32")[np.roll(ids, -1, axis=1)]
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()    # what earlier phases still hold
    t0 = time.perf_counter()
    net.fit(ds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    steps = []
    for _ in range(CHAR_WARM_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit(ds)
        e1.record()
        torch.cuda.synchronize()
        steps.append(e0.elapsed_time(e1))
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    loss = float(net.score_value)
    assert math.isfinite(loss)
    med = sorted(steps)[len(steps) // 2]
    flops = 3 * CHAR_FLOPS_PER_CHAR * CHAR_B * CHAR_T
    bound_ms = flops / PEAK_F32_FLOPS * 1e3
    prof = profile_rnn_step(net, ds)
    log(f"char-RNN training (bench.py:381-418 uncut: B={CHAR_B}, "
        f"T={CHAR_T}, vocab {CHAR_V}, 2 x GravesLSTM({CHAR_H}), RMSProp "
        f"1e-3, {n_params} params, {card}): first step {first_s:.3f} s; "
        f"{CHAR_WARM_STEPS} warm steps (CUDA events) median {med:.3f} ms, "
        f"min {min(steps):.3f}, max {max(steps):.3f} = "
        f"{CHAR_B * CHAR_T / med * 1e3:.0f} chars/s; bound {bound_ms:.4f} ms"
        f" ({flops / 1e9:.3f} GFLOP at the f32 CUDA-core "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s): {100 * bound_ms / med:.2f}%"
        f" of it; peak device memory {peak_gib:.3f} GiB above what was "
        f"allocated before; loss {loss:.4f}")
    log(f"char-RNN step under torch.profiler (one warm step): "
        f"{prof['kernels']} kernels, {prof['launch_calls']} host launch "
        f"calls; device " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / prof['busy_ms']:.1f}%)"
            for k, v in sorted(prof["families"].items(),
                               key=lambda kv: -kv[1]))
        + f"; busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
          f"wall under the profiler, idle {100 * prof['idle']:.1f}%; of the "
          f"unprofiled median step, idle "
          f"{100 * max(0.0, 1 - prof['busy_ms'] / med):.1f}%")
    return {"step_ms": med, "idle_unprofiled": max(0.0, 1 - prof["busy_ms"]
                                                   / med), "steps_ms": steps,
            "chars_s": CHAR_B * CHAR_T / med * 1e3, "bound_ms": bound_ms,
            "bound_share": bound_ms / med, "first_s": first_s,
            "peak_gib": peak_gib, "kernels": prof["kernels"],
            "launch_calls": prof["launch_calls"], "busy_ms": prof["busy_ms"],
            "wall_ms": prof["wall_ms"], "idle": prof["idle"],
            **lstm_yardstick(card)}


def learn_data(symbols, seed=0):
    """The learning run's data, numpy only (``rnn_learn_reference.py``
    draws the same): a text that repeats a fixed random permutation of
    ``symbols`` of the CHAR_V symbols (the current symbol decides the
    next), the offsets of 64 held-out windows, and the generator of each
    step's CHAR_B window offsets."""
    import numpy as np
    syms = np.random.default_rng(1 + seed).permutation(CHAR_V)
    text = np.tile(syms[:symbols], 64 * CHAR_V // symbols)
    held = np.random.default_rng(3 + seed).integers(
        0, len(text) - CHAR_T - 1, 64)
    return text, held, np.random.default_rng(2 + seed)


def windows(text, offsets):
    """(len(offsets), CHAR_T + 1) ids: the text's windows at ``offsets``."""
    import numpy as np
    return np.stack([text[o:o + CHAR_T + 1] for o in offsets])


def char_rnn_learn(card, symbols, steps=CHAR_LEARN_STEPS):
    """A fresh char-RNN (the leg's config) for ``steps`` steps on
    windows of ``learn_data(symbols)``'s text. Returns (the trained net,
    the text, the first and last step's loss and next-symbol accuracy on
    the 64 held-out windows)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(char_rnn_conf(), device="cuda").init()
    text, held, rng = learn_data(symbols)
    span = len(text) - CHAR_T - 1
    hx, hy = char_batch(windows(text, held), "cuda")

    def accuracy():
        return float((net.output(hx).argmax(-1) == hy.argmax(-1))
                     .float().mean())
    before = accuracy()
    losses, accs = [], []
    t0 = time.perf_counter()
    for k in range(steps):
        net.fit(DataSet(*char_batch(
            windows(text, rng.integers(0, span, CHAR_B)), "cuda")))
        if k in (0, steps - 1):
            losses.append(float(net.score_value))
        if k % 25 == 24:
            accs.append(round(accuracy(), 4))
    learn_s = time.perf_counter() - t0
    acc = accuracy()
    log(f"char-RNN learning ({card}): {steps} steps in "
        f"{learn_s:.2f} s on a permutation of {symbols} of the {CHAR_V} "
        f"symbols repeated; loss {losses[0]:.4f} at step 1, "
        f"{losses[1]:.4f} at step {steps}; next-symbol accuracy "
        f"on 64 held-out windows {before:.4f} before, every 25 steps "
        f"{accs}, {acc:.4f} after")
    assert losses[1] < losses[0], losses
    return net, text, {"learn_loss": losses, "accuracy": acc,
                       "learn_s": learn_s}


def lstm_yardstick(card):
    """torch.nn.LSTM (cuDNN, float32, no peepholes) forward + backward at
    B=CHAR_B, T=CHAR_T, CHAR_H -> CHAR_H, beside one port GravesLSTM
    layer at the same shapes (CUDA events; a measurement only, used on
    no path)."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM
    g = torch.Generator(device="cuda").manual_seed(0)
    xin = torch.randn(CHAR_B, CHAR_T, CHAR_H, generator=g, device="cuda",
                      requires_grad=True)
    lstm = torch.nn.LSTM(CHAR_H, CHAR_H, batch_first=True).cuda()
    weights = [xin] + list(lstm.parameters())

    def cudnn():
        y, _ = lstm(xin)
        torch.autograd.grad(y.sum(), weights)
    layer = GravesLSTM(n_in=CHAR_H, n_out=CHAR_H, activation="tanh")
    p, _ = layer.initialize(torch.Generator().manual_seed(0),
                            InputType.recurrent(CHAR_H))
    p = {k: v.cuda().requires_grad_() for k, v in p.items()}

    def ours():
        y, _ = layer.apply(p, {}, xin)
        torch.autograd.grad(y.sum(), [xin] + list(p.values()))
    cudnn_ms = time_ms(cudnn, iters=20, warmup=3)
    ours_ms = time_ms(ours, iters=10, warmup=2)
    flops = 3 * 2 * 4 * CHAR_H * (CHAR_H + CHAR_H) * CHAR_B * CHAR_T
    bound_ms = flops / PEAK_F32_FLOPS * 1e3
    log(f"one recurrent layer forward + backward, B={CHAR_B}, T={CHAR_T}, "
        f"{CHAR_H}->{CHAR_H}, f32 ({card}): torch.nn.LSTM (cuDNN, no "
        f"peepholes) {cudnn_ms:.3f} ms; the port's GravesLSTM (plain ops) "
        f"{ours_ms:.3f} ms; bound {bound_ms:.4f} ms ({flops / 1e9:.3f} "
        "GFLOP at the f32 CUDA-core peak)")
    return {"cudnn_lstm_ms": cudnn_ms, "graves_layer_ms": ours_ms,
            "layer_bound_ms": bound_ms}


def tbptt_card_vs_cpu(card):
    """One tBPTT batch (B=RNN_CHECK_B, T=RNN_CHECK_T in chunks of
    TBPTT_FWD, width RNN_CHECK_H, vocab CHAR_V) on the card held against
    the same batch on the CPU, leaf by leaf (each chunk's loss, the
    params and the RMSProp state after the batch), in L2, within
    F32_FACTOR times the CPU's own largest difference over three reruns
    with the rows reordered and/or oneDNN off, plus FLOOR_RTOL of the
    leaf's norm (``_leaf_errors``, as ``resnet_card_vs_cpu``)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    conf = char_rnn_conf(RNN_CHECK_H, tbptt=TBPTT_FWD)
    params0 = MultiLayerNetwork(conf, device="cpu").init().params
    ids = np.random.default_rng(4).integers(
        0, CHAR_V, (RNN_CHECK_B, RNN_CHECK_T + 1))
    chunks = RNN_CHECK_T // TBPTT_FWD

    def run(device, roll=0, onednn=True):
        net = MultiLayerNetwork(conf, device=device)
        net.set_params(params0)
        net._build_optimizer()
        losses = []

        class Losses(TrainingListener):  # every chunk's loss (replayed)
            def iteration_done(self, model, iteration, score, batch_size):
                losses.append(score)
        net.set_listeners(Losses())
        with torch.backends.mkldnn.flags(enabled=onednn):
            net.fit(DataSet(*char_batch(np.roll(ids, roll, axis=0),
                                        device)))
        assert net.iteration_count == chunks
        return {**{f"loss/{i}": np.array([float(v)])
                   for i, v in enumerate(losses)},
                **{"param/" + k: v for k, v in _flatten(net.params).items()},
                **{"opt/" + k: v for k, v in _flatten(net.opt_state).items()}}
    cpu = run("cpu")
    reruns = [run("cpu", roll, onednn)
              for roll, onednn in ((3, False), (5, True), (0, False))]
    card_out = run("cuda")
    rows = _leaf_errors(card_out, cpu, reruns, F32_FACTOR)
    log(f"tBPTT batch on the card vs the CPU (B={RNN_CHECK_B}, "
        f"T={RNN_CHECK_T} in {chunks} chunks of {TBPTT_FWD}, width "
        f"{RNN_CHECK_H}, {card}): chunk losses "
        + ", ".join(f"{card_out[f'loss/{i}'][0]:.6f} vs "
                    f"{cpu[f'loss/{i}'][0]:.6f}" for i in range(chunks))
        + f"; {len(cpu)} leaves; L2 |card - cpu| / ({F32_FACTOR:g} x the "
          f"CPU's largest rerun difference + {FLOOR_RTOL:g} x |cpu|), worst "
          "three: " + "; ".join(f"{k} {r:.3f} ({e:.3e} of {lim:.3e})"
                                for r, k, e, lim in rows[:3]) + " (limit 1)")
    assert rows[0][0] <= 1.0, rows[:3]
    return rows[0][0]


def char_rnn_tbptt(card):
    """The leg's config under backprop_type("tbptt", fwd_length=16) at
    T=64: one batch is 4 chunks, 4 updater steps and 4 iterations."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    net = MultiLayerNetwork(char_rnn_conf(tbptt=TBPTT_FWD),
                            device="cuda").init()
    ds = DataSet(*char_batch(np.random.default_rng(5).integers(
        0, CHAR_V, (CHAR_B, CHAR_T + 1)), "cuda"))
    chunks = CHAR_T // TBPTT_FWD
    net.fit(ds)
    assert net.iteration_count == chunks, net.iteration_count
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    net.fit(ds)
    e1.record()
    torch.cuda.synchronize()
    assert net.iteration_count == 2 * chunks, net.iteration_count
    assert math.isfinite(float(net.score_value))
    ms = e0.elapsed_time(e1)
    log(f"char-RNN under tBPTT (fwd_length {TBPTT_FWD}, T={CHAR_T}, "
        f"B={CHAR_B}, {card}): {chunks} iterations a batch; a warm batch "
        f"{ms:.3f} ms ({ms / chunks:.3f} ms a chunk)")
    worst = tbptt_card_vs_cpu(card)
    return {"tbptt_batch_ms": ms, "tbptt_worst_leaf": worst}


def char_rnn_stream(net, text, card):
    """On the trained net: STREAM_CHARS greedy symbols at B=STREAM_B three
    ways (``rnn_time_step`` a symbol a call, a streaming session's
    ``step``, ``output`` of the whole growing sequence), equal ids; then
    a written and restored zip whose ``output`` is bit-equal."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    def onehot(ids):
        return F.one_hot(ids, CHAR_V).float()
    start = torch.as_tensor(text[[0, 7, 13, 18]]).cuda()
    t0 = time.perf_counter()
    net.rnn_clear_previous_state()
    cur, a = start, []
    for _ in range(STREAM_CHARS):
        cur = net.rnn_time_step(onehot(cur)).argmax(-1)
        a.append(cur)
    sess = net.streaming_session(capacity=STREAM_CAPACITY, batch=STREAM_B)
    cur, b = start, []
    for _ in range(STREAM_CHARS):
        cur = sess.step(onehot(cur)).argmax(-1)
        b.append(cur)
    seq, c = start[:, None], []
    for _ in range(STREAM_CHARS):
        nxt = net.output(onehot(seq))[:, -1].argmax(-1)
        c.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], 1)
    a, b, c = (torch.stack(v, 1).cpu().numpy() for v in (a, b, c))
    stream_s = time.perf_counter() - t0
    # the text's transitions: each symbol of it has one successor
    succ = dict(zip(text[:-1].tolist(), text[1:].tolist()))
    prev = np.concatenate([start.cpu().numpy()[:, None], a[:, :-1]], 1)
    follows = np.mean([[succ.get(p) == n for p, n in zip(pr, nx)]
                       for pr, nx in zip(prev.tolist(), a.tolist())])
    assert (a == b).all() and (a == c).all(), (a, b, c)
    hx, _ = char_batch(windows(text, (3, 11, 29)), "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "char_rnn.zip")
        write_model(net, path)
        restored = restore_model(path, device="cuda")
    assert torch.equal(restored.output(hx), net.output(hx))
    log(f"char-RNN greedy decode ({card}): {STREAM_CHARS} symbols x "
        f"{STREAM_B} rows equal three ways (rnn_time_step, "
        f"streaming_session(capacity={STREAM_CAPACITY}).step, output of "
        f"the growing sequence) in {stream_s:.2f} s; {100 * follows:.1f}% "
        "of the generated transitions are the learned text's; zip write "
        "+ restore: output bit-equal")


def rnn_lone_decode(net, prompt, n_tokens):
    """Greedy ids of one prompt through ``rnn_time_step`` alone (B=1),
    and the probabilities of every step."""
    import numpy as np
    import torch
    net.rnn_clear_previous_state()
    probs = net.rnn_time_step(np.asarray(prompt, np.float32)[None, :, None])
    probs = probs[:, -1]
    ids, steps = [], []
    for _ in range(n_tokens):
        steps.append(probs[0])
        nxt = probs.argmax(-1)
        ids.append(nxt)
        probs = net.rnn_time_step(nxt[:, None].float())
    return torch.cat(ids).cpu().numpy(), steps


def char_rnn_serve(net, card):
    """ModelServer: /v1/predict of 8 rows of the trained char-RNN, and
    /v1/generate of 16 concurrent requests to the char-RNN LM (ids in
    through an embedding), which ``kv_mode="auto"`` decodes on the dense
    slot session; greedy ids held against lone ``rnn_time_step``
    decodes (a mismatch passes only at a near tie, TIE_RTOL)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.models.streaming import (
        SlotStreamingSession)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    lm = MultiLayerNetwork(char_rnn_conf(embed=True), device="cuda").init()
    rng = np.random.default_rng(6)
    x = np.eye(CHAR_V, dtype="float32")[rng.integers(0, CHAR_V,
                                                     (8, CHAR_T))]
    lengths = rng.integers(RNN_PROMPT_MIN, RNN_PROMPT_MAX + 1, GEN_REQUESTS)
    bodies = []
    for i, n in enumerate(lengths):
        body = {"model": "rnnlm", "prompt": rng.integers(0, CHAR_V,
                                                         n).tolist(),
                "n_tokens": GEN_TOKENS}
        if i % 4 == 3:
            body.update(temperature=0.8, seed=200 + i)
        bodies.append(body)
    reg = ModelRegistry()
    reg.register("char", net)
    reg.register("rnnlm", lm)
    server = ModelServer(reg, slots=RNN_SLOTS, capacity=RNN_CAPACITY,
                         wait_ms=5.0).start()
    try:
        code, body, _ = http(server.port, "/v1/predict",
                             {"model": "char", "inputs": x.tolist()})
        assert code == 200, body
        batcher, _ = server.batcher_for("rnnlm")
        assert not batcher._paged
        assert isinstance(batcher.session, SlotStreamingSession)
        http(server.port, "/v1/generate", {"model": "rnnlm",
                                           "prompt": [1, 2, 3],
                                           "n_tokens": 2})     # warm
        stream = batcher._stream
        before = [h.bucket_counts() for h in (stream.ttft, stream.itl)]
        replies = [None] * GEN_REQUESTS
        errors = []
        barrier = threading.Barrier(GEN_REQUESTS)

        def client(i):
            try:
                barrier.wait(timeout=60)
                replies[i] = http(server.port, "/v1/generate", bodies[i])
            except Exception as e:       # reported and failed below
                errors.append(repr(e))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(GEN_REQUESTS)]
        steps0 = batcher.device_steps
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        assert not errors, errors
        assert not any(th.is_alive() for th in threads), "client hung"
        ttft, itl = (hist_since(h, b) for h, b in zip(
            (stream.ttft, stream.itl), before))
        steps = batcher.device_steps - steps0
    finally:
        server.stop(drain=True)
    out = np.asarray(body["outputs"], np.float32)
    assert out.shape == (8, CHAR_T, CHAR_V) and np.isfinite(out).all()
    diff = float(np.abs(out - net.output(x).cpu().numpy()).max())
    assert diff <= 1e-6, diff
    compared = ties = 0
    for b, (code, reply, _) in zip(bodies, replies):
        assert code == 200, reply
        ids = np.asarray(reply["ids"])
        assert ids.shape == (GEN_TOKENS,) and ((ids >= 0) & (ids < CHAR_V)
                                               ).all()
        if "temperature" in b:
            continue
        ref, probs = rnn_lone_decode(lm, b["prompt"], GEN_TOKENS)
        bad = np.flatnonzero(ids != ref)
        if bad.size:
            m = int(bad[0])
            top2 = probs[m].double().topk(2).values.cpu().numpy()
            gap = (top2[0] - top2[1]) / top2[0]
            assert gap <= TIE_RTOL, (m, ids[m], ref[m], top2)
            ties += 1
            compared += m
        else:
            compared += ids.size
    log(f"char-RNN served ({card}): /v1/predict of 8 rows (max |served - "
        f"output| {diff:.2e}); /v1/generate of {GEN_REQUESTS} concurrent "
        f"requests (prompts {min(lengths)}-{max(lengths)} ids, "
        f"{GEN_TOKENS} tokens, 4 at temperature 0.8) on {RNN_SLOTS} dense "
        f"slots: {steps} device steps in {wall:.3f} s = "
        f"{GEN_REQUESTS * GEN_TOKENS / wall:.1f} generated tokens/s; TTFT "
        f"p50 {ttft.quantile(0.5):.3f} s, ITL p50 "
        f"{1e3 * itl.quantile(0.5):.3f} ms; greedy ids vs lone rnn_time_step"
        f" decodes: {compared} compared and equal, {ties} near ties")
    return {"tokens_s": GEN_REQUESTS * GEN_TOKENS / wall,
            "ttft_p50_s": ttft.quantile(0.5),
            "itl_p50_ms": 1e3 * itl.quantile(0.5), "gen_steps": steps}


def hybrid_check(attn, da, card):
    """GravesLSTM(CHAR_H) -> TransformerEncoderLayer(4 heads, causal;
    head dim 64) -> RnnOutputLayer(CHAR_V) at T=HYBRID_T, B=HYBRID_B:
    ``output`` of the whole sequence (the flash forward kernel) and the
    sequence stepped one symbol at a time through the dense
    StreamingSession (every attention the decode kernel), each held
    against the same net on the plain attention (``plain_attention``,
    ``plain_decode_attention``) and against each other at ATOL / RTOL.
    Returns (forward launches, decode launches) of this path."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesLSTM, RnnOutputLayer, TransformerEncoderLayer)
    conf = (NeuralNetConfiguration.builder().set_seed(0).list()
            .layer(GravesLSTM(n_out=CHAR_H, activation="tanh"))
            .layer(TransformerEncoderLayer(n_heads=4, causal=True))
            .layer(RnnOutputLayer(n_out=CHAR_V, loss="mcxent"))
            .set_input_type(InputType.recurrent(CHAR_V, HYBRID_T)).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    x, _ = char_batch(np.random.default_rng(7).integers(
        0, CHAR_V, (HYBRID_B, HYBRID_T + 1)), "cuda")

    def stream():
        sess = net.streaming_session(capacity=HYBRID_T, batch=HYBRID_B)
        return torch.stack([sess.step(x[:, t]) for t in range(HYBRID_T)],
                           1)
    attn.flash_attention_fwd_cuda.launches = 0     # this path only
    da.decode_attention_cuda.launches = 0
    full = net.output(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stepped = stream()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / HYBRID_T
    fwd, dec = (attn.flash_attention_fwd_cuda.launches,
                da.decode_attention_cuda.launches)
    assert fwd >= 1 and dec == HYBRID_T, (fwd, dec)
    with plain_attention(attn), plain_decode_attention(da):
        full_plain, stepped_plain = net.output(x), stream()
    assert (attn.flash_attention_fwd_cuda.launches,
            da.decode_attention_cuda.launches) == (fwd, dec)
    errs = {}
    for what, got, ref in (("output vs plain", full, full_plain),
                           ("stepped vs plain", stepped, stepped_plain),
                           ("stepped vs output", stepped, full)):
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
        errs[what] = float((got - ref).abs().max())
    log(f"hybrid GravesLSTM({CHAR_H}) -> TransformerEncoderLayer(4 heads, "
        f"causal) -> RnnOutputLayer({CHAR_V}), T={HYBRID_T}, B={HYBRID_B} "
        f"({card}): stepped through the dense session, {step_ms:.3f} ms a "
        f"step (host clock); max |diff| (atol {ATOL:g}, rtol {RTOL:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; flash_attention_fwd launches {fwd}, decode_attention "
          f"launches {dec}")
    return fwd, dec, {"hybrid_step_ms": step_ms,
                      "hybrid_max_abs_err": max(errs.values())}


def rnn_phase(attn, da, card):
    """The recurrent slice on the card: the char-RNN trained (timing,
    profile, learning), under tBPTT (and against the CPU), streamed,
    served; the GravesLSTM + transformer hybrid through the kernels.
    Returns the hybrid's (forward, decode) launches."""
    import torch
    train = char_rnn_train(card)
    _, _, all80 = char_rnn_learn(card, CHAR_V, CHAR_ALL_STEPS)
    net, text, learned = char_rnn_learn(card, LEARN_SYMBOLS)
    assert learned["accuracy"] > 0.9, learned
    tbptt = char_rnn_tbptt(card)
    char_rnn_stream(net, text, card)
    served = char_rnn_serve(net, card)
    del net
    torch.cuda.empty_cache()
    fwd, dec, hybrid = hybrid_check(attn, da, card)
    log("rnn_phase summary: " + json.dumps({
        **train, **learned, "accuracy_all_symbols": all80["accuracy"],
        **tbptt, **served, **hybrid}))
    return fwd, dec


# ------------------------------------------------------------ Keras import
# bench.py's vgg16_import leg (_KERAS_VGG16_SCRIPT, :470-488): B=32,
# 224x224x3, f32, 13 convs (3x3 same, relu) in 5 blocks + 3 dense
VGG_B, VGG_HW, VGG_CLASSES, VGG_DENSE = 32, 224, 1000, 4096
VGG_WIDTHS = (64, 128, 256, 512, 512)
VGG_REPS = (2, 2, 3, 3, 3)
VGG_TIMED = 20             # warm batches timed one by one (median)
# bench.py:586's VGG16_FWD_FLOPS: 15.47e9 an image, which counts one
# multiply-add as one operation (2x that in FLOPs, conv_dense_flops)
VGG16_FWD_FLOPS_BENCH = 15.47e9
# the imported transformer encoder block at the LM's width
BLOCK_B, BLOCK_T, BLOCK_D, BLOCK_H, BLOCK_CLASSES = 8, 1024, 1024, 16, 10
CPU_ROWS = 2               # rows held against the CPU


def _keras_layer(class_name, name, inbound=None, **config):
    """One layer of a Keras ``model_config`` (``config`` in Keras's own
    key names); ``inbound``: a Functional layer's Keras 2 node list."""
    layer = {"class_name": class_name, "name": name,
             "config": {"name": name, **config}}
    if inbound is not None:
        layer["inbound_nodes"] = [[[n, 0, 0, {}] for n in inbound]] \
            if inbound else []
    return layer


def _conv2d(name, filters):
    return _keras_layer("Conv2D", name, filters=filters, kernel_size=[3, 3],
                        strides=[1, 1], padding="same", dilation_rate=[1, 1],
                        activation="relu", use_bias=True)


def _dense(name, units, activation, inbound=None):
    return _keras_layer("Dense", name, inbound, units=units,
                        activation=activation, use_bias=True)


def keras_vgg16(hw, widths, dense, classes):
    """bench.py's Keras VGG16 as the Sequential ``model_config`` Keras
    writes (layers b{block}c{r}, b{block}p, flat, fc1, fc2, pred), and
    {layer: [(shape, init)]} of its weights in Keras's order."""
    layers = [_keras_layer("InputLayer", "input_layer",
                           batch_shape=[None, hw, hw, 3])]
    shapes, cin, side = {}, 3, hw
    for block, (n, reps) in enumerate(zip(widths, VGG_REPS)):
        for r in range(reps):
            layers.append(_conv2d(f"b{block}c{r}", n))
            shapes[f"b{block}c{r}"] = [((3, 3, cin, n), "glorot"),
                                       ((n,), "zeros")]
            cin = n
        layers.append(_keras_layer("MaxPooling2D", f"b{block}p",
                                   pool_size=[2, 2], strides=[2, 2],
                                   padding="valid"))
        side //= 2
    layers.append(_keras_layer("Flatten", "flat"))
    n_in = side * side * cin
    for name, units, act in (("fc1", dense, "relu"), ("fc2", dense, "relu"),
                             ("pred", classes, "softmax")):
        layers.append(_dense(name, units, act))
        shapes[name] = [((n_in, units), "glorot"), ((units,), "zeros")]
        n_in = units
    return ({"class_name": "Sequential",
             "config": {"name": "vgg16", "layers": layers}}, shapes)


def keras_transformer_block(T, d, H, classes):
    """A Keras transformer encoder block (tests/test_keras_import.py's
    model: LayerNormalization, self-attention MultiHeadAttention, Add,
    LayerNormalization, Dense(4d, gelu), Dense(d), Add,
    GlobalAveragePooling1D, Dense softmax) as the Functional
    ``model_config`` in Keras 2's inbound-node format, and its weights'
    (shape, init) in Keras's order."""
    kd = d // H
    ln = dict(axis=-1, epsilon=1e-3, center=True, scale=True)
    layers = [
        _keras_layer("InputLayer", "inp", [], batch_shape=[None, T, d]),
        _keras_layer("LayerNormalization", "ln1", ["inp"], **ln),
        _keras_layer("MultiHeadAttention", "mha", ["ln1", "ln1"],
                     num_heads=H, key_dim=kd, value_dim=kd, dropout=0.0,
                     use_bias=True, output_shape=None,
                     attention_axes=None),
        _keras_layer("Add", "add1", ["inp", "mha"]),
        _keras_layer("LayerNormalization", "ln2", ["add1"], **ln),
        _dense("ff1", 4 * d, "gelu", ["ln2"]),
        _dense("ff2", d, "linear", ["ff1"]),
        _keras_layer("Add", "add2", ["add1", "ff2"]),
        _keras_layer("GlobalAveragePooling1D", "gap", ["add2"]),
        _dense("pred", classes, "softmax", ["gap"]),
    ]
    ln_w = [((d,), "ones"), ((d,), "zeros")]
    shapes = {"ln1": ln_w, "ln2": ln_w,
              "mha": [((d, H, kd), "glorot"), ((H, kd), "zeros")] * 3
              + [((H, kd, d), "glorot"), ((d,), "zeros")],
              "ff1": [((d, 4 * d), "glorot"), ((4 * d,), "zeros")],
              "ff2": [((4 * d, d), "glorot"), ((d,), "zeros")],
              "pred": [((d, classes), "glorot"), ((classes,), "zeros")]}
    return ({"class_name": "Functional", "config": {
        "name": "block", "layers": layers,
        "input_layers": [["inp", 0, 0]],
        "output_layers": [["pred", 0, 0]]}}, shapes)


def keras_weights(shapes, seed=0):
    """Keras's default initialization from a seeded numpy generator:
    glorot-uniform kernels (Keras's fans: the receptive field times the
    last two axes), zero biases, LayerNormalization's gamma ones."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    for name, entries in shapes.items():
        arrays = []
        for shape, init in entries:
            if init != "glorot":
                arrays.append((np.ones if init == "ones" else np.zeros)(
                    shape, np.float32))
                continue
            field = int(np.prod(shape[:-2]))
            limit = math.sqrt(6.0 / (field * (shape[-2] + shape[-1])))
            u = rng.random(shape, dtype=np.float32)
            u *= np.float32(2 * limit)
            u -= np.float32(limit)
            arrays.append(u)
        out[name] = arrays
    return out


class _KerasGroup(dict):
    """One layer's group of a Keras h5 file: its datasets by name and
    ``attrs["weight_names"]`` in Keras's order."""

    def __init__(self, layer, arrays):
        names = [f"{layer}/w{i}" for i in range(len(arrays))]
        super().__init__(zip(names, arrays))
        self.attrs = {"weight_names": names}


class H5Like:
    """What the importer reads of a Keras legacy h5 file, in memory:
    ``attrs["model_config"]`` and ``["model_weights"][layer]``. Layers
    without weights have no group."""

    def __init__(self, model_config, weights):
        self.attrs = {"model_config": json.dumps(model_config)}
        self.model_weights = {name: _KerasGroup(name, arrays)
                              for name, arrays in weights.items() if arrays}

    def __getitem__(self, key):
        if key != "model_weights":
            raise KeyError(key)
        return self.model_weights


def write_keras_h5(path, model_config, weights, keras_version="2.15.0"):
    """The same archive as a real legacy Keras h5 file (needs h5py)."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        f.attrs["keras_version"] = keras_version
        f.attrs["backend"] = "tensorflow"
        mw = f.create_group("model_weights")
        for layer in model_config["config"]["layers"]:
            name = layer["config"]["name"]
            grp = mw.create_group(name)
            arrays = weights.get(name, [])
            names = [f"{name}/w{i}" for i in range(len(arrays))]
            for n, a in zip(names, arrays):
                grp.create_dataset(n, data=a)
            grp.attrs["weight_names"] = [n.encode() for n in names]


def median_ms(fn, n):
    """Median of ``n`` CUDA-event times of ``fn`` (ms), after a warm call."""
    import torch
    fn()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[n // 2]


def sequential_flops(net):
    """Forward FLOPs an example of a MultiLayerNetwork's convs and dense
    layers, from its config (``layer_flops`` summed over the layers)."""
    total, t = 0, net.conf.input_type
    for i, layer in enumerate(net.layers):
        if i in net.conf.preprocessors:
            t = net.conf.preprocessors[i].output_type(t)
        total += layer_flops(layer, t)
        t = layer.output_type(t)
    return total


def vgg16_import(card):
    """The vgg16_import leg on the card: bench.py's VGG16 config and
    Keras's default init (seed 0) through the importer's Sequential
    builder from memory, held against the same import on the CPU,
    timed, written and restored through the model guesser, summarized
    by the CLI; through a real h5 file when h5py is there."""
    import importlib.util

    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.keras import (
        import_keras_model_and_weights)
    from deeplearning4j_tpu_torch.keras.importer import _import_sequential
    from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    present = {m: importlib.util.find_spec(m) is not None
               for m in ("keras", "h5py")}
    log(f"on this machine: keras {'present' if present['keras'] else 'absent'}"
        f", h5py {'present' if present['h5py'] else 'absent'}")
    cfg, shapes = keras_vgg16(VGG_HW, VGG_WIDTHS, VGG_DENSE, VGG_CLASSES)
    t0 = time.perf_counter()
    weights = keras_weights(shapes, seed=0)
    archive = H5Like(cfg, weights)
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = _import_sequential(cfg, archive, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_params = net.num_params()
    assert n_params == sum(math.prod(shape) for entries in shapes.values()
                           for shape, _ in entries), n_params
    x = np.random.default_rng(0).normal(
        0, 1, (VGG_B, VGG_HW, VGG_HW, 3)).astype("float32")
    xd = torch.from_numpy(x).cuda()
    out = net.output(xd)
    assert out.shape == (VGG_B, VGG_CLASSES) and bool(
        torch.isfinite(out).all())
    cpu = _import_sequential(cfg, archive, device="cpu")
    ref = cpu.output(x[:CPU_ROWS])
    del cpu
    got = out[:CPU_ROWS].cpu()
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    err = float((got - ref).abs().max())
    top1 = int((got.argmax(1) == ref.argmax(1)).sum())
    ms = median_ms(lambda: net.output(xd), VGG_TIMED)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = sequential_flops(net) * VGG_B
    bound_bench_ms = VGG16_FWD_FLOPS_BENCH * VGG_B / PEAK_F32_FLOPS * 1e3
    bound_ms = flops / PEAK_F32_FLOPS * 1e3
    log(f"vgg16_import ({card}): B={VGG_B} {VGG_HW}x{VGG_HW}x3 f32, "
        f"{n_params} params; weights drawn in {draw_s:.2f} s, imported "
        f"onto the card in {import_s:.2f} s; card vs CPU on {CPU_ROWS} "
        f"images: max |diff| {err:.3e} (atol {ATOL:g}, rtol {RTOL:g}), "
        f"top-1 agree {top1}/{CPU_ROWS}; output warm median {ms:.3f} ms a "
        f"batch (CUDA events, {VGG_TIMED} batches) = "
        f"{VGG_B / ms * 1e3:.1f} images/s; bound at f32 "
        f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s: {bound_bench_ms:.3f} ms by "
        f"bench.py's {VGG16_FWD_FLOPS_BENCH:.4g} an image ("
        f"{100 * bound_bench_ms / ms:.1f}%), {bound_ms:.3f} ms by the "
        f"config's {flops / VGG_B:.4g} FLOPs an image "
        f"({100 * bound_ms / ms:.1f}%); peak device memory "
        f"{peak_gib:.2f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vgg16.zip")
        write_model(net, path)
        # the summary CLI reads the zip while this process restores it
        cli = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "summary",
             "--model", path, "--device", "cuda"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            # one batch size a comparison: cuDNN may take another
            # algorithm for another shape
            rows = net.output(xd[:CPU_ROWS])
            again = load_model_guess(path, device="cuda")
            assert torch.equal(again.output(xd[:CPU_ROWS]), rows)
            del again
            stdout, stderr = cli.communicate(timeout=300)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
        assert cli.returncode == 0, stderr
        lines = stdout.splitlines()
        assert lines[0] == "format: checkpoint", stdout
        assert lines[-1] == f"total params: {n_params}", stdout
        log(f"summary CLI of the zip: {lines[0]}; {len(lines) - 3} layers; "
            f"{lines[-1]}")
        if present["h5py"]:
            h5 = os.path.join(tmp, "vgg16.h5")
            write_keras_h5(h5, cfg, weights)
            from_file = import_keras_model_and_weights(h5, device="cuda")
            assert torch.equal(from_file.output(xd[:CPU_ROWS]), rows)
            log("the same archive as a legacy Keras h5 file, imported "
                "through import_keras_model_and_weights: outputs equal to "
                "the in-memory import")
            del from_file
        else:
            log("h5py is absent on this machine: the h5 file route was not "
                "run")
    return {"vgg16_ms": ms, "vgg16_images_per_s": VGG_B / ms * 1e3,
            "vgg16_bound_share_bench": bound_bench_ms / ms,
            "vgg16_bound_share_config": bound_ms / ms,
            "vgg16_peak_gib": peak_gib, "vgg16_max_abs_err": err,
            "vgg16_top1_agree": top1, "keras_present": present["keras"],
            "h5py_present": present["h5py"]}


def keras_block(attn, card):
    """An imported Keras transformer encoder block at the LM's width on
    ComputationGraph: its attention on the flash forward kernel, held
    against the same graph on the plain attention and against the CPU.
    Returns (forward launches of this path, numbers)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.keras.importer import _import_functional
    cfg, shapes = keras_transformer_block(BLOCK_T, BLOCK_D, BLOCK_H,
                                          BLOCK_CLASSES)
    archive = H5Like(cfg, keras_weights(shapes, seed=1))
    net = _import_functional(cfg, archive, device="cuda")
    x = np.random.default_rng(2).normal(
        0, 1, (BLOCK_B, BLOCK_T, BLOCK_D)).astype("float32")
    xd = torch.from_numpy(x).cuda()
    attn.flash_attention_fwd_cuda.launches = 0        # this path only
    out = net.output(xd)
    torch.cuda.synchronize()
    fwd = attn.flash_attention_fwd_cuda.launches
    assert fwd == 1, fwd
    assert out.shape == (BLOCK_B, BLOCK_CLASSES) and bool(
        torch.isfinite(out).all())
    with plain_attention(attn):
        plain = net.output(xd)
    assert attn.flash_attention_fwd_cuda.launches == fwd
    cpu = _import_functional(cfg, archive, device="cpu")
    ref = cpu.output(x[:CPU_ROWS])
    errs = {}
    for what, got, want in (("vs plain attention", out, plain),
                            ("vs the CPU", out[:CPU_ROWS].cpu(), ref)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        errs[what] = float((got - want).abs().max())
    ms = median_ms(lambda: net.output(xd), VGG_TIMED)
    log(f"imported Keras transformer block on ComputationGraph ({card}): "
        f"B={BLOCK_B} T={BLOCK_T} d={BLOCK_D} H={BLOCK_H}; output warm "
        f"median {ms:.3f} ms (CUDA events); max |diff| (atol {ATOL:g}, "
        f"rtol {RTOL:g}): " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in errs.items())
        + f"; flash_attention_fwd launches {fwd}")
    return fwd, {"block_ms": ms, "block_max_abs_err": max(errs.values())}


def keras_phase(attn, card):
    """Keras import on the card: the vgg16_import leg and the imported
    transformer block. Returns the block's forward launches."""
    import torch
    leg = vgg16_import(card)
    torch.cuda.empty_cache()
    fwd, block = keras_block(attn, card)
    torch.cuda.empty_cache()
    log("keras_phase summary: " + json.dumps({**leg, **block}))
    return fwd


def tf32_phase(card):
    """With both TF32 flags turned on, as a caller might, the LM (at
    depth 2) and a dense net compute in float32 on the card: the flags
    are off afterwards and each output is within f32 tolerance of the
    same network on the CPU (a TF32 product at these widths is ~1e-3
    off)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = lm_config()
    cfg["layers"] = cfg["layers"][:3] + cfg["layers"][-1:]
    mlp = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": 0},
           "input_type": {"kind": "ff", "size": D_MODEL},
           "layers": [{"@type": "DenseLayer", "n_out": D_MODEL,
                       "activation": "tanh"}] * 2
           + [{"@type": "DenseLayer", "n_out": D_MODEL}],
           "preprocessors": {}}
    rng = np.random.default_rng(3)
    inputs = (rng.integers(0, V, (2, 256)),
              rng.normal(0, 1, (16, D_MODEL)).astype("float32"))
    errs = {}
    for what, conf, x in (("LM (2 layers)", cfg, inputs[0]),
                          ("dense MLP", mlp, inputs[1])):
        cpu = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                                device="cpu").init()
        card_net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                                     device="cuda").init()
        card_net.set_params(cpu.params)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got = card_net.output(x).cpu()
        assert torch.backends.cuda.matmul.allow_tf32 is False, what
        assert torch.backends.cudnn.allow_tf32 is False, what
        ref = cpu.output(x)
        torch.testing.assert_close(got, ref, atol=1e-9 if what.startswith(
            "LM") else ATOL, rtol=RTOL)
        errs[what] = float((got - ref).abs().max())
    log(f"tf32_phase ({card}): both TF32 flags set True by the caller, "
        "off after the first layer; card vs CPU max |diff| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


def layers_phase(card):
    """Every layer of the Keras slice forward and backward on the card
    against the CPU at a small shape (f32, ATOL / RTOL): cuDNN's grouped
    and transposed convolutions over channels_last views."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    cnn, seq = InputType.convolutional(9, 10, 6), InputType.recurrent(6, 11)
    cases = [
        (L.Convolution1DLayer(n_out=8, kernel=3, stride=2, dilation=1,
                              convolution_mode="same"), seq),
        (L.Convolution1DLayer(n_out=8, kernel=2, dilation=2), seq),
        (L.Deconvolution2DLayer(n_out=5, kernel=3, stride=2, padding=1),
         cnn),
        (L.Deconvolution2DLayer(n_out=5, kernel=4, stride=2,
                                convolution_mode="same"), cnn),
        (L.DepthwiseConvolution2DLayer(kernel=3, depth_multiplier=2,
                                       convolution_mode="same"), cnn),
        (L.DepthwiseConvolution2DLayer(kernel=2, stride=2, dilation=1),
         cnn),
        (L.SeparableConvolution2DLayer(n_out=7, kernel=3, dilation=2,
                                       depth_multiplier=2), cnn),
        (L.ZeroPaddingLayer(pad=((1, 2), (0, 3))), cnn),
        (L.ZeroPadding1DLayer(pad=(2, 1)), seq),
        (L.UpsamplingLayer(size=(2, 3)), cnn),
        (L.CroppingLayer(crop=((1, 0), (2, 1))), cnn),
        (L.SpaceToDepthLayer(block_size=2), InputType.convolutional(8, 10, 6)),
        (L.SpaceToBatchLayer(block_size=2), InputType.convolutional(8, 10, 6)),
        (L.Subsampling1DLayer(pooling="max", kernel=3, stride=2,
                              convolution_mode="same"), seq),
        (L.Subsampling1DLayer(pooling="avg", kernel=2), seq),
        (L.LayerNormalization(), seq),
        (L.LocalResponseNormalization(), cnn),
    ]
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(4)
    errs = {}
    for i, (layer, it) in enumerate(cases):
        params, state = layer.initialize(g, it)
        x = rng.normal(0, 1, (3,) + it.array_shape()[1:]).astype("float32")
        results = []
        for device in ("cuda", "cpu"):
            p = {k: v.to(device).requires_grad_() for k, v in params.items()}
            xt = torch.tensor(x, device=device, requires_grad=True)
            y, _ = layer.apply(p, state, xt)
            ct = torch.from_numpy(np.random.default_rng(5).normal(
                0, 1, tuple(y.shape)).astype("float32")).to(device)
            grads = torch.autograd.grad(y, [xt] + list(p.values()), ct)
            results.append([t.detach().cpu() for t in (y,) + grads])
        worst = 0.0
        for got, want in zip(*results):
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            worst = max(worst, float((got - want).abs().max()))
        errs[f"{i}:{type(layer).__name__}"] = worst
    log(f"layers_phase ({card}): forward + input and param gradients on "
        f"the card vs the CPU, max |diff| (atol {ATOL:g}, rtol {RTOL:g}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    new_layers_check(card)


def new_layers_check(card):
    """The layers of the zoo and pretraining slice on the card against
    the CPU at a small shape: each one's forward (and the heads' losses,
    the pretraining losses with their draws fed alike) with the gradients
    of its input and of every param (a frozen layer's params have none)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    rng = np.random.default_rng(6)
    ff, seq = InputType.feed_forward(7), InputType.recurrent(7, 6)
    onehot = np.eye(4, dtype=np.float32)[[0, 2, 2, 1, 3]]
    yolo_t = np.zeros((5, 3, 3, 2 * 8), np.float32)
    yolo_t[:, 1, 2, 0:5] = (0.3, 0.6, 1.2, 0.8, 1.0)
    yolo_t[:, 1, 2, 6] = 1.0
    u = rng.random((5, 7)).astype(np.float32)
    eps = rng.standard_normal((2, 5, 3)).astype(np.float32)

    def fwd(lay, p, s, x):
        return lay.apply(p, s, x)[0]
    cases = [
        ("EmbeddingLayer", L.EmbeddingLayer(n_in=9, n_out=5,
                                            activation="tanh"),
         InputType.feed_forward(9),
         rng.integers(0, 9, (5, 1)).astype(np.float32), fwd),
        ("RBM", L.RBM(n_out=4), ff, None, fwd),
        ("RBM.free_energy", L.RBM(n_out=4), ff, None,
         lambda lay, p, s, x: lay._free_energy(p, x)),
        ("RBM.cd_loss", L.RBM(n_out=4), ff, None,
         lambda lay, p, s, x: lay._cd_loss(p, x, lay._gibbs(
             p, x, h=torch.as_tensor(u[:, :4] < 0.5, dtype=x.dtype,
                                     device=x.device)))),
        ("AutoEncoder", L.AutoEncoder(n_out=4, activation="tanh"), ff,
         None, fwd),
        ("AutoEncoder.recon_loss", L.AutoEncoder(n_out=4), ff, None,
         lambda lay, p, s, x: lay._recon_loss(
             p, x, torch.as_tensor(u < 0.7, device=x.device))),
        ("RecursiveAutoEncoder", L.RecursiveAutoEncoder(
            n_out=5, activation="tanh"), seq, None, fwd),
        ("RecursiveAutoEncoder.loss", L.RecursiveAutoEncoder(n_out=5),
         seq, None, lambda lay, p, s, x: lay.pretrain_loss(p, x)),
        ("CenterLossOutputLayer", L.CenterLossOutputLayer(n_out=4), ff,
         None, fwd),
        ("CenterLossOutputLayer.loss", L.CenterLossOutputLayer(n_out=4),
         ff, None, lambda lay, p, s, x: lay.loss_from_input(
             p, x, torch.as_tensor(onehot, device=x.device))
         + lay.center_loss({"centers": torch.ones(
             4, 7, device=x.device)}, x,
             torch.as_tensor(onehot, device=x.device))),
        ("FrozenLayer", L.FrozenLayer(inner=L.DenseLayer(
            n_out=3, activation="tanh")), ff, None, fwd),
        ("VariationalAutoencoder", L.VariationalAutoencoder(
            n_out=3, encoder_layer_sizes=(6,), decoder_layer_sizes=(5,)),
         ff, None, fwd),
        ("VariationalAutoencoder.elbo", L.VariationalAutoencoder(
            n_out=3, encoder_layer_sizes=(6,), decoder_layer_sizes=(5,),
            reconstruction_distribution="gaussian", num_samples=2), ff,
         None, lambda lay, p, s, x: lay._elbo(
             p, x, torch.as_tensor(eps, device=x.device))),
        ("Yolo2OutputLayer", L.Yolo2OutputLayer(
            anchors=((1.0, 1.5), (2.0, 1.0))),
         InputType.convolutional(3, 3, 16), None, fwd),
        ("Yolo2OutputLayer.loss", L.Yolo2OutputLayer(
            anchors=((1.0, 1.5), (2.0, 1.0))),
         InputType.convolutional(3, 3, 16), None,
         lambda lay, p, s, x: lay.loss_from_input(
             p, x, torch.as_tensor(yolo_t, device=x.device))),
    ]
    g = torch.Generator().manual_seed(1)
    errs = {}
    for label, layer, it, x, fn in cases:
        layer.set_n_in(it)
        params, state = layer.initialize(g, it)
        if x is None:
            x = rng.normal(0, 1, (5,) + it.array_shape()[1:]).astype(
                "float32")
        results = []
        for device in (CARD, "cpu"):
            p = updaters.tree_map(
                lambda t: t.to(device, copy=True).requires_grad_(), params)
            st = {k: v.to(device) for k, v in state.items()}
            xt = torch.tensor(x, device=device,
                              requires_grad=label != "EmbeddingLayer")
            y = fn(layer, p, st, xt)
            ct = torch.from_numpy(np.random.default_rng(5).normal(
                0, 1, tuple(y.shape)).astype("float32")).to(device)
            leaves = list(updaters.tree_leaves(p)) + (
                [xt] if xt.requires_grad else [])
            grads = torch.autograd.grad(y, leaves, ct, allow_unused=True)
            results.append([y.detach().cpu()] + [
                torch.zeros(()) if gr is None else gr.cpu() for gr in grads])
        worst = 0.0
        for got, want in zip(*results):
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            worst = max(worst, float((got - want).abs().max()))
        errs[label] = worst
    log(f"new layers ({card}): forward / loss + input and param gradients "
        f"on the card vs the CPU, max |diff| (atol {ATOL:g}, rtol "
        f"{RTOL:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


# --------------------------------------------------------------------
# zoo_phase: the rest of the model zoo at its published input shapes,
# a served GoogLeNet and a fine-tuned Darknet19; pretrain_phase: layerwise
# pretraining of the models the pretraining layers were built for (cuDNN,
# cuBLAS and plain ops: no kernel of the port's own on either path)
# --------------------------------------------------------------------

CARD = "cuda"              # the device of the two phases
ZOO_STEPS = 5              # fit steps a model: one untimed, four timed
ZOO_CHECK_B = 2            # rows of the card-vs-CPU check
# the card-vs-CPU floor, relative to a leaf's L2 norm: at B=2 a batch
# norm's beta and gamma gradients sum dL/dy over few values with
# cancellation, and cuDNN's f32 algorithms (FFT and Winograd among them:
# the profile shows pointwise_mult_and_sum_complex and flip_filter) round
# apart from oneDNN's direct convolutions. On an H100 (700 W) these leaves
# differ by up to 2.2e-4 (Darknet19's last batch norm), 1.2e-3
# (FaceNetNN4Small2's stem) and 6.0e-4 (TinyYOLO) where the CPU's own
# reruns differ far less; a wrong computation differs by O(1)
ZOO_FLOOR_RTOL = 1e-2
# UNet's loss is summed over its 128x128 mask pixels an image: at the
# zoo's nesterovs(1e-2, 0.9) both packages reach NaN at the second step,
# on the CPU as on the card; at 1e-4 the loss still climbs; at 1e-5 it
# falls
UNET_LR = 1e-5
ZOO_SERVE_REQUESTS, ZOO_SERVE_ROWS = 4, 2
TL_STEPS = 3
# (class, constructor kwargs, B, head) at each model's published input
ZOO_MODELS = [
    ("AlexNet", {"n_classes": 1000}, 64, "mcxent, LRN"),
    ("GoogLeNet", {"n_classes": 1000}, 32, "mcxent"),
    ("Darknet19", {"n_classes": 1000}, 32, "mcxent"),
    ("InceptionResNetV1", {"n_classes": 1000}, 32, "center loss, mcxent"),
    ("FaceNetNN4Small2", {"n_classes": 1000}, 64,
     "center loss, squared loss"),
    ("TinyYOLO", {"n_classes": 20}, 16, "5 VOC anchors, Yolo2 loss"),
    ("UNet", {"n_classes": 1}, 16, "binary mask, sigmoid + xent"),
]


def zoo_labels(zm, out_shape, B, rng):
    """Seeded labels for zoo model ``zm`` whose output rows have
    ``out_shape``: one-hot classes, YOLO grid targets (one object an
    image, VOC anchors) or a binary mask."""
    import numpy as np
    if zm.name == "tinyyolo":
        depth = 5 + zm.n_classes
        t = np.zeros((B,) + tuple(out_shape), np.float32)
        for i in range(B):
            gx, gy = rng.integers(0, out_shape[0], 2)
            base = rng.integers(0, len(zm.anchors)) * depth
            t[i, gy, gx, base:base + 2] = rng.random(2)
            t[i, gy, gx, base + 2:base + 4] = 0.5 + 4 * rng.random(2)
            t[i, gy, gx, base + 4] = 1.0
            t[i, gy, gx, base + 5 + rng.integers(0, zm.n_classes)] = 1.0
        return t
    if zm.name == "unet":
        return (rng.random((B,) + tuple(out_shape)) > 0.5).astype(np.float32)
    return np.eye(zm.n_classes, dtype=np.float32)[
        rng.integers(0, zm.n_classes, B)]


def out_shape_of(conf):
    """A zoo config's output row shape, from its types."""
    if hasattr(conf, "output_type"):
        t = conf.output_type()
    else:
        t = conf.activation_types[conf.network_outputs[0]]
    return t.array_shape()[1:]


class fixed_dropout:
    """Within the scope every dropout mask is drawn from numpy, seeded by
    the call's order, on the CPU and moved to the caller's device: a run
    on the card and a run on the CPU drop the same units (a run on rows
    rolled by ``roll`` gets the masks rolled alike)."""

    def __init__(self, roll=0):
        self.roll = roll

    def __enter__(self):
        import numpy as np
        import torch
        from deeplearning4j_tpu_torch.nn.conf.layers import base
        self._base, self._orig, self.calls = base, base.dropout_keep_mask, 0

        def mask(shape, keep, generator, device):
            self.calls += 1
            u = np.random.default_rng(self.calls).random(tuple(shape))
            m = torch.from_numpy(np.roll(u < keep, self.roll, axis=0))
            if torch.device(device).type == "cuda":
                # from pinned memory: a copy a graph capture can record
                # (fit captures its step after the eager run)
                return m.pin_memory().to(device, non_blocking=True)
            return m.to(device)
        base.dropout_keep_mask = mask
        return self

    def __exit__(self, *exc):
        self._base.dropout_keep_mask = self._orig


def zoo_step_leaves(zm, cpu_net, device, x, y, roll=0, onednn=True):
    """Forward, gradients and one fit step of ``zm`` from ``cpu_net``'s
    params and state on ``device``: flat leaves (out, loss, grad/...,
    state/..., param/...) as numpy. The dropout masks are fixed."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    from deeplearning4j_tpu_torch.util.tree import tree_to_device
    xx, yy = np.roll(x, roll, axis=0), np.roll(y, roll, axis=0)
    net = type(cpu_net)(zm.conf(), device=device)
    net.set_params(cpu_net.params)
    net.state = tree_to_device(cpu_net.state, net.device)
    net._build_optimizer()
    graph = isinstance(net, ComputationGraph)
    with fixed_dropout(roll), torch.backends.mkldnn.flags(enabled=onednn):
        out = net.output(xx)
        ds = DataSet(xx, yy)
        batch = net._batch_tuple(net._as_multi(ds) if graph else ds)
        loss, grads, _ = net._gradients(batch)
        net.fit(ds)
    out = np.roll(out.float().cpu().numpy(), -roll, axis=0)
    return {"out": out, "loss": np.array([loss.item()]),
            **{"grad/" + k: v for k, v in _flatten(grads).items()},
            **{"state/" + k: v for k, v in _flatten(net.state).items()},
            **{"param/" + k: v for k, v in _flatten(net.params).items()}}


def zoo_card_vs_cpu(zm, label):
    """The model's forward, gradients and one step at ZOO_CHECK_B rows
    on the card against the CPU, leaf by leaf (``_leaf_errors``,
    F32_FACTOR of the CPU's own reruns: rows in another order, oneDNN
    off). Returns the worst ratio (<= 1 passes)."""
    import numpy as np
    import torch
    cpu_net = zm.init(device="cpu")
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (ZOO_CHECK_B,) + tuple(zm.input_shape)).astype(
        "float32")
    y = zoo_labels(zm, out_shape_of(cpu_net.conf), ZOO_CHECK_B, rng)
    t0 = time.perf_counter()
    cpu = zoo_step_leaves(zm, cpu_net, "cpu", x, y)
    reruns = [zoo_step_leaves(zm, cpu_net, "cpu", x, y, roll, onednn)
              for roll, onednn in ((1, False), (0, False))]
    cpu_s = time.perf_counter() - t0
    card = zoo_step_leaves(zm, cpu_net, CARD, x, y)
    torch.cuda.synchronize()
    rows = _leaf_errors(card, cpu, reruns, F32_FACTOR, ZOO_FLOOR_RTOL)
    rel = sorted(((float(np.linalg.norm(card[k] - a)
                         / (np.linalg.norm(a) + 1e-30)), k)
                  for k, a in cpu.items()), reverse=True)
    log(f"{label} card vs CPU (B={ZOO_CHECK_B}, forward, gradients and one "
        f"step, dropout masks fixed; three CPU runs {cpu_s:.1f} s): loss "
        f"{card['loss'][0]:.6f} vs {cpu['loss'][0]:.6f}; {len(cpu)} leaves; "
        f"L2 |card - cpu| / ({F32_FACTOR:g} x the CPU's largest rerun "
        f"difference + {ZOO_FLOOR_RTOL:g} x |cpu|), worst three: "
        + "; ".join(f"{k} {r:.3f} ({e:.3e} of {lim:.3e})"
                    for r, k, e, lim in rows[:3]) + " (limit 1); largest "
        "relative L2 differences: " + "; ".join(
            f"{k} {r:.3e}" for r, k in rel[:3]))
    assert rows[0][0] <= 1.0, (label, rows[:3])
    if "state/out/centers" in cpu:
        assert np.abs(card["state/out/centers"]).max() > 0
    return rows[0][0]


def zoo_leg(zm, B, head, card):
    """ZOO_STEPS fit steps of ``zm`` on the card at B rows of its input
    shape (one untimed), a profiled step, a warm ``output`` at the same
    B, peak memory. Returns (its numbers, the trained net)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net = zm.init(device=CARD)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B,) + tuple(zm.input_shape)).astype("float32")
    y = zoo_labels(zm, out_shape_of(net.conf), B, rng)
    ds = DataSet(torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD))
    t0 = time.perf_counter()
    net.fit(ds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses, step_ms = [float(net.score_value)], []
    for _ in range(ZOO_STEPS - 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit(ds)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(net.score_value))
    assert all(math.isfinite(v) for v in losses), (zm.name, losses)
    med = sorted(step_ms)[len(step_ms) // 2]
    flops = (conv_dense_flops(net.conf) if hasattr(net.conf, "vertices")
             else sequential_flops(net))
    bound = 3 * flops * B / PEAK_F32_FLOPS * 1e3
    out_ms = median_ms(lambda: net.output(ds.features), 5)
    out = net.output(ds.features)
    assert torch.isfinite(out).all() and tuple(out.shape[1:]) == \
        tuple(out_shape_of(net.conf))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    label = type(zm).__name__
    log(f"{label} training (B={B}, {'x'.join(map(str, zm.input_shape))}, "
        f"{zm.n_classes} classes, {head}, nesterovs({zm.updater['lr']:g}, "
        f"{zm.updater['momentum']:g}), "
        f"{net.num_params()} params, {card}): init {init_s:.2f} s, first "
        f"step {first_s:.3f} s; warm steps " + ", ".join(
            f"{v:.3f}" for v in step_ms) + f" ms, median {med:.3f} ms = "
        f"{B / med * 1e3:.1f} images/s; losses " + ", ".join(
            f"{v:.6f}" for v in losses) + f"; bound {bound:.3f} ms "
        f"({3 * flops * B / 1e12:.4f} TFLOP at "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s): {100 * bound / med:.1f}% of "
        f"it; warm output at B={B} {out_ms:.3f} ms; peak device memory "
        f"{peak_gib:.2f} GiB")
    fams, busy, wall = profile_cnn_step(net, ds, label)
    return {"B": B, "median_ms": med, "images_s": B / med * 1e3,
            "bound_ms": bound, "bound_share": bound / med,
            "output_ms": out_ms, "peak_gib": peak_gib, "busy_ms": busy,
            "wall_ms": wall, "idle": max(0.0, 1 - busy / wall),
            "losses": losses, "families": fams}, net


def zoo_serve(net, zm, card):
    """Write the trained GoogLeNet, restore it on the card and serve
    ZOO_SERVE_REQUESTS /v1/predict requests of ZOO_SERVE_ROWS rows: each
    reply equals ``output`` of the restored net on the same rows."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "googlenet.zip")
        write_model(net, path)
        restored = restore_model(path, device=CARD)
    reg = ModelRegistry()
    reg.register("googlenet", restored)
    server = ModelServer(reg, wait_ms=5.0).start()
    rng = np.random.default_rng(3)
    diffs, req_s = [], []
    try:
        for _ in range(ZOO_SERVE_REQUESTS):
            x = rng.normal(0, 1, (ZOO_SERVE_ROWS,) + tuple(
                zm.input_shape)).astype("float32")
            t0 = time.perf_counter()
            code, body, _ = http(server.port, "/v1/predict",
                                 {"model": "googlenet", "inputs": x.tolist()})
            req_s.append(time.perf_counter() - t0)
            assert code == 200, body
            out = np.asarray(body["outputs"], np.float32)
            assert out.shape == (ZOO_SERVE_ROWS, zm.n_classes)
            ref = restored.output(x).cpu().numpy()
            diffs.append(float(np.abs(out - ref).max()))
    finally:
        server.stop(drain=True)
    assert max(diffs) <= 1e-6, diffs
    log(f"GoogLeNet served from a zip ({card}): {ZOO_SERVE_REQUESTS} "
        f"/v1/predict requests of {ZOO_SERVE_ROWS} rows, "
        + ", ".join(f"{s:.2f}" for s in req_s) + " s; max |served - output| "
        f"{max(diffs):.2e}")


def zoo_fine_tune(net, zm, card):
    """Darknet19 frozen up to its last conv block (the last batch norm),
    its 1000-class head replaced by a 10-class one (1x1 conv, global
    pool, output), TL_STEPS Adam steps: the frozen leaves bit-equal
    before and after, every head leaf moved. (The trunk's batch-norm
    statistics have seen five batches, so its frozen features are far
    from normalized and the new head's first loss is large: Adam bounds
    each step.)"""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.transfer_learning import (
        FineTuneConfiguration, TransferLearning)
    n = len(net.layers)
    assert type(net.layers[n - 4]).__name__ == "BatchNormalization"
    tl = (TransferLearning.builder(net)
          .fine_tune_configuration(FineTuneConfiguration(
              updater=updaters.adam(1e-3)))
          .set_feature_extractor(n - 4)
          .remove_layers_from_output(3)
          .add_layer(L.ConvolutionLayer(n_out=10, kernel=(1, 1),
                                        convolution_mode="same"))
          .add_layer(L.GlobalPoolingLayer(pooling="avg"))
          .add_layer(L.OutputLayer(n_out=10, loss="mcxent")).build())
    frozen = [i for i, lay in enumerate(tl.layers)
              if type(lay).__name__ == "FrozenLayer"]
    assert frozen == list(range(n - 3)), frozen
    before = [{k: v.detach().clone() for k, v in p.items()}
              for p in tl.params]
    state0 = [{k: v.clone() for k, v in s.items()} for s in tl.state]
    rng = np.random.default_rng(5)
    B = 16
    x = rng.normal(0, 1, (B,) + tuple(zm.input_shape)).astype("float32")
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
    ds = DataSet(torch.from_numpy(x).to(CARD), torch.from_numpy(y).to(CARD))
    losses, step_ms = [], []
    for _ in range(TL_STEPS):
        t0 = time.perf_counter()
        tl.fit(ds)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(tl.score_value))
    assert all(math.isfinite(v) for v in losses), losses
    after = tl.params
    n_frozen = 0
    for i in frozen:
        for k, v in before[i].items():
            assert torch.equal(after[i][k], v), (i, k)
            n_frozen += 1
        for k, v in state0[i].items():
            assert torch.equal(tl.state[i][k], v), (i, k)
    head = [(i, k) for i in range(n - 3, len(tl.layers))
            for k in before[i]]
    assert head and all(not torch.equal(after[i][k], before[i][k])
                        for i, k in head), head
    log(f"Darknet19 fine-tuned ({card}): layers 0-{n - 4} frozen "
        f"({n_frozen} leaves and their batch-norm state bit-equal after "
        f"{TL_STEPS} steps), 10-class head ({len(head)} leaves, every one "
        f"moved); B={B}, steps " + ", ".join(f"{v:.1f}" for v in step_ms)
        + " ms (host clock); losses " + ", ".join(f"{v:.6f}" for v in losses))


def zoo_phase(card):
    """The seven zoo models this slice brings at their published input
    shapes on the card (ZOO_MODELS): ZOO_STEPS nesterovs steps, step ms,
    images/s, share of the bound, device ms by family, idle share, peak
    memory, a warm ``output``, and the card held against the CPU; then
    GoogLeNet served from a zip and Darknet19 fine-tuned with its trunk
    frozen."""
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn.conf import updaters
    results = {}
    t_all = time.perf_counter()
    for cls_name, kw, B, head in ZOO_MODELS:
        t0 = time.perf_counter()
        if cls_name == "UNet":
            kw = {**kw, "updater": updaters.nesterovs(UNET_LR, 0.9)}
        zm = getattr(zoo, cls_name)(**kw)
        zoo_card_vs_cpu(zm, cls_name)
        results[cls_name], net = zoo_leg(zm, B, head, card)
        if cls_name == "GoogLeNet":
            zoo_serve(net, zm, card)
        elif cls_name == "Darknet19":
            zoo_fine_tune(net, zm, card)
        del net
        torch.cuda.empty_cache()
        log(f"{cls_name}: {time.perf_counter() - t0:.1f} s in all")
    log(f"zoo_phase {time.perf_counter() - t_all:.1f} s; summary: "
        + json.dumps({k: {m: v for m, v in r.items() if m != "families"}
                      for k, r in results.items()}))
    return results


# the published widths: Hinton & Salakhutdinov (Science 2006), MNIST's
# deep autoencoder 784-1000-500-250-30; Kingma & Welling (2014), the
# MNIST VAE 784 -> 500 -> 20
PRE_WIDTHS = (1000, 500, 250, 30)
PRE_B, PRE_BATCHES = 128, 50
PRE_PROTOS, PRE_FLIP = 10, 0.05


def binary_surrogate(n, seed=0):
    """A seeded binary 784-d set in MNIST's shape: each row one of
    PRE_PROTOS random binary prototypes with PRE_FLIP of its bits
    flipped (no dataset is fetched)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    protos = (rng.random((PRE_PROTOS, 784)) > 0.5).astype(np.float32)
    flips = rng.random((n, 784)) < PRE_FLIP
    return np.abs(protos[rng.integers(0, PRE_PROTOS, n)] - flips).astype(
        np.float32)


def pretrain_metric(layer, params, x):
    """A layer's pretraining loss (the RBM's reconstruction error) on
    ``x`` with draws from a generator seeded alike every call."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.layers import RBM
    with torch.no_grad():
        g = torch.Generator(device=x.device).manual_seed(7)
        if isinstance(layer, RBM):
            return float(layer.reconstruction_error(params, x, g))
        return float(layer.pretrain_loss(params, x, g))


def pretrain_leg(label, net, ds, check_rows):
    """``net.pretrain`` over ``ds`` (batches of PRE_B, one epoch) on the
    card, timed; each pretrained layer's metric on its input (through
    the pretrained layers below it) with its initial and its pretrained
    params, which must fall. Returns its numbers."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    graph = isinstance(net, ComputationGraph)
    p0 = updaters.tree_map(lambda p: p.detach().clone(), net.params)
    n_batches = -(-ds.features.shape[0] // PRE_B)
    idx = ([n for n in net.conf.topological_order()
            if hasattr(net.conf.vertices[n][0], "pretrain_loss")] if graph
           else [i for i, lay in enumerate(net.layers)
                 if hasattr(lay, "pretrain_loss")])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    if graph:
        net.pretrain(ds.batch_by(PRE_B))
    else:
        net.pretrain(ds, batch_size=PRE_B)
    e1.record()
    torch.cuda.synchronize()
    total_ms = e0.elapsed_time(e1)
    steps = n_batches * len(idx)
    sub = type(ds)(ds.features[:check_rows])
    rows = []
    for k in idx:
        obj = net.conf.vertices[k][0] if graph else net.layers[k]
        x_in = net._pretrain_input(sub, k)
        before = pretrain_metric(obj, p0[k], x_in)
        after = pretrain_metric(obj, net.params[k], x_in)
        rows.append((k, type(obj).__name__, before, after))
        assert math.isfinite(after) and after < before, (label, rows[-1])
    log(f"{label} pretrained ({steps} steps, B={PRE_B}): "
        f"{total_ms:.1f} ms = {total_ms / steps:.3f} ms a step (CUDA events "
        f"over pretrain); per layer, loss before -> after on its input: "
        + "; ".join(f"{k} {n} {b:.5f} -> {a:.5f}" for k, n, b, a in rows))
    return {"steps": steps, "ms_per_step": total_ms / steps,
            "layers": [list(r) for r in rows]}


def pretrain_card_vs_cpu(card):
    """One pretrain step of each pretraining layer at its published width
    (16 rows) on the card against the CPU, with the same uniforms and
    normals fed to both (core.uniform_draws, special.normal_draws)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        pretrain_step)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import core, special
    rows = 16
    cases = [
        (L.RBM(n_out=1000), InputType.feed_forward(784),
         binary_surrogate(rows, seed=3)),
        (L.AutoEncoder(n_out=1000, activation="sigmoid",
                       corruption_level=0.3), InputType.feed_forward(784),
         binary_surrogate(rows, seed=3)),
        (L.VariationalAutoencoder(n_out=20, encoder_layer_sizes=(500,),
                                  decoder_layer_sizes=(500,)),
         InputType.feed_forward(784), binary_surrogate(rows, seed=3)),
        (L.RecursiveAutoEncoder(n_out=256, activation="tanh"),
         InputType.recurrent(77, 40),
         np.eye(77, dtype=np.float32)[np.random.default_rng(3).integers(
             0, 77, (rows, 40))]),
    ]
    orig = core.uniform_draws, special.normal_draws

    def uniform(shape, generator, device):
        u = np.random.default_rng(len(shape) + shape[-1]).random(
            tuple(shape)).astype(np.float32)
        return torch.from_numpy(u).to(device)

    def normal(shape, generator, device):
        e = np.random.default_rng(shape[-1]).standard_normal(
            tuple(shape)).astype(np.float32)
        return torch.from_numpy(e).to(device)
    core.uniform_draws, special.normal_draws = uniform, normal
    errs = {}
    try:
        g = torch.Generator().manual_seed(0)
        for layer, it, x in cases:
            params, _ = layer.initialize(g, it)
            out = []
            for device in (CARD, "cpu"):
                p = updaters.tree_map(
                    lambda t: t.to(device, copy=True).requires_grad_(),
                    params)
                opt = updaters.to_transform(updaters.sgd(0.1))
                loss, _ = pretrain_step(layer, p, opt, opt.init(p),
                                        torch.from_numpy(x).to(device),
                                        None)
                out.append([loss.cpu()] + [t.detach().cpu() for t in
                                           updaters.tree_leaves(p)])
            worst = 0.0
            for got, want in zip(*out):
                torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
                worst = max(worst, float((got - want).abs().max()))
            errs[type(layer).__name__] = worst
    finally:
        core.uniform_draws, special.normal_draws = orig
    log(f"pretrain step on the card vs the CPU ({rows} rows, published "
        f"widths, the same draws fed to both; loss and params, atol "
        f"{ATOL:g}, rtol {RTOL:g}), max |diff|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))


def pool_stream_check(card):
    """GravesLSTM(256) then GlobalPoolingLayer (avg, max, pnorm) at the
    char-RNN's width (vocab 80) on the card: ``rnn_time_step`` step by
    step equals ``output`` over each prefix."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (GlobalPoolingLayer,
                                                         GravesLSTM,
                                                         OutputLayer)
    B, T_ = 4, 32
    x = np.eye(CHAR_V, dtype=np.float32)[
        np.random.default_rng(8).integers(0, CHAR_V, (B, T_))]
    errs = {}
    for pooling in ("avg", "max", "pnorm"):
        conf = (NeuralNetConfiguration.builder().set_seed(0).list()
                .layer(GravesLSTM(n_out=CHAR_H, activation="tanh"))
                .layer(GlobalPoolingLayer(pooling=pooling))
                .layer(OutputLayer(n_out=CHAR_V))
                .set_input_type(InputType.recurrent(CHAR_V, T_)).build())
        net = MultiLayerNetwork(conf, device=CARD).init()
        worst = 0.0
        for t in range(T_):
            got = net.rnn_time_step(x[:, t])
            want = net.output(x[:, :t + 1])
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            worst = max(worst, float((got - want).abs().max()))
        errs[pooling] = worst
    log(f"pooled stream on the card ({card}): GravesLSTM({CHAR_H}) + "
        f"GlobalPoolingLayer, B={B}, {T_} steps of rnn_time_step vs output "
        "over each prefix, max |diff|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))


def pretrain_phase(card):
    """Layerwise pretraining on the card at the published widths, on
    seeded binary 784-d surrogates: an RBM deep autoencoder stack, the
    same widths as denoising AutoEncoders (corruption 0.3), a VAE, a
    RecursiveAutoEncoder at TextGenerationLSTM's input (T=40, 77 symbols),
    and one AutoEncoder vertex inside a ComputationGraph; each layer's
    loss must fall. Then one step of each layer card vs CPU with the
    draws injected, and the pooled stream check."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    t_all = time.perf_counter()
    x = binary_surrogate(PRE_B * PRE_BATCHES)
    ds = DataSet(x)

    def stack(first_layers, updater, it=InputType.feed_forward(784)):
        b = NeuralNetConfiguration.builder().set_seed(0).updater(
            updater).list()
        for lay in first_layers:
            b = b.layer(lay)
        conf = b.layer(L.OutputLayer(n_out=10)).set_input_type(it).build()
        return MultiLayerNetwork(conf, device=CARD).init()
    results = {
        "rbm_stack": pretrain_leg(
            "RBM deep autoencoder 784-1000-500-250-30 (CD-1, sgd 0.1)",
            stack([L.RBM(n_out=w) for w in PRE_WIDTHS], updaters.sgd(0.1)),
            ds, 512),
        "ae_stack": pretrain_leg(
            "denoising AutoEncoder stack 784-1000-500-250-30 (corruption "
            "0.3, adam 1e-3)",
            stack([L.AutoEncoder(n_out=w, activation="sigmoid",
                                 corruption_level=0.3)
                   for w in PRE_WIDTHS], updaters.adam(1e-3)), ds, 512),
        "vae": pretrain_leg(
            "VAE 784 -> 500 -> 20, Bernoulli (adam 1e-3)",
            stack([L.VariationalAutoencoder(
                n_out=20, encoder_layer_sizes=(500,),
                decoder_layer_sizes=(500,),
                reconstruction_distribution="bernoulli")],
                updaters.adam(1e-3)), ds, 512),
    }
    seq = np.eye(77, dtype=np.float32)[np.random.default_rng(2).integers(
        0, 77, (PRE_B * 10, 40))]
    results["rae"] = pretrain_leg(
        "RecursiveAutoEncoder(256) on T=40 x 77 symbols (adam 1e-3)",
        stack([L.RecursiveAutoEncoder(n_out=256, activation="tanh")],
              updaters.adam(1e-3), InputType.recurrent(77, 40)),
        DataSet(seq), 256)
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updaters.adam(1e-3)).graph_builder()
            .add_inputs("in").set_input_types(InputType.feed_forward(784))
            .add_layer("dense", L.DenseLayer(n_out=500, activation="sigmoid"),
                       "in")
            .add_layer("ae", L.AutoEncoder(n_out=250, activation="sigmoid",
                                           corruption_level=0.3), "dense")
            .add_layer("out", L.OutputLayer(n_out=10), "ae")
            .set_outputs("out").build())
    results["graph_ae"] = pretrain_leg(
        "ComputationGraph AutoEncoder vertex 500 -> 250 (adam 1e-3)",
        ComputationGraph(conf, device=CARD).init(), ds, 512)
    pretrain_card_vs_cpu(card)
    pool_stream_check(card)
    log(f"pretrain_phase {time.perf_counter() - t_all:.1f} s; summary: "
        + json.dumps(results))
    return results


ETL_CLASSES, ETL_PER_CLASS, ETL_HW = 10, 52, 224    # bench.py:790-817
ETL_B, ETL_THREADS, ETL_QUEUE = 128, 4, 4           # bench.py:843-851
ETL_EPOCHS = 2                                      # bench.py:930-940
ETL_STEPS = 5              # timed warm steps on a device-resident batch


def etl_probe():
    """What the host offers the native loader: libpng's and zlib's
    headers and libraries, PIL, and the cores."""
    import importlib.util
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True,
                          text=True).stdout
    probe = {
        "png.h": os.path.exists("/usr/include/png.h"),
        "zlib.h": os.path.exists("/usr/include/zlib.h"),
        "libpng": sorted({m for m in re.findall(r"libpng\S*\.so\S*", libs)}),
        "libz": sorted({m for m in re.findall(r"libz\.so\S*", libs)}),
        "PIL": importlib.util.find_spec("PIL") is not None,
        "cores": os.cpu_count()}
    log("native loader probe: " + json.dumps(probe))
    return probe


def etl_phase(card):
    """``bench.py``'s ``resnet_native_etl`` leg (``bench.py:820-977``) on
    the port: ResNet50 (10 classes, f32, nesterovs(0.1, 0.9), B=128)
    trained from a directory-per-label PNG tree (10 classes x 52 noise
    images, 224x224, from ``default_rng(0)``, ~78 MB, written by the
    port's standard-library PNG writer under the gitignored ``build/``)
    through ``NativeImageDataSetIterator`` (the port's own PNG decoder
    over zlib, 4 threads, a queue of 4). Prints the probe and the decode
    route, decode ms a batch at 1, 2 and 4 threads, the exposed wait
    under a simulated step of 1x and 2x the decode, the upload of one
    batch pageable (as ``fit`` does it) and from a pinned buffer, the
    warm step (CUDA-event median), e2e ms a batch over 2 epochs and
    images/s, the exposed ETL (e2e - step), then a ``fit`` over
    ``AsyncDataSetIterator`` with a ``PerformanceListener`` (images/s,
    the data-wait share from ``_step_timing``), host cores and peak
    memory. Asserts the first batch on the card equals the host array
    bit for bit and the first step's loss is finite."""
    import resource
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.data import native_loader as nl
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, TrainingListener)

    t_all = time.perf_counter()
    probe = etl_probe()
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = nl.ensure_png_tree(
        os.path.join(repo, "build", f"png_tree_{ETL_HW}"),
        ETL_CLASSES, ETL_PER_CLASS, ETL_HW)
    tree_mb = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png")) / 1e6
    log(f"PNG tree {root}: {ETL_CLASSES} x {ETL_PER_CLASS} images "
        f"{ETL_HW}x{ETL_HW}, {tree_mb:.1f} MB, written in "
        f"{time.perf_counter() - t0:.1f} s by the standard-library writer")
    t0 = time.perf_counter()
    nl.native_image_available()
    log(f"decode route: the port's own PNG decoder over zlib ("
        f"{os.path.relpath(nl.SOURCE, repo)}, g++ -lz, "
        f"built in "
        f"{time.perf_counter() - t0:.1f} s into build/native/); libpng "
        f"headers {'present' if probe['png.h'] else 'absent'}, not used")

    def make_it(nt=ETL_THREADS):
        return nl.NativeImageDataSetIterator(
            root, ETL_B, ETL_HW, ETL_HW, 3, n_threads=nt,
            queue_capacity=ETL_QUEUE)

    def decode_pass(nt, consume_sleep_s=0.0):
        """Steady-state ms a full batch (the first dropped: pool spin-up
        and the directory scan), the best of 2 passes; with
        ``consume_sleep_s`` the consumer sleeps that long a batch (a
        step that holds no GIL), so the time is the wait it sees."""
        best = float("inf")
        for _ in range(2):
            gaps, last = [], time.perf_counter()
            for ds in make_it(nt):
                if ds.num_examples() == ETL_B:
                    now = time.perf_counter()
                    gaps.append(now - last)
                    if consume_sleep_s:
                        time.sleep(consume_sleep_s)
                    last = time.perf_counter()
            gaps = gaps[1:] if len(gaps) > 1 else gaps
            best = min(best, sum(gaps) / max(1, len(gaps)) * 1e3)
        return best

    scaling = {nt: decode_pass(nt) for nt in (1, 2, ETL_THREADS)}
    decode_ms = scaling[ETL_THREADS]
    exposed_sim = decode_pass(ETL_THREADS, decode_ms / 1e3)
    exposed_slack = decode_pass(ETL_THREADS, 2 * decode_ms / 1e3)
    log(f"decode ms a batch of {ETL_B} by threads: " + ", ".join(
        f"{nt}: {ms:.3f}" for nt, ms in scaling.items())
        + f"; exposed wait under a simulated step of 1x the decode "
        f"{exposed_sim:.3f} ms, of 2x {exposed_slack:.3f} ms")

    torch.cuda.reset_peak_memory_stats()
    net = zoo.ResNet50(n_classes=ETL_CLASSES,
                       updater=updaters.nesterovs(0.1, 0.9)).init(
                           device=CARD)
    first = next(iter(make_it()))
    assert first.features.shape == (ETL_B, ETL_HW, ETL_HW, 3)
    # the batch as fit moves it (ComputationGraph._batch_tuple)
    on_card = net._batch_tuple(net._as_multi(first))[0][0]
    assert on_card.device.type == torch.device(CARD).type
    assert on_card.dtype == torch.float32
    assert torch.equal(on_card.cpu(), torch.from_numpy(first.features))
    net.fit(first)
    losses = [float(net.score_value)]
    assert math.isfinite(losses[0]), losses

    feats = first.features
    up, pinned_up = float("inf"), float("inf")
    pinned = torch.empty(feats.shape, dtype=torch.float32, pin_memory=True)
    for i in range(3):
        fresh = feats + np.float32(i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net._tensors([fresh])                    # as _batch_tuple does
        torch.cuda.synchronize()
        up = min(up, time.perf_counter() - t0)
        pinned.copy_(torch.from_numpy(fresh))
        t0 = time.perf_counter()
        pinned.to(CARD, non_blocking=True)
        torch.cuda.synchronize()
        pinned_up = min(pinned_up, time.perf_counter() - t0)
    upload_ms, pinned_ms = up * 1e3, pinned_up * 1e3
    del pinned
    batch_mb = feats.nbytes / 2 ** 20
    log(f"upload of one batch ({feats.nbytes} B = {batch_mb:.1f} MiB): "
        f"pageable {upload_ms:.3f} ms ({feats.nbytes / up / 1e9:.2f} GB/s)"
        f", pinned {pinned_ms:.3f} ms ({feats.nbytes / pinned_up / 1e9:.2f}"
        " GB/s)")

    resident = DataSet(torch.from_numpy(feats).to(CARD),
                       torch.from_numpy(first.labels).to(CARD))
    step_ms = []
    for _ in range(ETL_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        net.fit(resident)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(float(net.score_value))
    del resident
    step = sorted(step_ms)[len(step_ms) // 2]

    # events on the training stream around the captured step's input
    # copy (host batch -> pinned staging -> the graph's static inputs)
    # and after each step (no sync): the card's timeline of one batch is
    # the idle gap before the upload (the host had not issued it yet),
    # the upload, the step (a replay)
    from deeplearning4j_tpu_torch.models import kstep
    marks, ends, host_next, host_fit = [], [], [], []
    real = kstep.TrainProgram._fill

    def marked(prog, window):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        real(prog, window)
        e1.record()
        marks.append((e0, e1))
    kstep.TrainProgram._fill = marked
    n_img, it = 0, make_it()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ETL_EPOCHS):
        batches = iter(it)
        while True:
            t1 = time.perf_counter()
            ds = next(batches, None)
            if ds is None:
                break
            if ds.num_examples() != ETL_B:
                continue
            t2 = time.perf_counter()
            host_next.append(t2 - t1)
            net.fit(ds)
            host_fit.append(time.perf_counter() - t2)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            n_img += ETL_B
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    kstep.TrainProgram._fill = real
    assert len(marks) == len(ends), (len(marks), len(ends))
    losses.append(float(net.score_value))
    e2e_ms = e2e_s / (n_img / ETL_B) * 1e3
    gap = [ends[i - 1].elapsed_time(marks[i][0]) for i in range(1, len(ends))]
    up_card = [e0.elapsed_time(e1) for e0, e1 in marks]
    step_card = [e1.elapsed_time(end) for (_, e1), end in zip(marks, ends)]
    mean = lambda xs: sum(xs) / len(xs)
    log(f"the card's timeline a batch (CUDA events, means over "
        f"{len(ends)} batches; gaps over the {len(gap)} after the first): "
        f"idle before the upload {mean(gap):.3f} ms (max {max(gap):.3f}), "
        f"upload {mean(up_card):.3f} ms, step {mean(step_card):.3f} ms; "
        f"host in next() (the hand-off, and any wait for decode) "
        f"{1e3 * mean(host_next):.3f} ms (max {1e3 * max(host_next):.3f}), "
        f"in fit (the upload, and the step's launches; it returns before "
        f"the card is done) {1e3 * mean(host_fit):.3f} ms")
    log(f"ResNet50 from PNGs (B={ETL_B}, f32, nesterovs(0.1, 0.9), {card})"
        f": warm step " + ", ".join(f"{x:.3f}" for x in step_ms)
        + f" ms, median {step:.3f} ms; e2e {e2e_ms:.3f} ms a batch over "
        f"{ETL_EPOCHS} epochs ({n_img} images, full batches) = "
        f"{n_img / e2e_s:.1f} images/s; exposed ETL (e2e - step) "
        f"{e2e_ms - step:.3f} ms ({100 * (e2e_ms - step) / step:.1f}% of "
        "the step); losses " + ", ".join(f"{x:.4f}" for x in losses))

    class Timing(TrainingListener):
        def __init__(self):
            self.wait = self.dispatch = 0.0
            self.images = 0

        def iteration_done(self, model, iteration, score, batch_size):
            wait, dispatch = model._step_timing
            self.wait += wait
            self.dispatch += dispatch
            self.images += batch_size

    perf, timing = PerformanceListener(frequency=1, report=False), Timing()
    net.set_listeners(perf, timing)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(AsyncDataSetIterator(make_it(), prefetch=2), epochs=ETL_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    net.set_listeners()
    assert timing.images == ETL_EPOCHS * ETL_CLASSES * ETL_PER_CLASS
    assert math.isfinite(float(net.score_value))
    host_peak_gib = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    dev_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"fit(AsyncDataSetIterator(NativeImageDataSetIterator)) over "
        f"{ETL_EPOCHS} epochs ({timing.images} images, a partial batch of "
        f"{ETL_CLASSES * ETL_PER_CLASS % ETL_B} an epoch): {fit_s:.3f} s = "
        f"{timing.images / fit_s:.1f} images/s; PerformanceListener's last "
        f"{perf.last_samples_per_sec:.1f} samples/s; summed data_wait "
        f"{timing.wait * 1e3:.3f} ms = {100 * timing.wait / fit_s:.2f}% of "
        f"the fit, dispatch {timing.dispatch * 1e3:.3f} ms; host cores "
        f"{os.cpu_count()}; peak device memory over the phase "
        f"{dev_peak_gib:.2f} GiB; the process's peak host RSS so far (every "
        f"phase before this one included) {host_peak_gib:.2f} GiB")
    del net
    torch.cuda.empty_cache()
    out = {"decode_ms_by_threads": scaling,
           "overlap_exposed_ms": exposed_sim,
           "overlap_exposed_ms_at_2x": exposed_slack,
           "upload_ms_pageable": upload_ms, "upload_ms_pinned": pinned_ms,
           "step_ms": step, "e2e_ms": e2e_ms,
           "card_idle_before_upload_ms": mean(gap),
           "card_upload_ms": mean(up_card), "card_step_ms": mean(step_card),
           "host_next_ms": 1e3 * mean(host_next),
           "host_fit_ms": 1e3 * mean(host_fit),
           "images_s": n_img / e2e_s, "exposed_etl_ms": e2e_ms - step,
           "async_fit_images_s": timing.images / fit_s,
           "data_wait_share": timing.wait / fit_s,
           "host_cores": os.cpu_count(), "losses": losses,
           "host_peak_gib": host_peak_gib, "device_peak_gib": dev_peak_gib}
    log(f"etl_phase {time.perf_counter() - t_all:.1f} s; summary: "
        + json.dumps(out))
    return out


EVAL_TRAIN, EVAL_TEST, EVAL_B = 2048, 512, 128
EVAL_TOL = 1e-5            # AUC, MSE and early-stopping scores, card vs CPU
ES_MAX_EPOCHS, ES_PATIENCE = 5, 2


def eval_phase(card):
    """The evaluators and early stopping on the card against the CPU.
    LeNet (nesterovs(1e-3, 0.9): the held-out loss falls slowly, so
    accuracy and AUC stay off their ceilings and the early-stopping
    scores off zero) on the MNIST surrogate (the fetchers' synthetic
    digits: no files under a data directory of the run's own), its
    inputs standardized by a ``NormalizerStandardize`` that the model's
    zip carries; trained 2 epochs on the card, written, restored on the
    card and on the CPU: ``evaluate`` (accuracy equal), ``evaluate_roc``
    exact and at 100 steps (AUC within 1e-5); an MLP regressor's
    ``evaluate_regression`` (MSE within 1e-5 relative); a two-output
    graph's ``evaluate_outputs``. Then an ``EarlyStoppingTrainer`` from
    one zip on each device (at most 5 epochs, score-improvement patience
    2, ``InMemoryModelSaver``, ``DataSetLossCalculator`` on the held-out
    set): the best epoch and the termination reason equal, the scores
    within 1e-5 relative."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.data import fetchers
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.data.iterators import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.data.normalizers import (
        NormalizerStandardize)
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.train import early_stopping as es
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, restore_normalizer, write_model)

    t_all = time.perf_counter()
    work = tempfile.mkdtemp(prefix="eval_phase_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    saved_dir = os.environ.get("DL4J_TPU_DATA_DIR")
    os.environ["DL4J_TPU_DATA_DIR"] = os.path.join(work, "no_data")
    try:
        x, y = fetchers.mnist_data(train=True, flatten=False, n=EVAL_TRAIN)
        xt, yt = fetchers.mnist_data(train=False, flatten=False,
                                     n=EVAL_TEST)
    finally:
        if saved_dir is None:
            del os.environ["DL4J_TPU_DATA_DIR"]
        else:
            os.environ["DL4J_TPU_DATA_DIR"] = saved_dir
    norm = NormalizerStandardize().fit(DataSet(x, y))
    lenet = zoo.LeNet(n_classes=10, updater=updaters.nesterovs(1e-3, 0.9))
    net = lenet.init(device=CARD)
    zip0 = os.path.join(work, "lenet0.zip")
    write_model(net, zip0, normalizer=norm.to_dict())
    norm = restore_normalizer(zip0)
    assert isinstance(norm, NormalizerStandardize)
    train = norm.transform(DataSet(x, y))
    test = norm.transform(DataSet(xt, yt))
    before = net.evaluate(test.features, test.labels).accuracy()
    net.fit(ArrayDataSetIterator(train.features, train.labels, EVAL_B),
            epochs=2)
    path = os.path.join(work, "lenet.zip")
    write_model(net, path, normalizer=norm.to_dict())
    nets = {"card": restore_model(path, device=CARD),
            "cpu": restore_model(path, device="cpu")}
    ev = {k: n.evaluate(test.features, test.labels) for k, n in nets.items()}
    acc = {k: e.accuracy() for k, e in ev.items()}
    assert acc["card"] == acc["cpu"], acc
    assert acc["card"] > before + 0.1, (before, acc)
    auc = {}
    for steps in (0, 100):
        # exact: the rank statistic; at 100 steps: the area under the
        # curve at 101 evenly spaced thresholds
        rocs = {k: n.evaluate_roc(test.features, test.labels, steps)
                for k, n in nets.items()}
        auc[steps] = {k: r.get_roc_curve().area() if steps
                      else r.calculate_auc() for k, r in rocs.items()}
        assert abs(auc[steps]["card"] - auc[steps]["cpu"]) <= EVAL_TOL, auc
    log(f"LeNet on the MNIST surrogate (standardized by the zip's "
        f"normalizer, {card}): accuracy {before:.4f} before 2 epochs, "
        f"card {acc['card']:.4f} = CPU {acc['cpu']:.4f}; ROC AUC exact "
        f"card {auc[0]['card']:.8f} CPU {auc[0]['cpu']:.8f}, 100 steps "
        f"card {auc[100]['card']:.8f} CPU {auc[100]['cpu']:.8f}")

    rng = np.random.default_rng(0)
    xr = rng.normal(size=(1024, 16)).astype("float32")
    wr = rng.normal(size=(16, 3)).astype("float32")
    yr = (np.tanh(xr @ wr) + rng.normal(0, 0.1, (1024, 3))).astype(
        "float32")
    conf = (NeuralNetConfiguration.builder().set_seed(1)
            .updater(updaters.nesterovs(0.05, 0.9)).list()
            .layer(L.DenseLayer(n_out=64, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="identity",
                                 loss="mse"))
            .set_input_type(InputType.feed_forward(16)).build())
    reg = MultiLayerNetwork(conf, device=CARD).init()
    reg.fit(ArrayDataSetIterator(xr[:768], yr[:768], 64), epochs=3)
    path = os.path.join(work, "reg.zip")
    write_model(reg, path)
    regs = {"card": reg, "cpu": restore_model(path, device="cpu")}
    mse = {k: [n.evaluate_regression(xr[768:], yr[768:])
               .mean_squared_error(c) for c in range(3)]
           for k, n in regs.items()}
    for a, b in zip(mse["card"], mse["cpu"]):
        assert abs(a - b) <= EVAL_TOL * abs(b), mse

    g = (NeuralNetConfiguration.builder().set_seed(2)
         .updater(updaters.nesterovs(0.05, 0.9)).graph_builder()
         .add_inputs("in").set_input_types(InputType.feed_forward(16)))
    g.add_layer("d", L.DenseLayer(n_out=32, activation="tanh"), "in")
    g.add_layer("cls", L.OutputLayer(n_out=2), "d")
    g.add_layer("reg", L.OutputLayer(n_out=3, activation="identity",
                                     loss="mse"), "d")
    graph = ComputationGraph(g.set_outputs("cls", "reg").build(),
                             device=CARD).init()
    ycls = np.eye(2, dtype="float32")[(yr[:, 0] > 0).astype(int)]
    graph.fit([MultiDataSet([xr[i:i + 64]], [ycls[i:i + 64],
                                             yr[i:i + 64]])
               for i in range(0, 768, 64)], epochs=3)
    path = os.path.join(work, "graph.zip")
    write_model(graph, path)
    graphs = {"card": graph, "cpu": restore_model(path, device="cpu")}
    held = MultiDataSet([xr[768:]], [ycls[768:], yr[768:]])
    outs = {k: n.evaluate_outputs(held) for k, n in graphs.items()}
    assert outs["card"]["cls"].accuracy() == outs["cpu"]["cls"].accuracy()
    graph_mse = {k: n.evaluate_regression(held, 1).mean_squared_error(0)
                 for k, n in graphs.items()}
    assert abs(graph_mse["card"] - graph_mse["cpu"]) <= \
        EVAL_TOL * graph_mse["cpu"], graph_mse
    log(f"MLP regressor evaluate_regression MSE by column: card "
        + ", ".join(f"{v:.8f}" for v in mse["card"]) + "; CPU "
        + ", ".join(f"{v:.8f}" for v in mse["cpu"])
        + f"; two-output graph evaluate_outputs: accuracy of 'cls' card "
        f"{outs['card']['cls'].accuracy():.4f} = CPU "
        f"{outs['cpu']['cls'].accuracy():.4f}, MSE of 'reg' card "
        f"{graph_mse['card']:.8f} CPU {graph_mse['cpu']:.8f}")

    results = {}
    for device in (CARD, "cpu"):
        model = restore_model(zip0, device=device)
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                es.ScoreImprovementEpochTerminationCondition(ES_PATIENCE)],
            score_calculator=es.DataSetLossCalculator(ArrayDataSetIterator(
                test.features, test.labels, 256)),
            model_saver=es.InMemoryModelSaver())
        t0 = time.perf_counter()
        results[device] = es.EarlyStoppingTrainer(
            cfg, model, ArrayDataSetIterator(
                train.features[:1024], train.labels[:1024], EVAL_B)).fit()
        results[device].seconds = time.perf_counter() - t0
    a, b = results[CARD], results["cpu"]
    assert (a.termination_reason, a.termination_details,
            a.best_model_epoch, a.total_epochs) == \
        (b.termination_reason, b.termination_details, b.best_model_epoch,
         b.total_epochs), (a, b)
    assert sorted(a.score_vs_epoch) == sorted(b.score_vs_epoch)
    worst = max(abs(a.score_vs_epoch[k] - b.score_vs_epoch[k])
                / abs(b.score_vs_epoch[k]) for k in b.score_vs_epoch)
    assert worst <= EVAL_TOL, (a.score_vs_epoch, b.score_vs_epoch)
    assert a.best_model.device.type == torch.device(CARD).type
    log(f"EarlyStoppingTrainer (LeNet, max {ES_MAX_EPOCHS} epochs, "
        f"patience {ES_PATIENCE}, in-memory saver, held-out loss): card "
        f"{a.termination_reason}/{a.termination_details}, best epoch "
        f"{a.best_model_epoch} of {a.total_epochs} ({a.seconds:.1f} s), CPU "
        f"{b.termination_reason}/{b.termination_details}, best epoch "
        f"{b.best_model_epoch} ({b.seconds:.1f} s); scores card "
        + ", ".join(f"{a.score_vs_epoch[k]:.8f}" for k in sorted(
            a.score_vs_epoch)) + " CPU " + ", ".join(
            f"{b.score_vs_epoch[k]:.8f}" for k in sorted(b.score_vs_epoch))
        + f"; worst relative difference {worst:.3e}")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    out = {"accuracy": acc["card"], "auc": auc[0]["card"],
           "auc_100": auc[100]["card"], "mse": mse["card"],
           "es_best_epoch": a.best_model_epoch,
           "es_reason": a.termination_details, "es_worst_rel": worst}
    log(f"eval_phase {time.perf_counter() - t_all:.1f} s; summary: "
        + json.dumps(out))
    return out


CAPTURE_STEPS = 5          # captured vs eager steps a model
CAPTURE_LENET_B = 128      # LeNet's batch in the capture check
# bench.py:2841-2935: the lenet_kstep leg's net (c4/c8/d64, Adam 1e-3),
# batch, logical steps a k and the ks
KSTEP_B, KSTEP_TOTAL, KSTEP_KS = 8, 384, (1, 8, 64)
CKPT_HIDDEN, CKPT_LAYERS, CKPT_SAVES = 1024, 4, 6   # bench.py:2552-2554
JAX_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "jax_elastic_ckpt_4.zip")


def host_leaves(net):
    """Params, layer state and updater state as flat host arrays."""
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    return {f"{name}/{k}": v for name in ("params", "state", "opt_state")
            for k, v in _flatten(getattr(net, name) or []).items()}


def idle_profile(fn):
    """(busy ms, wall ms) of ``fn()`` under torch.profiler, or None when
    the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return (busy, wall) if busy > 0 else None


def eager_steps(net, ds):
    """One eager training step on ``ds`` (each tBPTT chunk for a
    tBPTT net): the losses."""
    tbptt = net.conf.conf.tbptt
    m = net._coerce_fit_batch(ds)
    if net._batch_is_tbptt(m, tbptt):
        carries = net._zero_carries(m.features.shape[0])
        out = []
        for sub in net._tbptt_chunks(m, tbptt["fwd_length"]):
            loss, carries = net._train_step(net._batch_tuple(sub), carries)
            out.append(loss)
        return out
    return [net._train_step(net._batch_tuple(m))[0]]


def captured_vs_eager(label, make, data, card, stats, on_captured=None):
    """``data`` through ``fit`` on ``make()`` (the first step eager plus
    the capture, the rest replays; 0 captures after the first step), then
    twice through the eager step on fresh ``make()`` copies, all with
    cuDNN's deterministic algorithms: the losses, params, layer state and
    updater state of the captured run held to the first eager run leaf
    by leaf, in L2, within F32_FACTOR times the two eager runs' own
    difference plus FLOOR_RTOL of the leaf (``_leaf_errors``). Host wall ms a step (synchronized) both ways,
    and one profiled step each way. ``on_captured(net)`` runs right
    after the captured batches. Returns the numbers."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    class Losses(TrainingListener):
        def __init__(self):
            self.losses = []

        def iteration_done(self, model, iteration, score, batch_size):
            self.losses.append(score)

    def run(captured):
        net = make()
        rec = Losses()
        net.set_listeners(rec)
        losses, ms, mark = [], [], None
        for i, ds in enumerate(data):
            t0 = time.perf_counter()
            if captured:
                net.fit(ds)
            else:
                losses += eager_steps(net, ds)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                mark = stats.mark()
        after = stats.summary(mark)
        if captured:
            if on_captured is not None:
                on_captured(net)
            assert after["graph_captures"] == 0, (label, after)
            assert after["graph_replays"] >= len(data) - 1, (label, after)
            losses = rec.losses
        out = {f"loss/{i}": np.array([float(v)])
               for i, v in enumerate(losses)}
        out.update(host_leaves(net))
        prof = idle_profile(
            (lambda: net.fit(data[-1])) if captured
            else (lambda: eager_steps(net, data[-1])))
        del net
        gc.collect()
        torch.cuda.empty_cache()
        return out, ms, prof

    # cuDNN's deterministic algorithms, in all three runs: the default
    # ones sum with atomics, and a nesterovs step through 53 batch norms
    # amplifies that noise past what one rerun samples
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    allow_tf32=False):
        cap, cap_ms, cap_prof = run(True)
        ref, eager_ms, eager_prof = run(False)
        ref2, _, _ = run(False)
    rows = _leaf_errors(cap, ref, [ref2], F32_FACTOR)
    med = {k: sorted(v[1:])[len(v[1:]) // 2]
           for k, v in (("captured", cap_ms), ("eager", eager_ms))}

    def idle(p):
        return ("not measured" if p is None else
                f"busy {p[0]:.3f} of {p[1]:.3f} ms, idle "
                f"{100 * max(0.0, 1 - p[0] / p[1]):.1f}%")
    n_loss = sum(k.startswith("loss/") for k in cap)
    log(f"captured vs eager, {label} ({card}; cuDNN deterministic): "
        f"{len(data)} batches, "
        f"{n_loss} steps; losses captured "
        + ", ".join(f"{cap[f'loss/{i}'][0]:.6f}" for i in range(n_loss))
        + " vs eager " + ", ".join(f"{ref[f'loss/{i}'][0]:.6f}"
                                   for i in range(n_loss))
        + f"; {len(ref)} leaves, worst L2 |captured - eager| / "
          f"({F32_FACTOR:g} x |eager - eager rerun| + {FLOOR_RTOL:g} x "
          "|eager|): " + "; ".join(f"{k} {r:.3f} ({e:.3e} of {lim:.3e})"
                                    for r, k, e, lim in rows[:2])
        + f" (limit 1); host wall a batch (synchronized; first, then the "
          f"median of the rest) captured {cap_ms[0]:.3f}, "
          f"{med['captured']:.3f} ms, eager {eager_ms[0]:.3f}, "
          f"{med['eager']:.3f} ms; one profiled batch captured "
          f"{idle(cap_prof)}, eager {idle(eager_prof)}")
    assert rows[0][0] <= 1.0, (label, rows[:3])
    return {"captured_ms": med["captured"], "eager_ms": med["eager"],
            "captured_first_ms": cap_ms[0], "worst": rows[0][0],
            "captured_busy_wall": cap_prof, "eager_busy_wall": eager_prof}


def lenet_conf(c1=20, c2=50, dense=500, updater=None, dropout=None):
    """bench.py:281-307's LeNet (convolutional_flat 28x28x1) with the
    given widths and updater (default Adam 1e-3), seed 0."""
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                         DenseLayer,
                                                         OutputLayer,
                                                         SubsamplingLayer)
    kw = {} if dropout is None else {"dropout": dropout}
    return (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updater or updaters.adam(1e-3)).list()
            .layer(ConvolutionLayer(n_out=c1, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=c2, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=dense, activation="relu", **kw))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())


def digits(n, B, seed=0):
    """``n`` seeded batches of B noise images with one-hot labels."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(0, 1, (B, 784)).astype("float32"),
                    np.eye(10, dtype="float32")[rng.integers(0, 10, B)])
            for _ in range(n)]


def capture_phase(attn, card):
    """The captured training step against the eager ``_train_step`` on
    the card, CAPTURE_STEPS batches each (``captured_vs_eager``), dropout
    off: LeNet on MultiLayerNetwork (Adam with a ``step`` schedule),
    ResNet50 on ComputationGraph at the headline leg's shape, the
    char-RNN under tBPTT at its leg's width, the transformer LM at full
    width (its three attention kernels launched from the replays: the
    capture records 8 of each, every replay adds them). With dropout on
    (LeNet, sgd at rate 0, so only the masks move the loss), replays of
    one batch give different losses. Returns the LM run's launches."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    stats = install_global_watch()
    out = {}

    sched = updaters.adam(1e-3, schedule={"type": "step",
                                          "decay_rate": 0.5, "step": 2})
    out["lenet"] = captured_vs_eager(
        f"LeNet on MultiLayerNetwork (B={CAPTURE_LENET_B}, Adam 1e-3 with "
        "a step schedule)",
        lambda: MultiLayerNetwork(lenet_conf(updater=sched),
                                  device="cuda").init(),
        digits(CAPTURE_STEPS, CAPTURE_LENET_B), card, stats)

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(
        "float32")
    y = np.eye(RESNET_CLASSES, dtype="float32")[
        rng.integers(0, RESNET_CLASSES, RESNET_B)]
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    out["resnet50"] = captured_vs_eager(
        f"ResNet50 on ComputationGraph (B={RESNET_B}, {RESNET_HW}x"
        f"{RESNET_HW}, f32, nesterovs(0.1, 0.9))",
        lambda: zoo.ResNet50(n_classes=RESNET_CLASSES,
                             updater=updaters.nesterovs(0.1, 0.9)).init(
                                 device="cuda"),
        [ds] * CAPTURE_STEPS, card, stats)
    del ds

    ids = np.random.default_rng(1).integers(0, CHAR_V,
                                            (CHAR_B, CHAR_T + 1))
    chars = [DataSet(*char_batch(np.roll(ids, i, axis=0), "cuda"))
             for i in range(CAPTURE_STEPS)]
    out["char_rnn_tbptt"] = captured_vs_eager(
        f"char-RNN under tBPTT (B={CHAR_B}, T={CHAR_T} in chunks of "
        f"{TBPTT_FWD}, 2 x GravesLSTM({CHAR_H}))",
        lambda: MultiLayerNetwork(char_rnn_conf(tbptt=TBPTT_FWD),
                                  device="cuda").init(),
        chars, card, stats)

    conf = lm_config(updaters.adam(TRAIN_LR))
    lm_rng = np.random.default_rng(0)
    lm_ids = lm_rng.integers(0, V, (TRAIN_B, T)).astype("float32")
    lm_y = np.eye(V, dtype="float32")[lm_rng.integers(0, V, (TRAIN_B, T))]
    wrappers = {"flash_attention_fwd": attn.flash_attention_fwd_cuda,
                "flash_attention_bwd_dq": attn.flash_attention_bwd_dq_cuda,
                "flash_attention_bwd_dkv": attn.flash_attention_bwd_dkv_cuda}
    launches, tally = {}, {}

    def counted(net):
        """Read just after the captured run (the eager runs after it,
        and its profiled step, are not counted)."""
        torch.cuda.synchronize()
        launches.update({k: w.launches for k, w in wrappers.items()})
        prog, = net._programs.values()
        tally.update({k: prog.tally.get(w, 0) for k, w in wrappers.items()})
    for w in wrappers.values():
        w.launches = 0
    out["lm"] = captured_vs_eager(
        f"transformer LM (V={V}, D={D_MODEL}, L={LAYERS}, H={HEADS}, "
        f"T={T}, B={TRAIN_B}, Adam {TRAIN_LR:g})",
        lambda: MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                                  device="cuda").init(seed=0),
        [DataSet(lm_ids, lm_y)] * CAPTURE_STEPS, card, stats, counted)
    log(f"attention kernels in the captured LM run ({CAPTURE_STEPS} "
        f"steps: one eager, then the capture, then replays): launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items())
        + f" (expected {LAYERS * CAPTURE_STEPS} each: {LAYERS} a step, "
          f"counted on every replay); recorded by the capture {tally}")
    for k, n in launches.items():
        assert n == LAYERS * CAPTURE_STEPS, (k, n)
        assert tally[k] == LAYERS, (k, tally)

    net = MultiLayerNetwork(lenet_conf(updater=updaters.sgd(0.0),
                                       dropout=0.5), device="cuda").init()
    batch = digits(1, CAPTURE_LENET_B, seed=3)[0]
    drawn = []
    for _ in range(4):
        net.fit(batch)
        drawn.append(float(net.score_value))
    log(f"dropout 0.5 under the captured step (LeNet, sgd at rate 0, one "
        f"batch 4 times: the eager step, then 3 replays): losses "
        + ", ".join(f"{v:.6f}" for v in drawn))
    assert len(set(drawn[1:])) == 3, drawn
    del net
    log("capture_phase summary: " + json.dumps(out))
    return launches


def kstep_net(seed=0):
    """bench.py:2841's ``_kstep_lenet``: LeNet at c4/c8/d64, Adam 1e-3."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    conf = lenet_conf(4, 8, 64)
    conf.conf.seed = seed
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        conf.to_dict()), device="cuda").init()


def kstep_phase(card):
    """bench.py:2882's ``lenet_kstep`` leg: ``_kstep_lenet`` (c4/c8/d64,
    batch KSTEP_B, Adam 1e-3) at k in KSTEP_KS, every program warmed,
    then KSTEP_TOTAL logical steps through ``fit_batches(k batches,
    steps_per_device_call=k)``, inside ``zero_compile_scope``: steps/s,
    the p50 step and the jitter (p95 - p50) / p50 of wall / k a call."""
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    stats = install_global_watch()
    ds = digits(1, KSTEP_B)[0]
    res = {}
    for k in KSTEP_KS:
        net = kstep_net()
        rep = net.warmup(ds, steps_per_device_call=k)
        batches = [ds] * k
        with stats.zero_compile_scope(f"lenet_kstep k={k}"):
            for _ in range(max(2, 16 // k)):
                net.fit_batches(batches, steps_per_device_call=k)
            per_step = []
            t0 = time.perf_counter()
            for _ in range(KSTEP_TOTAL // k):
                t1 = time.perf_counter()
                net.fit_batches(batches, steps_per_device_call=k)
                per_step.append((time.perf_counter() - t1) / k)
            dt = time.perf_counter() - t0
        srt = sorted(per_step)
        p50 = srt[len(srt) // 2]
        p95 = srt[min(len(srt) - 1, int(len(srt) * 0.95))]
        res[k] = {"steps_per_sec": KSTEP_TOTAL / dt,
                  "step_ms_p50": p50 * 1e3, "step_ms_p95": p95 * 1e3,
                  "jitter_pct": (p95 - p50) / p50 * 100.0,
                  "warmup_s": rep}
        log(f"lenet_kstep k={k} ({card}): {res[k]['steps_per_sec']:.1f} "
            f"steps/s, p50 {res[k]['step_ms_p50']:.4f} ms, p95 "
            f"{res[k]['step_ms_p95']:.4f} ms, jitter (p95-p50)/p50 "
            f"{res[k]['jitter_pct']:.1f}%; warmup {rep}")
        del net
    log(f"lenet_kstep: k=8 / k=1 steps/s "
        f"{res[8]['steps_per_sec'] / res[1]['steps_per_sec']:.3f}, k=64 / "
        f"k=1 {res[64]['steps_per_sec'] / res[1]['steps_per_sec']:.3f}")
    return res


def aot_warmup_phase(card):
    """bench.py:2939's ``aot_warmup`` leg: the first training call cold
    (the eager step and the capture) and after ``warmup(k=8)`` (a
    replay); ``zero_compile_scope`` around 5 windows of 8 and a 3-batch
    tail each; the first serve request cold and after
    ``ModelServer.warmup(generate=False)``, then a mixed-size predict
    burst inside ``zero_compile_scope``."""
    import numpy as np
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    stats = install_global_watch()
    ds = digits(1, KSTEP_B)[0]
    cold = kstep_net(seed=1)
    t0 = time.perf_counter()
    cold.fit_batches([ds])
    cold_s = time.perf_counter() - t0
    warm = kstep_net(seed=1)
    mark = stats.mark()
    rep = warm.warmup(ds, steps_per_device_call=8)
    during = stats.summary(mark)
    t0 = time.perf_counter()
    warm.fit_batches([ds])
    warm_s = time.perf_counter() - t0
    mark = stats.mark()
    with stats.zero_compile_scope("aot_warmup train steady state"):
        for _ in range(5):
            warm.fit_batches([ds] * 8, steps_per_device_call=8)
            warm.fit_batches([ds] * 3, steps_per_device_call=8)
    steady = stats.summary(mark)
    assert during["graph_captures"] == 2, during
    assert steady["graph_replays"] == 5 * 4, steady

    x1 = np.zeros((1, 784), np.float32)
    reg = ModelRegistry()
    reg.register("default", kstep_net(seed=2))
    srv = ModelServer(reg, max_batch_size=8)
    sched, _ = srv.scheduler_for("default")
    t0 = time.perf_counter()
    sched.predict(x1, timeout=120)
    serve_cold_s = time.perf_counter() - t0
    srv.stop(drain=False)
    reg2 = ModelRegistry()
    reg2.register("default", kstep_net(seed=2))
    srv2 = ModelServer(reg2, max_batch_size=8)
    srv_rep = srv2.warmup(generate=False)
    sched2, _ = srv2.scheduler_for("default")
    t0 = time.perf_counter()
    sched2.predict(x1, timeout=120)
    serve_warm_s = time.perf_counter() - t0
    try:
        with stats.zero_compile_scope("aot_warmup serve burst"):
            for n in (1, 2, 3, 5, 8, 7, 4, 1):
                sched2.predict(np.zeros((n, 784), np.float32), timeout=120)
    finally:
        srv2.stop(drain=False)
    log(f"aot_warmup ({card}): train first call cold {cold_s * 1e3:.3f} ms"
        f" (eager step + capture) vs warm {warm_s * 1e3:.3f} ms (warmup "
        f"{ {k: round(v, 4) for k, v in rep.items()} } s, captures "
        f"{during['graph_captures']}); steady state (5 windows of 8 + "
        f"3-batch tails) {steady}; serve first request cold "
        f"{serve_cold_s * 1e3:.3f} ms vs warm {serve_warm_s * 1e3:.3f} ms "
        f"(buckets {srv_rep['default']['predict_buckets']}); 0 captures in "
        "both steady states (asserted)")
    return {"train_cold_ms": cold_s * 1e3, "train_warm_ms": warm_s * 1e3,
            "serve_cold_ms": serve_cold_s * 1e3,
            "serve_warm_ms": serve_warm_s * 1e3}


def elastic_data(n, seed):
    """tests/test_torch_fault_tolerance.py's ``_data``: n seeded batches
    of 8 rows of 4 features, 3 classes."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, 3, 8)
        x = (rng.normal(size=(8, 4)) + y[:, None]).astype(np.float32)
        out.append(DataSet(x, np.eye(3, dtype=np.float32)[y]))
    return out


def checkpoint_phase(card):
    """bench.py:2558's ``checkpoint_async`` leg: 4 x Dense(1024, relu) +
    Output(16), Adam 1e-3, on the card; CKPT_SAVES sync saves (the train
    thread's blocked ms), then CKPT_SAVES async ones with a barrier each
    (blocked p99 from the ``checkpoint_write_seconds{phase="blocked"}``
    histogram, reset first; the total a save); the newest generation
    restored, its output equal to the model's; and the JAX trainer's
    checkpoint committed under tests/fixtures (written by the JAX
    ElasticTrainer, killed at step 5) resumed by the port's trainer on
    the card to the run's end."""
    import shutil
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.observability.registry import REGISTRY
    from deeplearning4j_tpu_torch.train.fault_tolerance import (
        ElasticTrainer)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model)
    b = (NeuralNetConfiguration.builder().set_seed(0)
         .updater(updaters.adam(1e-3)).list())
    for _ in range(CKPT_LAYERS):
        b = b.layer(DenseLayer(n_out=CKPT_HIDDEN, activation="relu"))
    conf = (b.layer(OutputLayer(n_out=16))
            .set_input_type(InputType.feed_forward(CKPT_HIDDEN)).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    zip_mb = net.num_params() * 4 / 1e6
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        sync = ElasticTrainer(net, os.path.join(root, "sync"), keep=2,
                              handle_sigterm=False)
        sync_s = []
        for _ in range(CKPT_SAVES):
            net.iteration_count += 1
            t0 = time.perf_counter()
            sync.save_checkpoint()
            sync_s.append(time.perf_counter() - t0)
        for phase in ("blocked", "total"):
            REGISTRY.unregister("checkpoint_write_seconds",
                                {"phase": phase})
        asy = ElasticTrainer(net, os.path.join(root, "async"), keep=2,
                             handle_sigterm=False, async_checkpoint=True)
        total = []
        for _ in range(CKPT_SAVES):
            net.iteration_count += 1
            t0 = time.perf_counter()
            asy.save_checkpoint()
            asy.checkpoint_barrier()
            total.append(time.perf_counter() - t0)
        asy.close()
        p99_ms = REGISTRY.histogram("checkpoint_write_seconds", labels={
            "phase": "blocked"}).snapshot()["p99"] * 1e3
        x = np.random.default_rng(0).normal(
            0, 1, (64, CKPT_HIDDEN)).astype("float32")
        restored = restore_model(asy.latest_checkpoint(), device="cuda")
        diff = float((restored.output(x) - net.output(x)).abs().max())
        assert restored.iteration_count == net.iteration_count
        assert diff == 0.0, diff

        d = os.path.join(root, "jax_run")
        os.makedirs(d)
        shutil.copy(JAX_CKPT, os.path.join(d, "ckpt_4.zip"))
        small = restore_model(JAX_CKPT, device="cuda")
        tr = ElasticTrainer(small, d, save_every=2, handle_sigterm=False)
        at = (small.iteration_count, tr._batch)
        tr.fit(elastic_data(8, seed=7), until_epoch=2)
        final = float(small.score_value)
        assert at == (4, 4) and small.iteration_count == 16, (
            at, small.iteration_count)
        assert math.isfinite(final)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sync_ms = sorted(sync_s)[len(sync_s) // 2] * 1e3
    total_ms = sorted(total)[len(total) // 2] * 1e3
    log(f"checkpoint_async ({card}; {net.num_params()} params, ~{zip_mb:.0f}"
        f" MB of f32): sync {sync_ms:.3f} ms a save blocked (median of "
        f"{CKPT_SAVES}); async blocked p99 {p99_ms:.3f} ms (the "
        f"histogram), total {total_ms:.3f} ms a save; blocked / sync "
        f"{p99_ms / sync_ms:.4f}; the newest async generation restored: "
        f"max |output diff| {diff} over 64 rows; the JAX trainer's "
        f"checkpoint (tests/fixtures/{os.path.basename(JAX_CKPT)}) resumed by the port's trainer on the card "
        f"at iteration {at[0]}, batch {at[1]}, trained to iteration "
        f"{small.iteration_count}, last loss {final:.6f}")
    return {"sync_ms": sync_ms, "async_blocked_p99_ms": p99_ms,
            "async_total_ms": total_ms}


# --------------------------------------------------------------------
# retrieval_phase: vector indexes, k-means, the embedder and the
# retrieval routes on the card (the JAX package runs these as XLA's
# matmul, top_k and gather, so the port runs cuBLAS and torch ops: no
# kernel of the port's own)
# --------------------------------------------------------------------

# the corpus: SIFT1M's shape (ANN-benchmarks / TEXMEX, 10^6 x 128 f32),
# made from a seed as bench.py:3323-3327 makes its corpus
RETR_CORPUS = "random:n=1000000,dim=128,seed=0,clusters=1024"
RETR_NLIST, RETR_K, RETR_B = 1024, 10, 32
RETR_BATCHES = 64          # timed B=32 search batches a configuration
RETR_ORACLE_Q = 64         # queries held against the float64 oracle
RETR_RECALL_Q = 1024       # queries of the IVF recall against brute force
# the embedder: GloVe 6B's shape, values from a seed
GLOVE_V, GLOVE_D, EMBED_TEXTS = 400_000, 300, 256
# the soak: bench.py:3283-3285's retrieval_serving leg
SOAK_CORPUS = "random:n=8192,dim=64,seed=0,clusters=64"
SOAK_NLIST, SOAK_NPROBE, SOAK_CONC, SOAK_QUERIES = 64, 16, 8, 256
SOAK_KILL_AT = 200         # the routed request replica 0 dies at
RETR_TOL = 1e-4            # scores vs the float64 oracle; near-tie gap


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def retrieval_queries(vectors, n, seed):
    """``n`` corpus rows (drawn from ``seed``) with noise of 0.05 a
    coordinate: near-duplicates, as an ANN benchmark's queries are."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = rng.choice(vectors.shape[0], n, replace=False)
    return (vectors[rows] + 0.05 * rng.normal(
        size=(n, vectors.shape[1]))).astype(np.float32)


def cosine_oracle(vectors, ids, q, k):
    """(ids, scores) of the exact top-(k+1) by float64 cosine on the
    host, in blocks of queries."""
    import numpy as np
    vn = vectors.astype(np.float64)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    out_i, out_s = [], []
    for s in range(0, q.shape[0], 16):
        qn = q[s:s + 16].astype(np.float64)
        qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-12)
        sc = qn @ vn.T
        top = np.argpartition(-sc, k, axis=1)[:, :k + 1]
        order = np.argsort(-np.take_along_axis(sc, top, 1), axis=1)
        top = np.take_along_axis(top, order, 1)
        out_i.append(ids[top])
        out_s.append(np.take_along_axis(sc, top, 1))
    return np.concatenate(out_i), np.concatenate(out_s)


def check_against_oracle(got_ids, got_scores, want_ids, want_scores, k):
    """Scores within RETR_TOL of float64's; ids equal, except that
    within a run of scores closer than RETR_TOL they may be ordered
    (or, at the k-th place, chosen) differently. Returns the number of
    ids that had to match exactly and did."""
    import numpy as np
    np.testing.assert_allclose(got_scores, want_scores[:, :k],
                               atol=RETR_TOL, rtol=0)
    exact = 0
    for r in range(got_ids.shape[0]):
        s = want_scores[r]
        j = 0
        while j < k:
            e = j + 1
            while e <= k and s[e - 1] - s[e] <= RETR_TOL:
                e += 1
            if e > k:          # a tie run across the k-th place
                assert set(got_ids[r, j:k]) <= set(want_ids[r, j:e]), r
                break
            assert set(got_ids[r, j:e]) == set(want_ids[r, j:e]), \
                (r, got_ids[r], want_ids[r])
            exact += e - j
            j = e
    return exact


def search_batches(svc, queries, nprobe=None, k=RETR_K, b=RETR_B):
    """Every B-row batch of ``queries`` through the service, one at a
    time: (ids, per-batch ms, wall s)."""
    import numpy as np
    lat, out = [], []
    t0 = time.perf_counter()
    for s in range(0, queries.shape[0], b):
        t = time.perf_counter()
        ids, _ = svc.search(queries[s:s + b], k=k, nprobe=nprobe,
                            timeout=60.0)
        lat.append((time.perf_counter() - t) * 1e3)
        out.append(ids)
    return np.concatenate(out), lat, time.perf_counter() - t0


def recall_at(got, want, k):
    hits = sum(len({int(g) for g in a if g >= 0} & {int(w) for w in b[:k]})
               for a, b in zip(got, want))
    return hits / (k * len(got))


def retrieval_index_leg(device, card):
    """The million-vector corpus built through ``index build``'s code,
    brute force and IVF through RetrievalService. Returns the brute
    index, the corpus and the embedder vocabulary for the HTTP leg."""
    import numpy as np
    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.retrieval.index import _dot_topk
    from deeplearning4j_tpu_torch.serving.retrieval_backend import (
        RetrievalService)

    t0 = time.perf_counter()
    ids, vectors, vocab, table = cli._load_corpus(RETR_CORPUS)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    brute = cli.build_index(ids, vectors, "brute", metric="cosine",
                            device=device)
    brute_s = time.perf_counter() - t0
    st = brute.stats()
    snap = brute._snap
    nbytes = snap.mat.numel() * snap.mat.element_size()
    log(f"retrieval corpus {RETR_CORPUS}: {vectors.shape[0]} x "
        f"{vectors.shape[1]} f32 made in {corpus_s:.2f} s; brute index "
        f"(index build's code) in {brute_s:.2f} s: {st['vectors']} "
        f"vectors, capacity {st['capacity']} ({nbytes / 2 ** 20:.0f} MiB "
        f"on {snap.mat.device})")
    assert st["vectors"] == vectors.shape[0]

    queries = retrieval_queries(vectors, RETR_B * RETR_BATCHES, seed=1)
    svc = RetrievalService(brute, max_batch_size=RETR_B, wait_ms=2.0)
    try:
        svc.warmup(ks=(RETR_K,), batch_sizes=(RETR_B,))
        got, lat, wall = search_batches(svc, queries)
    finally:
        svc.close(drain=True)
    # the device's share: one batch's matmul + mask + top-k alone
    import torch
    qd = torch.from_numpy(brute._prep(queries[:RETR_B])).to(device)
    dev_ms = time_ms(lambda: _dot_topk(qd, snap.mat, snap.mask, 16)) \
        if device == "cuda" else float("nan")
    bound_ms = nbytes / PEAK_BYTES * 1e3
    if device == "cuda":
        check_bound(dev_ms, {"bound_ms": bound_ms, "bound_by": "bytes"},
                    "the brute-force batch")
    qps = queries.shape[0] / wall
    log(f"brute force ({card}): {RETR_BATCHES} batches of B={RETR_B}, "
        f"k={RETR_K} through RetrievalService: p50 "
        f"{percentile(lat, 0.5):.3f} ms, p99 {percentile(lat, 0.99):.3f} "
        f"ms, {qps:.1f} queries/s; the batch's device time (matmul + mask "
        f"+ top-16, CUDA events) {dev_ms:.4f} ms against its bound "
        f"{bound_ms:.4f} ms (the {nbytes / 2 ** 20:.0f} MiB corpus read "
        f"once at {PEAK_BYTES / 1e12:.2f} TB/s): {100 * bound_ms / dev_ms:.1f}"
        f"% of the bound; the service's p50 {100 * bound_ms / percentile(lat, 0.5):.1f}%")
    # exactness against float64 on the host
    want_i, want_s = cosine_oracle(vectors, ids, queries[:RETR_ORACLE_Q],
                                   RETR_K)
    gi, gs = brute.search(queries[:RETR_ORACLE_Q], k=RETR_K)
    exact = check_against_oracle(gi, gs, want_i, want_s, RETR_K)
    log(f"brute force vs the float64 oracle: {RETR_ORACLE_Q} queries, "
        f"scores within {RETR_TOL}, {exact} of {RETR_ORACLE_Q * RETR_K} "
        f"ids outside near-ties equal")

    t0 = time.perf_counter()
    ivf = cli.build_index(ids, vectors, "ivf", nlist=RETR_NLIST,
                          metric="cosine", device=device)
    ivf_s = time.perf_counter() - t0
    ist = ivf.stats()
    log(f"IVF index (index build's code, k-means on the whole corpus on "
        f"{device}): nlist {RETR_NLIST} built in {ivf_s:.2f} s; cells "
        f"{ist['cells']}")
    rq = queries[:RETR_RECALL_Q]
    truth = search_batches_direct(brute, rq)
    isvc = RetrievalService(ivf, max_batch_size=RETR_B, wait_ms=2.0)
    recalls = {}
    try:
        for nprobe in (1, 4, 16):
            isvc.warmup(ks=(RETR_K,), nprobes=(nprobe,),
                        batch_sizes=(RETR_B,))
            got, lat, wall = search_batches(isvc, rq, nprobe=nprobe)
            recalls[nprobe] = recall_at(got, truth, RETR_K)
            ivf.search(rq[:RETR_B], k=RETR_K, nprobe=nprobe)
            split = dict(ivf.last_split)
            log(f"IVF nprobe {nprobe} ({card}): recall@{RETR_K} against "
                f"brute force {recalls[nprobe]:.4f} over {rq.shape[0]} "
                f"queries; p50 {percentile(lat, 0.5):.3f} ms, p99 "
                f"{percentile(lat, 0.99):.3f} ms, "
                f"{rq.shape[0] / wall:.1f} queries/s "
                f"({rq.shape[0] / wall / qps:.3f}x brute force); a batch's "
                f"split: host (coarse scoring, candidate lists) "
                f"{split['host_s'] * 1e3:.3f} ms, device call and copy "
                f"back {split['device_s'] * 1e3:.3f} ms, gather width "
                f"c_pad {split['c_pad']} ({RETR_B} x {split['c_pad']} x "
                f"{vectors.shape[1]} f32 = "
                f"{RETR_B * split['c_pad'] * vectors.shape[1] * 4 / 2 ** 20:.0f}"
                f" MiB gathered)")
    finally:
        isvc.close(drain=True)
    assert recalls[16] >= 0.9, recalls
    del ivf, isvc
    return brute, ids, vectors, vocab, table, queries


def search_batches_direct(index, queries, k=RETR_K, b=RETR_B):
    """The index's ids for every B-row batch of ``queries``, called
    directly (no service)."""
    import numpy as np
    return np.concatenate([index.search(queries[s:s + b], k=k)[0]
                           for s in range(0, queries.shape[0], b)])


def retrieval_http_leg(brute, vocab, vectors, queries, device, card):
    """The retrieval routes on two port servers: the million-vector
    index with the corpus's own ``w{i}`` embedder (``serve --index
    random:``'s shape) for /v1/search by text and by vector and the
    /v1/index verbs, and a GloVe-shaped embedder for /v1/embed, held
    against numpy's masked mean-pool. After ``warmup()``,
    ``zero_compile_scope`` must see no capture."""
    import numpy as np
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex,
                                                    TextEmbedder)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.retrieval_backend import (
        RetrievalService)

    stats = install_global_watch()
    svc = RetrievalService(brute, embedder=TextEmbedder(
        vocab, vectors, device=device), max_batch_size=RETR_B)
    server = ModelServer(ModelRegistry(), retrieval=svc)
    rep = server.warmup()
    server.start()
    try:
        with stats.zero_compile_scope("post-warmup retrieval traffic"):
            m = stats.mark()
            code, body, _ = http(server.port, "/v1/search",
                                 {"queries": ["w5", "w123456 w7"],
                                  "k": RETR_K})
            assert code == 200, body
            assert body["results"][0][0]["id"] == 5, body["results"][0]
            code, vbody, _ = http(server.port, "/v1/search",
                                  {"vectors": queries[:4].tolist(),
                                   "k": RETR_K})
            assert code == 200, vbody
            direct, _ = brute.search(queries[:4], k=RETR_K)
            assert [[r["id"] for r in row] for row in vbody["results"]] \
                == direct.tolist()
            after = stats.summary(m)
        assert after["graph_captures"] == 0, after
        gen0 = brute.generation
        new_id = int(vectors.shape[0]) + 7
        steps = {}
        t0 = time.perf_counter()
        code, b, _ = http(server.port, "/v1/index/upsert",
                          {"ids": [new_id], "vectors": [[9.0] *
                                                        vectors.shape[1]]})
        steps["upsert"] = (time.perf_counter() - t0, code, b)
        code, hit, _ = http(server.port, "/v1/search",
                            {"vector": [9.0] * vectors.shape[1], "k": 1})
        assert hit["results"][0][0]["id"] == new_id, hit
        for verb, body in (("delete", {"ids": [new_id, 3]}),
                           ("compact", {}), ("stats", {})):
            t0 = time.perf_counter()
            code, b, _ = http(server.port, f"/v1/index/{verb}", body)
            steps[verb] = (time.perf_counter() - t0, code, b)
        assert all(c == 200 for _, c, _ in steps.values()), steps
        st = steps["stats"][2]["index"]
        assert st["vectors"] == vectors.shape[0] - 1, st
        assert st["tombstones"] == 0 and st["generation"] > gen0, st
        log(f"retrieval HTTP ({card}): warmup {rep['_search']}; text and "
            f"vector /v1/search on the {vectors.shape[0]}-vector index "
            f"inside zero_compile_scope: {after}; /v1/index seconds "
            + ", ".join(f"{v} {s:.2f}" for v, (s, _, _) in steps.items())
            + f"; stats after: {st}")
    finally:
        server.stop(drain=True)

    # the GloVe-shaped embedder behind /v1/embed
    rng = np.random.default_rng(5)
    table = rng.normal(size=(GLOVE_V, GLOVE_D)).astype(np.float32)
    gvocab = {f"t{i}": i for i in range(GLOVE_V)}
    emb = TextEmbedder(gvocab, table, normalize=False, device=device)
    small = BruteForceIndex(GLOVE_D, device=device)
    small.add(np.arange(4096), table[:4096])
    server = ModelServer(ModelRegistry(), retrieval=RetrievalService(
        small, embedder=emb, max_batch_size=RETR_B))
    server.start()
    try:
        lens = rng.integers(0, 48, EMBED_TEXTS)
        texts = [" ".join(f"t{i}" for i in rng.integers(0, GLOVE_V, n))
                 + (" oov" if n % 5 == 0 else "") for n in lens]
        t0 = time.perf_counter()
        code, body, _ = http(server.port, "/v1/embed", {"texts": texts})
        embed_s = time.perf_counter() - t0
        assert code == 200, body
        got = np.asarray(body["embeddings"], np.float64)
        packed = emb.encode(texts)
        tok = packed[:, 0, :].astype(np.int64)
        mask = packed[:, 1, :].astype(np.float64)
        want = (table[tok] * mask[..., None]).sum(1) / np.maximum(
            mask.sum(1, keepdims=True), 1.0)
        err = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    finally:
        server.stop(drain=True)
    log(f"/v1/embed ({card}): {EMBED_TEXTS} texts over a {GLOVE_V} x "
        f"{GLOVE_D} table ({GLOVE_V * GLOVE_D * 4 / 2 ** 20:.0f} MiB on "
        f"{device}) in {embed_s * 1e3:.1f} ms; vs numpy's masked mean "
        f"pool max |diff| {err:.3e} (atol 1e-5, rtol 1e-4)")


def retrieval_soak(device, card):
    """bench.py's retrieval_serving soak: four subprocess port replicas
    (``serve --index SOAK_CORPUS --index-kind ivf``) behind the router,
    SOAK_CONC clients sending SOAK_QUERIES vector searches with up to 3
    retries, a seeded ``serving.replica`` kill of replica 0 at routed
    request SOAK_KILL_AT. No request may fail; recall@10 against the
    client's float64 oracle must reach 0.9."""
    import numpy as np
    from deeplearning4j_tpu_torch import chaos, cli
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
    from deeplearning4j_tpu_torch.serving.router import Router

    ids, vectors, _, _ = cli._load_corpus(SOAK_CORPUS)
    pool = retrieval_queries(vectors, 256, seed=2)
    truth, _ = cosine_oracle(vectors, ids, pool, RETR_K)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p])
    fleet = ReplicaFleet(n=4, base_port=free_ports(4), device=device,
                         extra_args=["--index", SOAK_CORPUS,
                                     "--index-kind", "ivf", "--nlist",
                                     str(SOAK_NLIST), "--nprobe",
                                     str(SOAK_NPROBE)])
    t0 = time.perf_counter()
    fleet.start()
    router = Router(fleet, probe_interval_s=0.25, hedge_after_s=None,
                    sample_rate=0.0).start()
    try:
        t_end = time.monotonic() + 300
        while router.health_payload()["eligible"] < 4:
            assert time.monotonic() < t_end, "soak fleet never came up"
            for r in fleet.snapshot():
                assert r.proc.poll() is None, "a soak replica died booting"
            time.sleep(0.25)
        up_s = time.perf_counter() - t0
        for i in range(8):                 # warm each replica's bucket
            assert http(router.port, "/v1/search",
                        {"vector": pool[i].tolist(), "k": RETR_K})[0] == 200
        chaos.install({"faults": [{"site": "serving.replica",
                                   "kind": "kill", "at": [SOAK_KILL_AT],
                                   "args": {"replica": 0}}]}, seed=1234)
        lock = threading.Lock()
        todo = list(range(SOAK_QUERIES))
        results, failed, lat, retried = {}, [], [], [0]

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop()
                r = i % pool.shape[0]
                body = {"vector": pool[r].tolist(), "k": RETR_K}
                for attempt in range(4):
                    t = time.perf_counter()
                    try:
                        code, reply, _ = http(router.port, "/v1/search",
                                              body)
                    except OSError as e:
                        code, reply = 0, {"error": repr(e)}
                    if code == 200:
                        break
                    with lock:
                        retried[0] += 1
                    time.sleep(0.05 * (attempt + 1))
                with lock:
                    if code != 200:
                        failed.append((i, code, reply))
                    else:
                        lat.append((time.perf_counter() - t) * 1e3)
                        results[i] = [x["id"] for x in reply["results"][0]]

        threads = [threading.Thread(target=client)
                   for _ in range(SOAK_CONC)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        killed = [r.id for r in fleet.snapshot()]
    finally:
        chaos.uninstall()
        router.stop()
        fleet.stop(drain=False, timeout=10.0)
    hits = sum(len(set(results[i]) & set(truth[i % pool.shape[0]][:RETR_K]
                                           .tolist()))
               for i in results)
    recall = hits / (RETR_K * max(len(results), 1))
    log(f"retrieval soak ({card}): 4 subprocess replicas "
        f"(--index {SOAK_CORPUS} ivf nlist {SOAK_NLIST} nprobe "
        f"{SOAK_NPROBE}) up in {up_s:.1f} s; {SOAK_QUERIES} searches from "
        f"{SOAK_CONC} clients with replica 0 SIGKILLed at routed request "
        f"{SOAK_KILL_AT}: {len(failed)} failed, {retried[0]} retries, "
        f"replicas left {killed}, {SOAK_QUERIES / wall:.1f} queries/s, p50 "
        f"{percentile(lat, 0.5):.2f} ms p99 {percentile(lat, 0.99):.2f} ms; "
        f"recall@{RETR_K} vs the client's float64 oracle {recall:.4f}")
    assert not failed, failed[:5]
    assert len(killed) == 3, killed
    assert recall >= 0.9, recall


def retrieval_phase(card):
    """The retrieval slice on the card: the million-vector index
    (brute force and IVF, k-means included), the embedder and the
    retrieval routes, and the failover soak."""
    import torch
    device = CARD
    brute, ids, vectors, vocab, table, queries = retrieval_index_leg(
        device, card)
    del table
    retrieval_http_leg(brute, vocab, vectors, queries, device, card)
    del brute, vocab
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    retrieval_soak(device, card)



# --------------------------------------------------------------------
# fleet_control_phase: the fleet's control loops (collector, autoscaler,
# canary rollout) over the full-width LM on the card; host code, which
# bench.py's own legs call CPU-dominated
# --------------------------------------------------------------------

# ids a predict row in the control drills: a reply carries V floats an
# id as JSON, which at 8 ids held the drills' host to ~16 requests/s on
# an H100 machine, so one id
CTL_PREDICT_T = 1
# paired off/on runs (4, then 2, until the smoke's time limit; the
# cost is printed, not asserted), of 80 requests each (160 until the
# wide-head and rank-example phases)
OBS_RUNS, OBS_REQUESTS, OBS_CONC = 1, 80, 8
OBS_BAR = 0.02             # bench.py's OBS_OVERHEAD_BAR
ROLL_REPLICAS = 4
# bench.py's autoscaler_soak, its 14 s load cut to AS_DURATION
AS_PROFILE = (8.0, 48.0, 2.0)   # step: 8 q/s, then 48 q/s from t = 2 s
AS_DURATION, AS_CONC, AS_KILL_AT = 10.0, 24, 150
AS_MIX = (("gold", 0.2), ("standard", 0.5), ("best_effort", 0.3))
# the card's autoscaler drill: a generate stream the queue watermarks
# answer with a second LM replica
AS_LM_REQUESTS, AS_LM_TOKENS, AS_LM_CLIENTS = 96, 48, 16
AS_LM_PROMPTS = (16, 128)  # prompt lengths, drawn uniformly


def send_retrying(port, path, body, deadline_s=6.0, retries=6):
    """tools/loadgen's retry rule: a 429, 503 or network error retries
    (Retry-After honoured, within the request's deadline), anything
    else is final. Returns (status, reply, attempts)."""
    t_end = time.monotonic() + deadline_s
    attempts = 0
    while True:
        attempts += 1
        try:
            code, reply, hdrs = http(port, path, body)
        except OSError as e:
            code, reply, hdrs = 0, {"error": repr(e)}, {}
        if code == 200 or code not in (0, 429, 503) \
                or attempts > retries or time.monotonic() >= t_end:
            return code, reply, attempts
        wait = float(hdrs.get("Retry-After", 0) or 0.02)
        time.sleep(max(0.0, min(wait, t_end - time.monotonic())))


def closed_loop(port, bodies, conc):
    """``bodies`` from ``conc`` threads, each sending its next as its
    last returns; returns (statuses, wall seconds)."""
    codes, lock, todo = [], threading.Lock(), list(range(len(bodies)))

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop()
            c = send_retrying(port, "/v1/predict", bodies[i],
                              deadline_s=60.0)[0]
            with lock:
                codes.append(c)

    threads = [threading.Thread(target=client) for _ in range(conc)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    return codes, time.perf_counter() - t0


def lm_predicts(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{"model": "lm", "inputs": rng.integers(
        0, V, (1, CTL_PREDICT_T)).astype(float).tolist()}
            for _ in range(n)]


def lm_fleet(factory, n, **router_kw):
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
    from deeplearning4j_tpu_torch.serving.router import Router
    fleet = ReplicaFleet(factory, n=n, server_kwargs=dict(
        wait_ms=1.0, max_batch_size=8, queue_limit=64, slots=SLOTS,
        capacity=CAPACITY, page_size=PAGE)).start()
    kw = dict(probe_interval_s=0.05, probe_timeout_s=0.5,
              attempt_timeout_s=10.0, request_timeout_s=60.0,
              hedge_after_s=None, sample_rate=1.0)
    kw.update(router_kw)
    return fleet, Router(fleet, **kw).start()


def collector_drill(net, card):
    """bench.py's observability_overhead on the LM: the same predict
    burst through a 4-replica fleet with no collector and with a
    FleetCollector scraping every member each second, in alternating
    pairs. The QPS cost is host-timed: printed, not asserted."""
    import statistics
    import numpy as np
    from deeplearning4j_tpu_torch.observability.fleetobs import (
        FleetCollector)
    fleet, router = lm_fleet(lambda: {"lm": net}, ROLL_REPLICAS,
                             sample_rate=0.01)
    bodies = lm_predicts(OBS_REQUESTS, seed=4)
    try:
        codes, _ = closed_loop(router.port, bodies[:64], OBS_CONC)  # warm
        assert set(codes) == {200}, set(codes)

        def run(with_collector):
            col = None
            if with_collector:
                col = FleetCollector(fleet=fleet, router=router,
                                     interval_s=1.0, port=0).start()
                router.attach_fleet_health(col.fleet_health)
            try:
                codes, wall = closed_loop(router.port, bodies, OBS_CONC)
                scrapes = None if col is None else \
                    col.registry.get("fleet_scrapes_total").value
            finally:
                if col is not None:
                    router.attach_fleet_health(None)
                    col.stop()
            assert set(codes) == {200}, set(codes)
            return len(codes) / wall, scrapes

        ratios, on, off, scrapes = [], [], [], []
        for i in range(OBS_RUNS):
            order = (False, True) if i % 2 == 0 else (True, False)
            qps = {}
            for w in order:
                qps[w], s = run(w)
                if w:
                    scrapes.append(s)
            on.append(qps[True])
            off.append(qps[False])
            ratios.append(qps[True] / qps[False])
    finally:
        router.stop()
        fleet.stop(drain=False, timeout=10.0)
    rel = statistics.median(ratios)
    # what one predict's forward costs alone (host clock, synchronized)
    x = np.zeros((1, CTL_PREDICT_T), np.float32)
    fwd_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        net.output(x).cpu()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"one LM predict's forward alone (1 x {CTL_PREDICT_T} ids, host "
        f"clock, output copied back): median {statistics.median(fwd_ms):.2f}"
        f" ms over 20 warm calls")
    log(f"collector drill ({card}, host clock): {OBS_RUNS} paired runs of "
        f"{OBS_REQUESTS} LM predicts (1 x {CTL_PREDICT_T} ids) from "
        f"{OBS_CONC} clients over {ROLL_REPLICAS} replicas: scraped "
        f"{statistics.median(on):.1f} q/s ({scrapes} scrapes a run), "
        f"unscraped {statistics.median(off):.1f} q/s; ratio {rel:.4f}, "
        f"cost {100 * max(0.0, 1 - rel):.2f}% (bench.py's bar "
        f"{100 * OBS_BAR:.0f}%; printed, not asserted)")


class TierDriver:
    """Background predicts in each tier, paced, with per-tier outcomes
    and the running minimum of UP capacity (bench.py's rollout_soak)."""

    def __init__(self, port, fleet, bodies, pace_s=0.004):
        self.port, self.fleet, self.bodies = port, fleet, bodies
        self.pace_s = pace_s
        self.counts = {t: {"ok": 0, "dropped": 0, "nan": 0} for t in TIERS}
        self.min_capacity = 10 ** 9
        self._stop = threading.Event()
        self._threads = []

    def _loop(self, tier):
        import numpy as np
        from deeplearning4j_tpu_torch.serving.fleet import UP
        i = 0
        while not self._stop.is_set():
            body = dict(self.bodies[i % len(self.bodies)], tier=tier)
            i += 1
            try:
                code, reply, _ = http(self.port, "/v1/predict", body)
            except OSError:
                code, reply = 0, {}
            c = self.counts[tier]
            if code == 200:
                out = np.asarray(reply["outputs"], np.float64)
                c["ok" if np.isfinite(out).all() else "nan"] += 1
            else:
                c["dropped"] += 1
            self.min_capacity = min(self.min_capacity, sum(
                1 for r in self.fleet.snapshot() if r.fleet_state == UP))
            time.sleep(self.pace_s)

    def __enter__(self):
        for tier in TIERS:
            th = threading.Thread(target=self._loop, args=(tier,),
                                  daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30)


def rollout_drill(net, candidate, card):
    """bench.py's rollout_soak on 4 in-process LM replicas behind the
    router and collector: a good candidate (the same weights written to
    a zip and restored) promoted, then a candidate poisoned by the
    seeded ``serving.rollout`` ``bad_version`` fault caught by shadow
    scoring and rolled back. Zero gold drops, UP capacity never below
    4, one incident bundle from the bad run."""
    import shutil
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.observability.fleetobs import (
        FleetCollector)
    from deeplearning4j_tpu_torch.serving.rollout import RolloutController

    bodies = lm_predicts(64, seed=6)

    def run(bad, inc_dir):
        fleet, router = lm_fleet(lambda: {"lm": net}, ROLL_REPLICAS)
        col = FleetCollector(fleet=fleet, router=router, interval_s=0.25,
                             incident_min_interval_s=0.0,
                             incident_dir=inc_dir).start()
        rc = RolloutController(
            fleet, router, candidate_factory=lambda: {"lm": candidate},
            collector=col, canary_weight=0.25, shadow_sample=0.5,
            min_requests=40, warmup_requests=10, min_shadow_compared=10,
            gate_poll_s=0.1, drain_timeout_s=30.0, max_p99_ratio=50.0)
        router.attach_rollout(rc)
        if bad:
            chaos.install({"faults": [{"site": "serving.rollout",
                                       "kind": "bad_version",
                                       "at": [1]}]}, seed=23)
        try:
            with TierDriver(router.port, fleet, bodies) as drv:
                time.sleep(1.0)        # incumbent evidence first
                out = {}
                th = threading.Thread(
                    target=lambda: out.setdefault("s", rc.run()))
                th.start()
                th.join(timeout=300)
                if th.is_alive():
                    rc.abort("smoke watchdog")
                    th.join(timeout=60)
                time.sleep(0.5)
            versions = sorted(fleet.versions().values())
        finally:
            chaos.uninstall()
            col.stop()
            router.stop()
            fleet.stop(drain=False, timeout=10.0)
        st = out.get("s") or {}
        incidents = sorted(d for d in (os.listdir(inc_dir)
                                       if os.path.isdir(inc_dir) else [])
                           if d.startswith("incident-"))
        return st, drv, versions, incidents

    tmp = tempfile.mkdtemp(prefix="rollout-")
    try:
        good, gdrv, gver, ginc = run(False, os.path.join(tmp, "good"))
        bad, bdrv, bver, binc = run(True, os.path.join(tmp, "bad"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, st, drv, ver in (("good", good, gdrv, gver),
                               ("bad", bad, bdrv, bver)):
        log(f"rollout drill, {name} candidate ({card}): outcome "
            f"{st.get('outcome')} (gate {st.get('last_gate')}, holds "
            f"{st.get('holds')}) in "
            f"{st.get('finished_unix', 0) - st.get('started_unix', 0):.2f}"
            f" s; versions after {ver}; tiers {drv.counts}; UP capacity "
            f"never below {drv.min_capacity}")
        assert drv.counts["gold"]["dropped"] == 0, drv.counts
        assert drv.min_capacity >= ROLL_REPLICAS, drv.min_capacity
    assert good.get("outcome") == "promoted" and set(gver) == {2}, good
    assert bad.get("outcome") == "rolled_back" and set(bver) == {1}, bad
    assert bad.get("last_gate") == "shadow_mismatch", bad
    assert not ginc and len(binc) == 1, (ginc, binc)
    log(f"rollout drill: time to promoted "
        f"{good['finished_unix'] - good['started_unix']:.2f} s, time to "
        f"rolled back {bad['finished_unix'] - bad['started_unix']:.2f} s; "
        f"incident bundles: good {len(ginc)}, bad {binc}")


def open_loop(port, body_fn, rate_at, duration_s, conc, deadline_s=6.0,
              retries=6):
    """Arrivals at ``rate_at(t)`` requests a second for ``duration_s``,
    sent by ``conc`` workers with ``send_retrying``; per-tier counts."""
    times, t = [], 0.0
    while t < duration_s:
        times.append(t)
        t += 1.0 / rate_at(t)
    counts = {tier: {"sent": 0, "ok": 0, "failed": 0, "retries": 0}
              for tier, _ in AS_MIX}
    lock, nxt = threading.Lock(), [0]
    t0 = time.monotonic()

    def worker():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(times):
                return
            time.sleep(max(0.0, t0 + times[i] - time.monotonic()))
            body = body_fn(i)
            code, _, attempts = send_retrying(port, "/v1/predict", body,
                                              deadline_s, retries)
            with lock:
                c = counts[body["tier"]]
                c["sent"] += 1
                c["retries"] += attempts - 1
                c["ok" if code == 200 else "failed"] += 1

    threads = [threading.Thread(target=worker) for _ in range(conc)]
    for th in threads:
        th.start()
    return threads, counts


def autoscaler_drill(card):
    """bench.py's autoscaler_soak, shortened: sleep-based replicas (40
    ms a request, one at a time), bounds 1..3, a ~6x step of tiered
    load, a seeded ``serving.replica`` kill mid-spike. Prints seconds
    from SLO breach to recovery; no gold request may fail."""
    import numpy as np
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.observability.slo import (BurnWindow, SLO,
                                                            SLOMonitor)
    from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaFleet
    from deeplearning4j_tpu_torch.serving.router import Router

    class DelayModel:
        def output(self, x):
            time.sleep(0.04)
            return np.asarray(x)

    fleet = ReplicaFleet(lambda: {"default": DelayModel()}, n=1,
                         server_kwargs=dict(wait_ms=1.0, max_batch_size=1,
                                            queue_limit=6)).start()
    router = Router(fleet, probe_interval_s=0.1, probe_timeout_s=0.5,
                    attempt_timeout_s=3.0, request_timeout_s=8.0,
                    hedge_after_s=None, sample_rate=0.0).start()
    slos = SLOMonitor(router.registry, [SLO(
        name="router_p_latency", objective=0.8, threshold_s=0.1,
        metric="router_latency_seconds", labels={"route": "/v1/predict"},
        window_s=30.0, windows=[BurnWindow(short_s=1.5, long_s=4.0,
                                           factor=1.5)])],
        min_eval_interval_s=0.2)
    scaler = Autoscaler(fleet, router, slos=slos, registry=router.registry,
                        min_replicas=1, max_replicas=3,
                        tick_interval_s=0.25, queue_high=3.0,
                        queue_low=0.25, up_consecutive=2,
                        down_consecutive=10_000, up_cooldown_s=1.5,
                        down_cooldown_s=60.0).start()
    chaos.install({"faults": [{"site": "serving.replica", "kind": "kill",
                               "at": [AS_KILL_AT],
                               "args": {"replica": 0}}]}, seed=99)
    rng = np.random.default_rng(7)
    tiers = [name for name, _ in AS_MIX]
    draw = rng.choice(len(tiers), 4096, p=[p for _, p in AS_MIX])
    low, high, at = AS_PROFILE
    marks = {"breach": None, "recover": None}
    try:
        threads, counts = open_loop(
            router.port, lambda i: {"model": "default",
                                    "inputs": [[float(i % 7), 1.0]],
                                    "tier": tiers[draw[i % 4096]]},
            lambda t: high if t >= at else low, AS_DURATION, AS_CONC)
        t0 = time.monotonic()
        while time.monotonic() < t0 + AS_DURATION + 30.0:
            b = slos.any_breached()
            now = time.monotonic() - t0
            if b and marks["breach"] is None:
                marks["breach"] = now
            if not b and marks["breach"] is not None:
                marks["recover"] = now
                break
            time.sleep(0.1)
        for th in threads:
            th.join(timeout=60)
        final = fleet.size()
        ups = router.registry.get("autoscaler_scale_events_total",
                                  labels={"direction": "up"})
    finally:
        chaos.uninstall()
        scaler.stop(wait_retires=False)
        router.stop()
        fleet.stop(drain=False, timeout=5.0)
    rec = (None if None in marks.values()
           else marks["recover"] - marks["breach"])
    log(f"autoscaler drill (host clock): step {low:g} -> {high:g} q/s at "
        f"t = {at:g} s for {AS_DURATION:g} s, replica 0 killed at request "
        f"{AS_KILL_AT}: SLO breach at "
        + ("never" if marks["breach"] is None
           else f"{marks['breach']:.2f} s")
        + ", recovered " + ("not within the window" if rec is None
                            else f"{rec:.2f} s later")
        + f"; scale-ups {0 if ups is None else int(ups.value)}, replicas "
        f"at the end {final}; tiers {counts}")
    assert counts["gold"]["failed"] == 0, counts


def autoscaler_card_drill(net, da, card):
    """The queue watermarks grow a second full-width LM replica (its
    weights restored from a zip onto the card) under a generate stream,
    then retire it with drain. Every request must return 200 with the
    ids one server gives for it (or part from them only at a near tie
    of the plain-decode reference)."""
    import shutil
    import numpy as np
    from deeplearning4j_tpu_torch.serving.autoscaler import Autoscaler
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    rng = np.random.default_rng(9)
    bodies = [{"model": "lm", "prompt": rng.integers(
        0, V, int(n)).tolist(), "n_tokens": AS_LM_TOKENS}
              for n in rng.integers(AS_LM_PROMPTS[0], AS_LM_PROMPTS[1] + 1,
                                    AS_LM_REQUESTS)]
    registry = ModelRegistry()
    registry.register("lm", net)
    single = ModelServer(registry, slots=SLOTS, capacity=CAPACITY,
                         page_size=PAGE).start()
    try:
        ref, _ = burst(single.port, "/v1/generate", bodies)
    finally:
        single.stop(drain=True)
    tmp = tempfile.mkdtemp(prefix="scale-")
    path = os.path.join(tmp, "lm.zip")
    write_model(net, path)
    boots = []

    def factory():
        if not boots:
            boots.append(0.0)
            return {"lm": net}
        t0 = time.perf_counter()
        model = restore_model(path, device=CARD)
        boots.append(time.perf_counter() - t0)
        return {"lm": model}

    fleet, router = lm_fleet(factory, 1, attempt_timeout_s=300.0,
                             request_timeout_s=600.0, sample_rate=0.0)
    scaler = Autoscaler(fleet, router, min_replicas=1, max_replicas=2,
                        tick_interval_s=0.25, queue_high=4.0,
                        queue_low=0.5, up_consecutive=2,
                        down_consecutive=8, up_cooldown_s=1.0,
                        down_cooldown_s=1.0, drain_timeout_s=300.0)
    grown = {}
    grow = fleet.grow

    def timed_grow(*a, **kw):
        t0 = time.perf_counter()
        r = grow(*a, **kw)
        grown["boot_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        code, _, _ = http(r.port, "/v1/generate",
                          dict(bodies[0], n_tokens=8))
        grown["first_ms"] = (time.perf_counter() - t1) * 1e3
        grown["first_code"] = code
        grown["rid"] = r.id
        return r

    fleet.grow = timed_grow
    replies = [None] * len(bodies)
    try:
        scaler.start()
        lock, todo = threading.Lock(), list(range(len(bodies)))

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    i = todo.pop(0)
                replies[i] = http(router.port, "/v1/generate", bodies[i])

        threads = [threading.Thread(target=client)
                   for _ in range(AS_LM_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        t_end = time.monotonic() + 300
        while "first_code" not in grown and time.monotonic() < t_end:
            time.sleep(0.1)              # a scale-up still booting
        peak = 1 + ("rid" in grown)
        while fleet.size() > 1 and time.monotonic() < t_end:
            time.sleep(0.1)
        final = fleet.size()
        events = {d: router.registry.get(
            "autoscaler_scale_events_total", labels={"direction": d})
            for d in ("up", "down")}
    finally:
        scaler.stop(wait_retires=True)
        router.stop()
        fleet.stop(drain=False, timeout=30.0)
        shutil.rmtree(tmp, ignore_errors=True)
    assert all(r is not None and r[0] == 200 for r in replies), \
        [None if r is None else r[:2] for r in replies]
    compared = 0
    for body, (_, reply, _), (_, alone, _) in zip(bodies, replies, ref):
        if reply["ids"] == alone["ids"]:
            compared += len(reply["ids"])
        else:
            compared += check_greedy(net, da, body["prompt"], reply["ids"],
                                     n_tokens=AS_LM_TOKENS)
    log(f"autoscaler on the card ({card}): {AS_LM_REQUESTS} /v1/generate "
        f"({AS_LM_TOKENS} tokens) from {AS_LM_CLIENTS} clients through "
        f"the router in {wall:.2f} s; grew to {peak} replica(s) (the "
        f"grown replica booted in {grown.get('boot_s', float('nan')):.2f} "
        f"s, its weights restored in "
        f"{boots[-1] if len(boots) > 1 else float('nan'):.2f} s; its first "
        f"request {grown.get('first_ms', float('nan')):.1f} ms, status "
        f"{grown.get('first_code')}); retired back to {final} with drain; "
        f"scale events up "
        f"{0 if events['up'] is None else events['up'].value:g}, down "
        f"{0 if events['down'] is None else events['down'].value:g}; "
        f"every reply 200, greedy ids vs one server's: {compared} of "
        f"{AS_LM_REQUESTS * AS_LM_TOKENS} compared and equal")
    assert peak == 2 and grown.get("first_code") == 200, grown
    assert final == 1, final


def fleet_control_phase(attn, da, card):
    """The control loops: the collector's cost, the canary rollout on
    the full-width LM (depth FLEET_LAYERS), the autoscaler's drill and
    the autoscaler growing and retiring an LM replica on the card.
    Returns the forward and decode kernels' launches on this path."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    conf = lm_config(layers=FLEET_LAYERS)
    net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                            device=CARD).init(seed=0)
    tmp = tempfile.mkdtemp(prefix="candidate-")
    path = os.path.join(tmp, "lm.zip")
    write_model(net, path)         # the good candidate: the same weights
    candidate = restore_model(path, device=CARD)
    os.remove(path)
    os.rmdir(tmp)
    attn.flash_attention_fwd_cuda.launches = 0        # this path only
    da.decode_attention_cuda.launches = 0
    drills = {}
    for name, drill, args in (
            ("collector", collector_drill, (net, card)),
            ("rollout", rollout_drill, (net, candidate, card)),
            ("autoscaler", autoscaler_drill, (card,)),
            ("autoscaler_card", autoscaler_card_drill, (net, da, card))):
        t0 = time.perf_counter()
        drill(*args)
        drills[name] = round(time.perf_counter() - t0, 1)
    del candidate
    log(f"fleet_control drills, wall s: {json.dumps(drills)}")
    fwd, dec = (attn.flash_attention_fwd_cuda.launches,
                da.decode_attention_cuda.launches)
    log(f"fleet_control launches: flash_attention_fwd {fwd}, "
        f"decode_attention {dec}")
    assert fwd > 0 and dec > 0, (fwd, dec)
    return fwd, dec


PS_N_IN, PS_N_OUT, PS_HIDDEN = 8, 3, 16   # bench.py:2678-2680
PS_BATCHES, PS_BATCH = 24, 16
PS_LR, PS_EPOCH_CAP, PS_WORKERS = 0.2, 40, 3   # bench.py:2555, :2680
PS_STALENESS = (0, 4, 16, None)           # the frontier, bench.py:2811
PS_LM_LAYERS = 2         # the LM's depth here: two workers' models fit
PS_LM_WORKERS, PS_LM_STEPS, PS_LM_B = 2, 3, 8
PS_LM_LR = 1e-2          # the server's SGD rate on the LM's pushes
PS_CHECK_B = 2           # rows of the one push held against the CPU
PS_CLI_EPOCHS = 2        # train-ps launcher: 3 workers x 8 batches x 2
PS_CLI_CHAOS = {"faults": [
    {"site": "ps.push.drop", "kind": "drop", "at": [5]},
    {"site": "ps.server.restart", "kind": "restart", "at": [25]}]}


def ps_net(seed=0, device=None):
    """The ps_async_training leg's model: 8 -> 16 relu -> 3 softmax."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": seed},
           "input_type": {"kind": "ff", "size": PS_N_IN},
           "layers": [{"@type": "DenseLayer", "n_out": PS_HIDDEN,
                       "activation": "relu"},
                      {"@type": "OutputLayer", "n_out": PS_N_OUT}],
           "preprocessors": {}}
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device=device or CARD).init(seed=seed)


def ps_data():
    """The leg's 24 batches of 16 (cluster-shifted gaussians, seed 0,
    bench.py:2694-2701) as numpy (x, class) pairs."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = []
    for _ in range(PS_BATCHES):
        c = rng.integers(0, PS_N_OUT, PS_BATCH)
        x = (rng.normal(size=(PS_BATCH, PS_N_IN))
             + c[:, None] * 1.5).astype(np.float32)
        out.append((x, c))
    return out


def ps_eval(model, batches):
    """Mean eval loss of ``model`` over device batch tuples: one host
    read."""
    import torch
    with torch.no_grad():
        return float(torch.stack([model._loss(b, training=False)[0]
                                  for b in batches]).mean())


def ps_leg(card):
    """bench.py's ``ps_async_training`` leg at its own size on the card:
    a synchronous SGD baseline, then 3 PS worker threads at
    max_staleness 0 / 4 / 16 / unbounded to the epoch cap, a monitor
    thread recording when the server's params first reach the target
    (80% of the baseline's loss drop)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
    from deeplearning4j_tpu_torch.parallel.paramserver import (
        ParameterServer, PSClient, PSWorker)

    data = ps_data()
    batches = [DataSet(x, np.eye(PS_N_OUT, dtype=np.float32)[c])
               for x, c in data]
    ev_model = ps_net(0)
    ev_batches = [ev_model._batch_tuple(ds) for ds in batches]

    def eval_loss(params):
        ev_model.set_params(params)
        return ps_eval(ev_model, ev_batches)

    # synchronous baseline: plain SGD on exact gradients, on the card
    sync = ps_net(0)
    init_loss = eval_loss(sync.params)
    sync._gradients(ev_batches[0])          # first call outside the clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curve = []
    for _ in range(PS_EPOCH_CAP):
        for b in ev_batches:
            _, grads, _ = sync._gradients(b)
            with torch.no_grad():
                for p, g in zip(tree_leaves(sync.params),
                                tree_leaves(grads)):
                    p.sub_(PS_LR * g)
        curve.append((time.perf_counter() - t0, eval_loss(sync.params)))
    sync_total = time.perf_counter() - t0
    sync_final = curve[-1][1]
    target = init_loss - 0.8 * (init_loss - sync_final)
    sync_ttl = next((t for t, loss in curve if loss <= target), None)

    def run_ps(max_staleness):
        m0 = ps_net(0)
        server = ParameterServer(m0.params, lr=PS_LR,
                                 max_staleness=max_staleness).start()
        crossed = [None]
        stop = threading.Event()
        stats = [None] * PS_WORKERS
        errors = []
        t0 = time.perf_counter()

        def monitor():
            while not stop.wait(0.05):
                if crossed[0] is None \
                        and eval_loss(server.params_tree()) <= target:
                    crossed[0] = time.perf_counter() - t0

        def work(i):
            model = m0 if i == 0 else ps_net(i)
            client = PSClient(server.address)
            try:
                stats[i] = PSWorker(model, client,
                                    name=f"ps-leg-{i}").run(
                    batches[i::PS_WORKERS], epochs=PS_EPOCH_CAP)
            except BaseException as e:      # raised after the join
                errors.append(e)
            finally:
                client.close()

        mon = threading.Thread(target=monitor, name="ps-leg-mon",
                               daemon=True)
        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"ps-leg-{i}", daemon=True)
                   for i in range(PS_WORKERS)]
        mon.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        total = time.perf_counter() - t0
        stop.set()
        mon.join(10)
        try:
            assert not any(t.is_alive() for t in threads), "worker hung"
            if errors:
                raise errors[0]
            final = eval_loss(server.params_tree())
            if crossed[0] is None and final <= target:
                crossed[0] = total      # crossed between monitor ticks
            st = dict(server.stats)
        finally:
            server.stop()
        steps = sum(s["steps"] for s in stats)
        # every worker step produced exactly one push: applied, or
        # refused stale and folded back into the residual
        assert st["pushes_applied"] + st["pushes_stale"] == steps, \
            (max_staleness, st, steps)
        return {"max_staleness": max_staleness,
                "time_to_target_s": crossed[0], "total_s": total,
                "final_loss": final, "stale_rejects": st["pushes_stale"],
                "pushes_applied": st["pushes_applied"], "steps": steps}

    frontier = [run_ps(ms) for ms in PS_STALENESS]
    head = next(f for f in frontier if f["max_staleness"] == 4)
    assert head["time_to_target_s"] is not None, \
        f"s=4 never reached the target {target}: {head}"
    ttl = head["time_to_target_s"]
    log(f"ps_async_training ({card}; host clock; 3 worker threads, "
        f"{PS_BATCHES}x{PS_BATCH} batches, lr {PS_LR}, cap {PS_EPOCH_CAP} "
        f"epochs): init loss {init_loss:.6f}, target {target:.6f}; sync "
        f"SGD final {sync_final:.6f}, time to target {sync_ttl} s, total "
        f"{sync_total:.3f} s")
    for f in frontier:
        log(f"  s={f['max_staleness']}: time to target "
            f"{f['time_to_target_s']} s, total {f['total_s']:.3f} s, final "
            f"loss {f['final_loss']:.6f}, pushes applied "
            f"{f['pushes_applied']}, stale rejects {f['stale_rejects']}, "
            f"steps {f['steps']}")
    log(f"  vs_baseline (sync / async s=4 time to target): "
        f"{sync_ttl / ttl if sync_ttl else None}")


def ps_lm(attn, card):
    """PS workers training the LM at full width (depth PS_LM_LAYERS) on
    the card: PS_LM_WORKERS threads, max_staleness 4, PS_LM_STEPS steps
    each at B=PS_LM_B, the attention kernels counted; then one push of
    a card worker held against the CPU's. Returns the launches."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.parallel.paramserver import (
        ParameterServer, PSClient, PSWorker)

    cfg = lm_config()
    cfg["layers"] = (cfg["layers"][:1 + PS_LM_LAYERS]
                     + cfg["layers"][-1:])

    def lm(seed, device=None):
        return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                                 device=device or CARD).init(seed=seed)

    rng = np.random.default_rng(0)
    data = []
    for _ in range(PS_LM_WORKERS * PS_LM_STEPS):
        ids = rng.integers(0, V, (PS_LM_B, T)).astype(np.float32)
        y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (PS_LM_B, T))]
        data.append(DataSet(ids, y))
    m0 = lm(0)
    n_params = sum(p.numel() for p in m0.layer_params.parameters())
    server = ParameterServer(m0.params, lr=PS_LM_LR, max_staleness=4).start()
    ops = {"push": [], "pull": []}
    stats = [None] * PS_LM_WORKERS
    errors = []

    def timed_op(fn, what):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            ops[what].append(time.perf_counter() - t0)
            return out
        return call

    def work(i):
        model = m0 if i == 0 else lm(i)
        client = PSClient(server.address, op_timeout_s=60.0)
        client.push = timed_op(client.push, "push")
        client.pull = timed_op(client.pull, "pull")
        try:
            stats[i] = PSWorker(model, client, name=f"ps-lm-{i}").run(
                data[i::PS_LM_WORKERS], epochs=1)
        except BaseException as e:          # raised after the join
            errors.append(e)
        finally:
            client.close()

    for fn in (attn.flash_attention_fwd_cuda,
               attn.flash_attention_bwd_dq_cuda,
               attn.flash_attention_bwd_dkv_cuda):
        fn.launches = 0
    threads = [threading.Thread(target=work, args=(i,), name=f"ps-lm-{i}",
                                daemon=True)
               for i in range(PS_LM_WORKERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": attn.flash_attention_fwd_cuda.launches,
                "flash_attention_bwd_dq":
                    attn.flash_attention_bwd_dq_cuda.launches,
                "flash_attention_bwd_dkv":
                    attn.flash_attention_bwd_dkv_cuda.launches}
    try:
        assert not any(t.is_alive() for t in threads), "an LM worker hung"
        if errors:
            raise errors[0]
        st = dict(server.stats)
        params = server.params_tree()
    finally:
        server.stop()
    steps = sum(s["steps"] for s in stats)
    assert steps == PS_LM_WORKERS * PS_LM_STEPS, stats
    assert st["pushes_applied"] + st["pushes_stale"] == steps, st
    for name, n in launches.items():
        assert n == PS_LM_LAYERS * steps, (name, n)
    med = {k: sorted(v)[len(v) // 2] for k, v in ops.items()}
    log(f"ps LM ({card}; V={V} D={D_MODEL} L={PS_LM_LAYERS} H={HEADS} "
        f"T={T}, {n_params} parameters; {PS_LM_WORKERS} worker threads, "
        f"s=4, B={PS_LM_B}): {steps} steps in {wall:.3f} s (host clock), "
        f"{st['pushes_applied']} pushes applied, {st['pushes_stale']} "
        f"stale; push {n_params / 2**20:.2f} MiB of int8 codes (the "
        f"scales ride in the header), median {med['push']:.4f} s over "
        f"{len(ops['push'])}; pull {4 * n_params / 2**20:.2f} MiB f32, "
        f"median {med['pull']:.4f} s over {len(ops['pull'])}; last losses "
        + ", ".join(f"{s['last_loss']:.6f}" for s in stats)
        + "; launches " + ", ".join(f"{k} {n}" for k, n in launches.items()))

    # one push, card vs CPU: the same params and batch (B=PS_CHECK_B)
    ds = DataSet(data[0].features[:PS_CHECK_B], data[0].labels[:PS_CHECK_B])
    decoded = {}
    for device in (CARD, "cpu"):
        model = lm(0, device)
        model.set_params(params)
        worker = PSWorker(model, client=None)
        _, g_leaves = worker._gradients(ds)
        residual = [torch.zeros_like(g) for g in g_leaves]
        quantized, _ = worker.encode(g_leaves, residual)
        decoded[device] = quantized
        del model, worker, g_leaves, residual
    # one quantum: a code may move by one at a rounding boundary; the
    # two scales (absmax / 127) differ by what the absmaxes do, which
    # moves a decoded value by up to 127 times their difference. The
    # decoded values are compared in float64, where code x scale is exact
    worst, worst_limit = 0.0, 0.0
    for (qc, sc), (qh, sh) in zip(decoded[CARD], decoded["cpu"]):
        err = float(np.abs(qc.astype(np.float64) * float(sc)
                           - qh.astype(np.float64) * float(sh)).max())
        quantum = max(float(sc), float(sh))
        limit = quantum + 127 * abs(float(sc) - float(sh))
        assert err <= limit, (err, float(sc), float(sh))
        worst = max(worst, err / quantum)
        worst_limit = max(worst_limit, limit / quantum)
    log(f"one LM push at B={PS_CHECK_B}, card vs CPU (plain attention): "
        f"{len(decoded['cpu'])} leaves, worst decoded |diff| "
        f"{worst:.6f} quanta (limit: one quantum + 127 x the scales' "
        f"difference, at most {worst_limit:.6f} quanta)")
    return launches


def ps_cli(card):
    """``python -m deeplearning4j_tpu_torch train-ps`` as launcher on the
    card: 3 worker processes over the leg's data as CSV, one dropped push
    and one server restart from a chaos plan. Every process exits 0, the
    restart shows in the server's stats, every push is accounted for,
    and the saved model's loss is below the initial one."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)

    data = ps_data()
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="train-ps-") as tmp:
        model_zip = os.path.join(tmp, "m.zip")
        out_zip = os.path.join(tmp, "out.zip")
        csv = os.path.join(tmp, "d.csv")
        write_model(ps_net(0), model_zip)
        with open(csv, "w") as f:
            for x, c in data:
                for row, label in zip(x, c):
                    f.write(",".join(repr(float(v)) for v in row)
                            + f",{int(label)}\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch",
               "train-ps", "--model", model_zip, "--data", csv,
               "--label-index", str(PS_N_IN), "--classes", str(PS_N_OUT),
               "--batch-size", str(PS_BATCH), "--epochs",
               str(PS_CLI_EPOCHS), "--ps-workers", str(PS_WORKERS),
               "--lr", str(PS_LR), "--max-staleness", "4",
               "--save-every", "10", "--output", out_zip,
               "--device", CARD, "--chaos", json.dumps(PS_CLI_CHAOS)]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=tmp, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        try:
            out = proc.communicate(timeout=300)[0].decode()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, out[-4000:]
        steps = [int(m) for m in re.findall(
            r"train-ps worker \d+: (\d+) steps", out)]
        summary = re.search(
            r"train-ps: v(\d+) \((\d+) pushes applied, (\d+) duplicate, "
            r"(\d+) stale, (\d+) reaped, (\d+) restarts\)", out)
        assert len(steps) == PS_WORKERS and summary, out[-4000:]
        version, applied, dup, stale, reaped, restarts = map(
            int, summary.groups())
        drops = out.count("[chaos] dropping push")
        assert restarts == 1 and drops == 1, out[-4000:]
        # every step acknowledged: applied, a duplicate of an applied
        # one, or refused stale; a push applied just before the restart
        # dropped its connection is retried and refused against the
        # rolled-back server, so it may count twice (at most one a
        # worker)
        total = applied + dup + stale
        assert sum(steps) <= total <= sum(steps) + PS_WORKERS, \
            (steps, applied, dup, stale)
        batches = [DataSet(x, np.eye(PS_N_OUT, dtype=np.float32)[c])
                   for x, c in data]
        final, fresh = (restore_model(p, device=CARD)
                        for p in (out_zip, model_zip))
        loss_final = ps_eval(final, [final._batch_tuple(b) for b in batches])
        loss_fresh = ps_eval(fresh, [fresh._batch_tuple(b) for b in batches])
    assert loss_final < loss_fresh, (loss_final, loss_fresh)
    log(f"train-ps launcher ({card}): 3 worker processes, {sum(steps)} "
        f"steps in {wall:.3f} s of command (host clock, process starts "
        f"included); server v{version}, {applied} pushes applied, {dup} "
        f"duplicate, {stale} stale, {reaped} reaped, {restarts} restart, "
        f"{drops} push dropped; loss {loss_fresh:.6f} -> {loss_final:.6f}")


def ps_phase(attn, card):
    """The asynchronous parameter server (ROADMAP A8b): bench.py's
    ``ps_async_training`` leg at its own size, PS workers training the
    full-width LM through the attention kernels, and the ``train-ps``
    launcher's process topology under chaos. Returns the LM workers'
    kernel launches."""
    ps_leg(card)
    launches = ps_lm(attn, card)
    ps_cli(card)
    return launches


# ---- data parallelism (dp_phase): ranks as subprocesses of this script

DP_LEG_TOTAL = 192        # timed steps a configuration (bench.py:3062)
DP_LEG_KS = (1, 8)
DP_LEG_ROWS = 64          # the leg's global batch (bench.py:3056-3058)
DP_LM_LAYERS = 2          # the LM's depth here, as in ps_phase
DP_LM_B, DP_LM_STEPS = 8, 3
DP_RESNET_ROLLS = (4, 2)  # reordered dp=1 reruns: the step's own noise
DP_COMP_ROWS = 4          # rows a rank of the compressed check
DP_LOSS_BATCHES = 4       # the device-loss drill's batches, loss at the 2nd
DP_TIMEOUT_S = 420


def dp_leg_net(seed=1):
    """bench.py:3045's leg model: 32 -> 64 relu -> 64 relu -> 10, Adam
    1e-3."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": seed, "updater": updaters.adam(1e-3)},
           "input_type": {"kind": "ff", "size": 32},
           "layers": [{"@type": "DenseLayer", "n_out": 64,
                       "activation": "relu"},
                      {"@type": "DenseLayer", "n_out": 64,
                       "activation": "relu"},
                      {"@type": "OutputLayer", "n_out": 10}],
           "preprocessors": {}}
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device=CARD).init()


def dp_rows(n, seed=0, n_in=32, n_out=10):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, n)]
    return x, y


def dp_shard(*arrays):
    from deeplearning4j_tpu_torch.parallel.multihost import (
        local_batch_slice)
    sl = local_batch_slice(arrays[0].shape[0])
    return [a[sl] for a in arrays]


def dp_snapshot(net, what):
    """What a model's fit steps produced, flat by name: its parameters
    (``what="params"``) or Adam's moments (``"moments"``: ``mu/...``,
    ``nu/...``)."""
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    if what == "params":
        return _flatten(net.params)
    out = {}
    for k, v in _flatten(net.opt_state).items():
        parts = k.split("/")
        for moment in (".mu", ".nu"):
            if moment in parts:
                i = parts.index(moment)
                out[moment[1:] + "/" + "/".join(parts[i + 1:])] = v
    return out


def dp_part_leg(world, out):
    """The multichip_dp_scaling leg on this rank: dp x k steps/s, every
    program warmed, zero captures in the timed steady state. The first
    window after the warmup (k steps from the seed's init on the same
    64 global rows at every dp) is kept for the dp=2 vs dp=1 check."""
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observability.compile_watch import (
        install_global_watch)
    from deeplearning4j_tpu_torch.parallel.multihost import process_index
    stats = install_global_watch()
    ds = DataSet(*dp_shard(*dp_rows(DP_LEG_ROWS)))
    res = {}
    for k in DP_LEG_KS:
        m = dp_leg_net(seed=1)
        m.use_mesh(f"dp={world}")
        m.warmup(ds, steps_per_device_call=k)
        batches = [ds] * k
        m.fit_batches(batches, steps_per_device_call=k)
        if process_index() == 0:
            tag = os.path.join(out, f"leg_dp{world}_k{k}")
            _save_leaves(tag + "_m1", dp_snapshot(m, "moments"))
            _save_leaves(tag + "_p", dp_snapshot(m, "params"))
        for _ in range(max(2, 16 // k) - 1):
            m.fit_batches(batches, steps_per_device_call=k)
        ctx = m._mesh_ctx
        ctx.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with stats.zero_compile_scope(f"dp={world} k={k} steady state"):
            for _ in range(DP_LEG_TOTAL // k):
                m.fit_batches(batches, steps_per_device_call=k)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[f"dp{world}_k{k}_steps_per_sec"] = DP_LEG_TOTAL / dt
        res["reduce"] = ctx.reduce_route(m)
    return res


def dp_lm_net():
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = lm_config(updaters.adam(TRAIN_LR))
    cfg["layers"] = cfg["layers"][:1 + DP_LM_LAYERS] + cfg["layers"][-1:]
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device=CARD).init(seed=0)


# the norms of the tensor-parallel update (lm_tpn): a global-norm clip
# and a max_norm constraint on a Megatron dense pair (D -> D, tanh) ahead
# of the output layer; at init the pair's columns have norms near 1.0
TPN_CLIP, TPN_MAX_NORM = 1.0, 1.0
TPN_CLIP_REPS = 5          # timed runs of the clip alone (median)


def dp_lm_tpn_net():
    """dp_lm_net's LM under a global-norm gradient clip (TPN_CLIP), with
    a Megatron dense pair ahead of its output layer under a max_norm
    constraint (TPN_MAX_NORM): at tp=2 a COLUMN and a ROW split layer
    whose column norms cross the split or not. (The transformer block's
    MLP lives in the block's nested parameters, which a constraint does
    not reach in either package.)"""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = lm_config(updaters.adam(TRAIN_LR))
    cfg["global"]["gradient_clip"] = {"type": "norm", "v": TPN_CLIP}
    dense = {"@type": "DenseLayer", "n_out": D_MODEL, "activation": "tanh",
             "constraints": [{"type": "max_norm",
                              "max_norm": TPN_MAX_NORM}]}
    cfg["layers"] = (cfg["layers"][:1 + DP_LM_LAYERS] + [dense, dense]
                     + cfg["layers"][-1:])
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device=CARD).init(seed=0)


def tpn_clip_ms(net):
    """ms of the step's global-norm clip alone on gradients shaped like
    ``net``'s parameters (its squared sums and, under tp, their one
    all-reduce over the model group): the median of TPN_CLIP_REPS runs,
    the ranks starting each together."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.nn.conf.updaters import (
        clip_by_global_norm)
    from deeplearning4j_tpu_torch.parallel import tensor_parallel
    from deeplearning4j_tpu_torch.util.tree import tree_copy
    grads = tree_copy(net.params)
    clip = clip_by_global_norm(TPN_CLIP)
    ms = []
    for _ in range(TPN_CLIP_REPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with tensor_parallel.sharded_norms(net), torch.no_grad():
            clip.update(grads, {})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _save_leaves(path, leaves):
    """A flat dict of arrays as one float32 .npy and its keys."""
    import numpy as np
    keys = sorted(leaves)
    np.save(path + ".npy", np.concatenate(
        [np.asarray(leaves[k], np.float32).reshape(-1) for k in keys]))
    with open(path + ".json", "w") as f:
        json.dump([[k, list(np.shape(leaves[k]))] for k in keys], f)


def _load_leaves(path):
    import numpy as np
    flat = np.load(path + ".npy")
    with open(path + ".json") as f:
        keys = json.load(f)
    out, off = {}, 0
    for k, shape in keys:
        n = int(np.prod(shape)) if shape else 1
        out[k] = flat[off:off + n].reshape(shape)
        off += n
    return out


def dp_part_lm(world, out):
    """The LM at full width, depth DP_LM_LAYERS: DP_LM_STEPS Adam steps
    through ``fit`` on a global batch of DP_LM_B, this rank's rows; what
    they produced (parameters and Adam's moments), the attention
    kernels' launches, the step times, the reduce's bytes and time."""
    import hashlib
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.multihost import process_index
    net = dp_lm_net()
    rng = np.random.default_rng(0)          # as train_phase
    ids = rng.integers(0, V, (DP_LM_B, T)).astype("float32")
    y = np.eye(V, dtype="float32")[rng.integers(0, V, (DP_LM_B, T))]
    ds = DataSet(*dp_shard(ids, y))
    net.use_mesh(f"dp={world}")
    ctx = net._mesh_ctx
    kernels = (attn.flash_attention_fwd_cuda,
               attn.flash_attention_bwd_dq_cuda,
               attn.flash_attention_bwd_dkv_cuda)
    for fn in kernels:                     # the dp path only
        fn.launches = 0
    step_ms, losses = [], []
    collectives.reset_stats()
    tag = os.path.join(out, f"lm_dp{world}")
    for step in range(DP_LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(net.score_value))
        if process_index() == 0:
            _save_leaves(f"{tag}_m{step + 1}", dp_snapshot(net, "moments"))
    launches = {"flash_attention_fwd": kernels[0].launches,
                "flash_attention_bwd_dq": kernels[1].launches,
                "flash_attention_bwd_dkv": kernels[2].launches}
    in_step_s = collectives.STATS["dp"]["seconds"]
    # the bucket's all-reduce alone: loss + every gradient, float32
    n = 1 + sum(p.numel() for p in net.parameters())
    bucket = torch.zeros(n, device=CARD)
    reduce_ms = []
    for _ in range(3):
        ctx.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.all_reduce_(bucket)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    snap = {**dp_snapshot(net, "params"), **dp_snapshot(net, "moments")}
    digest = hashlib.sha256(b"".join(
        np.ascontiguousarray(snap[k]).tobytes()
        for k in sorted(snap))).hexdigest()
    if process_index() == 0:
        _save_leaves(tag + "_p", dp_snapshot(net, "params"))
    return {"step_ms": step_ms, "losses": losses, "launches": launches,
            "bucket_bytes": 4 * n, "reduce_ms": reduce_ms,
            "in_step_reduce_s": in_step_s, "digest": digest,
            "reduce": ctx.reduce_route(net)}


def dp_hold(got, ref, snaps, steps, lr):
    """dp=2 (the files ``got_*``) against dp=1 (``ref_*``) after the
    same ``fit`` steps from the same init on the same global rows. Fails
    unless

    - Adam's moments ``mu`` and ``nu`` after each of ``snaps`` fit
      calls (the mean gradient every step applied, weighted, and its
      square: a sum where a mean belongs doubles ``mu``) are each within
      GRAD_RTOL of their tensor's largest entry;
    - the parameters after the calls are too, over the entries whose
      moments agreed to GRAD_RTOL of their own size after every call.
      Adam moves an entry by lr * mu / (sqrt(nu) + eps) a step: where a
      gradient is at the rounding level of its tensor, or changes sign
      so that ``mu`` cancels, the two runs move it differently, by up to
      ``lr`` a step, which is the bound the other entries are held to.

    Returns (the worst relative error of the moments, of the held
    parameters, the entries not held and their largest difference)."""
    import numpy as np
    worst_m, held = 0.0, {}
    for t in range(1, snaps + 1):
        m_ref = _load_leaves(f"{ref}_m{t}")
        m_got = _load_leaves(f"{got}_m{t}")
        for k, a in m_ref.items():
            diff = np.abs(m_got[k] - a)
            scale = float(np.abs(a).max())
            e = float(diff.max())
            assert e <= GRAD_RTOL * scale, (t, k, e, scale)
            worst_m = max(worst_m, e / max(scale, 1e-30))
            name = k.split("/", 1)[1]
            ok = diff <= GRAD_RTOL * np.abs(a)
            held[name] = held[name] & ok if name in held else ok
        del m_ref, m_got
    p_ref, p_got = _load_leaves(f"{ref}_p"), _load_leaves(f"{got}_p")
    worst_p, loose, loose_max = 0.0, 0, 0.0
    for k, a in p_ref.items():
        diff = np.abs(p_got[k] - a)
        scale = float(np.abs(a).max())
        mask = held[k]
        e = float(diff[mask].max()) if mask.any() else 0.0
        assert e <= GRAD_RTOL * scale, (k, e, scale)
        worst_p = max(worst_p, e / max(scale, 1e-30))
        if not mask.all():
            loose += int((~mask).sum())
            loose_max = max(loose_max, float(diff[~mask].max()))
    assert loose_max <= 2 * lr * steps, loose_max
    return worst_m, worst_p, loose, loose_max


def dp_part_resnet(world, out):
    """One ResNet50 step at cnn_phase's card-vs-CPU input (B=CHECK_B,
    CHECK_HW x CHECK_HW, nesterovs) over the mesh: the parameter update
    and the new batch-norm state; at dp=1 also the same step on the
    rows reordered (the step's own rounding noise)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.parallel.multihost import process_index
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (CHECK_B, CHECK_HW, CHECK_HW, 3)).astype("float32")
    y = np.eye(RESNET_CLASSES, dtype="float32")[
        rng.integers(0, RESNET_CLASSES, CHECK_B)]
    zm = zoo.ResNet50(n_classes=RESNET_CLASSES,
                      input_shape=(CHECK_HW, CHECK_HW, 3),
                      updater=updaters.nesterovs(0.1, 0.9))
    init = zm.init(device="cpu")
    p0 = _flatten(init.params)
    res = {}
    for roll in (0,) + (DP_RESNET_ROLLS if world == 1 else ()):
        net = ComputationGraph(zm.conf(), device=CARD)
        net.set_params(init.params)
        net.state = {n: {k: v.to(CARD) for k, v in s.items()}
                     for n, s in init.state.items()}
        net._build_optimizer()
        xs, ys = dp_shard(np.roll(x, roll, axis=0), np.roll(y, roll, axis=0))
        t0 = time.perf_counter()
        net.fit(DataSet(xs, ys), mesh_spec=f"dp={world}")
        torch.cuda.synchronize()
        leaves = {"update/" + k: v - p0[k]
                  for k, v in _flatten(net.params).items()}
        leaves.update({"state/" + k: v
                       for k, v in _flatten(net.state).items()})
        if process_index() == 0:
            _save_leaves(os.path.join(out, f"resnet_dp{world}_r{roll}"),
                         leaves)
        res[f"roll{roll}_s"] = time.perf_counter() - t0
        res["loss"] = float(net.score_value)
        res["reduce"] = net._mesh_ctx.reduce_route(net)
        del net
    return res


def dp_comp_net():
    """__graft_entry__.py's compressed-reduce dryrun model: 16 -> 32
    tanh -> 10, SGD 0.1, seed 7."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    cfg = {"format_version": 1, "network_type": "MultiLayerNetwork",
           "global": {"seed": 7, "updater": updaters.sgd(0.1)},
           "input_type": {"kind": "ff", "size": 16},
           "layers": [{"@type": "DenseLayer", "n_out": 32,
                       "activation": "tanh"},
                      {"@type": "OutputLayer", "n_out": 10}],
           "preprocessors": {}}
    return MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                             device=CARD).init()


def dp_part_compressed(world, out):
    """dp=N with the int8 + EF reduce (threshold 1e-4) against the
    full-precision reduce: 3 epochs of one batch of DP_COMP_ROWS rows a
    rank (the JAX package's dryrun, __graft_entry__.py:135-173)."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    n = DP_COMP_ROWS * world
    x = np.random.default_rng(5).normal(0, 1, (n, 16)).astype("float32")
    y = np.eye(10, dtype="float32")[
        np.random.default_rng(6).integers(0, 10, n)]
    batch = DataSet(*dp_shard(x, y))
    losses = {}
    for name, comp in (("plain", None), ("int8", {"threshold": 1e-4})):
        net = dp_comp_net()
        pw = ParallelWrapper(net, build_mesh(MeshSpec(data=world)),
                             prefetch_buffer=0, dcn_compression=comp)
        pw.fit(ListDataSetIterator([batch]), epochs=3)
        losses[name] = float(net.score_value)
        losses[name + "_describe"] = pw.describe()["reduce"]
    return losses


def dp_part_loss(world, out):
    """One ``parallel.device`` loss drill: the last rank lost at the 2nd
    batch, the mesh shrunk to the largest power of two of the
    survivors, the steps going on there."""
    import numpy as np
    from deeplearning4j_tpu_torch import chaos
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.observability.registry import REGISTRY
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    x, y = dp_rows(8 * world * DP_LOSS_BATCHES, seed=3)
    net = dp_leg_net(seed=2)
    pw = ParallelWrapper(net, build_mesh(MeshSpec(data=world)),
                         prefetch_buffer=0)
    before = REGISTRY.snapshot().get("elastic_mesh_shrinks_total", 0.0)
    chaos.install({"faults": [{"site": "parallel.device", "kind": "loss",
                               "at": [2]}]}, seed=11)
    trained = []
    try:
        for i in range(DP_LOSS_BATCHES):
            rows = slice(i * 8 * world, (i + 1) * 8 * world)
            trained.append(pw._train_batch(DataSet(*dp_shard(x[rows],
                                                             y[rows]))))
    finally:
        chaos.uninstall()
    shrinks = REGISTRY.snapshot().get("elastic_mesh_shrinks_total",
                                      0.0) - before
    return {"trained": trained, "dp_after": pw.mesh.size,
            "shrinks": shrinks, "iterations": net.iteration_count,
            "loss": float(net.score_value) if pw.active else None,
            "active": pw.active}


DP_PARTS = {"leg": dp_part_leg, "lm": dp_part_lm, "resnet": dp_part_resnet,
            "compressed": dp_part_compressed, "loss": dp_part_loss}


def dp_rank_main(out, parts):
    """One rank of dp_phase: ``python3 chip_smoke.py dp-rank DIR PART...``
    with the multihost variables set. Writes DIR/dp{N}_rank{i}.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.parallel.multihost import (
        initialize_distributed, process_count, process_index)
    assert initialize_distributed(device=CARD)
    rank, world = process_index(), process_count()
    res = {"backend": dist.get_backend(), "card": card_name(),
           "device": torch.cuda.get_device_name(0)}
    for part in parts:
        t0 = time.perf_counter()
        res[part] = DP_PARTS[part](world, out)
        res[part + "_s"] = time.perf_counter() - t0
        log(f"dp={world} rank {rank}: {part} {res[part + '_s']:.1f} s")
    with open(os.path.join(out, f"dp{world}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# what run_ranks and the streaming leg's client start
RANK_SCRIPT = os.path.abspath(__file__)


def run_ranks(world, out, parts):
    """``world`` ranks of this script over one card; their results."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, DL4J_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   DL4J_TPU_NUM_PROCESSES=str(world),
                   DL4J_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, RANK_SCRIPT, "dp-rank", out]
            + list(parts), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    deadline = time.monotonic() + DP_TIMEOUT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            if " rank " in line and line.startswith("dp="):
                log("  " + line)
        assert p.returncode == 0, (f"dp={world} rank {rank} exited "
                                   f"{p.returncode}:\n{text[-6000:]}")
    out_json = []
    for rank in range(world):
        with open(os.path.join(out, f"dp{world}_rank{rank}.json")) as f:
            out_json.append(json.load(f))
    return out_json


def dp_phase(attn, card, out):
    """Data parallelism over torch.distributed on the card, ranks as
    subprocesses (dp=1: one rank, nccl; dp=2: two ranks on the one card,
    gloo): bench.py's multichip_dp_scaling leg uncut; the LM at full
    width and depth DP_LM_LAYERS through the attention kernels (what the
    fit steps produced at dp=2 vs dp=1, ``dp_hold``; replicas
    bit-equal); the leg's first window likewise; a ResNet50
    step's update and batch-norm state at dp=2 vs dp=1 (global batch
    statistics); the int8 compressed reduce vs the full-precision one;
    a device-loss drill shrinking dp=2 to dp=1. Returns the attention
    kernels' launches on this path; leaves the dp=1 LM runs' files in
    ``out`` (``tp_sp_pp_phase`` holds its runs against them: the LM's,
    and ``dp_lm_tpn_net``'s at one rank)."""
    import numpy as np
    # lm_tpn at one rank: the reference tp_sp_pp_phase holds its tp=2
    # run of the same config against
    one = run_ranks(1, out, ["leg", "lm", "resnet", "lm_tpn"])
    two = run_ranks(2, out, ["leg", "lm", "resnet", "compressed",
                             "loss"])
    log(f"dp ranks: dp=1 backend {one[0]['backend']}, dp=2 backend "
        f"{two[0]['backend']} (two ranks on one card: nccl refuses "
        f"them, gloo stages CUDA tensors through the host); "
        f"{one[0]['card']}")
    # (a) the leg
    rates = {**one[0]["leg"], **two[0]["leg"]}
    vs = rates["dp2_k8_steps_per_sec"] / rates["dp2_k1_steps_per_sec"]
    log(f"multichip_dp_scaling ({card}): " + ", ".join(
        f"{k} {rates[k]:.1f}" for k in sorted(rates)
        if k.endswith("steps_per_sec")) + f"; vs_baseline (dp2_k8 / "
        f"dp2_k1) {vs:.3f}; zero captures in every timed steady "
        f"state; dp=1 reduce: {one[0]['leg']['reduce']}; dp=2 reduce: "
        f"{two[0]['leg']['reduce']}; rank 1's dp=2 rates: " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(two[1]["leg"].items())
            if k.endswith("steps_per_sec")))
    log("  (as the JAX leg's note says of its 2-core host: on one "
        "card dp=2 shares one device and cannot beat dp=1; the leg "
        "measures the data-parallel path's overhead and k-fusion on "
        "it)")
    for k in DP_LEG_KS:
        worst_m, worst_p, loose, loose_max = dp_hold(
            os.path.join(out, f"leg_dp2_k{k}"),
            os.path.join(out, f"leg_dp1_k{k}"), 1, k, 1e-3)
        log(f"multichip_dp_scaling dp=2 vs dp=1, the first window "
            f"after the warmup (k={k}: {k} Adam steps on the same "
            f"{DP_LEG_ROWS} rows): Adam's moments worst max|diff| / "
            f"max|moment| of a tensor {worst_m:.3e}, parameters "
            f"{worst_p:.3e} (limit {GRAD_RTOL}); {loose} entries whose "
            f"moments differ by more than {GRAD_RTOL} of their own "
            f"size not held, max|diff| "
            f"{loose_max:.3e}")
    # (b) the LM: what its fit steps produced, dp=2 vs dp=1
    lm1, lm2 = one[0]["lm"], two[0]["lm"]
    assert two[0]["lm"]["digest"] == two[1]["lm"]["digest"], \
        "dp=2 replicas differ"
    worst_m, worst_p, loose, loose_max = dp_hold(
        os.path.join(out, "lm_dp2"), os.path.join(out, "lm_dp1"),
        DP_LM_STEPS, DP_LM_STEPS, TRAIN_LR)
    launches = {}
    for res in (one[0], two[0], two[1]):
        for k, n in res["lm"]["launches"].items():
            assert n == DP_LM_LAYERS * DP_LM_STEPS, (k, n)
            launches[k] = launches.get(k, 0) + n
    for tag, lm in (("dp=1", lm1), ("dp=2", lm2)):
        warm = lm["step_ms"][1:]
        log(f"LM dp ({card}; V={V} D={D_MODEL} L={DP_LM_LAYERS} "
            f"H={HEADS} T={T}, global B={DP_LM_B}) {tag}: "
            f"{DP_LM_STEPS} Adam steps, losses " + ", ".join(
                f"{x:.6f}" for x in lm["losses"]) + "; step ms "
            + ", ".join(f"{x:.2f}" for x in lm["step_ms"])
            + f" (warm median {statistics.median(warm):.2f}); "
            f"the bucket's all-reduce alone {lm['bucket_bytes']} bytes "
            "in " + ", ".join(f"{x:.2f}" for x in lm["reduce_ms"])
            + f" ms; host-staged reduce inside the steps "
            f"{lm['in_step_reduce_s'] * 1e3:.1f} ms in all; "
            f"{lm['reduce']}")
    log(f"LM dp=2 vs dp=1 after {DP_LM_STEPS} Adam steps through fit: "
        f"Adam's moments worst max|diff| / max|moment| of a tensor "
        f"{worst_m:.3e}, parameters {worst_p:.3e} (limit {GRAD_RTOL});"
        f" {loose} entries whose moments differ by more than "
        f"{GRAD_RTOL} of their own size not held,"
        f" max|diff| {loose_max:.3e} (Adam's bound 2 x lr x steps "
        f"{2 * TRAIN_LR * DP_LM_STEPS:g}); dp=2 replicas bit-equal "
        f"(sha256 {lm2['digest'][:16]}); launches "
        + ", ".join(f"{k} {n}" for k, n in launches.items()))
    # (c) ResNet50: global batch statistics
    ref = _load_leaves(os.path.join(out, "resnet_dp1_r0"))
    others = [_load_leaves(os.path.join(out, f"resnet_dp1_r{r}"))
              for r in DP_RESNET_ROLLS]
    got = _load_leaves(os.path.join(out, "resnet_dp2_r0"))
    rows = _leaf_errors(got, ref, others, F32_FACTOR)
    log(f"ResNet50 one step dp=2 vs dp=1 ({card}; B={CHECK_B}, "
        f"{CHECK_HW}x{CHECK_HW}; {two[0]['resnet']['reduce']}): loss "
        f"{two[0]['resnet']['loss']:.6f} vs {one[0]['resnet']['loss']:.6f}"
        f"; {len(ref)} leaves (updates, batch-norm state); L2 |dp2 - "
        f"dp1| / ({F32_FACTOR:g} x dp=1's reorder difference + "
        f"{FLOOR_RTOL:g} x |dp1|), worst three: " + "; ".join(
            f"{k} {r:.3f}" for r, k, _, _ in rows[:3]) + " (limit 1)")
    assert rows[0][0] <= 1.0, rows[:3]
    # (d) the compressed reduce
    comp = two[0]["compressed"]
    assert math.isfinite(comp["int8"])
    assert abs(comp["int8"] - comp["plain"]) < 0.05 * max(
        abs(comp["plain"]), 1.0), comp
    assert two[1]["compressed"]["int8"] == comp["int8"]
    log(f"dp=2 int8-compressed reduce ({card}): loss "
        f"{comp['int8']:.4f} vs uncompressed {comp['plain']:.4f} "
        f"(limit 5%); {comp['int8_describe']}")
    # (e) the device-loss drill
    r0, r1 = two[0]["loss"], two[1]["loss"]
    assert r0["shrinks"] == r1["shrinks"] == 1.0, (r0, r1)
    assert r0["dp_after"] == r1["dp_after"] == 1, (r0, r1)
    assert r0["trained"] == [True] * DP_LOSS_BATCHES, r0
    assert r1["trained"] == [True] + [False] * (DP_LOSS_BATCHES - 1), r1
    assert r0["active"] and not r1["active"]
    assert math.isfinite(r0["loss"])
    log(f"device-loss drill ({card}): rank 1 lost at batch 2, dp=2 -> "
        f"dp=1, rank 0 trained {r0['iterations']} batches (loss "
        f"{r0['loss']:.4f}), rank 1 left after {r1['iterations']}; "
        f"elastic_mesh_shrinks_total {r0['shrinks']:g}")
    log("dp rank seconds: " + json.dumps(
        {f"dp{len(g)}_rank{i}": {p: round(r[p + "_s"], 1)
                                 for p in DP_PARTS if p + "_s" in r}
         for g in (one, two) for i, r in enumerate(g)}))
    return launches


TSP_STEPS_MICRO = 4           # the pipeline's microbatches (2 rows each)
TSP_SERVE_IDS = 64            # ids a /v1/predict request of serve --mesh
TSP_SERVE_REQUESTS = 4


def _full_trees(net):
    """(params, updater state) of ``net`` whole: under tensor
    parallelism gathered over its model group (every rank calls it)."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        full_opt_state, full_params)
    return full_params(net), full_opt_state(net)


def mp_part_lm(world, out, mode):
    """The LM at full width, depth DP_LM_LAYERS, DP_LM_STEPS Adam steps
    on dp_part_lm's rows (its global batch of DP_LM_B) over ``world``
    ranks in ``mode``: "sp" (ParallelWrapper over a seq mesh, this rank's
    time chunk through the ring), "tp" (``fit(mesh_spec="tp=N")``: H/N
    heads a rank, W1 by columns, W2 by rows), "tpn" (the same on
    ``dp_lm_tpn_net``: the update's global-norm clip and max_norm
    constraint over the full arrays; also the clip's ms alone) or "pp"
    (``NetworkSpmdPipeline``: one encoder layer a stage, TSP_STEPS_MICRO
    microbatches). What the steps produced (Adam's moments after each,
    the parameters after all, whole), the attention kernels' launches,
    the step times and the collectives' bytes and host-staged time."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel.multihost import process_index
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    net = dp_lm_tpn_net() if mode == "tpn" else dp_lm_net()
    rng = np.random.default_rng(0)          # as dp_part_lm
    ids = rng.integers(0, V, (DP_LM_B, T)).astype("float32")
    y = np.eye(V, dtype="float32")[rng.integers(0, V, (DP_LM_B, T))]
    bridge = None
    if mode == "sp":
        from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
        pw = ParallelWrapper(net, build_mesh(MeshSpec(data=1, seq=world)),
                             prefetch_buffer=0)
        ds = DataSet(pw.local_shard(ids), pw.local_shard(y))
        step = lambda: pw.fit_batch(ds)
    elif mode in ("tp", "tpn"):
        net.use_mesh(f"tp={world}")
        ds = DataSet(ids, y)
        step = lambda: net.fit(ds)
    else:
        from deeplearning4j_tpu_torch.parallel.pipeline_spmd import (
            NetworkSpmdPipeline)
        bridge = NetworkSpmdPipeline(
            net, build_mesh(MeshSpec(data=1, pipe=world)),
            n_microbatches=TSP_STEPS_MICRO)
        step = lambda: bridge.train_batch(ids, y)
    kernels = (attn.flash_attention_fwd_cuda,
               attn.flash_attention_bwd_dq_cuda,
               attn.flash_attention_bwd_dkv_cuda)
    for fn in kernels:                     # this path only
        fn.launches = 0
    step_ms, losses, stats, idle = [], [], [], []
    tag = os.path.join(out, f"lm_{mode}{world}")
    for i in range(DP_LM_STEPS):
        collectives.reset_stats()
        idle0 = bridge.pipe.idle_seconds if bridge is not None else 0.0
        torch.cuda.synchronize()
        dist.barrier()             # the ranks start each step together
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        # the step's own collectives (not the snapshot's gathers below)
        stats.append({k: dict(v) for k, v in collectives.STATS.items()
                      if v["calls"]})
        if bridge is not None:
            idle.append((bridge.pipe.idle_seconds - idle0) * 1e3)
        losses.append(float(net.score_value))
        if bridge is not None:
            bridge.collect_params(updater=True)
        params, opt = _full_trees(net)
        if process_index() == 0:
            moments = {}
            for k, v in _flatten(opt).items():
                parts = k.split("/")
                for moment in (".mu", ".nu"):
                    if moment in parts:
                        j = parts.index(moment)
                        moments[moment[1:] + "/" + "/".join(
                            parts[j + 1:])] = v
            _save_leaves(f"{tag}_m{i + 1}", moments)
    if process_index() == 0:
        _save_leaves(tag + "_p", _flatten(params))
    res = {"step_ms": step_ms, "losses": losses, "idle_ms": idle,
           "launches": {"flash_attention_fwd": kernels[0].launches,
                        "flash_attention_bwd_dq": kernels[1].launches,
                        "flash_attention_bwd_dkv": kernels[2].launches},
           "stats": stats}
    if mode == "tp":
        res["route"] = net._mesh_ctx.reduce_route(net)
        res["modes"] = net._tp.describe()["modes"]
    if mode == "tpn":
        res["modes"] = ({} if net._tp is None
                        else net._tp.describe()["modes"])
        res["clip_ms"] = tpn_clip_ms(net)
    if mode == "pp":
        res["pipe"] = bridge.describe()
    return res


DP_PARTS.update({
    "lm_sp": lambda world, out: mp_part_lm(world, out, "sp"),
    "lm_tp": lambda world, out: mp_part_lm(world, out, "tp"),
    "lm_pp": lambda world, out: mp_part_lm(world, out, "pp"),
    "lm_tpn": lambda world, out: mp_part_lm(world, out, "tpn")})


def serve_mesh_drill(out, card):
    """``serve --mesh tp=2`` as two rank processes of the CLI on the card
    (multihost variables, gloo: they share it): rank 0 answers
    TSP_SERVE_REQUESTS ``/v1/predict`` requests of TSP_SERVE_IDS ids for
    the LM at full width and depth DP_LM_LAYERS, each held within
    ATOL / RTOL of the one-rank model's ``output`` on the card; ctrl-c
    drains rank 0 and stops rank 1. Returns the requests' ms."""
    import socket
    import signal
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    net = dp_lm_net()
    path = os.path.join(out, "lm_serve.zip")
    write_model(net, path)
    rng = np.random.default_rng(9)
    rows = [rng.integers(0, V, (1, TSP_SERVE_IDS)).astype("float32")
            for _ in range(TSP_SERVE_REQUESTS)]
    want = [net.output(r).cpu().numpy() for r in rows]
    del net
    torch.cuda.empty_cache()
    ports = []
    for _ in range(2):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=here,
                   DL4J_TPU_COORDINATOR=f"127.0.0.1:{ports[0]}",
                   DL4J_TPU_NUM_PROCESSES="2", DL4J_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
             "--model", f"lm={path}", "--mesh", "tp=2", "--device", CARD,
             "--port", str(ports[1])], env=env, cwd=out,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ms, errs = [], []
    try:
        base = f"http://127.0.0.1:{ports[1]}"
        deadline = time.monotonic() + 120
        while True:
            try:
                health = json.loads(urllib.request.urlopen(
                    base + "/healthz", timeout=5).read())
                break
            except OSError:
                assert time.monotonic() < deadline, "serve --mesh: no rank 0"
                assert procs[0].poll() is None, procs[0].stdout.read()
                time.sleep(0.5)
        assert health["mesh"]["axes"]["tp"] == 2, health
        for r, w in zip(rows, want):
            body = json.dumps({"model": "lm", "inputs": r.tolist()}).encode()
            t0 = time.perf_counter()
            got = json.loads(urllib.request.urlopen(urllib.request.Request(
                base + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=120).read())["outputs"]
            ms.append((time.perf_counter() - t0) * 1e3)
            got = np.asarray(got, np.float32)
            assert got.shape == w.shape, (got.shape, w.shape)
            assert np.allclose(got, w, rtol=RTOL, atol=ATOL), \
                float(np.abs(got - w).max())
            errs.append(float(np.abs(got - w).max()))
        procs[0].send_signal(signal.SIGINT)
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    for rank, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"serve --mesh rank {rank} exited "
                                   f"{p.returncode}:\n{text[-4000:]}")
    assert "serving mesh: tp=2" in logs[0] and "draining" in logs[0]
    assert "following the mesh's rank 0" in logs[1]
    log(f"serve --mesh tp=2 ({card}; two rank processes on the card, "
        f"gloo; LM V={V} D={D_MODEL} L={DP_LM_LAYERS} H={HEADS}): "
        f"{len(ms)} /v1/predict requests of {TSP_SERVE_IDS} ids, ms "
        + ", ".join(f"{x:.1f}" for x in ms) + "; max|tp=2 - one rank| "
        + ", ".join(f"{e:.2e}" for e in errs)
        + f" (limit atol {ATOL} + rtol {RTOL}); rank 1 followed "
        "and stopped on rank 0's ctrl-c")
    return ms


def tp_sp_pp_phase(attn, card, ref_dir):
    """Tensor, sequence and pipeline parallelism on the card, two rank
    processes sharing it (gloo): the LM at full width and depth
    DP_LM_LAYERS, DP_LM_STEPS Adam steps on dp_part_lm's rows, at sp=2
    (local T = T/2 through the ring on the flash kernels), tp=2 (H/2
    heads a rank) and pp=2 (one encoder layer a stage), each held against
    dp_phase's one-rank run in ``ref_dir`` by ``dp_hold``; the same at
    tp=2 under a global-norm clip and a max_norm constraint
    (``dp_lm_tpn_net``, held against its one-rank run in ``ref_dir``;
    every kernel launched on both ranks; the clip's ms alone and its
    share of the step); then ``serve --mesh tp=2``
    (``serve_mesh_drill``). Returns the attention kernels' launches on
    this path."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="tsp-", dir=os.path.join(here, "build"))
    try:
        ranks = run_ranks(2, out, ["lm_sp", "lm_tp", "lm_pp", "lm_tpn"])
        launches = {}
        for mode in ("sp", "tp", "pp", "tpn"):
            part = f"lm_{mode}"
            ref = os.path.join(ref_dir, "lm_tpn1" if mode == "tpn"
                               else "lm_dp1")
            worst_m, worst_p, loose, loose_max = dp_hold(
                os.path.join(out, f"lm_{mode}2"), ref, DP_LM_STEPS,
                DP_LM_STEPS, TRAIN_LR)
            per = {}
            for r in ranks:
                for k, n in r[part]["launches"].items():
                    per[k] = per.get(k, 0) + n
                    launches[k] = launches.get(k, 0) + n
                    if mode == "tpn":     # every kernel on both ranks
                        assert n > 0, (mode, k, n)
            for k, n in per.items():
                assert n > 0, (mode, k, n)
            r0 = ranks[0][part]
            warm = r0["step_ms"][1:]
            extra = ""
            if mode == "pp":
                extra = "; each stage's idle (bubble) ms in the warm " \
                    "steps: " + "; ".join(
                        f"stage {r[part]['pipe']['stage']} " + ", ".join(
                            f"{x:.1f} of {y:.1f}" for x, y in zip(
                                r[part]["idle_ms"][1:],
                                r[part]["step_ms"][1:])) for r in ranks)
            if mode == "tp":
                extra = f"; {r0['route']}; modes {r0['modes']}"
            if mode == "tpn":
                med = statistics.median(warm)
                clip0 = ranks[0][part]["clip_ms"]
                with open(os.path.join(ref_dir, "dp1_rank0.json")) as f:
                    alone = json.load(f)["lm_tpn"]
                warm1 = alone["step_ms"][1:]
                assert r0["modes"] == {
                    **{str(i): "attention_heads"
                       for i in range(1, 1 + DP_LM_LAYERS)},
                    str(1 + DP_LM_LAYERS): "column",
                    str(2 + DP_LM_LAYERS): "row"}, r0["modes"]
                extra = (f"; gradient_clip by norm {TPN_CLIP} and "
                         f"max_norm {TPN_MAX_NORM} on a dense pair, modes "
                         f"{r0['modes']}; the clip alone {clip0:.3f} ms "
                         f"(rank 0; rank 1 {ranks[1][part]['clip_ms']:.3f}"
                         f" ms), {100 * clip0 / med:.2f}% of the warm "
                         f"median step; at one rank the clip "
                         f"{alone['clip_ms']:.3f} ms of a "
                         f"{statistics.median(warm1):.1f} ms warm median step")
            log(f"LM {mode}=2 vs one rank ({card}; V={V} D={D_MODEL} "
                f"L={DP_LM_LAYERS} H={HEADS} T={T}, B={DP_LM_B}; two gloo "
                f"ranks on the card): {DP_LM_STEPS} Adam steps, losses "
                + ", ".join(f"{x:.6f}" for x in r0["losses"])
                + "; step ms " + ", ".join(f"{x:.1f}" for x in r0["step_ms"])
                + f" (warm median {statistics.median(warm):.1f}); "
                f"Adam's moments worst max|diff| / max|moment| "
                f"{worst_m:.3e}, parameters {worst_p:.3e} (limit "
                f"{GRAD_RTOL}); {loose} entries not held, max|diff| "
                f"{loose_max:.3e}; attention launches "
                + ", ".join(f"{k} {n}" for k, n in per.items())
                + "; rank 0's collectives a step: " + "; ".join(
                    ", ".join(f"{k} {v['bytes']} bytes in {v['calls']} "
                              f"calls, {v['seconds'] * 1e3:.1f} ms "
                              f"host-staged" for k, v in st.items())
                    for st in r0["stats"]) + extra)
            kind = {"sp": "ring", "tp": "tp", "pp": "pipe",
                    "tpn": "tp"}[mode]
            for i, st in enumerate(r0["stats"][1:], 2):
                v = st.get(kind, {"bytes": 0, "seconds": 0.0})
                log(f"  {mode}=2 step {i} (warm), rank 0: {kind} "
                    f"{v['bytes']} bytes, {v['seconds'] * 1e3:.1f} ms "
                    f"host-staged of the step's {r0['step_ms'][i - 1]:.1f}")
        log("  (nccl across ranks, i.e. the ring's device send/recv and "
            "tp's captured all-reduce, needs a card a rank: two ranks on "
            "one card run gloo)")
        serve_mesh_drill(out, card)
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


MESH_FLEET_BURST = 8         # predicts through the router, CLIENTS at once
MESH_FLEET_IDS = 64          # ids a request (TSP_SERVE_IDS)
MESH_BOOT_S = 300.0          # four ranks' imports, contexts and models
MESH_GONE_S = 5.0            # a dead follower's rank 0 is gone within this


def _pid_alive(pid):
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def mesh_fleet_phase(card):
    """``serve-fleet --mesh tp=2 --replicas 2`` on the card: the LM at
    full width and depth FLEET_LAYERS, each replica a rank set of two
    ``serve --mesh`` processes (four gloo ranks share the card). A burst
    of MESH_FLEET_BURST predicts through the router, CLIENTS at a time,
    each held within ATOL / RTOL of the one-rank model's ``output`` on
    the card (QPS and p50 printed); then one replica's follower is
    SIGKILLed while a client keeps predicting through the router: its
    rank 0 must be gone within MESH_GONE_S, the fleet must boot a
    successor, and every request of the drill must return 200 with the
    right answer. A predict to each replica's rank 0 and ctrl-c follow;
    every rank of the replicas that drained reports its forward-kernel
    launches in its log (the SIGKILLed set cannot). Returns their sum."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="meshfleet-",
                           dir=os.path.join(here, "build"))
    proc = None
    try:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            lm_config(None, FLEET_LAYERS)), device=CARD).init(seed=0)
        path = os.path.join(out, "lm.zip")
        write_model(net, path)
        rng = np.random.default_rng(21)
        rows = [rng.integers(0, V, (1, MESH_FLEET_IDS)).astype("float32")
                for _ in range(MESH_FLEET_BURST)]
        want = [net.output(r).cpu().numpy() for r in rows]
        del net
        torch.cuda.empty_cache()
        port = free_ports(1)
        base = f"http://127.0.0.1:{port}"
        logs = os.path.join(out, "ranks")
        fleet_log = open(os.path.join(out, "fleet.log"), "w")
        t_boot = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-fleet",
             "--model", f"lm={path}", "--mesh", "tp=2", "--replicas", "2",
             "--device", CARD, "--port", str(port), "--probe-interval",
             "0.5", "--log-dir", logs],
            env=dict(os.environ, PYTHONPATH=here), cwd=out,
            stdout=fleet_log, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)     # the fleet and its ranks: a group

        def fleet_text():
            with open(os.path.join(out, "fleet.log")) as f:
                return f.read()

        def ready(limit_s):
            t_end = time.monotonic() + limit_s
            while True:
                assert proc.poll() is None, fleet_text()[-6000:]
                assert time.monotonic() < t_end, "mesh fleet not ready"
                try:
                    if http(port, "/healthz")[1]["eligible"] == 2:
                        return http(port, "/fleet")[1]["replicas"]
                except (OSError, ValueError, KeyError):
                    pass
                time.sleep(0.25)

        def predict(i, url=base):
            body = json.dumps({"model": "lm",
                               "inputs": rows[i].tolist()}).encode()
            t0 = time.perf_counter()
            got = json.loads(urllib.request.urlopen(urllib.request.Request(
                url + "/v1/predict", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=300).read())["outputs"]
            ms = (time.perf_counter() - t0) * 1e3
            got = np.asarray(got, np.float32)
            assert got.shape == want[i].shape, (got.shape, want[i].shape)
            assert np.allclose(got, want[i], rtol=RTOL, atol=ATOL), \
                float(np.abs(got - want[i]).max())
            return ms, float(np.abs(got - want[i]).max())

        view = ready(MESH_BOOT_S)
        boot_s = time.perf_counter() - t_boot
        assert [len(r["pids"]) for r in view] == [2, 2], view
        for r in view:
            health = json.loads(urllib.request.urlopen(
                r["url"] + "/healthz", timeout=30).read())
            assert health["mesh"]["axes"]["tp"] == 2, health
        with ThreadPoolExecutor(CLIENTS) as pool:
            t0 = time.perf_counter()
            res = list(pool.map(predict, range(MESH_FLEET_BURST)))
            wall = time.perf_counter() - t0
        ms = sorted(m for m, _ in res)
        log(f"serve-fleet --mesh tp=2 --replicas 2 ({card}; LM V={V} "
            f"D={D_MODEL} L={FLEET_LAYERS} H={HEADS}; four gloo ranks on "
            f"the card): boot {boot_s:.1f} s; {MESH_FLEET_BURST} "
            f"/v1/predict of {MESH_FLEET_IDS} ids through the router, "
            f"{CLIENTS} at a time: {MESH_FLEET_BURST / wall:.2f} QPS, p50 "
            f"{ms[len(ms) // 2]:.1f} ms, max {ms[-1]:.1f} ms; max|fleet - "
            f"one rank| {max(e for _, e in res):.2e} (limit atol {ATOL} "
            f"+ rtol {RTOL})")
        # the kill drill: a client predicts through the router throughout
        dead = view[0]
        codes, stop = [], threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                try:
                    predict(i % MESH_FLEET_BURST)
                    codes.append(200)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
                except Exception as e:
                    codes.append(repr(e))
                i += 1

        th = threading.Thread(target=client, daemon=True)
        th.start()
        time.sleep(1.0)
        t_kill = time.monotonic()
        os.kill(dead["pids"][1], signal.SIGKILL)
        while _pid_alive(dead["pids"][0]):
            assert time.monotonic() - t_kill < MESH_GONE_S, \
                "rank 0 outlived its follower"
            time.sleep(0.02)
        gone_s = time.monotonic() - t_kill
        while True:
            view = ready(MESH_BOOT_S)
            if dead["id"] not in [r["id"] for r in view]:
                break
            time.sleep(0.25)
        replaced_s = time.monotonic() - t_kill
        time.sleep(1.0)
        stop.set()
        th.join(300)
        assert codes and all(c == 200 for c in codes), codes
        log(f"  mesh replica {dead['id']}'s follower SIGKILLed: its rank "
            f"0 gone in {gone_s:.2f} s (limit {MESH_GONE_S} s), the "
            f"replica replaced by {[r['id'] for r in view]} in "
            f"{replaced_s:.1f} s; {len(codes)} predicts through the router "
            f"meanwhile, all 200 and within the limit")
        for r in view:               # every rank of the final replicas
            predict(0, r["url"])
        proc.send_signal(signal.SIGINT)
        proc.wait(120)
        text = fleet_text()
        assert proc.returncode == 0 and "draining fleet" in text, \
            text[-6000:]
        pids = dead["pids"] + [p for r in view for p in r["pids"]]
        assert not [p for p in pids if _pid_alive(p)], "a rank outlived it"
        fwd, per = 0, []
        for r in view:
            for rank in range(2):
                with open(os.path.join(
                        logs, f"replica-{r['id']}-rank-{rank}.log")) as f:
                    rank_log = f.read()
                m = re.search(r"kernel launches (\{.*?\})", rank_log)
                assert m, rank_log[-4000:]
                n = json.loads(m.group(1))["flash_attention_fwd_cuda"]
                assert n > 0, (r["id"], rank, n)
                per.append(n)
                fwd += n
        log(f"  forward-kernel launches by rank process of the replicas "
            f"that drained ({[r['id'] for r in view]}): {per} (the "
            f"SIGKILLed set's are not read); no rank outlived ctrl-c")
        return fwd
    finally:
        if proc is not None:    # whatever failed, no rank outlives it
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(30)
        shutil.rmtree(out, ignore_errors=True)


# --------------------------------------------------------------------
# nlp_phase: the Word2Vec family on the card. No kernel of its own: the
# JAX package leaves these steps to XLA, the port to plain torch ops
# (cuBLAS, the gather and scatter kernels).
# --------------------------------------------------------------------

NLP_V = 100_000            # tests/test_nlp.py:586-609's corpus (seed 0):
NLP_SENT = 20              # every word once in 20-token sentences, plus
NLP_HEAD, NLP_HEAD_WORDS = 20_000, 200   # a head of 20,000 over 200 words
NLP_D = 300                # the width of retrieval_phase's 400,000 x 300
NLP_D_SMALL = 100          # the other trainers and the step checks
NLP_B, NLP_WINDOW, NLP_NEG = 4096, 5, 5
NLP_TIMED = 20             # warm steps timed by CUDA events (3 untimed)
NLP_QUERIES, NLP_CHUNK, NLP_K = 2048, 256, 5
NLP_CHECK_STEPS = 4        # card-vs-CPU steps on the real streams
NLP_CHECK_TOL = 1e-5       # max|diff| over each table's max|entry|
NLP_GLOVE_EPOCHS = 5
NLP_GRAPH_N, NLP_GRAPH_DEG, NLP_GRAPH_CROSS = 2000, 10, 20
NLP_WALKS, NLP_WALK_LEN = 4, 20
NLP_N2V_WALKS = 2          # Node2Vec's p/q choice is ~40 us a step
NLP_GRAPH_LR = 0.1         # at 0.025, one epoch leaves every vertex at
                           # cosine ~0.999 to every other
NLP_EMBED_TEXTS = 8
NLP_TSNE_WORDS, NLP_TSNE_ITERS = 500, 6
NLP_DP_CORPUS = ["the quick brown fox jumps over the lazy dog",
                 "a quick red fox runs past a lazy cat",
                 "dogs and cats and foxes run fast"] * 20


def nlp_corpus():
    """tests/test_nlp.py:586-609's 100k-vocabulary corpus: (words,
    sentences of tokens)."""
    import numpy as np
    rng = np.random.default_rng(0)
    words = [f"w{i:06d}" for i in range(NLP_V)]
    order = rng.permutation(NLP_V)
    corpus = [[words[j] for j in order[i:i + NLP_SENT]]
              for i in range(0, NLP_V, NLP_SENT)]
    head = [words[int(i)] for i in
            rng.integers(0, NLP_HEAD_WORDS, NLP_HEAD)]
    corpus += [head[i:i + NLP_SENT] for i in range(0, len(head), NLP_SENT)]
    return words, corpus


def nlp_w2v(D, **kw):
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    b = (Word2Vec.builder().layer_size(D).window_size(NLP_WINDOW)
         .negative_sample(NLP_NEG).min_word_frequency(1).epochs(1)
         .batch_size(NLP_B).sampling(0.0).seed(0).device(CARD))
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


def nlp_step_bytes(D, B, K, centers, contexts, negs):
    """The least bytes of one skip-gram NS step: each distinct touched
    row of syn0 and syn1 read and written once (a row the batch names
    again comes from cache), the indices read once."""
    import numpy as np
    u0 = len(np.unique(centers))
    u1 = len(np.unique(np.concatenate([contexts, negs.reshape(-1)])))
    return 8 * D * (u0 + u1) + 8 * B * (K + 2)


def nlp_skipgram_leg(corpus, card):
    """Skip-gram NS at NLP_D: the fit (vocab, pairs, steps) timed, the
    step's warm ms by CUDA events against its byte bound, the host ms a
    step, pairs/s; then words_nearest_batch. Returns the trained model
    and its pairs."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp.word2vec import ns_step
    w2v = nlp_w2v(NLP_D)
    t0 = time.perf_counter()
    w2v.build_vocab(corpus)
    vocab_s = time.perf_counter() - t0
    # the host half of the fit alone: the pair stream and the epoch's
    # permutation + negatives, drawn from the fit's generator
    rng = np.random.default_rng(w2v.seed + 1)
    t0 = time.perf_counter()
    pairs = w2v._training_pairs(corpus, rng)
    pairs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    order, negs = w2v._epoch(len(pairs), NLP_B, rng)
    torch.cuda.synchronize()
    draws_s = time.perf_counter() - t0
    steps = order.shape[0]
    del order, negs
    t0 = time.perf_counter()
    w2v.fit(corpus)
    fit_s = time.perf_counter() - t0
    assert w2v.syn0.shape == (len(w2v.vocab), NLP_D)
    assert np.isfinite(w2v.syn0).all() and np.isfinite(w2v.syn1).all()
    # the step on the card, warm, from the trained tables
    syn0, syn1 = w2v._tables()
    evs, sizes = [], []
    it = w2v.sg_batches(pairs, np.random.default_rng(7))
    for i in range(NLP_TIMED + 3):
        c, x, n = next(it)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ns_step(syn0, syn1, c, x, n, 0.01)
        e1.record()
        if i >= 3:
            evs.append((e0, e1))
            sizes.append(nlp_step_bytes(NLP_D, NLP_B, NLP_NEG, c.cpu().numpy(),
                                        x.cpu().numpy(), n.cpu().numpy()))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in evs)
    step_ms = ms[len(ms) // 2]
    # the kernels' own time a step (the profiler, the last batch again):
    # the rest of the event-timed step is the host enqueueing its ops
    # (its windows of 20 calls held 1737 or 1800 device events, so their
    # count is not held to a multiple of the calls; the bound check is)
    kern_ms = device_ms(lambda: ns_step(syn0, syn1, c, x, n, 0.01), 20,
                        fixed=False)
    nbytes = float(np.median(sizes))
    bound_ms = nbytes / PEAK_BYTES * 1e3
    check_bound(kern_ms, {"bound_ms": bound_ms, "bound_by": "bytes"},
                "the skip-gram NS step's kernels")
    flops = 2 * 3 * NLP_B * (NLP_NEG + 1) * NLP_D
    host_ms = (pairs_s + draws_s) * 1e3 / steps
    log(f"word2vec skip-gram NS ({card}): vocab {len(w2v.vocab)} "
        f"({vocab_s:.2f} s with the {NLP_D}-wide init), {len(pairs)} pairs, "
        f"{steps} steps of B={NLP_B} K={NLP_NEG}, D={NLP_D} (two "
        f"{len(w2v.vocab)} x {NLP_D} f32 tables, "
        f"{2 * len(w2v.vocab) * NLP_D * 4 / 1e6:.0f} MB); fit {fit_s:.2f} s, "
        f"{len(pairs) / fit_s:.0f} pairs/s; the step's warm median "
        f"{step_ms:.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f}; CUDA events, "
        f"{NLP_TIMED} steps) against its byte bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.2f} MB at {PEAK_BYTES / 1e12:.2f} TB/s; "
        f"{flops / 1e9:.2f} GFLOP, {flops / PEAK_F32_FLOPS * 1e3:.4f} ms at "
        f"the f32 rate): {bound_ms / step_ms:.1%}; the kernels' device "
        f"time a step {kern_ms:.4f} ms (profiler; "
        f"{bound_ms / kern_ms:.1%} of the bound); host a step "
        f"{host_ms:.3f} ms (pairs {pairs_s:.2f} s + permutation and "
        f"negatives drawn and uploaded {draws_s:.2f} s, over {steps} steps): "
        f"host share of the fit's step {host_ms / (host_ms + step_ms):.1%}")
    words = [w.word for w in w2v.vocab.words]
    queries = [words[int(i)] for i in
               np.random.default_rng(0).integers(0, len(words),
                                                 NLP_QUERIES)]
    secs = []
    for _ in range(2):          # the first uploads the unit rows
        t0 = time.perf_counter()
        res = w2v.words_nearest_batch(queries, n=NLP_K, chunk=NLP_CHUNK)
        secs.append(time.perf_counter() - t0)
        assert len(res) == NLP_QUERIES
        assert all(len(r) == NLP_K for r in res)
        assert all(q not in r for q, r in zip(queries, res))
    log(f"words_nearest_batch ({card}): {NLP_QUERIES} queries, k={NLP_K}, "
        f"chunk {NLP_CHUNK}, over {len(words)} x {NLP_D}: "
        f"{secs[0]:.3f} s with the unit rows' upload, {secs[1]:.3f} s warm "
        f"({secs[1] / NLP_QUERIES * 1e3:.4f} ms a query)")
    return w2v, pairs


def nlp_hold(name, tables, run, card, reordered=None):
    """``run(tables, device)`` (NLP_CHECK_STEPS steps in place) on the
    card and on the CPU from the same numpy ``tables``; fails unless
    every table agrees within NLP_CHECK_TOL of its largest entry. With
    ``reordered`` (the same run with its terms summed in another order,
    on the CPU), a table may also be within 4x the CPU's own difference
    under that reorder."""
    import torch

    def go(fn, dev):
        ts = [torch.tensor(t, device=dev) for t in tables]
        fn(ts, dev)
        return [t.cpu().numpy() for t in ts]

    def rel(a, b):
        return float(abs(a - b).max() / max(abs(a).max(), 1e-30))
    cpu, got = go(run, "cpu"), go(run, CARD)
    errs, limits = [], []
    for i, (a, b, t0) in enumerate(zip(cpu, got, tables)):
        assert (a != t0).any(), f"{name}: a table did not move"
        errs.append(rel(a, b))
        limits.append(NLP_CHECK_TOL)
    if reordered is not None:
        own = [rel(a, b) for a, b in zip(cpu, go(reordered, "cpu"))]
        limits = [max(l, 4 * o) for l, o in zip(limits, own)]
    assert all(e <= l for e, l in zip(errs, limits)), (name, errs, limits)
    return [(e, l) for e, l in zip(errs, limits)]


def nlp_step_checks(w2v, pairs, corpus, card):
    """Each step function on the card against its CPU run, from the same
    tables, on NLP_CHECK_STEPS batches of the real streams: skip-gram NS
    at NLP_D from the trained tables, then HS, CBOW NS and HS, PV-DBOW
    and DM and GloVe's epoch at NLP_D_SMALL over the same vocab."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp.glove import Glove, glove_epoch_step
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors, doc_step)
    from deeplearning4j_tpu_torch.nlp.word2vec import (cbow_step, hs_step,
                                                       ns_step)

    def batches(model, n, rng, negatives=True):
        order, negs = model._epoch(n, NLP_B, rng, negatives)
        return [(order[i].cpu().numpy(),
                 None if negs is None else negs[i].cpu().numpy())
                for i in range(NLP_CHECK_STEPS)]

    def idx(a, dev):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    report = {}
    sg = batches(w2v, len(pairs), np.random.default_rng(11))

    def run_ns(ts, dev):
        for sel, negs in sg:
            ns_step(*ts, idx(pairs[sel, 0], dev), idx(pairs[sel, 1], dev),
                    idx(negs, dev), 0.025)
    report[f"skip-gram NS D={NLP_D}"] = nlp_hold(
        "ns", [w2v.syn0, w2v.syn1], run_ns, card)

    D = NLP_D_SMALL
    rng = np.random.default_rng(12)
    V = len(w2v.vocab)
    small = [((rng.random((V, D)) - 0.5) / D).astype(np.float32),
             (rng.normal(size=(V, D)) * 0.1).astype(np.float32)]
    hsm = nlp_w2v(D, use_hierarchic_softmax=True)
    hsm.vocab = w2v.vocab
    t0 = time.perf_counter()
    hsm._tables_from_vocab()
    huff_s = time.perf_counter() - t0
    hs_np = hsm._hs_arrays
    hs_sel = batches(hsm, len(pairs), np.random.default_rng(13), False)

    def hs_of(dev):
        return (idx(hs_np[0], dev), torch.from_numpy(hs_np[1]).to(dev),
                torch.from_numpy(hs_np[2]).to(dev))

    def run_hs(ts, dev):
        hs = hs_of(dev)
        for sel, _ in hs_sel:
            hs_step(*ts, hs, idx(pairs[sel, 0], dev),
                    idx(pairs[sel, 1], dev), 0.025)
    report[f"skip-gram HS D={D}"] = nlp_hold("hs", small, run_hs, card)

    crng = np.random.default_rng(14)
    ctxs, masks, centers = hsm._cbow_batches(corpus, crng)
    cb = batches(hsm, len(centers), crng)
    for use_hs in (False, True):
        def run_cbow(ts, dev, use_hs=use_hs):
            hs = hs_of(dev) if use_hs else None
            for sel, negs in cb:
                cbow_step(*ts, idx(ctxs[sel], dev),
                          torch.from_numpy(masks[sel]).to(dev),
                          idx(centers[sel], dev), idx(negs, dev), 0.025, hs)
        report[f"CBOW {'HS' if use_hs else 'NS'} D={D}"] = nlp_hold(
            "cbow", small, run_cbow, card)

    for dm in (False, True):
        pv = ParagraphVectors(dm=dm, layer_size=D, window=NLP_WINDOW,
                              negative=NLP_NEG, batch_size=NLP_B,
                              device=CARD)
        pv.vocab = w2v.vocab
        pv._tables_from_vocab()
        dp = pv._doc_pairs(corpus)
        di = np.array([p[0] for p in dp], np.int64)
        ce = np.array([p[1] for p in dp], np.int64)
        cx = np.array([p[2] for p in dp], np.int64) if dm else None
        pb = batches(pv, len(dp), np.random.default_rng(15))
        docs = (rng.normal(size=(len(corpus), D)) * 0.1).astype(np.float32)

        def run_pv(ts, dev, cx=cx, di=di, ce=ce, pb=pb):
            for sel, negs in pb:
                doc_step(ts[2], ts[0], ts[1], idx(di[sel], dev),
                         idx(ce[sel], dev),
                         None if cx is None else idx(cx[sel], dev),
                         idx(negs, dev), 0.025)
        tables = small + [docs]
        if not dm:      # DBOW leaves syn0 as it is: hold syn1 and docs
            def run_pv(ts, dev, run=run_pv, s0=small[0]):
                run([torch.tensor(s0, device=dev)] + ts, dev)
            tables = small[1:] + [docs]
        report[f"PV-{'DM' if dm else 'DBOW'} D={D}"] = nlp_hold(
            "pv", tables, run_pv, card)

    g = Glove(layer_size=D, window=NLP_WINDOW, device=CARD)
    g.vocab = w2v.vocab
    t0 = time.perf_counter()
    co = g._cooccurrences(corpus)
    co_s = time.perf_counter() - t0
    rows = np.array([k[0] for k in co], np.int64)
    cols = np.array([k[1] for k in co], np.int64)
    vals = np.array(list(co.values()), np.float32)
    wgt = np.minimum(1.0, (vals / g.x_max) ** g.alpha).astype(np.float32)
    params = small + [np.zeros(V, np.float32), np.zeros(V, np.float32)]

    def run_glove(ts, dev, perm=slice(None)):
        accum = [torch.full_like(t, 1e-8) for t in ts]
        args = (idx(rows[perm], dev), idx(cols[perm], dev),
                torch.from_numpy(np.log(vals[perm])).to(dev),
                torch.from_numpy(wgt[perm]).to(dev))
        for _ in range(2):
            glove_epoch_step(ts, accum, *args, g.learning_rate)
    # AdaGrad's first step divides a gradient by ~sqrt(g^2 + 1e-8): where
    # the co-occurrences' terms cancel, their summation order (the card's
    # atomics) moves the step by up to lr * rounding / 1e-4, so the card
    # is also held within 4x the CPU's own difference under a reorder
    perm = np.random.default_rng(16).permutation(len(vals))
    report[f"GloVe epoch D={D}"] = nlp_hold(
        "glove", params, run_glove, card,
        reordered=lambda ts, dev: run_glove(ts, dev, perm))
    log(f"word2vec steps, card vs CPU ({card}; {NLP_CHECK_STEPS} steps of "
        f"B={NLP_B} from the same tables on the real streams, GloVe 2 "
        f"epochs over {len(vals)} co-occurrences; Huffman of "
        f"{V} words {huff_s:.2f} s, co-occurrences {co_s:.2f} s): max|diff| "
        f"over max|entry| by table (limit): "
        + "; ".join(f"{k} " + ", ".join(f"{e:.2e} ({l:.1e})" for e, l in v)
                    for k, v in report.items()))


def nlp_graph(n, seed=0):
    """Two communities of ``n/2`` vertices: NLP_GRAPH_DEG random edges
    a vertex inside its own, NLP_GRAPH_CROSS edges across."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.deepwalk import Graph
    rng = np.random.default_rng(seed)
    g = Graph(n)
    half = n // 2
    for v in range(n):
        base = 0 if v < half else half
        for u in rng.integers(0, half, NLP_GRAPH_DEG // 2):
            if base + int(u) != v:
                g.add_edge(v, base + int(u))
    for a, b in zip(rng.integers(0, half, NLP_GRAPH_CROSS),
                    rng.integers(half, n, NLP_GRAPH_CROSS)):
        g.add_edge(int(a), int(b))
    return g


def nlp_trainers_leg(corpus, card):
    """HS and CBOW, PV-DBOW and PV-DM (+ infer_vector), GloVe, DeepWalk
    and Node2Vec, each fit once on the card at NLP_D_SMALL; returns the
    HS model (for the .vec round trip)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.deepwalk import DeepWalk, Node2Vec
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors)
    D = NLP_D_SMALL
    secs = {}

    def fit(name, make):
        t0 = time.perf_counter()
        m = make()
        secs[name] = time.perf_counter() - t0
        return m

    hs = fit("skip-gram HS", lambda: nlp_w2v(
        D, use_hierarchic_softmax=True).fit(corpus))
    fit("CBOW NS", lambda: nlp_w2v(
        D, elements_learning_algorithm="cbow").fit(corpus))
    labels = [f"doc_{i}" for i in range(len(corpus))]
    for dm in (False, True):
        name = "PV-DM" if dm else "PV-DBOW"
        pv = fit(name, lambda dm=dm: ParagraphVectors(
            dm=dm, layer_size=D, window=NLP_WINDOW, negative=NLP_NEG,
            min_word_frequency=1, batch_size=NLP_B, subsampling=0.0,
            seed=0, device=CARD).fit_documents(corpus, labels))
        t0 = time.perf_counter()
        v = pv.infer_vector(corpus[3])
        secs[name + " infer_vector"] = time.perf_counter() - t0
        assert v.shape == (D,) and np.isfinite(v).all()
        assert np.isfinite(pv.doc_vectors).all()
    glove = fit("GloVe", lambda: Glove(
        layer_size=D, window=NLP_WINDOW, min_word_frequency=1,
        epochs=NLP_GLOVE_EPOCHS, seed=0, device=CARD).fit(corpus))
    assert np.isfinite(glove.syn0).all()
    graph = nlp_graph(NLP_GRAPH_N)
    half = NLP_GRAPH_N // 2
    pick = np.random.default_rng(1).integers(0, half, (200, 2))
    for name, cls, kw in (("DeepWalk", DeepWalk, {}),
                          ("Node2Vec", Node2Vec, dict(p=0.5, q=2.0))):
        walks = NLP_N2V_WALKS if cls is Node2Vec else NLP_WALKS
        m = fit(name, lambda cls=cls, kw=kw, walks=walks: cls(
            vector_size=64, window_size=NLP_WINDOW, walk_length=NLP_WALK_LEN,
            walks_per_vertex=walks, batch_size=NLP_B, seed=0, device=CARD,
            learning_rate=NLP_GRAPH_LR, **kw).fit(graph))
        same = np.mean([m.similarity(int(a), int(b)) for a, b in pick])
        cross = np.mean([m.similarity(int(a), int(b) + half)
                         for a, b in pick])
        assert same > cross, (name, same, cross)
        secs[name + " same vs cross"] = (same, cross)
    log(f"word2vec trainers ({card}; D={D}, B={NLP_B}, 1 epoch over the "
        f"corpus, GloVe {NLP_GLOVE_EPOCHS} epochs, graphs of {NLP_GRAPH_N} "
        f"vertices, walks of {NLP_WALK_LEN}): " + "; ".join(
            f"{k} {v[0]:.3f} vs {v[1]:.3f} mean cosine" if isinstance(v, tuple)
            else f"{k} {v:.2f} s" for k, v in secs.items()))
    return hs


def nlp_serve_leg(w2v, card):
    """``TextEmbedder.from_word2vec`` on the trained model behind a
    ModelServer's retrieval backend: /v1/embed of NLP_EMBED_TEXTS texts
    against numpy's mean pool of syn0's rows, a text /v1/search over the
    trained vectors against numpy's cosine top-k."""
    import numpy as np
    from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex,
                                                    TextEmbedder)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.retrieval_backend import (
        RetrievalService)
    emb = TextEmbedder.from_word2vec(w2v)
    assert emb.device.type == CARD
    index = BruteForceIndex(NLP_D, device=CARD)
    V = w2v.syn0.shape[0]
    index.add(np.arange(V), w2v.syn0)
    server = ModelServer(ModelRegistry(), retrieval=RetrievalService(
        index, embedder=emb, max_batch_size=32))
    server.start()
    rng = np.random.default_rng(3)
    words = [w.word for w in w2v.vocab.words]
    texts = [" ".join(words[int(i)] for i in rng.integers(0, V, n))
             + (" oov" if n % 3 == 0 else "")
             for n in rng.integers(1, 30, NLP_EMBED_TEXTS)]
    try:
        t0 = time.perf_counter()
        code, body, _ = http(server.port, "/v1/embed", {"texts": texts})
        embed_ms = (time.perf_counter() - t0) * 1e3
        assert code == 200, body
        got = np.asarray(body["embeddings"], np.float64)
        want = []
        for t in texts:
            ids = [w2v.vocab.index_of(x) for x in t.split()]
            v = w2v.syn0[[i for i in ids if i >= 0]].astype(np.float64)
            m = v.mean(0)
            want.append(m / max(np.linalg.norm(m), 1e-12))
        want = np.asarray(want)
        err = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        query = " ".join(words[:3])
        t0 = time.perf_counter()
        code, body, _ = http(server.port, "/v1/search",
                             {"queries": [query], "k": NLP_K})
        search_ms = (time.perf_counter() - t0) * 1e3
        assert code == 200, body
        ids = [r["id"] for r in body["results"][0]]
        unit = w2v.syn0 / np.maximum(
            np.linalg.norm(w2v.syn0, axis=1, keepdims=True), 1e-12)
        q = w2v.syn0[:3].astype(np.float64).mean(0)   # the query's mean
        scores = unit.astype(np.float64) @ (q / np.linalg.norm(q))
        top = np.argsort(-scores)[:NLP_K]
        assert ids[0] == int(top[0]), (ids, top)
        assert set(ids) <= set(np.argsort(-scores)[:NLP_K + 3].tolist())
    finally:
        server.stop(drain=True)
    log(f"from_word2vec behind ModelServer ({card}): /v1/embed of "
        f"{NLP_EMBED_TEXTS} texts over the {V} x {NLP_D} table in "
        f"{embed_ms:.1f} ms, max|diff| vs numpy's mean pool {err:.2e} "
        f"(atol 1e-4, rtol 1e-4); text /v1/search k={NLP_K} over the "
        f"trained vectors in {search_ms:.1f} ms, ids {ids} (numpy's top "
        f"{top.tolist()})")


def nlp_vec_leg(model, path, card):
    """write_word_vectors -> read_word_vectors on the 100k table, then
    the ``summary`` CLI on the file in a subprocess (returned running)."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.serializer import (read_word_vectors,
                                                         write_word_vectors)
    t0 = time.perf_counter()
    write_word_vectors(model, path)
    w_s = time.perf_counter() - t0
    cli = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch", "summary",
         "--model", path, "--device", "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    cache, vecs = read_word_vectors(path)
    r_s = time.perf_counter() - t0
    assert [w.word for w in cache.words] == \
        [w.word for w in model.vocab.words]
    err = float(np.abs(vecs - model.syn0).max())
    # 6 decimals (5e-7), then float32's rounding at the largest entry
    limit = 5e-7 + float(np.spacing(np.abs(model.syn0).max()))
    assert err <= limit, (err, limit)
    log(f".vec round trip ({card}): {vecs.shape[0]} x {vecs.shape[1]} "
        f"written in {w_s:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), "
        f"read in {r_s:.2f} s, max|diff| {err:.2e} (limit {limit:.2e})")
    return cli, time.perf_counter()


def nlp_dp_model():
    """The data-parallel drill's model, one rank's and every rank's: JAX's
    TestDataParallelEmbeddings configuration on the card."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    return (Word2Vec.builder().iterate(NLP_DP_CORPUS).layer_size(16)
            .min_word_frequency(1).epochs(2).batch_size(64).seed(0)
            .device(CARD).build())


def nlp_part_w2v(world, out):
    """One rank of nlp_phase's data-parallel drill: Word2Vec.fit(mesh=)
    of nlp_dp_model over the data axis of every rank."""
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    w = nlp_dp_model()
    t0 = time.perf_counter()
    w.fit(mesh=build_mesh(MeshSpec(data=world)))
    return {"syn0": w.syn0.tolist(), "syn1": w.syn1.tolist(),
            "nearest": w.words_nearest("fox", n=3),
            "fit_s": time.perf_counter() - t0}


DP_PARTS["w2v"] = nlp_part_w2v


def nlp_phase(card):
    """The Word2Vec family on the card (A8c): skip-gram NS over
    tests/test_nlp.py's 100k-vocabulary corpus at D=300 (B=4096, window
    5, 5 negatives, no subsampling, 1 epoch, seed 0; the step against
    its byte bound, the host's share, pairs/s) and words_nearest_batch
    (2048 queries, chunk 256); every step function on the card against
    its CPU run on the real streams; HS, CBOW, PV-DBOW / DM (+
    infer_vector), GloVe, DeepWalk and Node2Vec each fit once;
    ``TextEmbedder.from_word2vec`` behind a ModelServer (/v1/embed,
    /v1/search); the ``.vec`` round trip and the ``summary`` CLI;
    ``fit(mesh=)`` at dp=2 (two gloo ranks on the card) against one
    rank; t-SNE of the 500 most frequent words.

    Cuts, for the phase's 90 s: the other trainers and the step checks
    run at D=100 (the skip-gram leg at 300); the .vec round trip writes
    the D=100 HS table (100,000 x 100; the text format costs ~1 us a
    value to write on the host); the graphs are 2,000 vertices with 4
    walks a vertex (2 for Node2Vec, whose p/q choice is ~40 us a step);
    t-SNE runs NLP_TSNE_ITERS iterations, not 500 (the host Barnes-Hut
    tree is ~1.1 s an iteration at 500 points), while the dp drill
    runs."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne
    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="nlp-", dir=os.path.join(here, "build"))
    try:
        t0 = time.perf_counter()
        words, corpus = nlp_corpus()
        log(f"nlp corpus: {len(corpus)} sentences, "
            f"{sum(map(len, corpus))} tokens ({time.perf_counter() - t0:.2f}"
            f" s)")
        w2v, pairs = nlp_skipgram_leg(corpus, card)
        nlp_step_checks(w2v, pairs, corpus, card)
        del pairs
        hs = nlp_trainers_leg(corpus, card)
        nlp_serve_leg(w2v, card)
        cli, cli_t0 = nlp_vec_leg(hs, os.path.join(out, "x.vec"), card)
        del hs

        def tsne():
            x = w2v.syn0[:NLP_TSNE_WORDS]       # the vocab is by frequency
            t0 = time.perf_counter()
            y = BarnesHutTsne(n_iter=NLP_TSNE_ITERS,
                              exaggeration_iters=NLP_TSNE_ITERS // 2,
                              seed=0).fit(x)
            return y, time.perf_counter() - t0
        with ThreadPoolExecutor(1) as pool:
            job = pool.submit(tsne)
            t0 = time.perf_counter()
            ranks = run_ranks(2, out, ["w2v"])
            dp_s = time.perf_counter() - t0
            single = nlp_dp_model()
            single.fit()
            for r in ranks:
                np.testing.assert_allclose(np.asarray(r["w2v"]["syn0"]),
                                           single.syn0, rtol=1e-3,
                                           atol=1e-4)
                np.testing.assert_allclose(np.asarray(r["w2v"]["syn1"]),
                                           single.syn1, rtol=1e-3,
                                           atol=1e-4)
                assert r["w2v"]["nearest"] == single.words_nearest("fox",
                                                                   n=3)
            err = float(np.abs(np.asarray(ranks[0]["w2v"]["syn0"])
                               - single.syn0).max())
            log(f"Word2Vec.fit(mesh=) dp=2 ({card}; two gloo ranks on the "
                f"card, {ranks[0]['backend']}): {dp_s:.1f} s with the ranks' "
                f"start, fits {ranks[0]['w2v']['fit_s']:.2f} / "
                f"{ranks[1]['w2v']['fit_s']:.2f} s; syn0 max|diff| vs one "
                f"rank {err:.2e} (rtol 1e-3, atol 1e-4); words_nearest('fox'"
                f", 3) {ranks[0]['w2v']['nearest']} on both")
            y, tsne_s = job.result()
        assert y.shape == (NLP_TSNE_WORDS, 2) and np.isfinite(y).all()
        log(f"t-SNE ({card}, host): the {NLP_TSNE_WORDS} most frequent "
            f"words of the D={NLP_D} model, {NLP_TSNE_ITERS} iterations, "
            f"{tsne_s:.2f} s (beside the dp drill)")
        text, _ = cli.communicate(timeout=300)
        assert cli.returncode == 0, text
        assert text.startswith("format: word_vectors"), text
        log(f"summary --model x.vec ({card}): {text.strip()!r}, "
            f"{time.perf_counter() - cli_t0:.1f} s after its start")
    finally:
        shutil.rmtree(out, ignore_errors=True)


# ----------------------------------------------------------- library_phase

LIB_STEPS = 4              # Adam steps through fit with the stats pipeline
LIB_LBFGS_ITERS = 3        # optimize(..., "lbfgs", iterations=3)
LIB_KNN_REQUESTS = 200     # /knn and /knnindex requests at k = LIB_KNN_K
LIB_KNN_K = 10
LIB_KNN_CHECKED = 20       # of them held against the float64 brute force
LIB_KNN_CLI_ROWS = 100_000  # the serve-knn verb's .npy (of the corpus)
# (1, T) id messages through the route: 2 (16 until surface_phase, then
# 4 until the wide-head and rank-example phases), within the smoke's
# time (each message is ~3.6 s of JSON on the card's host)
LIB_STREAM_MSGS = 2
GC_REL = 1e-3              # the gradient check's limit (both packages')


def gc_configs():
    """tests/test_gradientcheck.py's configs and data, and the
    transformer block of tests/test_native_and_kernels.py:364-383, built
    by the port's builder: (name, network factory on a device, dataset,
    subset)."""
    import numpy as np
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex,
                                                        MergeVertex)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as IT

    def mln(layers, it, l1=0.0, l2=0.0, seed=3):
        def make(device):
            b = NeuralNetConfiguration.builder().set_seed(seed).l1(l1).l2(
                l2).list()
            for layer in layers():
                b = b.layer(layer)
            return MultiLayerNetwork(b.set_input_type(it).build(),
                                     device=device).init()
        return make

    def data(n=8, fin=4, fout=3, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, (n, fin))
        return DataSet(x, np.eye(fout)[rng.integers(0, fout, n)])

    def seq(seed, shape, classes, mask=None):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, shape)
        y = np.eye(classes)[rng.integers(0, classes, shape[:2])]
        return DataSet(x, y, features_mask=mask, labels_mask=mask)

    def graves(device):
        import torch
        net = mln(lambda: [L.GravesLSTM(n_out=4),
                           L.RnnOutputLayer(n_out=2, loss="mcxent")],
                  IT.recurrent(3, 5))(device)
        rng = np.random.default_rng(11)
        wc = net.params[0]["wc"]        # peepholes start at 0: perturb
        with torch.no_grad():
            wc.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(wc.shape))))
        return net

    def graph(build, device):
        return ComputationGraph(build(), device=device).init()

    def two_branch():
        return (NeuralNetConfiguration.builder().set_seed(5).graph_builder()
                .add_inputs("in")
                .add_layer("a", L.DenseLayer(n_out=4, activation="tanh"),
                           "in")
                .add_layer("b", L.DenseLayer(n_out=4,
                                             activation="sigmoid"), "in")
                .add_vertex("add", ElementWiseVertex(op="add"), "a", "b")
                .add_vertex("cat", MergeVertex(), "add", "a")
                .add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"),
                           "cat")
                .set_outputs("out").set_input_types(IT.feed_forward(4))
                .build())

    def multi_output():
        return (NeuralNetConfiguration.builder().set_seed(6).graph_builder()
                .add_inputs("in")
                .add_layer("h", L.DenseLayer(n_out=6, activation="tanh"),
                           "in")
                .add_layer("out1", L.OutputLayer(n_out=3, loss="mcxent"),
                           "h")
                .add_layer("out2", L.OutputLayer(n_out=2, loss="mse",
                                                 activation="identity"), "h")
                .set_outputs("out1", "out2")
                .set_input_types(IT.feed_forward(4)).build())

    rng = np.random.default_rng(7)
    mds = MultiDataSet([rng.normal(0, 1, (6, 4))],
                       [np.eye(3)[rng.integers(0, 3, 6)],
                        rng.normal(0, 1, (6, 2))])
    mask = np.ones((4, 6))
    mask[2:, 4:] = 0
    r1 = np.random.default_rng(1)
    cnn_ds = DataSet(r1.normal(0, 1, (4, 6, 6, 2)),
                     np.eye(3)[r1.integers(0, 3, 4)])
    r0 = np.random.default_rng(0)
    block_ds = DataSet(r0.normal(0, 1, (4, 6, 8)),
                       np.eye(2)[r0.integers(0, 2, 4)])
    return [
        ("dense_softmax", mln(lambda: [
            L.DenseLayer(n_out=5, activation="tanh"),
            L.OutputLayer(n_out=3, loss="mcxent")], IT.feed_forward(4)),
         data(), None),
        ("dense_with_l1_l2", mln(lambda: [
            L.DenseLayer(n_out=5, activation="sigmoid"),
            L.OutputLayer(n_out=3, loss="mcxent")], IT.feed_forward(4),
            l1=1e-2, l2=1e-2), data(), None),
        ("mse_identity", mln(lambda: [
            L.DenseLayer(n_out=5, activation="relu"),
            L.OutputLayer(n_out=3, loss="mse", activation="identity")],
            IT.feed_forward(4)), data(), None),
        ("cnn", mln(lambda: [
            L.ConvolutionLayer(n_out=3, kernel=(3, 3), activation="tanh"),
            L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
            L.OutputLayer(n_out=3, loss="mcxent")],
            IT.convolutional(6, 6, 2)), cnn_ds, None),
        ("lstm", mln(lambda: [L.LSTM(n_out=4),
                              L.RnnOutputLayer(n_out=2, loss="mcxent")],
                     IT.recurrent(3, 5)), seq(2, (4, 5, 3), 2), None),
        ("graves_lstm_peepholes", graves, seq(4, (4, 5, 3), 2), None),
        ("lstm_masked", mln(lambda: [L.LSTM(n_out=4),
                                     L.RnnOutputLayer(n_out=2,
                                                      loss="mcxent")],
                            IT.recurrent(3, 6)),
         seq(5, (4, 6, 3), 2, mask), None),
        ("batchnorm", mln(lambda: [
            L.DenseLayer(n_out=5, activation="identity"),
            L.BatchNormalization(), L.OutputLayer(n_out=3, loss="mcxent")],
            IT.feed_forward(4)), data(), None),
        ("two_branch_graph", lambda d: graph(two_branch, d), data(), None),
        ("multi_output_graph", lambda d: graph(multi_output, d), mds, None),
        ("transformer_block", mln(lambda: [
            L.TransformerEncoderLayer(n_heads=2, ffn_multiplier=2),
            L.GlobalPoolingLayer(pooling="avg"), L.OutputLayer(n_out=2)],
            IT.recurrent(8, 6), seed=1), block_ds, 150),
    ]


def lib_gradient_checks(card):
    """Every gradient-check config in float64 on the card: each passes
    (its parameters, largest relative error and seconds printed)."""
    from deeplearning4j_tpu_torch import gradientcheck as gc
    rows, t_all = [], time.perf_counter()
    for name, make, ds, subset in gc_configs():
        net = make(CARD)
        t0 = time.perf_counter()
        rep = gc.gradient_check_report(net, ds, subset=subset)
        rep["seconds"] = time.perf_counter() - t0
        assert rep["ok"] and rep["failures"] == 0, (name, rep)
        assert rep["max_rel_error"] <= GC_REL
        rows.append(f"{name} {rep['params']} params, max rel "
                    f"{rep['max_rel_error']:.3e}, {rep['seconds']:.2f} s")
    log(f"gradient checks in float64 on the card ({card}; limit {GC_REL}, "
        f"eps 1e-6): " + "; ".join(rows)
        + f"; {time.perf_counter() - t_all:.1f} s in all")


class _LibProbe:
    """Before the StatsListener, at ``iteration``: the parameters and
    the listener's device copy of the previous report's, fetched once
    to the host."""

    def __init__(self, stats, iteration):
        self.stats, self.iteration, self.got = stats, iteration, None
        self.ms = 0.0

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def iteration_done(self, model, iteration, score, batch_size):
        if iteration != self.iteration:
            return
        t0 = time.perf_counter()
        # copies: on the CPU .numpy() would share the tensors' memory
        now = {name: p.detach().cpu().numpy().ravel().copy()
               for _, name, p in self.stats.named_params(model)}
        prev = {n: t.cpu().numpy().copy()
                for n, t in self.stats._prev.items()}
        self.got = (now, prev)
        self.ms = (time.perf_counter() - t0) * 1e3


def lib_hold_report(report, now, prev, n_layers):
    """One StatsReport of the LM against numpy on the same parameters:
    every histogram's counts equal ``np.histogram``'s, the mean
    magnitudes and update:param ratios within 1e-5 relative."""
    import numpy as np
    worst = 0.0
    for name, arr in now.items():
        counts, _ = np.histogram(arr, bins=20)
        assert report.histograms[f"param/{name}"]["counts"] == \
            counts.tolist(), name
        want = float(np.mean(np.abs(arr), dtype=np.float64))
        got = report.param_mean_magnitudes[name]
        worst = max(worst, abs(got - want) / want)
    upd = {n: now[n] - prev[n] for n in now}
    counts, _ = np.histogram(np.concatenate(list(upd.values())), bins=20)
    assert report.histograms["update/all"]["counts"] == counts.tolist()
    for layer in range(n_layers):
        names = [n for n in now if n.split("_", 1)[0] == str(layer)]
        if not names:
            continue
        mu = np.mean(np.abs(np.concatenate([upd[n] for n in names])),
                     dtype=np.float64)
        mp = np.mean(np.abs(np.concatenate([now[n] for n in names])),
                     dtype=np.float64)
        got = report.update_ratios[str(layer)]
        worst = max(worst, abs(got - mu / mp) / (mu / mp))
    assert worst <= 1e-5, worst
    return len(now) + 1, worst


def lib_stats_leg(net, ds, card, out):
    """LIB_STEPS Adam steps of the full-width LM through ``fit`` with
    the stats pipeline: StatsListener(frequency=1, histograms) ->
    HealthMonitor(storage=FileStatsStorage), the monitor and a
    ProfilerListener(storage=) on the chain, and a UIServer (port 0,
    attach_model, attach_health) read over HTTP. Returns the stats
    file's path."""
    import torch
    from deeplearning4j_tpu_torch.observability.health import HealthMonitor
    from deeplearning4j_tpu_torch.observability.step_profile import (
        ProfilerListener)
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.stats import (FileStatsStorage,
                                                   StatsListener)

    class TimedStats(StatsListener):
        def iteration_done(self, model, iteration, score, batch_size):
            torch.cuda.synchronize()   # the step's own work is not ours
            t0 = time.perf_counter()
            super().iteration_done(model, iteration, score, batch_size)
            self.ms.append((time.perf_counter() - t0) * 1e3)

    path = os.path.join(out, "stats.jsonl")
    storage = FileStatsStorage(path)
    health = HealthMonitor(policy="warn", storage=storage)
    stats = TimedStats(health, frequency=1, session_id="lm",
                       collect_histograms=True)
    stats.ms = []
    # the last report (iterations count from 0)
    probe = _LibProbe(stats, LIB_STEPS - 1)
    prof = ProfilerListener(frequency=1, storage=storage,
                            session_id="profile", report=False)
    net.set_listeners(probe, stats, health, prof)
    ui = UIServer(port=0)
    ui.start()
    try:
        ui.attach(storage)
        ui.attach_model(net)
        ui.attach_health(monitor=health)
        step_ms = []
        for _ in range(LIB_STEPS):
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        net.set_listeners()
        base = f"http://127.0.0.1:{ui.port}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            assert "Training dashboard" in r.read().decode()
        sessions = http(ui.port, "/api/sessions")[1]
        assert sessions == ["lm", "profile"], sessions
        ups = http(ui.port, "/api/updates?session=lm")[1]
        flow = http(ui.port, "/api/flow")[1]
        doc = http(ui.port, "/api/health")[1]
    finally:
        ui.stop()
    reports = storage.get_all_updates("lm")
    assert len(ups) == len(reports) == LIB_STEPS
    assert [u["iteration"] for u in ups] == [r.iteration for r in reports]
    losses = [r.score for r in reports]
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    assert len(flow["nodes"]) == len(net.layers) + 1
    assert doc["status"] == "ok" and doc["monitor"]["anomaly_count"] == 0
    assert len(storage.get_all_updates("profile")) == LIB_STEPS - 1
    assert probe.got is not None
    n_hist, worst = lib_hold_report(reports[-1], *probe.got,
                                    len(net.layers))
    del probe.got
    warm_step = sorted(step_ms[1:-1])[len(step_ms[1:-1]) // 2]
    warm_stats = sorted(stats.ms[1:])[len(stats.ms[1:]) // 2]
    log(f"stats pipeline on the LM ({card}): {LIB_STEPS} Adam steps through "
        f"fit, losses {', '.join(f'{x:.6f}' for x in losses)}; StatsListener "
        f"{', '.join(f'{x:.2f}' for x in stats.ms)} ms a report (warm "
        f"median {warm_stats:.2f} ms, {warm_stats / warm_step:.1%} of the "
        f"{warm_step:.2f} ms fit call it is part of; steps "
        f"{', '.join(f'{x:.2f}' for x in step_ms)} ms, the first with the "
        f"capture, the last with the probe's {probe.ms:.0f} ms fetch of "
        f"the parameters twice); a report's JSON "
        f"{len(reports[-1].to_json())} bytes; the last report's "
        f"{n_hist} histograms equal np.histogram's, mean magnitudes and "
        f"ratios within {worst:.2e} relative (limit 1e-5); /, "
        f"/api/sessions {sessions}, /api/updates ({len(ups)}), /api/flow "
        f"({len(flow['nodes'])} nodes), /api/health {doc['status']}")
    return path


def lib_lbfgs_leg(attn, net, ds, card):
    """optimize(net, ds, "lbfgs", iterations=LIB_LBFGS_ITERS) on the
    full-width LM: the loss history must fall. Its evaluations are
    counted by the forward kernel's launches (LAYERS an evaluation):
    the first, then one per line-search trial (the steps it accepted
    are logged)."""
    import torch
    from deeplearning4j_tpu_torch.train import second_order

    class Steps(second_order.BackTrackLineSearch):
        def search(self, *args):
            res = super().search(*args)
            self.accepted.append(res[0])
            return res

    line_search = Steps()
    line_search.accepted = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fwd0 = attn.flash_attention_fwd_cuda.launches
    t0 = time.perf_counter()
    hist = second_order.optimize(net, ds, algorithm="lbfgs",
                                 iterations=LIB_LBFGS_ITERS,
                                 line_search=line_search)
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0, "evaluations":
           (attn.flash_attention_fwd_cuda.launches - fwd0) // LAYERS}
    assert all(math.isfinite(x) for x in hist), hist
    assert all(b < a for a, b in zip(hist, hist[1:])), hist
    peak = torch.cuda.max_memory_allocated()
    log(f"L-BFGS on the LM ({card}; B={TRAIN_B}, T={T}, history 10): losses "
        f"{', '.join(f'{x:.6f}' for x in hist)}; {run['evaluations']} "
        f"evaluations (the first, then the line searches' trials, which "
        f"accepted steps {line_search.accepted}) in {run['seconds']:.2f} s, "
        f"{run['seconds'] / run['evaluations'] * 1e3:.2f} ms an evaluation "
        f"(forward + backward + line-search scalars); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above "
        f"the model and its Adam state)")


def lib_oracle_vs_plain(attn, net, ds, card):
    """The L-BFGS oracle's first value_and_grad on the kernels against
    the same oracle under plain_attention: each parameter's gradient
    within GRAD_RTOL of its largest entry, the loss within 1e-5."""
    import torch
    from deeplearning4j_tpu_torch.train import second_order
    from deeplearning4j_tpu_torch.util.tree import flat_views, ordered_leaves
    oracle, x0 = second_order._flat_oracle(net, ds)
    loss_k, g_k = oracle(x0)
    with plain_attention(attn):
        loss_p, g_p = oracle(x0)
    torch.cuda.synchronize()
    live = ordered_leaves(net.params)
    worst = 0.0
    for a, b in zip(flat_views(g_k, live), flat_views(g_p, live)):
        scale = b.abs().max().item()
        e = (a - b).abs().max().item()
        assert e <= GRAD_RTOL * scale + 1e-12, (e, scale)
        worst = max(worst, e / max(scale, 1e-30))
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    log(f"L-BFGS oracle, kernels vs plain attention ({card}): loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst gradient "
        f"max|diff| / max|grad| {worst:.3e} over {len(live)} tensors "
        f"(limit {GRAD_RTOL}); x0 {x0.numel()} float32 on {x0.device}")


def lib_knn_oracle(points64, q, k):
    """(ids, distances) of the exact top-(k+1) neighbours by float64
    euclidean distance on the host."""
    import numpy as np
    sq = np.einsum("ij,ij->i", points64, points64)
    d2 = sq[:, None] - 2.0 * (points64 @ q.T) + (q * q).sum(1)[None, :]
    ids, dists = [], []
    for j in range(q.shape[0]):
        top = np.argpartition(d2[:, j], k + 8)[:k + 8]
        d = np.linalg.norm(points64[top] - q[j], axis=1)
        order = np.argsort(d, kind="stable")[:k + 1]
        ids.append(top[order])
        dists.append(d[order])
    return np.asarray(ids), np.asarray(dists)


def lib_knn_leg(vectors, card):
    """NearestNeighborsServer over retrieval_phase's 10^6 x 128 corpus:
    LIB_KNN_REQUESTS /knn and /knnindex requests at k=LIB_KNN_K, 20
    held against a float64 brute force (ties as sets)."""
    import numpy as np
    from deeplearning4j_tpu_torch.services.nearest_neighbors import (
        NearestNeighborsServer)
    t0 = time.perf_counter()
    server = NearestNeighborsServer(vectors, port=0, device=CARD).start()
    boot_s = time.perf_counter() - t0
    try:
        rng = np.random.default_rng(3)
        half = LIB_KNN_REQUESTS // 2
        queries = retrieval_queries(vectors, half, seed=3)
        rows = rng.choice(vectors.shape[0], half, replace=False)
        bodies = ([("/knn", {"vector": q.tolist(), "k": LIB_KNN_K})
                   for q in queries]
                  + [("/knnindex", {"index": int(r), "k": LIB_KNN_K})
                     for r in rows])
        order = rng.permutation(len(bodies))
        lat, answers = [], {}
        t0 = time.perf_counter()
        for i in order:
            path, body = bodies[i]
            t = time.perf_counter()
            code, res, _ = http(server.port, path, body)
            lat.append((time.perf_counter() - t) * 1e3)
            assert code == 200, (code, res)
            answers[i] = res
        wall = time.perf_counter() - t0
        checked = list(range(LIB_KNN_CHECKED // 2)) + list(
            range(half, half + LIB_KNN_CHECKED // 2))
        q = np.stack([queries[i] if i < half
                      else vectors[rows[i - half]] for i in checked])
        want_ids, want_d = lib_knn_oracle(server.points,
                                          q.astype(np.float64), LIB_KNN_K)
        got_ids = np.array([answers[i]["indices"] for i in checked])
        got_d = np.array([answers[i]["distances"] for i in checked])
        exact = check_against_oracle(got_ids, -got_d, want_ids, -want_d,
                                     LIB_KNN_K)
        for j, i in enumerate(checked[LIB_KNN_CHECKED // 2:]):
            assert got_ids[LIB_KNN_CHECKED // 2 + j][0] == rows[i - half]
            assert got_d[LIB_KNN_CHECKED // 2 + j][0] == 0.0
    finally:
        server.stop()
    log(f"k-NN server ({card}): {vectors.shape[0]} x {vectors.shape[1]} "
        f"f32 ({RETR_CORPUS}) up in {boot_s:.2f} s; {len(bodies)} requests "
        f"(/knn and /knnindex, k={LIB_KNN_K}, one client): p50 "
        f"{percentile(lat, 0.5):.2f} ms, p99 {percentile(lat, 0.99):.2f} ms, "
        f"{len(bodies) / wall:.1f} queries/s; {LIB_KNN_CHECKED} against the "
        f"float64 brute force: distances within {RETR_TOL}, {exact} ids "
        f"exact, the rest in tie runs; /knnindex self-distance 0.0")


def lib_verb_port(proc, pattern):
    line = proc.stdout.readline()
    m = re.search(pattern, line)
    assert m, line + proc.stdout.read()
    return int(m.group(1))


def lib_stop_verb(proc, name):
    proc.send_signal(signal.SIGINT)
    text, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, (name, proc.returncode, text)


def lib_stream_messages():
    """The streaming leg's LIB_STREAM_MSGS (1, T) id messages (seeded)."""
    import numpy as np
    rng = np.random.default_rng(5)
    return [rng.integers(0, V, (1, T)).astype(np.float32)
            for _ in range(LIB_STREAM_MSGS)]


def stream_client_main(out):
    """The streaming leg's other process (``chip_smoke.py stream-client
    DIR``): a SocketBrokerServer, its port on stdout; on a line on stdin
    (the route has subscribed), every message published to ``ids`` at
    once, and each output read back from ``probs`` into DIR with the
    seconds since the first publish and its payload's bytes."""
    import numpy as np
    from deeplearning4j_tpu_torch.services.streaming import (
        NDArrayConsumer, NDArrayPublisher, SocketBroker, SocketBrokerServer,
        _decode)
    srv = SocketBrokerServer()
    try:
        print(f"broker on port {srv.port}", flush=True)
        sys.stdin.readline()
        broker = SocketBroker(srv.host, srv.port)
        consumer = NDArrayConsumer(broker, "probs")
        pub = NDArrayPublisher(broker, "ids")
        t0 = time.perf_counter()
        for m in lib_stream_messages():
            pub.publish(m)
        arrived, sizes = [], []
        for i in range(LIB_STREAM_MSGS):
            payload = consumer.queue.get(timeout=300)
            arrived.append(time.perf_counter() - t0)
            sizes.append(len(payload))
            np.save(os.path.join(out, f"probs{i}.npy"), _decode(payload))
        with open(os.path.join(out, "stream.json"), "w") as f:
            json.dump({"arrived": arrived, "bytes": sizes}, f)
    finally:
        srv.close()
    return 0


def lib_stream_route(net, client):
    """InferenceRoute over the SocketBrokerServer of ``client`` (a
    ``stream-client`` process, so that decoding the outputs overlaps the
    route): LIB_STREAM_MSGS (1, T) id messages through the full-width LM,
    published at once; the client writes what came back."""
    from deeplearning4j_tpu_torch.services.streaming import (InferenceRoute,
                                                             SocketBroker)
    port = lib_verb_port(client, r"broker on port (\d+)")
    route = InferenceRoute(SocketBroker("127.0.0.1", port), net, "ids",
                           "probs").start()
    try:
        text, _ = client.communicate(input="go\n", timeout=900)
        assert client.returncode == 0, text
    finally:
        route.stop()


def lib_stream_check(net, card, out):
    """The route's outputs equal net.output on the same ids (ATOL/RTOL);
    these reference forwards come after the launches are read."""
    import numpy as np
    with open(os.path.join(out, "stream.json")) as f:
        got = json.load(f)
    worst = 0.0
    for i, m in enumerate(lib_stream_messages()):
        out_i = np.load(os.path.join(out, f"probs{i}.npy"))
        want = net.output(m).cpu().numpy()
        assert out_i.shape == want.shape == (1, T, V), out_i.shape
        np.testing.assert_allclose(out_i, want, atol=ATOL, rtol=RTOL)
        worst = max(worst, float(np.abs(out_i - want).max()))
    at = got["arrived"]
    gaps = [(b - a) * 1e3 for a, b in zip(at, at[1:])]
    log(f"streaming route ({card}): {LIB_STREAM_MSGS} (1, {T}) id messages "
        f"through InferenceRoute over a SocketBrokerServer, published at "
        f"once by another process (the LM's (1, {T}, {V}) f32 output back "
        f"as JSON, {np.mean(got['bytes']) / 1e6:.1f} MB a message): the "
        f"first back after {at[0] * 1e3:.1f} ms, then p50 "
        f"{percentile(gaps, 0.5):.1f} ms a message (max {max(gaps):.1f}), "
        f"all {LIB_STREAM_MSGS} in {at[-1]:.1f} s; outputs vs net.output "
        f"max|diff| {worst:.2e} (atol {ATOL}, rtol {RTOL})")


def library_phase(attn, card):
    """The rest of the library on the card: the full-width LM
    trained LIB_STEPS Adam steps through ``fit`` with the stats pipeline
    (StatsListener -> HealthMonitor -> FileStatsStorage, ProfilerListener
    storage, the UI server's routes; one report held against numpy),
    L-BFGS on the LM (its oracle against plain attention first), every
    gradient-check config in float64 on the card, the legacy k-NN server
    over 10^6 x 128 points and the serve-knn verb, the streaming route
    through the LM, and the ``ui`` verb on the stats file. Returns the
    flash kernels' launches on the LM paths (fit, L-BFGS, the route)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)

    from deeplearning4j_tpu_torch import cli

    here = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="library-", dir=os.path.join(here,
                                                                "build"))
    part = Parts()
    verbs = []
    try:
        # the k-NN corpus first, so the serve-knn verb boots (a process
        # of its own) while the LM legs run
        _, vectors, _, _ = cli._load_corpus(RETR_CORPUS)
        npy = os.path.join(out, "points.npy")
        np.save(npy, vectors[:LIB_KNN_CLI_ROWS])
        verbs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve-knn",
             "--points", npy, "--port", "0", "--device", CARD], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        # the streaming leg's broker and clients, in a process of their own
        verbs.append(subprocess.Popen(
            [sys.executable, RANK_SCRIPT, "stream-client", out],
            cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        part("the k-NN corpus, the serve-knn verb and stream client started")
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            lm_config(updaters.adam(TRAIN_LR))), device=CARD).init(seed=0)
        rng = np.random.default_rng(0)          # as train_phase's batch
        ids = rng.integers(0, V, (TRAIN_B, T)).astype("float32")
        y = np.eye(V, dtype="float32")[rng.integers(0, V, (TRAIN_B, T))]
        ds = DataSet(ids, y)
        lib_oracle_vs_plain(attn, net, ds, card)
        part("LM init, the oracle vs plain attention")
        # the LM paths' launches: counts set to 0 here, read after
        fns = (attn.flash_attention_fwd_cuda,
               attn.flash_attention_bwd_dq_cuda,
               attn.flash_attention_bwd_dkv_cuda)
        for fn in fns:
            fn.launches = 0
        stats_path = lib_stats_leg(net, ds, card, out)
        part(f"{LIB_STEPS} fit steps with the stats pipeline")
        ui = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "ui",
             "--port", "0", "--stats-file", stats_path], cwd=here,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        verbs.append(ui)
        lib_lbfgs_leg(attn, net, ds, card)
        part("L-BFGS")
        lib_stream_route(net, verbs[1])
        # read before the route's check, whose reference forwards are
        # no launches of the path
        launches = {"flash_attention_fwd": fns[0].launches,
                    "flash_attention_bwd_dq": fns[1].launches,
                    "flash_attention_bwd_dkv": fns[2].launches}
        for name, n in launches.items():
            assert n > 0, (name, n)
        lib_stream_check(net, card, out)
        part("streaming route")
        del net, ds
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        port = lib_verb_port(ui, r"localhost:(\d+)/")
        sessions = http(port, "/api/sessions")[1]
        assert sessions == ["lm", "profile"], sessions
        lib_stop_verb(ui, "ui")
        log(f"ui --stats-file ({card}): /api/sessions {sessions}; SIGINT -> "
            f"exit 0 ({time.perf_counter() - t0:.2f} s after its wait)")
        lib_gradient_checks(card)
        part("gradient checks")
        lib_knn_leg(vectors, card)
        part("k-NN server")
        verb = verbs[0]
        port = lib_verb_port(verb, r"on port (\d+) \(")
        code, res, _ = http(port, "/knnindex", {"index": 7, "k": 3})
        assert code == 200 and res["indices"][0] == 7, res
        lib_stop_verb(verb, "serve-knn")
        log(f"serve-knn --points ({LIB_KNN_CLI_ROWS} corpus rows, .npy, "
            f"{card}): "
            f"/knnindex 7 -> {res['indices']}; SIGINT -> exit 0")
        part("the serve-knn verb")
    finally:
        for p in verbs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out, ignore_errors=True)
    log(f"library_phase launches on the LM paths: {json.dumps(launches)}; "
        f"parts, wall s ({card}): {json.dumps(part.seconds)}")
    return launches


# surface_phase: bench.py:3128's disaggregation model (head dim 16)
DISAGG_V, DISAGG_D, DISAGG_H = 64, 32, 2
DISAGG_CAP, DISAGG_PS = 96, 16
DISAGG_PROMPT, DISAGG_TOKENS = 32, 8
SURFACE_GEN_REQUESTS = 8
# the examples at tests/test_examples.py's settings
SURFACE_EXAMPLES = [
    ("lenet_mnist", ["--epochs", "2", "--batch", "128"],
     ["Accuracy", "checkpoint round trip OK"]),
    ("word2vec_text", [], ["nearest(king):", "vectors written"]),
    ("elastic_transformer", ["--epochs", "4"],
     ["restart == uninterrupted: OK", "Accuracy after resume"]),
    ("streaming_generation", ["--epochs", "1", "--gen-tokens", "8"],
     ["bounded session matches eager decode OK"]),
    ("tpu_transformer_generate",
     ["--epochs", "1", "--gen-tokens", "8", "--trace", "{trace}"],
     ["running on CUDA", "generated:", "step profile:",
      "compile watch:"]),
]
# the examples whose training runs the three flash kernels
ATTENTION_EXAMPLES = ("elastic_transformer", "streaming_generation",
                      "tpu_transformer_generate")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")


def surface_readme_quickstart(card):
    """README.md's quickstart through the package's top-level names:
    LeNet, 8 batches of the MNIST surrogate, evaluated."""
    import math as _math
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
    conf = (NeuralNetConfiguration.builder()
            .set_seed(12345)
            .updater(updaters.adam(1e-3))
            .list()
            .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    t0 = time.perf_counter()
    net.fit(MnistDataSetIterator(128, train=True, n=1024), epochs=1)
    acc = net.evaluate(MnistDataSetIterator(256, train=False, n=1024,
                                            shuffle=False)).accuracy()
    loss = float(net.score_value)
    assert _math.isfinite(loss) and 0.0 <= acc <= 1.0, (loss, acc)
    log(f"README quickstart on {net.device} ({card}): 8 batches of 128 "
        f"in {time.perf_counter() - t0:.2f} s, loss {loss:.4f}, "
        f"accuracy {acc:.4f} on 1024 surrogate test digits")


def surface_v1_fixtures():
    """The committed v1 zips restored on the card, their outputs held
    to ``*_io.npz`` (rtol 1e-4, atol 1e-5)."""
    import numpy as np
    from deeplearning4j_tpu_torch.util.model_serializer import restore_model
    for name in ("mln_v1", "cg_v1"):
        model = restore_model(os.path.join(FIXTURES, f"{name}.zip"),
                              device="cuda")
        io_ = np.load(os.path.join(FIXTURES, f"{name}_io.npz"))
        out = model.output(io_["x"])
        out = (out[0] if isinstance(out, (list, tuple)) else out)
        out = out.cpu().numpy()
        diff = float(np.abs(out - io_["out"]).max())
        np.testing.assert_allclose(out, io_["out"], rtol=1e-4, atol=1e-5)
        log(f"{name}.zip on the card: outputs vs {name}_io.npz max |diff| "
            f"{diff:.3e} (rtol 1e-4, atol 1e-5)")


def surface_disagg_generate(attn, da, card):
    """bench.py:3128's disaggregation model (V=64, width 32 over 2 heads:
    head dim 16) trained one Adam step, then served through
    ``/v1/generate``: SURFACE_GEN_REQUESTS concurrent requests of
    DISAGG_PROMPT ids, greedy ids against the same model's on the plain
    decode attention, the decode kernel's launches moving."""
    import numpy as np
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import InputType, updaters
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        EmbeddingSequenceLayer, RnnOutputLayer, TransformerEncoderLayer)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    conf = (NeuralNetConfiguration.builder().set_seed(0)
            .updater(updaters.adam(1e-3)).list()
            .layer(EmbeddingSequenceLayer(n_in=DISAGG_V, n_out=DISAGG_D))
            .layer(TransformerEncoderLayer(n_heads=DISAGG_H, causal=True))
            .layer(RnnOutputLayer(n_out=DISAGG_V, loss="mcxent"))
            .set_input_type(InputType.recurrent(DISAGG_V, DISAGG_CAP))
            .build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, DISAGG_V, (8, DISAGG_PROMPT + 1))
    y = np.eye(DISAGG_V, dtype=np.float32)[ids[:, 1:]]
    fwd0, dq0 = (attn.flash_attention_fwd_cuda.launches,
                 attn.flash_attention_bwd_dq_cuda.launches)
    net.fit(DataSet(ids[:, :-1].astype(np.float32), y))
    loss = float(net.score_value)
    assert math.isfinite(loss), loss
    assert attn.flash_attention_fwd_cuda.launches > fwd0
    assert attn.flash_attention_bwd_dq_cuda.launches > dq0
    registry = ModelRegistry()
    registry.register("disagg", net)
    server = ModelServer(registry, slots=4, capacity=DISAGG_CAP,
                         page_size=DISAGG_PS).start()
    bodies = [{"model": "disagg", "n_tokens": DISAGG_TOKENS,
               "prompt": rng.integers(1, DISAGG_V, DISAGG_PROMPT).tolist()}
              for _ in range(SURFACE_GEN_REQUESTS)]
    replies = [None] * len(bodies)
    try:
        dec0 = da.decode_attention_cuda.launches

        def client(i):
            replies[i] = http(server.port, "/v1/generate", bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        launches = da.decode_attention_cuda.launches - dec0
        batcher, _ = server.batcher_for("disagg")
        assert batcher._paged
    finally:
        server.stop(drain=True)
    assert all(r is not None and r[0] == 200 for r in replies), replies
    assert launches > 0, "the decode kernel did not run"
    compared = sum(check_greedy(net, da, b["prompt"], r[1]["ids"],
                                n_tokens=DISAGG_TOKENS,
                                capacity=DISAGG_CAP)
                   for b, r in zip(bodies, replies))
    log(f"disaggregation model (bench.py:3128: V={DISAGG_V}, width "
        f"{DISAGG_D}, {DISAGG_H} heads of {DISAGG_D // DISAGG_H}) on "
        f"{card}: one Adam step (loss {loss:.4f}), then "
        f"{len(bodies)} concurrent /v1/generate requests of "
        f"{DISAGG_PROMPT} ids x {DISAGG_TOKENS} tokens on 4 paged slots: "
        f"decode_attention launches {launches}; {compared} greedy ids "
        "equal to the plain decode attention's")


def surface_examples(attn, da, card, tmp):
    """The card-runnable examples with ``--device cuda``, in this
    process: the lines tests/test_examples.py asserts, and the flash
    forward, dq and dk/dv launches of the attention examples."""
    import contextlib
    import importlib
    import io as _io
    counters = {"fwd": attn.flash_attention_fwd_cuda,
                "dq": attn.flash_attention_bwd_dq_cuda,
                "dkv": attn.flash_attention_bwd_dkv_cuda,
                "decode": da.decode_attention_cuda}
    for name, args, lines in SURFACE_EXAMPLES:
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        argv = [a.replace("{trace}", os.path.join(tmp, "trace.json"))
                for a in args] + ["--device", "cuda"]
        before = {k: w.launches for k, w in counters.items()}
        buf = _io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        secs = time.perf_counter() - t0
        out = buf.getvalue()
        moved = {k: w.launches - before[k] for k, w in counters.items()}
        if name == "tpu_transformer_generate":   # its exit status
            assert rc == 0, rc
        for line in lines:
            assert line in out, (name, line, out[-2000:])
        if name in ATTENTION_EXAMPLES:
            assert all(moved[k] > 0 for k in ("fwd", "dq", "dkv")), \
                (name, moved)
        tail = [ln for ln in out.splitlines()
                if any(x in ln for x in lines + ["launches", "compile"])]
        log(f"example {name} {' '.join(argv)} ({card}): {secs:.2f} s, "
            f"kernel launches {moved}; " + " | ".join(tail[-4:]))


def surface_evict(da, card):
    """``ModelServer.evict_model`` on the full-width LM (bench.py:982,
    seed 0) registered as v1 and v2: after both generate, v1 unregistered
    and evicted frees at least its parameter bytes plus its page pool's
    bytes (reckoned from their shapes) of ``memory_allocated``; v2 still
    answers 200 with its earlier ids; v1's series leave /metrics."""
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.updaters import tree_leaves
    from deeplearning4j_tpu_torch.ops.native import kernel_head_dim
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    registry = ModelRegistry()
    for _ in range(2):
        registry.register("lm", MultiLayerNetwork(
            MultiLayerConfiguration.from_dict(lm_config()),
            device="cuda").init(seed=0))
    server = ModelServer(registry, slots=SLOTS, capacity=CAPACITY,
                         page_size=PAGE).start()
    try:
        body = {"model": "lm", "prompt": list(range(1, 33)),
                "n_tokens": 8}
        ids = {}
        for v in (1, 2):
            code, reply, _ = http(server.port, "/v1/generate",
                                  dict(body, version=v))
            assert code == 200 and reply["model_version"] == v, reply
            ids[v] = reply["ids"]
        v1, _ = registry.resolve("lm", 1)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in tree_leaves(v1.params)
                          if isinstance(p, torch.Tensor))
        pages = server._batchers[("lm", 1)].session.pages_total() + 1
        pool_bytes = (2 * LAYERS * pages * PAGE * HEADS
                      * kernel_head_dim(D_MODEL // HEADS) * 4)
        del v1
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        registry.unregister("lm", version=1)
        drained = server.evict_model("lm", version=1)
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
        freed = before - after
        # the step graph's private pool leaves reserved memory only
        log(f"evict_model('lm', version=1) ({card}): drained {drained}; "
            f"memory_reserved {reserved} -> {torch.cuda.memory_reserved()} "
            f"B; memory_allocated {before} -> {after} B, freed {freed} B; "
            f"v1's parameters {param_bytes} B + page pool {pool_bytes} B "
            f"({pages} pages x {PAGE} x {HEADS} heads x "
            f"{kernel_head_dim(D_MODEL // HEADS)} x 4 B x k, v x {LAYERS} "
            f"layers) = {param_bytes + pool_bytes} B")
        assert drained
        assert freed >= param_bytes + pool_bytes, (freed, param_bytes,
                                                   pool_bytes)
        code, reply, _ = http(server.port, "/v1/generate", body)
        assert code == 200 and reply["model_version"] == 2, reply
        assert reply["ids"] == ids[2], (reply["ids"], ids[2])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics?format=prometheus",
                timeout=60) as resp:
            text = resp.read().decode()
        assert "generate/lm/v1" not in text and "generate/lm/v2" in text
        log("v2 answers 200 with its earlier ids; generate/lm/v1's series "
            "are gone from /metrics, generate/lm/v2's remain")
    finally:
        server.stop(drain=True)


def surface_phase(attn, da, card):
    """The package's public surface on the card: the README quickstart
    through the top-level names, the v1 checkpoint fixtures, the
    head-dim-16 disaggregation model served through ``/v1/generate``,
    the examples, and ``evict_model`` on the full-width LM. Returns the
    four kernels' launches in the phase (counts set to 0 just before,
    read just after)."""
    wrappers = {"flash_attention_fwd": attn.flash_attention_fwd_cuda,
                "flash_attention_bwd_dq": attn.flash_attention_bwd_dq_cuda,
                "flash_attention_bwd_dkv":
                    attn.flash_attention_bwd_dkv_cuda,
                "decode_attention": da.decode_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="surface-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        surface_readme_quickstart(card)
        surface_v1_fixtures()
        surface_disagg_generate(attn, da, card)
        surface_examples(attn, da, card, tmp)
        surface_evict(da, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"surface_phase kernel launches: {launches}")
    return launches

# the head-dim-256 model path: the LM's config over WIDE_LM_HEADS heads
WIDE_LAYERS = 2            # its depth (the width is the LM's)
WIDE_PREDICT_B = 2         # rows of the predict held against the plain one
WIDE_GEN_REQUESTS = 4      # concurrent /v1/generate requests
WIDE_GEN_PROMPT, WIDE_GEN_TOKENS, WIDE_CAP = 64, 8, 128


def wide_head_phase(attn, da, card):
    """The LM's config (V, D_MODEL, T) over WIDE_LM_HEADS heads, head dim
    D_MODEL / WIDE_LM_HEADS = 256 (the forward's and the backward's
    two-warpgroup kernels), at depth
    WIDE_LAYERS: a predict (``output``) and one step's loss and gradients
    held against the same model on the plain attention on the card, one
    Adam step through ``fit``, then WIDE_GEN_REQUESTS concurrent greedy
    ``/v1/generate`` requests on paged slots held against the plain
    decode attention's ids. Returns the four kernels' launches in the
    phase (counts set to 0 just before, read just after)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf import updaters
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.serving.http import ModelServer
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.util.model_serializer import _flatten
    wrappers = {"flash_attention_fwd": attn.flash_attention_fwd_cuda,
                "flash_attention_bwd_dq": attn.flash_attention_bwd_dq_cuda,
                "flash_attention_bwd_dkv":
                    attn.flash_attention_bwd_dkv_cuda,
                "decode_attention": da.decode_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    Dh = D_MODEL // WIDE_LM_HEADS
    conf = MultiLayerConfiguration.from_dict(lm_config(
        updaters.adam(TRAIN_LR), layers=WIDE_LAYERS, heads=WIDE_LM_HEADS))
    net = MultiLayerNetwork(conf, device="cuda").init(seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (TRAIN_B, T)).astype("float32")
    y = np.eye(V, dtype="float32")[rng.integers(0, V, (TRAIN_B, T))]
    ds = DataSet(ids, y)

    # a predict, kernels vs plain attention
    out = net.output(ids[:WIDE_PREDICT_B])
    before = attn.flash_attention_fwd_cuda.launches
    with plain_attention(attn):
        plain_out = net.output(ids[:WIDE_PREDICT_B])
    assert attn.flash_attention_fwd_cuda.launches == before
    torch.testing.assert_close(out, plain_out, atol=1e-6, rtol=1e-4)
    assert out.shape == (WIDE_PREDICT_B, T, V), tuple(out.shape)
    pred_err = (out - plain_out).abs().max().item()
    # one step's loss and gradients, kernels vs plain attention
    batch = net._batch_tuple(ds)
    loss_k, grads_k, _ = net._gradients(batch)
    with plain_attention(attn):
        loss_p, grads_p, _ = net._gradients(batch)
    torch.cuda.synchronize()
    worst = 0.0
    flat_k, flat_p = _flatten(grads_k), _flatten(grads_p)
    assert flat_k.keys() == flat_p.keys()
    for path, gp in flat_p.items():
        scale = float(np.abs(gp).max())
        e = float(np.abs(flat_k[path] - gp).max())
        assert e <= GRAD_RTOL * scale + 1e-12, (path, e, scale)
        worst = max(worst, e / max(scale, 1e-30))
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    del grads_k, grads_p, flat_k, flat_p
    # one Adam step through fit
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    net.fit(ds)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(net.score_value)
    assert math.isfinite(loss), loss
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert wrappers[k].launches - before[k] == WIDE_LAYERS, \
            (k, wrappers[k].launches - before[k])

    registry = ModelRegistry()
    registry.register("wide", net)
    server = ModelServer(registry, slots=4, capacity=WIDE_CAP,
                         page_size=PAGE).start()
    bodies = [{"model": "wide", "n_tokens": WIDE_GEN_TOKENS,
               "prompt": rng.integers(1, V, WIDE_GEN_PROMPT).tolist()}
              for _ in range(WIDE_GEN_REQUESTS)]
    replies = [None] * len(bodies)
    try:
        dec0 = da.decode_attention_cuda.launches

        def client(i):
            replies[i] = http(server.port, "/v1/generate", bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        decodes = da.decode_attention_cuda.launches - dec0
        batcher, _ = server.batcher_for("wide")
        assert batcher._paged
    finally:
        server.stop(drain=True)
    assert all(r is not None and r[0] == 200 for r in replies), replies
    assert decodes > 0, "the decode kernel did not run"
    launches = {k: w.launches for k, w in wrappers.items()}
    compared = sum(check_greedy(net, da, b["prompt"], r[1]["ids"],
                                n_tokens=WIDE_GEN_TOKENS,
                                capacity=WIDE_CAP)
                   for b, r in zip(bodies, replies))
    log(f"head dim {Dh} (the LM's V={V}, width {D_MODEL}, T={T} over "
        f"{WIDE_LM_HEADS} heads, depth {WIDE_LAYERS}) on {card}: predict "
        f"of {WIDE_PREDICT_B} rows max |kernels - plain| {pred_err:.3e} "
        f"(atol 1e-6, rtol 1e-4); a step's loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f}, worst gradient max|diff| / max|grad| "
        f"{worst:.3e} (limit {GRAD_RTOL}); one Adam step through fit "
        f"{step_s:.3f} s (loss {loss:.4f}); {len(bodies)} concurrent "
        f"/v1/generate requests of {WIDE_GEN_PROMPT} ids x "
        f"{WIDE_GEN_TOKENS} tokens on 4 paged slots: {compared} greedy "
        f"ids equal to the plain decode attention's; launches {launches}")
    return launches


# the rank examples at tests/test_examples.py's settings; their ranks
# share the card under gloo
RANK_EXAMPLES = {
    "data_parallel_resnet": (["--img", "32", "--steps", "3"],
                             ["4 devices", "final loss"]),
    "long_context_lm": (["--epochs", "8"],
                        ["data=2 x seq=2",
                         "matches single-device params: True"]),
}
RANK_EXAMPLE_WORLD = 4
RANK_EXAMPLE_TIMEOUT_S = 300


def example_rank_main(out, name, argv):
    """One rank of a rank example: ``python3 chip_smoke.py example-rank
    DIR NAME ARGS...`` with the multihost variables set. Runs the
    example's ``main(ARGS)`` as that rank and writes DIR/NAME_rank{i}.json:
    its exit status, what it printed, the kernels' launches."""
    import contextlib
    import importlib
    import io as _io
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import native
    mod = importlib.import_module(
        f"deeplearning4j_tpu_torch.examples.{name}")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    rank = int(os.environ["DL4J_TPU_PROCESS_ID"])
    with open(os.path.join(out, f"{name}_rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "stdout": buf.getvalue(),
                   "launches": native.launch_counts()}, f)
    return rc


def start_example_ranks(name, argv, out):
    """Start RANK_EXAMPLE_WORLD ranks of ``example-rank`` over the card
    (``wait_example_ranks`` collects them)."""
    port = free_ports(1)
    procs = []
    for rank in range(RANK_EXAMPLE_WORLD):
        env = dict(os.environ, DL4J_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   DL4J_TPU_NUM_PROCESSES=str(RANK_EXAMPLE_WORLD),
                   DL4J_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, RANK_SCRIPT, "example-rank", out, name]
            + argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def wait_example_ranks(name, procs, out):
    """Each rank's result of ``start_example_ranks``; fails on a rank's
    exit code, and stops them all after RANK_EXAMPLE_TIMEOUT_S."""
    logs = []
    deadline = time.monotonic() + RANK_EXAMPLE_TIMEOUT_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    results = []
    for rank, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"{name} rank {rank} exited "
                                   f"{p.returncode}:\n{text[-6000:]}")
        with open(os.path.join(out, f"{name}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def rank_examples_phase(attn, card):
    """The two rank examples with ``--device cuda``, their
    RANK_EXAMPLE_WORLD ranks each sharing the card under gloo, at
    tests/test_examples.py's settings and with the lines it asserts, the
    two at once: ``long_context_lm``'s ranks started here through
    ``example-rank`` (each counts its kernel launches: the ring's flash
    forward, dq and dk/dv at head dim 4, padded to 32), then
    ``data_parallel_resnet`` as a user runs it (its ``main`` starts its
    own ranks). Returns the three flash kernels' launches summed over
    long_context_lm's ranks."""
    import contextlib
    import importlib
    import io as _io
    from deeplearning4j_tpu_torch.examples import _ranks
    assert not _ranks.is_rank()
    lc_argv, lc_lines = RANK_EXAMPLES["long_context_lm"]
    tmp = tempfile.mkdtemp(prefix="rank-examples-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        t_lc = time.perf_counter()
        procs = start_example_ranks("long_context_lm",
                                    lc_argv + ["--device", "cuda"], tmp)
        try:
            argv, lines = RANK_EXAMPLES["data_parallel_resnet"]
            mod = importlib.import_module(
                "deeplearning4j_tpu_torch.examples.data_parallel_resnet")
            buf = _io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv + ["--device", "cuda"])
            secs = time.perf_counter() - t0
        finally:
            ranks = wait_example_ranks("long_context_lm", procs, tmp)
        lc_secs = time.perf_counter() - t_lc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = buf.getvalue()
    assert rc == 0, (rc, out[-2000:])
    for line in lines:
        assert line in out, ("data_parallel_resnet", line, out[-2000:])
    log(f"example data_parallel_resnet {' '.join(argv)} --device cuda "
        f"({card}, {RANK_EXAMPLE_WORLD} ranks it started, gloo, beside "
        f"long_context_lm's): {secs:.2f} s; "
        + " | ".join(out.strip().splitlines()[-2:]))
    argv, lines, secs = lc_argv, lc_lines, lc_secs
    out = ranks[0]["stdout"]
    for line in lines:
        assert line in out, ("long_context_lm", line, out[-2000:])
    names = {"flash_attention_fwd": attn.flash_attention_fwd_cuda.__name__,
             "flash_attention_bwd_dq":
                 attn.flash_attention_bwd_dq_cuda.__name__,
             "flash_attention_bwd_dkv":
                 attn.flash_attention_bwd_dkv_cuda.__name__}
    for r in ranks:
        assert r["rc"] == 0, r
        assert all(r["launches"][n] > 0 for n in names.values()), \
            r["launches"]
    launches = {k: sum(r["launches"][n] for r in ranks)
                for k, n in names.items()}
    log(f"example long_context_lm {' '.join(argv)} --device cuda ({card}, "
        f"{RANK_EXAMPLE_WORLD} ranks through example-rank, gloo): "
        f"{secs:.2f} s; flash launches over the ranks {launches}; "
        + " | ".join(out.strip().splitlines()[-2:]))
    return launches


def tensor_core_ops(native):
    """HMMA (tensor-core) instructions in each kernel function of the
    built libraries, from ``cuobjdump -sass``: {"dq_kernel<64>": n, ...}.
    Fails unless all fifteen kernel functions (the forward, dq and
    dk/dv, each at D = 32, 64 and 128, their wide variants at 128-wide
    chunks, the two-warpgroup forward past 128 up to 256, and the
    two-warpgroup dq and dk/dv at 256) are there and each has at least
    one (a build that fell back to FMA code has none)."""
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    counts = {}
    kernels = ("flash_fwd_kernel", "dq_kernel", "dkv_kernel",
               "flash_fwd_wide_kernel", "dq_wide_kernel", "dkv_wide_kernel",
               "flash_fwd_pair_kernel", "dq_pair_kernel", "dkv_pair_kernel")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", native._target(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            name = kernel_name(part.split("\n", 1)[0])
            counts[name] = len(re.findall(r"\bHMMA\b", part))
    log("tensor-core (HMMA) instructions per kernel function (cuobjdump "
        "-sass): " + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
    expected = ({f"{kernel}<{d}>" for kernel in kernels[:3]
                 for d in (32, 64, 128)}
                | {f"{kernel}<128>" for kernel in kernels[3:6]}
                | set(kernels[6:]))
    assert set(counts) == expected, counts
    for k, n in counts.items():
        assert n > 0, f"{k} has no tensor-core instruction"
    return counts


# a flash kernel function in a mangled symbol: its name and, for a
# template, its head dim or chunk width
FLASH_KERNEL = re.compile(
    r"(flash_fwd_kernel|dq_kernel|dkv_kernel|flash_fwd_wide_kernel"
    r"|dq_wide_kernel|dkv_wide_kernel|flash_fwd_pair_kernel"
    r"|dq_pair_kernel|dkv_pair_kernel)"
    r"(?:ILi(\d+)E)?")


def kernel_name(sym):
    """"dq_kernel<64>" or "dq_pair_kernel" from a flash kernel function's
    mangled symbol; any other symbol as it is."""
    m = FLASH_KERNEL.search(sym)
    if not m:
        return sym.strip()
    return f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)


def ptxas_functions(report):
    """{"dq_pair_kernel": (registers, spill store bytes, spill load
    bytes), ...} of every kernel function in an ``nvcc -Xptxas -v``
    report (a function's spills summed with those of the functions it
    calls, which ptxas reports after it)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = [None, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1] += int(m.group(1))
            out[name][2] += int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


PHASE_S = {}               # wall seconds of each phase of main()


def timed(name, phase, *args):
    """``phase(*args)``, its wall time logged and kept in PHASE_S."""
    import torch
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_S[name] = time.perf_counter() - t0
    log(f"{name}: {PHASE_S[name]:.1f} s")
    # a phase's models, and their captured graphs' pools, go with it
    gc.collect()
    torch.cuda.empty_cache()
    return out


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.ops import attention as attn
    from deeplearning4j_tpu_torch.ops import decode_attention as da
    from deeplearning4j_tpu_torch.ops import native

    card = card_name()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    for name, report in native.build_all().items():
        log(f"built {name}.cu for sm_90a:")
        functions = ptxas_functions(report)
        for fn, (regs, stores, loads) in functions.items():
            log(f"  {fn}: {regs} registers, {stores} bytes spill stores, "
                f"{loads} bytes spill loads")
            assert (stores, loads) == (0, 0), \
                f"{name}.cu: {fn} spills registers"
        # the two-warpgroup kernels among them
        for fn in {"flash_attention_fwd": ("flash_fwd_pair_kernel",),
                   "flash_attention_bwd": ("dq_pair_kernel",
                                           "dkv_pair_kernel")}.get(name, ()):
            assert fn in functions, (fn, sorted(functions))
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    hmma = tensor_core_ops(native)
    # first: the port keeps float32 float32 whatever the caller set;
    # every later phase runs with both TF32 flags off (the layers'
    # doing)
    timed("tf32_phase", tf32_phase, card)

    fwd = timed("kernel_phase", kernel_phase, attn)
    dq, dkv = timed("backward_kernel_phase", backward_kernel_phase, attn)
    dec = timed("decode_kernel_phase", decode_kernel_phase, da)
    # the instantiations the main path launches (D = 64)
    fwd["tensor_core_ops"] = hmma["flash_fwd_kernel<64>"]
    dq["tensor_core_ops"] = hmma["dq_kernel<64>"]
    dkv["tensor_core_ops"] = hmma["dkv_kernel<64>"]
    # each path's launches: counts set to 0 just before it, read after;
    # a kernel on several paths reports each and their sum
    fwd_serve = timed("slice_phase", slice_phase, attn, card)
    train_launches = timed("train_phase", train_phase, attn, card)
    dq["launches"] = train_launches["flash_attention_bwd_dq"]
    dkv["launches"] = train_launches["flash_attention_bwd_dkv"]
    dec_generate, net, server, bodies = timed("generate_phase",
                                              generate_phase, da, card)
    try:
        crash_drill(server, net, da)
        timed("serving_surface_phase", serving_surface_phase, attn, da,
              card, net, server)
    finally:
        server.stop(drain=True)
    timed("warmup_phase", warmup_phase, card)
    fwd_fleet, dec_fleet = timed("fleet_phase", fleet_phase, attn, da,
                                 card, bodies)
    del net
    torch.cuda.empty_cache()
    timed("cnn_phase", cnn_phase, card)
    fwd_rnn, dec_rnn = timed("rnn_phase", rnn_phase, attn, da, card)
    timed("layers_phase", layers_phase, card)
    fwd_keras = timed("keras_phase", keras_phase, attn, card)
    timed("zoo_phase", zoo_phase, card)
    timed("pretrain_phase", pretrain_phase, card)
    timed("etl_phase", etl_phase, card)
    timed("eval_phase", eval_phase, card)
    captured = timed("capture_phase", capture_phase, attn, card)
    timed("kstep_phase", kstep_phase, card)
    timed("aot_warmup_phase", aot_warmup_phase, card)
    timed("checkpoint_phase", checkpoint_phase, card)
    timed("retrieval_phase", retrieval_phase, card)
    fwd_ctl, dec_ctl = timed("fleet_control_phase", fleet_control_phase,
                             attn, da, card)
    ps = timed("ps_phase", ps_phase, attn, card)
    dp_dir = tempfile.mkdtemp(prefix="dp-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        dp = timed("dp_phase", dp_phase, attn, card, dp_dir)
        tsp = timed("tp_sp_pp_phase", tp_sp_pp_phase, attn, card, dp_dir)
    finally:
        shutil.rmtree(dp_dir, ignore_errors=True)
    mfleet = timed("mesh_fleet_phase", mesh_fleet_phase, card)
    timed("nlp_phase", nlp_phase, card)
    lib = timed("library_phase", library_phase, attn, card)
    surface = timed("surface_phase", surface_phase, attn, da, card)
    wide = timed("wide_head_phase", wide_head_phase, attn, da, card)
    ranked = timed("rank_examples_phase", rank_examples_phase, attn, card)
    fwd["launches_by_path"] = {"serve": fwd_serve, "fleet": fwd_fleet,
                               "rnn": fwd_rnn, "keras": fwd_keras,
                               "capture": captured["flash_attention_fwd"],
                               "fleet_control": fwd_ctl,
                               "ps": ps["flash_attention_fwd"],
                               "dp": dp["flash_attention_fwd"],
                               "tp_sp_pp": tsp["flash_attention_fwd"],
                               "mesh_fleet": mfleet,
                               "library": lib["flash_attention_fwd"],
                               "surface": surface["flash_attention_fwd"],
                               "wide_head": wide["flash_attention_fwd"],
                               "rank_examples":
                                   ranked["flash_attention_fwd"]}
    dec["launches_by_path"] = {"generate": dec_generate,
                               "fleet": dec_fleet, "rnn": dec_rnn,
                               "fleet_control": dec_ctl,
                               "surface": surface["decode_attention"],
                               "wide_head": wide["decode_attention"]}
    for record, name in ((dq, "flash_attention_bwd_dq"),
                         (dkv, "flash_attention_bwd_dkv")):
        record["launches_by_path"] = {"train": record["launches"],
                                      "capture": captured[name],
                                      "ps": ps[name], "dp": dp[name],
                                      "tp_sp_pp": tsp[name],
                                      "library": lib[name],
                                      "surface": surface[name],
                                      "wide_head": wide[name],
                                      "rank_examples": ranked[name]}
    for record in (fwd, dq, dkv, dec):
        record["launches"] = sum(record["launches_by_path"].values())
    records = [fwd, dq, dkv, dec]
    for record in records:
        assert record["launches"] > 0, record
        for key in ("ms", "plain_ms", "bound_ms", "bound_cuda_core_ms",
                    "library_ms", "max_abs_err"):
            assert math.isfinite(record[key]), (key, record[key])
    log("seconds by phase: " + json.dumps(
        {k: round(v, 1) for k, v in PHASE_S.items()}))
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["stream-client"]:
        sys.exit(stream_client_main(sys.argv[2]))
    if sys.argv[1:2] == ["example-rank"]:
        sys.exit(example_rank_main(sys.argv[2], sys.argv[3],
                                   sys.argv[4:]))
    sys.exit(main())
