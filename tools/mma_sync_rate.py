#!/usr/bin/env python3
"""The rate of the H100's tensor cores through ``mma.sync`` at the
attention kernels' instruction shape, and so the ceiling of a 3xTF32
kernel built on it (csrc/tf32_mma.cuh).

    python3 tools/mma_sync_rate.py

Builds (nvcc, sm_90a, into build/kernels/) a kernel whose warps issue
nothing but ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` in
``CHAINS`` independent accumulator chains, launches it with 1 to 4
warps on each of the SM's four schedulers (4 blocks of 1-4 warps an SM), times each with CUDA events, and prints one
JSON line: the card, the TF32 TFLOP/s reached at each warp count and
the f32-accurate ceiling of three passes (a third of the best). It
imports nothing of JAX or of the JAX package.
"""

import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  float d[CHAINS][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 ^ 1, a2 = a0 ^ 2, a3 = a0 ^ 3;
  uint32_t b0 = a0 ^ 5, b1 = a0 ^ 6;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(float* out, int blocks, int threads, int iters,
                        void* stream) {
  mma_loop<8><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
CHAINS = 8
ITERS = 4096


def main():
    import torch
    if not torch.cuda.is_available():
        print("mma_sync_rate: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from deeplearning4j_tpu_torch.ops import native
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "mma_sync_rate.cu")
    lib_path = os.path.join(native.BUILD_DIR, "mma_sync_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib_path).mma_rate
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for warps in (1, 2, 3, 4):
        blocks = sms * 4
        out = torch.empty(blocks * 32 * warps, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            assert fn(out.data_ptr(), blocks, 32 * warps, ITERS, stream) == 0
        run()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            run()
        t1.record()
        torch.cuda.synchronize()
        sec = t0.elapsed_time(t1) / 5 / 1e3
        flops = 2.0 * 16 * 8 * 8 * CHAINS * ITERS * blocks * warps
        rates[f"{warps} warps a scheduler"] = flops / sec / 1e12
    best = max(rates.values())
    print(json.dumps({"card": card, "instruction": "mma.sync m16n8k8 tf32",
                      "chains_a_warp": CHAINS, "tf32_tflops": rates,
                      "three_pass_f32_tflops": best / 3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
