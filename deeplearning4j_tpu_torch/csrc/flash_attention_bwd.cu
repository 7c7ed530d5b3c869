// Flash-attention backward for Hopper (sm_90a), float32 in, float32 out.
//
// Replaces the two Pallas TPU kernels of deeplearning4j_tpu/ops/
// attention.py launched by pallas_flash_attention_bwd: _dq_kernel and
// _dkv_kernel. Same function: with the forward's o and lse (B, H, T),
//
//   delta = rowsum(do * o)
//   p     = exp(q.k * scale - lse), 0 where lse <= -1e30/2 or where the
//           causal mask or the (B, T) kv_mask hides the key
//   ds    = p * (do.v - delta) * scale
//   dq    = ds . k,   dk = ds^T . q,   dv = p^T . do
//
// Same split as the TPU: dq is summed over keys inside one CTA per
// query tile, dk and dv over queries inside one CTA per key tile. No
// atomics, so every run gives the same bits.
//
// Bound on an H100: at the LM shape (B=8, T=1024, H=16, D=64, causal)
// there are 6.7e7 live (query, key) pairs; dq does 6*D FLOPs per pair
// (s, dp, dq: 2.6e10, >= 0.385 ms at the 67 TFLOP/s CUDA-core f32 rate)
// and dk/dv 8*D (s, dp, dv, dk: 3.4e10, >= 0.513 ms), against ~0.2 GB
// of operands (~0.06 ms at 3.35 TB/s). Both are bound by operations, so
// every operand of the inner products stays on chip:
//
//   - delta: one warp per (b, h, t) row, a pre-pass of the dq entry;
//   - dq: one CTA per (64-row query tile, b*h), one thread per query
//     row, as the forward: q and do tiles staged once in shared memory
//     (rows padded by four floats for conflict-free float4 reads of a
//     thread's own row), K/V in 32-key tiles read back as float4
//     broadcasts. The D-float dq accumulator and 32 scores (16 at
//     D = 128, so nothing spills) live in
//     registers; p and then ds go through a [key][thread] shared array,
//     so scores and dp are never held at once;
//   - dk/dv: one CTA per (64-key tile, b*h), TWO threads per key row,
//     each holding interleaved float4 halves of the row's dk and dv
//     accumulators (D floats a thread in all, as dq); a pair adds its
//     half dot products with one shuffle. K and V rows stay in shared
//     memory (rows padded by eight floats), q/do in 32-query tiles
//     (16 at D = 128);
//   - causal: dq stops at its last row's diagonal, dk/dv starts at the
//     first query tile that reaches its first key; the heaviest tiles
//     are scheduled first.
//
// Any T (the ragged edge masked), D in {32, 64, 128}, strides in
// elements (the last dimension contiguous, rows 16-byte aligned).
//
// C interface (loaded with ctypes), one entry per TPU kernel, each
// returning cudaGetLastError() after its launches (0 on success); they
// allocate nothing:
//   dl4j_flash_attention_bwd_dq_f32   writes dq and delta (B, H, T);
//   dl4j_flash_attention_bwd_dkv_f32  reads delta, writes dk and dv.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;    // dq: query rows per CTA, one thread each
constexpr int kBlockKV = 64;   // dk/dv: key rows per CTA
constexpr int kThreadsKV = 2 * kBlockKV;   // two threads per key row

// Keys per shared tile in dq, queries per shared tile in dk/dv: the
// tile's scores live in registers beside D accumulator floats, so at
// D = 128 the tile halves to stay within 255 registers without spills.
__host__ __device__ constexpr int tile_rows(int D) {
  return D == 128 ? 16 : 32;
}
constexpr float kNegInf = -1e30f;
constexpr float kDead = kNegInf * 0.5f;

struct Strides {
  long long b, t, h;
};

__global__ void delta_kernel(const float* __restrict__ o,
                             const float* __restrict__ dout,
                             float* __restrict__ delta, int rows, int T,
                             int H, int D, Strides so, Strides sdo) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // uniform across the warp
  const int bh = row / T;
  const int t = row - bh * T;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* orow = o + b * so.b + t * so.t + h * so.h;
  const float* drow = dout + b * sdo.b + t * sdo.t + h * sdo.h;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;   // row == bh * T + t
}

template <int D>
__global__ void __launch_bounds__(kBlockQ)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ kv_mask, float* __restrict__ dq,
          int T, int H, Strides sq, Strides sk, Strides sv, Strides sdo,
          Strides sdq, float scale, int causal) {
  constexpr int QS = D + 4;        // padded q / do row stride (floats)
  constexpr int D4 = D / 4;
  constexpr int kBlockK = tile_rows(D);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // kBlockQ x QS
  float* do_s = q_s + kBlockQ * QS;                // kBlockQ x QS
  float* k_s = do_s + kBlockQ * QS;                // kBlockK x D
  float* v_s = k_s + kBlockK * D;                  // kBlockK x D
  float* p_s = v_s + kBlockK * D;                  // kBlockK x kBlockQ
  float* live_s = p_s + kBlockK * kBlockQ;         // kBlockK

  const int tid = threadIdx.x;
  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = q_tile * kBlockQ;
  const int qi = q0 + tid;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  float* dqb = dq + b * sdq.b + h * sdq.h;

  for (int i = tid; i < kBlockQ * D4; i += kBlockQ) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = x;
    if (q0 + r < T) {
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.t + c);
      y = *reinterpret_cast<const float4*>(dob + (q0 + r) * sdo.t + c);
    }
    *reinterpret_cast<float4*>(q_s + r * QS + c) = x;
    *reinterpret_cast<float4*>(do_s + r * QS + c) = y;
  }
  const float row_lse = (qi < T) ? lse[(long long)bh * T + qi] : kNegInf;
  const float row_delta = (qi < T) ? delta[(long long)bh * T + qi] : 0.f;
  const bool row_live = row_lse > kDead;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const int k_end = causal ? min(T, q0 + kBlockQ) : T;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBlockK * D4; i += kBlockQ) {
      const int r = i / D4;
      const int c = (i - r * D4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < T) {
        kx = *reinterpret_cast<const float4*>(kb + (k0 + r) * sk.t + c);
        vx = *reinterpret_cast<const float4*>(vb + (k0 + r) * sv.t + c);
      }
      *reinterpret_cast<float4*>(k_s + r * D + c) = kx;
      *reinterpret_cast<float4*>(v_s + r * D + c) = vx;
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      live_s[tid] = (kj < T && (kv_mask == nullptr ||
                                kv_mask[(long long)b * T + kj] > 0.f))
                        ? 1.f : 0.f;
    }
    __syncthreads();

    // p = exp(q.k * scale - lse) for the 32 keys, into p_s
    float s[kBlockK];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 qc = *reinterpret_cast<const float4*>(q_s + tid * QS + c);
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float4 kc = *reinterpret_cast<const float4*>(k_s + j * D + c);
        s[j] = fmaf(qc.x, kc.x, s[j]);
        s[j] = fmaf(qc.y, kc.y, s[j]);
        s[j] = fmaf(qc.z, kc.z, s[j]);
        s[j] = fmaf(qc.w, kc.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const bool ok = row_live && live_s[j] > 0.f &&
                      (!causal || k0 + j <= qi);
      p_s[j * kBlockQ + tid] = ok ? expf(s[j] * scale - row_lse) : 0.f;
    }

    // dp = do.v in the same registers, then ds = p (dp - delta) scale
    // in place of p (each thread touches only its own p column)
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 dc = *reinterpret_cast<const float4*>(do_s + tid * QS + c);
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const float4 vc = *reinterpret_cast<const float4*>(v_s + j * D + c);
        s[j] = fmaf(dc.x, vc.x, s[j]);
        s[j] = fmaf(dc.y, vc.y, s[j]);
        s[j] = fmaf(dc.z, vc.z, s[j]);
        s[j] = fmaf(dc.w, vc.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float* p = p_s + j * kBlockQ + tid;
      *p = *p * (s[j] - row_delta) * scale;
    }

    // dq += ds . k
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      const float ds = p_s[j * kBlockQ + tid];
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 kc = *reinterpret_cast<const float4*>(k_s + j * D + c);
        acc[c] = fmaf(ds, kc.x, acc[c]);
        acc[c + 1] = fmaf(ds, kc.y, acc[c + 1]);
        acc[c + 2] = fmaf(ds, kc.z, acc[c + 2]);
        acc[c + 3] = fmaf(ds, kc.w, acc[c + 3]);
      }
    }
  }

  // dq through the q tile, stored coalesced
  __syncthreads();
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(q_s + tid * QS + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
  __syncthreads();
  for (int i = tid; i < kBlockQ * D4; i += kBlockQ) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    if (q0 + r < T)
      *reinterpret_cast<float4*>(dqb + (q0 + r) * sdq.t + c) =
          *reinterpret_cast<const float4*>(q_s + r * QS + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsKV)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ kv_mask, float* __restrict__ dk,
           float* __restrict__ dv, int T, int H, Strides sq, Strides sk,
           Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
           int causal) {
  constexpr int KS = D + 8;        // padded k / v row stride (floats)
  constexpr int D4 = D / 4;
  constexpr int C2 = D / 8;        // float4 chunks a thread owns per row
  constexpr int kBlockQ2 = tile_rows(D);
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // kBlockKV x KS
  float* v_s = k_s + kBlockKV * KS;                // kBlockKV x KS
  float* q_s = v_s + kBlockKV * KS;                // kBlockQ2 x D
  float* do_s = q_s + kBlockQ2 * D;                // kBlockQ2 x D
  float* p_s = do_s + kBlockQ2 * D;                // kBlockQ2 x kThreadsKV
  float* ds_s = p_s + kBlockQ2 * kThreadsKV;       // kBlockQ2 x kThreadsKV
  float* lse_s = ds_s + kBlockQ2 * kThreadsKV;     // kBlockQ2
  float* delta_s = lse_s + kBlockQ2;               // kBlockQ2

  const int tid = threadIdx.x;
  const int r = tid >> 1;          // key row of the tile
  const int half = tid & 1;        // which interleaved float4 chunks
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kBlockKV;   // heaviest (causal) first
  const int kj = k0 + r;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;

  for (int i = tid; i < kBlockKV * D4; i += kThreadsKV) {
    const int rr = i / D4;
    const int c = (i - rr * D4) * 4;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vx = kx;
    if (k0 + rr < T) {
      kx = *reinterpret_cast<const float4*>(kb + (k0 + rr) * sk.t + c);
      vx = *reinterpret_cast<const float4*>(vb + (k0 + rr) * sv.t + c);
    }
    *reinterpret_cast<float4*>(k_s + rr * KS + c) = kx;
    *reinterpret_cast<float4*>(v_s + rr * KS + c) = vx;
  }
  const bool key_live = kj < T && (kv_mask == nullptr ||
                                   kv_mask[(long long)b * T + kj] > 0.f);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int d = 0; d < D / 2; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const int q_begin = causal ? (k0 / kBlockQ2) * kBlockQ2 : 0;
  for (int q0 = q_begin; q0 < T; q0 += kBlockQ2) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBlockQ2 * D4; i += kThreadsKV) {
      const int rr = i / D4;
      const int c = (i - rr * D4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = x;
      if (q0 + rr < T) {
        x = *reinterpret_cast<const float4*>(qb + (q0 + rr) * sq.t + c);
        y = *reinterpret_cast<const float4*>(dob + (q0 + rr) * sdo.t + c);
      }
      *reinterpret_cast<float4*>(q_s + rr * D + c) = x;
      *reinterpret_cast<float4*>(do_s + rr * D + c) = y;
    }
    if (tid < kBlockQ2) {
      const bool in = q0 + tid < T;
      lse_s[tid] = in ? lseb[q0 + tid] : kNegInf;
      delta_s[tid] = in ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();

    // s = k.q for the 32 queries: half dot products, then the pair's sum
    float s[kBlockQ2];
#pragma unroll
    for (int i = 0; i < kBlockQ2; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < C2; ++cc) {
      const int c = 8 * cc + 4 * half;
      const float4 kc = *reinterpret_cast<const float4*>(k_s + r * KS + c);
#pragma unroll
      for (int i = 0; i < kBlockQ2; ++i) {
        const float4 qc = *reinterpret_cast<const float4*>(q_s + i * D + c);
        s[i] = fmaf(kc.x, qc.x, s[i]);
        s[i] = fmaf(kc.y, qc.y, s[i]);
        s[i] = fmaf(kc.z, qc.z, s[i]);
        s[i] = fmaf(kc.w, qc.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBlockQ2; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      const bool ok = key_live && lse_s[i] > kDead &&
                      (!causal || kj <= q0 + i);
      p_s[i * kThreadsKV + tid] = ok ? expf(s[i] * scale - lse_s[i]) : 0.f;
    }

    // dp = v.do in the same registers, then ds = p (dp - delta) scale
#pragma unroll
    for (int i = 0; i < kBlockQ2; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < C2; ++cc) {
      const int c = 8 * cc + 4 * half;
      const float4 vc = *reinterpret_cast<const float4*>(v_s + r * KS + c);
#pragma unroll
      for (int i = 0; i < kBlockQ2; ++i) {
        const float4 dc = *reinterpret_cast<const float4*>(do_s + i * D + c);
        s[i] = fmaf(vc.x, dc.x, s[i]);
        s[i] = fmaf(vc.y, dc.y, s[i]);
        s[i] = fmaf(vc.z, dc.z, s[i]);
        s[i] = fmaf(vc.w, dc.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBlockQ2; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      ds_s[i * kThreadsKV + tid] =
          p_s[i * kThreadsKV + tid] * (s[i] - delta_s[i]) * scale;
    }

    // dv += p^T . do, dk += ds^T . q (own columns only: no sync)
#pragma unroll 2
    for (int i = 0; i < kBlockQ2; ++i) {
      const float p = p_s[i * kThreadsKV + tid];
      const float ds = ds_s[i * kThreadsKV + tid];
#pragma unroll
      for (int cc = 0; cc < C2; ++cc) {
        const int c = 8 * cc + 4 * half;
        const float4 dc = *reinterpret_cast<const float4*>(do_s + i * D + c);
        const float4 qc = *reinterpret_cast<const float4*>(q_s + i * D + c);
        dv_acc[4 * cc] = fmaf(p, dc.x, dv_acc[4 * cc]);
        dv_acc[4 * cc + 1] = fmaf(p, dc.y, dv_acc[4 * cc + 1]);
        dv_acc[4 * cc + 2] = fmaf(p, dc.z, dv_acc[4 * cc + 2]);
        dv_acc[4 * cc + 3] = fmaf(p, dc.w, dv_acc[4 * cc + 3]);
        dk_acc[4 * cc] = fmaf(ds, qc.x, dk_acc[4 * cc]);
        dk_acc[4 * cc + 1] = fmaf(ds, qc.y, dk_acc[4 * cc + 1]);
        dk_acc[4 * cc + 2] = fmaf(ds, qc.z, dk_acc[4 * cc + 2]);
        dk_acc[4 * cc + 3] = fmaf(ds, qc.w, dk_acc[4 * cc + 3]);
      }
    }
  }

  // each pair stores its row: 32 contiguous bytes per chunk step
  if (kj < T) {
    float* dkr = dk + b * sdk.b + kj * sdk.t + h * sdk.h;
    float* dvr = dv + b * sdv.b + kj * sdv.t + h * sdv.h;
#pragma unroll
    for (int cc = 0; cc < C2; ++cc) {
      const int c = 8 * cc + 4 * half;
      *reinterpret_cast<float4*>(dkr + c) =
          make_float4(dk_acc[4 * cc], dk_acc[4 * cc + 1],
                      dk_acc[4 * cc + 2], dk_acc[4 * cc + 3]);
      *reinterpret_cast<float4*>(dvr + c) =
          make_float4(dv_acc[4 * cc], dv_acc[4 * cc + 1],
                      dv_acc[4 * cc + 2], dv_acc[4 * cc + 3]);
    }
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* o, const float* dout, const float* lse,
              const float* kv_mask, float* dq, float* delta, int B, int T,
              int H, Strides sq, Strides sk, Strides sv, Strides so,
              Strides sdo, Strides sdq, float scale, int causal,
              cudaStream_t stream) {
  const int rows = B * H * T;
  constexpr int kRowsPerBlock = 8;   // one warp per row
  delta_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock,
                 32 * kRowsPerBlock, 0, stream>>>(o, dout, delta, rows, T,
                                                  H, D, so, sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBlockK = tile_rows(D);
  const size_t smem = sizeof(float) * (2 * kBlockQ * (D + 4) +
                                       2 * kBlockK * D +
                                       kBlockK * kBlockQ + kBlockK);
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  dq_kernel<D><<<grid, kBlockQ, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, dq, T, H, sq, sk, sv, sdo, sdq,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const float* kv_mask, float* dk, float* dv, int B, int T,
               int H, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdk, Strides sdv, float scale, int causal,
               cudaStream_t stream) {
  constexpr int kBlockQ2 = tile_rows(D);
  const size_t smem = sizeof(float) * (2 * kBlockKV * (D + 8) +
                                       2 * kBlockQ2 * D +
                                       2 * kBlockQ2 * kThreadsKV +
                                       2 * kBlockQ2);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBlockKV - 1) / kBlockKV, B * H);
  dkv_kernel<D><<<grid, kThreadsKV, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, dk, dv, T, H, sq, sk, sv, sdo,
      sdk, sdv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dl4j_flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_mask, void* dq,
    void* delta, int B, int T, int H, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dq_sb, long long dq_st, long long dq_sh,
    float scale, int causal, void* stream) {
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, so{o_sb, o_st, o_sh},
      sdo{do_sb, do_st, do_sh}, sdq{dq_sb, dq_st, dq_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* mf = static_cast<const float*>(kv_mask);
  float* dqf = static_cast<float*>(dq);
  float* deltaf = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<32>(qf, kf, vf, of, df, lf, mf, dqf, deltaf, B, T,
                           H, sq, sk, sv, so, sdo, sdq, scale, causal, st);
    case 64:
      return launch_dq<64>(qf, kf, vf, of, df, lf, mf, dqf, deltaf, B, T,
                           H, sq, sk, sv, so, sdo, sdq, scale, causal, st);
    case 128:
      return launch_dq<128>(qf, kf, vf, of, df, lf, mf, dqf, deltaf, B, T,
                            H, sq, sk, sv, so, sdo, sdq, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dl4j_flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_mask, void* dk,
    void* dv, int B, int T, int H, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long do_sb, long long do_st, long long do_sh,
    long long dk_sb, long long dk_st, long long dk_sh,
    long long dv_sb, long long dv_st, long long dv_sh,
    float scale, int causal, void* stream) {
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, sdo{do_sb, do_st, do_sh},
      sdk{dk_sb, dk_st, dk_sh}, sdv{dv_sb, dv_st, dv_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  const float* mf = static_cast<const float*>(kv_mask);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv<32>(qf, kf, vf, df, lf, deltaf, mf, dkf, dvf, B, T,
                            H, sq, sk, sv, sdo, sdk, sdv, scale, causal, st);
    case 64:
      return launch_dkv<64>(qf, kf, vf, df, lf, deltaf, mf, dkf, dvf, B, T,
                            H, sq, sk, sv, sdo, sdk, sdv, scale, causal, st);
    case 128:
      return launch_dkv<128>(qf, kf, vf, df, lf, deltaf, mf, dkf, dvf, B,
                             T, H, sq, sk, sv, sdo, sdk, sdv, scale, causal,
                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
