// Flash-attention forward for Hopper (sm_90a), float32 in, float32 out,
// both products on the tensor cores at f32 accuracy (3xTF32).
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/attention.py:
// _fwd_kernel (launched by pallas_flash_attention). Same function:
// exact softmax attention with the online max / denominator recurrence,
// optional causal mask, optional (B, T) key-padding mask, the -1e30
// sentinel rules (a masked score is -1e30 before the max, p = 0 where
// s <= -1e30/2, the rescale is 0 where the old max is), o = acc /
// max(l, 1e-30) and lse = m + log(l) (or -1e30 for a row that saw no
// key), lse stored (B, H, T). No atomics: every launch gives the same
// bits.
//
// Bound on an H100 SXM (data-sheet peaks, at its 700 W power limit): 4*D
// FLOPs per live (query, key) pair (2D for q.k^T, 2D for p.v); at the LM
// shape (B=8, T=1024, H=16, D=64, causal) that is 6.7e7 pairs, 1.7e10
// FLOPs, against ~0.13 GB of q, k, v, o and lse (~0.04 ms at 3.35 TB/s).
// The fastest f32-accurate route for the products is three TF32 passes
// on the tensor cores, 495 / 3 = 165 TFLOP/s: >= 0.104 ms, bound by
// operations (the CUDA cores' 67 TFLOP/s f32 would give 0.257 ms). So
// the design feeds the tensor cores from registers and shared memory and
// keeps everything else on chip:
//
//   - products: mma.sync m16n8k8 with TF32 operands and f32 accumulators
//     (tf32_mma.cuh), each operand split hi + lo and the product taken
//     as lo.hi + hi.lo + hi.hi: s = q.k^T, then o += p.v. The masks, the
//     row max, exp (as exp2: q is scaled by scale * log2(e) before its
//     split, so the logits come out in base 2) and the rescale stay f32
//     on the CUDA cores, in the accumulator registers;
//   - CTAs of 4 warps, each warp owning 16 query rows (64 a CTA); a
//     thread holds rows g and g + 8 of its warp. The row max of a tile is
//     reduced over the 4 lanes that share a row (two shuffles) before the
//     rescale; l stays a per-lane partial, reduced once at the end;
//   - q is resident for the whole key loop, so it is split into hi and lo
//     once per CTA, not once per key tile, in place in shared memory
//     beside a lo tile. Held in registers instead, q's fragments cost the
//     SM its third CTA at D = 64 and ran slower on an H100; at D = 32
//     they gained nothing;
//   - p reaches p.v without moving: the C fragments of the score tile
//     are read as A fragments with the key order permuted, and v's rows
//     are read in the same order (tf32_mma.cuh), so there is no trip
//     through shared memory and no shuffle;
//   - the accumulator is D/8 C fragments (D/2 floats a thread). Each
//     tile's p.v goes into a partial that is added to acc * corr with an
//     f32 fma: the tensor core truncates its sums, and one accumulator
//     over a whole row of keys would gather that bias;
//   - k, v and the kv_mask row stream through a two-stage ring in dynamic
//     shared memory with cp.async, the next tile's copy issued before
//     this tile's products. Rows are padded to D + 4 floats, so every
//     fragment load is free of bank conflicts. A tile is 32 keys, so
//     nothing spills at D = 32, 64 and 128;
//   - causal: a CTA stops at its last row's diagonal, a warp skips a tile
//     that lies wholly past its last row, and the grid runs over (b*h,
//     tile) with the heaviest tiles of every head first.
//
// Unlike the TPU kernel there is no block-divisibility rule: the ragged
// edge of T is zero-filled by the copies and masked, so any T works. The
// TPU's sequential 'arbitrary' grid axis with VMEM scratch becomes the
// key loop inside the CTA.
//
// Head dims 129-256 (flash_fwd_pair_kernel): a warp's o accumulator and
// its tile partial are D/2 floats a thread each, so one warp over 16 rows
// at D = 256 would take twice D = 128's registers, which already near the
// 255 limit. The bound is the narrow kernel's, 4*D FLOPs per live pair at
// 165 TFLOP/s: 0.417 ms at (B=8, T=1024, H=16, D=256, causal), against
// ~0.54 GB of q, k, v, o and lse (0.16 ms at 3.35 TB/s), so bound by
// operations. A CTA is two warpgroups (8 warps) over 64 query rows, and
// the width is split between them, not over CTAs:
//
//   - warp w of warpgroup 0 and warp w of warpgroup 1 own the same 16
//     rows; at D = 256 warpgroup g owns columns [128 g, 128 g + 128) of
//     q, k, v and o (below, a split by blocks of 32 columns otherwise).
//     Each warp sums its warpgroup's columns of s = q.k^T for a tile of
//     R = 32 keys, leaves its partial C fragments in shared memory, meets
//     its partner at a named barrier (bar.sync 1 + w, 64) and adds the
//     partner's (the same lane holds the same elements; f32 addition
//     commutes, so both warps hold the same bits). Both then run the
//     masks, the row max, exp2 and the rescale, so m and l are the same
//     in both, and each runs o += p.v for its own columns into a tile
//     partial added to acc * corr. So s is computed once a tile, the
//     bound's 4*D a pair, and a thread keeps D = 128's register shape (64
//     accumulator floats and 64 of partial); warpgroup 0 writes lse;
//   - q is resident at the whole width, split into hi and lo once, in
//     place, times scale * log2(e), each warp its own rows and its
//     warpgroup's columns: 133,120 bytes at the padded stride of 260
//     floats. One k tile (with its kv_mask row) and one v tile stream in
//     turns beside the 16,384-byte exchange: 216,192 bytes of the 232,448
//     a block may use, one CTA an SM;
//   - the true head dim is read in place: any D in (128, 256] with D % 4
//     == 0 (rows stay 16-byte aligned). The copies zero-fill columns at
//     or past D as they zero-fill rows past T (cp.async with a source
//     size of 0), each warpgroup's products stop at its last block of
//     live columns, and only o's columns below D are stored, so the
//     wrapper neither pads nor slices.
//
// What bounds it in practice: through mma.sync the H100's tensor cores
// reach about 320 TFLOP/s of TF32 (tools/mma_sync_rate.py), so a 3xTF32
// kernel built on it tops out near 107 TFLOP/s, and beside every three
// mma.sync a warp issues some eight loads and splits of operands. The
// kernel is bound by issuing those and by their latency, not by memory.
//
// Head dims past 256 (Dp = 128 * n_chunks, the operands zero-padded to
// it by the wrapper; no model of the repo runs one): the chunked wide
// kernel splits o's columns over a third grid dimension of kWideChunk
// (128) wide chunks: each CTA accumulates s = q.k^T over the whole Dp in
// 128-wide slices streamed through the ring (q's slice too, re-read from
// L2 for every key tile, since a resident q at Dp no longer fits in
// shared memory beside the ring), then runs the softmax and o += p.v for
// its own 128 columns of o. The registers stay D = 128's; the cost is
// that s is recomputed once for every chunk of o (1.5x the bound's
// operations at Dp = 256, where it ran until the pair kernel came).
// Every chunk sums s in the same order, so every chunk has the same m
// and l; chunk 0 writes lse.
//
// C interface (loaded with ctypes): dl4j_flash_attention_fwd_f32 returns
// cudaGetLastError() after the launch (0 on success). It takes D = 32, 64,
// 128, any D in (128, 256] with D % 4 == 0, or a multiple of 128 past
// 256. It allocates nothing; strides are in elements, the last dimension
// must be contiguous and every row 16-byte aligned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::Frag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows per CTA
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kDead = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, t, h;
};

// 2^x on the special-function unit, results under 2^-126 flushed to 0:
// they vanish anyway in a sum whose largest term is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory layout in floats: the q tile (kRows x S, which becomes
// q's hi halves) and the tile of its lo halves, then kStages ring stages
// of a k and a v tile (R x S each) and R kv_mask entries.
template <int D>
struct Layout {
  static constexpr int S = D + 4;                 // padded row stride
  static constexpr int R = 32;                    // keys per streamed tile
  // CTAs an SM should hold: three at D = 64, the LM's head size, which
  // caps a thread at 168 registers
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int kQ = 2 * kRows * S;
  static constexpr int kStage = 2 * R * S + R;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kStages * kStage);
};

// rows [r0, r0 + ROWS) of a (T, D) operand into a padded shared tile;
// rows at or past T are zero-filled. A thread copies the same four
// columns of every (kThreads / (D / 4))-th row, so its offsets are
// fixed and the loop unrolls.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int r0,
                                          int T) {
  constexpr int S = D + 4, D4 = D / 4, kStep = kThreads / D4;
  static_assert(ROWS % kStep == 0, "whole passes over the rows");
  const int r = threadIdx.x / D4, c = (threadIdx.x % D4) * 4;
#pragma unroll
  for (int j = 0; j < ROWS / kStep; ++j) {
    const int row = r0 + r + j * kStep;
    const bool in = row < T;
    tf32mma::cp_async16(dst + (r + j * kStep) * S + c,
                        src + (in ? row : 0) * stride + c, in);
  }
}

// element i (one per thread, 0 <= i < n) of a length-T row from i0 into
// shared memory; zero past T
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int i0, int n, int T, int i) {
  if (i < n) {
    const bool in = i0 + i < T;
    tf32mma::cp_async4(dst + i, src + (in ? i0 + i : 0), in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ kv_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 int T, int H, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int causal) {
  using L = Layout<D>;
  constexpr int S = L::S, R = L::R, N = D / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // q, then its hi halves
  uint32_t* qlo_s = reinterpret_cast<uint32_t*>(q_s + kRows * S);
  float* ring = q_s + L::kQ;                       // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int r0 = 16 * warp;                              // the warp's rows

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // stage st <- keys [k0, k0 + R): k, v and the kv_mask
  auto load_tile = [&](int k0, int st) {
    float* k_s = ring + st * L::kStage;
    copy_rows<D, R>(k_s, kb, sk.t, k0, T);
    copy_rows<D, R>(k_s + R * S, vb, sv.t, k0, T);
    if (maskb) copy_vec(k_s + 2 * R * S, maskb, k0, R, T, tid);
  };

  copy_rows<D, kRows>(q_s, q + b * sq.b + h * sq.h, sq.t, q0, T);
  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_tiles = (k_end + R - 1) / R;
  load_tile(0, 0);
  tf32mma::cp_async_commit();
  tf32mma::cp_async_wait<0>();
  __syncthreads();

  // the warp's q rows, times scale * log2(e), split into hi and lo once
  // for the whole key loop
  tf32mma::split_rows<S, D>(q_s, qlo_s, r0, scale * kLog2e, lane);
  __syncwarp();
  const uint32_t* qhi_s = reinterpret_cast<const uint32_t*>(q_s);

  int row[2];
  float m[2], l[2];   // base-2 running max; this lane's share of the sum
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + r0 + g + 8 * hh;
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  float acc[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // this tile has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (it + 1 < n_tiles) load_tile((it + 1) * R, (it + 1) % kStages);
    tf32mma::cp_async_commit();

    const int k0 = it * R;
    // causal: every key of the tile lies past the warp's last row, so
    // the tile would leave m, l and acc as they are
    if (causal && k0 > q0 + r0 + 15) continue;
    const float* k_s = ring + (it % kStages) * L::kStage;
    const float* v_s = k_s + R * S;
    const float* live_s = v_s + R * S;

    // s = q.k^T in base 2 for the warp's 16 rows x R keys
    float s[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      Frag a[4];
      tf32mma::load_a_split<S>(a, qhi_s, qlo_s, r0, 8 * c, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bk[2];
        tf32mma::load_b_t<S>(bk, k_s, 8 * n, 8 * c, g, t);
        tf32mma::mma3(s[n], a, bk);
      }
    }

    // the masks (-1e30 before the max), skipped where the warp's rows see
    // every key of the tile; then the tile's row max over the 4 lanes
    // that share a row (C layout: element e is row g + 8 (e >> 1), key
    // column 2t + (e & 1) of the 8-key group)
    if (maskb || k0 + R > T || (causal && k0 + R - 1 > q0 + r0)) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          const int key = k0 + col;
          const bool ok = (maskb ? live_s[col] > 0.f : key < T) &&
                          (!causal || key <= row[e >> 1]);
          s[n][e] = ok ? s[n][e] : kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    // a row that has seen no key keeps m = -1e30 and subtracts 0, so its
    // p and its rescale are exp2(-1e30) = 0: the sentinel rules
    float corr[2], m_sub[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      m_sub[hh] = m_new <= kDead ? 0.f : m_new;
      corr[hh] = exp2_ftz(m[hh] - m_sub[hh]);
      m[hh] = m_new;
    }
    // p in place of s
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(s[n][e] - m_sub[e >> 1]);
        rowsum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], corr[hh], rowsum[hh]);

    // o += p.v, p's C fragments the A operand as they stand, into a tile
    // partial added to acc * corr in f32
    float part[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      Frag a[4];
      tf32mma::as_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        Frag bv[2];
        tf32mma::load_b_pairs<S>(bv, v_s, 8 * j, 8 * n, g, t);
        tf32mma::mma3(part[n], a, bv);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[n][e]);
  }

  // o = acc / max(l, 1e-30), each row stored as float2 pairs; one lane of
  // the four that share a row writes its lse
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= T) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    float* out = ob + row[hh] * so.t + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
          acc[n][2 * hh] / denom, acc[n][2 * hh + 1] / denom);
    if (t == 0)
      lse[(long long)bh * T + row[hh]] =
          l[hh] > 0.f ? m[hh] * kLn2 + logf(denom) : kNegInf;
  }
}

// The wide kernel's shared memory: kStages ring stages, each a slice
// of kRows q rows and R k rows (C columns each), and, on a key tile's
// last step, R v rows of the CTA's own chunk and R kv_mask entries.
template <int C>
struct WideLayout {
  static constexpr int S = C + 4;
  static constexpr int R = 32;
  static constexpr int kStage = (kRows + 2 * R) * S + R;
  static constexpr size_t kBytes = sizeof(float) * kStages * kStage;
};

constexpr int kWideChunk = 128;   // o's columns a wide CTA owns

// D = Dp > 128, a multiple of C: o's columns [z C, z C + C) for z =
// blockIdx.z. Steps i = it * n_chunks + c stream q's and k's slice c of
// key tile it; the tile's last step (c = n_chunks - 1) also brings v's
// slice z, and after it the tile's softmax and p.v run as in
// flash_fwd_kernel.
template <int C>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kv_mask,
                      float* __restrict__ o, float* __restrict__ lse, int T,
                      int H, int Dp, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale, int causal) {
  using L = WideLayout<C>;
  constexpr int S = L::S, R = L::R, N = C / 8;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int z = blockIdx.z;                              // o's chunk
  const int r0 = 16 * warp;                              // the warp's rows
  const int n_chunks = Dp / C;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // stage st <- step i: q's and k's slice c of key tile it (and, on the
  // tile's last step, v's slice z and the kv_mask)
  auto load_step = [&](int i, int st) {
    const int it = i / n_chunks, c = i - it * n_chunks;
    float* q_s = ring + st * L::kStage;
    float* k_s = q_s + kRows * S;
    copy_rows<C, kRows>(q_s, qb + c * C, sq.t, q0, T);
    copy_rows<C, R>(k_s, kb + c * C, sk.t, it * R, T);
    if (c == n_chunks - 1) {
      copy_rows<C, R>(k_s + R * S, vb + z * C, sv.t, it * R, T);
      if (maskb) copy_vec(k_s + 2 * R * S, maskb, it * R, R, T, tid);
    }
  };

  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_steps = (k_end + R - 1) / R * n_chunks;
  load_step(0, 0);
  tf32mma::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  int row[2];
  float m[2], l[2];   // base-2 running max; this lane's share of the sum
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + r0 + g + 8 * hh;
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  float acc[N][4], s[R / 8][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    tf32mma::cp_async_wait<0>();   // this step has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (i + 1 < n_steps) load_step(i + 1, (i + 1) % kStages);
    tf32mma::cp_async_commit();

    const int it = i / n_chunks, c = i - it * n_chunks;
    const int k0 = it * R;
    // causal: every key of the tile lies past the warp's last row
    if (causal && k0 > q0 + r0 + 15) continue;
    const float* q_s = ring + (i % kStages) * L::kStage;
    const float* k_s = q_s + kRows * S;

    // s += q_c.k_c^T for the warp's 16 rows x R keys
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll 2
    for (int cc = 0; cc < C; cc += 8) {
      Frag a[4];
      tf32mma::load_a<S>(a, q_s, r0, cc, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bk[2];
        tf32mma::load_b_t<S>(bk, k_s, 8 * n, cc, g, t);
        tf32mma::mma3(s[n], a, bk);
      }
    }
    if (c != n_chunks - 1) continue;

    // the tile's last slice: s in base 2, the masks, the tile's row max
    const float* v_s = k_s + R * S;
    const float* live_s = v_s + R * S;
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int key = k0 + col;
        const bool ok = (maskb ? live_s[col] > 0.f : key < T) &&
                        (!causal || key <= row[e >> 1]);
        s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float corr[2], m_sub[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      m_sub[hh] = m_new <= kDead ? 0.f : m_new;
      corr[hh] = exp2_ftz(m[hh] - m_sub[hh]);
      m[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(s[n][e] - m_sub[e >> 1]);
        rowsum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], corr[hh], rowsum[hh]);

    // o_z += p.v_z into a tile partial added to acc * corr in f32
    float part[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      Frag a[4];
      tf32mma::as_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        Frag bv[2];
        tf32mma::load_b_pairs<S>(bv, v_s, 8 * j, 8 * n, g, t);
        tf32mma::mma3(part[n], a, bv);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[n][e]);
  }

  float* ob = o + b * so.b + h * so.h + z * C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= T) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    float* out = ob + row[hh] * so.t + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
          acc[n][2 * hh] / denom, acc[n][2 * hh + 1] / denom);
    if (t == 0 && z == 0)
      lse[(long long)bh * T + row[hh]] =
          l[hh] > 0.f ? m[hh] * kLn2 + logf(denom) : kNegInf;
  }
}

// ------------------------------------------ D in (128, 256]: two warpgroups

constexpr int kPairThreads = 2 * kThreads;   // two warpgroups of kWarps
constexpr int kPairD = 256;                   // the widest D they run

// The pair kernel's shared memory in floats: the resident q tile at the
// whole width (kRows x S, which becomes q's hi halves) and the tile of its
// lo halves, one k tile with its R kv_mask entries and one v tile (R x S
// each), and the exchange of s's partial sums (a warp's R / 8 C
// fragments, one float4 a lane and fragment, for each of the 8 warps).
// 133,120 + 66,688 + 16,384 = 216,192 bytes of the 232,448 a block may
// use, so one CTA of 8 warps an SM. There is no room for a second stage
// of 32-key tiles beside the resident q, so k and v take turns: v(i)
// lands while s(i) runs, k(i + 1) while p.v(i) runs (faster on an H100
// than a two-stage ring of 16-key tiles, or of 32-key tiles with q kept
// as f32 and split at every read).
struct PairLayout {
  static constexpr int C = kPairD / 2;   // columns a warpgroup may own
  static constexpr int S = kPairD + 4;   // padded row stride
  static constexpr int R = 32;           // keys a tile
  static constexpr int kFrags = R / 8;
  static constexpr int kQ = 2 * kRows * S;
  static constexpr int kTiles = 2 * R * S + R;
  static constexpr int kExchange = 2 * kWarps * kFrags * 32 * 4;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kTiles + kExchange);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// rows [r0, r0 + ROWS) of a (T, D) operand into a padded shared tile of
// kPairD columns, by the pair kernel's threads; rows at or past T and
// columns at or past D (D % 4 == 0) are zero-filled. A thread copies the
// same four columns of every (kPairThreads / (kPairD / 4))-th row.
template <int ROWS>
__device__ __forceinline__ void copy_pair_rows(float* dst, const float* src,
                                               long long stride, int r0,
                                               int T, int D) {
  constexpr int S = PairLayout::S, D4 = kPairD / 4,
                kStep = kPairThreads / D4;
  static_assert(ROWS % kStep == 0, "whole passes over the rows");
  const int r = threadIdx.x / D4, c = (threadIdx.x % D4) * 4;
  const bool col_in = c < D;
#pragma unroll
  for (int j = 0; j < ROWS / kStep; ++j) {
    const int row = r0 + r + j * kStep;
    const bool in = col_in && row < T;
    tf32mma::cp_async16(dst + (r + j * kStep) * S + c,
                        src + (in ? row * stride + c : 0), in);
  }
}

// s summed over both warpgroups' columns: each warp leaves its partial C
// fragments in its slot, meets its partner (the other warpgroup's warp
// over the same rows and keys: the same lane holds the same elements) and
// adds the partner's. f32 addition commutes, so both warps hold the same
// bits. The slots are written again only after the next tile's first
// __syncthreads, which the partner reaches after its read.
template <int NF>
__device__ __forceinline__ void sum_pair(float4* xch, int wg, int w,
                                         int lane, float (&s)[NF][4]) {
  float4* mine = xch + (wg * kWarps + w) * NF * 32 + lane;
  const float4* theirs = xch + ((1 - wg) * kWarps + w) * NF * 32 + lane;
#pragma unroll
  for (int n = 0; n < NF; ++n)
    mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
  tf32mma::pair_sync(w);
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const float4 a = theirs[n * 32];
    s[n][0] += a.x; s[n][1] += a.y; s[n][2] += a.z; s[n][3] += a.w;
  }
}

// 128 < D <= 256, D % 4 == 0, read in place: 8 warps over 64 query rows,
// q resident at the whole width, key tiles of R streamed. Warp w of
// warpgroup wg sums s = q.k^T for rows 16 (w % 4) over the warpgroup's
// columns, the pair adds their partials, and each warp runs the softmax
// for the rows and o += p.v over its warpgroup's columns, as
// flash_fwd_kernel does.
//
// A warpgroup's columns are whole blocks of four 8-column groups, and
// both products run a block at a time, unrolled: a bound checked once a
// group broke the p.v loop into basic blocks too small to overlap one
// group's loads and splits with another's products, which on an H100 was
// the largest single cost of the first build. Warpgroup 0 takes the
// first half of the groups below D rounded up to a block, warpgroup 1
// the rest (16 and 16 at D = 256, 12 and 8 at D = 160, where 16 and 4
// left warpgroup 1 idle and ran nearly as long as D = 256); the columns
// of warpgroup 1's last block past D are zero in every tile.
__global__ void __launch_bounds__(kPairThreads, 1)
flash_fwd_pair_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kv_mask,
                      float* __restrict__ o, float* __restrict__ lse, int T,
                      int H, int D, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale, int causal) {
  using L = PairLayout;
  constexpr int C = L::C, S = L::S, R = L::R, NF = L::kFrags, N = C / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // q, then its hi halves
  uint32_t* qlo_s = reinterpret_cast<uint32_t*>(q_s + kRows * S);
  float* k_s = q_s + L::kQ;                        // R x S
  float* v_s = k_s + R * S;                        // R x S
  float* live_s = v_s + R * S;                     // R kv_mask entries
  float4* xch = reinterpret_cast<float4*>(q_s + L::kQ + L::kTiles);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / kWarps, w = warp % kWarps;
  const int r0 = 16 * w;    // the rows of warps w and w + kWarps
  // the warpgroup's columns: n_blk blocks of 4 groups from column c0
  const int groups = (D + 7) / 8, half = (groups + 7) / 8 * 4;
  const int c0 = 8 * half * wg;
  const int n_blk = wg == 0 ? half / 4 : (groups - half + 3) / 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // keys [k0, k0 + R): k with the kv_mask, and v
  auto load_k = [&](int k0) {
    copy_pair_rows<R>(k_s, kb, sk.t, k0, T, D);
    if (maskb) copy_vec(live_s, maskb, k0, R, T, tid);
  };
  auto load_v = [&](int k0) { copy_pair_rows<R>(v_s, vb, sv.t, k0, T, D); };

  copy_pair_rows<kRows>(q_s, q + b * sq.b + h * sq.h, sq.t, q0, T, D);
  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_tiles = (k_end + R - 1) / R;
  load_k(0);
  load_v(0);
  tf32mma::cp_async_commit();
  tf32mma::cp_async_wait<0>();
  __syncthreads();

  // the warp's q rows in its warpgroup's blocks, times scale * log2(e),
  // split into hi and lo once for the whole key loop (lane i the four
  // columns c0 + 4 i of each row): no other warp reads them
  if (lane < 8 * n_blk) {
    const float qscale = scale * kLog2e;
#pragma unroll 4
    for (int rr = r0; rr < r0 + 16; ++rr) {
      const int at = rr * S + c0 + 4 * lane;
      const float4 x = *reinterpret_cast<const float4*>(q_s + at);
      const Frag f0 = tf32mma::split(qscale * x.x),
                 f1 = tf32mma::split(qscale * x.y),
                 f2 = tf32mma::split(qscale * x.z),
                 f3 = tf32mma::split(qscale * x.w);
      *reinterpret_cast<uint4*>(q_s + at) = make_uint4(f0.hi, f1.hi, f2.hi,
                                                       f3.hi);
      *reinterpret_cast<uint4*>(qlo_s + at) = make_uint4(f0.lo, f1.lo,
                                                         f2.lo, f3.lo);
    }
  }
  __syncwarp();
  const uint32_t* qhi_s = reinterpret_cast<const uint32_t*>(q_s);

  int row[2];
  float m[2], l[2];   // base-2 running max; this lane's share of the sum
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = q0 + r0 + g + 8 * hh;
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  float acc[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // k(it) has landed ...
    __syncthreads();               // ... and v(it - 1)'s readers are done
    if (it > 0) load_v(it * R);
    tf32mma::cp_async_commit();

    const int k0 = it * R;
    // causal: every key of the tile lies past the rows of both warps of
    // the pair, so both skip its products (and neither waits for the
    // other), but not the CTA's barriers
    const bool live = !(causal && k0 > q0 + r0 + 15);
    float s[NF][4], corr[2];
    if (live) {
      // the warpgroup's share of s = q.k^T in base 2, 16 rows x R keys
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      for (int cb = 0; cb < n_blk; ++cb) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = c0 + 32 * cb + 8 * u;
          Frag a[4];
          tf32mma::load_a_split<S>(a, qhi_s, qlo_s, r0, c, g, t);
#pragma unroll
          for (int n = 0; n < NF; ++n) {
            Frag bk[2];
            tf32mma::load_b_t<S>(bk, k_s, 8 * n, c, g, t);
            tf32mma::mma3(s[n], a, bk);
          }
        }
      }
      sum_pair(xch, wg, w, lane, s);

      // the masks, the row max, p and l, as in flash_fwd_kernel
      if (maskb || k0 + R > T || (causal && k0 + R - 1 > q0 + r0)) {
#pragma unroll
        for (int n = 0; n < NF; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t + (e & 1);
            const int key = k0 + col;
            const bool ok = (maskb ? live_s[col] > 0.f : key < T) &&
                            (!causal || key <= row[e >> 1]);
            s[n][e] = ok ? s[n][e] : kNegInf;
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float m_sub[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        m_sub[hh] = m_new <= kDead ? 0.f : m_new;
        corr[hh] = exp2_ftz(m[hh] - m_sub[hh]);
        m[hh] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_ftz(s[n][e] - m_sub[e >> 1]);
          rowsum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = fmaf(l[hh], corr[hh], rowsum[hh]);
    }
    tf32mma::cp_async_wait<0>();   // v(it) has landed ...
    __syncthreads();               // ... and k(it)'s readers are done
    if (it + 1 < n_tiles) load_k((it + 1) * R);
    tf32mma::cp_async_commit();
    if (!live) continue;

    // the warpgroup's columns of o += p.v, a block of 4 groups at a
    // time, into a tile partial added to acc * corr in f32
    float part[N][4];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      Frag a[4];
      tf32mma::as_a(a, s[j]);
#pragma unroll
      for (int nb = 0; nb < N / 4; ++nb) {
        if (nb < n_blk) {
#pragma unroll
          for (int n = 4 * nb; n < 4 * nb + 4; ++n) {
            Frag bv[2];
            tf32mma::load_b_pairs<S>(bv, v_s, 8 * j, c0 + 8 * n, g, t);
            tf32mma::mma3(part[n], a, bv);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[n][e]);
  }

  // o's columns below D = acc / max(l, 1e-30); warpgroup 0 writes lse
  float* ob = o + b * so.b + h * so.h + c0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= T) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    float* out = ob + row[hh] * so.t + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      // the warpgroup's own blocks, columns below D (D even: the pair's
      // second column too)
      if (n < 4 * n_blk && c0 + 8 * n + 2 * t < D)
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
            acc[n][2 * hh] / denom, acc[n][2 * hh + 1] / denom);
    if (t == 0 && wg == 0)
      lse[(long long)bh * T + row[hh]] =
          l[hh] > 0.f ? m[hh] * kLn2 + logf(denom) : kNegInf;
  }
}

int launch_pair(const float* q, const float* k, const float* v,
                const float* kv_mask, float* o, float* lse, int B, int T,
                int H, int D, Strides sq, Strides sk, Strides sv,
                Strides so, float scale, int causal, cudaStream_t stream) {
  const size_t smem = PairLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_fwd_pair_kernel<<<grid, kPairThreads, smem, stream>>>(
      q, k, v, kv_mask, o, lse, T, H, D, sq, sk, sv, so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const float* q, const float* k, const float* v,
                const float* kv_mask, float* o, float* lse, int B, int T,
                int H, int D, Strides sq, Strides sk, Strides sv,
                Strides so, float scale, int causal, cudaStream_t stream) {
  constexpr int C = kWideChunk;
  const size_t smem = WideLayout<C>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows, D / C);
  flash_fwd_wide_kernel<C><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_mask, o, lse, T, H, D, sq, sk, sv, so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const float* kv_mask, float* o, float* lse, int B, int T, int H,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_mask, o, lse, T, H, sq, sk, sv, so, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dl4j_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, void* lse, int B, int T, int H, int D,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, void* stream) {
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh}, so{o_sb, o_st, o_sh};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* mf = static_cast<const float*>(kv_mask);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(qf, kf, vf, mf, of, lf, B, T, H, sq, sk, sv, so,
                        scale, causal, st);
    case 64:
      return launch<64>(qf, kf, vf, mf, of, lf, B, T, H, sq, sk, sv, so,
                        scale, causal, st);
    case 128:
      return launch<128>(qf, kf, vf, mf, of, lf, B, T, H, sq, sk, sv, so,
                         scale, causal, st);
    default:
      // the true D in (128, 256] read in place by the pair kernel; past
      // 256, multiples of 128 (the wrapper pads to them) by the chunked one
      if (D > 128 && D <= kPairD && D % 4 == 0)
        return launch_pair(qf, kf, vf, mf, of, lf, B, T, H, D, sq, sk, sv,
                           so, scale, causal, st);
      if (D > kPairD && D % kWideChunk == 0)
        return launch_wide(qf, kf, vf, mf, of, lf, B, T, H, D, sq, sk, sv,
                           so, scale, causal, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
