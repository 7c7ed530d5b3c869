// Flash-attention backward for Hopper (sm_90a), float32 in, float32 out,
// every product on the tensor cores at f32 accuracy (3xTF32).
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
// (s, dp, dq: 2.6e10) and dk/dv 8*D (s, dp, dv, dk: 3.4e10), against
// ~0.2 GB of operands (~0.06 ms at 3.35 TB/s). The fastest f32-accurate
// route for the products is three TF32 passes on the tensor cores, 495 /
// 3 = 165 TFLOP/s: >= 0.156 ms for dq and >= 0.208 ms for dk/dv (the
// CUDA cores' 67 TFLOP/s f32 would give 0.385 / 0.513 ms). Both kernels
// are bound by operations, so the design feeds the tensor cores from
// shared memory and keeps everything else on chip:
//
//   - products: mma.sync m16n8k8 with TF32 operands and f32 accumulators
//     (tf32_mma.cuh), each operand split hi + lo (hi rounded to nearest)
//     and the product taken as lo.hi + hi.lo + hi.hi. In dq: s = q.k^T,
//     dp = do.v^T, dq += ds.k; in dk/dv: s^T = k.q^T, dp^T = v.do^T, dv
//     += p^T.do, dk += ds^T.q. exp (as exp2 of one fma), the masks and
//     p (dp - delta) scale stay f32 on the CUDA cores, in the
//     accumulator registers. What limits the kernels is instruction
//     issue beside the tensor cores (fragment loads, the operand split,
//     the softmax): the split costs three instructions an element, not
//     the nine that cvt.rna on both halves compiles to on sm_90;
//   - p and ds reach the next product without moving: the C fragment of
//     a score tile is read as the A fragment of the next product with
//     its depth (key or query) order permuted, and the B operand's rows
//     are read in the same order (tf32_mma.cuh), so there is no trip
//     through shared memory and no shuffle;
//   - CTAs of 4 warps, each warp owning 16 rows: 64 query rows in dq, 64
//     key rows in dk/dv. The accumulators are C fragments: D/2 floats a
//     thread for dq, D for dk and dv together. Each streamed tile's
//     products go into a partial that is added to the accumulator with
//     f32 adds (dk/dv: at D <= 64, where the partials fit in registers):
//     the tensor core truncates its sums, and one accumulator over a
//     whole row of 1024 keys or queries gathers that bias (dk/dv's error
//     against the plain version was ~5x larger without the partials);
//   - the resident tiles (q and do in dq, k and v in dk/dv) are copied
//     once; the streamed tiles (k, v and the kv_mask in dq; q, do, lse
//     and delta in dk/dv) go through a two-stage ring in dynamic shared
//     memory with cp.async, the next tile's copy issued before this
//     tile's products. Every tile row is padded to D + 4 floats, so
//     every fragment load is free of bank conflicts and no operand needs
//     a transposed copy;
//   - delta is computed in the dq CTA's prologue for its own rows, while
//     the first copies fly, and written for dk/dv;
//   - causal: dq stops at its last row's diagonal, dk/dv starts at the
//     first query tile that reaches its first key; the grid runs over
//     (b*h, tile) with the heaviest tiles of every head first.
//
// Any T (the ragged edge is zero-filled by the copies and masked), D in
// {32, 64, 128} (streamed tiles of 32 rows, so nothing spills), 256
// (the pair kernels below) or another multiple of 128 past 128 (the
// chunked wide kernels), strides in elements (the last dimension
// contiguous, rows 16-byte aligned).
//
// D = 256 (160 and 192 zero-padded to it by the wrapper): the pair
// kernels, dq_pair_kernel and dkv_pair_kernel. The bound is the narrow
// kernels': 6*D FLOPs per live pair for dq, 8*D for dk/dv, at 165
// TFLOP/s (0.625 / 0.834 ms at B=8, T=1024, H=16, causal). What stands
// in its way at this width is the register file: D = 128's accumulators
// and partials already take 206-237 of a thread's 255 registers. So a
// CTA is two warpgroups (8 warps) over 64 owned rows, and the width is
// split between them, not over CTAs:
//
//   - warp w of warpgroup 0 and warp w of warpgroup 1 own the same 16
//     rows. Each sums its warpgroup's 128 columns of s and dp (q.k^T
//     and do.v^T in dq, k.q^T and v.do^T in dk/dv) for a tile of R = 16
//     streamed rows, leaves its partial C fragments in shared memory,
//     meets its partner at a named barrier (bar.sync 1 + w, 64) and
//     adds the partner's (the same lane holds the same elements, and
//     f32 addition commutes, so both hold the same bits). Both then
//     compute p and ds in registers and each accumulates its own 128
//     columns of dq (dq += ds.k, into a tile partial added with f32
//     adds) or of dk and dv (dv += p^T.do, dk += ds^T.q), p and ds
//     read from their own C fragments (tf32_mma.cuh). So s and dp are
//     computed once a tile: each live pair costs the bound's 6*D and
//     8*D, and a thread keeps D = 128's register shape (dq 64
//     accumulator floats and 64 of partials, dk/dv 128 accumulators).
//     This split exchanges partials once, where one warpgroup computing
//     s and p and the other dp and ds would pass p one way and ds the
//     other, two dependent meetings a tile;
//   - the owned rows are resident: q and do (dq) or k and v (dk/dv) at
//     the whole width are copied once a CTA, 133,120 bytes at the
//     padded stride of 260 floats; the streamed tile (k and v, or q and
//     do, with the mask row or lse and delta) goes through the two-stage
//     ring; with the exchange and delta 216,576 bytes, one 8-warp CTA
//     an SM;
//   - the copies stay cp.async (8 16-byte copies a thread a tile against
//     some 1,700 instructions of a warp's products): the zero fill of
//     rows past T comes with it, and the padded stride needs nothing
//     else. Hopper's bulk copies would take the address arithmetic off
//     the threads, but the rows past T would then need zeroing apart;
//   - everything else as in the narrow kernels: 3xTF32 mma.sync, no
//     atomics, the masks, the -1e30 sentinel (a fully masked row gets
//     dq = 0), the causal start and stop, heaviest tiles first; dq
//     writes delta for its rows, 8 rows a warp, shared through shared
//     memory.
//
// Head dims past 128 but 256 (Dp = 128 * n_chunks, zero-padded by the
// wrapper; no model of the repo runs one): the chunked wide kernels split
// the OUTPUT's columns over a third grid dimension of kWideChunk (128)
// wide chunks. A CTA
// streams the 128-wide slices of every operand of s and dp (dq: q, do,
// k, v; dk/dv: k, v, q, do) through the ring and sums s and dp over the
// whole Dp (dq a slice at a time, the slices' sums added in f32 through
// shared memory: one tensor-core accumulator over 384 columns left a
// zero gradient, a causal row's one key, past the tolerance), then
// computes p and ds and its own 128 columns of dq (or of dk and dv). Its slices run in the order z + 1, ..., z (mod n_chunks),
// so the tile's last slice is the CTA's own chunk z, which the output's
// product reads (dq: k's slice z; dk/dv: q's and do's) from the stage it
// already holds. The registers stay D = 128's; the cost is that s and
// dp are recomputed once for every chunk of the output (1.5x the bound's
// operations at Dp = 256, where they ran until the pair kernels came),
// and that the resident tiles of the narrow kernels are re-read from L2
// for every streamed tile. Chunk 0 writes delta.
//
// C interface (loaded with ctypes), one entry per TPU kernel, each
// returning cudaGetLastError() after its launch (0 on success); they
// allocate nothing:
//   dl4j_flash_attention_bwd_dq_f32   writes dq and delta (B, H, T);
//   dl4j_flash_attention_bwd_dkv_f32  reads delta, writes dk and dv.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using tf32mma::Frag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows (dq) / key rows (dk/dv)
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kDead = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;

// p = exp(s * scale - lse) as exp2 of one fused multiply-add
__device__ __forceinline__ float softmax_p(float s, float scale_log2,
                                           float lse_log2) {
  return exp2f(fmaf(s, scale_log2, -lse_log2));
}

struct Strides {
  long long b, t, h;
};

// Shared-memory layout in floats: two resident kRows x S tiles, then
// kStages ring stages of two streamed R x S tiles and two R-float rows.
// R is the streamed tile's rows: keys in dq, queries in dk/dv. 32 keeps
// the scores and the partials of a tile in registers beside the
// accumulators without spills (measured on an H100: with 64, dk/dv's
// partials spill at D = 64, and dq is no faster).
template <int D>
struct Layout {
  static constexpr int S = D + 4;                 // padded row stride
  static constexpr int R = 32;
  static constexpr int kResident = 2 * kRows * S;
  static constexpr int kStage = 2 * R * S + 2 * R;
  static constexpr size_t kBytes =
      sizeof(float) * (kResident + kStages * kStage);
};

// rows [r0, r0 + rows) of a (T, D) operand into a padded shared tile,
// by a CTA of NT threads; rows at or past T are zero-filled
template <int D, int NT = kThreads>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int r0,
                                          int rows, int T) {
  constexpr int S = D + 4, D4 = D / 4;
  for (int i = threadIdx.x; i < rows * D4; i += NT) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    const bool in = r0 + r < T;
    tf32mma::cp_async16(dst + r * S + c,
                        src + (in ? r0 + r : 0) * stride + c, in);
  }
}

// element i (one per thread, 0 <= i < n) of a length-T row from i0 into
// shared memory; zero past T
__device__ __forceinline__ void copy_vec(float* dst, const float* src,
                                         int i0, int n, int T, int i) {
  if (i >= 0 && i < n) {
    const bool in = i0 + i < T;
    tf32mma::cp_async4(dst + i, src + (in ? i0 + i : 0), in);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ kv_mask, float* __restrict__ dq,
          float* __restrict__ delta, int T, int H, Strides sq, Strides sk,
          Strides sv, Strides so, Strides sdo, Strides sdq, float scale,
          int causal) {
  using L = Layout<D>;
  constexpr int S = L::S, R = L::R;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // kRows x S
  float* do_s = q_s + kRows * S;                   // kRows x S
  float* ring = do_s + kRows * S;                  // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int r0 = 16 * warp;                              // the warp's rows

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // stage st <- keys [k0, k0 + R): k, v and the kv_mask
  auto load_tile = [&](int k0, int st) {
    float* k_s = ring + st * L::kStage;
    copy_rows<D>(k_s, kb, sk.t, k0, R, T);
    copy_rows<D>(k_s + R * S, vb, sv.t, k0, R, T);
    if (maskb) copy_vec(k_s + 2 * R * S, maskb, k0, R, T, tid);
  };

  copy_rows<D>(q_s, qb, sq.t, q0, kRows, T);
  copy_rows<D>(do_s, dob, sdo.t, q0, kRows, T);
  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_tiles = (k_end + R - 1) / R;
  load_tile(0, 0);
  tf32mma::cp_async_commit();

  // delta = rowsum(do * o) of the warp's 16 rows, read from device
  // memory while the copies fly; a thread keeps rows g and g + 8
  float row_delta[2] = {0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + r0 + i;
    float acc = 0.f;
    if (row < T) {   // uniform across the warp
      const float* orow = ob + row * so.t;
      const float* drow = dob + row * sdo.t;
      for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < T && lane == 0) delta[(long long)bh * T + row] = acc;
    if (i == g) row_delta[0] = acc;
    if (i == g + 8) row_delta[1] = acc;
  }
  const float scale_log2 = scale * kLog2e;
  int row_idx[2];
  float lse_log2[2];
  bool row_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_idx[hh] = q0 + r0 + g + 8 * hh;
    const float row_lse = row_idx[hh] < T
                              ? lse[(long long)bh * T + row_idx[hh]]
                              : kNegInf;
    row_live[hh] = row_lse > kDead;
    lse_log2[hh] = row_lse * kLog2e;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // this tile has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (it + 1 < n_tiles) load_tile((it + 1) * R, (it + 1) % kStages);
    tf32mma::cp_async_commit();

    const int k0 = it * R;
    const float* k_s = ring + (it % kStages) * L::kStage;
    const float* v_s = k_s + R * S;
    const float* live_s = v_s + R * S;

    // s = q.k^T and dp = do.v^T for the warp's 16 rows x R keys
    float s[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      Frag aq[4], ado[4];
      tf32mma::load_a<S>(aq, q_s, r0, c, g, t);
      tf32mma::load_a<S>(ado, do_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bk[2], bv[2];
        tf32mma::load_b_t<S>(bk, k_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], aq, bk);
        tf32mma::load_b_t<S>(bv, v_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], ado, bv);
      }
    }

    // ds = p (dp - delta) scale, in place of s (C layout: element e is
    // row g + 8 (e >> 1), key column 2t + (e & 1) of the 8-key group)
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int key = k0 + col;
        const bool ok = row_live[hh] &&
                        (maskb ? live_s[col] > 0.f : key < T) &&
                        (!causal || key <= row_idx[hh]);
        const float p = ok ? softmax_p(s[n][e], scale_log2, lse_log2[hh])
                           : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[hh]) * scale;
      }
    }

    // dq += ds . k, ds's C fragments the A operand as they stand; summed
    // into a tile partial and added to dq with f32 adds: the tensor core
    // truncates its sums, and one accumulator over many tiles would
    // gather that bias
    float part[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      Frag a[4];
      tf32mma::as_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        Frag bk[2];
        tf32mma::load_b_pairs<S>(bk, k_s, 8 * j, 8 * n, g, t);
        tf32mma::mma3(part[n], a, bk);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row_idx[hh] >= T) continue;
    float* row = dqb + row_idx[hh] * sdq.t + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ kv_mask, float* __restrict__ dk,
           float* __restrict__ dv, int T, int H, Strides sq, Strides sk,
           Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale,
           int causal) {
  using L = Layout<D>;
  constexpr int S = L::S, R = L::R;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // kRows x S
  float* v_s = k_s + kRows * S;                    // kRows x S
  float* ring = v_s + kRows * S;                   // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kRows;   // heaviest (causal) first
  const int r0 = 16 * warp;            // the warp's key rows

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;

  // stage st <- queries [q0, q0 + R): q, do, lse and delta
  auto load_tile = [&](int q0, int st) {
    float* q_s = ring + st * L::kStage;
    copy_rows<D>(q_s, qb, sq.t, q0, R, T);
    copy_rows<D>(q_s + R * S, dob, sdo.t, q0, R, T);
    copy_vec(q_s + 2 * R * S, lseb, q0, R, T, tid);
    copy_vec(q_s + 2 * R * S + R, deltab, q0, R, T, tid - R);
  };

  copy_rows<D>(k_s, k + b * sk.b + h * sk.h, sk.t, k0, kRows, T);
  copy_rows<D>(v_s, v + b * sv.b + h * sv.h, sv.t, k0, kRows, T);
  const int q_begin = causal ? k0 : 0;   // R divides kRows
  const int n_tiles = (T - q_begin + R - 1) / R;
  load_tile(q_begin, 0);
  tf32mma::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  int key[2];
  bool key_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + r0 + g + 8 * hh;
    key_live[hh] = key[hh] < T &&
                   (kv_mask == nullptr ||
                    kv_mask[(long long)b * T + key[hh]] > 0.f);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // this tile has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (it + 1 < n_tiles)
      load_tile(q_begin + (it + 1) * R, (it + 1) % kStages);
    tf32mma::cp_async_commit();

    const int q0 = q_begin + it * R;
    const float* q_s = ring + (it % kStages) * L::kStage;
    const float* do_s = q_s + R * S;
    const float* lse_s = do_s + R * S;
    const float* delta_s = lse_s + R;

    // s^T = k.q^T and dp^T = v.do^T for the warp's 16 keys x R queries
    float s[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      Frag ak[4], av[4];
      tf32mma::load_a<S>(ak, k_s, r0, c, g, t);
      tf32mma::load_a<S>(av, v_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bq[2], bdo[2];
        tf32mma::load_b_t<S>(bq, q_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], ak, bq);
        tf32mma::load_b_t<S>(bdo, do_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], av, bdo);
      }
    }

    // p^T in place of s, ds^T in place of dp (C layout: element e is
    // key row g + 8 (e >> 1), query column 2t + (e & 1) of the group)
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int qi = q0 + col;
        const float row_lse = lse_s[col];
        const bool ok = key_live[hh] && qi < T && row_lse > kDead &&
                        (!causal || key[hh] <= qi);
        const float p = ok ? softmax_p(s[n][e], scale_log2,
                                       row_lse * kLog2e)
                           : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[col]) * scale;
      }
    }

    // dv += p^T . do and dk += ds^T . q, the C fragments as A operands,
    // into tile partials added with f32 adds as in dq where they fit in
    // registers (D <= 64; at D = 128 they would spill)
    constexpr bool kPartial = D <= 64;
    float pk_buf[D / 8][4], pv_buf[D / 8][4];
    float(&pk)[D / 8][4] = kPartial ? pk_buf : dk_acc;
    float(&pv)[D / 8][4] = kPartial ? pv_buf : dv_acc;
    if constexpr (kPartial) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[n][e] = pv[n][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      Frag ap[4], ads[4];
      tf32mma::as_a(ap, s[j]);
      tf32mma::as_a(ads, dp[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        Frag bdo[2], bq[2];
        tf32mma::load_b_pairs<S>(bdo, do_s, 8 * j, 8 * n, g, t);
        tf32mma::mma3(pv[n], ap, bdo);
        tf32mma::load_b_pairs<S>(bq, q_s, 8 * j, 8 * n, g, t);
        tf32mma::mma3(pk[n], ads, bq);
      }
    }
    if constexpr (kPartial) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[n][e] += pk[n][e];
          dv_acc[n][e] += pv[n][e];
        }
    }
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= T) continue;
    float* dkr = dkb + key[hh] * sdk.t + 2 * t;
    float* dvr = dvb + key[hh] * sdv.t + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(dk_acc[n][2 * hh], dk_acc[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
    }
  }
}

constexpr int kWideChunk = 128;   // output columns a wide CTA owns

// The wide kernels' ring stage: the C-wide slices of two kRows x S
// tiles (the rows the CTA owns) and two R x S tiles (the streamed rows),
// and two R-float rows (dq: the kv_mask; dk/dv: lse and delta), brought
// on a tile's last slice. dq also keeps, after the ring, each warp's
// sums of s and dp over a tile's earlier slices (one float4 a lane for
// each of its 2 R / 8 fragments).
template <int C>
struct WideLayout {
  static constexpr int S = C + 4;
  static constexpr int R = 32;
  static constexpr int kStage = (2 * kRows + 2 * R) * S + 2 * R;
  static constexpr size_t kBytes = sizeof(float) * kStages * kStage;
  static constexpr int kSums = kWarps * 2 * (R / 8) * 32 * 4;
  static constexpr size_t kDqBytes = kBytes + sizeof(float) * kSums;
  static_assert(kDqBytes <= 232448, "over a block's shared memory");
};

// dq's columns [z C, z C + C), z = blockIdx.z, at D = Dp > 128: steps i =
// it * n_chunks + j bring slice (z + 1 + j) % n_chunks of q, do, k and v
// for key tile it; s and dp are summed a slice at a time and the slices'
// sums added in f32, and on the last (slice z) ds and dq += ds . k_z run
// as in dq_kernel.
template <int C>
__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ kv_mask, float* __restrict__ dq,
               float* __restrict__ delta, int T, int H, int Dp, Strides sq,
               Strides sk, Strides sv, Strides so, Strides sdo,
               Strides sdq, float scale, int causal) {
  using L = WideLayout<C>;
  constexpr int S = L::S, R = L::R;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this lane's slots of the warp's sums over a tile's earlier slices
  float4* sums = smem4 + kStages * L::kStage / 4 + warp * 2 * (R / 8) * 32
                 + lane;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int z = blockIdx.z;                              // dq's chunk
  const int r0 = 16 * warp;                              // the warp's rows
  const int n_chunks = Dp / C;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // stage st <- step i: slice (z + 1 + j) % n_chunks of q, do (the
  // CTA's rows) and k, v (key tile it); the kv_mask on the last slice
  auto load_step = [&](int i, int st) {
    const int it = i / n_chunks, j = i - it * n_chunks;
    const int c = (z + 1 + j) % n_chunks;
    float* q_s = ring + st * L::kStage;
    float* do_s = q_s + kRows * S;
    float* k_s = do_s + kRows * S;
    copy_rows<C>(q_s, qb + c * C, sq.t, q0, kRows, T);
    copy_rows<C>(do_s, dob + c * C, sdo.t, q0, kRows, T);
    copy_rows<C>(k_s, kb + c * C, sk.t, it * R, R, T);
    copy_rows<C>(k_s + R * S, vb + c * C, sv.t, it * R, R, T);
    if (maskb && j == n_chunks - 1)
      copy_vec(k_s + 2 * R * S, maskb, it * R, R, T, tid);
  };

  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_steps = (k_end + R - 1) / R * n_chunks;
  load_step(0, 0);
  tf32mma::cp_async_commit();

  // delta = rowsum(do * o) over the whole Dp, as dq_kernel's
  float row_delta[2] = {0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int row = q0 + r0 + i;
    float acc = 0.f;
    if (row < T) {   // uniform across the warp
      const float* orow = ob + row * so.t;
      const float* drow = dob + row * sdo.t;
      for (int c = lane; c < Dp; c += 32) acc = fmaf(orow[c], drow[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < T && lane == 0 && z == 0) delta[(long long)bh * T + row] = acc;
    if (i == g) row_delta[0] = acc;
    if (i == g + 8) row_delta[1] = acc;
  }
  const float scale_log2 = scale * kLog2e;
  int row_idx[2];
  float lse_log2[2];
  bool row_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_idx[hh] = q0 + r0 + g + 8 * hh;
    const float row_lse = row_idx[hh] < T
                              ? lse[(long long)bh * T + row_idx[hh]]
                              : kNegInf;
    row_live[hh] = row_lse > kDead;
    lse_log2[hh] = row_lse * kLog2e;
  }

  float acc[C / 8][4], s[R / 8][4], dp[R / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    tf32mma::cp_async_wait<0>();   // this step has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (i + 1 < n_steps) load_step(i + 1, (i + 1) % kStages);
    tf32mma::cp_async_commit();

    const int it = i / n_chunks, j = i - it * n_chunks;
    const int k0 = it * R;
    const float* q_s = ring + (i % kStages) * L::kStage;
    const float* do_s = q_s + kRows * S;
    const float* k_s = do_s + kRows * S;
    const float* v_s = k_s + R * S;
    const float* live_s = v_s + R * S;

    // s = q_c.k_c^T and dp = do_c.v_c^T for the warp's 16 rows x R keys
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < C; c += 8) {
      Frag aq[4], ado[4];
      tf32mma::load_a<S>(aq, q_s, r0, c, g, t);
      tf32mma::load_a<S>(ado, do_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bk[2], bv[2];
        tf32mma::load_b_t<S>(bk, k_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], aq, bk);
        tf32mma::load_b_t<S>(bv, v_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], ado, bv);
      }
    }
    // plus the earlier slices' sums, added in f32 (each lane reads and
    // writes only its own slots). One accumulator over the whole Dp
    // would take 3 Dp / 8 truncating tensor-core adds at the sum's full
    // size; a row whose gradient is 0 (a causal row's one key: dp =
    // delta) keeps that error in dq, past the tolerance at Dp = 384
    if (j > 0) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        const float4 a = sums[n * 32], d = sums[(R / 8 + n) * 32];
        s[n][0] += a.x; s[n][1] += a.y; s[n][2] += a.z; s[n][3] += a.w;
        dp[n][0] += d.x; dp[n][1] += d.y; dp[n][2] += d.z; dp[n][3] += d.w;
      }
    }
    if (j != n_chunks - 1) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        sums[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        sums[(R / 8 + n) * 32] =
            make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      }
      continue;
    }

    // ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int key = k0 + col;
        const bool ok = row_live[hh] &&
                        (maskb ? live_s[col] > 0.f : key < T) &&
                        (!causal || key <= row_idx[hh]);
        const float p = ok ? softmax_p(s[n][e], scale_log2, lse_log2[hh])
                           : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[hh]) * scale;
      }
    }

    // dq_z += ds . k_z (this stage holds slice z) into a tile partial
    float part[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < R / 8; ++jj) {
      Frag a[4];
      tf32mma::as_a(a, s[jj]);
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        Frag bk[2];
        tf32mma::load_b_pairs<S>(bk, k_s, 8 * jj, 8 * n, g, t);
        tf32mma::mma3(part[n], a, bk);
      }
    }
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  float* dqb = dq + b * sdq.b + h * sdq.h + z * C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row_idx[hh] >= T) continue;
    float* row = dqb + row_idx[hh] * sdq.t + 2 * t;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

// dk's and dv's columns [z C, z C + C), z = blockIdx.z, at D = Dp > 128:
// steps i = it * n_chunks + j bring slice (z + 1 + j) % n_chunks of k, v
// (the CTA's keys) and q, do (query tile it); s^T and dp^T sum over the
// slices, and on the last (slice z) p, ds and dv += p^T . do_z, dk +=
// ds^T . q_z run as in dkv_kernel (no partials: as at D = 128 they would
// spill).
template <int C>
__global__ void __launch_bounds__(kThreads)
dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ kv_mask, float* __restrict__ dk,
                float* __restrict__ dv, int T, int H, int Dp, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk,
                Strides sdv, float scale, int causal) {
  using L = WideLayout<C>;
  constexpr int S = L::S, R = L::R;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // kStages x kStage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kRows;   // heaviest (causal) first
  const int z = blockIdx.z;            // dk's and dv's chunk
  const int r0 = 16 * warp;            // the warp's key rows
  const int n_chunks = Dp / C;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;
  const int q_begin = causal ? k0 : 0;   // R divides kRows

  // stage st <- step i: slice (z + 1 + j) % n_chunks of k, v (the CTA's
  // keys) and q, do (query tile it); lse and delta on the last slice
  auto load_step = [&](int i, int st) {
    const int it = i / n_chunks, j = i - it * n_chunks;
    const int c = (z + 1 + j) % n_chunks;
    const int q0 = q_begin + it * R;
    float* k_s = ring + st * L::kStage;
    float* v_s = k_s + kRows * S;
    float* q_s = v_s + kRows * S;
    copy_rows<C>(k_s, kb + c * C, sk.t, k0, kRows, T);
    copy_rows<C>(v_s, vb + c * C, sv.t, k0, kRows, T);
    copy_rows<C>(q_s, qb + c * C, sq.t, q0, R, T);
    copy_rows<C>(q_s + R * S, dob + c * C, sdo.t, q0, R, T);
    if (j == n_chunks - 1) {
      copy_vec(q_s + 2 * R * S, lseb, q0, R, T, tid);
      copy_vec(q_s + 2 * R * S + R, deltab, q0, R, T, tid - R);
    }
  };

  const int n_steps = (T - q_begin + R - 1) / R * n_chunks;
  load_step(0, 0);
  tf32mma::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  int key[2];
  bool key_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + r0 + g + 8 * hh;
    key_live[hh] = key[hh] < T &&
                   (kv_mask == nullptr ||
                    kv_mask[(long long)b * T + key[hh]] > 0.f);
  }

  float dk_acc[C / 8][4], dv_acc[C / 8][4], s[R / 8][4], dp[R / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    tf32mma::cp_async_wait<0>();   // this step has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (i + 1 < n_steps) load_step(i + 1, (i + 1) % kStages);
    tf32mma::cp_async_commit();

    const int it = i / n_chunks, j = i - it * n_chunks;
    const int q0 = q_begin + it * R;
    const float* k_s = ring + (i % kStages) * L::kStage;
    const float* v_s = k_s + kRows * S;
    const float* q_s = v_s + kRows * S;
    const float* do_s = q_s + R * S;
    const float* lse_s = do_s + R * S;
    const float* delta_s = lse_s + R;

    // s^T += k_c.q_c^T and dp^T += v_c.do_c^T for 16 keys x R queries
    if (j == 0) {
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll 2
    for (int c = 0; c < C; c += 8) {
      Frag ak[4], av[4];
      tf32mma::load_a<S>(ak, k_s, r0, c, g, t);
      tf32mma::load_a<S>(av, v_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        Frag bq[2], bdo[2];
        tf32mma::load_b_t<S>(bq, q_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], ak, bq);
        tf32mma::load_b_t<S>(bdo, do_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], av, bdo);
      }
    }
    if (j != n_chunks - 1) continue;

    // p^T in place of s, ds^T in place of dp
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int qi = q0 + col;
        const float row_lse = lse_s[col];
        const bool ok = key_live[hh] && qi < T && row_lse > kDead &&
                        (!causal || key[hh] <= qi);
        const float p = ok ? softmax_p(s[n][e], scale_log2,
                                       row_lse * kLog2e)
                           : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[col]) * scale;
      }
    }

    // dv_z += p^T . do_z and dk_z += ds^T . q_z (this stage holds slice z)
#pragma unroll
    for (int jj = 0; jj < R / 8; ++jj) {
      Frag ap[4], ads[4];
      tf32mma::as_a(ap, s[jj]);
      tf32mma::as_a(ads, dp[jj]);
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        Frag bdo[2], bq[2];
        tf32mma::load_b_pairs<S>(bdo, do_s, 8 * jj, 8 * n, g, t);
        tf32mma::mma3(dv_acc[n], ap, bdo);
        tf32mma::load_b_pairs<S>(bq, q_s, 8 * jj, 8 * n, g, t);
        tf32mma::mma3(dk_acc[n], ads, bq);
      }
    }
  }

  float* dkb = dk + b * sdk.b + h * sdk.h + z * C;
  float* dvb = dv + b * sdv.b + h * sdv.h + z * C;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= T) continue;
    float* dkr = dkb + key[hh] * sdk.t + 2 * t;
    float* dvr = dvb + key[hh] * sdv.t + 2 * t;
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(dk_acc[n][2 * hh], dk_acc[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
    }
  }
}

// ------------------------------------------------- Dp = 256: two warpgroups

constexpr int kPairThreads = 2 * kThreads;   // two warpgroups of kWarps
constexpr int kPairD = 256;                   // the head dim they run at

// The pair kernels' shared memory in floats: the two resident kRows x S
// tiles at the whole width, kStages ring stages of two streamed R x S
// tiles and two R-float rows, the exchange of s's and dp's partial sums
// (a warp's 2 R / 8 C fragments, one float4 a lane and fragment, for
// each warp of each warpgroup) and kRows floats of delta (dq). At D =
// 256: 133,120 + 66,816 + 16,384 + 256 = 216,576 bytes of the 232,448
// a block may use, so one CTA of 8 warps an SM. R = 16 is what fits
// beside the resident tiles with two stages.
struct PairLayout {
  static constexpr int D = kPairD;
  static constexpr int C = D / 2;   // columns of the output a warpgroup owns
  static constexpr int S = D + 4;   // padded row stride
  static constexpr int R = 16;
  static constexpr int kFrags = R / 8;
  static constexpr int kResident = 2 * kRows * S;
  static constexpr int kStage = 2 * R * S + 2 * R;
  static constexpr int kExchange = 2 * kWarps * 2 * kFrags * 32 * 4;
  static constexpr size_t kBytes =
      sizeof(float) * (kResident + kStages * kStage + kExchange + kRows);
  static_assert(kBytes <= 232448, "over a block's shared memory");
};

// s and dp summed over both warpgroups' columns: each warp leaves its
// partial C fragments in its slot, meets its partner (the other
// warpgroup's warp over the same rows and keys: the same lane holds the
// same elements) and adds the partner's. f32 addition commutes, so both
// warps hold the same bits. The slots are written again only after the
// next tile's __syncthreads.
template <int NF>
__device__ __forceinline__ void sum_pair(float4* xch, int wg, int w,
                                         int lane, float (&s)[NF][4],
                                         float (&dp)[NF][4]) {
  float4* mine = xch + (wg * kWarps + w) * 2 * NF * 32 + lane;
  const float4* theirs = xch + ((1 - wg) * kWarps + w) * 2 * NF * 32 + lane;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    mine[n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    mine[(NF + n) * 32] = make_float4(dp[n][0], dp[n][1], dp[n][2],
                                      dp[n][3]);
  }
  tf32mma::pair_sync(w);
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const float4 a = theirs[n * 32], d = theirs[(NF + n) * 32];
    s[n][0] += a.x; s[n][1] += a.y; s[n][2] += a.z; s[n][3] += a.w;
    dp[n][0] += d.x; dp[n][1] += d.y; dp[n][2] += d.z; dp[n][3] += d.w;
  }
}

// dq and delta at D = 256: 8 warps over 64 query rows, q and do resident
// at the whole width, key tiles of R streamed. Warp w of warpgroup wg
// sums s = q.k^T and dp = do.v^T for rows 16 (w % 4) over the
// warpgroup's 128 columns, the pair adds their partials, and each warp
// computes ds for the rows and dq += ds . k over its warpgroup's 128
// columns (ds's C fragments the A operand, as in dq_kernel).
__global__ void __launch_bounds__(kPairThreads, 1)
dq_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ kv_mask, float* __restrict__ dq,
               float* __restrict__ delta, int T, int H, Strides sq,
               Strides sk, Strides sv, Strides so, Strides sdo,
               Strides sdq, float scale, int causal) {
  using L = PairLayout;
  constexpr int D = kPairD;
  constexpr int C = L::C, S = L::S, R = L::R, NF = L::kFrags;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // kRows x S
  float* do_s = q_s + kRows * S;                   // kRows x S
  float* ring = do_s + kRows * S;                  // kStages x kStage
  float4* xch = reinterpret_cast<float4*>(ring + kStages * L::kStage);
  float* delta_s = reinterpret_cast<float*>(xch) + L::kExchange;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / kWarps, w = warp % kWarps;
  const int r0 = 16 * w;    // the rows of warps w and w + kWarps
  const int c0 = C * wg;    // the warpgroup's columns
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* ob = o + b * so.b + h * so.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* maskb = kv_mask ? kv_mask + (long long)b * T : nullptr;

  // stage st <- keys [k0, k0 + R): k, v and the kv_mask
  auto load_tile = [&](int k0, int st) {
    float* k_s = ring + st * L::kStage;
    copy_rows<D, kPairThreads>(k_s, kb, sk.t, k0, R, T);
    copy_rows<D, kPairThreads>(k_s + R * S, vb, sv.t, k0, R, T);
    if (maskb) copy_vec(k_s + 2 * R * S, maskb, k0, R, T, tid);
  };

  copy_rows<D, kPairThreads>(q_s, qb, sq.t, q0, kRows, T);
  copy_rows<D, kPairThreads>(do_s, dob, sdo.t, q0, kRows, T);
  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_tiles = (k_end + R - 1) / R;
  load_tile(0, 0);
  tf32mma::cp_async_commit();

  // delta = rowsum(do * o), kRows / 8 rows a warp, read from device
  // memory while the copies fly, and shared with the warps of the rows
  constexpr int kDeltaRows = kRows / (2 * kWarps);
#pragma unroll 2
  for (int i = 0; i < kDeltaRows; ++i) {
    const int lr = kDeltaRows * warp + i, row = q0 + lr;
    float acc = 0.f;
    if (row < T) {   // uniform across the warp
      const float* orow = ob + row * so.t;
      const float* drow = dob + row * sdo.t;
      for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[lr] = acc;
      if (row < T) delta[(long long)bh * T + row] = acc;
    }
  }
  __syncthreads();
  const float scale_log2 = scale * kLog2e;
  float row_delta[2], lse_log2[2];
  int row_idx[2];
  bool row_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_delta[hh] = delta_s[r0 + g + 8 * hh];
    row_idx[hh] = q0 + r0 + g + 8 * hh;
    const float row_lse = row_idx[hh] < T
                              ? lse[(long long)bh * T + row_idx[hh]]
                              : kNegInf;
    row_live[hh] = row_lse > kDead;
    lse_log2[hh] = row_lse * kLog2e;
  }

  float acc[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // this tile has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (it + 1 < n_tiles) load_tile((it + 1) * R, (it + 1) % kStages);
    tf32mma::cp_async_commit();

    const int k0 = it * R;
    const float* k_s = ring + (it % kStages) * L::kStage;
    const float* v_s = k_s + R * S;
    const float* live_s = v_s + R * S;

    // the warpgroup's share of s = q.k^T and dp = do.v^T, 16 rows x R
    float s[NF][4], dp[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int c = c0; c < c0 + C; c += 8) {
      Frag aq[4], ado[4];
      tf32mma::load_a<S>(aq, q_s, r0, c, g, t);
      tf32mma::load_a<S>(ado, do_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        Frag bk[2], bv[2];
        tf32mma::load_b_t<S>(bk, k_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], aq, bk);
        tf32mma::load_b_t<S>(bv, v_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], ado, bv);
      }
    }
    sum_pair(xch, wg, w, lane, s, dp);

    // ds = p (dp - delta) scale, in place of s
#pragma unroll
    for (int n = 0; n < NF; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int key = k0 + col;
        const bool ok = row_live[hh] &&
                        (maskb ? live_s[col] > 0.f : key < T) &&
                        (!causal || key <= row_idx[hh]);
        const float p = ok ? softmax_p(s[n][e], scale_log2, lse_log2[hh])
                           : 0.f;
        s[n][e] = p * (dp[n][e] - row_delta[hh]) * scale;
      }
    }

    // dq's warpgroup columns += ds . k into a tile partial, added with
    // f32 adds (as in dq_kernel)
    float part[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      Frag a[4];
      tf32mma::as_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        Frag bk[2];
        tf32mma::load_b_pairs<S>(bk, k_s, 8 * j, c0 + 8 * n, g, t);
        tf32mma::mma3(part[n], a, bk);
      }
    }
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  float* dqb = dq + b * sdq.b + h * sdq.h + c0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row_idx[hh] >= T) continue;
    float* row = dqb + row_idx[hh] * sdq.t + 2 * t;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
}

// dk and dv at D = 256: 8 warps over 64 key rows, k and v resident at the
// whole width, query tiles of R streamed. Warp w of warpgroup wg sums
// s^T = k.q^T and dp^T = v.do^T for keys 16 (w % 4) over the
// warpgroup's 128 columns, the pair adds their partials, and each warp
// computes p^T and ds^T and dv += p^T . do, dk += ds^T . q over its
// warpgroup's 128 columns (no partials: as in dkv_kernel at D = 128
// they would spill).
__global__ void __launch_bounds__(kPairThreads, 1)
dkv_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v,
                const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ kv_mask, float* __restrict__ dk,
                float* __restrict__ dv, int T, int H, Strides sq,
                Strides sk, Strides sv, Strides sdo, Strides sdk,
                Strides sdv, float scale, int causal) {
  using L = PairLayout;
  constexpr int D = kPairD;
  constexpr int C = L::C, S = L::S, R = L::R, NF = L::kFrags;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // kRows x S
  float* v_s = k_s + kRows * S;                    // kRows x S
  float* ring = v_s + kRows * S;                   // kStages x kStage
  float4* xch = reinterpret_cast<float4*>(ring + kStages * L::kStage);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / kWarps, w = warp % kWarps;
  const int r0 = 16 * w;    // the key rows of warps w and w + kWarps
  const int c0 = C * wg;    // the warpgroup's columns
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kRows;   // heaviest (causal) first

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;

  // stage st <- queries [q0, q0 + R): q, do, lse and delta
  auto load_tile = [&](int q0, int st) {
    float* q_s = ring + st * L::kStage;
    copy_rows<D, kPairThreads>(q_s, qb, sq.t, q0, R, T);
    copy_rows<D, kPairThreads>(q_s + R * S, dob, sdo.t, q0, R, T);
    copy_vec(q_s + 2 * R * S, lseb, q0, R, T, tid);
    copy_vec(q_s + 2 * R * S + R, deltab, q0, R, T, tid - R);
  };

  copy_rows<D, kPairThreads>(k_s, k + b * sk.b + h * sk.h, sk.t, k0,
                             kRows, T);
  copy_rows<D, kPairThreads>(v_s, v + b * sv.b + h * sv.h, sv.t, k0,
                             kRows, T);
  const int q_begin = causal ? k0 : 0;   // R divides kRows
  const int n_tiles = (T - q_begin + R - 1) / R;
  load_tile(q_begin, 0);
  tf32mma::cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  int key[2];
  bool key_live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key[hh] = k0 + r0 + g + 8 * hh;
    key_live[hh] = key[hh] < T &&
                   (kv_mask == nullptr ||
                    kv_mask[(long long)b * T + key[hh]] > 0.f);
  }

  float dk_acc[C / 8][4], dv_acc[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tf32mma::cp_async_wait<0>();   // this tile has landed ...
    __syncthreads();               // ... and the last one's readers are done
    if (it + 1 < n_tiles)
      load_tile(q_begin + (it + 1) * R, (it + 1) % kStages);
    tf32mma::cp_async_commit();

    const int q0 = q_begin + it * R;
    const float* q_s = ring + (it % kStages) * L::kStage;
    const float* do_s = q_s + R * S;
    const float* lse_s = do_s + R * S;
    const float* delta_s = lse_s + R;

    // the warpgroup's share of s^T = k.q^T and dp^T = v.do^T, 16 keys x R
    float s[NF][4], dp[NF][4];
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int c = c0; c < c0 + C; c += 8) {
      Frag ak[4], av[4];
      tf32mma::load_a<S>(ak, k_s, r0, c, g, t);
      tf32mma::load_a<S>(av, v_s, r0, c, g, t);
#pragma unroll
      for (int n = 0; n < NF; ++n) {
        Frag bq[2], bdo[2];
        tf32mma::load_b_t<S>(bq, q_s, 8 * n, c, g, t);
        tf32mma::mma3(s[n], ak, bq);
        tf32mma::load_b_t<S>(bdo, do_s, 8 * n, c, g, t);
        tf32mma::mma3(dp[n], av, bdo);
      }
    }
    sum_pair(xch, wg, w, lane, s, dp);

    // p^T in place of s, ds^T in place of dp
#pragma unroll
    for (int n = 0; n < NF; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int qi = q0 + col;
        const float row_lse = lse_s[col];
        const bool ok = key_live[hh] && qi < T && row_lse > kDead &&
                        (!causal || key[hh] <= qi);
        const float p = ok ? softmax_p(s[n][e], scale_log2,
                                       row_lse * kLog2e)
                           : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[col]) * scale;
      }
    }

    // dv += p^T . do and dk += ds^T . q over the warpgroup's columns
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      Frag ap[4], ads[4];
      tf32mma::as_a(ap, s[j]);
      tf32mma::as_a(ads, dp[j]);
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        Frag bdo[2], bq[2];
        tf32mma::load_b_pairs<S>(bdo, do_s, 8 * j, c0 + 8 * n, g, t);
        tf32mma::mma3(dv_acc[n], ap, bdo);
        tf32mma::load_b_pairs<S>(bq, q_s, 8 * j, c0 + 8 * n, g, t);
        tf32mma::mma3(dk_acc[n], ads, bq);
      }
    }
  }

  float* dkb = dk + b * sdk.b + h * sdk.h + c0;
  float* dvb = dv + b * sdv.b + h * sdv.h + c0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] >= T) continue;
    float* dkr = dkb + key[hh] * sdk.t + 2 * t;
    float* dvr = dvb + key[hh] * sdv.t + 2 * t;
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n) =
          make_float2(dk_acc[n][2 * hh], dk_acc[n][2 * hh + 1]);
      *reinterpret_cast<float2*>(dvr + 8 * n) =
          make_float2(dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
    }
  }
}

int launch_dq_pair(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   const float* kv_mask, float* dq, float* delta, int B,
                   int T, int H, Strides sq, Strides sk, Strides sv,
                   Strides so, Strides sdo, Strides sdq, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = PairLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dq_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  dq_pair_kernel<<<grid, kPairThreads, smem, stream>>>(
      q, k, v, o, dout, lse, kv_mask, dq, delta, T, H, sq, sk, sv, so, sdo,
      sdq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_pair(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    const float* kv_mask, float* dk, float* dv, int B, int T,
                    int H, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdk, Strides sdv, float scale, int causal,
                    cudaStream_t stream) {
  const size_t smem = PairLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  dkv_pair_kernel<<<grid, kPairThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, dk, dv, T, H, sq, sk, sv, sdo,
      sdk, sdv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_wide(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   const float* kv_mask, float* dq, float* delta, int B,
                   int T, int H, int D, Strides sq, Strides sk, Strides sv,
                   Strides so, Strides sdo, Strides sdq, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int C = kWideChunk;
  const size_t smem = WideLayout<C>::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows, D / C);
  dq_wide_kernel<C><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, dout, lse, kv_mask, dq, delta, T, H, D, sq, sk, sv, so,
      sdo, sdq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_wide(const float* q, const float* k, const float* v,
                    const float* dout, const float* lse, const float* delta,
                    const float* kv_mask, float* dk, float* dv, int B, int T,
                    int H, int D, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdk, Strides sdv, float scale,
                    int causal, cudaStream_t stream) {
  constexpr int C = kWideChunk;
  const size_t smem = WideLayout<C>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_wide_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows, D / C);
  dkv_wide_kernel<C><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, kv_mask, dk, dv, T, H, D, sq, sk, sv, sdo,
      sdk, sdv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* o, const float* dout, const float* lse,
              const float* kv_mask, float* dq, float* delta, int B, int T,
              int H, Strides sq, Strides sk, Strides sv, Strides so,
              Strides sdo, Strides sdq, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, dout, lse, kv_mask, dq, delta, T, H, sq, sk, sv, so, sdo,
      sdq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const float* kv_mask, float* dk, float* dv, int B, int T,
               int H, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdk, Strides sdv, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
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
    case kPairD:
      return launch_dq_pair(qf, kf, vf, of, df, lf, mf, dqf, deltaf, B, T,
                            H, sq, sk, sv, so, sdo, sdq, scale, causal, st);
    default:
      if (D > 128 && D % kWideChunk == 0)
        return launch_dq_wide(qf, kf, vf, of, df, lf, mf, dqf, deltaf, B, T,
                              H, D, sq, sk, sv, so, sdo, sdq, scale, causal,
                              st);
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
    case kPairD:
      return launch_dkv_pair(qf, kf, vf, df, lf, deltaf, mf, dkf, dvf, B, T,
                             H, sq, sk, sv, sdo, sdk, sdv, scale, causal,
                             st);
    default:
      if (D > 128 && D % kWideChunk == 0)
        return launch_dkv_wide(qf, kf, vf, df, lf, deltaf, mf, dkf, dvf, B,
                               T, H, D, sq, sk, sv, sdo, sdk, sdv, scale,
                               causal, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
