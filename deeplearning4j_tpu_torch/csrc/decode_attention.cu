// Paged decode attention for Hopper (sm_90a), float32 in, float32 out.
//
// Replaces no Pallas kernel: the JAX package computes decode attention
// with XLA einsums (deeplearning4j_tpu/nn/conf/layers/attention.py:
// SelfAttentionLayer.apply_stream_paged, apply_stream_bounded and
// _stream_attention), gathering each slot's whole virtual cache
// (k_pool[table], v_pool[table]: P * page_size positions, however few
// are live) and masking the positions past the query. Same function
// here, without the gather:
//
//   o[s, i, h] = softmax_j(q[s, i, h] . k_j * Dh^-0.5) . v_j,  j <= pos[s] + i
//
// where key j of slot s lives at pool row (table[s, j / page_size],
// j % page_size). The JAX softmax gives a masked logit -1e30, and
// exp(-1e30 - max) == 0 in f32, so reading only the live keys skips
// nothing that counts. Every query sees key 0, so no row is empty. An
// inactive slot (table row of zeros, pos 0) reads the scratch page 0.
//
// Bound on an H100 SXM (data-sheet peaks, at its 700 W power limit):
// decode (t = 1) does 4*Dh FLOPs per live (query, key) pair against
// 8*Dh bytes of k and v, far below the ~20 FLOP/byte where f32 CUDA-core
// arithmetic (67 TFLOP/s) would be the limit, so it is bound by bytes:
// at S=8 slots, H=16, Dh=64, all slots at position 511, the live k/v
// are 33.6 MB, >= 0.0100 ms at 3.35 TB/s. There is no tensor-core work
// to gain, so the products are f32 FMAs on the CUDA cores. Reaching the
// byte rate takes many bytes in flight on every SM, so the design is
// flash-decoding: the keys of each (slot, head) are split over CTAs.
//
//   - split kernel: one CTA of 4 warps per (key chunk of kChunk = 128
//     keys, slot, head, tile of up to QT queries); QT is 1 for t = 1 (the
//     decode step) and 16 otherwise (prefill chunks, the speculative
//     verify chunk). The number of chunks is ceil(P * page_size /
//     kChunk): it depends on the table's span only, never on the
//     positions, so a launch captured in a CUDA graph stays valid for
//     any positions. A chunk that starts past the tile's last key
//     writes an empty partial (m = -inf, l = 0) and exits. At S=8, H=16,
//     span 1024 that is 1024 CTAs, 512 of them live at position 511:
//     about four a SM, all resident in one wave;
//   - inside a CTA each warp takes one tile of 32 keys. Scores: a lane
//     owns one key, reads its k row through the table with 16-byte
//     loads (the whole row in flight at once for Dh <= 64) and takes its
//     dot with every query of the tile (q, pre-scaled by Dh^-0.5 *
//     log2(e), from shared memory as a broadcast); an online softmax per
//     query in registers (masked keys give p = 0 exactly, and a query
//     that has seen no key keeps m = -inf with nothing to rescale);
//   - p.v: a lane owns Dh/32 output dims; the warp reads the tile's v
//     rows whole (coalesced, the row offset shuffled from the lane that
//     owned the key), a batch of rows loaded unconditionally (a dead
//     key's offset points at row 0 of page 0, which exists) before their
//     FMAs, so the loads of a batch are in flight together; a dead row's
//     value is replaced by 0 after the load;
//   - the four warps' (max, sum, o) are merged through shared memory and
//     written as the chunk's partial: m and l (log2 domain), and the
//     unnormalised o;
//   - merge kernel: one thread per output element walks the chunks in
//     order: M = max m_k, o = sum_k o_k 2^(m_k - M) / sum_k l_k 2^(m_k -
//     M), skipping empty chunks. A fixed order and no atomics: every
//     launch on the same inputs gives the same bits.
//
// Head dims past 128 (Dh = 128 * n_chunks, the wrapper's padded width):
// a lane's k row and its share of o grow with Dh, and at QT = 16 the
// warps' o partials in shared memory alone would pass the 48 KB a
// kernel may hold statically. So a wide launch splits o's columns over
// CTAs as the flash kernels do: each CTA of (key chunk, slot, head, query
// tile) and o-chunk z scores its keys over the whole row (q staged in
// dynamic shared memory at the full width, k read 16 bytes at a time in
// a loop) and runs p.v for its own 128 columns of o. Every chunk computes
// the same scores in the same order; chunk 0 writes the (m, l) partials,
// each chunk its columns of the o partials, and the merge kernel, which
// takes any width, is unchanged. The cost is the scores' k reads once
// for every chunk of o (k's bytes twice at Dh = 256, v's once).
//
// The positions are read from device memory (pos, S int32), so a graph
// replay reads the step's positions from the buffer it was captured
// with; the caller checks them on its host copy before the launch or
// the replay. The kernel trusts every table entry a live key reaches to
// name a page of the pool.
//
// C interface (loaded with ctypes): dl4j_decode_attention_f32 returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for arguments it does not take. It allocates
// nothing; q, o are contiguous (S, t, H, Dh), the pools contiguous
// (N, page_size, H, Dh), table contiguous (S, P) int32, pos (S,) int32,
// all in device memory, and partials a device scratch buffer of
// S * t * H * n_split * (Dh + 2) floats, n_split = ceil(P * page_size /
// 128) (checked).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 32;               // keys a warp scores at once
constexpr int kChunk = kKeyTile * kWarps;  // keys a CTA takes
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Dh / 32 consecutive floats of a row, one 4-, 8- or 16-byte load.
template <int VL>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VL]) {
  if constexpr (VL == 1) {
    r[0] = *p;
  } else if constexpr (VL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x;
    r[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  }
}

// DQ: the row width when it is the chunk width D (a narrow launch, all
// sizes known at compile time), or 0 for a wide launch, whose row width
// Dq is an argument and whose q lives in dynamic shared memory.
template <int D, int QT, int DQ>
struct Smem {
  float4 q[QT][DQ ? D / 4 : 1];
  float m[kWarps][QT];
  float l[kWarps][QT];
  float acc[kWarps][QT][D];
};

template <int D, int QT, int DQ>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        float* __restrict__ part_o,
                        float2* __restrict__ part_ml, int t, int H,
                        int page_size, int P, int n_split,
                        float scale_log2, int dq_arg) {
  constexpr int VL = D / 32;                    // output dims a lane owns
  // k chunks in flight
  constexpr int CH = QT == 1 ? (D / 4 < 16 ? D / 4 : 16) : 4;
  constexpr int VB = QT == 1 ? 8 : 4;           // v rows loaded together
  static_assert((D / 4) % CH == 0, "chunk width must be 32, 64 or 128");
  static_assert(kKeyTile % VB == 0, "v batch must divide the key tile");
  static_assert(DQ == 0 || DQ == D, "a narrow launch's row is its chunk");
  __shared__ Smem<D, QT, DQ> sm;
  extern __shared__ float4 q_wide[];            // QT x Dq / 4, wide only
  const int dq = DQ ? DQ : dq_arg;              // the row's width
  const int C4 = dq / 4;                        // float4 chunks of a row
  const int n_chunks = DQ ? 1 : dq / D;         // o's column chunks
  float4* q_s = DQ ? &sm.q[0][0] : q_wide;      // q_s[i * C4 + c]

  const int split = blockIdx.x % n_split;
  const int z = (blockIdx.x / n_split) % n_chunks;   // o's chunk
  const int q0 = (blockIdx.x / n_split / n_chunks) * QT;
  const int s = blockIdx.z, h = blockIdx.y;
  const int nq = min(QT, t - q0);               // queries of this tile
  const int p0 = pos[s];
  const int n_keys = p0 + q0 + nq;              // keys the last query sees
  const int c0 = split * kChunk;
  const int c1 = min(c0 + kChunk, n_keys);      // this CTA's keys: [c0, c1)
  // partial row of query i: ((s * t + q0 + i) * H + h) * n_split + split
  const long long prow =
      ((static_cast<long long>(s) * t + q0) * H + h) * n_split + split;
  const long long pstep = static_cast<long long>(H) * n_split;
  if (c0 >= c1) {                               // block-uniform
    if (threadIdx.x < nq && z == 0)
      part_ml[prow + threadIdx.x * pstep] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(H) * dq;  // floats a position

  for (int idx = threadIdx.x; idx < QT * C4; idx += kThreads) {
    const int i = idx / C4, c = idx % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nq) {
      x = reinterpret_cast<const float4*>(
          q + ((static_cast<long long>(s) * t + q0 + i) * H + h) * dq)[c];
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
    }
    q_s[i * C4 + c] = x;
  }
  __syncthreads();

  float m[QT], l[QT], acc[QT][VL];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VL; ++e) acc[i][e] = 0.f;
  }

  const int base = c0 + warp * kKeyTile;        // this warp's tile
  if (base < c1) {                              // warp-uniform
    const int* trow = table + static_cast<long long>(s) * P;
    const int j = base + lane;                  // this lane's key
    const bool live = j < c1;
    // the key's row offset in either pool (head h); a dead lane points at
    // row 0 of page 0, which exists, and its p is 0
    long long krow = static_cast<long long>(h) * dq;
    if (live) {
      const long long page = trow[j / page_size];
      krow += (page * page_size + j % page_size) * row;
    }
    float sc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) sc[i] = 0.f;
    if (live) {
      const float4* kp = reinterpret_cast<const float4*>(k_pool + krow);
#pragma unroll
      for (int c0k = 0; c0k < C4; c0k += CH) {
        float4 kr[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) kr[u] = kp[c0k + u];
#pragma unroll
        for (int i = 0; i < QT; ++i) {
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const float4 qq = q_s[i * C4 + c0k + u];
            sc[i] = fmaf(qq.x, kr[u].x, sc[i]);
            sc[i] = fmaf(qq.y, kr[u].y, sc[i]);
            sc[i] = fmaf(qq.z, kr[u].z, sc[i]);
            sc[i] = fmaf(qq.w, kr[u].w, sc[i]);
          }
        }
      }
    }
    // softmax over the tile: key j is visible to query i when
    // j <= p0 + q0 + i
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const bool vis = live && j <= p0 + q0 + i;
      const float si = vis ? sc[i] : -INFINITY;
      const float mn = warp_max(si);
      sc[i] = vis ? exp2f(si - mn) : 0.f;       // p
      l[i] = sc[i];
      m[i] = mn;
    }
    // p.v, VB v rows in flight at a time across the warp
#pragma unroll
    for (int jb = 0; jb < kKeyTile; jb += VB) {
      float vv[VB][VL];
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const long long vrow = __shfl_sync(kFull, krow, jb + u);
        load_row<VL>(v_pool + vrow + z * D + lane * VL, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        const bool lv = base + jb + u < c1;
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const float pj = __shfl_sync(kFull, sc[i], jb + u);
#pragma unroll
          for (int e = 0; e < VL; ++e)
            acc[i][e] = fmaf(pj, lv ? vv[u][e] : 0.f, acc[i][e]);
        }
      }
    }
  }

  // merge the warps into the chunk's partial: m = max_w m_w,
  // l = sum_w l_w 2^(m_w - m), o = sum_w acc_w 2^(m_w - m)
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const float li = warp_sum(l[i]);
    if (lane == 0) {
      sm.m[warp][i] = m[i];
      sm.l[warp][i] = li;
    }
#pragma unroll
    for (int e = 0; e < VL; ++e) sm.acc[warp][i][lane * VL + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm.m[w][i]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm.m[w][i];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      den = fmaf(sm.l[w][i], f, den);
      num = fmaf(sm.acc[w][i][d], f, num);
    }
    const long long r = prow + i * pstep;
    part_o[r * dq + z * D + d] = num;
    if (d == 0 && z == 0) part_ml[r] = make_float2(mx, den);
  }
}

// o[r, d] from the n_split partials of row r, in chunk order.
__global__ void __launch_bounds__(kThreads)
    decode_merge_kernel(const float* __restrict__ part_o,
                        const float2* __restrict__ part_ml,
                        float* __restrict__ o, long long n_out, int D,
                        int n_split) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const long long r = idx / D;
  const int d = static_cast<int>(idx % D);
  const float2* ml = part_ml + r * n_split;
  float mx = -INFINITY;
  for (int k = 0; k < n_split; ++k) mx = fmaxf(mx, ml[k].x);
  float den = 0.f, num = 0.f;
  for (int k = 0; k < n_split; ++k) {
    const float2 x = ml[k];
    if (x.x == -INFINITY) continue;             // an empty chunk
    const float f = exp2f(x.x - mx);
    den = fmaf(x.y, f, den);
    num = fmaf(part_o[(r * n_split + k) * D + d], f, num);
  }
  o[idx] = num / den;
}

constexpr int kWideChunk = 128;   // o's columns a wide CTA owns

// DQ = D: a narrow launch at row width D; DQ = 0: a wide one at row width
// dq (a multiple of D), its q staged in dq * QT * 4 bytes of dynamic
// shared memory.
template <int D, int QT, int DQ>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* table, const int* pos, float* o, float* part_o,
           float2* part_ml, int S, int t, int H, int dq, int page_size,
           int P, int n_split, float scale_log2, cudaStream_t stream) {
  const int n_qt = (t + QT - 1) / QT;
  size_t smem = 0;
  if constexpr (DQ == 0) {
    smem = sizeof(float) * QT * dq;
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<D, QT, DQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_split * n_qt * (dq / D), H, S);
  decode_split_kernel<D, QT, DQ><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, pos, part_o, part_ml, t, H, page_size, P,
      n_split, scale_log2, dq);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = static_cast<long long>(S) * t * H * dq;
  const unsigned blocks =
      static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  decode_merge_kernel<<<blocks, kThreads, 0, stream>>>(part_o, part_ml, o,
                                                       n_out, dq, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DQ>
int launch_d(const float* q, const float* k_pool, const float* v_pool,
             const int* table, const int* pos, float* o, float* part_o,
             float2* part_ml, int S, int t, int H, int dq, int page_size,
             int P, int n_split, float scale_log2, cudaStream_t stream) {
  if (t == 1)
    return launch<D, 1, DQ>(q, k_pool, v_pool, table, pos, o, part_o,
                            part_ml, S, t, H, dq, page_size, P, n_split,
                            scale_log2, stream);
  return launch<D, 16, DQ>(q, k_pool, v_pool, table, pos, o, part_o,
                           part_ml, S, t, H, dq, page_size, P, n_split,
                           scale_log2, stream);
}

}  // namespace

extern "C" int dl4j_decode_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* o, void* partials, int S, int t, int H, int D,
    int page_size, int P, int n_split, float scale, void* stream) {
  if (S < 1 || S > 65535 || t < 1 || H < 1 || H > 65535 || page_size < 1 ||
      P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long span = static_cast<long long>(P) * page_size;
  const long long rows = static_cast<long long>(S) * t * H;
  const long long n_chunks = D > 128 ? D / kWideChunk : 1;
  if (n_split != (span + kChunk - 1) / kChunk ||
      static_cast<long long>(n_split) * ((t + 15) / 16) * n_chunks >
          0x7fffffffLL ||
      rows * D / kThreads >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* tf = static_cast<const int*>(table);
  const int* pf = static_cast<const int*>(pos);
  float* of = static_cast<float*>(o);
  float* po = static_cast<float*>(partials);
  float2* pml = reinterpret_cast<float2*>(po + rows * n_split * D);
  const float sl = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32, 32>(qf, kf, vf, tf, pf, of, po, pml, S, t, H, D,
                              page_size, P, n_split, sl, st);
    case 64:
      return launch_d<64, 64>(qf, kf, vf, tf, pf, of, po, pml, S, t, H, D,
                              page_size, P, n_split, sl, st);
    case 128:
      return launch_d<128, 128>(qf, kf, vf, tf, pf, of, po, pml, S, t, H, D,
                                page_size, P, n_split, sl, st);
    default:
      if (D > 128 && D % kWideChunk == 0)
        return launch_d<kWideChunk, 0>(qf, kf, vf, tf, pf, of, po, pml, S, t,
                                       H, D, page_size, P, n_split, sl, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
