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
// to gain, so the products are f32 FMAs on the CUDA cores. The design
// reads each live k/v row once, through the table, and keeps the rest on
// chip:
//
//   - one CTA of 4 warps per (slot, head, tile of up to QT queries); QT
//     is 1 for t = 1 (the decode step) and 16 otherwise (prefill chunks,
//     the speculative verify chunk). The tile's q sits in shared memory,
//     pre-scaled by Dh^-0.5 * log2(e) so the softmax runs on exp2;
//   - the warps take interleaved tiles of 32 keys. Scores: a lane owns
//     one key, reads its k row through the table with 16-byte loads (the
//     whole row in flight at once) and takes its dot with every query of
//     the tile (q read from shared memory as a broadcast);
//   - an online softmax per query in registers: the tile's max over the
//     warp by shuffles, the running max warp-uniform, the denominator a
//     per-lane partial reduced once at the end. Masked keys give p = 0
//     exactly, and a query that has seen no key yet keeps m = -inf with
//     nothing to rescale, so no NaN arises;
//   - p.v: a lane owns Dh/32 output dims; for each key of the tile the
//     warp reads the v row whole (coalesced, its row offset shuffled from
//     the lane that owned the key) and each lane adds p_j * v_j[dims];
//   - the four warps' (max, sum, o) are merged through shared memory and
//     written once.
//
// The positions ride in the launch by value (up to kMaxSlots slots a
// launch), so the caller checks them on the host and no copy precedes
// the launch. The kernel trusts every table entry a live key reaches to
// name a page of the pool. No atomics: every launch gives the same bits.
//
// C interface (loaded with ctypes): dl4j_decode_attention_f32 returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments it does not take. It allocates
// nothing; q, o are contiguous (S, t, H, Dh), the pools contiguous
// (N, page_size, H, Dh), table contiguous (S, P) int32, and pos a HOST
// pointer to S int32 positions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 32;      // keys a warp scores at once, one a lane
constexpr int kMaxSlots = 512;    // positions carried by value a launch
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Positions {
  int v[kMaxSlots];
};

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

template <int D, int QT>
struct Smem {
  float4 q[QT][D / 4];
  float m[kWarps][QT];
  float l[kWarps][QT];
  float acc[kWarps][QT][D];
};

template <int D, int QT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k_pool,
                            const float* __restrict__ v_pool,
                            const int* __restrict__ table,
                            float* __restrict__ o, const Positions pos,
                            int t, int H, int page_size, int P,
                            float scale_log2) {
  constexpr int VL = D / 32;              // output dims a lane owns
  constexpr int C4 = D / 4;               // float4 chunks of a row
  constexpr int CH = QT == 1 ? 8 : 4;     // chunks of a k row in flight
  static_assert(C4 % CH == 0, "head dim must be 32, 64 or 128");
  __shared__ Smem<D, QT> sm;

  const int s = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, t - q0);         // queries of this tile
  const int p0 = pos.v[s];
  const int n_keys = p0 + q0 + nq;        // keys the tile's last query sees
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(H) * D;  // floats a position

  for (int idx = threadIdx.x; idx < QT * C4; idx += kThreads) {
    const int i = idx / C4, c = idx % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nq) {
      x = reinterpret_cast<const float4*>(
          q + ((static_cast<long long>(s) * t + q0 + i) * H + h) * D)[c];
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
    }
    sm.q[i][c] = x;
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

  const int* trow = table + static_cast<long long>(s) * P;
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    const int j = tile * kKeyTile + lane;  // this lane's key
    const bool live = j < n_keys;
    // the key's row offset in either pool (head h); a dead lane points at
    // row 0 of page 0, which exists, and its p is 0
    long long krow = static_cast<long long>(h) * D;
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
      for (int c0 = 0; c0 < C4; c0 += CH) {
        float4 kr[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) kr[u] = kp[c0 + u];
#pragma unroll
        for (int i = 0; i < QT; ++i) {
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const float4 qq = sm.q[i][c0 + u];
            sc[i] = fmaf(qq.x, kr[u].x, sc[i]);
            sc[i] = fmaf(qq.y, kr[u].y, sc[i]);
            sc[i] = fmaf(qq.z, kr[u].z, sc[i]);
            sc[i] = fmaf(qq.w, kr[u].w, sc[i]);
          }
        }
      }
    }
    // online softmax: key j is visible to query i when j <= p0 + q0 + i
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const bool vis = live && j <= p0 + q0 + i;
      const float si = vis ? sc[i] : -INFINITY;
      const float mn = fmaxf(m[i], warp_max(si));
      const float corr = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mn);
      sc[i] = vis ? exp2f(si - mn) : 0.f;  // p
      l[i] = l[i] * corr + sc[i];
#pragma unroll
      for (int e = 0; e < VL; ++e) acc[i][e] *= corr;
      m[i] = mn;
    }
    // p.v, a v row at a time across the warp
    const int base = tile * kKeyTile;
#pragma unroll
    for (int jj = 0; jj < kKeyTile; ++jj) {
      const long long vrow = __shfl_sync(kFull, krow, jj);
      float pj[QT];
#pragma unroll
      for (int i = 0; i < QT; ++i) pj[i] = __shfl_sync(kFull, sc[i], jj);
      if (base + jj < n_keys) {
        float vv[VL];
        load_row<VL>(v_pool + vrow + lane * VL, vv);
#pragma unroll
        for (int i = 0; i < QT; ++i)
#pragma unroll
          for (int e = 0; e < VL; ++e) acc[i][e] = fmaf(pj[i], vv[e], acc[i][e]);
      }
    }
  }

  // merge the warps: o = sum_w acc_w 2^(m_w - M) / sum_w l_w 2^(m_w - M)
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
    o[((static_cast<long long>(s) * t + q0 + i) * H + h) * D + d] = num / den;
  }
}

template <int D, int QT>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* table, float* o, const Positions& pos, int S, int t,
           int H, int page_size, int P, float scale_log2,
           cudaStream_t stream) {
  const dim3 grid((t + QT - 1) / QT, H, S);
  decode_attention_kernel<D, QT><<<grid, kThreads, 0, stream>>>(
      q, k_pool, v_pool, table, o, pos, t, H, page_size, P, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* q, const float* k_pool, const float* v_pool,
             const int* table, float* o, const Positions& pos, int S, int t,
             int H, int page_size, int P, float scale_log2,
             cudaStream_t stream) {
  if (t == 1)
    return launch<D, 1>(q, k_pool, v_pool, table, o, pos, S, t, H,
                        page_size, P, scale_log2, stream);
  return launch<D, 16>(q, k_pool, v_pool, table, o, pos, S, t, H, page_size,
                       P, scale_log2, stream);
}

}  // namespace

extern "C" int dl4j_decode_attention_f32(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* table, const void* pos,
                                         void* o, int S, int t, int H, int D,
                                         int page_size, int P, float scale,
                                         void* stream) {
  if (S < 1 || S > kMaxSlots || t < 1 || H < 1 || H > 65535 ||
      page_size < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Positions p;
  memset(&p, 0, sizeof(p));
  memcpy(p.v, pos, static_cast<size_t>(S) * sizeof(int));
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* tf = static_cast<const int*>(table);
  float* of = static_cast<float*>(o);
  const float sl = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(qf, kf, vf, tf, of, p, S, t, H, page_size, P, sl,
                          st);
    case 64:
      return launch_d<64>(qf, kf, vf, tf, of, p, S, t, H, page_size, P, sl,
                          st);
    case 128:
      return launch_d<128>(qf, kf, vf, tf, of, p, S, t, H, page_size, P, sl,
                           st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
