// Flash-attention forward for Hopper (sm_90a), float32 in, float32 out.
//
// Replaces the Pallas TPU kernel deeplearning4j_tpu/ops/attention.py:
// _fwd_kernel (launched by pallas_flash_attention). Same function:
// exact softmax attention with the online max / denominator recurrence,
// optional causal mask, optional (B, T) key-padding mask, the -1e30
// sentinel rules, o = acc / max(l, 1e-30) and lse = m + log(l) (or
// -1e30 for a row that saw no key), lse stored (B, H, T).
//
// Bound on an H100: at the LM shape (B=8, T=1024, H=16, D=64, causal)
// the work is ~1.7e10 FLOPs against ~134 MB of q/k/v/o, so the kernel is
// bound by operations (>= 0.26 ms at the 67 TFLOP/s CUDA-core f32 rate)
// long before bytes (>= 0.04 ms at 3.35 TB/s). The design therefore
// keeps every operand of the inner products on chip:
//
//   - one CTA per (64-row query tile, b*h); one thread per query row;
//   - the q tile is staged once in shared memory (rows padded by four
//     floats so each thread's float4 reads of its own row do not
//     conflict); K and V are staged in 32-key tiles by coalesced float4
//     loads and read back as float4 broadcasts (every thread of a warp
//     reads the same address);
//   - the 32 scores of a tile live in registers, the f32 accumulator of
//     the row (D floats) lives in registers; the tile's probabilities go
//     through a [key][thread] shared array, which keeps the P.V loop a
//     rolled loop without bank conflicts;
//   - causal CTAs stop at their last row's diagonal, and the heaviest
//     causal tiles are scheduled first.
//
// Unlike the TPU kernel there is no block-divisibility rule: the ragged
// edge of T is masked, so any T works. The TPU's (8, 128) lane layouts
// and its sequential 'arbitrary' grid axis with VMEM scratch are not
// carried over: the key loop runs inside the CTA.
//
// C interface (loaded with ctypes): dl4j_flash_attention_fwd_f32 returns
// cudaGetLastError() after the launch (0 on success). It allocates
// nothing; strides are in elements, the last dimension must be
// contiguous and every row 16-byte aligned.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per CTA, one thread each
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kDead = kNegInf * 0.5f;

struct Strides {
  long long b, t, h;
};

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ kv_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 int T, int H, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, int causal) {
  constexpr int QS = D + 4;        // padded q row stride (floats)
  constexpr int D4 = D / 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // kBlockQ x QS
  float* k_s = q_s + kBlockQ * QS;                 // kBlockK x D
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
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBlockQ * D4; i += kBlockQ) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.t + c);
    *reinterpret_cast<float4*>(q_s + r * QS + c) = x;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

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

    // s = q . k for the 32 keys of the tile
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

    // masks (-1e30 before the max), then the online-softmax update
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const bool ok = live_s[j] > 0.f && (!causal || k0 + j <= qi);
      s[j] = ok ? s[j] * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = (m <= kDead) ? 0.f : expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = (s[j] <= kDead) ? 0.f : expf(s[j] - m_new);
      p_sum += p;
      p_s[j * kBlockQ + tid] = p;
    }
    l = l * corr + p_sum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;

    // acc += p . v (each thread reads only its own p column: no sync)
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      const float p = p_s[j * kBlockQ + tid];
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 vc = *reinterpret_cast<const float4*>(v_s + j * D + c);
        acc[c] = fmaf(p, vc.x, acc[c]);
        acc[c + 1] = fmaf(p, vc.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, vc.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, vc.w, acc[c + 3]);
      }
    }
  }

  // o = acc / max(l, 1e-30) through the q tile, stored coalesced
  const float denom = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(q_s + tid * QS + c) =
        make_float4(acc[c] / denom, acc[c + 1] / denom, acc[c + 2] / denom,
                    acc[c + 3] / denom);
  }
  if (qi < T)
    lse[(long long)bh * T + qi] = (l > 0.f) ? m + logf(denom) : kNegInf;
  __syncthreads();
  for (int i = tid; i < kBlockQ * D4; i += kBlockQ) {
    const int r = i / D4;
    const int c = (i - r * D4) * 4;
    if (q0 + r < T)
      *reinterpret_cast<float4*>(ob + (q0 + r) * so.t + c) =
          *reinterpret_cast<const float4*>(q_s + r * QS + c);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const float* kv_mask, float* o, float* lse, int B, int T, int H,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBlockQ * (D + 4) + 2 * kBlockK * D +
                                       kBlockK * kBlockQ + kBlockK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kBlockQ, smem, stream>>>(
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
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
