// Warp-level building blocks for Hopper (sm_90a) kernels that run f32
// products on the tensor cores at f32 accuracy: the 3xTF32 split,
// mma.sync m16n8k8 with TF32 operands and f32 accumulators, and cp.async
// copies into shared memory.
//
// 3xTF32: each operand x is split as x = hi + lo, hi = tf32(x) rounded
// to nearest with ties away from zero (the rounding of cvt.rna.tf32.f32)
// and lo = x - hi (exact in f32). A product a.b is accumulated in f32 as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two small cross terms first.
// The tensor core reads a TF32 operand's top 19 bits, so lo is truncated
// to TF32 there; with lo.lo dropped, a product is off by at most about
// 3 * 2^-21 of itself (one TF32 pass: 2^-11, about 3 decimal digits).
//
// Cost: on sm_90 cvt.rna.tf32.f32 compiles to four instructions (a
// finiteness test and a select around the add and mask), and rounding
// lo as well doubles that; the split is the bulk of the non-tensor
// instructions in the products' inner loops. split() rounds hi with the
// integer add and mask alone (the same bits for every finite x; an
// infinite x gives NaN, as its products would) and leaves lo unrounded:
// 3 instructions an element instead of 9.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8, f32):  c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// A C fragment feeds the next product as an A fragment without moving:
// take A's depth index t to mean column 2t of C and t + 4 to mean 2t + 1,
// so (a0, a1, a2, a3) = (c0, c2, c1, c3), and read B's rows in the same
// order (row 2t as b0, row 2t + 1 as b1). See as_a() and the callers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

struct Frag {   // one TF32 operand fragment split in two passes
  uint32_t hi, lo;
};

__device__ __forceinline__ Frag split(float x) {
  Frag f;
  f.hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;   // round to nearest
  f.lo = __float_as_uint(x - __uint_as_float(f.hi));
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a.b at f32 accuracy: three TF32 passes, small cross terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag (&a)[4],
                                     const Frag (&b)[2]) {
  mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// The A fragment of rows (r0 + g, r0 + g + 8), depth columns
// (c0 + t, c0 + t + 4) of a row-major shared tile with row stride S.
// Free of bank conflicts when S % 32 == 4.
template <int S>
__device__ __forceinline__ void load_a(Frag (&a)[4], const float* s, int r0,
                                       int c0, int g, int t) {
  const float* p = s + (r0 + g) * S + c0 + t;
  a[0] = split(p[0]);
  a[1] = split(p[8 * S]);
  a[2] = split(p[4]);
  a[3] = split(p[8 * S + 4]);
}

// The B fragment whose columns n are rows (n0 + g) of a row-major shared
// tile and whose depth is columns (c0 + t, c0 + t + 4): B = tile^T, as
// k^T in q.k^T. Free of bank conflicts when S % 32 == 4.
template <int S>
__device__ __forceinline__ void load_b_t(Frag (&b)[2], const float* s,
                                         int n0, int c0, int g, int t) {
  const float* p = s + (n0 + g) * S + c0 + t;
  b[0] = split(p[0]);
  b[1] = split(p[4]);
}

// The B fragment for a C-fragment A (see as_a): depth rows (r0 + 2t,
// r0 + 2t + 1) of a row-major shared tile, column n0 + g. Free of bank
// conflicts when S % 32 == 4.
template <int S>
__device__ __forceinline__ void load_b_pairs(Frag (&b)[2], const float* s,
                                             int r0, int n0, int g, int t) {
  const float* p = s + (r0 + 2 * t) * S + n0 + g;
  b[0] = split(p[0]);
  b[1] = split(p[S]);
}

// A resident A operand split once, for a loop that multiplies it with
// many tiles of another: rows [r0, r0 + 16) of a row-major shared tile
// (stride S, K columns), times `scale`, are replaced by their hi halves,
// and their lo halves go to `lo` (same layout). The warp's lanes take
// whole float4 groups; __syncwarp() before reading them back with
// load_a_split.
template <int S, int K>
__device__ __forceinline__ void split_rows(float* s, uint32_t* lo, int r0,
                                           float scale, int lane) {
  constexpr int K4 = K / 4;
  for (int i = lane; i < 16 * K4; i += 32) {
    const int at = (r0 + i / K4) * S + (i % K4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(s + at);
    const Frag f0 = split(scale * x.x), f1 = split(scale * x.y),
               f2 = split(scale * x.z), f3 = split(scale * x.w);
    *reinterpret_cast<uint4*>(s + at) = make_uint4(f0.hi, f1.hi, f2.hi,
                                                   f3.hi);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(f0.lo, f1.lo, f2.lo,
                                                    f3.lo);
  }
}

// load_a's fragment from the two halves split_rows left in shared memory.
template <int S>
__device__ __forceinline__ void load_a_split(Frag (&a)[4],
                                             const uint32_t* hi,
                                             const uint32_t* lo, int r0,
                                             int c0, int g, int t) {
  const int i = (r0 + g) * S + c0 + t;
  a[0] = Frag{hi[i], lo[i]};
  a[1] = Frag{hi[i + 8 * S], lo[i + 8 * S]};
  a[2] = Frag{hi[i + 4], lo[i + 4]};
  a[3] = Frag{hi[i + 8 * S + 4], lo[i + 8 * S + 4]};
}

// A C fragment (16 x 8 f32) as the A operand of the next product.
__device__ __forceinline__ void as_a(Frag (&a)[4], const float (&c)[4]) {
  a[0] = split(c[0]);
  a[1] = split(c[2]);
  a[2] = split(c[1]);
  a[3] = split(c[3]);
}

// 16-byte / 4-byte asynchronous copies global -> shared; src_size 0
// (pred false) fills the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The two-warpgroup kernels' meeting of warps w and w + 4 (the two
// warpgroups' warps over the same rows): named barrier 1 + w for their
// 64 threads; barrier 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + w), "n"(2 * 32) : "memory");
}

}  // namespace tf32mma
