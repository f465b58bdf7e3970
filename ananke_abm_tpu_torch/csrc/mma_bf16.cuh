// bf16 tensor-core helpers shared by the port's kernels (sm_90a):
// mma.sync.m16n8k16 bf16 x bf16 -> f32, fragment packing, and B fragments
// read from weights in device memory.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// - A (16x16, row-major): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8,
//   cols 2t, 2t+1), a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8,
//   cols 2t+8, 2t+9); the lower column in the low half.
// - B (16x8, "col"): b0 = (rows 2t, 2t+1; col g), b1 = (rows 2t+8, 2t+9;
//   col g).
// - C (16x8, f32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row
//   g+8, cols 2t, 2t+1).
// Two n-blocks of C (8 columns each) are exactly one k-slice of an A
// fragment, so an activation flows from one product into the next in
// registers (c_to_a), rounded to bf16 on the way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ananke {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j0 + i] += A * (n-block i of W), i < G, over all K/16 k-slices.
// wT is (N_out, K) row-major bf16 from n-block 0 on; lane (g, t) reads row
// 8i+g, cols 16s+2t and 16s+2t+8 -- one 32-bit load per B register.
template <int K, int G, int NOUT>
__device__ __forceinline__ void mma_nblocks(float (&acc)[NOUT][4], int j0,
                                            const uint32_t (&a)[K / 16][4],
                                            const __nv_bfloat16* wT, int g,
                                            int t) {
  const __nv_bfloat16* row = wT + (size_t)g * K + 2 * t;
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const __nv_bfloat16* r = row + (size_t)8 * i * K + 16 * s;
      mma(acc[j0 + i], a[s], ldg32(r), ldg32(r + 8));
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// accumulator fragments of N columns (N/8 n-blocks) -> bf16 A fragments of
// K = N (N/16 k-slices)
template <int N>
__device__ __forceinline__ void c_to_a(const float (&c)[N / 8][4],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s) {
    a[s][0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
    a[s][1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
    a[s][2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
    a[s][3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
  }
}

}  // namespace ananke
