// The helpers that the Hopper stage and its VJP (stage_sm90.cuh: K2b, K6's
// and K7's bf16 body, K8), the float32 DOPRI5 kernels (fused_dopri5.cu) and
// the decode CE kernels (fused_train.cu) share: ldmatrix and shared-memory
// fragment loads and stores, A and C fragments of a warp's rows from and to
// device memory, fragment-order scratch arrays, the column sums, the slab
// layout of the summed gradients, and the drift's bf16 weights as the C
// entry points take them.
//
// Summed gradients go into a CTA's own slab in device memory with plain
// loads and stores, then the slabs are summed in CTA order
// (reduce_slabs.cuh): no atomics, so the same operands give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "reduce_slabs.cuh"

namespace ananke {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void sts32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// A fragments of K columns <-> a warp's 16 rows of a row-major bf16 array
// in shared memory (`base` = the warp's row 0)
template <int K>
__device__ __forceinline__ void lds_a(uint32_t (&a)[K / 16][4],
                                      const bf16* base, int stride, int g,
                                      int t) {
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const bf16* p = base + g * stride + 16 * s + 2 * t;
    a[s][0] = lds32(p);
    a[s][1] = lds32(p + 8 * stride);
    a[s][2] = lds32(p + 8);
    a[s][3] = lds32(p + 8 * stride + 8);
  }
}

template <int K>
__device__ __forceinline__ void sts_a(const uint32_t (&a)[K / 16][4],
                                      bf16* base, int stride, int g, int t) {
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    bf16* p = base + g * stride + 16 * s + 2 * t;
    sts32(p, a[s][0]);
    sts32(p + 8 * stride, a[s][1]);
    sts32(p + 8, a[s][2]);
    sts32(p + 8 * stride + 8, a[s][3]);
  }
}

// the bf16 values at accumulator positions of n-block j: (row g, cols
// 8j+2t, +1) and (row g+8, same cols), as floats
__device__ __forceinline__ void lds_c(float (&v)[4], const bf16* base,
                                      int stride, int j, int g, int t) {
  const bf16* p = base + g * stride + 8 * j + 2 * t;
  const float2 lo = unpack_bf16(lds32(p));
  const float2 hi = unpack_bf16(lds32(p + 8 * stride));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// A fragments of K columns from float rows `ra`, `rb` of a (n, K) array,
// rounded to bf16; rows that are not valid read as zeros
template <int K>
__device__ __forceinline__ void ldg_rows_a(uint32_t (&a)[K / 16][4],
                                           const float* src, long ra,
                                           long rb, bool va, bool vb,
                                           int t) {
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const int c = 16 * s + 2 * t;
    const float2 z2 = make_float2(0.f, 0.f);
    const float2 a0 = va ? *reinterpret_cast<const float2*>(src + ra * K + c) : z2;
    const float2 a1 = vb ? *reinterpret_cast<const float2*>(src + rb * K + c) : z2;
    const float2 a2 = va ? *reinterpret_cast<const float2*>(src + ra * K + c + 8) : z2;
    const float2 a3 = vb ? *reinterpret_cast<const float2*>(src + rb * K + c + 8) : z2;
    a[s][0] = pack_bf16(a0.x, a0.y);
    a[s][1] = pack_bf16(a1.x, a1.y);
    a[s][2] = pack_bf16(a2.x, a2.y);
    a[s][3] = pack_bf16(a3.x, a3.y);
  }
}

// float rows `ra`, `rb` of a (n, 8 NB) array -> accumulator fragments;
// rows that are not valid read as zeros
template <int NB>
__device__ __forceinline__ void ldg_rows_c(float (&c)[NB][4],
                                           const float* src, long ra,
                                           long rb, bool va, bool vb,
                                           int t) {
  constexpr int N = 8 * NB;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 z2 = make_float2(0.f, 0.f);
    const float2 lo = va ? *reinterpret_cast<const float2*>(src + ra * N + col) : z2;
    const float2 hi = vb ? *reinterpret_cast<const float2*>(src + rb * N + col) : z2;
    c[j][0] = lo.x; c[j][1] = lo.y; c[j][2] = hi.x; c[j][3] = hi.y;
  }
}

// accumulator fragments of N columns -> float rows `ra`, `rb` of (n, N)
template <int NB>
__device__ __forceinline__ void stg_rows_c(const float (&c)[NB][4],
                                           float* dst, long ra, long rb,
                                           bool va, bool vb, int t) {
  constexpr int N = 8 * NB;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = 8 * j + 2 * t;
    if (va) *reinterpret_cast<float2*>(dst + ra * N + col) = make_float2(c[j][0], c[j][1]);
    if (vb) *reinterpret_cast<float2*>(dst + rb * N + col) = make_float2(c[j][2], c[j][3]);
  }
}

// a lane's accumulator fragments <-> its slots of a per-warp float array in
// shared memory, [NB * 4][32] in fragment order (lane-private, no sync)
template <int NB>
__device__ __forceinline__ void frag_ld(float (&c)[NB][4], const float* base,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) c[j][k] = base[(4 * j + k) * 32 + lane];
}

template <int NB>
__device__ __forceinline__ void frag_st(const float (&c)[NB][4], float* base,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) base[(4 * j + k) * 32 + lane] = c[j][k];
}

// the warp's column sums of n-block j (16 rows) -> cs[8j + 2t], +1 (lanes
// with g == 0); a fixed shuffle tree, so the order is fixed
__device__ __forceinline__ void warp_colsum(float* cs, int j, const float (&c)[4],
                                            int g, int t) {
  float s0 = c[0] + c[2], s1 = c[1] + c[3];
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
  if (g == 0) {
    cs[8 * j + 2 * t] = s0;
    cs[8 * j + 2 * t + 1] = s1;
  }
}

__device__ __forceinline__ void slab_put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// slab[off + col] (+)= sum over warps (in order) of colsum[w][col], col < n
template <int W, int H>
__device__ __forceinline__ void flush_colsum(const float* colsum, float* slab,
                                             int n, bool first) {
  for (int col = threadIdx.x; col < n; col += 32 * W) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += colsum[w * H + col];
    slab_put(slab + col, s, first);
  }
}

// a slab's layout (floats): gze (Z, DZ) | gtf (tf_rows, H) | gWq (DA, DZ) |
// gW1xc (DA+DZ, H) | gW1h (DC, H) | per block gWr1 (H, H), gbr1 (H),
// gWr2 (H, H), gbr2 (H) | gW3 (H, DA) | gb3 (DA)
template <int DA, int DZ, int DC, int H>
struct Slab {
  long gtf, gwq, gw1, gw1h, blk0, gw3, gb3, size;
  __host__ __device__ Slab(int z, int nb, int tf_rows) {
    gtf = (long)z * DZ;
    gwq = gtf + (long)tf_rows * H;
    gw1 = gwq + DA * DZ;
    gw1h = gw1 + (DA + DZ) * H;
    blk0 = gw1h + DC * H;
    gw3 = blk0 + (long)nb * (2 * H * H + 2 * H);
    gb3 = gw3 + H * DA;
    size = gb3 + DA;
  }
  __host__ __device__ long wr1(int b) const { return blk0 + (long)b * (2 * H * H + 2 * H); }
  __host__ __device__ long br1(int b) const { return wr1(b) + H * H; }
  __host__ __device__ long wr2(int b) const { return br1(b) + H; }
  __host__ __device__ long br2(int b) const { return wr2(b) + H * H; }
};

// the drift's bf16 weights, each matrix in both layouts, and the zones
struct StageWeights {
  const bf16* ze;     // (zp, DZ), zero rows past z
  const bf16* zeT;    // (DZ, zp)
  const bf16* wqT;    // (DZ, DA)      forward
  const bf16* wq;     // (DA, DZ)      backward
  const bf16* w1xcT;  // (H, DA + DZ)
  const bf16* w1xc;   // (DA + DZ, H)
  const bf16* w1hT;   // (H, DC)
  const bf16* w1h;    // (DC, H)
  const bf16* wrT;    // (2 nb, H, H): Wr1_0^T, Wr2_0^T, ...
  const bf16* wr;     // (2 nb, H, H): Wr1_0, Wr2_0, ...
  const bf16* br;     // (2 nb, H)
  const bf16* w3T;    // (DA, H)
  const bf16* w3;     // (H, DA)
  const bf16* b3;     // (DA)
  int z, zp, num_blocks;
};

// the 12 weight pointers in the order the C entry points take them
inline void set_weights(StageWeights& w, const void* const* p) {
  w.wqT = static_cast<const bf16*>(p[0]);
  w.wq = static_cast<const bf16*>(p[1]);
  w.w1xcT = static_cast<const bf16*>(p[2]);
  w.w1xc = static_cast<const bf16*>(p[3]);
  w.w1hT = static_cast<const bf16*>(p[4]);
  w.w1h = static_cast<const bf16*>(p[5]);
  w.wrT = static_cast<const bf16*>(p[6]);
  w.wr = static_cast<const bf16*>(p[7]);
  w.br = static_cast<const bf16*>(p[8]);
  w.w3T = static_cast<const bf16*>(p[9]);
  w.w3 = static_cast<const bf16*>(p[10]);
  w.b3 = static_cast<const bf16*>(p[11]);
}

}  // namespace ananke
