// One GAT-ODE drift evaluation ("stage") and its VJP as device functions
// for a tile of 16 W agent rows (W warps), shared by the adjoint RHS
// kernels (fused_rhs.cu: K8, one stage and its VJP per launch; K8a, the
// stage alone) and K5's bf16 branch (fused_dopri5.cu). The Hopper stage of
// stage_sm90.cuh keeps this math with its weights in a shared ring.
//
// The math is the reference's stage (_stage_math / _stage_vjp_math in
// ananke_abm_tpu/ops/pallas/fused_step.py) with every bf16 rounding point:
// bf16 operands, f32 sums, a max-free softmax clamped at 80 and normalised
// after the context product.
//
// - Per-row products run on mma.sync m16n8k16, activations in registers
//   from one product into the next, B fragments read from weights in device
//   memory (L2-resident). Each weight comes in two layouts: (out, in) rows
//   for the forward products, (in, out) rows for the backward ones.
// - What the VJP needs of the forward lives in shared memory per tile:
//   feats = [bf16(x), bf16(ctx)], bf16(q), and the chain of block inputs
//   bf16(z). A block's inner activation is recomputed from its input.
// - The attention is recomputed by 16-zone chunks in the VJP (one pass for
//   sum(attn * gattn), one for ds): no Z-wide row is stored, any zone count.
// - Weight gradients are agent contractions A^T B of per-row intermediates
//   in shared memory, loaded with ldmatrix.trans (the agent axis is mma's
//   k), added into the CTA's own slab in device memory with plain loads and
//   stores: no atomics, so the same operands give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// out (M x N row-major, leading dim N) (+)= A1^T B1 [+ A2^T B2] over the
// tile's ROWS agent rows; A (ROWS x M) and B (ROWS x N) row-major bf16 in
// shared memory. Output tiles of 16 x 8 are dealt to the warps in turn;
// rows of `out` at or past m_valid are not written.
template <int M, int N, int ROWS, int W, bool TWO>
__device__ __forceinline__ void nt_dot(const bf16* A1, int sa1, const bf16* B1,
                                       int sb1, const bf16* A2, int sa2,
                                       const bf16* B2, int sb2, float* out,
                                       int m_valid, bool first, int warp,
                                       int lane) {
  constexpr int NT = N / 8, TILES = (M / 16) * NT;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, r = lane & 7;
  for (int tile = warp; tile < TILES; tile += W) {
    const int m0 = (tile / NT) * 16, n0 = (tile % NT) * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < ROWS; k0 += 16) {
      uint32_t af[4], bfr[2];
      ldsm_x4_trans(af, A1 + (k0 + r + 8 * (q >> 1)) * sa1 + m0 + 8 * (q & 1));
      ldsm_x2_trans(bfr, B1 + (k0 + r + 8 * (q & 1)) * sb1 + n0);
      mma(acc, af, bfr[0], bfr[1]);
      if (TWO) {
        ldsm_x4_trans(af, A2 + (k0 + r + 8 * (q >> 1)) * sa2 + m0 + 8 * (q & 1));
        ldsm_x2_trans(bfr, B2 + (k0 + r + 8 * (q & 1)) * sb2 + n0);
        mma(acc, af, bfr[0], bfr[1]);
      }
    }
    const int ma = m0 + g, mb = m0 + g + 8, c = n0 + 2 * t;
    if (ma < m_valid) {
      slab_put(out + (size_t)ma * N + c, acc[0], first);
      slab_put(out + (size_t)ma * N + c + 1, acc[1], first);
    }
    if (mb < m_valid) {
      slab_put(out + (size_t)mb * N + c, acc[2], first);
      slab_put(out + (size_t)mb * N + c + 1, acc[3], first);
    }
  }
}

template <int M, int N, int ROWS, int W>
__device__ __forceinline__ void nt_dot1(const bf16* A, int sa, const bf16* B,
                                        int sb, float* out, bool first,
                                        int warp, int lane) {
  nt_dot<M, N, ROWS, W, false>(A, sa, B, sb, nullptr, 0, nullptr, 0, out, M,
                               first, warp, lane);
}

// out[i] = sum over CTAs, in order, of slab[c][i]
__global__ void reduce_slabs(const float* slab, float* out, long size,
                             int num_ctas) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int c = 0; c < num_ctas; ++c) s += slab[(size_t)c * size + i];
  out[i] = s;
}

inline int launch_reduce_slabs(const float* slab, float* out, long size,
                               int num_ctas, cudaStream_t s) {
  const int threads = 256;
  reduce_slabs<<<(unsigned)((size + threads - 1) / threads), threads, 0, s>>>(
      slab, out, size, num_ctas);
  return (int)cudaGetLastError();
}

// shared-memory row strides (bf16): the width plus 8, so that the 8 rows
// an ldmatrix or a fragment access touches fall in distinct banks
template <int DA, int DZ, int DC, int H>
struct Layout {
  static constexpr int SF = DA + DZ + 8;  // feats
  static constexpr int SQ = DZ + 8;       // q16, gctx16
  static constexpr int SH = H + 8;        // block chain, G, R
  static constexpr int SS = (DA > DC ? DA : DC) + 8;  // gk16, hb
  static constexpr int SD = 16 + 8;       // one zone chunk of ds16, attn16
  // bytes of dynamic shared memory of the stage and its VJP, for `rows`
  // rows and nb blocks
  static size_t bytes(int rows, int warps, int nb) {
    return (size_t)warps * H * sizeof(float) +
           (size_t)rows * sizeof(bf16) *
               (SF + 2 * SQ + (size_t)(nb + 3) * SH + SS + 2 * SD);
  }
  // bytes of the forward alone (feats, q, the chain)
  static size_t bytes_forward(int rows, int nb) {
    return (size_t)rows * sizeof(bf16) * (SF + SQ + (size_t)(nb + 1) * SH);
  }
};

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

// a tile's shared memory for the stage and its VJP
struct StageSmem {
  float* colsum;  // [W][H]
  bf16* feats;    // [ROWS][SF]
  bf16* q;        // [ROWS][SQ]
  bf16* gctx;     // [ROWS][SQ]
  bf16* chain;    // (nb + 1) x [ROWS][SH]
  bf16* g;        // [ROWS][SH]
  bf16* r;        // [ROWS][SH]
  bf16* small;    // [ROWS][SS]
  bf16* ds;       // [ROWS][SD]
  bf16* at;       // [ROWS][SD]
  unsigned char* end;  // the first byte past them (16-byte aligned)
};

template <int DA, int DZ, int DC, int H, int W>
__device__ __forceinline__ StageSmem stage_smem(unsigned char* raw, int nb) {
  using L = Layout<DA, DZ, DC, H>;
  constexpr int ROWS = 16 * W;
  StageSmem s;
  s.colsum = reinterpret_cast<float*>(raw);
  s.feats = reinterpret_cast<bf16*>(s.colsum + W * H);
  s.q = s.feats + ROWS * L::SF;
  s.gctx = s.q + ROWS * L::SQ;
  s.chain = s.gctx + ROWS * L::SQ;
  s.g = s.chain + (size_t)(nb + 1) * ROWS * L::SH;
  s.r = s.g + ROWS * L::SH;
  s.small = s.r + ROWS * L::SH;
  s.ds = s.small + ROWS * L::SS;
  s.at = s.ds + ROWS * L::SD;
  s.end = reinterpret_cast<unsigned char*>(s.at + ROWS * L::SD);
  return s;
}

// the forward's part alone (Layout::bytes_forward): feats, q, the chain
template <int DA, int DZ, int DC, int H, int W>
__device__ __forceinline__ StageSmem stage_smem_forward(unsigned char* raw) {
  using L = Layout<DA, DZ, DC, H>;
  constexpr int ROWS = 16 * W;
  StageSmem s = {};
  s.feats = reinterpret_cast<bf16*>(raw);
  s.q = s.feats + ROWS * L::SF;
  s.chain = s.q + ROWS * L::SQ;
  return s;
}

// k = stage(xb): the drift at the bf16 stage input `xa` of the warp's 16
// rows, with h's A fragments `ha` and the time row `tf` (H floats, Dense_0's
// time rows and bias). Leaves feats, q and the block chain of the warp's
// rows in shared memory and returns the softmax's row normalisers, for
// stage_backward. Warp-local: no block barrier.
template <int DA, int DZ, int DC, int H, int W>
__device__ __forceinline__ void stage_forward(
    const StageWeights& w, const StageSmem& sm,
    const uint32_t (&xa)[DA / 16][4], const uint32_t (&ha)[DC / 16][4],
    const float* tf, float (&k)[DA / 8][4], float& inv_a, float& inv_b,
    int wr0, int g, int t) {
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int DF = DA + DZ, KF = DF / 16;
  using L = Layout<DA, DZ, DC, H>;
  static_assert(DA % 16 == 0 && DZ % 16 == 0 && DC % 16 == 0 &&
                    H % 16 == 0,
                "widths must be multiples of 16");
  const int nb = w.num_blocks;
  const float scale = 1.0f / sqrtf((float)DZ);
  bf16* chain_out = sm.chain + (size_t)nb * ROWS * L::SH;

  sts_a<DA>(xa, sm.feats + wr0 * L::SF, L::SF, g, t);
  uint32_t qa[KZ][4];
  {
    float q[NZ][4];
    zero(q);
#pragma unroll
    for (int j = 0; j < NZ; ++j)
      mma_nblocks<DA, 1>(q, j, xa, w.wqT + (size_t)8 * j * DA, g, t);
    c_to_a<DZ>(q, qa);
    sts_a<DZ>(qa, sm.q + wr0 * L::SQ, L::SQ, g, t);
  }

  // ctx = softmax(q ze^T * scale) @ ze, max-free, by zone chunks
  {
    float ctx[NZ][4];
    zero(ctx);
    float rs_a = 0.f, rs_b = 0.f;
    for (int z0 = 0; z0 < w.zp; z0 += 16) {
      float sc[2][4];
      zero(sc);
      mma_nblocks<DZ, 2>(sc, 0, qa, w.ze + (size_t)z0 * DZ, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int za = z0 + 2 * t + (c & 1);
        sc[0][c] = za < w.z ? expf(fminf(sc[0][c] * scale, 80.f)) : 0.f;
        sc[1][c] = za + 8 < w.z ? expf(fminf(sc[1][c] * scale, 80.f)) : 0.f;
      }
      rs_a += (sc[0][0] + sc[0][1]) + (sc[1][0] + sc[1][1]);
      rs_b += (sc[0][2] + sc[0][3]) + (sc[1][2] + sc[1][3]);
      uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                        pack_bf16(sc[0][2], sc[0][3]),
                        pack_bf16(sc[1][0], sc[1][1]),
                        pack_bf16(sc[1][2], sc[1][3])};
      const bf16* zt = w.zeT + z0;
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        const bf16* rowp = zt + (size_t)(8 * j + g) * w.zp + 2 * t;
        mma(ctx[j], pa, ldg32(rowp), ldg32(rowp + 8));
      }
    }
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
    inv_a = 1.0f / rs_a;
    inv_b = 1.0f / rs_b;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      ctx[j][0] *= inv_a; ctx[j][1] *= inv_a;
      ctx[j][2] *= inv_b; ctx[j][3] *= inv_b;
    }
    uint32_t ca[KZ][4];
    c_to_a<DZ>(ctx, ca);
    sts_a<DZ>(ca, sm.feats + wr0 * L::SF + DA, L::SF, g, t);
  }

  // z = tanh(feats @ W1xc + bf16(h) @ W1h + tf)
  float zz[NH][4];
  {
    uint32_t fa[KF][4];
    __syncwarp();
    lds_a<DF>(fa, sm.feats + wr0 * L::SF, L::SF, g, t);
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      float hp[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      mma_nblocks<DF, 1>(acc, 0, fa, w.w1xcT + (size_t)8 * j * DF, g, t);
      mma_nblocks<DC, 1>(hp, 0, ha, w.w1hT + (size_t)8 * j * DC, g, t);
      const float2 tv = *reinterpret_cast<const float2*>(tf + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        zz[j][c] = tanhf((acc[0][c] + hp[0][c]) + ((c & 1) ? tv.y : tv.x));
    }
  }

  // residual blocks; the chain keeps each block's bf16 input
  for (int b = 0; b < nb; ++b) {
    const bf16* wr1T = w.wrT + (size_t)(2 * b) * H * H;
    const bf16* wr2T = wr1T + (size_t)H * H;
    const bf16* br1 = w.br + (size_t)(2 * b) * H;
    const bf16* br2 = br1 + H;
    uint32_t za[KH][4];
    c_to_a<H>(zz, za);
    sts_a<H>(za, sm.chain + (size_t)b * ROWS * L::SH + wr0 * L::SH, L::SH,
             g, t);
    uint32_t rta[KH][4];
#pragma unroll
    for (int s = 0; s < KH; ++s) {
      float eo[2][4];
      zero(eo);
      mma_nblocks<H, 2>(eo, 0, za, wr1T + (size_t)16 * s * H, g, t);
      const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
      const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
      rta[s][0] = pack_bf16(tanhf(eo[0][0] + be.x), tanhf(eo[0][1] + be.y));
      rta[s][1] = pack_bf16(tanhf(eo[0][2] + be.x), tanhf(eo[0][3] + be.y));
      rta[s][2] = pack_bf16(tanhf(eo[1][0] + bo.x), tanhf(eo[1][1] + bo.y));
      rta[s][3] = pack_bf16(tanhf(eo[1][2] + bo.x), tanhf(eo[1][3] + bo.y));
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      mma_nblocks<H, 1>(acc, 0, rta, wr2T + (size_t)8 * j * H, g, t);
      const float2 bv = unpack_bf16(ldg32(br2 + 8 * j + 2 * t));
      zz[j][0] = tanhf(zz[j][0] + (acc[0][0] + bv.x));
      zz[j][1] = tanhf(zz[j][1] + (acc[0][1] + bv.y));
      zz[j][2] = tanhf(zz[j][2] + (acc[0][2] + bv.x));
      zz[j][3] = tanhf(zz[j][3] + (acc[0][3] + bv.y));
    }
  }
  {
    uint32_t za[KH][4];
    c_to_a<H>(zz, za);
    sts_a<H>(za, chain_out + wr0 * L::SH, L::SH, g, t);
    zero(k);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      mma_nblocks<H, 1>(k, j, za, w.w3T + (size_t)8 * j * H, g, t);
      const float2 bv = unpack_bf16(ldg32(w.b3 + 8 * j + 2 * t));
      k[j][0] += bv.x; k[j][1] += bv.y; k[j][2] += bv.x; k[j][3] += bv.y;
    }
  }
}

// The VJP of the last stage_forward at cotangent `ga` (f32, accumulator
// fragments): returns gx (f32, accumulator fragments) and adds the summed
// gradients into `slab` (the time row's at slab + gtf); gh = bf16(gpre1) @
// W1h^T is stored to rows ra, rb of `gh` and gW1h added into the slab.
// Every thread of the block calls it: it holds block barriers.
template <int DA, int DZ, int DC, int H, int W>
__device__ __forceinline__ void stage_backward(
    const StageWeights& w, const StageSmem& sm, const float (&ga)[DA / 8][4],
    const uint32_t (&ha)[DC / 16][4], float inv_a, float inv_b, float* slab,
    const Slab<DA, DZ, DC, H>& sl, long gtf, bool first,
    float (&gxb)[DA / 8][4], float* gh, long ra, long rb, bool va, bool vb,
    int warp, int lane) {
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8, KX = DA / 16;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int NC = DC / 8;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int DF = DA + DZ;
  using L = Layout<DA, DZ, DC, H>;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = warp * 16;
  const int nb = w.num_blocks;
  const float scale = 1.0f / sqrtf((float)DZ);
  float* cs = sm.colsum + warp * H;
  const bf16* chain_out = sm.chain + (size_t)nb * ROWS * L::SH;

  // k = z_out @ W3 + b3: gW3 = z_out^T bf16(gk), gb3 = sum gk,
  // gz = bf16(gk) @ W3^T
  float gz[NH][4];
  {
#pragma unroll
    for (int j = 0; j < NX; ++j) warp_colsum(cs, j, ga[j], g, t);
    uint32_t gka[KX][4];
    c_to_a<DA>(ga, gka);
    sts_a<DA>(gka, sm.small + wr0 * L::SS, L::SS, g, t);
    zero(gz);
#pragma unroll
    for (int j = 0; j < NH; ++j)
      mma_nblocks<DA, 1>(gz, j, gka, w.w3 + (size_t)8 * j * DA, g, t);
  }
  __syncthreads();
  nt_dot1<H, DA, ROWS, W>(chain_out, L::SH, sm.small, L::SS, slab + sl.gw3,
                          first, warp, lane);
  flush_colsum<W, H>(sm.colsum, slab + sl.gb3, DA, first);
  __syncthreads();

  // residual blocks, reversed: z_out = tanh(z_in + bf16(rt) @ Wr2 + br2),
  // rt = tanh(z_in @ Wr1 + br1)
  for (int b = nb - 1; b >= 0; --b) {
    const bf16* wr1T = w.wrT + (size_t)(2 * b) * H * H;
    const bf16* wr1 = w.wr + (size_t)(2 * b) * H * H;
    const bf16* wr2 = wr1 + (size_t)H * H;
    const bf16* br1 = w.br + (size_t)(2 * b) * H;
    const bf16* z_in = sm.chain + (size_t)b * ROWS * L::SH;
    const bf16* z_out = z_in + (size_t)ROWS * L::SH;
    // gpre = gz * (1 - zo^2), kept in gz
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float zo[4];
      lds_c(zo, z_out + wr0 * L::SH, L::SH, j, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gz[j][c] = __fmul_rn(gz[j][c], __fsub_rn(1.f, __fmul_rn(zo[c], zo[c])));
      warp_colsum(cs, j, gz[j], g, t);
    }
    uint32_t gpa[KH][4];
    c_to_a<H>(gz, gpa);
    sts_a<H>(gpa, sm.g + wr0 * L::SH, L::SH, g, t);
    // recompute bf16(rt) into R
    {
      uint32_t za[KH][4];
      lds_a<H>(za, z_in + wr0 * L::SH, L::SH, g, t);
#pragma unroll
      for (int s = 0; s < KH; ++s) {
        float eo[2][4];
        zero(eo);
        mma_nblocks<H, 2>(eo, 0, za, wr1T + (size_t)16 * s * H, g, t);
        const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
        const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
        bf16* rp = sm.r + (wr0 + g) * L::SH + 16 * s + 2 * t;
        sts32(rp, pack_bf16(tanhf(eo[0][0] + be.x), tanhf(eo[0][1] + be.y)));
        sts32(rp + 8 * L::SH, pack_bf16(tanhf(eo[0][2] + be.x), tanhf(eo[0][3] + be.y)));
        sts32(rp + 8, pack_bf16(tanhf(eo[1][0] + bo.x), tanhf(eo[1][1] + bo.y)));
        sts32(rp + 8 * L::SH + 8, pack_bf16(tanhf(eo[1][2] + bo.x), tanhf(eo[1][3] + bo.y)));
      }
    }
    __syncthreads();
    // gWr2 = bf16(rt)^T bf16(gpre), gbr2 = sum gpre
    nt_dot1<H, H, ROWS, W>(sm.r, L::SH, sm.g, L::SH, slab + sl.wr2(b), first,
                           warp, lane);
    flush_colsum<W, H>(sm.colsum, slab + sl.br2(b), H, first);
    __syncthreads();
    // gpre2 = (bf16(gpre) @ Wr2^T) * (1 - rt^2); bf16(gpre2) replaces rt
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      mma_nblocks<H, 1>(acc, 0, gpa, wr2 + (size_t)8 * j * H, g, t);
      float rt[4];
      lds_c(rt, sm.r + wr0 * L::SH, L::SH, j, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[0][c] = __fmul_rn(acc[0][c], __fsub_rn(1.f, __fmul_rn(rt[c], rt[c])));
      warp_colsum(cs, j, acc[0], g, t);
      bf16* rp = sm.r + (wr0 + g) * L::SH + 8 * j + 2 * t;
      sts32(rp, pack_bf16(acc[0][0], acc[0][1]));
      sts32(rp + 8 * L::SH, pack_bf16(acc[0][2], acc[0][3]));
    }
    __syncthreads();
    // gWr1 = z_in^T bf16(gpre2), gbr1 = sum gpre2
    nt_dot1<H, H, ROWS, W>(z_in, L::SH, sm.r, L::SH, slab + sl.wr1(b), first,
                           warp, lane);
    flush_colsum<W, H>(sm.colsum, slab + sl.br1(b), H, first);
    // gz = gpre + bf16(gpre2) @ Wr1^T
    {
      uint32_t g2a[KH][4];
      lds_a<H>(g2a, sm.r + wr0 * L::SH, L::SH, g, t);
#pragma unroll
      for (int j = 0; j < NH; ++j)
        mma_nblocks<H, 1>(gz, j, g2a, wr1 + (size_t)8 * j * H, g, t);
    }
    __syncthreads();
  }

  // z1 = tanh(feats @ W1xc + hpre + tf), the chain's first entry:
  // gpre1 = gz * (1 - z1^2); gtf = sum gpre1; gfeats = bf16(gpre1) @
  // W1xc^T = [gxb, gctx]; hpre's gradient per row is gpre1
  uint32_t gca[KZ][4];
  {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float z1[4];
      lds_c(z1, sm.chain + wr0 * L::SH, L::SH, j, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gz[j][c] = __fmul_rn(gz[j][c], __fsub_rn(1.f, __fmul_rn(z1[c], z1[c])));
      warp_colsum(cs, j, gz[j], g, t);
    }
    uint32_t g1a[KH][4];
    c_to_a<H>(gz, g1a);
    sts_a<H>(g1a, sm.g + wr0 * L::SH, L::SH, g, t);
    {
      sts_a<DC>(ha, sm.small + wr0 * L::SS, L::SS, g, t);
      float ghh[NC][4];
      zero(ghh);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        mma_nblocks<H, 1>(ghh, j, g1a, w.w1h + (size_t)8 * j * H, g, t);
      stg_rows_c<NC>(ghh, gh, ra, rb, va, vb, t);
    }
    zero(gxb);
#pragma unroll
    for (int j = 0; j < NX; ++j)
      mma_nblocks<H, 1>(gxb, j, g1a, w.w1xc + (size_t)8 * j * H, g, t);
    float gctx[NZ][4];
    zero(gctx);
#pragma unroll
    for (int j = 0; j < NZ; ++j)
      mma_nblocks<H, 1>(gctx, j, g1a, w.w1xc + (size_t)(DA + 8 * j) * H, g,
                        t);
    c_to_a<DZ>(gctx, gca);
    sts_a<DZ>(gca, sm.gctx + wr0 * L::SQ, L::SQ, g, t);
  }
  __syncthreads();
  // gW1xc = feats^T bf16(gpre1), gW1h = bf16(h)^T bf16(gpre1)
  nt_dot1<DF, H, ROWS, W>(sm.feats, L::SF, sm.g, L::SH, slab + sl.gw1, first,
                          warp, lane);
  nt_dot1<DC, H, ROWS, W>(sm.small, L::SS, sm.g, L::SH, slab + sl.gw1h,
                          first, warp, lane);
  flush_colsum<W, H>(sm.colsum, slab + gtf, H, first);

  // attention backward, recomputing attn16 by zone chunks:
  // gattn = bf16(gctx) @ ze^T; ds = attn (gattn - sum(attn gattn)) scale;
  // gq = bf16(ds) @ ze; gze = bf16(attn)^T bf16(gctx) + bf16(ds)^T q16
  uint32_t qa[KZ][4];
  lds_a<DZ>(qa, sm.q + wr0 * L::SQ, L::SQ, g, t);
  float S_a = 0.f, S_b = 0.f;
  for (int z0 = 0; z0 < w.zp; z0 += 16) {
    float sc[2][4], ga_[2][4];
    zero(sc);
    zero(ga_);
    mma_nblocks<DZ, 2>(sc, 0, qa, w.ze + (size_t)z0 * DZ, g, t);
    mma_nblocks<DZ, 2>(ga_, 0, gca, w.ze + (size_t)z0 * DZ, g, t);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int zi = z0 + 8 * i + 2 * t + (c & 1);
        const float pr = zi < w.z ? expf(fminf(sc[i][c] * scale, 80.f)) : 0.f;
        const float at = __bfloat162float(
            __float2bfloat16_rn(pr * ((c & 2) ? inv_b : inv_a)));
        if (c & 2) S_b += at * ga_[i][c]; else S_a += at * ga_[i][c];
      }
  }
  S_a += __shfl_xor_sync(0xffffffffu, S_a, 1);
  S_a += __shfl_xor_sync(0xffffffffu, S_a, 2);
  S_b += __shfl_xor_sync(0xffffffffu, S_b, 1);
  S_b += __shfl_xor_sync(0xffffffffu, S_b, 2);

  float gq[NZ][4];
  zero(gq);
  for (int z0 = 0; z0 < w.zp; z0 += 16) {
    float sc[2][4], ga_[2][4];
    zero(sc);
    zero(ga_);
    mma_nblocks<DZ, 2>(sc, 0, qa, w.ze + (size_t)z0 * DZ, g, t);
    mma_nblocks<DZ, 2>(ga_, 0, gca, w.ze + (size_t)z0 * DZ, g, t);
    float at[2][4], ds[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int zi = z0 + 8 * i + 2 * t + (c & 1);
        const float pr = zi < w.z ? expf(fminf(sc[i][c] * scale, 80.f)) : 0.f;
        at[i][c] = __bfloat162float(
            __float2bfloat16_rn(pr * ((c & 2) ? inv_b : inv_a)));
        ds[i][c] = __fmul_rn(__fmul_rn(at[i][c],
                                       __fsub_rn(ga_[i][c], (c & 2) ? S_b : S_a)),
                             scale);
      }
    uint32_t da_[1][4], aa_[1][4];
    da_[0][0] = pack_bf16(ds[0][0], ds[0][1]);
    da_[0][1] = pack_bf16(ds[0][2], ds[0][3]);
    da_[0][2] = pack_bf16(ds[1][0], ds[1][1]);
    da_[0][3] = pack_bf16(ds[1][2], ds[1][3]);
    aa_[0][0] = pack_bf16(at[0][0], at[0][1]);
    aa_[0][1] = pack_bf16(at[0][2], at[0][3]);
    aa_[0][2] = pack_bf16(at[1][0], at[1][1]);
    aa_[0][3] = pack_bf16(at[1][2], at[1][3]);
    sts_a<16>(da_, sm.ds + wr0 * L::SD, L::SD, g, t);
    sts_a<16>(aa_, sm.at + wr0 * L::SD, L::SD, g, t);
    const bf16* zt = w.zeT + z0;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      const bf16* rowp = zt + (size_t)(8 * j + g) * w.zp + 2 * t;
      mma(gq[j], da_[0], ldg32(rowp), ldg32(rowp + 8));
    }
    __syncthreads();
    nt_dot<16, DZ, ROWS, W, true>(sm.at, L::SD, sm.gctx, L::SQ, sm.ds, L::SD,
                                  sm.q, L::SQ, slab + (size_t)z0 * DZ,
                                  w.z - z0, first, warp, lane);
    __syncthreads();
  }

  // q = xb @ Wq: gWq = xb^T bf16(gq); gx = gxb + bf16(gq) @ Wq^T
  {
    uint32_t gqa[KZ][4];
    c_to_a<DZ>(gq, gqa);
    sts_a<DZ>(gqa, sm.g + wr0 * L::SH, L::SH, g, t);
#pragma unroll
    for (int j = 0; j < NX; ++j)
      mma_nblocks<DZ, 1>(gxb, j, gqa, w.wq + (size_t)8 * j * DZ, g, t);
  }
  __syncthreads();
  nt_dot1<DA, DZ, ROWS, W>(sm.feats, L::SF, sm.g, L::SH, slab + sl.gwq, first,
                           warp, lane);
  __syncthreads();
}

}  // namespace ananke
