// One DOPRI5 5(4) step of the GAT-ODE drift (K5) and the VJP of one
// accepted step (K7), for the discrete adjoint, on Hopper (sm_90a), in
// float32 throughout.
//
// Replaces the Pallas TPU kernels
//   K5 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_step_fused
//   K7 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_step_vjp_fused
// (stage math and stage VJP: _stage_math and _stage_vjp_math in
// ops/pallas/fused_step.py with the identity cast). Plain PyTorch versions:
// ananke_abm_tpu_torch/ops/cuda/fused_dopri5.py::dopri5_step_reference and
// ::dopri5_step_vjp_reference.
//
// What they compute, per agent row:
// - K5: the six stage evaluations k2..k7 of the drift from (x, f0 = k1),
//   y1 = x + h sum b5_j k_j, f1 = k7, the embedded error h sum (b5 - b4)_j
//   k_j (or, with err_stats, the sum over every real element of (err /
//   (atol + rtol max(|x|, |y1|)))^2) and r5 = h sum d_j k_j;
// - K7: the six stages again, then, stage by stage in reverse, the stage
//   recomputed and its VJP at gk_i, the cotangents chained through the
//   tableau: gk_j += h a_ij gx_i, gy0 += gx_i. Per agent gy0, gf0 (= gk_1)
//   and gh; summed over agents the gradients of the zones, the seven time
//   rows, Wq, W1xc, W1h, every residual block and the output layer.
//
// Why float32 FFMA: bf16 rounding of the stage activations is noise that
// does not cancel in the embedded 5(4) error and floors the step
// controller; TF32 keeps three decimal digits, the same class. So every
// product here is a float32 fused multiply-add on the CUDA cores.
//
// What bounds them on the card: operations. One stage is ~92 kMAC per agent
// at the shipping widths and Z = 64, its VJP about twice that; the bytes
// per agent are a few hundred. The design:
//
// - A CTA of 8 warps owns a tile of R agent rows (32; K7 16 for deep
//   drifts) and walks tiles tile = blockIdx.x, + gridDim.x, ...
// - Activations of the tile live in shared memory, float32 row-major.
//   Every product out = A W runs as register tiles: warp w computes rows
//   w, w + 8, ..., lane l a run of adjacent columns; A is read from shared
//   memory four columns at a time (a broadcast within the warp), W is
//   staged through two shared-memory buffers of 16 rows by cp.async, the
//   next chunk's copy in flight while this one is multiplied (the weights,
//   ~0.35 MB in float32, stay hot in L2).
// - The attention runs by chunks of 32 zones: no Z-wide row is stored, any
//   zone count; the max-free softmax (exp clamped at 80) sums its rows
//   chunk by chunk, the context is normalised after the product.
// - K7 cannot keep six stages of intermediates (~24 KB per agent): it keeps
//   the stage outputs k_j (and the cotangents gk_j, in a per-CTA scratch in
//   device memory, each element only ever touched by the thread that owns
//   it) and recomputes stage i's intermediates just before its VJP: 12
//   stage forwards and 6 stage VJPs per step.
// - Weight gradients are contractions over the tile's rows, added into the
//   CTA's own slab in device memory (plain loads and stores); a second
//   kernel sums the slabs in CTA order. K5's error sum is per CTA the same
//   way. No atomics: the same operands give the same bits, and so the same
//   step sequence.
//
// Rows past N read zeros: their cotangents are zero, so every gradient term
// they could feed is zero, and K5's error sum masks them.
//
// Compiled for (agent, zone, context, hidden) = (32, 64, 32, 128), 1-8
// residual blocks and any zone count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DA = 32, DZ = 64, DC = 32, H = 128, DF = DA + DZ;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;   // rows of W in each of the two staging buffers
constexpr int kZC = 32;   // zones per attention chunk
constexpr int kMaxBlocks = 8;
constexpr int kWbuf = 2 * kKC * H;  // floats of the two staging buffers
constexpr unsigned kFull = 0xffffffffu;

// the Dormand-Prince tableau, each weight rounded to float32 where used
__constant__ float cA[7][6] = {
    {0, 0, 0, 0, 0, 0},
    {(float)(1.0 / 5), 0, 0, 0, 0, 0},
    {(float)(3.0 / 40), (float)(9.0 / 40), 0, 0, 0, 0},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9), 0, 0, 0},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187),
     (float)(64448.0 / 6561), (float)(-212.0 / 729), 0, 0},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247),
     (float)(49.0 / 176), (float)(-5103.0 / 18656), 0},
    {(float)(35.0 / 384), 0, (float)(500.0 / 1113), (float)(125.0 / 192),
     (float)(-2187.0 / 6784), (float)(11.0 / 84)},
};
__constant__ float cB5[7] = {(float)(35.0 / 384), 0, (float)(500.0 / 1113),
                             (float)(125.0 / 192), (float)(-2187.0 / 6784),
                             (float)(11.0 / 84), 0};
__constant__ float cBE[7] = {
    (float)(35.0 / 384 - 5179.0 / 57600), 0,
    (float)(500.0 / 1113 - 7571.0 / 16695),
    (float)(125.0 / 192 - 393.0 / 640),
    (float)(-2187.0 / 6784 + 92097.0 / 339200),
    (float)(11.0 / 84 - 187.0 / 2100), (float)(-1.0 / 40)};
__constant__ float cD[7] = {
    (float)(-12715105075.0 / 11282082432.0), 0,
    (float)(87487479700.0 / 32700410799.0),
    (float)(-10690763975.0 / 1880347072.0),
    (float)(701980252875.0 / 199316789632.0),
    (float)(-1453857185.0 / 822651844.0),
    (float)(69997945.0 / 29380423.0)};

// the drift's float32 weights, each matrix (in, out) and its transpose
struct Weights {
  const float* wq;     // (DA, DZ)
  const float* wqT;    // (DZ, DA)
  const float* w1xc;   // (DF, H)
  const float* w1xcT;  // (H, DF)
  const float* w1h;    // (DC, H)
  const float* w1hT;   // (H, DC)
  const float* wr;     // (2 nb, H, H): Wr1_0, Wr2_0, ...
  const float* wrT;    // (2 nb, H, H): their transposes
  const float* br;     // (2 nb, H)
  const float* w3;     // (H, DA)
  const float* w3T;    // (DA, H)
  const float* b3;     // (DA)
  const float* ze;     // (zp, DZ), zero rows past z
  const float* zeT;    // (DZ, zp)
  const float* tf;     // (7, H) time rows
  int z, zp, nb;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// the column of a thread's j-th output in an N-wide product: lane l owns
// the N / 32 adjacent columns from l N / 32 (for N = 32, column l)
template <int N>
__device__ __forceinline__ int ocol(int lane, int j) {
  return (N / 32) * lane + j;
}

// 16 bytes global -> shared, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// C consecutive floats of shared memory, in the widest load they allow
template <int C>
__device__ __forceinline__ void lds_vec(float (&v)[C], const float* p) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = p[c];
  }
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// out = A (R x K, row stride lda, shared memory) times W (K x N, row stride
// ldw, device memory); ep(acc) receives the thread's register tile:
// acc[i][j] is row w + 8 i, column ocol<N>(lane, j). A is read four
// columns at a time (float4, a broadcast within the warp), W's rows as the
// lane's adjacent columns. Starts with a barrier (A may come from other
// threads), ends with one before ep (so ep may overwrite A or the staging
// buffer). lda, A and (for N >= 64) the columns must be 16-byte aligned.
template <int R, int K, int N, class Ep>
__device__ __forceinline__ void mm(const float* A, int lda,
                                   const float* __restrict__ W, int ldw,
                                   float* wbuf, Ep ep) {
  constexpr int RPT = R / kWarps, CPT = N / 32;
  static_assert(K % kKC == 0 && N % 32 == 0 && R % kWarps == 0, "shape");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  // chunk c of W's rows into staging buffer c % 2, by cp.async: the copy
  // of chunk c + 1 runs while chunk c is multiplied
  auto stage = [&](int c) {
    float* dst = wbuf + (c & 1) * kKC * N;
    for (int e = threadIdx.x * 4; e < kKC * N; e += kThreads * 4) {
      const int kk = e / N, n = e % N;
      cp_async16(dst + e, W + (size_t)(c * kKC + kk) * ldw + n);
    }
    cp_commit();
  };
  constexpr int NC = K / kKC;
  stage(0);
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC) {
      stage(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* wb = wbuf + (c & 1) * kKC * N;
    const int k0 = c * kKC;
#pragma unroll 2
    for (int kk = 0; kk < kKC; kk += 4) {
      float4 a[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            A + (w + kWarps * i) * lda + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[CPT];
        lds_vec<CPT>(b, wb + (kk + q) * N + CPT * lane);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(comp(a[i], q), b[j], acc[i][j]);
      }
    }
    // every warp is done with this buffer (and with A, for ep) before
    // chunk c + 2 refills it
    __syncthreads();
  }
  ep(acc);
}

// out[m][n] += sum_r A[r][m] B[r][n] (+ A2[r][m] B2[r][n]) for m < m_valid:
// the agent contraction of a weight gradient, into the CTA's slab (row
// stride N). Warp w owns rows 4 w .. 4 w + 3 (+ 32, ...), lane l the
// columns ocol<N>(l, j). Each output has one owner thread: no atomics.
template <int R, int M, int N, bool TWO>
__device__ __forceinline__ void ntdot(const float* A, int lda, const float* B,
                                      int ldb, const float* A2, int lda2,
                                      const float* B2, int ldb2, float* out,
                                      int m_valid) {
  constexpr int CPT = N / 32;
  static_assert(M % 32 == 0 && N % 32 == 0, "shape");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  for (int m0 = 4 * w; m0 < M; m0 += 4 * kWarps) {
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float a[4], b[CPT];
      lds_vec<4>(a, A + r * lda + m0);
      lds_vec<CPT>(b, B + r * ldb + CPT * lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (TWO) {
        lds_vec<4>(a, A2 + r * lda2 + m0);
        lds_vec<CPT>(b, B2 + r * ldb2 + CPT * lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + i >= m_valid) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[(size_t)(m0 + i) * N + CPT * lane + j] += acc[i][j];
    }
  }
}

// out[n] += sum_r B[r][n]: a bias (or time-row) gradient
template <int R, int N>
__device__ __forceinline__ void colsum(const float* B, int ldb, float* out) {
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += B[r * ldb + n];
    out[n] += s;
  }
}

// the shared-memory buffers of one stage evaluation
struct StageBufs {
  float* wbuf;   // [kKC * H] staged weights
  float* feats;  // [R][DF]: the stage input (cols 0..DA), ctx (DA..DF)
  float* q;      // [R][DZ + kZC]: q, then one chunk of p
  float* rt;     // [R][H]: a block's inner activation
  float* chain;  // level b at chain + b * chain_step: [R][H]
  int chain_step;
  float* hpre;   // [R][H]
  float* inv;    // [R]: 1 / the softmax's row sum
};

// k = stage_i(feats[:, :DA]) into kout ([R][DA]; its thread mapping is the
// per-element one: row w + 8 m, column lane).
template <int R>
__device__ void stage_forward(const Weights& w, const StageBufs& s, int stage,
                              float* kout) {
  constexpr int RPT = R / kWarps;
  constexpr int LQ = DZ + kZC;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // q = x Wq
  mm<R, DA, DZ>(s.feats, DF, w.wq, DZ, s.wbuf, [&](float (&acc)[RPT][2]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s.q[(wp + kWarps * i) * LQ + ocol<DZ>(lane, j)] = acc[i][j];
  });
  float* p = s.q + DZ;
  float rs[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) rs[i] = 0.f;
  for (int z0 = 0; z0 < w.zp; z0 += kZC) {
    const bool last = z0 + kZC >= w.zp;
    // p = exp(min(q ze^T scale, 80)) over the chunk's zones
    mm<R, DZ, kZC>(s.q, LQ, w.zeT + z0, w.zp, s.wbuf,
                   [&](float (&acc)[RPT][1]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float v = z0 + lane < w.z
                            ? expf(fminf(acc[i][0] * w.scale, 80.f)) : 0.f;
        p[(wp + kWarps * i) * LQ + lane] = v;
        rs[i] += warp_sum(v);
      }
    });
    // ctx += p ze; normalised after the last chunk
    mm<R, kZC, DZ>(p, LQ, w.ze + (size_t)z0 * DZ, DZ, s.wbuf,
                   [&](float (&acc)[RPT][2]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = wp + kWarps * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* c = s.feats + r * DF + DA + ocol<DZ>(lane, j);
          float v = (z0 == 0 ? 0.f : *c) + acc[i][j];
          if (last) v *= 1.f / rs[i];
          *c = v;
        }
        if (last && lane == 0) s.inv[r] = 1.f / rs[i];
      }
    });
  }
  // z = tanh(feats W1xc + hpre + tf_i)
  const float* tfi = w.tf + stage * H;
  float* z0p = s.chain;
  mm<R, DF, H>(s.feats, DF, w.w1xc, H, s.wbuf, [&](float (&acc)[RPT][4]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ocol<H>(lane, j), o = (wp + kWarps * i) * H + c;
        z0p[o] = tanhf(acc[i][j] + s.hpre[o] + tfi[c]);
      }
  });
  for (int b = 0; b < w.nb; ++b) {
    const float* zin = s.chain + b * s.chain_step;
    float* zout = s.chain + (b + 1) * s.chain_step;
    const float* br1 = w.br + (2 * b) * H;
    const float* br2 = w.br + (2 * b + 1) * H;
    mm<R, H, H>(zin, H, w.wr + (size_t)(2 * b) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ocol<H>(lane, j);
          s.rt[(wp + kWarps * i) * H + c] = tanhf(acc[i][j] + br1[c]);
        }
    });
    mm<R, H, H>(s.rt, H, w.wr + (size_t)(2 * b + 1) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ocol<H>(lane, j), o = (wp + kWarps * i) * H + c;
          zout[o] = tanhf(zin[o] + acc[i][j] + br2[c]);
        }
    });
  }
  // k = z W3 + b3
  mm<R, H, DA>(s.chain + w.nb * s.chain_step, H, w.w3, DA, s.wbuf,
               [&](float (&acc)[RPT][1]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      kout[(wp + kWarps * i) * DA + lane] = acc[i][0] + w.b3[lane];
  });
}

// offsets (floats) of the summed gradients in a slab: gze (z, DZ) | gtf
// (7, H) | gWq (DA, DZ) | gW1xc (DF, H) | gW1h (DC, H) | per block gWr1
// (H, H), gbr1 (H), gWr2 (H, H), gbr2 (H) | gW3 (H, DA) | gb3 (DA)
struct SlabLayout {
  long gtf, gwq, gw1, gw1h, blk0, gw3, gb3, size;
  __host__ __device__ SlabLayout(int z, int nb) {
    gtf = (long)z * DZ;
    gwq = gtf + 7 * H;
    gw1 = gwq + DA * DZ;
    gw1h = gw1 + DF * H;
    blk0 = gw1h + DC * H;
    gw3 = blk0 + (long)nb * (2 * H * H + 2 * H);
    gb3 = gw3 + H * DA;
    size = gb3 + DA;
  }
  __host__ __device__ long wr1(int b) const {
    return blk0 + (long)b * (2 * H * H + 2 * H);
  }
  __host__ __device__ long br1(int b) const { return wr1(b) + H * H; }
  __host__ __device__ long wr2(int b) const { return br1(b) + H; }
  __host__ __device__ long br2(int b) const { return wr2(b) + H * H; }
};

// the VJP of stage_i at gk ([R][DA] in shared memory), its forward just
// recomputed into s (every chain level kept): gradients into the slab, ghp
// += the Dense_0 pre-activation's cotangent, and gx ([R][DA], the
// per-element mapping) the cotangent of the stage input.
template <int R>
__device__ void stage_backward(const Weights& w, const StageBufs& s,
                               const SlabLayout& L, float* slab, int stage,
                               const float* gk, float* gp, float* ta,
                               float* tb, float* ghp, float* gx) {
  constexpr int RPT = R / kWarps;
  constexpr int LQ = DZ + kZC;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = w.nb;
  const float* zlast = s.chain + nb * s.chain_step;
  // k = z W3 + b3
  ntdot<R, H, DA, false>(zlast, H, gk, DA, nullptr, 0, nullptr, 0,
                         slab + L.gw3, H);
  colsum<R, DA>(gk, DA, slab + L.gb3);
  // gp = (gk W3^T) (1 - z^2): the last block's pre-activation cotangent
  mm<R, DA, H>(gk, DA, w.w3T, H, s.wbuf, [&](float (&acc)[RPT][4]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (wp + kWarps * i) * H + ocol<H>(lane, j);
        gp[o] = acc[i][j] * (1.f - zlast[o] * zlast[o]);
      }
  });
  for (int b = nb - 1; b >= 0; --b) {
    const float* zin = s.chain + b * s.chain_step;
    const float* br1 = w.br + (2 * b) * H;
    // rt = tanh(z_in Wr1 + br1), recomputed into ta
    mm<R, H, H>(zin, H, w.wr + (size_t)(2 * b) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ocol<H>(lane, j);
          ta[(wp + kWarps * i) * H + c] = tanhf(acc[i][j] + br1[c]);
        }
    });
    ntdot<R, H, H, false>(ta, H, gp, H, nullptr, 0, nullptr, 0,
                          slab + L.wr2(b), H);
    colsum<R, H>(gp, H, slab + L.br2(b));
    // tb = (gp Wr2^T) (1 - rt^2)
    mm<R, H, H>(gp, H, w.wrT + (size_t)(2 * b + 1) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (wp + kWarps * i) * H + ocol<H>(lane, j);
          tb[o] = acc[i][j] * (1.f - ta[o] * ta[o]);
        }
    });
    ntdot<R, H, H, false>(zin, H, tb, H, nullptr, 0, nullptr, 0,
                          slab + L.wr1(b), H);
    colsum<R, H>(tb, H, slab + L.br1(b));
    // gp = (gp + tb Wr1^T) (1 - z_in^2): the next pre-activation down
    mm<R, H, H>(tb, H, w.wrT + (size_t)(2 * b) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (wp + kWarps * i) * H + ocol<H>(lane, j);
          gp[o] = (gp[o] + acc[i][j]) * (1.f - zin[o] * zin[o]);
        }
    });
  }
  // z1 = tanh(feats W1xc + hpre + tf_i): gp is its pre-activation's
  // cotangent
  ntdot<R, DF, H, false>(s.feats, DF, gp, H, nullptr, 0, nullptr, 0,
                         slab + L.gw1, H);
  colsum<R, H>(gp, H, slab + L.gtf + stage * H);
  // ghp += gp; gf = gp W1xc^T into ta (cols 0..DF): gxb | gctx
  mm<R, H, DF>(gp, H, w.w1xcT, DF, s.wbuf, [&](float (&acc)[RPT][3]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = wp + kWarps * i;
#pragma unroll
      for (int j = 0; j < 3; ++j) ta[r * H + ocol<DF>(lane, j)] = acc[i][j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = r * H + ocol<H>(lane, j);
        ghp[o] += gp[o];
      }
    }
  });
  const float* gctx = ta + DA;
  float* at = tb;          // [R][H] cols 0..kZC: attn of the chunk
  float* ds = tb + kZC;    // cols kZC..2 kZC: ds of the chunk
  float* gq = gp;          // [R][H] cols 0..DZ
  float rd[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) rd[i] = 0.f;
  // attention VJP, two passes over the zone chunks: sum(attn gattn), then
  // ds = attn (gattn - sum) scale, gq = ds ze, gze += attn^T gctx + ds^T q
  for (int pass = 0; pass < 2; ++pass) {
    for (int z0 = 0; z0 < w.zp; z0 += kZC) {
      mm<R, DZ, kZC>(s.q, LQ, w.zeT + z0, w.zp, s.wbuf,
                     [&](float (&acc)[RPT][1]) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = wp + kWarps * i;
          at[r * H + lane] = z0 + lane < w.z
              ? expf(fminf(acc[i][0] * w.scale, 80.f)) * s.inv[r] : 0.f;
        }
      });
      mm<R, DZ, kZC>(gctx, H, w.zeT + z0, w.zp, s.wbuf,
                     [&](float (&acc)[RPT][1]) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = wp + kWarps * i;
          const float a = at[r * H + lane];
          if (pass == 0) {
            rd[i] += warp_sum(a * acc[i][0]);
          } else {
            ds[r * H + lane] = a * (acc[i][0] - rd[i]) * w.scale;
          }
        }
      });
      if (pass == 0) continue;
      mm<R, kZC, DZ>(ds, H, w.ze + (size_t)z0 * DZ, DZ, s.wbuf,
                     [&](float (&acc)[RPT][2]) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* g = gq + (wp + kWarps * i) * H + ocol<DZ>(lane, j);
            *g = (z0 == 0 ? 0.f : *g) + acc[i][j];
          }
      });
      ntdot<R, kZC, DZ, true>(at, H, gctx, H, ds, H, s.q, LQ,
                              slab + (size_t)z0 * DZ, w.z - z0);
    }
  }
  // q = x Wq: gWq += x^T gq; gx = gxb + gq Wq^T
  ntdot<R, DA, DZ, false>(s.feats, DF, gq, H, nullptr, 0, nullptr, 0,
                          slab + L.gwq, DA);
  mm<R, DZ, DA>(gq, H, w.wqT, DA, s.wbuf, [&](float (&acc)[RPT][1]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = wp + kWarps * i;
      gx[r * DA + lane] = ta[r * H + lane] + acc[i][0];
    }
  });
}

// ---- K5 -------------------------------------------------------------------

struct StepParams {
  Weights w;
  const float* x;   // (n, DA)
  const float* f0;  // (n, DA)
  const float* h;   // (n, DC)
  float* y1;        // (n, DA)
  float* f1;        // (n, DA)
  float* err;       // (n, DA), unless err_stats
  float* r5;        // (n, DA)
  float* partial;   // (gridDim.x): each CTA's sum of scaled squares
  int n, err_stats;
  float hstep, rtol, atol;
};

constexpr int kStepRows = 32;

template <int R>
size_t step_smem_floats() {
  return kWbuf + (size_t)R * (DA + 7 * DA + H + DF + H + H);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    dopri5_step_kernel(const StepParams p) {
  constexpr int M = R * DA / kThreads;  // elements per thread of a [R][DA]
  extern __shared__ __align__(16) float sm[];
  StageBufs s;
  s.wbuf = sm;
  float* x0 = s.wbuf + kWbuf;          // [R][DA]
  float* ks = x0 + R * DA;             // [7][R][DA]
  s.hpre = ks + 7 * R * DA;            // [R][H]
  s.feats = s.hpre + R * H;            // [R][DF]
  s.q = s.feats + R * DF;              // [R][H]: q and p, then rt
  s.rt = s.q;
  s.chain = s.q + R * H;               // [R][H], updated in place
  s.chain_step = 0;
  __shared__ float inv[R];
  __shared__ float red[kThreads];
  s.inv = inv;
  constexpr int RPT = R / kWarps;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float hs = p.hstep;
  const int n_tiles = (p.n + R - 1) / R;
  float sq = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * R;
    __syncthreads();
    // element m of this thread: row wp + 8 m, column lane
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = wp + kWarps * m;
      const long g = row0 + r;
      const bool v = g < p.n;
      x0[r * DA + lane] = v ? p.x[g * DA + lane] : 0.f;
      ks[r * DA + lane] = v ? p.f0[g * DA + lane] : 0.f;
      s.feats[r * DF + lane] = v ? p.h[g * DC + lane] : 0.f;  // h, staged
    }
    // hpre = h W1h: h is constant over the step, one product
    mm<R, DC, H>(s.feats, DF, p.w.w1h, H, s.wbuf, [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s.hpre[(wp + kWarps * i) * H + ocol<H>(lane, j)] = acc[i][j];
    });
    for (int st = 1; st < 7; ++st) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int o = (wp + kWarps * m) * DA + lane;
        float y = x0[o];
        for (int j = 0; j < st; ++j) {
          const float a = cA[st][j];
          if (a != 0.f) y = y + (hs * a) * ks[j * R * DA + o];
        }
        s.feats[(wp + kWarps * m) * DF + lane] = y;
      }
      stage_forward<R>(p.w, s, st, ks + st * R * DA);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = wp + kWarps * m;
      const int o = r * DA + lane;
      float inc = 0.f, e = 0.f, d = 0.f;
      for (int j = 0; j < 7; ++j) {
        const float k = ks[j * R * DA + o];
        if (cB5[j] != 0.f) inc = inc + cB5[j] * k;
        if (cBE[j] != 0.f) e = e + cBE[j] * k;
        if (cD[j] != 0.f) d = d + cD[j] * k;
      }
      const float y1 = x0[o] + hs * inc;
      e = hs * e;
      const long g = row0 + r;
      if (g < p.n) {
        p.y1[g * DA + lane] = y1;
        p.f1[g * DA + lane] = ks[6 * R * DA + o];
        p.r5[g * DA + lane] = hs * d;
        if (p.err_stats) {
          const float esc =
              e / (p.atol + p.rtol * fmaxf(fabsf(x0[o]), fabsf(y1)));
          sq += esc * esc;
        } else {
          p.err[g * DA + lane] = e;
        }
      }
    }
  }
  // the CTA's sum, in a fixed order
  red[threadIdx.x] = sq;
  __syncthreads();
  for (int m = kThreads / 2; m >= 1; m >>= 1) {
    if (threadIdx.x < m) red[threadIdx.x] += red[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.partial[blockIdx.x] = red[0];
}

// ---- K7 -------------------------------------------------------------------

struct VjpParams {
  Weights w;
  const float* x;    // (n, DA)
  const float* f0;   // (n, DA)
  const float* h;    // (n, DC)
  const float* gdy;  // (n, DA) the folded output cotangents
  const float* gr5;
  const float* gk1;
  const float* gk7;
  const float* gy0d;
  float* gy0;        // (n, DA)
  float* gf0;        // (n, DA)
  float* gh;         // (n, DC)
  float* scratch;    // (gridDim.x, 14, R, DA): the tile's k_j and gk_j
  float* slab;       // (gridDim.x, slab size), zeroed by the caller
  long slab_size;
  int n;
  float hstep;
};

template <int R>
size_t vjp_smem_floats(int nb) {
  return kWbuf + (size_t)R * (DC + 3 * H + DF + DZ + kZC + DA + 1 +
                              2 * H + (size_t)(nb + 1) * H);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    dopri5_vjp_kernel(const VjpParams p) {
  constexpr int M = R * DA / kThreads;
  constexpr int RPT = R / kWarps;
  extern __shared__ __align__(16) float sm[];
  const int nb = p.w.nb;
  StageBufs s;
  s.wbuf = sm;
  float* hin = s.wbuf + kWbuf;         // [R][DC]
  s.hpre = hin + R * DC;               // [R][H]
  float* ghp = s.hpre + R * H;         // [R][H]
  float* gp = ghp + R * H;             // [R][H]
  s.feats = gp + R * H;                // [R][DF]
  s.q = s.feats + R * DF;              // [R][DZ + kZC]
  float* gks = s.q + R * (DZ + kZC);   // [R][DA]: gk_i, then gx
  s.inv = gks + R * DA;                // [R]
  float* ta = s.inv + R;               // [R][H], the forward's rt too
  float* tb = ta + R * H;              // [R][H]
  s.rt = ta;
  s.chain = tb + R * H;                // (nb + 1) x [R][H]
  s.chain_step = R * H;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float hs = p.hstep;
  const SlabLayout L(p.w.z, nb);
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  float* ks = p.scratch + (size_t)blockIdx.x * 14 * R * DA;  // [7][R][DA]
  float* gk = ks + 7 * R * DA;                                // [7][R][DA]
  const int n_tiles = (p.n + R - 1) / R;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * R;
    __syncthreads();
    // element m of this thread: row wp + 8 m, column lane; the k_j and
    // gk_j of the scratch are only ever touched by their owner
    float x0[M], gy[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = wp + kWarps * m;
      const long g = row0 + r;
      const bool v = g < p.n;
      const int o = r * DA + lane;
      const long go = g * DA + lane;
      x0[m] = v ? p.x[go] : 0.f;
      ks[o] = v ? p.f0[go] : 0.f;
      hin[r * DC + lane] = v ? p.h[g * DC + lane] : 0.f;
      const float dy = v ? p.gdy[go] : 0.f, r5 = v ? p.gr5[go] : 0.f;
      for (int j = 0; j < 7; ++j) {
        float c = 0.f;
        if (cB5[j] != 0.f || cD[j] != 0.f) c = hs * (cB5[j] * dy + cD[j] * r5);
        if (j == 0) c = c + (v ? p.gk1[go] : 0.f);
        if (j == 6) c = c + (v ? p.gk7[go] : 0.f);
        gk[j * R * DA + o] = c;
      }
      gy[m] = v ? p.gy0d[go] : 0.f;
    }
    mm<R, DC, H>(hin, DC, p.w.w1h, H, s.wbuf, [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (wp + kWarps * i) * H + ocol<H>(lane, j);
          s.hpre[o] = acc[i][j];
          ghp[o] = 0.f;
        }
    });
    // the stage input of stage st, from x0 and the k_j
    auto stage_input = [&](int st) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int o = (wp + kWarps * m) * DA + lane;
        float y = x0[m];
        for (int j = 0; j < st; ++j) {
          const float a = cA[st][j];
          if (a != 0.f) y = y + (hs * a) * ks[j * R * DA + o];
        }
        s.feats[(wp + kWarps * m) * DF + lane] = y;
      }
    };
    for (int st = 1; st < 7; ++st) {
      stage_input(st);
      stage_forward<R>(p.w, s, st, gks);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int o = (wp + kWarps * m) * DA + lane;
        ks[st * R * DA + o] = gks[o];
      }
    }
    for (int st = 6; st >= 1; --st) {
      stage_input(st);
      stage_forward<R>(p.w, s, st, gks);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int o = (wp + kWarps * m) * DA + lane;
        gks[o] = gk[st * R * DA + o];
      }
      stage_backward<R>(p.w, s, L, slab, st, gks, gp, ta, tb, ghp, gks);
      // gx (in gks, the per-element mapping): into y0 and the earlier k_j
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int o = (wp + kWarps * m) * DA + lane;
        const float gx = gks[o];
        gy[m] = gy[m] + gx;
        for (int j = 0; j < st; ++j) {
          const float a = cA[st][j];
          if (a != 0.f) gk[j * R * DA + o] = gk[j * R * DA + o] + (hs * a) * gx;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int r = wp + kWarps * m;
      const long g = row0 + r;
      if (g < p.n) {
        p.gy0[g * DA + lane] = gy[m];
        p.gf0[g * DA + lane] = gk[r * DA + lane];
      }
    }
    // hpre = h W1h: gh = ghp W1h^T, gW1h += h^T ghp
    ntdot<R, DC, H, false>(hin, DC, ghp, H, nullptr, 0, nullptr, 0,
                           slab + L.gw1h, DC);
    mm<R, H, DC>(ghp, H, p.w.w1hT, DC, s.wbuf, [&](float (&acc)[RPT][1]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const long g = row0 + wp + kWarps * i;
        if (g < p.n) p.gh[g * DC + lane] = acc[i][0];
      }
    });
  }
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

int launch_reduce(const float* slab, float* out, long size, int num_ctas,
                  cudaStream_t s) {
  const int threads = 256;
  reduce_slabs<<<(unsigned)((size + threads - 1) / threads), threads, 0, s>>>(
      slab, out, size, num_ctas);
  return (int)cudaGetLastError();
}

bool widths_ok(int da, int dz, int dc, int hdim) {
  return da == DA && dz == DZ && dc == DC && hdim == H;
}

void set_weights(Weights& w, const void* const* p, const void* ze,
                 const void* zeT, const void* tf, int z, int zp, int nb) {
  const float* const* f = reinterpret_cast<const float* const*>(p);
  w.wq = f[0]; w.wqT = f[1]; w.w1xc = f[2]; w.w1xcT = f[3];
  w.w1h = f[4]; w.w1hT = f[5]; w.wr = f[6]; w.wrT = f[7]; w.br = f[8];
  w.w3 = f[9]; w.w3T = f[10]; w.b3 = f[11];
  w.ze = static_cast<const float*>(ze);
  w.zeT = static_cast<const float*>(zeT);
  w.tf = static_cast<const float*>(tf);
  w.z = z; w.zp = zp; w.nb = nb;
  w.scale = 0.125f;  // 1 / sqrt(DZ)
}

template <class K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int R>
int launch_vjp(const VjpParams& p, int num_ctas, cudaStream_t s) {
  auto* kernel = dopri5_vjp_kernel<R>;
  const size_t bytes = vjp_smem_floats<R>(p.w.nb) * sizeof(float);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<num_ctas, kThreads, bytes, s>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_reduce(p.slab, p.slab + (size_t)num_ctas * p.slab_size,
                       p.slab_size, num_ctas, s);
}

}  // namespace

extern "C" {

// Agent rows per tile: K5 32; K7 32 up to 4 residual blocks, 16 beyond
// (its chain of block activations must fit in shared memory).
int ananke_dopri5_tile_rows(int num_blocks, int vjp) {
  return vjp && num_blocks > 4 ? 16 : 32;
}

long ananke_dopri5_slab_size(int z, int num_blocks) {
  return SlabLayout(z, num_blocks).size;
}

// K5 on `stream`: the step kernel, then the sum of the CTAs' partial error
// sums into err_sum (1 float). Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for widths this file
// was not compiled for or bad sizes.
int ananke_dopri5_step(
    const void* x, const void* f0, const void* h, const void* ze,
    const void* zeT, const void* tf, const void* wq, const void* wqT,
    const void* w1xc, const void* w1xcT, const void* w1h, const void* w1hT,
    const void* wr, const void* wrT, const void* br, const void* w3,
    const void* w3T, const void* b3, void* y1, void* f1, void* err, void* r5,
    void* partial, void* err_sum, int n, int z, int zp, int num_blocks,
    int num_ctas, int err_stats, float hstep, float rtol, float atol, int da,
    int dz, int dc, int hdim, void* stream) {
  const int n_tiles = (n + kStepRows - 1) / kStepRows;
  if (!widths_ok(da, dz, dc, hdim) || num_blocks < 1 ||
      num_blocks > kMaxBlocks || n < 1 || z < 1 || zp % kZC != 0 || zp < z ||
      num_ctas < 1 || num_ctas > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  StepParams p;
  const void* wts[12] = {wq, wqT, w1xc, w1xcT, w1h, w1hT,
                         wr, wrT, br, w3, w3T, b3};
  set_weights(p.w, wts, ze, zeT, tf, z, zp, num_blocks);
  p.x = static_cast<const float*>(x);
  p.f0 = static_cast<const float*>(f0);
  p.h = static_cast<const float*>(h);
  p.y1 = static_cast<float*>(y1);
  p.f1 = static_cast<float*>(f1);
  p.err = static_cast<float*>(err);
  p.r5 = static_cast<float*>(r5);
  p.partial = static_cast<float*>(partial);
  p.n = n;
  p.err_stats = err_stats;
  p.hstep = hstep;
  p.rtol = rtol;
  p.atol = atol;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = dopri5_step_kernel<kStepRows>;
  const size_t bytes = step_smem_floats<kStepRows>() * sizeof(float);
  int e = set_smem(kernel, bytes);
  if (e) return e;
  kernel<<<num_ctas, kThreads, bytes, s>>>(p);
  e = (int)cudaGetLastError();
  if (e) return e;
  return launch_reduce(p.partial, static_cast<float*>(err_sum), 1, num_ctas,
                       s);
}

// K7 on `stream`: the VJP kernel, then the slab reduction into gsum, which
// follows the num_ctas slabs in `slab` (the caller zeroes the slabs).
int ananke_dopri5_step_vjp(
    const void* x, const void* f0, const void* h, const void* ze,
    const void* zeT, const void* tf, const void* wq, const void* wqT,
    const void* w1xc, const void* w1xcT, const void* w1h, const void* w1hT,
    const void* wr, const void* wrT, const void* br, const void* w3,
    const void* w3T, const void* b3, const void* gdy, const void* gr5,
    const void* gk1, const void* gk7, const void* gy0d, void* gy0, void* gf0,
    void* gh, void* scratch, void* slab, int n, int z, int zp,
    int num_blocks, int num_ctas, float hstep, int da, int dz, int dc,
    int hdim, void* stream) {
  const int rows = ananke_dopri5_tile_rows(num_blocks, 1);
  const int n_tiles = (n + rows - 1) / rows;
  if (!widths_ok(da, dz, dc, hdim) || num_blocks < 1 ||
      num_blocks > kMaxBlocks || n < 1 || z < 1 || zp % kZC != 0 || zp < z ||
      num_ctas < 1 || num_ctas > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  VjpParams p;
  const void* wts[12] = {wq, wqT, w1xc, w1xcT, w1h, w1hT,
                         wr, wrT, br, w3, w3T, b3};
  set_weights(p.w, wts, ze, zeT, tf, z, zp, num_blocks);
  p.x = static_cast<const float*>(x);
  p.f0 = static_cast<const float*>(f0);
  p.h = static_cast<const float*>(h);
  p.gdy = static_cast<const float*>(gdy);
  p.gr5 = static_cast<const float*>(gr5);
  p.gk1 = static_cast<const float*>(gk1);
  p.gk7 = static_cast<const float*>(gk7);
  p.gy0d = static_cast<const float*>(gy0d);
  p.gy0 = static_cast<float*>(gy0);
  p.gf0 = static_cast<float*>(gf0);
  p.gh = static_cast<float*>(gh);
  p.scratch = static_cast<float*>(scratch);
  p.slab = static_cast<float*>(slab);
  p.slab_size = SlabLayout(z, num_blocks).size;
  p.n = n;
  p.hstep = hstep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows == 32 ? launch_vjp<32>(p, num_ctas, s)
                    : launch_vjp<16>(p, num_ctas, s);
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
