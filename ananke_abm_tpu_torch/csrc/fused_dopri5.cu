// The discrete adjoint's kernels on Hopper (sm_90a): one DOPRI5 5(4) step
// of the GAT-ODE drift (K5), the VJP of one accepted step (K7) and the whole
// backward over every accepted step (K6).
//
// Replaces the Pallas TPU kernels
//   K5 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_step_fused
//   K7 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_step_vjp_fused
//   K6 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_backward_fused
// (stage math and stage VJP: _stage_math and _stage_vjp_math in
// ops/pallas/fused_step.py). Plain PyTorch versions:
// ananke_abm_tpu_torch/ops/cuda/fused_dopri5.py::dopri5_step_reference,
// ::dopri5_step_vjp_reference and ::dopri5_backward_reference.
//
// What they compute, per agent row:
// - K5: the six stage evaluations k2..k7 of the drift from (x, f0 = k1),
//   y1 = x + h sum b5_j k_j, f1 = k7, the embedded error h sum (b5 - b4)_j
//   k_j (or, with err_stats, the sum over every real element of (err /
//   (atol + rtol max(|x|, |y1|)))^2) and r5 = h sum d_j k_j;
// - K7: stages 1-5 again (k7 feeds no stage input), then, stage by stage
//   in reverse, the stage recomputed and its VJP at gk_i, the cotangents
//   chained through the tableau: gk_j += h a_ij gx_i, gy0 += gx_i. Per
//   agent gy0, gf0 (= gk_1) and gh; summed over agents the gradients of the
//   zones, the seven time rows, Wq, W1xc, W1h, every residual block and the
//   output layer;
// - K6: K7's step VJP for the accepted steps n_acc - 1 .. 0 in turn, each
//   step's cotangents folded from the carries (g_y, g_f) and the output
//   rows it filled (CONTD5 weights), its time rows' gradients in a slot of
//   their own.
//
// Two step bodies. float32 (K5, K7 and K6 at precision "f32", the
// trainers' forward): bf16 rounding of the stage activations is noise that
// does not cancel in the embedded 5(4) error and floors the step
// controller, and TF32 keeps three decimal digits, the same class; so every
// product of the step VJP's float32 body is a float32 fused multiply-add on
// the CUDA cores, and K5's products run in 3xTF32 on the tensor cores
// (each operand split into two TF32 parts, three products, float32 sums:
// the float32 class; the K5 section below).
// bf16 (K7 and K6 at precision "bf16", the adaptive trainer's backward at
// bench rung 3; K5 at "bf16", the forward the reference keeps for loose
// tolerances, rtol >= ~1e-3): the stage and its VJP of drift_stage.cuh
// (K8's and K2b's), bf16 operands on mma.sync with float32 sums at the
// reference's rounding points; a bf16 backward replays the forward's
// steps, so the noise moves the gradient, not the step sequence.
//
// What bounds them on the card: operations. One stage is ~92 kMAC per agent
// at the shipping widths and Z = 64, its VJP about twice that; the bytes
// per agent are a few hundred a step (K6: the two checkpoints, read once,
// and the output rows' cotangents). At bench rung 3 K6 at bf16 needs ~5.6
// TFLOP, 5.7 ms at the dense bf16 peak, its bytes ~1 ms. The design:
//
// - K5 at float32: 3xTF32 mma.sync products, a weight ring shared by a
//   CTA's 8 warps (128 rows); the K5 section below.
// - The float32 step-VJP body (K7 and K6 at "f32"): a CTA of 8 warps owns a
//   tile of R agent rows (32; 16 for deep drifts) and walks tiles tile =
//   blockIdx.x, + gridDim.x, ... Activations of the tile live in shared
//   memory, float32 row-major. Every product out = A W runs as register
//   tiles: warp w computes rows w, w + 8, ..., lane l a run of adjacent
//   columns; A is read from shared memory four columns at a time (a
//   broadcast within the warp), W is staged through two shared-memory
//   buffers of 32 rows by cp.async, the next chunk's copy in flight while
//   this one is multiplied (the weights, ~0.35 MB in float32, stay hot in
//   L2). The step VJP's weight gradients are register-blocked outer
//   products (ntdot; its predecessor issued two shared-memory loads for
//   4-16 multiply-adds): each thread owns a TM x 4 block of the gradient
//   (8 x 4 for the H x H ones, in two passes), so an agent row costs one
//   vector load of A (a broadcast) and one float4 of B for 4 TM
//   multiply-adds, and the block goes into the slab once per 32-row tile
//   and product in float4 read-modify-writes, at 237 registers and no
//   spills. The tile stays at 32 rows and one CTA an SM: its activations
//   take ~5 KB a row at two blocks (~196 KB with the buffers), so neither
//   two CTAs of 32 rows nor taller tiles fit, and two CTAs of 16 rows would
//   flush the slab twice as often per row. The attention runs by chunks of 32 zones:
//   no Z-wide row is stored, any zone count; the max-free softmax (exp
//   clamped at 80) sums its rows chunk by chunk, the context is normalised
//   after the product.
// - The bf16 body (K7 and K6 at "bf16"): stage_sm90.cuh's stage and VJP.
//   What held its drift_stage.cuh predecessor to ~1% of its bound, and what
//   the body does about each:
//   * weights from L2 per 16-row warp (~180 KB a stage forward, twice that
//     a VJP, one dependent L2 load behind each mma): every weight operand
//     (each product's weights, or half, or a 32-zone box of the zones and
//     their transpose) goes once per CTA through a 3-slot cp.async ring in
//     shared memory, 2 boxes ahead, and every warp reads its B fragments
//     from there by ldmatrix: one copy from L2 serves 96 rows. The warps
//     walk the step's fixed sequence of boxes in lockstep, one barrier a box;
//   * one warp per SM sub-partition: a CTA of W warps (6, 96 rows, up to 2
//     blocks; 4 up to 5; 2 beyond: the most whose rows fit beside the
//     ring) owns 16 W rows, each warp its 16 rows end to end on mma.sync
//     bf16 -> f32. Shared memory at two blocks: the ring 55 KB, per row
//     feats, q, two work rows, bf16(h) and the 3-level block chain (1.75
//     KB; the VJP's short-lived rows overlaid on the work rows), 230 KB for
//     96 rows;
//   * 255 registers and 1.5-1.9 KB of spill stores: the step body is a
//     function of its own, called once a step (step_vjp_bf16), whose
//     arguments are scalars and pointers; no weight pointer, shared-memory
//     address or slab offset is held across it (all are constants or
//     recomputed from the launch parameters), bf16(h) sits in shared
//     memory and the stage's gx waits in its scratch slot through the
//     attention VJP. At 6 warps the body spills nothing; the kernels save
//     their few loop values around the call, once a step;
//   * the step state in device memory: it stays in a warp-private scratch
//     (x0, the k_j, their cotangents and the h-row sums, 36 KB a warp: no
//     room beside the ring), coalesced, each array read at most once a
//     stage;
//   * a slab read-modify-write per 64 rows per product: once per 96 rows,
//     by 16 x 32 output blocks whose slab values are read in one round trip
//     before their products; the zones' gradient once per 32-zone box.
//   K5 at bf16 keeps drift_stage.cuh's forward (4 warps; 2 at 8 blocks)
//   with its warp's x0 and k_1 .. k_7 in shared memory.
// - Neither can keep six stages of intermediates (~24 KB per agent): each
//   keeps the stage outputs k_j (and the cotangents) and recomputes stage
//   i's intermediates just before its VJP: 11 stage forwards and 6 stage
//   VJPs per step.
// - K6: one CTA owns an agent tile for all steps, the step loop inside the
//   block, so no grid-wide sync; the carries stay in registers (float32)
//   or the warp's scratch (bf16) between steps; the output times and rows'
//   steps sit in shared memory, and the fold skips the rows a step did not
//   fill. One launch per backward.
// - Weight gradients are contractions over the tile's rows, added into the
//   CTA's own slab in device memory (plain loads and stores); a second
//   kernel sums the slabs in CTA order. K5's error sum is per CTA the same
//   way. No atomics: the same operands give the same bits, and so the same
//   step sequence. K6's slab holds 7 time rows per accepted step (sized by
//   n_acc, not max_acc).
//
// Rows past N read zeros: their cotangents are zero, so every gradient term
// they could feed is zero, and K5's error sum masks them.
//
// Compiled for (agent, zone, context, hidden) = (32, 64, 32, 128), 1-8
// residual blocks and any zone count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "drift_stage.cuh"
#include "stage_sm90.cuh"

namespace {

constexpr int DA = 32, DZ = 64, DC = 32, H = 128, DF = DA + DZ;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVjpKC = 32;  // rows of W in each of the float32 step VJP's two
                            // staging buffers
constexpr int kZC = 32;   // zones per attention chunk
constexpr int kMaxBlocks = 8;
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
template <int R, int K, int N, int KC, class Ep>
__device__ __forceinline__ void mm(const float* A, int lda,
                                   const float* __restrict__ W, int ldw,
                                   float* wbuf, Ep ep) {
  constexpr int RPT = R / kWarps, CPT = N / 32;
  static_assert(K % KC == 0 && N % 32 == 0 && R % kWarps == 0, "shape");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  // chunk c of W's rows into staging buffer c % 2, by cp.async: the copy
  // of chunk c + 1 runs while chunk c is multiplied
  auto stage = [&](int c) {
    float* dst = wbuf + (c & 1) * KC * N;
    for (int e = threadIdx.x * 4; e < KC * N; e += kThreads * 4) {
      const int kk = e / N, n = e % N;
      cp_async16(dst + e, W + (size_t)(c * KC + kk) * ldw + n);
    }
    cp_commit();
  };
  constexpr int NC = K / KC;
  stage(0);
  for (int c = 0; c < NC; ++c) {
    if (c + 1 < NC) {
      stage(c + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* wb = wbuf + (c & 1) * KC * N;
    const int k0 = c * KC;
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
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

// C consecutive floats of shared memory: float4 loads where C is a
// multiple of 4 (16-byte aligned), else float2 loads (8-byte aligned)
template <int C>
__device__ __forceinline__ void lds_row(float (&v)[C], const float* p) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x; v[c + 1] = t.y; v[c + 2] = t.z; v[c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + c);
      v[c] = t.x; v[c + 1] = t.y;
    }
  }
}

// the rows of a thread's block in ntdot: the largest even divisor of the
// rows a row group owns in all, up to 8 (so at most 32 accumulators)
__host__ __device__ constexpr int ntdot_rows(int per) {
  return per % 8 == 0 ? 8 : per % 6 == 0 ? 6 : per % 4 == 0 ? 4 : 2;
}

// out[m][n] += sum_r A[r][m] B[r][n] (+ A2[r][m] B2[r][n]) for m < m_valid:
// the agent contraction of a weight gradient, into the CTA's slab (row
// stride N), as register-blocked outer products. In each pass thread (mg,
// ng) owns a TM x 4 block (TM <= 8) of the gradient: rows TM mg .. of the
// pass, columns 4 ng ..; each agent row costs one load of its TM values of
// A (a broadcast within the warp) and one float4 of B for 4 TM fused
// multiply-adds, and the block goes into the slab once, in float4
// read-modify-writes. Each output has one owner thread: no atomics.
template <int R, int M, int N, bool TWO>
__device__ __forceinline__ void ntdot(const float* A, int lda, const float* B,
                                      int ldb, const float* A2, int lda2,
                                      const float* B2, int ldb2, float* out,
                                      int m_valid) {
  constexpr int NG = N / 4, MG = kThreads / NG, PER = M / MG;
  constexpr int TM = ntdot_rows(PER), PASSES = PER / TM;
  static_assert(N % 4 == 0 && kThreads % NG == 0 && PER * MG == M &&
                    PER % 2 == 0,
                "tile");
  const int ng = threadIdx.x % NG, mg = threadIdx.x / NG, n0 = 4 * ng;
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int m0 = pass * TM * MG + TM * mg;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      float a[TM], b[4];
      lds_row<TM>(a, A + r * lda + m0);
      lds_row<4>(b, B + r * ldb + n0);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      if (TWO) {
        lds_row<TM>(a, A2 + r * lda2 + m0);
        lds_row<4>(b, B2 + r * ldb2 + n0);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (m0 + i >= m_valid) continue;
      float4* o = reinterpret_cast<float4*>(out + (size_t)(m0 + i) * N + n0);
      float4 v = *o;
      v.x += acc[i][0]; v.y += acc[i][1]; v.z += acc[i][2]; v.w += acc[i][3];
      *o = v;
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
  float* wbuf;   // [2 KC * H] staged weights
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
template <int R, int KC>
__device__ void stage_forward(const Weights& w, const StageBufs& s, int stage,
                              float* kout) {
  constexpr int RPT = R / kWarps;
  constexpr int LQ = DZ + kZC;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // q = x Wq
  mm<R, DA, DZ, KC>(s.feats, DF, w.wq, DZ, s.wbuf, [&](float (&acc)[RPT][2]) {
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
    mm<R, DZ, kZC, KC>(s.q, LQ, w.zeT + z0, w.zp, s.wbuf,
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
    mm<R, kZC, DZ, KC>(p, LQ, w.ze + (size_t)z0 * DZ, DZ, s.wbuf,
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
  mm<R, DF, H, KC>(s.feats, DF, w.w1xc, H, s.wbuf, [&](float (&acc)[RPT][4]) {
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
    mm<R, H, H, KC>(zin, H, w.wr + (size_t)(2 * b) * H * H, H, s.wbuf,
                [&](float (&acc)[RPT][4]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ocol<H>(lane, j);
          s.rt[(wp + kWarps * i) * H + c] = tanhf(acc[i][j] + br1[c]);
        }
    });
    mm<R, H, H, KC>(s.rt, H, w.wr + (size_t)(2 * b + 1) * H * H, H, s.wbuf,
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
  mm<R, H, DA, KC>(s.chain + w.nb * s.chain_step, H, w.w3, DA, s.wbuf,
               [&](float (&acc)[RPT][1]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      kout[(wp + kWarps * i) * DA + lane] = acc[i][0] + w.b3[lane];
  });
}

// offsets (floats) of the summed gradients in a slab: gze (z, DZ) | gtf
// (tf_rows, H): K7's 7 stage rows, K6's 7 per step | gWq (DA, DZ) | gW1xc
// (DF, H) | gW1h (DC, H) | per block gWr1 (H, H), gbr1 (H), gWr2 (H, H),
// gbr2 (H) | gW3 (H, DA) | gb3 (DA); drift_stage.cuh's Slab, the same
// layout
struct SlabLayout {
  long gtf, gwq, gw1, gw1h, blk0, gw3, gb3, size;
  __host__ __device__ SlabLayout(int z, int nb, int tf_rows) {
    gtf = (long)z * DZ;
    gwq = gtf + (long)tf_rows * H;
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

// the VJP of a stage at gk ([R][DA] in shared memory), its forward just
// recomputed into s (every chain level kept): gradients into the slab (the
// time row's at slab + gtf), ghp += the Dense_0 pre-activation's
// cotangent, and gx ([R][DA], the per-element mapping) the cotangent of
// the stage input.
template <int R, int KC>
__device__ void stage_backward(const Weights& w, const StageBufs& s,
                               const SlabLayout& L, float* slab, long gtf,
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
  mm<R, DA, H, KC>(gk, DA, w.w3T, H, s.wbuf, [&](float (&acc)[RPT][4]) {
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
    mm<R, H, H, KC>(zin, H, w.wr + (size_t)(2 * b) * H * H, H, s.wbuf,
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
    mm<R, H, H, KC>(gp, H, w.wrT + (size_t)(2 * b + 1) * H * H, H, s.wbuf,
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
    mm<R, H, H, KC>(tb, H, w.wrT + (size_t)(2 * b) * H * H, H, s.wbuf,
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
  colsum<R, H>(gp, H, slab + gtf);
  // ghp += gp; gf = gp W1xc^T into ta (cols 0..DF): gxb | gctx
  mm<R, H, DF, KC>(gp, H, w.w1xcT, DF, s.wbuf, [&](float (&acc)[RPT][3]) {
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
      mm<R, DZ, kZC, KC>(s.q, LQ, w.zeT + z0, w.zp, s.wbuf,
                     [&](float (&acc)[RPT][1]) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = wp + kWarps * i;
          at[r * H + lane] = z0 + lane < w.z
              ? expf(fminf(acc[i][0] * w.scale, 80.f)) * s.inv[r] : 0.f;
        }
      });
      mm<R, DZ, kZC, KC>(gctx, H, w.zeT + z0, w.zp, s.wbuf,
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
      mm<R, kZC, DZ, KC>(ds, H, w.ze + (size_t)z0 * DZ, DZ, s.wbuf,
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
  mm<R, DZ, DA, KC>(gq, H, w.wqT, DA, s.wbuf, [&](float (&acc)[RPT][1]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = wp + kWarps * i;
      gx[r * DA + lane] = ta[r * H + lane] + acc[i][0];
    }
  });
}

// ---- K5 -------------------------------------------------------------------
//
// The float32 step on the tensor cores in 3xTF32. The FFMA design it
// replaces (32-row tiles, two CTAs an SM, every weight staged per tile
// through two 16-row cp.async buffers, 36% of the FP32 rate) is taken apart
// by probes in PERF.md. Here:
// - products: mma.sync m16n8k8 TF32 with each operand split into a TF32
//   part (its low mantissa bits cleared) and the rest, three products a
//   tile (lo hi, hi lo, hi hi) summed in float32: about 22 bits of each
//   operand, the float32 class the step controller needs (bf16 or TF32
//   alone floor it), at the tensor cores' TF32 rate. Within an 8-column
//   slice mma k t and t + 4 are the adjacent columns 2t and 2t + 1, so a
//   thread's A and B values are float2 loads and the accumulators of one
//   product are the A fragments of the next: q, the attention's p and
//   context and the blocks' inner activation never leave registers.
// - weights: a ring of 3 shared-memory slots that the CTA's 8 warps (128
//   rows, each warp 16 end to end) share; every stage walks the same boxes
//   (Wq^T, the zones by 32 beside their transpose, the halves of W1^T, of
//   each block's Wr1^T and Wr2^T, then W3^T), each copied once a CTA by
//   cp.async 2 boxes ahead, one block barrier a box. (A fourth slot, and
//   A operands read from shared memory in rolled loops, both read slower
//   on the card: PERF.md.)
// - h joins the stage input: Dense_0 is one product over [x | ctx | h] and
//   [W1xc; W1h], so no H-wide pre-activation row is kept.
// - the step state (x0, k1 .. k7: 1 KB a row) lives in a warp-private
//   scratch in device memory (16 KB a warp, L2-resident), each thread
//   reading back only what it wrote; the block chain z and the h rows sit
//   in shared memory by warp.

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
  float* scratch;   // (gridDim.x, k5::kW, k5::kState): the step state
  int n, err_stats;
  float hstep, rtol, atol;
};

namespace k5 {

constexpr int kW = 8;                // warps a CTA
constexpr int kRows = 16 * kW;       // agent rows a tile
// CTAs at most, one an SM; a constant, so the error sum's order depends on
// n alone
constexpr int kCtas = 132;
constexpr int SZ = H + 8;            // row strides (floats), 8 mod 32: the
constexpr int SH = DC + 8;           //   8 rows a fragment reads hit
constexpr int SB = H + 8;            //   distinct banks
constexpr int kSlot = 64 * SB;       // floats of a ring slot: a half box
constexpr int kSlots = 3;
constexpr int kState = 8 * 16 * 32;  // floats of a warp's step state
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kSlots * kSlot + kRows * SZ + kRows * SH);
static_assert(32 * (DZ + 8) + DZ * (32 + 8) <= kSlot && DA + DZ + DC == H,
              "box shapes");
static_assert(kSmemBytes + 32 * kW * sizeof(float) <= 232448,
              "shared memory of a CTA");

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly (13 significant bits, of which the tensor
// core reads the top 11: x to about 2^-22 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of an 8-column slice whose values are the accumulators c
// of an 8-column output tile (c: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)): within a slice mma k t and t + 4 are the adjacent columns 2t
// and 2t + 1, so one product's accumulators are the next one's A
__device__ __forceinline__ void frag_regs(const float (&c)[4], float (&a)[4]) {
  a[0] = c[0]; a[1] = c[2]; a[2] = c[1]; a[3] = c[3];
}

// the A fragment of slice s of 16 rows in shared memory (row stride S)
__device__ __forceinline__ void frag_smem(const float* rows, int S, int s,
                                          float (&a)[4], int g, int t) {
  const float2 u =
      *reinterpret_cast<const float2*>(rows + g * S + 8 * s + 2 * t);
  const float2 v =
      *reinterpret_cast<const float2*>(rows + (g + 8) * S + 8 * s + 2 * t);
  a[0] = u.x; a[1] = v.x; a[2] = u.y; a[3] = v.y;
}

// acc[j] (j < NT) += A B in 3xTF32: A the warp's 16 rows by KS slices of 8
// (af(s, a) gives slice s's fragment), B^T the NT 8-row tiles of a box at
// row stride S (row n holds output column n's weights, k contiguous; a
// thread's two values of a fragment are one float2). Per slice every B
// fragment is loaded and split first, then the products go term by term
// across the NT accumulators, so no two in a row depend.
template <int KS, int NT, class AF>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], AF af,
                                     const float* bt, int S, int g, int t) {
  const float* bp = bt + g * S + 2 * t;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    float a[4];
    af(s, a);
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(bp + 8 * j * S + 8 * s);
      split(b.x, bh[j][0], bl[j][0]);
      split(b.y, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows x cols floats (row stride ss) -> shared memory (row stride ds) by
// cp.async, every thread taking 16-byte pieces in turn
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          int ss, int rows, int cols) {
  const int per = cols / 4, pieces = rows * per;
  for (int e = threadIdx.x; e < pieces; e += 32 * kW) {
    const int r = e / per, k = e - r * per;
    cp_async16(dst + r * ds + 4 * k, src + (size_t)r * ss + 4 * k);
  }
}

// The weight ring. Box i of a stage (period P = 4 + nzc + 4 nb):
//   0 Wq^T (DZ x DA) | 1 .. nzc zones z0 = 32 (i - 1): ze rows z0 .. z0 + 31
//   (32 x DZ, stride DZ + 8), then ze^T's columns z0 .. z0 + 31 (DZ x 32,
//   stride 40) | the halves of W1^T (64 x [W1xc^T | W1h^T]) | per block
//   the halves of Wr1^T, then of Wr2^T (64 x H) | W3^T (DA x H).
// The warps consume boxes in that order, stage after stage, tile after
// tile; boxes c + 1 .. c + kSlots - 1 are in flight while box c is read.
struct Ring {
  float* base;
  int nzc, period, c, total;

  __device__ void copy_box(const Weights& w, int i, float* dst) const {
    if (i == 0) {
      copy_rows(dst, DA + 8, w.wqT, DA, DZ, DA);
    } else if (i <= nzc) {
      const int z0 = 32 * (i - 1);
      copy_rows(dst, DZ + 8, w.ze + (size_t)z0 * DZ, DZ, 32, DZ);
      copy_rows(dst + 32 * (DZ + 8), 32 + 8, w.zeT + z0, w.zp, DZ, 32);
    } else if (i <= nzc + 2) {
      const int hf = i - nzc - 1;
      copy_rows(dst, SB, w.w1xcT + (size_t)64 * hf * DF, DF, 64, DF);
      copy_rows(dst + DF, SB, w.w1hT + (size_t)64 * hf * DC, DC, 64, DC);
    } else if (i < period - 1) {
      const int r = i - nzc - 3;  // block r / 4: Wr1 (r & 2 == 0) or Wr2
      const int m = 2 * (r >> 2) + ((r >> 1) & 1), hf = r & 1;
      copy_rows(dst, SB, w.wrT + ((size_t)m * H + 64 * hf) * H, H, 64, H);
    } else {
      copy_rows(dst, SB, w.w3T, H, DA, H);
    }
  }

  __device__ void issue(const Weights& w, int i) {
    if (i < total) copy_box(w, i % period, base + (i % kSlots) * kSlot);
    cp_commit();  // an empty group past the end: the waits keep count
  }

  // the next box, landed and visible to every thread; the slot of the box
  // before it refilled, kSlots - 1 boxes ahead
  __device__ const float* next(const Weights& w) {
    cp_wait<kSlots - 2>();
    __syncthreads();
    issue(w, c + kSlots - 1);
    return base + (c++ % kSlots) * kSlot;
  }
};

// k = stage_stg(x) for the warp's 16 rows: x and k 16 x DA tiles in
// accumulator layout (x[j]: columns 8j .. 8j + 7), h the rows' context in
// shared memory, z the rows' block chain (shared memory, updated in place)
__device__ void stage(const Weights& w, Ring& ring, int stg,
                      const float (&x)[4][4], const float* hrow, float* z,
                      float (&k)[4][4], int g, int t) {
  // q = x Wq
  float q[8][4];
  zero(q);
  mma3<4>(q, [&](int s, float (&a)[4]) { frag_regs(x[s], a); },
          ring.next(w), DA + 8, g, t);
  // the attention by boxes of 32 zones: p = exp(min(q ze^T scale, 80)) (0
  // past z), ctx = (sum of p ze) / (sum of p)
  float ctx[8][4], rs_a = 0.f, rs_b = 0.f;
  zero(ctx);
#pragma unroll 1
  for (int z0 = 0; z0 < w.zp; z0 += 32) {
    const float* box = ring.next(w);
    float sc[4][4];
    zero(sc);
    mma3<8>(sc, [&](int s, float (&a)[4]) { frag_regs(q[s], a); }, box,
            DZ + 8, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int zi = z0 + 8 * j + 2 * t + (e & 1);
        const float v =
            zi < w.z ? expf(fminf(sc[j][e] * w.scale, 80.f)) : 0.f;
        sc[j][e] = v;
        if (e < 2) rs_a += v; else rs_b += v;
      }
    mma3<4>(ctx, [&](int s, float (&a)[4]) { frag_regs(sc[s], a); },
            box + 32 * (DZ + 8), 32 + 8, g, t);
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    rs_a += __shfl_xor_sync(kFull, rs_a, m);
    rs_b += __shfl_xor_sync(kFull, rs_b, m);
  }
  const float inv_a = 1.f / rs_a, inv_b = 1.f / rs_b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ctx[j][0] *= inv_a; ctx[j][1] *= inv_a;
    ctx[j][2] *= inv_b; ctx[j][3] *= inv_b;
  }
  // z = tanh([x | ctx | h] [W1xc; W1h] + tf_stg), by halves of its columns
  const float* tfs = w.tf + stg * H;
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    const float* box = ring.next(w);
    float acc[8][4];
    zero(acc);
    mma3<16>(acc, [&](int s, float (&a)[4]) {
      if (s < 4) frag_regs(x[s & 3], a);
      else if (s < 12) frag_regs(ctx[(s - 4) & 7], a);
      else frag_smem(hrow, SH, (s - 12) & 3, a, g, t);
    }, box, SB, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 64 * hf + 8 * j + 2 * t;
      const float2 tf = __ldg(reinterpret_cast<const float2*>(tfs + n));
      *reinterpret_cast<float2*>(z + g * SZ + n) =
          make_float2(tanhf(acc[j][0] + tf.x), tanhf(acc[j][1] + tf.y));
      *reinterpret_cast<float2*>(z + (g + 8) * SZ + n) =
          make_float2(tanhf(acc[j][2] + tf.x), tanhf(acc[j][3] + tf.y));
    }
  }
  // residual blocks: rt = tanh(z Wr1 + br1) (registers), z = tanh(z + rt
  // Wr2 + br2)
#pragma unroll 1
  for (int b = 0; b < w.nb; ++b) {
    const float* br1 = w.br + (2 * b) * H;
    const float* br2 = w.br + (2 * b + 1) * H;
    float rt[16][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* box = ring.next(w);
      float acc[8][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) {
        frag_smem(z, SZ, s, a, g, t);
      }, box, SB, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = __ldg(
            reinterpret_cast<const float2*>(br1 + 64 * hf + 8 * j + 2 * t));
        rt[8 * hf + j][0] = tanhf(acc[j][0] + bb.x);
        rt[8 * hf + j][1] = tanhf(acc[j][1] + bb.y);
        rt[8 * hf + j][2] = tanhf(acc[j][2] + bb.x);
        rt[8 * hf + j][3] = tanhf(acc[j][3] + bb.y);
      }
    }
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const float* box = ring.next(w);
      float acc[8][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) { frag_regs(rt[s], a); }, box,
               SB, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * hf + 8 * j + 2 * t;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(br2 + n));
        float2* za = reinterpret_cast<float2*>(z + g * SZ + n);
        float2* zb = reinterpret_cast<float2*>(z + (g + 8) * SZ + n);
        const float2 ua = *za, ub = *zb;
        *za = make_float2(tanhf(ua.x + acc[j][0] + bb.x),
                          tanhf(ua.y + acc[j][1] + bb.y));
        *zb = make_float2(tanhf(ub.x + acc[j][2] + bb.x),
                          tanhf(ub.y + acc[j][3] + bb.y));
      }
    }
  }
  // k = z W3 + b3
  zero(k);
  mma3<16>(k, [&](int s, float (&a)[4]) { frag_smem(z, SZ, s, a, g, t); },
           ring.next(w), SB, g, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 bb =
        __ldg(reinterpret_cast<const float2*>(w.b3 + 8 * j + 2 * t));
    k[j][0] += bb.x; k[j][1] += bb.y; k[j][2] += bb.x; k[j][3] += bb.y;
  }
}

// element e (< 16) of a thread's 16 x DA tile: row g (+ 8 for e & 2),
// column 8 (e / 4) + 2t + (e & 1)
__device__ __forceinline__ int tile_col(int e, int t) {
  return 8 * (e >> 2) + 2 * t + (e & 1);
}

}  // namespace k5

__global__ void __launch_bounds__(32 * k5::kW, 1)
    dopri5_step_kernel(const StepParams p) {
  using namespace k5;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32 * kW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* z = sm + kSlots * kSlot + warp * 16 * SZ;
  float* hrow = sm + kSlots * kSlot + kRows * SZ + warp * 16 * SH;
  // the thread's state: array a (x0, k1 .. k7), element e at
  // st[(16 a + e) * 32], coalesced over the warp
  float* st = p.scratch + ((size_t)blockIdx.x * kW + warp) * kState + lane;
  const int n_tiles = (p.n + kRows - 1) / kRows;
  const int mine = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  Ring ring;
  ring.base = sm;
  ring.nzc = p.w.zp / 32;
  ring.period = 4 + ring.nzc + 4 * p.w.nb;
  ring.c = 0;
  ring.total = mine * 6 * ring.period;
  for (int i = 0; i + 1 < kSlots; ++i) ring.issue(p.w, i);
  const float hs = p.hstep;
  float sq = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long ra = (long)tile * kRows + warp * 16 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;
    // x0 -> state 0, f0 = k1 -> state 1, h -> the warp's h rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 zero2 = make_float2(0.f, 0.f);
      const float2 xa = va ? *reinterpret_cast<const float2*>(p.x + ra * DA + c) : zero2;
      const float2 xb = vb ? *reinterpret_cast<const float2*>(p.x + rb * DA + c) : zero2;
      const float2 fa = va ? *reinterpret_cast<const float2*>(p.f0 + ra * DA + c) : zero2;
      const float2 fb = vb ? *reinterpret_cast<const float2*>(p.f0 + rb * DA + c) : zero2;
      const float2 ha = va ? *reinterpret_cast<const float2*>(p.h + ra * DC + c) : zero2;
      const float2 hb = vb ? *reinterpret_cast<const float2*>(p.h + rb * DC + c) : zero2;
      st[(4 * j + 0) * 32] = xa.x; st[(4 * j + 1) * 32] = xa.y;
      st[(4 * j + 2) * 32] = xb.x; st[(4 * j + 3) * 32] = xb.y;
      st[(16 + 4 * j + 0) * 32] = fa.x; st[(16 + 4 * j + 1) * 32] = fa.y;
      st[(16 + 4 * j + 2) * 32] = fb.x; st[(16 + 4 * j + 3) * 32] = fb.y;
      *reinterpret_cast<float2*>(hrow + g * SH + c) = ha;
      *reinterpret_cast<float2*>(hrow + (g + 8) * SH + c) = hb;
    }
#pragma unroll 1
    for (int stg = 1; stg < 7; ++stg) {
      // the stage input x0 + sum_j (h a_stg,j) k_j, in the reference's order
      float x[4][4];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float y = st[e * 32];
        for (int j = 0; j < stg; ++j) {
          const float a = cA[stg][j];
          if (a != 0.f) y = y + (hs * a) * st[(16 * (1 + j) + e) * 32];
        }
        x[e >> 2][e & 3] = y;
      }
      float k[4][4];
      stage(p.w, ring, stg, x, hrow, z, k, g, t);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        st[(16 * (1 + stg) + e) * 32] = k[e >> 2][e & 3];
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float inc = 0.f, er = 0.f, d = 0.f;
      for (int j = 0; j < 7; ++j) {
        const float kj = st[(16 * (1 + j) + e) * 32];
        if (cB5[j] != 0.f) inc = inc + cB5[j] * kj;
        if (cBE[j] != 0.f) er = er + cBE[j] * kj;
        if (cD[j] != 0.f) d = d + cD[j] * kj;
      }
      const float x0 = st[e * 32];
      const float y1 = x0 + hs * inc;
      er = hs * er;
      const long row = (e & 2) ? rb : ra;
      if ((e & 2) ? vb : va) {
        const long o = row * DA + tile_col(e, t);
        p.y1[o] = y1;
        p.f1[o] = st[(16 * 7 + e) * 32];
        p.r5[o] = hs * d;
        if (p.err_stats) {
          const float esc =
              er / (p.atol + p.rtol * fmaxf(fabsf(x0), fabsf(y1)));
          sq += esc * esc;
        } else {
          p.err[o] = er;
        }
      }
    }
  }
  // the CTA's sum, in a fixed order
  red[threadIdx.x] = sq;
  __syncthreads();
  for (int m = 16 * kW; m >= 1; m >>= 1) {
    if (threadIdx.x < m) red[threadIdx.x] += red[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.partial[blockIdx.x] = red[0];
  cp_wait<0>();
}

// ---- the step VJP's cotangents ---------------------------------------------

// the folded cotangents of one step (ode/discrete_adjoint.py derives them)
struct Gset {
  float dy, r5, k1x, k7x, y0d;
};

// stage j's initial cotangent h (b5_j g_dy + d_j g_r5), plus g_k1x on k1 and
// g_k7x on k7, each operation rounded as the reference rounds it
__device__ __forceinline__ float stage_cot(int j, float hs, const Gset& c) {
  float v = 0.f;
  if (cB5[j] != 0.f || cD[j] != 0.f)
    v = __fmul_rn(hs, __fadd_rn(__fmul_rn(cB5[j], c.dy),
                                __fmul_rn(cD[j], c.r5)));
  if (j == 0) v = __fadd_rn(v, c.k1x);
  if (j == 6) v = __fadd_rn(v, c.k7x);
  return v;
}

// K6's fold: a step's cotangents from the carries (g_y, g_f) and gr, the
// sums over the output rows it filled of the CONTD5 weights times the rows'
// cotangents
__device__ __forceinline__ Gset fold_gset(float gy, float gf,
                                          const float (&gr)[5], float hs) {
  Gset c;
  c.dy = __fadd_rn(__fsub_rn(__fadd_rn(gy, gr[1]), gr[2]),
                   __fmul_rn(2.f, gr[3]));
  c.r5 = gr[4];
  c.k1x = __fmul_rn(hs, __fsub_rn(gr[2], gr[3]));
  c.k7x = __fsub_rn(gf, __fmul_rn(hs, gr[3]));
  c.y0d = __fadd_rn(gy, gr[0]);
  return c;
}

// the CONTD5 weights (1, th, th om, th^2 om, th^2 om^2) of output time ts in
// the step [t0, t0 + hs]: th clipped to [0, 1], a zero step divides by 1
__device__ __forceinline__ void contd5_weights(float ts, float t0, float hs,
                                               float (&w)[5]) {
  const float safe = hs == 0.f ? 1.f : hs;
  const float th = fminf(fmaxf(__fdiv_rn(__fsub_rn(ts, t0), safe), 0.f), 1.f);
  const float om = __fsub_rn(1.f, th);
  w[0] = 1.f;
  w[1] = th;
  w[2] = __fmul_rn(th, om);
  w[3] = __fmul_rn(__fmul_rn(th, th), om);
  w[4] = __fmul_rn(w[3], om);
}

// ---- the float32 step VJP: K7 at precision "f32", and K6's f32 body --------

// a tile's shared memory for the float32 step VJP
struct F32Vjp {
  StageBufs s;
  float* hin;  // [R][DC]
  float* ghp;  // [R][H]
  float* gp;   // [R][H]
  float* gks;  // [R][DA]: gk_i, then gx
  float* ta;   // [R][H], the forward's rt too
  float* tb;   // [R][H]
};

// the staging buffers of the float32 step VJP's products
constexpr int kVjpWbuf = 2 * kVjpKC * H;

template <int R>
size_t f32_vjp_smem_floats(int nb) {
  return kVjpWbuf + (size_t)R * (DC + 3 * H + DF + DZ + kZC + DA + 1 +
                              2 * H + (size_t)(nb + 1) * H);
}

template <int R>
__device__ __forceinline__ F32Vjp f32_vjp_smem(float* sm) {
  F32Vjp t;
  t.s.wbuf = sm;
  t.hin = t.s.wbuf + kVjpWbuf;
  t.s.hpre = t.hin + R * DC;
  t.ghp = t.s.hpre + R * H;
  t.gp = t.ghp + R * H;
  t.s.feats = t.gp + R * H;
  t.s.q = t.s.feats + R * DF;              // [R][DZ + kZC]
  t.gks = t.s.q + R * (DZ + kZC);
  t.s.inv = t.gks + R * DA;                // [R]
  t.ta = t.s.inv + R;
  t.tb = t.ta + R * H;
  t.s.rt = t.ta;
  t.s.chain = t.tb + R * H;                // (nb + 1) x [R][H]
  t.s.chain_step = R * H;
  return t;
}

// The VJP of one accepted step for a tile of R rows. On entry t.s.hpre holds
// h W1h for the tile's rows (h is constant over the step), ks[0] = f0 and
// gk[j] stage j's initial cotangent (stage_cot) in the CTA's scratch ([7][R]
// [DA] each, the per-element mapping: element m of a thread is row wp + 8 m,
// column lane, and only that thread touches it); x0 and gy (= g_y0_direct)
// the thread's elements. The forward stages 1-5 keep their k (k7 feeds no
// stage input); then for stages 6 -> 1 the stage is recomputed from its
// input and its VJP runs: gk_j += h a_ij gx_i, gy += gx_i. On return gy =
// gy0, gk[0] = gf0 and t.ghp the step's sum of the h-row pre-activation's
// cotangent. The time rows are w.tf (7, H); their gradients go to slab +
// gtf0 + st H.
template <int R>
__device__ void step_vjp_f32(const Weights& w, const F32Vjp& t,
                             const SlabLayout& L, float* slab, long gtf0,
                             float hs, float* ks, float* gk,
                             const float (&x0)[R * DA / kThreads],
                             float (&gy)[R * DA / kThreads]) {
  constexpr int M = R * DA / kThreads;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < R * H; i += kThreads) t.ghp[i] = 0.f;
  // the stage input of stage st, x0 + sum_j (h a_st,j) k_j, into feats
  auto stage_input = [&](int st) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int o = (wp + kWarps * m) * DA + lane;
      float y = x0[m];
      for (int j = 0; j < st; ++j) {
        const float a = cA[st][j];
        if (a != 0.f)
          y = __fadd_rn(y, __fmul_rn(__fmul_rn(hs, a), ks[j * R * DA + o]));
      }
      t.s.feats[(wp + kWarps * m) * DF + lane] = y;
    }
  };
  for (int st = 1; st < 6; ++st) {
    stage_input(st);
    stage_forward<R, kVjpKC>(w, t.s, st, t.gks);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int o = (wp + kWarps * m) * DA + lane;
      ks[st * R * DA + o] = t.gks[o];
    }
  }
  for (int st = 6; st >= 1; --st) {
    stage_input(st);
    stage_forward<R, kVjpKC>(w, t.s, st, t.gks);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int o = (wp + kWarps * m) * DA + lane;
      t.gks[o] = gk[st * R * DA + o];
    }
    stage_backward<R, kVjpKC>(w, t.s, L, slab, gtf0 + (long)st * H, t.gks, t.gp,
                      t.ta, t.tb, t.ghp, t.gks);
    // gx (in gks, the per-element mapping): into y0 and the earlier k_j
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int o = (wp + kWarps * m) * DA + lane;
      const float gx = t.gks[o];
      gy[m] = __fadd_rn(gy[m], gx);
      for (int j = 0; j < st; ++j) {
        const float a = cA[st][j];
        if (a != 0.f)
          gk[j * R * DA + o] = __fadd_rn(gk[j * R * DA + o],
                                         __fmul_rn(__fmul_rn(hs, a), gx));
      }
    }
  }
}

// h W1h for the tile's rows (in hin) into t.s.hpre
template <int R>
__device__ __forceinline__ void f32_hpre(const Weights& w, const F32Vjp& t) {
  constexpr int RPT = R / kWarps;
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  mm<R, DC, H, kVjpKC>(t.hin, DC, w.w1h, H, t.s.wbuf,
                       [&](float (&acc)[RPT][4]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t.s.hpre[(wp + kWarps * i) * H + ocol<H>(lane, j)] = acc[i][j];
  });
}

// ---- the bf16 step VJP: K7 at precision "bf16", and K6's bf16 body ---------
//
// The stage math and its VJP are stage_sm90.cuh's (drift_stage.cuh's math,
// rounding point for rounding point, with every weight operand shared by the
// CTA's warps through a shared-memory ring). A tile is 16 W agent rows, warp
// w owns rows 16 w .. 16 w + 15 end to end; the warps walk the step's weight
// boxes in lockstep. Each warp keeps its rows' float32 step state in
// fragment order (frag_ld / frag_st) in a scratch of its own in device
// memory, FX floats an array: 0 x0 | 1-6 k_1 .. k_6, each slot taking stage
// i's gx once stage i + 1 no longer reads its k (slot i - 1 takes gx_i) | 7
// g_dy | 8 g_r5 | 9 g_k1x | 10 g_k7x | 11 gy (g_y0_direct in, gy0 out) | 12
// gf0 | 13 K6's gh carry | then the step's per-row sum of the h-row
// pre-activation's cotangent ([H/2][32]). Only the owning lane touches a
// slot: no barrier guards them. A stage reads each array at most once,
// coalesced (a lane's 16 floats of an array are 16 strided words).

constexpr int kFX = (DA / 8) * 4 * 32;        // floats of one array
constexpr int kGhp = 14 * kFX;                // offset of the ghp sum
constexpr int kWarpFloats = kGhp + (H / 8) * 4 * 32;
static_assert(DC == DA, "the gh carry takes one DA-wide array");

using ananke::bf16;
using ananke::StageSmem;
using ananke::StageWeights;
using BLayout = ananke::Layout<DA, DZ, DC, H>;
using HLayout = ananke::sm90::Layout<DA, DZ, DC, H>;
template <int W>
using HRing = ananke::sm90::Ring<DA, DZ, DC, H, W>;

// warps of the bf16 step VJP's tile: the most whose rows fit the SM's
// shared memory beside the ring (HLayout::bytes): 6 (96 rows) up to 2
// blocks, 4 up to 5, 2 beyond
inline int vjp_bf16_warps(int nb) { return nb <= 2 ? 6 : nb <= 5 ? 4 : 2; }
// warps of K5-bf16's tile (drift_stage.cuh's forward): 4, 2 at 8 blocks
inline int k5_bf16_warps(int nb) { return nb <= 7 ? 4 : 2; }

// xa = bf16(x0 + sum_j (h a_st,j) k_j), summed in the tableau's order
__device__ __forceinline__ void bf16_stage_input(uint32_t (&xa)[DA / 16][4],
                                                 const float* fr, int st,
                                                 float hs, int lane) {
  float xin[DA / 8][4];
  ananke::frag_ld<DA / 8>(xin, fr, lane);
  for (int j = 0; j < st; ++j) {
    const float a = cA[st][j];
    if (a == 0.f) continue;
    const float ha = __fmul_rn(hs, a);
    float k[DA / 8][4];
    ananke::frag_ld<DA / 8>(k, fr + (1 + j) * kFX, lane);
#pragma unroll
    for (int q = 0; q < DA / 8; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        xin[q][c] = __fadd_rn(xin[q][c], __fmul_rn(ha, k[q][c]));
  }
  ananke::c_to_a<DA>(xin, xa);
}

// stage st's cotangent: stage_cot, then h a_i,st gx_i for i = 6 .. st + 1 in
// the order the reference adds them (gx_i in slot i - 1)
__device__ __forceinline__ void bf16_stage_cot(float (&gk)[DA / 8][4],
                                               const float* fr, int st,
                                               float hs, int lane) {
#pragma unroll
  for (int q = 0; q < DA / 8; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i0 = (4 * q + c) * 32 + lane;
      const Gset gs = {fr[7 * kFX + i0], fr[8 * kFX + i0], fr[9 * kFX + i0],
                       fr[10 * kFX + i0], 0.f};
      float v = stage_cot(st, hs, gs);
      for (int i = 6; i > st; --i) {
        const float a = cA[i][st];
        if (a != 0.f)
          v = __fadd_rn(v, __fmul_rn(__fmul_rn(hs, a), fr[i * kFX + i0]));
      }
      gk[q][c] = v;
    }
}

// bf16(h) of the warp's rows ra, rb (rows past n read as zeros) into the
// tile's hb rows in shared memory, where every stage reads it; the tile's
// previous reader ended on a block barrier
template <int W>
__device__ __forceinline__ void stage_h_rows(const float* h, long ra, long rb,
                                             bool va, bool vb, int warp,
                                             int lane) {
  uint32_t ha[DC / 16][4];
  ananke::ldg_rows_a<DC>(ha, h, ra, rb, va, vb, lane & 3);
  ananke::sts_a<DC>(ha, ananke::sm90::Smem<DA, DZ, DC, H, W>::hb() +
                            warp * 16 * HLayout::SS,
                    HLayout::SS, lane >> 2, lane & 3);
}

// The VJP of one accepted step for the warp's 16 rows (fr: the warp's
// scratch, its step inputs in place; bf16(h) in the tile's hb rows; tf: the
// step's 7 time rows), then the step's h rows: gh = bf16(ghp) @ W1h^T into
// slot 13 (added to the slot's carry where carry_gh) and gW1h into the slab
// (tf_rows time rows, the step's from gtf0 on: stage st's at gtf0 + st H).
// Leaves gy0 in slot 11 and gf0 in 12. Consumes one period of the ring's
// schedule, c0 (mod kSlots) boxes consumed before it. A call of its own,
// one a step, whose arguments are scalars and pointers: its callers
// recompute their row state after it rather than hold it across. Every
// thread of the CTA calls it.
template <int W>
__device__ __noinline__ void step_vjp_bf16(const StageWeights& w, int c0,
                                           float* fr, const float* tf,
                                           float hs, float* slab, int tf_rows,
                                           long gtf0, bool carry_gh, int warp,
                                           int lane) {
  constexpr int NX = DA / 8;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  HRing<W> ring = HRing<W>::at_step(c0);
  float* ghp = fr + kGhp;
  for (int i = 0; i < (H / 8) * 4; ++i) ghp[i * 32 + lane] = 0.f;
  for (int st = 1; st < 6; ++st) {
    uint32_t xa[DA / 16][4];
    bf16_stage_input(xa, fr, st, hs, lane);
    float k[NX][4], ia, ib;
    ananke::sm90::stage_forward<DA, DZ, DC, H, W>(w, ring, xa, tf + st * H,
                                                  k, ia, ib, wr0, g, t);
    ananke::frag_st<NX>(k, fr + (1 + st) * kFX, lane);
  }
  for (int st = 6; st >= 1; --st) {
    uint32_t xa[DA / 16][4];
    bf16_stage_input(xa, fr, st, hs, lane);
    float k[NX][4], ia, ib;
    ananke::sm90::stage_forward<DA, DZ, DC, H, W>(w, ring, xa, tf + st * H,
                                                  k, ia, ib, wr0, g, t);
    float gk[NX][4];
    bf16_stage_cot(gk, fr, st, hs, lane);
    // gx_st goes to slot st (k_st's, read by no later stage)
    ananke::sm90::stage_backward<DA, DZ, DC, H, W>(
        w, ring, gk, ia, ib, slab, tf_rows, gtf0 + (long)st * H,
        fr + st * kFX, ghp, warp, lane);
    float gy[NX][4], gx[NX][4];
    ananke::frag_ld<NX>(gy, fr + 11 * kFX, lane);
    ananke::frag_ld<NX>(gx, fr + st * kFX, lane);
#pragma unroll
    for (int q = 0; q < NX; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) gy[q][c] = __fadd_rn(gy[q][c], gx[q][c]);
    ananke::frag_st<NX>(gy, fr + 11 * kFX, lane);
  }
  float gf[NX][4];
  bf16_stage_cot(gf, fr, 0, hs, lane);
  ananke::frag_st<NX>(gf, fr + 12 * kFX, lane);
  // hpre = bf16(h) @ W1h: gh = bf16(ghp) @ W1h^T, gW1h += bf16(h)^T bf16(ghp)
  float ghh[DC / 8][4];
  ananke::sm90::h_rows<DA, DZ, DC, H, W>(w, ring, ghp, slab, tf_rows, ghh,
                                         warp, lane);
  if (carry_gh) {
    float acc[DC / 8][4];
    ananke::frag_ld<DC / 8>(acc, fr + 13 * kFX, lane);
#pragma unroll
    for (int q = 0; q < DC / 8; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) ghh[q][c] = __fadd_rn(acc[q][c], ghh[q][c]);
  }
  ananke::frag_st<DC / 8>(ghh, fr + 13 * kFX, lane);
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
__global__ void __launch_bounds__(kThreads, 1)
    dopri5_vjp_kernel(const VjpParams p) {
  constexpr int M = R * DA / kThreads;
  constexpr int RPT = R / kWarps;
  extern __shared__ __align__(16) float sm[];
  const F32Vjp t = f32_vjp_smem<R>(sm);
  const int wp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float hs = p.hstep;
  const SlabLayout L(p.w.z, p.w.nb, 7);
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  float* ks = p.scratch + (size_t)blockIdx.x * 14 * R * DA;  // [7][R][DA]
  float* gk = ks + 7 * R * DA;                                // [7][R][DA]
  const int n_tiles = (p.n + R - 1) / R;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * R;
    __syncthreads();
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
      t.hin[r * DC + lane] = v ? p.h[g * DC + lane] : 0.f;
      const Gset c = {v ? p.gdy[go] : 0.f, v ? p.gr5[go] : 0.f,
                      v ? p.gk1[go] : 0.f, v ? p.gk7[go] : 0.f, 0.f};
      for (int j = 0; j < 7; ++j) gk[j * R * DA + o] = stage_cot(j, hs, c);
      gy[m] = v ? p.gy0d[go] : 0.f;
    }
    f32_hpre<R>(p.w, t);
    step_vjp_f32<R>(p.w, t, L, slab, L.gtf, hs, ks, gk, x0, gy);
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
    ntdot<R, DC, H, false>(t.hin, DC, t.ghp, H, nullptr, 0, nullptr, 0,
                           slab + L.gw1h, DC);
    mm<R, H, DC, kVjpKC>(t.ghp, H, p.w.w1hT, DC, t.s.wbuf,
                         [&](float (&acc)[RPT][1]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const long g = row0 + wp + kWarps * i;
        if (g < p.n) p.gh[g * DC + lane] = acc[i][0];
      }
    });
  }
}

struct VjpBf16Params {
  StageWeights w;
  const float* tf;   // (7, H)
  const float* x;    // (n, DA)
  const float* f0;
  const float* h;    // (n, DC)
  const float* gdy;  // (n, DA) the folded output cotangents
  const float* gr5;
  const float* gk1;
  const float* gk7;
  const float* gy0d;
  float* gy0;        // (n, DA)
  float* gf0;
  float* gh;         // (n, DC)
  float* scratch;    // (gridDim.x, W, kWarpFloats)
  float* slab;       // (gridDim.x, slab size), zeroed by the caller
  long slab_size;
  int n;
  float hstep;
};

// the rows of a warp of a bf16 tile (from row0 on; rows past n read as
// zeros), its scratch and its fragment mapping: element 4 q + c of a lane
// is row g + 8 (c >> 1) of the warp's 16, column 8 q + 2 t + (c & 1)
template <int W>
struct Bf16Rows {
  static constexpr int kElems = (DA / 8) * 4;
  int warp, lane, t;
  long ra, rb;
  bool va, vb;
  float* fr;

  __device__ Bf16Rows(long row0, int n, float* scratch) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    t = lane & 3;
    ra = row0 + warp * 16 + (lane >> 2);
    rb = ra + 8;
    va = ra < n;
    vb = rb < n;
    fr = scratch + ((size_t)blockIdx.x * W + warp) * kWarpFloats;
  }
  __device__ bool elem(int e, long& row, int& col) const {
    const int c = e & 3;
    row = (c & 2) ? rb : ra;
    col = 8 * (e >> 2) + 2 * t + (c & 1);
    return (c & 2) ? vb : va;
  }
  __device__ float carry_y(int e) const { return fr[11 * kFX + e * 32 + lane]; }
  __device__ float carry_f(int e) const { return fr[12 * kFX + e * 32 + lane]; }
  __device__ void set_step_input(int e, float x, float f0, const Gset& c,
                                 float) {
    const int i0 = e * 32 + lane;
    fr[i0] = x;
    fr[kFX + i0] = f0;
    fr[7 * kFX + i0] = c.dy;
    fr[8 * kFX + i0] = c.r5;
    fr[9 * kFX + i0] = c.k1x;
    fr[10 * kFX + i0] = c.k7x;
    fr[11 * kFX + i0] = c.y0d;
  }
};

template <int W>
__global__ void __launch_bounds__(32 * W, 1)
    dopri5_vjp_bf16_kernel(const VjpBf16Params p) {
  constexpr int ROWS = 16 * W, NX = DA / 8;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;
  const int period = HRing<W>::period(p.w);
  HRing<W>().prime(p.w);
  int c0 = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    {  // the tile's step inputs into the warps' scratch
      const Bf16Rows<W> r((long)tile * ROWS, p.n, p.scratch);
      stage_h_rows<W>(p.h, r.ra, r.rb, r.va, r.vb, r.warp, r.lane);
      const float* in[7] = {p.x, p.f0, p.gdy, p.gr5, p.gk1, p.gk7, p.gy0d};
      const int slot[7] = {0, 1, 7, 8, 9, 10, 11};
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        float v[NX][4];
        ananke::ldg_rows_c<NX>(v, in[i], r.ra, r.rb, r.va, r.vb, r.t);
        ananke::frag_st<NX>(v, r.fr + slot[i] * kFX, r.lane);
      }
    }
    {
      const Bf16Rows<W> r((long)tile * ROWS, p.n, p.scratch);
      step_vjp_bf16<W>(p.w, c0, r.fr, p.tf, p.hstep,
                       p.slab + (size_t)blockIdx.x * p.slab_size, 7,
                       (long)p.w.z * DZ, false, r.warp, r.lane);
    }
    c0 = (c0 + period) % HLayout::kSlots;
    const Bf16Rows<W> r((long)tile * ROWS, p.n, p.scratch);
    float v[NX][4];
    ananke::frag_ld<NX>(v, r.fr + 11 * kFX, r.lane);
    ananke::stg_rows_c<NX>(v, p.gy0, r.ra, r.rb, r.va, r.vb, r.t);
    ananke::frag_ld<NX>(v, r.fr + 12 * kFX, r.lane);
    ananke::stg_rows_c<NX>(v, p.gf0, r.ra, r.rb, r.va, r.vb, r.t);
    ananke::frag_ld<NX>(v, r.fr + 13 * kFX, r.lane);
    ananke::stg_rows_c<DC / 8>(v, p.gh, r.ra, r.rb, r.va, r.vb, r.t);
  }
  HRing<W>::drain();
}

// ---- K5 at bf16 -------------------------------------------------------------
//
// The step of K5 with the bf16 stage math of drift_stage.cuh (the reference's
// precision="bf16": every stage activation and weight narrowed to bf16,
// float32 sums), the tableau, y1, f1, err (or its masked sum of scaled
// squares) and r5 in float32 as K5's float32 body forms them. A tile is 16 W
// rows, warp w owns rows 16 w .. 16 w + 15 end to end, as the bf16 step
// VJP's tiles: the stage inputs are bf16_stage_input's, each stage is
// stage_forward, and the warp keeps its rows' step state in shared memory in
// fragment order, kStepFr floats: 0 x0 | 1-7 k_1 .. k_7. No block barrier
// but the CTA's error sum at the end.

constexpr int kStepFr = 8 * kFX;  // floats of a warp's step state

struct StepBf16Params {
  StageWeights w;
  const float* tf;  // (7, H)
  const float* x;   // (n, DA)
  const float* f0;  // (n, DA)
  const float* h;   // (n, DC)
  float* y1;        // (n, DA)
  float* f1;        // (n, DA)
  float* err;       // (n, DA), unless err_stats
  float* r5;        // (n, DA)
  float* partial;   // (gridDim.x): each CTA's sum of scaled squares
  size_t state_off; // bytes of shared memory before the warps' step states
  int n, err_stats;
  float hstep, rtol, atol;
};

// bytes of K5-bf16's shared memory: the stage forward's buffers, then the
// warps' step states
inline size_t step_bf16_smem(int W, int nb) {
  return BLayout::bytes_forward(16 * W, nb) +
         (size_t)W * kStepFr * sizeof(float);
}

template <int W>
__global__ void __launch_bounds__(32 * W, 1)
    dopri5_step_bf16_kernel(const StepBf16Params p) {
  constexpr int ROWS = 16 * W, NX = DA / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[32 * W];
  const StageSmem sm = ananke::stage_smem_forward<DA, DZ, DC, H, W>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  float* fr = reinterpret_cast<float*>(smem_raw + p.state_off) +
              (size_t)warp * kStepFr;
  const float hs = p.hstep;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;
  float sq = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long ra = (long)tile * ROWS + wr0 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;
    uint32_t ha[DC / 16][4];
    ananke::ldg_rows_a<DC>(ha, p.h, ra, rb, va, vb, t);
    float x0[NX][4], v[NX][4];
    ananke::ldg_rows_c<NX>(x0, p.x, ra, rb, va, vb, t);
    ananke::frag_st<NX>(x0, fr, lane);
    ananke::ldg_rows_c<NX>(v, p.f0, ra, rb, va, vb, t);
    ananke::frag_st<NX>(v, fr + kFX, lane);
    for (int st = 1; st < 7; ++st) {
      uint32_t xa[DA / 16][4];
      bf16_stage_input(xa, fr, st, hs, lane);
      float k[NX][4], ia, ib;
      ananke::stage_forward<DA, DZ, DC, H, W>(p.w, sm, xa, ha, p.tf + st * H,
                                              k, ia, ib, wr0, g, t);
      ananke::frag_st<NX>(k, fr + (1 + st) * kFX, lane);
    }
    // the tableau in the reference's order, each operation rounded alone
    float inc[NX][4], e[NX][4], d[NX][4];
    ananke::zero(inc);
    ananke::zero(e);
    ananke::zero(d);
    for (int j = 0; j < 7; ++j) {
      ananke::frag_ld<NX>(v, fr + (1 + j) * kFX, lane);
#pragma unroll
      for (int q = 0; q < NX; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cB5[j] != 0.f)
            inc[q][c] = __fadd_rn(inc[q][c], __fmul_rn(cB5[j], v[q][c]));
          if (cBE[j] != 0.f)
            e[q][c] = __fadd_rn(e[q][c], __fmul_rn(cBE[j], v[q][c]));
          if (cD[j] != 0.f)
            d[q][c] = __fadd_rn(d[q][c], __fmul_rn(cD[j], v[q][c]));
        }
    }
    // v holds k_7 = f1
#pragma unroll
    for (int q = 0; q < NX; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        inc[q][c] = __fadd_rn(x0[q][c], __fmul_rn(hs, inc[q][c]));  // y1
        e[q][c] = __fmul_rn(hs, e[q][c]);
        d[q][c] = __fmul_rn(hs, d[q][c]);                            // r5
      }
    ananke::stg_rows_c<NX>(inc, p.y1, ra, rb, va, vb, t);
    ananke::stg_rows_c<NX>(v, p.f1, ra, rb, va, vb, t);
    ananke::stg_rows_c<NX>(d, p.r5, ra, rb, va, vb, t);
    if (p.err_stats) {
#pragma unroll
      for (int q = 0; q < NX; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // elements 0, 1 of a fragment are row ra's, 2, 3 row rb's
          if (c < 2 ? va : vb) {
            const float esc = __fdiv_rn(
                e[q][c],
                __fadd_rn(p.atol,
                          __fmul_rn(p.rtol, fmaxf(fabsf(x0[q][c]),
                                                  fabsf(inc[q][c])))));
            sq = __fadd_rn(sq, __fmul_rn(esc, esc));
          }
        }
    } else {
      ananke::stg_rows_c<NX>(e, p.err, ra, rb, va, vb, t);
    }
  }
  // the CTA's sum, in a fixed order
  red[threadIdx.x] = sq;
  __syncthreads();
  for (int m = 16 * W; m >= 1; m >>= 1) {
    if (threadIdx.x < m) red[threadIdx.x] += red[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) p.partial[blockIdx.x] = red[0];
}

// ---- K6 -------------------------------------------------------------------
//
// One CTA owns an agent tile for every step: the TPU grid's sequential step
// axis is the loop inside the block (the agents of a tile never interact in
// the backward, so no grid-wide sync), the carries g_y, g_f (and, at bf16,
// gh) never leave the chip between steps but through the CTA's own
// scratch, the dense-output fold runs in the kernel from shared memory (the
// rows a step did not fill are skipped), and every step's weight, zone and
// time-row gradients go into the CTA's slab (time rows at slot 7 s + st),
// summed over the CTAs in CTA order afterwards. The step body is a template
// parameter: the float32 one (step_vjp_f32) or the bf16 one
// (step_vjp_bf16). The checkpoints' storage type (float32 or bf16) is a
// launch parameter, widened as read.

template <class Wt>
struct BwdParams {
  Wt w;
  const float* tf;        // (n_acc, 7, H): each step's stage time rows
  const void* ckpts;      // (max_acc, n, DA), CkptT
  const void* ckpt_f;     // (max_acc, n, DA), CkptT
  const float* g;         // (T, n, DA) the output rows' cotangents
  const float* hc;        // (n, DC)
  const float* steps;     // rec_t0 (n_acc) | rec_h (n_acc) | ts (T)
  const int* out_step;    // (T): the step that filled each row, or -1
  float* gy0;             // (n, DA)
  float* gf0;             // (n, DA)
  float* gh;              // (n, DC)
  float* scratch;         // the tile bodies' per-CTA scratch
  float* slab;            // (gridDim.x, slab size), zeroed by the caller
  long slab_size;
  size_t body_smem;       // bytes of the body's shared memory
  int n, n_acc, T;
  int ckpt_bf16;          // the checkpoints' storage: bf16, else float32
};

// element i of a checkpoint buffer, widened from its storage type
__device__ __forceinline__ float widen(const void* p, size_t i, bool b16) {
  return b16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

// K6's fold of step s: each of the thread's elements (rows, its body's
// elem mapping) gets its checkpoint, FSAL eval and the step's cotangents,
// folded from the body's carries and the output rows the step filled
// (CONTD5 weights; tss, ost: the output times and the rows' steps in
// shared memory)
template <class Rows, class Params>
__device__ __forceinline__ void fold_step(Rows& rows, const Params& p, int s,
                                          const float* tss, const int* ost) {
  const float hs = p.steps[p.n_acc + s], t0 = p.steps[s];
  const bool b16 = p.ckpt_bf16;
  const size_t plane = (size_t)s * p.n * DA;
#pragma unroll
  for (int e = 0; e < Rows::kElems; ++e) {
    long row;
    int col;
    const bool v = rows.elem(e, row, col);
    float gr[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < p.T; ++r) {
      if (ost[r] != s) continue;
      float w[5];
      contd5_weights(tss[r], t0, hs, w);
      const float gv = v ? p.g[((size_t)r * p.n + row) * DA + col] : 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        gr[k] = __fadd_rn(gr[k], __fmul_rn(w[k], gv));
    }
    const size_t i = plane + (size_t)row * DA + col;
    rows.set_step_input(e, v ? widen(p.ckpts, i, b16) : 0.f,
                        v ? widen(p.ckpt_f, i, b16) : 0.f,
                        fold_gset(rows.carry_y(e), rows.carry_f(e), gr, hs),
                        hs);
  }
}

// K6's float32 body: tiles of R rows, 8 warps, the per-element mapping
template <int R>
struct F32Body {
  static constexpr int kThreadsPerCta = kThreads;
  static constexpr int kRows = R;
  static constexpr int kElems = R * DA / kThreads;
  static constexpr int RPT = R / kWarps;
  using Params = BwdParams<Weights>;
  static size_t smem_bytes(int nb) {
    return f32_vjp_smem_floats<R>(nb) * sizeof(float);
  }

  const Params& p;
  F32Vjp t;
  SlabLayout L;
  float *slab, *ks, *gk;
  int wp, lane;
  long row0;
  float x0[kElems], gy[kElems], cy[kElems], cf[kElems], ghc[RPT];

  __device__ F32Body(const Params& p_, unsigned char* raw)
      : p(p_), L(p_.w.z, p_.w.nb, 7 * p_.n_acc) {
    t = f32_vjp_smem<R>(reinterpret_cast<float*>(raw));
    slab = p.slab + (size_t)blockIdx.x * p.slab_size;
    ks = p.scratch + (size_t)blockIdx.x * 14 * R * DA;
    gk = ks + 7 * R * DA;
    wp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
  }
  __device__ bool elem(int e, long& row, int& col) const {
    row = row0 + wp + kWarps * e;
    col = lane;
    return row < p.n;
  }
  __device__ float carry_y(int e) const { return cy[e]; }
  __device__ float carry_f(int e) const { return cf[e]; }
  __device__ void begin_tile(int tile) {
    row0 = (long)tile * R;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int r = wp + kWarps * e;
      const long g = row0 + r;
      t.hin[r * DC + lane] = g < p.n ? p.hc[g * DC + lane] : 0.f;
      cy[e] = cf[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) ghc[i] = 0.f;
    f32_hpre<R>(p.w, t);
  }
  __device__ void set_step_input(int e, float x, float f0, const Gset& c,
                                 float hs) {
    const int o = (wp + kWarps * e) * DA + lane;
    x0[e] = x;
    ks[o] = f0;
    for (int j = 0; j < 7; ++j) gk[j * R * DA + o] = stage_cot(j, hs, c);
    gy[e] = c.y0d;
  }
  __device__ void step(int s, const float* tss, const int* ost) {
    fold_step(*this, p, s, tss, ost);
    const float hs = p.steps[p.n_acc + s];
    Weights ws = p.w;
    ws.tf = p.tf + (size_t)7 * s * H;
    step_vjp_f32<R>(ws, t, L, slab, L.gtf + (long)7 * s * H, hs, ks, gk, x0,
                    gy);
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      cy[e] = gy[e];
      cf[e] = gk[(wp + kWarps * e) * DA + lane];
    }
    // hpre = h W1h: gh += ghp W1h^T, gW1h += h^T ghp, once a step
    ntdot<R, DC, H, false>(t.hin, DC, t.ghp, H, nullptr, 0, nullptr, 0,
                           slab + L.gw1h, DC);
    mm<R, H, DC, kVjpKC>(t.ghp, H, p.w.w1hT, DC, t.s.wbuf,
                         [&](float (&acc)[RPT][1]) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) ghc[i] = __fadd_rn(ghc[i], acc[i][0]);
    });
  }
  __device__ void end_tile() {
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      long g;
      int c;
      if (elem(e, g, c)) {
        p.gy0[g * DA + c] = cy[e];
        p.gf0[g * DA + c] = cf[e];
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long g = row0 + wp + kWarps * i;
      if (g < p.n) p.gh[g * DC + lane] = ghc[i];
    }
  }  __device__ void finish() {}
};

// K6's bf16 body: tiles of 16 W rows
template <int W>
struct Bf16Body {
  static constexpr int kThreadsPerCta = 32 * W;
  static constexpr int kRows = 16 * W;
  using Params = BwdParams<StageWeights>;
  static size_t smem_bytes(int nb) { return HLayout::bytes(kRows, W, nb); }

  const Params& p;
  int c0 = 0, period;  // the ring's boxes consumed (mod kSlots); a step's
  long row0 = 0;

  __device__ Bf16Body(const Params& p_, unsigned char*) : p(p_) {
    period = HRing<W>::period(p.w);
    HRing<W>().prime(p.w);
  }
  __device__ void begin_tile(int tile) {
    row0 = (long)tile * kRows;
    const Bf16Rows<W> r(row0, p.n, p.scratch);
    stage_h_rows<W>(p.hc, r.ra, r.rb, r.va, r.vb, r.warp, r.lane);
    for (int i = 0; i < Bf16Rows<W>::kElems; ++i)
      r.fr[11 * kFX + i * 32 + r.lane] = r.fr[12 * kFX + i * 32 + r.lane] =
          r.fr[13 * kFX + i * 32 + r.lane] = 0.f;
  }
  // the fold of step s, then its VJP (the row state recomputed, not held
  // across the call)
  __device__ void step(int s, const float* tss, const int* ost) {
    {
      Bf16Rows<W> r(row0, p.n, p.scratch);
      fold_step(r, p, s, tss, ost);
    }
    const Bf16Rows<W> r(row0, p.n, p.scratch);
    step_vjp_bf16<W>(p.w, c0, r.fr, p.tf + (size_t)7 * s * H,
                     p.steps[p.n_acc + s],
                     p.slab + (size_t)blockIdx.x * p.slab_size, 7 * p.n_acc,
                     (long)p.w.z * DZ + (long)7 * s * H, true, r.warp,
                     r.lane);
    c0 = (c0 + period) % HLayout::kSlots;
  }
  __device__ void end_tile() {
    const Bf16Rows<W> r(row0, p.n, p.scratch);
    float v[DA / 8][4];
    ananke::frag_ld<DA / 8>(v, r.fr + 11 * kFX, r.lane);
    ananke::stg_rows_c<DA / 8>(v, p.gy0, r.ra, r.rb, r.va, r.vb, r.t);
    ananke::frag_ld<DA / 8>(v, r.fr + 12 * kFX, r.lane);
    ananke::stg_rows_c<DA / 8>(v, p.gf0, r.ra, r.rb, r.va, r.vb, r.t);
    ananke::frag_ld<DA / 8>(v, r.fr + 13 * kFX, r.lane);
    ananke::stg_rows_c<DC / 8>(v, p.gh, r.ra, r.rb, r.va, r.vb, r.t);
  }
  __device__ void finish() { HRing<W>::drain(); }
};

// bytes of shared memory K6 adds to its body's: the output times and the
// rows' steps (the recorded steps' starts and sizes are read from device
// memory, one uniform load each a step)
inline size_t bwd_extra_bytes(int T) { return (size_t)2 * T * sizeof(float); }

template <class Body>
__global__ void __launch_bounds__(Body::kThreadsPerCta, 1)
    dopri5_backward_kernel(const typename Body::Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Body body(p, smem_raw);
  float* tss = reinterpret_cast<float*>(smem_raw + p.body_smem);
  int* ost = reinterpret_cast<int*>(tss + p.T);
  for (int i = threadIdx.x; i < p.T; i += blockDim.x) {
    tss[i] = p.steps[2 * p.n_acc + i];
    ost[i] = p.out_step[i];
  }
  __syncthreads();
  const int n_tiles = (p.n + Body::kRows - 1) / Body::kRows;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    body.begin_tile(tile);
    for (int s = p.n_acc - 1; s >= 0; --s) body.step(s, tss, ost);
    body.end_tile();
  }
  body.finish();
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

void set_weights_bf16(StageWeights& w, const void* const* p, const void* ze,
                      const void* zeT, int z, int zp, int nb) {
  ananke::set_weights(w, p);
  w.ze = static_cast<const bf16*>(ze);
  w.zeT = static_cast<const bf16*>(zeT);
  w.z = z; w.zp = zp; w.num_blocks = nb;
}

// the largest dynamic shared memory a block can use
constexpr size_t kMaxSmem = 232448;

template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int R>
int launch_vjp(const VjpParams& p, int num_ctas, cudaStream_t s) {
  auto* kernel = dopri5_vjp_kernel<R>;
  const size_t bytes = f32_vjp_smem_floats<R>(p.w.nb) * sizeof(float);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<num_ctas, kThreads, bytes, s>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  return ananke::launch_reduce_slabs(
      p.slab, p.slab + (size_t)num_ctas * p.slab_size, p.slab_size, num_ctas,
      s);
}

template <int W>
int launch_vjp_bf16(const VjpBf16Params& p, int num_ctas, cudaStream_t s) {
  auto* kernel = dopri5_vjp_bf16_kernel<W>;
  const size_t bytes = HLayout::bytes(16 * W, W, p.w.num_blocks);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<num_ctas, 32 * W, bytes, s>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  return ananke::launch_reduce_slabs(
      p.slab, p.slab + (size_t)num_ctas * p.slab_size, p.slab_size, num_ctas,
      s);
}

template <int W>
int launch_step_bf16(StepBf16Params p, int num_ctas, cudaStream_t s) {
  auto* kernel = dopri5_step_bf16_kernel<W>;
  const size_t bytes = step_bf16_smem(W, p.w.num_blocks);
  p.state_off = BLayout::bytes_forward(16 * W, p.w.num_blocks);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<num_ctas, 32 * W, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <class Body>
int launch_backward(typename Body::Params p, int nb, int num_ctas,
                    cudaStream_t s) {
  auto* kernel = dopri5_backward_kernel<Body>;
  p.body_smem = Body::smem_bytes(nb);
  const size_t bytes = p.body_smem + bwd_extra_bytes(p.T);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  kernel<<<num_ctas, Body::kThreadsPerCta, bytes, s>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  return ananke::launch_reduce_slabs(
      p.slab, p.slab + (size_t)num_ctas * p.slab_size, p.slab_size, num_ctas,
      s);
}

template <class Wt>
void set_bwd_params(BwdParams<Wt>& p, const void* ckpts, const void* ckpt_f,
                    const void* g, const void* hc, const void* tf,
                    const void* steps, const void* out_step, void* gy0,
                    void* gf0, void* gh, void* scratch, void* slab,
                    long slab_size, int n, int n_acc, int T) {
  p.tf = static_cast<const float*>(tf);
  p.ckpts = ckpts;
  p.ckpt_f = ckpt_f;
  p.g = static_cast<const float*>(g);
  p.hc = static_cast<const float*>(hc);
  p.steps = static_cast<const float*>(steps);
  p.out_step = static_cast<const int*>(out_step);
  p.gy0 = static_cast<float*>(gy0);
  p.gf0 = static_cast<float*>(gf0);
  p.gh = static_cast<float*>(gh);
  p.scratch = static_cast<float*>(scratch);
  p.slab = static_cast<float*>(slab);
  p.slab_size = slab_size;
  p.n = n;
  p.n_acc = n_acc;
  p.T = T;
}

}  // namespace

extern "C" {

// Agent rows per tile of a kernel's body: kind 0 K5 (128), kind 1 the
// float32 step VJP (32 up to 4 residual blocks, 16 beyond: its chain of
// block activations must fit in shared memory), kind 2 the bf16 step VJP
// (96 up to 2 blocks, 64 up to 5, 32 beyond: vjp_bf16_warps) and kind 3 K5
// at bf16 (64, or 32 at 8 blocks).
int ananke_dopri5_tile_rows(int num_blocks, int kind) {
  if (kind == 2) return 16 * vjp_bf16_warps(num_blocks);
  if (kind == 3) return 16 * k5_bf16_warps(num_blocks);
  if (kind == 0) return k5::kRows;
  return kind == 1 && num_blocks > 4 ? 16 : 32;
}

// Floats of one CTA's scratch in device memory of K5 (kind 0) or a
// step-VJP body (kind 1 or 2, as ananke_dopri5_tile_rows).
long ananke_dopri5_scratch_floats(int num_blocks, int kind) {
  if (kind == 0) return (long)k5::kW * k5::kState;
  if (kind == 2) return (long)vjp_bf16_warps(num_blocks) * kWarpFloats;
  return 14L * ananke_dopri5_tile_rows(num_blocks, 1) * DA;
}

// Floats of one CTA's slab with `tf_rows` time rows (K7 7, K6 7 n_acc).
long ananke_dopri5_slab_size(int z, int num_blocks, int tf_rows) {
  return SlabLayout(z, num_blocks, tf_rows).size;
}

// K5 on `stream`: the step kernel, then the sum of the CTAs' partial error
// sums into err_sum (1 float). `partial` holds num_ctas + 32 +
// num_ctas x ananke_dopri5_scratch_floats(num_blocks, 0) floats: the CTAs'
// sums, then the step state's scratch; the kernel runs on at most 132 of
// the num_ctas CTAs (k5::kCtas). Returns cudaGetLastError() after the
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
  const int n_tiles = (n + k5::kRows - 1) / k5::kRows;
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
  p.scratch = p.partial + (num_ctas + 31) / 32 * 32;
  p.n = n;
  p.err_stats = err_stats;
  p.hstep = hstep;
  p.rtol = rtol;
  p.atol = atol;
  const int ctas = num_ctas < k5::kCtas ? num_ctas : k5::kCtas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = dopri5_step_kernel;
  int e = set_smem(kernel, k5::kSmemBytes);
  if (e) return e;
  kernel<<<ctas, 32 * k5::kW, k5::kSmemBytes, s>>>(p);
  e = (int)cudaGetLastError();
  if (e) return e;
  return ananke::launch_reduce_slabs(
      p.partial, static_cast<float*>(err_sum), 1, ctas, s);
}

// K5 at bf16 on `stream`: as ananke_dopri5_step, but the 12 bf16 weights
// of drift_stage.cuh's set_weights and zones padded to a multiple of 16
// (the order of the bf16 step VJP's operands), tiles of
// ananke_dopri5_tile_rows(num_blocks, 3) rows.
int ananke_dopri5_step_bf16(
    const void* x, const void* f0, const void* h, const void* ze,
    const void* zeT, const void* tf, const void* wqT, const void* wq,
    const void* w1xcT, const void* w1xc, const void* w1hT, const void* w1h,
    const void* wrT, const void* wr, const void* br, const void* w3T,
    const void* w3, const void* b3, void* y1, void* f1, void* err, void* r5,
    void* partial, void* err_sum, int n, int z, int zp, int num_blocks,
    int num_ctas, int err_stats, float hstep, float rtol, float atol, int da,
    int dz, int dc, int hdim, void* stream) {
  const int rows = ananke_dopri5_tile_rows(num_blocks, 3);
  const int n_tiles = (n + rows - 1) / rows;
  if (!widths_ok(da, dz, dc, hdim) || num_blocks < 1 ||
      num_blocks > kMaxBlocks || n < 1 || z < 1 || zp % 16 != 0 || zp < z ||
      num_ctas < 1 || num_ctas > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  StepBf16Params p;
  const void* wts[12] = {wqT, wq, w1xcT, w1xc, w1hT, w1h,
                         wrT, wr, br, w3T, w3, b3};
  set_weights_bf16(p.w, wts, ze, zeT, z, zp, num_blocks);
  p.tf = static_cast<const float*>(tf);
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
  const int e = k5_bf16_warps(num_blocks) == 4
                    ? launch_step_bf16<4>(p, num_ctas, s)
                    : launch_step_bf16<2>(p, num_ctas, s);
  if (e) return e;
  return ananke::launch_reduce_slabs(
      p.partial, static_cast<float*>(err_sum), 1, num_ctas, s);
}

// K7 on `stream` at float32 (bf16 = 0: the 12 float32 weights of
// set_weights, zones padded to a multiple of 32) or bf16 (bf16 = 1: the 12
// bf16 weights of drift_stage.cuh's set_weights, zones padded to a multiple
// of 16): the VJP kernel, then the slab reduction into the slab that
// follows the num_ctas slabs in `slab` (the caller zeroes the slabs).
int ananke_dopri5_step_vjp(
    const void* x, const void* f0, const void* h, const void* ze,
    const void* zeT, const void* tf, const void* w0, const void* w1,
    const void* w2, const void* w3, const void* w4, const void* w5,
    const void* w6, const void* w7, const void* w8, const void* w9,
    const void* w10, const void* w11, const void* gdy, const void* gr5,
    const void* gk1, const void* gk7, const void* gy0d, void* gy0, void* gf0,
    void* gh, void* scratch, void* slab, int n, int z, int zp,
    int num_blocks, int num_ctas, int bf16_body, float hstep, int da, int dz,
    int dc, int hdim, void* stream) {
  const int rows = ananke_dopri5_tile_rows(num_blocks, bf16_body ? 2 : 1);
  const int n_tiles = (n + rows - 1) / rows;
  if (!widths_ok(da, dz, dc, hdim) || num_blocks < 1 ||
      num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % (bf16_body ? 16 : kZC) != 0 || zp < z || num_ctas < 1 ||
      num_ctas > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const void* wts[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_body) {
    VjpBf16Params p;
    set_weights_bf16(p.w, wts, ze, zeT, z, zp, num_blocks);
    p.tf = static_cast<const float*>(tf);
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
    p.slab_size = SlabLayout(z, num_blocks, 7).size;
    p.n = n;
    p.hstep = hstep;
    switch (vjp_bf16_warps(num_blocks)) {
      case 6: return launch_vjp_bf16<6>(p, num_ctas, s);
      case 4: return launch_vjp_bf16<4>(p, num_ctas, s);
      default: return launch_vjp_bf16<2>(p, num_ctas, s);
    }
  }
  VjpParams p;
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
  p.slab_size = SlabLayout(z, num_blocks, 7).size;
  p.n = n;
  p.hstep = hstep;
  return rows == 32 ? launch_vjp<32>(p, num_ctas, s)
                    : launch_vjp<16>(p, num_ctas, s);
}

// K6 on `stream`: the whole backward over the n_acc recorded steps, then the
// slab reduction into the slab that follows the num_ctas slabs in `slab`
// (the caller zeroes the slabs; their time rows are 7 n_acc). Weights and
// zones as ananke_dopri5_step_vjp takes them at `bf16_body`; tf (n_acc, 7,
// H); steps rec_t0 (n_acc) | rec_h (n_acc) | ts (T); out_step (T) int32;
// the checkpoints float32, or bf16 where ckpt_bf16.
int ananke_dopri5_backward_all(
    const void* ckpts, const void* ckpt_f, const void* g, const void* hc,
    const void* ze, const void* zeT, const void* tf, const void* steps,
    const void* out_step, const void* w0, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* w5, const void* w6,
    const void* w7, const void* w8, const void* w9, const void* w10,
    const void* w11, void* gy0, void* gf0, void* gh, void* scratch,
    void* slab, int n, int z, int zp, int num_blocks, int num_ctas,
    int n_acc, int T, int bf16_body, int ckpt_bf16, int da, int dz, int dc,
    int hdim, void* stream) {
  const int rows = ananke_dopri5_tile_rows(num_blocks, bf16_body ? 2 : 1);
  const int n_tiles = (n + rows - 1) / rows;
  if (!widths_ok(da, dz, dc, hdim) || num_blocks < 1 ||
      num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % (bf16_body ? 16 : kZC) != 0 || zp < z || num_ctas < 1 ||
      num_ctas > n_tiles || n_acc < 1 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const void* wts[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  const long size = SlabLayout(z, num_blocks, 7 * n_acc).size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_body) {
    BwdParams<StageWeights> p;
    set_weights_bf16(p.w, wts, ze, zeT, z, zp, num_blocks);
    set_bwd_params(p, ckpts, ckpt_f, g, hc, tf, steps, out_step, gy0, gf0,
                   gh, scratch, slab, size, n, n_acc, T);
    p.ckpt_bf16 = ckpt_bf16;
    switch (vjp_bf16_warps(num_blocks)) {
      case 6: return launch_backward<Bf16Body<6>>(p, num_blocks, num_ctas, s);
      case 4: return launch_backward<Bf16Body<4>>(p, num_blocks, num_ctas, s);
      default: return launch_backward<Bf16Body<2>>(p, num_blocks, num_ctas, s);
    }
  }
  BwdParams<Weights> p;
  set_weights(p.w, wts, ze, zeT, tf, z, zp, num_blocks);
  set_bwd_params(p, ckpts, ckpt_f, g, hc, tf, steps, out_step, gy0, gf0, gh,
                 scratch, slab, size, n, n_acc, T);
  p.ckpt_bf16 = ckpt_bf16;
  return rows == 32 ? launch_backward<F32Body<32>>(p, num_blocks, num_ctas, s)
                    : launch_backward<F32Body<16>>(p, num_blocks, num_ctas, s);
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
