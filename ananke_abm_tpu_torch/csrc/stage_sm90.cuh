// One GAT-ODE drift evaluation ("stage") and its VJP for a CTA of W warps
// (16 W agent rows) whose warps share every weight operand through a ring
// of shared-memory slots: the Hopper stage of the discrete adjoint's bf16
// step body (fused_dopri5.cu: K6 at precision "bf16", and K7's bf16 branch,
// the same step VJP launched once), of the fixed-step training day's
// reverse sweep (fused_train.cu: K2b) and of the continuous adjoint's
// augmented right-hand side (fused_rhs.cu: K8). Each walks its own fixed
// schedule of weight boxes (StepSchedule, DaySchedule, RhsSchedule below).
//
// The math is the reference's, rounding point for rounding point
// (_stage_math / _stage_vjp_math in
// ananke_abm_tpu/ops/pallas/fused_step.py): bf16 operands, float32 sums,
// the max-free softmax clamped at 80 and normalised after the context
// product, the block inputs kept as bf16, the attention recomputed by
// 16-zone chunks in the VJP. What differs is where the operands live:
//
// - The per-warp stage this replaced (once in drift_stage.cuh) read every
//   mma's B fragments from the weights in device memory, warp by warp:
//   each 16-row warp streamed ~180 KB of bf16 weights through L2 for a
//   stage forward and about twice that for a VJP,
//   one dependent L2 load behind each mma. Here the step's products are one
//   fixed sequence of weight boxes (Ring below: each box one product's
//   weights, or half of them, or one 32-zone chunk of the zones and their
//   transpose), copied by cp.async into a ring of kSlots slots (prefetch
//   kSlots - 1 boxes ahead) and read by every warp of the CTA from shared
//   memory: one copy serves 16 W rows (96 at two blocks). The warps walk
//   the sequence in lockstep, one block barrier per box (Ring::next). The
//   sequence repeats with a period: a DOPRI5 step's stages, an RK4 tile's
//   substeps, or one stage and its VJP, then the h rows' box.
// - B fragments come from shared memory at a row stride of the box width
//   plus 8 bf16, so the 8 rows a fragment touches fall in distinct banks;
//   one ldmatrix.x4 gives a k-slice's fragments of two n-blocks.
// - The per-row activations the VJP keeps (feats, q, the block-input chain,
//   two H-wide work rows g and r, and bf16(h), loaded once per tile) share
//   the SM with the ring; the VJP's short-lived rows are overlaid on g and r
//   (gk16 and gctx on r, a zone box's attn16 and ds16 on g), which is what
//   lets 6 warps' rows fit at two blocks (Layout::bytes: 230,400 bytes).
// - Weight gradients are agent contractions over the CTA's 16 W rows into
//   the CTA's slab in device memory, by 16 x 32 output blocks a warp: one A
//   fragment serves four tiles, and a block's slab values are read in one
//   round trip before its products. The zones' gradient is contracted once
//   per 32-zone box. No atomics.

#pragma once

#include "drift_stage.cuh"

namespace ananke {
namespace sm90 {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int DA, int DZ, int DC, int H>
struct Layout {
  static constexpr int DF = DA + DZ;
  static constexpr int SF = DF + 8;       // feats
  static constexpr int SQ = DZ + 8;       // q; gctx (on r)
  static constexpr int SH = H + 8;        // chain, g, r
  static constexpr int SS = cmax(DA, DC) + 8;  // gk16, bf16(h) (on r)
  static constexpr int ZC = 32;           // zones a ring box holds
  static constexpr int SD = ZC + 8;       // a box's attn16, ds16 (on g)
  static constexpr int HH = H / 2;        // output rows of a half box
  // bf16 elements of one slot: the largest box of the schedule (the W1
  // half: Dense_0's rows for both its products, W1xc^T and W1h^T)
  static constexpr int kSlot = cmax(
      cmax(cmax(DZ * (DA + 8), ZC * (DZ + 8) + DZ * (ZC + 8)),
           cmax(HH * (DF + 8) + HH * (DC + 8), HH * (H + 8))),
      cmax(cmax(DA * (H + 8), H * (DA + 8)),
           cmax(64 * (H + 8), cmax(DA * (DZ + 8), DC * (H + 8)))));
  static constexpr int kSlots = 3;
  static_assert(SQ <= SH && SS <= SH && 2 * SD <= SH, "overlays");
  static_assert(DF <= 128 && H % 32 == 0 && DZ % 16 == 0, "box shapes");
  // bytes of dynamic shared memory: colsum, the ring, then per row feats,
  // q, g, r, bf16(h) and the nb + 1 chain levels
  static size_t bytes(int rows, int warps, int nb) {
    return (size_t)warps * H * sizeof(float) +
           (size_t)kSlots * kSlot * sizeof(bf16) +
           (size_t)rows * sizeof(bf16) *
               (SF + SQ + SS + (size_t)(nb + 3) * SH);
  }
};

// A tile's shared memory, at fixed offsets from the start of the kernel's
// dynamic shared memory: colsum [W][H] | the ring | per row feats [SF], q
// [SQ], g [SH] (a zone box's attn16 | ds16 in the attention VJP), r [SH]
// (gk16 or gctx in the VJP), hb [SS] (bf16(h), the tile's rows for all its
// steps) | (nb + 1) chain levels [ROWS][SH]. The addresses are constants,
// so they cost no registers.
template <int DA, int DZ, int DC, int H, int W>
struct Smem {
  using L = Layout<DA, DZ, DC, H>;
  static constexpr int ROWS = 16 * W;
  static constexpr int kRing = W * H * 4;  // byte offsets
  static constexpr int kFeats = kRing + L::kSlots * L::kSlot * 2;
  static constexpr int kQ = kFeats + ROWS * L::SF * 2;
  static constexpr int kG = kQ + ROWS * L::SQ * 2;
  static constexpr int kR = kG + ROWS * L::SH * 2;
  static constexpr int kHb = kR + ROWS * L::SH * 2;
  static constexpr int kChain = kHb + ROWS * L::SS * 2;
  __device__ __forceinline__ static unsigned char* raw() {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return dyn_smem;
  }
  __device__ __forceinline__ static float* colsum() {
    return reinterpret_cast<float*>(raw());
  }
  __device__ __forceinline__ static bf16* ring() {
    return reinterpret_cast<bf16*>(raw() + kRing);
  }
  __device__ __forceinline__ static bf16* feats() {
    return reinterpret_cast<bf16*>(raw() + kFeats);
  }
  __device__ __forceinline__ static bf16* q() {
    return reinterpret_cast<bf16*>(raw() + kQ);
  }
  __device__ __forceinline__ static bf16* g() {
    return reinterpret_cast<bf16*>(raw() + kG);
  }
  __device__ __forceinline__ static bf16* r() {
    return reinterpret_cast<bf16*>(raw() + kR);
  }
  __device__ __forceinline__ static bf16* hb() {
    return reinterpret_cast<bf16*>(raw() + kHb);
  }
  // block b's input (b < nb), or the blocks' output (b = nb)
  __device__ __forceinline__ static bf16* chain(int b) {
    return reinterpret_cast<bf16*>(raw() + kChain) + (size_t)b * ROWS * L::SH;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc[j0 + i] += A * (n-block i of a box), i < G, over K/16 k-slices: the
// box holds the product's weights as (N_out, K) rows at row stride `st` in
// shared memory, from n-block j0's row 0 on. A pair of n-blocks takes its
// B fragments of a k-slice in one ldmatrix.x4 (lane l addresses row l % 8
// of the pair's n-block l / 16, at column 8 ((l / 8) % 2) of the slice); an
// odd last n-block two 32-bit loads. Each accumulator sums its k-slices in
// order; the G accumulators interleave.
template <int K, int G, int NOUT>
__device__ __forceinline__ void mma_s(float (&acc)[NOUT][4], int j0,
                                      const uint32_t (&a)[K / 16][4],
                                      const bf16* box, int st, int g, int t) {
  const int lane = 4 * g + t;
  const bf16* lrow =
      box + (8 * (lane >> 4) + (lane & 7)) * st + 8 * ((lane >> 3) & 1);
  const bf16* row = box + g * st + 2 * t;
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
#pragma unroll
    for (int i = 0; i + 1 < G; i += 2) {
      uint32_t b[4];
      ldsm_x4(b, lrow + 8 * i * st + 16 * s);
      mma(acc[j0 + i], a[s], b[0], b[1]);
      mma(acc[j0 + i + 1], a[s], b[2], b[3]);
    }
    if (G % 2 == 1) {
      const bf16* p = row + 8 * (G - 1) * st + 16 * s;
      mma(acc[j0 + G - 1], a[s], lds32(p), lds32(p + 8));
    }
  }
}

// The order of a period of the ring's schedule (below): per step kF stage
// forwards, then kP (forward, VJP) pairs; after the period's last step the
// h rows' box.
// - StepSchedule, the DOPRI5 step VJP (K6, K7-bf16): stages 1-5 forward,
//   then stages 6 .. 1 recomputed and differentiated; one step a period.
// - DaySchedule, the RK4 day's reverse sweep (K2b): per substep stages 1-3
//   forward, then stages 4 .. 1 recomputed and differentiated; a period is
//   a tile, its `steps` substeps, and ends with the tile's h rows.
// - RhsSchedule, the continuous adjoint's right-hand side (K8): one stage
//   forward and its VJP, then the h rows' box; a period is a tile.
struct StepSchedule {
  static constexpr int kF = 5, kP = 6;
  static constexpr bool kOneStep = true;
};

struct DaySchedule {
  static constexpr int kF = 3, kP = 4;
  static constexpr bool kOneStep = false;
  int steps = 1;
};

struct RhsSchedule {
  static constexpr int kF = 0, kP = 1;
  static constexpr bool kOneStep = true;
};

// A period's weight boxes, in the order it consumes them:
//   F (a stage forward): Wq^T | zones x nzc | W1 halves 0, 1 | per block
//     Wr1^T halves 0, 1, Wr2^T halves 0, 1 | W3^T
//   B (a stage VJP): W3 | per block, last first: Wr1^T halves, Wr2 halves,
//     Wr1 halves | W1xc rows 0-63, 64- | zones x nzc (the attention's first
//     pass) | zones x nzc (its second) | Wq
//   a step: F x kF, (F, B) x kP; the period: its steps, then W1h (the h
//     rows)
// A "zones" box is ZC rows of ze beside the same ZC columns of ze^T; a "W1
// half" H/2 rows of W1xc^T beside the same rows of W1h^T.
template <int DA, int DZ, int DC, int H, int W, class Sched = StepSchedule>
struct Ring : Sched {
  using L = Layout<DA, DZ, DC, H>;
  static constexpr int DF = DA + DZ;
  static constexpr int kH = Sched::kF + 2 * Sched::kP;  // the h rows' segment
  int c = 0;    // boxes consumed (the same in every thread)
  // the producer's cursor: box k of segment seg of step rep of the period
  // (segments 0 .. kF - 1 F, then F and B by turns, then segment kH, the h
  // rows' box, after the last step)
  int seg = 0, k = 0, rep = 0;

  // boxes of a stage forward, of a stage VJP
  __device__ __forceinline__ static int nzc(const StageWeights& w) {
    return (w.zp + L::ZC - 1) / L::ZC;
  }
  __device__ __forceinline__ static int fwd(const StageWeights& w) {
    return 4 + nzc(w) + 4 * w.num_blocks;
  }
  __device__ __forceinline__ static int vjp(const StageWeights& w) {
    return 4 + 6 * w.num_blocks + 2 * nzc(w);
  }
  // boxes of a period of `steps` steps
  __device__ __forceinline__ static int period(const StageWeights& w,
                                               int steps = 1) {
    return steps * ((Sched::kF + Sched::kP) * fwd(w) + Sched::kP * vjp(w)) +
           1;
  }
  // The ring as a period finds it, c0 boxes consumed (mod kSlots) before
  // it: its first kSlots - 1 boxes already in flight, the producer at the
  // period's box kSlots - 1 (a stage forward has more boxes than that).
  __device__ __forceinline__ static Ring at_step(int c0,
                                                 const Sched& s = Sched()) {
    Ring r;
    static_cast<Sched&>(r) = s;
    r.c = c0;
    r.k = L::kSlots - 1;
    return r;
  }
  __device__ __forceinline__ static bf16* slot(int ci) {
    return Smem<DA, DZ, DC, H, W>::ring() + (ci % L::kSlots) * L::kSlot;
  }

  // copy a (rows x cols) box of a row-major bf16 matrix (row stride ss)
  // into the slot at element doff, row stride ds (cols + 8 unless given);
  // every thread takes 16-byte pieces in turn
  __device__ __forceinline__ static void box(bf16* slot, int doff,
                                             const bf16* src, int rows,
                                             int cols, int ss, int ds = 0) {
    const int per = cols / 8, pieces = rows * per;
    if (ds == 0) ds = cols + 8;
    for (int e = threadIdx.x; e < pieces; e += 32 * W) {
      const int r = e / per, k = e - r * per;
      cp_async16(slot + doff + r * ds + 8 * k, src + (size_t)r * ss + 8 * k);
    }
  }

  __device__ static void zones(bf16* slot, const StageWeights& w, int zc) {
    const int z0 = zc * L::ZC, nz = min(L::ZC, w.zp - z0);
    box(slot, 0, w.ze + (size_t)z0 * DZ, nz, DZ, DZ);
    box(slot, L::ZC * (DZ + 8), w.zeT + z0, DZ, nz, w.zp, L::ZC + 8);
  }

  // start the copy of the cursor's box into slot ci % kSlots (one commit
  // group), and advance the cursor
  __device__ void issue(const StageWeights& w, int ci) {
    bf16* slot = Ring::slot(ci);
    const int nb = w.num_blocks, nz = nzc(w);
    const size_t HH2 = (size_t)L::HH * H;
    const bool fw =
        seg < Sched::kF || (seg < kH && seg % 2 == Sched::kF % 2);
    int len = 1;
    if (seg == kH) {
      box(slot, 0, w.w1h, DC, H, H);
    } else if (fw) {  // a stage forward
      len = fwd(w);
      if (k == 0) {
        box(slot, 0, w.wqT, DZ, DA, DA);
      } else if (k <= nz) {
        zones(slot, w, k - 1);
      } else if (k <= nz + 2) {
        const int h = k - nz - 1;
        box(slot, 0, w.w1xcT + h * L::HH * DF, L::HH, DF, DF);
        box(slot, L::HH * (DF + 8), w.w1hT + h * L::HH * DC, L::HH, DC, DC);
      } else if (k < len - 1) {
        const int kk = k - nz - 3, b = kk >> 2, r = kk & 3;
        box(slot, 0, w.wrT + (size_t)(2 * b + (r >> 1)) * H * H + (r & 1) * HH2,
            L::HH, H, H);
      } else {
        box(slot, 0, w.w3T, DA, H, H);
      }
    } else {  // a stage VJP
      len = vjp(w);
      if (k == 0) {
        box(slot, 0, w.w3, H, DA, DA);
      } else if (k <= 6 * nb) {
        const int kk = k - 1, b = nb - 1 - kk / 6, r = kk % 6;
        const bf16* m = r < 2 ? w.wrT + (size_t)(2 * b) * H * H
                        : r < 4 ? w.wr + (size_t)(2 * b + 1) * H * H
                                : w.wr + (size_t)(2 * b) * H * H;
        box(slot, 0, m + (r & 1) * HH2, L::HH, H, H);
      } else if (k <= 6 * nb + 2) {
        const int part = k - 6 * nb - 1;
        box(slot, 0, w.w1xc + (size_t)part * 64 * H,
            min(64, DF - 64 * part), H, H);
      } else if (k < len - 1) {
        const int zc = k - 6 * nb - 3;
        zones(slot, w, zc < nz ? zc : zc - nz);
      } else {
        box(slot, 0, w.wq, DA, DZ, DZ);
      }
    }
    cp_commit();
    if (++k == len) {
      k = 0;
      if constexpr (Sched::kOneStep) {
        seg = seg == kH ? 0 : seg + 1;
      } else if (seg == kH) {
        seg = 0;
        rep = 0;
      } else if (++seg == kH && ++rep < this->steps) {
        seg = 0;  // the period's next step
      }
    }
  }

  // start the first kSlots - 1 boxes (every thread)
  __device__ void prime(const StageWeights& w) {
    for (int i = 0; i < L::kSlots - 1; ++i) issue(w, c + i);
  }

  // The next box, once every thread's copies of it have landed; every
  // thread of the CTA calls it at the same point of the sequence. Its
  // barrier also tells that every warp is done with the previous box, whose
  // slot then takes the copy kSlots - 1 boxes ahead.
  __device__ const bf16* next(const StageWeights& w) {
    cp_wait<L::kSlots - 2>();
    __syncthreads();
    issue(w, c + L::kSlots - 1);
    return slot(c++);
  }

  // let the copies in flight land before the CTA exits
  __device__ static void drain() { cp_wait<0>(); }
};

// out (M x N row-major, leading dim N) += A1^T B1 [+ A2^T B2] over the
// tile's ROWS agent rows; A (ROWS x M) and B (ROWS x N) row-major bf16 in
// shared memory, N a multiple of 32. Output blocks of 16 x 32 are dealt to
// the warps in turn: a block's A fragment serves its four 16 x 8 tiles,
// their B fragments come two tiles to an ldmatrix.x4, and the block's slab
// values are read before its products, in one round trip; rows of `out` at
// or past m_valid are neither read nor written.
template <int M, int N, int ROWS, int W, bool TWO>
__device__ __forceinline__ void nt_dot(const bf16* A1, int sa1, const bf16* B1,
                                       int sb1, const bf16* A2, int sa2,
                                       const bf16* B2, int sb2, float* out,
                                       int m_valid, int warp, int lane) {
  static_assert(N % 32 == 0 && M % 16 == 0, "blocks");
  constexpr int NB = N / 32, BLOCKS = (M / 16) * NB;
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, r = lane & 7;
  for (int blk = warp; blk < BLOCKS; blk += W) {
    const int m0 = (blk / NB) * 16, n0 = (blk % NB) * 32;
    const int ma = m0 + g, mb = ma + 8;
    const bool va = ma < m_valid, vb = mb < m_valid;
    float acc[4][4], old[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float2 z2 = make_float2(0.f, 0.f);
      const float2 lo = va ? *reinterpret_cast<const float2*>(out + ma * N + c) : z2;
      const float2 hi = vb ? *reinterpret_cast<const float2*>(out + mb * N + c) : z2;
      old[j][0] = lo.x; old[j][1] = lo.y; old[j][2] = hi.x; old[j][3] = hi.y;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll 2
    for (int k0 = 0; k0 < ROWS; k0 += 16) {
      uint32_t af[4], b0[4], b1[4];
      const int ar = (k0 + r + 8 * (q >> 1)), br = (k0 + r + 8 * (q & 1));
      ldsm_x4_trans(af, A1 + ar * sa1 + m0 + 8 * (q & 1));
      ldsm_x4_trans(b0, B1 + br * sb1 + n0 + 8 * (q >> 1));
      ldsm_x4_trans(b1, B1 + br * sb1 + n0 + 16 + 8 * (q >> 1));
      mma(acc[0], af, b0[0], b0[1]);
      mma(acc[1], af, b0[2], b0[3]);
      mma(acc[2], af, b1[0], b1[1]);
      mma(acc[3], af, b1[2], b1[3]);
      if (TWO) {
        ldsm_x4_trans(af, A2 + ar * sa2 + m0 + 8 * (q & 1));
        ldsm_x4_trans(b0, B2 + br * sb2 + n0 + 8 * (q >> 1));
        ldsm_x4_trans(b1, B2 + br * sb2 + n0 + 16 + 8 * (q >> 1));
        mma(acc[0], af, b0[0], b0[1]);
        mma(acc[1], af, b0[2], b0[3]);
        mma(acc[2], af, b1[0], b1[1]);
        mma(acc[3], af, b1[2], b1[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (va)
        *reinterpret_cast<float2*>(out + ma * N + c) =
            make_float2(old[j][0] + acc[j][0], old[j][1] + acc[j][1]);
      if (vb)
        *reinterpret_cast<float2*>(out + mb * N + c) =
            make_float2(old[j][2] + acc[j][2], old[j][3] + acc[j][3]);
    }
  }
}

template <int M, int N, int ROWS, int W>
__device__ __forceinline__ void nt_dot1(const bf16* A, int sa, const bf16* B,
                                        int sb, float* out, int warp,
                                        int lane) {
  nt_dot<M, N, ROWS, W, false>(A, sa, B, sb, nullptr, 0, nullptr, 0, out, M,
                               warp, lane);
}

// k = stage(xb) for the warp's 16 rows (wr0: its first row in the tile), as
// the per-warp stage this replaced, with its weights from the ring (boxes
// F of the schedule). Leaves feats, q and the block chain of the warp's rows
// in shared memory and returns the softmax's row normalisers. Every thread
// of the CTA calls it (the ring's barriers).
template <int DA, int DZ, int DC, int H, int W, class Sched>
__device__ __forceinline__ void stage_forward(
    const StageWeights& w, Ring<DA, DZ, DC, H, W, Sched>& ring,
    const uint32_t (&xa)[DA / 16][4], const float* tf,
    float (&k)[DA / 8][4], float& inv_a, float& inv_b, int wr0, int g,
    int t) {
  using L = Layout<DA, DZ, DC, H>;
  constexpr int NX = DA / 8;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int DF = DA + DZ, KF = DF / 16;
  constexpr int SF = L::SF, SQ = L::SQ, SH = L::SH, HH = L::HH;
  using S = Smem<DA, DZ, DC, H, W>;
  const int nb = w.num_blocks;
  const float scale = 1.0f / sqrtf((float)DZ);
  bf16* chain_out = S::chain(nb);

  sts_a<DA>(xa, S::feats() + wr0 * SF, SF, g, t);
  uint32_t qa[KZ][4];
  {
    const bf16* bx = ring.next(w);  // Wq^T (DZ, DA)
    float q[NZ][4];
    zero(q);
    mma_s<DA, NZ>(q, 0, xa, bx, DA + 8, g, t);
    c_to_a<DZ>(q, qa);
    sts_a<DZ>(qa, S::q() + wr0 * SQ, SQ, g, t);
  }

  // ctx = softmax(q ze^T * scale) @ ze, max-free, by zone chunks
  {
    float ctx[NZ][4];
    zero(ctx);
    float rs_a = 0.f, rs_b = 0.f;
    for (int zc0 = 0; zc0 < w.zp; zc0 += L::ZC) {
      const bf16* bx = ring.next(w);  // ze rows | ze^T columns
      const bf16* zt = bx + L::ZC * (DZ + 8);
      const int zend = min(zc0 + L::ZC, w.zp);
      for (int z0 = zc0; z0 < zend; z0 += 16) {
        float sc[2][4];
        zero(sc);
        mma_s<DZ, 2>(sc, 0, qa, bx + (z0 - zc0) * (DZ + 8), DZ + 8, g, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int za = z0 + 2 * t + (c & 1);
          sc[0][c] = za < w.z ? expf(fminf(sc[0][c] * scale, 80.f)) : 0.f;
          sc[1][c] = za + 8 < w.z ? expf(fminf(sc[1][c] * scale, 80.f)) : 0.f;
        }
        rs_a += (sc[0][0] + sc[0][1]) + (sc[1][0] + sc[1][1]);
        rs_b += (sc[0][2] + sc[0][3]) + (sc[1][2] + sc[1][3]);
        const uint32_t pa[1][4] = {{pack_bf16(sc[0][0], sc[0][1]),
                                    pack_bf16(sc[0][2], sc[0][3]),
                                    pack_bf16(sc[1][0], sc[1][1]),
                                    pack_bf16(sc[1][2], sc[1][3])}};
        mma_s<16, NZ>(ctx, 0, pa, zt + (z0 - zc0), L::ZC + 8, g, t);
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
    sts_a<DZ>(ca, S::feats() + wr0 * SF + DA, SF, g, t);
  }

  // z = tanh(feats @ W1xc + bf16(h) @ W1h + tf), by halves of H
  float zz[NH][4];
  {
    uint32_t fa[KF][4], ha[DC / 16][4];
    __syncwarp();
    lds_a<DF>(fa, S::feats() + wr0 * SF, SF, g, t);
    lds_a<DC>(ha, S::hb() + wr0 * L::SS, L::SS, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* bx = ring.next(w);  // W1xc^T rows | W1h^T rows
      const bf16* bh = bx + HH * (DF + 8);
#pragma unroll
      for (int jj = 0; jj < NH / 2; jj += 2) {
        float acc[2][4], hp[2][4];
        zero(acc);
        zero(hp);
        mma_s<DF, 2>(acc, 0, fa, bx + 8 * jj * (DF + 8), DF + 8, g, t);
        mma_s<DC, 2>(hp, 0, ha, bh + 8 * jj * (DC + 8), DC + 8, g, t);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = h * (NH / 2) + jj + u;
          const float2 tv =
              *reinterpret_cast<const float2*>(tf + 8 * j + 2 * t);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            zz[j][c] =
                tanhf((acc[u][c] + hp[u][c]) + ((c & 1) ? tv.y : tv.x));
        }
      }
    }
  }

  // residual blocks; the chain keeps each block's bf16 input
  for (int b = 0; b < nb; ++b) {
    const bf16* br1 = w.br + (size_t)(2 * b) * H;
    const bf16* br2 = br1 + H;
    uint32_t za[KH][4];
    c_to_a<H>(zz, za);
    sts_a<H>(za, S::chain(b) + wr0 * SH, SH, g, t);
    uint32_t rta[KH][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* bx = ring.next(w);  // Wr1^T rows of this half
#pragma unroll
      for (int ss = 0; ss < KH / 2; ++ss) {
        const int s = h * (KH / 2) + ss;
        float eo[2][4];
        zero(eo);
        mma_s<H, 2>(eo, 0, za, bx + 16 * ss * SH, SH, g, t);
        const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
        const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
        rta[s][0] = pack_bf16(tanhf(eo[0][0] + be.x), tanhf(eo[0][1] + be.y));
        rta[s][1] = pack_bf16(tanhf(eo[0][2] + be.x), tanhf(eo[0][3] + be.y));
        rta[s][2] = pack_bf16(tanhf(eo[1][0] + bo.x), tanhf(eo[1][1] + bo.y));
        rta[s][3] = pack_bf16(tanhf(eo[1][2] + bo.x), tanhf(eo[1][3] + bo.y));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* bx = ring.next(w);  // Wr2^T rows of this half
#pragma unroll
      for (int jj = 0; jj < NH / 2; jj += 2) {
        float acc[2][4];
        zero(acc);
        mma_s<H, 2>(acc, 0, rta, bx + 8 * jj * SH, SH, g, t);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = h * (NH / 2) + jj + u;
          const float2 bv = unpack_bf16(ldg32(br2 + 8 * j + 2 * t));
          zz[j][0] = tanhf(zz[j][0] + (acc[u][0] + bv.x));
          zz[j][1] = tanhf(zz[j][1] + (acc[u][1] + bv.y));
          zz[j][2] = tanhf(zz[j][2] + (acc[u][2] + bv.x));
          zz[j][3] = tanhf(zz[j][3] + (acc[u][3] + bv.y));
        }
      }
    }
  }
  {
    uint32_t za[KH][4];
    c_to_a<H>(zz, za);
    sts_a<H>(za, chain_out + wr0 * SH, SH, g, t);
    const bf16* bx = ring.next(w);  // W3^T (DA, H)
    zero(k);
    mma_s<H, NX>(k, 0, za, bx, SH, g, t);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const float2 bv = unpack_bf16(ldg32(w.b3 + 8 * j + 2 * t));
      k[j][0] += bv.x; k[j][1] += bv.y; k[j][2] += bv.x; k[j][3] += bv.y;
    }
  }
}

// The VJP of the last stage_forward at cotangent `ga` (f32, accumulator
// fragments), as the per-warp stage VJP this replaced, but for the h rows,
// with its weights from the ring (boxes B of the schedule): returns gx (f32,
// accumulator fragments), adds the summed gradients into `slab` (the time
// row's at slab + gtf) and the gradient of Dense_0's h-row pre-activation
// per row into `ghp` (the warp's f32 [H/2][32] fragment array). Every
// thread of the CTA calls it.
template <int DA, int DZ, int DC, int H, int W, class Sched>
__device__ __forceinline__ void stage_backward(
    const StageWeights& w, Ring<DA, DZ, DC, H, W, Sched>& ring,
    const float (&ga)[DA / 8][4], float inv_a, float inv_b, float* slab,
    int tf_rows, long gtf, float* gx_slot, float* ghp, int warp, int lane) {
  using L = Layout<DA, DZ, DC, H>;
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8, KX = DA / 16;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int DF = DA + DZ;
  constexpr int SF = L::SF, SQ = L::SQ, SH = L::SH, SD = L::SD;
  using S = Smem<DA, DZ, DC, H, W>;
  const Slab<DA, DZ, DC, H> sl(w.z, w.num_blocks, tf_rows);
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = warp * 16;
  const int nb = w.num_blocks;
  const float scale = 1.0f / sqrtf((float)DZ);
  float* cs = S::colsum() + warp * H;
  const bf16* chain_out = S::chain(nb);
  bf16* small = S::r();  // gk16
  bf16* gctx = S::r();   // [ROWS][SQ] at row stride SH
  bf16* at16 = S::g();   // [ROWS][SD] at row stride SH: a zone box's attn
  bf16* ds16 = S::g() + SD;  // and ds

  // k = z_out @ W3 + b3: gW3 = z_out^T bf16(gk), gb3 = sum gk,
  // gz = bf16(gk) @ W3^T
  float gz[NH][4];
  {
#pragma unroll
    for (int j = 0; j < NX; ++j) warp_colsum(cs, j, ga[j], g, t);
    uint32_t gka[KX][4];
    c_to_a<DA>(ga, gka);
    sts_a<DA>(gka, small + wr0 * SH, SH, g, t);
    const bf16* bx = ring.next(w);  // W3 (H, DA)
    zero(gz);
    mma_s<DA, NH>(gz, 0, gka, bx, DA + 8, g, t);
  }
  __syncthreads();
  nt_dot1<H, DA, ROWS, W>(chain_out, SH, small, SH, slab + sl.gw3, warp,
                          lane);
  flush_colsum<W, H>(S::colsum(), slab + sl.gb3, DA, false);
  __syncthreads();

  // residual blocks, reversed: z_out = tanh(z_in + bf16(rt) @ Wr2 + br2),
  // rt = tanh(z_in @ Wr1 + br1)
  for (int b = nb - 1; b >= 0; --b) {
    const bf16* br1 = w.br + (size_t)(2 * b) * H;
    const bf16* z_in = S::chain(b);
    const bf16* z_out = z_in + (size_t)ROWS * SH;
    // gpre = gz * (1 - zo^2), kept in gz
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float zo[4];
      lds_c(zo, z_out + wr0 * SH, SH, j, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gz[j][c] = __fmul_rn(gz[j][c], __fsub_rn(1.f, __fmul_rn(zo[c], zo[c])));
      warp_colsum(cs, j, gz[j], g, t);
    }
    {
      uint32_t gpa[KH][4];
      c_to_a<H>(gz, gpa);
      sts_a<H>(gpa, S::g() + wr0 * SH, SH, g, t);
    }
    // recompute bf16(rt) into r
    {
      uint32_t za[KH][4];
      lds_a<H>(za, z_in + wr0 * SH, SH, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* bx = ring.next(w);  // Wr1^T rows of this half
#pragma unroll
        for (int ss = 0; ss < KH / 2; ++ss) {
          const int s = h * (KH / 2) + ss;
          float eo[2][4];
          zero(eo);
          mma_s<H, 2>(eo, 0, za, bx + 16 * ss * SH, SH, g, t);
          const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
          const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
          bf16* rp = S::r() + (wr0 + g) * SH + 16 * s + 2 * t;
          sts32(rp, pack_bf16(tanhf(eo[0][0] + be.x), tanhf(eo[0][1] + be.y)));
          sts32(rp + 8 * SH, pack_bf16(tanhf(eo[0][2] + be.x), tanhf(eo[0][3] + be.y)));
          sts32(rp + 8, pack_bf16(tanhf(eo[1][0] + bo.x), tanhf(eo[1][1] + bo.y)));
          sts32(rp + 8 * SH + 8, pack_bf16(tanhf(eo[1][2] + bo.x), tanhf(eo[1][3] + bo.y)));
        }
      }
    }
    __syncthreads();
    // gWr2 = bf16(rt)^T bf16(gpre), gbr2 = sum gpre
    nt_dot1<H, H, ROWS, W>(S::r(), SH, S::g(), SH, slab + sl.wr2(b), warp, lane);
    flush_colsum<W, H>(S::colsum(), slab + sl.br2(b), H, false);
    // gpre2 = (bf16(gpre) @ Wr2^T) * (1 - rt^2); bf16(gpre2) replaces rt
    // (the box's barrier orders it after every warp's nt_dot); bf16(gpre)
    // is read back from g rather than held across the contraction
    uint32_t gpa[KH][4];
    lds_a<H>(gpa, S::g() + wr0 * SH, SH, g, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16* bx = ring.next(w);  // Wr2 rows of this half
#pragma unroll
      for (int jj = 0; jj < NH / 2; jj += 2) {
        float acc[2][4];
        zero(acc);
        mma_s<H, 2>(acc, 0, gpa, bx + 8 * jj * SH, SH, g, t);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = h * (NH / 2) + jj + u;
          float rt[4];
          lds_c(rt, S::r() + wr0 * SH, SH, j, g, t);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[u][c] = __fmul_rn(acc[u][c],
                                  __fsub_rn(1.f, __fmul_rn(rt[c], rt[c])));
          warp_colsum(cs, j, acc[u], g, t);
          bf16* rp = S::r() + (wr0 + g) * SH + 8 * j + 2 * t;
          sts32(rp, pack_bf16(acc[u][0], acc[u][1]));
          sts32(rp + 8 * SH, pack_bf16(acc[u][2], acc[u][3]));
        }
      }
    }
    __syncthreads();
    // gWr1 = z_in^T bf16(gpre2), gbr1 = sum gpre2
    nt_dot1<H, H, ROWS, W>(z_in, SH, S::r(), SH, slab + sl.wr1(b), warp, lane);
    flush_colsum<W, H>(S::colsum(), slab + sl.br1(b), H, false);
    // gz = gpre + bf16(gpre2) @ Wr1^T
    {
      uint32_t g2a[KH][4];
      lds_a<H>(g2a, S::r() + wr0 * SH, SH, g, t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* bx = ring.next(w);  // Wr1 rows of this half
        mma_s<H, NH / 2>(gz, h * (NH / 2), g2a, bx, SH, g, t);
      }
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
      lds_c(z1, S::chain(0) + wr0 * SH, SH, j, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        gz[j][c] = __fmul_rn(gz[j][c], __fsub_rn(1.f, __fmul_rn(z1[c], z1[c])));
      warp_colsum(cs, j, gz[j], g, t);
    }
    uint32_t g1a[KH][4];
    c_to_a<H>(gz, g1a);
    sts_a<H>(g1a, S::g() + wr0 * SH, SH, g, t);
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ghp[(4 * j + c) * 32 + lane] += gz[j][c];
    float gctx_f[NZ][4];
    zero(gctx_f);
    {
      const bf16* bx = ring.next(w);  // W1xc rows 0-63: the x rows, ctx's
      // gxb waits in the stage's gx slot through the attention VJP
      float gxb[NX][4];
      zero(gxb);
      mma_s<H, NX>(gxb, 0, g1a, bx, SH, g, t);
      frag_st<NX>(gxb, gx_slot, lane);
      mma_s<H, (64 - DA) / 8>(gctx_f, 0, g1a, bx + DA * SH, SH, g, t);
    }
    {
      const bf16* bx = ring.next(w);  // W1xc rows 64 - DF: ctx's rest
      mma_s<H, NZ - (64 - DA) / 8>(gctx_f, (64 - DA) / 8, g1a, bx, SH, g, t);
    }
    c_to_a<DZ>(gctx_f, gca);
    sts_a<DZ>(gca, gctx + wr0 * SH, SH, g, t);
  }
  __syncthreads();
  // gW1xc = feats^T bf16(gpre1)
  nt_dot1<DF, H, ROWS, W>(S::feats(), SF, S::g(), SH, slab + sl.gw1, warp, lane);
  flush_colsum<W, H>(S::colsum(), slab + gtf, H, false);

  // attention backward, recomputing attn16 by zone chunks:
  // gattn = bf16(gctx) @ ze^T; ds = attn (gattn - sum(attn gattn)) scale;
  // gq = bf16(ds) @ ze; gze = bf16(attn)^T bf16(gctx) + bf16(ds)^T q16
  uint32_t qa[KZ][4];
  lds_a<DZ>(qa, S::q() + wr0 * SQ, SQ, g, t);
  float S_a = 0.f, S_b = 0.f;
  for (int zc0 = 0; zc0 < w.zp; zc0 += L::ZC) {
    const bf16* bx = ring.next(w);  // ze rows | ze^T columns
    const int zend = min(zc0 + L::ZC, w.zp);
    for (int z0 = zc0; z0 < zend; z0 += 16) {
      float sc[2][4], ga_[2][4];
      zero(sc);
      zero(ga_);
      const bf16* zb = bx + (z0 - zc0) * (DZ + 8);
      mma_s<DZ, 2>(sc, 0, qa, zb, DZ + 8, g, t);
      mma_s<DZ, 2>(ga_, 0, gca, zb, DZ + 8, g, t);
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
  }
  S_a += __shfl_xor_sync(0xffffffffu, S_a, 1);
  S_a += __shfl_xor_sync(0xffffffffu, S_a, 2);
  S_b += __shfl_xor_sync(0xffffffffu, S_b, 1);
  S_b += __shfl_xor_sync(0xffffffffu, S_b, 2);

  float gq[NZ][4];
  zero(gq);
  for (int zc0 = 0; zc0 < w.zp; zc0 += L::ZC) {
    const bf16* bx = ring.next(w);  // ze rows | ze^T columns
    const bf16* zt = bx + L::ZC * (DZ + 8);
    const int zend = min(zc0 + L::ZC, w.zp);
    for (int z0 = zc0; z0 < zend; z0 += 16) {
      float sc[2][4], ga_[2][4];
      zero(sc);
      zero(ga_);
      const bf16* zb = bx + (z0 - zc0) * (DZ + 8);
      mma_s<DZ, 2>(sc, 0, qa, zb, DZ + 8, g, t);
      mma_s<DZ, 2>(ga_, 0, gca, zb, DZ + 8, g, t);
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
      sts_a<16>(da_, ds16 + wr0 * SH + (z0 - zc0), SH, g, t);
      sts_a<16>(aa_, at16 + wr0 * SH + (z0 - zc0), SH, g, t);
      mma_s<16, NZ>(gq, 0, da_, zt + (z0 - zc0), L::ZC + 8, g, t);
    }
    // gze's rows of this box: the box's zones past zp (a half box) hold
    // stale columns, in output rows at or past m_valid
    __syncthreads();
    nt_dot<L::ZC, DZ, ROWS, W, true>(at16, SH, gctx, SH, ds16, SH, S::q(), SQ,
                                     slab + (size_t)zc0 * DZ, w.z - zc0,
                                     warp, lane);
    __syncthreads();
  }

  // q = xb @ Wq: gWq = xb^T bf16(gq); gx = gxb + bf16(gq) @ Wq^T, into
  // the gx slot
  {
    uint32_t gqa[KZ][4];
    c_to_a<DZ>(gq, gqa);
    sts_a<DZ>(gqa, S::g() + wr0 * SH, SH, g, t);
    const bf16* bx = ring.next(w);  // Wq (DA, DZ)
    float gxb[NX][4];
    frag_ld<NX>(gxb, gx_slot, lane);
    mma_s<DZ, NX>(gxb, 0, gqa, bx, DZ + 8, g, t);
    frag_st<NX>(gxb, gx_slot, lane);
  }
  __syncthreads();
  nt_dot1<DA, DZ, ROWS, W>(S::feats(), SF, S::g(), SH, slab + sl.gwq, warp, lane);
  __syncthreads();
}

// hpre = bf16(h) @ W1h, the step's h rows (the schedule's last box): gh =
// bf16(ghp) @ W1h^T per row (into ghh, accumulator fragments) and gW1h +=
// bf16(h)^T bf16(ghp) into the slab, at the reference's rounding points.
// Every thread of the CTA calls it.
template <int DA, int DZ, int DC, int H, int W, class Sched>
__device__ __forceinline__ void h_rows(const StageWeights& w,
                                       Ring<DA, DZ, DC, H, W, Sched>& ring,
                                       const float* ghp, float* slab,
                                       int tf_rows, float (&ghh)[DC / 8][4],
                                       int warp, int lane) {
  constexpr int SH = Layout<DA, DZ, DC, H>::SH, SS = Layout<DA, DZ, DC, H>::SS;
  using S = Smem<DA, DZ, DC, H, W>;
  const long gw1h = Slab<DA, DZ, DC, H>(w.z, w.num_blocks, tf_rows).gw1h;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  float gp[H / 8][4];
  frag_ld<H / 8>(gp, ghp, lane);
  uint32_t g1a[H / 16][4];
  c_to_a<H>(gp, g1a);
  sts_a<H>(g1a, S::g() + wr0 * SH, SH, g, t);
  const bf16* bx = ring.next(w);  // W1h (DC, H)
  zero(ghh);
  mma_s<H, DC / 8>(ghh, 0, g1a, bx, SH, g, t);
  __syncthreads();
  nt_dot1<DC, H, 16 * W, W>(S::hb(), SS, S::g(), SH, slab + gw1h, warp,
                            lane);
  __syncthreads();
}

}  // namespace sm90
}  // namespace ananke
