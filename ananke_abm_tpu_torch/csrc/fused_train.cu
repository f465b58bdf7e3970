// The fixed-step training day of the GAT-ODE on Hopper (sm_90a): three
// kernels here and one in fused_step.cu, each replacing a Pallas TPU
// kernel of ananke_abm_tpu/ops/pallas/fused_train.py. Plain PyTorch
// versions: ananke_abm_tpu_torch/ops/cuda/fused_train.py::*_reference.
//
// K2f <- _day_fwd_impl: the whole RK4 day per agent, every substep carry
//   written to xs (S+1, N, DA). It is the serving kernels' work (the bf16
//   stage, float32 carries) with a carry stored after each substep, so it
//   is their template's third instantiation, in fused_step.cu
//   (ananke_day_forward there): the TMA weight ring, wgmma products and the
//   RK4 state in shared memory.
//
// K2b day_bwd_kernel  <- _day_bwd_impl. The reverse sweep. The Pallas
//   kernel recomputes a substep's four stages and keeps all their
//   intermediates on chip; here, per substep in reverse, stages 1-3 run
//   forward keeping only their f32 k, then for stage 4 -> 1 the stage is
//   recomputed from its input x + c dt k and its VJP run: 7 stage forwards
//   a substep where the Pallas kernel runs 4 (~+35% FLOPs). The stage and
//   its VJP are stage_sm90.cuh's, the discrete adjoint's bf16 step body's
//   (K6): every weight box is copied once a CTA through its cp.async ring
//   (on the ring's DaySchedule: per substep 3 stage forwards, then 4
//   forward and VJP pairs, the tile's h rows after its last substep) and
//   serves every warp's rows; B fragments come by ldmatrix; the weight
//   gradients are contracted over the tile's rows by 16 x 32 blocks a warp.
//
//   Shared memory. The ring (3 slots of 18,432 bytes) and the rows the VJP
//   keeps (feats, q, the block chain, the work rows, bf16(h)) take
//   sm90::Layout::bytes: 230,400 bytes for 6 warps at 2 blocks, of the
//   232,448 a CTA may hold. The row state the sweep carries (x, the
//   cotangent g, three k slots and the h-row cotangent's sum: 18,432 bytes
//   a warp) would not fit beside it at any warp count the ring's rows allow
//   (4 warps with 3 slots: 245,760 bytes). It lives in a per-CTA scratch in
//   device memory, read and written by the lane that owns it (14.6 MB for
//   132 CTAs of 6 warps: L2-resident), as the K6 body keeps its step state.
//   So the tile is 96 rows (6 warps) up to 2 blocks, 64 up to 5, 32 beyond.
//   The ways that keep the row state in shared memory (two ring slots, or
//   only the h-row sum in device memory) both cap the tile at 64 rows;
//   64-row tiles of this kernel read 122 ms at bench rung 2 against 80 for
//   96 rows (chip_smoke.py --ab-train, H100 80GB HBM3, 700 W).
//
//   Summed gradients (zone embeddings, the (S, 4, H) time table, the
//   weights) go into per-CTA slabs in device memory, zeroed by the caller,
//   then summed in CTA order: no atomics, the same operands give the same
//   bits. Every stage VJP adds into the slab (~131,900 floats at Z=500,
//   read and written per stage and tile): at bench rung 2 ~34 GB of traffic
//   with 96-row tiles, ~10 ms at 3.35 TB/s, a floor under this design.
//
// K3f ce_fwd_kernel   <- _ce_fwd_impl. Per row: d = bf16(x) @ Wd, logits =
//   bf16(d) @ ze^T by zone chunks, a max-subtracted log-sum-exp (one pass
//   for the max, the first-index argmax and the target logit, one for the
//   sum), nll and the correct flag. The logits never reach device memory.
//   ~70 kFLOP per row at Z=500 against ~140 bytes: compute-bound.
//
// K3b ce_bwd_kernel   <- _ce_bwd_impl. Per row it recomputes d and the
//   log-sum-exp, then per zone box grow = bf16((p - onehot) g_nll): gd +=
//   grow @ ze per row, gze += grow^T d16 summed over the tile's rows; then
//   gx = bf16(gd) @ Wd^T per row and gWd += bf16(x)^T bf16(gd). What held
//   its first design (64-row tiles, two CTAs an SM) to 1% of its bound:
//   every B fragment an __ldg from L2, the logits computed three times, a
//   slab read-modify-write of each 16-zone chunk's gze per tile between two
//   block barriers. Now one persistent CTA an SM (8 warps, 128-row tiles)
//   streams ze through a 3-slot cp.async ring of 32-zone boxes, B fragments
//   by ldmatrix (.trans for gd: no ze^T copy), two passes over the logits
//   (an online max and sum, then the gradient), one block barrier a box;
//   gze accumulates in shared memory across the CTA's tiles (one owner per
//   element, written once) for as many zones as fit beside the rest (576),
//   the zones past that box by box into the slab; gWd in registers.
//
// The stage attention is max-free and clamped at 80; the decode's softmax
// subtracts the max: both as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage_sm90.cuh"

namespace {

using namespace ananke;

constexpr int kMaxBlocks = 8;
constexpr int kFwdWarps = 4;  // K3f: 64 rows per block
constexpr int kCeWarps = 8;   // K3b: 128 rows per tile
constexpr int kCeZC = 32;     // zones of a K3b ring box
// K3b's CTAs at most, one an SM; a constant, so the order of its sums
// depends on the row count alone
constexpr int kCeCtas = 132;
// the largest dynamic shared memory a block can use
constexpr size_t kCeMaxSmem = 232448;

struct DayBwdParams {
  StageWeights w;
  const float* xs;   // (steps + 1, n, DA)
  const float* gxs;  // (steps + 1, n, DA)
  const float* h;    // (n, DC)
  const float* tf;   // (steps, 4, H)
  const float* dts;  // (steps)
  float* gx0;        // (n, DA), without gxs[0]
  float* gh;         // (n, DC)
  float* slab;       // (num_ctas, slab_size), zeroed
  float* state;      // (num_ctas, warps, kDayWarpFloats): the row state
  float* gsum;       // (slab_size)
  int n, steps, num_ctas;
  long slab_size;
};

// xa = bf16(x + c * k) (separate multiply and add, no fma: the rounding of
// the reference), or bf16(x) when `plain`; x and k per-warp fragment arrays
template <int DA>
__device__ __forceinline__ void stage_input(uint32_t (&xa)[DA / 16][4],
                                            const float* fx, const float* fk,
                                            float c, bool plain, int lane) {
  float xin[DA / 8][4];
  frag_ld<DA / 8>(xin, fx, lane);
  if (!plain) {
    float k[DA / 8][4];
    frag_ld<DA / 8>(k, fk, lane);
#pragma unroll
    for (int j = 0; j < DA / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xin[j][i] = __fadd_rn(xin[j][i], __fmul_rn(c, k[j][i]));
  }
  c_to_a<DA>(xin, xa);
}

// ---- K2b ---------------------------------------------------------------------
//
// A tile is 16 W agent rows, warp w owns rows 16 w .. 16 w + 15 end to end;
// the warps walk the tile's weight boxes in lockstep (stage_sm90.cuh's Ring
// on its DaySchedule: one period a tile). Each warp keeps its rows' float32
// state in fragment order (frag_ld / frag_st) in a scratch of its own in
// device memory, kFX floats an array: 0 x (then stage 1's gx) | 1 the
// cotangent carry g | 2-4 k slots 0-2 (k_1 .. k_3 forward; slot r - 1 takes
// stage r's gx once stage r's input has read k_{r-1}) | then the per-row sum
// of Dense_0's h-row pre-activation cotangent ([H/2][32]). Only the owning
// lane touches a slot: no barrier guards them.

constexpr int kFX = (32 / 8) * 4 * 32;                // floats of one array
constexpr int kDayWarpFloats = 5 * kFX + (128 / 8) * 4 * 32;

// warps of K2b's tile: the most whose rows fit the SM's shared memory beside
// the ring (sm90::Layout::bytes): 6 (96 rows) up to 2 blocks, 4 up to 5, 2
// beyond
inline int day_bwd_warps(int nb) { return nb <= 2 ? 6 : nb <= 5 ? 4 : 2; }

template <int DA, int DZ, int DC, int H, int W>
__global__ void __launch_bounds__(32 * W, 1)
    day_bwd_kernel(const DayBwdParams p) {
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8, KX = DA / 16, FX = kFX;
  using Ring = sm90::Ring<DA, DZ, DC, H, W, sm90::DaySchedule>;
  using L = sm90::Layout<DA, DZ, DC, H>;
  using S = sm90::Smem<DA, DZ, DC, H, W>;
  static_assert(FX == NX * 4 * 32, "the row arrays");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  const int tf_rows = 4 * p.steps;
  const long gtf = Slab<DA, DZ, DC, H>(p.w.z, p.w.num_blocks, tf_rows).gtf;
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  float* fx = p.state + ((size_t)blockIdx.x * W + warp) * kDayWarpFloats;
  float* fg = fx + FX;
  float* fk = fg + FX;
  float* ghp = fk + 3 * FX;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;
  const size_t plane = (size_t)p.n * DA;
  sm90::DaySchedule sched;
  sched.steps = p.steps;
  const int period = Ring::period(p.w, p.steps);
  {
    Ring first;
    first.steps = p.steps;
    first.prime(p.w);
  }
  int c0 = 0;  // the ring's boxes consumed before the tile (mod kSlots)

  for (int tile = blockIdx.x; tile < n_tiles; tile += p.num_ctas) {
    const long ra = (long)tile * ROWS + wr0 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;
    {  // bf16(h) into the tile's hb rows, where every stage reads it
      uint32_t ha[DC / 16][4];
      ldg_rows_a<DC>(ha, p.h, ra, rb, va, vb, t);
      sts_a<DC>(ha, S::hb() + wr0 * L::SS, L::SS, g, t);
    }
    for (int i = 0; i < (H / 8) * 4; ++i) ghp[i * 32 + lane] = 0.f;
    for (int i = 0; i < NX * 4; ++i) fg[i * 32 + lane] = 0.f;
    Ring ring = Ring::at_step(c0, sched);

    for (int s = p.steps - 1; s >= 0; --s) {
      const float dt = p.dts[s];
      const float half = dt * 0.5f, third = dt / 3.0f, sixth = dt / 6.0f;
      const float* tfs = p.tf + (size_t)4 * s * H;
      // x = xs[s]; g += gxs[s + 1]
      {
        float v[NX][4], gc[NX][4];
        ldg_rows_c<NX>(v, p.xs + (size_t)s * plane, ra, rb, va, vb, t);
        frag_st<NX>(v, fx, lane);
        ldg_rows_c<NX>(v, p.gxs + (size_t)(s + 1) * plane, ra, rb, va, vb, t);
        frag_ld<NX>(gc, fg, lane);
#pragma unroll
        for (int j = 0; j < NX; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) gc[j][c] = gc[j][c] + v[j][c];
        frag_st<NX>(gc, fg, lane);
      }
      // stages 1-3 forward: k_r = f(x + c_r k_{r-1}) into slot r
#pragma unroll 1
      for (int r = 0; r < 3; ++r) {
        uint32_t xa[KX][4];
        stage_input<DA>(xa, fx, fk + (r > 0 ? r - 1 : 0) * FX, half, r == 0,
                        lane);
        float k[NX][4], ia, ib;
        sm90::stage_forward<DA, DZ, DC, H, W>(p.w, ring, xa, tfs + r * H, k,
                                              ia, ib, wr0, g, t);
        frag_st<NX>(k, fk + r * FX, lane);
      }
      // stages 4 -> 1: recompute the stage, then its VJP. The input of
      // stage r reads k_{r-1} (slot r-1); once read, the slot takes this
      // stage's gx, which the next (earlier) stage's cotangent reads; stage
      // 1's gx goes to the x array, read by no later stage of the substep.
#pragma unroll 1
      for (int r = 3; r >= 0; --r) {
        uint32_t xa[KX][4];
        stage_input<DA>(xa, fx, fk + (r > 0 ? r - 1 : 0) * FX,
                        r == 3 ? dt : half, r == 0, lane);
        // gk4 = dt/6 g; gk3 = dt/3 g + dt gx4; gk2 = dt/3 g + dt/2 gx3;
        // gk1 = dt/6 g + dt/2 gx2
        float gk[NX][4];
        {
          const float cg = (r == 3 || r == 0) ? sixth : third;
          frag_ld<NX>(gk, fg, lane);
          if (r == 3) {
#pragma unroll
            for (int j = 0; j < NX; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) gk[j][c] = __fmul_rn(cg, gk[j][c]);
          } else {
            const float cx = (r == 2) ? dt : half;
            float gn[NX][4];
            frag_ld<NX>(gn, fk + r * FX, lane);
#pragma unroll
            for (int j = 0; j < NX; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                gk[j][c] = __fadd_rn(__fmul_rn(cg, gk[j][c]),
                                     __fmul_rn(cx, gn[j][c]));
          }
        }
        float k[NX][4], ia, ib;
        sm90::stage_forward<DA, DZ, DC, H, W>(p.w, ring, xa, tfs + r * H, k,
                                              ia, ib, wr0, g, t);
        float* gx_slot = r > 0 ? fk + (r - 1) * FX : fx;
        sm90::stage_backward<DA, DZ, DC, H, W>(
            p.w, ring, gk, ia, ib, slab, tf_rows, gtf + (long)(4 * s + r) * H,
            gx_slot, ghp, warp, lane);
      }
      // g = g + gx1 + gx2 + gx3 + gx4, in the reference's order
      {
        float gc[NX][4], v[NX][4];
        frag_ld<NX>(gc, fg, lane);
        for (int i = 0; i < 4; ++i) {
          frag_ld<NX>(v, i == 0 ? fx : fk + (i - 1) * FX, lane);
#pragma unroll
          for (int j = 0; j < NX; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) gc[j][c] = gc[j][c] + v[j][c];
        }
        frag_st<NX>(gc, fg, lane);
      }
    }

    // gx0 = g; hpre = bf16(h) @ W1h: gh = bf16(ghp) @ W1h^T per row, gW1h
    // = bf16(h)^T bf16(ghp) summed (the period's last box)
    {
      float gc[NX][4];
      frag_ld<NX>(gc, fg, lane);
      stg_rows_c<NX>(gc, p.gx0, ra, rb, va, vb, t);
      float ghh[DC / 8][4];
      sm90::h_rows<DA, DZ, DC, H, W>(p.w, ring, ghp, slab, tf_rows, ghh,
                                     warp, lane);
      stg_rows_c<DC / 8>(ghh, p.gh, ra, rb, va, vb, t);
    }
    c0 = (c0 + period) % L::kSlots;
  }
  Ring::drain();
}

// ---- K3f / K3b: the decode head's cross-entropy -------------------------------
struct CeParams {
  const float* x;      // (m, DA)
  const int* tgt;      // (m)
  const float* gnll;   // (m), backward only
  const bf16* wdT;     // (DZ, DA)
  const bf16* wd;      // (DA, DZ)
  const bf16* ze;      // (zp, DZ), zero rows past z
  const bf16* zeT;     // (DZ, zp)
  float* nll;          // (m)
  int* correct;        // (m)
  float* gx;           // (m, DA)
  float* slab;         // (num_ctas, slab_size): gze (z, DZ) | gWd (DA, DZ)
  float* gsum;         // (slab_size)
  int m, z, zp, num_ctas;
  int zr;              // K3b: zones whose gze stays in shared memory
  long slab_size;
};

// d = bf16(x) @ Wd for the warp's 16 rows -> bf16 A fragments
template <int DA, int DZ>
__device__ __forceinline__ void decode_rows(uint32_t (&dA)[DZ / 16][4],
                                            const uint32_t (&xa)[DA / 16][4],
                                            const bf16* wdT, int g, int t) {
  float d[DZ / 8][4];
  zero(d);
#pragma unroll
  for (int j = 0; j < DZ / 8; ++j)
    mma_nblocks<DA, 1>(d, j, xa, wdT + (size_t)8 * j * DA, g, t);
  c_to_a<DZ>(d, dA);
}

// per row (g: .a, g+8: .b) the max logit over valid zones, its first index
// and the target's logit, reduced over the 4 lanes that share the rows
struct RowMax {
  float mx_a, mx_b, lt_a, lt_b;
  int id_a, id_b;
};

template <int DZ>
__device__ __forceinline__ RowMax row_max(const uint32_t (&dA)[DZ / 16][4],
                                          const bf16* ze, int z, int zp,
                                          int ta, int tb, int g, int t) {
  RowMax m = {-INFINITY, -INFINITY, 0.f, 0.f, 0, 0};
  for (int z0 = 0; z0 < zp; z0 += 8) {
    float lg[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    mma_nblocks<DZ, 1>(lg, 0, dA, ze + (size_t)z0 * DZ, g, t);
    const float* l = lg[0];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int zi = z0 + 2 * t + c;
      if (zi < z) {
        if (l[c] > m.mx_a) { m.mx_a = l[c]; m.id_a = zi; }
        if (l[2 + c] > m.mx_b) { m.mx_b = l[2 + c]; m.id_b = zi; }
        if (zi == ta) m.lt_a = l[c];
        if (zi == tb) m.lt_b = l[2 + c];
      }
    }
  }
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1) {
    const float oa = __shfl_xor_sync(0xffffffffu, m.mx_a, s);
    const int ia = __shfl_xor_sync(0xffffffffu, m.id_a, s);
    const float ob = __shfl_xor_sync(0xffffffffu, m.mx_b, s);
    const int ib = __shfl_xor_sync(0xffffffffu, m.id_b, s);
    if (oa > m.mx_a || (oa == m.mx_a && ia < m.id_a)) { m.mx_a = oa; m.id_a = ia; }
    if (ob > m.mx_b || (ob == m.mx_b && ib < m.id_b)) { m.mx_b = ob; m.id_b = ib; }
    m.lt_a += __shfl_xor_sync(0xffffffffu, m.lt_a, s);
    m.lt_b += __shfl_xor_sync(0xffffffffu, m.lt_b, s);
  }
  return m;
}

// per row sum over valid zones of exp(logit - max), reduced over the lanes
template <int DZ>
__device__ __forceinline__ void row_sumexp(const uint32_t (&dA)[DZ / 16][4],
                                           const bf16* ze, int z, int zp,
                                           float mx_a, float mx_b, float& s_a,
                                           float& s_b, int g, int t) {
  s_a = 0.f;
  s_b = 0.f;
  for (int z0 = 0; z0 < zp; z0 += 8) {
    float lg[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    mma_nblocks<DZ, 1>(lg, 0, dA, ze + (size_t)z0 * DZ, g, t);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (z0 + 2 * t + c < z) {
        s_a += expf(lg[0][c] - mx_a);
        s_b += expf(lg[0][2 + c] - mx_b);
      }
    }
  }
#pragma unroll
  for (int s = 1; s <= 2; s <<= 1) {
    s_a += __shfl_xor_sync(0xffffffffu, s_a, s);
    s_b += __shfl_xor_sync(0xffffffffu, s_b, s);
  }
}

template <int DA, int DZ>
__global__ void __launch_bounds__(32 * kFwdWarps) ce_fwd_kernel(const CeParams p) {
  constexpr int KX = DA / 16, KZ = DZ / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long ra = ((long)blockIdx.x * kFwdWarps + warp) * 16 + g, rb = ra + 8;
  const bool va = ra < p.m, vb = rb < p.m;
  uint32_t xa[KX][4];
  ldg_rows_a<DA>(xa, p.x, ra, rb, va, vb, t);
  uint32_t dA[KZ][4];
  decode_rows<DA, DZ>(dA, xa, p.wdT, g, t);
  const int ta = va ? p.tgt[ra] : -1, tb = vb ? p.tgt[rb] : -1;
  const RowMax m = row_max<DZ>(dA, p.ze, p.z, p.zp, ta, tb, g, t);
  float s_a, s_b;
  row_sumexp<DZ>(dA, p.ze, p.z, p.zp, m.mx_a, m.mx_b, s_a, s_b, g, t);
  if (t == 0) {
    if (va) {
      p.nll[ra] = (logf(s_a) + m.mx_a) - m.lt_a;
      p.correct[ra] = m.id_a == ta ? 1 : 0;
    }
    if (vb) {
      p.nll[rb] = (logf(s_b) + m.mx_b) - m.lt_b;
      p.correct[rb] = m.id_b == tb ? 1 : 0;
    }
  }
}

// K3b's shared memory (byte offsets): the ring of ze boxes (kCeZC rows
// each, row stride DZ + 8) | d16 and gd16 of the tile's rows | two grow
// buffers (a box's zones) | bf16(x) of the tile's rows | the CTA's gze, f32
// (zr, DZ): the zones whose gradient stays in shared memory
template <int DA, int DZ, int W>
struct CeSmem {
  static constexpr int ROWS = 16 * W;
  static constexpr int SZE = DZ + 8;   // a ze box row, d16, gd16
  static constexpr int SX = DA + 8;    // bf16(x)
  static constexpr int SG = kCeZC + 8;  // grow
  static constexpr int kSlot = kCeZC * SZE;  // bf16 elements
  static constexpr int kSlots = 3;
  static constexpr int kD = kSlots * kSlot * 2;
  static constexpr int kGd = kD + ROWS * SZE * 2;
  static constexpr int kG = kGd + ROWS * SZE * 2;
  static constexpr int kX = kG + 2 * ROWS * SG * 2;
  static constexpr int kGze = kX + ROWS * SX * 2;
  static size_t bytes(int zr) { return kGze + (size_t)zr * DZ * sizeof(float); }
  // the most zones whose gze fits beside the rest
  static int max_resident() {
    return (int)((kCeMaxSmem - kGze) / (DZ * sizeof(float)));
  }
};

// K3b's ring: box i is the ze rows of zone box i mod nzc (a tile reads every
// box twice: the log-sum-exp's pass, then the gradient's), copied by
// cp.async 2 boxes ahead, rows past zp zeroed; one block barrier a box
template <int DZ, int W>
struct CeRing {
  static constexpr int SZE = DZ + 8, kSlot = kCeZC * SZE;
  bf16* base;
  const bf16* ze;
  int zp, nzc, c, total;

  __device__ void issue(int i) {
    if (i < total) {
      bf16* dst = base + (i % 3) * kSlot;
      const int z0 = (i % nzc) * kCeZC, nz = min(kCeZC, zp - z0);
      constexpr int per = DZ / 8;
      for (int e = threadIdx.x; e < kCeZC * per; e += 32 * W) {
        const int r = e / per, k = e - r * per;
        if (r < nz)
          sm90::cp_async16(dst + r * SZE + 8 * k,
                           ze + (size_t)(z0 + r) * DZ + 8 * k);
        else
          *reinterpret_cast<uint4*>(dst + r * SZE + 8 * k) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
    sm90::cp_commit();
  }

  __device__ const bf16* next() {
    sm90::cp_wait<1>();
    __syncthreads();
    issue(c + 2);
    return base + (c++ % 3) * kSlot;
  }
};

// K3b. A persistent CTA of W warps (16 W rows a tile) streams ze through
// its ring twice a tile: per row the max and the sum of exp of the logits
// (online, one pass), then per box the logits again, grow = bf16((p -
// onehot) g_nll), gd += grow ze (B fragments by ldmatrix.trans from the
// box) and the box's gze = grow^T d16 over the tile's rows (one block of 8
// dz columns a warp, deferred to the next box's barrier). gze stays in
// shared memory for the first zr zones (every zone at rung 2), one owner
// per element, written to the CTA's slab once; zones past zr go to the
// slab box by box. gWd accumulates in registers (a warp's 8 columns) and
// is written once.
template <int DA, int DZ, int W>
__global__ void __launch_bounds__(32 * W, 1) ce_bwd_kernel(const CeParams p) {
  using S = CeSmem<DA, DZ, W>;
  constexpr int ROWS = S::ROWS, SZE = S::SZE, SX = S::SX, SG = S::SG;
  constexpr int KX = DA / 16, KZ = DZ / 16, NX = DA / 8, NZ = DZ / 8;
  static_assert(NZ == W && kCeZC == 32, "a warp per 8 dz columns");
  extern __shared__ __align__(16) unsigned char ce_smem[];
  bf16* s_d = reinterpret_cast<bf16*>(ce_smem + S::kD);
  bf16* s_gd = reinterpret_cast<bf16*>(ce_smem + S::kGd);
  bf16* s_g = reinterpret_cast<bf16*>(ce_smem + S::kG);
  bf16* s_x = reinterpret_cast<bf16*>(ce_smem + S::kX);
  float* s_gze = reinterpret_cast<float*>(ce_smem + S::kGze);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  const int q = lane >> 3, rr = lane & 7;
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  const int n_tiles = (p.m + ROWS - 1) / ROWS;
  const int nzc = (p.zp + kCeZC - 1) / kCeZC;
  const int mine = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  for (int i = threadIdx.x; i < p.zr * DZ; i += 32 * W) s_gze[i] = 0.f;
  CeRing<DZ, W> ring{reinterpret_cast<bf16*>(ce_smem), p.ze, p.zp, nzc, 0,
                     mine * 2 * nzc};
  ring.issue(0);
  ring.issue(1);
  float gwd[2][4];
  zero(gwd);
  bool first = true;

  // gze[box cc] += grow^T d16 over the tile's rows: this warp's 8 columns
  auto contract = [&](int cc) {
    const bf16* gb = s_g + (cc & 1) * ROWS * SG;
    const int col = 8 * warp + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < ROWS; k0 += 16) {
        uint32_t af[4], bfr[2];
        ldsm_x4_trans(af, gb + (k0 + rr + 8 * (q >> 1)) * SG + 16 * i +
                              8 * (q & 1));
        ldsm_x2_trans(bfr, s_d + (k0 + rr + 8 * (q & 1)) * SZE + 8 * warp);
        mma(acc, af, bfr[0], bfr[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int zi = cc * kCeZC + 16 * i + g + 8 * h;
        if (zi >= p.z) continue;
        if (zi < p.zr) {
          float2* o = reinterpret_cast<float2*>(s_gze + zi * DZ + col);
          const float2 v = *o;
          *o = make_float2(v.x + acc[2 * h], v.y + acc[2 * h + 1]);
        } else {
          slab_put(slab + (size_t)zi * DZ + col, acc[2 * h], first);
          slab_put(slab + (size_t)zi * DZ + col + 1, acc[2 * h + 1], first);
        }
      }
    }
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long ra = (long)tile * ROWS + wr0 + g, rb = ra + 8;
    const bool va = ra < p.m, vb = rb < p.m;
    uint32_t xa[KX][4];
    ldg_rows_a<DA>(xa, p.x, ra, rb, va, vb, t);
    uint32_t dA[KZ][4];
    decode_rows<DA, DZ>(dA, xa, p.wdT, g, t);
    const int ta = va ? p.tgt[ra] : -1, tb = vb ? p.tgt[rb] : -1;
    // padded rows carry a zero upstream gradient
    const float gn_a = va ? p.gnll[ra] : 0.f, gn_b = vb ? p.gnll[rb] : 0.f;
    // the last tile's contractions are done with s_x, s_d and s_gd
    __syncthreads();
    sts_a<DA>(xa, s_x + wr0 * SX, SX, g, t);
    sts_a<DZ>(dA, s_d + wr0 * SZE, SZE, g, t);

    // pass 1: per row the max logit over valid zones and the sum of
    // exp(logit - max), online over the boxes, then over the 4 lanes
    float m_a = -INFINITY, m_b = -INFINITY, s_a = 0.f, s_b = 0.f;
    for (int c = 0; c < nzc; ++c) {
      const bf16* box = ring.next();
      float sc[4][4];
      zero(sc);
      sm90::mma_s<DZ, 4, 4>(sc, 0, dA, box, SZE, g, t);
      float ca = -INFINITY, cb = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c * kCeZC + 8 * j + 2 * t + (e & 1) < p.z) {
            if (e < 2) ca = fmaxf(ca, sc[j][e]);
            else cb = fmaxf(cb, sc[j][e]);
          }
      const float na = fmaxf(m_a, ca), nb = fmaxf(m_b, cb);
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c * kCeZC + 8 * j + 2 * t + (e & 1) < p.z) {
            if (e < 2) pa += expf(sc[j][e] - na);
            else pb += expf(sc[j][e] - nb);
          }
      if (na != -INFINITY) { s_a = s_a * expf(m_a - na) + pa; m_a = na; }
      if (nb != -INFINITY) { s_b = s_b * expf(m_b - nb) + pb; m_b = nb; }
    }
    // the lanes' (max, sum) pairs, combined in lane order (the same bits on
    // each lane); a lane with no valid zone holds (-inf, 0)
    auto combine = [&](float& m, float& s, int x) {
      const float om = __shfl_xor_sync(0xffffffffu, m, x);
      const float os = __shfl_xor_sync(0xffffffffu, s, x);
      const bool lo = (t & x) == 0;
      const float ml = lo ? m : om, sl = lo ? s : os;
      const float mh = lo ? om : m, sh = lo ? os : s;
      const float nm = fmaxf(ml, mh);
      s = (sl == 0.f ? 0.f : sl * expf(ml - nm)) +
          (sh == 0.f ? 0.f : sh * expf(mh - nm));
      m = nm;
    };
    combine(m_a, s_a, 1); combine(m_b, s_b, 1);
    combine(m_a, s_a, 2); combine(m_b, s_b, 2);

    // pass 2: per box grow = bf16((p - onehot) g_nll); gd += grow @ ze;
    // the box's gze after the next barrier
    float gd[NZ][4];
    zero(gd);
    for (int c = 0; c < nzc; ++c) {
      const bf16* box = ring.next();
      if (c > 0) contract(c - 1);
      float sc[4][4];
      zero(sc);
      sm90::mma_s<DZ, 4, 4>(sc, 0, dA, box, SZE, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int zi = c * kCeZC + 8 * j + 2 * t + (e & 1);
          const bool b = (e & 2) != 0;
          float gr = 0.f;
          if (zi < p.z) {
            const float pr = expf(sc[j][e] - (b ? m_b : m_a)) /
                             (b ? s_b : s_a);
            const float oh = zi == (b ? tb : ta) ? 1.f : 0.f;
            gr = (pr - oh) * (b ? gn_b : gn_a);
          }
          sc[j][e] = gr;
        }
      uint32_t gra[2][4];
      c_to_a<kCeZC>(sc, gra);
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
        for (int j = 0; j < NZ; j += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, box + (16 * s2 + 8 * (q & 1) + rr) * SZE + 8 * j +
                               8 * (q >> 1));
          mma(gd[j], gra[s2], b[0], b[1]);
          mma(gd[j + 1], gra[s2], b[2], b[3]);
        }
      sts_a<kCeZC>(gra, s_g + (c & 1) * ROWS * SG + wr0 * SG, SG, g, t);
    }

    // d = xb @ Wd: gx = bf16(gd) @ Wd^T per row; gWd += xb^T bf16(gd)
    uint32_t gda[KZ][4];
    c_to_a<DZ>(gd, gda);
    sts_a<DZ>(gda, s_gd + wr0 * SZE, SZE, g, t);
    float gx[NX][4];
    zero(gx);
#pragma unroll
    for (int j = 0; j < NX; ++j)
      mma_nblocks<DZ, 1>(gx, j, gda, p.wd + (size_t)8 * j * DZ, g, t);
    stg_rows_c<NX>(gx, p.gx, ra, rb, va, vb, t);
    __syncthreads();
    contract(nzc - 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k0 = 0; k0 < ROWS; k0 += 16) {
        uint32_t af[4], bfr[2];
        ldsm_x4_trans(af, s_x + (k0 + rr + 8 * (q >> 1)) * SX + 16 * i +
                              8 * (q & 1));
        ldsm_x2_trans(bfr, s_gd + (k0 + rr + 8 * (q & 1)) * SZE + 8 * warp);
        mma(gwd[i], af, bfr[0], bfr[1]);
      }
    first = false;
  }
  // the CTA's sums into its slab: gze (the resident zones; the rest went
  // box by box), then gWd
  __syncthreads();
  const int zres = p.z < p.zr ? p.z : p.zr;
  for (int i = threadIdx.x; i < zres * DZ; i += 32 * W) slab[i] = s_gze[i];
  float* sw = slab + (size_t)p.z * DZ;
  const int col = 8 * warp + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sw[(16 * i + g) * DZ + col] = gwd[i][0];
    sw[(16 * i + g) * DZ + col + 1] = gwd[i][1];
    sw[(16 * i + g + 8) * DZ + col] = gwd[i][2];
    sw[(16 * i + g + 8) * DZ + col + 1] = gwd[i][3];
  }
  sm90::cp_wait<0>();
}

bool shipping_widths(int da, int dz, int dc, int hdim) {
  return da == 32 && dz == 64 && dc == 32 && hdim == 128;
}

template <int W>
int launch_day_bwd(const DayBwdParams& p, cudaStream_t s) {
  auto* kernel = day_bwd_kernel<32, 64, 32, 128, W>;
  const size_t smem =
      sm90::Layout<32, 64, 32, 128>::bytes(16 * W, W, p.w.num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.num_ctas, 32 * W, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_slabs(p.slab, p.gsum, p.slab_size, p.num_ctas, s);
}

}  // namespace

extern "C" {

// Agent rows per tile of the day's reverse sweep for `num_blocks` residual
// blocks: 96 (6 warps) up to 2 blocks, 64 up to 5, 32 beyond (day_bwd_warps).
int ananke_day_bwd_tile_rows(int num_blocks) {
  return 16 * day_bwd_warps(num_blocks);
}

// Agent rows per tile of the cross-entropy's backward.
int ananke_ce_bwd_tile_rows() { return 16 * kCeWarps; }

// Floats of one CTA's slab of the day's reverse sweep.
long ananke_day_bwd_slab_size(int z, int num_blocks, int steps) {
  return Slab<32, 64, 32, 128>(z, num_blocks, 4 * steps).size;
}

// K2b on `stream`: the reverse sweep, then the slab reduction into gsum
// (layout: Slab with 4 * steps time rows). `slab` holds num_ctas slabs,
// zeroed, then num_ctas x ananke_day_bwd_tile_rows(num_blocks) x (5 da +
// hdim) floats of row state the kernel overwrites. `w` points at the 12
// weights in set_weights' order. Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for widths this file was not compiled
// for or bad sizes.
int ananke_day_backward(const void* xs, const void* gxs, const void* h,
                        const void* ze, const void* zeT, const void* tf,
                        const void* dts, const void* w0, const void* w1,
                        const void* w2, const void* w3, const void* w4,
                        const void* w5, const void* w6, const void* w7,
                        const void* w8, const void* w9, const void* w10,
                        const void* w11, void* gx0, void* gh, void* slab,
                        void* gsum, int n, int z, int zp, int num_blocks,
                        int steps, int num_ctas, int da, int dz, int dc,
                        int hdim, void* stream) {
  const int rows = ananke_day_bwd_tile_rows(num_blocks);
  const int n_tiles = (n + rows - 1) / rows;
  if (num_blocks < 1 || num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % 16 != 0 || zp < z || steps < 1 || num_ctas < 1 ||
      num_ctas > n_tiles || !shipping_widths(da, dz, dc, hdim)) {
    return (int)cudaErrorInvalidValue;
  }
  DayBwdParams p;
  const void* wts[12] = {w0, w1, w2, w3, w4, w5, w6, w7, w8, w9, w10, w11};
  set_weights(p.w, wts);
  p.w.ze = static_cast<const bf16*>(ze);
  p.w.zeT = static_cast<const bf16*>(zeT);
  p.w.z = z; p.w.zp = zp; p.w.num_blocks = num_blocks;
  p.xs = static_cast<const float*>(xs);
  p.gxs = static_cast<const float*>(gxs);
  p.h = static_cast<const float*>(h);
  p.tf = static_cast<const float*>(tf);
  p.dts = static_cast<const float*>(dts);
  p.gx0 = static_cast<float*>(gx0);
  p.gh = static_cast<float*>(gh);
  p.slab = static_cast<float*>(slab);
  p.gsum = static_cast<float*>(gsum);
  p.n = n; p.steps = steps; p.num_ctas = num_ctas;
  p.slab_size = ananke_day_bwd_slab_size(z, num_blocks, steps);
  p.state = p.slab + (size_t)num_ctas * p.slab_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (day_bwd_warps(num_blocks)) {
    case 6: return launch_day_bwd<6>(p, s);
    case 4: return launch_day_bwd<4>(p, s);
    default: return launch_day_bwd<2>(p, s);
  }
}

// K3f on `stream`: nll and the correct flag per row.
int ananke_ce_forward(const void* x, const void* tgt, const void* wdT,
                      const void* ze, void* nll, void* correct, int m, int z,
                      int zp, int da, int dz, void* stream) {
  if (m < 1 || z < 1 || zp % 16 != 0 || zp < z || da != 32 || dz != 64)
    return (int)cudaErrorInvalidValue;
  CeParams p = {};
  p.x = static_cast<const float*>(x);
  p.tgt = static_cast<const int*>(tgt);
  p.wdT = static_cast<const bf16*>(wdT);
  p.ze = static_cast<const bf16*>(ze);
  p.nll = static_cast<float*>(nll);
  p.correct = static_cast<int*>(correct);
  p.m = m; p.z = z; p.zp = zp;
  const int rows = 16 * kFwdWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ce_fwd_kernel<32, 64><<<(unsigned)((m + rows - 1) / rows), 32 * kFwdWarps,
                          0, s>>>(p);
  return (int)cudaGetLastError();
}

// K3b on `stream`: gx per row, then gze | gWd summed over the rows into
// gsum through at most 132 (kCeCtas) of the num_ctas slabs (written, not
// added: need no zeroing).
int ananke_ce_backward(const void* x, const void* tgt, const void* gnll,
                       const void* wdT, const void* wd, const void* ze,
                       const void* zeT, void* gx, void* slab, void* gsum,
                       int m, int z, int zp, int num_ctas, int da, int dz,
                       void* stream) {
  using S = CeSmem<32, 64, kCeWarps>;
  const int rows = 16 * kCeWarps;
  const int n_tiles = (m + rows - 1) / rows;
  if (m < 1 || z < 1 || zp % 16 != 0 || zp < z || num_ctas < 1 ||
      num_ctas > n_tiles || da != 32 || dz != 64)
    return (int)cudaErrorInvalidValue;
  CeParams p = {};
  p.x = static_cast<const float*>(x);
  p.tgt = static_cast<const int*>(tgt);
  p.gnll = static_cast<const float*>(gnll);
  p.wdT = static_cast<const bf16*>(wdT);
  p.wd = static_cast<const bf16*>(wd);
  p.ze = static_cast<const bf16*>(ze);
  p.zeT = static_cast<const bf16*>(zeT);
  p.gx = static_cast<float*>(gx);
  p.slab = static_cast<float*>(slab);
  p.gsum = static_cast<float*>(gsum);
  p.m = m; p.z = z; p.zp = zp;
  p.num_ctas = num_ctas < kCeCtas ? num_ctas : kCeCtas;
  p.zr = z < S::max_resident() ? z : S::max_resident();
  p.slab_size = (long)(z + da) * dz;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = ce_bwd_kernel<32, 64, kCeWarps>;
  const size_t bytes = S::bytes(p.zr);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.num_ctas, 32 * kCeWarps, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_slabs(p.slab, p.gsum, p.slab_size, p.num_ctas, s);
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
