// The discrete adjoint's kernels on Hopper (sm_90a): one DOPRI5 5(4) step
// of the GAT-ODE drift at float32 (K5), the VJP of one accepted step (K7)
// and the whole backward over every accepted step (K6). K5 at bf16 is the
// serving kernels' template's fifth kind, in fused_step.cu
// (ananke_dopri5_step_bf16 there).
//
// Replaces the Pallas TPU kernels
//   K5 ananke_abm_tpu/ops/pallas/fused_dopri5.py::dopri5_step_fused (at
//     precision="f32")
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
// trainers' forward and their float32 backward): bf16 rounding of the stage
// activations is noise that does not cancel in the embedded 5(4) error and
// floors the step controller, and TF32 alone keeps three decimal digits,
// the same class; so every product runs in 3xTF32 on the tensor cores:
// each operand split into a TF32 part and its remainder, three mma.sync
// products (lo hi, hi lo, hi hi), float32 sums, about 22 bits of each
// operand, the float32 class (checks.py's bounds part it from TF32 alone).
// bf16 (K7 and K6 at precision "bf16", the adaptive trainer's backward at
// bench rung 3): the stage and its VJP of stage_sm90.cuh (K8's and K2b's),
// bf16 operands on mma.sync with float32 sums at the reference's rounding
// points; a bf16 backward replays the forward's steps, so the noise moves
// the gradient, not the step sequence. (K5 at "bf16", the forward the
// reference keeps for loose tolerances, rtol >= ~1e-3, runs the same
// stage math on the serving template: fused_step.cu.)
//
// What bounds them on the card: operations. One stage is ~92 kMAC per agent
// at the shipping widths and Z = 64, its VJP about twice that; the bytes
// per agent are a few hundred a step (K6: the two checkpoints, read once,
// and the output rows' cotangents). At bench rung 3 K6 at bf16 needs ~5.6
// TFLOP, 5.7 ms at the dense bf16 peak, its bytes ~1 ms. The design:
//
// - K5 at float32: 3xTF32 mma.sync products, a weight ring shared by a
//   CTA's 8 warps (128 rows); the K5 section below.
// - The float32 step-VJP body (K7 and K6 at "f32"): the vjp32 section
//   below. Its FFMA predecessor ran at 14% of the FP32 rate, bound by
//   instruction issue on the CUDA cores (its products as adds ran slower,
//   PERF.md), its weights copied per 32-row tile (20% of its time). Here
//   one mma.sync does 256 of its multiply-adds (three a 3xTF32 product
//   tile), the weight gradients are contractions on the tensor cores too,
//   every weight box is split into its TF32 parts once a launch
//   (split_boxes) and copied once per 128-row tile by one bulk copy into a
//   ring that 8 warps share. What bounds it now is the work around the
//   products, not the tensor cores: the A operands' loads and splits, the
//   sums, the contractions' operand traffic, the transcendentals (PERF.md's
//   probes).
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
// - Neither can keep six stages of intermediates (~24 KB per agent): each
//   keeps the stage outputs k_j (and the cotangents) and recomputes stage
//   i's intermediates just before its VJP: 11 stage forwards and 6 stage
//   VJPs per step.
// - K6: one CTA owns an agent tile for all steps, the step loop inside the
//   block, so no grid-wide sync; the carries stay in the warp's scratch
//   between steps; the output times and rows'
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

#include "dopri5_tableau.cuh"
#include "drift_stage.cuh"
#include "stage_sm90.cuh"

namespace {

constexpr int DA = 32, DZ = 64, DC = 32, H = 128, DF = DA + DZ;
constexpr int kZC = 32;   // zones per attention chunk
constexpr int kMaxBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;
// the largest dynamic shared memory a block can use
constexpr size_t kMaxSmem = 232448;

// the Dormand-Prince tableau (dopri5_tableau.cuh)
using ananke::cA;
using ananke::cB5;
using ananke::cBE;
using ananke::cD;

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
  // the float32 step VJP's weight boxes, each split into its TF32 parts
  // (vjp32::split_boxes)
  float* bank;
  int z, zp, nb;
  float scale;
};


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

// acc[j0 + j] (j < NT) += A B in 3xTF32: A the warp's 16 rows by KS slices
// of 8 (af(s, a) gives slice s's fragment), B^T the NT 8-row tiles of a box
// at row stride S (row n holds output column n's weights, k contiguous; a
// thread's two values of a fragment are one float2). Per slice every B
// fragment is loaded and split first, then the products go term by term
// across the NT accumulators, so no two in a row depend.
template <int KS, int NT, int NOUT, class AF>
__device__ __forceinline__ void mma3_at(float (&acc)[NOUT][4], int j0, AF af,
                                        const float* bt, int S, int g,
                                        int t) {
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
    for (int j = 0; j < NT; ++j)
      mma_tf32(acc[j0 + j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_tf32(acc[j0 + j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_tf32(acc[j0 + j], ah, bh[j][0], bh[j][1]);
  }
}

// acc += A B in 3xTF32, every accumulator of acc (mma3_at)
template <int KS, int NT, class AF>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], AF af,
                                     const float* bt, int S, int g, int t) {
  mma3_at<KS, NT, NT>(acc, 0, af, bt, S, g, t);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// rows x cols floats (row stride ss) -> shared memory (row stride ds) by
// cp.async, every thread of the CTA taking 16-byte pieces in turn
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          int ss, int rows, int cols) {
  const int per = cols / 4, pieces = rows * per;
  for (int e = threadIdx.x; e < pieces; e += blockDim.x) {
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
using ananke::StageWeights;
using HLayout = ananke::sm90::Layout<DA, DZ, DC, H>;
template <int W>
using HRing = ananke::sm90::Ring<DA, DZ, DC, H, W>;

// warps of the bf16 step VJP's tile: the most whose rows fit the SM's
// shared memory beside the ring (HLayout::bytes): 6 (96 rows) up to 2
// blocks, 4 up to 5, 2 beyond
inline int vjp_bf16_warps(int nb) { return nb <= 2 ? 6 : nb <= 5 ? 4 : 2; }

// xin = x0 + sum_j (h a_st,j) k_j, summed in the tableau's order
__device__ __forceinline__ void frag_stage_input(float (&xin)[DA / 8][4],
                                                 const float* fr, int st,
                                                 float hs, int lane) {
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
}

// xa = bf16(the stage input)
__device__ __forceinline__ void bf16_stage_input(uint32_t (&xa)[DA / 16][4],
                                                 const float* fr, int st,
                                                 float hs, int lane) {
  float xin[DA / 8][4];
  frag_stage_input(xin, fr, st, hs, lane);
  ananke::c_to_a<DA>(xin, xa);
}

// stage st's cotangent: stage_cot, then h a_i,st gx_i for i = 6 .. st + 1 in
// the order the reference adds them (gx_i in slot i - 1)
__device__ __forceinline__ void frag_stage_cot(float (&gk)[DA / 8][4],
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
    frag_stage_cot(gk, fr, st, hs, lane);
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
  frag_stage_cot(gf, fr, 0, hs, lane);
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

// ---- the float32 step VJP: K7 at precision "f32", and K6's f32 body --------
//
// The bf16 body's walk (stage_sm90.cuh: a CTA of W warps, 16 W agent rows,
// each warp its 16 rows end to end, every weight box shared through one
// ring in shared memory, the step state in a warp-private scratch) with
// 3xTF32 products on mma.sync, the weight gradients' contractions over the
// tile's rows among them, float32 sums at the plain version's points but in
// other orders. What sets its shape:
// - 8 warps (128 rows), two a sub-partition as in K5: one warp a
//   sub-partition (3 warps, 48 rows, when every activation row sat in
//   shared memory) left each warp's latencies exposed and ran slower than
//   the FFMA body. Shared memory holds the ring and two H-wide rows a tile
//   row, X and Y (139 KB at 128 rows), at any depth: the stage's chain
//   lives in X in place as in K5's stage, and X and Y hold the two
//   operands of each contraction over the tile's rows.
// - what the VJP reads of its stage's forward (x, ctx, q and the chain's
//   levels 0 .. nb, 2.2 KB a row at two blocks) is kept in the warp's
//   scratch in device memory (fragment order, coalesced, each thread
//   reading back only what it wrote) and copied into X or Y where a
//   contraction or a product takes it.
// - the weights are split into their TF32 parts once a launch
//   (split_boxes), box by box in a ring slot's layout (the bank), so no
//   warp splits a weight; a box goes to its slot by one bulk copy (TMA)
//   that one thread issues, one box ahead (two slots of 39 KB: the parts
//   take twice the float32 box), one block barrier a box.
// - the sums: the tensor core's accumulation truncates, and over a 48-term
//   chain (3 terms of 16 slices) that bias took K6's readings at 8 blocks
//   past DOPRI5_BWD_BOUNDS' max (PERF.md); so each pair of slices
//   goes into a zeroed partial that a float32 add rounds into the sum, and
//   each operand's TF32 part is its rounding to nearest, not its
//   truncation (split_rn). The contractions over the tile's rows, whose
//   error reaches no later product, keep K5's split and one chain.
// - accumulators are the next product's A operand where one product feeds
//   the next (q, the scores, the context, the blocks' inner activation,
//   the stage's cotangents through W3 and W1xc): the rest come from the
//   warp's own rows of X or Y (frag_smem), read as float2, each thread
//   reading the positions it wrote.
// - the weight gradients are 16 x 32 or 32 x 32 output blocks dealt to the
//   warps in turn (nt_dot), read-modify-written in the CTA's slab once a
//   tile and product; the bias and time-row gradients are column sums over
//   the tile's rows in a fixed order. No atomics.
namespace vjp32 {

using k5::frag_regs;
using k5::frag_smem;
using k5::mma_tf32;
using k5::split;
using k5::zero;

constexpr int SQ = DZ + 8;    // row strides (floats), 8 mod 32, so that the
constexpr int SH = H + 8;     //   8 rows a fragment reads hit distinct
constexpr int SX = DA + 8;    //   banks: the zones' box, X and Y, DA rows
constexpr int kZB = 32;       // zones a box
// floats of a box's TF32 parts, and again of their remainders (kPlane on):
// the largest box, the zones'
constexpr int kPlane = kZB * SQ + DZ * (kZB + 8);
constexpr int kBox = 2 * kPlane;  // floats of a box, and of a ring slot
constexpr int kSlots = 2;
constexpr int kMaxW = 8;      // warps a CTA at most
static_assert(DZ * SX <= kPlane && 32 * SH <= kPlane && 64 * SX <= kPlane &&
                  DA * SQ <= kPlane && kPlane % 4 == 0,
              "box shapes");
static_assert(DF + DC == H && DF == 3 * 32 && DC == 32 && kZB == kZC &&
                  2 * DZ == H,
              "the W1 quarters hold [W1xc^T | W1h^T]; W1xc by 32 rows; Y "
              "holds [gctx | q]");

// a warp's saved stage, after its step state in its scratch (fragment
// order): x | ctx | q | the chain's levels 0 .. nb
constexpr int kFQ = (DZ / 8) * 4 * 32;   // floats of a DZ-wide array
constexpr int kFH = (H / 8) * 4 * 32;    // floats of an H-wide array
constexpr int kSvCtx = kFX, kSvQ = kFX + kFQ, kSvLevels = kFX + 2 * kFQ;

// floats of a warp's scratch at nb blocks: the step state, its saved stage
__host__ __device__ constexpr long warp_floats(int nb) {
  return kWarpFloats + kSvLevels + (long)(nb + 1) * kFH;
}

// floats of a CTA's dynamic shared memory at `warps` warps: the ring, the
// X and Y rows, the ring's mbarriers
__host__ __device__ constexpr size_t smem_floats(int warps) {
  return (size_t)kSlots * kBox + (size_t)2 * 16 * warps * SH + 2 * kSlots;
}

// the most warps (up to kMaxW) whose rows fit the SM's shared memory beside
// the ring and `extra` bytes (K6's output times): 8 with none; 0 if not
// even one fits
inline int warps_for(size_t extra) {
  for (int w = kMaxW; w >= 1; --w)
    if (smem_floats(w) * sizeof(float) + extra <= kMaxSmem) return w;
  return 0;
}

// A tile's shared memory (16 rows a warp): the ring | X [rows][SH] | Y
// [rows][SH] | the ring's mbarriers
struct Smem {
  __device__ __forceinline__ static float* base() {
    extern __shared__ __align__(16) float vjp32_smem[];
    return vjp32_smem;
  }
  __device__ __forceinline__ static int rows() { return blockDim.x >> 1; }
  __device__ __forceinline__ static float* ring() { return base(); }
  __device__ __forceinline__ static float* x() {
    return base() + kSlots * kBox;
  }
  __device__ __forceinline__ static float* y() { return x() + rows() * SH; }
  __device__ __forceinline__ static float* bars() {
    return y() + rows() * SH;
  }
};

// x = hi + lo: hi is x rounded to TF32 (the nearest value with the low 13
// mantissa bits clear, ties away from zero), lo = x - hi exactly, of either
// sign and at most half hi's last place, of which the tensor core reads
// the top 11 bits: x to about 2^-23 |x|, without a bias toward zero
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc[j0 + j] (j < NT) += A B in 3xTF32: A the warp's 16 rows by KS slices
// of 8 (af(s, a) gives slice s's fragment, split here), B^T the NT 8-row
// tiles of a ring box at row stride S, its TF32 parts there and their
// remainders kPlane floats on (row n holds output column n's weights, k
// contiguous; a thread's two values of a fragment are one float2). The
// tensor core's sums truncate, so two slices at a time go into a zeroed
// partial that a float32 add then rounds into acc.
template <int KS, int NT, int NOUT, class AF>
__device__ __forceinline__ void mma3_at(float (&acc)[NOUT][4], int j0, AF af,
                                        const float* bt, int S, int g,
                                        int t) {
  static_assert(KS % 2 == 0, "slices in pairs");
  const float* bp = bt + g * S + 2 * t;
#pragma unroll
  for (int s0 = 0; s0 < KS; s0 += 2) {
    float pt[NT][4];
    zero(pt);
#pragma unroll
    for (int s = s0; s < s0 + 2; ++s) {
      float a[4];
      af(s, a);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_rn(a[e], ah[e], al[e]);
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 h =
            *reinterpret_cast<const float2*>(bp + 8 * j * S + 8 * s);
        const float2 l = *reinterpret_cast<const float2*>(
            bp + kPlane + 8 * j * S + 8 * s);
        bh[j][0] = __float_as_uint(h.x); bh[j][1] = __float_as_uint(h.y);
        bl[j][0] = __float_as_uint(l.x); bl[j][1] = __float_as_uint(l.y);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(pt[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(pt[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(pt[j], ah, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + j][e] += pt[j][e];
  }
}

// acc += A B in 3xTF32, every accumulator of acc (mma3_at)
template <int KS, int NT, class AF>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], AF af,
                                     const float* bt, int S, int g, int t) {
  mma3_at<KS, NT, NT>(acc, 0, af, bt, S, g, t);
}

// The weight boxes. A period, one step, consumes the boxes of 5 stage
// forwards (F), then of 6 (F, B) pairs, then the h rows' box:
//   F: Wq^T (DZ x DA) | zones x nzc | W1 quarters (32 rows of [W1xc^T |
//      W1h^T]) | per block the quarters of Wr1^T, then of Wr2^T (32 x H) |
//      W3^T (DA x H)
//   B: W3 halves (64 x DA) | per block, last first: the quarters of Wr1^T,
//      Wr2, Wr1 | W1xc by 32 rows | zones x nzc (the attention VJP's first
//      pass), again (its second) | Wq (DA x DZ)
//   h: W1h (DC x H)
// A zones box is 32 rows of ze (stride SQ) beside ze^T's same 32 columns
// (DZ x 32, stride 40). The distinct boxes sit in the bank (w.bank) in the
// layout a ring slot takes, kBox floats each, their TF32 parts and then
// their remainders: the F boxes in that order (ids 0 .. fwd - 1), then the
// W3 halves, per block the quarters of Wr2 and of Wr1, W1xc's three, Wq and
// W1h. split_boxes writes it once a launch; a ring slot takes a box by one
// linear copy.
struct Boxes {
  __host__ __device__ static int nzc(int zp) { return zp / kZB; }
  __host__ __device__ static int fwd(int zp, int nb) {
    return 6 + nzc(zp) + 8 * nb;
  }
  __host__ __device__ static int vjp(int zp, int nb) {
    return 6 + 12 * nb + 2 * nzc(zp);
  }
  __host__ __device__ static int period(int zp, int nb) {
    return 11 * fwd(zp, nb) + 6 * vjp(zp, nb) + 1;
  }
  // boxes in the bank
  __host__ __device__ static int count(int zp, int nb) {
    return fwd(zp, nb) + 7 + 8 * nb;
  }

  // the bank's box for box i of a period
  __device__ static int id(const Weights& w, int i) {
    const int nz = nzc(w.zp), nb = w.nb, nf = fwd(w.zp, nb),
              nv = vjp(w.zp, nb);
    if (i >= 5 * nf + 6 * (nf + nv)) return nf + 6 + 8 * nb;  // W1h
    int k = i % nf;
    if (i >= 5 * nf) {
      k = (i - 5 * nf) % (nf + nv);
      if (k < nf) return k;
      k -= nf;
    } else {
      return k;
    }
    if (k < 2) return nf + k;  // W3 halves
    if (k < 2 + 12 * nb) {
      const int kk = k - 2, b = nb - 1 - kk / 12, r = kk % 12;
      return r < 4 ? nz + 5 + 8 * b + r : nf + 2 + 8 * b + (r - 4);
    }
    if (k < 5 + 12 * nb) return nf + 2 + 8 * nb + (k - 2 - 12 * nb);
    if (k < nv - 1) {
      const int zc = k - 5 - 12 * nb;
      return 1 + (zc < nz ? zc : zc - nz);
    }
    return nf + 5 + 8 * nb;  // Wq
  }

  // piece `seg` (0 or 1) of bank box `b`: rows x cols floats from src (row
  // stride ss) to the box's plane from float `at` (row stride ds); false
  // past the box's pieces
  __device__ static bool piece(const Weights& w, int b, int seg,
                               const float*& src, int& ss, int& rows,
                               int& cols, int& ds, int& at) {
    const int nz = nzc(w.zp), nb = w.nb, nf = fwd(w.zp, nb);
    at = 0;
    if (b >= 1 && b <= nz) {  // zones: ze's rows, then ze^T's columns
      const int z0 = kZB * (b - 1);
      if (seg == 0) {
        src = w.ze + (size_t)z0 * DZ; ss = DZ; rows = kZB; cols = DZ;
        ds = SQ;
      } else {
        src = w.zeT + z0; ss = w.zp; rows = DZ; cols = kZB; ds = kZB + 8;
        at = kZB * SQ;
      }
      return true;
    }
    if (b > nz && b <= nz + 4) {  // W1 quarters: [W1xc^T | W1h^T]
      const int qq = b - nz - 1;
      if (seg == 0) {
        src = w.w1xcT + (size_t)32 * qq * DF; ss = DF; cols = DF;
      } else {
        src = w.w1hT + (size_t)32 * qq * DC; ss = DC; cols = DC; at = DF;
      }
      rows = 32; ds = SH;
      return true;
    }
    if (seg) return false;
    rows = 32; cols = H; ss = H; ds = SH;
    if (b == 0) {
      src = w.wqT; ss = DA; rows = DZ; cols = DA; ds = SX;
    } else if (b < nf - 1) {  // F: Wr1^T, Wr2^T quarters
      const int kk = b - nz - 5, m = 2 * (kk >> 3) + ((kk >> 2) & 1);
      src = w.wrT + ((size_t)m * H + 32 * (kk & 3)) * H;
    } else if (b == nf - 1) {
      src = w.w3T; rows = DA;
    } else if (b < nf + 2) {  // W3 halves
      src = w.w3 + (size_t)64 * (b - nf) * DA; ss = DA; rows = 64;
      cols = DA; ds = SX;
    } else if (b < nf + 2 + 8 * nb) {  // Wr2, then Wr1 quarters
      const int kk = b - nf - 2, blk = kk >> 3, r = kk & 7;
      src = w.wr + ((size_t)(2 * blk + (r < 4)) * H + 32 * (r & 3)) * H;
    } else if (b < nf + 5 + 8 * nb) {  // W1xc by 32 rows
      src = w.w1xc + (size_t)32 * (b - nf - 2 - 8 * nb) * H;
    } else if (b == nf + 5 + 8 * nb) {
      src = w.wq; ss = DZ; rows = DA; cols = DZ; ds = SQ;
    } else {
      src = w.w1h; rows = DC;
    }
    return true;
  }
};

// the bank: every weight box of the step VJP split into its TF32 parts
// (split_rn), box blockIdx.x a CTA
__global__ void __launch_bounds__(256)
    split_boxes(const Weights w) {
  float* box = w.bank + (size_t)blockIdx.x * kBox;
  for (int seg = 0; seg < 2; ++seg) {
    const float* src;
    int ss, rows, cols, ds, at;
    if (!Boxes::piece(w, blockIdx.x, seg, src, ss, rows, cols, ds, at))
      break;
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e - r * cols;
      uint32_t hi, lo;
      split_rn(src[(size_t)r * ss + c], hi, lo);
      box[at + r * ds + c] = __uint_as_float(hi);
      box[kPlane + at + r * ds + c] = __uint_as_float(lo);
    }
  }
}

// The weight ring: box i of the launch goes to slot i % kSlots, one box
// ahead of the one the warps read, by one bulk copy (TMA, no tensor map) of
// its bank box that the CTA's first thread issues and the slot's mbarrier
// counts in; every thread takes the boxes in that order, one block barrier
// a box.
struct Ring {
  int c;  // boxes consumed, the same in every thread

  __device__ __forceinline__ static int period(const Weights& w) {
    return Boxes::period(w.zp, w.nb);
  }
  __device__ __forceinline__ static float* slot(int i) {
    return Smem::ring() + (i % kSlots) * kBox;
  }
  __device__ __forceinline__ static uint32_t bar(int i) {
    return static_cast<uint32_t>(
               __cvta_generic_to_shared(Smem::bars())) + 8 * (i % kSlots);
  }
  // box i into its slot (the CTA's first thread, once every thread is done
  // with the box the slot held: a block barrier, then this proxy fence)
  __device__ static void issue(const Weights& w, int i) {
    const float* src = w.bank + (size_t)Boxes::id(w, i % period(w)) * kBox;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(slot(i)));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar(i)), "r"(kBox * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(kBox * 4), "r"(bar(i))
        : "memory");
  }
  // box i landed (every thread); a copy that never lands fails the launch
  // (trap) rather than hang the card
  __device__ static void wait(int i) {
    const int parity = (i / kSlots) & 1;
    for (int k = 0;; ++k) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred P;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
          "selp.b32 %0, 1, 0, P;\n}\n"
          : "=r"(done)
          : "r"(bar(i)), "r"(parity)
          : "memory");
      if (done) return;
      if (k == (1 << 24)) __trap();
    }
  }
  // the slots' barriers and the launch's first box (every thread)
  __device__ static void prime(const Weights& w) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar(s))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      issue(w, 0);
    }
    __syncthreads();
  }
  // box i, issued and not consumed, landed before the CTA exits (every
  // thread)
  __device__ static void drain(int i) { wait(i); }
  // The next box, landed. The barrier before it tells that every warp is
  // done with the box before, whose slot then takes the next box's copy.
  __device__ const float* next(const Weights& w) {
    __syncthreads();
    if (threadIdx.x == 0) issue(w, c + 1);
    wait(c);
    return slot(c++);
  }
};

// accumulator tiles -> the warp's 16 rows in shared memory (row stride S),
// tile j at column 8 j
template <int NT>
__device__ __forceinline__ void st_c(const float (&c)[NT][4], float* rows,
                                     int S, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(rows + g * S + 8 * j + 2 * t) =
        make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(rows + (g + 8) * S + 8 * j + 2 * t) =
        make_float2(c[j][2], c[j][3]);
  }
}

// the accumulator-layout values of the 8 columns from `col` of the warp's
// rows in shared memory
__device__ __forceinline__ void ld_c(float (&v)[4], const float* rows, int S,
                                     int col, int g, int t) {
  const float2 a = *reinterpret_cast<const float2*>(rows + g * S + col + 2 * t);
  const float2 b =
      *reinterpret_cast<const float2*>(rows + (g + 8) * S + col + 2 * t);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// the NT tiles of a saved array (fragment order) -> the warp's 16 rows in
// shared memory from column `col` (row stride S)
template <int NT>
__device__ __forceinline__ void sv_to_rows(const float* sv, float* rows,
                                           int S, int col, int g, int t,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* p = sv + 4 * j * 32 + lane;
    *reinterpret_cast<float2*>(rows + g * S + col + 8 * j + 2 * t) =
        make_float2(p[0], p[32]);
    *reinterpret_cast<float2*>(rows + (g + 8) * S + col + 8 * j + 2 * t) =
        make_float2(p[64], p[96]);
  }
}

// tile j of an accumulator-layout array -> its slots of a saved array
__device__ __forceinline__ void sv_st(const float (&c)[4], float* sv, int j,
                                      int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) sv[(4 * j + e) * 32 + lane] = c[e];
}

// out (M x N, row stride N) += A1^T B1 [+ A2^T B2] over the tile's rows, in
// 3xTF32: A (rows x M) and B (rows x N) row-major in shared memory. Output
// blocks of 16 MT x 32 are dealt to the warps in turn (MT 2 where there are
// blocks for every warp: a B fragment split once serves twice the
// products); a block's 8-row slice takes one A fragment (split once) for
// its four tiles of each 16 rows, and the block's slab values are read in
// one round trip before its products. Rows of out at or past m_valid are
// neither read nor written. Every thread calls it, after a barrier that
// lands the operands.
template <int M, int N, bool TWO, int MT = 1>
__device__ __forceinline__ void nt_dot(const float* A1, int sa1,
                                       const float* B1, int sb1,
                                       const float* A2, int sa2,
                                       const float* B2, int sb2, float* out,
                                       int m_valid) {
  static_assert(N % 32 == 0 && M % (16 * MT) == 0, "blocks");
  constexpr int NB = N / 32, BLOCKS = (M / (16 * MT)) * NB;
  const int warps = blockDim.x >> 5, rows = 16 * warps;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int blk = threadIdx.x >> 5; blk < BLOCKS; blk += warps) {
    const int m0 = (blk / NB) * 16 * MT, n0 = (blk % NB) * 32;
    float acc[MT][4][4], old[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int ma = m0 + 16 * i + g, mb = ma + 8;
      const bool va = ma < m_valid, vb = mb < m_valid;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float2 z2 = make_float2(0.f, 0.f);
        const float2 lo =
            va ? *reinterpret_cast<const float2*>(out + ma * N + c) : z2;
        const float2 hi =
            vb ? *reinterpret_cast<const float2*>(out + mb * N + c) : z2;
        old[i][j][0] = lo.x; old[i][j][1] = lo.y;
        old[i][j][2] = hi.x; old[i][j][3] = hi.y;
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
      }
    }
    // one 8-row slice of A^T B: row k0 + t is mma k t, k0 + t + 4 is t + 4
    auto slice = [&](const float* A, int sa, const float* B, int sb,
                     int k0) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a0 = A + (k0 + t) * sa + m0 + 16 * i + g;
        const float* a1 = a0 + 4 * sa;
        split(a0[0], ah[i][0], al[i][0]);
        split(a0[8], ah[i][1], al[i][1]);
        split(a1[0], ah[i][2], al[i][2]);
        split(a1[8], ah[i][3], al[i][3]);
      }
      const float* b0 = B + (k0 + t) * sb + n0 + g;
      const float* b1 = b0 + 4 * sb;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(b0[8 * j], bh[j][0], bl[j][0]);
        split(b1[8 * j], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    };
#pragma unroll 2
    for (int k0 = 0; k0 < rows; k0 += 8) {
      slice(A1, sa1, B1, sb1, k0);
      if (TWO) slice(A2, sa2, B2, sb2, k0);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int ma = m0 + 16 * i + g, mb = ma + 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (ma < m_valid)
          *reinterpret_cast<float2*>(out + ma * N + c) = make_float2(
              old[i][j][0] + acc[i][j][0], old[i][j][1] + acc[i][j][1]);
        if (mb < m_valid)
          *reinterpret_cast<float2*>(out + mb * N + c) = make_float2(
              old[i][j][2] + acc[i][j][2], old[i][j][3] + acc[i][j][3]);
      }
    }
  }
}

template <int M, int N, int MT = 1>
__device__ __forceinline__ void nt_dot1(const float* A, int sa, const float* B,
                                        int sb, float* out) {
  nt_dot<M, N, false, MT>(A, sa, B, sb, nullptr, 0, nullptr, 0, out, M);
}

// out[n] += the sum over the tile's rows of B[r][n], n < N, in a fixed
// order (four running sums over the rows mod 4): a bias or time-row
// gradient. Every thread calls it, after a barrier that lands B.
template <int N>
__device__ __forceinline__ void colsum(const float* B, int sb, float* out) {
  const int rows = Smem::rows();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int r = 0; r < rows; r += 4) {
      s0 += B[r * sb + n];
      s1 += B[(r + 1) * sb + n];
      s2 += B[(r + 2) * sb + n];
      s3 += B[(r + 3) * sb + n];
    }
    out[n] += (s0 + s1) + (s2 + s3);
  }
}

// k = stage(x) for the warp's 16 rows (wr0: its first row in the tile): x,
// k 16 x DA tiles in accumulator layout, h the rows' context (read from
// device memory, rows past n as zeros), tfs the stage's time row; the
// chain in the warp's rows of X, in place. With sv, what the VJP reads is
// kept there: x, ctx, q and the chain's levels. Returns the softmax's row
// normalisers. Every thread of the CTA calls it (the ring's barriers).
__device__ __forceinline__ void stage_fwd(const Weights& w, Ring& ring,
                                          const float (&x)[4][4],
                                          const float* h, long ra, long rb,
                                          bool va, bool vb, const float* tfs,
                                          float (&k)[4][4], float& inv_a,
                                          float& inv_b, float* sv, int wr0,
                                          int g, int t, int lane) {
  float* zr = Smem::x() + wr0 * SH;
  // q = x Wq
  float q[8][4];
  zero(q);
  mma3<4>(q, [&](int s, float (&a)[4]) { frag_regs(x[s], a); },
          ring.next(w), SX, g, t);
  if (sv) {
    ananke::frag_st<4>(x, sv, lane);
    ananke::frag_st<8>(q, sv + kSvQ, lane);
  }
  // the attention by boxes of 32 zones: p = exp(min(q ze^T scale, 80)) (0
  // past z), ctx = (sum of p ze) / (sum of p)
  float ctx[8][4], rs_a = 0.f, rs_b = 0.f;
  zero(ctx);
#pragma unroll 1
  for (int z0 = 0; z0 < w.zp; z0 += kZB) {
    const float* box = ring.next(w);
    float sc[4][4];
    zero(sc);
    mma3<8>(sc, [&](int s, float (&a)[4]) { frag_regs(q[s], a); }, box, SQ,
            g, t);
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
            box + kZB * SQ, kZB + 8, g, t);
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    rs_a += __shfl_xor_sync(kFull, rs_a, m);
    rs_b += __shfl_xor_sync(kFull, rs_b, m);
  }
  inv_a = 1.f / rs_a;
  inv_b = 1.f / rs_b;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ctx[j][0] *= inv_a; ctx[j][1] *= inv_a;
    ctx[j][2] *= inv_b; ctx[j][3] *= inv_b;
  }
  if (sv) ananke::frag_st<8>(ctx, sv + kSvCtx, lane);
  // z = tanh([x | ctx | h] [W1xc; W1h] + tf), by quarters of its columns:
  // chain level 0
  float hf[DC / 8][4];
  ananke::ldg_rows_c<DC / 8>(hf, h, ra, rb, va, vb, t);
  float* lv = sv ? sv + kSvLevels : nullptr;
#pragma unroll 1
  for (int qq = 0; qq < 4; ++qq) {
    const float* box = ring.next(w);
    float acc[4][4];
    zero(acc);
    mma3<16>(acc, [&](int s, float (&a)[4]) {
      if (s < 4) frag_regs(x[s & 3], a);
      else if (s < 12) frag_regs(ctx[(s - 4) & 7], a);
      else frag_regs(hf[(s - 12) & 3], a);
    }, box, SH, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 32 * qq + 8 * j + 2 * t;
      const float2 tf = __ldg(reinterpret_cast<const float2*>(tfs + n));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = tanhf(acc[j][e] + ((e & 1) ? tf.y : tf.x));
      *reinterpret_cast<float2*>(zr + g * SH + n) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(zr + (g + 8) * SH + n) =
          make_float2(acc[j][2], acc[j][3]);
      if (lv) sv_st(acc[j], lv, 4 * qq + j, lane);
    }
  }
  // residual blocks: rt = tanh(z Wr1 + br1) (registers), then z = tanh(z +
  // rt Wr2 + br2) in place: the next level
#pragma unroll 1
  for (int b = 0; b < w.nb; ++b) {
    const float* br1 = w.br + (2 * b) * H;
    const float* br2 = w.br + (2 * b + 1) * H;
    float rt[16][4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float* box = ring.next(w);
      float acc[4][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) {
        frag_smem(zr, SH, s, a, g, t);
      }, box, SH, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bb = __ldg(
            reinterpret_cast<const float2*>(br1 + 32 * qq + 8 * j + 2 * t));
        rt[4 * qq + j][0] = tanhf(acc[j][0] + bb.x);
        rt[4 * qq + j][1] = tanhf(acc[j][1] + bb.y);
        rt[4 * qq + j][2] = tanhf(acc[j][2] + bb.x);
        rt[4 * qq + j][3] = tanhf(acc[j][3] + bb.y);
      }
    }
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      const float* box = ring.next(w);
      float acc[4][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) { frag_regs(rt[s], a); }, box,
               SH, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * qq + 8 * j;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(br2 + n + 2 * t));
        float zi[4];
        ld_c(zi, zr, SH, n, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = tanhf(zi[e] + acc[j][e] + ((e & 1) ? bb.y : bb.x));
        *reinterpret_cast<float2*>(zr + g * SH + n + 2 * t) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(zr + (g + 8) * SH + n + 2 * t) =
            make_float2(acc[j][2], acc[j][3]);
        if (lv) sv_st(acc[j], lv + (b + 1) * kFH, 4 * qq + j, lane);
      }
    }
  }
  // k = z W3 + b3
  zero(k);
  mma3<16>(k, [&](int s, float (&a)[4]) { frag_smem(zr, SH, s, a, g, t); },
           ring.next(w), SH, g, t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 bb =
        __ldg(reinterpret_cast<const float2*>(w.b3 + 8 * j + 2 * t));
    k[j][0] += bb.x; k[j][1] += bb.y; k[j][2] += bb.x; k[j][3] += bb.y;
  }
}

// The VJP of the last stage_fwd (which kept its stage in sv; the chain's
// level nb in X) at cotangent gk (the warp's rows, 16 x DA in accumulator
// layout; inv_a, inv_b its softmax normalisers): gx (accumulator layout)
// into gx_slot (the warp's scratch, fragment order), the cotangent of
// Dense_0's h-row pre-activation added into ghp ([H / 8 * 4][32], fragment
// order), the summed gradients into the slab (the time row's at gtf).
// Each contraction's operands go into X and Y (zr, or: the rows holding
// the chain's level, which alternate between X and Y down the blocks),
// every warp's own rows, before a barrier. Every thread of the CTA calls
// it.
__device__ __forceinline__ void stage_bwd(const Weights& w, Ring& ring,
                                          const float (&gk)[4][4],
                                          float inv_a, float inv_b,
                                          float* slab, const SlabLayout& L,
                                          long gtf, float* gx_slot,
                                          float* ghp, const float* sv,
                                          int wr0, int g, int t, int lane) {
  const int nb = w.nb;
  float* zr = Smem::x();  // the chain's level nb, every warp's rows
  float* orr = Smem::y();
  const int o = wr0 * SH;  // the warp's rows
  // k = z W3 + b3: gW3 += z^T gk, gb3 += sum gk, gz = gk W3^T (gk in Y;
  // every warp's rows land before the W3 boxes' barriers)
  st_c(gk, orr + o, SH, g, t);
  float gz[16][4];
  zero(gz);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    mma3_at<4, 8>(gz, 8 * hf,
                  [&](int s, float (&a)[4]) { frag_regs(gk[s], a); },
                  ring.next(w), SX, g, t);
  nt_dot1<H, DA>(zr, SH, orr, SH, slab + L.gw3);
  colsum<DA>(orr, SH, slab + L.gb3);
  // residual blocks, reversed: z_out = tanh(z_in + rt Wr2 + br2), rt =
  // tanh(z_in Wr1 + br1); z_out in zr's rows, the other rows free
#pragma unroll 1
  for (int b = nb - 1; b >= 0; --b) {
    const float* br1 = w.br + (2 * b) * H;
    const float* zin = sv + kSvLevels + b * kFH;
    // gpre = gz (1 - z_out^2) into the other rows, z_in into zr's (every
    // warp done with both: the barrier)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float zo[4];
      ld_c(zo, zr + o, SH, 8 * j, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gz[j][e] = __fmul_rn(gz[j][e], __fsub_rn(1.f, __fmul_rn(zo[e], zo[e])));
    }
    __syncthreads();
    st_c(gz, orr + o, SH, g, t);
    sv_to_rows<16>(zin, zr + o, SH, 0, g, t, lane);
    // rt recomputed (registers), then in zr's rows over z_in
    float rt[16][4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float* box = ring.next(w);
      float acc[4][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) {
        frag_smem(zr + o, SH, s, a, g, t);
      }, box, SH, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 bb = __ldg(
            reinterpret_cast<const float2*>(br1 + 32 * qq + 8 * j + 2 * t));
        rt[4 * qq + j][0] = tanhf(acc[j][0] + bb.x);
        rt[4 * qq + j][1] = tanhf(acc[j][1] + bb.y);
        rt[4 * qq + j][2] = tanhf(acc[j][2] + bb.x);
        rt[4 * qq + j][3] = tanhf(acc[j][3] + bb.y);
      }
    }
    st_c(rt, zr + o, SH, g, t);
    __syncthreads();
    // gWr2 += rt^T gpre, gbr2 += sum gpre
    nt_dot1<H, H, 2>(zr, SH, orr, SH, slab + L.wr2(b));
    colsum<H>(orr, SH, slab + L.br2(b));
    // gpre2 = (gpre Wr2^T) (1 - rt^2) in place of rt (the boxes' barriers
    // order it after every warp's nt_dot)
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      const float* box = ring.next(w);
      float acc[4][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) {
        frag_smem(orr + o, SH, s, a, g, t);
      }, box, SH, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * qq + 8 * j;
        float rv[4];
        ld_c(rv, zr + o, SH, n, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fmul_rn(acc[j][e],
                                __fsub_rn(1.f, __fmul_rn(rv[e], rv[e])));
        *reinterpret_cast<float2*>(zr + o + g * SH + n + 2 * t) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(zr + o + (g + 8) * SH + n + 2 * t) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    // gz = gpre + gpre2 Wr1^T
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float* box = ring.next(w);
      float acc[4][4];
      zero(acc);
      mma3<16>(acc, [&](int s, float (&a)[4]) {
        frag_smem(zr + o, SH, s, a, g, t);
      }, box, SH, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float gp[4];
        ld_c(gp, orr + o, SH, 32 * qq + 8 * j, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) gz[4 * qq + j][e] = gp[e] + acc[j][e];
      }
    }
    // gWr1 += z_in^T gpre2, gbr1 += sum gpre2: z_in into the other rows
    // (this warp's gpre there read for the last time above)
    sv_to_rows<16>(zin, orr + o, SH, 0, g, t, lane);
    __syncthreads();
    nt_dot1<H, H, 2>(orr, SH, zr, SH, slab + L.wr1(b));
    colsum<H>(zr, SH, slab + L.br1(b));
    // z_in, the next block's z_out, is in the other rows
    float* sw = zr;
    zr = orr;
    orr = sw;
  }
  // z1 = tanh(feats W1xc + h W1h + tf), level 0 in zr's rows: gpre1 = gz (1
  // - z1^2) (in gz and the other rows); ghp += gpre1; gtf += sum gpre1;
  // gW1xc += feats^T gpre1 (feats [x | ctx] into zr's rows); [gxb | gctx] =
  // gpre1 W1xc^T
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float zv[4];
    ld_c(zv, zr + o, SH, 8 * j, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gz[j][e] = __fmul_rn(gz[j][e], __fsub_rn(1.f, __fmul_rn(zv[e], zv[e])));
      ghp[(4 * j + e) * 32 + lane] += gz[j][e];
    }
  }
  __syncthreads();
  st_c(gz, orr + o, SH, g, t);
  sv_to_rows<DA / 8>(sv, zr + o, SH, 0, g, t, lane);
  sv_to_rows<DZ / 8>(sv + kSvCtx, zr + o, SH, DA, g, t, lane);
  {
    // gxb waits in the stage's gx slot through the attention VJP
    float gxb[4][4];
    zero(gxb);
    mma3<16>(gxb, [&](int s, float (&a)[4]) { frag_regs(gz[s], a); },
             ring.next(w), SH, g, t);
    ananke::frag_st<4>(gxb, gx_slot, lane);
  }
  float gctx[8][4];
  zero(gctx);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    mma3_at<16, 4>(gctx, 4 * hf,
                   [&](int s, float (&a)[4]) { frag_regs(gz[s], a); },
                   ring.next(w), SH, g, t);
  nt_dot1<DF, H>(zr, SH, orr, SH, slab + L.gw1);
  colsum<H>(orr, SH, slab + gtf);
  // the attention's VJP by boxes of 32 zones, [gctx | q] in the other rows
  // (after every warp's nt_dot), attn recomputed; two passes: S =
  // sum(attn gattn) per row, then ds = attn (gattn - S) scale, gq += ds
  // ze, gze += attn^T gctx + ds^T q ([attn | ds] in zr's rows)
  __syncthreads();
  st_c(gctx, orr + o, SH, g, t);
  sv_to_rows<DZ / 8>(sv + kSvQ, orr + o, SH, DZ, g, t, lane);
  auto scores = [&](const float* box, int z0, float (&at)[4][4],
                    float (&ga)[4][4]) {
    zero(at);
    zero(ga);
    mma3<8>(at, [&](int s, float (&a)[4]) {
      frag_smem(orr + o + DZ, SH, s, a, g, t);
    }, box, SQ, g, t);
    mma3<8>(ga, [&](int s, float (&a)[4]) {
      frag_smem(orr + o, SH, s, a, g, t);
    }, box, SQ, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int zi = z0 + 8 * j + 2 * t + (e & 1);
        at[j][e] = zi < w.z ? expf(fminf(at[j][e] * w.scale, 80.f)) *
                                  ((e & 2) ? inv_b : inv_a)
                            : 0.f;
      }
  };
  float S_a = 0.f, S_b = 0.f;
#pragma unroll 1
  for (int z0 = 0; z0 < w.zp; z0 += kZB) {
    float at[4][4], ga[4][4];
    scores(ring.next(w), z0, at, ga);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      S_a += at[j][0] * ga[j][0] + at[j][1] * ga[j][1];
      S_b += at[j][2] * ga[j][2] + at[j][3] * ga[j][3];
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    S_a += __shfl_xor_sync(kFull, S_a, m);
    S_b += __shfl_xor_sync(kFull, S_b, m);
  }
  float gq[8][4];
  zero(gq);
#pragma unroll 1
  for (int z0 = 0; z0 < w.zp; z0 += kZB) {
    const float* box = ring.next(w);
    float at[4][4], ds[4][4];
    scores(box, z0, at, ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = __fmul_rn(
            __fmul_rn(at[j][e], __fsub_rn(ds[j][e], (e & 2) ? S_b : S_a)),
            w.scale);
    st_c(at, zr + o, SH, g, t);
    st_c(ds, zr + o + kZB, SH, g, t);
    mma3<4>(gq, [&](int s, float (&a)[4]) { frag_regs(ds[s], a); },
            box + kZB * SQ, kZB + 8, g, t);
    __syncthreads();
    // gze's rows of this box: zones past z are neither read nor written
    nt_dot<kZB, DZ, true>(zr, SH, orr, SH, zr + kZB, SH, orr + DZ, SH,
                          slab + (size_t)z0 * DZ, w.z - z0);
  }
  // q = x Wq: gx = gxb + gq Wq^T into the gx slot, gWq += x^T gq (gq in the
  // other rows, x in zr's, after the box's barrier: every warp is done
  // with the last gze's operands)
  {
    const float* box = ring.next(w);
    st_c(gq, orr + o, SH, g, t);
    sv_to_rows<DA / 8>(sv, zr + o, SH, 0, g, t, lane);
    float gx[4][4];
    ananke::frag_ld<4>(gx, gx_slot, lane);
    mma3<8>(gx, [&](int s, float (&a)[4]) { frag_regs(gq[s], a); }, box, SQ,
            g, t);
    ananke::frag_st<4>(gx, gx_slot, lane);
  }
  __syncthreads();
  nt_dot1<DA, DZ>(zr, SH, orr, SH, slab + L.gwq);
  __syncthreads();
}

// The VJP of one accepted step for the warp's 16 rows of the tile from row0
// (fr: the warp's scratch, its step inputs in place, its saved stage
// after them; h the context rows, (n, DC); tf the step's 7 time rows),
// then the step's h rows: gh = ghp W1h^T into slot 13 (added to the slot's
// carry where carry_gh), gW1h += h^T ghp into the slab (tf_rows time rows,
// the step's from gtf0 on: stage st's at gtf0 + st H). Leaves gy0 in slot
// 11 and gf0 in 12. Consumes one period of the ring's boxes, c0 consumed
// before it. A call of its own, one a step, whose arguments are scalars
// and pointers. Every thread of the CTA calls it.
__device__ __noinline__ void step_vjp_tf32(const Weights& w, int c0,
                                           float* fr, const float* tf,
                                           const float* h, float hs,
                                           float* slab, int tf_rows,
                                           long gtf0, bool carry_gh,
                                           long row0, int n) {
  constexpr int NX = DA / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr0 = 16 * warp;
  const long ra = row0 + wr0 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;
  const SlabLayout L(w.z, w.nb, tf_rows);
  Ring ring{c0};
  float* ghp = fr + kGhp;
  float* sv = fr + kWarpFloats;
  for (int i = 0; i < (H / 8) * 4; ++i) ghp[i * 32 + lane] = 0.f;
#pragma unroll 1
  for (int st = 1; st < 6; ++st) {
    float x[NX][4], k[NX][4], ia, ib;
    frag_stage_input(x, fr, st, hs, lane);
    stage_fwd(w, ring, x, h, ra, rb, va, vb, tf + st * H, k, ia, ib,
              nullptr, wr0, g, t, lane);
    ananke::frag_st<NX>(k, fr + (1 + st) * kFX, lane);
  }
#pragma unroll 1
  for (int st = 6; st >= 1; --st) {
    float gk[NX][4];
    {
      float x[NX][4], ia, ib;
      frag_stage_input(x, fr, st, hs, lane);
      stage_fwd(w, ring, x, h, ra, rb, va, vb, tf + st * H, gk, ia, ib, sv,
                wr0, g, t, lane);
      frag_stage_cot(gk, fr, st, hs, lane);
      // gx_st goes to slot st (k_st's, read by no later stage)
      stage_bwd(w, ring, gk, ia, ib, slab, L, gtf0 + (long)st * H,
                fr + st * kFX, ghp, sv, wr0, g, t, lane);
    }
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
  frag_stage_cot(gf, fr, 0, hs, lane);
  ananke::frag_st<NX>(gf, fr + 12 * kFX, lane);
  // hpre = h W1h: gh = ghp W1h^T, gW1h += h^T ghp (ghp in Y, h in X, after
  // the box's barrier)
  float ghh[DC / 8][4];
  {
    const float* box = ring.next(w);  // W1h (DC, H)
    float gp[H / 8][4], hf[DC / 8][4];
    ananke::frag_ld<H / 8>(gp, ghp, lane);
    ananke::ldg_rows_c<DC / 8>(hf, h, ra, rb, va, vb, t);
    st_c(gp, Smem::y() + wr0 * SH, SH, g, t);
    st_c(hf, Smem::x() + wr0 * SH, SH, g, t);
    zero(ghh);
    mma3<16>(ghh, [&](int s, float (&a)[4]) { frag_regs(gp[s], a); }, box,
             SH, g, t);
  }
  __syncthreads();
  nt_dot1<DC, H>(Smem::x(), SH, Smem::y(), SH, slab + L.gw1h);
  __syncthreads();
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

}  // namespace vjp32

// vjp32::split_boxes on `s`: the weight bank of w (w.bank) from its weights
inline int launch_split_boxes(const Weights& w, cudaStream_t s) {
  vjp32::split_boxes<<<vjp32::Boxes::count(w.zp, w.nb), 256, 0, s>>>(w);
  return (int)cudaGetLastError();
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
  float* scratch;    // (gridDim.x, warps, vjp32::warp_floats(nb)): the
                     // warps' step state and saved stage
  float* slab;       // (gridDim.x, slab size), zeroed by the caller
  long slab_size;
  int n;
  float hstep;
};

// the rows of a warp of a step-VJP tile (from row0 on; rows past n read as
// zeros), its scratch (`stride` floats a warp) and its fragment mapping:
// element 4 q + c of a lane is row g + 8 (c >> 1) of the warp's 16, column
// 8 q + 2 t + (c & 1)
struct StepRows {
  static constexpr int kElems = (DA / 8) * 4;
  int warp, lane, t;
  long ra, rb;
  bool va, vb;
  float* fr;

  __device__ StepRows(long row0, int n, float* scratch,
                      long stride = kWarpFloats) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    t = lane & 3;
    ra = row0 + warp * 16 + (lane >> 2);
    rb = ra + 8;
    va = ra < n;
    vb = rb < n;
    fr = scratch +
         ((size_t)blockIdx.x * (blockDim.x / 32) + warp) * stride;
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
  // the tile's step inputs (x, f0 and the five folded cotangents, (n, DA)
  // each) into the warp's scratch
  __device__ void load_inputs(const float* const (&in)[7]) const {
    const int slot[7] = {0, 1, 7, 8, 9, 10, 11};
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float v[DA / 8][4];
      ananke::ldg_rows_c<DA / 8>(v, in[i], ra, rb, va, vb, t);
      ananke::frag_st<DA / 8>(v, fr + slot[i] * kFX, lane);
    }
  }
  // gy0 (slot 11), gf0 (12) and gh (13) out to rows ra, rb
  __device__ void store_outputs(float* gy0, float* gf0, float* gh) const {
    float v[DA / 8][4];
    ananke::frag_ld<DA / 8>(v, fr + 11 * kFX, lane);
    ananke::stg_rows_c<DA / 8>(v, gy0, ra, rb, va, vb, t);
    ananke::frag_ld<DA / 8>(v, fr + 12 * kFX, lane);
    ananke::stg_rows_c<DA / 8>(v, gf0, ra, rb, va, vb, t);
    ananke::frag_ld<DA / 8>(v, fr + 13 * kFX, lane);
    ananke::stg_rows_c<DC / 8>(v, gh, ra, rb, va, vb, t);
  }
};

// K7 at float32: CTAs of vjp32::warps_for(0) warps, a tile of 16 rows a
// warp, the step body step_vjp_tf32 once a tile
__global__ void __launch_bounds__(32 * vjp32::kMaxW, 1)
    dopri5_vjp_kernel(const VjpParams p) {
  const int rows = blockDim.x / 2;
  const long stride = vjp32::warp_floats(p.w.nb);
  const int n_tiles = (p.n + rows - 1) / rows;
  const int period = vjp32::Ring::period(p.w);
  vjp32::Ring::prime(p.w);
  int c0 = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = (long)tile * rows;
    StepRows(row0, p.n, p.scratch, stride).load_inputs(
        {p.x, p.f0, p.gdy, p.gr5, p.gk1, p.gk7, p.gy0d});
    vjp32::step_vjp_tf32(p.w, c0, StepRows(row0, p.n, p.scratch, stride).fr,
                         p.w.tf,
                         p.h, p.hstep,
                         p.slab + (size_t)blockIdx.x * p.slab_size, 7,
                         (long)p.w.z * DZ, false, row0, p.n);
    c0 += period;
    StepRows(row0, p.n, p.scratch, stride).store_outputs(p.gy0, p.gf0,
                                                         p.gh);
  }
  vjp32::Ring::drain(c0);
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

template <int W>
__global__ void __launch_bounds__(32 * W, 1)
    dopri5_vjp_bf16_kernel(const VjpBf16Params p) {
  constexpr int ROWS = 16 * W;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;
  const int period = HRing<W>::period(p.w);
  HRing<W>().prime(p.w);
  int c0 = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    {  // the tile's step inputs into the warps' scratch
      const StepRows r((long)tile * ROWS, p.n, p.scratch);
      stage_h_rows<W>(p.h, r.ra, r.rb, r.va, r.vb, r.warp, r.lane);
      r.load_inputs({p.x, p.f0, p.gdy, p.gr5, p.gk1, p.gk7, p.gy0d});
    }
    {
      const StepRows r((long)tile * ROWS, p.n, p.scratch);
      step_vjp_bf16<W>(p.w, c0, r.fr, p.tf, p.hstep,
                       p.slab + (size_t)blockIdx.x * p.slab_size, 7,
                       (long)p.w.z * DZ, false, r.warp, r.lane);
    }
    c0 = (c0 + period) % HLayout::kSlots;
    StepRows((long)tile * ROWS, p.n, p.scratch)
        .store_outputs(p.gy0, p.gf0, p.gh);
  }
  HRing<W>::drain();
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
// parameter: the float32 one (step_vjp_tf32) or the bf16 one
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

// K6's float32 body: tiles of 16 rows a warp, vjp32::warps_for warps
struct Tf32Body {
  static constexpr int kThreadsPerCta = 32 * vjp32::kMaxW;
  using Params = BwdParams<Weights>;
  static int warps(int, size_t extra) { return vjp32::warps_for(extra); }
  static size_t smem_bytes(int, int warps) {
    return vjp32::smem_floats(warps) * sizeof(float);
  }

  const Params& p;
  int c0 = 0, period;  // the ring's boxes consumed; a step's
  long row0 = 0, stride;

  __device__ Tf32Body(const Params& p_, unsigned char*) : p(p_) {
    period = vjp32::Ring::period(p.w);
    stride = vjp32::warp_floats(p.w.nb);
    vjp32::Ring::prime(p.w);
  }
  __device__ int rows() const { return blockDim.x / 2; }
  __device__ void begin_tile(int tile) {
    row0 = (long)tile * rows();
    const StepRows r(row0, p.n, p.scratch, stride);
    for (int i = 0; i < StepRows::kElems; ++i)
      r.fr[11 * kFX + i * 32 + r.lane] = r.fr[12 * kFX + i * 32 + r.lane] =
          r.fr[13 * kFX + i * 32 + r.lane] = 0.f;
  }
  // the fold of step s, then its VJP
  __device__ void step(int s, const float* tss, const int* ost) {
    {
      StepRows r(row0, p.n, p.scratch, stride);
      fold_step(r, p, s, tss, ost);
    }
    vjp32::step_vjp_tf32(p.w, c0, StepRows(row0, p.n, p.scratch, stride).fr,
                         p.tf + (size_t)7 * s * H, p.hc,
                         p.steps[p.n_acc + s],
                         p.slab + (size_t)blockIdx.x * p.slab_size,
                         7 * p.n_acc, (long)p.w.z * DZ + (long)7 * s * H,
                         true, row0, p.n);
    c0 += period;
  }
  __device__ void end_tile() {
    StepRows(row0, p.n, p.scratch, stride).store_outputs(p.gy0, p.gf0, p.gh);
  }
  __device__ void finish() { vjp32::Ring::drain(c0); }
  // the weight bank, before the kernel
  static int prepare(const Params& p, cudaStream_t s) {
    return launch_split_boxes(p.w, s);
  }
};


// K6's bf16 body: tiles of 16 W rows
template <int W>
struct Bf16Body {
  static constexpr int kThreadsPerCta = 32 * W;
  static constexpr int kRows = 16 * W;
  using Params = BwdParams<StageWeights>;
  static int warps(int, size_t) { return W; }
  static size_t smem_bytes(int nb, int) {
    return HLayout::bytes(kRows, W, nb);
  }

  const Params& p;
  int c0 = 0, period;  // the ring's boxes consumed (mod kSlots); a step's
  long row0 = 0;

  __device__ Bf16Body(const Params& p_, unsigned char*) : p(p_) {
    period = HRing<W>::period(p.w);
    HRing<W>().prime(p.w);
  }
  __device__ int rows() const { return kRows; }
  __device__ void begin_tile(int tile) {
    row0 = (long)tile * kRows;
    const StepRows r(row0, p.n, p.scratch);
    stage_h_rows<W>(p.hc, r.ra, r.rb, r.va, r.vb, r.warp, r.lane);
    for (int i = 0; i < StepRows::kElems; ++i)
      r.fr[11 * kFX + i * 32 + r.lane] = r.fr[12 * kFX + i * 32 + r.lane] =
          r.fr[13 * kFX + i * 32 + r.lane] = 0.f;
  }
  // the fold of step s, then its VJP (the row state recomputed, not held
  // across the call)
  __device__ void step(int s, const float* tss, const int* ost) {
    {
      StepRows r(row0, p.n, p.scratch);
      fold_step(r, p, s, tss, ost);
    }
    const StepRows r(row0, p.n, p.scratch);
    step_vjp_bf16<W>(p.w, c0, r.fr, p.tf + (size_t)7 * s * H,
                     p.steps[p.n_acc + s],
                     p.slab + (size_t)blockIdx.x * p.slab_size, 7 * p.n_acc,
                     (long)p.w.z * DZ + (long)7 * s * H, true, r.warp,
                     r.lane);
    c0 = (c0 + period) % HLayout::kSlots;
  }
  __device__ void end_tile() {
    StepRows(row0, p.n, p.scratch).store_outputs(p.gy0, p.gf0, p.gh);
  }
  __device__ void finish() { HRing<W>::drain(); }
  static int prepare(const Params&, cudaStream_t) { return 0; }
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
  const int n_tiles = (p.n + body.rows() - 1) / body.rows();

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
  w.bank = nullptr;
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


template <class K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_vjp(const VjpParams& p, int num_ctas, cudaStream_t s) {
  auto* kernel = dopri5_vjp_kernel;
  const int warps = vjp32::warps_for(0);
  const size_t bytes = vjp32::smem_floats(warps) * sizeof(float);
  int err = set_smem(kernel, bytes);
  if (err) return err;
  err = launch_split_boxes(p.w, s);
  if (err) return err;
  kernel<<<num_ctas, 32 * warps, bytes, s>>>(p);
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

template <class Body>
int launch_backward(typename Body::Params p, int nb, int num_ctas,
                    cudaStream_t s) {
  auto* kernel = dopri5_backward_kernel<Body>;
  const size_t extra = bwd_extra_bytes(p.T);
  const int warps = Body::warps(nb, extra);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  p.body_smem = Body::smem_bytes(nb, warps);
  const size_t bytes = p.body_smem + extra;
  int err = set_smem(kernel, bytes);
  if (err) return err;
  err = Body::prepare(p, s);
  if (err) return err;
  kernel<<<num_ctas, 32 * warps, bytes, s>>>(p);
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
// float32 step VJP (128 at any depth: vjp32::warps_for; K6 at float32 takes
// fewer where its output times leave no room) and kind 2 the bf16 step VJP
// (96 up to 2 blocks, 64 up to 5, 32 beyond: vjp_bf16_warps).
int ananke_dopri5_tile_rows(int num_blocks, int kind) {
  if (kind == 2) return 16 * vjp_bf16_warps(num_blocks);
  if (kind == 0) return k5::kRows;
  return 16 * vjp32::warps_for(0);
}

// Floats of one CTA's scratch in device memory of K5 (kind 0) or a
// step-VJP body (kind 1 or 2, as ananke_dopri5_tile_rows).
long ananke_dopri5_scratch_floats(int num_blocks, int kind) {
  if (kind == 0) return (long)k5::kW * k5::kState;
  if (kind == 2) return (long)vjp_bf16_warps(num_blocks) * kWarpFloats;
  return (long)vjp32::warps_for(0) * vjp32::warp_floats(num_blocks);
}

// Floats of the float32 step VJP's weight bank at zp padded zones, which
// follows the num_ctas CTAs' scratch in its scratch buffer.
long ananke_dopri5_bank_floats(int zp, int num_blocks) {
  return (long)vjp32::Boxes::count(zp, num_blocks) * vjp32::kBox;
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
  p.w.bank = static_cast<float*>(scratch) +
             (size_t)num_ctas * ananke_dopri5_scratch_floats(num_blocks, 1);
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
  return launch_vjp(p, num_ctas, s);
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
  p.w.bank = static_cast<float*>(scratch) +
             (size_t)num_ctas * ananke_dopri5_scratch_floats(num_blocks, 1);
  set_bwd_params(p, ckpts, ckpt_f, g, hc, tf, steps, out_step, gy0, gf0, gh,
                 scratch, slab, size, n, n_acc, T);
  p.ckpt_bf16 = ckpt_bf16;
  return launch_backward<Tf32Body>(p, num_blocks, num_ctas, s);
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
