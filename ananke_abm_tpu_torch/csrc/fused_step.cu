// The GAT-ODE's RK4 rollout kernels on Hopper (sm_90a), one template for
// all three, for every agent in one launch:
// - K1: one output interval, `substeps` RK4 steps of the drift, then the
//   decode and its first-index argmax (ananke_rk4_interval_decode);
// - K0: one RK4 step, the same stage code with the decode compiled out
//   (ananke_rk4_step), for the per-step rollout, whose decode is a plain
//   product after each interval;
// - K2f: the fixed-step training day's forward (ananke_day_forward): the
//   stage code of S substeps, substep s of its own size dts[s], no decode,
//   x0 and the carry after every substep stored into xs (S + 1, N, DA).
//
// Replaces the Pallas TPU kernels
//   K1 ananke_abm_tpu/ops/pallas/fused_step.py::rk4_interval_decode_fused
//   K0 ananke_abm_tpu/ops/pallas/fused_step.py::rk4_step_fused
//   K2f ananke_abm_tpu/ops/pallas/fused_train.py::_day_fwd_impl
// (stage math: _stage_math in fused_step.py). The plain PyTorch versions
// are ananke_abm_tpu_torch/ops/cuda/fused_step.py::
// rk4_interval_decode_reference and ::rk4_step_reference, and
// ananke_abm_tpu_torch/ops/cuda/fused_train.py::day_forward_reference. K0
// is K1 with `stages` = 4 and no decode.
//
// What bounds it on the card. Per agent and interval the kernel does ~1.5
// MFLOP of bf16 matmul work (8 drift evaluations of ~92k multiply-adds at
// the shipping widths) against ~390 bytes of device-memory traffic (read x
// and h, write x and the id): ~3,800 FLOP/byte, far above the H100's ~295
// FLOP/byte ridge, so its bound is the tensor cores' (1.585 ms for K1 at
// 1,048,576 agents, 0.790 ms for K0). What holds it above that bound is
// what feeds the tensor cores: ~184 KB of bf16 weight operands a stage
// (Wq, the zones twice, W1, two H x H matrices a residual block, W3), the
// same for every row, and ~640 tanh a row a stage.
//
// - The CTA's kWarps warps (16 kWarps rows, whole warpgroups) share every
//   weight operand: the launch's products are one fixed sequence of weight
//   boxes (ServeRing below: per stage Wq^T, the zones by chunks of ZC, W1
//   by halves (W1xc^T and W1h^T rows), each residual matrix by halves,
//   W3^T; K1 then Wd^T and the zones again for the decode), which one
//   thread copies by TMA into a ring of kSlots shared-memory slots,
//   kSlots - 1 boxes ahead. A box's full barrier (an mbarrier the copy
//   completes) tells the warps it has landed, its empty barrier (one
//   arrival a warp) tells the copying thread its slot is free: no block
//   barrier. Read warp by warp from L2, as this kernel did until it was
//   redesigned, the same operands asked ~97 GB of L2 an interval at
//   1,048,576 agents; through the ring, ~8 GB.
// - Each product is one warpgroup's wgmma.m64nNk16 chain: A (the warp's 16
//   rows, bf16) from registers, B from the box in wgmma's K-major layout
//   with 64-byte swizzle (as TMA writes it), the sums in f32 registers in
//   mma.m16n8's accumulator layout, so each activation goes from one
//   product into the next in registers, rounded to bf16 on the way -- the
//   rounding points of the reference. Every accumulator starts at +0 and
//   sums its k16 slices in order, as the mma.sync chains of the kernel
//   this replaced did, and gives their bits. A zone box's 64 scores are one
//   product and its context sum another; Dense_0's two products share one
//   wait.
// - The RK4 state (x, k and the running k1 + 2 k2 + 2 k3 + k4) and bf16(h)
//   live per warp in shared memory: registers go to the activations, at
//   168 a thread for 12 warps an SM. Dense_0's h-row product is redone
//   each stage from the W1 box (the same bits; holding it would cost 512
//   bytes a row).
// - Zones are walked by boxes of ZC and chunks of 16 inside a box, so any
//   zone count works (the copy fills a box past zp with zeros, and zones
//   past z are masked). The max-free softmax needs no rescaling across
//   chunks: sum(exp) and sum(exp * ze) simply add. The decode argmax keeps a running maximum that a later zone
//   replaces only when strictly greater, then reduces across the 4 threads
//   that share a row, preferring the lower index on ties -- the first
//   index, as in the reference.
// - The stages run in one loop with a runtime stage index, so the stage
//   code is emitted once. Every warp walks the whole schedule, those whose
//   rows are all past n included (their rows are zero): the ring's empty
//   barriers and the warpgroup products need every warp of the CTA.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --ab-step, the
// rung-1 operands, one call): K1 9.7 ms against its 1.585 ms bound (the
// kernel it replaced: 25.3 ms), K0 4.5 ms against 0.790 ms (12.6 ms), the
// same bits as that kernel's at every checked shape; K2f 7.8 ms at bench
// rung 2 against its 0.863 ms bound (the kernel it replaced, drift_stage.cuh
// per warp: 18.2 ms; --ab-train), the same bits as that kernel's. PERF.md
// section 6 has the readings and what each part of the design moved.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace ananke;
using bf16 = __nv_bfloat16;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kWarps = 12;  // warps per CTA (whole warpgroups): 16 kWarps rows
constexpr int kMaxBlocks = 8;
static_assert(kWarps % 4 == 0, "the products are warpgroup-wide");

struct Params {
  // TMA maps of the weights and zones (box_map below): 64-byte swizzled
  // boxes of 32 columns
  CUtensorMap tm_wq, tm_ze, tm_zet, tm_w1xc, tm_w1h, tm_wr, tm_w3, tm_wd;
  const float* x;              // (n, DA)
  const float* h;              // (n, DC)
  const __nv_bfloat16* ze;     // (zp, DZ), zero rows past z
  const __nv_bfloat16* zeT;    // (DZ, zp)
  const __nv_bfloat16* wqT;    // (DZ, DA)
  const __nv_bfloat16* w1xcT;  // (H, DA + DZ)
  const __nv_bfloat16* w1hT;   // (H, DC)
  const __nv_bfloat16* wrT;    // (2 * num_blocks, H, H): Wr1_0, Wr2_0, ...
  const __nv_bfloat16* br;     // (2 * num_blocks, H)
  const __nv_bfloat16* w3T;    // (DA, H)
  const __nv_bfloat16* b3;     // (DA)
  const __nv_bfloat16* wdT;    // (DZ, DA)
  const float* tf;             // (stages, H)
  const float* dts;            // (stages / 4): the day's substep sizes (K2f)
  float* x_out;                // (n, DA); K2f: xs (stages / 4 + 1, n, DA)
  int* ids;                    // (n), unless the decode is compiled out
  int n, z, zp, num_blocks, stages;
  float dt;
};

// The serving ring's boxes and its shared memory: kSlots slots, each the
// largest box of the schedule, then each warp's RK4 state and bf16(h), then
// the ring's barriers. A box of R rows x K columns lies in K / 32 panels of
// R x 32, each as the TMA unit writes it with 64-byte swizzle (wgmma's
// K-major SW64 layout).
template <int DA, int DZ, int DC, int H>
struct Boxes {
  static constexpr int DF = DA + DZ;
  static constexpr int HH = H / 2;  // output rows of a half box
  static constexpr int ZC = 64;     // zones a box holds: ze rows | ze^T cols
  static constexpr int kSlot =
      cmax(cmax(2 * ZC * DZ, HH * H), cmax(HH * (DF + DC), cmax(DZ * DA, DA * H)));
  static constexpr int kSlots = 2;
  static constexpr int kRingBytes = kSlots * kSlot * 2;
  // a warp's RK4 state (x, k, ksum; f32), bf16(h) and the zone loops' A
  // fragments (bf16(q), or the decode's bf16(x @ Wd))
  static constexpr int kWarpBytes = 16 * 3 * DA * 4 + 16 * (DC + DZ) * 2;
  // then the ring's full and empty barriers
  static constexpr int bytes(int warps) {
    return kRingBytes + warps * kWarpBytes + 2 * kSlots * 8;
  }
  static_assert(DZ % 16 == 0 && H % 32 == 0 && HH <= 64 && DZ <= 64,
                "box shapes: a product's N is at most 64");
};

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A box whose
// copy never lands fails the launch (trap) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1 << 24)) __trap();
  }
}

// rows [r0, r0 + R) x columns [c0, c0 + K) of the matrix behind `m` (whose
// boxes are R x 32) into `dst` as K / 32 panels, completing on `bar`
__device__ __forceinline__ void tma_box(bf16* dst, const CUtensorMap* m,
                                        int r0, int c0, int R, int K,
                                        uint64_t* bar) {
  for (int pn = 0; pn < K / 32; ++pn)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(dst + pn * R * 32)),
        "l"(reinterpret_cast<uint64_t>(m)), "r"(c0 + 32 * pn), "r"(r0),
        "r"(smem_addr(bar))
        : "memory");
}

// The launch's weight boxes, in the order the kernel consumes them:
//   per stage: Wq^T, zones x nzc, W1 halves 0, 1, per block Wr1^T halves
//   0, 1 and Wr2^T halves 0, 1, W3^T | the decode (K1 only): Wd^T, zones x
//   nzc
// A "zones" box is ZC rows of ze beside the same ZC columns of ze^T; a "W1
// half" H/2 rows of W1xc^T beside the same rows of W1h^T (Dense_0's rows
// for both its products). One thread (the CTA's first) copies every box by
// TMA, kSlots - 1 boxes ahead: box j goes to slot j % kSlots once every
// warp has released the box that held it (the slot's empty barrier), and
// completes on the slot's full barrier, on which every warp waits. The
// producer's cursor is (seg, k): box k of segment seg (0 .. stages - 1 a
// stage, stages the decode); past the schedule it copies nothing.
template <int DA, int DZ, int DC, int H, bool kDecode, int W = kWarps>
struct ServeRing {
  using B = Boxes<DA, DZ, DC, H>;
  int c = 0;  // boxes consumed (the same in every thread)
  int seg = 0, k = 0;

  __device__ __forceinline__ static int nzc(const Params& p) {
    return (p.zp + B::ZC - 1) / B::ZC;
  }
  __device__ __forceinline__ static bf16* slot(int ci) {
    return reinterpret_cast<bf16*>(dyn_smem()) + (ci % B::kSlots) * B::kSlot;
  }
  __device__ __forceinline__ static uint64_t* full(int s) {
    return reinterpret_cast<uint64_t*>(dyn_smem() + B::kRingBytes +
                                       W * B::kWarpBytes) + s;
  }
  __device__ __forceinline__ static uint64_t* empty(int s) {
    return full(B::kSlots + s);
  }

  // the barriers, before any copy (every thread calls it)
  __device__ static void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < B::kSlots; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the cursor's box into slot j % kSlots, and advance the cursor (the
  // producer thread)
  __device__ void issue(const Params& p, int j) {
    const int s = j % B::kSlots, nz = nzc(p);
    bf16* dst = slot(j);
    uint64_t* bar = full(s);
    // up to two parts: (map, first row, first column, rows, columns, at)
    const CUtensorMap *m1 = nullptr, *m2 = nullptr;
    int r1 = 0, c1 = 0, R1 = 0, K1 = 0, r2 = 0, c2 = 0, R2 = 0, K2 = 0;
    int at2 = 0;
    if (seg < p.stages) {
      const int len = 4 + nz + 4 * p.num_blocks;
      if (k == 0) {
        m1 = &p.tm_wq; R1 = DZ; K1 = DA;
      } else if (k <= nz) {
        m1 = &p.tm_ze; r1 = (k - 1) * B::ZC; R1 = B::ZC; K1 = DZ;
        m2 = &p.tm_zet; c2 = (k - 1) * B::ZC; R2 = DZ; K2 = B::ZC;
        at2 = B::ZC * DZ;
      } else if (k <= nz + 2) {
        const int hh = k - nz - 1;
        m1 = &p.tm_w1xc; r1 = hh * B::HH; R1 = B::HH; K1 = B::DF;
        m2 = &p.tm_w1h; r2 = hh * B::HH; R2 = B::HH; K2 = DC;
        at2 = B::HH * B::DF;
      } else if (k < len - 1) {
        const int kk = k - nz - 3;  // block kk / 4: Wr1, Wr2 by halves
        m1 = &p.tm_wr;
        r1 = (2 * (kk >> 2) + ((kk >> 1) & 1)) * H + (kk & 1) * B::HH;
        R1 = B::HH; K1 = H;
      } else {
        m1 = &p.tm_w3; R1 = DA; K1 = H;
      }
      if (++k == len) {
        k = 0;
        ++seg;
      }
    } else if (kDecode && seg == p.stages) {
      if (k == 0) {
        m1 = &p.tm_wd; R1 = DZ; K1 = DA;
      } else {
        m1 = &p.tm_ze; r1 = (k - 1) * B::ZC; R1 = B::ZC; K1 = DZ;
        m2 = &p.tm_zet; c2 = (k - 1) * B::ZC; R2 = DZ; K2 = B::ZC;
        at2 = B::ZC * DZ;
      }
      if (++k == nz + 1) ++seg;
    }
    if (m1 == nullptr) return;  // past the schedule
    if (j >= B::kSlots) mbar_wait(empty(s), (j / B::kSlots - 1) & 1);
    mbar_expect(bar, 2 * 32 * (R1 * (K1 / 32) + R2 * (K2 / 32)));
    tma_box(dst, m1, r1, c1, R1, K1, bar);
    if (m2 != nullptr) tma_box(dst + at2, m2, r2, c2, R2, K2, bar);
  }

  // the barriers, then the first kSlots - 1 boxes (every thread calls it)
  __device__ void prime(const Params& p) {
    init();
    if (threadIdx.x == 0)
      for (int i = 0; i < B::kSlots - 1; ++i) issue(p, i);
  }

  // The next box, once its copy has landed; every thread of the CTA calls
  // it at the same point of the sequence. Each warp first releases the box
  // before it (its products are done: they wait for their sums), and the
  // producer thread refills that slot kSlots - 1 boxes ahead.
  __device__ const bf16* next(const Params& p) {
    if (c > 0) {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(empty((c - 1) % B::kSlots));
    }
    if (threadIdx.x == 0) issue(p, c + B::kSlots - 1);
    mbar_wait(full(c % B::kSlots), (c / B::kSlots) & 1);
    __syncwarp();  // converged again for the warpgroup's products
    return slot(c++);
  }
};

// ---- the products: wgmma.m64nNk16, A from registers, B from a box -------

// The shared-memory descriptor of a K-major panel with 64-byte swizzle:
// rows of 32 bf16 (64 bytes), 8-row groups 512 bytes apart (SBO).
__device__ __forceinline__ uint64_t sw64_desc(const bf16* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// one wgmma.mma_async of N = 8 NB columns into n-blocks j0 .. j0 + NB - 1
// of `d` (the warp's 16 rows in mma.m16n8's accumulator layout, n-block by
// n-block), A the warp's 16 x 16 bf16 fragment; scale_d 1 adds onto d
template <int NB>
struct Wgmma;

template <>
struct Wgmma<4> {
  template <int NOUT>
  __device__ __forceinline__ static void run(float (&d)[NOUT][4], int j0,
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %21, p, 1, 1, 0;\n}\n"
        : "+f"(d[j0 + 0][0]), "+f"(d[j0 + 0][1]), "+f"(d[j0 + 0][2]), "+f"(d[j0 + 0][3]),
          "+f"(d[j0 + 1][0]), "+f"(d[j0 + 1][1]), "+f"(d[j0 + 1][2]), "+f"(d[j0 + 1][3]),
          "+f"(d[j0 + 2][0]), "+f"(d[j0 + 2][1]), "+f"(d[j0 + 2][2]), "+f"(d[j0 + 2][3]),
          "+f"(d[j0 + 3][0]), "+f"(d[j0 + 3][1]), "+f"(d[j0 + 3][2]), "+f"(d[j0 + 3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
  }
};

template <>
struct Wgmma<8> {
  template <int NOUT>
  __device__ __forceinline__ static void run(float (&d)[NOUT][4], int j0,
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
        : "+f"(d[j0 + 0][0]), "+f"(d[j0 + 0][1]), "+f"(d[j0 + 0][2]), "+f"(d[j0 + 0][3]),
          "+f"(d[j0 + 1][0]), "+f"(d[j0 + 1][1]), "+f"(d[j0 + 1][2]), "+f"(d[j0 + 1][3]),
          "+f"(d[j0 + 2][0]), "+f"(d[j0 + 2][1]), "+f"(d[j0 + 2][2]), "+f"(d[j0 + 2][3]),
          "+f"(d[j0 + 3][0]), "+f"(d[j0 + 3][1]), "+f"(d[j0 + 3][2]), "+f"(d[j0 + 3][3]),
          "+f"(d[j0 + 4][0]), "+f"(d[j0 + 4][1]), "+f"(d[j0 + 4][2]), "+f"(d[j0 + 4][3]),
          "+f"(d[j0 + 5][0]), "+f"(d[j0 + 5][1]), "+f"(d[j0 + 5][2]), "+f"(d[j0 + 5][3]),
          "+f"(d[j0 + 6][0]), "+f"(d[j0 + 6][1]), "+f"(d[j0 + 6][2]), "+f"(d[j0 + 6][3]),
          "+f"(d[j0 + 7][0]), "+f"(d[j0 + 7][1]), "+f"(d[j0 + 7][2]), "+f"(d[j0 + 7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d),
          "l"(desc));
  }
};

// Pin an accumulator's or an A fragment's registers at this point: a
// wgmma reads and writes them after its issue, until its wait, so neither
// may be moved or reused in between.
template <int NOUT>
__device__ __forceinline__ void fence_acc(float (&d)[NOUT][4]) {
#pragma unroll
  for (int j = 0; j < NOUT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
}

template <int KS>
__device__ __forceinline__ void fence_a(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(a[s][c])::"memory");
}

// A product into n-blocks j0 .. j0 + NB - 1 of d (the warp's 16 rows in
// mma.m16n8's accumulator layout): A the warp's rows, KS k16 slices; B the
// box's first 8 NB rows (from `box`, its panels `panel` elements apart) at
// k16 steps k0 .. k0 + KS - 1. Every n-block sums its k-slices in order
// onto what d holds: wg_zero first starts it at +0, as the mma.sync chains
// of the kernel this replaced started. The warpgroup's 4 warps issue it
// together, between wg_open and wg_close (which returns when the sums are
// in registers), every accumulator and A fragment of the group fenced on
// both sides.
template <int NB, int NOUT>
__device__ __forceinline__ void wg_zero(float (&d)[NOUT][4], int j0) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[j0 + j][c] = 0.f;
}

__device__ __forceinline__ void wg_open() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_close() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int NB, int KS, int NOUT>
__device__ __forceinline__ void wg_issue(float (&d)[NOUT][4], int j0,
                                         uint32_t (&a)[KS][4],
                                         const bf16* box, int panel,
                                         int k0 = 0) {
  const uint64_t desc = sw64_desc(box);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int kk = k0 + s;  // panel kk / 2, its 32-byte half kk % 2
    Wgmma<NB>::run(d, j0, a[s],
                   desc + (((kk >> 1) * panel * 2 + (kk & 1) * 32) >> 4), 1);
  }
}

// one product alone, its sums started at +0
template <int NB, int KS, int NOUT>
__device__ __forceinline__ void wg_product(float (&d)[NOUT][4], int j0,
                                           uint32_t (&a)[KS][4],
                                           const bf16* box, int panel) {
  wg_zero<NB>(d, j0);
  fence_acc(d);
  fence_a(a);
  wg_open();
  wg_issue<NB, KS>(d, j0, a, box, panel);
  wg_close();
  fence_acc(d);
  fence_a(a);
}

// A fragments <-> a warp's shared-memory copy in fragment order ([4 s + c]
// [lane]), conflict-free
template <int KS>
__device__ __forceinline__ void frag_put(uint32_t (*dst)[32],
                                         const uint32_t (&a)[KS][4],
                                         int lane) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[4 * s + c][lane] = a[s][c];
}

template <int KS>
__device__ __forceinline__ void frag_get(uint32_t (&a)[KS][4],
                                         uint32_t (*src)[32], int lane) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[s][c] = src[4 * s + c][lane];
}

// the warp's x (its shared-memory rows, fragment order) into rows ra, rb
// of dst
template <int NX>
__device__ __forceinline__ void store_x(float* dst, float (*xs)[32], long ra,
                                        long rb, bool va, bool vb, int t,
                                        int lane) {
  constexpr int DA = 8 * NX;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int c = 8 * j + 2 * t;
    if (va)
      *reinterpret_cast<float2*>(dst + ra * DA + c) =
          make_float2(xs[4 * j][lane], xs[4 * j + 1][lane]);
    if (vb)
      *reinterpret_cast<float2*>(dst + rb * DA + c) =
          make_float2(xs[4 * j + 2][lane], xs[4 * j + 3][lane]);
  }
}

// kDecode: K1 (the stages, then the decode and argmax) or K0 (the stages);
// kDay: K2f (the stages of stages / 4 substeps, substep s of size dts[s],
// x0 and every substep's carry into the planes of xs); W warps a CTA
template <int DA, int DZ, int DC, int H, bool kDecode, bool kDay = false,
          int W = kWarps>
__global__ void __launch_bounds__(32 * W)
    interval_kernel(const __grid_constant__ Params p) {
  using B = Boxes<DA, DZ, DC, H>;
  constexpr int NX = DA / 8, KX = DA / 16;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int KC = DC / 16;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int DF = B::DF, KF = DF / 16;
  constexpr int ZB = B::ZC / 8;  // n-blocks of a zone box's scores
  static_assert(DA % 16 == 0 && DZ % 16 == 0 && DC % 16 == 0 &&
                    H % 16 == 0,
                "widths must be multiples of 16");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  static_assert(!(kDecode && kDay), "K2f has no decode");
  static_assert(W % 4 == 0, "the products are warpgroup-wide");
  const long row0 = ((long)blockIdx.x * W + warp) * 16;
  const long ra = row0 + g, rb = row0 + g + 8;
  const bool va = ra < p.n, vb = rb < p.n;
  // the warp's rows in shared memory, in fragment order ([4 j + c][lane]):
  // xs, the substep's start state during its four stages; sk, the last
  // stage's derivative; ss, the running k1 + 2 k2 + 2 k3 + k4 (f32
  // accumulator fragments); hs, bf16(h), and zq, the A fragments the zone
  // loops' products share (bf16(q), the decode's bf16(x Wd)), reloaded for
  // each zone box so that no A fragment of an in-flight product is carried
  // in registers from one box to the next. Kept out of the registers, which
  // the products' activations need.
  float (*xs)[32] = reinterpret_cast<float (*)[32]>(
      dyn_smem() + B::kRingBytes + warp * B::kWarpBytes);
  float (*sk)[32] = xs + 4 * NX;
  float (*ss)[32] = sk + 4 * NX;
  uint32_t (*hs)[32] = reinterpret_cast<uint32_t (*)[32]>(ss + 4 * NX);
  uint32_t (*zq)[32] = hs + 4 * KC;

  ServeRing<DA, DZ, DC, H, kDecode, W> ring;
  ring.prime(p);

  // ---- load x (accumulator layout) -------------------------------------
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int c = 8 * j + 2 * t;
    float2 lo = va ? *reinterpret_cast<const float2*>(p.x + ra * DA + c)
                   : make_float2(0.f, 0.f);
    float2 hi = vb ? *reinterpret_cast<const float2*>(p.x + rb * DA + c)
                   : make_float2(0.f, 0.f);
    xs[4 * j][lane] = lo.x; xs[4 * j + 1][lane] = lo.y;
    xs[4 * j + 2][lane] = hi.x; xs[4 * j + 3][lane] = hi.y;
  }
  if (kDay) store_x<NX>(p.x_out, xs, ra, rb, va, vb, t, lane);  // xs[0]

  // ---- bf16(h), the A fragments of Dense_0's h rows ----------------------
  {
#pragma unroll
    for (int s = 0; s < KC; ++s) {
      const int c = 16 * s + 2 * t;
      float2 a0 = va ? *reinterpret_cast<const float2*>(p.h + ra * DC + c)
                     : make_float2(0.f, 0.f);
      float2 a1 = vb ? *reinterpret_cast<const float2*>(p.h + rb * DC + c)
                     : make_float2(0.f, 0.f);
      float2 a2 = va ? *reinterpret_cast<const float2*>(p.h + ra * DC + c + 8)
                     : make_float2(0.f, 0.f);
      float2 a3 = vb ? *reinterpret_cast<const float2*>(p.h + rb * DC + c + 8)
                     : make_float2(0.f, 0.f);
      hs[4 * s][lane] = pack_bf16(a0.x, a0.y);
      hs[4 * s + 1][lane] = pack_bf16(a1.x, a1.y);
      hs[4 * s + 2][lane] = pack_bf16(a2.x, a2.y);
      hs[4 * s + 3][lane] = pack_bf16(a3.x, a3.y);
    }
  }

  const float scale = 1.0f / sqrtf((float)DZ);
  float dt = p.dt;
  float half = dt * 0.5f;
  float sixth = dt / 6.0f;

  for (int st = 0; st < p.stages; ++st) {
    const int r = st & 3;  // RK4 stage within the substep
    if (kDay && r == 0) {  // the substep's own size
      dt = p.dts[st >> 2];
      half = dt * 0.5f;
      sixth = dt / 6.0f;
    }
    // ---- stage input: xs + c_r * k_{r-1}, rounded to bf16 -------------
    // (separate multiply and add, no fma: the rounding of the reference)
    uint32_t xa[KX][4];
    {
      const float cr = (r == 0) ? 0.f : ((r == 3) ? dt : half);
      float xin[NX][4];
#pragma unroll
      for (int j = 0; j < NX; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xin[j][c] = (r == 0) ? xs[4 * j + c][lane]
                               : __fadd_rn(xs[4 * j + c][lane],
                                           __fmul_rn(cr, sk[4 * j + c][lane]));
      c_to_a<DA>(xin, xa);
    }

    // ---- q = xb @ Wq -------------------------------------------------------
    {
      const bf16* bx = ring.next(p);  // Wq^T (DZ, DA)
      float q[NZ][4];
      wg_product<NZ, KX>(q, 0, xa, bx, DZ * 32);
      uint32_t qa[KZ][4];
      c_to_a<DZ>(q, qa);
      frag_put(zq, qa, lane);
    }

    // ---- ctx = softmax(q ze^T * scale) @ ze, max-free, by zone chunks ---
    float ctx[NZ][4];
    zero(ctx);
    float rs_a = 0.f, rs_b = 0.f;
    for (int zc0 = 0; zc0 < p.zp; zc0 += B::ZC) {
      const bf16* bx = ring.next(p);  // ze rows | ze^T columns
      // the box's scores, zone zc0 + 8 j + 2 t + (c & 1) in sc[j][c] (the
      // box's rows past zp are zero; their zones are masked)
      float sc[ZB][4];
      {
        uint32_t qa[KZ][4];
        frag_get(qa, zq, lane);
        wg_product<ZB, KZ>(sc, 0, qa, bx, B::ZC * 32);
      }
      // by 16-zone chunks, in zone order: chunk i is ctx's k-slice i
      uint32_t pa[ZB / 2][4];
#pragma unroll
      for (int i = 0; i < ZB / 2; ++i) {
        float* s0 = sc[2 * i];
        float* s1 = sc[2 * i + 1];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int za = zc0 + 16 * i + 2 * t + (c & 1);
          s0[c] = za < p.z ? expf(fminf(s0[c] * scale, 80.f)) : 0.f;
          s1[c] = za + 8 < p.z ? expf(fminf(s1[c] * scale, 80.f)) : 0.f;
        }
        rs_a += (s0[0] + s0[1]) + (s1[0] + s1[1]);
        rs_b += (s0[2] + s0[3]) + (s1[2] + s1[3]);
        pa[i][0] = pack_bf16(s0[0], s0[1]);
        pa[i][1] = pack_bf16(s0[2], s0[3]);
        pa[i][2] = pack_bf16(s1[0], s1[1]);
        pa[i][3] = pack_bf16(s1[2], s1[3]);
      }
      fence_acc(ctx);
      fence_a(pa);
      wg_open();
      wg_issue<NZ, ZB / 2>(ctx, 0, pa, bx + B::ZC * DZ, DZ * 32);  // ze^T
      wg_close();
      fence_acc(ctx);
      fence_a(pa);
    }
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
    const float inv_a = 1.0f / rs_a, inv_b = 1.0f / rs_b;

    // ---- feats = [xb, bf16(ctx * inv)] ------------------------------------
    uint32_t fa[KF][4];
#pragma unroll
    for (int s = 0; s < KX; ++s)
#pragma unroll
      for (int c = 0; c < 4; ++c) fa[s][c] = xa[s][c];
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      ctx[j][0] *= inv_a; ctx[j][1] *= inv_a;
      ctx[j][2] *= inv_b; ctx[j][3] *= inv_b;
    }
    {
      uint32_t ca[KZ][4];
      c_to_a<DZ>(ctx, ca);
#pragma unroll
      for (int s = 0; s < KZ; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) fa[KX + s][c] = ca[s][c];
    }

    // ---- z = tanh(feats @ W1xc + bf16(h) @ W1h + tf[st]), by halves of H --
    // (the h-row product again each stage: its bits are the same, and
    // holding it would cost 512 bytes a row)
    float zz[NH][4];
    const float* tfr = p.tf + (size_t)st * H;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const bf16* bx = ring.next(p);  // W1xc^T rows | W1h^T rows
      const bf16* bh = bx + B::HH * DF;
      uint32_t ha[KC][4];
#pragma unroll
      for (int s = 0; s < KC; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c) ha[s][c] = hs[4 * s + c][lane];
      // both of Dense_0's products of this half in one group
      float hp[NH / 2][4];
      wg_zero<NH / 2>(zz, hh * (NH / 2));
      wg_zero<NH / 2>(hp, 0);
      fence_acc(zz);
      fence_acc(hp);
      fence_a(fa);
      fence_a(ha);
      wg_open();
      wg_issue<NH / 2, KF>(zz, hh * (NH / 2), fa, bx, B::HH * 32);
      wg_issue<NH / 2, KC>(hp, 0, ha, bh, B::HH * 32);
      wg_close();
      fence_acc(zz);
      fence_acc(hp);
      fence_a(fa);
      fence_a(ha);
#pragma unroll
      for (int u = 0; u < NH / 2; ++u) {
        const int j = hh * (NH / 2) + u;
        const float2 tv =
            __ldg(reinterpret_cast<const float2*>(tfr + 8 * j + 2 * t));
#pragma unroll
        for (int c = 0; c < 4; ++c)
          zz[j][c] = tanhf((zz[j][c] + hp[u][c]) + ((c & 1) ? tv.y : tv.x));
      }
    }

    // ---- residual blocks: z = tanh(z + bf16(tanh(bf16(z) Wr1 + br1)) Wr2 + br2)
    for (int b = 0; b < p.num_blocks; ++b) {
      const bf16* br1 = p.br + (size_t)(2 * b) * H;
      const bf16* br2 = br1 + H;
      uint32_t za[KH][4];
      c_to_a<H>(zz, za);
      uint32_t rta[KH][4];
      // the two n-blocks 2s, 2s+1 of rt make its k-slice s for Wr2
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bf16* bx = ring.next(p);  // Wr1^T rows of this half
        float eo[NH / 2][4];
        wg_product<NH / 2, KH>(eo, 0, za, bx, B::HH * 32);
#pragma unroll
        for (int u = 0; u < KH / 2; ++u) {
          const int s = hh * (KH / 2) + u;
          const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
          const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
          const float* e = eo[2 * u];
          const float* o = eo[2 * u + 1];
          rta[s][0] = pack_bf16(tanhf(e[0] + be.x), tanhf(e[1] + be.y));
          rta[s][1] = pack_bf16(tanhf(e[2] + be.x), tanhf(e[3] + be.y));
          rta[s][2] = pack_bf16(tanhf(o[0] + bo.x), tanhf(o[1] + bo.y));
          rta[s][3] = pack_bf16(tanhf(o[2] + bo.x), tanhf(o[3] + bo.y));
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bf16* bx = ring.next(p);  // Wr2^T rows of this half
        float acc[NH / 2][4];
        wg_product<NH / 2, KH>(acc, 0, rta, bx, B::HH * 32);
#pragma unroll
        for (int u = 0; u < NH / 2; ++u) {
          const int j = hh * (NH / 2) + u;
          const float* a = acc[u];
          const float2 bv = unpack_bf16(ldg32(br2 + 8 * j + 2 * t));
          zz[j][0] = tanhf(zz[j][0] + (a[0] + bv.x));
          zz[j][1] = tanhf(zz[j][1] + (a[1] + bv.y));
          zz[j][2] = tanhf(zz[j][2] + (a[2] + bv.x));
          zz[j][3] = tanhf(zz[j][3] + (a[3] + bv.y));
        }
      }
    }

    // ---- k = bf16(z) @ W3 + b3; RK4 accumulation --------------------------
    {
      uint32_t za[KH][4];
      c_to_a<H>(zz, za);
      const bf16* bx = ring.next(p);  // W3^T (DA, H)
      const float w = (r == 1 || r == 2) ? 2.0f : 1.0f;
      float k[NX][4];
      wg_product<NX, KH>(k, 0, za, bx, DA * 32);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const float2 bv = unpack_bf16(ldg32(p.b3 + 8 * j + 2 * t));
        k[j][0] += bv.x;
        k[j][1] += bv.y;
        k[j][2] += bv.x;
        k[j][3] += bv.y;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* ks = &ss[4 * j + c][lane];
          sk[4 * j + c][lane] = k[j][c];
          *ks = (r == 0) ? k[j][c] : __fadd_rn(*ks, __fmul_rn(w, k[j][c]));
          if (r == 3)
            xs[4 * j + c][lane] =
                __fadd_rn(xs[4 * j + c][lane], __fmul_rn(sixth, *ks));
        }
      }
      if (kDay && r == 3)  // the substep's carry: xs[st / 4 + 1]
        store_x<NX>(p.x_out + (size_t)((st >> 2) + 1) * p.n * DA, xs, ra, rb,
                    va, vb, t, lane);
    }
  }

  // ---- store x_new ----------------------------------------------------------
  if (!kDay) store_x<NX>(p.x_out, xs, ra, rb, va, vb, t, lane);

  if (kDecode) {
    // ---- decode: ids = argmax(bf16(bf16(x) @ Wd) @ ze^T), first index ----
    uint32_t xa[KX][4];
    {
      float xf[NX][4];
#pragma unroll
      for (int j = 0; j < NX; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) xf[j][c] = xs[4 * j + c][lane];
      c_to_a<DA>(xf, xa);
    }
    {
      const bf16* bx = ring.next(p);  // Wd^T (DZ, DA)
      float d[NZ][4];
      wg_product<NZ, KX>(d, 0, xa, bx, DZ * 32);
      uint32_t dA[KZ][4];
      c_to_a<DZ>(d, dA);
      frag_put(zq, dA, lane);
    }
    float best_a = -INFINITY, best_b = -INFINITY;
    int idx_a = 0, idx_b = 0;
    for (int zc0 = 0; zc0 < p.zp; zc0 += B::ZC) {
      const bf16* bx = ring.next(p);  // ze rows | ze^T columns
      // the box's logits, zone zc0 + 8 i + 2 t + c in lg[i][c] (row g) and
      // lg[i][2 + c] (row g + 8), taken in zone order
      float lg[ZB][4];
      {
        uint32_t dA[KZ][4];
        frag_get(dA, zq, lane);
        wg_product<ZB, KZ>(lg, 0, dA, bx, B::ZC * 32);
      }
#pragma unroll
      for (int i = 0; i < ZB; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int zi = zc0 + 8 * i + 2 * t + c;
          if (zi < p.z) {
            if (lg[i][c] > best_a) { best_a = lg[i][c]; idx_a = zi; }
            if (lg[i][2 + c] > best_b) { best_b = lg[i][2 + c]; idx_b = zi; }
          }
        }
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const float ob_a = __shfl_xor_sync(0xffffffffu, best_a, m);
      const int oi_a = __shfl_xor_sync(0xffffffffu, idx_a, m);
      const float ob_b = __shfl_xor_sync(0xffffffffu, best_b, m);
      const int oi_b = __shfl_xor_sync(0xffffffffu, idx_b, m);
      if (ob_a > best_a || (ob_a == best_a && oi_a < idx_a)) { best_a = ob_a; idx_a = oi_a; }
      if (ob_b > best_b || (ob_b == best_b && oi_b < idx_b)) { best_b = ob_b; idx_b = oi_b; }
    }
    if (t == 0) {
      if (va) p.ids[ra] = idx_a;
      if (vb) p.ids[rb] = idx_b;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a TMA map of a row-major (rows x cols) bf16 matrix: boxes of 32 columns x
// box_rows rows, written with 64-byte swizzle, zeros past the matrix
bool box_map(CUtensorMap* m, const void* base, int rows, int cols,
             int box_rows) {
  const EncodeTiled f = encoder();
  if (f == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
           dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
           CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the interval kernel over `p` on `stream`, for the widths it is compiled
// for; cudaErrorInvalidValue for others
template <bool kDecode, bool kDay = false, int W = kWarps>
int launch(Params& p, int da, int dz, int dc, int hdim, cudaStream_t s) {
  if (!(da == 32 && dz == 64 && dc == 32 && hdim == 128))
    return (int)cudaErrorInvalidValue;
  constexpr int DA = 32, DZ = 64, DC = 32, H = 128;
  using B = Boxes<DA, DZ, DC, H>;
  const bool ok =
      box_map(&p.tm_wq, p.wqT, DZ, DA, DZ) &&
      box_map(&p.tm_ze, p.ze, p.zp, DZ, B::ZC) &&
      box_map(&p.tm_zet, p.zeT, DZ, p.zp, DZ) &&
      box_map(&p.tm_w1xc, p.w1xcT, H, B::DF, B::HH) &&
      box_map(&p.tm_w1h, p.w1hT, H, DC, B::HH) &&
      box_map(&p.tm_wr, p.wrT, 2 * p.num_blocks * H, H, B::HH) &&
      box_map(&p.tm_w3, p.w3T, DA, H, DA) &&
      (!kDecode || box_map(&p.tm_wd, p.wdT, DZ, DA, DZ));
  if (!ok) return (int)cudaErrorNotSupported;
  auto* kernel = interval_kernel<32, 64, 32, 128, kDecode, kDay, W>;
  const int smem = Boxes<32, 64, 32, 128>::bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the largest shared-memory carveout (smallest L1): the weights come
  // through the ring, and the more CTAs the SM holds the better
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * W;
  kernel<<<(unsigned)((p.n + rows - 1) / rows), 32 * W, smem, s>>>(p);
  return (int)cudaGetLastError();
}

void set_params(Params& p, const void* x, const void* h, const void* ze,
                const void* zeT, const void* wqT, const void* w1xcT,
                const void* w1hT, const void* wrT, const void* br,
                const void* w3T, const void* b3, const void* tf,
                void* x_out, int n, int z, int zp, int num_blocks,
                int stages, float dt) {
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.ze = static_cast<const __nv_bfloat16*>(ze);
  p.zeT = static_cast<const __nv_bfloat16*>(zeT);
  p.wqT = static_cast<const __nv_bfloat16*>(wqT);
  p.w1xcT = static_cast<const __nv_bfloat16*>(w1xcT);
  p.w1hT = static_cast<const __nv_bfloat16*>(w1hT);
  p.wrT = static_cast<const __nv_bfloat16*>(wrT);
  p.br = static_cast<const __nv_bfloat16*>(br);
  p.w3T = static_cast<const __nv_bfloat16*>(w3T);
  p.b3 = static_cast<const __nv_bfloat16*>(b3);
  p.tf = static_cast<const float*>(tf);
  p.x_out = static_cast<float*>(x_out);
  p.wdT = nullptr;
  p.ids = nullptr;
  p.dts = nullptr;
  p.n = n; p.z = z; p.zp = zp; p.num_blocks = num_blocks; p.stages = stages;
  p.dt = dt;
}

bool sizes_ok(int n, int z, int zp, int num_blocks, int stages) {
  return num_blocks >= 1 && num_blocks <= kMaxBlocks && n >= 1 && z >= 1 &&
         zp % 16 == 0 && zp >= z && stages >= 4 && stages % 4 == 0;
}

}  // namespace

extern "C" {

// Launch one interval (K1) on `stream`. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for widths this file
// was not compiled for or a bad block count.
int ananke_rk4_interval_decode(
    const void* x, const void* h, const void* ze, const void* zeT,
    const void* wqT, const void* w1xcT, const void* w1hT, const void* wrT,
    const void* br, const void* w3T, const void* b3, const void* wdT,
    const void* tf, void* x_out, void* ids, int n, int z, int zp,
    int num_blocks, int stages, float dt, int da, int dz, int dc, int hdim,
    void* stream) {
  if (!sizes_ok(n, z, zp, num_blocks, stages))
    return (int)cudaErrorInvalidValue;
  Params p;
  set_params(p, x, h, ze, zeT, wqT, w1xcT, w1hT, wrT, br, w3T, b3, tf, x_out,
             n, z, zp, num_blocks, stages, dt);
  p.wdT = static_cast<const __nv_bfloat16*>(wdT);
  p.ids = static_cast<int*>(ids);
  return launch<true>(p, da, dz, dc, hdim, static_cast<cudaStream_t>(stream));
}

// Launch one RK4 step (K0) on `stream`: `tf` holds the step's 4 stage rows.
// Returns as ananke_rk4_interval_decode.
int ananke_rk4_step(const void* x, const void* h, const void* ze,
                    const void* zeT, const void* wqT, const void* w1xcT,
                    const void* w1hT, const void* wrT, const void* br,
                    const void* w3T, const void* b3, const void* tf,
                    void* x_out, int n, int z, int zp, int num_blocks,
                    float dt, int da, int dz, int dc, int hdim,
                    void* stream) {
  if (!sizes_ok(n, z, zp, num_blocks, 4)) return (int)cudaErrorInvalidValue;
  Params p;
  set_params(p, x, h, ze, zeT, wqT, w1xcT, w1hT, wrT, br, w3T, b3, tf, x_out,
             n, z, zp, num_blocks, 4, dt);
  return launch<false>(p, da, dz, dc, hdim,
                       static_cast<cudaStream_t>(stream));
}

// Launch the fixed-step training day's forward (K2f) on `stream`: `steps`
// RK4 substeps from x0, substep s of size dts[s] with the time rows tf[s]
// (steps, 4, H), x0 and every substep's carry into xs (steps + 1, n, DA).
// w0 .. w11 are the 12 stage weights in drift_stage.cuh's set_weights
// order; the kernel reads the (out, in) ones: Wq^T (w0), W1xc^T (w2), W1h^T
// (w4), the residual matrices' Wr^T (w6), their biases (w8), W3^T (w9) and
// b3 (w11). Returns as ananke_rk4_interval_decode.
int ananke_day_forward(const void* x0, const void* h, const void* ze,
                       const void* zeT, const void* tf, const void* dts,
                       const void* w0, const void* w1, const void* w2,
                       const void* w3, const void* w4, const void* w5,
                       const void* w6, const void* w7, const void* w8,
                       const void* w9, const void* w10, const void* w11,
                       void* xs, int n, int z, int zp, int num_blocks,
                       int steps, int da, int dz, int dc, int hdim,
                       void* stream) {
  (void)w1; (void)w3; (void)w5; (void)w7; (void)w10;
  if (steps < 1 || !sizes_ok(n, z, zp, num_blocks, 4 * steps))
    return (int)cudaErrorInvalidValue;
  Params p;
  set_params(p, x0, h, ze, zeT, w0, w2, w4, w6, w8, w9, w11, tf, xs, n, z,
             zp, num_blocks, 4 * steps, 0.f);
  p.dts = static_cast<const float*>(dts);
  return launch<false, true>(p, da, dz, dc, hdim,
                             static_cast<cudaStream_t>(stream));
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
