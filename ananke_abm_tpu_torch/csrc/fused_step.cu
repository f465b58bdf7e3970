// The GAT-ODE serving rollout's kernels on Hopper (sm_90a), one template
// for both, for every agent in one launch:
// - K1: one output interval, `substeps` RK4 steps of the drift, then the
//   decode and its first-index argmax (ananke_rk4_interval_decode);
// - K0: one RK4 step, the same stage code with the decode compiled out
//   (ananke_rk4_step), for the per-step rollout, whose decode is a plain
//   product after each interval.
//
// Replaces the Pallas TPU kernels
//   K1 ananke_abm_tpu/ops/pallas/fused_step.py::rk4_interval_decode_fused
//   K0 ananke_abm_tpu/ops/pallas/fused_step.py::rk4_step_fused
// (stage math: _stage_math in the same file). The plain PyTorch versions
// are ananke_abm_tpu_torch/ops/cuda/fused_step.py::
// rk4_interval_decode_reference and ::rk4_step_reference. K0 is K1 with
// `stages` = 4 and no decode: per agent and step it reads x and h and
// writes x, ~0.75 MFLOP against ~384 bytes, compute-bound as K1 is.
//
// What bounds it on the card. Per agent and interval the kernel does ~1.5
// MFLOP of bf16 matmul work (8 drift evaluations of ~92k multiply-adds at
// the shipping widths) against ~390 bytes of device-memory traffic (read x
// and h, write x and the id): ~3,800 FLOP/byte, far above the H100's
// ~295 FLOP/byte ridge. It is compute-bound, so the design keeps every
// activation on chip and runs every product on the tensor cores:
//
// - One warp owns 16 agent rows end to end; warps never communicate and
//   the kernel has no block-wide barrier. A block is 4 warps (64 rows);
//   the ragged tail is zero-filled on load and masked on store.
// - Products are mma.sync.m16n8k16 bf16 x bf16 -> f32. An accumulator
//   fragment (16x8, f32) has exactly the register layout of half of the
//   next product's A fragment (16x16, bf16), so each activation goes from
//   one matmul into the next in registers, rounded to bf16 on the way --
//   the rounding points of the reference stage math.
// - Weights are not staged in shared memory: the packed weights and zone
//   table are ~180 KB of bf16, which leaves too little of the 227 KB for
//   a useful agent tile. B fragments are read straight from device memory
//   through the read-only path; every warp on the card reads the same
//   ~180 KB, which stays resident in L2 (50 MB). Each
//   weight matrix is stored (out, in), so one 32-bit load gives the two
//   adjacent-k bf16 values of a B-fragment register.
// - The h-row product of Dense_0 (h is constant over the interval) is
//   computed once per interval and parked in shared memory, in fragment
//   order, 8 KB per warp at hidden width 128.
// - Zones are walked in chunks of 16, so any zone count works. The
//   max-free softmax needs no rescaling across chunks: sum(exp) and
//   sum(exp * ze) simply add. The decode argmax keeps a running maximum
//   that a later zone replaces only when strictly greater, then reduces
//   across the 4 threads that share a row, preferring the lower index on
//   ties -- the first index, as in the reference.
// - The 8 stages run in one loop with a runtime stage index, so the stage
//   code is emitted once.
//
// Measured on an H100 (700 W): 25 ms per interval at 1,048,576 agents,
// ~62 TFLOP/s, about 6% of the dense bf16 peak. The kernel uses 255
// registers a thread, so an SM holds 2 blocks (8 warps), too few to hide
// the latency of the mma chains and of the B-fragment loads. Neither more
// independent accumulators (more registers, spills) nor a larger L1 helped;
// the smallest L1 (largest shared carveout) gained ~2.5%, and is set at
// launch. Fewer live registers (activations in shared memory) or wgmma
// with TMA-staged weights are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace ananke;

constexpr int kWarps = 4;  // warps per block: 64 agent rows
constexpr int kMaxBlocks = 8;

struct Params {
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
  float* x_out;                // (n, DA)
  int* ids;                    // (n), unless the decode is compiled out
  int n, z, zp, num_blocks, stages;
  float dt;
};

// kDecode: K1 (the stages, then the decode and argmax) or K0 (the stages)
template <int DA, int DZ, int DC, int H, bool kDecode>
__global__ void __launch_bounds__(32 * kWarps)
    interval_kernel(const Params p) {
  constexpr int NX = DA / 8, KX = DA / 16;
  constexpr int NZ = DZ / 8, KZ = DZ / 16;
  constexpr int KC = DC / 16;
  constexpr int NH = H / 8, KH = H / 16;
  constexpr int KF = KX + KZ;  // feats = [x, ctx]
  static_assert(DA % 16 == 0 && DZ % 16 == 0 && DC % 16 == 0 &&
                    H % 16 == 0,
                "widths must be multiples of 16");

  // h-row pre-activation of Dense_0, in accumulator-fragment order
  __shared__ float hpre_s[kWarps][NH * 4][32];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long row0 = ((long)blockIdx.x * kWarps + warp) * 16;
  const long ra = row0 + g, rb = row0 + g + 8;
  const bool va = ra < p.n, vb = rb < p.n;
  float (*hpre)[32] = hpre_s[warp];

  // ---- load x (accumulator layout) -------------------------------------
  float xs[NX][4];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int c = 8 * j + 2 * t;
    float2 lo = va ? *reinterpret_cast<const float2*>(p.x + ra * DA + c)
                   : make_float2(0.f, 0.f);
    float2 hi = vb ? *reinterpret_cast<const float2*>(p.x + rb * DA + c)
                   : make_float2(0.f, 0.f);
    xs[j][0] = lo.x; xs[j][1] = lo.y; xs[j][2] = hi.x; xs[j][3] = hi.y;
  }

  // ---- h_pre = bf16(h) @ W1h, once per interval ------------------------
  {
    uint32_t ha[KC][4];
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
      ha[s][0] = pack_bf16(a0.x, a0.y);
      ha[s][1] = pack_bf16(a1.x, a1.y);
      ha[s][2] = pack_bf16(a2.x, a2.y);
      ha[s][3] = pack_bf16(a3.x, a3.y);
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
      mma_nblocks<DC, 1>(acc, 0, ha, p.w1hT + (size_t)8 * j * DC, g, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) hpre[4 * j + c][lane] = acc[0][c];
    }
  }

  const float scale = 1.0f / sqrtf((float)DZ);
  const float dt = p.dt;
  const float half = dt * 0.5f;
  const float sixth = dt / 6.0f;

  // xs is the substep's start state during its four stages; k the last
  // stage's derivative; ksum the running k1 + 2 k2 + 2 k3 + k4
  float ksum[NX][4], k[NX][4];
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) { ksum[j][c] = 0.f; k[j][c] = 0.f; }

  for (int st = 0; st < p.stages; ++st) {
    const int r = st & 3;  // RK4 stage within the substep
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
          xin[j][c] = (r == 0) ? xs[j][c]
                               : __fadd_rn(xs[j][c], __fmul_rn(cr, k[j][c]));
      c_to_a<DA>(xin, xa);
    }

    // ---- q = xb @ Wq -------------------------------------------------------
    uint32_t qa[KZ][4];
    {
      float q[NZ][4];
      zero(q);
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        mma_nblocks<DA, 1>(q, j, xa, p.wqT + (size_t)8 * j * DA, g, t);
      c_to_a<DZ>(q, qa);
    }

    // ---- ctx = softmax(q ze^T * scale) @ ze, max-free, by zone chunks ---
    float ctx[NZ][4];
#pragma unroll
    for (int j = 0; j < NZ; ++j) ctx[j][0] = ctx[j][1] = ctx[j][2] = ctx[j][3] = 0.f;
    float rs_a = 0.f, rs_b = 0.f;
    for (int z0 = 0; z0 < p.zp; z0 += 16) {
      // scores of zones z0 .. z0+7 (sc[0]) and z0+8 .. z0+15 (sc[1])
      float sc[2][4];
      zero(sc);
      mma_nblocks<DZ, 2>(sc, 0, qa, p.ze + (size_t)z0 * DZ, g, t);
      float* s0 = sc[0];
      float* s1 = sc[1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int za = z0 + 2 * t + (c & 1);
        s0[c] = za < p.z ? expf(fminf(s0[c] * scale, 80.f)) : 0.f;
        s1[c] = za + 8 < p.z ? expf(fminf(s1[c] * scale, 80.f)) : 0.f;
      }
      rs_a += (s0[0] + s0[1]) + (s1[0] + s1[1]);
      rs_b += (s0[2] + s0[3]) + (s1[2] + s1[3]);
      uint32_t pa[1][4];
      pa[0][0] = pack_bf16(s0[0], s0[1]);
      pa[0][1] = pack_bf16(s0[2], s0[3]);
      pa[0][2] = pack_bf16(s1[0], s1[1]);
      pa[0][3] = pack_bf16(s1[2], s1[3]);
      // zeT is (DZ, zp): the 16 zones of this chunk are k-slice z0 / 16
      const __nv_bfloat16* zt = p.zeT + z0;
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        const __nv_bfloat16* rowp = zt + (size_t)(8 * j + g) * p.zp + 2 * t;
        mma(ctx[j], pa[0], ldg32(rowp), ldg32(rowp + 8));
      }
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

    // ---- z = tanh(feats @ W1xc + h_pre + tf[st]) --------------------------
    float zz[NH][4];
    const float* tfr = p.tf + (size_t)st * H;
    zero(zz);
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      mma_nblocks<DA + DZ, 1>(zz, j, fa, p.w1xcT + (size_t)8 * j * (DA + DZ),
                              g, t);
      const float2 tv = __ldg(reinterpret_cast<const float2*>(tfr + 8 * j + 2 * t));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        zz[j][c] = tanhf((zz[j][c] + hpre[4 * j + c][lane]) + ((c & 1) ? tv.y : tv.x));
    }

    // ---- residual blocks: z = tanh(z + bf16(tanh(bf16(z) Wr1 + br1)) Wr2 + br2)
    for (int b = 0; b < p.num_blocks; ++b) {
      const __nv_bfloat16* wr1 = p.wrT + (size_t)(2 * b) * H * H;
      const __nv_bfloat16* wr2 = wr1 + (size_t)H * H;
      const __nv_bfloat16* br1 = p.br + (size_t)(2 * b) * H;
      const __nv_bfloat16* br2 = br1 + H;
      uint32_t za[KH][4];
      c_to_a<H>(zz, za);
      uint32_t ra_[KH][4];
      // the two n-blocks 2s, 2s+1 of rt make its k-slice s for Wr2
#pragma unroll
      for (int s = 0; s < KH; ++s) {
        float eo[2][4];
        zero(eo);
        mma_nblocks<H, 2>(eo, 0, za, wr1 + (size_t)16 * s * H, g, t);
        const float2 be = unpack_bf16(ldg32(br1 + 16 * s + 2 * t));
        const float2 bo = unpack_bf16(ldg32(br1 + 16 * s + 8 + 2 * t));
        const float* e = eo[0];
        const float* o = eo[1];
        ra_[s][0] = pack_bf16(tanhf(e[0] + be.x), tanhf(e[1] + be.y));
        ra_[s][1] = pack_bf16(tanhf(e[2] + be.x), tanhf(e[3] + be.y));
        ra_[s][2] = pack_bf16(tanhf(o[0] + bo.x), tanhf(o[1] + bo.y));
        ra_[s][3] = pack_bf16(tanhf(o[2] + bo.x), tanhf(o[3] + bo.y));
      }
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
        mma_nblocks<H, 1>(acc, 0, ra_, wr2 + (size_t)8 * j * H, g, t);
        const float* a = acc[0];
        const float2 bv = unpack_bf16(ldg32(br2 + 8 * j + 2 * t));
        zz[j][0] = tanhf(zz[j][0] + (a[0] + bv.x));
        zz[j][1] = tanhf(zz[j][1] + (a[1] + bv.y));
        zz[j][2] = tanhf(zz[j][2] + (a[2] + bv.x));
        zz[j][3] = tanhf(zz[j][3] + (a[3] + bv.y));
      }
    }

    // ---- k = bf16(z) @ W3 + b3; RK4 accumulation --------------------------
    {
      uint32_t za[KH][4];
      c_to_a<H>(zz, za);
      const float w = (r == 1 || r == 2) ? 2.0f : 1.0f;
      zero(k);
#pragma unroll
      for (int j = 0; j < NX; ++j)
        mma_nblocks<H, 1>(k, j, za, p.w3T + (size_t)8 * j * H, g, t);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const float2 bv = unpack_bf16(ldg32(p.b3 + 8 * j + 2 * t));
        k[j][0] += bv.x;
        k[j][1] += bv.y;
        k[j][2] += bv.x;
        k[j][3] += bv.y;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ksum[j][c] = (r == 0) ? k[j][c] : __fadd_rn(ksum[j][c], __fmul_rn(w, k[j][c]));
      }
    }
    if (r == 3) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          xs[j][c] = __fadd_rn(xs[j][c], __fmul_rn(sixth, ksum[j][c]));
    }
  }

  // ---- store x_new ----------------------------------------------------------
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int c = 8 * j + 2 * t;
    if (va) *reinterpret_cast<float2*>(p.x_out + ra * DA + c) = make_float2(xs[j][0], xs[j][1]);
    if (vb) *reinterpret_cast<float2*>(p.x_out + rb * DA + c) = make_float2(xs[j][2], xs[j][3]);
  }

  if (!kDecode) return;

  // ---- decode: ids = argmax(bf16(bf16(x) @ Wd) @ ze^T), first index ------
  uint32_t xa[KX][4];
  c_to_a<DA>(xs, xa);
  uint32_t dA[KZ][4];
  {
    float d[NZ][4];
    zero(d);
#pragma unroll
    for (int j = 0; j < NZ; ++j)
      mma_nblocks<DA, 1>(d, j, xa, p.wdT + (size_t)8 * j * DA, g, t);
    c_to_a<DZ>(d, dA);
  }
  float best_a = -INFINITY, best_b = -INFINITY;
  int idx_a = 0, idx_b = 0;
  for (int z0 = 0; z0 < p.zp; z0 += 8) {
    float lg[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    mma_nblocks<DZ, 1>(lg, 0, dA, p.ze + (size_t)z0 * DZ, g, t);
    const float* l = lg[0];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int zi = z0 + 2 * t + c;
      if (zi < p.z) {
        if (l[c] > best_a) { best_a = l[c]; idx_a = zi; }
        if (l[2 + c] > best_b) { best_b = l[2 + c]; idx_b = zi; }
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

// the interval kernel over `p` on `stream`, for the widths it is compiled
// for; cudaErrorInvalidValue for others
template <bool kDecode>
int launch(const Params& p, int da, int dz, int dc, int hdim,
           cudaStream_t s) {
  if (!(da == 32 && dz == 64 && dc == 32 && hdim == 128))
    return (int)cudaErrorInvalidValue;
  auto* kernel = interval_kernel<32, 64, 32, 128, kDecode>;
  // the largest shared-memory carveout (smallest L1): weights are read
  // from L2 either way, and on an H100 this ran faster than the default
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * kWarps;
  kernel<<<(unsigned)((p.n + rows - 1) / rows), 32 * kWarps, 0, s>>>(p);
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

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
