// The continuous adjoint's right-hand sides on Hopper (sm_90a), for every
// agent in one launch each:
// - K8: one GAT-ODE drift evaluation and its whole VJP at a cotangent `a`,
//   with the weight gradients summed over agents (the augmented right-hand
//   side of the backward solve; ananke_drift_rhs_and_vjp);
// - K8a: the drift evaluation alone, f = stage(bf16(x)) (the forward
//   solve's; ananke_drift_rhs).
//
// Replaces the Pallas TPU kernels
//   K8  ananke_abm_tpu/ops/pallas/fused_rhs.py::drift_rhs_and_vjp
//   K8a ananke_abm_tpu/ops/pallas/fused_rhs.py::drift_rhs_fused
// (stage math and stage VJP: _stage_math and _stage_vjp_math in
// ops/pallas/fused_step.py). The plain PyTorch versions are
// ananke_abm_tpu_torch/ops/cuda/fused_rhs.py::drift_rhs_and_vjp_reference
// and ::drift_rhs_reference.
//
// K8a is K8's forward half: drift_stage.cuh's stage_forward over a tile of
// 16 W rows, each warp its 16 rows end to end, no block barrier and no
// sums over agents; the forward's intermediates go to shared memory only
// because stage_forward keeps them there. Per agent ~190 kFLOP of bf16
// products against ~384 bytes (read x and h, write f): compute-bound.
//
// What it computes, per agent row: f = stage(x) (bf16 operands, f32 sums,
// max-free softmax clamped at 80 and normalised after the context
// product), then the stage's VJP at `a` with every bf16 rounding point of
// the reference: gx, gh per agent; gze, the time-row gradient gtf, and the
// gradients of Wq, W1xc, W1h, every residual block and the output layer,
// summed over agents.
//
// What bounds it on the card. About 3x the forward's matmul work (~550
// kFLOP per agent at the shipping widths and Z=64) against ~400 bytes of
// per-agent traffic: compute-bound per row. The weight gradients contract
// over agents; their sum (92,832 floats at Z=64) is larger than a block's
// shared memory, so it cannot stay on chip across tiles. The design:
//
// - A block of W warps owns a tile of 16 W agent rows; a fixed grid of
//   CTAs (num_ctas, chosen by the caller from N alone) walks the tiles
//   tile = blockIdx.x, + num_ctas, ... Each CTA owns a private slab of
//   every summed gradient in device memory and adds each tile's partial
//   sums into it with plain loads and stores; a second kernel sums the
//   slabs in CTA order. No atomics: the same operands give the same bits,
//   which the adjoint's step controller needs (it reads every element of
//   the gradient state, so low-bit noise would change the step count).
// - The stage and its VJP are drift_stage.cuh's stage_forward and
//   stage_backward (per-row products on mma.sync, the forward's
//   intermediates in shared memory, agent contractions through
//   ldmatrix.trans, the attention recomputed by zone chunks). Up to 7
//   blocks fit a 64-row tile's shared memory; 8 blocks take 32-row tiles.
//
// Rows past N are zero-filled: their cotangent is zero, so every gradient
// term they could feed is zero, as in the reference's padded tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "drift_stage.cuh"

namespace {

using namespace ananke;

constexpr int kMaxBlocks = 8;

struct Params {
  StageWeights w;
  const float* x;       // (n, DA)
  const float* h;       // (n, DC)
  const float* a;       // (n, DA) cotangent of f
  const float* tf;      // (H) time-row pre-activation
  float* f;             // (n, DA)
  float* gx;            // (n, DA)
  float* gh;            // (n, DC)
  float* slab;          // (num_ctas, slab_size)
  float* gsum;          // (slab_size) the slabs' sum
  int n, num_ctas;
  long slab_size;
};

template <int DA, int DZ, int DC, int H, int W>
__global__ void __launch_bounds__(32 * W)
    drift_vjp_kernel(const Params p) {
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8, KX = DA / 16;
  constexpr int KC = DC / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StageSmem sm = stage_smem<DA, DZ, DC, H, W>(smem_raw, p.w.num_blocks);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = warp * 16;  // the warp's first row in the tile
  const Slab<DA, DZ, DC, H> sl(p.w.z, p.w.num_blocks, 1);
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += p.num_ctas) {
    const long ra = (long)tile * ROWS + wr0 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;

    // forward: f = stage(bf16(x))
    uint32_t xa[KX][4];
    ldg_rows_a<DA>(xa, p.x, ra, rb, va, vb, t);
    uint32_t ha[KC][4];
    ldg_rows_a<DC>(ha, p.h, ra, rb, va, vb, t);
    float inv_a, inv_b;
    {
      float k[NX][4];
      stage_forward<DA, DZ, DC, H, W>(p.w, sm, xa, ha, p.tf, k, inv_a, inv_b,
                                      wr0, g, t);
      stg_rows_c<NX>(k, p.f, ra, rb, va, vb, t);
    }

    // backward at gk = a
    float ga[NX][4], gx[NX][4];
    ldg_rows_c<NX>(ga, p.a, ra, rb, va, vb, t);
    stage_backward<DA, DZ, DC, H, W>(
        p.w, sm, ga, ha, inv_a, inv_b, slab, sl, sl.gtf, first, gx, p.gh, ra,
        rb, va, vb, warp, lane);
    stg_rows_c<NX>(gx, p.gx, ra, rb, va, vb, t);
    first = false;
  }
}

struct FwdParams {
  StageWeights w;
  const float* x;   // (n, DA)
  const float* h;   // (n, DC)
  const float* tf;  // (H) time-row pre-activation
  float* f;         // (n, DA)
  int n;
};

template <int DA, int DZ, int DC, int H, int W>
__global__ void __launch_bounds__(32 * W) drift_rhs_kernel(const FwdParams p) {
  constexpr int NX = DA / 8, KX = DA / 16, KC = DC / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StageSmem sm = stage_smem_forward<DA, DZ, DC, H, W>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = warp * 16;
  const long ra = (long)blockIdx.x * 16 * W + wr0 + g, rb = ra + 8;
  const bool va = ra < p.n, vb = rb < p.n;
  uint32_t xa[KX][4];
  ldg_rows_a<DA>(xa, p.x, ra, rb, va, vb, t);
  uint32_t ha[KC][4];
  ldg_rows_a<DC>(ha, p.h, ra, rb, va, vb, t);
  float k[NX][4], inv_a, inv_b;
  stage_forward<DA, DZ, DC, H, W>(p.w, sm, xa, ha, p.tf, k, inv_a, inv_b,
                                  wr0, g, t);
  stg_rows_c<NX>(k, p.f, ra, rb, va, vb, t);
}

// warps of K8a's tile: 4 (64 rows); its forward buffers fit at 8 blocks
constexpr int kFwdWarps = 4;

template <int DA, int DZ, int DC, int H, int W>
int launch(const Params& p, cudaStream_t s) {
  auto* kernel = drift_vjp_kernel<DA, DZ, DC, H, W>;
  const size_t smem = Layout<DA, DZ, DC, H>::bytes(16 * W, W, p.w.num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.num_ctas, 32 * W, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_slabs(p.slab, p.gsum, p.slab_size, p.num_ctas, s);
}

void set_stage_weights(StageWeights& w, const void* const* wts,
                       const void* ze, const void* zeT, int z, int zp,
                       int num_blocks) {
  set_weights(w, wts);
  w.ze = static_cast<const bf16*>(ze);
  w.zeT = static_cast<const bf16*>(zeT);
  w.z = z; w.zp = zp; w.num_blocks = num_blocks;
}

}  // namespace

extern "C" {

// Agent rows per tile for `num_blocks` residual blocks: 64 (4 warps), or 32
// (2 warps) where a 64-row tile's intermediates would not fit in shared
// memory.
int ananke_drift_rhs_tile_rows(int num_blocks) {
  return num_blocks <= 7 ? 64 : 32;
}

// One drift evaluation and its VJP on `stream`: the main kernel, then the
// slab reduction into `gsum`. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for widths this file
// was not compiled for or bad sizes.
int ananke_drift_rhs_and_vjp(
    const void* x, const void* h, const void* a, const void* ze,
    const void* zeT, const void* tf, const void* wqT, const void* wq,
    const void* w1xcT, const void* w1xc, const void* w1hT, const void* w1h,
    const void* wrT, const void* wr, const void* br, const void* w3T,
    const void* w3, const void* b3, void* f, void* gx, void* gh, void* slab,
    void* gsum, int n, int z, int zp, int num_blocks, int num_ctas, int da,
    int dz, int dc, int hdim, void* stream) {
  const int rows = ananke_drift_rhs_tile_rows(num_blocks);
  const int n_tiles = (n + rows - 1) / rows;
  if (num_blocks < 1 || num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % 16 != 0 || zp < z || num_ctas < 1 || num_ctas > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  if (!(da == 32 && dz == 64 && dc == 32 && hdim == 128))
    return (int)cudaErrorInvalidValue;
  Params p;
  const void* wts[12] = {wqT, wq, w1xcT, w1xc, w1hT, w1h,
                         wrT, wr, br, w3T, w3, b3};
  set_stage_weights(p.w, wts, ze, zeT, z, zp, num_blocks);
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.a = static_cast<const float*>(a);
  p.tf = static_cast<const float*>(tf);
  p.f = static_cast<float*>(f);
  p.gx = static_cast<float*>(gx);
  p.gh = static_cast<float*>(gh);
  p.slab = static_cast<float*>(slab);
  p.gsum = static_cast<float*>(gsum);
  p.n = n;
  p.num_ctas = num_ctas;
  p.slab_size = Slab<32, 64, 32, 128>(z, num_blocks, 1).size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows == 64 ? launch<32, 64, 32, 128, 4>(p, s)
                    : launch<32, 64, 32, 128, 2>(p, s);
}

// One drift evaluation (K8a) on `stream`: f (n, DA) from x, h, the zones
// and the time row tf (H), the 12 weights as ananke_drift_rhs_and_vjp
// takes them. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for widths this file was not compiled for or bad
// sizes.
int ananke_drift_rhs(const void* x, const void* h, const void* ze,
                     const void* zeT, const void* tf, const void* wqT,
                     const void* wq, const void* w1xcT, const void* w1xc,
                     const void* w1hT, const void* w1h, const void* wrT,
                     const void* wr, const void* br, const void* w3T,
                     const void* w3, const void* b3, void* f, int n, int z,
                     int zp, int num_blocks, int da, int dz, int dc,
                     int hdim, void* stream) {
  if (num_blocks < 1 || num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % 16 != 0 || zp < z)
    return (int)cudaErrorInvalidValue;
  if (!(da == 32 && dz == 64 && dc == 32 && hdim == 128))
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  const void* wts[12] = {wqT, wq, w1xcT, w1xc, w1hT, w1h,
                         wrT, wr, br, w3T, w3, b3};
  set_stage_weights(p.w, wts, ze, zeT, z, zp, num_blocks);
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.tf = static_cast<const float*>(tf);
  p.f = static_cast<float*>(f);
  p.n = n;
  auto* kernel = drift_rhs_kernel<32, 64, 32, 128, kFwdWarps>;
  const size_t smem =
      Layout<32, 64, 32, 128>::bytes_forward(16 * kFwdWarps, num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * kFwdWarps;
  kernel<<<(unsigned)((n + rows - 1) / rows), 32 * kFwdWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
