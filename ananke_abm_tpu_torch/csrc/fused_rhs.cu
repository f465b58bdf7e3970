// The continuous adjoint's augmented right-hand side on Hopper (sm_90a),
// K8: one GAT-ODE drift evaluation and its whole VJP at a cotangent `a`,
// for every agent in one launch, with the weight gradients summed over
// agents (ananke_drift_rhs_and_vjp). Its forward half K8a, the forward
// solve's right-hand side (ananke_drift_rhs), is the serving kernels'
// template's fourth instantiation, in fused_step.cu.
//
// Replaces the Pallas TPU kernel
//   K8 ananke_abm_tpu/ops/pallas/fused_rhs.py::drift_rhs_and_vjp
// (stage math and stage VJP: _stage_math and _stage_vjp_math in
// ops/pallas/fused_step.py). The plain PyTorch version is
// ananke_abm_tpu_torch/ops/cuda/fused_rhs.py::drift_rhs_and_vjp_reference.
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
// shared memory, so it cannot stay on chip across tiles. The design is
// stage_sm90.cuh's, as K2b's and K6's bf16 body's:
//
// - A tile is 16 W agent rows (96 up to 2 blocks, 64 up to 5, 32 beyond:
//   the most whose rows fit beside the ring), warp w owns rows 16 w ..
//   16 w + 15 end to end. A fixed grid of CTAs (num_ctas, chosen by the
//   caller from N alone) walks the tiles tile = blockIdx.x, + num_ctas, ...
// - A tile's weight operands are one period of the ring's RhsSchedule: the
//   stage forward's boxes, its VJP's, then W1h for the h rows (35 boxes at
//   Z = 64 and 2 blocks). Each box is copied once a tile by cp.async and
//   read by every warp from shared memory (ldmatrix B fragments); the
//   kernel this replaced read every B fragment from L2 warp by warp, with
//   a dependent load behind each product.
// - Each CTA owns a private slab of every summed gradient in device memory,
//   zeroed before the launch, and adds each tile's contractions into it by
//   16 x 32 output blocks a warp (a block's slab values read in one round
//   trip before its products); a second kernel sums the slabs in CTA order.
//   No atomics: the same operands give the same bits, which the adjoint's
//   step controller needs (it reads every element of the gradient state,
//   so low-bit noise would change the step count).
// - gx waits through the attention's VJP, and the h-row pre-activation's
//   cotangent until the period's last box, in a scratch of each warp's own
//   in device memory (lane-private, L2-resident): the ring and the rows the
//   VJP keeps fill the shared memory (230,400 bytes at 6 warps, 2 blocks).
//
// The per-row outputs f, gx and gh keep the bits of the kernel this
// replaced (drift_stage.cuh's math, rounding point for rounding point); the
// summed gradients add in another order (the tile height).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --ab-k8, rung 3's
// operands: 98,304 agents, Z = 64, 2 blocks): 1.70-1.71 ms against the
// replaced kernel's 4.79-4.83 in the same calls. Without its slab traffic
// it would take ~1.04 ms, without expf / tanhf ~1.52. At 6 warps ptxas
// spills 168 bytes; the tile body as a called function spills none and
// reads 4.5% slower, a warp's next slab block read ahead or an L2
// evict_last policy on the slabs 3-5% slower, and fewer CTAs (fewer
// slabs) slower still. PERF.md section 6 has the readings.
//
// Rows past N are zero-filled: their cotangent is zero, so every gradient
// term they could feed is zero, as in the reference's padded tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage_sm90.cuh"

namespace {

using namespace ananke;

constexpr int DA = 32, DZ = 64, DC = 32, H = 128;  // the widths compiled
constexpr int kMaxBlocks = 8;
// a warp's row scratch, fragment order: gx ([DA / 8 x 4][32] floats), then
// the h-row pre-activation's cotangent ([H / 8 x 4][32]): DA + H floats a row
constexpr int kFX = (DA / 8) * 4 * 32;
constexpr int kWarpFloats = 16 * (DA + H);

struct Params {
  StageWeights w;
  const float* x;   // (n, DA)
  const float* h;   // (n, DC)
  const float* a;   // (n, DA) cotangent of f
  const float* tf;  // (H) time-row pre-activation
  float* f;         // (n, DA)
  float* gx;        // (n, DA)
  float* gh;        // (n, DC)
  float* slab;      // (num_ctas, slab_size), zeroed before the launch
  float* scratch;   // (num_ctas, W, kWarpFloats): the warps' row scratch
  float* gsum;      // (slab_size) the slabs' sum
  int n, num_ctas;
  long slab_size;
};

// warps of the tile: the most whose rows fit the SM's shared memory beside
// the ring (sm90::Layout::bytes): 6 (96 rows) up to 2 blocks, 4 up to 5, 2
// beyond
inline int vjp_warps(int nb) { return nb <= 2 ? 6 : nb <= 5 ? 4 : 2; }

template <int W>
__global__ void __launch_bounds__(32 * W, 1)
    drift_vjp_kernel(const Params p) {
  constexpr int ROWS = 16 * W;
  constexpr int NX = DA / 8, KX = DA / 16;
  using Ring = sm90::Ring<DA, DZ, DC, H, W, sm90::RhsSchedule>;
  using L = sm90::Layout<DA, DZ, DC, H>;
  using S = sm90::Smem<DA, DZ, DC, H, W>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr0 = warp * 16;
  const long gtf = Slab<DA, DZ, DC, H>(p.w.z, p.w.num_blocks, 1).gtf;
  float* slab = p.slab + (size_t)blockIdx.x * p.slab_size;
  float* gx_slot =
      p.scratch + ((size_t)blockIdx.x * W + warp) * kWarpFloats;
  float* ghp = gx_slot + kFX;
  const int n_tiles = (p.n + ROWS - 1) / ROWS;
  const int period = Ring::period(p.w);
  Ring().prime(p.w);
  int c0 = 0;  // the ring's boxes consumed before the tile (mod kSlots)

  for (int tile = blockIdx.x; tile < n_tiles; tile += p.num_ctas) {
    const long ra = (long)tile * ROWS + wr0 + g, rb = ra + 8;
    const bool va = ra < p.n, vb = rb < p.n;
    {  // bf16(h) into the tile's hb rows (the last tile's readers ended on
       // h_rows' block barrier)
      uint32_t ha[DC / 16][4];
      ldg_rows_a<DC>(ha, p.h, ra, rb, va, vb, t);
      sts_a<DC>(ha, S::hb() + wr0 * L::SS, L::SS, g, t);
    }
    for (int i = 0; i < (H / 8) * 4; ++i) ghp[i * 32 + lane] = 0.f;
    Ring ring = Ring::at_step(c0);

    // forward: f = stage(bf16(x))
    float inv_a, inv_b;
    {
      uint32_t xa[KX][4];
      ldg_rows_a<DA>(xa, p.x, ra, rb, va, vb, t);
      float k[NX][4];
      sm90::stage_forward<DA, DZ, DC, H, W>(p.w, ring, xa, p.tf, k, inv_a,
                                            inv_b, wr0, g, t);
      stg_rows_c<NX>(k, p.f, ra, rb, va, vb, t);
    }
    // its VJP at gk = a: gx through the warp's slot, gpre1 into ghp
    {
      float ga[NX][4];
      ldg_rows_c<NX>(ga, p.a, ra, rb, va, vb, t);
      sm90::stage_backward<DA, DZ, DC, H, W>(p.w, ring, ga, inv_a, inv_b,
                                             slab, 1, gtf, gx_slot, ghp,
                                             warp, lane);
      float gx[NX][4];
      frag_ld<NX>(gx, gx_slot, lane);
      stg_rows_c<NX>(gx, p.gx, ra, rb, va, vb, t);
    }
    // hpre = bf16(h) @ W1h: gh = bf16(gpre1) @ W1h^T per row, gW1h +=
    // bf16(h)^T bf16(gpre1) (the period's last box)
    {
      float ghh[DC / 8][4];
      sm90::h_rows<DA, DZ, DC, H, W>(p.w, ring, ghp, slab, 1, ghh, warp,
                                     lane);
      stg_rows_c<DC / 8>(ghh, p.gh, ra, rb, va, vb, t);
    }
    c0 = (c0 + period) % L::kSlots;
  }
  Ring::drain();
}

template <int W>
int launch(const Params& p, cudaStream_t s) {
  auto* kernel = drift_vjp_kernel<W>;
  const size_t smem =
      sm90::Layout<DA, DZ, DC, H>::bytes(16 * W, W, p.w.num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(p.slab, 0,
                        (size_t)p.num_ctas * p.slab_size * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.num_ctas, 32 * W, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce_slabs(p.slab, p.gsum, p.slab_size, p.num_ctas, s);
}

}  // namespace

extern "C" {

// Agent rows per tile for `num_blocks` residual blocks: 96 (6 warps) up to
// 2 blocks, 64 up to 5, 32 beyond.
int ananke_drift_rhs_tile_rows(int num_blocks) {
  return 16 * vjp_warps(num_blocks);
}

// One drift evaluation and its VJP on `stream`: the slabs zeroed, the main
// kernel, then the slab reduction into `gsum`. `slab` holds num_ctas slabs
// of the summed gradients, then the CTAs' row scratch: num_ctas x
// ananke_drift_rhs_tile_rows(num_blocks) x (da + hdim) floats. Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for widths this file was not compiled for or bad
// sizes.
int ananke_drift_rhs_and_vjp(
    const void* x, const void* h, const void* a, const void* ze,
    const void* zeT, const void* tf, const void* wqT, const void* wq,
    const void* w1xcT, const void* w1xc, const void* w1hT, const void* w1h,
    const void* wrT, const void* wr, const void* br, const void* w3T,
    const void* w3, const void* b3, void* f, void* gx, void* gh, void* slab,
    void* gsum, int n, int z, int zp, int num_blocks, int num_ctas, int da,
    int dz, int dc, int hdim, void* stream) {
  if (num_blocks < 1 || num_blocks > kMaxBlocks || n < 1 || z < 1 ||
      zp % 16 != 0 || zp < z || num_ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = ananke_drift_rhs_tile_rows(num_blocks);
  if (num_ctas > (n + rows - 1) / rows) return (int)cudaErrorInvalidValue;
  if (!(da == DA && dz == DZ && dc == DC && hdim == H))
    return (int)cudaErrorInvalidValue;
  Params p;
  const void* wts[12] = {wqT, wq, w1xcT, w1xc, w1hT, w1h,
                         wrT, wr, br, w3T, w3, b3};
  set_weights(p.w, wts);
  p.w.ze = static_cast<const bf16*>(ze);
  p.w.zeT = static_cast<const bf16*>(zeT);
  p.w.z = z;
  p.w.zp = zp;
  p.w.num_blocks = num_blocks;
  p.x = static_cast<const float*>(x);
  p.h = static_cast<const float*>(h);
  p.a = static_cast<const float*>(a);
  p.tf = static_cast<const float*>(tf);
  p.f = static_cast<float*>(f);
  p.gx = static_cast<float*>(gx);
  p.gh = static_cast<float*>(gh);
  p.slab = static_cast<float*>(slab);
  p.slab_size = Slab<DA, DZ, DC, H>(z, num_blocks, 1).size;
  p.scratch = p.slab + (size_t)num_ctas * p.slab_size;
  p.gsum = static_cast<float*>(gsum);
  p.n = n;
  p.num_ctas = num_ctas;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows / 16) {
    case 6: return launch<6>(p, s);
    case 4: return launch<4>(p, s);
    default: return launch<2>(p, s);
  }
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
