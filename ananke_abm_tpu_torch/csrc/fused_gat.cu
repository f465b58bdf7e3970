// The zone-graph encoder (ZoneGAT) of the GAT-ODE on Hopper (sm_90a): two
// kernels, each replacing a Pallas TPU kernel of
// ananke_abm_tpu/ops/pallas/fused_gat.py. Plain PyTorch versions:
// ananke_abm_tpu_torch/ops/cuda/fused_gat.py::gat_{forward,backward}_reference.
//
// K4f ananke_gat_forward  <- _gat_fwd_impl. The whole encoder forward
//   (_gat_math): h0 = zf Win + bin, then per layer Wh = h W, per head the
//   scores s_ij = lrelu(e_src_i + e_dst_j) masked to -1e30 off the graph, a
//   max-subtracted softmax over j, out_i = sum_j alpha_ij Wh_j, elu, the
//   residual and flax's LayerNorm (var = E[x^2] - E[x]^2, eps in the
//   rsqrt). Grids: one for the input Dense and layer 0's projection, then
//   one per layer (L + 1 launches). A warp owns a destination row and all
//   four heads; a CTA of 4 warps streams the source rows in chunks of 64
//   through shared memory (Wh and e_dst), in two passes: the row max, then
//   p = exp(s - max), its sum and sum_j p Wh_j. The epilogue does elu, the
//   residual, the LayerNorm (warp reductions over the 64 features) and the
//   next layer's projection and e_src / e_dst (row-local, W in shared
//   memory). It keeps what the backward reads: each layer's input, Wh,
//   e_src, e_dst, the row max and sum per head, the attention output, the
//   normalised x and 1/std.
//
// K4b ananke_gat_backward <- _gat_bwd_impl. The VJP with respect to every
//   parameter, layers in reverse, three grids per layer and one reduction:
//   - row pass (warp per destination row i): LayerNorm, residual and elu
//     VJPs, then over all source rows j the recomputed alpha_ij and
//     g_alpha = g_out_i . Wh_j, summed per head into D_i = sum_j alpha
//     g_alpha (the softmax VJP's) and, over the edges whose score lies on
//     each side of the leaky-relu's kink, A+- = sum alpha g_alpha and B+- =
//     sum alpha. As sum_j alpha = 1 on the edges, g_e_src_i = sum_j on
//     lrelu' alpha (g_alpha - D_i) = 0.8 (A+ - D B+) = -0.8 (A- - D B-),
//     taken from the side with less weight. The row's softmax is invariant
//     to e_src_i apart from the kink, so its gradient is small against
//     D_i: a form that relies on the computed sum of alpha being 1 (A - D B
//     over all edges) carries that sum's rounding times D_i, up to 1e-4 of
//     a_src's gradient at Z = 2048; this one is exactly 0 where all the
//     edges lie on one side, as autograd's VJP through the row max is;
//   - column pass (warp per source row j, the FlashAttention-2 backward
//     pattern): over all destination rows i the same alpha and g_s, giving
//     g_Wh_j = sum_i alpha_ij g_out_i and g_e_dst_j = sum_i g_s. Both passes
//     recompute alpha = exp(s - max) / sum from the forward's saved max and
//     sum by one rule (score()), so their row and column sums agree;
//   - projection pass (CTA per 32-row tile): g_Wh += g_e_src a_src +
//     g_e_dst a_dst, g_h = g_res + g_Wh W^T, and the tile's partial sums of
//     every parameter gradient (W, a_src, a_dst, scale, bias and, at layer
//     0, Win and bin) into the tile's slab;
//   - one reduction sums the slabs in tile order. No atomics: the same
//     operands give the same bits.
//
// Everything is float32: products as FFMA on the CUDA cores, no bf16 and no
// TF32 (the LayerNorm and softmax gradients are precision-sensitive, and the
// encoder is a small share of the training step). At bench rung 2 (Z = 500,
// 2 layers) the forward is ~45 MFLOP and reads ~1 MB (the adjacency): less
// than 2 us of FP32 FFMA or memory. What bounds it on this card is launch
// latency and the serial chunk loops of a few hundred CTAs: the design
// keeps each pass one grid and the working set (at Z = 2048, 512 KB per
// (Z, 64) array) in L2, and leaves fusing the grids into one persistent
// launch to later work. The exp of every score (Z^2 per head, two or three
// times) is the next cost; each is computed once per pass and shared
// through shared memory where a row's 64 features need it.
//
// Compiled for 64 features in 4 heads of 16, 1-4 layers, 1-64 zone
// features and any zone count the caller's memory holds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // features
constexpr int NH = 4;          // heads
constexpr int DH = D / NH;     // features per head
constexpr int kMaxLayers = 4;
constexpr int kMaxF = 64;      // zone features
constexpr int kInRows = 8;     // input grid: rows (warps) per CTA
constexpr int kRows = 4;       // row / column passes: rows (warps) per CTA
constexpr int kChunk = 64;     // rows staged through shared memory at once
constexpr int kTile = 32;      // projection pass: rows per CTA (and slab)
constexpr int kProjThreads = 256;
constexpr float kNeg = -1e30f;
constexpr float kSlope = 0.2f;
constexpr float kLnEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

// the packed parameter vector: Win (F, D), bin (D), then per layer W (D, D),
// a_src (NH, DH), a_dst (NH, DH), scale (D), bias (D), each row-major
__host__ __device__ __forceinline__ long layer_off(int f, int k) {
  return (long)f * D + D + (long)k * (D * D + 4 * D);
}

struct Fwd {
  const float* zf;   // (z, f)
  const float* adj;  // (z, z)
  const float* prm;  // packed parameters
  float* H;          // (layers + 1, z, D): each layer's input; [layers] out
  float* WH;         // (layers, z, D)
  float* ST;         // (4, layers, z, NH): e_src, e_dst, row max, row sum
  float* GX;         // (2, layers, z, D): attention output, normalised x
  float* RS;         // (layers, z): 1 / std of the LayerNorm
  int z, f, layers;
};

struct Bwd {
  Fwd p;
  const float* g;  // (z, D): cotangent of the output
  float* GH;       // (layers, z, D): cotangent of each layer's input
  float* GRES;     // (z, D): the residual path's share of it
  float* GO;       // (z, D): cotangent of the attention output
  float* GV;       // (z, D): sum_i alpha_ij g_out_i
  float* DD;       // (z, NH): D_i = sum_j alpha_ij g_out_i . Wh_j
  float* GES;      // (z, NH): cotangent of e_src
  float* GED;      // (z, NH): cotangent of e_dst
  float* slab;     // (num_tiles, param size), written, not added
  float* gsum;     // (param size)
};

__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(kFull, v, 8);
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 2);
  v += __shfl_xor_sync(kFull, v, 1);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
  return sum16(v + __shfl_xor_sync(kFull, v, 16));
}

__device__ __forceinline__ float max16(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 1));
}

// the masked leaky-relu score of pre = e_src_i + e_dst_j: one rule for the
// forward and both backward passes
__device__ __forceinline__ float score(float pre, bool on) {
  const float s = pre >= 0.f ? pre : kSlope * pre;
  return on ? s : kNeg;
}

// A lane holds features `lane` (head lane / 16) and `lane + 32` (head 2 +
// lane / 16); a_src / a_dst are (NH, DH) row-major, so a feature's index is
// its offset in them. Lanes 0-15 hold heads 0 and 2, lanes 16-31 heads 1
// and 3; a 16-lane sum is a head's.
__device__ __forceinline__ float pick(const float (&v)[NH], int head) {
  return head == 0 ? v[0] : head == 1 ? v[1] : head == 2 ? v[2] : v[3];
}

// Wh = h W of one row (h in `row`, W in shared memory), its e_src and
// e_dst, written for layer k
__device__ void project_row(const Fwd& p, int k, int i, float hA, float hB,
                            float* row, const float* w_s, const float* lw,
                            int lane) {
  row[lane] = hA;
  row[lane + 32] = hB;
  __syncwarp();
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float x = row[c];
    a = fmaf(x, w_s[c * D + lane], a);
    b = fmaf(x, w_s[c * D + lane + 32], b);
  }
  __syncwarp();
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  float* wh = p.WH + k * zd + (long)i * D;
  wh[lane] = a;
  wh[lane + 32] = b;
  const float* asrc = lw + D * D;
  const float* adst = asrc + D;
  const float esA = sum16(a * asrc[lane]), esB = sum16(b * asrc[lane + 32]);
  const float edA = sum16(a * adst[lane]), edB = sum16(b * adst[lane + 32]);
  if ((lane & 15) == 0) {
    const int hA = lane >> 4, hB = 2 + hA;
    float* es = p.ST + k * zh + (long)i * NH;
    float* ed = p.ST + (p.layers + k) * zh + (long)i * NH;
    es[hA] = esA;
    es[hB] = esB;
    ed[hA] = edA;
    ed[hB] = edB;
  }
}

// ---- K4f ---------------------------------------------------------------------

// h0 = zf Win + bin, then layer 0's projection; a warp per row
__global__ void __launch_bounds__(32 * kInRows) gat_input_kernel(const Fwd p) {
  __shared__ float win_s[kMaxF * D];
  __shared__ float w_s[D * D];
  __shared__ float row_s[kInRows][D];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* lw = p.prm + layer_off(p.f, 0);
  for (int idx = tid; idx < p.f * D; idx += 32 * kInRows) win_s[idx] = p.prm[idx];
  for (int idx = tid; idx < D * D; idx += 32 * kInRows) w_s[idx] = lw[idx];
  __syncthreads();
  const int i = blockIdx.x * kInRows + warp;
  if (i >= p.z) return;
  const float* bin = p.prm + (long)p.f * D;
  float hA = 0.f, hB = 0.f;
  for (int k = 0; k < p.f; ++k) {
    const float x = p.zf[(long)i * p.f + k];
    hA = fmaf(x, win_s[k * D + lane], hA);
    hB = fmaf(x, win_s[k * D + lane + 32], hB);
  }
  hA += bin[lane];
  hB += bin[lane + 32];
  p.H[(long)i * D + lane] = hA;
  p.H[(long)i * D + lane + 32] = hB;
  project_row(p, 0, i, hA, hB, row_s[warp], w_s, lw, lane);
}

// one layer: attention, elu, residual, LayerNorm, and the next layer's
// projection; a warp per destination row
__global__ void __launch_bounds__(32 * kRows)
    gat_attn_kernel(const Fwd p, const int k) {
  __shared__ float wh_s[kChunk][D + 1];
  __shared__ float ed_s[kChunk][NH + 1];
  __shared__ float p_s[kRows][NH][kChunk + 1];
  __shared__ float wn_s[D * D];
  __shared__ float row_s[kRows][D];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = blockIdx.x * kRows + warp;
  const bool row_ok = i < p.z;
  const bool has_next = k + 1 < p.layers;
  if (has_next) {
    const float* nw = p.prm + layer_off(p.f, k + 1);
    for (int idx = tid; idx < D * D; idx += 32 * kRows) wn_s[idx] = nw[idx];
  }
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* WH = p.WH + k * zd;
  const float* ES = p.ST + k * zh;
  const float* ED = p.ST + (p.layers + k) * zh;
  float* MX = p.ST + (2 * p.layers + k) * zh;
  float* SM = p.ST + (3 * p.layers + k) * zh;
  const float* adj_row = p.adj + (long)(row_ok ? i : 0) * p.z;
  const int hA = lane >> 4, hB = 2 + hA;

  // pass 1: the row max per head, 16 lanes a head, j strided by 16
  float es[NH], m[NH];
  float mA = -INFINITY, mB = -INFINITY;
  if (row_ok) {
#pragma unroll
    for (int h = 0; h < NH; ++h) es[h] = ES[(long)i * NH + h];
    const float esA = pick(es, hA), esB = pick(es, hB);
    for (int j = lane & 15; j < p.z; j += 16) {
      const bool on = adj_row[j] > 0.f;
      mA = fmaxf(mA, score(esA + ED[(long)j * NH + hA], on));
      mB = fmaxf(mB, score(esB + ED[(long)j * NH + hB], on));
    }
    mA = max16(mA);
    mB = max16(mB);
    m[0] = __shfl_sync(kFull, mA, 0);
    m[1] = __shfl_sync(kFull, mA, 16);
    m[2] = __shfl_sync(kFull, mB, 0);
    m[3] = __shfl_sync(kFull, mB, 16);
  }

  // pass 2: p = exp(s - max) by chunks of source rows, computed once per
  // (row, head, j) into shared memory, then summed per feature
  float accA = 0.f, accB = 0.f, lA = 0.f, lB = 0.f;
  for (int j0 = 0; j0 < p.z; j0 += kChunk) {
    const int n = min(kChunk, p.z - j0);
    __syncthreads();
    for (int idx = tid; idx < kChunk * D; idx += 32 * kRows) {
      const int r = idx / D, c = idx % D;
      wh_s[r][c] = r < n ? WH[(long)(j0 + r) * D + c] : 0.f;
    }
    for (int idx = tid; idx < kChunk * NH; idx += 32 * kRows) {
      const int r = idx / NH, h = idx % NH;
      ed_s[r][h] = r < n ? ED[(long)(j0 + r) * NH + h] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = lane + 32 * half;
      const bool in = q < n;
      const bool on = in && adj_row[j0 + q] > 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        p_s[warp][h][q] = in ? expf(score(es[h] + ed_s[q][h], on) - m[h]) : 0.f;
    }
    __syncwarp();
    for (int jj = 0; jj < n; ++jj) {
      const float pa = p_s[warp][hA][jj], pb = p_s[warp][hB][jj];
      accA = fmaf(pa, wh_s[jj][lane], accA);
      accB = fmaf(pb, wh_s[jj][lane + 32], accB);
      lA += pa;
      lB += pb;
    }
    __syncwarp();
  }
  if (!row_ok) return;

  // epilogue: elu, residual, LayerNorm
  const long o = (long)i * D;
  const float gA = accA / lA, gB = accB / lB;
  float* G = p.GX + k * zd;
  float* XH = p.GX + (p.layers + k) * zd;
  G[o + lane] = gA;
  G[o + lane + 32] = gB;
  if ((lane & 15) == 0) {
    MX[(long)i * NH + hA] = mA;
    MX[(long)i * NH + hB] = mB;
    SM[(long)i * NH + hA] = lA;
    SM[(long)i * NH + hB] = lB;
  }
  const float yA = gA > 0.f ? gA : expf(fminf(gA, 0.f)) - 1.f;
  const float yB = gB > 0.f ? gB : expf(fminf(gB, 0.f)) - 1.f;
  const float* hin = p.H + k * zd + o;
  const float xA = hin[lane] + yA, xB = hin[lane + 32] + yB;
  const float mu = sum32(xA + xB) / D;
  const float var = fmaxf(sum32(xA * xA + xB * xB) / D - mu * mu, 0.f);
  const float r = 1.f / sqrtf(var + kLnEps);
  const float xhA = (xA - mu) * r, xhB = (xB - mu) * r;
  const float* sc = p.prm + layer_off(p.f, k) + D * D + 2 * D;
  const float* bi = sc + D;
  const float oA = xhA * sc[lane] + bi[lane];
  const float oB = xhB * sc[lane + 32] + bi[lane + 32];
  XH[o + lane] = xhA;
  XH[o + lane + 32] = xhB;
  if (lane == 0) p.RS[(long)k * p.z + i] = r;
  float* hout = p.H + (k + 1) * zd + o;
  hout[lane] = oA;
  hout[lane + 32] = oB;
  if (has_next)
    project_row(p, k + 1, i, oA, oB, row_s[warp], wn_s,
                p.prm + layer_off(p.f, k + 1), lane);
}

// ---- K4b ---------------------------------------------------------------------

// the cotangent of layer k's output
__device__ __forceinline__ const float* layer_gout(const Bwd& b, int k) {
  return k + 1 == b.p.layers ? b.g : b.GH + (long)(k + 1) * b.p.z * D;
}

// row pass of layer k: LayerNorm / residual / elu VJPs, D and g_e_src; a
// warp per destination row
__global__ void __launch_bounds__(32 * kRows)
    gat_bwd_row_kernel(const Bwd b, const int k) {
  __shared__ float wh_s[kChunk][D + 1];
  __shared__ float ed_s[kChunk][NH + 1];
  __shared__ float go_s[kRows][D];
  const Fwd& p = b.p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = blockIdx.x * kRows + warp;
  const bool row_ok = i < p.z;
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* WH = p.WH + k * zd;
  const float* ED = p.ST + (p.layers + k) * zh;
  const float* adj_row = p.adj + (long)(row_ok ? i : 0) * p.z;
  const int hA = lane >> 4, hB = 2 + hA;

  float es[NH], m[NH], l[NH];
  if (row_ok) {
    const long o = (long)i * D;
    const float* gout = layer_gout(b, k) + o;
    const float* xh = p.GX + (p.layers + k) * zd + o;
    const float* gat = p.GX + k * zd + o;
    const float* sc = p.prm + layer_off(p.f, k) + D * D + 2 * D;
    const float r = p.RS[(long)k * p.z + i];
    const float xhA = xh[lane], xhB = xh[lane + 32];
    const float gxhA = gout[lane] * sc[lane];
    const float gxhB = gout[lane + 32] * sc[lane + 32];
    const float m1 = sum32(gxhA + gxhB) / D;
    const float m2 = sum32(gxhA * xhA + gxhB * xhB) / D;
    const float gxA = r * (gxhA - m1 - xhA * m2);
    const float gxB = r * (gxhB - m1 - xhB * m2);
    b.GRES[o + lane] = gxA;
    b.GRES[o + lane + 32] = gxB;
    const float gA = gat[lane], gB = gat[lane + 32];
    const float goA = gA > 0.f ? gxA : gxA * expf(fminf(gA, 0.f));
    const float goB = gB > 0.f ? gxB : gxB * expf(fminf(gB, 0.f));
    b.GO[o + lane] = goA;
    b.GO[o + lane + 32] = goB;
    go_s[warp][lane] = goA;
    go_s[warp][lane + 32] = goB;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      es[h] = p.ST[k * zh + (long)i * NH + h];
      m[h] = p.ST[(2 * p.layers + k) * zh + (long)i * NH + h];
      l[h] = p.ST[(3 * p.layers + k) * zh + (long)i * NH + h];
    }
  }

  // a lane per source row of the chunk, all heads; per head D and, by side
  // of the kink, sum alpha g_alpha and sum alpha over the edges
  float sum_d[NH] = {0.f, 0.f, 0.f, 0.f};
  float ag_pos[NH] = {0.f, 0.f, 0.f, 0.f}, al_pos[NH] = {0.f, 0.f, 0.f, 0.f};
  float ag_neg[NH] = {0.f, 0.f, 0.f, 0.f}, al_neg[NH] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < p.z; j0 += kChunk) {
    const int n = min(kChunk, p.z - j0);
    __syncthreads();
    for (int idx = tid; idx < kChunk * D; idx += 32 * kRows) {
      const int r = idx / D, c = idx % D;
      wh_s[r][c] = r < n ? WH[(long)(j0 + r) * D + c] : 0.f;
    }
    for (int idx = tid; idx < kChunk * NH; idx += 32 * kRows) {
      const int r = idx / NH, h = idx % NH;
      ed_s[r][h] = r < n ? ED[(long)(j0 + r) * NH + h] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = lane + 32 * half;
      if (q >= n) continue;
      const bool on = adj_row[j0 + q] > 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float pre = es[h] + ed_s[q][h];
        const float alpha = expf(score(pre, on) - m[h]) / l[h];
        float ga = 0.f;
#pragma unroll
        for (int t = 0; t < DH; ++t)
          ga = fmaf(go_s[warp][h * DH + t], wh_s[q][h * DH + t], ga);
        const float ag = alpha * ga;
        sum_d[h] += ag;
        if (on && pre >= 0.f) {
          ag_pos[h] += ag;
          al_pos[h] += alpha;
        } else if (on) {
          ag_neg[h] += ag;
          al_neg[h] += alpha;
        }
      }
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float d = sum32(sum_d[h]);
    const float ap = sum32(ag_pos[h]), bp = sum32(al_pos[h]);
    const float an = sum32(ag_neg[h]), bn = sum32(al_neg[h]);
    if (lane == 0) {
      b.DD[(long)i * NH + h] = d;
      b.GES[(long)i * NH + h] = bp <= bn ? (1.f - kSlope) * (ap - d * bp)
                                         : -(1.f - kSlope) * (an - d * bn);
    }
  }
}

// column pass of layer k: g_Wh_j = sum_i alpha_ij g_out_i and g_e_dst; a
// warp per source row
__global__ void __launch_bounds__(32 * kRows)
    gat_bwd_col_kernel(const Bwd b, const int k) {
  __shared__ float go_s[kChunk][D + 1];
  __shared__ float st_s[kChunk][4 * NH + 1];  // e_src, max, sum, D of row i
  __shared__ float adj_s[kChunk][kRows + 1];
  __shared__ float v_s[kRows][D];
  __shared__ float al_s[kRows][NH][kChunk + 1];
  const Fwd& p = b.p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * kRows, j = j0 + warp;
  const bool col_ok = j < p.z;
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* WH = p.WH + k * zd;
  const float* ES = p.ST + k * zh;
  const float* MX = p.ST + (2 * p.layers + k) * zh;
  const float* SM = p.ST + (3 * p.layers + k) * zh;
  const int hA = lane >> 4, hB = 2 + hA;

  float ed[NH];
  if (col_ok) {
    v_s[warp][lane] = WH[(long)j * D + lane];
    v_s[warp][lane + 32] = WH[(long)j * D + lane + 32];
#pragma unroll
    for (int h = 0; h < NH; ++h)
      ed[h] = p.ST[(p.layers + k) * zh + (long)j * NH + h];
  }
  float accA = 0.f, accB = 0.f;
  float ged[NH] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < p.z; i0 += kChunk) {
    const int n = min(kChunk, p.z - i0);
    __syncthreads();
    for (int idx = tid; idx < kChunk * D; idx += 32 * kRows) {
      const int r = idx / D, c = idx % D;
      go_s[r][c] = r < n ? b.GO[(long)(i0 + r) * D + c] : 0.f;
    }
    for (int idx = tid; idx < kChunk * NH; idx += 32 * kRows) {
      const int r = idx / NH, h = idx % NH;
      const bool in = r < n;
      const long o = (long)(i0 + r) * NH + h;
      st_s[r][h] = in ? ES[o] : 0.f;
      st_s[r][NH + h] = in ? MX[o] : 0.f;
      st_s[r][2 * NH + h] = in ? SM[o] : 1.f;
      st_s[r][3 * NH + h] = in ? b.DD[o] : 0.f;
    }
    for (int idx = tid; idx < kChunk * kRows; idx += 32 * kRows) {
      const int r = idx / kRows, w = idx % kRows;
      adj_s[r][w] = (r < n && j0 + w < p.z)
                        ? p.adj[(long)(i0 + r) * p.z + j0 + w] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = lane + 32 * half;
      const bool in = q < n;
      const bool on = in && adj_s[q][warp] > 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float alpha = 0.f;
        if (in) {
          const float pre = st_s[q][h] + ed[h];
          alpha = expf(score(pre, on) - st_s[q][NH + h]) / st_s[q][2 * NH + h];
          float ga = 0.f;
#pragma unroll
          for (int t = 0; t < DH; ++t)
            ga = fmaf(go_s[q][h * DH + t], v_s[warp][h * DH + t], ga);
          const float gs = alpha * (ga - st_s[q][3 * NH + h]);
          ged[h] += on ? (pre >= 0.f ? gs : kSlope * gs) : 0.f;
        }
        al_s[warp][h][q] = alpha;
      }
    }
    __syncwarp();
    for (int ii = 0; ii < n; ++ii) {
      accA = fmaf(al_s[warp][hA][ii], go_s[ii][lane], accA);
      accB = fmaf(al_s[warp][hB][ii], go_s[ii][lane + 32], accB);
    }
    __syncwarp();
  }
  if (!col_ok) return;
  b.GV[(long)j * D + lane] = accA;
  b.GV[(long)j * D + lane + 32] = accB;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float v = sum32(ged[h]);
    if (lane == 0) b.GED[(long)j * NH + h] = v;
  }
}

// projection pass of layer k over a tile of kTile rows: g_Wh, the
// cotangent of the layer's input, and the tile's partial parameter
// gradients into its slab
__global__ void __launch_bounds__(kProjThreads)
    gat_bwd_proj_kernel(const Bwd b, const int k) {
  __shared__ float w_s[D][D + 1];
  __shared__ float h_s[kTile][D];
  __shared__ float gwh_s[kTile][D];
  __shared__ float gh_s[kTile][D];
  const Fwd& p = b.p;
  const int tid = threadIdx.x, c = tid % D, grp = tid / D;
  constexpr int kGroups = kProjThreads / D;
  const int row0 = blockIdx.x * kTile;
  const int n = min(kTile, p.z - row0);
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* lw = p.prm + layer_off(p.f, k);
  const float* asrc = lw + D * D;
  const float* adst = asrc + D;
  const float* H = p.H + k * zd;
  const float* WH = p.WH + k * zd;
  const float* XH = p.GX + (p.layers + k) * zd;
  const float* gout = layer_gout(b, k);
  const int hd = c / DH;
  for (int idx = tid; idx < D * D; idx += kProjThreads)
    w_s[idx / D][idx % D] = lw[idx];
  for (int r = grp; r < kTile; r += kGroups) {
    const long row = row0 + r, o = row * D + c;
    const bool in = r < n;
    h_s[r][c] = in ? H[o] : 0.f;
    gwh_s[r][c] = in ? b.GV[o] + b.GES[row * NH + hd] * asrc[c] +
                           b.GED[row * NH + hd] * adst[c]
                     : 0.f;
  }
  __syncthreads();
  // g_h = g_res + g_Wh W^T, row-local
  for (int r = grp; r < kTile; r += kGroups) {
    float gh = 0.f;
    if (r < n) {
      float acc = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < D; ++cc) acc = fmaf(gwh_s[r][cc], w_s[c][cc], acc);
      const long o = (long)(row0 + r) * D + c;
      gh = b.GRES[o] + acc;
      b.GH[k * zd + o] = gh;
    }
    gh_s[r][c] = gh;
  }
  __syncthreads();
  float* slab = b.slab + (long)blockIdx.x * layer_off(p.f, p.layers);
  float* ls = slab + layer_off(p.f, k);
  // g_W[in][out] = sum_r h[r][in] g_Wh[r][out]
  for (int kin = grp; kin < D; kin += kGroups) {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) acc = fmaf(h_s[r][kin], gwh_s[r][c], acc);
    ls[kin * D + c] = acc;
  }
  // the vectors: group 0 a_src, 1 a_dst, 2 scale, 3 bias
  {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) {
      const long row = row0 + r, o = row * D + c;
      if (grp == 0) acc = fmaf(b.GES[row * NH + hd], WH[o], acc);
      else if (grp == 1) acc = fmaf(b.GED[row * NH + hd], WH[o], acc);
      else if (grp == 2) acc = fmaf(gout[o], XH[o], acc);
      else acc += gout[o];
    }
    ls[D * D + grp * D + c] = acc;
  }
  if (k != 0) return;
  // h0 = zf Win + bin
  for (int fi = grp; fi < p.f; fi += kGroups) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(p.zf[(long)(row0 + r) * p.f + fi], gh_s[r][c], acc);
    slab[fi * D + c] = acc;
  }
  if (grp == 0) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) acc += gh_s[r][c];
    slab[(long)p.f * D + c] = acc;
  }
}

// gsum = the slabs summed in tile order
__global__ void gat_reduce_kernel(const float* slab, float* gsum, long size,
                                  int tiles) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += slab[t * size + idx];
  gsum[idx] = acc;
}

bool compiled_for(int z, int f, int layers, int d, int heads) {
  return z >= 1 && f >= 1 && f <= kMaxF && layers >= 1 &&
         layers <= kMaxLayers && d == D && heads == NH;
}

}  // namespace

extern "C" {

// Floats of the packed parameter vector (and of one slab).
long ananke_gat_param_size(int f, int layers) { return layer_off(f, layers); }

// Rows of one tile of the backward's projection pass (one slab each).
int ananke_gat_bwd_tile_rows() { return kTile; }

// K4f on `stream`: the encoder's forward, its output in H[layers] and the
// residuals the backward reads in H, WH, ST, GX, RS (shapes as struct Fwd).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for widths this file was not compiled for.
int ananke_gat_forward(const void* zf, const void* adj, const void* prm,
                       void* H, void* WH, void* ST, void* GX, void* RS, int z,
                       int f, int layers, int d, int heads, void* stream) {
  if (!compiled_for(z, f, layers, d, heads)) return (int)cudaErrorInvalidValue;
  Fwd p;
  p.zf = static_cast<const float*>(zf);
  p.adj = static_cast<const float*>(adj);
  p.prm = static_cast<const float*>(prm);
  p.H = static_cast<float*>(H);
  p.WH = static_cast<float*>(WH);
  p.ST = static_cast<float*>(ST);
  p.GX = static_cast<float*>(GX);
  p.RS = static_cast<float*>(RS);
  p.z = z; p.f = f; p.layers = layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gat_input_kernel<<<(z + kInRows - 1) / kInRows, 32 * kInRows, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  for (int k = 0; k < layers && err == cudaSuccess; ++k) {
    gat_attn_kernel<<<(z + kRows - 1) / kRows, 32 * kRows, 0, s>>>(p, k);
    err = cudaGetLastError();
  }
  return (int)err;
}

// K4b on `stream`: the gradient of every parameter at the output's
// cotangent g, packed as prm, into gsum, from the forward's residuals.
// GH (layers, z, D), GRES, GO, GV (z, D) each and DD, GES, GED (z, NH) each
// are scratch; slab is (num_tiles, param size), num_tiles = ceil(z / 32).
int ananke_gat_backward(const void* zf, const void* adj, const void* prm,
                        const void* H, const void* WH, const void* ST,
                        const void* GX, const void* RS, const void* g,
                        void* GH, void* scratch, void* scratch_nh, void* slab,
                        void* gsum, int z, int f, int layers, int num_tiles,
                        int d, int heads, void* stream) {
  if (!compiled_for(z, f, layers, d, heads) ||
      num_tiles != (z + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  Bwd b;
  b.p.zf = static_cast<const float*>(zf);
  b.p.adj = static_cast<const float*>(adj);
  b.p.prm = static_cast<const float*>(prm);
  // read only in the backward
  b.p.H = const_cast<float*>(static_cast<const float*>(H));
  b.p.WH = const_cast<float*>(static_cast<const float*>(WH));
  b.p.ST = const_cast<float*>(static_cast<const float*>(ST));
  b.p.GX = const_cast<float*>(static_cast<const float*>(GX));
  b.p.RS = const_cast<float*>(static_cast<const float*>(RS));
  b.p.z = z; b.p.f = f; b.p.layers = layers;
  const long zd = (long)z * D, zh = (long)z * NH;
  b.g = static_cast<const float*>(g);
  b.GH = static_cast<float*>(GH);
  b.GRES = static_cast<float*>(scratch);
  b.GO = b.GRES + zd;
  b.GV = b.GO + zd;
  b.DD = static_cast<float*>(scratch_nh);
  b.GES = b.DD + zh;
  b.GED = b.GES + zh;
  b.slab = static_cast<float*>(slab);
  b.gsum = static_cast<float*>(gsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows_grid = (z + kRows - 1) / kRows;
  cudaError_t err = cudaSuccess;
  for (int k = layers - 1; k >= 0 && err == cudaSuccess; --k) {
    gat_bwd_row_kernel<<<rows_grid, 32 * kRows, 0, s>>>(b, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gat_bwd_col_kernel<<<rows_grid, 32 * kRows, 0, s>>>(b, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gat_bwd_proj_kernel<<<num_tiles, kProjThreads, 0, s>>>(b, k);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const long size = layer_off(f, layers);
  gat_reduce_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      b.slab, b.gsum, size, num_tiles);
  return (int)cudaGetLastError();
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
