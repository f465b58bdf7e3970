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
//   rsqrt). Grids: one for the input Dense, the graph's entries and layer
//   0's projection, then one per layer (L + 1 launches), a warp a row:
//   - input grid: each row's on-graph columns as a bitmask of ceil(Z / 32)
//     words (one ballot a word of adj[i, :]; the layout of the row half of
//     K4b's lists), in RS's tail: adj is read once a call;
//   - attention grid: row i's entries in index order, 32 at a time (lane e
//     the e-th, its e_dst a float4; RowWalk). The row max per head: a row
//     of at most 32 entries (rung 2's: ~7-12 of 500) takes it over its one
//     batch by shuffles and keeps the scores in registers for the sum;
//     a longer row scans every column, 8 words' e_dst at a time, with no
//     walk. Then each batch's p = exp(s - max) goes through shared memory
//     and, entry by entry, into its sum and sum_j p Wh_j, the batch's 32
//     Wh rows loaded before their FMAs and the next batch's columns and
//     e_dst fetched before those. An off-graph term is exp(-1e30 - max) =
//     0 exactly, so the walk sums the same terms in the same order as one
//     over every column: the first design's bits. A row with no entry (all
//     words 0) has every score -1e30, max -1e30 and every p 1, and walks
//     every column. The epilogue does elu, the residual, the LayerNorm
//     (warp reductions over the 64 features) and the next layer's
//     projection and e_src / e_dst (row-local, W in shared memory, copied
//     by cp.async during the walk).
//   It keeps what the backward reads: each layer's input, Wh, e_src,
//   e_dst, the row max and sum per head, the attention output, the
//   normalised x and 1/std.
//
// K4b ananke_gat_backward <- _gat_bwd_impl. The VJP with respect to every
//   parameter, layers in reverse: one grid that lists the graph's entries,
//   three grids per layer and one reduction (3 L + 2 launches):
//   - lists: every row's on-graph columns and every column's on-graph rows
//     as bitmasks of ceil(Z / 32) words (one ballot a row of each 32 x 32
//     block of adj), and the rows with no entry. An off-graph score is
//     -1e30 and its alpha exp(-1e30 - max) an exact 0, so the passes skip
//     those terms and compute the same function; a row with no entry
//     attends uniformly to every column (every score -1e30), so it walks
//     every column and every column walks it;
//   - row pass (warp per destination row i): LayerNorm, residual and elu
//     VJPs, then over i's entries, 32 at a time (lane e the e-th, Wh_j in
//     its registers), the recomputed alpha_ij and g_alpha = g_out_i .
//     Wh_j, summed per head into D_i = sum_j alpha g_alpha (the softmax
//     VJP's) and, over the edges whose score lies on each side of the
//     leaky-relu's kink, A+- = sum alpha g_alpha and B+- = sum alpha. As
//     sum_j alpha = 1 on the edges, g_e_src_i = sum_j on lrelu' alpha
//     (g_alpha - D_i) = 0.8 (A+ - D B+) = -0.8 (A- - D B-), taken from the
//     side with less weight. The row's softmax is invariant to e_src_i
//     apart from the kink, so its gradient is small against D_i: a form
//     that relies on the computed sum of alpha being 1 (A - D B over all
//     edges) carries that sum's rounding times D_i, up to 1e-4 of a_src's
//     gradient at Z = 2048; this one is exactly 0 where all the edges lie
//     on one side, as autograd's VJP through the row max is;
//   - column pass (warp per source row j, the FlashAttention-2 backward
//     pattern): over j's entries, 32 at a time, the same alpha and g_s,
//     giving g_Wh_j = sum_i alpha_ij g_out_i (in entry order, through
//     shared memory) and g_e_dst_j = sum_i g_s. Both passes recompute alpha
//     = exp(s - max) / sum from the forward's saved max and sum by one
//     rule (score()), so their row and column sums agree;
//   - projection pass (4 CTAs per 32-row tile, 16 output columns each):
//     g_Wh += g_e_src a_src + g_e_dst a_dst, g_h = g_res + g_Wh W^T, and
//     the tile's partial sums of every parameter gradient (W, a_src,
//     a_dst, scale, bias and, at layer 0, Win and bin) into the tile's
//     slab;
//   - one reduction (reduce_slabs.cuh) sums the slabs in tile order. No
//     atomics: the same operands give the same bits.
//
// Everything is float32: products as FFMA on the CUDA cores, no bf16 and no
// TF32 (the LayerNorm and softmax gradients are precision-sensitive, and the
// encoder is a small share of the training step). At bench rung 2 (Z = 500,
// 2 layers) the forward is ~45 MFLOP over every column and reads ~1 MB (the
// adjacency): less than 2 us of FP32 FFMA or memory. What bounds both
// kernels on this card is latency: launches and the dependent loads of a
// few hundred warps. Their first designs walked all Z columns in chunks of
// 64 through shared memory, though rung 2's zone world holds ~7-12 entries
// a row of 500 (H100 probes, PERF.md); both now walk the entries alone,
// each warp's gathers a round trip or two. K4b's projection pass
// register-blocks its products (each shared-memory load feeds 4 or more
// FMAs) and loads every row's operand before it sums them, on four CTAs a
// tile. On a dense graph the lists are full length and both kernels do the
// first designs' work, their sums in the same order: the same bits.
//
// Compiled for 64 features in 4 heads of 16, 1-4 layers, 1-64 zone
// features and any zone count the caller's memory holds.

#include <cuda_runtime.h>
#include <math.h>

#include "reduce_slabs.cuh"

namespace {

constexpr int D = 64;          // features
constexpr int NH = 4;          // heads
constexpr int DH = D / NH;     // features per head
constexpr int kMaxLayers = 4;
constexpr int kMaxF = 64;      // zone features
constexpr int kInRows = 8;     // input grid: rows (warps) per CTA
constexpr int kRows = 4;       // row / column passes: rows (warps) per CTA
constexpr int kScan = 8;       // attention grid: words of e_dst in flight
constexpr int kTile = 32;      // projection pass: rows a tile (and slab)
constexpr int kProjParts = 4;  // projection pass: CTAs a tile
constexpr int kPartCols = D / kProjParts;  // output columns a CTA
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
  // row i's on-graph columns as a bitmask of `words` = ceil(z / 32) words
  // (z, words), the layout of the row half of Bwd::lists; in RS's tail
  unsigned* rows;
  int z, f, layers, words;
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
  // the graph's entries as bitmasks of `words` = ceil(z / 32) words: each
  // row's on-graph columns (z, words), each column's on-graph rows (z,
  // words), then the rows with no entry (words)
  unsigned* lists;
  int words;
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

// the bits of word w of a list over z indices that stand for an index
__device__ __forceinline__ unsigned valid_bits(int z, int w) {
  const int n = z - 32 * w;
  return n >= 32 ? kFull : (1u << n) - 1u;
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

__device__ __forceinline__ float pick(const float4& v, int head) {
  return head == 0 ? v.x : head == 1 ? v.y : head == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// x = the N floats at p (16-byte aligned), as N / 4 loads all in flight
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&x)[N]) {
#pragma unroll
  for (int c = 0; c < N; c += 4) {
    const float4 v = ldg4(p + c);
    x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
  }
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

// 16 bytes global -> shared, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// n floats (a multiple of 4, both ends 16-byte aligned) into shared memory
// by the CTA's nthreads threads, as one committed group of cp.async
__device__ __forceinline__ void copy_to_shared(float* dst, const float* src,
                                               int n, int nthreads) {
  for (int idx = 4 * threadIdx.x; idx < n; idx += 4 * nthreads)
    cp_async16(dst + idx, src + idx);
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy_to_shared of the thread landed; a block barrier then makes
// the CTA's visible to all its threads
__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The entries of up to 32 words of a list, lane L holding word L (0 past
// the list), in index order: entry t is bit entry_bit(t) of word
// entry_word(t).
struct Walk {
  unsigned word;
  int before;  // entries in the words below the lane's
  int total;   // entries in all 32 words
  __device__ __forceinline__ explicit Walk(unsigned w) : word(w) {
    const int lane = threadIdx.x & 31;
    int incl = __popc(w);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    before = incl - __popc(w);
    total = __shfl_sync(kFull, incl, 31);
  }
  // the word holding entry t (t < total): the last lane whose words below
  // hold at most t entries; every lane of the warp calls it
  __device__ __forceinline__ int entry_word(int t) const {
    int w = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kFull, before, w + step) <= t) w += step;
    return w;
  }
  // entry t's bit in word m of the walk, given m's words below: the bit
  // with rank t - below among m's set bits
  __device__ __forceinline__ static int entry_bit(unsigned m, int rank) {
    int bit = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__popc(m & ((1u << (bit + step)) - 1u)) <= rank) bit += step;
    return bit;
  }
  // the column of entry t of this walk over words w0.. (every lane calls
  // it; t < total)
  __device__ __forceinline__ int column(int w0, int t) const {
    const int ew = entry_word(t);
    return (w0 + ew) * 32 +
           entry_bit(__shfl_sync(kFull, word, ew),
                     t - __shfl_sync(kFull, before, ew));
  }
};

// ---- K4f ---------------------------------------------------------------------

// h0 = zf Win + bin, row i's list of on-graph columns, then layer 0's
// projection; a warp per row. Win and W come by cp.async while the warp
// builds its row's list.
__global__ void __launch_bounds__(32 * kInRows) gat_input_kernel(const Fwd p) {
  __shared__ __align__(16) float win_s[kMaxF * D];
  __shared__ __align__(16) float w_s[D * D];
  __shared__ float row_s[kInRows][D];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* lw = p.prm + layer_off(p.f, 0);
  copy_to_shared(win_s, p.prm, p.f * D, 32 * kInRows);
  copy_to_shared(w_s, lw, D * D, 32 * kInRows);
  const int i = blockIdx.x * kInRows + warp;
  const bool row_ok = i < p.z;  // warp-uniform
  if (row_ok) {
    // the list: one ballot a word of 32 columns, 8 words' loads at once;
    // lane L keeps word w0 + L
    const float* adj_row = p.adj + (long)i * p.z;
    unsigned* list = p.rows + (long)i * p.words;
    for (int w0 = 0; w0 < p.words; w0 += 32) {
      const int nw = min(32, p.words - w0);
      unsigned mine = 0u;
      for (int w = 0; w < nw; w += 8) {
        float a[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = (w0 + w + u) * 32 + lane;
          a[u] = j < p.z ? adj_row[j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const unsigned m = __ballot_sync(kFull, a[u] > 0.f);
          if (lane == w + u) mine = m;
        }
      }
      if (lane < nw) list[w0 + lane] = mine;
    }
  }
  copies_landed();
  __syncthreads();
  if (!row_ok) return;
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

// A cursor over row i's entries in index order, 32 at a time: batch() is
// the number n of the batch's entries, and column() the column of entry
// t0 + lane (lanes past n: the batch's last entry). A row with no entry
// walks every column. Every lane of the warp calls each member.
struct RowWalk {
  const unsigned* list;
  int words, z;
  bool on;
  int w0 = 0, t0 = 0;  // the walk's first word and the batch's first entry
  Walk walk;
  __device__ __forceinline__ RowWalk(const Fwd& p, const unsigned* l,
                                     unsigned first, bool o)
      : list(l), words(p.words), z(p.z), on(o), walk(group(0, first)) {
    skip_empty();
  }
  // lane L's word of the group of 32 words from w (first: the group at 0)
  __device__ __forceinline__ unsigned group(int w, unsigned first) const {
    const int wl = w + (threadIdx.x & 31);
    return wl >= words ? 0u
           : !on       ? valid_bits(z, wl)
           : w == 0    ? first
                       : list[wl];
  }
  __device__ __forceinline__ void skip_empty() {
    while (walk.total == 0 && w0 + 32 < words) {
      w0 += 32;
      walk = Walk(group(w0, 0u));
    }
  }
  __device__ __forceinline__ int batch() const {
    return max(0, min(32, walk.total - t0));
  }
  __device__ __forceinline__ int column() const {
    return walk.column(w0, min(t0 + (int)(threadIdx.x & 31), walk.total - 1));
  }
  __device__ __forceinline__ void advance() {
    t0 += 32;
    if (t0 < walk.total || w0 + 32 >= words) return;
    w0 += 32;
    t0 = 0;
    walk = Walk(group(w0, 0u));
    skip_empty();
  }
};

// one layer: attention over row i's entries, elu, residual, LayerNorm, and
// the next layer's projection; a warp per destination row. An off-graph
// score is -1e30 and its p = exp(-1e30 - max) an exact 0, so a walk over
// the entries alone sums the same terms in the same order as one over
// every column; a row with no entry has every score -1e30, max -1e30 and
// every p 1, and walks every column.
__global__ void __launch_bounds__(32 * kRows)
    gat_attn_kernel(const Fwd p, const int k) {
  __shared__ __align__(16) float wn_s[D * D];
  __shared__ float row_s[kRows][D];
  __shared__ float p_s[kRows][NH][33];  // a batch's weights by head
  __shared__ int j_s[kRows][32];        // a batch's columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = blockIdx.x * kRows + warp;
  const bool row_ok = i < p.z;  // warp-uniform
  const bool has_next = k + 1 < p.layers;
  if (has_next)  // the next layer's W lands while the walk runs
    copy_to_shared(wn_s, p.prm + layer_off(p.f, k + 1), D * D, 32 * kRows);
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const int hA = lane >> 4, hB = 2 + hA;
  float oA = 0.f, oB = 0.f;
  if (row_ok) {
    const float* WH = p.WH + k * zd;
    const float* ED = p.ST + (p.layers + k) * zh;
    const unsigned* list = p.rows + (long)i * p.words;
    const unsigned first = lane < p.words ? list[lane] : 0u;
    const long o = (long)i * D;
    // the epilogue's operands, loaded before the walk
    const float* hin = p.H + k * zd + o;
    const float inA = hin[lane], inB = hin[lane + 32];
    const float* sc = p.prm + layer_off(p.f, k) + D * D + 2 * D;
    const float* bi = sc + D;
    const float scA = sc[lane], scB = sc[lane + 32];
    const float biA = bi[lane], biB = bi[lane + 32];
    const float4 es4 = ldg4(p.ST + k * zh + (long)i * NH);
    const float es[NH] = {es4.x, es4.y, es4.z, es4.w};
    // a row whose words are all 0 has no entry
    unsigned any = first;
    for (int w = 32 + lane; w < p.words; w += 32) any |= list[w];
    const bool on = __any_sync(kFull, any != 0u);
    const int count = __reduce_add_sync(kFull, __popc(first));
    // one batch (rung 2's rows): its scores stay in registers from the max
    // to the sum
    const bool one = on && p.words <= 32 && count <= 32;
    const auto scores = [&](const float4& ed, float (&s)[NH]) {
#pragma unroll
      for (int h = 0; h < NH; ++h) s[h] = score(es[h] + pick(ed, h), on);
    };

    // the row max per head (-1e30 for a row with no entry): over the one
    // batch's entries, or else over every column in turn, lane L column
    // 32 c + L of word c, kScan words' e_dst loaded at once
    float m[NH], s1[NH];
    int j1 = 0;
#pragma unroll
    for (int h = 0; h < NH; ++h) m[h] = on ? -INFINITY : kNeg;
    if (one) {
      const RowWalk rw(p, list, first, on);
      j1 = rw.column();
      scores(ldg4(ED + (long)j1 * NH), s1);
#pragma unroll
      for (int h = 0; h < NH; ++h) m[h] = lane < count ? s1[h] : -INFINITY;
    } else if (on) {
      for (int c0 = 0; c0 < p.words; c0 += kScan) {
        unsigned wd[kScan];
        float4 ed[kScan];
#pragma unroll
        for (int u = 0; u < kScan; ++u) {
          const int c = min(c0 + u, p.words - 1), j = 32 * c + lane;
          wd[u] = c0 + u < p.words ? list[c] : 0u;
          ed[u] = ldg4(ED + (long)min(j, p.z - 1) * NH);
        }
#pragma unroll
        for (int u = 0; u < kScan; ++u) {
          float s[NH];
          scores(ed[u], s);
          if ((wd[u] >> lane) & 1u) {
#pragma unroll
            for (int h = 0; h < NH; ++h) m[h] = fmaxf(m[h], s[h]);
          }
        }
      }
    }
    if (on) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
        m[h] = max16(fmaxf(m[h], __shfl_xor_sync(kFull, m[h], 16)));
    }

    // p = exp(s - max) of a batch's entries into shared memory, then in
    // entry order their sum and sum_j p Wh_j per feature, the batch's Wh
    // rows all loaded before the FMAs; the next batch's columns and e_dst
    // are fetched in between
    float accA = 0.f, accB = 0.f, lA = 0.f, lB = 0.f;
    const auto stage = [&](int n, int j, const float (&s)[NH]) {
      if (lane < n) {
#pragma unroll
        for (int h = 0; h < NH; ++h) p_s[warp][h][lane] = expf(s[h] - m[h]);
        j_s[warp][lane] = j;
      }
      __syncwarp();
    };
    const auto sum = [&](int n) {
      // every lane loads 32 rows, the last entry's again past n: loads
      // under a predicate cost registers and spills (H100, PERF.md)
      float va[32], vb[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float* wh = WH + (long)j_s[warp][min(e, n - 1)] * D;
        va[e] = wh[lane];
        vb[e] = wh[lane + 32];
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e < n) {
          const float pa = p_s[warp][hA][e], pb = p_s[warp][hB][e];
          accA = fmaf(pa, va[e], accA);
          accB = fmaf(pb, vb[e], accB);
          lA += pa;
          lB += pb;
        }
      }
      __syncwarp();
    };
    if (one) {
      stage(count, j1, s1);
      sum(count);
    } else {
      RowWalk rw(p, list, first, on);
      int j = rw.column();
      float4 ed = ldg4(ED + (long)j * NH);
      for (int n = rw.batch(); n > 0; n = rw.batch()) {
        float s[NH];
        scores(ed, s);
        stage(n, j, s);
        rw.advance();
        j = rw.column();
        ed = ldg4(ED + (long)j * NH);
        sum(n);
      }
    }

    // epilogue: elu, residual, LayerNorm
    const float mA = hA == 0 ? m[0] : m[1], mB = hA == 0 ? m[2] : m[3];
    const float gA = accA / lA, gB = accB / lB;
    float* G = p.GX + k * zd;
    float* XH = p.GX + (p.layers + k) * zd;
    G[o + lane] = gA;
    G[o + lane + 32] = gB;
    if ((lane & 15) == 0) {
      float* MX = p.ST + (2 * p.layers + k) * zh;
      float* SM = p.ST + (3 * p.layers + k) * zh;
      MX[(long)i * NH + hA] = mA;
      MX[(long)i * NH + hB] = mB;
      SM[(long)i * NH + hA] = lA;
      SM[(long)i * NH + hB] = lB;
    }
    const float yA = gA > 0.f ? gA : expf(fminf(gA, 0.f)) - 1.f;
    const float yB = gB > 0.f ? gB : expf(fminf(gB, 0.f)) - 1.f;
    const float xA = inA + yA, xB = inB + yB;
    const float mu = sum32(xA + xB) / D;
    const float var = fmaxf(sum32(xA * xA + xB * xB) / D - mu * mu, 0.f);
    const float r = 1.f / sqrtf(var + kLnEps);
    const float xhA = (xA - mu) * r, xhB = (xB - mu) * r;
    oA = xhA * scA + biA;
    oB = xhB * scB + biB;
    XH[o + lane] = xhA;
    XH[o + lane + 32] = xhB;
    if (lane == 0) p.RS[(long)k * p.z + i] = r;
    float* hout = p.H + (k + 1) * zd + o;
    hout[lane] = oA;
    hout[lane + 32] = oB;
  }
  if (!has_next) return;  // block-uniform
  copies_landed();
  __syncthreads();
  if (row_ok)
    project_row(p, k + 1, i, oA, oB, row_s[warp], wn_s,
                p.prm + layer_off(p.f, k + 1), lane);
}

// ---- K4b: the graph's entries -----------------------------------------------

constexpr int kListWarps = 16;  // list kernel: 32 x 32 blocks (warps) a CTA

// K4b's lists from adj (> 0: on the graph): a CTA per strip of 32 rows, a
// warp per 32 x 32 block of it at a time, one ballot a row of the block:
// lane r keeps row i0 + r's word of the block, lane c builds column j0 +
// c's word of the strip. The strip's rows without an entry: the warps'
// words ORed through shared memory.
__global__ void __launch_bounds__(32 * kListWarps)
    gat_bwd_lists_kernel(const Bwd b) {
  __shared__ unsigned filled[kListWarps];
  const int z = b.p.z, nw = b.words;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int strip = blockIdx.x, i0 = strip * 32;
  unsigned* rows = b.lists;
  unsigned* cols = rows + (long)z * nw;
  bool some = false;  // lane r: row i0 + r has an entry in this warp's blocks
  for (int cb = warp; cb < nw; cb += kListWarps) {
    const int j = cb * 32 + lane;
    float a[32];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      a[r] = i0 + r < z && j < z ? b.p.adj[(long)(i0 + r) * z + j] : 0.f;
    unsigned mine = 0, col = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const unsigned m = __ballot_sync(kFull, a[r] > 0.f);
      if (lane == r) mine = m;
      col |= ((m >> lane) & 1u) << r;
    }
    if (i0 + lane < z) rows[(long)(i0 + lane) * nw + cb] = mine;
    if (j < z) cols[(long)j * nw + strip] = col;
    some |= mine != 0;
  }
  const unsigned has = __ballot_sync(kFull, some);
  if (lane == 0) filled[warp] = has;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned f = 0;
    for (int w = 0; w < kListWarps; ++w) f |= filled[w];
    cols[(long)z * nw + strip] = ~f & valid_bits(z, strip);
  }
}

// ---- K4b: the passes --------------------------------------------------------

// the cotangent of layer k's output
__device__ __forceinline__ const float* layer_gout(const Bwd& b, int k) {
  return k + 1 == b.p.layers ? b.g : b.GH + (long)(k + 1) * b.p.z * D;
}

// row pass of layer k: LayerNorm / residual / elu VJPs, D and g_e_src; a
// warp per destination row i, over i's on-graph columns (every column for
// a row with none) in index order, 32 at a time: lane e the e-th
__global__ void __launch_bounds__(32 * kRows)
    gat_bwd_row_kernel(const Bwd b, const int k) {
  __shared__ float go_s[kRows][D];
  const Fwd& p = b.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kRows + warp;
  if (i >= p.z) return;  // warp-uniform; no block barrier below
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* WH = p.WH + k * zd;
  const float* ED = p.ST + (p.layers + k) * zh;
  const int hA = lane >> 4, hB = 2 + hA;
  // the row's list (its first 32 words loaded now, before any store)
  const unsigned* list = b.lists + (long)i * b.words;
  const bool lonely =
      (b.lists[2L * p.z * b.words + (i >> 5)] >> (i & 31)) & 1u;
  const unsigned first = lane < b.words ? list[lane] : 0u;

  float es[NH], m[NH], l[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    es[h] = p.ST[k * zh + (long)i * NH + h];
    m[h] = p.ST[(2 * p.layers + k) * zh + (long)i * NH + h];
    l[h] = p.ST[(3 * p.layers + k) * zh + (long)i * NH + h];
  }
  {
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
    __syncwarp();
  }

  // per head D and, by side of the kink, sum alpha g_alpha and sum alpha
  // over the edges; a row with no entry walks every column, all off
  const bool on = !lonely;
  float sum_d[NH] = {0.f, 0.f, 0.f, 0.f};
  float ag_pos[NH] = {0.f, 0.f, 0.f, 0.f}, al_pos[NH] = {0.f, 0.f, 0.f, 0.f};
  float ag_neg[NH] = {0.f, 0.f, 0.f, 0.f}, al_neg[NH] = {0.f, 0.f, 0.f, 0.f};
  for (int w0 = 0; w0 < b.words; w0 += 32) {
    const int w = w0 + lane;
    const Walk walk(w >= b.words ? 0u
                    : lonely    ? valid_bits(p.z, w)
                    : w0 == 0   ? first
                                : list[w]);
    for (int t0 = 0; t0 < walk.total; t0 += 32) {
      const int n = min(32, walk.total - t0);
      const int t = min(t0 + lane, walk.total - 1);
      const int ew = walk.entry_word(t);
      const int j = (w0 + ew) * 32 +
                    Walk::entry_bit(__shfl_sync(kFull, walk.word, ew),
                                    t - __shfl_sync(kFull, walk.before, ew));
      float wh[D];
      load_floats<D>(WH + (long)j * D, wh);
      const float4 ed = ldg4(ED + (long)j * NH);
      if (lane < n) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float pre = es[h] + pick(ed, h);
          const float alpha = expf(score(pre, on) - m[h]) / l[h];
          float ga = 0.f;
#pragma unroll
          for (int u = 0; u < DH; ++u)
            ga = fmaf(go_s[warp][h * DH + u], wh[h * DH + u], ga);
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
  }
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
// warp per source row j, over the rows i with j on the graph and the rows
// with no entry (which attend to every column), in index order, 32 at a
// time
__global__ void __launch_bounds__(32 * kRows)
    gat_bwd_col_kernel(const Bwd b, const int k) {
  __shared__ float go_s[kRows][32][D + 1];
  __shared__ float al_s[kRows][NH][32 + 1];
  __shared__ float v_s[kRows][D];
  const Fwd& p = b.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * kRows + warp;
  if (j >= p.z) return;  // warp-uniform; no block barrier below
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* WH = p.WH + k * zd;
  const float* ES = p.ST + k * zh;
  const float* MX = p.ST + (2 * p.layers + k) * zh;
  const float* SM = p.ST + (3 * p.layers + k) * zh;
  const int hA = lane >> 4, hB = 2 + hA;

  float ed[NH];
  v_s[warp][lane] = WH[(long)j * D + lane];
  v_s[warp][lane + 32] = WH[(long)j * D + lane + 32];
  __syncwarp();
#pragma unroll
  for (int h = 0; h < NH; ++h)
    ed[h] = p.ST[(p.layers + k) * zh + (long)j * NH + h];
  const unsigned* list = b.lists + ((long)p.z + j) * b.words;
  const unsigned* lonely = b.lists + 2L * p.z * b.words;
  float accA = 0.f, accB = 0.f;
  float ged[NH] = {0.f, 0.f, 0.f, 0.f};
  for (int w0 = 0; w0 < b.words; w0 += 32) {
    const int w = w0 + lane;
    const unsigned ons = w < b.words ? list[w] : 0u;
    const Walk walk(w < b.words ? ons | lonely[w] : 0u);
    for (int t0 = 0; t0 < walk.total; t0 += 32) {
      const int n = min(32, walk.total - t0);
      const int t = min(t0 + lane, walk.total - 1);
      const int ew = walk.entry_word(t);
      const int bit =
          Walk::entry_bit(__shfl_sync(kFull, walk.word, ew),
                          t - __shfl_sync(kFull, walk.before, ew));
      const int i = (w0 + ew) * 32 + bit;
      const bool on = (__shfl_sync(kFull, ons, ew) >> bit) & 1u;
      float go[D];
      load_floats<D>(b.GO + (long)i * D, go);
      const long o = (long)i * NH;
      const float4 se = ldg4(ES + o), mx = ldg4(MX + o), sm = ldg4(SM + o),
                   dd = ldg4(b.DD + o);
#pragma unroll
      for (int c = 0; c < D; ++c) go_s[warp][lane][c] = go[c];
      if (lane < n) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float pre = pick(se, h) + ed[h];
          const float alpha =
              expf(score(pre, on) - pick(mx, h)) / pick(sm, h);
          float ga = 0.f;
#pragma unroll
          for (int u = 0; u < DH; ++u)
            ga = fmaf(go[h * DH + u], v_s[warp][h * DH + u], ga);
          const float gs = alpha * (ga - pick(dd, h));
          ged[h] += on ? (pre >= 0.f ? gs : kSlope * gs) : 0.f;
          al_s[warp][h][lane] = alpha;
        }
      }
      __syncwarp();
      for (int e = 0; e < n; ++e) {
        accA = fmaf(al_s[warp][hA][e], go_s[warp][e][lane], accA);
        accB = fmaf(al_s[warp][hB][e], go_s[warp][e][lane + 32], accB);
      }
      __syncwarp();
    }
  }
  b.GV[(long)j * D + lane] = accA;
  b.GV[(long)j * D + lane + 32] = accB;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float v = sum32(ged[h]);
    if (lane == 0) b.GED[(long)j * NH + h] = v;
  }
}

// projection pass of layer k over a tile of kTile rows, one CTA for each
// kPartCols of its D output columns: g_Wh, the cotangent of the layer's
// input, and the tile's partial parameter gradients into its slab (each
// CTA of the tile writes its own columns)
__global__ void __launch_bounds__(kProjThreads)
    gat_bwd_proj_kernel(const Bwd b, const int k) {
  __shared__ float w_s[kPartCols][D + 1];  // W's rows of the part's inputs
  __shared__ __align__(16) float h_s[kTile][D];
  __shared__ __align__(16) float gwh_s[kTile][D];
  __shared__ float gh_s[kTile][kPartCols];
  const Fwd& p = b.p;
  constexpr int kGroups = kProjThreads / kPartCols;
  constexpr int kRowsPer = kTile / kGroups;  // rows of g_h a thread
  constexpr int kInPer = D / kGroups;        // rows of g_W a thread
  const int tid = threadIdx.x, cl = tid % kPartCols, grp = tid / kPartCols;
  const int part = blockIdx.x % kProjParts;
  const int c = part * kPartCols + cl;
  const int row0 = blockIdx.x / kProjParts * kTile;
  const int n = min(kTile, p.z - row0);
  const long zd = (long)p.z * D, zh = (long)p.z * NH;
  const float* lw = p.prm + layer_off(p.f, k);
  const float* asrc = lw + D * D;
  const float* adst = asrc + D;
  const float* H = p.H + k * zd;
  const float* WH = p.WH + k * zd;
  const float* XH = p.GX + (p.layers + k) * zd;
  const float* gout = layer_gout(b, k);
  // the operands no shared-memory step feeds, loaded first: the vectors'
  // (groups 0-3), Win's (layer 0, the thread's first zone feature) and
  // g_res
  const int hd = c / DH;
  float x[kTile], y[kTile], zx[kTile], gres[kRowsPer];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const long row = row0 + r, o = row * D + c;
    const bool in = r < n && grp < 4;
    x[r] = !in ? 0.f : grp == 0 ? b.GES[row * NH + hd]
                     : grp == 1 ? b.GED[row * NH + hd] : gout[o];
    y[r] = !in || grp == 3 ? 0.f : grp < 2 ? WH[o] : XH[o];
    zx[r] = r < n && k == 0 && grp < p.f ? p.zf[row * p.f + grp] : 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPer; ++rr) {
    const int r = grp * kRowsPer + rr;
    gres[rr] = r < n ? b.GRES[(long)(row0 + r) * D + c] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kPartCols * D / kProjThreads; ++q) {
    const int idx = tid + q * kProjThreads;
    w_s[idx / D][idx % D] = lw[(long)(part * kPartCols) * D + idx];
  }
#pragma unroll
  for (int q = 0; q < kTile * D / kProjThreads; ++q) {
    const int idx = tid + q * kProjThreads, r = idx / D, cc = idx % D;
    const long row = row0 + r, o = row * D + cc;
    const int hc = cc / DH;
    const bool in = r < n;
    h_s[r][cc] = in ? H[o] : 0.f;
    gwh_s[r][cc] = in ? b.GV[o] + b.GES[row * NH + hc] * asrc[cc] +
                            b.GED[row * NH + hc] * adst[cc]
                      : 0.f;
  }
  __syncthreads();
  // g_h = g_res + g_Wh W^T, row-local: the thread's kRowsPer rows of
  // column c, each a sum over cc in order
  {
    float acc[kRowsPer];
#pragma unroll
    for (int rr = 0; rr < kRowsPer; ++rr) acc[rr] = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < D; cc += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = w_s[cl][cc + q];
#pragma unroll
      for (int rr = 0; rr < kRowsPer; ++rr) {
        const float4 g =
            *reinterpret_cast<const float4*>(&gwh_s[grp * kRowsPer + rr][cc]);
        acc[rr] = fmaf(g.x, w[0], acc[rr]);
        acc[rr] = fmaf(g.y, w[1], acc[rr]);
        acc[rr] = fmaf(g.z, w[2], acc[rr]);
        acc[rr] = fmaf(g.w, w[3], acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPer; ++rr) {
      const int r = grp * kRowsPer + rr;
      float gh = 0.f;
      if (r < n) {
        gh = gres[rr] + acc[rr];
        b.GH[k * zd + (long)(row0 + r) * D + c] = gh;
      }
      gh_s[r][cl] = gh;
    }
  }
  __syncthreads();
  float* slab = b.slab + (long)(blockIdx.x / kProjParts) *
                              layer_off(p.f, p.layers);
  float* ls = slab + layer_off(p.f, k);
  // g_W[in][out] = sum_r h[r][in] g_Wh[r][out]: the thread's kInPer inputs
  // of output c, each a sum over the tile's rows in order
  {
    float acc[kInPer];
#pragma unroll
    for (int q = 0; q < kInPer; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float g = gwh_s[r][c];
#pragma unroll
      for (int q = 0; q < kInPer; q += 4) {
        const float4 h =
            *reinterpret_cast<const float4*>(&h_s[r][grp * kInPer + q]);
        acc[q] = fmaf(h.x, g, acc[q]);
        acc[q + 1] = fmaf(h.y, g, acc[q + 1]);
        acc[q + 2] = fmaf(h.z, g, acc[q + 2]);
        acc[q + 3] = fmaf(h.w, g, acc[q + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < kInPer; ++q) ls[(grp * kInPer + q) * D + c] = acc[q];
  }
  // the vectors, groups 0-3: a_src, a_dst, scale, bias, summed in row
  // order
  if (grp < 4) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      if (r >= n) break;
      acc = grp == 3 ? acc + x[r] : fmaf(x[r], y[r], acc);
    }
    ls[D * D + grp * D + c] = acc;
  }
  if (k != 0) return;
  // h0 = zf Win + bin
  for (int fi = grp; fi < p.f; fi += kGroups) {
    if (fi != grp) {
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        zx[r] = r < n ? p.zf[(long)(row0 + r) * p.f + fi] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      if (r >= n) break;
      acc = fmaf(zx[r], gh_s[r][cl], acc);
    }
    slab[fi * D + c] = acc;
  }
  if (grp == 0) {
    float acc = 0.f;
    for (int r = 0; r < n; ++r) acc += gh_s[r][cl];
    slab[(long)p.f * D + c] = acc;
  }
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
// residuals the backward reads in H, WH, ST, GX, RS (shapes as struct Fwd;
// RS holds layers * z floats, then the lists of the graph's entries, z *
// ceil(z / 32) words).
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
  p.rows = reinterpret_cast<unsigned*>(p.RS + (long)layers * z);
  p.words = (z + 31) / 32;
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
// GH (layers, z, D), GRES, GO, GV (z, D) each are scratch, and so is
// scratch_nh: DD, GES, GED (z, NH) each, then the lists (2 z w + w words,
// w = ceil(z / 32)); slab is (num_tiles, param size), num_tiles =
// ceil(z / 32).
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
  b.lists = reinterpret_cast<unsigned*>(b.GED + zh);
  b.words = (z + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows_grid = (z + kRows - 1) / kRows;
  gat_bwd_lists_kernel<<<b.words, 32 * kListWarps, 0, s>>>(b);
  cudaError_t err = cudaGetLastError();
  for (int k = layers - 1; k >= 0 && err == cudaSuccess; --k) {
    gat_bwd_row_kernel<<<rows_grid, 32 * kRows, 0, s>>>(b, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gat_bwd_col_kernel<<<rows_grid, 32 * kRows, 0, s>>>(b, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gat_bwd_proj_kernel<<<num_tiles * kProjParts, kProjThreads, 0, s>>>(b,
                                                                         k);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  return ananke::launch_reduce_slabs(b.slab, b.gsum, layer_off(f, layers),
                                     num_tiles, s);
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
