// Sparse edge-list GAT aggregation on Hopper (sm_90a): one kernel pair over
// a CSR layout of the zone graph, replacing four Pallas TPU kernels of
// ananke_abm_tpu/ops/pallas/. Plain PyTorch versions:
// ananke_abm_tpu_torch/ops/cuda/edge_segment.py::gat_edge_csr_{forward,
// backward}_reference.
//
// ananke_edge_csr_forward <- edge_segment.py gat_edge_aggregate_pallas (K9a,
//   one head), gat_edge_aggregate_multihead_pallas (K9b, all heads) and
//   edge_gather.py gat_edge_aggregate_gather_pallas (K9d, the large-Z
//   block-pair form): one function. A warp owns a destination row i and all
//   H * d features (lane l holds features l, l + 32, ...; feature f belongs
//   to head f / d). Over i's in-edges (row_ptr[i] .. row_ptr[i + 1], sources
//   in src[]) it scores s = lrelu(e_recv[i, h] + e_send[j, h], 0.2), takes
//   the exact per-destination max m in a first pass and, in a second,
//   p = exp(s - m), its sum and sum_j p Wh[j]. It writes out[i] =
//   sum_j p Wh[j] / max(sum_j p, 1e-12) and lse[i, h] = m + log(sum_j p)
//   (0 for a row with no edge, whose output is 0).
//
// ananke_edge_csr_backward <- edge_segment.py
//   gat_edge_backward_multihead_pallas (K9c) and K9d's VJP. With corr[i, h]
//   = <g_i, out_i> per head (computed by the caller, the telescoped softmax
//   correction), every edge (j -> i) recomputes alpha = exp(lrelu(s) -
//   lse[i]) and ds = alpha (<g_i, Wh_j> - corr_i) lrelu'(s) from the node
//   tables. One launch, two block roles: the first blocks walk destination
//   rows (CSR) and sum d_recv[i] = sum_j ds; the others walk source rows in
//   the source-major order of the same edges (col_ptr, dst_by_src) and sum
//   d_wh[j] = sum_i alpha g_i and d_send[j] = sum_i ds. Each sum runs in one
//   warp in edge order: no atomics, so the same operands give the same bits.
//
// Everything is float32 (features, scores, sums); no bf16 and no tensor
// cores. The TPU kernels' one-hot-matmul gathers, hi/lo bf16 score pairs and
// Cuthill-McKee chunking exist because Mosaic cannot gather rows; here a
// lane loads its features of row j directly. What bounds the pair on this
// card is memory: per edge a 4 H d-byte row of Wh (forward, and the
// destination role) or of g (the source role) and a few scalars, against 2-5
// FLOP per byte. At the sparse world (Z = 32,768, E = 264,678, H d = 64) the
// node tables are 8.4 MB each and stay in the 50 MB L2, so the gathers hit
// L2; the design keeps each row's state in registers, reads every table
// once per edge and writes every output once. The in-edge loops are short
// (degree 7-15) and serial in their loads; deeper unrolling or a row per
// half-warp are later work.
//
// Compiled for H * d <= 256 features, heads of any width d.
//
// ananke_segment_sum <- edge_segment.py segment_sum_pallas (K9e): (E, D)
//   float32 values, each rounded to bf16, summed in float32 into
//   (num_segments, D) by unsorted int32 ids; ids outside [0, num_segments)
//   are dropped, an empty segment is 0. What bounds it is memory: every
//   value and id is read once, ~1 FLOP per 4 bytes. Its rows are skewed (at
//   bench rung 1, 1,048,576 persons fall in 64 zones, ~16,000 a zone), so
//   the work is split by rows, not by segments: a grid of chunks x zone
//   slices. A CTA of 8 warps owns a contiguous chunk of rows; each warp a
//   contiguous part of it, walked in order, lane l adding column l (+ 32,
//   ...) of each row whose id falls in the CTA's zone slice into the warp's
//   own (slice, D) float32 table in shared memory; 16 rows' loads are in
//   flight at a time. The warps' tables are summed in warp order into the
//   chunk's partial sums in device memory, and a second kernel sums the
//   chunks in chunk order. No atomics: the order of every sum depends on
//   E, Z and D alone, so the same operands give the same bits. Zone
//   slices keep a warp's table within kSegSliceBytes of shared memory (96
//   zones at D = 32: rung 1's 64 zones take one slice, BASELINE config 4's
//   500 take 6, each re-reading the ids but not the values of other
//   slices).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;     // rows (warps) per CTA
constexpr int kMaxSlots = 8;  // 32-feature slots per row: H * d <= 256
constexpr float kSlope = 0.2f;
constexpr float kDenFloor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lrelu(float s) {
  return s >= 0.f ? s : kSlope * s;
}

__device__ __forceinline__ float lrelu_grad(float s) {
  return s >= 0.f ? 1.f : kSlope;
}

// Per slot, the sum of v over the features of the lane's head, in every lane
// of that head. d divides 32: a butterfly over the head's d lanes. d a
// multiple of 32: the whole warp, then the head's d / 32 slots. Any other d
// (a head straddles lanes and slots): through the warp's row `buf` of
// 32 * S floats in shared memory, each lane summing its head in feature
// order. All three are fixed orders: the same operands give the same bits.
template <int S>
__device__ __forceinline__ void head_sums(float (&v)[S], int d, int hd,
                                          float* buf) {
  const int lane = threadIdx.x & 31;
  if (32 % d != 0 && d % 32 != 0) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k * 32 + lane < hd) buf[k * 32 + lane] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int f = k * 32 + lane;
      if (f >= hd) continue;
      const float* head = buf + (f / d) * d;
      float t = 0.f;
      for (int q = 0; q < d; ++q) t += head[q];
      v[k] = t;
    }
    __syncwarp();
    return;
  }
  const int width = d < 32 ? d : 32;
  for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  if (d > 32) {
    const int per = d >> 5;
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      t[k] = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q)
        if (q / per == k / per) t[k] += v[q];
    }
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] = t[k];
  }
}

struct Lanes {
  int f[kMaxSlots];  // feature of the lane in each slot
  int h[kMaxSlots];  // its head
  bool on[kMaxSlots];
};

template <int S>
__device__ __forceinline__ void lanes_of(Lanes& ln, int hd, int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    ln.f[k] = k * 32 + lane;
    ln.on[k] = ln.f[k] < hd;
    ln.h[k] = ln.on[k] ? ln.f[k] / d : 0;
  }
}

template <int S>
__global__ void __launch_bounds__(32 * kWarps)
csr_forward_kernel(const float* __restrict__ wh,
                   const float* __restrict__ e_recv,
                   const float* __restrict__ e_send,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ src, float* __restrict__ out,
                   float* __restrict__ lse, int zd, int H, int d) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= zd) return;  // warp-uniform
  const int hd = H * d;
  Lanes ln;
  lanes_of<S>(ln, hd, d);
  const int beg = row_ptr[i], end = row_ptr[i + 1];
  float* orow = out + (long)i * hd;
  if (beg == end) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (!ln.on[k]) continue;
      orow[ln.f[k]] = 0.f;
      if (ln.f[k] % d == 0) lse[(long)i * H + ln.h[k]] = 0.f;
    }
    return;
  }
  float er[S], m[S], acc[S], den[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    er[k] = ln.on[k] ? e_recv[(long)i * H + ln.h[k]] : 0.f;
    m[k] = -INFINITY;
    acc[k] = 0.f;
    den[k] = 0.f;
  }
  for (int p = beg; p < end; ++p) {
    const long j = src[p];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (!ln.on[k]) continue;
      m[k] = fmaxf(m[k], lrelu(er[k] + e_send[j * H + ln.h[k]]));
    }
  }
  for (int p = beg; p < end; ++p) {
    const long j = src[p];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (!ln.on[k]) continue;
      const float w = expf(lrelu(er[k] + e_send[j * H + ln.h[k]]) - m[k]);
      den[k] += w;
      acc[k] += w * wh[j * hd + ln.f[k]];
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!ln.on[k]) continue;
    orow[ln.f[k]] = acc[k] / fmaxf(den[k], kDenFloor);
    if (ln.f[k] % d == 0) lse[(long)i * H + ln.h[k]] = m[k] + logf(den[k]);
  }
}

struct Bwd {
  const float* g;       // (zd, H d) output cotangent
  const float* wh;      // (zs, H d)
  const float* e_recv;  // (zr, H)
  const float* e_send;  // (zs, H)
  const float* lse;     // (zd, H)
  const float* corr;    // (zd, H)
  const int* row_ptr;   // (zd + 1) destination-major
  const int* src;       // (E) sources in destination-major order
  const int* col_ptr;   // (zs + 1) source-major
  const int* dst_by_src;  // (E) destinations in source-major order
  float* d_wh;          // (zs, H d)
  float* d_recv;        // (zr, H)
  float* d_send;        // (zs, H)
  int zd, zr, zs, H, d, recv_blocks;
};

template <int S>
__global__ void __launch_bounds__(32 * kWarps)
csr_backward_kernel(const Bwd b) {
  __shared__ float rows[kWarps][32 * S];  // head_sums' rows, one a warp
  const int hd = b.H * b.d;
  Lanes ln;
  lanes_of<S>(ln, hd, b.d);
  const int warp = threadIdx.x >> 5;
  float* buf = rows[warp];
  if ((int)blockIdx.x < b.recv_blocks) {
    // destination role: d_recv[i] = sum over i's in-edges of ds
    const int i = blockIdx.x * kWarps + warp;
    if (i >= b.zr) return;
    const int beg = i < b.zd ? b.row_ptr[i] : 0;
    const int end = i < b.zd ? b.row_ptr[i + 1] : 0;
    float gi[S], er[S], ls[S], cr[S], acc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      acc[k] = 0.f;
      const bool use = ln.on[k] && beg < end;
      const long r = (long)i * b.H + ln.h[k];
      gi[k] = use ? b.g[(long)i * hd + ln.f[k]] : 0.f;
      er[k] = use ? b.e_recv[r] : 0.f;
      ls[k] = use ? b.lse[r] : 0.f;
      cr[k] = use ? b.corr[r] : 0.f;
    }
    for (int p = beg; p < end; ++p) {
      const long j = b.src[p];
      float t[S];
#pragma unroll
      for (int k = 0; k < S; ++k)
        t[k] = ln.on[k] ? gi[k] * b.wh[j * hd + ln.f[k]] : 0.f;
      head_sums<S>(t, b.d, hd, buf);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        if (!ln.on[k]) continue;
        const float s = er[k] + b.e_send[j * b.H + ln.h[k]];
        const float alpha = expf(lrelu(s) - ls[k]);
        acc[k] += alpha * (t[k] - cr[k]) * lrelu_grad(s);
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (ln.on[k] && ln.f[k] % b.d == 0)
        b.d_recv[(long)i * b.H + ln.h[k]] = acc[k];
    return;
  }
  // source role: d_wh[j] = sum_i alpha g_i, d_send[j] = sum_i ds
  const int j = (blockIdx.x - b.recv_blocks) * kWarps + warp;
  if (j >= b.zs) return;
  const int beg = b.col_ptr[j], end = b.col_ptr[j + 1];
  float wj[S], es[S], gw[S], gs[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool use = ln.on[k] && beg < end;
    wj[k] = use ? b.wh[(long)j * hd + ln.f[k]] : 0.f;
    es[k] = use ? b.e_send[(long)j * b.H + ln.h[k]] : 0.f;
    gw[k] = 0.f;
    gs[k] = 0.f;
  }
  for (int p = beg; p < end; ++p) {
    const long i = b.dst_by_src[p];
    float gi[S], t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      gi[k] = ln.on[k] ? b.g[i * hd + ln.f[k]] : 0.f;
      t[k] = gi[k] * wj[k];
    }
    head_sums<S>(t, b.d, hd, buf);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (!ln.on[k]) continue;
      const long r = i * b.H + ln.h[k];
      const float s = b.e_recv[r] + es[k];
      const float alpha = expf(lrelu(s) - b.lse[r]);
      gw[k] += alpha * gi[k];
      gs[k] += alpha * (t[k] - b.corr[r]) * lrelu_grad(s);
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!ln.on[k]) continue;
    b.d_wh[(long)j * hd + ln.f[k]] = gw[k];
    if (ln.f[k] % b.d == 0) b.d_send[(long)j * b.H + ln.h[k]] = gs[k];
  }
}

// ---- K9e: the segment sum --------------------------------------------------

constexpr int kSegWarps = 8;    // warps per CTA, each with its own table
constexpr int kSegUnroll = 16;  // rows whose loads are in flight at a time
// the warps' tables of one CTA: 96 KB, so that 2 CTAs share an SM
constexpr int kSegSliceBytes = 96 * 1024;

// (values, ids) rows [r0, r1) of this CTA's chunk -> the chunk's partial
// sums (z, d) of the zone slice [z0, z0 + zn), blockIdx.y = slice index
__global__ void __launch_bounds__(32 * kSegWarps)
    segment_sum_kernel(const float* __restrict__ vals,
                       const int* __restrict__ ids, float* partial, long e,
                       int d, int z, int zs, int num_chunks) {
  extern __shared__ float tab[];  // [kSegWarps][zs][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int z0 = blockIdx.y * zs;
  const int zn = min(zs, z - z0);
  float* mine = tab + (size_t)warp * zs * d;
  for (int i = lane; i < zn * d; i += 32) mine[i] = 0.f;
  __syncwarp();
  const long c0 = e * blockIdx.x / num_chunks;
  const long c1 = e * (blockIdx.x + 1) / num_chunks;
  const long r0 = c0 + (c1 - c0) * warp / kSegWarps;
  const long r1 = c0 + (c1 - c0) * (warp + 1) / kSegWarps;
  for (int col0 = 0; col0 < d; col0 += 32) {
    const int col = col0 + lane;
    const bool cv = col < d;
    for (long r = r0; r < r1; r += kSegUnroll) {
      // lane u < kSegUnroll holds row r + u's id relative to the slice;
      // a row past r1, or an id outside the slice, reads as zn (dropped).
      // Unsigned: a negative id or one below z0 wraps past zn.
      unsigned rel = (unsigned)zn;
      if (lane < kSegUnroll && r + lane < r1)
        rel = min((unsigned)__ldg(ids + r + lane) - (unsigned)z0,
                  (unsigned)zn);
      float v[kSegUnroll];
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const unsigned ru = __shfl_sync(0xffffffffu, rel, u);
        v[u] = (cv && ru < (unsigned)zn)
                   ? __bfloat162float(__float2bfloat16_rn(
                         __ldg(vals + (r + u) * d + col)))
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const unsigned ru = __shfl_sync(0xffffffffu, rel, u);
        if (cv && ru < (unsigned)zn) mine[ru * d + col] += v[u];
      }
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)blockIdx.x * z + z0) * d;
  for (int i = threadIdx.x; i < zn * d; i += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) acc += tab[(size_t)w * zs * d + i];
    out[i] = acc;
  }
}

// out[i] = sum over chunks, in order, of partial[c][i]
__global__ void segment_sum_chunks(const float* partial, float* out,
                                   long size, int num_chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float acc = 0.f;
  for (int c = 0; c < num_chunks; ++c) acc += partial[(size_t)c * size + i];
  out[i] = acc;
}

// zones of one slice: as many as kSegSliceBytes holds for every warp, the
// slices of a zone count made even; 0 where one zone does not fit
int segment_slice(int z, int d) {
  const long fit = kSegSliceBytes / ((long)kSegWarps * d * sizeof(float));
  if (fit < 1) return 0;
  const long slices = (z + fit - 1) / fit;
  return (int)((z + slices - 1) / slices);
}

bool compiled_for(int H, int d) {
  return H >= 1 && d >= 1 && H * d <= 32 * kMaxSlots;
}

unsigned blocks(int rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

}  // namespace

extern "C" {

// The forward on `stream`: out (zd, H d) and lse (zd, H) from wh (zs, H d),
// e_recv (>= zd rows with edges, H), e_send (zs, H) and the destination-major
// layout row_ptr (zd + 1), src. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for widths this file was not compiled for.
int ananke_edge_csr_forward(const void* wh, const void* e_recv,
                            const void* e_send, const void* row_ptr,
                            const void* src, void* out, void* lse, int zd,
                            int H, int d, void* stream) {
  if (!compiled_for(H, d) || zd < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (H * d + 31) / 32;
  const auto* w = static_cast<const float*>(wh);
  const auto* er = static_cast<const float*>(e_recv);
  const auto* es = static_cast<const float*>(e_send);
  const auto* rp = static_cast<const int*>(row_ptr);
  const auto* sr = static_cast<const int*>(src);
  auto* o = static_cast<float*>(out);
  auto* l = static_cast<float*>(lse);
#define ANANKE_FWD(S)                                                     \
  case S:                                                                 \
    csr_forward_kernel<S><<<blocks(zd), 32 * kWarps, 0, s>>>(             \
        w, er, es, rp, sr, o, l, zd, H, d);                               \
    break;
  switch (slots) {
    ANANKE_FWD(1) ANANKE_FWD(2) ANANKE_FWD(3) ANANKE_FWD(4)
    ANANKE_FWD(5) ANANKE_FWD(6) ANANKE_FWD(7) ANANKE_FWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ANANKE_FWD
  return (int)cudaGetLastError();
}

// The backward on `stream`: d_wh (zs, H d), d_recv (zr, H) and d_send (zs, H)
// from the output cotangent g (zd, H d), the forward's operands and lse, the
// per-head correction corr (zd, H) and both orders of the edges. Rows of
// d_recv at or past zd are 0. Returns as ananke_edge_csr_forward.
int ananke_edge_csr_backward(const void* g, const void* wh,
                             const void* e_recv, const void* e_send,
                             const void* lse, const void* corr,
                             const void* row_ptr, const void* src,
                             const void* col_ptr, const void* dst_by_src,
                             void* d_wh, void* d_recv, void* d_send, int zd,
                             int zr, int zs, int H, int d, void* stream) {
  if (!compiled_for(H, d) || zd < 0 || zr < 0 || zs < 0 || zr + zs < 1)
    return (int)cudaErrorInvalidValue;
  Bwd b;
  b.g = static_cast<const float*>(g);
  b.wh = static_cast<const float*>(wh);
  b.e_recv = static_cast<const float*>(e_recv);
  b.e_send = static_cast<const float*>(e_send);
  b.lse = static_cast<const float*>(lse);
  b.corr = static_cast<const float*>(corr);
  b.row_ptr = static_cast<const int*>(row_ptr);
  b.src = static_cast<const int*>(src);
  b.col_ptr = static_cast<const int*>(col_ptr);
  b.dst_by_src = static_cast<const int*>(dst_by_src);
  b.d_wh = static_cast<float*>(d_wh);
  b.d_recv = static_cast<float*>(d_recv);
  b.d_send = static_cast<float*>(d_send);
  b.zd = zd; b.zr = zr; b.zs = zs; b.H = H; b.d = d;
  b.recv_blocks = (int)blocks(zr);
  const unsigned grid = blocks(zr) + blocks(zs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = (H * d + 31) / 32;
#define ANANKE_BWD(S)                                                     \
  case S:                                                                 \
    csr_backward_kernel<S><<<grid, 32 * kWarps, 0, s>>>(b);               \
    break;
  switch (slots) {
    ANANKE_BWD(1) ANANKE_BWD(2) ANANKE_BWD(3) ANANKE_BWD(4)
    ANANKE_BWD(5) ANANKE_BWD(6) ANANKE_BWD(7) ANANKE_BWD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ANANKE_BWD
  return (int)cudaGetLastError();
}

// The largest row width the segment sum takes: one zone's row for every
// warp must fit its shared memory.
int ananke_segment_sum_max_features() {
  return kSegSliceBytes / (kSegWarps * (int)sizeof(float));
}

// The segment sum on `stream`: out (z, d) from vals (e, d) and ids (e),
// through `partial` (num_chunks, z, d) when num_chunks > 1 (the caller
// chooses num_chunks from e, z and d alone; at 1 the CTAs write `out`).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a width this file does not take or bad sizes.
int ananke_segment_sum(const void* vals, const void* ids, void* partial,
                       void* out, long e, int d, int z, int num_chunks,
                       void* stream) {
  const int zs = segment_slice(z, d);
  if (e < 1 || d < 1 || z < 1 || zs < 1 || num_chunks < 1 ||
      num_chunks > e)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)kSegWarps * zs * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segment_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(num_chunks > 1 ? partial : out);
  const dim3 grid((unsigned)num_chunks, (unsigned)((z + zs - 1) / zs));
  segment_sum_kernel<<<grid, 32 * kSegWarps, bytes, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids), dst, e,
      d, z, zs, num_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_chunks == 1) return (int)err;
  const long size = (long)z * d;
  segment_sum_chunks<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      dst, static_cast<float*>(out), size, num_chunks);
  return (int)cudaGetLastError();
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
