// Sparse edge-list GAT aggregation on Hopper (sm_90a): one kernel pair over
// a CSR layout of the zone graph, replacing four Pallas TPU kernels of
// ananke_abm_tpu/ops/pallas/. Plain PyTorch versions:
// ananke_abm_tpu_torch/ops/cuda/edge_segment.py::gat_edge_csr_{forward,
// backward}_reference.
//
// ananke_edge_csr_forward <- edge_segment.py gat_edge_aggregate_pallas (K9a,
//   one head), gat_edge_aggregate_multihead_pallas (K9b, all heads) and
//   edge_gather.py gat_edge_aggregate_gather_pallas (K9d, the large-Z
//   block-pair form): one function. Over each destination row i's in-edges
//   (row_ptr[i] .. row_ptr[i + 1], sources in src[]) it scores s =
//   lrelu(e_recv[i, h] + e_send[j, h], 0.2), takes the exact
//   per-destination max m in a first walk and, in a second, p = exp(s - m),
//   its sum and sum_j p Wh[j], in edge order. It writes out[i] = sum_j p
//   Wh[j] / max(sum_j p, 1e-12) and lse[i, h] = m + log(sum_j p) (0 for a
//   row with no edge, whose output is 0).
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
// L2; the forward keeps each row's state in registers, reads every table
// once per edge and writes every output once.
//
// Both kernels' first designs (a warp a row, lane l features l, l + 32,
// ...) spent most of their time in the instruction stream and the latency
// chain of their edge loops, not in their gathers (H100 probes, PERF.md):
// per edge each lane loaded the edge's index, then its scalars and its row,
// one edge at a time, and took 2 expf (the forward: 64 expf a destination
// an edge where its 4 heads need 4); the forward's index loads and gathers
// cost ~0.022 of its 0.054 ms, its max walk ~0.013. Their layout now: a
// group of G = 8, 16 or 32 lanes owns a row, each lane V = 4 contiguous
// features of one head in each slot (16-byte loads; V = 1 where d is not a
// multiple of 4), so a 64-feature row is a half-warp and a warp walks two
// rows. A group loads up to G of its edge indices in one coalesced load and
// hands them out by shuffle. The backward sums a head as the lane's
// products in registers, then a butterfly over the head's d / V lanes, and
// starts the gathers of 4 / S edges of a destination row or 2 / S of a
// source row (their rows and scalars) before it sums any. The forward
// gathers 8 / S edges' scores at once for the max, then 4 / S edges' rows
// and scores before it sums any; each lane takes its head's exp once an
// edge (16 expf a destination an edge at 4 heads of 16), and keeps the
// first batch of indices for the second walk. Both: 4-warp CTAs, 8 an SM at
// the main path's one slot (backward 64 registers, forward 54). Latency
// still bounds them, not their bytes: a row's loads are a chain of L2 round
// trips (its offsets, its edge indices, the forward's scores, then the
// gathers a few edges at a time), and 32 warps an SM hide part of them;
// more edges in flight (8) or more CTAs an SM (12) spill and lose.
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
//   own (slice, D) float32 table in shared memory. The warps' tables are
//   summed in warp order into the chunk's partial sums in device memory,
//   and a second kernel sums the chunks in chunk order, a CTA a tile of 32
//   outputs with every chunk's loads in flight. No atomics: the order of
//   every sum depends on E, Z and D alone, so the same operands give the
//   same bits. Zone slices keep a warp's table within kSegSliceBytes of
//   shared memory (96 zones at D = 32: rung 1's 64 zones take one slice,
//   BASELINE config 4's 500 take 6, each re-reading the ids and values).
//   Its first design ran each 16-row batch as one serial chain (ids, then
//   the values loaded only for rows in the slice, then the adds), at 40
//   registers: 0.22 ms at rung 1 where the values alone need 0.041. Now a
//   warp loads every value of a 32-row batch whatever its id (a row is
//   dropped at its add), and issues the next batch's loads before this
//   batch's adds; at D = 32 the batch's loads take immediate offsets. At
//   rung 1 the adds cost ~0.0025 ms and the stream runs at ~2.3 TB/s;
//   three batches in flight, an interleaved partition, 16-row batches or
//   predicated adds are no faster (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// The CSR kernels' row layout: a row of hd features over a group of G
// lanes (32 / G rows a warp), V contiguous features a lane in each of S
// slots: lane q of its group holds features (k G + q) V .. (k G + q) V + V
// - 1 in slot k, all of one head. V = 4 reads rows as 16-byte loads (d a
// multiple of 4); V = 1 takes heads of any width.
template <int V, int G, int S>
struct Slots {
  int f0[S];  // first feature of the lane in each slot
  int h[S];   // its head
  bool on[S];
  __device__ __forceinline__ Slots(int hd, int d) {
    const int q = (threadIdx.x & 31) % G;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      f0[k] = (k * G + q) * V;
      on[k] = f0[k] < hd;
      h[k] = on[k] ? f0[k] / d : 0;
    }
  }
};

// x = the V features at p where `use`, else 0
template <int V>
__device__ __forceinline__ void load_row(bool use, const float* p,
                                         float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = use ? __ldg(reinterpret_cast<const float4*>(p))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = use ? __ldg(p + v) : 0.f;
  }
}

// For each of U edges and each slot, <a, b> over the lane's head, in every
// lane of the head: a the group's own row, b the edge's other end. Heads of
// d / V lanes, a power of two within the group: the lane's V products in
// order, then a butterfly over the head's lanes, the U edges' shuffles
// interleaved. Heads of whole slots (d / V a multiple of G = 32): the
// butterfly over the group, then the head's slots. Any other d: edge by
// edge through the group's row `buf` in shared memory, each lane summing
// its head in feature order. Fixed orders all: the same operands give the
// same bits. Every lane of the warp calls it.
template <int V, int G, int S, int U>
__device__ __forceinline__ void head_sums(const float (&a)[S][V],
                                          const float (&b)[U][S][V],
                                          float (&t)[U][S],
                                          const Slots<V, G, S>& sl, int d,
                                          float* buf) {
  const int lph = d / V;
  const bool butterfly = (lph & (lph - 1)) == 0 && lph <= G;
  if (butterfly || lph % G == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < S; ++k) {
        t[u][k] = a[k][0] * b[u][k][0];
#pragma unroll
        for (int v = 1; v < V; ++v) t[u][k] += a[k][v] * b[u][k][v];
      }
    for (int off = (butterfly ? lph : G) >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < S; ++k)
          t[u][k] += __shfl_xor_sync(kFull, t[u][k], off);
    }
    if (butterfly) return;
    const int per = lph / G;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float m[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        m[k] = 0.f;
#pragma unroll
        for (int q = 0; q < S; ++q)
          if (q / per == k / per) m[k] += t[u][q];
      }
#pragma unroll
      for (int k = 0; k < S; ++k) t[u][k] = m[k];
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (sl.on[k]) {
#pragma unroll
        for (int v = 0; v < V; ++v) buf[sl.f0[k] + v] = a[k][v] * b[u][k][v];
      }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < S; ++k) {
      t[u][k] = 0.f;
      if (!sl.on[k]) continue;
      const float* head = buf + sl.h[k] * d;
      for (int q = 0; q < d; ++q) t[u][k] += head[q];
    }
    __syncwarp();
  }
}

constexpr int kBwdWarps = 4;
// CTAs an SM at one slot: registers for 32 warps (64 a thread); rows of
// S slots get S times the registers, so that they do not spill
constexpr int kBwdBlocks = 8;
// edges a group gathers before it sums any: a destination row's edges
// gather a row and one scalar each, a source row's a row and three
constexpr int kRecvInFlight = 4;
constexpr int kSendInFlight = 2;

// K9c. A group of G lanes owns a row: a destination row i in the first
// recv_blocks blocks (d_recv[i] = sum over i's in-edges of ds), a source
// row j in the others (d_wh[j] = sum over j's out-edges of alpha g_i,
// d_send[j] = of ds). A group loads up to G of its edge indices at once,
// one coalesced load, hands them out by shuffle, and starts the gathers of
// a few edges (the other end's row, 16 bytes a lane, and its scalars)
// before it sums any. The warp walks the largest edge count of its rows;
// each sum runs in edge order. backward_rows walks block `block` of one
// role, fixed at compile time; `buf` is the warp's row of shared memory.
template <bool recv, int V, int G, int S>
__device__ __forceinline__ void backward_rows(const Bwd& b, int block,
                                              float* buf) {
  constexpr int R = 32 / G;      // rows a warp
  constexpr int flight = recv ? kRecvInFlight : kSendInFlight;
  constexpr int U = S < flight ? flight / S : 1;
  const int hd = b.H * b.d;
  const Slots<V, G, S> sl(hd, b.d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane % G, grp = lane / G;
  buf += grp * (G * S * V);
  const int row = block * (kBwdWarps * R) + warp * R + grp;
  const bool ok = row < (recv ? b.zr : b.zs);
  // the row's edges: destination-major in the first role, source-major in
  // the second (rows of d_recv at or past zd have none)
  int beg = 0, cnt = 0;
  if (ok && (!recv || row < b.zd)) {
    const int* ptr = recv ? b.row_ptr : b.col_ptr;
    beg = ptr[row];
    cnt = ptr[row + 1] - beg;
  }
  const int* ends = recv ? b.src : b.dst_by_src;
  // its own row and scalars: g_i, e_recv, lse, corr (destination); Wh_j,
  // e_send (source)
  const float* own = recv ? b.g : b.wh;
  const float* far = recv ? b.wh : b.g;
  float mine[S][V], e_own[S], ls[S], cr[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool use = sl.on[k] && cnt > 0;
    const long r = (long)row * b.H + sl.h[k];
    load_row<V>(use, own + (long)row * hd + sl.f0[k], mine[k]);
    e_own[k] = use ? (recv ? b.e_recv[r] : b.e_send[r]) : 0.f;
    ls[k] = use && recv ? b.lse[r] : 0.f;
    cr[k] = use && recv ? b.corr[r] : 0.f;
  }
  int most = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    most = max(most, __shfl_xor_sync(kFull, most, off));
  float gs[S], gw[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    gs[k] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) gw[k][v] = 0.f;
  }
  for (int base = 0; base < most; base += G) {
    const int batch = base + q < cnt ? __ldg(ends + beg + base + q) : 0;
    const int n = min(G, most - base);
    for (int u0 = 0; u0 < n; u0 += U) {
      // the gathers of U edges, then their sums
      float x[U][S][V], sa[U][S], sb[U][S], sc[U][S];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long e = __shfl_sync(kFull, batch, u0 + u, G);
        live[u] = base + u0 + u < cnt;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const bool use = live[u] && sl.on[k];
          const long r = e * b.H + sl.h[k];
          load_row<V>(use, far + e * hd + sl.f0[k], x[u][k]);
          sa[u][k] = use ? __ldg((recv ? b.e_send : b.e_recv) + r) : 0.f;
          sb[u][k] = use && !recv ? __ldg(b.lse + r) : ls[k];
          sc[u][k] = use && !recv ? __ldg(b.corr + r) : cr[k];
        }
      }
      float t[U][S];
      head_sums<V, G, S, U>(mine, x, t, sl, b.d, buf);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (!sl.on[k]) continue;
          // e_recv[i] + e_send[j] in either role
          const float s = recv ? e_own[k] + sa[u][k] : sa[u][k] + e_own[k];
          const float alpha = expf(lrelu(s) - sb[u][k]);
          if (!recv) {
#pragma unroll
            for (int v = 0; v < V; ++v) gw[k][v] += alpha * x[u][k][v];
          }
          gs[k] += alpha * (t[u][k] - sc[u][k]) * lrelu_grad(s);
        }
      }
    }
  }
  if (!ok) return;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!sl.on[k]) continue;
    const bool first = sl.f0[k] % b.d == 0;  // the head's first lane
    if (recv) {
      if (first) b.d_recv[(long)row * b.H + sl.h[k]] = gs[k];
      continue;
    }
    float* out = b.d_wh + (long)row * hd + sl.f0[k];
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out) =
          make_float4(gw[k][0], gw[k][1], gw[k][2], gw[k][3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = gw[k][v];
    }
    if (first) b.d_send[(long)row * b.H + sl.h[k]] = gs[k];
  }
}

template <int V, int G, int S>
__global__ void __launch_bounds__(32 * kBwdWarps,
                                  S < kBwdBlocks ? kBwdBlocks / S : 1)
csr_backward_kernel(const Bwd b) {
  __shared__ float rows[kBwdWarps][32 * S * V];  // head_sums' general path
  float* buf = rows[threadIdx.x >> 5];
  if ((int)blockIdx.x < b.recv_blocks)
    backward_rows<true, V, G, S>(b, blockIdx.x, buf);
  else
    backward_rows<false, V, G, S>(b, blockIdx.x - b.recv_blocks, buf);
}

struct Fwd {
  const float* wh;      // (zs, H d)
  const float* e_recv;  // (>= zd rows with edges, H)
  const float* e_send;  // (zs, H)
  const int* row_ptr;   // (zd + 1) destination-major
  const int* src;       // (E) sources in destination-major order
  float* out;           // (zd, H d)
  float* lse;           // (zd, H)
  int zd, H, d;
};

constexpr int kFwdWarps = 4;
// CTAs an SM at one slot, as the backward's
constexpr int kFwdBlocks = 8;
// scores a lane gathers at once in the max pass, and edges whose source
// rows it gathers before it sums any in the second pass (over its slots)
constexpr int kScoresInFlight = 8;
constexpr int kFwdInFlight = 4;

// The forward on K9c's layout: a group of G lanes owns a destination row
// i, lane q V contiguous features of one head in each of S slots. The
// group loads up to G of i's edge indices at once (one coalesced load),
// hands them out by shuffle, and walks them twice: the exact per-head max
// m of the scores s = lrelu(e_recv[i] + e_send[j]), then, in edge order,
// w = exp(s - m), den += w and acc += w Wh[j], the gathers of a few edges
// (the source row's V features and its score) issued before any is
// summed. Every lane takes its own head's w once an edge. The batch of
// the first G edges is kept for the second walk. The warp walks the
// largest edge count of its rows.
template <int V, int G, int S>
__global__ void __launch_bounds__(32 * kFwdWarps,
                                  S < kFwdBlocks ? kFwdBlocks / S : 1)
csr_forward_kernel(const Fwd f) {
  constexpr int R = 32 / G;  // rows a warp
  constexpr int P = S < kScoresInFlight ? kScoresInFlight / S : 1;
  constexpr int U = S < kFwdInFlight ? kFwdInFlight / S : 1;
  const int H = f.H, hd = H * f.d;
  const Slots<V, G, S> sl(hd, f.d);
  const int lane = threadIdx.x & 31, q = lane % G;
  const int row = blockIdx.x * (kFwdWarps * R) + (threadIdx.x >> 5) * R +
                  lane / G;
  int beg = 0, cnt = 0;
  if (row < f.zd) {
    beg = f.row_ptr[row];
    cnt = f.row_ptr[row + 1] - beg;
  }
  float er[S], m[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    er[k] = sl.on[k] && cnt > 0 ? __ldg(f.e_recv + (long)row * H + sl.h[k])
                                : 0.f;
    m[k] = -INFINITY;
  }
  int most = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    most = max(most, __shfl_xor_sync(kFull, most, off));
  const int* ends = f.src + beg;
  int first = 0;  // the first batch of edge indices
  for (int base = 0; base < most; base += G) {
    const int idx = base + q < cnt ? __ldg(ends + base + q) : 0;
    if (base == 0) first = idx;
    const int n = min(G, most - base);
    for (int u0 = 0; u0 < n; u0 += P) {
      // the scores of P edges (-inf past the row's edges), then their max
      float sc[P][S];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const long j = __shfl_sync(kFull, idx, u0 + u, G);
        const bool live = base + u0 + u < cnt;
#pragma unroll
        for (int k = 0; k < S; ++k)
          sc[u][k] = live && sl.on[k] ? __ldg(f.e_send + j * H + sl.h[k])
                                      : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < P; ++u)
#pragma unroll
        for (int k = 0; k < S; ++k)
          m[k] = fmaxf(m[k], lrelu(er[k] + sc[u][k]));
    }
  }
  float den[S], acc[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    den[k] = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
  }
  for (int base = 0; base < most; base += G) {
    const int idx = base == 0 ? first
                    : base + q < cnt ? __ldg(ends + base + q) : 0;
    const int n = min(G, most - base);
    for (int u0 = 0; u0 < n; u0 += U) {
      // the gathers of U edges, then their sums
      float x[U][S][V], sc[U][S];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long j = __shfl_sync(kFull, idx, u0 + u, G);
        live[u] = base + u0 + u < cnt;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const bool use = live[u] && sl.on[k];
          load_row<V>(use, f.wh + j * hd + sl.f0[k], x[u][k]);
          sc[u][k] = use ? __ldg(f.e_send + j * H + sl.h[k]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (!sl.on[k]) continue;
          const float w = expf(lrelu(er[k] + sc[u][k]) - m[k]);
          den[k] += w;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k][v] += w * x[u][k][v];
        }
      }
    }
  }
  if (row >= f.zd) return;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (!sl.on[k]) continue;
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = cnt > 0 ? acc[k][v] / fmaxf(den[k], kDenFloor) : 0.f;
    float* orow = f.out + (long)row * hd + sl.f0[k];
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(orow) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) orow[v] = o[v];
    }
    if (sl.f0[k] % f.d == 0)  // the head's first lane
      f.lse[(long)row * H + sl.h[k]] = cnt > 0 ? m[k] + logf(den[k]) : 0.f;
  }
}

// ---- K9e: the segment sum --------------------------------------------------

constexpr int kSegWarps = 8;   // warps per CTA, each with its own table
constexpr int kSegRows = 32;   // rows of a batch: an id a lane
// the warps' tables of one CTA: 96 KB, so that 2 CTAs share an SM
constexpr int kSegSliceBytes = 96 * 1024;
// the chunk sum: outputs a CTA, and chunks each of its 8 column groups
// loads at once (SEGMENT_MAX_CHUNKS = 264 = 8 x 33: one round)
constexpr int kSumCols = 32;
constexpr int kSumDepth = 33;
constexpr int kSumThreads = 256;
// chunks whose partial sums of a CTA's outputs fit 48 KB of shared memory
constexpr int kMaxChunks = 48 * 1024 / (kSumCols * (int)sizeof(float));

// A batch of a warp's rows, in flight while the batch before it adds:
// lane u the id of row r + u (-1 past r1), every lane its column of each
// row (0 past r1 or d). The value loads do not wait for the ids.
struct SegBatch {
  int id;
  float v[kSegRows];
};

// batch rows [r, min(r + kSegRows, r1)); vcol: the lane's column of row 0
__device__ __forceinline__ void seg_load(SegBatch& b, const float* vcol,
                                         const int* ids, long r, long r1,
                                         int d, bool cv, int lane) {
  const long left = r1 - r;  // rows of the batch before r1
  b.id = lane < left ? __ldg(ids + r + lane) : -1;
  const float* p = vcol + r * d;
#pragma unroll
  for (int u = 0; u < kSegRows; ++u)
    b.v[u] = cv && u < left ? __ldg(p + u * d) : 0.f;
}

// the batch's values, rounded to bf16, added in row order into the warp's
// table `mine` of the zone slice [z0, z0 + zn); a row whose id falls
// outside the slice (or past r1) is dropped here
__device__ __forceinline__ void seg_add(const SegBatch& b, float* mine,
                                        int z0, int zn, int d, int col,
                                        bool cv) {
  // unsigned: an id of -1, a negative one or one below z0 wraps past zn
  const unsigned rel = min((unsigned)b.id - (unsigned)z0, (unsigned)zn);
#pragma unroll
  for (int u = 0; u < kSegRows; ++u) {
    const unsigned ru = __shfl_sync(kFull, rel, u);
    const float x = __bfloat162float(__float2bfloat16_rn(b.v[u]));
    if (cv && ru < (unsigned)zn) mine[ru * d + col] += x;
  }
}

// (values, ids) rows [c0, c1) of this CTA's chunk -> the chunk's partial
// sums (z, d) of the zone slice [z0, z0 + zn), blockIdx.y = slice index.
// Warp w walks rows [r0, r1) of the chunk in order, two batches at a time:
// the loads of one batch are issued before the adds of the one before.
// kD: the row width where it is fixed at compile time (the main path's
// 32, so that a batch's loads take immediate offsets), else 0 (d_arg).
template <int kD>
__global__ void __launch_bounds__(32 * kSegWarps)
    segment_sum_kernel(const float* __restrict__ vals,
                       const int* __restrict__ ids, float* partial, long e,
                       int d_arg, int z, int zs, int num_chunks) {
  extern __shared__ float tab[];  // [kSegWarps][zs][d]
  const int d = kD > 0 ? kD : d_arg;
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
    const float* vcol = vals + col;
    SegBatch a, b;
    seg_load(a, vcol, ids, r0, r1, d, cv, lane);
    for (long r = r0; r < r1; r += 2 * kSegRows) {
      seg_load(b, vcol, ids, r + kSegRows, r1, d, cv, lane);
      seg_add(a, mine, z0, zn, d, col, cv);
      seg_load(a, vcol, ids, r + 2 * kSegRows, r1, d, cv, lane);
      seg_add(b, mine, z0, zn, d, col, cv);
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

// out[i] = sum over chunks, in order, of partial[c][i]. A CTA owns
// kSumCols outputs: its 8 column groups load every chunk's partial sums
// of them into shared memory (group g chunks g, g + 8, ..., all loads in
// flight before any is stored), then one warp sums each output's column
// in chunk order.
__global__ void __launch_bounds__(kSumThreads)
    segment_sum_chunks(const float* __restrict__ partial,
                       float* __restrict__ out, long size, int num_chunks) {
  extern __shared__ float st[];  // [num_chunks][kSumCols]
  constexpr int kGroups = kSumThreads / kSumCols;
  const int col = threadIdx.x % kSumCols, grp = threadIdx.x / kSumCols;
  const long i = (long)blockIdx.x * kSumCols + col;
  const bool ok = i < size;
  for (int c0 = grp; c0 < num_chunks; c0 += kGroups * kSumDepth) {
    float x[kSumDepth];
#pragma unroll
    for (int k = 0; k < kSumDepth; ++k) {
      const int c = c0 + k * kGroups;
      x[k] = ok && c < num_chunks ? __ldg(partial + (size_t)c * size + i)
                                  : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kSumDepth; ++k) {
      const int c = c0 + k * kGroups;
      if (c < num_chunks) st[c * kSumCols + col] = x[k];
    }
  }
  __syncthreads();
  if (grp != 0 || !ok) return;
  float acc = 0.f;
  for (int c = 0; c < num_chunks; ++c) acc += st[c * kSumCols + col];
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

// The row layout of the CSR kernels for rows of hd = H d features: V = 4
// (16-byte rows) where heads hold whole float4s and the rows are aligned,
// else 1; groups of G = 8, 16 or 32 lanes a row; S slots a lane.
struct RowLayout {
  bool v4;
  int width, slots;
  RowLayout(int H, int d, bool aligned) {
    v4 = d % 4 == 0 && aligned;
    const int vecs = v4 ? H * d / 4 : H * d;
    width = v4 ? (vecs <= 8 ? 8 : vecs <= 16 ? 16 : 32) : 32;
    slots = (vecs + width - 1) / width;
  }
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the layouts the kernels are compiled for: H d <= 256 features
#define ANANKE_LAYOUTS(X)                                                  \
  X(4, 8, 1) X(4, 16, 1) X(4, 32, 1) X(4, 32, 2)                            \
  X(1, 32, 1) X(1, 32, 2) X(1, 32, 3) X(1, 32, 4) X(1, 32, 5) X(1, 32, 6)  \
  X(1, 32, 7) X(1, 32, 8)

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
  Fwd f;
  f.wh = static_cast<const float*>(wh);
  f.e_recv = static_cast<const float*>(e_recv);
  f.e_send = static_cast<const float*>(e_send);
  f.row_ptr = static_cast<const int*>(row_ptr);
  f.src = static_cast<const int*>(src);
  f.out = static_cast<float*>(out);
  f.lse = static_cast<float*>(lse);
  f.zd = zd; f.H = H; f.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowLayout lay(H, d, aligned16(wh) && aligned16(out));
  const int per_block = kFwdWarps * (32 / lay.width);
  const unsigned grid = (unsigned)((zd + per_block - 1) / per_block);
#define ANANKE_FWD(V, G, S)                                               \
  if (lay.v4 == (V == 4) && lay.width == G && lay.slots == S) {           \
    csr_forward_kernel<V, G, S><<<grid, 32 * kFwdWarps, 0, s>>>(f);       \
    return (int)cudaGetLastError();                                       \
  }
  ANANKE_LAYOUTS(ANANKE_FWD)
#undef ANANKE_FWD
  return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowLayout lay(H, d, aligned16(g) && aligned16(wh) && aligned16(d_wh));
  const int per_block = kBwdWarps * (32 / lay.width);
  const auto bwd_blocks = [per_block](int rows) {
    return (unsigned)((rows + per_block - 1) / per_block);
  };
  b.recv_blocks = (int)bwd_blocks(zr);
  const unsigned grid = bwd_blocks(zr) + bwd_blocks(zs);
#define ANANKE_BWD(V, G, S)                                               \
  if (lay.v4 == (V == 4) && lay.width == G && lay.slots == S) {           \
    csr_backward_kernel<V, G, S><<<grid, 32 * kBwdWarps, 0, s>>>(b);      \
    return (int)cudaGetLastError();                                       \
  }
  ANANKE_LAYOUTS(ANANKE_BWD)
#undef ANANKE_BWD
  return (int)cudaErrorInvalidValue;
}

// The largest row width the segment sum takes: one zone's row for every
// warp must fit its shared memory.
int ananke_segment_sum_max_features() {
  return kSegSliceBytes / (kSegWarps * (int)sizeof(float));
}

// The segment sum on `stream`: out (z, d) from vals (e, d) and ids (e),
// through `partial` (num_chunks, z, d) when num_chunks > 1 (the caller
// chooses num_chunks <= 384 from e, z and d alone; at 1 the CTAs write
// `out`).
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for a width this file does not take or bad sizes.
int ananke_segment_sum(const void* vals, const void* ids, void* partial,
                       void* out, long e, int d, int z, int num_chunks,
                       void* stream) {
  const int zs = segment_slice(z, d);
  if (e < 1 || d < 1 || z < 1 || zs < 1 || num_chunks < 1 ||
      num_chunks > e || num_chunks > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)kSegWarps * zs * d * sizeof(float);
  const auto kernel = d == 32 ? segment_sum_kernel<32> : segment_sum_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(num_chunks > 1 ? partial : out);
  const dim3 grid((unsigned)num_chunks, (unsigned)((z + zs - 1) / zs));
  kernel<<<grid, 32 * kSegWarps, bytes, s>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids), dst, e,
      d, z, zs, num_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_chunks == 1) return (int)err;
  const long size = (long)z * d;
  segment_sum_chunks<<<(unsigned)((size + kSumCols - 1) / kSumCols),
                       kSumThreads,
                       (size_t)num_chunks * kSumCols * sizeof(float), s>>>(
      dst, static_cast<float*>(out), size, num_chunks);
  return (int)cudaGetLastError();
}

const char* ananke_cuda_error_string(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

}  // extern "C"
