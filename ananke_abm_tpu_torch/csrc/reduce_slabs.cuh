// The ordered sum of per-CTA partial sums: each CTA writes its own slab of
// `size` floats with plain stores, and one launch sums the slabs in CTA
// order, so the same operands give the same bits (no atomics). The summed
// gradients of the drift's VJPs (drift_stage.cuh's slab layout), the zone
// encoder's VJP (fused_gat.cu, a slab a 32-row tile) and K5-bf16's error
// sum (fused_step.cu, one float a CTA) use it.
#pragma once

#include <cuda_runtime.h>

namespace ananke {

// out[i] = sum over CTAs, in order, of slab[c][i]
__global__ void reduce_slabs(const float* slab, float* out, long size,
                             int num_ctas) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int c = 0; c < num_ctas; ++c) s += slab[(size_t)c * size + i];
  out[i] = s;
}

inline int launch_reduce_slabs(const float* slab, float* out, long size,
                               int num_ctas, cudaStream_t s) {
  const int threads = 256;
  reduce_slabs<<<(unsigned)((size + threads - 1) / threads), threads, 0, s>>>(
      slab, out, size, num_ctas);
  return (int)cudaGetLastError();
}

}  // namespace ananke
