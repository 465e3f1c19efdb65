// Device helpers shared by the search kernels: the chunked ADC sum and the
// bitonic compare-exchange network in shared memory (the block regime; the
// warp regime runs the same network in registers, warp_bitonic.cuh). Both
// follow the arithmetic and the comparison rule of the plain PyTorch
// versions exactly (the library is built with --fmad=false), so the kernels
// are bit-equal to them.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define REPRO_INVALID 0x7fffffff

// Every lane of a warp, for the *_sync intrinsics.
constexpr unsigned FULL_MASK = 0xffffffffu;

// Subspaces summed per chunk: the ADC sum is the sum over chunks of the
// sequential sum of MC table entries (src/repro/kernels/pq_adc/pq_adc.py:31,
// onehot_adc_accumulate). Subspaces past m contribute 0.0f, as the zero table
// rows of the reference's m padding do.
#define REPRO_MC 8

template <typename CodeT>
__device__ __forceinline__ float adc_sum(const float* tbl, const CodeT* code, int m) {
  float acc = 0.0f;
  for (int c = 0; c < m; c += REPRO_MC) {
    float part = tbl[c * 256 + (int)code[c]];
#pragma unroll
    for (int j = 1; j < REPRO_MC; ++j) {
      const int s = c + j;
      const float v = s < m ? tbl[s * 256 + (int)code[s]] : 0.0f;
      part = part + v;
    }
    acc = acc + part;
  }
  return acc;
}

// (dist, id) lexicographic "greater than" (src/repro/kernels/bitonic/bitonic.py:57).
__device__ __forceinline__ bool key_gt(float da, int ia, float db, int ib) {
  return (da > db) || (da == db && ia > ib);
}

// One stage of the bitonic network over n elements in shared memory: the
// partner of index a is a ^ j, and the pair sorts ascending iff bit k of a is
// 0. Equal keys swap in descending pairs, as in the reference network. The
// payload v (may be null) rides along. Ends with a block barrier.
__device__ __forceinline__ void bitonic_stage(float* d, int* id, int* v, int n, int j, int k) {
  for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
    const int a = 2 * j * (p / j) + (p % j);
    const int b = a + j;
    const bool asc = (a & k) == 0;
    const bool gt = key_gt(d[a], id[a], d[b], id[b]);
    if (asc ? gt : !gt) {
      const float td = d[a]; d[a] = d[b]; d[b] = td;
      const int ti = id[a]; id[a] = id[b]; id[b] = ti;
      if (v != nullptr) { const int tv = v[a]; v[a] = v[b]; v[b] = tv; }
    }
  }
  __syncthreads();
}

// Full sort (every k = 2..n) or, for a bitonic input, the final merge phase
// only (k = n). n is a power of two. Call with the inputs already visible to
// the whole block.
__device__ __forceinline__ void bitonic_network(float* d, int* id, int* v, int n, bool full_sort) {
  for (int k = full_sort ? 2 : n; k <= n; k *= 2)
    for (int j = k / 2; j >= 1; j /= 2) bitonic_stage(d, id, v, n, j, k);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
// Beyond the device's limit (227 KB on the H100) this returns
// cudaErrorInvalidValue, which the Python wrapper raises. The refusal also
// sets the runtime's last error, which is cleared here: left set, the next
// launch of any kernel would read it back as its own.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}
