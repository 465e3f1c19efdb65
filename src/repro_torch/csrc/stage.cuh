// Block-wide staging of global memory into shared memory with cp.async
// (K2's shared-table regime and K3's candidate tiles). The copies run
// asynchronously: a block issues them all, does other work, then waits with
// stage_wait() followed by __syncthreads().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Wait for every cp.async this thread issued; a __syncthreads() after it
// makes the whole block's copies visible.
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Close the group of copies issued so far; stage_wait_group<N>() waits until
// at most the N groups closed last are still in flight.
__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void stage_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Copy `bytes` contiguous bytes to `dst` (16-byte aligned) with the whole
// block: 16-byte copies in flight from every thread where the source and the
// length allow them, else one byte per load (odd shapes only).
__device__ __forceinline__ void stage_bytes(void* dst, const void* src, int bytes) {
  if (aligned16(src) && bytes % 16 == 0) {
    for (int k = threadIdx.x; k < bytes / 16; k += blockDim.x)
      cp_async16(static_cast<char*>(dst) + 16 * k, static_cast<const char*>(src) + 16 * k);
  } else {
    for (int k = threadIdx.x; k < bytes; k += blockDim.x)
      static_cast<unsigned char*>(dst)[k] = static_cast<const unsigned char*>(src)[k];
  }
}

// Copy columns [lo, hi) of `rows` contiguous rows of d floats to `dst`
// (16-byte aligned) at a row stride of `stride` floats (a multiple of 4):
// 16-byte copies where the source, d and lo allow them, else 4-byte copies;
// consecutive threads take consecutive addresses, so the reads coalesce.
// A caller whose slice is always 4 * W4 columns wide passes W4, so that the
// chunk index splits by a constant and not by a division at run time.
template <int W4 = 0>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int d, int stride,
                                           int lo, int hi) {
  if (aligned16(src) && d % 4 == 0 && lo % 4 == 0) {
    const int w4 = W4 > 0 ? W4 : (hi - lo) / 4;
    for (int k = threadIdx.x; k < rows * w4; k += blockDim.x) {
      const int r = k / w4, c = lo + 4 * (k - r * w4);
      cp_async16(dst + r * stride + c, src + r * d + c);
    }
  } else {
    const int w = hi - lo;
    for (int k = threadIdx.x; k < rows * w; k += blockDim.x) {
      const int r = k / w, c = lo + (k - r * w);
      cp_async4(dst + r * stride + c, src + r * d + c);
    }
  }
}
