// Global-memory lookups of the PQ distance table: the ADC cores of K2
// (pq_adc.cu), K1 (search_step.cu) and K7 (local_adc.cu).
//
//  * warp_adc (K2 below SHARED_TABLE_MIN_R candidates): one warp per
//    candidate, lane l reading subspace l of each window of 32 and the
//    entries folded with shuffles (fold_window);
//  * lane_adc (K1, K7): one thread per candidate, the 32 entries of a window
//    all in flight at once.
//
// Both give the bits of the plain version: adc_sum's order (common.cuh),
// each chunk of REPRO_MC subspaces summed in sequence, 0.0f past m, then the
// chunks in sequence. A window of 32 subspaces holds whole chunks.
//
// Neither copies the (m, 256) table to shared memory: a query's candidates
// touch only the 32-byte sectors their codes look up, and the blocks keep no
// table-sized shared memory, so many more of them fit an SM.
#pragma once

#include "common.cuh"

static_assert(32 % REPRO_MC == 0, "a window of 32 subspaces must hold whole chunks");

// Add one window of 32 subspaces, s0 .. s0+31, to acc in adc_sum's order:
// lane l holds the entry of subspace s0 + l (0.0f past m). Every lane forms
// its chunk's sequential sum, then every lane adds the chunks in turn, so
// all lanes return the same bits.
__device__ __forceinline__ float fold_window(float acc, float v, int s0, int m, int lane) {
  const int c = lane & ~(REPRO_MC - 1);
  float part = __shfl_sync(FULL_MASK, v, c);
#pragma unroll
  for (int j = 1; j < REPRO_MC; ++j) part = part + __shfl_sync(FULL_MASK, v, c + j);
#pragma unroll
  for (int k = 0; k < 32; k += REPRO_MC)
    if (s0 + k < m) acc = acc + __shfl_sync(FULL_MASK, part, k);
  return acc;
}

// The code of subspace s0 + lane in `row`, 0 past m.
__device__ __forceinline__ int window_code(const uint8_t* row, int s0, int m, int lane) {
  const int s = s0 + lane;
  return s < m ? (int)row[s] : 0;
}

// One warp sums the m entries of one code row from the query's table `tb`.
// code0 = window_code(row, 0, m, lane), loaded by the caller so that it can
// be in flight beside its other loads. Every lane returns the sum.
__device__ __forceinline__ float warp_adc(const float* tb, const uint8_t* row, int m, int lane,
                                          int code0) {
  float acc = 0.0f;
  int code = code0;
  for (int s0 = 0; s0 < m; s0 += 32) {
    const int s = s0 + lane;
    if (s0 > 0) code = window_code(row, s0, m, lane);
    const float v = s < m ? tb[s * 256 + code] : 0.0f;
    acc = fold_window(acc, v, s0, m, lane);
  }
  return acc;
}

// One thread sums the m entries of one code row from the query's table `tb`.
// Per window of 32 subspaces: the window's codes in two 16-byte loads where
// `wide` (m % 16 == 0 and the codes 16-byte aligned, so every row is), else
// byte by byte; then its 32 table entries, all loaded before any is added.
__device__ __forceinline__ float lane_adc(const float* __restrict__ tb, const uint8_t* __restrict__ row,
                                          int m, bool wide) {
  float acc = 0.0f;
  for (int c0 = 0; c0 < m; c0 += 32) {
    uint32_t w[8];
    if (wide) {
      const uint4 lo = *reinterpret_cast<const uint4*>(row + c0);
      const uint4 hi = c0 + 16 < m ? *reinterpret_cast<const uint4*>(row + c0 + 16) : make_uint4(0, 0, 0, 0);
      w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
      w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (c0 + k < m) w[k >> 2] |= (uint32_t)row[c0 + k] << (8 * (k & 3));
    }
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int code = (w[k >> 2] >> (8 * (k & 3))) & 0xff;
      v[k] = c0 + k < m ? tb[(c0 + k) * 256 + code] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 32; c += REPRO_MC) {
      if (c0 + c < m) {
        float part = v[c];
#pragma unroll
        for (int j = 1; j < REPRO_MC; ++j) part = part + v[c + j];
        acc = acc + part;
      }
    }
  }
  return acc;
}
