// The bitonic network of common.cuh (bitonic_stage, bitonic_network) run by
// one warp on a row held in its registers: the warp regime of K1, K4 and K6.
//
// It is the same network, so it gives the same bits on every input, ties
// included: the pairs (a, a ^ j), the stages in the same order over k and j,
// ascending iff (a & k) == 0, the comparison key_gt, equal keys swapping in
// descending pairs, the payload riding along. Only the data's home differs:
// element q of a row lives in lane q % 32, register q / 32 of E registers a
// lane. A stage with j >= 32 exchanges two registers of one thread; a stage
// with j < 32 trades with lane ^ j by __shfl_xor_sync, both lanes of a pair
// computing the same swap from the same two keys. E is a template parameter
// and every loop over registers and stages unrolls, so the arrays stay in
// registers. A row of n < 32 elements holds lanes 0 .. n-1 of register 0;
// the other lanes pair only among themselves and their values are not used.
// No __syncthreads and no shared memory.
#pragma once

#include "common.cuh"

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// Elements a lane holds for a row of n <= 512 (a power of two).
__host__ __device__ constexpr int lane_elems(int n) { return n <= 32 ? 1 : n / 32; }

// One stage (j, k) over the first n elements of the row (n a power of two,
// j < n <= 32 * E). Whole registers past n are left alone; the payload v is
// used only where PAYLOAD.
template <int E, bool PAYLOAD>
__device__ __forceinline__ void warp_stage(float (&d)[E], int (&id)[E], int (&v)[E], int j, int k,
                                           int n, int lane) {
  if (j >= 32) {
    const int jr = j >> 5;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if ((r & jr) == 0 && (r << 5) < n) {
        const int s = r | jr;
        // a = 32 r + lane and k >= 2 j >= 64, so bit k of a is bit k of 32 r.
        const bool asc = ((r << 5) & k) == 0;
        const bool gt = key_gt(d[r], id[r], d[s], id[s]);
        if (asc ? gt : !gt) {
          const float td = d[r]; d[r] = d[s]; d[s] = td;
          const int ti = id[r]; id[r] = id[s]; id[s] = ti;
          if (PAYLOAD) { const int tv = v[r]; v[r] = v[s]; v[s] = tv; }
        }
      }
    }
  } else {
    const bool upper = (lane & j) != 0;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if ((r << 5) < n) {
        const float pd = __shfl_xor_sync(FULL_MASK, d[r], j);
        const int pi = __shfl_xor_sync(FULL_MASK, id[r], j);
        const int pv = PAYLOAD ? __shfl_xor_sync(FULL_MASK, v[r], j) : 0;
        // The pair's lower element a and this element differ in bit j only,
        // and k != j, so bit k of a is bit k of this element's index.
        const bool asc = (((r << 5) | lane) & k) == 0;
        const bool gt = upper ? key_gt(pd, pi, d[r], id[r]) : key_gt(d[r], id[r], pd, pi);
        if (asc ? gt : !gt) {
          d[r] = pd;
          id[r] = pi;
          if (PAYLOAD) v[r] = pv;
        }
      }
    }
  }
}

// The whole network over the first n elements (every k = 2..n) or, for a
// bitonic input, its final merge phase only (k = n). n is a power of two,
// n <= 32 * E, the same for every lane.
template <int E, bool PAYLOAD>
__device__ __forceinline__ void warp_bitonic(float (&d)[E], int (&id)[E], int (&v)[E], int n,
                                             bool full_sort, int lane) {
  constexpr int LOG = ilog2(32 * E);
#pragma unroll
  for (int lk = 1; lk <= LOG; ++lk) {
    const int k = 1 << lk;
    if (k <= n && (full_sort || k == n)) {
#pragma unroll
      for (int lj = lk - 1; lj >= 0; --lj) warp_stage<E, PAYLOAD>(d, id, v, 1 << lj, k, n, lane);
    }
  }
}
