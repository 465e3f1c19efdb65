// K4 and K5: the staged mode's bitonic sort of the candidate lists (BANG
// §4.7) and their merge into the worklist (§4.8).
//
// Replace the TPU kernels bitonic.sort_kv_pallas (_sort_kernel) and
// bitonic.merge_pallas (_merge_kernel), src/repro/kernels/bitonic/bitonic.py.
// The Pallas kernels ran the network as reshapes and selects over (8, n)
// tiles in VMEM; here the same compare-exchange stages run in one of two
// regimes, chosen by the wrapper from the padded row p:
//   * the warp regime (p <= 512): one warp per row holds the row in
//     registers, lane_elems(p) elements a lane, and runs the network of
//     warp_bitonic.cuh (register exchanges for j >= 32, shuffles below);
//     several rows a block, loads and stores coalesced, no barrier and no
//     shared memory;
//   * the block regime (p > 512): one block per row keeps the row in shared
//     memory and runs bitonic_network (common.cuh, shared with the fused
//     hop's block regime), one thread per pair, a barrier after each stage.
// Both run the same network, so both give the plain version's bits.
//
// Sort: the row is padded to p = next_pow2(n) with (+inf, INVALID) and the
// whole network runs (log2(p) (log2(p) + 1) / 2 stages).
//
// Merge: as merge_pallas, list 2 (the R sorted candidates, unvisited) is
// padded with (+inf, INVALID, unvisited) to p - t entries *before* it is
// reversed behind the t-worklist; the sequence is bitonic, so only the final
// merge phase runs (log2(p) stages), and the first t slots are kept. The
// worklist's pads carry visited = 1, the candidates' pads 0; ties between
// them fall where the network puts them, which the plain version
// (kernels/bitonic/ref.py) reproduces. No slot is forced visited here
// (unlike the fused hop's tail). The candidates come in sorted, so merge
// slot x >= p - R reads candidate p - 1 - x straight from global memory:
// 32 neighbouring lanes read 32 neighbouring entries, in reverse.
//
// What bounds them on the H100: bytes, and far below what one launch
// costs. At B = 1024, n = 64 the sort reads and writes 1 MB (about 0.3 us at
// 3.35 TB/s); the merge reads 1.3 MB and writes 0.6 MB. Compare-exchanges
// are cheap. In the warp regime the sort's 21 stages and the merge's 7 run
// in registers, so a launch costs little above the launch itself.
#include "common.cuh"
#include "warp_bitonic.cuh"

namespace {

// K4, the warp regime: one warp per row, p = next_pow2(n) <= 512 (E =
// lane_elems(p)), several rows a block.
template <int E>
__global__ void warp_sort_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                                 float* __restrict__ out_d, int* __restrict__ out_i, int B, int n,
                                 int p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)b * n;
  float d[E];
  int id[E], no_payload[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = (r << 5) | lane;
    d[r] = q < n ? dists[row + q] : CUDART_INF_F;
    id[r] = q < n ? ids[row + q] : REPRO_INVALID;
  }
  warp_bitonic<E, false>(d, id, no_payload, p, true, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int q = (r << 5) | lane;
    if (q < n) {
      out_d[row + q] = d[r];
      out_i[row + q] = id[r];
    }
  }
}

// K4, the block regime: one block per row, the row in shared memory.
__global__ void bitonic_sort_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                                    float* __restrict__ out_d, int* __restrict__ out_i,
                                    int n, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d = reinterpret_cast<float*>(smem);
  int* id = reinterpret_cast<int*>(d + p);
  const size_t row = (size_t)blockIdx.x * n;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    d[q] = q < n ? dists[row + q] : CUDART_INF_F;
    id[q] = q < n ? ids[row + q] : REPRO_INVALID;
  }
  __syncthreads();
  bitonic_network(d, id, nullptr, p, true);
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    out_d[row + q] = d[q];
    out_i[row + q] = id[q];
  }
}

// K5, the warp regime: one warp per merge row, p = next_pow2(t + R) <= 512
// (E = lane_elems(p)), several rows a block. Slot x of the row lives in lane
// x % 32, register x / 32: the worklist in [0, t), list 2 reversed in
// [t, p). Lanes past p (p < 32) hold inert pads and store nothing.
template <int E>
__global__ void warp_merge_kernel(const float* __restrict__ wld, const int* __restrict__ wli,
                                  const bool* __restrict__ wlv, const float* __restrict__ cd,
                                  const int* __restrict__ ci, float* __restrict__ owd,
                                  int* __restrict__ owi, bool* __restrict__ owv, int B, int t,
                                  int R, int p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t wrow = (size_t)b * t, crow = (size_t)b * R;
  float d[E];
  int id[E], v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int x = (r << 5) | lane;
    const int s = p - 1 - x;  // entry of the padded list 2 held at x >= t
    if (x < t) {
      d[r] = wld[wrow + x];
      id[r] = wli[wrow + x];
      v[r] = wlv[wrow + x] ? 1 : 0;
    } else {
      const bool cand = s >= 0 && s < R;
      d[r] = cand ? cd[crow + s] : CUDART_INF_F;
      id[r] = cand ? ci[crow + s] : REPRO_INVALID;
      v[r] = 0;
    }
  }
  warp_bitonic<E, true>(d, id, v, p, false, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int x = (r << 5) | lane;
    if (x < t) {
      owd[wrow + x] = d[r];
      owi[wrow + x] = id[r];
      owv[wrow + x] = v[r] != 0;
    }
  }
}

// K5, the block regime: one block per row, the row in shared memory.
__global__ void bitonic_merge_kernel(const float* __restrict__ wld, const int* __restrict__ wli,
                                     const bool* __restrict__ wlv, const float* __restrict__ cd,
                                     const int* __restrict__ ci, float* __restrict__ owd,
                                     int* __restrict__ owi, bool* __restrict__ owv,
                                     int t, int R, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d = reinterpret_cast<float*>(smem);
  int* id = reinterpret_cast<int*>(d + p);
  int* v = id + p;
  const size_t b = blockIdx.x;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    if (q < t) {
      d[q] = wld[b * t + q];
      id[q] = wli[b * t + q];
      v[q] = wlv[b * t + q] ? 1 : 0;
    } else {
      const int s = p - 1 - q;  // entry of the padded list 2 held at q
      d[q] = s < R ? cd[b * R + s] : CUDART_INF_F;
      id[q] = s < R ? ci[b * R + s] : REPRO_INVALID;
      v[q] = 0;
    }
  }
  __syncthreads();
  bitonic_network(d, id, v, p, false);
  for (int q = threadIdx.x; q < t; q += blockDim.x) {
    owd[b * t + q] = d[q];
    owi[b * t + q] = id[q];
    owv[b * t + q] = v[q] != 0;
  }
}

}  // namespace

// rows = 1..8: the warp regime (p <= 512), `rows` rows a block; rows = 0:
// the block regime, one row a block of `threads`.
extern "C" int repro_bitonic_sort(const void* dists, const void* ids, void* out_d, void* out_i,
                                  int B, int n, int p, int threads, int rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    const size_t smem = (size_t)p * 8;
    cudaError_t err = allow_smem(bitonic_sort_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    bitonic_sort_kernel<<<B, threads, smem, st>>>(
        (const float*)dists, (const int*)ids, (float*)out_d, (int*)out_i, n, p);
    return (int)cudaGetLastError();
  }
  if (rows < 0 || rows > 8) return (int)cudaErrorInvalidValue;
  const int blocks = (B + rows - 1) / rows;
  switch (p > 512 ? 0 : lane_elems(p)) {
#define REPRO_CASE(E)                                                                    \
  case E:                                                                                \
    warp_sort_kernel<E><<<blocks, 32 * rows, 0, st>>>((const float*)dists, (const int*)ids, \
                                                       (float*)out_d, (int*)out_i, B, n, p); \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(4) REPRO_CASE(8) REPRO_CASE(16)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows = 1..8: the warp regime (p <= 512), `rows` rows a block; rows = 0:
// the block regime, one row a block of `threads`.
extern "C" int repro_bitonic_merge(const void* wld, const void* wli, const void* wlv,
                                   const void* cd, const void* ci,
                                   void* owd, void* owi, void* owv,
                                   int B, int t, int R, int p, int threads, int rows,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) {
    const size_t smem = (size_t)p * 12;
    cudaError_t err = allow_smem(bitonic_merge_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    bitonic_merge_kernel<<<B, threads, smem, st>>>(
        (const float*)wld, (const int*)wli, (const bool*)wlv, (const float*)cd, (const int*)ci,
        (float*)owd, (int*)owi, (bool*)owv, t, R, p);
    return (int)cudaGetLastError();
  }
  if (rows < 0 || rows > 8) return (int)cudaErrorInvalidValue;
  const int blocks = (B + rows - 1) / rows;
  switch (p > 512 ? 0 : lane_elems(p)) {
#define REPRO_CASE(E)                                                                         \
  case E:                                                                                     \
    warp_merge_kernel<E><<<blocks, 32 * rows, 0, st>>>(                                       \
        (const float*)wld, (const int*)wli, (const bool*)wlv, (const float*)cd, (const int*)ci, \
        (float*)owd, (int*)owi, (bool*)owv, B, t, R, p);                                       \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(4) REPRO_CASE(8) REPRO_CASE(16)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
