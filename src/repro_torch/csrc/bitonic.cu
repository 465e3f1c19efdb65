// K4 and K5: the staged mode's bitonic sort of the candidate lists (BANG
// §4.7) and their merge into the worklist (§4.8).
//
// Replace the TPU kernels bitonic.sort_kv_pallas (_sort_kernel) and
// bitonic.merge_pallas (_merge_kernel), src/repro/kernels/bitonic/bitonic.py.
// The Pallas kernels ran the network as reshapes and selects over (8, n)
// tiles in VMEM; here one thread block takes one row, keeps it in shared
// memory and runs the same compare-exchange stages (bitonic_network in
// common.cuh, shared with the fused hop), one thread per pair, a barrier
// after each stage.
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
// (kernels/bitonic/ref.py) reproduces. No slot is forced visited here.
//
// What bounds them on the H100: bytes, and far below what one launch
// costs. At B = 1024, n = 64 the sort reads and writes 1 MB (about 0.3 us at
// 3.35 TB/s); the merge reads 1.3 MB and writes 0.6 MB. Compare-exchanges
// are cheap; the 21 (sort) and 7 (merge) barrier-separated stages with few
// warps per block leave each SM waiting on shared memory and barriers, so
// these simple kernels stand well above the bound. Warp-level networks with
// several rows per block are a later change.
#include "common.cuh"

namespace {

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

extern "C" int repro_bitonic_sort(const void* dists, const void* ids, void* out_d, void* out_i,
                                  int B, int n, int p, int threads, void* stream) {
  const size_t smem = (size_t)p * 8;
  cudaError_t err = allow_smem(bitonic_sort_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bitonic_sort_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)dists, (const int*)ids, (float*)out_d, (int*)out_i, n, p);
  return (int)cudaGetLastError();
}

extern "C" int repro_bitonic_merge(const void* wld, const void* wli, const void* wlv,
                                   const void* cd, const void* ci,
                                   void* owd, void* owi, void* owv,
                                   int B, int t, int R, int p, int threads, void* stream) {
  const size_t smem = (size_t)p * 12;
  cudaError_t err = allow_smem(bitonic_merge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bitonic_merge_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)wld, (const int*)wli, (const bool*)wlv, (const float*)cd, (const int*)ci,
      (float*)owd, (int*)owi, (bool*)owv, t, R, p);
  return (int)cudaGetLastError();
}
