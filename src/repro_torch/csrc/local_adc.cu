// K7: owner-shard gather + ADC of the sharded search (BANG §4.5 over a mesh).
//
// Replaces the TPU kernels search_step.local_adc_pallas
// (src/repro/kernels/search_step/search_step.py:492, _local_adc_kernel) and
// its beyond-VMEM twin local_adc_dma_pallas (search_step.py:524,
// _local_adc_dma_kernel). The TPU needed the twin because a shard's codes
// block had to fit VMEM or be streamed through it in tiles; here the code
// rows are gathered straight from global memory, so one kernel serves both.
//
// Each rank holds a contiguous block of n_loc code rows. For every candidate
// lane the caller passes its shard-relative id and whether this shard owns
// it; the kernel writes the lane's ADC distance where owned and 0.0f
// elsewhere, and an all-reduce (sum) over the model group rebuilds the full
// (B, R) row, exactly, since x + 0.0f = x.
//
// One thread block per query, one thread per lane (adc.cuh, lane_adc, as
// K1): an owned lane's thread reads its code row and looks its m entries up
// in the (m, 256) table in global memory, summed in the order of K1, K2 and
// the plain version (ref.local_adc_ref), so an owner's value is bit-equal to
// the single-device ADC, and the sharded traversal to the single-device one.
// Lanes that are not owned read no code row and no table entry.
//
// What bounds it on the H100: bytes. The function needs, per owned lane, the
// m table sectors (32 bytes each) its codes look up and its m code bytes,
// plus the ids, flags and outputs: about 25 MB per hop at B = 1024, R = 64,
// m = 32 on one shard (about 76% of the tables' sectors), under 8 us at
// 3.35 TB/s; on S shards each reads about 1/S of the lanes' sectors. The
// lookups read just those sectors, so a shard's time falls with the lanes it
// owns, where a copy of each query's whole 32 KB table to shared memory
// would cost every shard the full table. A block runs one thread per lane,
// up to 128, so the medoid seed (R = 1) runs one warp a query.
#include "adc.cuh"
#include "stage.cuh"

namespace {

__global__ void local_adc_kernel(const float* __restrict__ table, const uint8_t* __restrict__ codes,
                                 const int* __restrict__ rel, const bool* __restrict__ own,
                                 float* __restrict__ out, int R, int m, int n_loc) {
  const int b = blockIdx.x;
  const float* tb = table + (size_t)b * m * 256;
  const bool wide = m % 16 == 0 && aligned16(codes);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const size_t o = (size_t)b * R + r;
    float acc = 0.0f;
    if (own[o]) {
      // Clamped like the reference's gather; owned ids lie in [0, n_loc).
      const int row = min(max(rel[o], 0), n_loc - 1);
      acc = lane_adc(tb, codes + (size_t)row * m, m, wide);
    }
    out[o] = acc;
  }
}

}  // namespace

extern "C" int repro_local_adc(const void* table, const void* codes, const void* rel,
                               const void* own, void* out, int B, int R, int m, int n_loc,
                               int threads, void* stream) {
  local_adc_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const uint8_t*)codes, (const int*)rel, (const bool*)own, (float*)out,
      R, m, n_loc);
  return (int)cudaGetLastError();
}
