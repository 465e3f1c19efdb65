// K2: PQ asymmetric distances (BANG §4.5) of R candidates per query.
//
// Replaces the TPU kernel pq_adc.adc_pallas (src/repro/kernels/pq_adc/pq_adc.py:80,
// _adc_onehot_kernel and _adc_gather_kernel). On the TPU the table lookups
// became a one-hot matrix product for the MXU; on the GPU a lookup is a load,
// so both variant names run this kernel.
//
// What bounds it on the H100: bytes. The function needs, per valid candidate,
// the m looked-up table entries (one 32-byte sector each) and its m codes.
// Two regimes, chosen by the wrapper from R (kernels/pq_adc/ops.py,
// SHARED_TABLE_MIN_R = 40, where the shared table first beats the global
// lookups in chip_smoke.py's sweep over R on the H100 at B = 1024, m = 32):
//
//  * small R (the medoid seed, R = 1): one warp per candidate looks its m
//    entries up straight from the table in global memory, lane j taking
//    subspace j, so a query reads about 1 KB and not its whole 32 KB table.
//    The code load and the table load are the only two memory round trips;
//    at R = 1 a launch's own time is more than the bytes need.
//  * large R (the staged mode, R = 64): the fresh candidates touch most of
//    the table's sectors (75.6% at B = 1024, R = 64, m = 32), so one block
//    per query copies its whole table, its codes and its valid flags into
//    shared memory with 16-byte cp.async copies, all in flight at once
//    (stage.cuh); then each thread sums one candidate from there. The table
//    copy streams at the memory's rate, and about six 34 KB blocks fit an
//    SM, so the copies of several queries overlap.
//
// Both regimes fold the m entries of a candidate in the order of the plain
// version (ref.adc_ref, core/pq.py adc_sum, csrc/common.cuh adc_sum): each
// chunk of REPRO_MC subspaces summed in sequence, 0.0f past m, then the
// chunks in sequence. In the global regime the lanes' values are gathered
// with shuffles and added in that order (no tree), so both regimes are
// bit-equal to the plain version. The global lookups are adc.cuh's
// warp_adc, shared with K1 and K7.
// Codes are uint8, the index's own type (the wrapper converts others).
#include "adc.cuh"
#include "stage.cuh"

namespace {

// Small R: one warp per (query, candidate), the table read in place.
__global__ void adc_global_kernel(const float* __restrict__ table, const uint8_t* __restrict__ codes,
                                  const bool* __restrict__ valid, float* __restrict__ out,
                                  long long pairs, int R, int m) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= pairs) return;                      // the whole warp leaves
  const uint8_t* cw = codes + (size_t)w * m;
  // The flag and the first window's code are loaded together; an invalid
  // candidate reads no table entry.
  const bool ok = valid[w];
  const int code = window_code(cw, 0, m, lane);
  const float acc = ok ? warp_adc(table + (size_t)(w / R) * m * 256, cw, m, lane, code) : CUDART_INF_F;
  if (lane == 0) out[w] = acc;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Large R: one block per query, table, codes and flags staged in shared
// memory, one thread per candidate summing with adc_sum (K1's and K7's sum).
__global__ void adc_shared_kernel(const float* __restrict__ table, const uint8_t* __restrict__ codes,
                                  const bool* __restrict__ valid, float* __restrict__ out,
                                  int R, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const size_t tbytes = (size_t)m * 256 * 4, cbytes = (size_t)R * m;
  float* tbl = reinterpret_cast<float*>(smem);
  uint8_t* cs = smem + tbytes;
  bool* vs = reinterpret_cast<bool*>(smem + tbytes + align16(cbytes));
  stage_bytes(tbl, table + (size_t)b * m * 256, (int)tbytes);
  stage_bytes(cs, codes + (size_t)b * R * m, (int)cbytes);
  for (int r = threadIdx.x; r < R; r += blockDim.x) vs[r] = valid[(size_t)b * R + r];
  stage_wait();
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    out[(size_t)b * R + r] = vs[r] ? adc_sum(tbl, cs + (size_t)r * m, m) : CUDART_INF_F;
}

}  // namespace

// shared_table: 0 for the global-lookup regime, 1 for the shared-table one.
// threads: a multiple of 32.
extern "C" int repro_pq_adc(const void* table, const void* codes, const void* valid, void* out,
                            int B, int R, int m, int shared_table, int threads, void* stream) {
  const float* t = (const float*)table;
  const uint8_t* c = (const uint8_t*)codes;
  const bool* v = (const bool*)valid;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!shared_table) {
    const long long pairs = (long long)B * R;
    const long long blocks = (pairs * 32 + threads - 1) / threads;
    adc_global_kernel<<<(unsigned)blocks, threads, 0, s>>>(t, c, v, o, pairs, R, m);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)m * 256 * 4 + align16((size_t)R * m) + align16(R);
  cudaError_t err = allow_smem(adc_shared_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adc_shared_kernel<<<B, threads, smem, s>>>(t, c, v, o, R, m);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
