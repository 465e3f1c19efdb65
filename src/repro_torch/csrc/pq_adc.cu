// K2: PQ asymmetric distances (BANG §4.5) of R candidates per query.
//
// Replaces the TPU kernel pq_adc.adc_pallas (src/repro/kernels/pq_adc/pq_adc.py:80,
// _adc_onehot_kernel and _adc_gather_kernel). On the TPU the table lookups
// became a one-hot matrix product for the MXU; on the GPU a lookup in shared
// memory is cheap, so both variant names run this one kernel.
//
// One thread block per query: the (m, 256) table goes to shared memory, then
// each thread sums one candidate's m entries in MC-subspace chunks, in the
// order of the plain version (ref.adc_ref), and writes +inf where invalid.
//
// What bounds it on the H100: bytes. The function needs, per candidate, the
// m looked-up table entries, one 32-byte sector each, plus its codes: on the
// search path (the medoid seed, R = 1) about 1 KB per query, about 1.2 MB at
// B = 1024, which is under 1 us at 3.35 TB/s. This kernel reads each block's
// whole table (32 KB at m = 32) into shared memory first, 32 times the bytes
// the function needs at R = 1, so it stands far above that bound; at large R
// the table copy pays for itself. Looking entries up straight from global
// memory when R is small is left to a later change, since this launch runs
// once per batch.
#include "common.cuh"

namespace {

__global__ void pq_adc_kernel(const float* __restrict__ table, const int* __restrict__ codes,
                              const bool* __restrict__ valid, float* __restrict__ out,
                              int R, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tbl = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x;
  const float* tb = table + (size_t)b * m * 256;
  for (int i = threadIdx.x; i < m * 256; i += blockDim.x) tbl[i] = tb[i];
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const size_t o = (size_t)b * R + r;
    const float acc = adc_sum(tbl, codes + o * m, m);
    out[o] = valid[o] ? acc : CUDART_INF_F;
  }
}

}  // namespace

extern "C" int repro_pq_adc(const void* table, const void* codes, const void* valid, void* out,
                            int B, int R, int m, int threads, void* stream) {
  const size_t smem = (size_t)m * 256 * 4;
  cudaError_t err = allow_smem(pq_adc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pq_adc_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)codes, (const bool*)valid, (float*)out, R, m);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
