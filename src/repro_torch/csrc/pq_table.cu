// K8: PQ distance-table construction (BANG §4.2).
//
// Replaces the TPU kernel pq_table.dist_table_pallas
// (src/repro/kernels/pq_table/pq_table.py:56, _table_kernel), which turned
// the table into MXU products through ||q - c||^2 = ||q||^2 + ||c||^2 - 2 q.c.
// The same formula here, with dsub-long dot products (4 at d = 128, m = 32)
// that a tensor core tile would mostly pad.
//
// One thread block per (query, subspace), one thread per centroid c:
//   qn  = sum_i q_i * q_i,   cn = sum_i c_i * c_i,   qc = sum_i q_i * c_i,
// each a sequential float32 sum over i = 0..dsub-1 of rounded products
// (built with --fmad=false, so no product is fused into its add), then
//   out = (qn + cn) - 2 * qc.
// The plain version (kernels/pq_table/ref.py, dist_table_ref) takes the same
// sums in the same order, so the two are bit-equal.
//
// What bounds it on the H100: bytes. The output is (B, m, 256) f32, 33.5 MB
// at B = 1024, m = 32, about 10 us at 3.35 TB/s; the inputs are under 1 MB
// and the work is about 6 * dsub operations per entry. A block's 256 threads
// write 1 KB of neighbouring addresses, so the writes are coalesced; each
// thread's query row is the same for the whole block (a broadcast from L1).
#include "common.cuh"

namespace {

__global__ void pq_table_kernel(const float* __restrict__ q, const float* __restrict__ cb,
                                float* __restrict__ out, int m, int dsub) {
  const int bj = blockIdx.x;            // b * m + j
  const int j = bj % m;
  const int c = threadIdx.x;            // centroid, blockDim.x == 256
  const float* qv = q + (size_t)bj * dsub;
  const float* cv = cb + ((size_t)j * 256 + c) * dsub;
  float qn = 0.0f, cn = 0.0f, qc = 0.0f;
  for (int i = 0; i < dsub; ++i) {
    const float a = qv[i];
    const float x = cv[i];
    qn = qn + a * a;
    cn = cn + x * x;
    qc = qc + a * x;
  }
  out[(size_t)bj * 256 + c] = (qn + cn) - 2.0f * qc;
}

}  // namespace

extern "C" int repro_pq_table(const void* q, const void* cb, void* out, int B, int m, int dsub,
                              void* stream) {
  const long long blocks = (long long)B * m;
  pq_table_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)cb, (float*)out, m, dsub);
  return (int)cudaGetLastError();
}
