// K3: exact squared L2 for the re-rank (BANG §4.9).
//
// Replaces the TPU kernel rerank_l2.exact_sq_dists_pallas
// (src/repro/kernels/rerank_l2/rerank_l2.py:38, _rerank_kernel), which took
// the candidate dot products on the MXU. The result is the reference's
// formula ||q||^2 + ||v||^2 - 2<v,q>, which cancels: two orders of summation
// disagree by about 1e-5 at the norms of real descriptors. So the kernel sums
// in the order of the plain version (ref.exact_sq_dists_ref), which is the
// reference's on its CPU backend: sequential norms, and the dot product in 8
// strided fused-multiply-add partials (float64 product and sum rounded to
// float32) folded pairwise. The sequential norms leave no parallelism inside
// one pair, so one thread scores one (query, candidate) pair.
//
// What bounds it on the H100: bytes. The candidate vectors, (B, C, d) f32,
// are read once (about 54 MB at B = 1024, C = 104, d = 128, about 16 us at
// 3.35 TB/s); the flops are few. A thread walks its own 512-byte row, so a
// warp's loads are not coalesced: each load touches 32 lines, and L1 serves
// the following 7 loads of each line. A layout in which a warp reads
// neighbouring addresses (candidates transposed in shared memory) would
// reach the bound; that is left to a later change.
#include "common.cuh"

namespace {

__global__ void rerank_l2_kernel(const float* __restrict__ q, const float* __restrict__ v,
                                 float* __restrict__ out, int B, int C, int d) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= (long long)B * C) return;
  const float* qb = q + (size_t)(pair / C) * d;
  const float* vb = v + (size_t)pair * d;
  float qq = 0.0f, vv = 0.0f;
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < d; i0 += 8) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int i = i0 + l;
      if (i < d) {
        const float a = qb[i];
        const float x = vb[i];
        qq = qq + a * a;
        vv = vv + x * x;
        part[l] = (float)((double)part[l] + (double)x * (double)a);
      }
    }
  }
  const float p0 = part[0] + part[4], p1 = part[1] + part[5];
  const float p2 = part[2] + part[6], p3 = part[3] + part[7];
  const float vq = (p0 + p2) + (p1 + p3);
  out[pair] = (qq + vv) - 2.0f * vq;
}

}  // namespace

extern "C" int repro_rerank_l2(const void* q, const void* v, void* out, int B, int C, int d,
                               int threads, void* stream) {
  const long long blocks = ((long long)B * C + threads - 1) / threads;
  rerank_l2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)v, (float*)out, B, C, d);
  return (int)cudaGetLastError();
}
