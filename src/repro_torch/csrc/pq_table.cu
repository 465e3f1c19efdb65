// K8: PQ distance-table construction (BANG §4.2).
//
// Replaces the TPU kernel pq_table.dist_table_pallas
// (src/repro/kernels/pq_table/pq_table.py:56, _table_kernel), which turned
// the table into MXU products through ||q - c||^2 = ||q||^2 + ||c||^2 - 2 q.c.
// The same formula here, with dsub-long dot products (4 at d = 128, m = 32)
// that a tensor core tile would mostly pad.
//
// Every entry is
//   qn  = sum_i q_i * q_i,   cn = sum_i c_i * c_i,   qc = sum_i q_i * c_i,
// each a sequential float32 sum over i = 0..dsub-1 of rounded products
// (built with --fmad=false, so no product is fused into its add), then
//   out = (qn + cn) - 2 * qc.
// The plain version (kernels/pq_table/ref.py, dist_table_ref) takes the same
// sums in the same order, so the kernel is bit-equal to it in both regimes.
//
// What bounds it on the H100: bytes. The output is (B, m, 256) f32, 33.5 MB
// at B = 1024, m = 32, about 10 us at 3.35 TB/s; the inputs are under 1 MB
// and the work is about 6 * dsub operations per entry. Two regimes, chosen
// by the wrapper from dsub:
//   * the tile regime (dsub <= 16), as the reference's (m, B / BQ) grid: a
//     block of 64 threads takes one subspace j and tiles of `queries`
//     queries. Each thread owns 4 consecutive centroids, loads their
//     codebook rows into registers and computes their norms once; then, for
//     each query of the tile (staged in shared memory, read as a broadcast),
//     it computes qn and its four qc and writes the four entries as one
//     16-byte store, a warp 512 contiguous bytes. Output row (b, j) starts at
//     a multiple of 1 KB of the wrapper's buffer, so the stores are aligned;
//     the inputs are read with scalar loads, so they need no alignment. The
//     grid is m x ceil(B / queries) blocks (capped at 65,535 in y, a block
//     then looping over several tiles with its codebook rows kept), so each
//     subspace's codebook slice is read ceil(B / queries) times, not B times
//     as one block per (query, subspace) would;
//   * the general regime (dsub > 16, whose rows the registers cannot hold):
//     one block per (query, subspace), one thread per centroid, each thread
//     reading its codebook row and writing 4 bytes.
#include "common.cuh"

namespace {

// Most dimensions a subspace may have for the tile regime.
constexpr int TILE_MAX_DSUB = 16;

// The tile regime for dsub <= DS: blockIdx.x = subspace j, threads 0..63
// own centroids 4 * threadIdx.x .. + 3, blockIdx.y walks the query tiles.
template <int DS>
__global__ void __launch_bounds__(64) pq_table_tile_kernel(
    const float* __restrict__ q, const float* __restrict__ cb, float* __restrict__ out, int B,
    int m, int dsub, int queries) {
  extern __shared__ float qs[];   // the tile's query slices, queries * dsub
  const int j = blockIdx.x;
  const int c0 = 4 * threadIdx.x;
  const float* cv = cb + ((size_t)j * 256 + c0) * dsub;
  float x[4][DS];
  float cn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cn[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      x[k][i] = i < dsub ? cv[k * dsub + i] : 0.0f;
      if (i < dsub) cn[k] = cn[k] + x[k][i] * x[k][i];
    }
  }
  const int tiles = (B + queries - 1) / queries;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int b0 = tile * queries;
    const int nq = min(queries, B - b0);
    __syncthreads();   // the previous tile's queries are read
    for (int e = threadIdx.x; e < nq * dsub; e += blockDim.x) {
      const int qb = e / dsub;
      qs[e] = q[((size_t)(b0 + qb) * m + j) * dsub + (e - qb * dsub)];
    }
    __syncthreads();
    for (int qb = 0; qb < nq; ++qb) {
      const float* qv = qs + qb * dsub;
      float qn = 0.0f;
      float qc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        if (i < dsub) {
          const float a = qv[i];
          qn = qn + a * a;
#pragma unroll
          for (int k = 0; k < 4; ++k) qc[k] = qc[k] + a * x[k][i];
        }
      }
      float4 o;
      o.x = (qn + cn[0]) - 2.0f * qc[0];
      o.y = (qn + cn[1]) - 2.0f * qc[1];
      o.z = (qn + cn[2]) - 2.0f * qc[2];
      o.w = (qn + cn[3]) - 2.0f * qc[3];
      reinterpret_cast<float4*>(out + ((size_t)(b0 + qb) * m + j) * 256)[threadIdx.x] = o;
    }
  }
}

// The general regime: one block per (query, subspace), one thread per
// centroid.
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

template <int DS>
cudaError_t launch_tile(const float* q, const float* cb, float* out, int B, int m, int dsub,
                        int queries, cudaStream_t st) {
  const size_t smem = (size_t)queries * dsub * 4;
  const cudaError_t err = allow_smem(pq_table_tile_kernel<DS>, smem);
  if (err != cudaSuccess) return err;
  const int grid_y = min((B + queries - 1) / queries, 65535);
  pq_table_tile_kernel<DS><<<dim3(m, grid_y), 64, smem, st>>>(q, cb, out, B, m, dsub, queries);
  return cudaGetLastError();
}

}  // namespace

// queries >= 1: the tile regime (dsub <= 16), `queries` queries a tile;
// queries = 0: the general regime.
extern "C" int repro_pq_table(const void* q, const void* cb, void* out, int B, int m, int dsub,
                              int queries, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* cbf = (const float*)cb;
  float* of = (float*)out;
  if (queries == 0) {
    const long long blocks = (long long)B * m;
    pq_table_kernel<<<(unsigned)blocks, 256, 0, st>>>(qf, cbf, of, m, dsub);
    return (int)cudaGetLastError();
  }
  if (queries < 0 || dsub > TILE_MAX_DSUB) return (int)cudaErrorInvalidValue;
  if (dsub <= 4) return (int)launch_tile<4>(qf, cbf, of, B, m, dsub, queries, st);
  if (dsub <= 8) return (int)launch_tile<8>(qf, cbf, of, B, m, dsub, queries, st);
  return (int)launch_tile<16>(qf, cbf, of, B, m, dsub, queries, st);
}
