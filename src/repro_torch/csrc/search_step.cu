// K1: one whole Algorithm-2 hop per query (BANG §4.5-§4.8) in one kernel,
// and K6, the same hop on distances computed outside the kernel.
//
// Replaces the TPU kernels search_step.fused_step_pallas
// (src/repro/kernels/search_step/search_step.py:293, _fused_step_kernel and
// _traverse_math) and its beyond-VMEM twin fused_step_dma_pallas
// (search_step.py:365, _dma_tiled_adc). The TPU needed the twin because the
// codes block had to fit VMEM or be streamed through it; on the GPU the code
// rows are gathered straight from global memory, so one kernel serves both.
//
// Per query (one thread block, the paper's mapping):
//   1. the t-worklist goes to shared memory;
//   2. ADC: one thread per fresh candidate gathers its code row and looks
//      its m entries up in the (m, 256) PQ distance table in global memory
//      (adc.cuh, lane_adc), all of a window's 32 loads in flight at once,
//      summed in MC-subspace chunks;
//   3. the next_pow2(R) candidates are sorted by (dist, id) with a bitonic
//      network in shared memory, padded with (+inf, INVALID);
//   4. eager selection (§4.6) reads the pre-merge worklist;
//   5. worklist ++ reversed candidates is bitonic, so only the final merge
//      phase runs (P = next_pow2(t + Rp)); INVALID slots are forced visited;
//   6. lazy selection reads the merged worklist; the chosen id is marked
//      visited.
//
// What bounds it on the H100: bytes. Per hop the function needs, per query,
// the table sectors (32 bytes each) that the fresh candidates' codes look
// up, the fresh code rows (m bytes each) and the worklist in and out. With
// F fresh candidates a subspace's 32 sectors are each touched with
// probability 1 - (31/32)^F, about 76% of the 32 KB table at F = 45 (m = 32),
// so the table still dominates: about 25 MB per hop at B = 1024, about 8 us
// at 3.35 TB/s, against about 1.5 MB of code rows. Operations are few (R*m
// adds, O(P log^2 P) compare-exchanges). The lookups read only the sectors
// the codes need, each fresh candidate's in two dependent round trips
// (its code row, then its entries), and every intermediate (distances, the
// sorted tile, the merge buffer) stays in shared memory, so per hop only
// the inputs are read and the new worklist written. Copying each query's
// whole table to shared memory instead, in every block or per block from its
// count of fresh candidates, measured slower on the H100 at every count from
// 0 to 64: the copy moves all 32 KB, and a launch that allows it reserves
// 32 KB of shared memory for every block, six blocks an SM. Without it, all
// 1,024 blocks of a batch are resident at once.
//
// K6 replaces search_step.fused_traverse_pallas (search_step.py:433,
// _traverse_kernel): steps 3-6 above on precomputed (B, R) distances, for the
// exact variant, whose distances come from full vectors. It shares K1's
// code after the ADC (traverse_tail). What bounds it: bytes, the candidates
// (B, R) and the worklist in and out, about 1.7 MB at B = 1024, R = t = 64
// (0.5 us at 3.35 TB/s); its 28 barrier-separated network stages on one
// block per query keep it far above that, as for K1.
#include "adc.cuh"
#include "stage.cuh"

namespace {

// The hop after the candidates' distances are known (_traverse_math of the
// reference): §4.7 sort of the Rp-candidate tile cd/ci, §4.6 selection, §4.8
// merge into the worklist md/mi/mv (held in [0, t) of the P-slot buffers),
// INVALID slots forced visited, and the outputs of query b. cd/ci and the
// worklist must be visible to the whole block.
__device__ __forceinline__ void traverse_tail(
    float* cd, int* ci, float* md, int* mi, int* mv, int b, int t, int Rp, int P, int eager,
    const bool* __restrict__ active, float* __restrict__ owd, int* __restrict__ owi,
    bool* __restrict__ owv, int* __restrict__ ou, bool* __restrict__ oact) {
  __shared__ int s_u, s_found;

  // §4.7 sort of the candidate tile.
  bitonic_network(cd, ci, nullptr, Rp, true);

  // §4.6 eager selection on the pre-merge worklist, while the other threads
  // append the reversed, padded candidates behind the worklist.
  if (eager && threadIdx.x == 0) {
    int pos = -1;
    float wl_d = CUDART_INF_F;
    for (int i = 0; i < t; ++i) {
      if (!mv[i]) {
        if (pos < 0) pos = i;
        if (md[i] < wl_d) wl_d = md[i];
      }
    }
    const bool wl_found = pos >= 0;
    const int wl_u = wl_found ? mi[pos] : REPRO_INVALID;
    if (!wl_found) wl_d = CUDART_INF_F;
    s_u = cd[0] < wl_d ? ci[0] : wl_u;
    s_found = wl_found || ci[0] != REPRO_INVALID;
  }
  for (int q = threadIdx.x; q < P - t; q += blockDim.x) {
    const int s = P - t - 1 - q;
    md[t + q] = s < Rp ? cd[s] : CUDART_INF_F;
    mi[t + q] = s < Rp ? ci[s] : REPRO_INVALID;
    mv[t + q] = 0;
  }
  __syncthreads();

  // §4.8 merge: final bitonic merge phase only.
  bitonic_network(md, mi, mv, P, false);

  for (int i = threadIdx.x; i < t; i += blockDim.x)
    if (mi[i] == REPRO_INVALID) mv[i] = 1;
  __syncthreads();

  if (threadIdx.x == 0) {
    if (!eager) {
      int pos = -1;
      for (int i = 0; i < t && pos < 0; ++i)
        if (!mv[i]) pos = i;
      s_found = pos >= 0;
      s_u = pos >= 0 ? mi[pos] : REPRO_INVALID;
    }
    const bool act = active[b] && s_found;
    s_u = act ? s_u : REPRO_INVALID;
    ou[b] = s_u;
    oact[b] = act;
  }
  __syncthreads();

  const int u = s_u;
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    owd[(size_t)b * t + i] = md[i];
    owi[(size_t)b * t + i] = mi[i];
    owv[(size_t)b * t + i] = mv[i] || mi[i] == u;
  }
}

__global__ void search_step_kernel(
    const float* __restrict__ table, const uint8_t* __restrict__ codes,
    const int* __restrict__ nbrs, const bool* __restrict__ fresh,
    const float* __restrict__ wld, const int* __restrict__ wli,
    const bool* __restrict__ wlv, const bool* __restrict__ active,
    float* __restrict__ owd, int* __restrict__ owi, bool* __restrict__ owv,
    int* __restrict__ ou, bool* __restrict__ oact,
    int n, int m, int R, int t, int Rp, int P, int eager) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cd = reinterpret_cast<float*>(smem);    // Rp
  int* ci = reinterpret_cast<int*>(cd + Rp);     // Rp
  float* md = reinterpret_cast<float*>(ci + Rp); // P
  int* mi = reinterpret_cast<int*>(md + P);      // P
  int* mv = mi + P;                              // P

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    md[i] = wld[(size_t)b * t + i];
    mi[i] = wli[(size_t)b * t + i];
    mv[i] = wlv[(size_t)b * t + i] ? 1 : 0;
  }

  // §4.5 ADC with the code gather inside the kernel.
  const float* tb = table + (size_t)b * m * 256;
  const bool wide = m % 16 == 0 && aligned16(codes);
  for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
    float d = CUDART_INF_F;
    int id = REPRO_INVALID;
    if (r < R && fresh[(size_t)b * R + r]) {
      id = nbrs[(size_t)b * R + r];
      // Clamped like the reference's XLA gather; ids out of [0, n) do not
      // occur on the search path.
      const int row = min(max(id, 0), n - 1);
      d = lane_adc(tb, codes + (size_t)row * m, m, wide);
    }
    cd[r] = d;
    ci[r] = id;
  }
  __syncthreads();

  traverse_tail(cd, ci, md, mi, mv, b, t, Rp, P, eager, active, owd, owi, owv, ou, oact);
}

// K6: the hop on precomputed distances (B, R), padded to Rp with
// (+inf, INVALID); everything else is K1's.
__global__ void fused_traverse_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_i,
    const float* __restrict__ wld, const int* __restrict__ wli,
    const bool* __restrict__ wlv, const bool* __restrict__ active,
    float* __restrict__ owd, int* __restrict__ owi, bool* __restrict__ owv,
    int* __restrict__ ou, bool* __restrict__ oact,
    int R, int t, int Rp, int P, int eager) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cd = reinterpret_cast<float*>(smem);    // Rp
  int* ci = reinterpret_cast<int*>(cd + Rp);     // Rp
  float* md = reinterpret_cast<float*>(ci + Rp); // P
  int* mi = reinterpret_cast<int*>(md + P);      // P
  int* mv = mi + P;                              // P

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    md[i] = wld[(size_t)b * t + i];
    mi[i] = wli[(size_t)b * t + i];
    mv[i] = wlv[(size_t)b * t + i] ? 1 : 0;
  }
  for (int r = threadIdx.x; r < Rp; r += blockDim.x) {
    cd[r] = r < R ? cand_d[(size_t)b * R + r] : CUDART_INF_F;
    ci[r] = r < R ? cand_i[(size_t)b * R + r] : REPRO_INVALID;
  }
  __syncthreads();
  traverse_tail(cd, ci, md, mi, mv, b, t, Rp, P, eager, active, owd, owi, owv, ou, oact);
}

}  // namespace

extern "C" int repro_search_step(
    const void* table, const void* codes, const void* nbrs, const void* fresh,
    const void* wld, const void* wli, const void* wlv, const void* active,
    void* owd, void* owi, void* owv, void* ou, void* oact,
    int B, int n, int m, int R, int t, int Rp, int P, int eager, int threads,
    void* stream) {
  // The sorted candidate tile (dist, id) and the merge buffer (dist, id,
  // visited).
  const size_t smem = (size_t)Rp * 8 + (size_t)P * 12;
  cudaError_t err = allow_smem(search_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  search_step_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const uint8_t*)codes, (const int*)nbrs, (const bool*)fresh,
      (const float*)wld, (const int*)wli, (const bool*)wlv, (const bool*)active,
      (float*)owd, (int*)owi, (bool*)owv, (int*)ou, (bool*)oact,
      n, m, R, t, Rp, P, eager);
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_traverse(
    const void* cand_d, const void* cand_i, const void* wld, const void* wli, const void* wlv,
    const void* active, void* owd, void* owi, void* owv, void* ou, void* oact,
    int B, int R, int t, int Rp, int P, int eager, int threads, void* stream) {
  // The candidate tile (dist, id) and the merge buffer (dist, id, visited).
  const size_t smem = (size_t)Rp * 8 + (size_t)P * 12;
  cudaError_t err = allow_smem(fused_traverse_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_traverse_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cand_d, (const int*)cand_i, (const float*)wld, (const int*)wli,
      (const bool*)wlv, (const bool*)active, (float*)owd, (int*)owi, (bool*)owv,
      (int*)ou, (bool*)oact, R, t, Rp, P, eager);
  return (int)cudaGetLastError();
}
