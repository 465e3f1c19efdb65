// K1: one whole Algorithm-2 hop per query (BANG §4.5-§4.8) in one kernel,
// and K6, the same hop on distances computed outside the kernel.
//
// K1 replaces the TPU kernels search_step.fused_step_pallas
// (src/repro/kernels/search_step/search_step.py:293, _fused_step_kernel and
// _traverse_math) and its beyond-VMEM twin fused_step_dma_pallas
// (search_step.py:365, _dma_tiled_adc). The TPU needed the twin because the
// codes block had to fit VMEM or be streamed through it; on the GPU the code
// rows are gathered straight from global memory, so one kernel serves both.
// K6 replaces search_step.fused_traverse_pallas (search_step.py:433,
// _traverse_kernel): the hop on precomputed (B, R) distances, for the exact
// variant and the mesh paths.
//
// K1, per query (one thread block):
//   1. ADC: one thread per fresh candidate gathers its code row and looks
//      its m entries up in the (m, 256) PQ distance table in global memory
//      (adc.cuh, lane_adc), all of a window's 32 loads in flight at once,
//      summed in MC-subspace chunks, into the Rp = next_pow2(R) candidate
//      tile in shared memory, padded with (+inf, INVALID);
//   2. the tail, below.
// K6 runs the tail alone on its (B, R) input.
//
// The tail (_traverse_math of the reference):
//   3. §4.7: the Rp candidates are sorted by (dist, id), bitonic network;
//   4. §4.6: eager selection reads the pre-merge worklist;
//   5. §4.8: worklist ++ reversed candidates is bitonic, so only the final
//      merge phase runs (P = next_pow2(t + Rp)); INVALID slots are forced
//      visited;
//   6. lazy selection reads the merged worklist; the chosen id is marked
//      visited.
// It has two regimes, chosen by the wrapper from P:
//   * the warp regime, P <= 512 (t <= 448 at R = 64): one warp per query
//     holds the tile and the P-slot merge row in registers (lane_elems(P)
//     a lane) and runs the network of warp_bitonic.cuh. Worklist and
//     candidates come in and the new worklist goes out in coalesced loads
//     and stores; the reversed candidates reach their merge slots by one
//     shuffle a register; the selections are ballots and a shuffle
//     reduction. No __syncthreads and no shared memory. K6 runs several
//     queries a block; in K1, after the ADC's barrier, warp 0 runs the tail
//     and the other warps finish.
//   * the block regime, P > 512: one block per query keeps the tile and the
//     merge row in shared memory and runs common.cuh's bitonic_network, a
//     barrier after each of its stages; thread 0 makes the selections.
// Both run the same network, so both give the plain version's bits.
//
// What bounds K1 on the H100: bytes. Per hop the function needs, per query,
// the table sectors (32 bytes each) that the fresh candidates' codes look
// up, the fresh code rows (m bytes each) and the worklist in and out. With
// F fresh candidates a subspace's 32 sectors are each touched with
// probability 1 - (31/32)^F, about 76% of the 32 KB table at F = 45 (m = 32),
// so the table still dominates: about 25 MB per hop at B = 1024, about 8 us
// at 3.35 TB/s, against about 1.5 MB of code rows. Operations are few (R*m
// adds, O(P log^2 P) compare-exchanges). The lookups read only the sectors
// the codes need, each fresh candidate's in two dependent round trips
// (its code row, then its entries), and every intermediate (distances, the
// sorted tile, the merge row) stays on the chip, so per hop only the inputs
// are read and the new worklist written. Copying each query's whole table
// to shared memory instead, in every block or per block from its count of
// fresh candidates, measured slower on the H100 at every count from 0 to
// 64: the copy moves all 32 KB, and a launch that allows it reserves 32 KB
// of shared memory for every block, six blocks an SM. Without it, all 1,024
// blocks of a batch are resident at once.
//
// What bounds K6: bytes, the candidates (B, R) and the worklist in and out,
// about 1.7 MB at B = 1024, R = t = 64 (0.5 us at 3.35 TB/s), below the
// device time of one launch; the warp regime keeps its 28 network stages in
// registers so that the launch, and not the network, sets its time.
#include "adc.cuh"
#include "stage.cuh"
#include "warp_bitonic.cuh"

namespace {

// ------------------------------------------------------------ warp regime
// Registers a lane holds of the candidate tile, for a merge row of 32 * E
// slots: Rp <= P / 2, so half of the row's.
__host__ __device__ constexpr int tile_elems(int E) { return E > 1 ? E / 2 : 1; }

// The first unvisited slot of [0, t) of the merge row, by ballot: returns
// true and its id in u, or false and INVALID where every slot is visited.
template <int E>
__device__ __forceinline__ bool first_unvisited(const int (&mi)[E], const int (&mv)[E], int t,
                                                int lane, int& u) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const unsigned m = __ballot_sync(FULL_MASK, ((r << 5) | lane) < t && !mv[r]);
    if (m) {
      u = __shfl_sync(FULL_MASK, mi[r], __ffs(m) - 1);
      return true;
    }
  }
  u = REPRO_INVALID;
  return false;
}

// The tail of query b by one warp (P = 32 * E, or P <= 32 at E = 1). cd/ci
// hold the unsorted Rp-candidate tile, element s in lane s % 32, register
// s / 32, (+inf, INVALID) past R; the worklist rows are read here and the
// outputs written.
template <int E>
__device__ __forceinline__ void warp_traverse_tail(
    float (&cd)[tile_elems(E)], int (&ci)[tile_elems(E)], const float* __restrict__ wld,
    const int* __restrict__ wli, const bool* __restrict__ wlv, int b, int t, int Rp, int P,
    int eager, const bool* __restrict__ active, float* __restrict__ owd, int* __restrict__ owi,
    bool* __restrict__ owv, int* __restrict__ ou, bool* __restrict__ oact, int lane) {
  constexpr int EC = tile_elems(E);
  const size_t row = (size_t)b * t;
  // The worklist: slots [0, t) of the merge row, slot x in lane x % 32,
  // register x / 32. Slots past t count as visited until the merge row is
  // built, so that the eager scan passes over them.
  float md[E];
  int mi[E], mv[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int x = (r << 5) | lane;
    md[r] = x < t ? wld[row + x] : CUDART_INF_F;
    mi[r] = x < t ? wli[row + x] : REPRO_INVALID;
    mv[r] = x < t ? (int)wlv[row + x] : 1;
  }

  // §4.7 sort of the candidate tile.
  int no_payload[EC];
  warp_bitonic<EC, false>(cd, ci, no_payload, Rp, true, lane);

  // §4.6 eager selection on the pre-merge worklist: the first unvisited
  // slot and the least unvisited distance, as the serial scan finds them
  // (a '<' scan from +inf passes over NaN and +inf alike; the sign of a
  // zero minimum cannot change the comparison below).
  int u = REPRO_INVALID;
  bool found = false;
  if (eager) {
    int wl_u;
    const bool wl_found = first_unvisited<E>(mi, mv, t, lane, wl_u);
    float wl_d = CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < E; ++r)
      if (!mv[r] && md[r] < wl_d) wl_d = md[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(FULL_MASK, wl_d, off);
      if (o < wl_d) wl_d = o;
    }
    const float c0 = __shfl_sync(FULL_MASK, cd[0], 0);
    const int i0 = __shfl_sync(FULL_MASK, ci[0], 0);
    u = c0 < wl_d ? i0 : wl_u;
    found = wl_found || i0 != REPRO_INVALID;
  }

  // §4.8 merge. Slot x >= t takes candidate P - 1 - x where that is < Rp,
  // else (+inf, INVALID), unvisited. Candidate P - 1 - x lives in lane
  // (P - 1 - x) % 32 = (P - 1 - lane) % 32, register E - 1 - r.
  const int src = (P - 1 - lane) & 31;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int x = (r << 5) | lane;
    const int sr = E - 1 - r;
    float pd = CUDART_INF_F;
    int pi = REPRO_INVALID;
    if (sr < EC) {   // registers below E / 2 hold no candidate slot
      pd = __shfl_sync(FULL_MASK, cd[sr < EC ? sr : 0], src);
      pi = __shfl_sync(FULL_MASK, ci[sr < EC ? sr : 0], src);
    }
    if (x >= t) {
      const bool cand = x >= P - Rp;
      md[r] = cand ? pd : CUDART_INF_F;
      mi[r] = cand ? pi : REPRO_INVALID;
      mv[r] = 0;
    }
  }
  warp_bitonic<E, true>(md, mi, mv, P, false, lane);
#pragma unroll
  for (int r = 0; r < E; ++r)
    if (mi[r] == REPRO_INVALID) mv[r] = 1;

  if (!eager) found = first_unvisited<E>(mi, mv, t, lane, u);
  const bool act = active[b] && found;
  u = act ? u : REPRO_INVALID;
  if (lane == 0) {
    ou[b] = u;
    oact[b] = act;
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int x = (r << 5) | lane;
    if (x < t) {
      owd[row + x] = md[r];
      owi[row + x] = mi[r];
      owv[row + x] = mv[r] || mi[r] == u;
    }
  }
}

// ----------------------------------------------------------- block regime

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

// K1. E > 0: the warp regime's tail (P = 32 * E, or P <= 32 at E = 1);
// E = 0: the block regime's.
template <int E>
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
  float* md = reinterpret_cast<float*>(ci + Rp); // P, block regime only
  int* mi = reinterpret_cast<int*>(md + P);      // P
  int* mv = mi + P;                              // P

  const int b = blockIdx.x;
  if constexpr (E == 0) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      md[i] = wld[(size_t)b * t + i];
      mi[i] = wli[(size_t)b * t + i];
      mv[i] = wlv[(size_t)b * t + i] ? 1 : 0;
    }
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

  if constexpr (E == 0) {
    traverse_tail(cd, ci, md, mi, mv, b, t, Rp, P, eager, active, owd, owi, owv, ou, oact);
  } else {
    if (threadIdx.x >= 32) return;
    constexpr int EC = tile_elems(E);
    const int lane = threadIdx.x;
    float tcd[EC];
    int tci[EC];
#pragma unroll
    for (int r = 0; r < EC; ++r) {
      const int s = (r << 5) | lane;
      tcd[r] = s < Rp ? cd[s] : CUDART_INF_F;
      tci[r] = s < Rp ? ci[s] : REPRO_INVALID;
    }
    warp_traverse_tail<E>(tcd, tci, wld, wli, wlv, b, t, Rp, P, eager, active, owd, owi, owv, ou,
                          oact, lane);
  }
}

// K6, the warp regime: one warp per query, several queries a block.
template <int E>
__global__ void warp_traverse_kernel(
    const float* __restrict__ cand_d, const int* __restrict__ cand_i,
    const float* __restrict__ wld, const int* __restrict__ wli,
    const bool* __restrict__ wlv, const bool* __restrict__ active,
    float* __restrict__ owd, int* __restrict__ owi, bool* __restrict__ owv,
    int* __restrict__ ou, bool* __restrict__ oact,
    int B, int R, int t, int Rp, int P, int eager) {
  constexpr int EC = tile_elems(E);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const size_t row = (size_t)b * R;
  float cd[EC];
  int ci[EC];
#pragma unroll
  for (int r = 0; r < EC; ++r) {
    const int s = (r << 5) | lane;
    cd[r] = s < R ? cand_d[row + s] : CUDART_INF_F;
    ci[r] = s < R ? cand_i[row + s] : REPRO_INVALID;
  }
  warp_traverse_tail<E>(cd, ci, wld, wli, wlv, b, t, Rp, P, eager, active, owd, owi, owv, ou, oact,
                        lane);
}

// K6, the block regime: one block per query, the hop on precomputed
// distances (B, R), padded to Rp with (+inf, INVALID); the tail is K1's.
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

#define REPRO_STEP_ARGS                                                                          \
  (const float*)table, (const uint8_t*)codes, (const int*)nbrs, (const bool*)fresh,              \
      (const float*)wld, (const int*)wli, (const bool*)wlv, (const bool*)active, (float*)owd,   \
      (int*)owi, (bool*)owv, (int*)ou, (bool*)oact, n, m, R, t, Rp, P, eager

#define REPRO_TRAVERSE_ARGS                                                                    \
  (const float*)cand_d, (const int*)cand_i, (const float*)wld, (const int*)wli,                \
      (const bool*)wlv, (const bool*)active, (float*)owd, (int*)owi, (bool*)owv, (int*)ou,    \
      (bool*)oact

// warp_tail != 0: the warp regime (P <= 512), else the block regime.
extern "C" int repro_search_step(
    const void* table, const void* codes, const void* nbrs, const void* fresh,
    const void* wld, const void* wli, const void* wlv, const void* active,
    void* owd, void* owi, void* owv, void* ou, void* oact,
    int B, int n, int m, int R, int t, int Rp, int P, int eager, int threads, int warp_tail,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!warp_tail) {
    // The candidate tile (dist, id) and the merge row (dist, id, visited).
    const size_t smem = (size_t)Rp * 8 + (size_t)P * 12;
    cudaError_t err = allow_smem(search_step_kernel<0>, smem);
    if (err != cudaSuccess) return (int)err;
    search_step_kernel<0><<<B, threads, smem, st>>>(REPRO_STEP_ARGS);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)Rp * 8;   // the candidate tile only
  switch (P > 512 ? 0 : lane_elems(P)) {
    case 1: search_step_kernel<1><<<B, threads, smem, st>>>(REPRO_STEP_ARGS); break;
    case 2: search_step_kernel<2><<<B, threads, smem, st>>>(REPRO_STEP_ARGS); break;
    case 4: search_step_kernel<4><<<B, threads, smem, st>>>(REPRO_STEP_ARGS); break;
    case 8: search_step_kernel<8><<<B, threads, smem, st>>>(REPRO_STEP_ARGS); break;
    case 16: search_step_kernel<16><<<B, threads, smem, st>>>(REPRO_STEP_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// warps = 1..8: the warp regime (P <= 512), `warps` queries a block (at
// P = 512 a thread holds over 120 registers, so 32 warps would not fit an
// SM); warps = 0: the block regime, one query a block of `threads`.
extern "C" int repro_fused_traverse(
    const void* cand_d, const void* cand_i, const void* wld, const void* wli, const void* wlv,
    const void* active, void* owd, void* owi, void* owv, void* ou, void* oact,
    int B, int R, int t, int Rp, int P, int eager, int threads, int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps == 0) {
    // The candidate tile (dist, id) and the merge row (dist, id, visited).
    const size_t smem = (size_t)Rp * 8 + (size_t)P * 12;
    cudaError_t err = allow_smem(fused_traverse_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_traverse_kernel<<<B, threads, smem, st>>>(REPRO_TRAVERSE_ARGS, R, t, Rp, P, eager);
    return (int)cudaGetLastError();
  }
  if (warps < 0 || warps > 8) return (int)cudaErrorInvalidValue;
  const int blocks = (B + warps - 1) / warps;
  switch (P > 512 ? 0 : lane_elems(P)) {
#define REPRO_CASE(E)                                                                           \
  case E:                                                                                       \
    warp_traverse_kernel<E><<<blocks, 32 * warps, 0, st>>>(REPRO_TRAVERSE_ARGS, B, R, t, Rp, P, \
                                                           eager);                              \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(4) REPRO_CASE(8) REPRO_CASE(16)
#undef REPRO_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
