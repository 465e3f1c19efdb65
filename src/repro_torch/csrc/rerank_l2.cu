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
// What bounds it on the H100: bytes, with the float64 steps close behind.
// The candidate vectors, (B, C, d) f32, are read once: about 54 MB at
// B = 1024, C = 104, d = 128, 16 us at 3.35 TB/s. Each element also needs
// one float32 -> float64 conversion, which the H100 issues at an eighth of
// its float32 rate, a float64 fused multiply-add and the rounding of the
// partial back to float32 precision.
//
// Design: a persistent grid, as many blocks as fit the card, each taking
// work items (a query and a tile of up to blockDim.x of its candidates) in
// turn, one thread per candidate. The rows are streamed through shared
// memory in slices of SLICE dimensions: a ring of RING slots, each holding
// one slice of every row of an item, is filled with 16-byte cp.async copies
// from consecutive threads (coalesced; 4-byte copies where d or the address
// is not a multiple of 4 floats) RING - 1 slices ahead of the one being
// scored, so each block keeps reads in flight while it computes, across
// item boundaries. (Blocks that load a whole tile and then compute run in
// waves that leave the memory idle while they compute; double-buffering
// whole tiles leaves too few warps resident.) Each thread walks its row
// slice by slice in the plain version's order, ||q||^2 included (every
// thread sums it, in the same order), with its partials in registers. A
// slice row spans an odd number of 16-byte words, so the threads' 16-byte
// reads of their own rows hit distinct banks. The rounding of each partial
// to float32 is done in float64 arithmetic (round_to_float) instead of two
// more conversions; it is exact while the partials stay in float32's normal
// range, and a row whose partials leave it (zero aside) is summed again
// from global memory with the conversions (dot_exact).
//
// Largest d: the block's shared memory grows with d. It holds RING slots of
// min(C, 128) rows x SSTRIDE floats, each slot with a copy of the query, and
// the query again as floats and as doubles: 55,296 + 24 d bytes at C >= 128
// and d a multiple of 4. On the H100's 227 KB per block that serves d up to
// 7,380; beyond it the launch is refused and the wrapper raises.
#include "common.cuh"
#include "stage.cuh"

namespace {

// The float32 rounding of d, kept as a double: for |d| in [2^-126, 2^127)
// with exponent e, adding m = sign(d) 2^(e+29) leaves a sum whose last bit
// is worth 2^(e-23), float32's unit in the last place at e, so the float64
// addition rounds d to float32 precision, ties to even (m's last bit is 0);
// subtracting m again is exact. A carry into 2^(e+1) stays below float32's
// overflow while e <= 126. d = 0 gives 0. `lo` and `hi` collect the
// exponent field of every nonzero d (less one) and of every d, so that the
// caller can check the range once per row.
__device__ __forceinline__ double round_to_float(double d, unsigned& lo, unsigned& hi) {
  const int top = __double2hiint(d);
  const unsigned ex = (unsigned)top & 0x7ff00000u;
  lo = min(lo, ex - 1u);     // a zero d wraps to the largest value
  hi = max(hi, ex);
  const double m = __hiloint2double((top & (int)0xfff00000) + (29 << 20), 0);
  return (d + m) - m;
}

// Nonzero exponent fields within [2^-126, 2^126] (biased 897 .. 1149).
__device__ __forceinline__ bool in_float_range(unsigned lo, unsigned hi) {
  return lo >= (897u << 20) - 1u && hi <= (1149u << 20);
}

// Dimensions [lo, hi) of one row (x indexed by dimension): the sequential
// ||v||^2 and ||q||^2, and the 8 strided partials
// part = float32(float64(part) + float64(x) * a), kept as doubles. The
// product of two float32 values is exact in float64, so the fused
// multiply-add rounds once, as the sum of the plain version does. lo is a
// multiple of 8; the dimensions past the last multiple of 8 (full) are
// walked singly. lo_ex and hi_ex collect the partials' exponents.
__device__ __forceinline__ void walk(const float* x, const float* qf, const double* qd, int lo,
                                     int hi, int full, float& vv, float& qq, double* part,
                                     unsigned& lo_ex, unsigned& hi_ex) {
  for (int i0 = lo; i0 < min(hi, full); i0 += 8) {
    const float4 xa = *reinterpret_cast<const float4*>(x + i0);
    const float4 xb = *reinterpret_cast<const float4*>(x + i0 + 4);
    const float4 fa = *reinterpret_cast<const float4*>(qf + i0);
    const float4 fb = *reinterpret_cast<const float4*>(qf + i0 + 4);
    const double2 da = *reinterpret_cast<const double2*>(qd + i0);
    const double2 db = *reinterpret_cast<const double2*>(qd + i0 + 2);
    const double2 dc = *reinterpret_cast<const double2*>(qd + i0 + 4);
    const double2 dd = *reinterpret_cast<const double2*>(qd + i0 + 6);
    const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float fs[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
    const double as[8] = {da.x, da.y, db.x, db.y, dc.x, dc.y, dd.x, dd.y};
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      vv = vv + xs[l] * xs[l];
      qq = qq + fs[l] * fs[l];
      part[l] = round_to_float(__fma_rn((double)xs[l], as[l], part[l]), lo_ex, hi_ex);
    }
  }
#pragma unroll
  for (int l = 0; l < 8; ++l) {              // static indices keep part in registers
    const int i = full + l;
    if (i >= lo && i < hi) {
      const float xv = x[i], fv = qf[i];
      vv = vv + xv * xv;
      qq = qq + fv * fv;
      part[l] = round_to_float(__fma_rn((double)xv, qd[i], part[l]), lo_ex, hi_ex);
    }
  }
}

// The 8 partials folded pairwise: <v, q>.
__device__ __forceinline__ float fold(float a0, float a1, float a2, float a3, float a4, float a5,
                                      float a6, float a7) {
  const float p0 = a0 + a4, p1 = a1 + a5, p2 = a2 + a6, p3 = a3 + a7;
  return (p0 + p2) + (p1 + p3);
}

// <v, q> of one row with the plain conversions, for any values.
__device__ __noinline__ float dot_exact(const float* x, const double* qd, int d) {
  float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < d; ++i) p[i % 8] = (float)((double)p[i % 8] + (double)x[i] * qd[i]);
  return fold(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]);
}

constexpr int SLICE = 32;              // dimensions per slice: one 128-byte line of a row
constexpr int RING = 3;                // slots: RING - 1 slices in flight while one is scored
constexpr int SSTRIDE = SLICE + 4;     // floats per slice row: 9 16-byte words

struct Shape {
  int C, d, tiles, items, slices, cap, slot;   // slot: floats per ring slot
};

// Issue slice n of this block's sequence into its ring slot, as one cp.async
// group (empty past the block's last item). Slice 0 of an item also stages
// the item's query.
__device__ __forceinline__ void issue(float* ring, const float* q, const float* v, int n,
                                      const Shape& s) {
  const int item = blockIdx.x + n / s.slices * gridDim.x;
  if (item < s.items) {
    const int j = n % s.slices, lo = j * SLICE, hi = min(s.d, lo + SLICE);
    const int b = item / s.tiles, c0 = (item - b * s.tiles) * blockDim.x;
    float* slot = ring + (size_t)(n % RING) * s.slot;
    const float* src = v + ((size_t)b * s.C + c0) * s.d;
    const int rows = min((int)blockDim.x, s.C - c0);
    if (hi - lo == SLICE)
      stage_rows<SLICE / 4>(slot - lo, src, rows, s.d, SSTRIDE, lo, hi);
    else
      stage_rows(slot - lo, src, rows, s.d, SSTRIDE, lo, hi);
    if (j == 0) stage_rows(slot + s.cap * SSTRIDE, q + (size_t)b * s.d, 1, s.d, 0, 0, s.d);
  }
  stage_commit();
}

__global__ void rerank_l2_kernel(const float* __restrict__ q, const float* __restrict__ v,
                                 float* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qf = ring + RING * (size_t)s.slot;                  // the item's query, d padded to 4
  double* qd = reinterpret_cast<double*>(qf + (s.d + 3) / 4 * 4);
  const int r = threadIdx.x, d = s.d, full = d - d % 8;
  const int mine = (s.items - blockIdx.x + gridDim.x - 1) / gridDim.x;   // items of this block
  for (int n = 0; n < RING - 1; ++n) issue(ring, q, v, n, s);
  int b = 0, c0 = 0, rows = 0;
  float vv = 0.0f, qq = 0.0f;
  double part[8];
  unsigned lo_ex = ~0u, hi_ex = 0u;
  for (int n = 0; n < mine * s.slices; ++n) {
    stage_wait_group<RING - 2>();            // slice n has landed
    __syncthreads();                         // ... for every thread; slot (n-1) % RING is free
    issue(ring, q, v, n + RING - 1, s);
    const int j = n % s.slices;
    const float* slot = ring + (size_t)(n % RING) * s.slot;
    if (j == 0) {                            // a new item: its query, fresh sums
      const int item = blockIdx.x + n / s.slices * gridDim.x;
      b = item / s.tiles;
      c0 = (item - b * s.tiles) * blockDim.x;
      rows = min((int)blockDim.x, s.C - c0);
      const float* qs = slot + s.cap * SSTRIDE;
      for (int i = r; i < d; i += blockDim.x) {
        qf[i] = qs[i];
        qd[i] = (double)qs[i];
      }
      __syncthreads();
      vv = qq = 0.0f;
      for (int l = 0; l < 8; ++l) part[l] = 0.0;
      lo_ex = ~0u;
      hi_ex = 0u;
    }
    if (r < rows) {
      const int lo = j * SLICE;
      walk(slot + r * SSTRIDE - lo, qf, qd, lo, min(d, lo + SLICE), full, vv, qq, part, lo_ex,
           hi_ex);
      if (j == s.slices - 1) {
        const size_t row = (size_t)b * s.C + c0 + r;
        const float vq = in_float_range(lo_ex, hi_ex)
                             ? fold((float)part[0], (float)part[1], (float)part[2],
                                    (float)part[3], (float)part[4], (float)part[5],
                                    (float)part[6], (float)part[7])
                             : dot_exact(v + row * d, qd, d);
        out[row] = (qq + vv) - 2.0f * vq;
      }
    }
  }
}

}  // namespace

// threads: candidates per item, a multiple of 32, one per thread.
extern "C" int repro_rerank_l2(const void* q, const void* v, void* out, int B, int C, int d,
                               int threads, void* stream) {
  Shape s;
  s.C = C;
  s.d = d;
  s.tiles = (C + threads - 1) / threads;
  s.items = B * s.tiles;
  s.slices = (d + SLICE - 1) / SLICE;
  s.cap = min(threads, C);
  s.slot = s.cap * SSTRIDE + (d + 3) / 4 * 4;
  const size_t smem = (RING * (size_t)s.slot + (d + 3) / 4 * 4) * 4 + (size_t)d * 8;
  cudaError_t err = allow_smem(rerank_l2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rerank_l2_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(s.items, sms * max(per_sm, 1));
  rerank_l2_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>((const float*)q, (const float*)v,
                                                                  (float*)out, s);
  return (int)cudaGetLastError();
}
