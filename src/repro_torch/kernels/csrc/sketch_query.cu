// Batched RACE query for Hopper: hash each query, gather counts[r, code_r],
// mean over the R rows.
//
// Replaces the Pallas TPU kernel `sketch_query` in
// src/repro/kernels/sketch_query.py. That kernel gathers through a one-hot
// contraction on the MXU because the TPU has no fast gather; here the gather
// is an indexed load.
//
// Two bodies, chosen by the shape alone (no switch, no fallback):
//   * the staged body, d <= 32 and p <= 8: the fits' and the gateways'
//     queries (d = 12, 11);
//   * the generic body, d > 32 or p > 8 (any d, p up to 30): wide rows (the
//     d = 40 fit's d = 43 queries) and the probes' queries at d_model scale
//     (d = 3587, m = 17 a DFO step, m = 34 a 2-tap fleet step).
// Both keep the plain version's contract: for every (point, row, plane) the
// projection sum_f q[i, f] * w[j, f, r] is summed by one thread, in index
// order, each term a __fmul_rn then a __fadd_rn, from +0 (no FMA, no TF32,
// no split of the feature sum), and the code bit is acc > 0.
//
// The staged body. What bounds it: latency at the main path's m (17 points
// per DFO step, 198 per refine batch, 272 for a 16-tenant fleet, 512
// gateway slots); the work is m*R*p*d multiply-adds and m*R gathers from a
// table that stays in L2, and w is p*d*R floats (393 KB at p = 4, d = 12,
// R = 2048).
//   * A 2-D grid: x = slices of the R rows, y = tiles of up to 128 points,
//     one point per thread. Slices are sized so that the grid holds about
//     kBlocksPerSm blocks per SM (at least kMinRows rows a slice), so at
//     m = 17 a launch spreads over 256 blocks, and w crosses L2 once per
//     point tile instead of once per point. Variants of the three constants
//     (scripts/insert_variants.py --family query) moved m = 17, 272, 512 and
//     4096 by at most 10% either way, except kMinRows >= 16 (m = 17 +33%)
//     and 64-point tiles (m = 4096 +20%); 4 blocks per SM beat 8 at m = 272
//     and 512 (the fleet's and the gateway's queries) by 6-10%.
//   * A block stages its slice of w in shared memory once, zero-padded to
//     DMAX features a plane (DMAX in {12, 16, 32}), then each thread hashes
//     its point (held in registers) against every row of the slice. The
//     padded features add 0 * 0 = +0, which changes no nonzero sum and no
//     comparison.
//
// The generic body. At the probe shape (d = 3587, R = 2048, p = 4) the hash
// family is 117.5 MB, larger than L2, so every launch streams it from HBM:
// 35 us at 3.35 TB/s. The contract's arithmetic is 2*m*d*R*p lane
// instructions, 29.9 us at m = 17 and 59.7 us at m = 34 on 132 SMs x 128
// lanes at 1980 MHz. There are only m*R*p = 139 k chains at m = 17 for the
// card's 16.9 k lanes: about one warp a scheduler, so issue, not bytes,
// bounds it.
//   * A block owns kGenRows = 16 hash rows and a tile of the points (all
//     of them at small m), 4 or 8 warps of TP in {3, 5, 9} points each
//     (make_plan: the smallest tile that holds m; m = 17 takes 4 x 5, m = 34
//     4 x 9, past 72 tiles of 8 x 9 along the grid's y). R = 2048 gives 128
//     blocks, one per SM. Lane (pair, slot) = (lane % 8, lane / 8) owns two
//     adjacent rows and plane slot (and slot + 4 past p = 4) of the warp's
//     points: 2 TP chains at p <= 4. Per feature it reads one float2 of
//     weights and, per 4 features, one float4 of each point, a broadcast:
//     9 shared loads per 80 multiply-adds at TP = 5.
//   * w streams through a ring of kGenStages buffers in chunks of 63
//     features: one TMA box (planes, 63, 16 rows) a chunk, issued by one
//     thread two chunks ahead and counted on an mbarrier, zero-filled past
//     R, d and p. 63 is odd so that a plane's 1008 words start in the other
//     half of the banks than its neighbour's: the 4 slots of a warp read
//     their float2s in 2 wavefronts. (Where TMA cannot take w, R % 4 != 0
//     or w not 16-byte aligned, the threads copy it with cp.async.) The
//     points' rows are not 16-byte aligned at odd d, so no TMA box starts
//     there: each thread loads 2 TP of the tile's chunk into registers a
//     step ahead and stores them beside the weights, 64 a point, the 64th
//     zero (it meets the next plane's first weight, or the zeros past the
//     last plane).
//   * Each group of 4 features is loaded into registers while the one
//     before computes (project).
//   * p > 8 runs in passes of pg = ceil(p / ceil(p / 8)) planes over the
//     chunk stream, each reading its own planes of w (w still crosses HBM
//     once); the lanes of a point group gather their bits by shuffles, and
//     the codes their bits across passes.
//   * Gather: lane (pair, slot) reads its 2 rows' cells of the warp's points
//     slot, slot + 4, ...; the 8 pairs add them by shuffles (a fixed tree)
//     and pair 0 reduces the block's 16 rows of the point as below.
// On an H100 (700 W) a launch takes 0.100 ms at m = 17 and 0.152 ms at
// m = 34, 3.4x and 2.6x the floor above (chip_smoke.py phases 15 and 19
// print each beside its bound, its floor and the cuBLAS time of the
// projection alone; PERF.md section 6). What holds it there
// (scripts/query_generic.py --phases, clock64 by part of a step): the
// multiply-add loop retires about 0.57 FP32 instructions a cycle (1260 a
// lane per chunk) with one warp a scheduler, and staging the points takes
// a quarter of a step.
//
// Both bodies reduce the same way:
//   * Gather: counts[r, code] (banked: of table sketch_idx[i]), narrow
//     counters widened at the load, summed over the block's rows in int64.
//   * Reduce exactly: each point's block sum goes into an int64 per-point
//     workspace with a 64-bit atomicAdd; integer sums are exact in any
//     order. After a __threadfence, the block takes a ticket of its point
//     tile; the last block of the tile reads each sum with atomicExch (which
//     sets it back to 0), writes out[i] = fp32(sum) * fp32(1/R) (the
//     reference's jnp.mean lowers to the same product; below 2^24 the
//     result equals the fp32 mean bit for bit, above it the int64 sum is
//     still exact where an fp32 sum would round), and zeroes the ticket.
//     So the workspace is all zeros between launches: no memset, no host
//     sync, nothing a CUDA graph could not capture.
//   * The banked entry point replaces `sketch_query_banked` (same JAX file):
//     the counts are an (S, R, 2^p) stack under one hash family and point i
//     gathers from table sketch_idx[i]. The lone one is compiled without the
//     index (BANKED = false).
//   * f32 tables (a privatized release: integer counts plus noise; the
//     reference's bodies read them too, casting the tile to f32) take the
//     same projection and gather with another accumulator (FLOAT = true).
//     Float atomics would make the sum depend on the order in which blocks
//     finish, so each block sums its rows of a point in float64 in an order
//     fixed by the plan and writes one partial per (row slice, point) to a
//     float64 workspace; the last block of the tile sums the partials in
//     slice order, converts once to f32 and scales by fp32(1/R). Two
//     launches on the same inputs give the same bits; on integer-valued
//     tables the float64 sums are exact, so the result equals the integer
//     body's bit for bit. Every partial is written before it is read, so
//     this workspace needs no zeroing either.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "insert_common.cuh"

namespace {

constexpr int kMaxTile = 128;        // points per block, one per thread
constexpr int kBlocksPerSm = 4;      // the grid's target, per SM
constexpr int kMinRows = 8;          // rows per slice, at least
constexpr int kMaxPlanes = 8;        // the staged body's reach in p ...
constexpr int kMaxFeatures = 32;     // ... and in d
// A slice's weights, at most: with the kernel's static shared memory this
// stays within the 48 KB a launch gets without opting in (a full 48 KB
// slice made the launch fail). Large m reaches the cap: few blocks along R.
constexpr int kWeightBytes = 32 * 1024;

// The generic body (d > 32 or p > 8).
constexpr int kGenRows = 16;             // hash rows per block
constexpr int kGenPairs = kGenRows / 2;  // row pairs across a warp's lanes
constexpr int kGenSlots = 32 / kGenPairs;  // plane slots across them
constexpr int kGenChunk = 63;  // features per stage: odd, see the note
constexpr int kGenXStride = 68;  // floats per staged point (64 + 4)
constexpr int kGenStages = 3;            // the ring
constexpr int kGenMaxThreads = 256;      // 8 warps
constexpr int kGenMaxPlanes = 8;         // planes per pass
constexpr int kMaxAllPlanes = 30;        // codes are int32 bit fields

// Adds counts[k] to a slice sum: integers of count_bytes widened to int64,
// or an f32 widened to float64.
__device__ __forceinline__ void add_count(long long& sum,
                                          const void* __restrict__ c,
                                          size_t k, int count_bytes) {
  if (count_bytes == 4) sum += static_cast<const int32_t*>(c)[k];
  else if (count_bytes == 2) sum += static_cast<const int16_t*>(c)[k];
  else sum += static_cast<const int8_t*>(c)[k];
}

__device__ __forceinline__ void add_count(double& sum,
                                          const void* __restrict__ c,
                                          size_t k, int) {
  sum += (double)static_cast<const float*>(c)[k];
}

// Adds a block's sum of point i to the reduction: FLOAT, the partial of
// row slice blockIdx.x; else into the int64 workspace.
template <bool FLOAT, class Sum>
__device__ __forceinline__ void put_sum(Sum sum, int i, int m,
                                        unsigned long long* sums,
                                        double* partials) {
  if constexpr (FLOAT)
    partials[(size_t)blockIdx.x * m + i] = sum;
  else if (sum != 0)
    atomicAdd(sums + i, (unsigned long long)sum);
}

// After every thread of the block has put its sums of point tile t (points
// base .. base + npts - 1): take the tile's ticket; the last block of the
// tile writes the means and leaves the workspace and the ticket at zero.
template <bool FLOAT>
__device__ __forceinline__ void finish_tile(int t, int base, int npts, int m,
                                            int rows, float* out,
                                            unsigned long long* sums,
                                            const double* partials,
                                            unsigned* tickets, bool* last) {
  __threadfence();  // this block's sums are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    *last = atomicAdd(tickets + t, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*last) return;  // block uniform
  for (int k = threadIdx.x; k < npts; k += blockDim.x) {
    const int i = base + k;
    if constexpr (FLOAT) {
      double total = 0.0;  // in slice order: the same bits every launch
      for (int x = 0; x < (int)gridDim.x; ++x)
        total += __ldcg(partials + (size_t)x * m + i);
      out[i] = __fmul_rn(__double2float_rn(total), __frcp_rn((float)rows));
    } else {
      const long long total = (long long)atomicExch(sums + i, 0ull);
      out[i] = __fmul_rn(__ll2float_rn(total), __frcp_rn((float)rows));
    }
  }
  if (threadIdx.x == 0) tickets[t] = 0u;
}

// The staged body: P planes, d <= DMAX. FLOAT: f32 tables, reduced through
// `partials` (gridDim.x x m float64); else integer tables, reduced through
// `sums` (m int64).
template <int P, int DMAX, bool BANKED, bool FLOAT>
__global__ void __launch_bounds__(kMaxTile)
sketch_query_kernel(const float* __restrict__ q, const float* __restrict__ w,
                    const void* __restrict__ counts, int count_bytes,
                    const int32_t* __restrict__ sketch_idx,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ sums,
                    double* __restrict__ partials,
                    unsigned* __restrict__ tickets, int m, int d, int p,
                    int rows, int slice) {
  using Sum = std::conditional_t<FLOAT, double, long long>;
  extern __shared__ __align__(16) float wsm[];  // (slice, P, DMAX)
  __shared__ bool last;
  const int tid = threadIdx.x, tile = blockDim.x;
  const int r0 = blockIdx.x * slice;
  const int nr = min(slice, rows - r0);
  const int buckets = 1 << p;
  // Row fastest, so that a warp reads neighbouring rows of one feature.
  for (int k = tid; k < nr * P * DMAX; k += tile) {
    const int rr = k % nr, rest = k / nr;
    const int f = rest % DMAX, j = rest / DMAX;
    wsm[(rr * P + j) * DMAX + f] =
        f < d ? w[((size_t)j * d + f) * rows + r0 + rr] : 0.f;
  }
  __syncthreads();
  const int ntiles = (m + tile - 1) / tile;
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int i = t * tile + tid;
    if (i < m) {
      const size_t table =
          BANKED ? (size_t)sketch_idx[i] * rows * buckets : 0;
      const size_t cell0 = table + (size_t)r0 * buckets;
      Sum sum = 0;
      float qv[DMAX];
#pragma unroll
      for (int f = 0; f < DMAX; ++f)
        qv[f] = f < d ? q[(size_t)i * d + f] : 0.f;
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr) {
        const float4* wr =
            reinterpret_cast<const float4*>(wsm + rr * P * DMAX);
        int code = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int f4 = 0; f4 < DMAX / 4; ++f4) {
            const float4 v = wr[j * (DMAX / 4) + f4];
            acc = __fadd_rn(acc, __fmul_rn(qv[4 * f4], v.x));
            acc = __fadd_rn(acc, __fmul_rn(qv[4 * f4 + 1], v.y));
            acc = __fadd_rn(acc, __fmul_rn(qv[4 * f4 + 2], v.z));
            acc = __fadd_rn(acc, __fmul_rn(qv[4 * f4 + 3], v.w));
          }
          code |= (acc > 0.f) << j;
        }
        add_count(sum, counts, cell0 + (size_t)rr * buckets + code,
                  count_bytes);
      }
      put_sum<FLOAT>(sum, i, m, sums, partials);
    }
    finish_tile<FLOAT>(t, t * tile, min(tile, m - t * tile), m, rows, out,
                       sums, partials, tickets, &last);
  }
}

// The grid of one staged launch: x = slices of `slice` rows, y = point
// tiles.
struct Plan {
  int tile, gx, gy, slice;
};

Plan make_plan(int m, int d, int p, int rows, int sms) {
  Plan g;
  g.tile = m >= kMaxTile ? kMaxTile : (m + 31) / 32 * 32;
  const int ntiles = (m + g.tile - 1) / g.tile;
  g.gy = std::min(ntiles, 65535);
  const int want_gx = std::max(1, sms * kBlocksPerSm / g.gy);
  g.slice = std::max((rows + want_gx - 1) / want_gx, std::min(kMinRows, rows));
  const int dmax = d <= 12 ? 12 : d <= 16 ? 16 : 32;  // the staged weights
  g.slice = std::min(g.slice, kWeightBytes / (int)(sizeof(float) * p * dmax));
  g.gx = (rows + g.slice - 1) / g.slice;
  return g;
}

bool staged(int d, int p) { return d <= kMaxFeatures && p <= kMaxPlanes; }

cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <int P, int DMAX, bool BANKED, bool FLOAT>
cudaError_t launch(const float* q, const float* w, const void* counts,
                   int count_bytes, const int32_t* sketch_idx, float* out,
                   unsigned long long* sums, double* partials,
                   unsigned* tickets, int m, int d, int p, int rows,
                   cudaStream_t s) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan g = make_plan(m, d, p, rows, sms);
  const size_t smem = sizeof(float) * g.slice * P * DMAX;
  sketch_query_kernel<P, DMAX, BANKED, FLOAT>
      <<<dim3(g.gx, g.gy), g.tile, smem, s>>>(
          q, w, counts, count_bytes, sketch_idx, out, sums, partials, tickets,
          m, d, p, rows, g.slice);
  return cudaGetLastError();
}

template <int P, bool BANKED, bool FLOAT>
cudaError_t dispatch_d(const float* q, const float* w, const void* counts,
                       int count_bytes, const int32_t* sketch_idx, float* out,
                       unsigned long long* sums, double* partials,
                       unsigned* tickets, int m, int d, int p, int rows,
                       cudaStream_t s) {
  if (d <= 12)
    return launch<P, 12, BANKED, FLOAT>(q, w, counts, count_bytes,
                                        sketch_idx, out, sums, partials,
                                        tickets, m, d, p, rows, s);
  if (d <= 16)
    return launch<P, 16, BANKED, FLOAT>(q, w, counts, count_bytes,
                                        sketch_idx, out, sums, partials,
                                        tickets, m, d, p, rows, s);
  return launch<P, 32, BANKED, FLOAT>(q, w, counts, count_bytes, sketch_idx,
                                      out, sums, partials, tickets, m, d, p,
                                      rows, s);
}

// ---- the generic body --------------------------------------------------------

namespace generic {

// A chunk is 63 features of w (so that a plane's (63, 16) weights span
// 1008 words: planes alternate between the two halves of the banks) and
// 64 of each point, the last one zero.
static_assert(kGenChunk % 2 == 1 && kGenChunk + 1 == kGenXStride - 4 &&
              kGenXStride % 4 == 0 && kGenChunk <= 256, "chunk layout");

// Floats of one stage of the ring at PG planes and mt points: the weights
// (PG, 63, 16) and 16 zeros (read past the last plane at the 64th feature
// of a chunk, times a zero point feature), then the points, each part
// starting on 128 bytes (a TMA destination's alignment).
__host__ __device__ constexpr int weight_floats(int pg) {
  return (pg * kGenChunk * kGenRows + kGenRows + 31) / 32 * 32;
}
__host__ __device__ constexpr int stage_floats(int pg, int mt) {
  return weight_floats(pg) + (mt * kGenXStride + 31) / 32 * 32;
}

// Planes per pass: p itself up to 8, else p split evenly over ceil(p / 8)
// passes.
inline int pass_planes(int p) {
  const int passes = (p + kGenMaxPlanes - 1) / kGenMaxPlanes;
  return (p + passes - 1) / passes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One thread: the (pg, 63, 16) box of w at (j0, f0, r0) into dst, counted
// on bar; the tensor map zero-fills rows past R, features past d and planes
// past p.
__device__ __forceinline__ void tma_weights(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int pg, int r0,
                                            int f0, int j0) {
  const uint32_t bytes = sizeof(float) * pg * kGenChunk * kGenRows;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(r0),
         "r"(f0), "r"(j0), "r"(smem_addr(bar))
      : "memory");
}

// Where TMA cannot bring w (see weight_map): the threads copy the weights
// of chunk f0, planes j0 .. j0 + live - 1, into `buf` with 4-byte cp.async
// (zeros past d, live and R) and commit them as one group.
__device__ __forceinline__ void copy_weights(float* buf, const float* w,
                                             int d, int rows, int pg, int r0,
                                             int f0, int j0, int live) {
  constexpr int KC = kGenChunk;
  const int nf = min(KC, d - f0);
  for (int k = threadIdx.x; k < pg * KC * kGenRows; k += blockDim.x) {
    const int c = k % kGenRows, rest = k / kGenRows;
    const int f = rest % KC, j = rest / KC;
    if (j < live && f < nf && r0 + c < rows)
      storm::cp_async4(buf + k, w + ((size_t)(j0 + j) * d + f0 + f) * rows
                                    + r0 + c);
    else
      buf[k] = 0.f;
  }
  storm::cp_async_commit();
}

// One group of 4 features in registers: the warp's TP points (broadcast
// loads) and this lane's two rows of its PPL planes for each feature.
template <int PPL, int TP>
struct Group {
  float4 x[TP];
  float2 w[4][PPL];
};

template <int PPL, int TP>
__device__ __forceinline__ void load_group(Group<PPL, TP>& g, const float* xs,
                                           const float* (&wj)[PPL],
                                           int f4) {
#pragma unroll
  for (int t = 0; t < TP; ++t)
    g.x[t] = *reinterpret_cast<const float4*>(xs + t * kGenXStride + 4 * f4);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int k = 0; k < PPL; ++k)
      g.w[u][k] = *reinterpret_cast<const float2*>(
          wj[k] + (4 * f4 + u) * kGenRows);
}

template <int PPL, int TP>
__device__ __forceinline__ void mac_group(const Group<PPL, TP>& g,
                                          float (&acc)[TP][2][PPL]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const float xq = u == 0 ? g.x[t].x : u == 1 ? g.x[t].y
                     : u == 2 ? g.x[t].z : g.x[t].w;
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        acc[t][0][k] = __fadd_rn(acc[t][0][k], __fmul_rn(xq, g.w[u][k].x));
        acc[t][1][k] = __fadd_rn(acc[t][1][k], __fmul_rn(xq, g.w[u][k].y));
      }
    }
}

// nf4 groups of 4 features of the chunk (16 in a full one, whose 64th is a
// zero point feature; past d both sides are zero) into acc[t][h][k] (the
// warp's point t at xs, row r0 + 2 * pair + h, plane slot + 4 k of the
// pass), feature by feature in index order. wj: this lane's planes'
// weights in the stage. Each group's loads are issued while the one before
// computes; the loads past the last group stay inside the stage and are
// dropped.
template <int PPL, int TP>
__device__ __forceinline__ void project(const float* xs,
                                        const float* (&wj)[PPL],
                                        int nf4, float (&acc)[TP][2][PPL]) {
  Group<PPL, TP> a, b;
  load_group(a, xs, wj, 0);
#pragma unroll 1
  for (int f4 = 0; f4 < nf4; f4 += 2) {
    load_group(b, xs, wj, f4 + 1);
    mac_group(a, acc);
    if (f4 + 1 == nf4) break;
    load_group(a, xs, wj, f4 + 2);
    mac_group(b, acc);
  }
}

// A block: rows r0 .. r0 + 15 (r0 = 16 blockIdx.x) against point tiles of
// TP points a warp, tiles blockIdx.y, blockIdx.y + gridDim.y, ... Lane
// (pair, slot) = (lane % 8, lane / 8) owns the rows r0 + 2 pair, + 1 and
// the planes slot + 4 k (k < PPL) of a pass of pg planes (PPL = 1 at
// pg <= 4, else 2). FLOAT and BANKED as for the staged body. tma: wmap
// describes w as a (p, d, R) tensor and brings its boxes.
template <int PPL, int TP, bool BANKED, bool FLOAT>
__global__ void __launch_bounds__(kGenMaxThreads, 1)
sketch_query_kernel(const float* __restrict__ q, const float* __restrict__ w,
                    const __grid_constant__ CUtensorMap wmap, bool tma,
                    const void* __restrict__ counts, int count_bytes,
                    const int32_t* __restrict__ sketch_idx,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ sums,
                    double* __restrict__ partials,
                    unsigned* __restrict__ tickets, int m, int d, int p,
                    int rows, int pg) {
  using Sum = std::conditional_t<FLOAT, double, long long>;
  constexpr int KC = kGenChunk;
  extern __shared__ __align__(16) float smem_raw[];  // kGenStages x stage
  __shared__ __align__(8) uint64_t bars[kGenStages];  // tma: one a stage
  __shared__ bool last;
  // 128-byte aligned, by offsetting the shared array itself: the compiler
  // keeps the shared address space (a pointer rebuilt from an integer would
  // turn every shared load into a generic one).
  float* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = lane % kGenPairs, slot = lane / kGenPairs;
  const int mt = TP * (blockDim.x / 32);  // point slots a tile
  const int r0 = blockIdx.x * kGenRows;
  const int rl = r0 + 2 * pair;  // this lane's first row
  const int sf = stage_floats(pg, mt), wf = weight_floats(pg);
  const int chunks = (d + KC - 1) / KC;
  const int steps = chunks * ((p + pg - 1) / pg);  // (pass, chunk) pairs
  const size_t buckets = (size_t)1 << p;
  // This lane's planes in a stage (a plane past pg reads the last one: its
  // bits are dropped), and the zeros past the last plane.
  int plane_off[PPL];
#pragma unroll
  for (int k = 0; k < PPL; ++k)
    plane_off[k] = min(slot + 4 * k, pg - 1) * KC * kGenRows + 2 * pair;
  for (int k = tid; k < kGenStages * kGenRows; k += blockDim.x)
    smem[(k / kGenRows) * sf + pg * KC * kGenRows + k % kGenRows] = 0.f;
  if (tma && tid == 0) {
    for (int i = 0; i < kGenStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int ntiles = (m + mt - 1) / mt;
  int g0 = 0;  // steps of earlier tiles: the ring's position and phases
  float xr[2 * TP];  // this thread's share of a chunk of the point tile
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y, g0 += steps) {
    const int base = t * mt, npts = min(mt, m - base);
    auto buffer = [&](int s) { return smem + ((g0 + s) % kGenStages) * sf; };
    // Step s (pass s / chunks, chunk s % chunks): its weights into its
    // buffer, by TMA (one thread) or by cp.async (every thread).
    auto stage_weights = [&](int s) {
      const int pass = s / chunks, j0 = pass * pg;
      const int f0 = (s - pass * chunks) * KC;
      if (tma) {
        if (tid == 0 && s < steps)
          tma_weights(buffer(s), &wmap, bars + (g0 + s) % kGenStages, pg, r0,
                      f0, j0);
      } else if (s < steps) {
        copy_weights(buffer(s), w, d, rows, pg, r0, f0, j0, min(pg, p - j0));
      } else {
        storm::cp_async_commit();  // an empty group keeps the count
      }
    };
    // Step s's 64 features of the tile's points (mt x 64 = 2 TP a thread:
    // feature tid % 64 of the points tid / 64 + e * blockDim.x / 64):
    // loaded into xr (zeros past d and npts), later stored to its buffer.
    const int fx = tid & 63, px = tid >> 6, pstep = blockDim.x >> 6;
    const float* qx = q + ((size_t)base + px) * d + fx;
    auto load_points = [&](int s) {
      const int pass = s / chunks, f0 = (s - pass * chunks) * KC;
      const bool in = s < steps && fx < d - f0 && fx < KC;
#pragma unroll
      for (int e = 0; e < 2 * TP; ++e)
        xr[e] = in && px + e * pstep < npts
                    ? __ldg(qx + (size_t)e * pstep * d + f0) : 0.f;
    };
    auto store_points = [&](int s) {
      float* xs = buffer(s) + wf + px * kGenXStride + fx;
#pragma unroll
      for (int e = 0; e < 2 * TP; ++e) xs[e * pstep * kGenXStride] = xr[e];
    };
    __syncthreads();  // zeros and barriers set; earlier buffers consumed
#pragma unroll
    for (int s = 0; s < kGenStages - 1; ++s) {
      stage_weights(s);
      load_points(s);
      store_points(s);
    }
    load_points(kGenStages - 1);
    int code[TP][2];
#pragma unroll
    for (int i = 0; i < TP; ++i) code[i][0] = code[i][1] = 0;
    float acc[TP][2][PPL];
    for (int s = 0; s < steps; ++s) {
      const int pass = s / chunks, c = s - pass * chunks, g = g0 + s;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int k = 0; k < PPL; ++k) acc[i][0][k] = acc[i][1][k] = 0.f;
      }
      if (tma)
        mbar_wait(bars + g % kGenStages, (g / kGenStages) & 1);
      else
        storm::cp_async_wait<kGenStages - 2>();
      __syncthreads();  // step s is in; every thread is done with s - 1
      // Into the buffer of step s - 1: the weights and points (loaded
      // during step s - 1) of step s + kGenStages - 1; then load the next
      // step's points, in flight while this one computes.
      stage_weights(s + kGenStages - 1);
      store_points(s + kGenStages - 1);
      load_points(s + kGenStages);
      const float* buf = buffer(s);
      const float* wj[PPL];
#pragma unroll
      for (int k = 0; k < PPL; ++k) wj[k] = buf + plane_off[k];
      project<PPL, TP>(buf + wf + warp * TP * kGenXStride, wj,
                       (min(KC, d - c * KC) + 3) >> 2, acc);
      if (c == chunks - 1) {  // this lane's bits, then the warp's codes
        const int j0 = pass * pg;
#pragma unroll
        for (int i = 0; i < TP; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int bits = 0;
#pragma unroll
            for (int k = 0; k < PPL; ++k) {
              const int j = slot + 4 * k;
              if (j < pg && j0 + j < p)
                bits |= (acc[i][h][k] > 0.f) << (j0 + j);
            }
            bits |= __shfl_xor_sync(0xffffffffu, bits, kGenPairs);
            bits |= __shfl_xor_sync(0xffffffffu, bits, 2 * kGenPairs);
            code[i][h] |= bits;
          }
      }
    }
    // Gather: slot s takes the warp's points s, s + 4, ...: its two rows'
    // cells, added over the 8 pairs by shuffles (a fixed tree).
#pragma unroll
    for (int i = 0; i < (TP + kGenSlots - 1) / kGenSlots; ++i) {
      const int tt = slot + kGenSlots * i;  // this lane's point of the warp
      const int k = warp * TP + tt, pt = base + k;
      Sum sum = 0;
      int cd[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < TP; ++j)  // code[tt] without local memory
        if (j == tt) cd[0] = code[j][0], cd[1] = code[j][1];
      if (tt < TP && k < npts) {
        const size_t table =
            BANKED ? (size_t)sketch_idx[pt] * rows * buckets : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rl + h < rows)
            add_count(sum, counts,
                      table + (size_t)(rl + h) * buckets + cd[h],
                      count_bytes);
      }
#pragma unroll
      for (int off = 1; off < kGenPairs; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (pair == 0 && tt < TP && k < npts)
        put_sum<FLOAT>(sum, pt, m, sums, partials);
    }
    finish_tile<FLOAT>(t, base, npts, m, rows, out, sums, partials, tickets,
                       &last);
  }
}

// The grid of one generic launch: x = blocks of 16 rows, y = point tiles of
// warps x tp slots.
struct Plan {
  int tp, warps, gx, gy;
};

// The smallest tile of tp in {3, 5, 9} points a warp and 4 or 8 warps
// (one or two a scheduler) that holds all m points; past 72, tiles of 72.
Plan make_plan(int m, int rows) {
  static constexpr int kShapes[][2] = {{3, 4}, {5, 4}, {3, 8}, {9, 4},
                                       {5, 8}, {9, 8}};
  Plan g{9, 8, 0, 0};
  for (const auto& s : kShapes)
    if (s[0] * s[1] >= m) {
      g.tp = s[0], g.warps = s[1];
      break;
    }
  const int mt = g.tp * g.warps;
  g.gx = (rows + kGenRows - 1) / kGenRows;
  g.gy = std::min((m + mt - 1) / mt, 65535);
  return g;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link against
// libcuda); null where it is missing.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// w as a (p, d, R) f32 tensor in boxes of (pg, 63, 16), zero-filled past
// its edges. False where TMA cannot take it (R % 4 != 0: rows are not
// 16-byte strided; w not 16-byte aligned; no encoder): then the block's
// threads copy the boxes with cp.async.
bool weight_map(CUtensorMap* map, const float* w, int d, int p, int rows,
                int pg) {
  const EncodeTiled encode = encoder();
  if (!encode || rows % 4 || reinterpret_cast<uintptr_t>(w) % 16) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)rows, (cuuint64_t)d, (cuuint64_t)p};
  const cuuint64_t strides[2] = {sizeof(float) * (cuuint64_t)rows,
                                 sizeof(float) * (cuuint64_t)rows * d};
  const cuuint32_t box[3] = {kGenRows, kGenChunk, (cuuint32_t)pg};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PPL, int TP, bool BANKED, bool FLOAT>
cudaError_t launch(const float* q, const float* w, const void* counts,
                   int count_bytes, const int32_t* sketch_idx, float* out,
                   unsigned long long* sums, double* partials,
                   unsigned* tickets, int m, int d, int p, int rows, int pg,
                   const Plan& g, cudaStream_t s) {
  auto kernel = sketch_query_kernel<PPL, TP, BANKED, FLOAT>;
  // + the alignment, and the slack that the last group's prefetch reads
  const size_t smem = sizeof(float) * kGenStages
                      * stage_floats(pg, TP * g.warps) + 128 + 64;
  if (smem > 48 * 1024) {  // opt in for what this launch needs
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap map{};
  const bool tma = weight_map(&map, w, d, p, rows, pg);
  kernel<<<dim3(g.gx, g.gy), 32 * g.warps, smem, s>>>(
      q, w, map, tma, counts, count_bytes, sketch_idx, out, sums, partials,
      tickets, m, d, p, rows, pg);
  return cudaGetLastError();
}

template <int PPL, bool BANKED, bool FLOAT>
cudaError_t dispatch_tp(const float* q, const float* w, const void* counts,
                        int count_bytes, const int32_t* sketch_idx,
                        float* out, unsigned long long* sums,
                        double* partials, unsigned* tickets, int m, int d,
                        int p, int rows, cudaStream_t s, int pg) {
  const Plan g = make_plan(m, rows);
#define STORM_GENERIC_TP(TP)                                                  \
  if (g.tp == TP)                                                             \
    return launch<PPL, TP, BANKED, FLOAT>(q, w, counts, count_bytes,          \
                                          sketch_idx, out, sums, partials,    \
                                          tickets, m, d, p, rows, pg, g, s);
  STORM_GENERIC_TP(3)
  STORM_GENERIC_TP(5)
  STORM_GENERIC_TP(9)
#undef STORM_GENERIC_TP
  return cudaErrorInvalidValue;
}

}  // namespace generic

// count_bytes: 4, 2 or 1 for int32, int16 or int8 tables; 4 for f32 ones
// (FLOAT).
template <bool BANKED, bool FLOAT>
cudaError_t query(const float* q, const float* w, const void* counts,
                  const int32_t* sketch_idx, float* out,
                  unsigned long long* sums, double* partials,
                  unsigned* tickets, int m, int d, int p, int rows,
                  int count_bytes, cudaStream_t s) {
  if (m == 0) return cudaSuccess;
  if (p < 1 || p > kMaxAllPlanes || rows < 1 || d < 1 ||
      (count_bytes != 4 && count_bytes != 2 && count_bytes != 1) ||
      (FLOAT && count_bytes != 4))
    return cudaErrorInvalidValue;
#define STORM_QUERY_ARGS                                                      \
  q, w, counts, count_bytes, sketch_idx, out, sums, partials, tickets, m, d,  \
      p, rows, s
  if (!staged(d, p)) {
    const int pg = generic::pass_planes(p);
    if (pg <= 4)
      return generic::dispatch_tp<1, BANKED, FLOAT>(STORM_QUERY_ARGS, pg);
    return generic::dispatch_tp<2, BANKED, FLOAT>(STORM_QUERY_ARGS, pg);
  }
  switch (p) {
    case 1: return dispatch_d<1, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 2: return dispatch_d<2, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 3: return dispatch_d<3, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 4: return dispatch_d<4, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 5: return dispatch_d<5, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 6: return dispatch_d<6, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 7: return dispatch_d<7, BANKED, FLOAT>(STORM_QUERY_ARGS);
    case 8: return dispatch_d<8, BANKED, FLOAT>(STORM_QUERY_ARGS);
  }
#undef STORM_QUERY_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (m, d) f32, w (p, d, R) f32, counts (R, 2^p) of count_bytes = 4 (int32),
// 2 (int16) or 1 (int8); out (m,) f32. sums and tickets (at least m each,
// int64 and int32) are the stream's workspace: all zero before the launch,
// and all zero again after it.
int storm_sketch_query(const void* q, const void* w, const void* counts,
                       void* out, void* sums, void* tickets, int m, int d,
                       int p, int rows, int count_bytes, void* stream) {
  return (int)query<false, false>(
      (const float*)q, (const float*)w, counts, nullptr, (float*)out,
      (unsigned long long*)sums, nullptr, (unsigned*)tickets, m, d, p, rows,
      count_bytes, (cudaStream_t)stream);
}

// The banked query: counts (S, R, 2^p), sketch_idx (m,) int32 in [0, S),
// checked by the caller; the rest as above.
int storm_sketch_query_banked(const void* q, const void* w, const void* counts,
                              const void* sketch_idx, void* out, void* sums,
                              void* tickets, int m, int d, int p, int rows,
                              int count_bytes, void* stream) {
  return (int)query<true, false>(
      (const float*)q, (const float*)w, counts, (const int32_t*)sketch_idx,
      (float*)out, (unsigned long long*)sums, nullptr, (unsigned*)tickets, m,
      d, p, rows, count_bytes, (cudaStream_t)stream);
}

// The float64 partials a query of f32 tables writes: one per (row slice,
// point) of the body that serves (d, p); -1 on a CUDA error.
long long storm_sketch_query_partials(int m, int d, int p, int rows) {
  if (m <= 0) return 0;
  if (!staged(d, p)) return (long long)generic::make_plan(m, rows).gx * m;
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return (long long)make_plan(m, d, p, rows, sms).gx * m;
}

// The queries of f32 tables, counts (R, 2^p), or (S, R, 2^p) with
// sketch_idx: partials (storm_sketch_query_partials of them) and tickets (at
// least m int32, all zero before and after, shared with the integer queries
// of the stream).
int storm_sketch_query_f32(const void* q, const void* w, const void* counts,
                           void* out, void* partials, void* tickets, int m,
                           int d, int p, int rows, void* stream) {
  return (int)query<false, true>(
      (const float*)q, (const float*)w, counts, nullptr, (float*)out, nullptr,
      (double*)partials, (unsigned*)tickets, m, d, p, rows, 4,
      (cudaStream_t)stream);
}

int storm_sketch_query_banked_f32(const void* q, const void* w,
                                  const void* counts, const void* sketch_idx,
                                  void* out, void* partials, void* tickets,
                                  int m, int d, int p, int rows,
                                  void* stream) {
  return (int)query<true, true>(
      (const float*)q, (const float*)w, counts, (const int32_t*)sketch_idx,
      (float*)out, nullptr, (double*)partials, (unsigned*)tickets, m, d, p,
      rows, 4, (cudaStream_t)stream);
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
