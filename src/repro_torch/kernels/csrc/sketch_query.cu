// Batched RACE query for Hopper: hash each query, gather counts[r, code_r],
// mean over the R rows.
//
// Replaces the Pallas TPU kernel `sketch_query` in
// src/repro/kernels/sketch_query.py. That kernel gathers through a one-hot
// contraction on the MXU because the TPU has no fast gather; here the gather
// is an indexed load.
//
// What bounds it on the H100: latency at the main path's m, operations at
// large m. On the main path m is small (F*(2k+1) = 17 points per DFO step,
// 198 per refine batch, 272 for a 16-tenant fleet, 512 gateway slots): the
// work is m*R*p*d multiply-adds and m*R gathers from a table that stays in
// L2 (128 KB lone, 2 MB for a 16-tenant bank). The hash family w is p*d*R
// floats (393 KB at the regression family's p = 4, d = 12, R = 2048).
//
// Design (one block per point, each reading all of w, moved m x 393 KB
// through L2 per launch and kept 17 SMs busy at m = 17):
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
//     DMAX features a plane (p <= 8, d <= 32; DMAX in {12, 16, 32}), then
//     each thread hashes its point (held in registers) against every row of
//     the slice: index-order __fmul_rn/__fadd_rn from +0, as the plain
//     version does. The padded features add 0 * 0 = +0, which changes no
//     nonzero sum and no comparison. Wider rows and p > 8 take a generic
//     body that reads w from global memory (off the main path).
//   * Gather: counts[r, code] (banked: of table sketch_idx[i]), narrow
//     counters widened at the load, summed over the slice in int64.
//   * Reduce exactly: each thread adds its slice sum to an int64 per-point
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
//     finish, so each thread sums its slice in float64, in row order, and
//     writes one partial per (slice, point) to a float64 workspace; the last
//     block of the tile sums the partials in slice order, converts once to
//     f32 and scales by fp32(1/R). Two launches on the same inputs give the
//     same bits; on integer-valued tables the float64 sums are exact, so the
//     result equals the integer body's bit for bit. Every partial is written
//     before it is read, so this workspace needs no zeroing either.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// P > 0: the staged body (P planes, d <= DMAX); P = 0: the generic body.
// FLOAT: f32 tables, reduced through `partials` (gridDim.x x m float64);
// else integer tables, reduced through `sums` (m int64).
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
  if constexpr (P > 0) {
    // Row fastest, so that a warp reads neighbouring rows of one feature.
    for (int k = tid; k < nr * P * DMAX; k += tile) {
      const int rr = k % nr, rest = k / nr;
      const int f = rest % DMAX, j = rest / DMAX;
      wsm[(rr * P + j) * DMAX + f] =
          f < d ? w[((size_t)j * d + f) * rows + r0 + rr] : 0.f;
    }
    __syncthreads();
  }
  const int ntiles = (m + tile - 1) / tile;
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int i = t * tile + tid;
    if (i < m) {
      const size_t table =
          BANKED ? (size_t)sketch_idx[i] * rows * buckets : 0;
      const size_t cell0 = table + (size_t)r0 * buckets;
      Sum sum = 0;
      if constexpr (P > 0) {
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
      } else {
        const float* qi = q + (size_t)i * d;
        for (int rr = 0; rr < nr; ++rr) {
          const int r = r0 + rr;
          int code = 0;
          for (int j = 0; j < p; ++j) {
            const float* wj = w + (size_t)j * d * rows + r;
            float acc = 0.f;
            for (int f = 0; f < d; ++f)
              acc = __fadd_rn(acc, __fmul_rn(qi[f], wj[(size_t)f * rows]));
            code |= (acc > 0.f) << j;
          }
          add_count(sum, counts, cell0 + (size_t)rr * buckets + code,
                    count_bytes);
        }
      }
      if constexpr (FLOAT)
        partials[(size_t)blockIdx.x * m + i] = sum;
      else if (sum != 0)
        atomicAdd(sums + i, (unsigned long long)sum);
    }
    __threadfence();  // this block's sums are visible before its ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + t, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) {  // every slice of tile t has added its sums
      if (i < m) {
        if constexpr (FLOAT) {
          double total = 0.0;  // in slice order: the same bits every launch
          for (int x = 0; x < (int)gridDim.x; ++x)
            total += __ldcg(partials + (size_t)x * m + i);
          out[i] = __fmul_rn(__double2float_rn(total),
                             __frcp_rn((float)rows));
        } else {
          const long long total = (long long)atomicExch(sums + i, 0ull);
          out[i] = __fmul_rn(__ll2float_rn(total), __frcp_rn((float)rows));
        }
      }
      if (tid == 0) tickets[t] = 0u;
    }
  }
}

// The grid of one launch: x = slices of `slice` rows, y = point tiles.
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
  if (d <= kMaxFeatures && p <= kMaxPlanes) {  // the staged body's weights
    const int dmax = d <= 12 ? 12 : d <= 16 ? 16 : 32;
    g.slice = std::min(g.slice, kWeightBytes / (int)(sizeof(float) * p * dmax));
  }
  g.gx = (rows + g.slice - 1) / g.slice;
  return g;
}

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
  const size_t smem = P > 0 ? sizeof(float) * g.slice * P * DMAX : 0;
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

// count_bytes: 4, 2 or 1 for int32, int16 or int8 tables; 4 for f32 ones
// (FLOAT).
template <bool BANKED, bool FLOAT>
cudaError_t query(const float* q, const float* w, const void* counts,
                  const int32_t* sketch_idx, float* out,
                  unsigned long long* sums, double* partials,
                  unsigned* tickets, int m, int d, int p, int rows,
                  int count_bytes, cudaStream_t s) {
  if (m == 0) return cudaSuccess;
  if (p < 1 || p > 30 || rows < 1 ||
      (count_bytes != 4 && count_bytes != 2 && count_bytes != 1) ||
      (FLOAT && count_bytes != 4))
    return cudaErrorInvalidValue;
  if (d > kMaxFeatures || p > kMaxPlanes)
    return launch<0, 4, BANKED, FLOAT>(q, w, counts, count_bytes, sketch_idx,
                                       out, sums, partials, tickets, m, d, p,
                                       rows, s);
#define STORM_QUERY_P(P)                                                      \
  case P:                                                                     \
    return dispatch_d<P, BANKED, FLOAT>(q, w, counts, count_bytes,            \
                                        sketch_idx, out, sums, partials,      \
                                        tickets, m, d, p, rows, s);
  switch (p) {
    STORM_QUERY_P(1)
    STORM_QUERY_P(2)
    STORM_QUERY_P(3)
    STORM_QUERY_P(4)
    STORM_QUERY_P(5)
    STORM_QUERY_P(6)
    STORM_QUERY_P(7)
    STORM_QUERY_P(8)
  }
#undef STORM_QUERY_P
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
// point); -1 on a CUDA error.
long long storm_sketch_query_partials(int m, int d, int p, int rows) {
  int sms = 0;
  if (m <= 0) return 0;
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
