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
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// counts[k] of a table of count_bytes-wide integers, widened.
__device__ __forceinline__ long long count_at(const void* __restrict__ c,
                                              size_t k, int count_bytes) {
  if (count_bytes == 4) return static_cast<const int32_t*>(c)[k];
  if (count_bytes == 2) return static_cast<const int16_t*>(c)[k];
  return static_cast<const int8_t*>(c)[k];
}

// P > 0: the staged body (P planes, d <= DMAX); P = 0: the generic body.
template <int P, int DMAX, bool BANKED>
__global__ void __launch_bounds__(kMaxTile)
sketch_query_kernel(const float* __restrict__ q, const float* __restrict__ w,
                    const void* __restrict__ counts, int count_bytes,
                    const int32_t* __restrict__ sketch_idx,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ sums,
                    unsigned* __restrict__ tickets, int m, int d, int p,
                    int rows, int slice) {
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
      long long sum = 0;
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
          sum += count_at(counts, cell0 + (size_t)rr * buckets + code,
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
          sum += count_at(counts, cell0 + (size_t)rr * buckets + code,
                          count_bytes);
        }
      }
      if (sum != 0) atomicAdd(sums + i, (unsigned long long)sum);
    }
    __threadfence();  // this block's sums are visible before its ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + t, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) {  // every slice of tile t has added its sums
      if (i < m) {
        const long long total = (long long)atomicExch(sums + i, 0ull);
        out[i] = __fmul_rn(__ll2float_rn(total), __frcp_rn((float)rows));
      }
      if (tid == 0) tickets[t] = 0u;
    }
  }
}

template <int P, int DMAX, bool BANKED>
cudaError_t launch(const float* q, const float* w, const void* counts,
                   int count_bytes, const int32_t* sketch_idx, float* out,
                   unsigned long long* sums, unsigned* tickets, int m, int d,
                   int p, int rows, cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tile = m >= kMaxTile ? kMaxTile : (m + 31) / 32 * 32;
  const int ntiles = (m + tile - 1) / tile;
  const int gy = std::min(ntiles, 65535);
  const int want_gx = std::max(1, sms * kBlocksPerSm / gy);
  int slice = std::max((rows + want_gx - 1) / want_gx,
                       std::min(kMinRows, rows));
  if constexpr (P > 0)
    slice = std::min(slice, kWeightBytes / (int)(sizeof(float) * P * DMAX));
  const int gx = (rows + slice - 1) / slice;
  const size_t smem = P > 0 ? sizeof(float) * slice * P * DMAX : 0;
  sketch_query_kernel<P, DMAX, BANKED><<<dim3(gx, gy), tile, smem, s>>>(
      q, w, counts, count_bytes, sketch_idx, out, sums, tickets, m, d, p,
      rows, slice);
  return cudaGetLastError();
}

template <int P, bool BANKED>
cudaError_t dispatch_d(const float* q, const float* w, const void* counts,
                       int count_bytes, const int32_t* sketch_idx, float* out,
                       unsigned long long* sums, unsigned* tickets, int m,
                       int d, int p, int rows, cudaStream_t s) {
  if (d <= 12)
    return launch<P, 12, BANKED>(q, w, counts, count_bytes, sketch_idx, out,
                                 sums, tickets, m, d, p, rows, s);
  if (d <= 16)
    return launch<P, 16, BANKED>(q, w, counts, count_bytes, sketch_idx, out,
                                 sums, tickets, m, d, p, rows, s);
  return launch<P, 32, BANKED>(q, w, counts, count_bytes, sketch_idx, out,
                               sums, tickets, m, d, p, rows, s);
}

template <bool BANKED>
cudaError_t query(const float* q, const float* w, const void* counts,
                  const int32_t* sketch_idx, float* out,
                  unsigned long long* sums, unsigned* tickets, int m, int d,
                  int p, int rows, int count_bytes, cudaStream_t s) {
  if (m == 0) return cudaSuccess;
  if (p < 1 || p > 30 || rows < 1 ||
      (count_bytes != 4 && count_bytes != 2 && count_bytes != 1))
    return cudaErrorInvalidValue;
  if (d > kMaxFeatures || p > kMaxPlanes)
    return launch<0, 4, BANKED>(q, w, counts, count_bytes, sketch_idx, out,
                                sums, tickets, m, d, p, rows, s);
#define STORM_QUERY_P(P)                                                      \
  case P:                                                                     \
    return dispatch_d<P, BANKED>(q, w, counts, count_bytes, sketch_idx, out,  \
                                 sums, tickets, m, d, p, rows, s);
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
  return (int)query<false>((const float*)q, (const float*)w, counts, nullptr,
                           (float*)out, (unsigned long long*)sums,
                           (unsigned*)tickets, m, d, p, rows, count_bytes,
                           (cudaStream_t)stream);
}

// The banked query: counts (S, R, 2^p), sketch_idx (m,) int32 in [0, S),
// checked by the caller; the rest as above.
int storm_sketch_query_banked(const void* q, const void* w, const void* counts,
                              const void* sketch_idx, void* out, void* sums,
                              void* tickets, int m, int d, int p, int rows,
                              int count_bytes, void* stream) {
  return (int)query<true>((const float*)q, (const float*)w, counts,
                          (const int32_t*)sketch_idx, (float*)out,
                          (unsigned long long*)sums, (unsigned*)tickets, m, d,
                          p, rows, count_bytes, (cudaStream_t)stream);
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
