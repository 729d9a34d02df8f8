// Shared by the insert kernels (paired_hash_histogram.cu, hash_histogram.cu),
// the SRP hash (srp_hash.cu) and the projection tile (projection_tile.cuh):
// the grid sizing over (R-tile, n-chunk, tenant), the load of a hash row's
// weights into registers, the cp.async helpers and the inserts' staging of
// a tile, the warp-ballot compaction of its valid points into records, the
// bit-plane counting of a group of 32 records, and the saturating epilogue
// that narrows the int32 histogram to int16/int8.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace storm {

constexpr int kTilePoints = 64;   // points staged in shared memory per step
constexpr int kBlocksPerSm = 8;   // target resident blocks when sizing the grid

// Threads per block of an insert kernel: one hash row each, and the
// bucket-major histogram (2^p ints per thread) stays within 32 KB.
inline int insert_threads(int p) { return std::min(128, 8192 >> p); }

// The grid of an insert over `tenants` streams of n points each:
// x = R-tiles of `threads` rows, z = the tenant, y = n-chunks of whole
// tiles of `tile` points, enough of them to fill the card. Writes the grid
// and the points per chunk.
inline cudaError_t insert_grid(int n, int rows, int threads, int tenants,
                               dim3* grid, int* chunk,
                               int tile = kTilePoints) {
  if (tenants < 1 || tenants > 65535) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long gx = (rows + threads - 1) / threads;
  const long long tiles = ((long long)n + tile - 1) / tile;
  long long gy = ((long long)sms * kBlocksPerSm + gx * tenants - 1) /
                 (gx * tenants);
  gy = std::max(1LL, std::min(gy, std::min(tiles, 65535LL)));
  const long long per = (tiles + gy - 1) / gy * tile;
  gy = ((long long)n + per - 1) / per;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)tenants);
  *chunk = (int)per;
  return cudaSuccess;
}

// Hash row r's weights, plane by plane, into registers: wr[j][i] =
// w[j, i, r] for i < d, 0 beyond d and for an inactive row. w is (P, d, R).
template <int P, int DMAX>
__device__ __forceinline__ void load_row_weights(const float* __restrict__ w,
                                                 int r, int d, int rows,
                                                 bool active,
                                                 float (&wr)[P][DMAX]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      wr[j][i] = (active && i < d) ? w[((size_t)j * d + i) * rows + r] : 0.f;
  }
}

// ---- the inserts' tile pipeline -------------------------------------------

constexpr int kGroup = 32;  // records per bit-plane word
constexpr int kSub = 8;     // records per unrolled step of the group loop

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of one tile into shared memory and commit them as one
// group: `count` floats of points from src to dst (16 bytes at a time where
// src is 16-byte aligned, dst always is; 4 bytes otherwise and for the
// tail), and npts mask values from msrc to mdst. All threads of the block
// call it.
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int count, float* mdst,
                                           const float* msrc, int npts,
                                           int tid, int nthr) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    for (int i = tid; i < n4; i += nthr) cp_async16(dst + 4 * i, src + 4 * i);
    i0 = n4 << 2;
  }
  for (int i = i0 + tid; i < count; i += nthr) cp_async4(dst + i, src + i);
  for (int i = tid; i < npts; i += nthr) cp_async4(mdst + i, msrc + i);
  cp_async_commit();
}

// The slot of this lane's point among the tile's kept points: a warp ballot
// of `keep` and one shared atomicAdd per warp on *count, so the kept points
// of a warp take consecutive slots. Every lane of the warp calls it.
__device__ __forceinline__ int compact_slot(bool keep, int* count) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  int slot = 0;
  if (lane == 0 && ballot != 0) slot = atomicAdd(count, __popc(ballot));
  return __shfl_sync(0xffffffffu, slot, 0)
         + __popc(ballot & ((1u << lane) - 1u));
}

// Record k of a tile: REC floats (a multiple of 4) as REC/4 float4 stores
// and broadcast loads.
template <int REC>
__device__ __forceinline__ void store_record(float* recs, int k,
                                             const float (&v)[REC]) {
  float4* dst = reinterpret_cast<float4*>(recs) + k * (REC / 4);
#pragma unroll
  for (int q = 0; q < REC / 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int REC>
__device__ __forceinline__ void load_record(const float* recs, int k,
                                            float (&v)[REC]) {
  const float4* src = reinterpret_cast<const float4*>(recs) + k * (REC / 4);
#pragma unroll
  for (int q = 0; q < REC / 4; ++q) {
    const float4 a = src[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// One side of a group of up to 32 records against one hash row: bit k of
// words[j] says plane j of record k is on. cnt[b] += popc(M_b & valid), M_b
// the AND over planes j of words[j] (bit j of b set) or ~words[j], built as
// a binary tree: level j splits each bucket below 2^j on plane j. The loops
// have constant bounds so that they unroll and the words stay in registers.
template <int P>
__device__ __forceinline__ void count_group(const unsigned (&words)[P],
                                            unsigned valid,
                                            int (&cnt)[1 << P]) {
  unsigned m[1 << P];
  m[0] = valid;
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int b = (1 << P) - 1; b >= 0; --b) {
      if (b >= (2 << j)) continue;  // not yet split
      if (b & (1 << j))
        m[b] = m[b ^ (1 << j)] & words[j];
      else
        m[b] &= ~words[j];
    }
  }
#pragma unroll
  for (int b = 0; b < (1 << P); ++b) cnt[b] += __popc(m[b]);
}

// The narrow bodies keep a hash row's weights in registers, which bounds them
// to d <= 32 and p <= 8; every other shape takes the wide body
// (projection_tile.cuh).
constexpr int kNarrowFeatures = 32;
constexpr int kNarrowPlanes = 8;

template <typename T>
__global__ void saturating_cast_kernel(const int32_t* __restrict__ src,
                                       T* __restrict__ dst, long long count,
                                       int lo, int hi) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = (T)min(max(src[i], lo), hi);
}

// out_bytes = 4: the int32 histogram is the output, nothing to do;
// 2 / 1: one saturating cast of all `count` cells into int16 / int8 `out`.
inline cudaError_t cast_out(const int32_t* hist, void* out, long long count,
                            int out_bytes, cudaStream_t stream) {
  if (out_bytes == 4 || count == 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  if (out_bytes == 2)
    saturating_cast_kernel<int16_t><<<blocks, threads, 0, stream>>>(
        hist, (int16_t*)out, count, -32768, 32767);
  else if (out_bytes == 1)
    saturating_cast_kernel<int8_t><<<blocks, threads, 0, stream>>>(
        hist, (int8_t*)out, count, -128, 127);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace storm
