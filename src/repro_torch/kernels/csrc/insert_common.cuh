// Shared by the insert kernels (paired_hash_histogram.cu, hash_histogram.cu)
// and the SRP hash (srp_hash.cu): the grid sizing over (R-tile, n-chunk,
// tenant), the one-row projection loop of the single-sided hash, and the
// saturating epilogue that narrows the int32 histogram to int16/int8.
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

// The SRP code of one point xa (d features) against one hash row wr:
// sum_j (xa . wr[j] > 0) << j. Each plane's projection accumulates feature by
// feature in index order, a rounded multiply then a rounded add (__fmul_rn /
// __fadd_rn: no FMA contraction, no TF32), as the plain PyTorch version does
// (kernels/ref.py, _project), so kernel and plain version agree bit for bit.
template <int P, int DMAX>
__device__ __forceinline__ int srp_code(const float (&xa)[DMAX],
                                        const float (&wr)[P][DMAX], int d) {
  int code = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) acc = __fadd_rn(acc, __fmul_rn(xa[i], wr[j][i]));
    code |= (acc > 0.f) << j;
  }
  return code;
}

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
