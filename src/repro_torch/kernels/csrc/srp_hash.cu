// SRP hash for Hopper: codes[i, r] = sum_j (x_i . w[j, :, r] > 0) << j, as
// (n, R) int32, for x (n, d) fp32 and w (p, d, R) fp32.
//
// Replaces the Pallas TPU kernel `srp_hash` in src/repro/kernels/srp_hash.py.
// That kernel tiles (bn, bd) @ (bd, br) matmuls through VMEM accumulators
// because the MXU wants 128-aligned products; here the contraction is short
// (d is 12 on the regression path, d_model + 3 for probes) and must round
// exactly as the plain PyTorch version does, so it runs on the CUDA cores.
//
// What bounds it on the H100: at the regression family's widths (n = 2^18,
// d = 12, R = 2048, p = 4) 2*n*d*R*p = 5.2e10 fp32 operations (0.77 ms at
// 67 TFLOP/s) against 2.1 GB of int32 codes written (0.64 ms at 3.35 TB/s).
// The no-FMA arithmetic that bit equality needs issues a multiply and an
// add per term, so the operations side binds first.
//
// Design:
//   * Register path (p <= 8, d <= 32, the hashes of the sketch paths): each
//     thread owns one hash row r and keeps its p*d weights in registers for
//     its whole chunk of points; a block stages a tile of points in shared
//     memory (every thread reads the same point: broadcasts), computes the
//     code with storm::srp_code (insert_common.cuh, the loop the
//     single-sided insert runs) and stores it. A warp stores 32 neighbouring
//     rows of one point: one coalesced 128-byte store per point.
//   * Tiled path (wider d or more planes, up to p = 30): a block computes a
//     tile of 8 points x 32 rows, one code per thread. For each plane it
//     walks the features in chunks of 128, staging the points' features and
//     the rows' weights in shared memory, and carries the accumulator across
//     chunks, so d is unbounded and the sum keeps index order.
//   * Both accumulate feature by feature in index order with __fmul_rn /
//     __fadd_rn (no FMA contraction, no TF32), as kernels/ref.py's _project
//     does: kernel and plain version compare bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "insert_common.cuh"

namespace {

using storm::kTilePoints;

constexpr int kRegThreads = 128;  // rows per block on the register path
constexpr int kTileRows = 32;     // tiled path: rows per block (one warp)
constexpr int kTilePts = 8;       // tiled path: points per block
constexpr int kFeatChunk = 128;   // tiled path: features staged per step

template <int P, int DMAX>
__global__ void srp_hash_reg_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    int32_t* __restrict__ codes, int n, int d,
                                    int rows, int chunk) {
  extern __shared__ float xs[];  // (kTilePoints, d)
  const int tid = threadIdx.x;
  const int r = blockIdx.x * blockDim.x + tid;
  const bool active = r < rows;
  float wr[P][DMAX];
  storm::load_row_weights<P, DMAX>(w, r, d, rows, active, wr);

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  for (long long base = start; base < end; base += kTilePoints) {
    const int npts = (int)min((long long)kTilePoints, end - base);
    __syncthreads();  // the previous tile has been consumed
    const float* src = x + base * d;
    for (int k = tid; k < npts * d; k += blockDim.x) xs[k] = src[k];
    __syncthreads();
    if (!active) continue;
    int32_t* out = codes + base * rows + r;
    for (int pt = 0; pt < npts; ++pt) {
      float xa[DMAX];  // the point's features, read once into registers
#pragma unroll
      for (int i = 0; i < DMAX; ++i) xa[i] = i < d ? xs[pt * d + i] : 0.f;
      out[(size_t)pt * rows] = storm::srp_code<P, DMAX>(xa, wr, d);
    }
  }
}

__global__ void srp_hash_tiled_kernel(const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      int32_t* __restrict__ codes, int n,
                                      int d, int p, int rows) {
  __shared__ float xs[kTilePts][kFeatChunk];
  __shared__ float ws[kFeatChunk][kTileRows];
  const int col = threadIdx.x;  // the block's row
  const int pt = threadIdx.y;   // the block's point
  const int tid = pt * kTileRows + col;
  const int r0 = blockIdx.x * kTileRows;
  const long long tiles = ((long long)n + kTilePts - 1) / kTilePts;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long i0 = tile * kTilePts;
    int code = 0;
    for (int j = 0; j < p; ++j) {
      float acc = 0.f;
      for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
        const int nf = min(kFeatChunk, d - f0);
        __syncthreads();  // the previous chunk has been consumed
        for (int k = tid; k < kTilePts * nf; k += kTilePts * kTileRows) {
          const int kp = k / nf, kf = k - kp * nf;
          const long long i = i0 + kp;
          xs[kp][kf] = i < n ? x[i * d + f0 + kf] : 0.f;
        }
        for (int k = tid; k < nf * kTileRows; k += kTilePts * kTileRows) {
          const int kf = k / kTileRows, kc = k - kf * kTileRows;
          const int r = r0 + kc;
          ws[kf][kc] = r < rows ? w[((size_t)j * d + f0 + kf) * rows + r]
                                : 0.f;
        }
        __syncthreads();
        for (int f = 0; f < nf; ++f)
          acc = __fadd_rn(acc, __fmul_rn(xs[pt][f], ws[f][col]));
      }
      code |= (acc > 0.f) << j;
    }
    const long long i = i0 + pt;
    const int r = r0 + col;
    if (i < n && r < rows) codes[i * rows + r] = code;
  }
}

template <int P, int DMAX>
cudaError_t launch_reg(const float* x, const float* w, int32_t* codes, int n,
                       int d, int rows, cudaStream_t stream) {
  dim3 grid;
  int chunk = 0;
  cudaError_t err = storm::insert_grid(n, rows, kRegThreads, 1, &grid, &chunk);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (size_t)kTilePoints * d;
  srp_hash_reg_kernel<P, DMAX><<<grid, kRegThreads, smem, stream>>>(
      x, w, codes, n, d, rows, chunk);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_p(int p, const float* x, const float* w, int32_t* codes,
                       int n, int d, int rows, cudaStream_t s) {
  switch (p) {
    case 1: return launch_reg<1, DMAX>(x, w, codes, n, d, rows, s);
    case 2: return launch_reg<2, DMAX>(x, w, codes, n, d, rows, s);
    case 3: return launch_reg<3, DMAX>(x, w, codes, n, d, rows, s);
    case 4: return launch_reg<4, DMAX>(x, w, codes, n, d, rows, s);
    case 5: return launch_reg<5, DMAX>(x, w, codes, n, d, rows, s);
    case 6: return launch_reg<6, DMAX>(x, w, codes, n, d, rows, s);
    case 7: return launch_reg<7, DMAX>(x, w, codes, n, d, rows, s);
    case 8: return launch_reg<8, DMAX>(x, w, codes, n, d, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tiled(const float* x, const float* w, int32_t* codes,
                         int n, int d, int p, int rows, cudaStream_t s) {
  const long long tiles = ((long long)n + kTilePts - 1) / kTilePts;
  const dim3 grid((unsigned)((rows + kTileRows - 1) / kTileRows),
                  (unsigned)(tiles < 65535 ? tiles : 65535));
  srp_hash_tiled_kernel<<<grid, dim3(kTileRows, kTilePts), 0, s>>>(
      x, w, codes, n, d, p, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, d) f32, w (p, d, R) f32, codes (n, R) int32; 1 <= p <= 30, d >= 1.
int storm_srp_hash(const void* x, const void* w, void* codes, int n, int d,
                   int p, int rows, void* stream) {
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  int32_t* out = (int32_t*)codes;
  cudaStream_t s = (cudaStream_t)stream;
  if (p < 1 || p > 30 || d < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err;
  if (p <= 8 && d <= 16)
    err = dispatch_p<16>(p, xf, wf, out, n, d, rows, s);
  else if (p <= 8 && d <= 32)
    err = dispatch_p<32>(p, xf, wf, out, n, d, rows, s);
  else
    err = launch_tiled(xf, wf, out, n, d, p, rows, s);
  return (int)err;
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
