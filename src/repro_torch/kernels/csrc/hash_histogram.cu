// Single-sided insert for Hopper: SRP hash of pre-augmented points + masked
// (R, 2^p) histogram, for one stream or a stack of tenant streams.
//
// Replaces the Pallas TPU kernels `hash_histogram` and `hash_histogram_banked`
// in src/repro/kernels/storm_sketch.py. Those expand each code into a one-hot
// cube and reduce it on the MXU because the TPU has no fast scatter; here the
// insert is a plain histogram.
//
// What bounds it on the H100: arithmetic. Every (point, row) pair costs p*d
// multiply-adds plus one bucket increment, while each point is d + 1 floats of
// input: at the classification path's shapes (n = 2^22, d = 11 augmented
// features, R = 1024, p = 2) that is ~1.9e11 flops against ~0.2 GB of reads.
//
// Design: the paired insert's (paired_hash_histogram.cu) without the negative
// side.
//   * Blocks tile (R-tile x n-chunk x tenant). Each thread owns one hash row r
//     and keeps its p*d weights in registers for the whole chunk.
//   * A block stages a tile of points in shared memory; every thread reads the
//     same point, so the reads are broadcasts.
//   * The rows are already augmented ([z, 0, pad], lsh.augment_data), so the
//     kernel computes no pad: it projects every feature, in index order, with
//     __fmul_rn/__fadd_rn (no FMA contraction), as the plain PyTorch version
//     does, and the two compare bit for bit. The loop is storm::srp_code
//     (insert_common.cuh), shared with srp_hash.cu.
//   * Each thread owns one column of a bucket-major (2^p, threads) histogram in
//     shared memory: one conflict-free read-modify-write per point.
//   * Blocks merge with one integer atomicAdd per cell into an int32 table:
//     integer adds commute, so the result is exact whatever the block order.
//   * A narrow output (int16/int8) is one saturating cast after the histogram.
//   * Grid axis z is the tenant: its blocks read x[s], mask[s] and write table
//     s under the one shared hash family, so slice s of a bank equals the lone
//     insert of tenant s bit for bit. The lone entry point compiles the body
//     without the tenant offsets (BANKED = false).
#include <cuda_runtime.h>
#include <stdint.h>

#include "insert_common.cuh"

namespace {

using storm::kTilePoints;

template <int P, int DMAX, bool BANKED>
__global__ void hist_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ mask,
                            int32_t* __restrict__ hist, int n, int d, int rows,
                            int chunk) {
  constexpr int B = 1 << P;
  extern __shared__ float smem[];
  float* xs = smem;                    // (kTilePoints, d)
  float* ms = xs + kTilePoints * d;    // (kTilePoints,)
  int* hs = reinterpret_cast<int*>(ms + kTilePoints);  // (B, blockDim)

  if (BANKED) {  // this block's stream and table
    const size_t tenant = blockIdx.z;
    x += tenant * n * d;
    mask += tenant * n;
    hist += tenant * rows * B;
  }
  const int tid = threadIdx.x;
  const int r = blockIdx.x * blockDim.x + tid;
  const bool active = r < rows;

  float wr[P][DMAX];  // the row's weights, per plane
  storm::load_row_weights<P, DMAX>(w, r, d, rows, active, wr);
  // Thread tid owns column tid of the bucket-major histogram: no two threads
  // share a word, and a warp's accesses fall in 32 distinct banks.
  int* col = hs + tid;
  for (int b = 0; b < B; ++b) col[b * blockDim.x] = 0;

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  for (long long base = start; base < end; base += kTilePoints) {
    const int npts = (int)min((long long)kTilePoints, end - base);
    __syncthreads();  // the previous tile has been consumed
    const float* src = x + base * d;
    for (int k = tid; k < npts * d; k += blockDim.x) xs[k] = src[k];
    for (int pt = tid; pt < npts; pt += blockDim.x) ms[pt] = mask[base + pt];
    __syncthreads();
    if (!active) continue;
    for (int pt = 0; pt < npts; ++pt) {
      const int inc = (int)ms[pt];
      if (inc == 0) continue;
      float xa[DMAX];  // the point's features, read once into registers
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        xa[i] = i < d ? xs[pt * d + i] : 0.f;
      col[storm::srp_code<P, DMAX>(xa, wr, d) * blockDim.x] += inc;
    }
  }
  if (!active) return;
  int32_t* out = hist + (size_t)r * B;
  for (int b = 0; b < B; ++b) {
    const int c = col[b * blockDim.x];
    if (c != 0) atomicAdd(out + b, c);
  }
}

template <int P, int DMAX>
cudaError_t launch(const float* x, const float* w, const float* mask,
                   int32_t* hist, int n, int d, int rows, int tenants,
                   cudaStream_t stream) {
  const int threads = storm::insert_threads(P);
  const size_t smem = sizeof(float) * ((size_t)kTilePoints * (d + 1))
                      + sizeof(int) * (size_t)(1 << P) * threads;
  dim3 grid;
  int chunk = 0;
  cudaError_t err = storm::insert_grid(n, rows, threads, tenants, &grid, &chunk);
  if (err != cudaSuccess) return err;
  if (tenants == 1)  // the lone kernel carries no tenant offsets
    hist_kernel<P, DMAX, false><<<grid, threads, smem, stream>>>(
        x, w, mask, hist, n, d, rows, chunk);
  else
    hist_kernel<P, DMAX, true><<<grid, threads, smem, stream>>>(
        x, w, mask, hist, n, d, rows, chunk);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_p(int p, const float* x, const float* w, const float* mask,
                       int32_t* hist, int n, int d, int rows, int tenants,
                       cudaStream_t stream) {
  switch (p) {
    case 1: return launch<1, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 2: return launch<2, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 3: return launch<3, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 4: return launch<4, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 5: return launch<5, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 6: return launch<6, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 7: return launch<7, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    case 8: return launch<8, DMAX>(x, w, mask, hist, n, d, rows, tenants, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The insert of `tenants` stacked streams, then the epilogue.
cudaError_t insert(const float* x, const float* w, const float* mask,
                   int32_t* hist, void* out, int tenants, int n, int d, int p,
                   int rows, int out_bytes, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (n == 0)
    ;  // empty streams leave the zeroed tables as they are
  else if (d <= 16)
    err = dispatch_p<16>(p, x, w, mask, hist, n, d, rows, tenants, s);
  else if (d <= 32)
    err = dispatch_p<32>(p, x, w, mask, hist, n, d, rows, tenants, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return storm::cast_out(hist, out, ((long long)tenants * rows) << p,
                         out_bytes, s);
}

}  // namespace

extern "C" {

// x (n, d) f32 (already augmented), w (p, d, R) f32, mask (n,) f32, hist
// (R, 2^p) int32 zeroed by the caller. out_bytes selects the output: 4 = hist
// itself (out unused), 2 = int16, 1 = int8, written to out after one
// saturating cast.
int storm_hash_histogram(const void* x, const void* w, const void* mask,
                         void* hist, void* out, int n, int d, int p, int rows,
                         int out_bytes, void* stream) {
  return (int)insert((const float*)x, (const float*)w, (const float*)mask,
                     (int32_t*)hist, out, 1, n, d, p, rows, out_bytes,
                     (cudaStream_t)stream);
}

// The banked insert: x (S, n, d), mask (S, n), hist (S, R, 2^p) int32 zeroed
// by the caller, out as above over all S tables; w is shared.
int storm_hash_histogram_banked(const void* x, const void* w, const void* mask,
                                void* hist, void* out, int tenants, int n,
                                int d, int p, int rows, int out_bytes,
                                void* stream) {
  return (int)insert((const float*)x, (const float*)w, (const float*)mask,
                     (int32_t*)hist, out, tenants, n, d, p, rows, out_bytes,
                     (cudaStream_t)stream);
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
