// Antithetic PRP insert for Hopper: paired SRP hash + masked (R, 2^p) histogram.
//
// Replaces the Pallas TPU kernel `paired_hash_histogram` in
// src/repro/kernels/storm_sketch.py. That kernel expands each code into a
// one-hot cube and reduces it on the MXU because the TPU has no fast scatter;
// here the insert is a plain histogram.
//
// What bounds it on the H100: arithmetic. Every (point, row) pair costs
// p*(d+2) multiply-adds plus two bucket increments, while each point is only
// (d+1) floats of input: at the main path's shapes (n = 2^22, d+2 = 12,
// R = 2048, p = 4) that is ~8.2e11 flops against ~0.2 GB of reads.
//
// Design:
//   * Blocks tile (R-tile x n-chunk x tenant). Each thread owns one hash row r
//     and keeps its p*(d+1) weights in registers for the whole chunk.
//   * A block stages a tile of points (and their pad = sqrt(max(0, 1-|z|^2)))
//     in shared memory; every thread reads the same point, so the reads are
//     broadcasts.
//   * The projection of the augmented row [z, 0, pad] is accumulated feature
//     by feature in index order with __fmul_rn/__fadd_rn (no FMA contraction),
//     the zero feature skipped and the pad term last. The plain PyTorch
//     version does the same arithmetic, so the two compare bit for bit. The
//     negative side is derived from the same accumulator as
//     acc < 2*pad*w_pad, exactly as the JAX code does.
//   * Each thread owns one column of a bucket-major (2^p, threads) histogram in
//     shared memory: two conflict-free read-modify-writes per point, no
//     atomics.
//   * Blocks merge with integer atomicAdd into an int32 (R, 2^p) table: integer
//     adds commute, so the result is exact whatever the block order.
//   * A narrow output (int16/int8) is one saturating cast after the histogram.
//     Counters only grow, so one clamp of the whole stream's total equals the
//     JAX per-batch saturating scan; one launch takes the whole masked stream.
//   * The banked entry point (replacing `paired_hash_histogram_banked` of the
//     same JAX file) runs the same kernel body over a tenant stack: grid axis
//     z is the tenant, whose blocks read z[s], mask[s] and write table s under
//     the one shared hash family, so slice s of a bank equals the lone insert
//     of tenant s bit for bit. The lone entry point compiles the body without
//     the tenant offsets (BANKED = false): carrying them cost the lone kernel
//     7% of its time on the H100.
#include <cuda_runtime.h>
#include <stdint.h>

#include "insert_common.cuh"

namespace {

using storm::kTilePoints;

template <int P, int DMAX, bool BANKED>
__global__ void paired_hist_kernel(const float* __restrict__ z,
                                   const float* __restrict__ w,
                                   const float* __restrict__ mask,
                                   int32_t* __restrict__ hist,
                                   int n, int d, int rows, int chunk) {
  constexpr int B = 1 << P;
  extern __shared__ float smem[];
  float* zs = smem;                          // (kTilePoints, d)
  float* pads = zs + kTilePoints * d;        // (kTilePoints,)
  float* ms = pads + kTilePoints;            // (kTilePoints,)
  int* hs = reinterpret_cast<int*>(ms + kTilePoints);  // (B, blockDim)

  const int d2 = d + 2;  // w's feature count: [z, 0, pad]
  if (BANKED) {  // this block's stream and table
    const size_t tenant = blockIdx.z;
    z += tenant * n * d;
    mask += tenant * n;
    hist += tenant * rows * B;
  }
  const int tid = threadIdx.x;
  const int r = blockIdx.x * blockDim.x + tid;
  const bool active = r < rows;

  float wr[P][DMAX];  // the row's weights of z's features, per plane
  float wpad[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      wr[j][i] = (active && i < d) ? w[((size_t)j * d2 + i) * rows + r] : 0.f;
    wpad[j] = active ? w[((size_t)j * d2 + d + 1) * rows + r] : 0.f;
  }
  // Thread tid owns column tid of the bucket-major histogram: no two threads
  // share a word, and a warp's accesses fall in 32 distinct banks.
  int* col = hs + tid;
  for (int b = 0; b < B; ++b) col[b * blockDim.x] = 0;

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  for (long long base = start; base < end; base += kTilePoints) {
    const int npts = (int)min((long long)kTilePoints, end - base);
    __syncthreads();  // the previous tile has been consumed
    const float* src = z + base * d;
    for (int k = tid; k < npts * d; k += blockDim.x) zs[k] = src[k];
    __syncthreads();
    for (int pt = tid; pt < npts; pt += blockDim.x) {
      float sq = 0.f;
      for (int i = 0; i < d; ++i) {
        const float v = zs[pt * d + i];
        sq = __fadd_rn(sq, __fmul_rn(v, v));
      }
      pads[pt] = __fsqrt_rn(fmaxf(__fsub_rn(1.f, sq), 0.f));
      ms[pt] = mask[base + pt];
    }
    __syncthreads();
    if (!active) continue;
    for (int pt = 0; pt < npts; ++pt) {
      const int inc = (int)ms[pt];
      if (inc == 0) continue;
      const float pad = pads[pt];
      // The point's features, read once into registers.
      float xa[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        xa[i] = i < d ? zs[pt * d + i] : 0.f;
      int cp = 0, cn = 0;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DMAX; ++i)
          if (i < d) acc = __fadd_rn(acc, __fmul_rn(xa[i], wr[j][i]));
        acc = __fadd_rn(acc, __fmul_rn(pad, wpad[j]));
        const float t2 = __fmul_rn(__fmul_rn(2.f, pad), wpad[j]);
        cp |= (acc > 0.f) << j;
        cn |= (acc < t2) << j;
      }
      col[cp * blockDim.x] += inc;
      col[cn * blockDim.x] += inc;
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
cudaError_t launch(const float* z, const float* w, const float* mask,
                   int32_t* hist, int n, int d, int rows, int tenants,
                   cudaStream_t stream) {
  const int threads = storm::insert_threads(P);
  const size_t smem = sizeof(float) * ((size_t)kTilePoints * d + 2 * kTilePoints)
                      + sizeof(int) * (size_t)(1 << P) * threads;
  dim3 grid;
  int chunk = 0;
  cudaError_t err = storm::insert_grid(n, rows, threads, tenants, &grid, &chunk);
  if (err != cudaSuccess) return err;
  if (tenants == 1)  // the lone kernel carries no tenant offsets
    paired_hist_kernel<P, DMAX, false><<<grid, threads, smem, stream>>>(
        z, w, mask, hist, n, d, rows, chunk);
  else
    paired_hist_kernel<P, DMAX, true><<<grid, threads, smem, stream>>>(
        z, w, mask, hist, n, d, rows, chunk);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_p(int p, const float* z, const float* w, const float* mask,
                       int32_t* hist, int n, int d, int rows, int tenants,
                       cudaStream_t stream) {
  switch (p) {
    case 1: return launch<1, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 2: return launch<2, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 3: return launch<3, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 4: return launch<4, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 5: return launch<5, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 6: return launch<6, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 7: return launch<7, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    case 8: return launch<8, DMAX>(z, w, mask, hist, n, d, rows, tenants, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The insert of `tenants` stacked streams, then the epilogue.
cudaError_t insert(const float* z, const float* w, const float* mask,
                   int32_t* hist, void* out, int tenants, int n, int d, int p,
                   int rows, int out_bytes, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (n == 0)
    ;  // empty streams leave the zeroed tables as they are
  else if (d <= 16)
    err = dispatch_p<16>(p, z, w, mask, hist, n, d, rows, tenants, s);
  else if (d <= 32)
    err = dispatch_p<32>(p, z, w, mask, hist, n, d, rows, tenants, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return storm::cast_out(hist, out, ((long long)tenants * rows) << p,
                         out_bytes, s);
}

}  // namespace

extern "C" {

// z (n, d) f32, w (p, d+2, R) f32, mask (n,) f32, hist (R, 2^p) int32 zeroed by
// the caller. out_bytes selects the output: 4 = hist itself (out unused),
// 2 = int16, 1 = int8, written to out after one saturating cast.
int storm_paired_hash_histogram(const void* z, const void* w, const void* mask,
                                void* hist, void* out, int n, int d, int p,
                                int rows, int out_bytes, void* stream) {
  return (int)insert((const float*)z, (const float*)w, (const float*)mask,
                     (int32_t*)hist, out, 1, n, d, p, rows, out_bytes,
                     (cudaStream_t)stream);
}

// The banked insert: z (S, n, d), mask (S, n), hist (S, R, 2^p) int32 zeroed
// by the caller, out as above over all S tables; w is shared.
int storm_paired_hash_histogram_banked(const void* z, const void* w,
                                       const void* mask, void* hist, void* out,
                                       int tenants, int n, int d, int p,
                                       int rows, int out_bytes, void* stream) {
  return (int)insert((const float*)z, (const float*)w, (const float*)mask,
                     (int32_t*)hist, out, tenants, n, d, p, rows, out_bytes,
                     (cudaStream_t)stream);
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
