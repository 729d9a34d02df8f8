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
//   * Blocks tile (R-tile x n-chunk). Each thread owns one hash row r and keeps
//     its p*(d+1) weights in registers for the whole chunk.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTilePoints = 64;   // points staged in shared memory per step
constexpr int kBlocksPerSm = 8;   // target resident blocks when sizing the grid

template <int P, int DMAX>
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

template <typename T>
__global__ void saturating_cast_kernel(const int32_t* __restrict__ src,
                                       T* __restrict__ dst, int count, int lo,
                                       int hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = (T)min(max(src[i], lo), hi);
}

template <int P, int DMAX>
cudaError_t launch(const float* z, const float* w, const float* mask,
                   int32_t* hist, int n, int d, int rows, cudaStream_t stream) {
  // The histogram takes 2^p * threads ints of shared memory: at most 32 KB.
  const int threads = std::min(128, 8192 >> P);
  const size_t hist_smem = sizeof(int) * (size_t)(1 << P) * threads;
  const size_t smem =
      sizeof(float) * ((size_t)kTilePoints * d + 2 * kTilePoints) + hist_smem;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int gx = (rows + threads - 1) / threads;
  const long long tiles = (n + kTilePoints - 1) / kTilePoints;
  long long gy = ((long long)sms * kBlocksPerSm + gx - 1) / gx;
  gy = std::max(1LL, std::min(gy, std::min(tiles, 65535LL)));
  long long chunk = (tiles + gy - 1) / gy * kTilePoints;
  gy = (n + chunk - 1) / chunk;
  paired_hist_kernel<P, DMAX><<<dim3(gx, (unsigned)gy), threads, smem, stream>>>(
      z, w, mask, hist, n, d, rows, (int)chunk);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch_p(int p, const float* z, const float* w, const float* mask,
                       int32_t* hist, int n, int d, int rows,
                       cudaStream_t stream) {
  switch (p) {
    case 1: return launch<1, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 2: return launch<2, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 3: return launch<3, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 4: return launch<4, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 5: return launch<5, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 6: return launch<6, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 7: return launch<7, DMAX>(z, w, mask, hist, n, d, rows, stream);
    case 8: return launch<8, DMAX>(z, w, mask, hist, n, d, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// z (n, d) f32, w (p, d+2, R) f32, mask (n,) f32, hist (R, 2^p) int32 zeroed by
// the caller. out_bytes selects the output: 4 = hist itself (out unused),
// 2 = int16, 1 = int8, written to out after one saturating cast.
int storm_paired_hash_histogram(const void* z, const void* w, const void* mask,
                                void* hist, void* out, int n, int d, int p,
                                int rows, int out_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n == 0)
    ;  // an empty stream leaves the zeroed table as it is
  else if (d <= 16)
    err = dispatch_p<16>(p, (const float*)z, (const float*)w,
                         (const float*)mask, (int32_t*)hist, n, d, rows, s);
  else if (d <= 32)
    err = dispatch_p<32>(p, (const float*)z, (const float*)w,
                         (const float*)mask, (int32_t*)hist, n, d, rows, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || out_bytes == 4) return (int)err;
  const int count = rows << p;
  const int threads = 256;
  const int blocks = (count + threads - 1) / threads;
  if (out_bytes == 2)
    saturating_cast_kernel<int16_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)hist, (int16_t*)out, count, -32768, 32767);
  else if (out_bytes == 1)
    saturating_cast_kernel<int8_t><<<blocks, threads, 0, s>>>(
        (const int32_t*)hist, (int8_t*)out, count, -128, 127);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
