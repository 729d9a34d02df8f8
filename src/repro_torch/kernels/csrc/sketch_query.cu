// Batched RACE query for Hopper: hash each query, gather counts[r, code_r],
// mean over the R rows.
//
// Replaces the Pallas TPU kernel `sketch_query` in
// src/repro/kernels/sketch_query.py. That kernel gathers through a one-hot
// contraction on the MXU because the TPU has no fast gather; here the gather
// is an indexed load.
//
// What bounds it on the H100: latency. On the main path m is small
// (F*(2k+1) = 17 points per DFO step, 198 per refine batch): the work is
// m*R*p*d multiply-adds and m*R gathers from a 128 KB table that stays in L2,
// so the time is the chain of dependent loads in one thread, not bandwidth.
//
// Design: one block per query point, up to 1024 threads, so a thread hashes
// only R/1024 rows (2 at R = 2048). The block stages the query in shared
// memory, each thread hashes rows r = tid, tid + blockDim, ... against
// w[:, :, r] (coalesced across threads; the feature loop is unrolled so its
// loads are in flight together), gathers counts[r, code] (narrow counters
// are widened at the gather), and sums in int64. A block reduction
// gives the row total; its fp32 conversion times the fp32 reciprocal of R is
// the mean (the reference's jnp.mean lowers to the same product). A paired
// cell holds up to 2n, so at n = 2^22 a sum over 2048 rows reaches ~1e10: an
// fp32 sum would round, in an order that changes from run to run, where the
// int64 sum is exact. Below 2^24 the result equals the fp32 mean bit for bit.
// The projection is accumulated feature by feature in index order with
// __fmul_rn/__fadd_rn, as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

template <typename C>
__global__ void sketch_query_kernel(const float* __restrict__ q,
                                    const float* __restrict__ w,
                                    const C* __restrict__ counts,
                                    float* __restrict__ out, int d, int p,
                                    int rows) {
  extern __shared__ float qs[];  // (d,)
  __shared__ long long warp_sums[kMaxThreads / 32];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < d; i += blockDim.x) qs[i] = q[(size_t)qi * d + i];
  __syncthreads();

  const int buckets = 1 << p;
  long long total = 0;
  for (int r = tid; r < rows; r += blockDim.x) {
    int code = 0;
    for (int j = 0; j < p; ++j) {
      const float* wj = w + (size_t)j * d * rows + r;
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < d; ++i)
        acc = __fadd_rn(acc, __fmul_rn(qs[i], wj[(size_t)i * rows]));
      code |= (acc > 0.f) << j;
    }
    total += (long long)counts[(size_t)r * buckets + code];
  }
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = total;
  __syncthreads();
  if (tid == 0) {
    long long sum = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) sum += warp_sums[k];
    out[qi] = __fmul_rn(__ll2float_rn(sum), __frcp_rn((float)rows));
  }
}

}  // namespace

extern "C" {

// q (m, d) f32, w (p, d, R) f32, counts (R, 2^p) of count_bytes = 4 (int32),
// 2 (int16) or 1 (int8); out (m,) f32.
int storm_sketch_query(const void* q, const void* w, const void* counts,
                       void* out, int m, int d, int p, int rows,
                       int count_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)d;
  const int threads = rows >= kMaxThreads ? kMaxThreads : (rows + 31) / 32 * 32;
  const float* qf = (const float*)q;
  const float* wf = (const float*)w;
  float* of = (float*)out;
  switch (count_bytes) {
    case 4:
      sketch_query_kernel<int32_t><<<m, threads, smem, s>>>(
          qf, wf, (const int32_t*)counts, of, d, p, rows);
      break;
    case 2:
      sketch_query_kernel<int16_t><<<m, threads, smem, s>>>(
          qf, wf, (const int16_t*)counts, of, d, p, rows);
      break;
    case 1:
      sketch_query_kernel<int8_t><<<m, threads, smem, s>>>(
          qf, wf, (const int8_t*)counts, of, d, p, rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
