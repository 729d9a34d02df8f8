// Shared by the insert kernels (paired_hash_histogram.cu, hash_histogram.cu)
// and the SRP hash (srp_hash.cu): the grid sizing over (R-tile, n-chunk,
// tenant), the one-row projection loop of the SRP hash, the inserts'
// cp.async staging of a tile, the warp-ballot compaction of its valid
// points into records, the bit-plane counting of a group of 32 records, the
// inserts' wide body (any d, p up to 30), and the saturating epilogue that
// narrows the int32 histogram to int16/int8.
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

// ---- the inserts' wide body: any d, 1 <= p <= 30 ----------------------------
//
// The narrow bodies keep a hash row's weights in registers, which bounds them
// to d <= 32 and p <= 8. Every other shape (wide rows: the probes' d_model + 1
// features, a user's wide [x, y]; or many planes) takes this body. It is off
// the main path and simple, and it keeps the narrow bodies' contract:
//   * A block is 32 hash rows (one per lane) x 8 warps; each thread owns its
//     row and TPT points of a tile of 8 * TPT points (point k of the tile
//     goes to warp k % 8), and keeps their per-plane accumulators in
//     registers while the features stream through shared memory in chunks
//     of kWideChunk: the tile's features (a broadcast per warp) and the 32
//     rows' weights of every plane (conflict-free). So d is unbounded and
//     each projection sums in index order with __fmul_rn / __fadd_rn (no
//     FMA), starting from +0 as the plain version does.
//   * Paired: the accumulator covers z's d features; the zero feature is
//     skipped and the pad term added last, pad = sqrt(max(0, 1 - |z|^2))
//     with the squares summed in index order (kernels/ref.py, _pad); the
//     negative side is acc < (2*pad)*w_pad.
//   * A tile whose masks are all 0 is skipped; point i adds int(mask[i]).
//   * Counting: int32 atomics into the block's (32, 2^p) histogram in shared
//     memory for p <= kWideSharedPlanes, merged into the table at the end;
//     above, int32 atomics straight into the (R, 2^p) table.
constexpr int kNarrowFeatures = 32;    // the narrow bodies' reach: a row's
constexpr int kNarrowPlanes = 8;       // weights in registers
constexpr int kWideRows = 32;          // hash rows per block: one per lane
constexpr int kWideWarps = 8;          // warps per block
constexpr int kWideChunk = 16;         // features staged per step
constexpr int kWideSharedPlanes = 8;   // shared histogram up to this p
constexpr int kWideMaxPlanes = 30;     // codes are int32 bit fields

inline size_t wide_smem_bytes(int p, int tile) {
  return sizeof(float) * ((size_t)tile * kWideChunk
                          + (size_t)p * kWideChunk * kWideRows)
         + (p <= kWideSharedPlanes
                ? sizeof(int) * (size_t)kWideRows * ((1 << p) + 1) : 0);
}

template <int PMAX, int TPT, bool PAIRED, bool BANKED>
__global__ void __launch_bounds__(kWideRows * kWideWarps)
wide_hist_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ mask, int32_t* __restrict__ hist,
                 int n, int d, int p, int rows, int chunk) {
  constexpr int TILE = kWideWarps * TPT;  // points per tile
  constexpr int NTHR = kWideRows * kWideWarps;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // (TILE, kWideChunk) the points' chunk
  float* wsm = xs + TILE * kWideChunk;  // (p, kWideChunk, kWideRows) weights
  // (kWideRows, 2^p + 1): a row's counters, one word of padding apart.
  int* hs = reinterpret_cast<int*>(wsm + p * kWideChunk * kWideRows);
  __shared__ int incs[TILE];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kWideRows + lane;
  const int buckets = 1 << p, stride = buckets + 1;
  const int dw = PAIRED ? d + 2 : d;  // w's feature count
  if (BANKED) {  // this block's stream and table
    const size_t tenant = blockIdx.z;
    x += tenant * n * d;
    mask += tenant * n;
    hist += tenant * rows * buckets;
  }
  const int r0 = blockIdx.x * kWideRows;
  const int r = r0 + lane;
  const bool active = r < rows;
  const bool shared_hist = p <= kWideSharedPlanes;
  if (shared_hist)
    for (int k = tid; k < kWideRows * stride; k += NTHR) hs[k] = 0;
  float wpad[PMAX];  // paired: the pad feature's weight of this row
#pragma unroll
  for (int j = 0; j < PMAX; ++j)
    wpad[j] = (PAIRED && j < p && active)
                  ? w[((size_t)j * dw + d + 1) * rows + r] : 0.f;

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  for (long long base = start; base < end; base += TILE) {
    const int npts = (int)min((long long)TILE, end - base);
    __syncthreads();  // the previous tile has been consumed
    if (tid < TILE) incs[tid] = tid < npts ? (int)mask[base + tid] : 0;
    if (!__syncthreads_or(tid < TILE && incs[tid] != 0)) continue;

    float acc[TPT][PMAX];
    float sq[TPT];
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
      sq[t] = 0.f;
#pragma unroll
      for (int j = 0; j < PMAX; ++j) acc[t][j] = 0.f;
    }
    for (int f0 = 0; f0 < d; f0 += kWideChunk) {
      const int nf = min(kWideChunk, d - f0);
      __syncthreads();  // the previous chunk has been consumed
      for (int k = tid; k < TILE * kWideChunk; k += NTHR) {
        const int kp = k / kWideChunk, kf = k - kp * kWideChunk;
        xs[k] = (kp < npts && kf < nf) ? x[(base + kp) * d + f0 + kf] : 0.f;
      }
      for (int k = tid; k < p * kWideChunk * kWideRows; k += NTHR) {
        const int kc = k % kWideRows, rest = k / kWideRows;
        const int kf = rest % kWideChunk, j = rest / kWideChunk;
        const int rr = r0 + kc;
        wsm[k] = (rr < rows && kf < nf)
                     ? w[((size_t)j * dw + f0 + kf) * rows + rr] : 0.f;
      }
      __syncthreads();
      for (int f = 0; f < nf; ++f) {
        float xv[TPT];
#pragma unroll
        for (int t = 0; t < TPT; ++t) {
          xv[t] = xs[(t * kWideWarps + warp) * kWideChunk + f];
          if (PAIRED) sq[t] = __fadd_rn(sq[t], __fmul_rn(xv[t], xv[t]));
        }
#pragma unroll
        for (int j = 0; j < PMAX; ++j) {
          if (j >= p) break;
          const float wv = wsm[(j * kWideChunk + f) * kWideRows + lane];
#pragma unroll
          for (int t = 0; t < TPT; ++t)
            acc[t][j] = __fadd_rn(acc[t][j], __fmul_rn(xv[t], wv));
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
      const int k = t * kWideWarps + warp;
      const int inc = incs[k];  // 0 beyond npts
      if (inc == 0) continue;
      int cp = 0, cn = 0;
      const float pad =
          PAIRED ? __fsqrt_rn(fmaxf(__fsub_rn(1.f, sq[t]), 0.f)) : 0.f;
      const float pad2 = __fmul_rn(2.f, pad);
#pragma unroll
      for (int j = 0; j < PMAX; ++j) {
        if (j >= p) break;
        float a = acc[t][j];
        if (PAIRED) {
          a = __fadd_rn(a, __fmul_rn(pad, wpad[j]));
          cn |= (a < __fmul_rn(pad2, wpad[j])) << j;
        }
        cp |= (a > 0.f) << j;
      }
      if (shared_hist) {
        atomicAdd(hs + lane * stride + cp, inc);
        if (PAIRED) atomicAdd(hs + lane * stride + cn, inc);
      } else {
        atomicAdd(hist + (size_t)r * buckets + cp, inc);
        if (PAIRED) atomicAdd(hist + (size_t)r * buckets + cn, inc);
      }
    }
  }
  if (!shared_hist) return;
  __syncthreads();
  for (int k = tid; k < (kWideRows << p); k += NTHR) {
    const int rr = k >> p, b = k & (buckets - 1);
    const int c = hs[rr * stride + b];
    if (r0 + rr < rows && c != 0)
      atomicAdd(hist + (size_t)(r0 + rr) * buckets + b, c);
  }
}

template <int PMAX, int TPT, bool PAIRED>
cudaError_t launch_wide_p(const float* x, const float* w, const float* mask,
                          int32_t* hist, int n, int d, int p, int rows,
                          int tenants, cudaStream_t stream) {
  constexpr int TILE = kWideWarps * TPT;
  dim3 grid;
  int chunk = 0;
  cudaError_t err = insert_grid(n, rows, kWideRows, tenants, &grid, &chunk,
                                TILE);
  if (err != cudaSuccess) return err;
  const size_t smem = wide_smem_bytes(p, TILE);
  auto kernel = tenants == 1 ? wide_hist_kernel<PMAX, TPT, PAIRED, false>
                             : wide_hist_kernel<PMAX, TPT, PAIRED, true>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, dim3(kWideRows, kWideWarps), smem, stream>>>(
      x, w, mask, hist, n, d, p, rows, chunk);
  return cudaGetLastError();
}

// The wide body for `tenants` stacked streams of n points of d features
// (paired: w has d + 2 features): four points per thread up to p = 8, two
// above, so that the accumulators stay in registers.
template <bool PAIRED>
cudaError_t launch_wide(const float* x, const float* w, const float* mask,
                        int32_t* hist, int n, int d, int p, int rows,
                        int tenants, cudaStream_t stream) {
  if (p < 1 || p > kWideMaxPlanes) return cudaErrorInvalidValue;
  if (p <= 8)
    return launch_wide_p<8, 4, PAIRED>(x, w, mask, hist, n, d, p, rows,
                                       tenants, stream);
  return launch_wide_p<kWideMaxPlanes, 2, PAIRED>(x, w, mask, hist, n, d, p,
                                                  rows, tenants, stream);
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
