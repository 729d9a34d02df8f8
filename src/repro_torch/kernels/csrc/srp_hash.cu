// SRP hash for Hopper: codes[i, r] = sum_j (x_i . w[j, :, r] > 0) << j, as
// (n, R) int32, for x (n, d) fp32 and w (p, d, R) fp32.
//
// Replaces the Pallas TPU kernel `srp_hash` in src/repro/kernels/srp_hash.py.
// That kernel tiles (bn, bd) @ (bd, br) matmuls through VMEM accumulators
// because the MXU wants 128-aligned products; here the contraction must
// round exactly as the plain PyTorch version does, so it runs on the CUDA
// cores.
//
// What bounds it on the H100: at the regression family's widths (n = 2^18,
// d = 12, R = 2048, p = 4) 2*n*d*R*p = 5.2e10 fp32 operations (0.77 ms at
// 67 TFLOP/s) against 2.1 GB of int32 codes written (0.64 ms at 3.35 TB/s).
// The no-FMA arithmetic that bit equality needs issues a multiply and an
// add per term: 96 instructions per (point, row) pair at d = 12, p = 4, and
// about 9 more for the code and its store, 1.7 ms over 5.4e8 pairs at the
// card's 3.35e13 lane instructions per second. The stores overlap that.
// The register path's hot loop issues 121.5 instructions per pair
// (cuobjdump; scripts/insert_variants.py --family srp) and takes 2.27 ms
// on an H100 at 1980 MHz (scripts/ab_insert_kernel.py): 0.86 instructions
// per scheduler per cycle, 1.34x the floor.
//
// Design:
//   * Register path (p <= 8 and d <= 16, or p <= 4 and d <= 32: the hashes
//     of the sketch paths): each thread owns RT hash rows (lanes own
//     adjacent rows) and keeps their p*d weights in registers for its whole
//     chunk of points. A block stages tiles of 64 points in shared memory
//     with cp.async, double-buffered (tile t + 1 in flight while tile t
//     computes, one barrier per tile), each point padded to a multiple of 4
//     floats, so that a thread reads a point as float4 broadcasts, once for
//     its RT rows. Compile-time widths for the regression family (d = 12)
//     and the single-sided family (d = 11), two rows per thread at p <= 4;
//     every other d a generic body over DMAX = 16 or 32 with a runtime
//     guard, one row per thread. A warp stores the codes of one point over
//     64 (32) consecutive rows, with streaming stores (__stcs): the codes
//     are far larger than L2.
//   * Tiled path (wider d or more planes, up to p = 30): the register-blocked
//     projection tile of projection_tile.cuh, which the inserts' wide body
//     shares, with an epilogue that stores the codes (CodesOut).
//   * Both accumulate feature by feature in index order with __fmul_rn /
//     __fadd_rn (no FMA contraction, no TF32), starting from +0, as
//     kernels/ref.py's _project does: kernel and plain version compare bit
//     for bit. Offsets into the codes are 64-bit (n * R may pass 2^31).
#include <cuda_runtime.h>
#include <stdint.h>

#include "projection_tile.cuh"

namespace {

using storm::kTilePoints;

constexpr int kRegThreads = 128;  // threads per block on the register path
constexpr int kExactRegression = 12;  // [x, y] of d = 9, augmented
constexpr int kExactSingle = 11;      // x of d = 9, augmented
constexpr int kPairPlanes = 4;        // two rows per thread up to this p

// Stage npts points of d features from src (contiguous rows) into dst at a
// stride of XS floats, as one cp.async group: 16-byte copies where the rows
// and src are 16-byte aligned and d == XS, else 4-byte ones.
template <int XS>
__device__ __forceinline__ void stage_points(float* dst, const float* src,
                                             int npts, int d, int tid) {
  if (d == XS && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int k = tid; k < npts * XS / 4; k += kRegThreads)
      storm::cp_async16(dst + 4 * k, src + 4 * k);
  } else {
    for (int k = tid; k < npts * d; k += kRegThreads) {
      const int pt = k / d, f = k - pt * d;
      storm::cp_async4(dst + pt * XS + f, src + k);
    }
  }
  storm::cp_async_commit();
}

// D > 0: exactly D features (compile time); D == 0: d <= DMAX at run time.
template <int P, int D, int DMAX, int RT>
__global__ void __launch_bounds__(kRegThreads)
srp_hash_reg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    int32_t* __restrict__ codes, int n, int d, int rows,
                    int chunk) {
  constexpr int XS = (DMAX + 3) & ~3;  // floats per staged point
  constexpr int TILE = kTilePoints;
  extern __shared__ __align__(16) float xs[];  // 2 x (TILE, XS)
  const int tid = threadIdx.x;
  const int r = (blockIdx.x * kRegThreads + tid) * RT;  // first row
  const int dd = D > 0 ? D : d;
  float wr[RT][P][DMAX];
#pragma unroll
  for (int h = 0; h < RT; ++h)
    storm::load_row_weights<P, DMAX>(w, r + h, dd, rows, r + h < rows, wr[h]);

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  const int tiles = (int)((end - start + TILE - 1) / TILE);
  stage_points<XS>(xs, x + start * dd, (int)min((long long)TILE, end - start),
                   dd, tid);
  for (int t = 0; t < tiles; ++t) {
    const long long base = start + (long long)t * TILE;
    const int npts = (int)min((long long)TILE, end - base);
    storm::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every thread is done with t - 1
    if (t + 1 < tiles)
      stage_points<XS>(xs + ((t + 1) & 1) * TILE * XS, x + (base + TILE) * dd,
                       (int)min((long long)TILE, end - base - TILE), dd, tid);
    if (r >= rows) continue;
    const float* buf = xs + (t & 1) * TILE * XS;
    int32_t* out = codes + (size_t)base * rows + r;
    for (int pt = 0; pt < npts; ++pt) {
      float xa[XS];  // the point's features, as float4 broadcasts
#pragma unroll
      for (int q = 0; q < XS / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(buf + pt * XS)[q];
        xa[4 * q] = v.x;
        xa[4 * q + 1] = v.y;
        xa[4 * q + 2] = v.z;
        xa[4 * q + 3] = v.w;
      }
      float acc[RT][P];
#pragma unroll
      for (int h = 0; h < RT; ++h)
#pragma unroll
        for (int j = 0; j < P; ++j) acc[h][j] = 0.f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (D == 0 && i >= d) break;
#pragma unroll
        for (int h = 0; h < RT; ++h)
#pragma unroll
          for (int j = 0; j < P; ++j)
            acc[h][j] = __fadd_rn(acc[h][j], __fmul_rn(xa[i], wr[h][j][i]));
      }
      int code[RT];
#pragma unroll
      for (int h = 0; h < RT; ++h) {
        code[h] = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) code[h] |= (acc[h][j] > 0.f) << j;
      }
      int32_t* dst = out + (size_t)pt * rows;
      if (RT == 2 && (rows & 1) == 0) {  // r is even, so is r + 1 < rows
        __stcs(reinterpret_cast<int2*>(dst), make_int2(code[0], code[RT - 1]));
      } else {
#pragma unroll
        for (int h = 0; h < RT; ++h)
          if (r + h < rows) __stcs(dst + h, code[h]);
      }
    }
  }
}

template <int P, int D, int DMAX, int RT>
cudaError_t launch_reg(const float* x, const float* w, int32_t* codes, int n,
                       int d, int rows, cudaStream_t stream) {
  constexpr int XS = (DMAX + 3) & ~3;
  dim3 grid;
  int chunk = 0;
  cudaError_t err = storm::insert_grid(n, rows, kRegThreads * RT, 1, &grid,
                                       &chunk);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * 2 * (size_t)kTilePoints * XS;
  srp_hash_reg_kernel<P, D, DMAX, RT><<<grid, kRegThreads, smem, stream>>>(
      x, w, codes, n, d, rows, chunk);
  return cudaGetLastError();
}

// The register path at p planes: two rows per thread at the exact widths
// up to p = 4, one row otherwise.
template <int P>
cudaError_t dispatch_d(const float* x, const float* w, int32_t* codes, int n,
                       int d, int rows, cudaStream_t s) {
  constexpr int RT = P <= kPairPlanes ? 2 : 1;
  if (d == kExactRegression)
    return launch_reg<P, kExactRegression, kExactRegression, RT>(
        x, w, codes, n, d, rows, s);
  if (d == kExactSingle)
    return launch_reg<P, kExactSingle, kExactSingle, RT>(x, w, codes, n, d,
                                                         rows, s);
  if (d <= 16) return launch_reg<P, 0, 16, 1>(x, w, codes, n, d, rows, s);
  if constexpr (P <= kPairPlanes)
    return launch_reg<P, 0, 32, 1>(x, w, codes, n, d, rows, s);
  return cudaErrorInvalidValue;
}

// Whether a row's weights fit the register path: p * DMAX <= 128.
bool register_path(int d, int p) {
  return (p <= 8 && d <= 16) || (p <= kPairPlanes && d <= 32);
}

// The tiled path's epilogue: the codes of a point at the lane's two rows,
// one streaming int2 store where both lie in an even R, else one each.
struct CodesOut {
  int32_t* codes;  // (n, R)

  static size_t smem_bytes(int, int) { return 0; }
  __device__ void setup(int, const storm::ProjArgs&, char*, int, int, int) {}
  __device__ bool begin_tile(long long, int, int, int) { return true; }
  __device__ void put(int, long long i, int r, const int (&cp)[2],
                      const int (&)[2], int rows) {
    int32_t* dst = codes + (size_t)i * rows + r;
    if ((rows & 1) == 0 && r < rows) {
      __stcs(reinterpret_cast<int2*>(dst), make_int2(cp[0], cp[1]));
    } else {
      if (r < rows) __stcs(dst, cp[0]);
      if (r + 1 < rows) __stcs(dst + 1, cp[1]);
    }
  }
  __device__ void finish(int, int, int) {}
};

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
  if (!register_path(d, p)) {
    const storm::ProjArgs a{xf, wf, n, d, d, p, rows, 0};
    return (int)storm::launch_projection_p<false>(a, CodesOut{out}, 1, s);
  }
  switch (p) {
    case 1: return (int)dispatch_d<1>(xf, wf, out, n, d, rows, s);
    case 2: return (int)dispatch_d<2>(xf, wf, out, n, d, rows, s);
    case 3: return (int)dispatch_d<3>(xf, wf, out, n, d, rows, s);
    case 4: return (int)dispatch_d<4>(xf, wf, out, n, d, rows, s);
    case 5: return (int)dispatch_d<5>(xf, wf, out, n, d, rows, s);
    case 6: return (int)dispatch_d<6>(xf, wf, out, n, d, rows, s);
    case 7: return (int)dispatch_d<7>(xf, wf, out, n, d, rows, s);
    case 8: return (int)dispatch_d<8>(xf, wf, out, n, d, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* storm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
