// Single-sided insert for Hopper: SRP hash of pre-augmented points + masked
// (R, 2^p) histogram, for one stream or a stack of tenant streams.
//
// Replaces the Pallas TPU kernels `hash_histogram` (storm_sketch.py:112) and
// `hash_histogram_banked` (storm_sketch.py:339) in src/repro/kernels/. Those
// expand each code into a one-hot cube and reduce it on the MXU because the
// TPU has no fast scatter; here the insert is a histogram.
//
// What bounds it on the H100: fp32 instruction issue. Every (point, row)
// pair costs p*d multiply-adds while each point is d + 1 floats of input
// (the classification path: n = 2^22, d = 11 augmented features, R = 1024,
// p = 2: ~1.9e11 flops against ~0.2 GB of reads). The bit-exact contract
// with the plain version forbids FMA, TF32 and tensor cores (see the
// projection below), so a plane costs d rounded multiplies and d - 1
// rounded adds: 42 fp32 instructions per pair at d = 11, p = 2 (84 at
// p = 4), 4.29e9 pairs over 132 SMs x 128 lanes at 1980 MHz: a floor of
// 5.39 ms (10.8 ms at p = 4), against the FMA bound of 2.82 ms.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, SM clock read at 1980 MHz
// while it ran (scripts/ab_insert_kernel.py): the lone insert takes 6.91 ms
// at that shape, the banked one 6.88 ms over 16 x 2^18 rows, the lone one
// at p = 4 13.88 ms. The hot loop issues 47.56 instructions per pair at
// d = 11, p = 2 (FMUL 22, FADD 20, FSETP 2, IADD3 1.81, LDS 0.75, SEL + SHF
// + LOP3 0.75, other 0.25) and the counting 68 per group of 32 records x 4
// rows, 0.53 per pair (cuobjdump; scripts/insert_variants.py). 48.1
// instructions x 4.29e9 pairs in 6.91 ms is 0.89 instructions per scheduler
// per cycle, 1.28x the contract floor.
//
// Design: the paired insert's (paired_hash_histogram.cu) without the
// negative side and without the pad, sharing its tile pipeline
// (insert_common.cuh):
//   * Blocks tile (R-tile x n-chunk x tenant); each thread owns TR hash rows
//     (compile-time) and keeps their weights in registers for the chunk.
//   * Staging, double-buffered: cp.async copies tile t+1's raw points and
//     mask into shared memory while tile t is consumed (a 4-byte path for
//     views that are not 16-byte aligned). All threads then turn the tile
//     into records [x_0 .. x_{d-1}, inc] padded to a multiple of 4 floats
//     (12 at d = 11) and drop masked slots by warp ballot, so the consumer
//     loop has no mask branch; a consumer reads a record as float4
//     broadcasts (3 at d = 11) and projects it against all its rows.
//   * Projection: every column of x, the augmented zero column included (the
//     kernel takes any x), accumulated in index order with __fmul_rn /
//     __fadd_rn (no FMA contraction), as the plain PyTorch version does. The
//     first product is not added to +0 as the plain version does: that
//     changes only the sign of a zero sum, which acc > 0 does not see, so
//     the codes agree bit for bit.
//   * Exact width: d = 11 (margin classification, logistic and kmeans at
//     the paper's d = 9, augmented, and the single-sided gateway) is a
//     compile-time loop; every other d <= 32 takes a generic body over
//     DMAX = 16 or 32 with a runtime guard. Wider rows (d > 32) and p > 8
//     take the wide body, the register-blocked projection tile of
//     projection_tile.cuh (any d, p up to 30).
//   * Counting off the per-pair path (p <= 5 while a row's weights fit in
//     128 registers): per group of 32 records a thread sets bit k of word
//     P_j when plane j of record k is positive; after the group bucket b
//     grows by popc(M_b & valid), M_b the AND over planes of P_j or ~P_j by
//     bit j of b; the 2^p counters live in registers at compile-time
//     indices. A tile whose valid weights are not all 1 is counted point by
//     point with int(mask[i]) (same launch, same arithmetic).
//   * Every other p keeps a bucket-major (2^p, threads) histogram in shared
//     memory, one conflict-free column per thread.
//   * Blocks merge with integer atomicAdd into an int32 (R, 2^p) table:
//     integer adds commute, so the result is exact whatever the block order.
//     A narrow output (int16/int8) is one saturating cast after it.
//   * Banked (BANKED = true): grid axis z is the tenant, whose blocks read
//     x[s], mask[s] and write table s under the one shared hash family, so
//     slice s of a bank equals the lone insert of tenant s bit for bit. The
//     lone entry point is compiled without the tenant offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "projection_tile.cuh"

namespace {

// Hash rows per thread on the exact-width path, at p <= 2 (a row is 22
// weights at d = 11) and at p = 3, 4; p = 5 takes one row. At p = 2 four
// rows (160 registers, 0.75 shared loads per pair) took 6.98-6.99 ms for
// the lone insert against 7.46-7.49 with two rows and 7.51-7.54 with one;
// at p = 4 two rows took 13.90-14.01 ms against one row's
// 14.17-14.28 (scripts/insert_variants.py times them).
constexpr int kRowsNarrow = 4;
constexpr int kRowsWide = 2;
// The largest p that counts in registers.
constexpr int kRegPlanes = 5;
constexpr int kExactWidth = 11;  // the single-sided family's augmented d
using storm::kGroup;
using storm::kSub;

// One instantiation's compile-time shape. D > 0: exactly D features;
// D = 0: a runtime d <= DMAX.
template <int P, int D, int DMAX>
struct Shape {
  static constexpr int kBuckets = 1 << P;
  static constexpr bool kExact = D > 0;
  // Register counters while the row's weights take at most 128 registers.
  static constexpr bool kReg = P <= kRegPlanes && P * DMAX <= 128;
  static constexpr int kTR = !(kExact && kReg) ? 1
                             : P <= 2          ? kRowsNarrow
                             : P <= 4          ? kRowsWide
                                               : 1;
  static constexpr int kRec = (DMAX + 1 + 3) / 4 * 4;  // floats per record
  static constexpr int kIncSlot = DMAX;
  static constexpr int kTile = kExact ? 256 : (DMAX > 16 ? 64 : 128);
  static_assert(kTile % kGroup == 0, "tiles hold whole groups");
};

template <int P, int D, int DMAX>
size_t smem_bytes(int threads) {
  using S = Shape<P, D, DMAX>;
  return sizeof(float) * (2 * S::kTile * DMAX + 2 * S::kTile
                          + S::kTile * S::kRec)
         + (S::kReg ? 0 : sizeof(int) * S::kBuckets * threads);
}

// Every plane of one record against one hash row: pos[j] = acc_j > 0.
template <int P, int DMAX, int REC, bool EXACT>
__device__ __forceinline__ void project(const float (&v)[REC],
                                        const float (&wr)[P][DMAX], int d,
                                        bool (&pos)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float acc = __fmul_rn(v[0], wr[j][0]);
#pragma unroll
    for (int i = 1; i < DMAX; ++i)
      if (EXACT || i < d) acc = __fadd_rn(acc, __fmul_rn(v[i], wr[j][i]));
    pos[j] = acc > 0.f;
  }
}

template <int P, int D, int DMAX, bool BANKED>
__global__ void __launch_bounds__(128)
hist_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ mask, int32_t* __restrict__ hist, int n,
            int d_arg, int rows, int chunk) {
  using S = Shape<P, D, DMAX>;
  constexpr int B = S::kBuckets, TR = S::kTR, TILE = S::kTile, REC = S::kRec;
  const int d = S::kExact ? D : d_arg;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                     // (2, TILE * DMAX) raw points
  float* msk = raw + 2 * TILE * DMAX;    // (2, TILE) their mask values
  float* recs = msk + 2 * TILE;          // (TILE, REC) compacted records
  int* hs = reinterpret_cast<int*>(recs + TILE * REC);  // (B, threads)
  __shared__ int tile_count[2], tile_weighted[2];

  if (BANKED) {  // this block's stream and table
    const size_t tenant = blockIdx.z;
    x += tenant * n * d;
    mask += tenant * n;
    hist += tenant * rows * B;
  }
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int row0 = blockIdx.x * nthr * TR + tid;  // rows row0 + t * nthr

  float wr[TR][P][DMAX];  // the rows' weights, per plane
#pragma unroll
  for (int t = 0; t < TR; ++t) {
    const int r = row0 + t * nthr;
    storm::load_row_weights<P, DMAX>(w, r, d, rows, r < rows, wr[t]);
  }
  int cnt[S::kReg ? TR : 1][S::kReg ? B : 1];
#pragma unroll
  for (int t = 0; t < (S::kReg ? TR : 1); ++t)
#pragma unroll
    for (int b = 0; b < (S::kReg ? B : 1); ++b) cnt[t][b] = 0;
  // Shared path: thread tid owns column tid of the bucket-major histogram;
  // no two threads share a word, and a warp's accesses hit 32 banks.
  int* col = hs + tid;
  if (!S::kReg)
    for (int b = 0; b < B; ++b) col[b * nthr] = 0;
  if (tid == 0) tile_count[0] = tile_weighted[0] = 0;

  const long long start = (long long)blockIdx.y * chunk;
  const long long end = min((long long)n, start + chunk);
  const int ntiles = (int)((end - start + TILE - 1) / TILE);

  // Issue the copies of tile tt's points and mask into buffer b.
  auto stage = [&](int tt, int b) {
    const long long base = start + (long long)tt * TILE;
    const int npts = (int)min((long long)TILE, end - base);
    storm::stage_tile(raw + b * TILE * DMAX, x + base * d, npts * d,
                      msk + b * TILE, mask + base, npts, tid, nthr);
  };

  if (ntiles > 0) stage(0, 0);
  for (int tt = 0; tt < ntiles; ++tt) {
    const int buf = tt & 1;
    if (tt + 1 < ntiles) {
      stage(tt + 1, buf ^ 1);  // its buffer was compacted before barrier B
      storm::cp_async_wait<1>();
    } else {
      storm::cp_async_wait<0>();
    }
    __syncthreads();  // A: tile tt has landed; tile tt-1 has been consumed

    // Compaction: the valid points of the tile become records.
    {
      const long long base = start + (long long)tt * TILE;
      const int npts = (int)min((long long)TILE, end - base);
      const float* rx = raw + buf * TILE * DMAX;
      const float* rm = msk + buf * TILE;
      if (tid == 0) tile_count[buf ^ 1] = tile_weighted[buf ^ 1] = 0;
      for (int k0 = 0; k0 < TILE; k0 += nthr) {  // uniform trip count
        const int k = k0 + tid;
        const int inc = k < npts ? (int)rm[k] : 0;
        const int slot = storm::compact_slot(inc != 0, &tile_count[buf]);
        if (inc != 0) {
          if (inc != 1) tile_weighted[buf] = 1;
          float v[REC];
#pragma unroll
          for (int i = 0; i < REC; ++i) v[i] = 0.f;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            if (S::kExact || i < d) v[i] = rx[k * d + i];
          v[S::kIncSlot] = __int_as_float(inc);
          storm::store_record(recs, slot, v);
        }
      }
    }
    __syncthreads();  // B: the records are ready

    if (row0 >= rows) continue;  // no row of this thread is active
    const int count = tile_count[buf];
    if constexpr (S::kReg) {
      if (tile_weighted[buf] == 0) {
        // Bit planes: 32 records per word, counted after each group.
        for (int g0 = 0; g0 < count; g0 += kGroup) {
          const int glen = min(kGroup, count - g0);
          unsigned pw[TR][P];
#pragma unroll
          for (int t = 0; t < TR; ++t)
#pragma unroll
            for (int j = 0; j < P; ++j) pw[t][j] = 0u;
          for (int q = 0; q < glen; q += kSub) {
            // Records past `count` (up to the step's end) are stale; the
            // valid word drops their bits.
            unsigned pb[TR][P];
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int j = 0; j < P; ++j) pb[t][j] = 0u;
#pragma unroll
            for (int kk = 0; kk < kSub; ++kk) {
              float v[REC];
              storm::load_record(recs, g0 + q + kk, v);
#pragma unroll
              for (int t = 0; t < TR; ++t) {
                bool pos[P];
                project<P, DMAX, REC, S::kExact>(v, wr[t], d, pos);
#pragma unroll
                for (int j = 0; j < P; ++j)
                  if (pos[j]) pb[t][j] |= 1u << kk;
              }
            }
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int j = 0; j < P; ++j) pw[t][j] |= pb[t][j] << q;
          }
          const unsigned valid =
              glen == kGroup ? 0xffffffffu : (1u << glen) - 1u;
#pragma unroll
          for (int t = 0; t < TR; ++t)
            storm::count_group<P>(pw[t], valid, cnt[t]);
        }
        continue;
      }
    }
    // Point by point, each adding its weight: the weighted tiles of the
    // register path, and every tile of the shared-histogram path.
    for (int k = 0; k < count; ++k) {
      float v[REC];
      storm::load_record(recs, k, v);
      const int inc = __float_as_int(v[S::kIncSlot]);
#pragma unroll
      for (int t = 0; t < TR; ++t) {
        bool pos[P];
        project<P, DMAX, REC, S::kExact>(v, wr[t], d, pos);
        int code = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) code |= (int)pos[j] << j;
        if constexpr (S::kReg) {
#pragma unroll
          for (int b = 0; b < B; ++b) cnt[t][b] += code == b ? inc : 0;
        } else {
          col[code * nthr] += inc;
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TR; ++t) {
    const int r = row0 + t * nthr;
    if (r >= rows) continue;
    int32_t* out = hist + (size_t)r * B;
    if constexpr (S::kReg) {
#pragma unroll
      for (int b = 0; b < B; ++b)
        if (cnt[t][b] != 0) atomicAdd(out + b, cnt[t][b]);
    } else {
      for (int b = 0; b < B; ++b) {
        const int c = col[b * nthr];
        if (c != 0) atomicAdd(out + b, c);
      }
    }
  }
}

template <int P, int D, int DMAX>
cudaError_t launch(const float* x, const float* w, const float* mask,
                   int32_t* hist, int n, int d, int rows, int tenants,
                   cudaStream_t stream) {
  using S = Shape<P, D, DMAX>;
  const int threads = storm::insert_threads(P);
  const size_t smem = smem_bytes<P, D, DMAX>(threads);
  dim3 grid;
  int chunk = 0;
  cudaError_t err = storm::insert_grid(n, rows, threads * S::kTR, tenants,
                                       &grid, &chunk, S::kTile);
  if (err != cudaSuccess) return err;
  // The lone kernel carries no tenant offsets.
  auto kernel = tenants == 1 ? hist_kernel<P, D, DMAX, false>
                             : hist_kernel<P, D, DMAX, true>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(x, w, mask, hist, n, d, rows,
                                          chunk);
  return cudaGetLastError();
}

// The exact-width body for d = 11 at the register-counting p; a generic
// body over DMAX = 16 or 32 for every other d <= 32.
template <int P>
cudaError_t dispatch_d(const float* x, const float* w, const float* mask,
                       int32_t* hist, int n, int d, int rows, int tenants,
                       cudaStream_t s) {
  if constexpr (P <= kRegPlanes) {
    if (d == kExactWidth)
      return launch<P, kExactWidth, kExactWidth>(x, w, mask, hist, n, d, rows,
                                                 tenants, s);
  }
  if (d <= 16) return launch<P, 0, 16>(x, w, mask, hist, n, d, rows, tenants, s);
  return launch<P, 0, 32>(x, w, mask, hist, n, d, rows, tenants, s);
}

// The insert of `tenants` stacked streams, then the epilogue.
cudaError_t insert(const float* x, const float* w, const float* mask,
                   int32_t* hist, void* out, int tenants, int n, int d, int p,
                   int rows, int out_bytes, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (n > 0 && (d > storm::kNarrowFeatures || p > storm::kNarrowPlanes)) {
    err = storm::launch_wide<false>(x, w, mask, hist, n, d, p, rows, tenants,
                                     s);
  } else if (n > 0) {  // empty streams leave the zeroed tables as they are
    switch (p) {
      case 1: err = dispatch_d<1>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 2: err = dispatch_d<2>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 3: err = dispatch_d<3>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 4: err = dispatch_d<4>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 5: err = dispatch_d<5>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 6: err = dispatch_d<6>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 7: err = dispatch_d<7>(x, w, mask, hist, n, d, rows, tenants, s); break;
      case 8: err = dispatch_d<8>(x, w, mask, hist, n, d, rows, tenants, s); break;
      default: err = cudaErrorInvalidValue;
    }
  }
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
