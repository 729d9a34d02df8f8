// Antithetic PRP insert for Hopper: paired SRP hash + masked (R, 2^p) histogram.
//
// Replaces the Pallas TPU kernels `paired_hash_histogram` and
// `paired_hash_histogram_banked` in src/repro/kernels/storm_sketch.py. Those
// expand each code into a one-hot cube and reduce it on the MXU because the
// TPU has no fast scatter; here the insert is a histogram.
//
// What bounds it on the H100: fp32 instruction issue. Every (point, row)
// pair costs p*(d+2) multiply-adds while each point is only d+1 floats of
// input (at the main path's shapes, n = 2^22, d = 10, R = 2048, p = 4:
// ~8.2e11 flops against ~0.2 GB of reads). The bit-exact contract with the
// plain version forbids FMA, TF32 and tensor cores (see the projection
// below), so a plane costs d rounded multiplies, d-1 rounded adds and three
// more for the pad term and the negative side: 88 fp32 instructions per
// pair at d = 10, p = 4, twice what the FMA bound of PERF.md's table
// counts. The hot loop of this design issues about 109 instructions per
// pair (88.5 of them that fp32 work, 8 compares, 10 bit operations, 1.5
// shared loads) and the per-group counting about 3 more (cuobjdump;
// scripts/insert_variants.py). Kernel 1 takes 32.6 ms on an H100 whose SM
// clock read 1980 MHz while it ran (scripts/ab_insert_kernel.py): 0.88
// instructions per scheduler per cycle, 1.44x the contract's floor. The
// rest is the ~24 instructions per pair beyond the contract and the 12% of
// issue slots left empty (why they are empty is not measured).
//
// Design:
//   * Blocks tile (R-tile x n-chunk x tenant); each thread owns TR hash rows
//     (compile-time) and keeps their weights in registers for the chunk.
//   * Staging, double-buffered: cp.async copies tile t+1's raw points and
//     mask into shared memory while tile t is consumed. All threads then
//     turn the tile into records [z_0 .. z_{D-1}, pad, inc] padded to a
//     multiple of 4 floats, with pad = sqrt(max(0, 1 - |z|^2)) (squares
//     summed in index order) computed once per point, and drop masked slots
//     (a warp ballot and one shared atomic per warp): the consumer loop has
//     no mask branch, and a mostly masked tick projects only its valid rows.
//   * A consumer thread reads a record as float4 broadcasts (3 at d = 10).
//   * The projection of the augmented row [z, 0, pad] accumulates feature by
//     feature in index order with __fmul_rn/__fadd_rn (no FMA contraction),
//     the zero feature skipped and the pad term last; the negative side is
//     acc < (2*pad)*w_pad from the same accumulator. The plain PyTorch
//     version does the same arithmetic. The first product is not added to
//     +0 as the plain version does: that changes only the sign of a zero
//     sum, which neither comparison sees, so the codes agree bit for bit.
//   * Exact width: d = 10 (the regression family: kernel 1, the bank and
//     the gateway) is a compile-time loop; other d <= 32 take a generic
//     body over DMAX = 16 or 32 with a runtime guard. Wider rows (d > 32)
//     and p > 8 take the wide body, the register-blocked projection tile
//     of projection_tile.cuh (any d, p up to 30).
//   * Counting off the per-pair path (p <= 5 while a row's weights fit in
//     128 registers; d = 10 takes two rows per thread at p <= 4): per group
//     of 32 records a thread sets bit k of word P_j (N_j) when plane j of
//     record k is on the positive (negative) side. After the group, bucket
//     b's count grows by popc(M_b(P) & valid) + popc(M_b(N) & valid), M_b
//     the AND over planes of X_j or ~X_j by bit j of b, built as a binary
//     tree; the 2^p counters live in registers at compile-time indices.
//   * Integer weights: the mask adds int(mask[i]) per point. A tile whose
//     valid masks are not all 1 sets a block-uniform flag and is counted
//     point by point with the weight (rare; same launch, same arithmetic).
//   * Every other p keeps a bucket-major (2^p, threads) histogram in shared
//     memory, one conflict-free column per thread, for every tile.
//   * Blocks merge with integer atomicAdd into an int32 (R, 2^p) table:
//     integer adds commute, so the result is exact whatever the block order.
//   * A narrow output (int16/int8) is one saturating cast after the
//     histogram. Counters only grow, so one clamp of the whole stream's total
//     equals the JAX per-batch saturating scan; one launch takes the stream.
//   * Banked (BANKED = true): grid axis z is the tenant, whose blocks read
//     z[s], mask[s] and write table s under the one shared hash family, so
//     slice s of a bank equals the lone insert of tenant s bit for bit. The
//     lone entry point is compiled without the tenant offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "projection_tile.cuh"

namespace {

// Hash rows per thread on the exact-width path at p <= 4: two rows measured
// 2% faster than one at p = 4 and 7% slower at p = 5 (more registers, fewer
// blocks per SM), so p = 5 keeps one row.
constexpr int kRowsPerThread = 2;
// The largest p that counts in registers: p = 5 there measured 36% faster
// than in the shared histogram. (scripts/insert_variants.py times both.)
constexpr int kRegPlanes = 5;
constexpr int kExactWidth = 10;  // the regression family's d
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
  static constexpr int kTR = (kExact && kReg && P <= 4) ? kRowsPerThread : 1;
  static constexpr int kRec = (DMAX + 2 + 3) / 4 * 4;  // floats per record
  static constexpr int kPadSlot = DMAX, kIncSlot = DMAX + 1;
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

// Both sides of every plane of one record against one hash row:
// pos[j] = acc_j > 0, neg[j] = acc_j < (2*pad)*w_pad[j].
template <int P, int DMAX, int REC, bool EXACT>
__device__ __forceinline__ void project(const float (&v)[REC],
                                        const float (&wr)[P][DMAX],
                                        const float (&wpad)[P], float pad,
                                        float pad2, int d, bool (&pos)[P],
                                        bool (&neg)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float acc = __fmul_rn(v[0], wr[j][0]);
#pragma unroll
    for (int i = 1; i < DMAX; ++i)
      if (EXACT || i < d) acc = __fadd_rn(acc, __fmul_rn(v[i], wr[j][i]));
    acc = __fadd_rn(acc, __fmul_rn(pad, wpad[j]));
    const float t2 = __fmul_rn(pad2, wpad[j]);
    pos[j] = acc > 0.f;
    neg[j] = acc < t2;
  }
}

template <int P, int D, int DMAX, bool BANKED>
__global__ void __launch_bounds__(128)
paired_hist_kernel(const float* __restrict__ z, const float* __restrict__ w,
                   const float* __restrict__ mask, int32_t* __restrict__ hist,
                   int n, int d_arg, int rows, int chunk) {
  using S = Shape<P, D, DMAX>;
  constexpr int B = S::kBuckets, TR = S::kTR, TILE = S::kTile, REC = S::kRec;
  const int d = S::kExact ? D : d_arg;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                     // (2, TILE * DMAX) raw points
  float* msk = raw + 2 * TILE * DMAX;    // (2, TILE) their mask values
  float* recs = msk + 2 * TILE;          // (TILE, REC) compacted records
  int* hs = reinterpret_cast<int*>(recs + TILE * REC);  // (B, threads)
  __shared__ int tile_count[2], tile_weighted[2];

  const int d2 = d + 2;  // w's feature count: [z, 0, pad]
  if (BANKED) {  // this block's stream and table
    const size_t tenant = blockIdx.z;
    z += tenant * n * d;
    mask += tenant * n;
    hist += tenant * rows * B;
  }
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int row0 = blockIdx.x * nthr * TR + tid;  // rows row0 + t * nthr

  float wr[TR][P][DMAX];  // the rows' weights of z's features, per plane
  float wpad[TR][P];
#pragma unroll
  for (int t = 0; t < TR; ++t) {
    const int r = row0 + t * nthr;
    const bool active = r < rows;
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        wr[t][j][i] = (active && i < d) ? w[((size_t)j * d2 + i) * rows + r]
                                        : 0.f;
      wpad[t][j] = active ? w[((size_t)j * d2 + d + 1) * rows + r] : 0.f;
    }
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
    storm::stage_tile(raw + b * TILE * DMAX, z + base * d, npts * d,
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
      const float* rz = raw + buf * TILE * DMAX;
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
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < DMAX; ++i)
            if (S::kExact || i < d) {
              v[i] = rz[k * d + i];
              sq = __fadd_rn(sq, __fmul_rn(v[i], v[i]));
            }
          v[S::kPadSlot] = __fsqrt_rn(fmaxf(__fsub_rn(1.f, sq), 0.f));
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
          unsigned pw[TR][P], nw[TR][P];
#pragma unroll
          for (int t = 0; t < TR; ++t)
#pragma unroll
            for (int j = 0; j < P; ++j) pw[t][j] = nw[t][j] = 0u;
          for (int q = 0; q < glen; q += kSub) {
            // Records past `count` (up to the step's end) are stale; the
            // valid word drops their bits.
            unsigned pb[TR][P], nb[TR][P];
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int j = 0; j < P; ++j) pb[t][j] = nb[t][j] = 0u;
#pragma unroll
            for (int kk = 0; kk < kSub; ++kk) {
              float v[REC];
              storm::load_record(recs, g0 + q + kk, v);
              const float pad = v[S::kPadSlot];
              const float pad2 = __fmul_rn(2.f, pad);
#pragma unroll
              for (int t = 0; t < TR; ++t) {
                bool pos[P], neg[P];
                project<P, DMAX, REC, S::kExact>(v, wr[t], wpad[t], pad, pad2,
                                                 d, pos, neg);
#pragma unroll
                for (int j = 0; j < P; ++j) {
                  if (pos[j]) pb[t][j] |= 1u << kk;
                  if (neg[j]) nb[t][j] |= 1u << kk;
                }
              }
            }
#pragma unroll
            for (int t = 0; t < TR; ++t)
#pragma unroll
              for (int j = 0; j < P; ++j) {
                pw[t][j] |= pb[t][j] << q;
                nw[t][j] |= nb[t][j] << q;
              }
          }
          const unsigned valid =
              glen == kGroup ? 0xffffffffu : (1u << glen) - 1u;
#pragma unroll
          for (int t = 0; t < TR; ++t) {
            storm::count_group<P>(pw[t], valid, cnt[t]);
            storm::count_group<P>(nw[t], valid, cnt[t]);
          }
        }
        continue;
      }
    }
    {
      // Point by point, each adding its weight: the weighted tiles of the
      // register path, and every tile of the shared-histogram path.
      for (int k = 0; k < count; ++k) {
        float v[REC];
        storm::load_record(recs, k, v);
        const float pad = v[S::kPadSlot];
        const float pad2 = __fmul_rn(2.f, pad);
        const int inc = __float_as_int(v[S::kIncSlot]);
#pragma unroll
        for (int t = 0; t < TR; ++t) {
          bool pos[P], neg[P];
          project<P, DMAX, REC, S::kExact>(v, wr[t], wpad[t], pad, pad2, d,
                                           pos, neg);
          int cp = 0, cn = 0;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            cp |= (int)pos[j] << j;
            cn |= (int)neg[j] << j;
          }
          if constexpr (S::kReg) {
#pragma unroll
            for (int b = 0; b < B; ++b)
              cnt[t][b] += (cp == b ? inc : 0) + (cn == b ? inc : 0);
          } else {
            col[cp * nthr] += inc;
            col[cn * nthr] += inc;
          }
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
cudaError_t launch(const float* z, const float* w, const float* mask,
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
  auto kernel = tenants == 1 ? paired_hist_kernel<P, D, DMAX, false>
                             : paired_hist_kernel<P, D, DMAX, true>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(z, w, mask, hist, n, d, rows,
                                          chunk);
  return cudaGetLastError();
}

// The exact-width body for d = 10 at the register-counting p; a generic
// body over DMAX = 16 or 32 for every other d <= 32.
template <int P>
cudaError_t dispatch_d(const float* z, const float* w, const float* mask,
                       int32_t* hist, int n, int d, int rows, int tenants,
                       cudaStream_t s) {
  if constexpr (P <= kRegPlanes) {
    if (d == kExactWidth)
      return launch<P, kExactWidth, kExactWidth>(z, w, mask, hist, n, d, rows,
                                                 tenants, s);
  }
  if (d <= 16) return launch<P, 0, 16>(z, w, mask, hist, n, d, rows, tenants, s);
  return launch<P, 0, 32>(z, w, mask, hist, n, d, rows, tenants, s);
}

// The insert of `tenants` stacked streams, then the epilogue.
cudaError_t insert(const float* z, const float* w, const float* mask,
                   int32_t* hist, void* out, int tenants, int n, int d, int p,
                   int rows, int out_bytes, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (n > 0 && (d > storm::kNarrowFeatures || p > storm::kNarrowPlanes)) {
    err = storm::launch_wide<true>(z, w, mask, hist, n, d, p, rows, tenants,
                                     s);
  } else if (n > 0) {  // empty streams leave the zeroed tables as they are
    switch (p) {
      case 1: err = dispatch_d<1>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 2: err = dispatch_d<2>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 3: err = dispatch_d<3>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 4: err = dispatch_d<4>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 5: err = dispatch_d<5>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 6: err = dispatch_d<6>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 7: err = dispatch_d<7>(z, w, mask, hist, n, d, rows, tenants, s); break;
      case 8: err = dispatch_d<8>(z, w, mask, hist, n, d, rows, tenants, s); break;
      default: err = cudaErrorInvalidValue;
    }
  }
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
