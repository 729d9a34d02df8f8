// The projection tile shared by the inserts' wide body (kernels 1, 3, 4 and
// 5 at d > 32 or p > 8; paired_hash_histogram.cu, hash_histogram.cu) and the
// SRP hash's tiled path (kernel 7 where a row's weights do not fit in
// registers; srp_hash.cu):
//
//   acc[i, j, r] = sum_f x[i, f] * w[j, f, r]
//
// in index order, each term a rounded multiply then a rounded add
// (__fmul_rn / __fadd_rn: no FMA contraction, no TF32), starting from +0, as
// the plain PyTorch version (kernels/ref.py, _project) does, so that kernel
// and plain version agree bit for bit. The users differ only in what they
// do with the signs, the epilogue `Out` (a template parameter): the inserts
// count the codes into an (R, 2^p) histogram (HistOut below), the SRP hash
// stores them as (n, R) int32.
//
// What bounds it on the H100: issue of fp32 instructions. Without FMA a
// multiply-add is two instructions, so at d = 515, n = 2^16, R = 2048,
// p = 4 the 2.8e11 multiply-adds need 16.5 ms at the card's 3.35e13 lane
// instructions per second (132 SMs x 128 lanes at 1980 MHz), twice the FMA
// bound. The hot loop issues 2.12 instructions per multiply-add
// (cuobjdump; scripts/insert_variants.py --family wide), and at that shape
// the paired insert takes 26.5 ms, the single-sided one 25.5 ms and the SRP
// hash 25.9 ms on an H100 at 1980 MHz (scripts/ab_insert_kernel.py), 1.6x
// the floor: about 0.65 instructions per scheduler per cycle, where the
// narrow inserts and the SRP hash's register path reach 0.86-0.90 (the
// stall reasons are not measured). The design keeps the instructions
// beyond the contract's two small:
//   * Register blocking. A block of 8 warps owns a tile of 64 hash rows and
//     TILE points. Lane l owns the adjacent rows r0 + 2l and r0 + 2l + 1
//     (one conflict-free float2 load per plane and feature; the SRP hash
//     stores both codes as one int2) and each warp TP consecutive points,
//     with TP x 2 x PG accumulators in registers. Per 4 features a thread
//     loads each of its points' 4 values as one float4 broadcast, and per
//     feature PG float2 weights: at PG = 4, TP = 8, 6 shared loads per 64
//     multiply-adds.
//   * Planes at compile time: PG = p for p <= 8, so that no accumulator is
//     dead. p > 8 runs in ceil(p / 8) passes of PG = ceil(p / passes)
//     planes over the same tile (the features restaged per pass), with
//     fewer points per thread; codes gather their bits across passes. The
//     kernels of PG = 5..8 serve both (p = PG in one pass, or passes).
//   * Staging: the features stream through shared memory in chunks of KC
//     (64 at PG <= 4, else 16), double-buffered with cp.async: chunk c + 1
//     is in flight while chunk c computes, and the next tile's first chunk
//     while a tile's last one does, one barrier per chunk. 16-byte
//     copies where the rows and the base are 16-byte aligned, 4-byte ones
//     otherwise (rows of d = 515 floats are not). Features past d, points
//     past the tile and rows past R are staged as zeros: a padded feature
//     adds +-0 to a sum that started at +0 (which a sum of rounded terms
//     never leaves for -0), so no bit changes.
//   * Paired (the PRP hash of kernels 1 and 4): the accumulator covers z's
//     d features; the zero feature is skipped and the pad term added last.
//     |z|^2 is summed once per point in index order, one lane per point as
//     the chunks stream in, and pad = sqrt(max(0, 1 - |z|^2)) kept in shared
//     memory; a = acc + pad * w_pad, the positive code is a > 0 and the
//     negative code a < (2 * pad) * w_pad, as the plain version.
//   * Banked: grid axis z is the tenant (its points and the epilogue's
//     tables); a lone stream is tenant 0 of the same kernel (the offsets
//     cost one multiply per block, so there is no separate lone build).
#pragma once

#include "insert_common.cuh"

namespace storm {

constexpr int kProjWarps = 8;
constexpr int kProjThreads = 32 * kProjWarps;
constexpr int kProjRows = 64;        // hash rows per tile: two per lane
constexpr int kProjPlanes = 8;       // the most planes per pass
constexpr int kProjMaxPlanes = 30;   // codes are int32 bit fields
constexpr int kProjChunkNarrow = 64;  // features per stage at PG <= 4
constexpr int kProjChunkWide = 16;    // ... and at PG > 4
constexpr int kProjPointsNarrow = 8;  // points per thread at PG <= 4
constexpr int kProjPointsWide = 4;    // ... and at PG > 4
// Resident blocks per SM that a kernel's registers must allow: at PG <= 4
// one (up to 255 registers: no spills, and as fast as two blocks with
// spills at 128); above, two (10% faster at p = 9 despite spills).
constexpr int kProjMinBlocksNarrow = 1;
constexpr int kProjMinBlocksWide = 2;

template <int PG>
struct ProjShape {
  static constexpr int kTP = PG <= 4 ? kProjPointsNarrow : kProjPointsWide;
  static constexpr int kChunk = PG <= 4 ? kProjChunkNarrow : kProjChunkWide;
  static constexpr int kTile = kProjWarps * kTP;  // points per tile
  static constexpr int kXStride = kChunk + 4;     // floats per staged point
  // Floats per stage: the tile's points, then the (PG, KC, 64) weights.
  static constexpr int kStage = kTile * kXStride + PG * kChunk * kProjRows;
  static_assert(kChunk % 4 == 0 && kXStride % 4 == 0, "float4 alignment");
};

// Planes per pass: p itself up to 8, else p split evenly over ceil(p / 8)
// passes.
inline int proj_planes(int p) {
  const int passes = (p + kProjPlanes - 1) / kProjPlanes;
  return (p + passes - 1) / passes;
}

struct ProjArgs {
  const float* x;  // (tenants, n, d) points
  const float* w;  // (p, dw, R) weights; the tile projects features [0, d)
  int n, d, dw, p, rows, chunk;
};

// Issue the copies of chunk f0 of one tile into `buf` (see ProjShape) and
// commit them as one group; zeros past d, npts, live planes and R. All
// threads of the block call it.
template <int PG>
__device__ __forceinline__ void stage_chunk(float* buf, const ProjArgs& a,
                                            const float* x, long long base,
                                            int npts, int f0, int j0,
                                            int live, int r0, bool x16,
                                            bool w16, int tid) {
  using S = ProjShape<PG>;
  constexpr int KC = S::kChunk, XS = S::kXStride, TILE = S::kTile;
  const int nf = min(KC, a.d - f0);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (x16) {  // d % 4 == 0, so nf is too
    for (int k = tid; k < TILE * KC / 4; k += kProjThreads) {
      const int pt = k / (KC / 4), f = 4 * (k % (KC / 4));
      float* dst = buf + pt * XS + f;
      if (pt < npts && f < nf)
        cp_async16(dst, x + (base + pt) * a.d + f0 + f);
      else
        *reinterpret_cast<float4*>(dst) = zero4;
    }
  } else {
    for (int k = tid; k < TILE * KC; k += kProjThreads) {
      const int pt = k / KC, f = k % KC;
      float* dst = buf + pt * XS + f;
      if (pt < npts && f < nf)
        cp_async4(dst, x + (base + pt) * a.d + f0 + f);
      else
        *dst = 0.f;
    }
  }
  float* ws = buf + TILE * XS;
  if (w16) {  // R % 4 == 0: a group of 4 rows is all in or all out
    for (int k = tid; k < PG * KC * kProjRows / 4; k += kProjThreads) {
      const int c = 4 * (k % (kProjRows / 4)), rest = k / (kProjRows / 4);
      const int f = rest % KC, j = rest / KC;
      float* dst = ws + (j * KC + f) * kProjRows + c;
      if (j < live && f < nf && r0 + c < a.rows)
        cp_async16(dst, a.w + ((size_t)(j0 + j) * a.dw + f0 + f) * a.rows
                            + r0 + c);
      else
        *reinterpret_cast<float4*>(dst) = zero4;
    }
  } else {
    for (int k = tid; k < PG * KC * kProjRows; k += kProjThreads) {
      const int c = k % kProjRows, rest = k / kProjRows;
      const int f = rest % KC, j = rest / KC;
      float* dst = ws + k;
      if (j < live && f < nf && r0 + c < a.rows)
        cp_async4(dst, a.w + ((size_t)(j0 + j) * a.dw + f0 + f) * a.rows
                           + r0 + c);
      else
        *dst = 0.f;
    }
  }
  cp_async_commit();
}

// The hot loop: nf4 groups of 4 staged features into this thread's
// accumulators acc[t][h][j] (point warp * TP + t, row r0 + 2 * lane + h,
// plane j of the pass), feature by feature in index order.
template <int PG>
__device__ __forceinline__ void project_chunk(
    const float* buf, int nf4, int warp, int lane,
    float (&acc)[ProjShape<PG>::kTP][2][PG]) {
  using S = ProjShape<PG>;
  constexpr int TP = S::kTP, KC = S::kChunk, XS = S::kXStride;
  const float* xs = buf + warp * TP * XS;
  const float* ws = buf + S::kTile * XS + 2 * lane;
#pragma unroll 1
  for (int f4 = 0; f4 < nf4; ++f4) {
    float4 xv[TP];
#pragma unroll
    for (int t = 0; t < TP; ++t)
      xv[t] = *reinterpret_cast<const float4*>(xs + t * XS + 4 * f4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 wv[PG];
#pragma unroll
      for (int j = 0; j < PG; ++j)
        wv[j] = *reinterpret_cast<const float2*>(
            ws + (j * KC + 4 * f4 + q) * kProjRows);
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        const float xq = q == 0 ? xv[t].x : q == 1 ? xv[t].y
                       : q == 2 ? xv[t].z : xv[t].w;
#pragma unroll
        for (int j = 0; j < PG; ++j) {
          acc[t][0][j] = __fadd_rn(acc[t][0][j], __fmul_rn(xq, wv[j].x));
          acc[t][1][j] = __fadd_rn(acc[t][1][j], __fmul_rn(xq, wv[j].y));
        }
      }
    }
  }
}

// Shared memory of the tile kernel beyond the epilogue's own.
template <int PG>
constexpr size_t proj_smem_bytes() {
  using S = ProjShape<PG>;
  return sizeof(float) * (2 * (size_t)S::kStage + S::kTile);  // + pads
}

// The kernel. Out is the epilogue:
//   static size_t smem_bytes(int p, int tile): its shared memory (host);
//   void setup(int tenant, const ProjArgs&, char* smem, int tile, int r0,
//              int tid): per block (tenant offsets, shared tables zeroed;
//              the first tile's barrier publishes them);
//   bool begin_tile(long long base, int npts, int tile, int tid): block
//              uniform; false skips the tile (it may hold a barrier);
//   void put(int k, long long i, int r, const int (&cp)[2],
//            const int (&cn)[2], int rows): the codes of point i (tile slot
//            k) at rows r and r + 1 (either may be past R), cn the negative
//            side's (paired only);
//   void finish(int r0, int rows, int tid): after the block's last tile.
//
// PG > 4 may run in passes (p > 8: the codes gather bits across them); at
// PG <= 4 the one pass is known at compile time, so that the codes are not
// live across the hot loop.
template <int PG, bool PAIRED, class Out>
__global__ void __launch_bounds__(kProjThreads, PG <= 4 ? kProjMinBlocksNarrow
                                                        : kProjMinBlocksWide)
projection_tile_kernel(ProjArgs a, Out out) {
  using S = ProjShape<PG>;
  constexpr int TP = S::kTP, KC = S::kChunk, XS = S::kXStride;
  constexpr int TILE = S::kTile;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                    // 2 x kStage
  float* pads = smem + 2 * S::kStage;      // (TILE,) paired: the pads
  char* out_smem = reinterpret_cast<char*>(pads + TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tenant = blockIdx.z;
  const float* x = a.x + (size_t)tenant * a.n * a.d;
  const int r0 = blockIdx.x * kProjRows;
  const int rl = r0 + 2 * lane;  // this lane's first row
  out.setup(tenant, a, out_smem, TILE, r0, tid);
  const int passes = PG > 4 ? (a.p + PG - 1) / PG : 1;
  const int chunks = (a.d + KC - 1) / KC;
  const bool x16 = ((reinterpret_cast<uintptr_t>(x) | (uintptr_t)a.d * 4)
                    & 15) == 0;
  const bool w16 = ((reinterpret_cast<uintptr_t>(a.w)
                     | (uintptr_t)a.rows * 4) & 15) == 0;

  const long long start = (long long)blockIdx.y * a.chunk;
  const long long end = min((long long)a.n, start + a.chunk);
  int cur = 0;           // the stage that holds (or will hold) the next chunk
  bool staged = false;   // this tile's first chunk is already in flight
  for (long long base = start; base < end; base += TILE) {
    const int npts = (int)min((long long)TILE, end - base);
    __syncthreads();  // the previous tile has been consumed
    if (!out.begin_tile(base, npts, TILE, tid)) {
      cp_async_wait<0>();  // drop a prefetch of this tile before restaging
      staged = false;
      continue;
    }
    int cp[TP][2], cn[TP][2];
#pragma unroll
    for (int t = 0; t < TP; ++t)
      cp[t][0] = cp[t][1] = cn[t][0] = cn[t][1] = 0;
    for (int pass = 0; pass < passes; ++pass) {
      const int j0 = pass * PG, live = min(PG, a.p - j0);
      float acc[TP][2][PG];
#pragma unroll
      for (int t = 0; t < TP; ++t)
#pragma unroll
        for (int j = 0; j < PG; ++j) acc[t][0][j] = acc[t][1][j] = 0.f;
      float sq = 0.f;  // paired, pass 0, tid < TILE: |z|^2 of point tid
      if (!staged)
        stage_chunk<PG>(stages + cur * S::kStage, a, x, base, npts, 0, j0,
                        live, r0, x16, w16, tid);
      staged = false;
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c is in; every thread is done with c - 1
        float* next = stages + (cur ^ 1) * S::kStage;
        if (c + 1 < chunks) {
          stage_chunk<PG>(next, a, x, base, npts, (c + 1) * KC, j0, live, r0,
                          x16, w16, tid);
        } else if (pass + 1 == passes && base + TILE < end) {
          stage_chunk<PG>(next, a, x, base + TILE,
                          (int)min((long long)TILE, end - base - TILE), 0, 0,
                          min(PG, a.p), r0, x16, w16, tid);
          staged = true;  // the next tile's first chunk of its first pass
        }
        const float* buf = stages + cur * S::kStage;
        cur ^= 1;
        const int nf = min(KC, a.d - c * KC);
        if (PAIRED && pass == 0 && tid < TILE) {
          const float* xp = buf + tid * XS;
          for (int f = 0; f < nf; ++f)
            sq = __fadd_rn(sq, __fmul_rn(xp[f], xp[f]));
          if (c == chunks - 1)
            pads[tid] = __fsqrt_rn(fmaxf(__fsub_rn(1.f, sq), 0.f));
        }
        project_chunk<PG>(buf, (nf + 3) >> 2, warp, lane, acc);
      }
      __syncthreads();  // the pads are in; the buffers are free again
      float2 wpad[PG];  // paired: the pad feature's weights of both rows
      if (PAIRED) {
#pragma unroll
        for (int j = 0; j < PG; ++j) {
          const float* src =
              a.w + ((size_t)(j0 + j) * a.dw + a.d + 1) * a.rows;
          wpad[j].x = (j < live && rl < a.rows) ? src[rl] : 0.f;
          wpad[j].y = (j < live && rl + 1 < a.rows) ? src[rl + 1] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        const float pad = PAIRED ? pads[warp * TP + t] : 0.f;
        const float pad2 = __fmul_rn(2.f, pad);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < PG; ++j) {
            if (j >= live) break;
            float v = acc[t][h][j];
            if (PAIRED) {
              const float wp = h ? wpad[j].y : wpad[j].x;
              v = __fadd_rn(v, __fmul_rn(pad, wp));
              cn[t][h] |= (v < __fmul_rn(pad2, wp)) << (j0 + j);
            }
            cp[t][h] |= (v > 0.f) << (j0 + j);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const int k = warp * TP + t;
      if (k < npts) out.put(k, base + k, rl, cp[t], cn[t], a.rows);
    }
  }
  out.finish(r0, a.rows, tid);
}

template <int PG, bool PAIRED, class Out>
cudaError_t launch_projection(const ProjArgs& args, const Out& out,
                              int tenants, cudaStream_t stream) {
  using S = ProjShape<PG>;
  ProjArgs a = args;
  dim3 grid;
  cudaError_t err = insert_grid(a.n, a.rows, kProjRows, tenants, &grid,
                                &a.chunk, S::kTile);
  if (err != cudaSuccess) return err;
  const size_t smem = proj_smem_bytes<PG>() + Out::smem_bytes(a.p, S::kTile);
  auto kernel = projection_tile_kernel<PG, PAIRED, Out>;
  if (smem > 48 * 1024) {  // every instantiation opts in for what it needs
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kProjThreads, smem, stream>>>(a, out);
  return cudaGetLastError();
}

// Launch the tile at PG = proj_planes(p) for `tenants` stacked streams.
template <bool PAIRED, class Out>
cudaError_t launch_projection_p(const ProjArgs& a, const Out& out,
                                int tenants, cudaStream_t s) {
  if (a.p < 1 || a.p > kProjMaxPlanes || a.d < 1 || a.rows < 1)
    return cudaErrorInvalidValue;
  switch (proj_planes(a.p)) {
    case 1: return launch_projection<1, PAIRED>(a, out, tenants, s);
    case 2: return launch_projection<2, PAIRED>(a, out, tenants, s);
    case 3: return launch_projection<3, PAIRED>(a, out, tenants, s);
    case 4: return launch_projection<4, PAIRED>(a, out, tenants, s);
    case 5: return launch_projection<5, PAIRED>(a, out, tenants, s);
    case 6: return launch_projection<6, PAIRED>(a, out, tenants, s);
    case 7: return launch_projection<7, PAIRED>(a, out, tenants, s);
    case 8: return launch_projection<8, PAIRED>(a, out, tenants, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the inserts' epilogue: a masked (R, 2^p) histogram ---------------------
//
// Point i adds int(mask[i]) to its code's bucket of every row (paired: to
// both codes'); a tile whose masks are all 0 is skipped. Counting: int32
// atomics into the block's (64, 2^p) histogram in shared memory for
// p <= kWideSharedPlanes, merged into the table after the block's last
// tile; above, int32 atomics straight into the (R, 2^p) table. Integer adds
// commute, so the table is exact whatever the order.
constexpr int kWideSharedPlanes = 6;  // 64 x 65 ints = 16.6 KB at p = 6

template <bool PAIRED>
struct HistOut {
  const float* mask;  // (tenants, n)
  int32_t* hist;      // (tenants, R, 2^p) int32
  int* incs;          // (TILE,) the tile's int(mask)
  int* hs;            // (64, 2^p + 1) the block's counters, or null
  int p;

  static size_t smem_bytes(int p, int tile) {
    return sizeof(int) * ((size_t)tile
                          + (p <= kWideSharedPlanes
                                 ? (size_t)kProjRows * ((1 << p) + 1) : 0));
  }

  __device__ void setup(int tenant, const ProjArgs& a, char* smem, int tile,
                        int, int tid) {
    p = a.p;
    mask += (size_t)tenant * a.n;
    hist += ((size_t)tenant * a.rows) << p;
    incs = reinterpret_cast<int*>(smem);
    hs = p <= kWideSharedPlanes ? incs + tile : nullptr;
    if (hs)
      for (int k = tid; k < kProjRows * ((1 << p) + 1); k += kProjThreads)
        hs[k] = 0;
  }

  __device__ bool begin_tile(long long base, int npts, int tile, int tid) {
    if (tid < tile) incs[tid] = tid < npts ? (int)mask[base + tid] : 0;
    return __syncthreads_or(tid < tile && incs[tid] != 0);
  }

  __device__ void put(int k, long long, int r, const int (&cp)[2],
                      const int (&cn)[2], int rows) {
    const int inc = incs[k];
    if (inc == 0) return;
    const int stride = (1 << p) + 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + h >= rows) break;
      if (hs) {
        int* row = hs + (r + h - blockIdx.x * kProjRows) * stride;
        atomicAdd(row + cp[h], inc);
        if (PAIRED) atomicAdd(row + cn[h], inc);
      } else {
        int32_t* row = hist + ((size_t)(r + h) << p);
        atomicAdd(row + cp[h], inc);
        if (PAIRED) atomicAdd(row + cn[h], inc);
      }
    }
  }

  __device__ void finish(int r0, int rows, int tid) {
    if (!hs) return;
    __syncthreads();
    const int buckets = 1 << p;
    for (int k = tid; k < (kProjRows << p); k += kProjThreads) {
      const int rr = k >> p, b = k & (buckets - 1);
      const int c = hs[rr * (buckets + 1) + b];
      if (r0 + rr < rows && c != 0)
        atomicAdd(hist + ((size_t)(r0 + rr) << p) + b, c);
    }
  }
};

// The inserts' wide body for `tenants` stacked streams of n points of d
// features (paired: w has d + 2 features, z is projected over the first d
// and the pad feature d + 1 added last), counted into the zeroed int32
// tables `hist`.
template <bool PAIRED>
cudaError_t launch_wide(const float* x, const float* w, const float* mask,
                        int32_t* hist, int n, int d, int p, int rows,
                        int tenants, cudaStream_t stream) {
  const ProjArgs a{x, w, n, d, PAIRED ? d + 2 : d, p, rows, 0};
  HistOut<PAIRED> out{mask, hist, nullptr, nullptr, p};
  return launch_projection_p<PAIRED>(a, out, tenants, stream);
}

}  // namespace storm
