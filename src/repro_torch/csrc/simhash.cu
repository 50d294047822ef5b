// Fused SimHash for Hopper: projection, sign and bit-pack in one pass.
//
//   codes[t, n] = sum_k [x[n] . w[:, t*K + k] >= 0] << k     (int64, < 2^K)
//
// Replaces the TPU kernel `_simhash_kernel` / `simhash_codes_pallas`
// (src/repro/kernels/simhash/kernel.py:53 / :76).
//
// Bound on an H100: the projection is 2*N*d*L*K fp32 operations
// (4.2e10 at N = 463,715, d = 91, L*K = 500) against ~0.54 GB of traffic
// (x read once, int64 codes written once), so the kernel is bound by
// CUDA-core fp32 FMAs (~0.63 ms at the SXM part's 67 TFLOP/s), not by
// memory.  Tensor cores are not used on purpose: TF32 flips the sign of
// near-zero projections and breaks code parity with the plain version,
// and full-fp32 tensor-core emulation (3xTF32) is later work.
//
// What the design does about that bound (times: tools/bench_simhash.py
// on an H100 80GB HBM3 at 700 W; PERF.md):
//   * Register tiles.  A block of 256 threads computes BM rows x 128
//     columns of whole tables (floor(128 / K) tables: 25 at K 5, so 4
//     groups and 512 column slots for L*K = 500).  Each thread owns
//     TM = BM / 16 rows x 8 contiguous columns; a feature step is TM / 4
//     (or one 8-byte) shared loads of x and 2 of w for 8 * TM FMAs: 4
//     loads per 64 FMAs at BM 128.  A warp covers 8 row threads x 32
//     columns, so a warp whose 32 columns are all padding skips its FMAs.
//   * Narrow groups.  A group of at most 72 columns whose parts go across
//     blocks (the train path's 70) takes a layout of its own: 8 column
//     threads of 9 columns (thread ct has columns ct + 8 j), 32 row
//     threads of TM = BM / 32 consecutive rows, so all 8 warps compute
//     and 72 columns are computed, not 96 (with 2 of 8 warps idle on
//     padding).  Its w is read unpadded, 4 bytes a copy, into shared rows
//     of 8 x 12 floats (a thread's 9 columns 16-byte aligned: 3 loads a
//     feature); its part sums go to scratch column-major, so that a warp
//     writes whole sectors.
//   * Staging.  x and w go through shared memory in chunks of 32
//     features, a ring of 3 chunks of cp.async copies, one __syncthreads
//     a chunk.  The number of copy instructions is what costs: with every
//     thread copying 4 bytes at a time, copies and FMAs did not overlap
//     (their times added up) whatever the ring's depth, so the copies are
//     as wide as the layouts allow:
//       - w in 16-byte copies from a padded layout (simhash_codes_cuda
//         puts group g's columns at g * 128, one strided copy per call);
//       - x in 16-byte copies, row-major (row stride 36 floats, a
//         thread's rows a row-thread count apart: a warp's 8 row threads
//         hit distinct banks; one load gives a row's 4 features), when
//         its rows are 16-byte aligned (d % 4 == 0) at TM <= 4, not
//         beside a running total nor in a wide split of 4 rows a thread
//         (there it spills); else in 4-byte copies, feature-major (rows
//         padded by 4 floats: 32 distinct banks).
//     The blocks of one row tile are adjacent in launch order, so the x
//     tile they share is read from HBM once and from L2 after that.
//   * Epilogue.  Like the TPU kernel, the (N, L*K) projection never
//     reaches device memory: the signs of a row's 8 columns are one byte
//     of its 128-bit sign word in shared memory; then one thread per
//     (row, table) reads its K bits (they may straddle two 32-bit words)
//     and writes the code table-major, (L, N): neighbouring threads take
//     neighbouring rows, so a warp's stores are coalesced and the index
//     build sorts each table row in place.
//   * The sum order is the bucket probe's (bucket_probe.cu), so a point
//     hashed by the probe as a query gets bitwise the code it has here:
//       d <= 128: one sum over the features in order with fmaf from 0.
//       d > 128: parts of 64 features, each summed in order with fmaf
//         from 0; the total starts at 0 and adds the parts in part order.
//     Above 128 features a launch adds the parts one of two ways
//     (simhash_plan in kernels/simhash/kernel.py picks), both at
//     TM <= 4, to bound the registers:
//       - in registers: each thread keeps a part's sums and the running
//         total, when the row tiles alone fill the card;
//       - across blocks, when they do not: R (2 to 16) blocks share a row
//         tile, block r taking parts [r * pg, + pg) and writing each
//         part's sums to scratch (L2).  The launch is cooperative, so
//         every block is resident at once and a block may wait for the
//         others of its tile: one release add of a count per tile, then
//         an acquire spin until all R have added.  Then block r adds, for
//         rows [r * BM / R, + BM / R) of the tile, every part's sums in
//         part order: all threads copy batches of parts (16-byte
//         cp.async) into shared memory, and a thread per 4 sums adds
//         them in order; then it packs and writes those rows' codes.  The adds are spread over the tile's blocks, none serial
//         over the whole tile (a last block adding a 64-row tile's 48
//         parts alone left a ~15 us tail; thread-block clusters sharing
//         the sums in distributed shared memory were scheduled 16 blocks
//         per GPC, up to 66 us late).  The last block to leave sets the
//         tile's counts back to 0, so they need no fill per call.  This
//         is the train path's case (N 2,048, d 3,072, 70 columns).
//     No atomics touch a sum, so two calls give the same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;      // chunks in the staging ring
constexpr int kDepth = 32;      // features a staging chunk
constexpr int kFeatOne = 128;   // d up to this: one sum over every feature
constexpr int kFeatPart = 64;   // above it: features a part
constexpr int kSignRow = 20;    // sign bytes a row: 128 bits and a zero word
constexpr int kMaxK = 32;
constexpr int kMaxRanks = 16;   // blocks a row tile
constexpr int kChunksPerPart = kFeatPart / kDepth;
static_assert(kFeatPart % kDepth == 0 && kDepth % 8 == 0,
              "parts are whole chunks of whole 8-feature groups");

// A block's column layout.  Wide: 16 column threads of 8 contiguous
// columns (thread ct: ct * 8 + j), 128 columns, w padded to 128 a group.
// Narrow: 8 column threads of 9 interleaved columns (ct + 8 j), 72
// columns, w unpadded; in shared memory a thread's 9 at ct * 12.  A warp
// is 8 row threads x 4 column threads either way.
template <bool kNarrow>
struct Cols {
  static constexpr int kTN = kNarrow ? 9 : 8;    // columns a thread
  static constexpr int kSN = kNarrow ? 12 : 8;   // their floats in shared w
  static constexpr int kCW = kNarrow ? 2 : 4;    // column warps
  static constexpr int kCT = 4 * kCW;            // column threads
  static constexpr int kRT = kThreads / kCT;     // row threads: 32 or 16
  static constexpr int kCols = kCT * kTN;        // columns a block
  static constexpr int kWs = kCT * kSN;          // floats of a shared w row
  // column of a thread's j-th
  static __device__ __forceinline__ int col(int ct, int j) {
    return kNarrow ? ct + kCT * j : ct * kTN + j;
  }
};

constexpr int kWideCols = Cols<false>::kCols;     // 128
constexpr int kNarrowCols = Cols<true>::kCols;    // 72

// floats of one ring slot: x, then w (feature-major, row stride kWs).
// x is feature-major (row stride rows + 4) from 4-byte copies or, when
// its rows are 16-byte aligned (kVec), row-major (row stride kDepth + 4)
// from 16-byte copies
template <int TM, bool kVec, bool kNarrow>
constexpr int kXFloats = kVec ? Cols<kNarrow>::kRT * TM * (kDepth + 4)
                              : kDepth * (Cols<kNarrow>::kRT * TM + 4);
template <int TM, bool kVec, bool kNarrow>
constexpr int kSlotFloats =
    kXFloats<TM, kVec, kNarrow> + kDepth * Cols<kNarrow>::kWs;
// dynamic shared memory of a block: the ring, then the sign words
template <int TM, bool kVec, bool kNarrow>
constexpr int kSmemBytes = kStages * kSlotFloats<TM, kVec, kNarrow> * 4 +
                           Cols<kNarrow>::kRT * TM * kSignRow;

// The launch's arguments.  x: (n, d); w: (d, lk), group g's columns at
// c0 = g * 128 (wide, padded) or g * tables * k (narrow, w as given);
// codes: (l, n); split: part [tile * groups + group][parts], each part
// rows x cs floats (wide row-major, narrow column-major), and arrived 2
// counts a tile, 0 before and after the launch
struct Params {
  const float* x;
  const float* w;
  int64_t* codes;
  float* part;
  int* arrived;
  int64_t n, lk;
  int d, l, k, tables, groups, parts, ranks, pg, cs;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// wait until at most `pending` of this thread's newest copy groups are
// still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Copy features [f0, f0 + kDepth) of the block's rows of x and of its
// group's columns of w into the slot.  w: wide, by 16-byte copies of the
// padded rows (features past d not copied); narrow, by 4-byte copies,
// column c of the group to c % 8 * 12 + c / 8 (thread ct's columns ct +
// 8 j at ct * 12 + j), zero-filled past d and past the group's ncols
// columns.  x: feature-major (row stride rows + 4) by 4-byte copies,
// zero-filled past n and d, a warp on 4 rows x 8 features (4 segments of
// 32 bytes, 32 distinct banks: 4 * f + r mod 32), or (kVec) row-major
// (row stride kDepth + 4) by 16-byte copies, a warp on 4 rows x 128
// bytes.  Features past d are never read, nor are rows past n stored.
template <int TM, bool kVec, bool kNarrow>
__device__ __forceinline__ void stage(float* __restrict__ xs,
                                      float* __restrict__ ws,
                                      const Params p, int64_t row0, int c0,
                                      int ncols, int f0) {
  using C = Cols<kNarrow>;
  constexpr int kRows = C::kRT * TM, kXs = kRows + 4, kGroups = kDepth / 8;
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kQ = kDepth / 4;   // 16-byte pieces a row of a chunk
#pragma unroll
    for (int e = tid; e < kRows * kQ; e += kThreads) {
      const int r = e / kQ, q = e % kQ;
      const int64_t row = row0 + r;
      const int feat = f0 + 4 * q;
      if (row < p.n && feat < p.d)   // d % 4 == 0: all 4 features or none
        cp_async16(xs + r * (kDepth + 4) + 4 * q, p.x + row * p.d + feat);
    }
  }
#pragma unroll
  for (int u = 0; u < (kVec ? 0 : kRows * kDepth / kThreads); ++u) {
    const unsigned e = u * kThreads + tid;
    const int f = (e / 32) % kGroups * 8 + (e & 7);
    const int r = e / (32 * kGroups) * 4 + ((e >> 3) & 3);
    const int64_t row = row0 + r;
    const int feat = f0 + f;
    const bool ok = row < p.n && feat < p.d;
    cp_async4(xs + f * kXs + r, ok ? p.x + row * p.d + feat : p.x, ok);
  }
  if constexpr (kNarrow) {
    // thread tid < 3 * kCols: column c = tid % kCols, features tid /
    // kCols + 3 i (a fixed column and stride: few live registers)
    constexpr int kSpan = kThreads / C::kCols;   // 3
    if (tid < kSpan * C::kCols) {
      const int c = tid % C::kCols, fs = tid / C::kCols;
      float* dst = ws + fs * C::kWs + c % C::kCT * C::kSN + c / C::kCT;
      const float* src = p.w + (f0 + fs) * p.lk + c0 + c;
#pragma unroll
      for (int f = fs; f < kDepth; f += kSpan) {
        const bool ok = f0 + f < p.d && c < ncols;
        cp_async4(dst, ok ? src : p.w, ok);
        dst += kSpan * C::kWs;
        src += kSpan * p.lk;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kDepth * C::kCols / 4 / kThreads; ++u) {
      const int e = u * kThreads + tid;
      const int c = (e & (C::kCols / 4 - 1)) * 4, f = e / (C::kCols / 4);
      const int feat = f0 + f;
      if (feat < p.d)
        cp_async16(ws + f * C::kWs + c, p.w + feat * p.lk + c0 + c);
    }
  }
}

// a thread's kTN columns of w at one feature: 16-byte loads, then one
// 4-byte load of the narrow layout's ninth
template <int TN>
__device__ __forceinline__ void load_w(const float* __restrict__ ws,
                                       float (&b)[TN]) {
#pragma unroll
  for (int j = 0; j + 4 <= TN; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(ws + j);
    b[j] = v.x;
    b[j + 1] = v.y;
    b[j + 2] = v.z;
    b[j + 3] = v.w;
  }
#pragma unroll
  for (int j = TN / 4 * 4; j < TN; ++j) b[j] = ws[j];
}

// One feature step of a thread's TM x TN tile from feature-major x.
template <int TM, int TN>
__device__ __forceinline__ void fma_step(const float* __restrict__ xs,
                                         const float* __restrict__ ws,
                                         float (&acc)[TM][TN]) {
  float a[TM], b[TN];
  if constexpr (TM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(xs);
    a[0] = v.x;
    a[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
  }
  load_w<TN>(ws, b);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// Four feature steps of a thread's TM x TN tile from row-major x (kVec):
// one 16-byte load gives a row's 4 features; rows RS apart.
template <int TM, int TN, int RS, int WS>
__device__ __forceinline__ void fma_step4(const float* __restrict__ xs,
                                          const float* __restrict__ ws,
                                          float (&acc)[TM][TN]) {
  float4 a[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
    a[i] = *reinterpret_cast<const float4*>(xs + i * RS * (kDepth + 4));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float b[TN];
    load_w<TN>(ws + q * WS, b);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float ai = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z
                                                                  : a[i].w;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, b[j], acc[i][j]);
    }
  }
}

// the sign bits of 8 columns, `stride` floats apart
__device__ __forceinline__ unsigned sign_byte(const float* s,
                                              int stride = 1) {
  unsigned byte = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) byte |= (s[j * stride] >= 0.f ? 1u : 0u) << j;
  return byte;
}

// How a launch adds the features: one sum (d <= 128), or parts of 64
// with the running total in registers, or parts across blocks.
enum Mode { kOne, kRegParts, kSplitParts };

// Block (tile * groups + group) * ranks + rank of the flattened grid:
// rows [tile * rows, + rows), tables [group * tables, + tables), and the
// features of parts [rank * pg, + pg) (kSplitParts: the ranks blocks of
// a tile share their part sums in part, cs >= the group's columns) or
// all of them.  Dynamic shared memory: the ring, then the sign words
// [rows][kSignRow bytes].
template <int TM, Mode M, bool kVec, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 2)
simhash_kernel(const Params p) {
  using C = Cols<kNarrow>;
  static_assert(!kNarrow || (M == kSplitParts && (TM == 2 || TM == 4)),
                "the narrow layout's sums go through scratch");
  constexpr int kTN = C::kTN, kRows = C::kRT * TM, kXs = kRows + 4;
  constexpr int kSlot = kSlotFloats<TM, kVec, kNarrow>;
  constexpr int kX = kXFloats<TM, kVec, kNarrow>;
  constexpr bool kTotal = M == kRegParts, kSplit = M == kSplitParts;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;
  uint8_t* const signs = reinterpret_cast<uint8_t*>(smem + kStages * kSlot);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = kSplit ? blockIdx.x % p.ranks : 0;
  const int tg = kSplit ? blockIdx.x / p.ranks : blockIdx.x;
  const int g = tg % p.groups;
  const int64_t row0 = static_cast<int64_t>(tg / p.groups) * kRows;
  const int t0 = g * p.tables;
  const int ntab = min(p.tables, p.l - t0);
  const int ncols = ntab * p.k;
  const int c0 = kNarrow ? t0 * p.k : g * C::kCols;
  // the block's features: all, or parts [rank * pg, + pg) (none for a
  // rank past the last part)
  const int fbeg = kSplit ? min(p.d, rank * p.pg * kFeatPart) : 0;
  const int fend = kSplit ? min(p.d, (rank + 1) * p.pg * kFeatPart) : p.d;

  // thread tile: rows rt * TM + i (kVec: rt + kRT * i, so that a warp's 8
  // row threads read 8 consecutive rows, on distinct banks), columns
  // C::col(ct, j)
  const int rt = warp / C::kCW * 8 + (lane >> 2);
  const int rfirst = kVec ? rt : rt * TM;
  constexpr int kRStride = kVec ? C::kRT : 1;
  const int ct = warp % C::kCW * 4 + (lane & 3);
  // a wide warp whose 32 columns are all padding skips its FMAs
  const bool live = kNarrow || warp % C::kCW * 32 < ncols;

  // kSplitParts: this thread's part sums, part 0 (a part is kRows * cs
  // floats: wide [row][cs], narrow [cs][row])
  float* const mine =
      !kSplit ? nullptr
              : p.part + static_cast<int64_t>(tg) * p.parts * kRows * p.cs +
                    (kNarrow ? C::col(ct, 0) * kRows + rfirst
                             : rfirst * p.cs + C::col(ct, 0));

  float acc[TM][kTN], tot[kTotal ? TM : 1][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  if constexpr (kTotal) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) tot[i][j] = 0.f;
  }

  // the ring: chunk c in slot c % kStages, kStages - 1 chunks in flight;
  // every step commits a group (empty past the end), so "chunk c has
  // landed" is "at most kStages - 2 groups pending"
  const int nch = (fend - fbeg + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch)
      stage<TM, kVec, kNarrow>(ring + s * kSlot, ring + s * kSlot + kX, p,
                               row0, c0, ncols, fbeg + s * kDepth);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c has landed; chunk c - 1's slot is free
    if (c + kStages - 1 < nch) {
      float* slot = ring + (c + kStages - 1) % kStages * kSlot;
      stage<TM, kVec, kNarrow>(slot, slot + kX, p, row0, c0, ncols,
                               fbeg + (c + kStages - 1) * kDepth);
    }
    cp_async_commit();
    const int depth = min(kDepth, fend - fbeg - c * kDepth);
    if (live) {
      const float* wb = ring + c % kStages * kSlot + kX + ct * C::kSN;
      if constexpr (kVec) {
        // depth is a multiple of 4 (d is)
        const float* xb = ring + c % kStages * kSlot + rt * (kDepth + 4);
        if (depth == kDepth) {
          // the narrow 4 x 9 tile: 2 steps at a time, so that the loads
          // of later steps do not spill it
#pragma unroll(kNarrow && TM == 4 ? 2 : kDepth / 4)
          for (int f = 0; f < kDepth; f += 4)
            fma_step4<TM, kTN, C::kRT, C::kWs>(xb + f, wb + f * C::kWs, acc);
        } else {
          for (int f = 0; f < depth; f += 4)
            fma_step4<TM, kTN, C::kRT, C::kWs>(xb + f, wb + f * C::kWs, acc);
        }
      } else {
        const float* xb = ring + c % kStages * kSlot + rt * TM;
        if (depth == kDepth) {
#pragma unroll
          for (int f = 0; f < kDepth; ++f)
            fma_step<TM, kTN>(xb + f * kXs, wb + f * C::kWs, acc);
        } else {
          for (int f = 0; f < depth; ++f)
            fma_step<TM, kTN>(xb + f * kXs, wb + f * C::kWs, acc);
        }
      }
    }
    if constexpr (kTotal || kSplit) {
      // the end of a part: add its sums to the total, in part order, or
      // write them to scratch for the tile's blocks
      if ((c + 1) % kChunksPerPart == 0 || c + 1 == nch) {
        if constexpr (kSplit) {
          float* dst = mine + static_cast<int64_t>(
                                  rank * p.pg + c / kChunksPerPart) *
                                  kRows * p.cs;
          if constexpr (kNarrow) {
            // column ct + 8 j (below cs): a warp's 8 row threads write
            // consecutive rows of a column, whole sectors; a thread's TM
            // rows in one store where they are consecutive (not kVec)
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              float* q = dst + C::kCT * j * kRows;
              if (C::col(ct, j) >= p.cs) continue;
              if constexpr (kVec) {
#pragma unroll
                for (int i = 0; i < TM; ++i) q[i * kRStride] = acc[i][j];
              } else if constexpr (TM == 4)
                *reinterpret_cast<float4*>(q) =
                    make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
              else
                *reinterpret_cast<float2*>(q) =
                    make_float2(acc[0][j], acc[1][j]);
            }
          } else if (ct * kTN < ncols) {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                *reinterpret_cast<float4*>(dst + i * kRStride * p.cs +
                                           4 * h) =
                    make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            if constexpr (kTotal) tot[i][j] += acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
  }
  if constexpr (kTotal) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = tot[i][j];
  }

  // the sign words of the rows this block writes: [rbeg, rbeg + rows)
  int rbeg = 0, rows = kRows;
  if constexpr (kSplit) {
    __syncthreads();   // the block's part sums are written
    if (tid == 0) {
      // release: the block's sums before its count; acquire: the other
      // blocks' sums after theirs (bar.sync carries both to the block)
      red_release_add(p.arrived + 2 * tg, 1);
      while (ld_acquire(p.arrived + 2 * tg) < p.ranks) __nanosleep(32);
    }
    __syncthreads();   // every part's sums of the tile are in scratch
    // rows [rbeg, + rows) of the tile, one item a float4 (wide: 4
    // columns of a row; narrow: 4 rows of a column): every part's sums in
    // part order from 0.  In batches of as
    // many parts as fit the ring after the items' running sums: every
    // thread copies (16-byte cp.async, through L2: other SMs wrote them)
    // its share of the batch, then each item's thread adds the batch's
    // parts to its sum in order
    rows = kRows / p.ranks;
    rbeg = rank * rows;
    const int items = rows * p.cs / 4, quads = kNarrow ? rows / 4 : 0;
    float4* const sums = reinterpret_cast<float4*>(ring);
    float4* const stg = sums + items;
    const int batch = (kStages * kSlot / 4 - items) / items;
    const float* from =
        p.part + static_cast<int64_t>(tg) * p.parts * kRows * p.cs +
        (kNarrow ? rbeg : rbeg * p.cs);
    for (int e = tid; e < items; e += kThreads)
      sums[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < p.parts; q0 += batch) {
      const int nb = min(batch, p.parts - q0);
      for (int e = tid; e < nb * items; e += kThreads) {
        const int u = e / items, it = e - u * items;
        const int at = kNarrow ? it / quads * kRows + it % quads * 4 : it * 4;
        cp_async16(reinterpret_cast<float*>(stg + e),
                   from + static_cast<int64_t>(q0 + u) * kRows * p.cs + at);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = tid; e < items; e += kThreads) {
        float4 sm = sums[e];
        for (int u = 0; u < nb; ++u) {
          const float4 v = stg[u * items + e];
          sm.x += v.x;
          sm.y += v.y;
          sm.z += v.z;
          sm.w += v.w;
        }
        sums[e] = sm;
      }
      __syncthreads();
    }
    if (tid == 0 && atomicAdd(p.arrived + 2 * tg + 1, 1) == p.ranks - 1) {
      // every block of the tile is past its wait: the counts go back to 0
      p.arrived[2 * tg] = 0;
      p.arrived[2 * tg + 1] = 0;
    }
    for (int e = tid; e < rows * 16; e += kThreads) {
      const int rl = e >> 4, oct = e & 15;
      const unsigned byte =
          oct * 8 >= ncols ? 0u
          : kNarrow        ? sign_byte(ring + oct * 8 * rows + rl, rows)
                           : sign_byte(ring + rl * p.cs + oct * 8);
      signs[(rbeg + rl) * kSignRow + oct] = static_cast<uint8_t>(byte);
      if (oct < 4) signs[(rbeg + rl) * kSignRow + 16 + oct] = 0;
    }
  } else {
    // signs: byte ct of row r holds columns ct * 8 .. + 7, so the bytes
    // of a row are its 128-bit sign word (little-endian: column c is bit
    // c % 32 of 32-bit word c / 32); a zero word after it for straddling
    // reads
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rfirst + i * kRStride;
      signs[r * kSignRow + ct] = static_cast<uint8_t>(sign_byte(acc[i]));
      if (ct < 4) signs[r * kSignRow + 16 + ct] = 0;
    }
  }
  __syncthreads();

  // one thread per (row, table): neighbouring threads, neighbouring rows
  const uint64_t mask = (uint64_t{1} << p.k) - 1;
  const int lg = __ffs(rows) - 1;   // rows is a power of 2
  for (int e = tid; e < ntab * rows; e += kThreads) {
    const int r = rbeg + (e & (rows - 1)), tl = e >> lg;
    const int64_t row = row0 + r;
    if (row >= p.n) continue;
    const int cb = tl * p.k;
    const uint32_t* sw =
        reinterpret_cast<const uint32_t*>(signs + r * kSignRow);
    const uint64_t both =
        sw[cb >> 5] | static_cast<uint64_t>(sw[(cb >> 5) + 1]) << 32;
    p.codes[static_cast<int64_t>(t0 + tl) * p.n + row] =
        static_cast<int64_t>((both >> (cb & 31)) & mask);
  }
}

template <int TM, Mode M, bool kVec, bool kNarrow>
int launch(const Params& p, unsigned blocks, cudaStream_t stream) {
  constexpr int smem = kSmemBytes<TM, kVec, kNarrow>;
  if constexpr (smem > 48 * 1024) {
    static const cudaError_t set = cudaFuncSetAttribute(
        simhash_kernel<TM, M, kVec, kNarrow>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // split across blocks: every block resident at once, for the tile waits
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = M == kSplitParts ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, simhash_kernel<TM, M, kVec, kNarrow>, p));
}

// One instantiation: its launcher, dynamic shared memory, rows a block,
// sum mode and layouts.
struct Instance {
  int (*launch)(const Params&, unsigned, cudaStream_t);
  int smem, rows, mode, vec, narrow;
};

template <int TM, Mode M, bool kVec, bool kNarrow>
Instance instance() {
  return {launch<TM, M, kVec, kNarrow>, kSmemBytes<TM, kVec, kNarrow>,
          Cols<kNarrow>::kRT * TM, M, kVec, kNarrow};
}

// 16-byte copies of x where a row-major x's registers do not spill: at
// TM <= 4, not beside a running total, nor in a wide split of 4 rows a
// thread
template <int TM, Mode M, bool kNarrow>
Instance instance_x(bool vec) {
  if constexpr (TM <= 4 && M != kRegParts &&
                (kNarrow || M != kSplitParts || TM == 2))
    if (vec) return instance<TM, M, true, kNarrow>();
  return instance<TM, M, false, kNarrow>();
}

// The instantiation that computes a plan (simhash_plan's fields) on x, or
// none (launch null) for a plan the kernel does not take.  Also the
// part sums' row stride cs.
Instance select(const float* x, int64_t n, int d, int l, int k, int bm,
                int tables, int parts, int ranks, int narrow, int* cs) {
  const Instance none = {};
  const int want_parts = d <= kFeatOne ? 1 : (d + kFeatPart - 1) / kFeatPart;
  if (k < 1 || k > kMaxK || d < 1 || l < 1 || n < 1 || tables < 1 ||
      tables > l || (narrow != 0 && narrow != 1) ||
      tables * k > (narrow ? kNarrowCols : kWideCols) ||
      parts != want_parts || ranks < 1 || ranks > kMaxRanks ||
      (ranks & (ranks - 1)) || ranks > parts)
    return none;
  if (narrow ? ranks < 2 || (bm != 128 && bm != 64)
             : (bm != 128 && bm != 64 && bm != 32) || (parts > 1 && bm > 64))
    return none;
  const int64_t groups = (l + tables - 1) / tables;
  if ((n + bm - 1) / bm * groups * ranks > 0x7fffffffLL) return none;
  // rows of x 16-byte aligned: 16-byte copies of x
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Instance in =
      narrow      ? bm == 128 ? instance_x<4, kSplitParts, true>(vec)
                              : instance_x<2, kSplitParts, true>(vec)
      : ranks > 1 ? bm == 64 ? instance_x<4, kSplitParts, false>(vec)
                             : instance_x<2, kSplitParts, false>(vec)
      : parts > 1 ? bm == 64 ? instance_x<4, kRegParts, false>(vec)
                             : instance_x<2, kRegParts, false>(vec)
      : bm == 128 ? instance_x<8, kOne, false>(vec)
      : bm == 64  ? instance_x<4, kOne, false>(vec)
                  : instance_x<2, kOne, false>(vec);
  *cs = (tables * k + 7) / 8 * 8;
  // a split block's reduce: its rows' running sums and one part's more
  // fit the ring
  if (ranks > 1 &&
      2 * (bm / ranks) * (*cs / 4) > (in.smem - bm * kSignRow) / 16)
    return none;
  return in;
}

}  // namespace

// The instantiation a plan launches on x (see simhash_codes_launch):
// info = {rows a block, sum mode (0 one, 1 parts in registers, 2 parts
// across blocks), 16-byte copies of x, the narrow layout, dynamic shared
// memory bytes}.  Returns 0, or cudaErrorInvalidValue for a plan the
// kernel does not take.
extern "C" int simhash_instance(const float* x, int64_t n, int d, int l,
                                int k, int bm, int tables, int parts,
                                int ranks, int narrow, int* info) {
  int cs;
  const Instance in =
      select(x, n, d, l, k, bm, tables, parts, ranks, narrow, &cs);
  if (!in.launch) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = in.rows;
  info[1] = in.mode;
  info[2] = in.vec;
  info[3] = in.narrow;
  info[4] = in.smem;
  return 0;
}

// x: (n, d) fp32 row-major; w: (d, l*k) fp32 row-major as given (narrow),
// or (d, groups * 128), 16-byte aligned, group g's tables' columns at
// g * 128 (simhash_codes_cuda lays the projections out so; the columns
// after them only reach sign bits that are masked off); codes: (l, n)
// int64.  The plan (simhash_plan): bm rows a block (128, 64 or 32; at
// most 64 when d > 128, except narrow), tables a block (tables * k <= 128,
// or <= 72 narrow), parts (1 for d <= 128, else ceil(d / 64)), ranks, the
// blocks that share a row tile: 1 (every part in one block) or 2, 4, 8
// or 16, each taking ceil(parts / ranks) parts, when part holds
// ceil(n / bm) * groups * parts * bm * cs floats of scratch, cs = tables
// * k rounded up to 8, arrived 2 * ceil(n / bm) * groups int32 counts
// that are 0 before the launch (and 0 again after it), and every block
// fits on the card at once (a cooperative launch); and narrow (only with
// ranks > 1, at bm 128 or 64).  Returns the cudaError_t of the launch.
extern "C" int simhash_codes_launch(const float* x, const float* w,
                                    int64_t* codes, float* part,
                                    int* arrived, int64_t n, int d, int l,
                                    int k, int bm, int tables, int parts,
                                    int ranks, int narrow, void* stream) {
  int cs;
  const Instance in =
      select(x, n, d, l, k, bm, tables, parts, ranks, narrow, &cs);
  if (!in.launch || (ranks > 1 && (!part || !arrived)) ||
      (!narrow && reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (l + tables - 1) / tables;
  Params p;
  p.x = x;
  p.w = w;
  p.codes = codes;
  p.part = part;
  p.arrived = arrived;
  p.n = n;
  p.lk = narrow ? static_cast<int64_t>(l) * k
                : static_cast<int64_t>(groups) * kWideCols;
  p.d = d;
  p.l = l;
  p.k = k;
  p.tables = tables;
  p.groups = groups;
  p.parts = parts;
  p.ranks = ranks;
  p.pg = (parts + ranks - 1) / ranks;
  p.cs = cs;
  const auto blocks =
      static_cast<unsigned>((n + bm - 1) / bm * groups * ranks);
  return in.launch(p, blocks, static_cast<cudaStream_t>(stream));
}
