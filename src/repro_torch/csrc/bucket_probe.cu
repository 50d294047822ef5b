// LSH bucket probe for Hopper: hash once per (query, table), then one
// warp-wide k-ary search per (query, probe, table).
//
//   lo[b, j, t] = #{ i : sorted_codes[t, i] <  code(q_b)[t] ^ mask_j }
//   hi[b, j, t] = #{ i : sorted_codes[t, i] <= code(q_b)[t] ^ mask_j }
//
// Three entry points replace the three TPU kernels in
// src/repro/kernels/bucket_probe/kernel.py:
//   bucket_probe_launch        `_fused_kernel` / `bucket_probe_pallas` (:92 / :164)
//   bucket_probe_multi_launch  `_multi_kernel` / `bucket_probe_multi_pallas` (:125 / :200)
//   bucket_probe_codes_launch  `_codes_kernel` / `bucket_probe_codes_pallas` (:110 / :246)
//
// The TPU kernels COUNT: they stream all L*N sorted codes per call and
// rank the query code against every one, because a TPU has no cheap
// gathers.  Hopper has them, so lo and hi come from searches instead.
//
// What bounds it on an H100: not bytes.  The searches touch ~30 KB at
// B 1, J 1, L 100, and the hash reads w once (182 KB at d 91, 860 KB at
// d 3,072): well under a microsecond at HBM rate.  The time is the
// launch plus ROUNDS OF L2 LATENCY: the hash's loads, then each search
// round's loads, each waiting on the one before.  What the design does
// about it is to cut the rounds:
//
// 1. Hash once per (query, table), spread over threads.  The L*K
//    projections of a query are a GEMV over w (d x L*K, row-major).  A
//    block takes one query and a group of whole tables (T*K <= 256
//    columns; the wrapper takes the fewest T of 1, 2, 4, 8 that keeps
//    the launch within 2 blocks an SM, since a small group starts its
//    searches sooner but more blocks cost more: T 1 at B 1, d 91; 2 at
//    d 3,072; 8 at B 16).  Its threads stage the group's slice of w into
//    shared memory in batches of independent L2 loads, neighbouring
//    threads on neighbouring columns (each row of the slice is one
//    coalesced read), and one thread per column sums its column.  Each
//    warp ballots its columns' signs into a 256-bit word in shared
//    memory; a table's K bits are read from it (its columns may straddle
//    two warps).  The J probes of a table reuse its one code.
//    The order of the sums, fixed, with no atomics in them, so two calls
//    on the same inputs give the same bits:
//      d <= 128 (kFeatOne): one block per (query, table group) sums all
//        d features in order with fmaf from 0, the order of simhash.cu:
//        a query hashed here gets bitwise the code simhash gives it.
//      d > 128: parts of 64 features (kFeatPart), one block per (query,
//        group, part), each summing its part in order with fmaf from 0
//        into scratch.  The block that counts a (query, group)'s last
//        part (one atom.acq_rel add, then it sets the count back to 0,
//        so the counts need no fill per call) adds the parts' sums in
//        part order, then packs and searches.  One launch: at d 3,072
//        that is 48 blocks a group, each reading 64 rows of w.
// 2. Search with a whole warp (warp_bounds) instead of ~log2(N) rounds.
//    In a round the lanes load 32 pivots of the unknown run [a, b)
//    (m = b - a codes): lane k at a + (k + 1) * (m + 1) / 33 - 1 while
//    m > 32, so each of the 33 gaps holds at most ceil((m - 32) / 33)
//    codes; at a + k when m <= 32, the last round, one coalesced load of
//    the codes left.  __ballot_sync of (pivot < key) counts the pivots
//    below the key and narrows [a, b) to one gap.  The lower bound (key
//    c) and the upper bound (the lower bound of c + 1) run side by side:
//    while their runs coincide one load per lane serves both ballots;
//    once they part, each lane loads one pivot of each run in the same
//    round, both loads in flight together (no 16-lane halves, no
//    searches in turn).  Rounds: at most 1 for N <= 32, 2 for
//    N <= 1,088, 3 for N <= 35,936, 4 for N <= 1,185,920: 4 at
//    N 463,715 and 3 at N 2,048, against the binary search's 19 and 12.
//    probe_codes_kernel runs the same function, a warp per (query,
//    table).  Both kernels put the searches of one table on neighbouring
//    warps: their first round reads the same pivots, from L1.
// 3. Masks: the J masks travel by value in the launch's parameter
//    block, 2,116 bytes (529 slots, the Hamming ball of radius 2 at
//    K 32).  A compact block (-DPROBE_MASK_SLOTS=16: 64 bytes, J <= 16)
//    read 0.22 us SLOWER at J 1 on the H100 (6.054 against 5.838 us of
//    device time, twelve turns each; PERF.md), so the full block stays,
//    and chip_smoke.py times the pair in every run.

#include <cuda_runtime.h>
#include <cstdint>

#ifndef PROBE_MASK_SLOTS
#define PROBE_MASK_SLOTS (1 + 32 + 32 * 31 / 2)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFeatOne = 128;   // d up to this: one block sums every feature
constexpr int kFeatPart = 64;   // above it: features per part
constexpr int kStage = 8192;    // floats staged in shared memory at a time
constexpr int kBatch = 16;      // loads in flight per thread while staging
constexpr int kMaxMasks = 1 + 32 + 32 * 31 / 2;  // Hamming ball of radius 2, K <= 32

struct ProbeMasks {
  uint32_t m[PROBE_MASK_SLOTS];
};

// Lane k's pivot in the unknown run [a, a + m), m > 0.
__device__ __forceinline__ int64_t pivot(int64_t a, int64_t m, int k) {
  return m <= kLanes ? a + k : a + (k + 1) * (m + 1) / (kLanes + 1) - 1;
}

// Narrow the run [a, b) to the gap that holds the bound, given the
// number of the round's pivots below the key.
__device__ __forceinline__ void narrow(int64_t& a, int64_t& b, int below) {
  const int64_t m = b - a;
  if (m == 0) return;
  const int pivots = m < kLanes ? static_cast<int>(m) : kLanes;
  const int64_t a0 = a;
  if (below > 0) a = pivot(a0, m, below - 1) + 1;
  if (below < pivots) b = pivot(a0, m, below);
}

// Lower bound of c (first i with row[i] >= c) and of c + 1 in the
// ascending row[0, n), by the whole warp; every lane gets both.
__device__ __forceinline__ void warp_bounds(const int64_t* __restrict__ row,
                                            int64_t n, int64_t c, int lane,
                                            int* lo, int* hi) {
  const int64_t c1 = c + 1;
  int64_t a0 = 0, b0 = n, a1 = 0, b1 = n;
  while (a0 < b0 || a1 < b1) {
    const int64_t m0 = b0 - a0, m1 = b1 - a1;
    const bool on0 = lane < m0, on1 = lane < m1;
    const int64_t v0 = on0 ? row[pivot(a0, m0, lane)] : 0;
    const int64_t v1 = (a0 == a1 && b0 == b1) ? v0
                       : on1                  ? row[pivot(a1, m1, lane)]
                                              : 0;
    const int below0 = __popc(__ballot_sync(kFull, on0 && v0 < c));
    const int below1 = __popc(__ballot_sync(kFull, on1 && v1 < c1));
    narrow(a0, b0, below0);
    narrow(a1, b1, below1);
  }
  *lo = static_cast<int>(a0);
  *hi = static_cast<int>(a1);
}

// dst[r * cols + c] = src[r * ld + c] for r < rows, c < cols, through
// L2 (not L1: the partial sums were written by other SMs), kBatch
// independent loads a thread in flight at a time.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      int rows, int cols, int64_t ld) {
  const int total = rows * cols;
  for (int e0 = 0; e0 < total; e0 += kThreads * kBatch) {
    float r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + static_cast<int>(threadIdx.x);
      const int i = e / cols;
      r[u] = e < total ? __ldcg(src + i * ld + (e - i * cols)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + static_cast<int>(threadIdx.x);
      if (e < total) dst[e] = r[u];
    }
  }
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Block (p, g, b) of the flattened grid: query b, tables
// [g * tables, + tables) of l, features of part p.
__global__ void __launch_bounds__(kThreads)
probe_hashed_kernel(const float* __restrict__ q, const float* __restrict__ w,
                    const int64_t* __restrict__ sc, ProbeMasks masks,
                    int* __restrict__ lo, int* __restrict__ hi,
                    float* __restrict__ part, int* __restrict__ arrived,
                    int d, int l, int k, int64_t n, int j, int tables,
                    int groups, int parts) {
  __shared__ float ws[kStage];
  __shared__ float qs[kFeatOne];
  __shared__ uint32_t signs[kWarps + 1];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x % parts;
  const int g = (blockIdx.x / parts) % groups;
  const int bb = blockIdx.x / (parts * groups);
  const int t0 = g * tables;
  const int tk = min(tables, l - t0) * k;   // this group's columns
  const int64_t lk = static_cast<int64_t>(l) * k;
  const int feat = parts == 1 ? d : kFeatPart;
  const int f0 = p * feat, f1 = min(d, f0 + feat);

  // 1. the group's projections over features [f0, f1), one thread a column
  const float qv = tid < f1 - f0
                       ? __ldcg(q + static_cast<int64_t>(bb) * d + f0 + tid)
                       : 0.f;
  const int rows = kStage / tk;
  float s = 0.f;
  for (int i0 = f0; i0 < f1; i0 += rows) {
    const int nr = min(rows, f1 - i0);
    stage(ws, w + i0 * lk + t0 * k, nr, tk, lk);
    if (i0 == f0 && tid < f1 - f0) qs[tid] = qv;
    __syncthreads();
    if (tid < tk)
      for (int i = 0; i < nr; ++i) s = fmaf(qs[i0 - f0 + i], ws[i * tk + tid], s);
    __syncthreads();
  }

  if (parts > 1) {
    // the (query, group)'s parts: [parts][tk] in scratch
    float* sums = part + (static_cast<int64_t>(bb) * groups + g) * parts *
                             (static_cast<int64_t>(tables) * k);
    if (tid < tk) sums[p * tk + tid] = s;
    __syncthreads();  // the block's sums are written
    if (tid == 0) {
      // release: the block's sums before its count; acquire: the other
      // blocks' sums after theirs (bar.sync carries both to the block)
      const int before = atomic_add_acq_rel(arrived + bb * groups + g, 1);
      last = before == parts - 1;
      if (last) atomicExch(arrived + bb * groups + g, 0);
    }
    __syncthreads();
    if (!last) return;
    // the last block adds the parts' sums in part order
    const int per = kStage / tk;
    s = 0.f;
    for (int p0 = 0; p0 < parts; p0 += per) {
      const int np = min(per, parts - p0);
      stage(ws, sums + p0 * tk, np, tk, tk);
      __syncthreads();
      if (tid < tk)
        for (int i = 0; i < np; ++i) s += ws[i * tk + tid];
      __syncthreads();
    }
  }

  // 2. pack: bit c of the 256-bit word is column c's sign
  const unsigned word = __ballot_sync(kFull, tid < tk && s >= 0.f);
  if (lane == 0) signs[warp] = word;
  if (tid == 0) signs[kWarps] = 0u;
  __syncthreads();

  // 3. a warp per (probe, table) of the group, a table's probes on
  // neighbouring warps (their first round reads the same pivots: L1 hits)
  const int tg = tk / k;
  const uint64_t kbits = (uint64_t{1} << k) - 1;
  for (int pr = warp; pr < tg * j; pr += kWarps) {
    const int tl = pr / j, jj = pr - tl * j;
    const int c0 = tl * k;
    const uint64_t both = signs[c0 >> 5] |
                          static_cast<uint64_t>(signs[(c0 >> 5) + 1]) << 32;
    const uint32_t code = static_cast<uint32_t>((both >> (c0 & 31)) & kbits);
    const int t = t0 + tl;
    int rlo, rhi;
    warp_bounds(sc + static_cast<int64_t>(t) * n, n,
                static_cast<int64_t>(code ^ masks.m[jj]), lane, &rlo, &rhi);
    if (lane == 0) {
      const int64_t o = (static_cast<int64_t>(bb) * j + jj) * l + t;
      lo[o] = rlo;
      hi[o] = rhi;
    }
  }
}

// A warp per (query, table) of the b x l pre-hashed codes, table-major:
// the queries of one table on neighbouring warps, whose first round
// reads the same pivots (and every round, where two codes are equal).
__global__ void __launch_bounds__(kThreads)
probe_codes_kernel(const int64_t* __restrict__ qc,
                   const int64_t* __restrict__ sc, int* __restrict__ lo,
                   int* __restrict__ hi, int b, int l, int64_t n) {
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= static_cast<int64_t>(b) * l) return;  // whole warps
  const int64_t t = s / b, o = (s - t * b) * l + t;
  const int lane = threadIdx.x & 31;
  int rlo, rhi;
  warp_bounds(sc + t * n, n, qc[o], lane, &rlo, &rhi);
  if (lane == 0) {
    lo[o] = rlo;
    hi[o] = rhi;
  }
}

int launch_hashed(const float* q, const float* w, const int64_t* sc,
                  const uint32_t* masks, int j, int* lo, int* hi, float* part,
                  int* arrived, int b, int d, int l, int k, int64_t n,
                  int tables, int parts, void* stream) {
  const int want_parts = d <= kFeatOne ? 1 : (d + kFeatPart - 1) / kFeatPart;
  if (j < 1 || j > kMaxMasks || j > PROBE_MASK_SLOTS || k < 1 || k > 32 ||
      b < 1 || d < 0 || l < 1 || n < 1 || n > 0x7fffffffLL || tables < 1 ||
      tables * k > kThreads || parts != want_parts ||
      (parts > 1 && (!part || !arrived)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (l + tables - 1) / tables;
  const int64_t blocks = static_cast<int64_t>(b) * groups * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ProbeMasks pm = {};
  for (int i = 0; i < j; ++i) pm.m[i] = masks ? masks[i] : 0u;
  probe_hashed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, w, sc, pm, lo, hi, part, arrived, d, l, k, n, j, tables, groups,
      parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, d) fp32; w: (d, l*k) fp32; sc: (l, n) int64 ascending per row;
// lo, hi: (b, l) int32.  tables: tables per block (tables * k <= 256);
// parts: 1 for d <= 128, else ceil(d / 64), when part holds
// b * ceil(l / tables) * parts * tables * k floats of scratch and
// arrived b * ceil(l / tables) int32 counts that are 0 before the launch
// (and 0 again after it).
extern "C" int bucket_probe_launch(const float* q, const float* w,
                                   const int64_t* sc, int* lo, int* hi,
                                   float* part, int* arrived, int b, int d,
                                   int l, int k, int64_t n, int tables,
                                   int parts, void* stream) {
  return launch_hashed(q, w, sc, nullptr, 1, lo, hi, part, arrived, b, d, l,
                       k, n, tables, parts, stream);
}

// As bucket_probe_launch for the j host-side XOR masks; lo, hi: (b, j, l).
extern "C" int bucket_probe_multi_launch(const float* q, const float* w,
                                         const int64_t* sc,
                                         const uint32_t* masks, int j,
                                         int* lo, int* hi, float* part,
                                         int* arrived, int b, int d, int l,
                                         int k, int64_t n, int tables,
                                         int parts, void* stream) {
  return launch_hashed(q, w, sc, masks, j, lo, hi, part, arrived, b, d, l, k,
                       n, tables, parts, stream);
}

// qc: (b, l) int64 pre-hashed query codes; sc: (l, n); lo, hi: (b, l).
extern "C" int bucket_probe_codes_launch(const int64_t* qc, const int64_t* sc,
                                         int* lo, int* hi, int b, int l,
                                         int64_t n, void* stream) {
  if (b < 1 || l < 1 || n < 1 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t searches = static_cast<int64_t>(b) * l;
  const int64_t blocks = (searches + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  probe_codes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(qc, sc, lo, hi,
                                                            b, l, n);
  return static_cast<int>(cudaGetLastError());
}
