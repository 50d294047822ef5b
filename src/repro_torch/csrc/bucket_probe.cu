// LSH bucket probe for Hopper: per (query, probe, table) binary search.
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
// rank the query code against every one (~371 MB per probe at
// N = 463,715, L = 100 with int64 codes), because a TPU has no cheap
// gathers.  Hopper has them, so this kernel does not carry that design
// over: one thread does the lower-bound and the upper-bound binary
// search of one (query, probe, table) over the sorted row.  That gives
// the same (lo, hi) from ~2*ceil(log2(N+1)) eight-byte loads per thread
// instead of N.
//
// Bound on an H100: the bytes the searches need (~30 KB for B = 1, J = 1,
// L = 100) take nanoseconds at HBM rate, so the kernel is bound by the
// LATENCY of ~20 dependent loads per search, microseconds.  What the
// design does about it: the two searches run interleaved in one thread
// (both loads of a level in flight together), each (query, probe, table)
// is its own thread so all B*J*L chains run at once, and the upper
// levels of every table's search tree stay in L2 from one step to the
// next.
//
// The fused and multi entries hash the query in the kernel, as the TPU
// kernels do: each thread forms its table's K projections with fmaf
// over the features in order (the same order as the simhash kernel, so
// a query hashed here gets the code the simhash kernel gives it).  That
// hash is a second latency chain, ahead of the search.  The multi entry
// writes (B, J, L) directly; the TPU kernel's blocked j-major layout is
// not carried over.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMasks = 1 + 32 + 32 * 31 / 2;  // Hamming ball of radius 2, K <= 32

struct ProbeMasks {
  uint32_t m[kMaxMasks];
};

// The K projections of table t, one bit after another.  The feature
// loop's loads do not depend on the running sum, so the compiler
// pipelines them.  (One pass with K guarded accumulators measured about
// twice as slow on the H100: it waits out a load round per feature.)
__device__ __forceinline__ uint32_t hash_query(const float* __restrict__ q,
                                               const float* __restrict__ w,
                                               int d, int64_t lk, int t,
                                               int k) {
  uint32_t code = 0;
  for (int bit = 0; bit < k; ++bit) {
    const float* col = w + static_cast<int64_t>(t) * k + bit;
    float s = 0.f;
    for (int i = 0; i < d; ++i) s = fmaf(q[i], col[i * lk], s);
    code |= (s >= 0.f ? 1u : 0u) << bit;
  }
  return code;
}

// Lower and upper bound of `c` in the ascending row[0, n), interleaved:
// both loads of a level are issued before either compare, so the two
// dependent-load chains overlap.
__device__ __forceinline__ void bounds(const int64_t* __restrict__ row,
                                       int64_t n, int64_t c, int* lo,
                                       int* hi) {
  int64_t a0 = 0, a1 = n;   // lower bound: first i with row[i] >= c
  int64_t b0 = 0, b1 = n;   // upper bound: first i with row[i] >  c
  while (a0 < a1 || b0 < b1) {
    const int64_t ma = (a0 + a1) >> 1, mb = (b0 + b1) >> 1;
    const int64_t va = row[min(ma, n - 1)], vb = row[min(mb, n - 1)];
    if (a0 < a1) {
      if (va < c) a0 = ma + 1; else a1 = ma;
    }
    if (b0 < b1) {
      if (vb <= c) b0 = mb + 1; else b1 = mb;
    }
  }
  *lo = static_cast<int>(a0);
  *hi = static_cast<int>(b0);
}

__global__ void __launch_bounds__(kThreads)
probe_hashed_kernel(const float* __restrict__ q, const float* __restrict__ w,
                    const int64_t* __restrict__ sc, ProbeMasks masks,
                    int* __restrict__ lo, int* __restrict__ hi, int b, int d,
                    int l, int k, int64_t n, int j) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(b) * j * l) return;
  const int t = static_cast<int>(idx % l);
  const int jj = static_cast<int>((idx / l) % j);
  const int64_t bb = idx / (static_cast<int64_t>(l) * j);
  const uint32_t code =
      hash_query(q + bb * d, w, d, static_cast<int64_t>(l) * k, t, k) ^
      masks.m[jj];
  bounds(sc + static_cast<int64_t>(t) * n, n, static_cast<int64_t>(code),
         lo + idx, hi + idx);
}

__global__ void __launch_bounds__(kThreads)
probe_codes_kernel(const int64_t* __restrict__ qc,
                   const int64_t* __restrict__ sc, int* __restrict__ lo,
                   int* __restrict__ hi, int b, int l, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(b) * l) return;
  const int t = static_cast<int>(idx % l);
  bounds(sc + static_cast<int64_t>(t) * n, n, qc[idx], lo + idx, hi + idx);
}

unsigned blocks_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

int launch_hashed(const float* q, const float* w, const int64_t* sc,
                  const uint32_t* masks, int j, int* lo, int* hi, int b,
                  int d, int l, int k, int64_t n, void* stream) {
  if (j < 1 || j > kMaxMasks || k < 1 || k > 32 || b < 1 || l < 1 || n < 1 ||
      n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  ProbeMasks pm = {};
  for (int i = 0; i < j; ++i) pm.m[i] = masks ? masks[i] : 0u;
  probe_hashed_kernel<<<blocks_for(static_cast<int64_t>(b) * j * l), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      q, w, sc, pm, lo, hi, b, d, l, k, n, j);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, d) fp32; w: (d, l*k) fp32; sc: (l, n) int64 ascending per row;
// lo, hi: (b, l) int32.
extern "C" int bucket_probe_launch(const float* q, const float* w,
                                   const int64_t* sc, int* lo, int* hi, int b,
                                   int d, int l, int k, int64_t n,
                                   void* stream) {
  return launch_hashed(q, w, sc, nullptr, 1, lo, hi, b, d, l, k, n, stream);
}

// As bucket_probe_launch for the j host-side XOR masks; lo, hi: (b, j, l).
extern "C" int bucket_probe_multi_launch(const float* q, const float* w,
                                         const int64_t* sc,
                                         const uint32_t* masks, int j, int* lo,
                                         int* hi, int b, int d, int l, int k,
                                         int64_t n, void* stream) {
  return launch_hashed(q, w, sc, masks, j, lo, hi, b, d, l, k, n, stream);
}

// qc: (b, l) int64 pre-hashed query codes; sc: (l, n); lo, hi: (b, l).
extern "C" int bucket_probe_codes_launch(const int64_t* qc, const int64_t* sc,
                                         int* lo, int* hi, int b, int l,
                                         int64_t n, void* stream) {
  if (b < 1 || l < 1 || n < 1 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  probe_codes_kernel<<<blocks_for(static_cast<int64_t>(b) * l), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(qc, sc, lo, hi, b,
                                                            l, n);
  return static_cast<int>(cudaGetLastError());
}
