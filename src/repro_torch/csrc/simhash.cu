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
// CUDA-core fp32 FMAs (~0.6 ms at the SXM part's 67 TFLOP/s), not by
// memory.  Tensor cores are not used on purpose: TF32 flips the sign of
// near-zero projections and breaks code parity with the plain version,
// and full-fp32 tensor-core emulation is later work.
//
// What the design does about that bound:
//   * Like the TPU kernel, the (N, L*K) projection never reaches device
//     memory: each thread keeps its 32 projection sums in registers and
//     packs them in the epilogue.
//   * A block is 128 rows (one per thread) x one group of whole tables
//     (floor(32 / K) tables, so no table straddles two blocks).  x and w
//     are staged through shared memory in chunks of 32 features; every
//     thread reads the same w row (a broadcast, one 16-byte load per four
//     FMAs) and its own x element (row stride 33 floats: no bank
//     conflicts), so the inner loop is FMA-bound rather than load-bound.
//   * The blocks of one row tile are adjacent in launch order, so the
//     x tile they share is read from HBM once and from L2 after that.
//   * Codes are written table-major, (L, N): a warp stores 32 adjacent
//     int64 codes of one table, fully coalesced, and the index build
//     sorts each table row in place without a transpose.
//   * Each sum runs over the features in order with fmaf, the same order
//     as the probe kernel's query hash.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRows = 128;   // rows per block, one per thread
constexpr int kCols = 32;    // projection columns per thread (whole tables)
constexpr int kDepth = 32;   // features staged per shared-memory chunk

__global__ void __launch_bounds__(kRows)
simhash_kernel(const float* __restrict__ x, const float* __restrict__ w,
               int64_t* __restrict__ codes, int64_t n, int d, int l, int k,
               int tables_per_group, int groups) {
  __shared__ float xs[kRows][kDepth + 1];
  __shared__ __align__(16) float ws[kDepth][kCols];

  const int tid = threadIdx.x;
  const int group = blockIdx.x % groups;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / groups) * kRows;
  const int64_t row = row0 + tid;
  const int t0 = group * tables_per_group;
  const int ncols = min(tables_per_group, l - t0) * k;
  const int64_t lk = static_cast<int64_t>(l) * k;
  const int c0 = t0 * k;

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int i0 = 0; i0 < d; i0 += kDepth) {
    const int depth = min(kDepth, d - i0);
    for (int e = tid; e < kRows * kDepth; e += kRows) {
      const int r = e / kDepth, i = e % kDepth;
      const int64_t gr = row0 + r;
      xs[r][i] = (gr < n && i < depth) ? x[gr * d + i0 + i] : 0.f;
    }
    for (int e = tid; e < kDepth * kCols; e += kRows) {
      const int i = e / kCols, c = e % kCols;
      ws[i][c] = (i < depth && c < ncols) ? w[(i0 + i) * lk + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < depth; ++i) {
      const float xv = xs[tid][i];
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[i][c]);
        acc[c] = fmaf(xv, wv.x, acc[c]);
        acc[c + 1] = fmaf(xv, wv.y, acc[c + 1]);
        acc[c + 2] = fmaf(xv, wv.z, acc[c + 2]);
        acc[c + 3] = fmaf(xv, wv.w, acc[c + 3]);
      }
    }
    __syncthreads();
  }
  if (row >= n) return;

  // Epilogue: sign + pack, K bits per table, written table-major.
  uint32_t code = 0;
  int bit = 0, t = t0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < ncols) {
      code |= (acc[c] >= 0.f ? 1u : 0u) << bit;
      if (++bit == k) {
        codes[static_cast<int64_t>(t) * n + row] = code;
        code = 0;
        bit = 0;
        ++t;
      }
    }
  }
}

}  // namespace

// x: (n, d) fp32 row-major; w: (d, l*k) fp32 row-major;
// codes: (l, n) int64.  Returns the cudaError_t of the launch.
extern "C" int simhash_codes_launch(const float* x, const float* w,
                                    int64_t* codes, int64_t n, int d, int l,
                                    int k, void* stream) {
  if (k < 1 || k > kCols || d < 1 || l < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tables_per_group = kCols / k;
  const int groups = (l + tables_per_group - 1) / tables_per_group;
  const int64_t blocks = ((n + kRows - 1) / kRows) * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  simhash_kernel<<<static_cast<unsigned>(blocks), kRows, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, w, codes, n, d, l, k, tables_per_group, groups);
  return static_cast<int>(cudaGetLastError());
}
