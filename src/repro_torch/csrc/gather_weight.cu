// Fused batch assembly for Hopper: token-row gather + importance weights.
//
//   rows[i, :] = store[idx[i], :]
//   w[i]       = 1 / (max(p[i], p_floor) * N)
//
// Replaces the TPU kernel `_gather_weight_kernel` / `gather_weight_pallas`
// (src/repro/kernels/gather_weight/kernel.py:48 / :56).
//
// Bound on an H100: bytes.  The kernel does one multiply and one
// division per row, and moves 2 * m * W * 4 bytes of token rows (~33 KB
// at the LM slice's m = 8, W = 513), so its bound is nanoseconds and a
// launch is set by its latency: one dependent load of idx, then the row.
//
// What the design does about that:
//   * One block per sampled row; its threads copy the row with
//     neighbouring threads on neighbouring words, so every warp load and
//     store is coalesced.  All m rows are in flight at once.
//   * 16-byte loads and stores where the row pitch and both base
//     pointers allow them (W % 4 == 0), else 4-byte ones.  The TPU
//     kernel's 128-lane row padding is a TPU layout rule and is not
//     carried over: the store stays (N, W) int32 for any W.
//   * Thread 0 of the block computes the weight.  The arithmetic is the
//     plain version's, in the same order, with IEEE division (the build
//     has no --use_fast_math), so the weight is bitwise equal to it.
//     max() keeps a NaN probability NaN, as torch.clamp does.
//   * Duplicate ids are two blocks reading the same row.  An id outside
//     [0, N) stops the kernel with a device-side assert: checking on the
//     host would need the ids there, a sync on every step.

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_weight_kernel(const T* __restrict__ store,
                     const int64_t* __restrict__ idx,
                     const float* __restrict__ probs, T* __restrict__ rows,
                     float* __restrict__ w, int64_t n, int64_t width,
                     float p_floor) {
  const int64_t i = blockIdx.x;
  const int64_t id = idx[i];
  assert(0 <= id && id < n);
  const T* src = store + id * width;
  T* dst = rows + i * width;
  for (int64_t c = threadIdx.x; c < width; c += kThreads) dst[c] = src[c];
  if (threadIdx.x == 0) {
    const float p = probs[i];
    const float pf = p < p_floor ? p_floor : p;
    w[i] = 1.0f / (pf * static_cast<float>(n));
  }
}

}  // namespace

// store: (n, width) int32 row-major; idx: (m,) int64; probs: (m,) f32;
// rows: (m, width) int32; w: (m,) f32.  Returns the cudaError_t of the
// launch.
extern "C" int gather_weight_launch(const int32_t* store, const int64_t* idx,
                                    const float* probs, int32_t* rows,
                                    float* w, int64_t n, int64_t width,
                                    int64_t m, float p_floor, void* stream) {
  if (n < 1 || width < 1 || m < 1 || m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(store) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const unsigned blocks = static_cast<unsigned>(m);
  if (vec) {
    gather_weight_kernel<int4><<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(store), idx, probs,
        reinterpret_cast<int4*>(rows), w, n, width / 4, p_floor);
  } else {
    gather_weight_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        store, idx, probs, rows, w, n, width, p_floor);
  }
  return static_cast<int>(cudaGetLastError());
}
