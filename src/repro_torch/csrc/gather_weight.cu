// Batch assembly for Hopper: the token-row gather and importance weights
// (gather_weight), and the whole draw after the probe in one launch
// (draw_assemble).
//
// gather_weight
// -------------
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
//
// draw_assemble
// -------------
// Algorithm 1 after the probe, for every (query b, repetition r), and
// with a token store the row gather and the weight: what the sampler's
// plain composition computes (core/sampler.py: `_sample_rows`, then
// `gather_weight_ref`).  The JAX package runs that composition as one
// jitted program around the same TPU kernel (src/repro/core/sampler.py
// `sample_gather`; src/repro/kernels/gather_weight/kernel.py:56), so
// this launch is the port's counterpart of that program.
//
//   walk:  the P table draws x J probes in (draw, probe) order; the
//          first candidate whose bucket hi - lo is non-empty wins
//   slot:  lo + min(floor(u * (f32)size), size - 1)
//   id:    order[t, slot], or the fallback when no bucket is found: the
//          fallback draw itself, or with a live count n_live (a
//          streaming index, whose live ids fill every table's first
//          n_live sorted slots) order[0, draw] for a draw in [0, n_live)
//   cp:    the family's collision law on x_aug[id] and the query
//   p:     J = 1: cp^K (1 - cp^K)^(l-1) / size
//          J > 1: q_r = cp^(K-r) (1-cp)^r, miss = max(1 - sum q, 0),
//                 p = q_pj miss^(l-1) / size
//          fallback: p_fallback (1/N, or 1/n_live)
//   gather and weight: as gather_weight, when a store is given, with
//          N = n_live when a live count is given
//
// Band mode (a banded family, src/repro/core/sampler.py
// `_sample_one_banded`): the bounds are (B, nb, J, L), one plane per norm
// band, and `starts` (nb + 1,) is the bands' partition of the sorted
// order, on the device (its total starts[nb] is the live count, which the
// host never reads).  Before the walk:
//   band:  u = min(floor(band_u * (f32)total), total - 1), band = the
//          number of starts[1..nb] <= u (a binary search), n_band =
//          starts[band + 1] - starts[band]; the walk reads that band's plane
//   p:     (n_band / total) q_pj miss^(l-1) / size, the multi-probe form at
//          every J and in that order; fallback: the id
//          order[0, min(floor(fallback_u * total), total - 1)] with
//          p = 1 / total, both computed here
// The law reads the first d_law coordinates of a row of d: a banded
// row's last coordinate is its band id (up to nb - 1), which must not
// enter |x|.  The band mode is a template flag (kBand), so the flat
// instantiations (no starts, nb 1) run the flat path's instructions only,
// with its arithmetic unchanged.
//
// Bound on an H100: bytes, and those are nanoseconds: a repetition reads
// its walked table draws and bounds, one order entry, one row of x and
// the query (364 B at d 91, 12 KB at d 3,072), and writes 25 B of result
// plus its token row.  What the time is made of is the launch and the
// chain of dependent loads: table draw -> bounds -> order -> x row (and
// store row).  The eager composition runs ~55-64 launches for the same
// work, each a round trip of its own.  The design:
//   * One block of 128 threads per (query, repetition): B * m blocks,
//     16 on the LGD path (m 16) and 8 on the train path.  All of them
//     are in flight at once; the grid is small, so latency counts, not
//     occupancy.
//   * The walk is warp 0's: 32 candidates a round, each lane reading its
//     table draw and that bucket's lo and hi; one __ballot_sync of
//     (size > 0) and __ffs give the first non-empty candidate, and the
//     walk stops at the first round that has one (at most
//     ceil(P * J / 32) rounds: 7 at P 200, J 1; 19 at J 3).  The winning
//     lane computes the slot with the plain version's own float
//     arithmetic (one rounded product, floor, min), so the id is
//     bitwise the plain version's, and loads order[t, slot].
//   * x . q, x . x and q . q in float32 over d in ONE fixed order: each
//     thread sums the features tid, tid + 128, ... in order (a rounded
//     product, then a rounded add: no FMA contraction), a shuffle-down
//     tree combines a warp's 32 sums into lane 0, and thread 0 adds the
//     4 warps' sums in warp order.  Two calls give the same bits, and
//     tests/test_torch_draw.py models the order in numpy.
//   * The token row's first batch of loads is issued before the dot
//     products, so its round trip overlaps theirs; 16-byte copies where
//     the width and the pointers allow, as gather_weight.
//   * Thread 0 applies the law (acosf), the probability and the weight
//     1 / (max(p, p_floor) * N) with IEEE division, and writes every
//     result field.  p differs from the plain version's only in its last
//     bits (another sum order, acosf and powf against torch's).  The
//     weights' mean-1 normalisation needs every block of a chain, so it
//     stays two torch ops after the launch, not a last-block count.
//   * An id outside [0, N) (a fallback draw out of range), a live-prefix
//     draw outside [0, n_live) and a table draw outside [0, L) stop the
//     kernel with a device-side assert.
//     Nothing syncs with the host.

#include <cuda_runtime.h>
#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

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

// draw_assemble's launch constants (tests/test_torch_draw.py reads them)
constexpr int kDrawThreads = 128;                 // 4 warps a block
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kRowBatch = 8;                      // row loads in flight a thread
constexpr int kMaxMasks = 1 + 32 + 32 * 31 / 2;   // the probe's mask cap
constexpr float kPi = 3.14159265358979323846f;

// the collision laws, in the order of the wrapper's LAWS
enum Law : int { kAngle = 0, kQuadratic = 1 };

struct DrawArgs {
  const int32_t* lo;          // (B, nb, J, L) the probe's bucket bounds
  const int32_t* hi;
  const int64_t* order;       // (L, N) each table's sorted point ids
  const float* x;             // (N, d) hashed vectors
  const float* q;             // (B, d) hashed queries
  const int64_t* tables;      // (B, m, P) table draws
  const float* slot_u;        // (B, m) within-bucket uniforms
  const int64_t* fb_ids;      // (B, m) fallback ids, or null (band mode)
  const int32_t* starts;      // (nb + 1,) band starts, or null (flat)
  const float* band_u;        // (B, m) band uniforms (band mode)
  const float* fb_u;          // (B, m) fallback uniforms (band mode)
  const int32_t* store;       // (N, W) token rows, or null
  int64_t* indices;           // (B, m) results
  float* probs;
  int32_t* n_probes;
  int32_t* bucket_sizes;
  bool* fallback;
  int32_t* probe_code;
  int32_t* rows;              // (B * m, W), or null
  float* w;                   // (B * m,), or null
  int64_t n, d, width;        // width in units of the copy type
  int64_t d_law;              // leading coordinates the law reads
  int64_t n_live;             // 0, or the live count of a streaming index
  int n_tables, m, p, j, k, law, nb;
  float p_fallback, p_floor;
  uint8_t popc[kMaxMasks];    // popcount r of each probe mask
};

template <typename T, bool kBand>
__global__ void __launch_bounds__(kDrawThreads)
draw_assemble_kernel(const __grid_constant__ DrawArgs a) {
  __shared__ int64_t s_id;
  __shared__ int s_first, s_size, s_nband, s_total;
  __shared__ float s_part[3][kDrawWarps];
  const int64_t blk = blockIdx.x;                 // b * m + r
  const int64_t b = blk / a.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the walk: warp 0, 32 candidates a round
  if (warp == 0) {
    const int64_t* ts = a.tables + blk * a.p;
    const int64_t plane = static_cast<int64_t>(a.j) * a.n_tables;
    int64_t band = 0;
    int total = 0, n_band = 0;
    if constexpr (kBand) {              // band mode: every lane alike
      total = a.starts[a.nb];
      assert(total > 0);
      int64_t u = static_cast<int64_t>(floorf(
          __fmul_rn(a.band_u[blk], static_cast<float>(total))));
      if (u > total - 1) u = total - 1;
      int lo_b = 0, hi_b = a.nb;        // count of starts[1..nb] <= u
      while (lo_b < hi_b) {
        const int mid = (lo_b + hi_b) >> 1;
        if (a.starts[mid + 1] <= u) lo_b = mid + 1; else hi_b = mid;
      }
      band = lo_b;
      n_band = a.starts[band + 1] - a.starts[band];
    }
    const int64_t at_b = (kBand ? b * a.nb + band : b) * plane;
    const int32_t* lo = a.lo + at_b;
    const int32_t* hi = a.hi + at_b;
    const int cands = a.p * a.j;
    const float u = a.slot_u[blk];
    int first = -1;
    for (int base = 0; base < cands && first < 0; base += 32) {
      const int c = base + lane;
      int64_t t = 0;
      int lov = 0, size = 0;
      if (c < cands) {
        t = ts[c / a.j];
        assert(0 <= t && t < a.n_tables);
        const int64_t at = static_cast<int64_t>(c % a.j) * a.n_tables + t;
        lov = lo[at];
        size = hi[at] - lov;
      }
      const unsigned hit = __ballot_sync(kFull, size > 0);
      if (hit != 0u) {
        first = base + __ffs(hit) - 1;
        if (c == first) {
          int64_t slot = static_cast<int64_t>(
              floorf(__fmul_rn(u, static_cast<float>(size))));
          if (slot > size - 1) slot = size - 1;
          s_id = a.order[t * a.n + lov + slot];
          s_first = first;
          s_size = size;
        }
      }
    }
    if (kBand && lane == 0) {
      s_nband = n_band;
      s_total = total;
    }
    if (first < 0 && lane == 0) {
      if (kBand) {                      // a slot of the bands' live prefix
        int64_t slot = static_cast<int64_t>(floorf(
            __fmul_rn(a.fb_u[blk], static_cast<float>(total))));
        if (slot > total - 1) slot = total - 1;
        s_id = a.order[slot];
      } else if (a.n_live > 0) {        // a slot of table 0's live prefix
        const int64_t fb = a.fb_ids[blk];
        assert(0 <= fb && fb < a.n_live);
        s_id = a.order[fb];
      } else {
        s_id = a.fb_ids[blk];
      }
      s_first = -1;
      s_size = 0;
    }
  }
  __syncthreads();
  const int64_t id = s_id;
  assert(0 <= id && id < a.n);

  // the row's first batch of loads, in flight during the dot products
  const bool gather = a.rows != nullptr;
  const T* src = nullptr;
  T* dst = nullptr;
  T v[kRowBatch];
  if (gather) {
    src = reinterpret_cast<const T*>(a.store) + id * a.width;
    dst = reinterpret_cast<T*>(a.rows) + blk * a.width;
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int64_t c = threadIdx.x + i * kDrawThreads;
      if (c < a.width) v[i] = src[c];
    }
  }

  // x . q, x . x, q . q: strided per thread, in order, no contraction
  const float* xr = a.x + id * a.d;
  const float* qr = a.q + b * a.d;
  float xq = 0.f, xx = 0.f, qq = 0.f;
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < a.d_law; c += kDrawThreads) {
    const float xv = xr[c], qv = qr[c];
    xq = __fadd_rn(xq, __fmul_rn(xv, qv));
    xx = __fadd_rn(xx, __fmul_rn(xv, xv));
    qq = __fadd_rn(qq, __fmul_rn(qv, qv));
  }

  if (gather) {
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int64_t c = threadIdx.x + i * kDrawThreads;
      if (c < a.width) dst[c] = v[i];
    }
    for (int64_t c = threadIdx.x + kRowBatch * kDrawThreads; c < a.width;
         c += kDrawThreads)
      dst[c] = src[c];
  }

  // a warp's 32 sums into lane 0, a shuffle-down tree
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    xq = __fadd_rn(xq, __shfl_down_sync(kFull, xq, off));
    xx = __fadd_rn(xx, __shfl_down_sync(kFull, xx, off));
    qq = __fadd_rn(qq, __shfl_down_sync(kFull, qq, off));
  }
  if (lane == 0) {
    s_part[0][warp] = xq;
    s_part[1][warp] = xx;
    s_part[2][warp] = qq;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  xq = s_part[0][0];
  xx = s_part[1][0];
  qq = s_part[2][0];
  for (int i = 1; i < kDrawWarps; ++i) {          // in warp order
    xq = __fadd_rn(xq, s_part[0][i]);
    xx = __fadd_rn(xx, s_part[1][i]);
    qq = __fadd_rn(qq, s_part[2][i]);
  }

  // the family's law; the comparisons keep a NaN NaN, as torch.clamp
  float cs;
  if (a.law == kAngle) {              // cos(x, q)
    float den = __fmul_rn(sqrtf(xx), sqrtf(qq));
    den = den < 1e-30f ? 1e-30f : den;
    cs = __fdiv_rn(xq, den);
  } else {                            // cos(T(x), T(q)) = (x.q)^2 / |x|^2 |q|^2
    float den = __fmul_rn(xx, qq);
    den = den < 1e-30f ? 1e-30f : den;
    cs = __fdiv_rn(__fmul_rn(xq, xq), den);
  }
  cs = cs < -1.f ? -1.f : (cs > 1.f ? 1.f : cs);
  const float cp = __fsub_rn(1.f, __fdiv_rn(acosf(cs), kPi));

  const int first = s_first;
  const bool found = first >= 0;
  float p = kBand ? __fdiv_rn(1.f, static_cast<float>(s_total))
                  : a.p_fallback;
  int l = a.p, pj = -1, size = 0;
  if (found) {
    pj = first % a.j;
    l = first / a.j + 1;
    size = s_size;
    const float lm1 = static_cast<float>(l - 1);
    const float fsize = static_cast<float>(size);
    const float fk = static_cast<float>(a.k);
    if (a.j == 1 && !kBand) {
      const float cpk = powf(cp, fk);
      p = __fdiv_rn(__fmul_rn(cpk, powf(__fsub_rn(1.f, cpk), lm1)), fsize);
    } else {
      const float cq = __fsub_rn(1.f, cp);
      float total = 0.f, q_win = 0.f;
      for (int jj = 0; jj < a.j; ++jj) {
        const float r = static_cast<float>(a.popc[jj]);
        const float q_r = __fmul_rn(powf(cp, __fsub_rn(fk, r)), powf(cq, r));
        total = __fadd_rn(total, q_r);
        if (jj == pj) q_win = q_r;
      }
      float miss = __fsub_rn(1.f, total);
      miss = miss < 0.f ? 0.f : miss;
      if (kBand)                        // (n_band / total) q_pj, first
        q_win = __fmul_rn(__fdiv_rn(static_cast<float>(s_nband),
                                    static_cast<float>(s_total)), q_win);
      p = __fdiv_rn(__fmul_rn(q_win, powf(miss, lm1)), fsize);
    }
  }
  a.indices[blk] = id;
  a.probs[blk] = p;
  a.n_probes[blk] = l;
  a.bucket_sizes[blk] = size;
  a.fallback[blk] = !found;
  a.probe_code[blk] = pj;
  if (gather) {
    const float pf = p < a.p_floor ? a.p_floor : p;
    const int64_t n_w = a.n_live > 0 ? a.n_live : a.n;
    a.w[blk] = 1.0f / (pf * static_cast<float>(n_w));
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

// lo, hi: (b, j, n_tables) int32; order: (n_tables, n) int64; x: (n, d)
// f32; q: (b, d) f32; tables: (b, m, p) int64; slot_u: (b, m) f32;
// fb_ids: (b, m) int64; popc: (j,) popcounts; store: (n, width) int32 or
// null.  n_live: 0, or the live count of a streaming index, which makes
// fb_ids slots of order[0, :n_live] and the weights' N n_live.  Band mode:
// starts (nb + 1,) int32 and band_u, fb_u (b, m) f32, with lo, hi
// (b, nb, j, n_tables) and fb_ids null; without starts, nb is 1 and both
// uniforms null.
// The law reads the first d_law of x's d coordinates.  Results:
// indices (b, m) int64, probs f32, n_probes, bucket_sizes and probe_code
// int32, fallback bool; with a store rows (b * m, width) int32 and w
// (b * m,) f32.  law: 0 angle, 1 quadratic.
// Returns the cudaError_t of the launch.
extern "C" int draw_assemble_launch(
    const int32_t* lo, const int32_t* hi, const int64_t* order,
    const float* x, const float* q, const int64_t* tables,
    const float* slot_u, const int64_t* fb_ids, const uint8_t* popc,
    const int32_t* starts, const float* band_u, const float* fb_u,
    const int32_t* store, int64_t* indices, float* probs, int32_t* n_probes,
    int32_t* bucket_sizes, bool* fallback, int32_t* probe_code,
    int32_t* rows, float* w, int64_t b, int64_t m, int64_t p, int64_t j,
    int64_t n_tables, int64_t n, int64_t d, int64_t width, int64_t k,
    int64_t law, int64_t n_live, int64_t nb, int64_t d_law,
    float p_fallback, float p_floor, void* stream) {
  if (b < 1 || m < 1 || b * m > 0x7fffffffLL || p < 1 || j < 1 ||
      j > kMaxMasks || p * j > 0x7fffffffLL - 32 || n_tables < 1 ||
      n_tables > 0x7fffffffLL || n < 1 || d < 1 || k < 1 || k > 32 ||
      n_live < 0 || n_live > n || d_law < 1 || d_law > d || nb < 1 ||
      nb > 0x7fffffffLL / (j * n_tables) ||
      (starts == nullptr && (fb_ids == nullptr || nb != 1 ||
                             band_u != nullptr || fb_u != nullptr)) ||
      (starts != nullptr &&
       (fb_ids != nullptr || band_u == nullptr || fb_u == nullptr)) ||
      (law != kAngle && law != kQuadratic) ||
      (store != nullptr && (width < 1 || rows == nullptr || w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DrawArgs a = {lo, hi, order, x, q, tables, slot_u, fb_ids, starts,
                band_u, fb_u, store,
                indices, probs, n_probes, bucket_sizes, fallback, probe_code,
                store ? rows : nullptr, store ? w : nullptr,
                n, d, store ? width : 0, d_law, n_live,
                static_cast<int>(n_tables), static_cast<int>(m),
                static_cast<int>(p), static_cast<int>(j), static_cast<int>(k),
                static_cast<int>(law), static_cast<int>(nb), p_fallback,
                p_floor, {}};
  for (int64_t i = 0; i < j; ++i) a.popc[i] = popc[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(b * m);
  const bool vec = store != nullptr && width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(store) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (vec) a.width = width / 4;
  if (vec && starts)
    draw_assemble_kernel<int4, true><<<blocks, kDrawThreads, 0, s>>>(a);
  else if (vec)
    draw_assemble_kernel<int4, false><<<blocks, kDrawThreads, 0, s>>>(a);
  else if (starts)
    draw_assemble_kernel<int32_t, true><<<blocks, kDrawThreads, 0, s>>>(a);
  else
    draw_assemble_kernel<int32_t, false><<<blocks, kDrawThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
