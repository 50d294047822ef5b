// Causal GQA flash attention (prefill) and flash decode for Hopper.
//
//   prefill: o[b,h,g,i] = sum_j softmax_j(scale * q[b,h,g,i] . k[b,h,j]) v[b,h,j]
//            over j <= i when causal (every j < S otherwise)
//   decode:  o[b,h,g]   = the same for one query per (b, h, g), over the
//            cache positions j < kv_len[b]
//
// Replaces the TPU kernels `_flash_kernel` / `flash_attention_pallas` and
// `_decode_kernel` / `flash_decode_pallas`
// (src/repro/kernels/flash_attention/kernel.py:38 / :92 and :147 / :184).
//
// All keep the reference's online softmax: a running max m, normaliser l
// and accumulator acc in f32, masked logits at -1e30 (not -inf), the
// normaliser floored at 1e-30, f32 accumulation whatever the input type,
// and the output cast once at the end.  Keys at or past S (ragged tails)
// are -inf and add exactly 0.
//
// Prefill, bf16 (the serve path's type), B=4 Hkv=8 G=3 S=2048 D=128
// causal on an H100: Q.K^T and P.V are ~103 GFLOP against ~0.2 GB of
// traffic, so it is bound by operations: ~0.104 ms at the 989 TFLOP/s
// bf16 tensor-core peak.  `flash_prefill_mma_kernel` runs both products
// on the tensor cores with warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulate), FlashAttention-2's structure:
//   * a block is 4 warps and 64 query rows of ONE (b, hkv, g) head, 16
//     rows a warp; the grid and its heaviest-tiles-first order are the
//     f32 kernel's, and causal tiles above the diagonal are skipped (only
//     the diagonal tile and a ragged last tile are masked);
//   * the Q tile and two stages of 64-key K and V tiles sit in shared
//     memory as bf16 rows padded to D + 8 elements, so the 8 row
//     addresses of every ldmatrix fall in 8 distinct 16-byte bank groups
//     (87,040 bytes at D = 128: two blocks an SM);
//   * tiles arrive by 16-byte cp.async (zero-filled past S, never read):
//     tile j + 1 is in flight while tile j computes (commit_group /
//     wait_group 1);
//   * Q fragments are loaded once with ldmatrix.x4 and kept in registers;
//     K fragments come by ldmatrix (K's [key][d] rows are the .col B
//     operand), V fragments by ldmatrix.trans;
//   * the online softmax runs on the S accumulator fragments (rows
//     lane/4 and lane/4 + 8 of the warp's 16), reduced over the quad by
//     two shuffles, with the accurate expf (no --use_fast_math);
//   * the S accumulators of two adjacent 8-key tiles are one A fragment
//     of P.V (no trip through shared memory).  The mma rounds its inputs
//     to bf16, but the reference keeps P in f32: P is split into
//     hi = bf16(P) and lo = bf16(P - hi), both multiplied into the same
//     f32 accumulator.  That carries P to ~2^-17 relative, where a single
//     bf16 P (2^-9) breaks the two-ulp limit of chip_smoke.py on short
//     causal rows (tests/test_torch_attention.py emulates both).  It
//     costs half again the P.V work: ~154 GFLOP in all, a 0.156 ms floor.
// What remains between this design and the bound is Hopper's own path:
// wgmma (warpgroup products from shared memory, the only way to the full
// tensor-core rate), TMA loads with mbarriers, and warp specialisation.
//
// Prefill, f32: `flash_prefill_kernel` on CUDA cores (the tests' and the
// f32 rows' type): a 64 x 64 score tile per block, register-tiled 4 x 4
// per thread from shared memory, P.V from a shared P tile.
//
// Decode, cache S=2560: one query row per (b, h, g), so the work is
// reading the cache: ~4*Hq*D FLOPs per key against 4*Hkv*D bytes of K and
// V (bf16), ~3 FLOP a byte, bound by bytes: the keys that kv_len makes
// valid, over 3.35 TB/s (22.1 MB, 6.6 us at B=4 Hkv=8 G=3 D=128 with
// kv_len [1, 777, 2048, 2560]).  FlashDecoding's split-KV, in one launch:
//   * grid (B*Hkv, ceil(S / chunk)): each row's cache is cut into chunks
//     of whole 32-key tiles, sized by the wrapper from S and the SM count,
//     so the rows spread over all 132 SMs; a block whose chunk starts at
//     or past the row's end (kv_len, or all S when kv_len is 0) exits at
//     once.  kv_len is read on the card only;
//   * a block (4 warps) streams its chunk through a ring of four 32-key
//     K and V stages, filled by 16-byte cp.async in the input type, and
//     reads each K/V row once for all G heads (the TPU kernel's GQA tile);
//   * bf16 (`flash_decode_mma_kernel`) runs both products on the tensor
//     cores: at ~3 FLOP a byte they are not needed for the rate, but on
//     CUDA cores a key cost ~90 instructions a warp (dot products,
//     butterflies, unpacking, exps), which kept the first design at a
//     quarter of the bound.  Every warp computes S = Q.K^T for the whole
//     tile (G heads padded to 16-row mma tiles) and the same online
//     softmax, so m and l agree across warps; each warp then adds P.V
//     for its quarter of D, with P split into bf16 hi + lo as in the
//     prefill.  f32 (`flash_decode_kernel`, the tests' and the f32 rows'
//     type) stays on CUDA cores: lanes of 16 bytes across D, the heads in
//     register slots, a butterfly per key, warps merged through shared
//     memory;
//   * with one split holding keys a block writes the output.  Otherwise
//     it writes its partial (m, l, acc[G][D]) in f32 to scratch and counts
//     it with one acq_rel atomic; the block that counts the row's last
//     partial merges them online (m* = max m_i, l* = sum e^(m_i - m*)
//     l_i, acc likewise) and sets the count back to 0, so the counts need
//     no fill per call and a call is one launch.
//   Only splits that ran keys are merged, and m starts at -1e30, never
//   -inf, so no exp(-inf + inf) arises; with kv_len 0 every logit is
//   -1e30 and the merge gives the reference's average of V over all S.
//   What is left between the kernel and its bound is latency more than
//   bytes: ~1 us to launch, ~2 us from the kv_len read to the first tile,
//   ~2 us for the count and the merge (PERF.md, section 6).

// Layout.  Every tensor is passed by pointer plus element strides, with
// the head dimension D contiguous, so the model's (B, S, H, D)
// activations and its (B, S_max, Hkv, D) KV cache are read in place as
// (B, Hkv, [G,] S, D) views without a transpose copy.  The bf16 prefill's
// 16-byte copies need every row stride to be a multiple of 8 elements;
// the wrapper checks it.  The query rows of one block belong to ONE
// (b, hkv, g) head: the causal mask compares a row's sequence position,
// never a flat index over G*S rows.
//
// The f32 kernels sum in a fixed order with fmaf and the accurate expf,
// so they agree with the plain PyTorch version to ~1e-6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // masked logit, as the TPU kernel
constexpr float kLFloor = 1e-30f;  // normaliser floor, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as .astype
}

// Stage `rows` rows of D elements (row r at src + r * row_stride) into
// shared memory as f32 (row r at dst + r * ld); rows >= valid are zero.
// One 16-byte load per thread and step; the wrapper checks alignment.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int rows,
                                          int valid, int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int e = tid; e < rows * kPerRow; e += nthreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * kVec;
    float* out = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = to_f<T>(vals[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block (one head)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 score tile each

struct PrefillStrides {
  int64_t q[4];  // (b, h, g, s)
  int64_t k[3];  // (b, h, s)
  int64_t v[3];  // (b, h, s)
  int64_t o[4];  // (b, h, g, s)
};

template <int D>
constexpr size_t prefill_smem_floats() {
  // q and k tiles padded to an odd row length: the 16 threads of a row
  // group read 16 different k rows (or 2 q rows) at one d without bank
  // conflicts.  At D = 128 this is 115,456 bytes: two blocks per SM.
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     PrefillStrides st, int hkv, int g, int s, float scale,
                     int causal) {
  extern __shared__ float smem[];
  constexpr int kLdq = D + 1, kLdk = D + 1, kLdv = D, kLdp = kBK + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  float* qs = smem;
  float* ks = qs + kBQ * kLdq;
  float* vs = ks + kBK * kLdk;
  float* ps = vs + kBK * kLdv;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx + 16 j, output columns tx + 16 c
  const int ty = tid / 16;  // query rows 4 ty .. 4 ty + 3
  // the last query tiles do the most causal work: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int gi = blockIdx.x % g;
  const int hi = (blockIdx.x / g) % hkv;
  const int bi = blockIdx.x / (g * hkv);
  const T* qp = q + bi * st.q[0] + hi * st.q[1] + gi * st.q[2] + q0 * st.q[3];
  const T* kp = k + bi * st.k[0] + hi * st.k[1];
  const T* vp = v + bi * st.v[0] + hi * st.v[1];
  T* op = o + bi * st.o[0] + hi * st.o[1] + gi * st.o[2] + q0 * st.o[3];

  load_rows<T, D>(qs, kLdq, qp, st.q[3], kBQ, min(kBQ, s - q0), tid,
                  kThreads);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // causal: tiles strictly above the diagonal add nothing; skip them
  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int kvalid = min(kBK, s - k0);
    __syncthreads();  // the last tile's readers are done with ks/vs/ps
    load_rows<T, D>(ks, kLdk, kp + k0 * st.k[2], st.k[2], kBK, kvalid, tid,
                    kThreads);
    load_rows<T, D>(vs, kLdv, vp + k0 * st.v[2], st.v[2], kBK, kvalid, tid,
                    kThreads);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * kLdq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax; a row's 16 threads are one half-warp (lanes tx)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kpos >= s) {
          x = -INFINITY;
        } else if (causal && kpos > qpos) {
          x = kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(4 * ty + i) * kLdp + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V over this tile (keys past S have p = 0, v = 0)
#pragma unroll 4
    for (int c = 0; c < kvalid; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kLdp + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float vv = vs[c * kLdv + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (q0 + r >= s) continue;
    const float denom = fmaxf(l[i], kLFloor);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      op[r * st.o[3] + tx + 16 * cc] = from_f<T>(acc[i][cc] / denom);
  }
}

// ---------------------------------------------------------------------------
// prefill, bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

using bf16_t = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 query rows each

template <int D>
constexpr size_t prefill_mma_smem_bytes() {
  // the Q tile and two stages of K and V tiles, rows padded to D + 8
  return static_cast<size_t>(kBQ + 4 * kBK) * (D + 8) * sizeof(bf16_t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_size 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), two packed pairs (the
// lower column in the low half, as an mma fragment holds it)
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// cp.async 64 rows of D bf16 (row r at src + r * row_stride) into shared
// memory rows of D + 8; rows >= valid are zero-filled and never read
template <int D>
__device__ __forceinline__ void cp_rows(bf16_t* dst, const bf16_t* src,
                                        int64_t row_stride, int valid,
                                        int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kBQ == kBK && (kBK * kChunks) % kMmaThreads == 0, "tile");
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * (D + 8) + c),
               src + (ok ? r : 0) * row_stride + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_prefill_mma_kernel(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                         PrefillStrides st, int hkv, int g, int s,
                         float scale, int causal) {
  static_assert(D % 16 == 0, "D is a multiple of the mma's k = 16");
  constexpr int kLd = D + 8;        // shared row, in bf16 elements
  constexpr int kKD = D / 16;       // k-steps of Q.K^T
  constexpr int kND = D / 8;        // 8-column tiles of the output
  constexpr int kNK = kBK / 8;      // 8-key tiles of a score row
  constexpr int kTile = kBK * kLd;  // one K or V stage
  extern __shared__ uint4 smem_u4[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_u4);
  bf16_t* ks = qs + kBQ * kLd;        // two stages
  bf16_t* vs = ks + 2 * kTile;        // two stages

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int quad = lane % 4;        // fragment columns 2 quad, 2 quad + 1
  const int r0 = warp * 16 + lane / 4;  // fragment rows r0, r0 + 8
  // the last query tiles do the most causal work: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int gi = blockIdx.x % g;
  const int hi = (blockIdx.x / g) % hkv;
  const int bi = blockIdx.x / (g * hkv);
  const bf16_t* qp = q + bi * st.q[0] + hi * st.q[1] + gi * st.q[2] + q0 * st.q[3];
  const bf16_t* kp = k + bi * st.k[0] + hi * st.k[1];
  const bf16_t* vp = v + bi * st.v[0] + hi * st.v[1];
  bf16_t* op = o + bi * st.o[0] + hi * st.o[1] + gi * st.o[2] + q0 * st.o[3];

  // causal: tiles strictly above the diagonal add nothing; skip them
  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  cp_rows<D>(qs, qp, st.q[3], min(kBQ, s - q0), tid);
  cp_rows<D>(ks, kp, st.k[2], min(kBK, s), tid);
  cp_rows<D>(vs, vp, st.v[2], min(kBK, s), tid);
  cp_async_commit();

  uint32_t qf[kKD][4];
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix.x4 row addresses: lane / 8 picks the 8 x 8 matrix
  const int mat = lane / 8, mrow = lane % 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const bf16_t* kt = ks + (t & 1) * kTile;
    const bf16_t* vt = vs + (t & 1) * kTile;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      const int k1 = k0 + kBK;
      cp_rows<D>(ks + ((t + 1) & 1) * kTile, kp + k1 * st.k[2], st.k[2],
                 min(kBK, s - k1), tid);
      cp_rows<D>(vs + ((t + 1) & 1) * kTile, vp + k1 * st.v[2], st.v[2],
                 min(kBK, s - k1), tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      // A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        ldsm_x4(qf[kk], smem_addr(qs + (warp * 16 + lane % 16) * kLd +
                                  kk * 16 + (lane / 16) * 8));
    }

    // S = Q . K^T over this tile: 16 rows x 64 keys a warp
    float sc[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int np = 0; np < kNK / 2; ++np) {
        // B fragments of key tiles 2 np and 2 np + 1: matrices
        // (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7), ...
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt + (np * 16 + mrow + (mat / 2) * 8) * kLd +
                             kk * 16 + (mat % 2) * 8));
        mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax on the fragments: element e of tile n is row
    // r0 + 8 (e / 2), key k0 + 8 n + 2 quad + e % 2
    const bool edge = k0 + kBK > s || (causal && k0 + kBK - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * quad + (e & 1);
          const int qpos = q0 + r0 + (e >> 1) * 8;
          if (kpos >= s) {
            x = -INFINITY;
          } else if (causal && kpos > qpos) {
            x = kNegInf;
          }
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);  // m_new
    }
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - mx[e >> 1]);
        sc[n][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      alpha[i] = expf(m[i] - mx[i]);
      l[i] = alpha[i] * l[i] + sum[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P . V: the S fragments of key tiles 2 kc and 2 kc + 1 are
    // the A fragment of keys 16 kc .. 16 kc + 15, split into hi and lo
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16x2(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      split_bf16x2(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
      split_bf16x2(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16x2(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        // B fragments of d tiles 2 dp and 2 dp + 1, transposed: matrices
        // (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15), ...
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(vt + (kc * 16 + mrow + (mat % 2) * 8) *
                                            kLd + dp * 16 + (mat / 2) * 8));
        mma_bf16(acc[2 * dp], ph, b[0], b[1]);
        mma_bf16(acc[2 * dp], pl, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (q0 + r >= s) continue;
    const float denom = fmaxf(l[i], kLFloor);
    bf16_t* orow = op + r * st.o[3];
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * quad) =
          __floats2bfloat162_rn(acc[n][2 * i] / denom,
                                acc[n][2 * i + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// decode: split-KV over the SMs, the splits merged in the same launch
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTile = 32;      // keys per cp.async stage
constexpr int kDecStages = 4;     // stages in the ring
constexpr int kDecPer = kDecTile / kDecWarps;  // a warp's keys of a tile
constexpr int kMaxGD = 2048;      // G * D of one (b, hkv) group
constexpr int kMaxSplits = 64;    // splits of one row

struct DecodeStrides {
  int64_t q[3];  // (b, h, g)
  int64_t k[3];  // (b, h, s)
  int64_t v[3];  // (b, h, s)
  int64_t o[3];  // (b, h, g)
};

// A decode block's place: its row's end, its chunk of keys, and how many
// of the row's splits hold keys.
struct DecodeRow {
  int bh, split, hi, bi, end, c0, c1, n_valid, n_tiles;
  bool none;  // kv_len <= 0: every logit is -1e30, v averaged over S
  __device__ DecodeRow(const int* kv_len, int hkv, int s, int chunk) {
    bh = blockIdx.x;
    split = blockIdx.y;
    hi = bh % hkv;
    bi = bh / hkv;
    const int len = kv_len[bi];
    // positions >= len add exactly 0 once one position is valid, so stop
    // there; with none valid the reference averages v over all S
    // positions, and so do the splits and their merge
    end = len > 0 ? min(len, s) : s;
    none = len <= 0;
    c0 = split * chunk;
    c1 = min(c0 + chunk, end);
    n_valid = (end + chunk - 1) / chunk;  // the splits that hold keys
    n_tiles = (c1 - c0 + kDecTile - 1) / kDecTile;
  }
};

// Scratch of a row's splits: acc[G][D] of every (bh, split), then (m, l)
// of every (bh, split, head).
__device__ __forceinline__ float* part_acc_of(float* part, int bh, int gd) {
  return part + static_cast<int64_t>(bh) * gridDim.y * gd;
}
__device__ __forceinline__ float* part_ml_of(float* part, int bh, int g,
                                             int gd) {
  return part + static_cast<int64_t>(gridDim.x) * gridDim.y * gd +
         static_cast<int64_t>(bh) * gridDim.y * g * 2;
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// After a block has written its split's partial: count it, and in
// the block that counts the row's last partial merge the n_valid partials
// and set the count back to 0 (so the counts need no fill per call).  A
// thread merges four elements of one head online over the splits (m* =
// max m_i, l* = sum e^(m_i - m*) l_i, acc likewise), its loads issued
// together.  m is never -inf (a split that ran keys has m >= -1e30), so
// no exp(-inf + inf) arises.
template <typename T, int D>
__device__ void decode_merge_splits(const DecodeRow& row, T* op, int64_t o_g,
                                    float* part, int* arrived, int g,
                                    int* last) {
  const int tid = threadIdx.x, gd = g * D;
  __syncthreads();  // the block's partial is written
  if (tid == 0) {
    // release: the block's partial before its count; acquire: the other
    // blocks' partials after theirs (bar.sync carries both to the block)
    const int before = atomic_add_acq_rel(arrived + row.bh, 1);
    *last = before == row.n_valid - 1;
    if (*last) atomicExch(arrived + row.bh, 0);
  }
  __syncthreads();
  if (!*last) return;
  const float4* acc4 =
      reinterpret_cast<const float4*>(part_acc_of(part, row.bh, gd));
  const float2* ml2 =
      reinterpret_cast<const float2*>(part_ml_of(part, row.bh, g, gd));
  for (int e4 = tid; e4 < gd / 4; e4 += kDecThreads) {
    const int h = 4 * e4 / D, d = 4 * e4 % D;
    float mm = kNegInf, ll = 0.f, aa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int i = 0; i < row.n_valid; ++i) {
      const float2 ml = __ldcg(ml2 + i * g + h);
      const float4 a4 = __ldcg(acc4 + i * (gd / 4) + e4);
      const float m_new = fmaxf(mm, ml.x);
      const float s_old = expf(mm - m_new), s_new = expf(ml.x - m_new);
      ll = fmaf(ml.y, s_new, ll * s_old);
      aa[0] = fmaf(a4.x, s_new, aa[0] * s_old);
      aa[1] = fmaf(a4.y, s_new, aa[1] * s_old);
      aa[2] = fmaf(a4.z, s_new, aa[2] * s_old);
      aa[3] = fmaf(a4.w, s_new, aa[3] * s_old);
      mm = m_new;
    }
    const float den = fmaxf(ll, kLFloor);
#pragma unroll
    for (int c = 0; c < 4; ++c) op[h * o_g + d + c] = from_f<T>(aa[c] / den);
  }
}

// ---- decode, bf16: tensor cores ----------------------------------------

template <int D>
size_t decode_mma_smem_bytes(int g) {
  // the Q rows (G padded to 16 MT) and the ring of K and V tiles, bf16
  // rows padded to D + 8 (ldmatrix rows in distinct bank groups)
  const int mt = (g + 15) / 16;
  return (static_cast<size_t>(16) * mt +
          static_cast<size_t>(kDecStages) * 2 * kDecTile) *
         (D + 8) * sizeof(bf16_t);
}

// Grid (B * Hkv, n_split); block (bh, i) runs keys [i * chunk, (i + 1) *
// chunk) of its row, cut at end = min(kv_len, S) (all S when kv_len is
// 0).  The G heads are the rows of MT 16-row mma tiles.  For each 32-key
// tile every warp computes S (16 x 32 per tile row) = Q . K^T by
// m16n8k16 (four independent 8-key chains) and the same online softmax
// on the accumulator fragments (head rows lane / 4 and lane / 4 + 8,
// keys 2 (lane % 4) and + 1 of each 8), so m and l agree across the
// warps; then each warp adds P . V for its quarter of D by m16n8k16,
// two S tiles making P's A fragment, P split into bf16 hi + lo (the
// reference keeps P in f32) and V fragments by ldmatrix.trans.
template <int D, int MT>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_mma_kernel(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v,
                        const int* __restrict__ kv_len,
                        bf16_t* __restrict__ o, float* __restrict__ part,
                        int* __restrict__ arrived, DecodeStrides st, int hkv,
                        int g, int s, int chunk, float scale) {
  static_assert(D % 16 == 0, "D is a multiple of the mma's k = 16");
  constexpr int kLd = D + 8;        // shared row, in bf16 elements
  constexpr int kKD = D / 16;       // k-steps of Q.K^T
  constexpr int kND = D / 8;        // 8-column tiles of the output
  constexpr int kNK = kDecTile / 8; // 8-key tiles of S
  // a warp's 8-column tiles of the output (D = 16: warps 2 and 3 none)
  constexpr int kWD = kND >= kDecWarps ? kND / kDecWarps : 1;
  constexpr int kChunks = D / 8;    // 16-byte chunks a row
  constexpr int kCopies = (2 * kDecTile * kChunks) / kDecThreads;
  constexpr int kStage = 2 * kDecTile * kLd;
  static_assert(kCopies >= 1 && (2 * kDecTile * kChunks) % kDecThreads == 0,
                "whole copies a thread");
  extern __shared__ uint4 dec_smem[];
  __shared__ int last;
  bf16_t* qs = reinterpret_cast<bf16_t*>(dec_smem);  // 16 MT x kLd
  bf16_t* ring = qs + 16 * MT * kLd;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the Q rows, zero past G, are in flight while kv_len is read; they go
  // with the first tile's group
  {
    const bf16_t* qp = q + (blockIdx.x / hkv) * st.q[0] +
                       (blockIdx.x % hkv) * st.q[1];
    for (int e = tid; e < 16 * MT * kChunks; e += kDecThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool ok = r < g;
      cp_async16(smem_addr(qs + r * kLd + c),
                 qp + (ok ? r : 0) * st.q[2] + c, ok);
    }
  }
  const DecodeRow row(kv_len, hkv, s, chunk);
  if (row.c0 >= row.end) {
    cp_async_commit();   // no copy outlives its block
    cp_async_wait<0>();
    return;              // this split holds no key of the row
  }
  const float scale2 = scale * kLog2e;
  const int quad = lane % 4;        // fragment columns 2 quad, 2 quad + 1
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix.x4 addresses
  const int n0 = warp * kWD;        // this warp's first output tile
  const bool has_d = n0 < kND;

  // this thread's copies of each tile: (K or V row r, 16-byte chunk c),
  // the source at key c0 and its step per key; rows at or past c1 are
  // zero-filled, never read from memory
  const bf16_t* src[kCopies];
  int64_t step[kCopies];
  int crow[kCopies];
  uint32_t cdst[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = tid + i * kDecThreads;
    const int half = e / (kDecTile * kChunks);  // 0: K, 1: V
    const int r = (e / kChunks) % kDecTile, c = (e % kChunks) * 8;
    step[i] = half ? st.v[2] : st.k[2];
    src[i] = (half ? v + row.bi * st.v[0] + row.hi * st.v[1]
                   : k + row.bi * st.k[0] + row.hi * st.k[1]) +
             (row.c0 + r) * step[i] + c;
    crow[i] = r;
    cdst[i] = smem_addr(ring + half * kDecTile * kLd + r * kLd + c);
  }
  auto load_tile = [&](int t) {
    const int rows = min(kDecTile, row.c1 - (row.c0 + t * kDecTile));
    const uint32_t stage = (t % kDecStages) * kStage * sizeof(bf16_t);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool ok = crow[i] < rows;
      cp_async16(cdst[i] + stage,
                 ok ? src[i] + static_cast<int64_t>(t) * kDecTile * step[i]
                    : src[i],
                 ok);
    }
  };

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < row.n_tiles) load_tile(t);
    cp_async_commit();
  }

  uint32_t qf[MT][kKD][4];
  float acc[MT][kWD][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < kWD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int t = 0; t < row.n_tiles; ++t) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
      // A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)
          ldsm_x4(qf[mt][kk], smem_addr(qs + (mt * 16 + lane % 16) * kLd +
                                        kk * 16 + (lane / 16) * 8));
    }
    const int rows = min(kDecTile, row.c1 - (row.c0 + t * kDecTile));
    const bf16_t* kt = ring + (t % kDecStages) * kStage;
    const bf16_t* vt = kt + kDecTile * kLd;

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // S = Q . K^T: B fragments of key tile nt at k-steps kk, kk + 1:
      // matrices (keys 0-7, d 16 kk + 0-7), (+ 8-15), (16 kk + 16-23), ...
      // two accumulator sets (even and odd k-steps) halve the mma chain
      float sc[kNK][4], sc2[kNK][4];
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = sc2[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKD; kk += 2) {
        const int k2 = min(kk + mat / 2, kKD - 1);  // D = 16: one k-step
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, smem_addr(kt + (nt * 8 + mrow) * kLd + k2 * 16 +
                               (mat % 2) * 8));
          mma_bf16(sc[nt], qf[mt][kk], b[0], b[1]);
          if (kk + 1 < kKD) mma_bf16(sc2[nt], qf[mt][kk + 1], b[2], b[3]);
        }
      }
      // online softmax in log2 units (scale * log2 e folded into the
      // logits; m and l go out in natural units): element e of key tile
      // nt is head row 16 mt + lane / 4 + 8 (e / 2), key 8 nt + 2 quad +
      // e % 2; keys past the chunk are -inf, so p = 0 exactly (and their
      // V rows are zero).  Rows 8-15 of a tile are all padding when G
      // stops before them: their softmax is skipped (their P.V adds 0)
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = nt * 8 + 2 * quad + (e & 1);
          sc[nt][e] = key >= rows ? -INFINITY
                                  : (row.none ? kNegInf
                                              : (sc[nt][e] + sc2[nt][e]) *
                                                    scale2);
        }
      const int n_rows = mt * 16 + 8 < g ? 2 : 1;  // the same for the warp
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= n_rows) {
#pragma unroll
          for (int nt = 0; nt < kNK; ++nt)
            sc[nt][2 * i] = sc[nt][2 * i + 1] = 0.f;
          continue;
        }
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt)
          mx = fmaxf(mx, fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][i], mx);
        if (m_new > m[mt][i]) {  // a new max: rescale what came before
          const float a = exp2f(m[mt][i] - m_new);
          l[mt][i] *= a;
#pragma unroll
          for (int n = 0; n < kWD; ++n) {
            acc[mt][n][2 * i] *= a;
            acc[mt][n][2 * i + 1] *= a;
          }
          m[mt][i] = m_new;
        }
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) {
          sc[nt][2 * i] = exp2f(sc[nt][2 * i] - m[mt][i]);
          sc[nt][2 * i + 1] = exp2f(sc[nt][2 * i + 1] - m[mt][i]);
          sum += sc[nt][2 * i] + sc[nt][2 * i + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[mt][i] += sum;
      }
      if (!has_d) continue;
      // acc += P . V over this warp's output tiles: the S fragments of key
      // tiles 2 kc and 2 kc + 1 are the A fragment of keys 16 kc .. + 15
#pragma unroll
      for (int kc = 0; kc < kNK / 2; ++kc) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int n = 0; n < kWD; n += 2) {
          // matrices (keys 0-7, tile n0 + n), (keys 8-15, same),
          // (keys 0-7, tile n0 + n + 1), (keys 8-15, same), transposed
          uint32_t b[4];
          const int nn = n0 + min(n + mat / 2, kWD - 1);
          ldsm_x4_trans(b, smem_addr(vt + (kc * 16 + mrow + (mat % 2) * 8) *
                                              kLd + nn * 8));
          mma_bf16(acc[mt][n], ph, b[0], b[1]);
          mma_bf16(acc[mt][n], pl, b[0], b[1]);
          if (n + 1 < kWD) {
            mma_bf16(acc[mt][n + 1], ph, b[2], b[3]);
            mma_bf16(acc[mt][n + 1], pl, b[2], b[3]);
          }
        }
      }
    }
    if (t + kDecStages - 1 < row.n_tiles) load_tile(t + kDecStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this warp's columns of the block's partial, or of the output when one
  // split holds the row's keys
  const int gd = g * D;
  bf16_t* op = o + row.bi * st.o[0] + row.hi * st.o[1];
  float* pacc = part_acc_of(part, row.bh, gd) + row.split * gd;
  float* pml = part_ml_of(part, row.bh, g, gd) + row.split * g * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int h = mt * 16 + lane / 4 + 8 * i;
      if (h >= g) continue;
      const float den = fmaxf(l[mt][i], kLFloor);
      if (has_d) {
#pragma unroll
        for (int n = 0; n < kWD; ++n) {
          const int d = (n0 + n) * 8 + 2 * quad;
          if (row.n_valid == 1) {
            *reinterpret_cast<__nv_bfloat162*>(op + h * st.o[2] + d) =
                __floats2bfloat162_rn(acc[mt][n][2 * i] / den,
                                      acc[mt][n][2 * i + 1] / den);
          } else {
            *reinterpret_cast<float2*>(pacc + h * D + d) =
                make_float2(acc[mt][n][2 * i], acc[mt][n][2 * i + 1]);
          }
        }
      }
      if (row.n_valid > 1 && warp == 0 && quad == 0)
        *reinterpret_cast<float2*>(pml + 2 * h) =
            make_float2(m[mt][i] * kLn2, l[mt][i]);
    }
  if (row.n_valid == 1) return;  // the only split wrote the output
  decode_merge_splits<bf16_t, D>(row, op, st.o[2], part, arrived, g, &last);
}

// ---- decode, f32: CUDA cores -------------------------------------------

template <int D>
size_t decode_f32_smem_bytes(int g) {
  // the ring of K and V tiles; after the loop, each warp's (acc[G][D],
  // m[G], l[G]) for the block's merge of its warps
  const size_t ring =
      static_cast<size_t>(kDecStages) * 2 * kDecTile * D * sizeof(float);
  const size_t warps =
      static_cast<size_t>(kDecWarps) * g * (D + 2) * sizeof(float);
  return ring > warps ? ring : warps;
}

// The tests' and the f32 rows' type.  A lane holds 16 bytes (4 floats)
// of a row: D / 4 lanes span one head, so a warp holds 128 / D query
// heads at once, in registers, and NS such slots hold G.  Warp w takes
// keys 8 w .. 8 w + 7 of each 32-key tile, kBatch at a time: a 16-byte K
// load, a partial dot product per slot, a butterfly over the lanes of a
// head; one rescale a batch; an f32 P.V into lane-owned accumulators.
template <int D, int NS>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ kv_len, float* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ arrived,
                    DecodeStrides st, int hkv, int g, int s, int chunk,
                    float scale) {
  constexpr int kVec = 4;
  constexpr int kLanes = D / kVec;
  constexpr int kHeads = 32 / kLanes;
  constexpr int kStage = 2 * kDecTile * D;      // elements: K tile, V tile
  // keys a warp takes at once: independent chains, one rescale a batch;
  // fewer as the slots take more registers
  constexpr int kBatch = NS <= 2 ? 8 : 16 / NS;
  static_assert(kLanes >= 1 && kLanes <= 32, "16-byte lanes across D");
  static_assert(kDecPer % kBatch == 0, "whole batches in a tile");
  extern __shared__ uint4 dec_smem[];
  __shared__ int last;
  float* ring = reinterpret_cast<float*>(dec_smem);

  const DecodeRow row(kv_len, hkv, s, chunk);
  if (row.c0 >= row.end) return;  // this split holds no key of the row
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* kp = k + row.bi * st.k[0] + row.hi * st.k[1];
  const float* vp = v + row.bi * st.v[0] + row.hi * st.v[1];

  // tile t (keys c0 + 32 t ..) into ring stage t % kDecStages by 16-byte
  // cp.async; rows at or past c1 are neither read nor written
  auto load_tile = [&](int t) {
    const int k0 = row.c0 + t * kDecTile;
    const int rows = min(kDecTile, row.c1 - k0);
    float* dst = ring + (t % kDecStages) * kStage;
    for (int e = tid; e < 2 * kDecTile * kLanes; e += kDecThreads) {
      const int half = e / (kDecTile * kLanes);  // 0: K, 1: V
      const int r = (e / kLanes) % kDecTile;
      const int c = (e % kLanes) * kVec;
      if (r < rows) {
        const float* src = half ? vp + (k0 + r) * st.v[2] : kp + (k0 + r) * st.k[2];
        cp_async16(smem_addr(dst + half * kDecTile * D + r * D + c), src + c,
                   true);
      }
    }
  };

  // slot j holds head j * kHeads + grp, elements d0 .. d0 + 3
  const int grp = lane / kLanes;
  const int d0 = (lane % kLanes) * kVec;
  float qr[NS][kVec], acc[NS][kVec], m[NS], l[NS];
  const float* qp = q + row.bi * st.q[0] + row.hi * st.q[1];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int h = j * kHeads + grp;
    const float4 q4 = h < g
        ? *reinterpret_cast<const float4*>(qp + h * st.q[2] + d0)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[j][0] = q4.x;
    qr[j][1] = q4.y;
    qr[j][2] = q4.z;
    qr[j][3] = q4.w;
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < row.n_tiles) load_tile(t);
    cp_async_commit();
  }
  for (int t = 0; t < row.n_tiles; ++t) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + kDecStages - 1 < row.n_tiles) load_tile(t + kDecStages - 1);
    cp_async_commit();
    const float* kt = ring + (t % kDecStages) * kStage;
    const float* vt = kt + kDecTile * D;
    const int rows = min(kDecTile, row.c1 - (row.c0 + t * kDecTile));
#pragma unroll 1
    for (int j0 = 0; j0 < kDecPer; j0 += kBatch) {
      const int r0 = warp * kDecPer + j0;
      if (r0 >= rows) break;  // the same for the whole warp
      float x[kBatch][NS];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float4 k4 = r0 + i < rows
            ? *reinterpret_cast<const float4*>(kt + (r0 + i) * D + d0)
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < NS; ++j)
          x[i][j] = fmaf(qr[j][3], k4.w,
                         fmaf(qr[j][2], k4.z,
                              fmaf(qr[j][1], k4.y, qr[j][0] * k4.x)));
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j)
            x[i][j] += __shfl_xor_sync(0xffffffffu, x[i][j], off);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float m_new = m[j];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          x[i][j] = row.none ? kNegInf : x[i][j] * scale;
          if (r0 + i < rows) m_new = fmaxf(m_new, x[i][j]);
        }
        if (m_new > m[j]) {  // a new max: rescale what came before
          const float a = expf(m[j] - m_new);
          l[j] *= a;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[j][e] *= a;
          m[j] = m_new;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r0 + i >= rows) break;
        const float4 v4 = *reinterpret_cast<const float4*>(vt + (r0 + i) * D + d0);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float p = expf(x[i][j] - m[j]);
          l[j] += p;
          acc[j][0] = fmaf(p, v4.x, acc[j][0]);
          acc[j][1] = fmaf(p, v4.y, acc[j][1]);
          acc[j][2] = fmaf(p, v4.z, acc[j][2]);
          acc[j][3] = fmaf(p, v4.w, acc[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' partials

  const int rec = g * (D + 2);
  float* wsm = reinterpret_cast<float*>(dec_smem);
  float* mine = wsm + warp * rec;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int h = j * kHeads + grp;
    if (h < g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) mine[h * D + d0 + e] = acc[j][e];
      if (d0 == 0) {
        mine[g * D + h] = m[j];
        mine[g * D + g + h] = l[j];
      }
    }
  }
  __syncthreads();
  // merge the warps: one that ran no key holds m = -1e30, l = 0 and adds
  // exactly 0; then the output, or this split's partial
  const int gd = g * D;
  float* op = o + row.bi * st.o[0] + row.hi * st.o[1];
  float* pacc = part_acc_of(part, row.bh, gd) + row.split * gd;
  float* pml = part_ml_of(part, row.bh, g, gd) + row.split * g * 2;
  for (int e = tid; e < gd; e += kDecThreads) {
    const int h = e / D, d = e % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mm = fmaxf(mm, wsm[w * rec + gd + h]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float a = expf(wsm[w * rec + gd + h] - mm);
      ll = fmaf(a, wsm[w * rec + gd + g + h], ll);
      aa = fmaf(a, wsm[w * rec + e], aa);
    }
    if (row.n_valid == 1) {
      op[h * st.o[2] + d] = aa / fmaxf(ll, kLFloor);
    } else {
      pacc[e] = aa;
      if (d == 0) {
        pml[2 * h] = mm;
        pml[2 * h + 1] = ll;
      }
    }
  }
  if (row.n_valid == 1) return;  // the only split wrote the output
  decode_merge_splits<float, D>(row, op, st.o[2], part, arrived, g, &last);
}

template <typename T, int D>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   const PrefillStrides& st, int b, int hkv, int g, int s,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = prefill_smem_floats<D>() * sizeof(float);
  auto kernel = flash_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hkv * g, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, hkv, g, s, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                        const PrefillStrides& st, int b, int hkv, int g, int s,
                        float scale, int causal, cudaStream_t stream) {
  const size_t smem = prefill_mma_smem_bytes<D>();
  auto kernel = flash_prefill_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hkv * g, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
      static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), st, hkv, g, s,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename Kernel>
int launch_decode_kernel(Kernel kernel, size_t smem, const void* q,
                         const void* k, const void* v, const int* kv_len,
                         void* o, float* part, int* arrived,
                         const DecodeStrides& st, int b, int hkv, int g, int s,
                         int chunk, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hkv, (s + chunk - 1) / chunk);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), kv_len, static_cast<E*>(o), part, arrived, st,
      hkv, g, s, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

#define DECODE_ARGS q, k, v, kv_len, o, part, arrived, st, b, hkv, g, s, chunk, scale, stream

// bf16: the fewest 16-row mma tiles (MT) that hold G heads
template <int D>
int decode_bf16(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, float* part, int* arrived,
                const DecodeStrides& st, int b, int hkv, int g, int s,
                int chunk, float scale, cudaStream_t stream) {
  const size_t smem = decode_mma_smem_bytes<D>(g);
  const int mt = (g + 15) / 16;   // G * D <= 2048: mt <= 2048 / (16 D)
  if (mt <= 1) return launch_decode_kernel<bf16_t>(flash_decode_mma_kernel<D, 1>, smem, DECODE_ARGS);
  if constexpr (D <= 64) {
    if (mt <= 2) return launch_decode_kernel<bf16_t>(flash_decode_mma_kernel<D, 2>, smem, DECODE_ARGS);
  }
  if constexpr (D <= 32) {
    if (mt <= 4) return launch_decode_kernel<bf16_t>(flash_decode_mma_kernel<D, 4>, smem, DECODE_ARGS);
  }
  if constexpr (D <= 16) {
    if (mt <= 8) return launch_decode_kernel<bf16_t>(flash_decode_mma_kernel<D, 8>, smem, DECODE_ARGS);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32: the fewest register slots (NS) that hold G heads
template <int D>
int decode_f32(const void* q, const void* k, const void* v,
               const int* kv_len, void* o, float* part, int* arrived,
               const DecodeStrides& st, int b, int hkv, int g, int s,
               int chunk, float scale, cudaStream_t stream) {
  const size_t smem = decode_f32_smem_bytes<D>(g);
  constexpr int kHeads = 128 / D;
  const int ns = (g + kHeads - 1) / kHeads;  // G * D <= 2048: ns <= 16
  if (ns <= 1) return launch_decode_kernel<float>(flash_decode_kernel<D, 1>, smem, DECODE_ARGS);
  if (ns <= 2) return launch_decode_kernel<float>(flash_decode_kernel<D, 2>, smem, DECODE_ARGS);
  if (ns <= 4) return launch_decode_kernel<float>(flash_decode_kernel<D, 4>, smem, DECODE_ARGS);
  if (ns <= 8) return launch_decode_kernel<float>(flash_decode_kernel<D, 8>, smem, DECODE_ARGS);
  if (ns <= 16) return launch_decode_kernel<float>(flash_decode_kernel<D, 16>, smem, DECODE_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

int decode_by_d(int d, int is_bf16, const void* q, const void* k,
                const void* v, const int* kv_len, void* o, float* part,
                int* arrived, const DecodeStrides& st, int b, int hkv, int g,
                int s, int chunk, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return is_bf16 ? decode_bf16<16>(DECODE_ARGS) : decode_f32<16>(DECODE_ARGS);
    case 32: return is_bf16 ? decode_bf16<32>(DECODE_ARGS) : decode_f32<32>(DECODE_ARGS);
    case 64: return is_bf16 ? decode_bf16<64>(DECODE_ARGS) : decode_f32<64>(DECODE_ARGS);
    case 128: return is_bf16 ? decode_bf16<128>(DECODE_ARGS) : decode_f32<128>(DECODE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef DECODE_ARGS

template <typename T>
int prefill_by_d(int d, const void* q, const void* k, const void* v, void* o,
                 const PrefillStrides& st, int b, int hkv, int g, int s,
                 float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_prefill<T, 16>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 32: return launch_prefill<T, 32>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 64: return launch_prefill<T, 64>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 128: return launch_prefill<T, 128>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int prefill_bf16_by_d(int d, const void* q, const void* k, const void* v,
                      void* o, const PrefillStrides& st, int b, int hkv, int g,
                      int s, float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_prefill_bf16<16>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 32: return launch_prefill_bf16<32>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 64: return launch_prefill_bf16<64>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    case 128: return launch_prefill_bf16<128>(q, k, v, o, st, b, hkv, g, s, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hkv, G, S, D), k/v (B, Hkv, S, D), o like q, each given by its
// base pointer and element strides: strides = [q: b, h, g, s | k: b, h, s |
// v: b, h, s | o: b, h, g, s], D contiguous.  is_bf16 selects bf16 over
// f32 for all four.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int b, int hkv,
                                      int g, int s, int d, int is_bf16,
                                      float scale, int causal, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || s < 1 || (s + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PrefillStrides st;
  for (int i = 0; i < 4; ++i) st.q[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.k[i] = strides[4 + i];
  for (int i = 0; i < 3; ++i) st.v[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.o[i] = strides[10 + i];
  auto stream_ = static_cast<cudaStream_t>(stream);
  return is_bf16 ? prefill_bf16_by_d(d, q, k, v, o, st, b, hkv, g, s, scale,
                                     causal, stream_)
                 : prefill_by_d<float>(d, q, k, v, o, st, b, hkv, g, s,
                                       scale, causal, stream_);
}

// Dynamic shared memory of one bf16 prefill block at head dim d, in
// bytes (0 for a d that has no instance).
extern "C" int flash_prefill_bf16_smem_bytes(int d) {
  switch (d) {
    case 16: return static_cast<int>(prefill_mma_smem_bytes<16>());
    case 32: return static_cast<int>(prefill_mma_smem_bytes<32>());
    case 64: return static_cast<int>(prefill_mma_smem_bytes<64>());
    case 128: return static_cast<int>(prefill_mma_smem_bytes<128>());
    default: return 0;
  }
}

// q (B, Hkv, G, D), k/v cache (B, Hkv, S, D), kv_len (B,) int32 on the
// card, o like q; strides = [q: b, h, g | k: b, h, s | v: b, h, s |
// o: b, h, g], D contiguous.  The cache is cut into ceil(S / chunk) <= 64
// splits of `chunk` keys (a multiple of 32).  With more than one split,
// part is f32 scratch of B * Hkv * n_split * G * (D + 2) elements and
// arrived B * Hkv int32 counts that are 0 before the launch and 0 again
// after it; with one split neither is touched (they may be null).
// Returns the cudaError_t of the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* kv_len, void* o,
                                   float* part, int* arrived,
                                   const int64_t* strides, int b, int hkv,
                                   int g, int s, int d, int is_bf16,
                                   int chunk, float scale, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || s < 1 || g * d > kMaxGD || chunk < 1 ||
      chunk % kDecTile || (s + chunk - 1) / chunk > kMaxSplits ||
      (chunk < s && (part == nullptr || arrived == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeStrides st;
  for (int i = 0; i < 3; ++i) st.q[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.k[i] = strides[3 + i];
  for (int i = 0; i < 3; ++i) st.v[i] = strides[6 + i];
  for (int i = 0; i < 3; ++i) st.o[i] = strides[9 + i];
  auto stream_ = static_cast<cudaStream_t>(stream);
  return decode_by_d(d, is_bf16, q, k, v, kv_len, o, part, arrived, st, b,
                     hkv, g, s, chunk, scale, stream_);
}

// Dynamic shared memory of one decode block for G heads at head dim d,
// in bytes (0 for a d that has no instance).
extern "C" int flash_decode_smem_bytes(int g, int d, int is_bf16) {
  switch (d) {
    case 16: return static_cast<int>(is_bf16 ? decode_mma_smem_bytes<16>(g) : decode_f32_smem_bytes<16>(g));
    case 32: return static_cast<int>(is_bf16 ? decode_mma_smem_bytes<32>(g) : decode_f32_smem_bytes<32>(g));
    case 64: return static_cast<int>(is_bf16 ? decode_mma_smem_bytes<64>(g) : decode_f32_smem_bytes<64>(g));
    case 128: return static_cast<int>(is_bf16 ? decode_mma_smem_bytes<128>(g) : decode_f32_smem_bytes<128>(g));
    default: return 0;
  }
}
