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
// V (bf16), bound by bytes.  One block per (b, hkv) reads each K/V tile
// once for all G heads of the group (the TPU kernel's GQA tile), 128 keys
// per tile, 16-byte loads, and stops at kv_len: the blocks past it add
// exactly 0, so unlike the TPU kernel it never reads them.  B*Hkv = 32
// blocks on 132 SMs leaves most SMs idle; split-KV is later work.
//
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
// decode
// ---------------------------------------------------------------------------

constexpr int kDecBK = 128;       // keys per tile
constexpr int kDecThreads = 256;  // 8 warps
constexpr int kMaxGD = 2048;      // G * D per block: <= 8 outputs a thread
constexpr int kDecAcc = kMaxGD / kDecThreads;

struct DecodeStrides {
  int64_t q[3];  // (b, h, g)
  int64_t k[3];  // (b, h, s)
  int64_t v[3];  // (b, h, s)
  int64_t o[3];  // (b, h, g)
};

template <int D>
size_t decode_smem_floats(int g) {
  return static_cast<size_t>(g) * D + kDecBK * (D + 1) + kDecBK * D +
         static_cast<size_t>(g) * kDecBK + 3 * g;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, DecodeStrides st, int hkv, int g,
                    int s, float scale) {
  extern __shared__ float smem[];
  constexpr int kLdk = D + 1;
  constexpr int kWarps = kDecThreads / 32;
  float* qs = smem;                 // g x D
  float* ks = qs + g * D;           // kDecBK x (D + 1)
  float* vs = ks + kDecBK * kLdk;   // kDecBK x D
  float* ps = vs + kDecBK * D;      // g x kDecBK: logits, then p
  float* ms = ps + g * kDecBK;      // running max per head
  float* ls = ms + g;               // normaliser per head
  float* as = ls + g;               // this tile's rescale per head

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int hi = blockIdx.x % hkv;
  const int bi = blockIdx.x / hkv;
  const T* kp = k + bi * st.k[0] + hi * st.k[1];
  const T* vp = v + bi * st.v[0] + hi * st.v[1];

  load_rows<T, D>(qs, D, q + bi * st.q[0] + hi * st.q[1], st.q[2], g, g, tid,
                  kDecThreads);
  for (int i = tid; i < g; i += kDecThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }
  const int len = kv_len[bi];
  // positions >= len add exactly 0 once one position is valid, so stop
  // there; with none valid the reference averages v over all S positions
  // (every logit is -1e30), and so does this loop
  const int end = len > 0 ? min(len, s) : s;
  const int gd = g * D;

  float acc[kDecAcc];
#pragma unroll
  for (int a = 0; a < kDecAcc; ++a) acc[a] = 0.f;

  for (int k0 = 0; k0 < end; k0 += kDecBK) {
    const int kvalid = min(kDecBK, s - k0);
    __syncthreads();
    load_rows<T, D>(ks, kLdk, kp + k0 * st.k[2], st.k[2], kDecBK, kvalid, tid,
                    kDecThreads);
    load_rows<T, D>(vs, D, vp + k0 * st.v[2], st.v[2], kDecBK, kvalid, tid,
                    kDecThreads);
    __syncthreads();

    for (int e = tid; e < g * kDecBK; e += kDecThreads) {
      const int gi = e / kDecBK, c = e % kDecBK;
      const float* qr = qs + gi * D;
      const float* kr = ks + c * kLdk;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) x = fmaf(qr[d], kr[d], x);
      x *= scale;
      const int pos = k0 + c;
      if (pos >= s) {
        x = -INFINITY;
      } else if (pos >= len) {
        x = kNegInf;
      }
      ps[e] = x;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += kWarps) {
      float* pr = ps + gi * kDecBK;
      float x[kDecBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kDecBK / 32; ++t) {
        x[t] = pr[lane + 32 * t];
        mx = fmaxf(mx, x[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kDecBK / 32; ++t) {
        const float p = expf(x[t] - m_new);
        pr[lane + 32 * t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[gi] = alpha * ls[gi] + sum;
        ms[gi] = m_new;
        as[gi] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kDecAcc; ++a) {
      const int e = tid + a * kDecThreads;
      if (e < gd) {
        const int gi = e / D, d = e % D;
        const float* pr = ps + gi * kDecBK;
        float y = acc[a] * as[gi];
#pragma unroll 8
        for (int c = 0; c < kvalid; ++c) y = fmaf(pr[c], vs[c * D + d], y);
        acc[a] = y;
      }
    }
  }
  __syncthreads();

  T* op = o + bi * st.o[0] + hi * st.o[1];
#pragma unroll
  for (int a = 0; a < kDecAcc; ++a) {
    const int e = tid + a * kDecThreads;
    if (e < gd) {
      const int gi = e / D, d = e % D;
      op[gi * st.o[2] + d] = from_f<T>(acc[a] / fmaxf(ls[gi], kLFloor));
    }
  }
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

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* kv_len, void* o, const DecodeStrides& st, int b,
                  int hkv, int g, int s, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_floats<D>(g) * sizeof(float);
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b * hkv, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), st, hkv, g, s,
      scale);
  return static_cast<int>(cudaGetLastError());
}

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

template <typename T>
int decode_by_d(int d, const void* q, const void* k, const void* v,
                const int* kv_len, void* o, const DecodeStrides& st, int b,
                int hkv, int g, int s, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_decode<T, 16>(q, k, v, kv_len, o, st, b, hkv, g, s, scale, stream);
    case 32: return launch_decode<T, 32>(q, k, v, kv_len, o, st, b, hkv, g, s, scale, stream);
    case 64: return launch_decode<T, 64>(q, k, v, kv_len, o, st, b, hkv, g, s, scale, stream);
    case 128: return launch_decode<T, 128>(q, k, v, kv_len, o, st, b, hkv, g, s, scale, stream);
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
// o: b, h, g], D contiguous.  Returns the cudaError_t of the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const int* kv_len, void* o,
                                   const int64_t* strides, int b, int hkv,
                                   int g, int s, int d, int is_bf16,
                                   float scale, void* stream) {
  if (b < 1 || hkv < 1 || g < 1 || s < 1 || g * d > kMaxGD)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeStrides st;
  for (int i = 0; i < 3; ++i) st.q[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.k[i] = strides[3 + i];
  for (int i = 0; i < 3; ++i) st.v[i] = strides[6 + i];
  for (int i = 0; i < 3; ++i) st.o[i] = strides[9 + i];
  auto stream_ = static_cast<cudaStream_t>(stream);
  return is_bf16 ? decode_by_d<__nv_bfloat16>(d, q, k, v, kv_len, o, st, b,
                                              hkv, g, s, scale, stream_)
                 : decode_by_d<float>(d, q, k, v, kv_len, o, st, b, hkv, g,
                                      s, scale, stream_);
}
