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
// Both keep the reference's online softmax: a running max m, normaliser
// l and accumulator acc in f32, masked logits at -1e30 (not -inf), the
// normaliser floored at 1e-30, f32 accumulation whatever the input type
// (f32 or bf16, a template parameter), and the output cast once at the
// end.  Keys at or past S (ragged tails) are -inf and add exactly 0.
//
// Bound on an H100 (phi4-mini serve shapes, bf16):
//   * prefill, B=4 Hkv=8 G=3 S=2048 D=128 causal: ~103 GFLOP of Q.K^T and
//     P.V against ~0.2 GB of traffic, so it is bound by operations
//     (~0.10 ms at the 989 TFLOP/s bf16 tensor-core peak).  This first
//     design runs on CUDA cores in f32 (no mma/wgmma yet), so it sits far
//     above that bound.  What it does about the work it has: a 64 x 64
//     score tile per block, register-tiled 4 x 4 per thread from shared
//     memory (16 FMAs per 8 shared loads), P.V from a shared P tile into a
//     4 x D/16 register accumulator, and causal tiles strictly above the
//     diagonal are never visited (half the work at S = 2048).
//   * decode, cache S=2560: one query row per (b, h, g), so the work is
//     reading the cache: ~4*Hq*D FLOPs per key against 4*Hkv*D bytes of
//     K and V (bf16), bound by bytes.  One block per (b, hkv) reads each
//     K/V tile once for all G heads of the group (the TPU kernel's GQA
//     tile), 128 keys per tile, 16-byte loads, and stops at kv_len: the
//     blocks past it add exactly 0, so unlike the TPU kernel it never reads
//     them.  B*Hkv = 32 blocks on 132 SMs leaves most SMs idle; split-KV
//     is later work.
//
// Layout.  Every tensor is passed by pointer plus element strides, with
// the head dimension D contiguous, so the model's (B, S, H, D)
// activations and its (B, S_max, Hkv, D) KV cache are read in place as
// (B, Hkv, [G,] S, D) views without a transpose copy.  The query rows of
// one block belong to ONE (b, hkv, g) head: the causal mask compares a
// row's sequence position, never a flat index over G*S rows.
//
// Each sum runs in a fixed order with fmaf; expf is the accurate one
// (no --use_fast_math), so the f32 kernels agree with the plain PyTorch
// version to ~1e-6.

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
  return is_bf16 ? prefill_by_d<__nv_bfloat16>(d, q, k, v, o, st, b, hkv, g,
                                               s, scale, causal, stream_)
                 : prefill_by_d<float>(d, q, k, v, o, st, b, hkv, g, s,
                                       scale, causal, stream_);
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
