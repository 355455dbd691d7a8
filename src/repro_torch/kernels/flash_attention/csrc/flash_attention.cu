// Causal GQA flash-attention forward with an optional sliding window,
// written for Hopper (sm_90a) on the fp32 FMA units.  `ops.kernel_for`
// sends fp32 here, and bf16 at head dims 16 and 80; bf16 at 64, 128 and
// 256 runs on the tensor cores in flash_attention_wgmma.cu.
//
// Replaces the TPU kernel `_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py (the pl.pallas_call reached
// through repro.kernels.flash_attention.ops.flash_attention).  It computes
// the same function:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / groups] * scale)
//                * v[b, j, h / groups],    scale = 1 / sqrt(hd),
//
// over the keys j with j < Sk and, when causal, j <= i and (with a window)
// j > i - window.  The online softmax keeps m, l and acc in fp32, masks
// scores to -1e30, skips tiles that are wholly above the diagonal or
// outside the window, and emits acc / max(l, 1e-30) in q's dtype.  bf16
// inputs are widened to fp32 on load, as the Pallas kernel does.
//
// What differs from the Pallas kernel, by design:
// - The TPU kernel carries (m, l, acc) in VMEM across a sequential grid
//   axis over key blocks.  Blocks on Hopper run in no order, so one thread
//   block owns one (batch, head, 64-row query tile) and loops over the key
//   tiles itself, with the state in registers.
// - The ops wrapper of the reference pads hd to 128 and Sq/Sk to the block
//   sizes, and the kernel masks on the PADDED Sk (so a non-causal call with
//   a ragged Sk lets the zero keys into the softmax).  Here nothing is
//   padded: the kernel masks rows past Sq and keys past the true Sk, and
//   uses the true hd's scale, so it equals the plain version `attention_ref`
//   in that case too.
// - Query tiles are scheduled heaviest first (the last causal tile has the
//   most key tiles), so the tail of the grid is short.
//
// Layout: q [B, Sq, H, hd], k/v [B, Sk, KV, hd], o [B, Sq, H, hd],
// contiguous, fp32 or bf16, 16-byte aligned.  hd is a template parameter,
// instantiated for the head dims of the ported models and the reference's
// kernel tests: 16 (smoke), 64, 80, 128 and 256.  256 threads as 16 x 16:
// thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 2) of a 32-key tile, and output columns tx + 16 j
// (j < hd / 16).  Shared memory holds the query tile, one key and one
// value tile and the tile's probabilities, all fp32:
// 76 KB at hd = 128 (two blocks an SM), 139 KB at hd = 256 (above the
// 48 KB default, so the launcher raises the block's dynamic limit).
//
// Bound on this card: at the serving path's prefill (B = 4, S = 2048,
// H = 24, KV = 8, hd = 128, bf16) the two products need 4 hd B H S(S+1)/2 =
// 1.03e11 operations, 104 us at the H100's 989 TFLOP/s for bf16, against
// 134 MB of q, k, v and o, 40 us at 3.35 TB/s: operations bound it.  This
// kernel runs the products on the fp32 FMA units from shared memory, far
// below that bound (4.0 ms at that shape in bf16 on an H100); the
// tensor-core kernel in flash_attention_wgmma.cu is the one that
// approaches it, and serves that shape.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kCols = kBK / 16;     // score columns per thread
constexpr int kLdP = kBK + 4;       // probability tile row stride (floats)
constexpr float kMasked = -1e30f;   // the reference's masked score

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Copy `rows` rows of HD elements (global row stride `stride` elements)
// into shared memory with row stride `ld` floats, widened to fp32; rows at
// or past `valid` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float component(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (HD + 4) +
                          static_cast<size_t>(kBK) * (HD + 4) +
                          static_cast<size_t>(kBK) * HD +
                          static_cast<size_t>(kBQ) * kLdP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
              int H, int KV, float scale, int causal, int has_window,
              int window) {
  constexpr int kLdQ = HD + 4;  // q and k row stride: conflict-free float4
  constexpr int kNJ = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLdQ;
  float* Vs = Ks + kBK * kLdQ;
  float* Ps = Vs + kBK * HD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * HD;
  const long long kv_stride = static_cast<long long>(KV) * HD;
  const long long q_base = (static_cast<long long>(b) * Sq + q0) * q_stride +
                           static_cast<long long>(h) * HD;
  const long long kv_base = static_cast<long long>(b) * Sk * kv_stride +
                            static_cast<long long>(kvh) * HD;

  load_tile<T, HD>(Qs, kLdQ, q + q_base, q_stride, kBQ, Sq - q0);

  float m[kRows], l[kRows], acc[kRows][kNJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    if (causal) {
      if (k0 > q0 + kBQ - 1) break;  // this and later tiles: above diagonal
      if (has_window && k0 + kBK - 1 <= q0 - window) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(Ks, kLdQ, k + kv_base + k0 * kv_stride, kv_stride, kBK,
                     Sk - k0);
    load_tile<T, HD>(Vs, HD, v + kv_base + k0 * kv_stride, kv_stride, kBK,
                     Sk - k0);
    __syncthreads();

    // scores s = q . k over the tile
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kLdQ +
                                                 d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLdQ +
                                                 d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax; the 16 threads of a row are one half warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (has_window) ok = ok && kpos > qpos - window;
        }
        s[i][j] = ok ? s[i][j] * scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kNJ];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) vv[j] = Vs[(kk + u) * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = component(pv[i], u);
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + q_base + r * q_stride;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) store(out + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, scale,
      causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int KV, float scale, int causal,
                int has_window, int window, cudaStream_t s) {
#define FA_CASE(HD)                                                         \
  case HD:                                                                  \
    return launch<T, HD>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,       \
                         has_window, window, s);
  switch (hd) {
    FA_CASE(16)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window is read only when has_window.
// Returns the launch's CUDA error code (0 on success); the wrapper checks
// every argument first.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   float scale, int causal, int has_window,
                                   int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                              has_window, window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, KV, scale,
                                      causal, has_window, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
