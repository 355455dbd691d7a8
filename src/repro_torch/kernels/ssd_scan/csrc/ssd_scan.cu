// Mamba-2 SSD (state-space duality) chunked scan, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/kernel.py (the pl.pallas_call reached through
// repro.kernels.ssd_scan.ops.ssd_scan).  It computes the same function,
// the recurrence
//
//   s_t = exp(-A_h dt_t) s_{t-1} + dt_t x_t B_t^T,   y_t = s_t C_t,
//
// per (batch b, head h) with s a [P, N] fp32 state starting at zero, in
// its chunked form: over a chunk of L steps with cum_i = sum_{k<=i} -A dt_k,
//
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//       + exp(cum_i) C_i . S_prev                                 (inter)
//   S   = exp(cum_L) S_prev + sum_j exp(cum_L - cum_j) dt_j x_j B_j^T.
//
// What differs from the Pallas kernel, by design:
// - The TPU kernel carries the state in VMEM scratch across a sequential
//   grid axis over chunks.  Blocks on Hopper run in no order, so one block
//   owns one (batch, head) and loops over the chunks itself, with the
//   state in shared memory.
// - The chunk is the kernel's own tile, L = 32 steps (one warp scans the
//   log-decays with shuffles).  The result does not depend on the chunk
//   (the chunked form is exact), so the wrapper's `chunk` is not read here.
// - The reference's wrapper pads S to the chunk and its kernel masks on the
//   padded length (a no-op, right only because the padded dt are zero).
//   Here nothing is padded: steps at or past the true S load as zero
//   (dt = 0 is the identity transition) and their y is not written.
// - The intra-chunk weights are computed only for j <= i; the others are
//   zero without exponentiating a masked value.
//
// Layout: x [B, S, H, P], dt [B, S, H] fp32, A [H] fp32 (the positive decay
// rate), Bm/Cm [B, S, N] shared by all heads, y [B, S, H, P] in x's dtype,
// state [B, H, P, N] fp32; all contiguous.  x, Bm, Cm are fp32 or bf16
// (widened to fp32 on load).  P is a template parameter (16, 32, 64);
// N is at most 256.  256 threads a block.  Shared memory,
// all fp32: B and C of the chunk transposed to [N][L + 2], x [L][P], the
// weights transposed [L][L + 2] and the state [N][P]; 80 KB at P = 64,
// N = 128 (above the 48 KB default, so the launcher raises the block's
// dynamic limit; two blocks fit an SM).
//
// Bound on this card: at the mamba2-780m prefill (B = 4, S = 2048, H = 48,
// P = 64, N = 128, bf16 x/B/C) the function reads x, dt, B, C once and
// writes y and the state once, ~113 MB, 34 us at 3.35 TB/s; its products
// (2.3e10 operations in 128-step chunks, causal pairs only) take 23 us at
// the tensor cores' 989 TFLOP/s: bytes bound it.  This kernel runs every
// product on the fp32 FMA units out of shared memory, one block per
// (batch, head), so it sits far above that bound; chunk products on
// tensor cores (wgmma), with heads split over more blocks, are the later
// work that approaches it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;              // steps per chunk (one warp)
constexpr int kLd = kL + 2;         // row stride of the [N][L] / [L][L] tiles
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (H, B); block kThreads.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ state, int S, int H, int N) {
  constexpr int G = kThreads / P;   // thread groups sharing one column p
  constexpr int R = kL / G;         // output rows per thread
  static_assert(kThreads % P == 0 && kL % G == 0 && R % 2 == 0, "tiling");
  extern __shared__ float4 smem4[];
  float* Bt = reinterpret_cast<float*>(smem4);   // [N][kLd]
  float* Ct = Bt + N * kLd;                      // [N][kLd]
  float* Xs = Ct + N * kLd;                      // [kL][P]
  float* Wt = Xs + kL * P;                       // [kL][kLd], Wt[j][i]
  float* St = Wt + kL * kLd;                     // [N][P]
  float* cum = St + N * P;                       // [kL]
  float* dts = cum + kL;                         // [kL]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a_h = A[h];
  const int p = tid % P, g = tid / P;

  for (int e = tid; e < N * P; e += kThreads) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    // -- load the chunk (steps past S as zero) and scan its log-decays
    for (int e = tid; e < kL * P; e += kThreads) {
      const int j = e / P, t = t0 + j;
      Xs[e] = t < S ? to_f32(x[((size_t(b) * S + t) * H + h) * P + e % P])
                    : 0.f;
    }
    for (int e = tid; e < kL * N; e += kThreads) {
      const int j = e / N, n = e % N, t = t0 + j;
      const size_t src = (size_t(b) * S + t) * N + n;
      Bt[n * kLd + j] = t < S ? to_f32(Bm[src]) : 0.f;
      Ct[n * kLd + j] = t < S ? to_f32(Cm[src]) : 0.f;
    }
    if (tid < kL) {
      const int t = t0 + tid;
      const float d = t < S ? dt[(size_t(b) * S + t) * H + h] : 0.f;
      float c = -a_h * d;
#pragma unroll
      for (int off = 1; off < kL; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, c, off);
        if (tid >= off) c += up;
      }
      cum[tid] = c;
      dts[tid] = d;
    }
    __syncthreads();

    // -- intra-chunk weights W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j
    //    for j <= i, else 0; thread (ty, tx) owns i = 2ty + {0, 1},
    //    j = 2tx + {0, 1}
    {
      const int ty = tid / 16, tx = tid % 16;
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      if (tx <= ty) {
        for (int n = 0; n < N; ++n) {
          const float2 c = *reinterpret_cast<const float2*>(
              &Ct[n * kLd + 2 * ty]);
          const float2 bb = *reinterpret_cast<const float2*>(
              &Bt[n * kLd + 2 * tx]);
          acc[0][0] = fmaf(c.x, bb.x, acc[0][0]);
          acc[0][1] = fmaf(c.x, bb.y, acc[0][1]);
          acc[1][0] = fmaf(c.y, bb.x, acc[1][0]);
          acc[1][1] = fmaf(c.y, bb.y, acc[1][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int i = 2 * ty + u, j = 2 * tx + v;
          Wt[j * kLd + i] =
              j <= i ? acc[u][v] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // -- y over rows i0 .. i0 + R - 1 of column p: intra + inter
    {
      const int i0 = g * R;
      float intra[R], inter[R];
#pragma unroll
      for (int k = 0; k < R; ++k) intra[k] = inter[k] = 0.f;
      const int jmax = min(kL, i0 + R);   // W[i][j] = 0 for j > i
      for (int j = 0; j < jmax; ++j) {
        const float xv = Xs[j * P + p];
#pragma unroll
        for (int k = 0; k < R; k += 2) {
          const float2 w = *reinterpret_cast<const float2*>(
              &Wt[j * kLd + i0 + k]);
          intra[k] = fmaf(w.x, xv, intra[k]);
          intra[k + 1] = fmaf(w.y, xv, intra[k + 1]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float sv = St[n * P + p];
#pragma unroll
        for (int k = 0; k < R; k += 2) {
          const float2 c = *reinterpret_cast<const float2*>(
              &Ct[n * kLd + i0 + k]);
          inter[k] = fmaf(c.x, sv, inter[k]);
          inter[k + 1] = fmaf(c.y, sv, inter[k + 1]);
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int t = t0 + i0 + k;
        if (t < S)
          y[((size_t(b) * S + t) * H + h) * P + p] =
              from_f32<T>(intra[k] + expf(cum[i0 + k]) * inter[k]);
      }
    }
    __syncthreads();

    // -- state: S[p][n] = exp(cum_L) S[p][n]
    //                     + sum_j x_j[p] exp(cum_L - cum_j) dt_j B_j[n];
    //    thread owns column p at n = g, g + G, ...
    {
      const float last = cum[kL - 1];
      float xd[kL];
#pragma unroll
      for (int j = 0; j < kL; ++j)
        xd[j] = Xs[j * P + p] * expf(last - cum[j]) * dts[j];
      const float decay = expf(last);
      for (int n = g; n < N; n += G) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kL; j += 2) {
          const float2 bb = *reinterpret_cast<const float2*>(
              &Bt[n * kLd + j]);
          acc = fmaf(bb.x, xd[j], acc);
          acc = fmaf(bb.y, xd[j + 1], acc);
        }
        St[n * P + p] = fmaf(decay, St[n * P + p], acc);
      }
    }
    __syncthreads();
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    state[(size_t(b) * H + h) * P * N + e] = St[n * P + pp];
  }
}

size_t smem_bytes(int P, int N) {
  return sizeof(float) *
         (size_t(2) * N * kLd + kL * P + kL * kLd + size_t(N) * P + 2 * kL);
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int S, int H, int N,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(int P, const void* x, const void* dt, const void* A,
               const void* Bm, const void* Cm, void* y, void* state, int B,
               int S, int H, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, state, B, S, H, N, s);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, state, B, S, H, N, s);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, state, B, S, H, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  Returns the
// launch's CUDA error code (0 on success); the wrapper checks every
// argument first.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state, int dtype, int B, int S, int H,
                            int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_p<float>(P, x, dt, A, Bm, Cm, y, state, B, S, H, N, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(P, x, dt, A, Bm, Cm, y, state, B, S, H,
                                     N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
