// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t, written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `rglru_scan_pallas` in
// src/repro/kernels/rglru/kernel.py (the pl.pallas_call reached through
// repro.kernels.rglru.ops.rglru_scan).  It computes the same function: per
// (batch b, channel r), h starts at zero and h_t = a_t h_{t-1} + b_t is
// written for every step, in fp32.  Each step is one fused multiply-add,
// rounded once, as the reference's compiled recurrence and the plain
// version round it: with a constant a near 1, rounding the product and the
// sum apart drifts past the reference's 1e-5 bar over 2,048 steps.
//
// What differs from the Pallas kernel, by design:
// - The TPU kernel tiles channels to the lane width and carries h in VMEM
//   across a sequential grid axis over chunks.  Here one thread owns one
//   (batch, channel) chain and loops over the whole sequence with h in a
//   register, so there is no chunk and no channel block (the wrapper's
//   `chunk` and `block_r` are not read here), and nothing is padded.
// - Neighbouring threads own neighbouring channels, so every load and
//   store of a warp is one 128-byte line.  Each thread loads kUnroll steps
//   ahead before it runs them, to keep loads in flight while the chain
//   waits.
//
// Layout: a, b, h [B, S, R] fp32, contiguous.  64 threads a block, grid
// (ceil(R / 64), B).
//
// Bound on this card: the function reads a and b once and writes h once,
// 12 bytes a step and channel: at the recurrentgemma-2b prefill (B = 4,
// S = 4096, R = 2560) 503 MB, 150 us at 3.35 TB/s; its 2 operations a
// step are nothing beside that: bytes bound it.  B R = 10,240 chains are
// too few to keep the memory busy while each waits on its own loads; a
// chunked two-pass scan (chunk-local scans in parallel, then a carry
// pass) is the later work that approaches the bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ h,
                      int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t base = size_t(blockIdx.y) * S * R + r;
  float carry = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[base + size_t(t + u) * R];
      bv[u] = b[base + size_t(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      h[base + size_t(t + u) * R] = carry;
    }
  }
  for (; t < S; ++t) {
    carry = fmaf(a[base + size_t(t) * R], carry, b[base + size_t(t) * R]);
    h[base + size_t(t) * R] = carry;
  }
}

}  // namespace

// Returns the launch's CUDA error code (0 on success); the wrapper checks
// every argument first.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int R, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, R);
  return static_cast<int>(cudaGetLastError());
}
