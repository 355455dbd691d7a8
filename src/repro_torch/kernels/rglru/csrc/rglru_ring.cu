// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper
// (sm_90a): each (batch, channel) chain runs sequentially in one lane, its
// a and b fed through a ring of stages in shared memory that are copied
// several stages ahead of the chain.
//
// Replaces the TPU kernel `_kernel` (src/repro/kernels/rglru/kernel.py:20)
// and its pl.pallas_call in `rglru_scan_pallas` (:45), reached through
// repro.kernels.rglru.ops.rglru_scan.  It computes the same function: per
// (batch b, channel r), h starts at zero and h_t = a_t h_{t-1} + b_t is
// written for every step, in fp32.  The arithmetic is that of the direct
// kernel in rglru.cu: one fmaf a step from zero, in the same order, so the
// two agree bit for bit on every input.
//
// Bound on this card: the function reads a and b once and writes h once,
// 12 bytes a step and channel; its 2 operations a step are nothing beside
// that, so bytes bound it.  At the recurrentgemma-2b prefill (B = 4,
// S = 4096, R = 2560) that is 503 MB, 150.24 us at 3.35 TB/s.
//
// What holds the direct kernel back is the bytes in flight: each thread
// loads 16 steps, runs them, and only then issues the next 16, so its
// loads drain to zero between batches, and 10,240 chains keep on average
// well under the ~20 KB an SM that the memory's latency asks for at its
// rate.  Here:
// - A block is one warp and owns 32 consecutive channels of one batch row,
//   one lane a channel: grid (ceil(R / 32), B), 320 blocks at the served
//   shape, all resident at once (about 2.4 an SM).
// - The warp copies its a and b with cp.async into a ring of kStages
//   stages, each kSteps steps x 32 channels of a and of b (4 KB at 16
//   steps), and keeps kStages - 1 stages in flight: it issues stage
//   s + kStages - 1 before it waits for stage s, so the copies never
//   drain.  At 4 stages that is 12 KB in flight a block, ~30 KB an SM.
//   tools/rglru_phases.py times the kernel over kSteps and kStages on an
//   H100: 16 steps and 4 stages came within 2 % of a plain streaming
//   kernel that moves the same bytes, while 32 steps lost time as stages
//   were added (more bytes in flight than the memory needs).
// - The chain reads its stage from shared memory, one fmaf a step, and
//   stores h for each step straight to device memory: 128 bytes a warp,
//   one line.  The chain is kSteps dependent fmaf a stage, a small
//   fraction of the time the memory takes to deliver the next stage, so it
//   waits on the copies and not the reverse (without the copies, the chain
//   and its stores take about 0.4 of the kernel's time).
// - cp.async rather than TMA: a TMA tensor map needs row strides that are
//   multiples of 16 bytes, i.e. R % 4 == 0, and the kernel takes any R.
//   Rows of 16-byte multiples (R % 4 == 0, 16-byte aligned bases: the
//   served shape) copy 16 bytes a lane; any other R copies 4 bytes a lane.
//   The warp that copies is the warp that consumes, so a stage is "full"
//   at cp.async.wait_group and __syncwarp, and "empty" once the warp has
//   passed the __syncwarp after its chain: no mbarrier is needed.
// - Masks cover the ragged S (a short last stage) and R (lanes past R copy
//   and store nothing; what they compute on is never written).  Nothing is
//   padded and nothing is allocated.
//
// Layout: a, b, h [B, S, R] fp32, contiguous.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;   // channels a block, one lane each
constexpr int kSteps = 16;   // steps a stage
constexpr int kStages = 4;   // stages in the ring
// a then b, each [kSteps][kLanes] fp32, for each stage
constexpr int kStageFloats = 2 * kSteps * kLanes;
constexpr int kSmem = kStages * kStageFloats * 4;
static_assert(kSteps % 4 == 0, "a stage copies whole 16-byte pieces");
static_assert(kStages >= 2, "the ring needs a stage in flight");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most kStages - 1 groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Issues stage s (steps s kSteps ...) of a and b into its ring slot and
// commits it as one group; past the last stage, an empty group, so that
// every iteration's wait counts the same number of groups.
template <bool kVec>
__device__ __forceinline__ void issue_stage(float* ring, const float* a,
                                            const float* b, size_t row0,
                                            int s, int n, int S, int R,
                                            int r0, int lane) {
  if (s < n) {
    float* sa = ring + (s % kStages) * kStageFloats;
    float* sb = sa + kSteps * kLanes;
    const int t0 = s * kSteps;
    if (kVec) {
      // 8 pieces of 16 bytes a step, kSteps / 4 pieces a lane
#pragma unroll
      for (int i = 0; i < kSteps / 4; ++i) {
        const int piece = i * kLanes + lane;
        const int u = piece / 8, col = (piece % 8) * 4;
        if (t0 + u < S && r0 + col < R) {
          const size_t g = (row0 + t0 + u) * R + r0 + col;
          cp_async16(sa + u * kLanes + col, a + g);
          cp_async16(sb + u * kLanes + col, b + g);
        }
      }
    } else if (r0 + lane < R) {
#pragma unroll 8
      for (int u = 0; u < kSteps; ++u) {
        if (t0 + u < S) {
          const size_t g = (row0 + t0 + u) * R + r0 + lane;
          cp_async4(sa + u * kLanes + lane, a + g);
          cp_async4(sb + u * kLanes + lane, b + g);
        }
      }
    }
  }
  cp_async_commit();
}

template <bool kVec>
__global__ void __launch_bounds__(kLanes)
    rglru_ring_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ h,
                      int S, int R) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kLanes;
  const int r = r0 + lane;
  const bool live = r < R;
  const size_t row0 = size_t(blockIdx.y) * S;  // the batch row's first step
  const int n = (S + kSteps - 1) / kSteps;
  for (int s = 0; s < kStages - 1; ++s)
    issue_stage<kVec>(ring, a, b, row0, s, n, S, R, r0, lane);
  float carry = 0.f;
  for (int s = 0; s < n; ++s) {
    // the slot of stage s - 1, which every lane has finished reading
    issue_stage<kVec>(ring, a, b, row0, s + kStages - 1, n, S, R, r0, lane);
    cp_async_wait_ring();
    __syncwarp();  // stage s has landed, every lane's copies included
    const float* sa = ring + (s % kStages) * kStageFloats + lane;
    const float* sb = sa + kSteps * kLanes;
    const int t0 = s * kSteps;
    float* out = h + (row0 + t0) * R + r;
    if (t0 + kSteps <= S) {
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        carry = fmaf(sa[u * kLanes], carry, sb[u * kLanes]);
        if (live) out[size_t(u) * R] = carry;
      }
    } else {
      for (int u = 0; u < S - t0; ++u) {
        carry = fmaf(sa[u * kLanes], carry, sb[u * kLanes]);
        if (live) out[size_t(u) * R] = carry;
      }
    }
    __syncwarp();  // every lane is done with slot s % kStages
  }
}

template <bool kVec>
int launch(const float* a, const float* b, float* h, int B, int S, int R,
           cudaStream_t stream) {
  auto kernel = rglru_ring_kernel<kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + kLanes - 1) / kLanes, B);
  kernel<<<grid, kLanes, kSmem, stream>>>(a, b, h, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h [B, S, R] fp32, contiguous.  Returns the launch's CUDA error code
// (0 on success); the wrapper checks every argument first.
extern "C" int rglru_scan_ring_fwd(const void* a, const void* b, void* h,
                                   int B, int S, int R, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const auto fa = static_cast<const float*>(a);
  const auto fb = static_cast<const float*>(b);
  const auto fh = static_cast<float*>(h);
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(fa, fb, fh, B, S, R, st)
             : launch<false>(fa, fb, fh, B, S, R, st);
}
