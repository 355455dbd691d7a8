// One-launch arbitration skeleton of the netsim kernels on Hopper (sm_90a),
// for the row-index priority (the oracle step's grant, the fused step's
// arbitration core): `grant_coop.cu` and `cycle_core_coop.cu` instantiate
// it with their row policy.  The three-pass `cycle_core.cu` stays for
// explicit priorities (the compact step; `ops.kernel_for`).
//
// One persistent cooperative launch, one block of 1,024 threads on every SM,
// the per-channel minimum of the rows' 64-bit keys in device memory (L2):
//
//   rows       each row read once (16-byte loads of the int32 arrays, 4-byte
//              loads of the bool ones, two quads of four rows a thread
//              loaded before either is used), its eligibility and key
//              computed once, a native 64-bit atomic minimum (REDG.MIN.64,
//              no reply awaited) into the lane's table, win = 0 written;
//              the other half of the table, read by the previous call, is
//              set to ~0 for the next one (no fill phase);
//   barrier    one grid-wide barrier: a 64-bit arrival count that only
//              grows, so it needs no reset and no second atomic;
//   channels   won (and wprio) per channel, the channel mask applied after
//              the reduction; the key's low word IS the winning row, so the
//              channel writes win[row] = 1 and no row is read again.
//
// The scratch is [2, B, E] uint64 (the two halves, ~0 before the first
// call) and two uint64 words (0 before the first call): the barrier's
// arrival count and the call count, whose parity names the half a call
// uses; both live on the device, so the kernel can be captured in a CUDA
// graph.  Calls that share a scratch must be ordered (one stream) and on
// one device (the grid is its SM count).
//
// Why not a thread-block cluster with the table in distributed shared
// memory (measured on NVIDIA H100 80GB HBM3, 700 W, with 16-block clusters
// a lane): 64 SMs stream the rows (~35 GB/s an SM), the 64-bit minimum into
// a remote block's shared memory is a compare-and-swap loop (there is no
// native 64-bit shared-memory minimum, and ptxas's lowering of
// `atom.shared::cluster.min.u64` lost updates) whose round trips took
// 5-6 us a block at the fused step's shape, and three cluster barriers
// cost ~1 us each: 19 us a call against 8.5 us for the three-pass kernel.
//
// Built with -DNETSIM_PHASES (tools/netsim_phases.py), thread 0 of the
// first blocks reads the global timer at each phase boundary.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

// Everything here is local to the translation unit that includes it.
namespace {

constexpr unsigned long long kEmpty = ~0ULL;
constexpr int kThreads = 1024;

__device__ __forceinline__ unsigned long long row_key(int32_t itime,
                                                      uint32_t row) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(itime) ^
                                          0x80000000u) << 32) |
         row;
}

__device__ __forceinline__ int4 ld4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// The 64-bit minimum into device memory, no reply awaited (REDG).
__device__ __forceinline__ void red_min(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.min.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

#ifdef NETSIM_PHASES
// the global timer (ns) at each phase boundary, thread 0 of the first
// kPhaseBlocks blocks: [block][mark]
constexpr int kPhaseBlocks = 128, kMarks = 7;
__device__ unsigned long long phase_times[kPhaseBlocks * kMarks];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define NETSIM_MARK(k) \
  if (marking) phase_t[k] = global_ns();
#define NETSIM_MARKS(block)                           \
  if (marking) {                                      \
    for (int i = 0; i < kMarks; ++i)                  \
      phase_times[(block) * kMarks + i] = phase_t[i]; \
  }
#else
#define NETSIM_MARK(k)
#define NETSIM_MARKS(block)
#endif

// Every block of the launch waits here until all have arrived.  `count`
// grows by the grid's size (the same at every launch on a device) at
// every barrier and is never reset: a block's arrival number names its
// barrier's target, and no block waits on a second atomic.
__device__ __forceinline__ void grid_barrier(unsigned long long* count,
                                             unsigned int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long arrival = atomicAdd(count, 1ULL);
    const unsigned long long target = (arrival / blocks + 1) * blocks;
    while (static_cast<long long>(ld_acquire(count) - target) < 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The row policy gives, for lane b and quad q (rows 4q .. 4q + 3):
//   load4<kVec>(b, q, N, E, o, k): o[i] = the row's channel if it is
//     eligible and in [0, E), else -1; k[i] = its key (16-byte loads with
//     kVec: aligned rows, N % 4 == 0; else plain loads with bounds);
//   chan_ok(b, c): whether channel c may grant.
template <class Rows, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    arbiter_one(Rows rows, unsigned long long* __restrict__ scratch,
                uint8_t* __restrict__ win, uint8_t* __restrict__ won,
                int32_t* __restrict__ wprio,
                unsigned long long* __restrict__ launches, int B, int N,
                int E) {
  __shared__ unsigned long long s_calls;
  const long long BE = static_cast<long long>(B) * E;
  unsigned long long* ctrl = scratch + 2 * BE;  // [arrivals, calls]
  if (threadIdx.x == 0) s_calls = __ldcg(ctrl + 1);
  __syncthreads();
  const unsigned long long calls = s_calls;
  unsigned long long* mine = scratch + (calls & 1) * BE;
  unsigned long long* next = scratch + ((calls + 1) & 1) * BE;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int Q = (N + 3) / 4;
  const long long BQ = static_cast<long long>(B) * Q;
#ifdef NETSIM_PHASES
  const bool marking = threadIdx.x == 0 && blockIdx.x < kPhaseBlocks;
  unsigned long long phase_t[kMarks] = {};
#endif
  NETSIM_MARK(0)

  // -- rows: each read once; its key into the lane's table
  for (long long x = g; x < BQ; x += 2 * threads) {
    // two quads, both loaded before either is used (the second clamped
    // into range and dropped when past the end)
    const long long xs[2] = {x, x + threads < BQ ? x + threads : x};
    int32_t o[2][4];
    unsigned long long k[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long b = xs[j] / Q;
      rows.template load4<kVec>(b, static_cast<int>(xs[j] - b * Q), N, E,
                                o[j], k[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && x + threads >= BQ) break;
      const long long b = xs[j] / Q;
      const int q = static_cast<int>(xs[j] - b * Q);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (o[j][i] >= 0) red_min(&mine[b * E + o[j][i]], k[j][i]);
      const long long r0 = b * N + 4LL * q;
      if (kVec) {
        *reinterpret_cast<uint32_t*>(win + r0) = 0u;
      } else {
        for (int i = 0; i < 4 && 4 * q + i < N; ++i) win[r0 + i] = 0;
      }
    }
  }
  // the other half, read by the previous call, set for the next one
  for (long long i = g; i < BE; i += threads) next[i] = kEmpty;
  NETSIM_MARK(1)
  grid_barrier(ctrl, gridDim.x);
  NETSIM_MARK(2)
  // every block read the call count before it arrived; the launch
  // counted where it runs, so a graph's replays count too
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[1] = calls + 1;
    atomicAdd(launches, 1ULL);
  }

  // -- channels: won (and wprio), and the winning row's win
  for (long long i = g; i < BE; i += threads) {
    const long long b = i / E;
    const int c = static_cast<int>(i - b * E);
    const unsigned long long v = __ldcg(mine + i);
    const bool w = rows.chan_ok(b, c) & (v != kEmpty);
    won[i] = w;
    if (wprio) wprio[i] = w ? static_cast<int32_t>(v & 0xffffffffULL) : 0;
    if (w) win[b * N + static_cast<uint32_t>(v & 0xffffffffULL)] = 1;
  }
  NETSIM_MARK(3)
  NETSIM_MARKS(blockIdx.x)
}

// The SMs of the current device when `kernel` fits one block on each (all
// resident, as a cooperative launch requires), else 0.
template <class Fn>
int resident_blocks(Fn kernel) {
  static std::mutex lock;
  static const void* fns[16];
  static int devices[16], blocks[16], filled = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> g(lock);
  for (int i = 0; i < filled; ++i)
    if (fns[i] == fn && devices[i] == device) return blocks[i];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int n = per_sm > 0 ? sms : 0;
  if (filled < 16) {
    fns[filled] = fn, devices[filled] = device, blocks[filled] = n;
    ++filled;
  }
  return n;
}

// One launch on `stream`.  `scratch` is as described at the top, `vec`
// says that the rows are 16-byte aligned with N % 4 == 0; the kernel adds
// one to `launches` on the device.  Returns the launch's CUDA error.
template <class Rows>
int launch_one(const Rows& rows, bool vec, unsigned long long* scratch,
               uint8_t* win, uint8_t* won, int32_t* wprio,
               unsigned long long* launches, int B, int N, int E,
               cudaStream_t stream) {
  auto kernel = vec ? arbiter_one<Rows, true> : arbiter_one<Rows, false>;
  const int blocks = resident_blocks(kernel);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Rows r = rows;
  void* args[] = {&r, &scratch, &win, &won, &wprio, &launches, &B, &N, &E};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), args, 0, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef NETSIM_PHASES
inline int read_phase_times(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_times, sizeof(phase_times)));
}
#endif

}  // namespace

