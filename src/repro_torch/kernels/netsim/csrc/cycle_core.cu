// Arbitration core of the simulator's fused and compact cycle steps, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cycle_kernel` / `cycle_core_pallas` in
// src/repro/kernels/netsim/kernel.py (the pl.pallas_call reached through
// repro.kernels.netsim.ops.cycle_core).  The Pallas kernel carries the
// per-channel minimum `m` in VMEM across a sequential (phase, chunk) grid
// and builds one-hot [chunk, E] tiles for the TPU's vector unit; blocks on
// Hopper run in no order, so that design is not carried over.  As in
// grant.cu, the minimum is taken with atomicMin on ONE 64-bit key per row,
//
//     key = ((itime ^ 0x80000000) << 32) | prio,
//
// whose unsigned order is (itime ascending, prio ascending): the
// reference's packed int32 key `itime * r2 + prio` wherever that fits, and
// its two-pass age-then-priority form where it would overflow, so one
// kernel serves both of the reference's grant forms.  atomicMin is
// order-independent: the result is bit-exact and deterministic.
//
// Three launches on the caller's stream, no allocation, no synchronisation:
//   fill        (one thread per lane and channel)   m[b, c] = ~0
//   accumulate  (one thread per lane and row)       atomicMin(m[b, out], key)
//                                                   on the ok rows
//   emit        (one thread per lane and row or channel)
//               win[b, r] = ok && ch_ok[out] && m[b, out] == key,
//               won[b, c] = ch_ok[c] && m[b, c] != ~0,
//               wprio[b, c] = won ? low32(m[b, c]) : 0
// with ok read as ok[b, r] && 0 <= out < E.  The channel mask is applied
// after the reduction, as in the reference.  `prio` may be null: the row
// index is then the priority (the dense fused step), which saves reading
// 4 bytes a row.
//
// Bound on this card: a few integer operations per row, so the bound is
// bytes.  The fused step at the paper's radix-16 network (4 lanes,
// N = 204,672 rows, E = 30,176 channels, no prio) reads 9 bytes a row and
// 1 a channel and writes 1 a row and 5 a channel: 8.9 MB, 2.7 us at
// 3.35 TB/s.  The compact step (N = 51,168 active rows with prio) moves
// 3.6 MB, 1.1 us.  At these sizes launch overhead dominates; fusing the
// request assembly into the accumulate pass, or capturing the cycle loop in
// a CUDA graph, is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ULL;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long row_key(int32_t itime,
                                                      uint32_t prio) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(itime) ^
                                          0x80000000u) << 32) |
         prio;
}

__device__ __forceinline__ uint32_t row_prio(const int32_t* prio, long long i,
                                             int r) {
  return prio ? static_cast<uint32_t>(prio[i]) : static_cast<uint32_t>(r);
}

__global__ void cycle_fill(unsigned long long* m, int E) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < E) m[static_cast<long long>(blockIdx.y) * E + c] = kEmpty;
}

__global__ void cycle_accumulate(const int32_t* out, const int32_t* itime,
                                 const uint8_t* ok, const int32_t* prio,
                                 unsigned long long* m, int N, int E) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long b = blockIdx.y;
  const long long i = b * N + r;
  const int32_t o = out[i];
  if (!ok[i] || o < 0 || o >= E) return;
  atomicMin(&m[b * E + o], row_key(itime[i], row_prio(prio, i, r)));
}

__global__ void cycle_emit(const int32_t* out, const int32_t* itime,
                           const uint8_t* ok, const int32_t* prio,
                           const uint8_t* ch_ok, long long ch_ok_ls,
                           const unsigned long long* m, uint8_t* win,
                           uint8_t* won, int32_t* wprio,
                           unsigned long long* launches, int N, int E) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  // the call counted where it runs, so a graph's replays count too
  if (x == 0 && b == 0) atomicAdd(launches, 1ULL);
  const unsigned long long* mb = m + b * E;
  const uint8_t* cb = ch_ok + b * ch_ok_ls;
  if (x < N) {
    const long long i = b * N + x;
    const int32_t o = out[i];
    win[i] = ok[i] && o >= 0 && o < E && cb[o] &&
             mb[o] == row_key(itime[i], row_prio(prio, i, x));
  }
  if (x < E) {
    const unsigned long long v = mb[x];
    const bool w = cb[x] && v != kEmpty;
    won[b * E + x] = w;
    wprio[b * E + x] = w ? static_cast<int32_t>(v & 0xffffffffULL) : 0;
  }
}

}  // namespace

// Row tensors are [B, N] and channel tensors [B, E], contiguous along the
// last axis; `ch_ok_ls` is the channel mask's lane stride in elements (0
// when one mask is shared by every lane).  `prio` is [B, N] or null.  `m` is
// [B, E] uint64 scratch.  The emit kernel adds one to `launches` on the
// device.  Returns cudaGetLastError() after the launches.
extern "C" int netsim_cycle_core(const int32_t* out, const int32_t* itime,
                                 const uint8_t* ok, const int32_t* prio,
                                 const uint8_t* ch_ok, long long ch_ok_ls,
                                 unsigned long long* m, uint8_t* win,
                                 uint8_t* won, int32_t* wprio, int B, int N,
                                 int E, unsigned long long* launches,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const dim3 grid_ch((E + kThreads - 1) / kThreads, B);
  const dim3 grid_row((N + kThreads - 1) / kThreads, B);
  const int X = N > E ? N : E;
  const dim3 grid_emit((X + kThreads - 1) / kThreads, B);
  cycle_fill<<<grid_ch, block, 0, s>>>(m, E);
  cycle_accumulate<<<grid_row, block, 0, s>>>(out, itime, ok, prio, m, N, E);
  cycle_emit<<<grid_emit, block, 0, s>>>(out, itime, ok, prio, ch_ok,
                                         ch_ok_ls, m, win, won, wprio,
                                         launches, N, E);
  return static_cast<int>(cudaGetLastError());
}
