// Age-based grant for the simulator's oracle cycle step, written for Hopper
// (sm_90a): the three-pass kernel.  The wrappers run the one-launch
// `grant_coop.cu` instead; this one runs only when a call names it
// (`ops.grant(..., kernel="three_pass")`), as the tests and
// `chip_smoke.py` do to hold and time the two against each other.
//
// Replaces the TPU kernel `_kernel` / `grant_pallas` in
// src/repro/kernels/netsim/kernel.py (the pl.pallas_call reached through
// repro.kernels.netsim.ops.grant).  The Pallas kernel runs a 3-phase grid
// (age minimum, row-id tie-break, emit) over one-hot [chunk, E] tiles kept
// in VMEM; that design exists for the TPU's vector unit and sequential grid
// and is not carried over.  Here the two segment minima collapse into ONE
// 64-bit key per row,
//
//     key = ((itime ^ 0x80000000) << 32) | row,
//
// whose unsigned order is (itime ascending, row ascending): exactly the
// oracle's "oldest first, smallest row id among the ties".  (The sign flip
// maps int32 order onto unsigned order, so any itime below 2^31 - 1 keys
// correctly.)  atomicMin is order-independent, so the result is bit-exact
// and deterministic whatever order the blocks run in.
//
// Three launches on the caller's stream, no allocation, no synchronisation:
//   fill        m[b, c] = ~0                      one thread per (lane, channel)
//   accumulate  atomicMin(m[b, out], key) if ok   one thread per (lane, row)
//   emit        win[b, r] = ok && m[b, out] == key,
//               won[b, c] = m[b, c] != ~0         one thread per (lane, row|channel)
// with ok = valid & 0 <= out < E & busy[out] == 0 & (ovc < buf_pkts | is_eject)
//           & alive[out].
//
// Bound on this card: the work is a few integer operations per row, so the
// bound is bytes.  At the paper's radix-16 network (E = 30,176 channels,
// N = 204,672 request rows per lane) one lane-cycle reads 5 row arrays
// (14 bytes a row) and 2 channel arrays (5 bytes a channel) and writes
// 1 byte a row and a channel, about 3.3 MB: about 1 us at 3.35 TB/s.
// Launch overhead dominates at this size.  Making it fast — fusing the
// eligibility into the request gather, or capturing the whole cycle loop in
// a CUDA graph — is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ULL;
constexpr int kThreads = 256;

__device__ __forceinline__ bool row_ok(int32_t out, int E, uint8_t valid,
                                       int32_t ovc, uint8_t is_eject,
                                       const int32_t* busy,
                                       const uint8_t* alive, int buf_pkts) {
  if (!valid || out < 0 || out >= E) return false;
  return busy[out] == 0 && (ovc < buf_pkts || is_eject) && alive[out];
}

__device__ __forceinline__ unsigned long long row_key(int32_t itime, int r) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(itime) ^
                                          0x80000000u) << 32) |
         static_cast<uint32_t>(r);
}

__global__ void grant_fill(unsigned long long* m, int E) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < E) m[static_cast<long long>(blockIdx.y) * E + c] = kEmpty;
}

__global__ void grant_accumulate(const int32_t* out, const int32_t* itime,
                                 const uint8_t* valid, const int32_t* ovc,
                                 const uint8_t* is_eject,
                                 const int32_t* busy, long long busy_ls,
                                 const uint8_t* alive, long long alive_ls,
                                 unsigned long long* m, int N, int E,
                                 int buf_pkts) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const long long b = blockIdx.y;
  const long long i = b * N + r;
  const int32_t o = out[i];
  if (!row_ok(o, E, valid[i], ovc[i], is_eject[i], busy + b * busy_ls,
              alive + b * alive_ls, buf_pkts))
    return;
  atomicMin(&m[b * E + o], row_key(itime[i], r));
}

__global__ void grant_emit(const int32_t* out, const int32_t* itime,
                           const uint8_t* valid, const int32_t* ovc,
                           const uint8_t* is_eject, const int32_t* busy,
                           long long busy_ls, const uint8_t* alive,
                           long long alive_ls, const unsigned long long* m,
                           uint8_t* win, uint8_t* won,
                           unsigned long long* launches, int N, int E,
                           int buf_pkts) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  // the call counted where it runs, so a graph's replays count too
  if (x == 0 && b == 0) atomicAdd(launches, 1ULL);
  const unsigned long long* mb = m + b * E;
  if (x < N) {
    const long long i = b * N + x;
    const int32_t o = out[i];
    const bool ok = row_ok(o, E, valid[i], ovc[i], is_eject[i],
                           busy + b * busy_ls, alive + b * alive_ls,
                           buf_pkts);
    win[i] = ok && mb[o] == row_key(itime[i], x);
  }
  if (x < E) won[b * E + x] = mb[x] != kEmpty;
}

}  // namespace

// Row tensors are [B, N] and channel tensors [B, E], contiguous along the
// last axis; `busy_ls` / `alive_ls` are the channel tensors' lane strides in
// elements (0 when one mask is shared by every lane).  `m` is [B, E] uint64
// scratch.  The emit kernel adds one to `launches` on the device.  Returns
// cudaGetLastError() after the three launches.
extern "C" int netsim_grant(const int32_t* out, const int32_t* itime,
                            const uint8_t* valid, const int32_t* ovc,
                            const uint8_t* is_eject, const int32_t* busy,
                            long long busy_ls, const uint8_t* alive,
                            long long alive_ls, unsigned long long* m,
                            uint8_t* win, uint8_t* won, int B, int N, int E,
                            int buf_pkts, unsigned long long* launches,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const dim3 grid_ch((E + kThreads - 1) / kThreads, B);
  const dim3 grid_row((N + kThreads - 1) / kThreads, B);
  const int X = N > E ? N : E;
  const dim3 grid_emit((X + kThreads - 1) / kThreads, B);
  grant_fill<<<grid_ch, block, 0, s>>>(m, E);
  grant_accumulate<<<grid_row, block, 0, s>>>(out, itime, valid, ovc,
                                              is_eject, busy, busy_ls, alive,
                                              alive_ls, m, N, E, buf_pkts);
  grant_emit<<<grid_emit, block, 0, s>>>(out, itime, valid, ovc, is_eject,
                                         busy, busy_ls, alive, alive_ls, m,
                                         win, won, launches, N, E, buf_pkts);
  return static_cast<int>(cudaGetLastError());
}
