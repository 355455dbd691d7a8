// Head-record gathers of the simulator's fused cycle step, written for
// Hopper (sm_90a).
//
// A buffer record is NUM_FUSED_FIELDS = 8 int32 fields: 32 bytes.  The
// step gathers one record a (lane, channel, VC) buffer head, then one a
// channel for the winner of each channel.  aten's `index_select` runs one
// 32-thread block a gathered row, of which 2 threads move data, so its
// time follows the rows and not the bytes (0.60 us a thousand rows on an
// H100).  Here one thread moves one record: two 16-byte loads and two
// 16-byte stores, 256 threads a block over the B x rows records, the
// ragged edge masked.
//
//   dense   head[b, e * NV + v, :] = store[b, e, v, b_head[b, e, v], :]
//           for e < rows_e; the thread computes the record's address from
//           the strides it is given, in 64-bit arithmetic.  Neighbouring
//           threads read records S x 32 bytes apart (one sector each) and
//           write neighbouring records (coalesced); b_head is read
//           coalesced.
//   picked  out[b, c, :] = head[b, clamp(idx[b, c]), :], with the
//           reference's gather rule: a negative index wraps once, then
//           the index is clamped to [0, R - 1].
//
// Both copy a record with `copy_record`.  A slot outside [0, S) (which the
// state never holds) is clamped, so no thread reads outside the store.
// The host checks that records are 32 bytes, contiguous and 16-byte
// aligned (every stride a multiple of 4 fields).  No allocation, no
// synchronisation: one launch on the caller's stream, which a CUDA graph
// captures.  The kernel adds one to `launches` on the device.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 8;

__device__ __forceinline__ void copy_record(const int32_t* __restrict__ src,
                                            int32_t* __restrict__ dst) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  const int4 lo = __ldg(s);
  const int4 hi = __ldg(s + 1);
  d[0] = lo;
  d[1] = hi;
}

__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
}

__global__ void __launch_bounds__(kThreads) head_records_dense(
    const int32_t* __restrict__ store, long long st_b, long long st_e,
    long long st_v, long long st_s, const int32_t* __restrict__ b_head,
    long long hd_b, long long hd_e, long long hd_v, int32_t* __restrict__ head,
    unsigned rows, unsigned NV, int S, unsigned total,
    unsigned long long* __restrict__ launches) {
  count_launch(launches);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned b = i / rows;
  const unsigned r = i - b * rows;
  const unsigned e = r / NV;
  const unsigned v = r - e * NV;
  int s = __ldg(b_head + b * hd_b + e * hd_e + v * hd_v);
  s = min(max(s, 0), S - 1);
  copy_record(store + b * st_b + e * st_e + v * st_v + s * st_s,
              head + static_cast<long long>(i) * kFields);
}

__global__ void __launch_bounds__(kThreads) head_records_picked(
    const int32_t* __restrict__ head, long long hd_b, long long hd_r, int R,
    const int32_t* __restrict__ idx, long long ix_b, long long ix_c,
    int32_t* __restrict__ out, unsigned E, unsigned total,
    unsigned long long* __restrict__ launches) {
  count_launch(launches);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned b = i / E;
  const unsigned c = i - b * E;
  int k = __ldg(idx + b * ix_b + c * ix_c);
  k = min(max(k, -R), R - 1);
  if (k < 0) k += R;
  copy_record(head + b * hd_b + k * hd_r,
              out + static_cast<long long>(i) * kFields);
}

unsigned blocks_for(unsigned total) {
  return (total + kThreads - 1) / kThreads;
}

}  // namespace

// Dense form: head [B, rows_e * NV, 8] (contiguous) from the store
// [B, E', NV, S, 8] and b_head [B, E'', NV], both read through their
// strides in elements (the last of the store's is 1), for e < rows_e.
// `total` = B * rows_e * NV, below 2^31, and above 0.  Returns the
// launch's CUDA error.
extern "C" int netsim_head_records_dense(
    const int32_t* store, long long st_b, long long st_e, long long st_v,
    long long st_s, const int32_t* b_head, long long hd_b, long long hd_e,
    long long hd_v, int32_t* head, int rows_e, int NV, int S, int total,
    unsigned long long* launches, void* stream) {
  const unsigned rows = static_cast<unsigned>(rows_e) * NV;
  head_records_dense<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      store, st_b, st_e, st_v, st_s, b_head, hd_b, hd_e, hd_v, head, rows,
      static_cast<unsigned>(NV), S, static_cast<unsigned>(total), launches);
  return static_cast<int>(cudaGetLastError());
}

// Picked form: out [B, E, 8] (contiguous) from head [B, R, 8] and the int32
// index idx [B, E], both read through their strides in elements.
// `total` = B * E, below 2^31, and above 0.  Returns the launch's CUDA
// error.
extern "C" int netsim_head_records_picked(
    const int32_t* head, long long hd_b, long long hd_r, int R,
    const int32_t* idx, long long ix_b, long long ix_c, int32_t* out, int E,
    int total, unsigned long long* launches, void* stream) {
  head_records_picked<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      head, hd_b, hd_r, R, idx, ix_b, ix_c, out, static_cast<unsigned>(E),
      static_cast<unsigned>(total), launches);
  return static_cast<int>(cudaGetLastError());
}
