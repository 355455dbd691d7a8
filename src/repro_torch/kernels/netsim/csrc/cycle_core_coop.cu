// Arbitration core of the simulator's fused cycle step as ONE launch for
// Hopper (sm_90a): the skeleton in arbiter.cuh (a persistent cooperative
// launch, the per-channel minimum in L2, one grid barrier), for the
// row-index priority (`prio` None).
//
// Replaces the TPU kernel `_cycle_kernel` (src/repro/kernels/netsim/
// kernel.py:147), reached by `cycle_core_pallas` (:205), as the three-pass
// `cycle_core.cu` did; that kernel stays for explicit priorities (the
// compact step, where it measured faster; `ops.kernel_for`).  Same function, bit for bit: the minimum over the ok
// rows of key = ((itime ^ 2^31) << 32) | row, the channel mask applied
// after the reduction, won / wprio / win as `ref.cycle_core_ref`.
//
// Bound on this card: bytes (a few integer operations a row).  The fused
// step at the paper's radix-16 network (4 lanes, N = 204,672 rows, E =
// 30,176 channels) reads 9 bytes a row and 1 a channel and writes 1 a row
// and 5 a channel: 8.9 MB, 2.66 us at 3.35 TB/s.  The three-pass kernel
// paid three launches (fill, accumulate, emit) and read every row twice.
// Here: one launch, no fill (the next call's half of the table is set in
// this one), each row read once: the key's low word is the row, so the
// channels write win.
#include "arbiter.cuh"

namespace {

struct cycle_core_rows {
  const int32_t* out;
  const int32_t* itime;
  const uint8_t* ok;
  const uint8_t* ch_ok;
  long long ch_ok_ls;
  int N;

  __device__ __forceinline__ bool chan_ok(long long b, int c) const {
    return ch_ok[b * ch_ok_ls + c] != 0;
  }

  __device__ __forceinline__ void decode(int4 a, int4 t, uint32_t e, int r0,
                                         int E, int32_t o[4],
                                         unsigned long long k[4]) const {
    const int32_t oo[4] = {a.x, a.y, a.z, a.w};
    const int32_t tt[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool eligible = ((e >> (8 * i)) & 0xffu) != 0;
      o[i] = eligible && oo[i] >= 0 && oo[i] < E ? oo[i] : -1;
      k[i] = row_key(tt[i], static_cast<uint32_t>(r0 + i));
    }
  }

  template <bool kVec>
  __device__ __forceinline__ void load4(long long b, int q, int N_, int E,
                                        int32_t o[4],
                                        unsigned long long k[4]) const {
    const int r0 = 4 * q;
    const long long i0 = b * N_ + r0;
    if (kVec) {
      decode(ld4(out + i0), ld4(itime + i0),
             __ldg(reinterpret_cast<const unsigned int*>(ok + i0)), r0, E, o,
             k);
      return;
    }
    int32_t oo[4], tt[4];
    uint32_t e = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oo[i] = -1, tt[i] = 0;
      if (r0 + i < N_) {
        oo[i] = out[i0 + i];
        tt[i] = itime[i0 + i];
        e |= static_cast<uint32_t>(ok[i0 + i] != 0) << (8 * i);
      }
    }
    decode(make_int4(oo[0], oo[1], oo[2], oo[3]),
           make_int4(tt[0], tt[1], tt[2], tt[3]), e, r0, E, o, k);
  }

};

bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

cycle_core_rows make_rows(const int32_t* out, const int32_t* itime,
                          const uint8_t* ok, const uint8_t* ch_ok,
                          long long ch_ok_ls, int N, const uint8_t* win,
                          bool* vec) {
  *vec = N % 4 == 0 && aligned(out, 16) && aligned(itime, 16) &&
         aligned(ok, 4) && aligned(win, 4);
  return cycle_core_rows{out, itime, ok, ch_ok, ch_ok_ls, N};
}

}  // namespace

// Row tensors are [B, N] and channel tensors [B, E], contiguous along the
// last axis; `ch_ok_ls` is the mask's lane stride in elements (0 when one
// mask is shared by every lane).  The priority is the row index.
// `scratch` is [2, B, E] uint64 set to ~0, then two uint64 set to 0, kept
// from call to call (arbiter.cuh).  The kernel adds one to `launches` on
// the device.  Returns the launch's CUDA error.
extern "C" int netsim_cycle_core_coop(const int32_t* out,
                                      const int32_t* itime, const uint8_t* ok,
                                      const uint8_t* ch_ok, long long ch_ok_ls,
                                      unsigned long long* scratch,
                                      uint8_t* win, uint8_t* won,
                                      int32_t* wprio, int B, int N, int E,
                                      unsigned long long* launches,
                                      void* stream) {
  bool vec = false;
  const cycle_core_rows rows =
      make_rows(out, itime, ok, ch_ok, ch_ok_ls, N, win, &vec);
  return launch_one(rows, vec, scratch, win, won, wprio, launches, B, N, E,
                    static_cast<cudaStream_t>(stream));
}

#ifdef NETSIM_PHASES
extern "C" int netsim_cycle_core_phase_read(unsigned long long* out) {
  return read_phase_times(out);
}
#endif
