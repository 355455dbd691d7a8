// Age-based grant of the simulator's oracle cycle step as ONE launch for
// Hopper (sm_90a): the skeleton in arbiter.cuh (a persistent cooperative
// launch, the per-channel minimum in L2, one grid barrier), shared with
// cycle_core_coop.cu.
//
// Replaces the TPU kernel `_kernel` (src/repro/kernels/netsim/kernel.py:62),
// reached by `grant_pallas` (:131), as the three-pass `grant.cu` did; every
// grant call runs this kernel (`ops.kernel_for`).  Same function, bit for
// bit: one winner per channel, oldest itime first, the smallest row among
// the ties, as `ref.grant_ref` (key = ((itime ^ 2^31) << 32) | row under a
// minimum).
//
// Bound on this card: bytes.  At the paper's radix-16 network (4 lanes,
// N = 204,672 rows, E = 30,176 channels) a call reads 14 bytes a row (out,
// itime, valid, ovc_count, is_eject) and 5 a channel (busy, alive) and
// writes 1 a row and 1 a channel: 12.9 MB, 3.85 us at 3.35 TB/s.  The
// three-pass kernel paid three launches and evaluated each row's
// eligibility twice, each time with random gathers of busy[out] and
// alive[out].  Here: one launch; each row read once; a row's eligibility
// is only its own (valid, credit or eject); the channel's (not busy,
// alive) is read once per channel and applied after the reduction, which
// is the same grant: a masked channel's rows only lower its entry, and it
// grants nothing.  The key's low word is the row, so the channels write
// win and no row is read again.
#include "arbiter.cuh"

namespace {

struct grant_rows {
  const int32_t* out;
  const int32_t* itime;
  const uint8_t* valid;
  const int32_t* ovc;
  const uint8_t* is_eject;
  const int32_t* busy;
  long long busy_ls;
  const uint8_t* alive;
  long long alive_ls;
  int buf_pkts;
  int N;

  // both loads issued before either is used (no short circuit)
  __device__ __forceinline__ bool chan_ok(long long b, int c) const {
    const int32_t bz = busy[b * busy_ls + c];
    const uint8_t al = alive[b * alive_ls + c];
    return (bz == 0) & (al != 0);
  }

  __device__ __forceinline__ void decode(int4 a, int4 t, int4 v, uint32_t va,
                                         uint32_t ej, int r0, int E,
                                         int32_t o[4],
                                         unsigned long long k[4]) const {
    const int32_t oo[4] = {a.x, a.y, a.z, a.w};
    const int32_t tt[4] = {t.x, t.y, t.z, t.w};
    const int32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool eligible =
          ((va >> (8 * i)) & 0xffu) != 0 &&
          (vv[i] < buf_pkts || ((ej >> (8 * i)) & 0xffu) != 0);
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
      decode(ld4(out + i0), ld4(itime + i0), ld4(ovc + i0),
             __ldg(reinterpret_cast<const unsigned int*>(valid + i0)),
             __ldg(reinterpret_cast<const unsigned int*>(is_eject + i0)), r0,
             E, o, k);
      return;
    }
    int32_t oo[4], tt[4], vv[4];
    uint32_t va = 0, ej = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      oo[i] = -1, tt[i] = 0, vv[i] = 0;
      if (r0 + i < N_) {
        oo[i] = out[i0 + i];
        tt[i] = itime[i0 + i];
        vv[i] = ovc[i0 + i];
        va |= static_cast<uint32_t>(valid[i0 + i] != 0) << (8 * i);
        ej |= static_cast<uint32_t>(is_eject[i0 + i] != 0) << (8 * i);
      }
    }
    decode(make_int4(oo[0], oo[1], oo[2], oo[3]),
           make_int4(tt[0], tt[1], tt[2], tt[3]),
           make_int4(vv[0], vv[1], vv[2], vv[3]), va, ej, r0, E, o, k);
  }

};

bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

grant_rows make_rows(const int32_t* out, const int32_t* itime,
                     const uint8_t* valid, const int32_t* ovc,
                     const uint8_t* is_eject, const int32_t* busy,
                     long long busy_ls, const uint8_t* alive,
                     long long alive_ls, int N, int buf_pkts,
                     const uint8_t* win, bool* vec) {
  *vec = N % 4 == 0 && aligned(out, 16) && aligned(itime, 16) &&
         aligned(ovc, 16) && aligned(valid, 4) && aligned(is_eject, 4) &&
         aligned(win, 4);
  return grant_rows{out,     itime, valid,    ovc,      is_eject, busy,
                    busy_ls, alive, alive_ls, buf_pkts, N};
}

}  // namespace

// Row tensors are [B, N] and channel tensors [B, E], contiguous along the
// last axis; `busy_ls` / `alive_ls` are the channel tensors' lane strides in
// elements (0 when one is shared by every lane).  `scratch` is [2, B, E]
// uint64 set to ~0, then two uint64 set to 0, kept from call to call
// (arbiter.cuh).  The kernel adds one to `launches` on the device.
// Returns the launch's CUDA error.
extern "C" int netsim_grant_coop(const int32_t* out, const int32_t* itime,
                                 const uint8_t* valid, const int32_t* ovc,
                                 const uint8_t* is_eject, const int32_t* busy,
                                 long long busy_ls, const uint8_t* alive,
                                 long long alive_ls,
                                 unsigned long long* scratch, uint8_t* win,
                                 uint8_t* won, int B, int N, int E,
                                 int buf_pkts, unsigned long long* launches,
                                 void* stream) {
  bool vec = false;
  const grant_rows rows = make_rows(out, itime, valid, ovc, is_eject, busy,
                                    busy_ls, alive, alive_ls, N, buf_pkts,
                                    win, &vec);
  return launch_one(rows, vec, scratch, win, won, nullptr, launches, B, N,
                    E, static_cast<cudaStream_t>(stream));
}

#ifdef NETSIM_PHASES
extern "C" int netsim_grant_phase_read(unsigned long long* out) {
  return read_phase_times(out);
}
#endif
