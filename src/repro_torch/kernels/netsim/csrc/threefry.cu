// Threefry-2x32 draws of the simulator's PRNG (`repro_torch.random`),
// written for Hopper (sm_90a).
//
// The reference draws every random number from `jax.random`'s default
// generator: Threefry-2x32, 20 rounds, over a flat iota counter, keyed
// per lane (`jax_threefry_partitionable`).  It has no TPU kernel: XLA
// fuses the hash into one loop.  The plain PyTorch version
// (`ref.threefry2x32`) runs each add, shift, or, mask and xor of the 20
// rounds as one int64 kernel, ~170 launches a hash, each at the launch
// floor.  Here one thread computes one output element of one draw in
// uint32 registers (the rotations one `__funnelshift_l` each) and writes
// the draw's final form and dtype:
//
//   split      out[l, j, :] = threefry(key_l, (0, j)) as two int64 words
//   bits       out[l, j] = b1 ^ b2 (int64 holding a uint32)
//   uniform    out[l, j] = float((b1 ^ b2) >> 9 | 0x3F800000) - 1 (fp32)
//   bernoulli  out[l, j] = uniform < p (bool)
//   randint    the two subkeys split(key_l) recomputed in registers, a
//              `higher` and a `lower` draw, and the reference's
//              multiply-and-remainder onto [minval, minval + span) (int32)
//
// with (hi, lo) = (0, j) the counter of element j of the lane's draw, as
// `iota_2x32_shape` gives it for fewer than 2^32 elements.  A thread
// reads its lane's two key words through the key's strides in elements,
// so a strided view of a `split` output is read in place.  The work is
// ~80 int32 operations a hash, ~330 an element of `randint`; at the
// benchmark's 24 lanes x 5,248 terminals a launch is bound by neither
// bytes nor operations but by its own launch.  No allocation, no
// synchronisation: one launch on the caller's stream, which a CUDA graph
// captures.  The kernel adds one to `launches` on the device.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

enum Form { kSplit = 0, kBits = 1, kUniform = 2, kRandint = 3,
            kBernoulli = 4 };

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Threefry-2x32, 20 rounds: the key schedule and rotations of
// `ref.threefry2x32`, with the key injection after every four rounds.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// 32 random bits of element j under the key (k0, k1)
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t j) {
  const uint2 w = threefry2x32(k0, k1, 0u, j);
  return w.x ^ w.y;
}

template <int F>
__global__ void __launch_bounds__(kThreads) threefry_draw(
    const long long* __restrict__ key, long long ks_lane, long long ks_word,
    unsigned n, unsigned total, void* __restrict__ out, unsigned span,
    unsigned mult, unsigned minval, float p,
    unsigned long long* __restrict__ launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned lane = i / n;
  const unsigned j = i - lane * n;
  const long long* kp = key + static_cast<long long>(lane) * ks_lane;
  // the words are uint32 values held in int64: their low halves
  const uint32_t k0 = static_cast<uint32_t>(__ldg(kp));
  const uint32_t k1 = static_cast<uint32_t>(__ldg(kp + ks_word));
  if constexpr (F == kSplit) {
    const uint2 w = threefry2x32(k0, k1, 0u, j);
    reinterpret_cast<longlong2*>(out)[i] =
        make_longlong2(static_cast<long long>(w.x),
                       static_cast<long long>(w.y));
  } else if constexpr (F == kBits) {
    static_cast<long long*>(out)[i] = static_cast<long long>(bits(k0, k1, j));
  } else if constexpr (F == kUniform || F == kBernoulli) {
    const float u = __uint_as_float((bits(k0, k1, j) >> 9) | 0x3F800000u)
                    - 1.0f;
    if constexpr (F == kUniform) {
      static_cast<float*>(out)[i] = u;
    } else {
      static_cast<bool*>(out)[i] = u < p;
    }
  } else {
    // split(key) into the `higher` and `lower` subkeys, then one draw each
    const uint2 s0 = threefry2x32(k0, k1, 0u, 0u);
    const uint2 s1 = threefry2x32(k0, k1, 0u, 1u);
    const uint32_t higher = bits(s0.x, s0.y, j);
    const uint32_t lower = bits(s1.x, s1.y, j);
    // all modulo 2^32, as the reference's uint32 arithmetic
    const uint32_t off = ((higher % span) * mult + lower % span) % span;
    static_cast<int32_t*>(out)[i] = static_cast<int32_t>(off + minval);
  }
}

}  // namespace

// One draw of `form` (0 split, 1 bits, 2 uniform, 3 randint, 4 bernoulli)
// over `total` = lanes x n elements (below 2^31, above 0): lane l's key
// words at key[l * ks_lane] and key[l * ks_lane + ks_word] (int64
// elements), n elements a lane, into the contiguous `out` of the form's
// dtype.  `span` (>= 1), `mult` and `minval` (as uint32) are randint's,
// `p` bernoulli's; the other forms ignore them.  Returns the launch's
// CUDA error.
extern "C" int netsim_threefry(int form, const long long* key,
                               long long ks_lane, long long ks_word, int n,
                               int total, void* out, unsigned span,
                               unsigned mult, unsigned minval, float p,
                               unsigned long long* launches, void* stream) {
  const unsigned blocks = (static_cast<unsigned>(total) + kThreads - 1)
                          / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned un = static_cast<unsigned>(n);
  const unsigned ut = static_cast<unsigned>(total);
  switch (form) {
    case kSplit:
      threefry_draw<kSplit><<<blocks, kThreads, 0, s>>>(
          key, ks_lane, ks_word, un, ut, out, span, mult, minval, p,
          launches);
      break;
    case kBits:
      threefry_draw<kBits><<<blocks, kThreads, 0, s>>>(
          key, ks_lane, ks_word, un, ut, out, span, mult, minval, p,
          launches);
      break;
    case kUniform:
      threefry_draw<kUniform><<<blocks, kThreads, 0, s>>>(
          key, ks_lane, ks_word, un, ut, out, span, mult, minval, p,
          launches);
      break;
    case kRandint:
      threefry_draw<kRandint><<<blocks, kThreads, 0, s>>>(
          key, ks_lane, ks_word, un, ut, out, span, mult, minval, p,
          launches);
      break;
    case kBernoulli:
      threefry_draw<kBernoulli><<<blocks, kThreads, 0, s>>>(
          key, ks_lane, ks_word, un, ut, out, span, mult, minval, p,
          launches);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
