// Mamba-2 SSD (state-space duality) scan for bf16 x, B and C on Hopper's
// tensor cores (sm_90a): wgmma products fed by TMA, the fp32 state held in
// registers as a wgmma accumulator from the first chunk to the last.
//
// Replaces the TPU kernel `_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/kernel.py (:20, :68; the pl.pallas_call at
// :76) for bf16 x/B/C at head dims P = 16, 32, 64 and a state width N that
// is a multiple of 16 up to 256; fp32 goes to the FMA kernel in
// ssd_scan.cu (ops.kernel_for).  It computes the recurrence
//
//   s_t = exp(-A_h dt_t) s_{t-1} + dt_t x_t B_t^T,   y_t = s_t C_t,
//
// per (batch b, head h), s a [P, N] fp32 state from zero, in chunks of
// L = 64 steps walked in order.  With cum_i = sum_{k<=i} -A dt_k over the
// chunk and L its last step:
//
//   W_ij  = (C_i . B_j) exp(cum_i - cum_j) dt_j        (j <= i, else 0)
//   y_i   = exp(cum_i) C_i . S_in + sum_j W_ij x_j
//   S_out = exp(cum_L) S_in + sum_j v_j B_j^T,  v_j = exp(cum_L - cum_j) dt_j x_j
//
// `ref.ssd_chunk_ref` is this decomposition in plain PyTorch with the
// kernel's roundings; `ref.ssd_ref`, the sequential recurrence, is what
// the kernel is held to.
//
// Bound on the H100.  At the mamba2-780m prefill (B 4, S 2,048, H 48,
// P 64, N 128) the function reads x, dt, B, C once and writes y and the
// state once: ~113 MB, 33.65 us at 3.35 TB/s; its products take 22.87 us
// at 989 TFLOP/s.  Bytes bound it.  The FMA kernel (ssd_scan.cu) runs
// every product on the fp32 units out of shared memory, at 39x the bound;
// here they run on the tensor cores.  This kernel issues ~5.4e10 operations a call (the
// full 64 x 64 C B^T and W x, the split products twice), ~55 us at the
// tensor cores' peak.  What bounds it in practice is the latency of one
// (batch, head)'s walk over its 32 chunks: 192 walks, one or two an SM,
// each chunk a chain of dependent steps (PERF.md has the measured times).
//
// Design (the "P split" form: no scratch in device memory).
// - One block, one warpgroup, a (batch, head).  Warp w owns state rows
//   p = 16 w .. 16 w + 15, which stay in its registers: the state is the
//   accumulator of the wgmma S += v^T B (M = p, N = n, K = the chunk's
//   steps), chunk after chunk.  A state row evolves alone, so no state is
//   exchanged and nothing is written to device memory but y and the final
//   state.  The rejected alternative, chunk states in parallel with a scan
//   between them, writes [B, S / L, H, P, N] fp32 three times and reads it
//   twice: ~400 MB at L = 128, 3.6x the whole bound.  P < 64 runs the same
//   64 rows with the x columns past P loaded as zeros.
// - The heads of a batch do not share a block: each block reads B and C
//   (1 MB at the served shape) through L2, 201 MB over the 192 blocks.
//   Two blocks fit an SM (95 KB of shared memory each at N 128), so all
//   192 are resident at once.
// - TMA loads x, B and C of the next chunk into the other of two stages
//   while this chunk computes (one thread issues them under the chunk's
//   first products; an mbarrier a stage counts the bytes in), as 64-row
//   boxes of 128 bytes in the 128-byte swizzle that wgmma's descriptors
//   read; 64 threads load its dt (strided by H) with plain loads, stored
//   to shared memory at the chunk's end.
//   The tensor maps take x [B, S, H, P] and B, C [B, S, N] in place through
//   their strides (unit stride in P and N, the rest multiples of 16 bytes):
//   the views of the conv output that `models/ssm.py` passes need no copy.
//   Rows past S, x columns past P and B, C columns past N arrive as zeros
//   (dt = 0 is the identity transition), and y past S is not written;
//   nothing is padded.  N runs in widths of 64 (NP, the template
//   parameter: 64, 128 or 256; at 256 ptxas spills a little, and no served
//   model has N above 128).
// - Each chunk, after a block barrier:
//   1. each warp scans the 64 log-decays itself (shuffles) into its own
//      cum, exp(cum), exp(cum_L - cum) dt and W's decay factors;
//   2. issued together and waited for: C B^T (M = i, N = j, K = n; both
//      operands K-major in shared memory) and y^T = S_in C^T (M = p, N = i,
//      K = n; S_in from the state registers, since a wgmma accumulator is
//      laid out as wgmma's register A operand, with C as the K-major B
//      operand);
//   3. the state update S = exp(cum_L) S + v^T B is issued (A: v from
//      ldmatrix.trans of x, scaled; B: the B tile MN-major, through
//      wgmma's transpose bit), and while it runs W is formed from C B^T
//      in bf16 into shared memory and y^T's columns i are scaled by
//      exp(cum_i).  W's decay exp(cum_i - cum_j) is masked before any
//      exponential (j > i is zero) and, left of a warp's diagonal 16 x 16
//      block, taken as exp(cum_i - cum_r) exp(cum_r - cum_j) about the
//      warp's first row r: both factors are at most 1 and come from the
//      scan, so only the diagonal block takes exponentials here (more of
//      them here measurably slowed the products in flight);
//   4. a block barrier (W complete), then y^T += x^T W^T (A: the x
//      fragments, B: W K-major); y^T is stored through shared memory
//      (stmatrix.trans), 16 bytes a store.
//   Two block barriers a chunk, 32 chunks at S = 2,048.
// - One device kernel a call.
//
// Roundings (held on the CPU by ref.ssd_chunk_ref at S 2,048, P 64, N 128,
// where one bf16 operand for v gave 2.8e-3 on the state against the 1e-4
// bar).  Products are bf16 x bf16 with fp32 accumulation; x, B and C are
// exact bf16 inputs.  W is rounded to bf16 once.  S_in (fp32) and v (fp32:
// the decay weight times x; the weight sits on x's side so that B enters
// exact) each enter as a bf16 high part plus a bf16 low part, t = hi + lo
// to ~2^-16 relative, in two products into one fp32 accumulator.  cum and
// every sum are fp32; the exponentials are the fast ones (__expf, relative
// error ~1e-6 at the arguments that matter, far below both bars).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;              // steps per chunk
constexpr int kThreads = 128;       // one warpgroup
constexpr int kBox = kL * 128;      // one 64-row x 128-byte swizzled box
constexpr int kEncodeError = 10000;  // + CUresult: a tensor map failed

template <int NP>
struct Cfg {
  static constexpr int kBoxes = NP / 64;
  // one stage: x [kL][64], B and C [kBoxes][kL][64] bf16, dt [kL] fp32
  // (in a 1 KB slot), every tile 1 KB aligned
  static constexpr int kB = kBox;
  static constexpr int kC = kB + kBoxes * kBox;
  static constexpr int kDt = kC + kBoxes * kBox;
  static constexpr int kStage = kDt + 1024;
  // two stages, W [kL][64] bf16 (also y's staging), per warp four arrays
  // of kL fp32 (cum, exp(cum), the state weights, W's factors), two
  // mbarriers; + 1 KB to align the base to 1 KB
  static constexpr int kW = 2 * kStage;
  static constexpr int kWarpArrays = kW + kBox;
  static constexpr int kBars = kWarpArrays + 4 * 4 * kL * 4;
  static constexpr int kSmem = 1024 + kBars + 16;
  static constexpr uint32_t kTxBytes = kDt;   // the TMA boxes of a stage
  // boxes of S_in whose y^T products are in flight together (their hi/lo
  // operands stay in registers until they complete): all at N <= 128, one
  // at a time above, where the state itself takes 128 registers
  static constexpr int kBatch = kBoxes <= 2 ? kBoxes : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `c` (0..7) of row `r` in a 128-byte-swizzled
// box: the piece index is XORed with the row's place in its 8-row group.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `phase` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D / 4-D tensor map into shared memory, completing on
// `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Make this thread's st.shared writes visible to the tensor cores' reads
// (the async proxy); a barrier then covers the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Store four 8 x 8 bf16 matrices transposed: lanes 8m .. 8m + 7 give the
// addresses of the rows of matrix m as stored (the columns of the
// fragment), 16 bytes each.
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr,
                                              const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1 KB aligned apart from the k offset), `lbo` and `sbo` in bytes.
// K-major operands step 8 rows by sbo = 1 KB and ignore lbo; an MN-major
// operand steps 8 rows of K by sbo and the next 64 columns by lbo.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K step ks (16 columns) of a K-major tile of 64-row boxes, 64 columns each.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return gmma_desc(tile + (ks / 4) * kBox + 32 * (ks % 4), 16, 1024);
}

// K step ks (16 rows) of an MN-major box (64 rows of K, 64 columns of N).
__device__ __forceinline__ uint64_t desc_mn(uint32_t box, int ks) {
  return gmma_desc(box + ks * 16 * 128, kBox, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across its issue and its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator operands of an m64n64 wgmma: 32 fp32 registers a thread.
// Register r holds row 16 warp + lane / 4 + 8 ((r / 2) % 2) and column
// 8 (r / 4) + 2 (lane % 4) + r % 2 of the warpgroup's 64 x 64 tile.
#define SSD_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SSD_D32 SSD_D8(0), SSD_D8(8), SSD_D8(16), SSD_D8(24)
#define SSD_REGS32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"

// D[64, 64] (+)= A[64, 16] . B[16, 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SSD_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SSD_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 64] += A[64, 16] . B[16, 64], A in registers (the layout of an
// accumulator's 16 columns, packed in pairs), B in shared memory: K-major
// (kTrans 0) or MN-major (kTrans 1, wgmma's transpose bit).
template <int kTrans>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" SSD_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SSD_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTrans));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// (v0, v1) as a bf16 high pair and a bf16 low pair: v ~ hi + lo.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// grid (H, B); block kThreads.
template <int NP>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tc,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          __nv_bfloat16* __restrict__ y,
                          float* __restrict__ state, int S, int H, int P,
                          int N) {
  using C = Cfg<NP>;
  constexpr int kBoxes = C::kBoxes, kBatch = C::kBatch;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // tiles 1 KB aligned, as the swizzle's period needs
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const uint32_t base = smem_u32(smem);
  const uint32_t w_tile = base + C::kW;
  const uint32_t full = base + C::kBars;   // + 8 stage: chunk's bytes in

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int p0 = 16 * warp;
  float* cum = reinterpret_cast<float*>(smem + C::kWarpArrays) + 4 * kL * warp;
  float* ecum = cum + kL;   // exp(cum_i)
  float* wst = ecum + kL;   // exp(cum_L - cum_j) dt_j
  // W's factors about this warp's first row r = p0: exp(cum_r - cum_j) dt_j
  // for j < r, exp(cum_i - cum_r) for i >= r; both at most 1
  float* wfac = wst + kL;
  const float a_h = A[h];

  // x, B and C of the chunk at t0 into stage st, by one thread
  auto load = [&](int st, int t0) {
    const uint32_t xs = base + st * C::kStage, bar = full + 8 * st;
    mbar_expect_tx(bar, C::kTxBytes);
    tma_load4(xs, &tx, bar, 0, h, t0, b);
#pragma unroll
    for (int bx = 0; bx < kBoxes; ++bx) {
      tma_load3(xs + C::kB + bx * kBox, &tb, bar, 64 * bx, t0, b);
      tma_load3(xs + C::kC + bx * kBox, &tc, bar, 64 * bx, t0, b);
    }
  };
  // dt of the chunk at t0, step tid (threads below kL), 0 past S
  auto load_dt = [&](int t0) {
    const int t = t0 + tid;
    return tid < kL && t < S ? dt[(static_cast<long long>(b) * S + t) * H + h]
                             : 0.f;
  };
  auto dt_slot = [&](int st) {
    return reinterpret_cast<float*>(smem + st * C::kStage + C::kDt);
  };

  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the state, NP / 64 m64n64 accumulators: rows p0 + g (+ 8), columns
  // n = 64 box + 8 (r / 4) + 2 t4 + r % 2
  float s[kBoxes][32];
#pragma unroll
  for (int bx = 0; bx < kBoxes; ++bx)
#pragma unroll
    for (int r = 0; r < 32; ++r) s[bx][r] = 0.f;

  const int nc = (S + kL - 1) / kL;
  if (tid == 0) load(0, 0);
  if (tid < kL) dt_slot(0)[tid] = load_dt(0);
  for (int c = 0; c < nc; ++c) {
    const int st = c & 1, t0 = c * kL;
    mbar_wait(full + 8 * st, (c / 2) & 1);
    __syncthreads();  // chunk c has landed; every warp is done with c - 1
    const float dt_next = load_dt(t0 + kL);   // stored at the chunk's end
    const uint32_t xs = base + st * C::kStage;
    const uint32_t bs = xs + C::kB, cs = xs + C::kC;
    const float* ds = dt_slot(st);

    // -- 1. this warp's copy of the chunk's log-decay scan: lane l holds
    //    steps 2l and 2l + 1
    {
      const float d0 = ds[2 * lane], d1 = ds[2 * lane + 1];
      const float l0 = -a_h * d0, l1 = -a_h * d1;
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      const float c0 = (lane > 0 ? excl : 0.f) + l0, c1 = c0 + l1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      const float cr = __shfl_sync(0xffffffffu, c0, p0 / 2);   // cum_{p0}
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = __expf(c0);
      ecum[2 * lane + 1] = __expf(c1);
      wst[2 * lane] = __expf(last - c0) * d0;
      wst[2 * lane + 1] = __expf(last - c1) * d1;
      wfac[2 * lane] = 2 * lane < p0 ? __expf(cr - c0) * d0 : __expf(c0 - cr);
      wfac[2 * lane + 1] =
          2 * lane + 1 < p0 ? __expf(cr - c1) * d1 : __expf(c1 - cr);
      __syncwarp();
    }

    // -- 2. C B^T (M = i, N = j) and y^T = S_in C^T (M = p, N = i), S_in as
    //    hi + lo straight from the state registers, 16 columns n a step,
    //    kBatch boxes of n in flight at a time
    float cbt[32], yt[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) cbt[r] = yt[r] = 0.f;
#pragma unroll
    for (int b0 = 0; b0 < kBoxes; b0 += kBatch) {
      uint32_t hi[kBatch * 4][4], lo[kBatch * 4][4];
#pragma unroll
      for (int k = 0; k < kBatch * 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(s[b0 + k / 4][8 * (k % 4) + 2 * e],
                s[b0 + k / 4][8 * (k % 4) + 2 * e + 1], hi[k][e], lo[k][e]);
      wgmma_fence();
      if (b0 == 0) {
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks)
          wgmma_ss(cbt, desc_k(cs, ks), desc_k(bs, ks), ks > 0);
      }
#pragma unroll
      for (int k = 0; k < kBatch * 4; ++k) {
        wgmma_rs<0>(yt, lo[k], desc_k(cs, 4 * b0 + k));
        wgmma_rs<0>(yt, hi[k], desc_k(cs, 4 * b0 + k));
      }
      wgmma_commit();
      // the next chunk's loads, issued while the products run (stage
      // st ^ 1 is free: every warp is past chunk c - 1)
      if (b0 == 0 && tid == 0 && c + 1 < nc) load(st ^ 1, t0 + kL);
      wgmma_wait0();
      reg_fence(cbt);
      reg_fence(yt);
      reg_fence(hi);
      reg_fence(lo);
    }

    // -- 3. the state, S = exp(cum_L) S + v^T B over the chunk's steps j,
    //    v = x exp(cum_L - cum_j) dt_j as hi + lo, issued; while it runs,
    //    W and y^T's scaling
    uint32_t xf[4][4];
    {
      uint32_t vh[4][4], vl[4][4];
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        // x^T rows p0 .. p0 + 15, steps 16 kj .. 16 kj + 15
        const int j = 16 * kj + lane % 8 + 8 * (lane / 16);
        ldsm_x4_trans(xf[kj], xs + swz(j, 2 * warp + (lane / 8) % 2));
        const int jj = 16 * kj + 2 * t4;
        const float w0 = wst[jj], w1 = wst[jj + 1], w2 = wst[jj + 8],
                    w3 = wst[jj + 9];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack(xf[kj][e]);
          const bool upper = e >= 2;   // steps jj + 8, jj + 9
          split(f.x * (upper ? w2 : w0), f.y * (upper ? w3 : w1), vh[kj][e],
                vl[kj][e]);
        }
      }
      const float decay = ecum[kL - 1];
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx)
#pragma unroll
        for (int r = 0; r < 32; ++r) s[bx][r] *= decay;
      wgmma_fence();
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx)
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          wgmma_rs<1>(s[bx], vl[kj], desc_mn(bs + bx * kBox, kj));
          wgmma_rs<1>(s[bx], vh[kj], desc_mn(bs + bx * kBox, kj));
        }
      wgmma_commit();

      // W_ij for this warp's rows i = p0 + g (+ 8), columns
      // j = 8 q + 2 t4 (+ 1), into the W tile (rows i, K-major for step 4).
      // Left of the warp's diagonal block (j < p0 <= i) the decay factors
      // about r = p0, exp(cum_i - cum_j) = exp(cum_i - cum_r) exp(cum_r -
      // cum_j), both at most 1, so nothing overflows and no exponential is
      // taken here; in the diagonal block, directly; above it, zero
      const float ci0 = cum[p0 + g], ci1 = cum[p0 + g + 8];
      const float ei0 = wfac[p0 + g], ei1 = wfac[p0 + g + 8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = 8 * q + 2 * t4;
        uint32_t w[2] = {0u, 0u};
        if (q < 2 * warp) {
          const float f0 = wfac[j], f1 = wfac[j + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float ei = half ? ei1 : ei0;
            w[half] = pack_bf16(cbt[4 * q + 2 * half] * ei * f0,
                                cbt[4 * q + 2 * half + 1] * ei * f1);
          }
        } else if (q <= 2 * warp + 1) {
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float dj0 = ds[j], dj1 = ds[j + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = p0 + g + 8 * half;
            const float ci = half ? ci1 : ci0;
            const float w0 =
                j <= i ? cbt[4 * q + 2 * half] * __expf(ci - cj0) * dj0 : 0.f;
            const float w1 = j + 1 <= i ? cbt[4 * q + 2 * half + 1] *
                                              __expf(ci - cj1) * dj1
                                        : 0.f;
            w[half] = pack_bf16(w0, w1);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(smem + C::kW +
                                       swz(p0 + g + 8 * half, q) + 4 * t4) =
              w[half];
      }
      fence_proxy_async();
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int i = 8 * (r / 4) + 2 * t4;
        yt[r] *= ecum[i];
        yt[r + 1] *= ecum[i + 1];
      }
      __syncthreads();  // W is complete

      // -- 4. y^T += x^T W^T over the chunk's steps j
      wgmma_fence();
#pragma unroll
      for (int kj = 0; kj < 4; ++kj)
        wgmma_rs<0>(yt, xf[kj], desc_k(w_tile, kj));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(yt);
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx) reg_fence(s[bx]);
      reg_fence(xf);
      reg_fence(vh);
      reg_fence(vl);
    }

    // y [b, t0 + i, h, p]: y^T in bf16 through the W tile (free again:
    // the products that read it are done), transposed by stmatrix into
    // rows i of 64 p, then 16 bytes a store; rows past S and columns past
    // P are not written
#pragma unroll
    for (int sm = 0; sm < 4; ++sm) {
      const uint32_t f[4] = {pack_bf16(yt[8 * sm], yt[8 * sm + 1]),
                             pack_bf16(yt[8 * sm + 2], yt[8 * sm + 3]),
                             pack_bf16(yt[8 * sm + 4], yt[8 * sm + 5]),
                             pack_bf16(yt[8 * sm + 6], yt[8 * sm + 7])};
      const int m = lane / 8;
      const int i = 8 * (2 * sm + m / 2) + lane % 8;
      stsm_x4_trans(w_tile + swz(i, 2 * warp + m % 2), f);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k, i = e / 2, ch = 2 * warp + e % 2;
      const int t = t0 + i;
      if (t < S && 8 * ch < P) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(smem + C::kW + swz(i, ch));
        *reinterpret_cast<uint4*>(
            y + ((static_cast<long long>(b) * S + t) * H + h) * P + 8 * ch) = v;
      }
    }
    if (tid < kL) dt_slot(st ^ 1)[tid] = dt_next;
  }

  // the final state [B, H, P, N]; rows past P and columns past N are not
  // written
#pragma unroll
  for (int bx = 0; bx < kBoxes; ++bx)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int p = p0 + g + 8 * ((r / 2) % 2);
      const int n = 64 * bx + 8 * (r / 4) + 2 * t4;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(
            state + ((static_cast<long long>(b) * H + h) * P + p) * N + n) =
            make_float2(s[bx][r], s[bx][r + 1]);
    }
}

#undef SSD_D8
#undef SSD_D32
#undef SSD_REGS32

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// links against nothing but the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a `rank`-D tensor (dims and byte strides innermost first) in
// boxes of `box`; reads out of bounds fill with zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  CUtensorMapDataType type, int rank, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The byte stride of a dimension, or `other` when its extent is 1: such a
// dimension is never stepped, and its stride may be anything in a view.
cuuint64_t stride_or(long long bytes, long long extent, cuuint64_t other) {
  return extent > 1 ? static_cast<cuuint64_t>(bytes) : other;
}

template <int NP>
int launch(const void* x, long long sxb, long long sxs, long long sxh,
           const void* dt, const void* A, const void* Bm, long long sbb,
           long long sbs, const void* Cm, long long scb, long long scs,
           void* y, void* state, int B, int S, int H, int P, int N,
           cudaStream_t stream) {
  using C = Cfg<NP>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // dims and byte strides innermost first
  const cuuint64_t x_head = stride_or(2ll * sxh, H, 2ull * P);
  const cuuint64_t x_row = stride_or(2ll * sxs, S, x_head * H);
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[3] = {x_head, x_row,
                                   stride_or(2ll * sxb, B, x_row * S)};
  const cuuint32_t x_box[4] = {64, 1, kL, 1};
  const cuuint64_t n_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t b_row = stride_or(2ll * sbs, S, 2ull * N);
  const cuuint64_t c_row = stride_or(2ll * scs, S, 2ull * N);
  const cuuint64_t b_strides[2] = {b_row, stride_or(2ll * sbb, B, b_row * S)};
  const cuuint64_t c_strides[2] = {c_row, stride_or(2ll * scb, B, c_row * S)};
  const cuuint32_t n_box[3] = {64, kL, 1};
  CUtensorMap tx, tb, tc;
  CUresult res = make_map(encode, &tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          x_dims, x_strides, x_box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tb, Bm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   n_dims, b_strides, n_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tc, Cm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   n_dims, c_strides, n_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  auto kernel = ssd_scan_wgmma_kernel<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, C::kSmem, stream>>>(
      tx, tb, tc, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 x [B, S, H, P] at element strides (sxb, sxs, sxh, 1), bf16 Bm, Cm
// [B, S, N] at (sbb, sbs, 1) and (scb, scs, 1), fp32 dt [B, S, H] and A [H]
// contiguous; writes bf16 y [B, S, H, P] and the fp32 state [B, H, P, N],
// both contiguous.  P is 16, 32 or 64 and N a multiple of 16 up to 256;
// the strides are multiples of 8 elements and the bases 16-byte aligned.
// Returns 0, a CUDA error code, or kEncodeError plus the driver's CUresult
// when a tensor map cannot be built; the wrapper checks every argument
// first.
extern "C" int ssd_scan_wgmma_fwd(const void* x, long long sxb, long long sxs,
                                  long long sxh, const void* dt,
                                  const void* A, const void* Bm, long long sbb,
                                  long long sbs, const void* Cm, long long scb,
                                  long long scs, void* y, void* state, int B,
                                  int S, int H, int P, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((P != 16 && P != 32 && P != 64) || N <= 0 || N > 256 || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 64)
    return launch<64>(x, sxb, sxs, sxh, dt, A, Bm, sbb, sbs, Cm, scb, scs, y,
                      state, B, S, H, P, N, s);
  if (N <= 128)
    return launch<128>(x, sxb, sxs, sxh, dt, A, Bm, sbb, sbs, Cm, scb, scs, y,
                       state, B, S, H, P, N, s);
  return launch<256>(x, sxb, sxs, sxh, dt, A, Bm, sbb, sbs, Cm, scb, scs, y,
                     state, B, S, H, P, N, s);
}
