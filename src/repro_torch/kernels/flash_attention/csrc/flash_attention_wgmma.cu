// Causal GQA flash-attention forward with an optional sliding window for
// bf16 inputs, on Hopper's tensor cores (sm_90a): wgmma products fed by
// TMA through a ring of shared-memory stages, one producer warp and two
// consumer warpgroups.
//
// Replaces the TPU kernel `_kernel` (src/repro/kernels/flash_attention/
// kernel.py:25) reached through `flash_attention_pallas` (:96), for bf16
// at head dims 64, 128 and 256; fp32, and bf16 at the other head dims, go
// to the FMA kernel in flash_attention.cu (ops.kernel_for).  It computes
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / groups] * scale)
//                * v[b, j, h / groups],    scale = 1 / sqrt(hd),
//
// over the keys j < Sk and, when causal, j <= i and (with a window)
// j > i - window, as `ref.attention_ref`.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), 4 hd operations per
// (query, key) pair: llama3.2-3b's prefill (B 4, S 2,048, H 24, KV 8,
// hd 128, causal) needs 1.03e11 operations, 104 us, against 40 us for
// its 134 MB; recurrentgemma-2b's local layers (B 4, S 4,096, H 10, KV 1,
// hd 256, window 2,048) need 2.58e11 operations, 261 us, against 47 us
// for 157 MB.  Operations bound both, so the products have to run on the
// tensor cores and the loads have to hide behind them.
//
// Design.
// - A persistent grid, one block an SM.  A block walks work items (128
//   query rows of one (batch, head) and the key tiles they need), in
//   rounds of one item a block, heaviest causal items first and each round
//   walked the other way, so blocks get like shares; the H heads of a
//   query tile run side by side, so the query heads of one KV head share
//   its tiles in L2.  Tiles wholly above the diagonal or wholly outside
//   the window are never loaded.
// - Warp specialisation: threads 0-255 are two consumer warpgroups of 64
//   rows each (wgmma's M); one thread of warp 8 issues every TMA load;
//   `setmaxnreg` moves registers from the producer warpgroup (24) to the
//   consumers (240).
// - TMA reads q [B, Sq, H, hd] and k, v [B, Sk, KV, hd] in place through
//   4-D tensor maps built on the host, in boxes of 64 head-dim columns
//   (128 bytes) by the tile's rows, 128-byte swizzled.  Rows past Sq or Sk
//   come in as zeros: nothing is padded.  K and V cycle through kStages
//   stages, each with full (TMA bytes arrived) and empty (the eight
//   consumer warps are done) mbarriers; K goes back as soon as its S
//   product is done, V after P V, and Q after an item's last S product,
//   so the next item's Q loads under this one's last softmax and output.
//   GQA reads KV head h / (H / KV) with no expansion.
// - S = Q K^T: wgmma m64nBNk16, Q and K both K-major in shared memory.
//   O += P V: P from registers as the A operand, V [keys, hd] MN-major as
//   B, read through wgmma's transpose bit.
// - Inside a warpgroup, tile t's S product is issued with tile t-1's P V
//   queued behind it: the softmax of t runs while P V of t-1 does, and O's
//   rescale while S does.  The two warpgroups interleave freely (taking
//   turns through named barriers measured slower on the H100).
// - The online softmax keeps m, l and O in fp32 registers; scores are in
//   log2 units (exp2).  Only tiles that cross the diagonal, the window's
//   edge or Sk are masked, to -1e30 as the reference; the others scale
//   and subtract the max in one fused multiply-add.  The output is
//   O / max(l, 1e-30), rounded to bf16.
// - The one rounding the reference does not make: P is rounded to bf16 to
//   enter the P V product (the reference keeps it in fp32); l sums the
//   unrounded fp32 P.  The result is held to the reference's bf16 bar,
//   2e-2 relative per output row.
//
// Configurations (hd: query rows x key tile, stages, shared memory;
// registers a consumer thread 240, from ptxas):
// 64: 128 x 128, 2, 81 KB; 128: 128 x 128, 2, 161 KB; 256: 128 x 64, 2,
// 193 KB.
//
// tools/flash_ablation.py times variants of this file that drop one step
// of the softmax; it finds the lines to edit by their exact text (its
// VARIANTS), and tests/test_torch_flash_attention.py checks that each is
// here once.  Edit those lines and the tool's text together.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;       // two consumer warpgroups + producer
constexpr int kBM = 128;            // query rows per block
constexpr int kConsumerWarps = 8;
constexpr float kMasked = -1e30f;   // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 10000;  // + CUresult: a tensor map failed

template <int HD>
struct Cfg {
  static constexpr int kBN = HD == 256 ? 64 : 128;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr int kChunks = HD / 64;           // 128-byte column boxes
  static constexpr uint32_t kQBytes = kBM * HD * 2;
  static constexpr uint32_t kKVBytes = kBN * HD * 2;
  static constexpr uint32_t kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // + 1 KB to align the tiles to the 128-byte swizzle's 1 KB period
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1 KB aligned apart from the k offset): `lbo` and `sbo` in bytes.  K-major
// operands (Q, K) step 8 rows by sbo = 1 KB and ignore lbo; the MN-major V
// steps 8 keys by sbo and the next 64 head-dim columns by lbo.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator operands of one wgmma, N / 2 fp32 registers a thread.
#define FA_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
#define FA_D64 FA_D32, FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
#define FA_D128 \
  FA_D64, FA_D8(64), FA_D8(72), FA_D8(80), FA_D8(88), FA_D8(96), FA_D8(104), \
      FA_D8(112), FA_D8(120)

// D[64, 64] (+)= A[64, 16] . B[16, 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 128] (+)= A[64, 16] . B[16, 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 64] += A[64, 16] . B[16, 64], A in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 128] += A[64, 16] . B[16, 128], A in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64, 256] += A[64, 16] . B[16, 256], A in registers, B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121,"
      "%122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FA_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BN == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    static_assert(BN == 128, "key tile of 64 or 128");
    wgmma_ss_n128(d, da, db, accumulate);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(HD == 256, "head dim 64, 128 or 256");
    wgmma_rs_n256(d, a, db);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Register j of a thread's m64nN fp32 accumulator holds row
// 16 warp + lane / 4 + 8 ((j / 2) % 2) and column 8 (j / 4) + 2 (lane % 4)
// + j % 2 of the warpgroup's 64 x N tile: a thread holds two rows, and the
// four threads of a quad share them.
struct RowState {
  float m[2] = {kMasked, kMasked};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum
};

// Max and sum over a thread's registers of row r (those with
// (j / 2) % 2 == r): value v of the row is register 4 (v / 2) + 2 r + v % 2.
// Four running partials, so that the operations do not wait on each
// other.
template <int BN>
__device__ __forceinline__ float row_max(const float (&x)[BN / 2], int r) {
  float t[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) t[v] = x[4 * (v / 2) + 2 * r + v % 2];
#pragma unroll
  for (int v = 4; v < BN / 4; ++v)
    t[v % 4] = fmaxf(t[v % 4], x[4 * (v / 2) + 2 * r + v % 2]);
  return fmaxf(fmaxf(t[0], t[1]), fmaxf(t[2], t[3]));
}

template <int BN>
__device__ __forceinline__ float row_sum(const float (&x)[BN / 2], int r) {
  float t[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) t[v] = x[4 * (v / 2) + 2 * r + v % 2];
#pragma unroll
  for (int v = 4; v < BN / 4; ++v) t[v % 4] += x[4 * (v / 2) + 2 * r + v % 2];
  return (t[0] + t[1]) + (t[2] + t[3]);
}

// Turn one tile's raw scores into P = exp2(s scale_log2 - m) in place and
// update the rows' max and sums; returns each row's rescale of O in corr.
// Only an `edge` tile is masked (keys past Sk, above the diagonal or
// outside the window), to -1e30 as the reference: there the scores are
// scaled first, so that a masked one is exactly -1e30.  A row with no key
// yet has m = -1e30, so its P is 1 until its first key, whose rescale
// exp2(-1e30 - m) wipes it, as in the reference.
template <int BN>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BN / 2], RowState& st, float (&corr)[2], bool edge, int k0,
    int row0, int col0, int Sk, int causal, int has_window, int window,
    float scale_log2) {
  float m_new[2];
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int kpos = k0 + 8 * (j / 4) + col0 + (j % 2);
      const int qpos = row0 + 8 * ((j / 2) % 2);
      bool ok = kpos < Sk;
      if (causal) {
        ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
      }
      sc[j] = ok ? sc[j] * scale_log2 : kMasked;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      m_new[r] = fmaxf(st.m[r], quad_max(row_max<BN>(sc, r)));
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      sc[j] = fast_exp2(sc[j] - m_new[(j / 2) % 2]);
  } else {
    // rounding is monotone: max(s) scale = max(s scale)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      m_new[r] =
          fmaxf(st.m[r], quad_max(row_max<BN>(sc, r)) * scale_log2);
    // scale and subtract in one fused multiply-add
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      sc[j] = fast_exp2(fmaf(sc[j], scale_log2, -m_new[(j / 2) % 2]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    corr[r] = fast_exp2(st.m[r] - m_new[r]);
    st.m[r] = m_new[r];
    st.l[r] = st.l[r] * corr[r] + row_sum<BN>(sc, r);
  }
}

// P in bf16 as wgmma's A fragments, one per 16 keys: they are the
// accumulator's registers in order, two to a 32-bit register.
template <int BN>
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2)
    pa[j / 8][(j % 8) / 2] = pack_bf16(sc[j], sc[j + 1]);
}

// One work item: 128 query rows of one (batch, head), and its key tiles.
struct Item {
  int h, b, q0, kt_lo, kt_hi;
};

// Items in order of work, heaviest first when causal (the last query
// tiles have the most keys), with a tile's H heads side by side so that
// the query heads of one KV head share its K and V tiles in L2.
template <int BN>
__device__ __forceinline__ Item item_at(int idx, int H, int B, int Sq,
                                        int Sk, int causal, int has_window,
                                        int window) {
  const int n_qt = (Sq + kBM - 1) / kBM;
  Item it;
  it.h = idx % H;
  it.b = (idx / H) % B;
  const int t = idx / (H * B);
  it.q0 = (causal ? n_qt - 1 - t : t) * kBM;
  // the key tiles of the item's rows: none wholly above the diagonal or
  // wholly outside the window
  it.kt_lo = 0;
  it.kt_hi = (Sk + BN - 1) / BN;
  if (causal) {
    it.kt_hi = min(it.kt_hi, (min(it.q0 + kBM, Sq) - 1) / BN + 1);
    if (has_window) it.kt_lo = max(0, it.q0 - window + 1) / BN;
  }
  return it;
}

// The n-th item of a block of a persistent grid of G blocks: rounds of G
// items, walked forwards and backwards in turn, so that every block gets
// a like share of heavy and light items.
__device__ __forceinline__ int item_index(int n) {
  const int G = gridDim.x;
  return n % 2 == 0 ? n * G + blockIdx.x : n * G + (G - 1 - blockIdx.x);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk,
                    int H, int KV, float scale_log2, int causal,
                    int has_window, int window) {
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;              // + stage * kKVBytes
  const uint32_t sV = sK + kStages * C::kKVBytes;   // + stage * kKVBytes
  // barriers, 8 bytes each: Q loaded, Q released; then per stage K
  // loaded, V loaded, K released, V released (at index + 8 stage)
  const uint32_t q_full = sQ + C::kBarOffset, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const int items = (Sq + kBM - 1) / kBM * B * H;
  auto item = [&](int n) {
    return item_at<kBN>(item_index(n), H, B, Sq, Sk, causal, has_window,
                        window);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one thread issues every TMA load of the block, Q of
    // the next item as soon as the consumers' last S product of the
    // current one is done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int i = 0;  // key tiles loaded so far
      for (int n = 0; item_index(n) < items; ++n) {
        const Item it = item(n);
        const int kvh = it.h / (H / KV);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(sQ + c * kBM * 128, &tq, q_full, 64 * c, it.h, it.q0,
                   it.b);
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt, ++i) {
          const int s = i % kStages;
          const uint32_t phase = (i / kStages) & 1;
          mbar_wait(k_empty + 8 * s, phase ^ 1);
          mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load(sK + s * C::kKVBytes + c * kBN * 128, &tk,
                     k_full + 8 * s, 64 * c, kvh, kt * kBN, it.b);
          mbar_wait(v_empty + 8 * s, phase ^ 1);
          mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load(sV + s * C::kKVBytes + c * kBN * 128, &tv,
                     v_full + 8 * s, 64 * c, kvh, kt * kBN, it.b);
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_tile = sQ + 64 * wg * 128;
    int i0 = 0;  // key tiles of the earlier items
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    for (int n = 0; item_index(n) < items; ++n) {
      const Item it = item(n);
      const int r_lo = it.q0 + 64 * wg, r_hi = r_lo + 63;
      const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
      // this warpgroup's own tiles [a, e) of the item's [kt_lo, kt_hi)
      int a = it.kt_lo, e = it.kt_hi;
      if (causal) {
        e = min(e, r_hi / kBN + 1);
        if (has_window) a = max(a, max(0, r_lo - window + 1) / kBN);
      }

      auto stage = [&](int kt) { return (i0 + kt - it.kt_lo) % kStages; };
      auto phase = [&](int kt) {
        return static_cast<uint32_t>(((i0 + kt - it.kt_lo) / kStages) & 1);
      };
      // hand a stage back to the producer; a warp arrives once its reads,
      // and those of the wgmma it issued, are done
      auto release = [&](uint32_t bar, int kt) {
        arrive(bar + 8 * stage(kt));
      };
      // a tile of the item that this warpgroup does not need: released
      // once it has arrived, so that arrivals keep the ring's order
      auto skip = [&](int kt) {
        mbar_wait(k_full + 8 * stage(kt), phase(kt));
        mbar_wait(v_full + 8 * stage(kt), phase(kt));
        release(k_empty, kt);
        release(v_empty, kt);
      };
      // S = Q K^T over hd in steps of 16 (issued, not waited for)
      auto issue_qk = [&](float (&sc)[kBN / 2], int kt) {
        const uint32_t k_tile = sK + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const int c = ks / 4, kk = ks % 4;
          wgmma_qk<kBN>(
              sc, gmma_desc(q_tile + c * kBM * 128 + 32 * kk, 16, 1024),
              gmma_desc(k_tile + c * kBN * 128 + 32 * kk, 16, 1024), ks > 0);
        }
        wgmma_commit();
      };
      // O += P V over the tile's keys in steps of 16 (issued)
      auto issue_pv = [&](float (&acc)[HD / 2], uint32_t (&pa)[kBN / 16][4],
                          int kt) {
        const uint32_t v_tile = sV + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int ks = 0; ks < kBN / 16; ++ks)
          wgmma_pv<HD>(acc, pa[ks],
                       gmma_desc(v_tile + ks * 16 * 128, kBN * 128, 1024));
        wgmma_commit();
      };
      // S of tile kt is done: K goes back, and after the item's last S,
      // Q too (the producer then loads the next item's)
      auto s_done = [&](float (&sc)[kBN / 2], int kt) {
        reg_fence(sc);
        release(k_empty, kt);
        if (kt == e - 1) arrive(q_empty);
      };
      auto softmax = [&](float (&sc)[kBN / 2], RowState& st,
                         float (&corr)[2], int kt) {
        const int k0 = kt * kBN;
        const bool edge =
            k0 + kBN > Sk ||
            (causal && (k0 + kBN - 1 > r_lo ||
                        (has_window && k0 <= r_hi - window)));
        online_softmax<kBN>(sc, st, corr, edge, k0, row0, col0, Sk, causal,
                            has_window, window, scale_log2);
      };

      float acc[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;
      RowState st;
      float sc[kBN / 2], corr[2];
      uint32_t pa[kBN / 16][4];

      mbar_wait(q_full, n & 1);
      for (int kt = it.kt_lo; kt < min(a, it.kt_hi); ++kt) skip(kt);
      if (a < e) {
        // the first tile: S, softmax, P
        mbar_wait(k_full + 8 * stage(a), phase(a));
        wgmma_fence();
        issue_qk(sc, a);
        wgmma_wait<0>();
        s_done(sc, a);
        softmax(sc, st, corr, a);
        pack_p<kBN>(sc, pa);
        // then each tile's S product runs with the previous tile's P V
        // product queued behind it, and its softmax while P V runs; O
        // takes the previous tile's rescale while S runs
        for (int kt = a + 1; kt < e; ++kt) {
          mbar_wait(k_full + 8 * stage(kt), phase(kt));
          mbar_wait(v_full + 8 * stage(kt - 1), phase(kt - 1));
          wgmma_fence();
          issue_qk(sc, kt);
#pragma unroll
          for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j / 2) % 2];
          wgmma_fence();
          issue_pv(acc, pa, kt - 1);
          wgmma_wait<1>();  // S done
          s_done(sc, kt);
          softmax(sc, st, corr, kt);
          wgmma_wait<0>();  // P V done
          reg_fence(acc);
          reg_fence(pa);
          release(v_empty, kt - 1);
          pack_p<kBN>(sc, pa);
        }
        mbar_wait(v_full + 8 * stage(e - 1), phase(e - 1));
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j / 2) % 2];
        wgmma_fence();
        issue_pv(acc, pa, e - 1);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(pa);
        release(v_empty, e - 1);
      } else {
        arrive(q_empty);
      }
      for (int kt = max(a, e); kt < it.kt_hi; ++kt) skip(kt);
      i0 += it.kt_hi - it.kt_lo;

      // O / l, rounded to bf16; rows past Sq are not written
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float inv = 1.f / fmaxf(quad_sum(st.l[r]), 1e-30f);
        if (row < Sq) {
          __nv_bfloat16* out =
              o + ((static_cast<long long>(it.b) * Sq + row) * H + it.h) *
                      HD +
              col0;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                      acc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

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

// A map over x [B, S, heads, hd] (bf16, contiguous) in boxes of 64 head-dim
// columns x `rows` rows of one head, 128-byte swizzled; reads past S fill
// with zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* x, int B,
                  int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * hd;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  using C = Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult res = make_map(encode, &tq, q, B, Sq, H, HD, kBM);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tk, k, B, Sk, KV, HD, C::kBN);
  if (res == CUDA_SUCCESS)
    res = make_map(encode, &tv, v, B, Sk, KV, HD, C::kBN);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  auto kernel = flash_fwd_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: one block an SM, or one an item if fewer
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>((Sq + kBM - 1) / kBM) * B * H;
  if (items > (1ll << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, Sq, Sk, H, KV,
      scale * kLog2e, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

#undef FA_D8
#undef FA_D32
#undef FA_D64
#undef FA_D128

}  // namespace

// bf16 q, k, v, o; hd 64, 128 or 256.  window is read only when
// has_window.  Returns 0, a CUDA error code, or kEncodeError plus the
// driver's CUresult when a tensor map cannot be built; the wrapper checks
// every argument first.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int Sq,
                                         int Sk, int H, int KV, int hd,
                                         float scale, int causal,
                                         int has_window, int window,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                        has_window, window, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                         has_window, window, s);
    case 256:
      return launch<256>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                         has_window, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
