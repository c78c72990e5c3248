// Hopper-only building blocks of the attention kernels, forward and backward
// (sm_90a): mbarriers, TMA tile loads (cp.async.bulk.tensor) and plain bulk
// copies, wgmma descriptors for the 128- and 64-byte swizzles, the wgmma.mma_async
// forms the kernels issue, named barriers and setmaxnreg. Every helper is a
// forced-inline device function in an anonymous namespace, as in mma_utils.cuh.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic still to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA

// One box of a 4-D tensor map, coordinates innermost first, into shared
// memory; completion is counted in bytes on `bar`. Coordinates past the map's
// bounds read as zero.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous device memory into shared memory,
// both 16-byte aligned; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of shared memory added (fp32 add, element by element, in no fixed
// order against other adds) into a 4-D tensor map's tensor in device memory;
// the part of the box past the map's bounds is dropped. Completion is tracked
// by the issuing thread's bulk group.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's bulk groups have completed: their writes
// to device memory (a reduce-add's too) are performed.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy accesses to device memory against its
// async-proxy (TMA) ones, in both directions.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A flag in device memory shared by the CTAs of a grid: spin until it holds
// `value` (acquire at GPU scope), or add one to it after everything this
// thread did before (release at GPU scope), as CUTLASS's generic barrier does.
__device__ __forceinline__ void flag_wait_eq(const int* flag, int value) {
  int seen;
  do {
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(seen) : "l"(flag) : "memory");
  } while (seen != value);
}

__device__ __forceinline__ void flag_release_inc(int* flag) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(flag) : "memory");
}

// Generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma, TMA) of this CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------- barriers, registers

template <int THREADS>
__device__ __forceinline__ void named_barrier_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// --------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a swizzled tile: the tile's start, the
// leading and stride byte offsets, and the swizzle the TMA wrote it with
// (SWIZZLE 128 or 64 bytes: rows of 64 or 32 bf16, the pattern repeating
// every 8 rows, 1024 or 512 bytes, from an address aligned to it).
//   K-major (rows of 64 or 32 bf16, the reduction dim contiguous):
//     stride = 8 rows (1024 or 512 bytes); leading is not used.
//   MN-major (rows of 64 or 32 bf16 along M or N, the reduction dim across
//     rows): leading = the distance between 64- or 32-wide column blocks of
//     the tile, stride = 8 rows of the reduction dim.
// Within a row the start may move by a k-step's 32 bytes: the hardware
// swizzles the address it forms, as the TMA did.
template <int SWIZZLE = 128>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t leading_bytes,
                                               uint32_t stride_bytes) {
  static_assert(SWIZZLE == 128 || SWIZZLE == 64, "128- or 64-byte swizzle");
  constexpr uint64_t kLayout = SWIZZLE == 128 ? 1 : 2;  // the descriptor's layout type
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(leading_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (kLayout << 62);
}

// The byte offset of 16-byte chunk c of row r in a tile of ROW_BYTES-byte
// rows (128 or 64) that the TMA wrote with the swizzle of that width: the
// chunk index XORed with address bits 7.. (r % 8 for 128-byte rows, r / 2 % 4
// for 64-byte ones).
template <int ROW_BYTES>
__device__ __forceinline__ int swizzled_offset(int r, int c) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "128- or 64-byte rows");
  return r * ROW_BYTES + ((c ^ ((r * ROW_BYTES >> 7) & (ROW_BYTES / 16 - 1))) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties an accumulator to the asynchronous product that writes it, so the
// compiler neither hoists a read above the wait nor sinks a write below the
// issue.
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define REPTEXT_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPTEXT_ACC32(d, i) \
  REPTEXT_ACC8(d, i), REPTEXT_ACC8(d, i + 8), REPTEXT_ACC8(d, i + 16), REPTEXT_ACC8(d, i + 24)
#define REPTEXT_REGS16 "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
#define REPTEXT_REGS32                                                      \
  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"                  \
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define REPTEXT_REGS64                                                      \
  REPTEXT_REGS32 ","                                                        \
  "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"        \
  "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, A and B K-major in shared memory.
// The accumulator fragment: thread (warp w, g = lane / 4, t = lane % 4) holds
// rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8 (d[4 j + 2], d[4 j + 3])
// at columns 8 j + 2 t and 8 j + 2 t + 1. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REPTEXT_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : REPTEXT_ACC32(d, 0), REPTEXT_ACC32(d, 32)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both operands in shared memory.
// TRANS_A / TRANS_B 0: the operand is K-major (A as [64][16], B as [64][16],
// the reduction dim contiguous); 1: MN-major (A as [16][64], B as [16][64],
// its 64 rows or columns contiguous, the reduction dim across 128-byte rows).
// The accumulator fragment is wgmma_ss_n128's at half the columns: d[4 j + e]
// is column 8 j + 2 t + (e & 1) of row 16 w + g + 8 (e >> 1).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REPTEXT_REGS32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : REPTEXT_ACC32(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows: a0 row g cols 2t, 2t+1; a1 row
// g + 8; a2, a3 the same at cols + 8) and B MN-major in shared memory (its
// 128 columns contiguous: the transposed-B form).
__device__ __forceinline__ void wgmma_rs_n128_bt(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REPTEXT_REGS64
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : REPTEXT_ACC32(d, 0), REPTEXT_ACC32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// wgmma_rs_n128_bt at 64 columns: d[64 x 64] += A[64 x 16] B[16 x 64], A from
// registers, B MN-major in shared memory (one 64-wide column block).
__device__ __forceinline__ void wgmma_rs_n64_bt(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REPTEXT_REGS32
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : REPTEXT_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// wgmma_rs_n64_bt at 32 columns (one 32-wide column block).
__device__ __forceinline__ void wgmma_rs_n32_bt(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" REPTEXT_REGS16
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : REPTEXT_ACC8(d, 0), REPTEXT_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// wgmma_ss_n64 at 32 columns: d[64 x 32] (+)= A[64 x 16] B[16 x 32], both in
// shared memory, TRANS_A / TRANS_B as there.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" REPTEXT_REGS16
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : REPTEXT_ACC8(d, 0), REPTEXT_ACC8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// The transposed-B register-A product at N = D columns (the head dim: 32, 64
// or 128), as the attention kernels instantiate it.
template <int D>
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  static_assert(D == 32 || D == 64 || D == 128,
                "the kernels are instantiated at head dims 32, 64 and 128");
  if constexpr (D == 128) {
    wgmma_rs_n128_bt(d, a, desc_b);
  } else if constexpr (D == 64) {
    wgmma_rs_n64_bt(d, a, desc_b);
  } else {
    wgmma_rs_n32_bt(d, a, desc_b);
  }
}

// The shared-memory product at N columns (64 or 32), TRANS_A / TRANS_B as in
// wgmma_ss_n64.
template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  static_assert(N == 32 || N == 64, "64 or 32 columns");
  if constexpr (N == 64) {
    wgmma_ss_n64<TRANS_A, TRANS_B>(d, desc_a, desc_b, accumulate);
  } else {
    wgmma_ss_n32<TRANS_A, TRANS_B>(d, desc_a, desc_b, accumulate);
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
