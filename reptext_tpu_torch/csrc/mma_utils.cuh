// Register-level helpers shared by the attention kernels (sm_90a): bf16
// packing, mma.sync m16n8k16 bf16 -> fp32, ldmatrix and cp.async with
// zero-fill. Every helper is a forced-inline device function in an anonymous
// namespace, so each translation unit that includes this file gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 halves of a packed pair, widened to fp32 (exact).
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }

__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// 2^x for a packed pair of bf16 values in one PTX instruction (sm_90's
// ptxas issues it as two MUFU.EX2.BF16, one per half; subnormal results
// flush to 0).
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

// D = C + A * B for one 16x8x16 tile; A row-major, B column-major.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16-byte global -> shared copy; `valid` false zero-fills the destination.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy of one float; `valid` false writes 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Issue the copies of rows [row0, row0 + ROWS) of a [seq, D] bf16 matrix with
// row stride `ss` into dst[ROWS][LD]; rows past `seq` are zero-filled.
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long ss, int row0, int seq) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < seq;
    cp_async16(dst + r * LD + c, src + (long long)(valid ? row : 0) * ss + c, valid);
  }
}

}  // namespace
