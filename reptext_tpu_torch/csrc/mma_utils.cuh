// Register-level helpers shared by the attention kernels (sm_90a): bf16
// rounding, packing and unpacking, and the packed bf16 exponential. Every
// helper is a forced-inline device function in an anonymous namespace, so each
// translation unit that includes this file gets its own copy.

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

}  // namespace
