// The tanh GELU of the single blocks' MLP branch, sm_90a: one pass from the
// proj_mlp GEMM's output into its columns of proj_out's input buffer.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses reptext_tpu/nn/blocks.py's
// gelu and the concatenation of the attention and MLP branches into their
// neighbours. Eagerly, the single block wrote gelu(mlp) to a tensor of its own
// and then copied it, with the attention output, into a new [B, S, inner +
// mlp] tensor for proj_out. Here the attention kernel writes its output into
// the first inner columns of that buffer and this kernel writes the GELU into
// the rest, so nothing is copied (ops/gelu.py, nn/blocks.py).
//
// What it computes, per element, is F.gelu(x, approximate="tanh") as ATen's
// CUDA kernel computes it (GeluCUDAKernelImpl) in its opmath, fp32:
//   inner = kBeta * (x + kKappa * x^3), y = 0.5 * x * (1 + tanhf(inner))
// with kBeta = sqrt(2) * 2/sqrt(pi) * 0.5 and kKappa = 0.044715, both taken in
// double and stored as float as ATen's constexprs are, the same operations in
// the same order, and one rounding to x's dtype (round to nearest even). A
// bf16 x cubes exactly in fp32 (8 + 8 + 8 significant bits), and on the card
// every finite bf16 input gives ATen's bits, with or without the inner sum
// contracted into an FMA (nvcc 12.9 against PyTorch's CUDA 12.8 build; the
// card tests check all 65536 inputs).
//
// What bounds it on an H100: bytes. At [1, 4608, 12288] bf16 it reads 113 MB
// and writes 113 MB: 68 us at 3.35 TB/s; tanhf is some twenty fp32 operations
// an element, under the bytes' time.
//
// The design. A thread takes kVecs 16-byte vectors of one row (8 bf16 or 4
// fp32 elements each), all loaded before any is computed, neighbouring
// threads neighbouring vectors; a CTA of
// kThreads covers kThreads * kVecs vectors of one row, and a row takes
// blocks_per_row CTAs, so the grid is one-dimensional at any number of rows.
// x and out are rows of nv vectors with their own row strides (out: proj_out's
// input buffer, inner + mlp elements a row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors a thread

struct GeluArgs {
  const void* x;
  void* out;
  long long x_rs, o_rs;   // row strides, in elements
  int nv;                 // 16-byte vectors a row
  int blocks_per_row;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // sqrt(2) * 2 / sqrt(pi) * 0.5 (M_SQRT2 * M_2_SQRTPI * 0.5)
  constexpr float kBeta =
      static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = static_cast<float>(0.044715);
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// One 16-byte vector of the tag type's elements through the GELU.
__device__ __forceinline__ uint4 gelu_vec(uint4 v, __nv_bfloat16) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = gelu_tanh(f[i]);
  return pack8(f);
}

__device__ __forceinline__ uint4 gelu_vec(uint4 v, float) {
  return make_uint4(__float_as_uint(gelu_tanh(__uint_as_float(v.x))),
                    __float_as_uint(gelu_tanh(__uint_as_float(v.y))),
                    __float_as_uint(gelu_tanh(__uint_as_float(v.z))),
                    __float_as_uint(gelu_tanh(__uint_as_float(v.w))));
}

// A thread's kVecs loads are all issued before any of its math.
template <typename T>
__global__ void __launch_bounds__(kThreads) gelu_tanh_kernel(const GeluArgs a) {
  const long long row = blockIdx.x / a.blocks_per_row;
  const int first = static_cast<int>(blockIdx.x - row * a.blocks_per_row) * kThreads * kVecs +
                    threadIdx.x;
  const uint4* x = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) + row * a.x_rs);
  uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + row * a.o_rs);
  uint4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int vi = first + j * kThreads;
    if (vi < a.nv) v[j] = x[vi];
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int vi = first + j * kThreads;
    if (vi < a.nv) out[vi] = gelu_vec(v[j], T());
  }
}

}  // namespace

// out[r, :] = gelu_tanh(x[r, :]) for `rows` rows of nv 16-byte vectors; x and
// out of one dtype (f32: fp32, else bf16), 16-byte-aligned bases and row
// strides x_rs and o_rs in elements, each a whole number of 16 bytes; the
// elements of a row contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int reptext_gelu_tanh(const void* x, void* out, long long rows, int nv,
                                 long long x_rs, long long o_rs, int f32, void* stream) {
  if (rows < 0 || nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int per_cta = kThreads * kVecs;
  const GeluArgs a{x, out, x_rs, o_rs, nv, (nv + per_cta - 1) / per_cta};
  const long long blocks = rows * a.blocks_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    gelu_tanh_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    gelu_tanh_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
