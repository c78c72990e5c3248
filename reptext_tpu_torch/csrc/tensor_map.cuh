// Host-side TMA tensor maps shared by the attention kernels (sm_90a): the
// cuTensorMapEncodeTiled lookup, the map every kernel streams its bf16
// operands through, and the fp32 map the backward adds dq through. Host
// functions in an anonymous namespace, so each translation unit that includes
// this file gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// the library links against the runtime alone (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) sym = nullptr;
    return reinterpret_cast<EncodeTiled>(sym);
  }();
  return fn;
}

// The channels of one box of a bf16 map, and so of one swizzled row in
// shared memory: 64 (128 bytes) for head dims of 64 and more, the whole head
// dim (32: 64 bytes) below.
__host__ __device__ constexpr int box_channels(int head_dim) {
  return head_dim < 64 ? head_dim : 64;
}

// A 4-D map over (D, S, H, B) of a bf16 tensor with element strides (ss, sh,
// sb) and a contiguous head dim of `head_dim` channels; a box is
// box_channels(head_dim) channels x `box_rows` rows of one (b, h), stored with
// the swizzle of its row's width (128 bytes, or 64 at head dim 32). Rows past
// `seq` read as zero. A layout no tensor map takes (a stride that is not a
// positive multiple of 16 bytes, a misaligned base) returns false.
bool make_map(CUtensorMap* map, const void* base, int batch, int heads, int seq, long long sb,
              long long sh, long long ss, int head_dim, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  // the stride of a dimension of one element is never used: any legal value
  const cuuint64_t strides[3] = {(cuuint64_t)(seq > 1 ? ss : head_dim) * 2,
                                 (cuuint64_t)(heads > 1 ? sh : head_dim) * 2,
                                 (cuuint64_t)(batch > 1 ? sb : head_dim) * 2};
  const int channels = box_channels(head_dim);
  const cuuint32_t box[4] = {(cuuint32_t)channels, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                channels == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map over (D, S, H, B) of a contiguous fp32 [B, H, S, D] tensor; a box
// is 32 channels (128 bytes) x `box_rows` rows of one (b, h), stored with the
// 128-byte swizzle. For reduce-adds: the rows of a box past `seq` are dropped.
bool make_map_f32(CUtensorMap* map, const void* base, int batch, int heads, int seq, int head_dim,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)head_dim * 4;
  const cuuint64_t strides[3] = {row, row * seq, row * seq * heads};
  const cuuint32_t box[4] = {32, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
