// The fp32 row norms of the FLUX and ControlNet blocks, sm_90a: the AdaLN
// LayerNorm with its modulation, and the per-head q/k RMSNorm, one pass each.
//
// Replaces no Pallas kernel: on the TPU, XLA fused reptext_tpu/nn/layers.py's
// modulate (layer_norm_no_affine_f32, then * (1 + scale) + shift, then the
// cast) and RMSNorm into their neighbours. Eager PyTorch runs each as a chain
// of 7 to 11 kernels that write fp32 temporaries of the whole activation.
//
// What it computes, per row of D elements, in fp32 from x's dtype (bf16 or
// fp32), with the parameters (shift and scale, or the norm's weight) in x's
// dtype:
//   modulate_ln_kernel:  mean = sum(x) / D; var = sum((x - mean)^2) / D;
//                        out = ((x - mean) * rsqrt(var + eps)) * (1 + scale[b])
//                              + shift[b]
//   rms_norm_kernel:     ms = sum(x^2) / D; out = (x * rsqrt(ms + eps)) * w
// rounded once to x's dtype (round to nearest even). The variance is two-pass
// from registers, never E[x^2] - mean^2: FLUX's activations carry large
// outliers. Every product and sum is rounded where the eager chain rounds it
// (__fmul_rn and __fadd_rn, so nothing contracts into an FMA), the mean is the
// sum times the fp32 1 / D, as PyTorch's CUDA mean takes it, and rsqrtf is the
// function the eager rsqrt calls. So the kernel and the eager chain differ
// only in the order of the row sums.
//
// What bounds it on an H100: bytes. A [1, 4608, 3072] bf16 row norm reads x
// once and writes out once, 4 bytes an element, 57 MB: 17 us at 3.35 TB/s; a
// few tens of fp32 operations an element are nothing beside that. The
// parameters are one row per batch entry and stay in L2.
//
// The design. A row is NV = D / N vectors of 16 bytes of x (N = 8 bf16 or 4
// fp32 elements), held in registers by G threads, VPT vectors each,
// interleaved so that neighbouring threads read neighbouring 16 bytes. With G
// <= 32 (a power of two) a CTA of 256 threads holds 256 / G rows and a row's
// sums are xor shuffles within its G lanes; with G > 32 (a multiple of 32, at
// most 256) a CTA is one row, its sums shuffles within each warp and then the
// warps' partial sums through shared memory, added in warp order. An xor
// butterfly gives every lane the same bits, so every thread of a row uses the
// same mean and scale. The wrapper picks VPT (1, 2 or 4) and G from D, up to
// FLUX's 3072, the widest row the port sends (ops/norms.py::plan): at most 128
// threads a row where VPT allows, so that a thread keeps 32 to 64 bytes of x in
// flight at FLUX's widths (an fp32 row of 3072 takes 192). modulate's x
// may be a strided [B, S, D] view (any batch and token strides, unit last
// stride) and its out is a dense [B, S, D]; rms_norm walks flat rows of a
// dense tensor whose last stride is 1, and its out has x's strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsCta = 256;   // the CTA size when a row takes G <= 32 threads
constexpr int kMaxGroup = 256;  // the most threads a row takes

struct NormArgs {
  const void* x;
  const void* p0;       // modulate: shift; rms_norm: the weight
  const void* p1;       // modulate: scale
  void* out;
  long long rows;       // modulate: B * S; rms_norm: numel / D
  long long seq;        // modulate: S
  long long x_sb, x_ss; // modulate: x's batch and token strides, in elements
  long long p0_sb, p1_sb;  // modulate: shift's and scale's batch strides (0: one row for all)
  int nv;               // vectors of N elements in a row
  int group;            // G, threads a row
  float eps, inv_d;
};

template <typename T>
struct Lanes;  // N: the elements of T in 16 bytes
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Lanes<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  load4(p, f);
  load4(p + 4, f + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (N == 8) {
    load8(p, f);
  } else {
    load4(p, f);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The sum of v over a row's G lanes, the same bits in every lane. G > 32:
// one row a CTA; red holds the warps' partial sums and is free again on return.
__device__ __forceinline__ float row_sum(float v, int group, float* red) {
  const int width = group < 32 ? group : 32;
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (group <= 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < (group >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// The one template of both kernels. MODULATE: the AdaLN LayerNorm with its
// modulation; else the RMSNorm. T: the type of x, out and the parameters.
template <bool MODULATE, typename T, int VPT>
__device__ __forceinline__ void row_norm(const NormArgs& a) {
  constexpr int N = Lanes<T>::N;
  __shared__ float red[kMaxGroup / 32];
  const int g = a.group;
  const long long row = g <= 32
      ? static_cast<long long>(blockIdx.x) * (kRowsCta / g) + threadIdx.x / g
      : static_cast<long long>(blockIdx.x);
  const int lane = g <= 32 ? static_cast<int>(threadIdx.x % g) : static_cast<int>(threadIdx.x);
  const bool live = row < a.rows;
  const long long b = MODULATE ? row / a.seq : 0;
  const long long x_off = MODULATE ? b * a.x_sb + (row - b * a.seq) * a.x_ss
                                   : row * a.nv * N;
  const T* x = static_cast<const T*>(a.x) + x_off;
  T* out = static_cast<T*>(a.out) + row * a.nv * N;

  float v[VPT][N];
  bool in_row[VPT];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vi = lane + j * g;
    in_row[j] = live && vi < a.nv;
    if (in_row[j]) {
      load_vec<N>(x + static_cast<long long>(vi) * N, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[j][i] = 0.0f;
    }
  }

  float rstd, mean = 0.0f;
  if constexpr (MODULATE) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int i = 0; i < N; ++i) sum += v[j][i];
    }
    mean = row_sum(sum, g, red) * a.inv_d;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (in_row[j]) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float d = v[j][i] - mean;
          sq += __fmul_rn(d, d);
        }
      }
    }
    rstd = rsqrtf(__fadd_rn(row_sum(sq, g, red) * a.inv_d, a.eps));
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int i = 0; i < N; ++i) sum += __fmul_rn(v[j][i], v[j][i]);
    }
    rstd = rsqrtf(__fadd_rn(row_sum(sum, g, red) * a.inv_d, a.eps));
  }

  const T* p0 = static_cast<const T*>(a.p0) + (MODULATE ? b * a.p0_sb : 0);
  const T* p1 = static_cast<const T*>(a.p1) + (MODULATE ? b * a.p1_sb : 0);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (!in_row[j]) continue;
    const long long e = static_cast<long long>(lane + j * g) * N;
    float o[N], w0[N];
    load_vec<N>(p0 + e, w0);
    if constexpr (MODULATE) {
      float w1[N];
      load_vec<N>(p1 + e, w1);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float n = __fmul_rn(v[j][i] - mean, rstd);
        o[i] = __fadd_rn(__fmul_rn(n, __fadd_rn(1.0f, w1[i])), w0[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = __fmul_rn(__fmul_rn(v[j][i], rstd), w0[i]);
    }
    store_vec(out + e, o);
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxGroup) modulate_ln_kernel(const NormArgs a) {
  row_norm<true, T, VPT>(a);
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxGroup) rms_norm_kernel(const NormArgs a) {
  row_norm<false, T, VPT>(a);
}

bool bad_plan(int nv, int group, int vpt) {
  const bool small = group >= 1 && group <= 32 && (group & (group - 1)) == 0;
  const bool large = group > 32 && group <= kMaxGroup && group % 32 == 0;
  return nv < 1 || !(small || large) || !(vpt == 1 || vpt == 2 || vpt == 4)
         || static_cast<long long>(group) * vpt < nv;
}

template <bool MODULATE, typename T, int VPT>
cudaError_t launch_vpt(const NormArgs& a, cudaStream_t s) {
  const int rows_cta = a.group <= 32 ? kRowsCta / a.group : 1;
  const dim3 grid(static_cast<unsigned>((a.rows + rows_cta - 1) / rows_cta));
  const dim3 block(a.group <= 32 ? kRowsCta : a.group);
  if constexpr (MODULATE) {
    modulate_ln_kernel<T, VPT><<<grid, block, 0, s>>>(a);
  } else {
    rms_norm_kernel<T, VPT><<<grid, block, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool MODULATE, typename T>
cudaError_t launch_typed(const NormArgs& a, int vpt, cudaStream_t s) {
  switch (vpt) {
    case 1: return launch_vpt<MODULATE, T, 1>(a, s);
    case 2: return launch_vpt<MODULATE, T, 2>(a, s);
    default: return launch_vpt<MODULATE, T, 4>(a, s);
  }
}

template <bool MODULATE>
int launch(const NormArgs& a, int vpt, int f32, void* stream) {
  if (bad_plan(a.nv, a.group, vpt) || a.rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f32 ? launch_typed<MODULATE, float>(a, vpt, s)
                               : launch_typed<MODULATE, __nv_bfloat16>(a, vpt, s));
}

}  // namespace

// modulate: x [B, S, D] (strides x_sb, x_ss, 1), shift and scale [B, D] of
// x's type (batch strides shift_sb, scale_sb, unit last stride), out a dense
// [B, S, D] of x's type; rows = B * S, seq = S; f32: fp32, else bf16.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// plan the kernel does not take).
extern "C" int reptext_modulate(const void* x, const void* shift, const void* scale, void* out,
                                long long rows, long long seq, long long x_sb, long long x_ss,
                                long long shift_sb, long long scale_sb, int nv, int group,
                                int vpt, int f32, float eps, float inv_d, void* stream) {
  if (seq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const NormArgs a{x, shift, scale, out, rows, seq, x_sb, x_ss, shift_sb, scale_sb,
                   nv, group, eps, inv_d};
  return launch<true>(a, vpt, f32, stream);
}

// rms_norm: rows flat rows of nv vectors at x (a dense tensor whose last
// stride is 1), out with x's strides, the weight [D] of x's type with unit
// stride.
extern "C" int reptext_rms_norm(const void* x, const void* weight, void* out, long long rows,
                                int nv, int group, int vpt, int f32, float eps, float inv_d,
                                void* stream) {
  const NormArgs a{x, weight, nullptr, out, rows, 1, 0, 0, 0, 0, nv, group, eps, inv_d};
  return launch<false>(a, vpt, f32, stream);
}
