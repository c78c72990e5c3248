// Joint (non-causal) flash attention backward for FLUX MMDiT blocks, sm_90a.
//
// Replaces reptext_tpu/ops/flash_attention.py::_dq_kernel (dQ) and
// ::_dkv_kernel (dK, dV), the Pallas kernels behind _flash_backward_pallas
// (K4). q and k arrive already rotated (the RoPE entry's backward rotates them
// in PyTorch with the fp32 tables and un-rotates dq and dk afterwards, as
// _rope_bwd does). What it computes, per (b, h), from the forward's saved
// lse and delta_i = sum_d dO_i * O_i (fp32, computed by the caller):
//   s_ij = fp32(q_i . k_j) * scale;  clamped mode: clip(s_ij, -43, 43), with
//          the gradient passed straight through beyond the bound (the Pallas
//          kernels' choice); online mode: no clip
//   p_ij = exp(s_ij - lse_i), 0 for keys j >= S
//   dp_ij = dO_i . v_j;  ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i = scale * sum_j bf16(ds_ij) k_j
//   dk_j = scale * sum_i bf16(ds_ij) q_i;  dv_j = sum_i bf16(p_ij) dO_i
// Products run on bf16 operands with fp32 accumulation (p and ds are rounded
// to bf16 before their products, as the forward rounds p); dq, dk, dv are
// written in bf16.
//
// What bounds it on an H100: at (1, 24, 4608, 128) the two kernels do
// 7 * 2 * S^2 * D * H = 9.1e11 FLOP (dQ: QK^T, dO V^T, dS K; dK/dV: the same
// two logit products again, P^T dO and dS^T Q) against ~0.2 GB of traffic,
// far above the card's ~295 FLOP/byte ridge: it is bound by tensor-core math
// and by how well shared memory feeds it, not by device memory.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16) and nothing of size S^2 leaves the chip. The logits are
// recomputed in both kernels instead of being shared through device memory,
// which would cost an S x S write and read per head.
//   dQ kernel: one CTA of 4 warps owns 64 query rows; each warp keeps its 16
//     rows of q and dO as mma A-fragments in registers and accumulates dq in
//     fp32 registers, while K and V stream through a two-stage cp.async ring in
//     64-key tiles (the forward's schedule).
//   dK/dV kernel: one CTA of 4 warps owns 64 key rows, held in shared memory
//     (the two fp32 accumulators, dk and dv, already take 128 registers per
//     thread); Q, dO, lse and delta stream through a two-stage cp.async ring in
//     64-query tiles. The transposed products (k q^T, v dO^T) make the key the
//     row of every fragment, so p^T and ds^T go from accumulators straight into
//     A-fragments, and dO and Q are read transposed by ldmatrix.trans.
// Rows and keys past S are zero-filled by the copies and masked, so the
// unaligned S = 4106 needs no padded tensors. The Pallas tiling (block_q,
// block_kv = 512 and the padding to them) followed from VMEM limits and is
// not carried over. wgmma, TMA and sharing the logits between the two passes
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 16 * kWarps;  // rows a CTA owns, and rows per streamed tile
constexpr int kPad = 8;              // bf16 pad per smem row: conflict-free ldmatrix
constexpr float kLogitClamp = 43.0f;

struct BwdParams {
  const __nv_bfloat16* q;     // rotated
  const __nv_bfloat16* k;     // rotated
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;           // [B, H, S] contiguous
  const float* delta;         // [B, H, S] contiguous
  __nv_bfloat16* dq;          // [B, H, S, D] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long d_sb, d_sh, d_ss;
  int heads;
  int seq;
  float scale;
};

template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long ss, int row0, int seq) {
  load_rows_async<D, kBlock, D + kPad, kThreads>(dst, src, ss, row0, seq);
}

// p = exp(clip(s * scale) - lse), masked, as one logit of either kernel.
template <bool ONLINE>
__device__ __forceinline__ float prob(float s, float scale, float lse, bool valid) {
  float x = s * scale;
  if (!ONLINE) x = fminf(fmaxf(x, -kLogitClamp), kLogitClamp);
  return valid ? expf(x - lse) : 0.0f;
}

// Write a warp's 16 x D fp32 accumulator rows (times `mul`) as bf16 into a
// contiguous [S, D] matrix at rows row0 + g and row0 + g + 8.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           int row0, int g, int t, int seq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* drow = dst + (long long)row * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

template <int D, bool ONLINE>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(const BwdParams p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kKSteps = D / 16;   // mma k-steps over the head dim
  constexpr int kNTilesD = D / 8;   // 8-channel column tiles of dq

  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* k_s = smem;              // [2][kBlock][kLd]
  __nv_bfloat16* v_s = smem + 2 * kTile;  // [2][kBlock][kLd]

  const int h = blockIdx.y, b = blockIdx.z;
  const int seq = p.seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row within it
  const int q0 = blockIdx.x * kBlock;
  const long long bh = (long long)b * p.heads + h;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // q and dO rows of this CTA, staged through the two K stages -> A fragments.
  load_tile_async<D>(k_s, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, seq);
  load_tile_async<D>(k_s + kTile, p.dout + b * p.d_sb + h * p.d_sh, p.d_ss, q0, seq);
  cp_async_commit();
  cp_async_wait_0();
  __syncthreads();
  uint32_t qf[kKSteps][4], df[kKSteps][4];
  {
    const int off = (warp * 16 + g) * kLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = off + (i & 1) * 8 * kLd + kk * 16 + (i >> 1) * 8;
        qf[kk][i] = *reinterpret_cast<const uint32_t*>(k_s + o);
        df[kk][i] = *reinterpret_cast<const uint32_t*>(k_s + kTile + o);
      }
    }
  }
  __syncthreads();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < seq ? p.lse[bh * seq + row] : 0.0f;
    delta_r[r] = row < seq ? p.delta[bh * seq + row] : 0.0f;
  }

  float acc[kNTilesD][4];
#pragma unroll
  for (int n = 0; n < kNTilesD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  load_tile_async<D>(k_s, kb, p.k_ss, 0, seq);
  load_tile_async<D>(v_s, vb, p.v_ss, 0, seq);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * kBlock;
    if (it + 1 < n_tiles) {
      load_tile_async<D>(k_s + (stage ^ 1) * kTile, kb, p.k_ss, k0 + kBlock, seq);
      load_tile_async<D>(v_s + (stage ^ 1) * kTile, vb, p.v_ss, k0 + kBlock, seq);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile's group has landed; the next may be in flight
    __syncthreads();
    const __nv_bfloat16* ks = k_s + stage * kTile;
    const __nv_bfloat16* vs = v_s + stage * kTile;

    // 16 keys at a time: s = q k^T and dp = dO v^T (two 8-key column tiles
    // each), then ds -> one A fragment of the 16-key k-step of dq += ds k.
#pragma unroll
    for (int c = 0; c < kBlock / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
        const int key_off = ((2 * c + j) * 8 + lr) * kLd + lm * 8;
#pragma unroll
        for (int kk = 0; kk < kKSteps; kk += 2) {
          uint32_t bf[4];
          ldmatrix_x4(bf, ks + key_off + kk * 16);
          mma_bf16_16816(s[j], qf[kk], bf[0], bf[1]);
          mma_bf16_16816(s[j], qf[kk + 1], bf[2], bf[3]);
          ldmatrix_x4(bf, vs + key_off + kk * 16);
          mma_bf16_16816(dp[j], df[kk], bf[0], bf[1]);
          mma_bf16_16816(dp[j], df[kk + 1], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + (2 * c + j) * 8 + 2 * t + (e & 1);
          const float pr = prob<ONLINE>(s[j][e], p.scale, lse_r[e >> 1], col < seq);
          s[j][e] = pr * (dp[j][e] - delta_r[e >> 1]);
        }
      }
      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
      const __nv_bfloat16* krow = ks + (c * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kNTilesD; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, krow + n * 8);
        mma_bf16_16816(acc[n], pa, bf[0], bf[1]);
        mma_bf16_16816(acc[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_rows<D>(p.dq + bh * seq * D, acc, q0 + warp * 16, g, t, seq, p.scale);
}

template <int D, bool ONLINE>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kKSteps = D / 16;
  constexpr int kNTilesD = D / 8;

  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* k_s = smem;                // [kBlock][kLd], this CTA's keys
  __nv_bfloat16* v_s = smem + kTile;        // [kBlock][kLd]
  __nv_bfloat16* q_s = smem + 2 * kTile;    // [2][kBlock][kLd]
  __nv_bfloat16* do_s = smem + 4 * kTile;   // [2][kBlock][kLd]
  float* stat_s = reinterpret_cast<float*>(smem + 6 * kTile);  // [2][lse, delta][kBlock]

  const int h = blockIdx.y, b = blockIdx.z;
  const int seq = p.seq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int kv0 = blockIdx.x * kBlock;
  const long long bh = (long long)b * p.heads + h;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lseb = p.lse + bh * seq;
  const float* deltab = p.delta + bh * seq;

  // the 64 queries of tile `it`: Q, dO, lse and delta into ring stage `st`
  auto load_queries = [&](int it, int st) {
    const int row0 = it * kBlock;
    load_tile_async<D>(q_s + st * kTile, qb, p.q_ss, row0, seq);
    load_tile_async<D>(do_s + st * kTile, dob, p.d_ss, row0, seq);
    if (threadIdx.x < 2 * kBlock) {
      const int i = threadIdx.x % kBlock;
      const bool valid = row0 + i < seq;
      const float* src = threadIdx.x < kBlock ? lseb : deltab;
      cp_async4(stat_s + (2 * st + threadIdx.x / kBlock) * kBlock + i,
                src + (valid ? row0 + i : 0), valid);
    }
  };

  load_tile_async<D>(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, kv0, seq);
  load_tile_async<D>(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, kv0, seq);
  load_queries(0, 0);
  cp_async_commit();

  float dk[kNTilesD][4], dv[kNTilesD][4];
#pragma unroll
  for (int n = 0; n < kNTilesD; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
  }
  // A fragments of this warp's 16 keys (k and v rows) come from shared memory
  const int a_off = (warp * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;

  const int n_tiles = (seq + kBlock - 1) / kBlock;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int qt0 = it * kBlock;
    if (it + 1 < n_tiles) load_queries(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const __nv_bfloat16* qs = q_s + stage * kTile;
    const __nv_bfloat16* dos = do_s + stage * kTile;
    const float* lse_s = stat_s + 2 * stage * kBlock;
    const float* delta_s = lse_s + kBlock;

    // 16 queries at a time: s^T = k q^T and dp^T = v dO^T (two 8-query column
    // tiles each), then p^T and ds^T -> A fragments of the 16-query k-step of
    // dv += p^T dO and dk += ds^T q.
#pragma unroll
    for (int c = 0; c < kBlock / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
      // B fragments of queries c*16 + [0, 8) (j = 0) and + [8, 16) (j = 1)
      const int b_off = (c * 16 + (lm >> 1) * 8 + lr) * kLd + (lm & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4], bf[4];
        ldmatrix_x4(a, k_s + a_off + kk * 16);
        ldmatrix_x4(bf, qs + b_off + kk * 16);
        mma_bf16_16816(s[0], a, bf[0], bf[1]);
        mma_bf16_16816(s[1], a, bf[2], bf[3]);
        ldmatrix_x4(a, v_s + a_off + kk * 16);
        ldmatrix_x4(bf, dos + b_off + kk * 16);
        mma_bf16_16816(dp[0], a, bf[0], bf[1]);
        mma_bf16_16816(dp[1], a, bf[2], bf[3]);
      }
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c * 16 + j * 8 + 2 * t + (e & 1);  // query within the tile
          const float pr = prob<ONLINE>(s[j][e], p.scale, lse_s[i], qt0 + i < seq);
          s[j][e] = pr;
          ds[j][e] = pr * (dp[j][e] - delta_s[i]);
        }
      }
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
      da[0] = pack_bf16(ds[0][0], ds[0][1]);
      da[1] = pack_bf16(ds[0][2], ds[0][3]);
      da[2] = pack_bf16(ds[1][0], ds[1][1]);
      da[3] = pack_bf16(ds[1][2], ds[1][3]);
      const int t_off = (c * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kNTilesD; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, dos + t_off + n * 8);
        mma_bf16_16816(dv[n], pa, bf[0], bf[1]);
        mma_bf16_16816(dv[n + 1], pa, bf[2], bf[3]);
        ldmatrix_x4_trans(bf, qs + t_off + n * 8);
        mma_bf16_16816(dk[n], da, bf[0], bf[1]);
        mma_bf16_16816(dk[n + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int row0 = kv0 + warp * 16;
  store_rows<D>(p.dk + bh * seq * D, dk, row0, g, t, seq, p.scale);
  store_rows<D>(p.dv + bh * seq * D, dv, row0, g, t, seq, 1.0f);
}

template <int D, bool ONLINE>
cudaError_t launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kTileBytes = kBlock * (D + kPad) * sizeof(__nv_bfloat16);
  constexpr int kSmemDq = 4 * kTileBytes;
  constexpr int kSmemDkv = 6 * kTileBytes + 4 * kBlock * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D, ONLINE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<D, ONLINE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seq + kBlock - 1) / kBlock, p.heads, batch);
  attn_bwd_dq_kernel<D, ONLINE><<<grid, kThreads, kSmemDq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<D, ONLINE><<<grid, kThreads, kSmemDkv, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by reptext_tpu_torch/ops/flash_attention.py.
// q, k, v, dout: bf16 [B, H, S, D] with element strides (the head dim
// contiguous); lse, delta: fp32 [B, H, S] contiguous; dq, dk, dv: bf16
// [B, H, S, D] contiguous, allocated by the caller. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int reptext_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int seq,
    int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss,
    float scale, int online, void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.d_sb = d_sb; p.d_sh = d_sh; p.d_ss = d_ss;
  p.heads = heads;
  p.seq = seq;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || batch < 1 || heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  // FLUX's head dim; other widths get their instantiation when a model needs one
  if (head_dim == 128) {
    err = online ? launch_bwd<128, true>(p, batch, s) : launch_bwd<128, false>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
