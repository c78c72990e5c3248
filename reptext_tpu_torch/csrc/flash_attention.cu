// Joint (non-causal) flash attention forward for FLUX MMDiT blocks, sm_90a.
//
// Replaces reptext_tpu/ops/flash_attention.py::_attn_kernel_rope (K1, RoPE
// fused, half-split channel layout), ::_attn_kernel (K2, no rotation) and
// ::_streaming_kernel (K3, the streaming kernel for S > 6144 on pre-rotated
// q and k): one template, instantiated with ROPE = true / false, with the
// scale folded into q (K1, K2) or applied to the fp32 logits (SCALE_LOGITS,
// K3), and with the clamped max-free softmax (default) or the running-max
// online softmax.
//
// What it computes, per (b, h) and query row i, exactly as the Pallas kernels:
//   q' = bf16(rot(q_i) * 1/sqrt(D)),  k'_j = bf16(rot(k_j))
//        rot(x) = x * cos + (-x_hi ++ x_lo) * sin, with bf16-rounded tables
//        (rot = identity when ROPE is false)
//   s_j = fp32(q' . k'_j)
//        K3: q' = q_i, and s_j = fp32(q_i . k_j) * 1/sqrt(D) (fp32 multiply)
//   clamped: s_j = clip(s_j, -43, 43); then s_j = -inf for j >= S
//   e_j = exp(s_j - m)    (m = 0 clamped, running row max online)
//   out = (sum_j bf16(e_j) v_j, fp32 accumulation) / sum_j e_j
//   lse = m + log(sum_j e_j)
//
// What bounds it on an H100: at (1, 24, 4608, 128) one call is 4*S^2*D*H =
// 2.6e11 FLOP against ~0.11 GB of q/k/v/out traffic, i.e. far above the
// card's ~295 FLOP/byte ridge: it is bound by tensor-core math and by how
// well the math is fed from L2 and shared memory, not by device memory.
// K3 at (2, 24, 7424, 128), the inpaint request at 1536x1152, is 1.35e12 FLOP
// against ~0.37 GB: the same bound, more so.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate), and nothing of size S^2
// leaves the chip. One CTA of 4 warps owns 64 query rows of one (b, h); each
// warp keeps its 16 rows of q' as mma A-fragments in registers for the whole
// kernel. K and V stream through a two-stage shared-memory ring in 64-key
// tiles with cp.async, so the next tile's copy overlaps this tile's math;
// their mma B-fragments come from ldmatrix (V transposed by ldmatrix.trans).
// The probabilities go from the QK accumulators straight into the PV
// A-fragments, and the division by the row sum waits until after PV (D
// divides per row instead of S). Rows and keys past S are zero-filled by the
// copies and masked to -inf, so no padded tensors are made.
//
// RoPE: q is rotated while it is staged, once per CTA. k is rotated once per
// call by rope_rotate_kernel into a bf16 scratch copy (k' as above), which the
// main kernel then streams like an unrotated k. Rotating k inside every CTA
// instead (the Pallas kernel's choice) re-reads the [S, D] fp32 tables for
// every 64-query tile -- 72x per head at S = 4608 -- and measured 4.24 ms
// against 2.55 ms without RoPE on the H100; the copy costs one S x D bf16
// write and read per head. The TPU tiling (block_q caps, _pick_chunks,
// _SINGLE_PASS_MAX_SEQ, K3's 256 x 512 blocks and VMEM scratch) followed from
// VMEM limits and is not carried over: K/V already stream through the ring
// here, so K3 is this template with the scale moved onto the logits, and the
// running max, row sums and accumulator that the Pallas kernel keeps in
// scratch across its kv grid axis stay in registers across the key loop.
// The wrapper still routes by _SINGLE_PASS_MAX_SEQ, for the reference's
// rounding (fp32 rotation outside the kernel, scale after the product).
// wgmma and TMA are later work.
//
// The attention A/B variants (reptext_attention_variant_fwd): the same
// template with the running max, the scale on the fp32 logits, no lse store,
// and a compile-time exponential (EXP):
//   kExpE     replaces benchmarks/exp_softmax_overlap.py::_chunked_kernel, the
//             online softmax over unrolled key chunks: e = exp(s - m). The
//             64-key cp.async ring takes the place of the chunks.
//   kExp2     replaces benchmarks/sweep_attention.py::_exp2_kernel: log2(e) is
//             folded into the scale (the caller passes scale * log2(e)), so s,
//             the running max and alpha are in log2 units and e = exp2(s - m).
//   kExp2Bf16 replaces benchmarks/exp_softmax_overlap.py::_bf16exp_kernel:
//             s - m (log2 units) is rounded to bf16 and exponentiated two at a
//             time by ex2.approx.ftz.bf16x2; the packed result is the PV
//             A fragment as it stands, and the row sums add its two halves in
//             fp32. The Pallas kernel rounds logits - m (natural units) and
//             takes exp at bf16; folding log2(e) in first moves that rounding
//             to (logits - m) * log2(e): both are a relative error of 2^-9 in
//             the exponent's argument.
// The Pallas _bf16exp_kernel and _exp2_kernel take the full row max in one
// pass over [block_q, S] fp32 logits held in VMEM. A [64, 4608] fp32 row tile
// is 1.2 MB, far beyond one CTA's registers and shared memory, so these take
// the running max instead: the function is the same, only where p is rounded
// to bf16 differs (each tile's p against the max so far, rescaled in fp32).
// What bounds them: at the study's (1, 24, 4608, 128), 2.61e11 FLOP of
// products against 0.113 GB, 0.264 ms at 989 TFLOP/s (bytes: 0.034 ms); the
// 5.1e8 exponentials run on the special-function unit beside the tensor
// cores. sm_90's ptxas issues each packed ex2.approx.ftz.bf16x2 as two
// MUFU.EX2.BF16, one per half (cuobjdump -sass), so the bf16 form issues as
// many MUFU ops as kExp2; it saves the fp32 -> bf16 rounding of p instead.
//
// The ring step (reptext_ring_attention_step, CARRY) replaces
// reptext_tpu/ops/ring_attention.py::_ring_kernel (K5). The Pallas kernel is one
// program per device that rotates K/V blocks to its right neighbour by
// in-kernel RDMA and folds each block into an fp32 online-softmax state. Here
// one launch is one ring step: the K/V transfer runs outside the kernel, as a
// collective on the group (reptext_tpu_torch/ops/ring_attention.py), and no
// kernel ever waits on another rank. The step is this template with the
// running max, expf, the scale on the fp32 logits, no clamp, Sq queries
// against Sk keys (keys past Sk masked as K3 masks them), and the state
// carried between launches in device memory: acc [B, H, Sq, D], m and l
// [B, H, Sq], all fp32 and contiguous. The first step sets m = -1e30, l = 0,
// acc = 0 in registers, as the Pallas kernel initialises its scratch; a later
// step loads them. Each thread loads and stores exactly the rows and columns
// of its own C fragments (rows g and g + 8 of its warp's 16, columns 2t and
// 2t + 1 of each 8-channel tile), so the state never passes through shared
// memory; l is loaded into the quad's t = 0 lane and summed over the quad at
// the end like the partial row sums. Every step but the last stores the
// state; the last writes acc / l in q's dtype and stores no state. p is
// rounded to bf16 for PV as in K1-K3, where the Pallas kernel multiplies fp32
// p by fp32 V. What bounds it: at (1, 24, 4608, 128) over 4 ranks (Sq = Sk =
// 1152) a step is 1.63e10 FLOP (16.5 us at 989 TFLOP/s) against ~50 MB of
// q, k, v and the fp32 state in and out (14.9 us at 3.35 TB/s): the carried
// state nearly balances the step. Keeping the state in registers across the
// steps needs the transfers inside one kernel, which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_utils.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per CTA (16 per warp)
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 pad per smem row: conflict-free ldmatrix
constexpr float kLogitClamp = 43.0f;

// The softmax's exponential (see the source note).
constexpr int kExpE = 0;      // expf(s - m)
constexpr int kExp2 = 1;      // exp2f(s - m), s in log2 units
constexpr int kExp2Bf16 = 2;  // ex2.approx.ftz.bf16x2(bf16(s - m)), s in log2 units

template <int EXP>
__device__ __forceinline__ float softmax_exp(float x) {
  return EXP == kExpE ? expf(x) : exp2f(x);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;   // the rotated copy when ROPE
  const __nv_bfloat16* v;
  const float* cos;         // [S, D] fp32, rounded to bf16 on read (ROPE only)
  const float* sin;
  __nv_bfloat16* out;
  float* lse;               // [B, H, S] contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads;
  int seq;                  // query rows
  int seq_k;                // keys (== seq but for the ring step)
  float scale;
  // ring step (CARRY) only: the fp32 state, contiguous, and the step's role
  float* acc;               // [B, H, seq, D]
  float* m_state;           // [B, H, seq]
  float* l_state;           // [B, H, seq]
  int first;
  int last;
};

__device__ __forceinline__ void load8_rounded(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = bf16_round(a.x); f[1] = bf16_round(a.y); f[2] = bf16_round(a.z); f[3] = bf16_round(a.w);
  f[4] = bf16_round(b.x); f[5] = bf16_round(b.y); f[6] = bf16_round(b.z); f[7] = bf16_round(b.w);
}

// Rotate one 8-channel chunk of the low half (lo, channels d0..d0+7) and its
// partner of the high half (hi, d0 + D/2 ...) of position `row`, then
// multiply by `mul`. fp32 products and sums are rounded one at a time (no FMA
// contraction), as the plain PyTorch version computes them.
template <int D, bool ROPE>
__device__ __forceinline__ void rotate_chunk(float (&lo)[8], float (&hi)[8], const float* cos_t,
                                             const float* sin_t, int row, int d0, float mul) {
  constexpr int kHalf = D / 2;
  if (ROPE) {
    float c_lo[8], c_hi[8], s_lo[8], s_hi[8];
    const long long base = (long long)row * D + d0;
    load8_rounded(cos_t + base, c_lo);
    load8_rounded(cos_t + base + kHalf, c_hi);
    load8_rounded(sin_t + base, s_lo);
    load8_rounded(sin_t + base + kHalf, s_hi);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x_lo = lo[i], x_hi = hi[i];
      lo[i] = __fadd_rn(__fmul_rn(x_lo, c_lo[i]), __fmul_rn(-x_hi, s_lo[i]));
      hi[i] = __fadd_rn(__fmul_rn(x_hi, c_hi[i]), __fmul_rn(x_lo, s_hi[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lo[i] = __fmul_rn(lo[i], mul);
    hi[i] = __fmul_rn(hi[i], mul);
  }
}

// k' = bf16(rot(k)) for every row, into a contiguous [B, H, S, D] scratch.
template <int D>
__global__ void __launch_bounds__(256) rope_rotate_kernel(const Params p, __nv_bfloat16* k_rot) {
  constexpr int kHalf = D / 2;
  constexpr int kChunks = kHalf / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / kChunks;
  const int d0 = (idx % kChunks) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.seq) return;
  const __nv_bfloat16* src = p.k + b * p.k_sb + h * p.k_sh + (long long)row * p.k_ss;
  float lo[8], hi[8];
  unpack8(*reinterpret_cast<const uint4*>(src + d0), lo);
  unpack8(*reinterpret_cast<const uint4*>(src + d0 + kHalf), hi);
  rotate_chunk<D, true>(lo, hi, p.cos, p.sin, row, d0, 1.0f);
  __nv_bfloat16* dst = k_rot + (((long long)b * p.heads + h) * p.seq + row) * D;
  *reinterpret_cast<uint4*>(dst + d0) = pack8(lo);
  *reinterpret_cast<uint4*>(dst + d0 + kHalf) = pack8(hi);
}

// Issue the copies of rows [row0, row0 + 64) of src into dst[64][D + kPad].
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long ss, int row0, int seq) {
  load_rows_async<D, kBlockK, D + kPad, kThreads>(dst, src, ss, row0, seq);
}

template <int D, bool ROPE, bool ONLINE, bool SCALE_LOGITS, int EXP = kExpE, bool CARRY = false>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const Params p) {
  constexpr int kLd = D + kPad;
  constexpr int kTile = kBlockK * kLd;    // elements per K or V stage
  constexpr int kKSteps = D / 16;         // mma k-steps over the head dim (QK)
  constexpr int kNTilesS = kBlockK / 8;   // 8-key column tiles of the logits
  constexpr int kNTilesO = D / 8;         // 8-channel column tiles of the output
  constexpr int kHalf = D / 2;
  static_assert(kBlockQ <= 2 * kBlockK, "q' is staged in the two K stages");
  static_assert(!(ROPE && SCALE_LOGITS), "K3 takes pre-rotated q and k");
  static_assert(EXP == kExpE || ONLINE, "the exp2 modes keep a running max");
  static_assert(!CARRY || (ONLINE && SCALE_LOGITS && EXP == kExpE && !ROPE),
                "the ring step is the online, scale-on-logits, expf form");

  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* k_s = smem;              // [2][kBlockK][kLd]
  __nv_bfloat16* v_s = smem + 2 * kTile;  // [2][kBlockK][kLd]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = p.seq;
  const int seq_k = p.seq_k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row group of an mma fragment
  const int t = lane & 3;   // column pair within the fragment
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // q' for this CTA's rows, staged through the K stages, -> A fragments.
  for (int idx = threadIdx.x; idx < kBlockQ * (kHalf / 8); idx += kThreads) {
    const int r = idx / (kHalf / 8);
    const int d0 = (idx % (kHalf / 8)) * 8;
    const int row = q0 + r;
    float lo[8], hi[8];
    if (row < seq) {
      const __nv_bfloat16* src = qb + (long long)row * p.q_ss;
      unpack8(*reinterpret_cast<const uint4*>(src + d0), lo);
      unpack8(*reinterpret_cast<const uint4*>(src + d0 + kHalf), hi);
      rotate_chunk<D, ROPE>(lo, hi, p.cos, p.sin, row, d0, SCALE_LOGITS ? 1.0f : p.scale);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0.0f;
    }
    *reinterpret_cast<uint4*>(k_s + r * kLd + d0) = pack8(lo);
    *reinterpret_cast<uint4*>(k_s + r * kLd + d0 + kHalf) = pack8(hi);
  }
  __syncthreads();
  uint32_t qf[kKSteps][4];
  {
    const __nv_bfloat16* r_a = k_s + (warp * 16 + g) * kLd + 2 * t;
    const __nv_bfloat16* r_b = r_a + 8 * kLd;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(r_a + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(r_b + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(r_a + kk * 16 + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(r_b + kk * 16 + 8);
    }
  }
  __syncthreads();

  float o[kNTilesO][4];
#pragma unroll
  for (int n = 0; n < kNTilesO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  // Per-thread partial row sums for rows g and g + 8 (reduced over the quad at
  // the end) and, online, the running row maxima (kept equal across the quad).
  float l_part[2] = {0.0f, 0.0f};
  float m_run[2] = {-INFINITY, -INFINITY};
  // The ring step's state row of (b, h), in elements, for rows g and g + 8.
  [[maybe_unused]] long long state_row[2] = {0, 0};
  if constexpr (CARRY) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      state_row[r] = ((long long)b * p.heads + h) * seq + row;
      m_run[r] = -1e30f;  // the Pallas kernel's NEG_INF
      if (p.first || row >= seq) continue;
      m_run[r] = p.m_state[state_row[r]];
      l_part[r] = t == 0 ? p.l_state[state_row[r]] : 0.0f;
      const float* arow = p.acc + state_row[r] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kNTilesO; ++n) {
        const float2 a = *reinterpret_cast<const float2*>(arow + n * 8);
        o[n][2 * r] = a.x;
        o[n][2 * r + 1] = a.y;
      }
    }
  }

  // ldmatrix lane addressing: lane -> (matrix lane / 8, row lane % 8)
  const int lm = lane >> 3, lr = lane & 7;
  const int n_tiles = (seq_k + kBlockK - 1) / kBlockK;

  load_tile_async<D>(k_s, kb, p.k_ss, 0, seq_k);
  load_tile_async<D>(v_s, vb, p.v_ss, 0, seq_k);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      load_tile_async<D>(k_s + (stage ^ 1) * kTile, kb, p.k_ss, k0 + kBlockK, seq_k);
      load_tile_async<D>(v_s + (stage ^ 1) * kTile, vb, p.v_ss, k0 + kBlockK, seq_k);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile's group has landed; the next may be in flight
    __syncthreads();
    const __nv_bfloat16* ks = k_s + stage * kTile;
    const __nv_bfloat16* vs = v_s + stage * kTile;

    // s = q' k'^T for 16 rows x 64 keys per warp. One ldmatrix.x4 gives the
    // B fragments (b0, b1) of two k-steps for one 8-key tile.
    float s[kNTilesS][4];
#pragma unroll
    for (int n = 0; n < kNTilesS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; kk += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (n * 8 + lr) * kLd + kk * 16 + lm * 8);
        mma_bf16_16816(s[n], qf[kk], bf[0], bf[1]);
        mma_bf16_16816(s[n], qf[kk + 1], bf[2], bf[3]);
      }
    }

    // K3: scale the fp32 logits. Clamp (max-free mode), then mask keys past
    // the end: exp(-inf) == 0.
#pragma unroll
    for (int n = 0; n < kNTilesS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = SCALE_LOGITS ? __fmul_rn(s[n][e], p.scale) : s[n][e];
        if (!ONLINE) x = fminf(fmaxf(x, -kLogitClamp), kLogitClamp);
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = col < seq_k ? x : -INFINITY;
      }
    }

    if (ONLINE) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNTilesS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // The first tile always holds key 0, so m_new is finite from here on.
        const float m_new = fmaxf(m_run[r], mx[r]);
        const float alpha = softmax_exp<EXP>(m_run[r] - m_new);
        l_part[r] *= alpha;
#pragma unroll
        for (int n = 0; n < kNTilesO; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
        m_run[r] = m_new;
      }
    }

    // p = exp(s - m). The fp32 modes keep p in the logits accumulators and
    // round it to bf16 pairs in the PV loop below (packing here instead
    // measured 5-10 % slower for K1-K3: 186 registers against 175-179). The
    // bf16 mode rounds s - m to bf16 pairs and exponentiates them packed: a C
    // fragment's two adjacent columns of one row (pp[n][0]: row g, pp[n][1]:
    // row g + 8) are exactly the pair the PV A fragment takes.
    [[maybe_unused]] uint32_t pp[EXP == kExp2Bf16 ? kNTilesS : 1][2];
#pragma unroll
    for (int n = 0; n < kNTilesS; ++n) {
      if constexpr (EXP == kExp2Bf16) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t e2 =
              ex2_bf16x2(pack_bf16(s[n][2 * r] - m_run[r], s[n][2 * r + 1] - m_run[r]));
          pp[n][r] = e2;
          l_part[r] += bf16_lo(e2);
          l_part[r] += bf16_hi(e2);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = softmax_exp<EXP>(ONLINE ? s[n][e] - m_run[e >> 1] : s[n][e]);
          s[n][e] = x;
          l_part[e >> 1] += x;
        }
      }
    }

    // o += bf16(p) v: the probabilities of two neighbouring 8-key tiles are
    // exactly the A fragment of one 16-key k-step; one ldmatrix.x4.trans of V
    // gives the B fragments of two 8-channel output tiles.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      if constexpr (EXP == kExp2Bf16) {
        pa[0] = pp[2 * kk][0];
        pa[1] = pp[2 * kk][1];
        pa[2] = pp[2 * kk + 1][0];
        pa[3] = pp[2 * kk + 1][1];
      } else {
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lm & 1) * 8 + lr) * kLd + (lm >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kNTilesO; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + n * 8);
        mma_bf16_16816(o[n], pa, bf[0], bf[1]);
        mma_bf16_16816(o[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
  }

  if constexpr (CARRY) {
    if (!p.last) {  // store the state: acc undivided, m, l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= seq) continue;
        float* arow = p.acc + state_row[r] * D + 2 * t;
#pragma unroll
        for (int n = 0; n < kNTilesO; ++n) {
          *reinterpret_cast<float2*>(arow + n * 8) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
        }
        if (t == 0) {
          p.m_state[state_row[r]] = m_run[r];
          p.l_state[state_row[r]] = l_part[r];
        }
      }
      return;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* orow = p.out + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
#pragma unroll
    for (int n = 0; n < kNTilesO; ++n) {
      const float lo = __fdiv_rn(o[n][2 * r], l_part[r]);
      const float hi = __fdiv_rn(o[n][2 * r + 1], l_part[r]);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_bf16(lo, hi);
    }
    if (t == 0 && p.lse != nullptr) {  // the A/B variants store no lse
      const float m = ONLINE ? m_run[r] : 0.0f;
      p.lse[((long long)b * p.heads + h) * seq + row] = m + logf(l_part[r]);
    }
  }
}

template <int D, bool ROPE, bool ONLINE, bool SCALE_LOGITS = false, int EXP = kExpE,
          bool CARRY = false>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = 4 * kBlockK * (D + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<D, ROPE, ONLINE, SCALE_LOGITS, EXP, CARRY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, p.heads, batch);
  attn_fwd_kernel<D, ROPE, ONLINE, SCALE_LOGITS, EXP, CARRY><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(Params p, int batch, int rope, int online, __nv_bfloat16* k_rot,
                     cudaStream_t stream) {
  if (rope) {
    constexpr int kChunks = D / 16;
    dim3 grid((p.seq * kChunks + 255) / 256, p.heads, batch);
    rope_rotate_kernel<D><<<grid, 256, 0, stream>>>(p, k_rot);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    p.k = k_rot;
    p.k_ss = D;
    p.k_sh = (long long)p.seq * D;
    p.k_sb = (long long)p.heads * p.seq * D;
    return online ? launch<D, true, true>(p, batch, stream) : launch<D, true, false>(p, batch, stream);
  }
  return online ? launch<D, false, true>(p, batch, stream) : launch<D, false, false>(p, batch, stream);
}

Params make_params(const void* q, const void* k, const void* v, void* out, void* lse,
                   int heads, int seq, long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss, float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.cos = nullptr;
  p.sin = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.heads = heads;
  p.seq = seq;
  p.seq_k = seq;
  p.scale = scale;
  p.acc = nullptr;
  p.m_state = nullptr;
  p.l_state = nullptr;
  p.first = 1;
  p.last = 1;
  return p;
}

}  // namespace

// C interface, bound with ctypes by reptext_tpu_torch/ops/flash_attention.py.
// Strides are in elements; the head dim must be contiguous. With rope, k_rot
// is a contiguous [B, H, S, D] bf16 scratch the caller allocates. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int reptext_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_rot, void* out, void* lse, int batch, int heads, int seq, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int rope, int online, void* stream) {
  Params p = make_params(q, k, v, out, lse, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq < 1 || batch < 1 || heads < 1 || (rope && k_rot == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  __nv_bfloat16* kr = static_cast<__nv_bfloat16*>(k_rot);
  cudaError_t err;
  // FLUX's head dim; other widths get their instantiation when a model needs one
  if (head_dim == 128) err = dispatch<128>(p, batch, rope, online, kr, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K3: the streaming forward on pre-rotated q and k, with the scale applied to
// the fp32 logits. Strides in elements, as above; returns the cudaError_t.
extern "C" int reptext_flash_attention_streaming_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int seq, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int online, void* stream) {
  if (seq < 1 || batch < 1 || heads < 1 || head_dim != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(q, k, v, out, lse, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh,
                               k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = online ? launch<128, false, true, true>(p, batch, s)
                                 : launch<128, false, false, true>(p, batch, s);
  return static_cast<int>(err);
}

// The attention A/B variants: running max, `scale` multiplied onto the fp32
// logits (1/sqrt(D) for exp_mode 0; 1/sqrt(D) * log2(e) for the exp2 modes 1
// and 2), out only (no lse). exp_mode: 0 exp (_chunked_kernel), 1 exp2
// (_exp2_kernel), 2 packed bf16 exp2 (_bf16exp_kernel). Strides in elements,
// as above; returns the cudaError_t.
extern "C" int reptext_attention_variant_fwd(
    const void* q, const void* k, const void* v, void* out,
    int batch, int heads, int seq, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int exp_mode, void* stream) {
  if (seq < 1 || batch < 1 || heads < 1 || head_dim != 128 || exp_mode < 0 || exp_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(q, k, v, out, nullptr, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh,
                               k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (exp_mode == kExpE) err = launch<128, false, true, true, kExpE>(p, batch, s);
  else if (exp_mode == kExp2) err = launch<128, false, true, true, kExp2>(p, batch, s);
  else err = launch<128, false, true, true, kExp2Bf16>(p, batch, s);
  return static_cast<int>(err);
}

// K5's ring step: q [B, H, seq_q, D] against one K/V block [B, H, seq_k, D],
// all bf16 with the head dim contiguous, folded into the contiguous fp32 state
// acc [B, H, seq_q, D], m and l [B, H, seq_q] (see the source note). `first`
// starts the state instead of loading it; `last` writes acc / l to `out`
// (q's layout: strides o_*) and stores no state. Strides in elements;
// returns the cudaError_t of the launch.
extern "C" int reptext_ring_attention_step(
    const void* q, const void* k, const void* v, void* out, void* acc, void* m_state,
    void* l_state, int batch, int heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int first, int last, void* stream) {
  if (seq_q < 1 || seq_k < 1 || batch < 1 || heads < 1 || head_dim != 128 ||
      (last && out == nullptr) || (!(first && last) && (acc == nullptr || m_state == nullptr ||
                                                        l_state == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k, v, out, nullptr, heads, seq_q, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  p.seq_k = seq_k;
  p.acc = static_cast<float*>(acc);
  p.m_state = static_cast<float*>(m_state);
  p.l_state = static_cast<float*>(l_state);
  p.first = first;
  p.last = last;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch<128, false, true, true, kExpE, true>(p, batch, s));
}
