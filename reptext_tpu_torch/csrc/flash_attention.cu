// Joint (non-causal) flash attention forward for FLUX MMDiT blocks, sm_90a:
// one warp-specialised TMA + wgmma template for every forward kernel of the port.
//
// Replaces reptext_tpu/ops/flash_attention.py::_attn_kernel_rope (K1, RoPE
// fused, half-split channel layout), ::_attn_kernel (K2, no rotation) and
// ::_streaming_kernel (K3, the streaming kernel for S > 6144 on pre-rotated
// q and k), reptext_tpu/ops/ring_attention.py::_ring_kernel (K5, one ring step
// per launch) and the three kernels of the attention study
// (benchmarks/exp_softmax_overlap.py::_chunked_kernel, ::_bf16exp_kernel,
// benchmarks/sweep_attention.py::_exp2_kernel). The instantiations differ in
// ROPE (q rotated while staged, k from the rotated scratch), in the softmax
// (clamped and max-free, the default; or the running max, ONLINE), in the
// exponential (EXP) and in CARRY (the ring step's state in device memory).
// Where 1/sqrt(D) goes is a run-time pair of factors: folded into q' before
// its bf16 rounding (K1, K2: q_mul = 1/sqrt(D)) or multiplied onto the fp32
// logits (K3, K5 and the study: q_mul = 1).
//
// What it computes, per (b, h) and query row i, as the Pallas kernels do:
//   q' = bf16(rot(q_i) * q_mul),  k'_j = bf16(rot(k_j))
//        rot(x) = x * cos + (-x_hi ++ x_lo) * sin, with bf16-rounded tables
//        (rot = identity when ROPE is false)
//   s_j = fp32(q' . k'_j) * (1 or 1/sqrt(D), whichever q_mul left out)
//   clamped: s_j = clip(s_j, -43, 43); then s_j = -inf for j >= S_k
//   e_j = exp(s_j - m)    (m = 0 clamped, running row max online)
//   out = (sum_j bf16(e_j) v_j, fp32 accumulation) / sum_j e_j
//   lse = m + log(sum_j e_j)
// The exponential is exp2 on logits in log2 units (all but the study's kExpE):
// after the product the fp32 logits are multiplied once by log2(e) (times
// 1/sqrt(D) where it was not folded into q'), the clamp is +/-43 log2(e), the
// running max lives in log2 units, and e_j = 2^(t_j - m) is one FFMA and one
// MUFU.EX2. lse = m ln 2 + log(l), and the m that K5 stores between launches,
// go back to natural units, so device memory holds what the plain versions
// hold. q' keeps its rounding point: log2(e) is never folded into q'.
//
// What bounds it on an H100: at (1, 24, 4608, 128) one call is 4 S^2 D H =
// 2.6e11 FLOP (0.264 ms at 989 TFLOP/s) against ~0.11 GB of q/k/v/out traffic
// (0.034 ms at 3.35 TB/s): tensor-core math, and how well it is fed from L2
// and shared memory. K3 at (2, 24, 7424, 128) is 1.35e12 FLOP against
// ~0.37 GB: the same bound, more so. Each 128-query CTA reads all of K and V
// of its head from L2: 64 KB per 8.4 MFLOP tile.
//
// The design. A CTA owns 128 query rows of one (b, h) and has three
// warpgroups. Warpgroup 0 is the producer: it gives up its registers
// (setmaxnreg 24) and one thread of it streams K and V in 128-key tiles by
// TMA (cp.async.bulk.tensor through two 4-D tensor maps over (D, S, H, B)
// with the caller's strides, built on the host at every call) into two rings
// of kStages tiles each, one for K and one for V; a "full" mbarrier per tile
// counts the bytes that land, an "empty" one the consumer warps that are done
// with it, so the key loop has no __syncthreads() and a K tile is given back
// as soon as its logits exist. Rows past S_k are zero-filled by the map's
// bounds and masked to -inf. Warpgroups 1 and 2 are consumers (setmaxnreg
// 240), 64 query rows each. Both products are wgmma.mma_async m64n128k16,
// bf16 in, fp32 accumulate: S = q' k'^T with q' and the K tile read from
// shared memory (128-byte swizzle, K-major: a [rows, 128] tile is two
// [rows, 64] halves), the 64 x 128 logits in registers; O += bf16(p) V with p
// as the register A operand (the accumulator fragment has the A fragment's
// rows and column pairs, so p never leaves the registers) and V read in its
// own [keys, D] layout through the transposed-B (MN-major) descriptor. No
// ldmatrix, no B fragments in registers. The division by the row sum waits
// until after PV. q is rotated and scaled by the threads of its warpgroup
// while it is staged, once per CTA, into the swizzled q' tile (16-byte chunk
// c of row r at chunk c ^ (r % 8)).
//
// What overlaps. (1) The next tiles' loads run under this tile's math (the
// rings). (2) Within a warpgroup, tile j + 1's logits are issued before tile
// j's probabilities have gone through PV: each round issues S(j + 1) =
// q' k'^T and O += p(j) V(j) together, waits for the first only, turns
// S(j + 1) into p(j + 1) while PV still runs, then waits for PV, rescales O
// (online) and packs p(j + 1) to bf16. The pack waits for PV because PV
// reads its A fragments until it completes: written earlier, ptxas serialises
// the products (its warning C7513). (3) The two consumer warpgroups take
// turns issuing their products (one named barrier each), so one's
// exponentials run under the other's products. Measured at (1, 24, 4608, 128)
// and (2, 24, 7424, 128) on an H100 at 700 W: (2) and (3) together take about
// a tenth off the kernel that runs one product after the other; a third stage
// changed nothing measurable and 64-key tiles in 4 stages were several
// percent slower. So the tiling is 128-key tiles in 2 stages, overlapped; only
// the packed bf16 exponential runs its products one after the other (see
// launch()).
//
// Head dim and output dtype. D is a template argument, instantiated at 128
// (FLUX.1-dev), 64 (the trained-weights demo's models) and 32 (the tiny
// configs of the CLI's --tiny demo) for K1-K3 and the ring step (K5). A row
// of q', K or V is D / 64 blocks of 64 channels, each 128 bytes under the
// 128-byte swizzle, so D = 64 is one block where D = 128 is two; at D = 32 a
// row is one block of 32 channels, 64 bytes, and its tensor maps, q' tile and
// wgmma descriptors take the 64-byte swizzle (chunk c of row r at c ^ (r / 2
// % 4), the pattern every 512 bytes; the same 32-byte k-step moves the start
// within a row). The QK product takes D / 16 k-steps (2 at D = 32), PV is
// m64nDk16 and the accumulator D / 2 registers a thread. RoPE's pairs (i, i +
// D/2) are two blocks apart at D = 128 and inside one block at D = 64 and 32
// (at 32: chunks 0 and 2, 1 and 3 of the 64-byte row), so q is staged in chunk
// pairs and each chunk placed by its own channel. OUT_F32 writes out in fp32:
// the fp32 entries of ops/flash_attention.py round q, k and v to bf16 in the
// wrapper (TMA copies bytes and cannot convert) and keep the fp32
// accumulator's quotient, as the JAX kernels return the input's dtype; the
// ring step's last launch writes acc / l so too. The tensor-core operands are
// bf16 either way.
//
// RoPE: k is rotated once per call by rope_rotate_kernel into a bf16 scratch
// copy (k' as above), which a tensor map then streams like an unrotated k;
// rotating k inside every CTA would re-read the fp32 tables per query tile.
//
// K1's segment route: a double block's joint sequence [text; image] arrives
// as two segments, each of q, k and v a [B, H, rows, D] view with its own
// strides (the projections' outputs, never concatenated), and out leaves as
// two (each stream's dense [B, rows, H * D] output). A q row, a k row read by
// the rotation kernel and an out row pick their segment by whether the joint
// row is below the split; V takes a tensor map per segment, and since the
// split is a multiple of kBlockK each 128-key tile comes wholly from one. The
// rotated k is still one joint scratch. Nothing of the arithmetic changes, so
// the segment route's out and lse equal the joint route's bit for bit; the
// other kernels see one segment.
//
// The TPU tiling (block_q caps, _pick_chunks, _SINGLE_PASS_MAX_SEQ, K3's
// 256 x 512 blocks and VMEM scratch) followed from VMEM limits and is not
// carried over: K3 is this template with the scale on the logits, and the
// running max, row sums and accumulator that the Pallas kernel keeps in
// scratch across its kv grid axis stay in registers across the key loop. The
// wrapper still routes by _SINGLE_PASS_MAX_SEQ, for the reference's rounding
// (fp32 rotation outside the kernel, scale after the product).
//
// The attention A/B variants (reptext_attention_variant_fwd): the running
// max, `scale` on the fp32 logits, no lse store, and the exponential EXP:
//   kExpE     replaces _chunked_kernel, the online softmax over unrolled key
//             chunks: natural units, e = exp(s - m). The 128-key tiles of the
//             ring take the place of the chunks.
//   kExp2     replaces _exp2_kernel: the caller folds log2(e) into the scale,
//             e = exp2(s - m): the instantiation K3 online runs, without lse.
//   kExp2Bf16 replaces _bf16exp_kernel: s - m (log2 units) is rounded to bf16
//             and exponentiated two at a time by ex2.approx.ftz.bf16x2; the
//             packed result is the PV A fragment as it stands, and the row
//             sums add its two halves in fp32. The Pallas kernel rounds
//             logits - m (natural units) and takes exp at bf16; folding
//             log2(e) in first moves that rounding to (logits - m) * log2(e):
//             both are a relative error of 2^-9 in the exponent's argument.
// The Pallas _bf16exp_kernel and _exp2_kernel take the full row max in one
// pass over [block_q, S] fp32 logits held in VMEM; a [64, 4608] fp32 row tile
// is far beyond one CTA's registers, so these take the running max instead:
// the function is the same, only where p is rounded to bf16 differs (each
// tile's p against the max so far, rescaled in fp32). sm_90's ptxas issues
// each packed ex2.approx.ftz.bf16x2 as two MUFU.EX2.BF16, one per half.
//
// The ring step (reptext_ring_attention_step, CARRY) replaces _ring_kernel
// (K5). The Pallas kernel is one program per device that rotates K/V blocks
// to its right neighbour by in-kernel RDMA and folds each block into an fp32
// online-softmax state. Here one launch is one ring step: the K/V transfer
// runs outside the kernel, as a collective on the group
// (reptext_tpu_torch/ops/ring_attention.py), and no kernel ever waits on
// another rank. The step is this template with the running max, no clamp, Sq
// queries against Sk keys, and the state carried between launches in device
// memory: acc [B, H, Sq, D], m and l [B, H, Sq], all fp32 and contiguous, m in
// natural units. The first step sets m = -1e30, l = 0, acc = 0 in registers,
// as the Pallas kernel initialises its scratch; a later step loads them. Each
// thread loads and stores exactly the rows and columns of its own accumulator
// fragment (rows g and g + 8 of its warp's 16, columns 2t and 2t + 1 of each
// 8-channel tile), so the state never passes through shared memory; l is
// loaded into the quad's t = 0 lane and summed over the quad at the end like
// the partial row sums. Every step but the last stores the state; the last
// writes acc / l in q's dtype and stores no state. p is rounded to bf16 for
// PV as in K1-K3, where the Pallas kernel multiplies fp32 p by fp32 V. What
// bounds it: at (1, 24, 4608, 128) over 4 ranks (Sq = Sk = 1152) a step is
// 1.63e10 FLOP (16.5 us at 989 TFLOP/s) against ~50 MB of q, k, v and the
// fp32 state in and out (14.9 us at 3.35 TB/s): the carried state nearly
// balances the step. Keeping the state in registers across the steps needs
// the transfers inside one kernel, which is later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kWgRows = 64;          // query rows per consumer warpgroup
constexpr int kConsumers = 2;        // consumer warpgroups per CTA
constexpr int kBlockQ = kWgRows * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);

// The tiling of the keys: kBlockK keys per K or V tile, kStages tiles in each
// of the K and V rings.
constexpr int kBlockK = 128;
constexpr int kStages = 2;

// The head dim D is a template argument (32, 64 or 128). A row of q', K or V
// is kBlocks channel blocks of kChannels channels, each one swizzled row of
// kRowBytes: two blocks of 64 channels (128 bytes, the 128-byte swizzle) for
// FLUX's D = 128, one for D = 64, and one of 32 channels (64 bytes, the
// 64-byte swizzle) for D = 32.
template <int D>
struct FwdShape {
  static_assert(D == 32 || D == 64 || D == 128,
                "the template is instantiated at head dims 32, 64 and 128");
  static constexpr int kChannels = box_channels(D);
  static constexpr int kRowBytes = 2 * kChannels;
  static constexpr int kBlocks = D / kChannels;
  static constexpr int kQBlockBytes = kBlockQ * kRowBytes;  // one channel block of q'
  static constexpr int kBlockBytes = kBlockK * kRowBytes;   // one channel block of a tile
  static constexpr int kTileBytes = kBlocks * kBlockBytes;
  static constexpr int kSmemBytes = 1024 /* alignment slack */ + kBlocks * kQBlockBytes +
                                    2 * kStages * kTileBytes + 4 * kStages * 8 /* mbarriers */;
};

constexpr float kLogitClamp = 43.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The softmax's exponential (see the source note).
constexpr int kExpE = 0;      // expf(s - m), natural units
constexpr int kExp2 = 1;      // ex2(s - m), s in log2 units
constexpr int kExp2Bf16 = 2;  // ex2.approx.ftz.bf16x2(bf16(s - m)), s in log2 units

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;   // the rotated copy when ROPE
  const __nv_bfloat16* v;
  const float* cos;         // [S, D] fp32, rounded to bf16 on read (ROPE only)
  const float* sin;
  void* out;                // bf16, or fp32 (OUT_F32)
  float* lse;               // [B, H, S] contiguous
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads;
  int seq;                  // query rows
  int seq_k;                // keys (== seq but for the ring step)
  float scale;              // 1/sqrt(D) (the rotation kernel ignores it)
  float q_mul;              // multiplied into q' before its bf16 rounding
  float logit_mul;          // multiplied onto the fp32 logits (includes log2(e))
  // ring step (CARRY) only: the fp32 state, contiguous, and the step's role
  float* acc;               // [B, H, seq, D]
  float* m_state;           // [B, H, seq]
  float* l_state;           // [B, H, seq]
  int first;
  int last;
  // K1's segment route: the joint rows from `split` on are row - split of a
  // second segment of q, k, v and out, each with its own strides (k read by
  // the rotation kernel only, v through a second tensor map). split is a
  // multiple of kBlockK, so a key tile lies in one segment. One segment
  // (every other call): split beyond every row and key.
  int split;
  const __nv_bfloat16* q2;
  const __nv_bfloat16* k2;
  const __nv_bfloat16* v2;
  void* out2;
  long long q2_sb, q2_sh, q2_ss;
  long long k2_sb, k2_sh, k2_ss;
  long long v2_sb, v2_sh, v2_ss;
  long long o2_sb, o2_sh, o2_ss;
};

// Row `row` of head h, batch b of q (Q) or of k, in the segment that holds it.
template <bool Q>
__device__ __forceinline__ const __nv_bfloat16* operand_row(const Params& p, int b, int h,
                                                            int row) {
  if (row < p.split) {
    return Q ? p.q + b * p.q_sb + h * p.q_sh + (long long)row * p.q_ss
             : p.k + b * p.k_sb + h * p.k_sh + (long long)row * p.k_ss;
  }
  const long long r = row - p.split;
  return Q ? p.q2 + b * p.q2_sb + h * p.q2_sh + r * p.q2_ss
           : p.k2 + b * p.k2_sb + h * p.k2_sh + r * p.k2_ss;
}

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
template <bool ROPE, int D>
__device__ __forceinline__ void rotate_chunk(float (&lo)[8], float (&hi)[8], const float* cos_t,
                                             const float* sin_t, int row, int d0, float mul) {
  if (ROPE) {
    float c_lo[8], c_hi[8], s_lo[8], s_hi[8];
    const long long base = (long long)row * D + d0;
    load8_rounded(cos_t + base, c_lo);
    load8_rounded(cos_t + base + D / 2, c_hi);
    load8_rounded(sin_t + base, s_lo);
    load8_rounded(sin_t + base + D / 2, s_hi);
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

// k' = bf16(rot(k)) for every row, into a contiguous [B, H, S, D] scratch;
// one thread per 8-channel chunk pair (d0, d0 + D/2). The heads are the
// grid's fastest axis, so the CTAs in flight read the same rows of every
// head: whole stretches of memory when k comes as the projections leave it
// ([B, S, H, D], the segment route), where a head's rows lie H * D apart.
template <int D>
__global__ void __launch_bounds__(256) rope_rotate_kernel(const Params p, __nv_bfloat16* k_rot) {
  constexpr int kPairs = D / 16;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  const int row = idx / kPairs;
  const int d0 = (idx % kPairs) * 8;
  const int h = blockIdx.x, b = blockIdx.z;
  if (row >= p.seq) return;
  const __nv_bfloat16* src = operand_row<false>(p, b, h, row);
  float lo[8], hi[8];
  unpack8(*reinterpret_cast<const uint4*>(src + d0), lo);
  unpack8(*reinterpret_cast<const uint4*>(src + d0 + D / 2), hi);
  rotate_chunk<true, D>(lo, hi, p.cos, p.sin, row, d0, 1.0f);
  __nv_bfloat16* dst = k_rot + (((long long)b * p.heads + h) * p.seq + row) * D;
  *reinterpret_cast<uint4*>(dst + d0) = pack8(lo);
  *reinterpret_cast<uint4*>(dst + d0 + D / 2) = pack8(hi);
}

template <int EXP>
__device__ __forceinline__ float softmax_exp(float x) {
  return EXP == kExpE ? expf(x) : ex2_approx(x);
}

// The fp32 logits of one tile (a thread's accumulator fragment: s[4 j + e] is
// column k0 + 8 j + 2 t + (e & 1) of row g (e < 2) or g + 8) to probabilities,
// in place; updates the thread's partial row sums and, online, the running
// maxima. Returns in `alpha` what the accumulator's rows must be multiplied by
// (online only). TAIL: the tile reaches past the last key; those columns are
// masked to -inf, exp(-inf) == 0. The bf16 mode rounds s - m to bf16 pairs and
// exponentiates them packed: a fragment's two adjacent columns of one row are
// exactly the pair the PV A fragment takes, so the packed pair is kept, as
// bits, in the first of the two.
template <bool ONLINE, int EXP, bool TAIL, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_run)[2],
                                             float (&l_part)[2], float (&alpha)[2], float mul,
                                             int k0, int seq_k, int t) {
  if constexpr (ONLINE) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (TAIL && k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= seq_k) s[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // The first tile always holds key 0, so m_new is finite from here on.
      const float m_new = fmaxf(m_run[r], mx[r] * mul);
      alpha[r] = softmax_exp<EXP>(m_run[r] - m_new);
      l_part[r] *= alpha[r];
      m_run[r] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int r = (i >> 1) & 1;
    float x0, x1;
    if constexpr (ONLINE) {
      x0 = fmaf(s[i], mul, -m_run[r]);
      x1 = fmaf(s[i + 1], mul, -m_run[r]);
    } else {  // clamp (max-free mode), then mask keys past the end
      x0 = fminf(fmaxf(s[i] * mul, -kLogitClamp * kLog2e), kLogitClamp * kLog2e);
      x1 = fminf(fmaxf(s[i + 1] * mul, -kLogitClamp * kLog2e), kLogitClamp * kLog2e);
      const int col = k0 + (i >> 2) * 8 + 2 * t;
      if (TAIL && col >= seq_k) x0 = -INFINITY;
      if (TAIL && col + 1 >= seq_k) x1 = -INFINITY;
    }
    if constexpr (EXP == kExp2Bf16) {
      const uint32_t packed = ex2_bf16x2(pack_bf16(x0, x1));
      l_part[r] += bf16_lo(packed);
      l_part[r] += bf16_hi(packed);
      s[i] = __uint_as_float(packed);
    } else {
      s[i] = softmax_exp<EXP>(x0);
      s[i + 1] = softmax_exp<EXP>(x1);
      l_part[r] += s[i];
      l_part[r] += s[i + 1];
    }
  }
}

// PIPELINED issues tile j + 1's logits before tile j's exponentials (see the
// source note). D: the head dim; OUT_F32: out is written in fp32 (the fp32
// entries), else in bf16.
template <int D, bool ROPE, bool ONLINE, int EXP, bool CARRY, bool PIPELINED, bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_v2) {
  using Shape = FwdShape<D>;
  constexpr int kBlocks = Shape::kBlocks;
  constexpr int kChannels = Shape::kChannels;
  constexpr int kRowBytes = Shape::kRowBytes;
  constexpr int kQBlockBytes = Shape::kQBlockBytes;
  constexpr int kBlockBytes = Shape::kBlockBytes;
  constexpr int kTileBytes = Shape::kTileBytes;
  constexpr int kNS = kBlockK / 2;       // logits per thread and tile
  constexpr int kKSteps = D / 16;        // wgmma k-steps over the head dim (QK)
  constexpr int kRowSteps = kRowBytes / 32;  // of them in one swizzled row
  constexpr int kPvSteps = kBlockK / 16; // wgmma k-steps over the keys (PV)
  constexpr bool kLog2Units = EXP != kExpE;
  static_assert(EXP == kExp2 || ONLINE, "the study's exponentials keep a running max");
  static_assert(!CARRY || (ONLINE && EXP == kExp2 && !ROPE),
                "the ring step is the online form on unrotated inputs");

  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 (or 512) bytes of the shared address
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sm_q = smem_addr(sm);                  // q': kBlocks x [kBlockQ][kChannels]
  const uint32_t sm_k = sm_q + kBlocks * kQBlockBytes;  // K ring: kStages x kBlocks x
                                                        // [kBlockK][kChannels]
  const uint32_t sm_v = sm_k + kStages * kTileBytes;  // V ring, the same
  const uint32_t bars = sm_v + kStages * kTileBytes;
  // tile `it` lives in slot it % kStages; its barriers flip once per round
  const auto slot = [](int it) { return it % kStages; };
  const auto round = [](int it) { return static_cast<uint32_t>(it / kStages) & 1u; };
  const auto full_k = [&](int it) { return bars + 8 * slot(it); };
  const auto empty_k = [&](int it) { return bars + 8 * (kStages + slot(it)); };
  const auto full_v = [&](int it) { return bars + 8 * (2 * kStages + slot(it)); };
  const auto empty_v = [&](int it) { return bars + 8 * (3 * kStages + slot(it)); };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = p.seq;
  const int seq_k = p.seq_k;
  const int n_tiles = (seq_k + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int k0 = it * kBlockK;
        const uint32_t kt = sm_k + slot(it) * kTileBytes;
        mbar_wait(empty_k(it), round(it) ^ 1);
        mbar_arrive_expect_tx(full_k(it), kTileBytes);
        for (int blk = 0; blk < kBlocks; ++blk) {
          tma_load_4d(kt + blk * kBlockBytes, &map_k, full_k(it), blk * kChannels, k0, h, b);
        }
        const uint32_t vt = sm_v + slot(it) * kTileBytes;
        const bool v_first = k0 < p.split;  // the tile's segment
        mbar_wait(empty_v(it), round(it) ^ 1);
        mbar_arrive_expect_tx(full_v(it), kTileBytes);
        for (int blk = 0; blk < kBlocks; ++blk) {
          tma_load_4d(vt + blk * kBlockBytes, v_first ? &map_v : &map_v2, full_v(it),
                      blk * kChannels, v_first ? k0 : k0 - p.split, h, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int cw = tid >> 7;          // consumer warpgroup
    const int wtid = tid & 127;       // thread within it
    const int warp = wtid >> 5;
    const int lane = wtid & 31;
    const int g = lane >> 2;  // row within the 8-row group of a fragment
    const int t = lane & 3;   // column pair within the fragment
    const int q0 = blockIdx.x * kBlockQ + cw * kWgRows;  // this warpgroup's first row

    // q' for this warpgroup's 64 rows, rotated and scaled, into the swizzled
    // tile: each thread takes 8-channel chunk pairs (c, c + D/2), the pairs
    // the half-split rotation mixes; channel ch of row r lands in block
    // ch / kChannels at 16-byte chunk (ch % kChannels) / 8, swizzled
    {
      constexpr int kPairs = D / 16;
      uint8_t* q_tile = sm + cw * kWgRows * kRowBytes;
      const auto store = [&](int r, int ch, const float (&f)[8]) {
        const int off = (ch / kChannels) * kQBlockBytes +
                        swizzled_offset<kRowBytes>(r, (ch % kChannels) >> 3);
        *reinterpret_cast<uint4*>(q_tile + off) = pack8(f);
      };
      for (int idx = wtid; idx < kWgRows * kPairs; idx += 128) {
        const int r = idx / kPairs;
        const int c = idx % kPairs;
        const int row = q0 + r;
        float lo[8], hi[8];
        if (row < seq) {
          const __nv_bfloat16* src = operand_row<true>(p, b, h, row);
          unpack8(*reinterpret_cast<const uint4*>(src + c * 8), lo);
          unpack8(*reinterpret_cast<const uint4*>(src + c * 8 + D / 2), hi);
          rotate_chunk<ROPE, D>(lo, hi, p.cos, p.sin, row, c * 8, p.q_mul);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0.0f;
        }
        store(r, c * 8, lo);
        store(r, c * 8 + D / 2, hi);
      }
      fence_proxy_async();
      named_barrier_sync<128>(1 + cw);
    }
    const uint32_t q_addr = sm_q + cw * kWgRows * kRowBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    // Per-thread partial row sums for rows g and g + 8 (reduced over the quad
    // at the end) and, online, the running row maxima (equal across the quad),
    // in the exponential's units.
    float l_part[2] = {0.0f, 0.0f};
    float m_run[2] = {-INFINITY, -INFINITY};
    // The ring step's state row of (b, h), in elements, for rows g and g + 8.
    [[maybe_unused]] long long state_row[2] = {0, 0};
    if constexpr (CARRY) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        state_row[r] = ((long long)b * p.heads + h) * seq + row;
        m_run[r] = -1e30f * kLog2e;  // the Pallas kernel's NEG_INF
        if (p.first || row >= seq) continue;
        m_run[r] = p.m_state[state_row[r]] * kLog2e;
        l_part[r] = t == 0 ? p.l_state[state_row[r]] : 0.0f;
        const float* arow = p.acc + state_row[r] * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 a = *reinterpret_cast<const float2*>(arow + n * 8);
          o[4 * n + 2 * r] = a.x;
          o[4 * n + 2 * r + 1] = a.y;
        }
      }
    }

    const float mul = p.logit_mul;

    // s = q' k'^T of tile `it`: 64 rows x kBlockK keys, issued and committed
    const auto issue_qk = [&](float (&s)[kNS], int it) {
      const uint32_t k_addr = sm_k + slot(it) * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const uint32_t blk = kk / kRowSteps, in = (kk % kRowSteps) * 32u;
        wgmma_ss_n128(s,
                      wgmma_desc<kRowBytes>(q_addr + blk * kQBlockBytes + in, 16, 8 * kRowBytes),
                      wgmma_desc<kRowBytes>(k_addr + blk * kBlockBytes + in, 16, 8 * kRowBytes),
                      kk != 0);
      }
      wgmma_commit();
    };

    // o += bf16(p) v of tile `it`, issued and committed
    const auto issue_pv = [&](const uint32_t (&pa)[kPvSteps][4], int it) {
      const uint32_t v_addr = sm_v + slot(it) * kTileBytes;
      wgmma_fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPvSteps; ++kk) {
        wgmma_rs_bt<D>(o, pa[kk], wgmma_desc<kRowBytes>(v_addr + kk * 16 * kRowBytes, kBlockBytes,
                                                        8 * kRowBytes));
      }
      wgmma_commit();
    };

    const auto softmax = [&](float (&s)[kNS], int it, float (&alpha)[2]) {
      const int k0 = it * kBlockK;
      if (k0 + kBlockK > seq_k) {
        softmax_tile<ONLINE, EXP, true>(s, m_run, l_part, alpha, mul, k0, seq_k, t);
      } else {
        softmax_tile<ONLINE, EXP, false>(s, m_run, l_part, alpha, mul, k0, seq_k, t);
      }
    };

    // bf16(p) as the PV A fragments: the probabilities of two neighbouring
    // 8-key tiles are the A fragment of one 16-key k-step. It runs after the
    // wait for the PV that reads the previous fragments: written any earlier,
    // ptxas serialises the products in flight.
    const auto pack = [&](const float (&s)[kNS], uint32_t (&pa)[kPvSteps][4]) {
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        // i = 8 kk + 2 a: a0 (row g, keys 2t..), a1 (row g + 8), a2, a3 (keys + 8)
        pa[i >> 3][(i >> 1) & 3] =
            EXP == kExp2Bf16 ? __float_as_uint(s[i]) : pack_bf16(s[i], s[i + 1]);
      }
    };

    const auto rescale = [&](const float (&alpha)[2]) {
      if constexpr (ONLINE) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };

    // One arrival per warp: wgmma.wait_group has made the warp's reads complete.
    const auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // The two consumer warpgroups take turns issuing their products (named
    // barriers 3 and 4, one per warpgroup: a warpgroup waits on its own and
    // signals the other's), so one's exponentials run under the other's products.
    const auto my_turn = [&] { named_barrier_sync<256>(3 + cw); };
    const auto your_turn = [&] {
      asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (cw ^ 1)), "n"(256) : "memory");
    };

    float s[kNS];
    uint32_t pa[kPvSteps][4];
    float alpha[2] = {1.0f, 1.0f};
    if constexpr (PIPELINED) {
      if (cw == 1) your_turn();  // warpgroup 0 goes first
      mbar_wait(full_k(0), 0);
      my_turn();
      issue_qk(s, 0);
      your_turn();
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      release(empty_k(0));
      softmax(s, 0, alpha);
      rescale(alpha);  // the ring step's loaded state
      pack(s, pa);
      for (int it = 1; it < n_tiles; ++it) {
        // tile it's logits and tile it - 1's PV in flight together; the
        // exponentials of tile it run while PV does
        mbar_wait(full_k(it), round(it));
        my_turn();
        issue_qk(s, it);
        mbar_wait(full_v(it - 1), round(it - 1));
        issue_pv(pa, it - 1);
        your_turn();
        wgmma_wait<1>();
        wgmma_fence_regs(s);
        release(empty_k(it));
        softmax(s, it, alpha);
        wgmma_wait<0>();
        wgmma_fence_regs(o);
        release(empty_v(it - 1));
        rescale(alpha);
        pack(s, pa);
      }
      mbar_wait(full_v(n_tiles - 1), round(n_tiles - 1));
      issue_pv(pa, n_tiles - 1);
      wgmma_wait<0>();
      wgmma_fence_regs(o);
      release(empty_v(n_tiles - 1));
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        mbar_wait(full_k(it), round(it));
        issue_qk(s, it);
        wgmma_wait<0>();
        wgmma_fence_regs(s);
        release(empty_k(it));
        softmax(s, it, alpha);
        rescale(alpha);
        pack(s, pa);
        mbar_wait(full_v(it), round(it));
        issue_pv(pa, it);
        wgmma_wait<0>();
        wgmma_fence_regs(o);
        release(empty_v(it));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
    }

    if constexpr (CARRY) {
      if (!p.last) {  // store the state: acc undivided, m (natural units), l
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + warp * 16 + g + 8 * r;
          if (row >= seq) continue;
          float* arow = p.acc + state_row[r] * D + 2 * t;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<float2*>(arow + n * 8) =
                make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
          }
          if (t == 0) {
            p.m_state[state_row[r]] = m_run[r] * kLn2;
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
      // the row's segment of out
      const bool first_seg = row < p.split;
      void* out = first_seg ? p.out : p.out2;
      const long long orow =
          first_seg ? b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss + 2 * t
                    : b * p.o2_sb + h * p.o2_sh + (long long)(row - p.split) * p.o2_ss + 2 * t;
      const float inv = __frcp_rn(l_part[r]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float x0 = o[4 * n + 2 * r] * inv, x1 = o[4 * n + 2 * r + 1] * inv;
        if constexpr (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + orow + n * 8) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + orow + n * 8) =
              pack_bf16(x0, x1);
        }
      }
      if (t == 0 && p.lse != nullptr) {  // the A/B variants store no lse
        const float m = ONLINE ? m_run[r] * (kLog2Units ? kLn2 : 1.0f) : 0.0f;
        p.lse[((long long)b * p.heads + h) * seq + row] = m + logf(l_part[r]);
      }
    }
  }
}

template <int D, bool ROPE, bool ONLINE, int EXP = kExp2, bool CARRY = false,
          bool OUT_F32 = false>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  CUtensorMap map_k, map_v, map_v2;
  // a layout no tensor map takes (a stride that is not a positive multiple of
  // 16 bytes, a misaligned base) is refused here; V in two segments takes a
  // map each, bounded by its own rows
  const bool two = p.split < p.seq_k;
  if (!make_map(&map_k, p.k, batch, p.heads, p.seq_k, p.k_sb, p.k_sh, p.k_ss, D, kBlockK) ||
      !make_map(&map_v, p.v, batch, p.heads, two ? p.split : p.seq_k, p.v_sb, p.v_sh, p.v_ss, D,
                kBlockK) ||
      (two && !make_map(&map_v2, p.v2, batch, p.heads, p.seq_k - p.split, p.v2_sb, p.v2_sh,
                        p.v2_ss, D, kBlockK))) {
    return cudaErrorInvalidValue;
  }
  if (!two) map_v2 = map_v;
  // the packed bf16 exponential keeps its pairs in the logits' registers, which
  // leaves ptxas too few registers to overlap the two products: it runs them
  // one after the other either way, so this form takes the loop that says so
  const auto kernel = attn_fwd_kernel<D, ROPE, ONLINE, EXP, CARRY, EXP != kExp2Bf16, OUT_F32>;
  constexpr int kSmemBytes = FwdShape<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, p.heads, batch);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p, map_k, map_v, map_v2);
  return cudaGetLastError();
}

// K1, K2 and K3 (CARRY: K5's step) at head dim D and the call's output dtype.
template <int D, bool ROPE, bool ONLINE, bool CARRY = false>
cudaError_t launch_dtype(const Params& p, int batch, int out_f32, cudaStream_t stream) {
  return out_f32 ? launch<D, ROPE, ONLINE, kExp2, CARRY, true>(p, batch, stream)
                 : launch<D, ROPE, ONLINE, kExp2, CARRY>(p, batch, stream);
}

// The same at the call's head dim (32, 64 or 128: attention_head_dim).
template <bool ROPE, bool ONLINE, bool CARRY = false>
cudaError_t launch_attention(const Params& p, int batch, int head_dim, int out_f32,
                             cudaStream_t stream) {
  if (head_dim == 32) return launch_dtype<32, ROPE, ONLINE, CARRY>(p, batch, out_f32, stream);
  if (head_dim == 64) return launch_dtype<64, ROPE, ONLINE, CARRY>(p, batch, out_f32, stream);
  return launch_dtype<128, ROPE, ONLINE, CARRY>(p, batch, out_f32, stream);
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
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.heads = heads;
  p.seq = seq;
  p.seq_k = seq;
  p.scale = scale;
  // the scale on the fp32 logits, in log2 units; fold_scale() moves it into q'
  p.q_mul = 1.0f;
  p.logit_mul = scale * kLog2e;
  p.acc = nullptr;
  p.m_state = nullptr;
  p.l_state = nullptr;
  p.first = 1;
  p.last = 1;
  p.split = 0x7fffffff;  // one segment
  p.q2 = nullptr;
  p.k2 = nullptr;
  p.v2 = nullptr;
  p.out2 = nullptr;
  p.q2_sb = p.q2_sh = p.q2_ss = 0;
  p.k2_sb = p.k2_sh = p.k2_ss = 0;
  p.v2_sb = p.v2_sh = p.v2_ss = 0;
  p.o2_sb = p.o2_sh = p.o2_ss = 0;
  return p;
}

// K1, K2: 1/sqrt(D) folded into q' before its bf16 rounding.
void fold_scale(Params& p) {
  p.q_mul = p.scale;
  p.logit_mul = kLog2e;
}

// The head dims the attention entries (K1, K2, K3) and K5's ring step are
// instantiated at: FLUX's 128, the trained-weights demo's 64 and the tiny
// configs' 32. The study's variants are instantiated at FLUX's alone.
constexpr int kFluxD = 128;

bool attention_head_dim(int head_dim) {
  return head_dim == 32 || head_dim == 64 || head_dim == 128;
}

}  // namespace

// C interface, bound with ctypes by reptext_tpu_torch/ops/flash_attention.py.
// Strides are in elements; the head dim must be contiguous, every other stride
// a multiple of 8 elements and the bases 16-byte aligned (what a tensor map
// takes). q, k and v are bf16; out is bf16, or fp32 when out_f32 (the fp32
// entries: the wrapper rounds their inputs to bf16, the kernel writes its fp32
// accumulator divided by the row sum). With rope, k_rot is a contiguous
// [B, H, S, D] bf16 scratch the caller allocates. With rope, split in (0, seq)
// and a multiple of 128 gives the joint sequence as two segments: rows below
// split at q, k, v and out, the rest at q2, k2, v2 and out2 (strides *2_*),
// each [B, H, rows, D]; split == seq is one segment (q2 ... unused). Returns
// the cudaError_t of the launches (0 on success).
extern "C" int reptext_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* k_rot, void* out, void* lse, int batch, int heads, int seq, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int rope, int online, int out_f32,
    int split, const void* q2, const void* k2, const void* v2, void* out2,
    long long q2_sb, long long q2_sh, long long q2_ss,
    long long k2_sb, long long k2_sh, long long k2_ss,
    long long v2_sb, long long v2_sh, long long v2_ss,
    long long o2_sb, long long o2_sh, long long o2_ss, void* stream) {
  const bool two = split != seq;
  if (seq < 1 || batch < 1 || heads < 1 || !attention_head_dim(head_dim) ||
      (rope && k_rot == nullptr) ||
      (two && (!rope || split < 1 || split > seq || split % kBlockK != 0 || q2 == nullptr ||
               k2 == nullptr || v2 == nullptr || out2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k, v, out, lse, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  fold_scale(p);
  if (two) {
    p.split = split;
    p.q2 = static_cast<const __nv_bfloat16*>(q2);
    p.k2 = static_cast<const __nv_bfloat16*>(k2);
    p.v2 = static_cast<const __nv_bfloat16*>(v2);
    p.out2 = out2;
    p.q2_sb = q2_sb; p.q2_sh = q2_sh; p.q2_ss = q2_ss;
    p.k2_sb = k2_sb; p.k2_sh = k2_sh; p.k2_ss = k2_ss;
    p.v2_sb = v2_sb; p.v2_sh = v2_sh; p.v2_ss = v2_ss;
    p.o2_sb = o2_sb; p.o2_sh = o2_sh; p.o2_ss = o2_ss;
  }
  p.cos = static_cast<const float*>(cos_t);
  p.sin = static_cast<const float*>(sin_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rope) {
    dim3 grid(heads, (seq * (head_dim / 16) + 255) / 256, batch);
    __nv_bfloat16* k_out = static_cast<__nv_bfloat16*>(k_rot);
    if (head_dim == 32) {
      rope_rotate_kernel<32><<<grid, 256, 0, s>>>(p, k_out);
    } else if (head_dim == 64) {
      rope_rotate_kernel<64><<<grid, 256, 0, s>>>(p, k_out);
    } else {
      rope_rotate_kernel<128><<<grid, 256, 0, s>>>(p, k_out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.k = k_out;
    p.k_ss = head_dim;
    p.k_sh = (long long)seq * head_dim;
    p.k_sb = (long long)heads * seq * head_dim;
    err = online ? launch_attention<true, true>(p, batch, head_dim, out_f32, s)
                 : launch_attention<true, false>(p, batch, head_dim, out_f32, s);
  } else {
    err = online ? launch_attention<false, true>(p, batch, head_dim, out_f32, s)
                 : launch_attention<false, false>(p, batch, head_dim, out_f32, s);
  }
  return static_cast<int>(err);
}

// K3: the streaming forward on pre-rotated q and k, with the scale applied to
// the fp32 logits. Strides in elements and out_f32, as above; returns the
// cudaError_t.
extern "C" int reptext_flash_attention_streaming_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int seq, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int online, int out_f32, void* stream) {
  if (seq < 1 || batch < 1 || heads < 1 || !attention_head_dim(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = make_params(q, k, v, out, lse, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh,
                               k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = online ? launch_attention<false, true>(p, batch, head_dim, out_f32, s)
                                 : launch_attention<false, false>(p, batch, head_dim, out_f32, s);
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
  if (seq < 1 || batch < 1 || heads < 1 || head_dim != kFluxD || exp_mode < 0 || exp_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k, v, out, nullptr, heads, seq, q_sb, q_sh, q_ss, k_sb, k_sh,
                         k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale);
  p.logit_mul = scale;  // the caller's units: natural for exp, log2 for exp2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (exp_mode == kExpE) err = launch<kFluxD, false, true, kExpE>(p, batch, s);
  else if (exp_mode == kExp2) err = launch<kFluxD, false, true, kExp2>(p, batch, s);
  else err = launch<kFluxD, false, true, kExp2Bf16>(p, batch, s);
  return static_cast<int>(err);
}

// K5's ring step: q [B, H, seq_q, D] against one K/V block [B, H, seq_k, D], D
// 32, 64 or 128, all bf16 with the head dim contiguous, folded into the
// contiguous fp32 state acc [B, H, seq_q, D], m and l [B, H, seq_q] (see the
// source note). `first` starts the state instead of loading it; `last` writes
// acc / l to `out` (q's layout: strides o_*; fp32 when out_f32, the fp32
// entry's, else bf16) and stores no state. Strides in elements; returns the
// cudaError_t of the launch.
extern "C" int reptext_ring_attention_step(
    const void* q, const void* k, const void* v, void* out, void* acc, void* m_state,
    void* l_state, int batch, int heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int first, int last, int out_f32, void* stream) {
  if (seq_q < 1 || seq_k < 1 || batch < 1 || heads < 1 || !attention_head_dim(head_dim) ||
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
  return static_cast<int>(launch_attention<false, true, true>(p, batch, head_dim, out_f32, s));
}
