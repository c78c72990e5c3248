// Joint (non-causal) flash attention backward for FLUX MMDiT blocks, sm_90a:
// one warp-specialised TMA + wgmma kernel between a preprocess and an
// epilogue pass.
//
// Replaces reptext_tpu/ops/flash_attention.py::_dq_kernel (dQ) and
// ::_dkv_kernel (dK, dV), the Pallas kernels behind _flash_backward_pallas
// (K4), and the delta = sum(dO * O) that XLA computes before them. q and k
// arrive already rotated (the RoPE entry's backward rotates them in PyTorch
// with the fp32 tables and un-rotates dq and dk afterwards, as _rope_bwd
// does). What it computes, per (b, h), from the forward's saved lse:
//   delta_i = sum_d fp32(dO_i) * fp32(O_i)
//   s_ij = fp32(q_i . k_j) * scale;  clamped mode: clip(s_ij, -43, 43), with
//          the gradient passed straight through beyond the bound (the Pallas
//          kernels' choice); online mode: no clip
//   p_ij = exp(s_ij - lse_i), 0 for keys j >= S
//   dp_ij = dO_i . v_j;  ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i = scale * sum_j bf16(ds_ij) k_j
//   dk_j = scale * sum_i bf16(ds_ij) q_i;  dv_j = sum_i bf16(p_ij) dO_i
// Products run on bf16 operands with fp32 accumulation (p and ds are rounded
// to bf16 before their products, as the forward rounds p; the Pallas kernels
// keep them fp32); dq, dk, dv are written in bf16. The exponential is exp2 on
// logits in log2 units, as in the forward: p = 2^(s * scale * log2(e) - lse *
// log2(e)), one FFMA and one MUFU.EX2, the clamp at +/-43 log2(e).
//
// What bounds it on an H100: at (1, 24, 4608, 128) the five products (q k^T,
// dO v^T, p^T dO, ds^T q, ds k) are 10 S^2 D H = 6.5e11 FLOP (0.660 ms at 989
// TFLOP/s) against ~0.2 GB of operand traffic (0.06 ms at 3.35 TB/s):
// tensor-core math, how shared memory feeds it, and how much else (the
// exponentials, the packing, the dq reduction) runs under it.
//
// The design. Three launches per call:
// (1) attn_bwd_preprocess_kernel reads dO and O once (16 bytes a thread, 16
//     threads a row) and writes fp32 delta and lse * log2(e), both [B, H,
//     S_pad] with S_pad = S rounded up to 64 and zeros past S, so that a
//     64-query slice is one aligned 256-byte bulk copy.
// (2) attn_bwd_kernel: a CTA owns 128 keys of one (b, h) and has three
//     warpgroups. Warpgroup 0 is the producer (setmaxnreg 24): one thread
//     loads the CTA's K and V tiles once by TMA and then streams Q, dO, lse
//     log2(e) and delta in 64-query tiles into a two-stage ring, a "full"
//     mbarrier per stage counting the bytes that land, an "empty" one the
//     consumer warps that are done with it. Warpgroups 1 and 2 are consumers
//     (setmaxnreg 240), 64 keys each, and keep dk and dv [64 keys, 128] in
//     fp32 registers over the whole query loop. Per query tile each computes
//     the logits transposed, keys as rows: s^T = k q^T and dp^T = v dO^T
//     (wgmma m64n64k16, both operands K-major in shared memory), so that p^T
//     and ds^T in the accumulator fragment's layout are, rounded to bf16, the
//     register A operand of dv += p^T dO and dk += ds^T q (m64n128k16, dO and
//     Q read in their own [queries, D] layout through the MN-major B
//     descriptor, as the forward reads V). The query of a logit is its
//     fragment column, so lse log2(e) and delta come from the stage's stat
//     tile in shared memory. For dq the same bf16 ds^T is also written to a
//     swizzled [128 keys, 64 queries] tile in shared memory; after a named
//     barrier both warpgroups have their halves there, and each computes dq
//     [64 queries, 64 channels] = ds k over all 128 keys for its half of the
//     channels (m64n64k16 with A transposed, i.e. MN-major from shared
//     memory, and B = the resident K tile, MN-major). The ds tile is double
//     buffered, so one barrier per query tile is enough. The partial dq goes
//     from the fragment to a swizzled fp32 staging tile in shared memory (two
//     per consumer warpgroup, taken in turn) and from there into an fp32 [B,
//     H, S, D] buffer in device memory by TMA reduce-add
//     (cp.reduce.async.bulk.tensor, two boxes of 64 queries x 32 channels);
//     rows past S are dropped by the map's bounds. The adds are issued by two
//     threads of the producer warpgroup, one per consumer warpgroup (the dq
//     writers), in a fixed order: see "Run-to-run order" below. The key tile
//     is the fastest grid index, so one head's 36 CTAs (S = 4608) run
//     together and its 2.4 MB slice of the buffer stays in L2 while they add
//     85 MB into it (2.0 GB per call at batch 1). Five products per tile,
//     nothing of size S^2 leaves the chip.
// (3) attn_bwd_epilogue_kernel multiplies the fp32 dq buffer by scale and
//     writes bf16 dq.
// Queries and keys past S are zero-filled by the tensor maps' bounds and
// masked (p^T = 0 for a query >= S as well as for a key >= S), so unaligned
// and short S need no padded tensors. The 64-query tile follows from
// registers: dk and dv take 128 per consumer thread, s^T and dp^T at 64
// queries 64 more, then the bf16 fragments (32) and dq (32) in their place.
// The Pallas tiling (block_q, block_kv = 512 and the padding to them)
// followed from VMEM limits and is not carried over.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, CUDA events, median
// of 20, one call = the three launches and the zeroing of the dq buffer):
// 1.47-1.62 ms at (1, 24, 4608, 128), 403-445 TFLOP/s, 41-45 % of the bound
// (the mma.sync pair of kernels it replaces: 4.89-4.93 ms; the backward of
// PyTorch's fused attention call, SDPA, alone: 1.38-1.74 ms), and 2.83-2.98 ms
// at (2, 24, 4608, 128), every train launch's shape (44-47 %; SDPA 2.54-2.99).
// Registers hold it there: each product runs to its end before the next
// step (logits, exponentials, dv/dk with dq behind them), because the next
// tile's logits beside dk, dv, the bf16 fragments and dq would need 256
// registers a thread. The forms that were tried and lost: adding dq from the
// fragments with red.global.add.v2.f32 (the 8-byte adds cost a quarter more
// time than the staged TMA adds); the warpgroups taking turns at the tensor
// cores with dq deferred by one tile (a branch around a wgmma in flight made
// ptxas spill; peeled, no gain); adding dq under the next tile's logit
// products (spills). ptxas: 168 registers at launch, no spills.
//
// Head dims 64 and 32, and fp32 outputs. D is a template argument,
// instantiated at 128 (FLUX.1-dev), 64 (the trained-weights demo's models)
// and 32 (the tiny configs of the CLI's --tiny demo). A row of K, V, Q or dO
// is D / 64 blocks of 64 channels, so D = 64 is one block where D = 128 is
// two: s^T and dp^T take D / 16 k-steps, dv and dk are m64nDk16 products into
// D / 2 registers a thread. At D = 32 a row is one block of 32 channels, 64
// bytes, under the 64-byte swizzle (the tensor maps' and the K-major and
// MN-major descriptors'), as in the forward. dq changes its split: at D = 128
// each consumer warpgroup makes its 64-channel half of dq over all 128 keys
// of the CTA; at D = 64 and 32 there is one channel block, so each makes all
// D channels over its own 64 keys (the ds^T rows it wrote and the K rows it
// owns; at D = 32 an m64n32k16 product) and the two partials of a CTA are
// added one after the other, behind one counter per query tile that counts
// warpgroups (writer cw of key tile x waits for 2 x + cw), so the order stays
// fixed. The fp32 staging row of dq is 32 channels, 128 bytes, at every D: two
// boxes a warpgroup at D = 64 and 128, one at 32. OUT_F32 writes dq (the
// epilogue), dk and dv in fp32 and reads the forward's fp32 out in the
// preprocess pass: the fp32 entries round q, k, v and dO to bf16 in the
// wrapper (TMA copies bytes and cannot convert), and the products stay bf16.
//
// Run-to-run order: dq is a sum of one fp32 partial per key tile, and fp32
// sums depend on their order. The Pallas _dq_kernel walks the key blocks in
// grid order into one accumulator, so its dq repeats bit for bit; so does
// this one's. Every (b, h, query tile, channel half) has an int32 counter in
// device memory, zeroed with the dq buffer by the caller. The dq writer of
// key tile x waits until its counter equals x (an acquire load at GPU scope),
// issues the add, waits until the add has completed (cp.async.bulk.wait_group
// 0: its writes are performed, not just its shared-memory reads done), then
// adds one to the counter with release semantics, as FlashAttention-3's
// deterministic backward does. So the partials of one query tile land in key
// order 0, 1, 2, ... in every run. The consumers hand a staged tile to the
// writer through an mbarrier pair and go on with the next query tile; with
// two staging tiles per warpgroup a CTA may run two tiles ahead of its adds.
// Deadlock freedom rests on the launch order: a writer only waits on CTAs of
// lower key index of the same (b, h), which come earlier in the grid's
// linear order (the key tile is the fastest index) and are therefore resident
// or finished when it waits, since CTAs are dispatched in that order. If the
// grid's order ever changes, a persistent or cluster launch is needed.
// The cost: the adds of one query tile run one after another, and one
// head's CTAs start their first adds one add-latency apart (a pipeline fill
// of up to 36 adds at S = 4608), then march together. dk and dv are summed in
// one CTA's registers in a fixed order and were bit-equal across runs
// before this order was fixed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_utils.cuh"
#include "mma_utils.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kWgKeys = 64;          // keys per consumer warpgroup
constexpr int kConsumers = 2;        // consumer warpgroups per CTA
constexpr int kBlockKV = kWgKeys * kConsumers;   // keys a CTA owns
constexpr int kBlockQ = 64;          // queries per streamed tile
constexpr int kStages = 2;           // stages of the Q / dO ring
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kDsRowBytes = kBlockQ * 2;              // a ds^T row: 64 queries, bf16
constexpr int kDsTileBytes = kBlockKV * kDsRowBytes;  // [128 keys][64 queries] bf16
constexpr int kStatBytes = 2 * kBlockQ * 4;         // lse log2(e) and delta of one tile
constexpr int kDsBufs = 2;           // ds^T tiles: one barrier per query tile is enough
constexpr int kDqRowBytes = 32 * 4;                   // a dq box row: 32 channels, fp32
constexpr int kDqBoxBytes = kBlockQ * kDqRowBytes;    // [64 queries][32 ch] fp32
constexpr int kDqBufs = 2;           // staging tiles per consumer warpgroup
constexpr int kBars = 1 + 2 * kStages + 2 * kConsumers * kDqBufs;
constexpr int kStatPad = kBlockQ;    // lse log2(e) and delta rows are padded to this

// The head dim D is a template argument (32, 64 or 128): a row of K, V, Q or
// dO is kBlocks channel blocks of kChannels channels, each one swizzled row of
// kRowBytes: two blocks of 64 channels (128 bytes) for FLUX's D = 128, one for
// D = 64, one of 32 channels (64 bytes, the 64-byte swizzle) for D = 32 (see
// "Head dims 64 and 32" in the source note). A warpgroup's dq is kDqChannels
// wide, staged in kDqChannels / 32 boxes of 32 fp32 channels.
template <int D>
struct BwdShape {
  static_assert(D == 32 || D == 64 || D == 128,
                "the backward is instantiated at head dims 32, 64 and 128");
  static constexpr int kChannels = box_channels(D);
  static constexpr int kRowBytes = 2 * kChannels;
  static constexpr int kBlocks = D / kChannels;
  static constexpr int kKVBlockBytes = kBlockKV * kRowBytes;  // one channel block of K or V
  static constexpr int kQBlockBytes = kBlockQ * kRowBytes;    // one of a Q or dO tile
  static constexpr int kKVTileBytes = kBlocks * kKVBlockBytes;
  static constexpr int kQTileBytes = kBlocks * kQBlockBytes;
  static constexpr int kStageBytes = 2 * kQTileBytes + kStatBytes;
  static constexpr int kDqChannels = D < 64 ? D : 64;
  static constexpr int kDqBoxes = kDqChannels / 32;
  static constexpr int kDqStageBytes = kDqBoxes * kDqBoxBytes;  // a warpgroup's dq, fp32
  static constexpr int kSmemBytes = 1024 /* alignment slack */ + 2 * kKVTileBytes +
                                    kStages * kStageBytes + kDsBufs * kDsTileBytes +
                                    kConsumers * kDqBufs * kDqStageBytes +
                                    kBars * 8 /* mbarriers */;
  static_assert(kSmemBytes <= 232448, "more shared memory than an sm_90 block may take");
};

constexpr float kLogitClamp = 43.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* out;            // the forward's output, bf16 or fp32 (preprocess only)
  const __nv_bfloat16* dout;  // (preprocess only; the main kernel reads it through its map)
  const float* lse;           // [B, H, S] contiguous, natural units
  float* lse2;                // [B, H, S_pad] contiguous: lse * log2(e), 0 past S
  float* delta;               // [B, H, S_pad] contiguous, 0 past S
  float* dq_acc;              // [B, H, S, D] fp32 contiguous, zeroed by the caller
  int* dq_flags;              // [B, H, ceil(S / 64), 2] int32, zeroed by the caller
  void* dq;                   // [B, H, S, D] contiguous, bf16 or fp32 (OUT_F32)
  void* dk;
  void* dv;
  long long o_sb, o_sh, o_ss;
  long long d_sb, d_sh, d_ss;
  int heads;
  int seq;
  int seq_pad;
  float scale;
};

// Eight elements of a bf16 or fp32 row, widened to fp32.
template <bool F32>
__device__ __forceinline__ void load8(const void* base, long long off, float (&f)[8]) {
  if constexpr (F32) {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + off), f);
  }
}

// Eight fp32 values stored as bf16 or fp32.
template <bool F32>
__device__ __forceinline__ void store8(void* base, long long off, const float (&f)[8]) {
  if constexpr (F32) {
    float* d = static_cast<float*>(base) + off;
    *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + off) = pack8(f);
  }
}

// delta = rowsum(dO * O) and lse * log2(e): D / 8 threads per row, 8 channels
// each; O in the forward's output dtype (fp32 when OUT_F32), dO in bf16.
template <int D, bool OUT_F32>
__global__ void __launch_bounds__(256) attn_bwd_preprocess_kernel(const BwdParams p) {
  constexpr int kChunks = D / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / kChunks;      // < seq_pad: the grid covers it exactly
  const int d0 = (idx % kChunks) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  float sum = 0.0f;
  if (row < p.seq) {
    float o[8], g[8];
    load8<OUT_F32>(p.out, b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss + d0, o);
    unpack8(*reinterpret_cast<const uint4*>(p.dout + b * p.d_sb + h * p.d_sh +
                                            (long long)row * p.d_ss + d0), g);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum = fmaf(g[i], o[i], sum);
  }
#pragma unroll
  for (int off = kChunks / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (d0 == 0) {
    const long long bh = (long long)b * p.heads + h;
    p.delta[bh * p.seq_pad + row] = sum;
    p.lse2[bh * p.seq_pad + row] = row < p.seq ? p.lse[bh * p.seq + row] * kLog2e : 0.0f;
  }
}

// dq = scale * dq_acc in the output dtype, 8 elements a thread.
template <bool OUT_F32>
__global__ void __launch_bounds__(256) attn_bwd_epilogue_kernel(const BwdParams p, long long n8) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(p.dq_acc)[2 * idx];
  const float4 c = reinterpret_cast<const float4*>(p.dq_acc)[2 * idx + 1];
  const float f[8] = {a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale,
                      c.x * p.scale, c.y * p.scale, c.z * p.scale, c.w * p.scale};
  store8<OUT_F32>(p.dq, 8 * idx, f);
}

// One tile's transposed logits to p^T (in s) and ds^T (in dp), in place. A
// thread's fragment: s[4 j + e] is query q0 + 8 j + 2 t + (e & 1) (its column)
// of key key0 + 8 (e >> 1) (its row). TAIL: the tile reaches past the last
// query or the CTA past the last key; those entries are 0.
template <bool ONLINE, bool TAIL>
__device__ __forceinline__ void bwd_softmax_tile(float (&s)[kBlockQ / 2], float (&dp)[kBlockQ / 2],
                                                 const float* lse2_s, const float* delta_s,
                                                 float mul, int key0, int q0, int seq, int t) {
#pragma unroll
  for (int j = 0; j < kBlockQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2_s + 8 * j + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float lse2 = (e & 1) ? l2.y : l2.x;
      float x;
      if constexpr (ONLINE) {
        x = fmaf(s[i], mul, -lse2);
      } else {
        x = fminf(fmaxf(s[i] * mul, -kLogitClamp * kLog2e), kLogitClamp * kLog2e) - lse2;
      }
      float pr = ex2_approx(x);
      if (TAIL && (key0 + 8 * (e >> 1) >= seq || q0 + 8 * j + 2 * t + (e & 1) >= seq)) pr = 0.0f;
      s[i] = pr;
      dp[i] = pr * (dp[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

template <int D, bool ONLINE, bool OUT_F32>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_dq) {
  using Shape = BwdShape<D>;
  constexpr int kBlocks = Shape::kBlocks;
  constexpr int kChannels = Shape::kChannels;
  constexpr int kRowBytes = Shape::kRowBytes;
  constexpr int kKVBlockBytes = Shape::kKVBlockBytes;
  constexpr int kQBlockBytes = Shape::kQBlockBytes;
  constexpr int kKVTileBytes = Shape::kKVTileBytes;
  constexpr int kQTileBytes = Shape::kQTileBytes;
  constexpr int kDqChannels = Shape::kDqChannels;
  constexpr int kDqStageBytes = Shape::kDqStageBytes;
  constexpr int kNS = kBlockQ / 2;         // logits per thread and tile
  constexpr int kDSteps = D / 16;          // wgmma k-steps over the head dim (s^T, dp^T)
  constexpr int kRowSteps = kRowBytes / 32;  // of them in one swizzled row
  constexpr int kQSteps = kBlockQ / 16;    // over the tile's queries (dv, dk)
  // D = 128: a warpgroup's dq is its 64-channel half over all 128 keys of the
  // CTA; D = 64 and 32: all D channels over its own 64 keys (see "Head dims
  // 64 and 32")
  constexpr bool kSplitKeys = D <= 64;
  constexpr int kKeySteps = (kSplitKeys ? kWgKeys : kBlockKV) / 16;  // over keys (dq)

  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 (or 512) bytes of the shared address
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sm_k = smem_addr(sm);                     // kBlocks x [kBlockKV][kChannels]
  const uint32_t sm_v = sm_k + kKVTileBytes;               // the same
  const uint32_t sm_q = sm_v + kKVTileBytes;  // kStages x kBlocks x [kBlockQ][kChannels]
  const uint32_t sm_do = sm_q + kStages * kQTileBytes;     // the same
  const uint32_t sm_ds = sm_do + kStages * kQTileBytes;    // kDsBufs x [kBlockKV][kBlockQ]
  // kConsumers x kDqBufs x kDqChannels / 32 x [kBlockQ][32] fp32
  const uint32_t sm_dq = sm_ds + kDsBufs * kDsTileBytes;
  const uint32_t sm_stat = sm_dq + kConsumers * kDqBufs * kDqStageBytes;  // kStages x (lse2, delta)
  const uint32_t bars = sm_stat + kStages * kStatBytes;
  uint8_t* const ds_ptr = sm + 2 * kKVTileBytes + 2 * kStages * kQTileBytes;
  uint8_t* const dq_ptr = ds_ptr + kDsBufs * kDsTileBytes;
  const float* const stat_ptr =
      reinterpret_cast<const float*>(dq_ptr + kConsumers * kDqBufs * kDqStageBytes);
  // tile `it` lives in slot it % kStages; its barriers flip once per round
  const auto slot = [](int it) { return it % kStages; };
  const auto round = [](int it) { return static_cast<uint32_t>(it / kStages) & 1u; };
  const uint32_t full_kv = bars;
  const auto full = [&](int it) { return bars + 8 * (1 + slot(it)); };
  const auto empty = [&](int it) { return bars + 8 * (1 + kStages + slot(it)); };
  // staging tile `it % kDqBufs` of warpgroup cw: filled by its consumers,
  // emptied by its dq writer once the add has completed
  const auto dq_buf = [](int it) { return it % kDqBufs; };
  const auto dq_round = [](int it) { return static_cast<uint32_t>(it / kDqBufs) & 1u; };
  const auto dq_stage = [&](int cw, int it) {
    return sm_dq + (cw * kDqBufs + dq_buf(it)) * kDqStageBytes;
  };
  const auto dq_full = [&](int cw, int it) {
    return bars + 8 * (1 + 2 * kStages + cw * kDqBufs + dq_buf(it));
  };
  const auto dq_empty = [&](int cw, int it) {
    return bars + 8 * (1 + 2 * kStages + (kConsumers + cw) * kDqBufs + dq_buf(it));
  };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int seq = p.seq;
  const int kv0 = blockIdx.x * kBlockKV;
  const int n_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const long long bh = (long long)b * p.heads + h;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int cw = 0; cw < kConsumers; ++cw) {
      for (int i = 0; i < kDqBufs; ++i) {
        mbar_init(dq_full(cw, i), 128);  // every thread of the warpgroup
        mbar_init(dq_empty(cw, i), 1);   // the dq writer
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(full_kv, 2 * kKVTileBytes);
      for (int blk = 0; blk < kBlocks; ++blk) {
        tma_load_4d(sm_k + blk * kKVBlockBytes, &map_k, full_kv, blk * kChannels, kv0, h, b);
        tma_load_4d(sm_v + blk * kKVBlockBytes, &map_v, full_kv, blk * kChannels, kv0, h, b);
      }
      const float* lse2_row = p.lse2 + bh * p.seq_pad;
      const float* delta_row = p.delta + bh * p.seq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = it * kBlockQ;
        const uint32_t qt = sm_q + slot(it) * kQTileBytes;
        const uint32_t dot = sm_do + slot(it) * kQTileBytes;
        const uint32_t st = sm_stat + slot(it) * kStatBytes;
        mbar_wait(empty(it), round(it) ^ 1);
        mbar_arrive_expect_tx(full(it), Shape::kStageBytes);
        for (int blk = 0; blk < kBlocks; ++blk) {
          tma_load_4d(qt + blk * kQBlockBytes, &map_q, full(it), blk * kChannels, q0, h, b);
          tma_load_4d(dot + blk * kQBlockBytes, &map_do, full(it), blk * kChannels, q0, h, b);
        }
        bulk_load(st, lse2_row + q0, kStatBytes / 2, full(it));
        bulk_load(st + kStatBytes / 2, delta_row + q0, kStatBytes / 2, full(it));
      }
    } else if (threadIdx.x == 32 || threadIdx.x == 64) {
      // dq writer of consumer warpgroup cw: add each staged tile once the
      // partials before it have landed. D = 128: the key tiles before this
      // one, on this warpgroup's channel half (a counter per half); D = 64
      // and 32: the key tiles before this one and, in this CTA, warpgroup 0's
      // keys before warpgroup 1's (one counter, counting warpgroups)
      const int cw = (threadIdx.x >> 5) - 1;
      int* const flags = p.dq_flags + bh * n_tiles * kConsumers + (kSplitKeys ? 0 : cw);
      const int turn = kSplitKeys ? kConsumers * blockIdx.x + cw : blockIdx.x;
      const int ch0 = kSplitKeys ? 0 : cw * kDqChannels;
      for (int it = 0; it < n_tiles; ++it) {
        const uint32_t stage = dq_stage(cw, it);
        mbar_wait(dq_full(cw, it), dq_round(it));
        int* const flag = flags + it * kConsumers;
        flag_wait_eq(flag, turn);
        fence_proxy_async_global();
#pragma unroll
        for (int box = 0; box < Shape::kDqBoxes; ++box) {
          tma_reduce_add_4d(&map_dq, stage + box * kDqBoxBytes, ch0 + 32 * box, it * kBlockQ, h,
                            b);
        }
        bulk_commit();
        bulk_wait<0>();
        fence_proxy_async_global();
        flag_release_inc(flag);
        mbar_arrive(dq_empty(cw, it));
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
    const int key_row = cw * kWgKeys + warp * 16 + g;  // this thread's first key in the CTA
    const bool key_tail = kv0 + kBlockKV > seq;
    const float mul = p.scale * kLog2e;

    // this warpgroup's 64 keys of K and V (A operands of s^T and dp^T) and the
    // B operand of dq: its 64-channel half of all 128 keys of K (D = 128), or
    // all D channels of its own 64 keys (D = 64, 32), with the ds^T rows that
    // go with them (A of dq)
    const uint32_t k_rows = sm_k + cw * kWgKeys * kRowBytes;
    const uint32_t v_rows = sm_v + cw * kWgKeys * kRowBytes;
    const uint32_t k_cols = kSplitKeys ? k_rows : sm_k + cw * kKVBlockBytes;
    const uint32_t ds_first = kSplitKeys ? cw * kWgKeys * kDsRowBytes : 0;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

    // One arrival per warp: wgmma.wait_group has made the warp's reads complete.
    const auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    // s^T = k q^T and dp^T = v dO^T of tile `it`: 64 keys x 64 queries each,
    // issued and committed
    const auto issue_logits = [&](float (&s)[kNS], float (&dp)[kNS], int it) {
      const uint32_t q_addr = sm_q + slot(it) * kQTileBytes;
      const uint32_t do_addr = sm_do + slot(it) * kQTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        const uint32_t blk = kk / kRowSteps, in = (kk % kRowSteps) * 32u;
        wgmma_ss_n64<0, 0>(
            s, wgmma_desc<kRowBytes>(k_rows + blk * kKVBlockBytes + in, 16, 8 * kRowBytes),
            wgmma_desc<kRowBytes>(q_addr + blk * kQBlockBytes + in, 16, 8 * kRowBytes), kk != 0);
      }
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        const uint32_t blk = kk / kRowSteps, in = (kk % kRowSteps) * 32u;
        wgmma_ss_n64<0, 0>(
            dp, wgmma_desc<kRowBytes>(v_rows + blk * kKVBlockBytes + in, 16, 8 * kRowBytes),
            wgmma_desc<kRowBytes>(do_addr + blk * kQBlockBytes + in, 16, 8 * kRowBytes), kk != 0);
      }
      wgmma_commit();
    };

    // the logits of tile `it` to p^T and ds^T, in place
    const auto softmax = [&](float (&s)[kNS], float (&dp)[kNS], int it) {
      const float* lse2_s = stat_ptr + slot(it) * (kStatBytes / 4);
      const int q0 = it * kBlockQ;
      if (key_tail || q0 + kBlockQ > seq) {
        bwd_softmax_tile<ONLINE, true>(s, dp, lse2_s, lse2_s + kBlockQ, mul, kv0 + key_row, q0,
                                       seq, t);
      } else {
        bwd_softmax_tile<ONLINE, false>(s, dp, lse2_s, lse2_s + kBlockQ, mul, kv0 + key_row, q0,
                                        seq, t);
      }
    };

    // bf16 p^T and ds^T as A fragments: two neighbouring 8-query column tiles
    // are the A fragment of one 16-query k-step (i = 8 kk + 2 a: a0 row g,
    // queries 2t..; a1 row g + 8; a2, a3 queries + 8). ds^T also goes to the
    // shared tile `buf`, row = key, 16-byte chunk c (8 queries) of row r at
    // chunk c ^ (r % 8): the MN-major A operand of dq.
    const auto pack = [&](const float (&s)[kNS], const float (&dp)[kNS],
                          uint32_t (&pa)[kQSteps][4], uint32_t (&da)[kQSteps][4], int buf) {
      uint8_t* ds_rows = ds_ptr + buf * kDsTileBytes + key_row * kDsRowBytes + 4 * t;
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
        const uint32_t d2 = pack_bf16(dp[i], dp[i + 1]);
        da[i >> 3][(i >> 1) & 3] = d2;
        // key_row % 8 == g for both of the thread's rows
        *reinterpret_cast<uint32_t*>(ds_rows + ((i >> 1) & 1) * 8 * kDsRowBytes +
                                     (((i >> 2) ^ g) << 4)) = d2;
      }
      fence_proxy_async();
    };

    // dv += p^T dO and dk += ds^T q of tile `it`, issued (not committed)
    const auto issue_dkv = [&](const uint32_t (&pa)[kQSteps][4], const uint32_t (&da)[kQSteps][4],
                               int it) {
      const uint32_t q_addr = sm_q + slot(it) * kQTileBytes;
      const uint32_t do_addr = sm_do + slot(it) * kQTileBytes;
      wgmma_fence_regs(dv);
      wgmma_fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        wgmma_rs_bt<D>(dv, pa[kk], wgmma_desc<kRowBytes>(do_addr + kk * 16 * kRowBytes,
                                                         kQBlockBytes, 8 * kRowBytes));
      }
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        wgmma_rs_bt<D>(dk, da[kk], wgmma_desc<kRowBytes>(q_addr + kk * 16 * kRowBytes,
                                                         kQBlockBytes, 8 * kRowBytes));
      }
    };

    // dq[64 queries x kDqChannels] = ds k over the CTA's 128 keys (D = 128)
    // or this warpgroup's 64 (D = 64, 32), from the shared tile `buf`,
    // issued (not committed)
    const auto issue_dq = [&](float (&dq)[kDqChannels / 2], int buf) {
      const uint32_t ds_addr = sm_ds + buf * kDsTileBytes + ds_first;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        wgmma_ss_n<kDqChannels, 1, 1>(
            dq, wgmma_desc(ds_addr + kk * 16 * kDsRowBytes, kDsTileBytes, 1024),
            wgmma_desc<kRowBytes>(k_cols + kk * 16 * kRowBytes, kKVBlockBytes, 8 * kRowBytes),
            kk != 0);
      }
    };

    // the partial dq of tile `it` handed to the dq writer. The fragment (rows
    // g and g + 8 of the warp's 16 queries, this warpgroup's kDqChannels
    // channels) goes to one of the warpgroup's staging tiles, kDqChannels / 32
    // boxes of [64 queries][32 channels] fp32 with the 128-byte swizzle
    // (16-byte chunk c of row r at chunk c ^ (r % 8)), once the writer has
    // emptied it.
    const auto add_dq = [&](const float (&dq)[kDqChannels / 2], int it) {
      uint8_t* const stage_ptr = dq_ptr + (cw * kDqBufs + dq_buf(it)) * kDqStageBytes;
      mbar_wait(dq_empty(cw, it), dq_round(it) ^ 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        uint8_t* row_ptr = stage_ptr + row * kDqRowBytes + (2 * t & 3) * 4;
#pragma unroll
        for (int j = 0; j < kDqChannels / 8; ++j) {
          // channel 8 j + 2 t of the warpgroup's: box j / 4, chunk 2 (j % 4) + t / 2
          *reinterpret_cast<float2*>(row_ptr + (j >> 2) * kDqBoxBytes +
                                     (((2 * (j & 3) + (t >> 1)) ^ g) << 4)) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
      fence_proxy_async();
      mbar_arrive(dq_full(cw, it));
    };

    mbar_wait(full_kv, 0);
    for (int it = 0; it < n_tiles; ++it) {
      float s[kNS], dp[kNS], dq[kDqChannels / 2];
      uint32_t pa[kQSteps][4], da[kQSteps][4];
      mbar_wait(full(it), round(it));
      issue_logits(s, dp, it);
      wgmma_wait<0>();
      wgmma_fence_regs(s);
      wgmma_fence_regs(dp);
      softmax(s, dp, it);
      pack(s, dp, pa, da, it % kDsBufs);
      issue_dkv(pa, da, it);
      wgmma_commit();
      // both warpgroups' halves of ds^T are in shared memory past this barrier
      named_barrier_sync<128 * kConsumers>(1);
      issue_dq(dq, it % kDsBufs);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_regs(dq);
      wgmma_fence_regs(dv);
      wgmma_fence_regs(dk);
      release(empty(it));
      add_dq(dq, it);
    }

    // dk (times scale) and dv: rows g and g + 8 of the warp's 16 keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kv0 + key_row + 8 * r;
      if (key >= seq) continue;
      const long long row = (bh * seq + key) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float k0 = dk[4 * n + 2 * r] * p.scale, k1 = dk[4 * n + 2 * r + 1] * p.scale;
        const float v0 = dv[4 * n + 2 * r], v1 = dv[4 * n + 2 * r + 1];
        if constexpr (OUT_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.dk) + row + n * 8) = make_float2(k0, k1);
          *reinterpret_cast<float2*>(static_cast<float*>(p.dv) + row + n * 8) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dk) + row + n * 8) =
              pack_bf16(k0, k1);
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dv) + row + n * 8) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

BwdParams make_params(const void* out, const void* dout, const void* lse, void* lse2, void* delta,
                      void* dq_acc, void* dq, void* dk, void* dv, int heads, int seq, int seq_pad,
                      long long o_sb, long long o_sh, long long o_ss,
                      long long d_sb, long long d_sh, long long d_ss, float scale) {
  BwdParams p;
  p.out = out;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(lse2);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dq_flags = nullptr;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.d_sb = d_sb; p.d_sh = d_sh; p.d_ss = d_ss;
  p.heads = heads;
  p.seq = seq;
  p.seq_pad = seq_pad;
  p.scale = scale;
  return p;
}

bool bad_shape(int batch, int heads, int seq, int seq_pad, int head_dim) {
  // FLUX.1-dev's head dim, the trained-weights demo's and the tiny configs'
  return seq < 1 || batch < 1 || heads < 1 ||
         (head_dim != 32 && head_dim != 64 && head_dim != 128) || seq_pad < seq ||
         seq_pad % kStatPad != 0;
}

template <int D, bool OUT_F32>
cudaError_t launch_preprocess(const BwdParams& p, int batch, cudaStream_t s) {
  dim3 grid(p.seq_pad * (D / 8) / 256, p.heads, batch);
  attn_bwd_preprocess_kernel<D, OUT_F32><<<grid, 256, 0, s>>>(p);
  return cudaGetLastError();
}

template <int D, bool ONLINE, bool OUT_F32>
cudaError_t launch_backward(const BwdParams& p, const void* q, const void* k, const void* v,
                            const void* dout, int batch, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss, cudaStream_t s) {
  const int heads = p.heads, seq = p.seq;
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  // a layout no tensor map takes is refused here
  if (!make_map(&map_q, q, batch, heads, seq, q_sb, q_sh, q_ss, D, kBlockQ) ||
      !make_map(&map_k, k, batch, heads, seq, k_sb, k_sh, k_ss, D, kBlockKV) ||
      !make_map(&map_v, v, batch, heads, seq, v_sb, v_sh, v_ss, D, kBlockKV) ||
      !make_map(&map_do, dout, batch, heads, seq, p.d_sb, p.d_sh, p.d_ss, D, kBlockQ) ||
      !make_map_f32(&map_dq, p.dq_acc, batch, heads, seq, D, kBlockQ)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = attn_bwd_kernel<D, ONLINE, OUT_F32>;
  constexpr int kSmemBytes = BwdShape<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // the key tile is the fastest index: one head's CTAs run together, so its
  // slice of dq_acc stays in L2 while they add into it, and a CTA's dq
  // writers wait only on CTAs launched before it (see "Run-to-run order")
  dim3 grid((seq + kBlockKV - 1) / kBlockKV, heads, batch);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(p, map_q, map_k, map_v, map_do, map_dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n8 = (long long)batch * heads * seq * (D / 8);
  attn_bwd_epilogue_kernel<OUT_F32><<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, s>>>(p, n8);
  return cudaGetLastError();
}

template <int D, bool OUT_F32>
cudaError_t launch_backward_softmax(const BwdParams& p, int online, const void* q,
                                    const void* k, const void* v, const void* dout, int batch,
                                    long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss,
                                    long long v_sb, long long v_sh, long long v_ss,
                                    cudaStream_t s) {
  return online ? launch_backward<D, true, OUT_F32>(p, q, k, v, dout, batch, q_sb, q_sh, q_ss,
                                                    k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s)
                : launch_backward<D, false, OUT_F32>(p, q, k, v, dout, batch, q_sb, q_sh, q_ss,
                                                     k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s);
}

}  // namespace

// C interface, bound with ctypes by reptext_tpu_torch/ops/flash_attention.py.
// Strides are in elements; the head dim (32, 64 or 128) must be contiguous, every
// other stride a multiple of 8 elements and the bases 16-byte aligned. q, k,
// v and dO are bf16; out (the preprocess pass's input) and dq, dk, dv are bf16,
// or fp32 when out_f32. Each function returns the cudaError_t of its launches
// (0 on success).

// delta = rowsum(dO * O) and lse * log2(e). out, dout: [B, H, S, D] with
// strides; lse: fp32 [B, H, S] contiguous; lse2, delta: fp32 [B, H, seq_pad]
// contiguous with seq_pad a multiple of 64, written whole (0 past S).
extern "C" int reptext_flash_attention_bwd_preprocess(
    const void* out, const void* dout, const void* lse, void* lse2, void* delta,
    int batch, int heads, int seq, int seq_pad, int head_dim,
    long long o_sb, long long o_sh, long long o_ss,
    long long d_sb, long long d_sh, long long d_ss, int out_f32, void* stream) {
  if (bad_shape(batch, heads, seq, seq_pad, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdParams p = make_params(out, dout, lse, lse2, delta, nullptr, nullptr, nullptr, nullptr,
                                  heads, seq, seq_pad, o_sb, o_sh, o_ss, d_sb, d_sh, d_ss, 0.0f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 32) {
    err = out_f32 ? launch_preprocess<32, true>(p, batch, s)
                  : launch_preprocess<32, false>(p, batch, s);
  } else if (head_dim == 64) {
    err = out_f32 ? launch_preprocess<64, true>(p, batch, s)
                  : launch_preprocess<64, false>(p, batch, s);
  } else {
    err = out_f32 ? launch_preprocess<128, true>(p, batch, s)
                  : launch_preprocess<128, false>(p, batch, s);
  }
  return static_cast<int>(err);
}

// The main kernel and the epilogue. q, k, v, dout: [B, H, S, D] with strides;
// lse2, delta: the preprocess pass's outputs; dq_acc: fp32 [B, H, S, D]
// contiguous and zero; dq_flags: int32 [B, H, ceil(S / 64), 2] contiguous and
// zero (the order of the dq adds); dq, dk, dv: [B, H, S, D] contiguous. All
// allocated by the caller.
extern "C" int reptext_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, void* dq_acc, void* dq_flags, void* dq, void* dk, void* dv,
    int batch, int heads, int seq, int seq_pad, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss,
    float scale, int online, int out_f32, void* stream) {
  if (bad_shape(batch, heads, seq, seq_pad, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p = make_params(nullptr, dout, nullptr, const_cast<void*>(lse2),
                            const_cast<void*>(delta), dq_acc, dq, dk, dv, heads, seq, seq_pad,
                            0, 0, 0, d_sb, d_sh, d_ss, scale);
  p.dq_flags = static_cast<int*>(dq_flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 32) {
    err = out_f32 ? launch_backward_softmax<32, true>(p, online, q, k, v, dout, batch, q_sb, q_sh,
                                                      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s)
                  : launch_backward_softmax<32, false>(p, online, q, k, v, dout, batch, q_sb,
                                                       q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                                                       v_ss, s);
  } else if (head_dim == 64) {
    err = out_f32 ? launch_backward_softmax<64, true>(p, online, q, k, v, dout, batch, q_sb, q_sh,
                                                      q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, s)
                  : launch_backward_softmax<64, false>(p, online, q, k, v, dout, batch, q_sb,
                                                       q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                                                       v_ss, s);
  } else {
    err = out_f32 ? launch_backward_softmax<128, true>(p, online, q, k, v, dout, batch, q_sb,
                                                       q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                                                       v_ss, s)
                  : launch_backward_softmax<128, false>(p, online, q, k, v, dout, batch, q_sb,
                                                        q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                                                        v_ss, s);
  }
  return static_cast<int>(err);
}
