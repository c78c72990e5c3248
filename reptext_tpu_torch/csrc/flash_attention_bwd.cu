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

constexpr int kD = 128;              // head dim (FLUX's)
constexpr int kHalf = kD / 2;        // 64 bf16: one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kWgKeys = 64;          // keys per consumer warpgroup
constexpr int kConsumers = 2;        // consumer warpgroups per CTA
constexpr int kBlockKV = kWgKeys * kConsumers;   // keys a CTA owns
constexpr int kBlockQ = 64;          // queries per streamed tile
constexpr int kStages = 2;           // stages of the Q / dO ring
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kKVHalfBytes = kBlockKV * kRowBytes;  // one 64-channel half of K or V
constexpr int kKVTileBytes = 2 * kKVHalfBytes;
constexpr int kQHalfBytes = kBlockQ * kRowBytes;    // one 64-channel half of a Q or dO tile
constexpr int kQTileBytes = 2 * kQHalfBytes;
constexpr int kDsTileBytes = kBlockKV * kRowBytes;  // [128 keys][64 queries] bf16
constexpr int kStatBytes = 2 * kBlockQ * 4;         // lse log2(e) and delta of one tile
constexpr int kStageBytes = 2 * kQTileBytes + kStatBytes;
constexpr int kDsBufs = 2;           // ds^T tiles: one barrier per query tile is enough
constexpr int kDqStageBytes = kBlockQ * kHalf * 4;  // a warpgroup's [64 queries][64 ch] fp32
constexpr int kDqBufs = 2;           // staging tiles per consumer warpgroup
constexpr int kBars = 1 + 2 * kStages + 2 * kConsumers * kDqBufs;
constexpr int kSmemBytes = 1024 /* alignment slack */ + 2 * kKVTileBytes +
                           kStages * kStageBytes + kDsBufs * kDsTileBytes +
                           kConsumers * kDqBufs * kDqStageBytes + kBars * 8 /* mbarriers */;
static_assert(kSmemBytes <= 232448, "more shared memory than an sm_90 block may take");
constexpr int kStatPad = kBlockQ;    // lse log2(e) and delta rows are padded to this

constexpr float kLogitClamp = 43.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const __nv_bfloat16* out;   // the forward's output (preprocess only)
  const __nv_bfloat16* dout;  // (preprocess only; the main kernel reads it through its map)
  const float* lse;           // [B, H, S] contiguous, natural units
  float* lse2;                // [B, H, S_pad] contiguous: lse * log2(e), 0 past S
  float* delta;               // [B, H, S_pad] contiguous, 0 past S
  float* dq_acc;              // [B, H, S, D] fp32 contiguous, zeroed by the caller
  int* dq_flags;              // [B, H, ceil(S / 64), 2] int32, zeroed by the caller
  __nv_bfloat16* dq;          // [B, H, S, D] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long o_sb, o_sh, o_ss;
  long long d_sb, d_sh, d_ss;
  int heads;
  int seq;
  int seq_pad;
  float scale;
};

// delta = rowsum(dO * O) and lse * log2(e): 16 threads per row, 8 channels each.
__global__ void __launch_bounds__(256) attn_bwd_preprocess_kernel(const BwdParams p) {
  constexpr int kChunks = kD / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = idx / kChunks;      // < seq_pad: the grid covers it exactly
  const int d0 = (idx % kChunks) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  float sum = 0.0f;
  if (row < p.seq) {
    float o[8], g[8];
    unpack8(*reinterpret_cast<const uint4*>(p.out + b * p.o_sb + h * p.o_sh +
                                            (long long)row * p.o_ss + d0), o);
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

// dq = bf16(scale * dq_acc), 8 elements a thread.
__global__ void __launch_bounds__(256) attn_bwd_epilogue_kernel(const BwdParams p, long long n8) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(p.dq_acc)[2 * idx];
  const float4 c = reinterpret_cast<const float4*>(p.dq_acc)[2 * idx + 1];
  const float f[8] = {a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale,
                      c.x * p.scale, c.y * p.scale, c.z * p.scale, c.w * p.scale};
  reinterpret_cast<uint4*>(p.dq)[idx] = pack8(f);
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

template <bool ONLINE>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const BwdParams p, const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_dq) {
  constexpr int kNS = kBlockQ / 2;         // logits per thread and tile
  constexpr int kDSteps = kD / 16;         // wgmma k-steps over the head dim (s^T, dp^T)
  constexpr int kQSteps = kBlockQ / 16;    // over the tile's queries (dv, dk)
  constexpr int kKeySteps = kBlockKV / 16; // over the CTA's keys (dq)

  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes of the shared address
  uint8_t* sm = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sm_k = smem_addr(sm);                     // 2 halves x [kBlockKV][64]
  const uint32_t sm_v = sm_k + kKVTileBytes;               // the same
  const uint32_t sm_q = sm_v + kKVTileBytes;               // kStages x 2 x [kBlockQ][64]
  const uint32_t sm_do = sm_q + kStages * kQTileBytes;     // the same
  const uint32_t sm_ds = sm_do + kStages * kQTileBytes;    // kDsBufs x [kBlockKV][kBlockQ]
  // kConsumers x kDqBufs x 2 x [kBlockQ][32] fp32
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
      tma_load_4d(sm_k, &map_k, full_kv, 0, kv0, h, b);
      tma_load_4d(sm_k + kKVHalfBytes, &map_k, full_kv, kHalf, kv0, h, b);
      tma_load_4d(sm_v, &map_v, full_kv, 0, kv0, h, b);
      tma_load_4d(sm_v + kKVHalfBytes, &map_v, full_kv, kHalf, kv0, h, b);
      const float* lse2_row = p.lse2 + bh * p.seq_pad;
      const float* delta_row = p.delta + bh * p.seq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int q0 = it * kBlockQ;
        const uint32_t qt = sm_q + slot(it) * kQTileBytes;
        const uint32_t dot = sm_do + slot(it) * kQTileBytes;
        const uint32_t st = sm_stat + slot(it) * kStatBytes;
        mbar_wait(empty(it), round(it) ^ 1);
        mbar_arrive_expect_tx(full(it), kStageBytes);
        tma_load_4d(qt, &map_q, full(it), 0, q0, h, b);
        tma_load_4d(qt + kQHalfBytes, &map_q, full(it), kHalf, q0, h, b);
        tma_load_4d(dot, &map_do, full(it), 0, q0, h, b);
        tma_load_4d(dot + kQHalfBytes, &map_do, full(it), kHalf, q0, h, b);
        bulk_load(st, lse2_row + q0, kStatBytes / 2, full(it));
        bulk_load(st + kStatBytes / 2, delta_row + q0, kStatBytes / 2, full(it));
      }
    } else if (threadIdx.x == 32 || threadIdx.x == 64) {
      // dq writer of consumer warpgroup cw: add each staged tile once the
      // key tiles before this one have added theirs
      const int cw = (threadIdx.x >> 5) - 1;
      int* const flags = p.dq_flags + bh * n_tiles * kConsumers + cw;
      for (int it = 0; it < n_tiles; ++it) {
        const uint32_t stage = dq_stage(cw, it);
        mbar_wait(dq_full(cw, it), dq_round(it));
        int* const flag = flags + it * kConsumers;
        flag_wait_eq(flag, blockIdx.x);
        fence_proxy_async_global();
        tma_reduce_add_4d(&map_dq, stage, cw * kHalf, it * kBlockQ, h, b);
        tma_reduce_add_4d(&map_dq, stage + kDqStageBytes / 2, cw * kHalf + 32, it * kBlockQ, h, b);
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

    // this warpgroup's 64 keys of K and V (A operands of s^T and dp^T) and its
    // 64-channel half of all 128 keys of K (B operand of dq)
    const uint32_t k_rows = sm_k + cw * kWgKeys * kRowBytes;
    const uint32_t v_rows = sm_v + cw * kWgKeys * kRowBytes;
    const uint32_t k_cols = sm_k + cw * kKVHalfBytes;

    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.0f;

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
        const uint32_t half = kk >> 2, in = (kk & 3) * 32u;
        wgmma_ss_n64<0, 0>(s, wgmma_desc(k_rows + half * kKVHalfBytes + in, 16, 1024),
                           wgmma_desc(q_addr + half * kQHalfBytes + in, 16, 1024), kk != 0);
      }
#pragma unroll
      for (int kk = 0; kk < kDSteps; ++kk) {
        const uint32_t half = kk >> 2, in = (kk & 3) * 32u;
        wgmma_ss_n64<0, 0>(dp, wgmma_desc(v_rows + half * kKVHalfBytes + in, 16, 1024),
                           wgmma_desc(do_addr + half * kQHalfBytes + in, 16, 1024), kk != 0);
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
      uint8_t* ds_rows = ds_ptr + buf * kDsTileBytes + key_row * kRowBytes + 4 * t;
#pragma unroll
      for (int i = 0; i < kNS; i += 2) {
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(s[i], s[i + 1]);
        const uint32_t d2 = pack_bf16(dp[i], dp[i + 1]);
        da[i >> 3][(i >> 1) & 3] = d2;
        // key_row % 8 == g for both of the thread's rows
        *reinterpret_cast<uint32_t*>(ds_rows + ((i >> 1) & 1) * 8 * kRowBytes +
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
        wgmma_rs_n128_bt(dv, pa[kk], wgmma_desc(do_addr + kk * 16 * kRowBytes, kQHalfBytes, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        wgmma_rs_n128_bt(dk, da[kk], wgmma_desc(q_addr + kk * 16 * kRowBytes, kQHalfBytes, 1024));
      }
    };

    // dq[64 queries x 64 channels] = ds k over the CTA's 128 keys, from the
    // shared tile `buf`, issued (not committed)
    const auto issue_dq = [&](float (&dq)[kNS], int buf) {
      const uint32_t ds_addr = sm_ds + buf * kDsTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeySteps; ++kk) {
        wgmma_ss_n64<1, 1>(dq, wgmma_desc(ds_addr + kk * 16 * kRowBytes, kDsTileBytes, 1024),
                           wgmma_desc(k_cols + kk * 16 * kRowBytes, kKVHalfBytes, 1024), kk != 0);
      }
    };

    // the partial dq of tile `it` handed to the dq writer. The fragment (rows
    // g and g + 8 of the warp's 16 queries, this warpgroup's 64 channels)
    // goes to one of the warpgroup's staging tiles, two boxes of [64
    // queries][32 channels] fp32 with the 128-byte swizzle (16-byte chunk c of
    // row r at chunk c ^ (r % 8)), once the writer has emptied it.
    const auto add_dq = [&](const float (&dq)[kNS], int it) {
      uint8_t* const stage_ptr = dq_ptr + (cw * kDqBufs + dq_buf(it)) * kDqStageBytes;
      mbar_wait(dq_empty(cw, it), dq_round(it) ^ 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        uint8_t* row_ptr = stage_ptr + row * kRowBytes + (2 * t & 3) * 4;
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          // channel 8 j + 2 t of the half: box j / 4, chunk 2 (j % 4) + t / 2
          *reinterpret_cast<float2*>(row_ptr + (j >> 2) * (kDqStageBytes / 2) +
                                     (((2 * (j & 3) + (t >> 1)) ^ g) << 4)) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
      fence_proxy_async();
      mbar_arrive(dq_full(cw, it));
    };

    mbar_wait(full_kv, 0);
    for (int it = 0; it < n_tiles; ++it) {
      float s[kNS], dp[kNS], dq[kNS];
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
      __nv_bfloat16* dk_row = p.dk + (bh * seq + key) * kD + 2 * t;
      __nv_bfloat16* dv_row = p.dv + (bh * seq + key) * kD + 2 * t;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk_row + n * 8) =
            pack_bf16(dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_row + n * 8) =
            pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

BwdParams make_params(const void* out, const void* dout, const void* lse, void* lse2, void* delta,
                      void* dq_acc, void* dq, void* dk, void* dv, int heads, int seq, int seq_pad,
                      long long o_sb, long long o_sh, long long o_ss,
                      long long d_sb, long long d_sh, long long d_ss, float scale) {
  BwdParams p;
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.lse2 = static_cast<float*>(lse2);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.dq_flags = nullptr;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.d_sb = d_sb; p.d_sh = d_sh; p.d_ss = d_ss;
  p.heads = heads;
  p.seq = seq;
  p.seq_pad = seq_pad;
  p.scale = scale;
  return p;
}

bool bad_shape(int batch, int heads, int seq, int seq_pad, int head_dim) {
  // FLUX's head dim; other widths get their instantiation when a model needs one
  return seq < 1 || batch < 1 || heads < 1 || head_dim != kD || seq_pad < seq ||
         seq_pad % kStatPad != 0;
}

}  // namespace

// C interface, bound with ctypes by reptext_tpu_torch/ops/flash_attention.py.
// Strides are in elements; the head dim must be contiguous, every other stride
// a multiple of 8 elements and the bases 16-byte aligned. Each function
// returns the cudaError_t of its launches (0 on success).

// delta = rowsum(dO * O) and lse * log2(e). out, dout: bf16 [B, H, S, D] with
// strides; lse: fp32 [B, H, S] contiguous; lse2, delta: fp32 [B, H, seq_pad]
// contiguous with seq_pad a multiple of 64, written whole (0 past S).
extern "C" int reptext_flash_attention_bwd_preprocess(
    const void* out, const void* dout, const void* lse, void* lse2, void* delta,
    int batch, int heads, int seq, int seq_pad, int head_dim,
    long long o_sb, long long o_sh, long long o_ss,
    long long d_sb, long long d_sh, long long d_ss, void* stream) {
  if (bad_shape(batch, heads, seq, seq_pad, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdParams p = make_params(out, dout, lse, lse2, delta, nullptr, nullptr, nullptr, nullptr,
                                  heads, seq, seq_pad, o_sb, o_sh, o_ss, d_sb, d_sh, d_ss, 0.0f);
  dim3 grid(seq_pad * (kD / 8) / 256, heads, batch);
  attn_bwd_preprocess_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The main kernel and the epilogue. q, k, v, dout: bf16 [B, H, S, D] with
// strides; lse2, delta: the preprocess pass's outputs; dq_acc: fp32 [B, H, S,
// D] contiguous and zero; dq_flags: int32 [B, H, ceil(S / 64), 2] contiguous
// and zero (the order of the dq adds); dq, dk, dv: bf16 [B, H, S, D]
// contiguous. All allocated by the caller.
extern "C" int reptext_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, void* dq_acc, void* dq_flags, void* dq, void* dk, void* dv,
    int batch, int heads, int seq, int seq_pad, int head_dim,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss,
    float scale, int online, void* stream) {
  if (bad_shape(batch, heads, seq, seq_pad, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p = make_params(nullptr, dout, nullptr, const_cast<void*>(lse2),
                            const_cast<void*>(delta), dq_acc, dq, dk, dv, heads, seq, seq_pad,
                            0, 0, 0, d_sb, d_sh, d_ss, scale);
  p.dq_flags = static_cast<int*>(dq_flags);
  CUtensorMap map_q, map_k, map_v, map_do, map_dq;
  // a layout no tensor map takes is refused here
  if (!make_map(&map_q, q, batch, heads, seq, q_sb, q_sh, q_ss, kD, kBlockQ) ||
      !make_map(&map_k, k, batch, heads, seq, k_sb, k_sh, k_ss, kD, kBlockKV) ||
      !make_map(&map_v, v, batch, heads, seq, v_sb, v_sh, v_ss, kD, kBlockKV) ||
      !make_map(&map_do, dout, batch, heads, seq, d_sb, d_sh, d_ss, kD, kBlockQ) ||
      !make_map_f32(&map_dq, dq_acc, batch, heads, seq, kD, kBlockQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = online ? attn_bwd_kernel<true> : attn_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the key tile is the fastest index: one head's CTAs run together, so its
  // slice of dq_acc stays in L2 while they add into it, and a CTA's dq
  // writers wait only on CTAs launched before it (see "Run-to-run order")
  dim3 grid((seq + kBlockKV - 1) / kBlockKV, heads, batch);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(p, map_q, map_k, map_v, map_do, map_dq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n8 = (long long)batch * heads * seq * (kD / 8);
  attn_bwd_epilogue_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, s>>>(p, n8);
  return static_cast<int>(cudaGetLastError());
}
