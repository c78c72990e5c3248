#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (reptext_tpu_torch).

    python3 chip_smoke.py                 # 4 steps, ControlNet on for the first 2; 3 train steps
    python3 chip_smoke.py --steps 30 --controlnet-step 30   # the reference op-point
    python3 chip_smoke.py --profile       # adds device profiles of two inpaint steps at
                                          # 1536x1152, two ControlNet steps at 1024^2
                                          # and one train step

Needs one CUDA device (an H100; the kernels are built for sm_90a) and exits
non-zero without one. Phases, one line each, and any failure ends the run:

1. device: the card's name and power limit from nvidia-smi;
2. build: nvcc builds the kernels from reptext_tpu_torch/csrc; registers per thread and
   spill bytes of every kernel from ptxas, its performance warnings (any one
   fails the run), and the tensor-core instructions in the SASS of every
   instantiation of the forward template and of the backward's main kernel:
   each must run on wgmma (HGMMA) and none on mma.sync (HMMA), and the
   backward's main kernel must not spill;
3. kernels: the flash-attention forward kernel (K1 RoPE-fused, K2 plain), the
   streaming forward kernel (K3, past 6144 tokens, on q and k rotated with
   the fp32 tables) and the backward (K4: preprocess pass, main kernel,
   epilogue) against their plain PyTorch versions on the card: K1/K2/K4 at
   the 1024^2 shape (1, 24, 4608, 128), K4 also at every train launch's (2,
   24, 4608, 128) and on K3's lse at (1, 24, 7424, 128), K3 at the 1536x1152
   inpaint shape (2, 24, 7424, 128) and the 1536^2 shape (1, 24, 9728, 128),
   all with RoPE tables from the real text/image ids, at unaligned lengths
   ((2, 24, 4106, 128); K3 (1, 24, 6500, 128)), K3 at the 2048^2 request's
   shapes (clamped at (1, 24, 16896, 128), the one-card path; online at (1,
   12, 16896, 128), a Ulysses rank's half of the heads) and beyond the logit
   clamp; errors and median times (kernel and plain version, with the
   achieved TFLOP/s and the bound's share of the time), K1's and K3's clamped
   against their online softmax, and K4 called twice on the same inputs
   (max|dq1 - dq2| beside its limit: the adds into dq land in another order
   each run; dk and dv must be bit-equal);
   then K5, the ring step: sequence_sharded_attention(impl="ring_kernel") over
   4 thread ranks on the card against the plain ring at (1, 24, 4608, 128)
   and (1, 24, 16896, 128), and the three steps one rank of the 2048^2 SP
   request makes (q (1, 24, 8704, 128) against the text block and two image
   blocks of 8192 keys) against the plain steps, within 2^-6 of max|plain
   out|; the step's, the whole ring's and SDPA's times beside the bound;
   Ulysses over 4 thread ranks with logits planted beyond the clamp against
   plain_attention (its local attention is an exact softmax) and against the
   clamped K2, from which it must differ; with
   two or more cards, one process per card over NCCL: the K5 ring against the
   plain ring, then the 2048^2 request of phase 10 on each card alone and with
   shard_for_sp over the cards (ring and Ulysses, each called twice: cold,
   warm), the transfers alone, and a profile of one warm step of each backend
   (one card: a line says so);
4. variants: the attention A/B kernels of the study (chunked online softmax,
   exp2, bf16 exp; reptext_tpu_torch/ops/attention_variants.py) against their
   plain versions at (1, 24, 4608, 128), their times beside the plain
   version's, SDPA's and the bound, the MUFU instructions in their SASS; then
   the study's entry points (benchmarks.sweep_attention.run and
   benchmarks.exp_softmax_overlap.run: the JAX scripts' own fp32 check at
   (1, 2, 4608, 128) and their timings), which must launch every variant and
   K2; and library_ms for K1-K4 (torch's scaled_dot_product_attention, timed
   here only as the yardstick);
5. reference: a small FLUX + ControlNet forward, and one ControlNet train
   step (loss and every ControlNet gradient), on the card (bf16, kernels)
   against the same weights on the CPU (float32, plain attention);
6. end to end: two 1024x1024 txt2img requests (an Arabic line, then a Latin
   line) through the port's CLI path (reptext_tpu_torch.cli.build_pipeline /
   generate) at full FLUX.1-dev + RepText + T5-XXL + CLIP-L + VAE geometry,
   bf16, seeded random weights; checks the image shape, finite latents and
   that K1 ran steps * 57 + controlnet_steps * 14 times per image and K2 and
   K3 none;
7. large: on the same modules, one 1536x1536 txt2img request through
   cli.generate (joint S = 9728: K3 = steps * 57 + controlnet_steps * 14, K1 =
   K2 = 0), then text inpainting through cli.generate_inpaint with one added
   inpaint ControlNet (seeded random weights): a 1280x960 request (S = 5312,
   the reference's op-point: K1 only) and a 1536x1152 one (S = 7424: K3
   only), each at true-CFG scale 3.5 with the default negative prompt, a
   seeded numpy source image and a box mask over the text line; per image
   steps * (57 + 14) + controlnet_steps * 14 launches of its kernel. Checks
   image shapes, uint8 and finite latents; prints s/image, stage seconds,
   sampler ms/step and peak memory; then frees the inpaint ControlNet;
8. with --profile: torch.profiler over two inpaint steps at 1536x1152 (in the
   large phase) and over two ControlNet steps of the txt2img sampler at 1024^2,
   device (kernel) time by class, the device's idle share and the top kernels;
9. train: on the same pipeline, the CLI's train path (reptext_tpu_torch.cli.
   train: warm start, AdamW at the CLI defaults, ElasticTrainer +
   PrefetchLoader) for 3 steps at batch 2, 1024^2, with remat; checks finite
   losses, nonzero heads and exactly-zero block gradients after step 1, a
   bit-identical base, and K1 = 141, K4 = 70, K2 = K3 = 0 launches per step;
   with --profile, then torch.profiler over one more train step;
10. sp: on the same modules, txt2img at 2048x2048 (S = 16896) for 2 steps with
   the ControlNet on both, from the same packed noise: the single-device
   pipeline (K3: 142 launches), then FluxRepTextPipeline.shard_for_sp over 2
   thread ranks on the card (parallel/testing.py) with the ring backend (K5:
   (n + 1) x 71 launches per rank and step) and the Ulysses backend (K3's
   running-max form on 12 heads per rank: 71 per rank and step); each
   gathered latent against the single device's within SP_RTOL, ranks equal;
   ms/step, peak memory. The sharded pipelines are with_config clones over the
   modules the single-device pipeline goes on using.

Then a JSON line of the eight kernels' results (launches per path, each
path's counts set to 0 just before it and read just after; times, the bound,
SDPA's time), the nvidia-smi line, and as the last line {"ok": true,
"device": {...}}. The text lines come from
tests/fixtures/conditions_1024.npz and conditions_large.npz, whose condition
arrays are used only where Pillow or a font is missing.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "conditions_1024.npz")
LARGE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "conditions_large.npz")
TRUE_GUIDANCE = 3.5

# Stated tolerances, kernel vs its plain version on the same bf16 inputs.
# Both sides round q', k' and p to bf16 at the same points but sum in another
# order, so an output element may land one bf16 ulp away: at most 2^-7 of
# max|out|. The limit is two such ulps, 2^-6 of max|plain out| in each case
# (with randn q/k/v at S = 4608 the softmax spreads over thousands of keys and
# max|out| is only ~0.13, so an absolute limit would have to be this small too).
# lse is the fp32 log of a sum over S keys: ordering error ~1e-6.
OUT_RTOL = 2.0 ** -6
LSE_ATOL = 1e-3
# Backward kernel vs its plain version on the same bf16 inputs: both round p
# and ds to bf16 at the same points but sum thousands of products in another
# order; max-abs within 2^-5 of max|plain| and mean-abs within 2^-7 of
# mean|plain|, per gradient.
GRAD_MAX_RTOL = 2.0 ** -5
GRAD_MEAN_RTOL = 2.0 ** -7
# The attention variants vs their plain versions on the same bf16 inputs:
# chunked (exp) and exp2 round p to bf16 where their plain versions do, but
# against the running max tile by tile instead of the chunk's or the row's max,
# so OUT_RTOL as above. bf16 exp adds a rounding the plain version places
# elsewhere: the kernel rounds (logits - m) * log2(e) to bf16, the plain
# version logits - m, each a relative error of 2^-9 in the exponent's argument,
# so a probability may differ by up to 2^-8 |logits - m| relative (at most
# 2^-8 / e of the row's largest one) on top of the bf16 rounding of p they
# share: twice the limit, 2^-5 of max|plain out|, as the JAX script doubles
# its own atol for this variant (4e-2 against 2e-2).
BF16EXP_RTOL = 2.0 ** -5
# Least time for the work, one H100 SXM at its published dense peaks.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Small-model reference: bf16 activations on the card vs float32 on the CPU
# with the same (bf16-valued) weights, 4 blocks deep: relative to max|ref|
# (the forward output, the loss, and each ControlNet gradient tensor).
REF_RTOL = 5e-2
DOUBLE_CALLS, SINGLE_CALLS = 19 + 38, 4 + 10
# The ring phase: K5 alone over 4 thread ranks; SP txt2img at 2048^2 (512 T5
# tokens + a 128 x 128 token grid) over 2 thread ranks on one card.
RING_RANKS, SP_RANKS, HEADS = 4, 2, 24
RING_LENGTHS = (4608, 16896)
SP_SIZE, TXT_LEN = 2048, 512
S_SP = (SP_SIZE // 16) ** 2
# SP txt2img against the single-device pipeline, latents after 2 steps:
# max_abs within 5e-2 of max|single|, the small-model reference's limit. Both
# runs are bf16 end to end and differ only where they round: the attention's
# sums in another order (split over ranks; the ring's online softmax and fp32
# state, and Ulysses' running-max K3 over 12 heads, against K3's clamped
# single pass), and cuBLAS on half the rows. A ring that drops or repeats a block moves the
# velocity by its own size, tens of percent of the latents after one step.
SP_RTOL = REF_RTOL
# One train step with remat: the forward runs every block once (57 + 14); the
# backward recomputes and differentiates every block but the base's first
# double block, whose inputs carry no gradient (the residuals join after it).
FWD_CALLS = DOUBLE_CALLS + SINGLE_CALLS
TRAIN_K4 = FWD_CALLS - 1
TRAIN_K1 = FWD_CALLS + TRAIN_K4


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def forward_counters():
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops import ring_attention as ra

    return {"K1": fa.flash_attention_rope, "K2": fa.flash_attention,
            "K3": fa.flash_attention_streaming, "K5": ra.ring_step}


def reset_launches():
    for entry in forward_counters().values():
        entry.launches = 0


def read_launches():
    return {key: entry.launches for key, entry in forward_counters().items()}


def cuda_time_ms(fn, repeats=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), min(times), max(times)


def alternated_ms(kernel, plain):
    """Medians of 20 (kernel, plain), run plain, kernel, kernel, plain: compare
    only within one call."""
    p1 = cuda_time_ms(plain)
    k1 = cuda_time_ms(kernel)
    k2 = cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain)
    return (min(k1, k2, key=lambda t: t[0]), min(p1, p2, key=lambda t: t[0]),
            f"kernel median {k1[0]:.4f} / {k2[0]:.4f} ms (min {min(k1[1], k2[1]):.4f}, max "
            f"{max(k1[2], k2[2]):.4f}); plain median {p1[0]:.4f} / {p2[0]:.4f} ms (min "
            f"{min(p1[1], p2[1]):.4f}, max {max(p1[2], p2[2]):.4f}); 20 repeats each")


def rate(flop, ms, bound_ms):
    """Achieved TFLOP/s of ``flop`` operations in ``ms``, and the bound's share of the time."""
    return f"{flop / ms / 1e9:.1f} TFLOP/s, bound / time {100 * bound_ms / ms:.1f} %"


def attention_flop(b, h, sq, sk, d=128):
    return 4 * b * h * sq * sk * d


def rope_tables(txt_len, grid_h, grid_w, device):
    """FLUX RoPE tables for [txt_len zeros; (0, row, col) grid] ids."""
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    ids = torch.cat([torch.zeros(txt_len, 3, device=device),
                     prepare_latent_image_ids(2 * grid_h, 2 * grid_w, device)])
    return rope_cos_sin_half(ids, (16, 56, 56), 10000)


def compare(name, got, want):
    (o, l), (po, pl) = got, want
    out_err = (o.float() - po.float()).abs().max().item()
    lse_err = (l - pl).abs().max().item()
    out_max = po.float().abs().max().item()
    out_lim = OUT_RTOL * out_max
    lse_rel = lse_err / max(pl.abs().max().item(), 1e-30)
    ok = out_err <= out_lim and lse_err <= LSE_ATOL and bool(torch.isfinite(o.float()).all())
    phase("kernels", f"{name}: out max_abs {out_err:.3e} (limit {out_lim:.3e} = 2^-6 x "
                     f"max|plain out| {out_max:.4f}); lse max_abs {lse_err:.3e} max_rel "
                     f"{lse_rel:.3e} (atol {LSE_ATOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain version: {name}")
    return max(out_err, lse_err)


def kernel_phase(dev):
    from reptext_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, s, d=128):
        return [torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    results = {}
    errs = {"K1": 0.0, "K2": 0.0}
    # the main path's shape: 512 T5 tokens + a 64 x 64 token grid (1024^2)
    q, k, v = qkv(1, 24, 4608)
    cos, sin = rope_tables(512, 64, 64, dev)
    for online in (False, True):
        tag = "online" if online else "clamped"
        errs["K1"] = max(errs["K1"], compare(
            f"K1 (1,24,4608,128) {tag}", fa.flash_attention_rope(q, k, v, cos, sin, online),
            fa.flash_attention_rope_plain(q, k, v, cos, sin, online)))
        errs["K2"] = max(errs["K2"], compare(
            f"K2 (1,24,4608,128) {tag}", fa.flash_attention(q, k, v, online),
            fa.flash_attention_plain(q, k, v, online)))
    for key, run, plain in (
            ("K1", lambda: fa.flash_attention_rope(q, k, v, cos, sin),
             lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin)),
            ("K2", lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v))):
        kern, pln, line = alternated_ms(run, plain)
        results[key] = {"ms": kern[0], "plain_ms": pln[0]}
        b_ms = forward_bound(1, 24, 4608, tables=key == "K1")[0]
        phase("kernels", f"{key} (1,24,4608,128) time: {line}; "
                         f"{rate(attention_flop(1, 24, 4608, 4608), kern[0], b_ms)}")
    # clamped (the default) against online softmax, alternated within this call
    ab = {False: [], True: []}
    for online in (False, True, True, False, False, True):
        ab[online].append(cuda_time_ms(
            lambda: fa.flash_attention_rope(q, k, v, cos, sin, online))[0])
    phase("kernels", "K1 (1,24,4608,128) softmax A/B, medians of 20 in the order c o o c c o: "
                     f"clamped {' / '.join(f'{t:.4f}' for t in ab[False])} ms, "
                     f"online {' / '.join(f'{t:.4f}' for t in ab[True])} ms")
    del q, k, v

    # unaligned: 10 text tokens + a 64 x 64 grid = 4106 keys, batch 2
    q, k, v = qkv(2, 24, 4106)
    cos, sin = rope_tables(10, 64, 64, dev)
    errs["K1"] = max(errs["K1"], compare(
        "K1 (2,24,4106,128)", fa.flash_attention_rope(q, k, v, cos, sin),
        fa.flash_attention_rope_plain(q, k, v, cos, sin)))
    errs["K2"] = max(errs["K2"], compare(
        "K2 (2,24,4106,128)", fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)))
    del q, k, v

    # beyond the clamp: row logits span [-80, 80]; text-only ids make the
    # rotation the identity, so both entries see the planted logits
    s, d = 1000, 128
    q = torch.zeros(1, 2, s, d, device=dev)
    k = torch.zeros(1, 2, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5          # the 1/sqrt(d) scale folds back to 80
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, 2, s, d, generator=gen, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    cos, sin = rope_tables(s, 0, 0, dev)
    got = fa.flash_attention_rope(q, k, v, cos, sin)
    lmax = (fa.flash_attention_rope_plain(q, k, v, cos, sin, online=True)[1]).max().item()
    phase("kernels", f"beyond-clamp case: unclamped lse max {lmax:.2f} (> {fa.LOGIT_CLAMP})")
    errs["K1"] = max(errs["K1"], compare(
        "K1 beyond clamp (1,2,1000,128)", got, fa.flash_attention_rope_plain(q, k, v, cos, sin)))
    errs["K2"] = max(errs["K2"], compare(
        "K2 beyond clamp (1,2,1000,128)", fa.flash_attention(q, k, v),
        fa.flash_attention_plain(q, k, v)))
    for key in results:
        results[key]["max_abs_err"] = errs[key]
    torch.cuda.empty_cache()
    return results


def streaming_kernel_phase(dev):
    """K3 against flash_attention_streaming_plain on q and k rotated with the
    fp32 tables, as the RoPE entry's route rotates them past 6144 tokens."""
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, txt_len, grid_h, grid_w):
        s = txt_len + grid_h * grid_w
        q, k, v = (torch.randn(b, 24, s, 128, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = rope_tables(txt_len, grid_h, grid_w, dev)
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v

    err, ms = 0.0, {}
    # the 1536x1152 inpaint request: 512 T5 tokens + a 72 x 96 grid, CFG batch 2
    # the 1536^2 txt2img request: 512 + 96 x 96
    for b, txt, gh, gw, modes in ((2, 512, 72, 96, (False, True)), (1, 512, 96, 96, (False,))):
        q, k, v = inputs(b, txt, gh, gw)
        shape = f"({b},24,{q.shape[2]},128)"
        for online in modes:
            err = max(err, compare(f"K3 {shape} {'online' if online else 'clamped'}",
                                   fa.flash_attention_streaming(q, k, v, online),
                                   fa.flash_attention_streaming_plain(q, k, v, online)))
        kern, pln, line = alternated_ms(lambda: fa.flash_attention_streaming(q, k, v),
                                        lambda: fa.flash_attention_streaming_plain(q, k, v))
        ms[shape] = {"ms": kern[0], "plain_ms": pln[0]}
        s_len = q.shape[2]
        phase("kernels", f"K3 {shape} time: {line}; "
                         f"{rate(attention_flop(b, 24, s_len, s_len), kern[0], forward_bound(b, 24, s_len)[0])}")
        if b == 2:
            ab = {False: [], True: []}
            for online in (False, True, True, False, False, True):
                ab[online].append(cuda_time_ms(
                    lambda: fa.flash_attention_streaming(q, k, v, online))[0])
            phase("kernels", f"K3 {shape} softmax A/B, medians of 20 in the order c o o c c o: "
                             f"clamped {' / '.join(f'{t:.4f}' for t in ab[False])} ms, "
                             f"online {' / '.join(f'{t:.4f}' for t in ab[True])} ms")
        del q, k, v
        torch.cuda.empty_cache()

    # unaligned: 100 text tokens + an 80 x 80 grid = 6500 keys (6500 % 64 = 36)
    q, k, v = inputs(1, 100, 80, 80)
    for online in (False, True):
        err = max(err, compare(f"K3 (1,24,6500,128) {'online' if online else 'clamped'}",
                               fa.flash_attention_streaming(q, k, v, online),
                               fa.flash_attention_streaming_plain(q, k, v, online)))
    del q, k, v
    # the 2048^2 request: 512 T5 tokens + a 128 x 128 grid = 16896 keys, a
    # 132-tile key loop. One card runs the clamped form over all 24 heads; a
    # Ulysses rank of two runs the online form over its 12. The plain version
    # goes four heads at a time (heads are independent): its fp32 logits of
    # all of them at once would not fit beside the rest.
    q, k, v = inputs(1, TXT_LEN, SP_SIZE // 16, SP_SIZE // 16)
    for heads, online in ((HEADS, False), (HEADS // SP_RANKS, True)):
        want = [fa.flash_attention_streaming_plain(q[:, h:h + 4], k[:, h:h + 4], v[:, h:h + 4],
                                                   online) for h in range(0, heads, 4)]
        want = tuple(torch.cat(part, dim=1) for part in zip(*want))
        err = max(err, compare(
            f"K3 (1,{heads},{S_SP + TXT_LEN},128) {'online' if online else 'clamped'}",
            fa.flash_attention_streaming(q[:, :heads], k[:, :heads], v[:, :heads], online), want))
        del want
    del q, k, v
    torch.cuda.empty_cache()
    # beyond the clamp: planted logits up to 80, which K3 scales on the fp32 logits
    s, d = 1000, 128
    q = torch.zeros(1, 2, s, d, device=dev)
    k = torch.zeros(1, 2, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, 2, s, d, generator=gen, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lmax = fa.flash_attention_streaming_plain(q, k, v, online=True)[1].max().item()
    phase("kernels", f"K3 beyond-clamp case: unclamped lse max {lmax:.2f} (> {fa.LOGIT_CLAMP})")
    err = max(err, compare("K3 beyond clamp (1,2,1000,128)", fa.flash_attention_streaming(q, k, v),
                           fa.flash_attention_streaming_plain(q, k, v)))
    torch.cuda.empty_cache()
    main = ms["(2,24,7424,128)"]
    return {"ms": main["ms"], "plain_ms": main["plain_ms"], "ms_by_shape": ms,
            "max_abs_err": err}


def compare_grads(name, got, want):
    worst = 0.0
    parts = []
    ok = True
    for tag, x, y in zip(("dq", "dk", "dv"), got, want):
        err = (x.float() - y.float()).abs()
        ref = y.float().abs()
        mx, mn = err.max().item(), err.mean().item()
        lim_mx, lim_mn = GRAD_MAX_RTOL * ref.max().item(), GRAD_MEAN_RTOL * ref.mean().item()
        ok = ok and mx <= lim_mx and mn <= lim_mn and bool(torch.isfinite(x.float()).all())
        worst = max(worst, mx)
        parts.append(f"{tag} max_abs {mx:.3e} (limit {lim_mx:.3e}) mean_abs {mn:.3e} "
                     f"(limit {lim_mn:.3e})")
    phase("kernels", f"{name}: {'; '.join(parts)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"backward kernel disagrees with its plain version: {name}")
    return worst


def plain_backward_by_heads(fa, args, online, heads=8):
    """flash_attention_backward_plain a few heads at a time (heads are
    independent): its fp32 [S, S] tensors of every head at once would not fit
    beside the rest at the larger shapes."""
    parts = [fa.flash_attention_backward_plain(*(x[:, h:h + heads] for x in args), online=online)
             for h in range(0, args[0].shape[1], heads)]
    return tuple(torch.cat(part, dim=1) for part in zip(*parts))


def backward_kernel_phase(dev):
    """K4 (preprocess, main kernel, epilogue) against flash_attention_backward_plain."""
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    gen = torch.Generator(device=dev).manual_seed(5)

    def inputs(q, k, v, cos, sin, online):
        """Rotated q/k, v, the forward's out and lse (K1, or K3 past 6144
        tokens: the RoPE entry's route), and dO laid out as merge_heads'
        gradient arrives ([B, S, H, D] memory viewed [B, H, S, D])."""
        out, lse = fa.flash_attention_rope(q, k, v, cos, sin, online)
        b, h, s, d = q.shape
        do = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
        return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v, out, lse, do

    def qkv(b, h, s, d=128):
        return [torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    def timed(shape, args):
        b, h, s = shape
        kern, plain, line = alternated_ms(lambda: fa.flash_attention_backward(*args),
                                          lambda: fa.flash_attention_backward_plain(*args))
        pre = cuda_time_ms(lambda: fa.backward_preprocess(args[3], args[4], args[5]))[0]
        phase("kernels", f"K4 ({b},{h},{s},128) time (the preprocess pass, the main kernel, the "
                         f"zeroing of its fp32 dq buffer and the epilogue): {line}; the "
                         f"preprocess pass alone {pre:.4f} ms; "
                         f"{rate(10 * b * h * s * s * 128, kern[0], backward_bound(b, h, s)[0])}")
        return {"ms": kern[0], "plain_ms": plain[0], "preprocess_ms": pre}

    err, ms = 0.0, {}
    cos, sin = rope_tables(512, 64, 64, dev)
    for b in (1, 2):
        q, k, v = qkv(b, 24, 4608)
        for online in (False, True) if b == 1 else (False,):
            args = inputs(q, k, v, cos, sin, online)
            err = max(err, compare_grads(
                f"K4 ({b},24,4608,128) {'online' if online else 'clamped'}",
                fa.flash_attention_backward(*args, online=online),
                fa.flash_attention_backward_plain(*args, online=online)))
            if not online:
                keep = args
        ms[f"({b},24,4608,128)"] = timed((b, 24, 4608), keep)
        del args
    # the train step's shape again: the preprocess pass against its plain
    # version, and two calls on the same inputs (dq's adds land in another
    # order each run; dk and dv are summed in a fixed one)
    out, lse, do = keep[3:]
    (delta, lse2), (p_delta, p_lse2) = (fa.backward_preprocess(out, lse, do),
                                        fa.backward_preprocess_plain(out, lse, do))
    d_err, d_lim = (delta - p_delta).abs().max().item(), 2.0 ** -20 * p_delta.abs().max().item()
    l_err = (lse2 - p_lse2).abs().max().item()
    ok = d_err <= d_lim and l_err <= 1e-5 and delta.shape == p_delta.shape
    phase("kernels", f"K4 preprocess (2,24,4608,128): delta max_abs {d_err:.3e} (limit {d_lim:.3e} "
                     f"= 2^-20 x max|plain delta|: fp32 sums of 128 products in another order), "
                     f"lse log2(e) max_abs {l_err:.3e} (limit 1e-5) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the backward's preprocess pass disagrees with its plain version")
    first, second = fa.flash_attention_backward(*keep), fa.flash_attention_backward(*keep)
    dq_diff = (first[0].float() - second[0].float()).abs().max().item()
    dq_lim = GRAD_MAX_RTOL * first[0].float().abs().max().item()
    same = bool(torch.equal(first[1], second[1])) and bool(torch.equal(first[2], second[2]))
    phase("kernels", f"K4 (2,24,4608,128) two calls on the same inputs: max|dq1 - dq2| "
                     f"{dq_diff:.3e} (limit {dq_lim:.3e} = 2^-5 x max|dq|); dk and dv bit-equal "
                     f"{same} -> {'ok' if same and dq_diff <= dq_lim else 'FAIL'}")
    if not (same and dq_diff <= dq_lim):
        raise SystemExit("the backward kernel is not reproducible where it must be")
    del q, k, v, keep, out, lse, do, first, second
    torch.cuda.empty_cache()

    q, k, v = qkv(2, 24, 4106)
    cos, sin = rope_tables(10, 64, 64, dev)
    args = inputs(q, k, v, cos, sin, None)
    err = max(err, compare_grads("K4 (2,24,4106,128)", fa.flash_attention_backward(*args),
                                 plain_backward_by_heads(fa, args, None)))
    del q, k, v, args
    torch.cuda.empty_cache()

    # past 6144 tokens the route's forward is K3: K4 on its lse, at the
    # 1536x1152 inpaint length (512 T5 tokens + a 72 x 96 grid)
    q, k, v = qkv(1, 24, 7424)
    cos, sin = rope_tables(512, 72, 96, dev)
    n3 = fa.flash_attention_streaming.launches
    args = inputs(q, k, v, cos, sin, None)
    if fa.flash_attention_streaming.launches != n3 + 1:
        raise SystemExit("the RoPE entry did not take K3 at 7424 tokens")
    err = max(err, compare_grads("K4 (1,24,7424,128) on K3's lse",
                                 fa.flash_attention_backward(*args),
                                 plain_backward_by_heads(fa, args, None)))
    del q, k, v, args
    torch.cuda.empty_cache()

    # beyond the clamp (the forward case's planted logits, peak 80): clamped,
    # the gradient passes straight through the clip in both versions
    s, d = 1000, 128
    q = torch.zeros(1, 2, s, d, device=dev)
    k = torch.zeros(1, 2, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, 2, s, d, generator=gen, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    cos, sin = rope_tables(s, 0, 0, dev)
    args = inputs(q, k, v, cos, sin, False)
    err = max(err, compare_grads("K4 beyond clamp (1,2,1000,128)",
                                 fa.flash_attention_backward(*args, online=False),
                                 fa.flash_attention_backward_plain(*args, online=False)))
    torch.cuda.empty_cache()
    main = ms["(1,24,4608,128)"]
    return {"ms": main["ms"], "plain_ms": main["plain_ms"], "ms_by_shape": ms,
            "max_abs_err": err, "dq_run_to_run_max_abs": dq_diff}


def bound(flop, nbytes):
    """(bound_ms, bound_by): the larger of ``flop`` at the bf16 tensor-core peak
    and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def forward_bound(b, h, s, d=128, lse=True, tables=False):
    """A forward: both products, 4 B H S^2 D FLOP; q, k, v read and out written
    once in bf16, the fp32 lse written, the fp32 [S, D] RoPE tables read."""
    return bound(4 * b * h * s * s * d,
                 4 * b * h * s * d * 2 + (4 * b * h * s if lse else 0) + (2 * s * d * 4 if tables else 0))


def backward_bound(b, h, s, d=128):
    """The backward's least work: five S^2 D products (q k^T, dO v^T, dS k,
    dS^T q, P^T dO: the five K4 makes), 10 B H S^2 D FLOP; q, k, v, out, dO and
    the lse read, dq, dk, dv written."""
    return bound(10 * b * h * s * s * d, 8 * b * h * s * d * 2 + 4 * b * h * s)


def variant_counters():
    from reptext_tpu_torch.ops import attention_variants as av
    from reptext_tpu_torch.ops import flash_attention as fa

    return {"chunked": av.chunked_attn, "bf16exp": av.bf16exp_attn, "exp2": av.exp2_attn,
            "K2": fa.flash_attention}


FWD_RE = r"attn_fwd_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)ELb(\d)EE"


def kernel_label(mangled):
    """A readable name for a kernel of the library from its mangled one: the
    forward template's instantiations by their arguments (ROPE, ONLINE, EXP,
    CARRY, PIPELINED), the backward's main kernel by its softmax, the others
    by their function name."""
    import re

    m = re.search(FWD_RE, mangled)
    if m is None:
        bwd = re.search(r"attn_bwd_kernelILb(\d)EE", mangled)
        if bwd:
            return f"K4 main {'online' if int(bwd.group(1)) else 'clamped'}"
        other = re.search(r"(rope_rotate_kernel|attn_bwd_\w+?_kernel)", mangled)
        return other.group(1) if other else mangled[:60]
    rope, online, exp, carry, overlap = (int(g) for g in m.groups())
    if carry:
        name = "K5"
    elif rope:
        name = "K1"
    else:
        name = {0: "chunked (exp)", 1: "K2/K3" + (" and exp2" if online else ""),
                2: "bf16exp (ex2.approx.ftz.bf16x2)"}[exp]
    return (f"{name} {'online' if online else 'clamped'} "
            f"[{'overlapped' if overlap else 'one product after the other'}]")


def ptxas_summary(log):
    """{kernel label: (registers per thread, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output."""
    import re

    out, fn = {}, None
    spills = (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = (int(m.group(1)), *spills)
            fn = None
    return out


def sass_ops():
    """{kernel label: {instruction: count}} for the tensor-core (HGMMA: wgmma;
    HMMA: mma.sync) and special-function (MUFU) instructions in the library's
    SASS, from cuobjdump."""
    import re

    from reptext_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.LIB_PATH], capture_output=True, text=True,
                          check=True).stdout
    ops, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = kernel_label(ln.split("Function :")[1].strip())
            ops[fn] = {}
            continue
        m = re.search(r"\b(HGMMA|HMMA|MUFU\.[A-Z0-9_.]+)\b", ln)
        if fn and m:
            ops[fn][m.group(1)] = ops[fn].get(m.group(1), 0) + 1
    return ops


def build_phase():
    """Build the library; registers and spills of every kernel from ptxas, and
    the tensor-core instructions of the forward template's instantiations and
    of the backward's main kernel: each must run its products on wgmma (HGMMA)
    and none on mma.sync (HMMA), and the backward's main kernel must not spill.
    A ptxas performance warning (it serialised wgmma products that the source
    meant to overlap) fails the run."""
    from reptext_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    phase("build", f"nvcc {' '.join(_build.ARCH_FLAGS)} built "
                   f"{os.path.relpath(_build.LIB_PATH, ROOT)} in {time.perf_counter() - t0:.1f} s")
    summary = ptxas_summary(_build.build_log["ptxas"])
    phase("build", "ptxas, registers per thread at launch (the producer warpgroup of the forward "
                   "template and of the backward's main kernel then drops to 24 and their "
                   "consumers rise to 240 by setmaxnreg) and "
                   "spill bytes (stores/loads): "
                   + " | ".join(f"{fn}: {r} regs, spill {st}/{ld}"
                                for fn, (r, st, ld) in sorted(summary.items())))
    warned = [ln for ln in _build.build_log["ptxas"].splitlines()
              if "Potential Performance Loss" in ln]
    phase("build", f"ptxas performance warnings: {len(warned)}" + "".join(
        f" | {kernel_label(w)}: {w.split('Loss:')[1].split(' in the function')[0].strip()}"
        for w in warned))
    if warned:
        raise SystemExit("ptxas warns of a performance loss in the kernels it built")
    _build.load()
    ops = sass_ops()
    forward = {fn: c for fn, c in ops.items() if fn.startswith(("K1", "K2", "K5", "chunked",
                                                                "bf16exp"))}
    phase("build", "SASS tensor-core instructions of the forward template: "
                   + " | ".join(f"{fn}: HGMMA x{c.get('HGMMA', 0)}, HMMA x{c.get('HMMA', 0)}"
                                for fn, c in sorted(forward.items())))
    bad = [fn for fn, c in forward.items() if c.get("HMMA", 0) or not c.get("HGMMA", 0)]
    served = {fn.split(" [")[0] for fn in forward}
    missing = {"K1 clamped", "K1 online", "K2/K3 clamped", "K2/K3 and exp2 online",
               "K5 online"} - served
    if bad or missing:
        raise SystemExit(f"the forward template is not on wgmma alone: {bad}; missing {missing}")
    backward = {fn: c for fn, c in ops.items() if fn.startswith("K4 main")}
    phase("build", "SASS tensor-core instructions of the backward's main kernel: "
                   + " | ".join(f"{fn}: HGMMA x{c.get('HGMMA', 0)}, HMMA x{c.get('HMMA', 0)}"
                                for fn, c in sorted(backward.items())))
    bad = [fn for fn, c in backward.items() if c.get("HMMA", 0) or not c.get("HGMMA", 0)]
    if bad or set(backward) != {"K4 main clamped", "K4 main online"}:
        raise SystemExit(f"the backward's main kernel is not on wgmma alone: {bad}; found "
                         f"{sorted(backward)}")
    spilled = [fn for fn, (_, st, ld) in summary.items() if fn.startswith("K4 main") and (st or ld)]
    if spilled:
        raise SystemExit(f"the backward's main kernel spills registers: {spilled}")
    return ops


def variants_phase(dev, sass):
    """The attention A/B kernels against their plain versions at the study's
    shape, their SASS, the study's entry points (their launch counts set to 0
    just before and read just after), and SDPA as every kernel's yardstick."""
    import torch.nn.functional as F

    from reptext_tpu_torch.benchmarks import exp_softmax_overlap, sweep_attention
    from reptext_tpu_torch.ops import attention_variants as av

    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(1, 24, 4608, 128, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    results = {}
    for key, kern, plain, rtol in (
            ("chunked", av.chunked_attn, av.chunked_attn_plain, OUT_RTOL),
            ("exp2", av.exp2_attn, av.exp2_attn_plain, OUT_RTOL),
            ("bf16exp", av.bf16exp_attn, av.bf16exp_attn_plain, BF16EXP_RTOL)):
        got, want = kern(q, k, v), plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        out_max = want.float().abs().max().item()
        ok = err <= rtol * out_max and bool(torch.isfinite(got.float()).all())
        phase("variants", f"{key} (1,24,4608,128): out max_abs {err:.3e} (limit "
                          f"{rtol * out_max:.3e} = 2^{int(np.log2(rtol))} x max|plain out| "
                          f"{out_max:.4f}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"attention variant disagrees with its plain version: {key}")
        kern_t, plain_t, line = alternated_ms(lambda: kern(q, k, v), lambda: plain(q, k, v))
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))[0]
        bound_ms, bound_by = forward_bound(1, 24, 4608, lse=False)
        results[key] = {"ms": kern_t[0], "plain_ms": plain_t[0], "library_ms": lib,
                        "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by}
        phase("variants", f"{key} (1,24,4608,128) time: {line}; library (SDPA) {lib:.4f} ms; "
                          f"bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v
    for fn, ops in sorted(sass.items()):
        if fn.startswith(("chunked", "bf16exp", "K2/K3 and exp2")):
            phase("variants", f"SASS {fn}: " + ", ".join(
                f"{op} x{n}" for op, n in sorted(ops.items()) if op.startswith("MUFU")))

    counters = variant_counters()
    for entry in counters.values():
        entry.launches = 0
    study = {"sweep_attention": sweep_attention.run(dev),
             "exp_softmax_overlap": exp_softmax_overlap.run(dev)}
    launches = {key: entry.launches for key, entry in counters.items()}
    sweep, overlap = study["sweep_attention"], study["exp_softmax_overlap"]
    phase("variants", "sweep_attention.run: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in sweep["kernels"].items())
        + f", exp2 check max err {sweep['exp2_err']:.2e} (atol 2e-2), plain "
          f"{sweep['plain_ms']:.4f} ms, tensor-core bound {sweep['tensor_core_ms']:.4f} ms, "
          f"best MFU {100 * sweep['best_mfu']:.1f} %")
    phase("variants", f"exp_softmax_overlap.run: production (K2) {overlap['production_ms']:.4f} ms; "
          + "; ".join(f"chunked bq={c['block_q']} chunks={c['n_chunks']} {c['ms']:.4f} ms "
                      f"(err {c['err']:.2e}, atol 2e-2)" for c in overlap["chunked"])
          + f"; bf16-exp {overlap['bf16exp']['ms']:.4f} ms (err {overlap['bf16exp']['err']:.2e}, "
            "atol 4e-2)")
    phase("variants", "launches in the two run() calls: "
          + ", ".join(f"{key} {n}" for key, n in launches.items()))
    if not all(launches.values()):
        raise SystemExit(f"the study's entry points did not launch every kernel: {launches}")
    torch.cuda.empty_cache()
    return results, launches


def library_yardsticks(dev):
    """library_ms for K1-K4: one PyTorch call of the same function at each
    kernel's main-path shape, timed as the kernels are (median of 20)."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops.rope import apply_rope_half

    sdpa = F.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(13)
    lib = {}

    def rotated(b, txt, gh, gw):
        s = txt + gh * gw
        q, k, v = (torch.randn(b, 24, s, 128, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = rope_tables(txt, gh, gw, dev)
        return q, k, v, apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)

    q, k, v, qr, kr = rotated(1, 512, 64, 64)
    lib["K2"] = cuda_time_ms(lambda: sdpa(q, k, v))[0]
    # no single call fuses the rotation: SDPA on the rotated q and k, as context
    lib["K1"] = cuda_time_ms(lambda: sdpa(qr, kr, v))[0]
    lib["K4"] = {}
    for b in (1, 2):      # the kernel phase's shape, and every train launch's (batch 2)
        qg, kg, vg = (x.detach().repeat(b, 1, 1, 1).requires_grad_(True) for x in (qr, kr, v))
        out = sdpa(qg, kg, vg)
        do = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        lib["K4"][f"({b},24,4608,128)"] = cuda_time_ms(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))[0]
        del qg, kg, vg, out, do
    del q, k, v, qr, kr
    lib["K3"] = {}
    for b, txt, gh, gw in ((2, 512, 72, 96), (1, 512, 96, 96)):
        _, _, v, qr, kr = rotated(b, txt, gh, gw)
        lib["K3"][f"({b},24,{qr.shape[2]},128)"] = cuda_time_ms(lambda: sdpa(qr, kr, v))[0]
        del v, qr, kr
    torch.cuda.empty_cache()
    phase("variants", "library (torch.nn.functional.scaled_dot_product_attention, default "
                      f"dispatch; median of 20): K2 (1,24,4608,128) {lib['K2']:.4f} ms; K1 the "
                      f"same on rotated q, k {lib['K1']:.4f} ms (context: no call fuses RoPE); "
                      "K4 its backward alone "
                      + ", ".join(f"{shape} {ms:.4f} ms" for shape, ms in lib["K4"].items())
                      + "; K3 "
                      + ", ".join(f"{shape} {ms:.4f} ms" for shape, ms in lib["K3"].items()))
    return lib


def reference_phase(dev):
    """Small FLUX + ControlNet forward: card (bf16, kernel) vs CPU (fp32)."""
    import dataclasses

    from reptext_tpu_torch.configs import ControlNetConfig, FluxConfig
    from reptext_tpu_torch.models.controlnet import RepTextControlNet
    from reptext_tpu_torch.models.flux import FluxTransformer2D
    from reptext_tpu_torch.nn.init import random_init_
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids

    small = dict(num_attention_heads=2, joint_attention_dim=64, pooled_projection_dim=32)
    fcfg = dataclasses.replace(FluxConfig(), num_layers=2, num_single_layers=2, **small)
    ccfg = dataclasses.replace(ControlNetConfig(), num_layers=1, num_single_layers=1, **small)
    gen = torch.Generator().manual_seed(1)
    cpu = [random_init_(FluxTransformer2D(fcfg), gen), random_init_(RepTextControlNet(ccfg), gen)]
    with torch.no_grad():
        for m in cpu:   # non-zero heads, and bf16-valued weights on both sides
            for p in m.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen)).copy_(
                    p.to(torch.bfloat16).float())
    card = [type(m)(m.config, device=dev, dtype=torch.bfloat16) for m in cpu]
    for c, m in zip(card, cpu):
        c.load_state_dict(m.state_dict())
    g = torch.Generator().manual_seed(2)
    s_txt, hw = 64, 16
    x = torch.randn(1, hw * hw, 64, generator=g)
    cond = torch.randn(1, hw * hw, 128, generator=g)
    ctx = torch.randn(1, s_txt, 64, generator=g)
    pooled = torch.randn(1, 32, generator=g)
    # the bf16 path embeds bf16(t * 1000) (752 for t = 0.75, as the JAX
    # sampler does); the fp32 reference gets that same timestep
    t_card = torch.full((1,), 0.75, dtype=torch.bfloat16)
    t_ref = (t_card * 1000.0).float() / 1000.0
    gd = torch.full((1,), 3.5)
    img_ids = prepare_latent_image_ids(2 * hw, 2 * hw)
    txt_ids = torch.zeros(s_txt, 3)

    def run(models, device, t):
        flux, cn = models
        a = [z.to(device) for z in (x, cond, ctx, pooled)]
        ids = (img_ids.to(device), txt_ids.to(device))
        tt, gg = t.to(device), gd.to(device)
        with torch.inference_mode():
            blocks, singles = cn(a[0], a[1], a[2], a[3], tt, *ids, gg, 0.8)
            return flux(a[0], a[2], a[3], tt, *ids, gg, blocks, singles).float().cpu()

    want = run(cpu, "cpu", t_ref)
    got = run(card, dev, t_card)
    err = (got - want).abs().max().item() / want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= REF_RTOL
    phase("reference", f"small FLUX(2+2)+ControlNet(1+1), 2 heads x 128, S={s_txt + hw * hw}: "
                       f"card bf16 vs CPU fp32 max_abs/max|ref| {err:.3e} (tol {REF_RTOL}) -> "
                       f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the port on the card disagrees with its CPU reference")

    # one ControlNet train step: the same weights (nonzero heads), the same
    # explicit t and noise, K1 + K4 on the card against autograd on the CPU
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.sampling.train_controlnet import controlnet_flow_match_loss

    mask = torch.zeros(1, hw * hw, 1)
    mask[:, : hw * hw // 2] = 1.0
    batch = {"x0": x, "cond_tokens": cond, "token_mask": mask, "prompt_embeds": ctx,
             "pooled": pooled, "img_ids": img_ids, "txt_ids": txt_ids, "guidance": gd}
    t_train = torch.full((1,), 0.6)
    noise = torch.randn(x.shape, generator=g)

    def train_grads(models, device):
        flux, cn = models
        flux.requires_grad_(False)
        cn.requires_grad_(True)
        cn.zero_grad(set_to_none=True)
        loss = controlnet_flow_match_loss(
            flux, cn, {k: v.to(device) for k, v in batch.items()},
            t=t_train.to(device), noise=noise.to(device))
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu() for n, p in cn.named_parameters()}

    loss_ref, grads_ref = train_grads(cpu, "cpu")
    n4 = fa.flash_attention_backward.launches
    loss_card, grads_card = train_grads(card, dev)
    n4 = fa.flash_attention_backward.launches - n4
    loss_err = abs(loss_card - loss_ref) / abs(loss_ref)
    ratios = {n: (grads_card[n] - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
              for n, r in grads_ref.items()}
    worst = max(ratios, key=ratios.get)
    # every block but the base's first double block: 2 + 2 + 1 + 1 - 1
    ok = (loss_err <= REF_RTOL and ratios[worst] <= REF_RTOL and n4 == 5
          and all(bool(torch.isfinite(v).all()) for v in grads_card.values()))
    phase("reference", f"one ControlNet train step on the same model, t = 0.6, explicit noise: "
                       f"loss card {loss_card:.6f} vs CPU {loss_ref:.6f} (rel {loss_err:.3e}); "
                       f"{len(ratios)} ControlNet gradients, max_abs/max|ref grad| worst "
                       f"{ratios[worst]:.3e} ({worst}), median "
                       f"{statistics.median(ratios.values()):.3e} (tol {REF_RTOL}); K4 launches "
                       f"{n4} (expected 5) -> {'ok' if ok else 'FAIL'}")
    phase("reference", "per tensor, max_abs/max|ref grad|: "
                       + ", ".join(f"{n} {r:.2e}" for n, r in ratios.items()))
    if not ok:
        raise SystemExit("the port's train step on the card disagrees with its CPU reference")


def load_requests():
    data = np.load(FIXTURE)
    size, font_size = int(data["size"]), int(data["font_size"])
    names = sorted({k.split(".")[0] for k in data.files if "." in k})
    reqs = []
    for name in ("arabic", "latin"):
        if name not in names:
            raise SystemExit(f"{FIXTURE} lacks the {name} request")
        reqs.append((name, str(data[f"{name}.text"]), tuple(int(v) for v in data[f"{name}.position"])))
    return data, size, font_size, reqs


def conditions_for(data, name, text, pos, size, font_size, path=FIXTURE):
    """build_conditions when Pillow and a font are there, else the fixture
    arrays; ``size`` is square or (width, height)."""
    width, height = (size, size) if isinstance(size, int) else size
    try:
        from reptext_tpu_torch.conditioning import TextLine, build_conditions, default_font_path

        default_font_path()
    except (ImportError, FileNotFoundError) as e:
        line = types.SimpleNamespace(**{k: data[f"{name}.{k}"] for k in
                                        ("canny_image", "position_mask", "region_mask")})
        cond = types.SimpleNamespace(lines=[line], glyph_canvas=data[f"{name}.glyph_canvas"],
                                     num_lines=1)
        return cond, f"fixture {os.path.relpath(path, ROOT)} ({type(e).__name__}: {e})"
    cond = build_conditions([TextLine(text, pos, font_size=font_size)], width, height,
                            font_size=font_size)
    return cond, "build_conditions"


def e2e_phase(dev, steps, cn_steps, seed):
    from reptext_tpu_torch import cli

    data, size, font_size, reqs = load_requests()
    base = ["--size", str(size), "--steps", str(steps), "--controlnet-step", str(cn_steps),
            "--seed", str(seed), "--font-size", str(font_size), "--random-weights"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args0 = cli.build_parser().parse_args(
        ["--text", reqs[0][1], "--position", *map(str, reqs[0][2]), *base])
    pipe = cli.build_pipeline(args0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.flux, pipe.controlnet, pipe.t5, pipe.clip, pipe.vae)
                   for p in m.parameters())
    phase("e2e", f"pipeline built in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.2f}B "
                 f"parameters, bf16, seeded random weights, device {dev}")

    gate = min(cn_steps, steps)
    expect = {"K1": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0}
    launches = {"K1": 0, "K2": 0, "K3": 0, "K5": 0}
    for i, (name, text, pos) in enumerate(reqs):
        args = cli.build_parser().parse_args(["--text", text, "--position", *map(str, pos), *base])
        cond, source = conditions_for(data, name, text, pos, size, font_size)
        timings = {}
        reset_launches()
        t0 = time.perf_counter()
        lat = cli.generate(args, pipe, cond, timings=timings, output_type="latent")
        images = pipe.decode(lat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        for key in launches:
            launches[key] += got[key]
        finite = bool(torch.isfinite(lat).all())
        shape_ok = images.shape == (1, size, size, 3) and images.dtype == np.uint8
        phase("e2e", f"request {i + 1} ({name}, {text!r}, conditions: {source}): "
                     f"{'cold' if i == 0 else 'warm'} {wall:.3f} s/image; stages "
                     + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
                     + f"; sampler {1e3 * timings['sample'] / steps:.1f} ms/step; "
                     f"kernel launches K1 {got['K1']} (expected {expect['K1']}) K2 {got['K2']} "
                     f"K3 {got['K3']} K5 {got['K5']} (expected 0, 0 and 0: every block passes RoPE "
                     f"tables, S = 4608, one device); image {images.shape} {images.dtype}, "
                     f"mean {images.mean():.2f}; latents finite {finite}")
        if not (finite and shape_ok and got == expect):
            raise SystemExit(f"end-to-end request {i + 1} failed its checks")
    phase("e2e", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                 f"(torch.cuda.max_memory_allocated)")
    return launches, pipe, cond


def source_image(seed, height, width):
    """A photo stand-in from the seed: smooth colour gradients plus noise, uint8."""
    r = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1) * r.uniform(80, 200, 3)
    return np.clip(base + r.normal(0, 12, (height, width, 3)) + 30, 0, 255).astype(np.uint8)


def box_mask(cond, margin=24):
    """uint8 mask: 255 on the text line's region box grown by ``margin`` pixels."""
    region = np.asarray(cond.lines[0].region_mask) > 0
    ys, xs = np.nonzero(region)
    mask = np.zeros(region.shape, np.uint8)
    mask[max(ys.min() - margin, 0):ys.max() + margin + 1,
         max(xs.min() - margin, 0):xs.max() + margin + 1] = 255
    return mask


def run_request(label, call, pipe, expect, shape, steps):
    """One request (``call(timings)`` -> latents) with its launch counts set
    to 0 just before and read just after; checks and prints it."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    timings = {}
    t0 = time.perf_counter()
    lat = call(timings)
    images = pipe.decode(lat)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(lat).all())
    shape_ok = images.shape == shape and images.dtype == np.uint8
    phase("large", f"{label}: {wall:.3f} s/image (cold for its size); stages "
                   + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
                   + f"; sampler {1e3 * timings['sample'] / steps:.1f} ms/step; kernel launches "
                   + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                   + f"; image {images.shape} {images.dtype}, mean {images.mean():.2f}; latents "
                   f"finite {finite}; peak device memory {peak:.2f} GiB")
    if not (finite and shape_ok and got == expect):
        raise SystemExit(f"the {label} request failed its checks")
    return got


def large_phase(dev, pipe, steps, cn_steps, seed, profile=False):
    """txt2img at 1536^2, then inpainting at 1280x960 and 1536x1152, on the
    e2e phase's modules plus one inpaint ControlNet; with ``profile``, a
    device profile of two inpaint steps at 1536x1152."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline

    data = np.load(LARGE_FIXTURE)
    font_size = int(data["font_size"])
    gate = min(cn_steps, steps)
    launches = {}

    def request(name, mode_flags):
        text = str(data[f"{name}.text"])
        pos = tuple(int(v) for v in data[f"{name}.position"])
        width, height = (int(v) for v in data[f"{name}.size"])
        args = cli.build_parser().parse_args(
            [*mode_flags, "--text", text, "--position", *map(str, pos), "--size", str(width),
             "--steps", str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed),
             "--font-size", str(font_size), "--random-weights"])
        cond, source = conditions_for(data, name, text, pos, (width, height), font_size,
                                      LARGE_FIXTURE)
        return args, cond, source, width, height

    name = "txt2img_1536"
    args, cond, source, width, height = request(name, [])
    big = pipe.with_config(cli.pipeline_config(args, height, width))
    s = big.pipe_cfg.image_seq_len + big.pipe_cfg.max_sequence_length
    expect = {"K1": 0, "K2": 0, "K3": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K5": 0}
    launches[name] = run_request(
        f"txt2img {width}x{height} (S = {s}, conditions: {source})",
        lambda timings: cli.generate(args, big, cond, timings=timings, output_type="latent"),
        big, expect, (1, height, width, 3), steps)

    inp = None
    for name in ("inpaint_1280x960", "inpaint_1536x1152"):
        args, cond, source, width, height = request(
            name, ["--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE)])
        cfg = cli.pipeline_config(args, height, width)
        if inp is None:
            t0 = time.perf_counter()
            inp = FluxRepTextInpaintPipeline.from_pipeline(pipe, seed=args.seed + 7, pipe_cfg=cfg)
            torch.cuda.synchronize()
            n = sum(p.numel() for p in inp.inpaint_controlnet.parameters())
            phase("large", f"inpaint ControlNet built in {time.perf_counter() - t0:.1f} s: "
                           f"{n / 1e9:.2f}B parameters, 68 condition features, seeded random "
                           f"weights; FLUX, the RepText ControlNet, the VAE, CLIP and T5 shared")
        else:
            inp = inp.with_config(cfg)
        image, mask = source_image(seed, height, width), box_mask(cond)
        s = cfg.image_seq_len + cfg.max_sequence_length
        kernel = "K3" if fa.streams(s) else "K1"
        expect = {"K1": 0, "K2": 0, "K3": 0, "K5": 0}
        expect[kernel] = steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS
        launches[name] = run_request(
            f"inpaint {width}x{height} (S = {s}, CFG batch 2, true-CFG {TRUE_GUIDANCE}, "
            f"mask {int((mask > 0).sum())} px, conditions: {source})",
            lambda timings: cli.generate_inpaint(args, inp, cond, image, mask, timings=timings,
                                                 output_type="latent"),
            inp, expect, (1, height, width, 3), steps)
        if profile and kernel == "K3":
            inpaint_profile(dev, inp, cond, image, mask, seed)
    del inp
    torch.cuda.empty_cache()
    return launches


def train_phase(dev, pipe, seed, profile=False):
    """The CLI's train path on the full-geometry pipeline: 3 steps, batch 2;
    with ``profile``, then a device profile of one more step."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.data import GlyphTextDataset
    from reptext_tpu_torch.ops import flash_attention as fa

    data, size, font_size, reqs = load_requests()
    args = cli.build_parser().parse_args(
        ["--mode", "train", "--random-weights", "--size", str(size), "--train-steps", "3",
         "--batch-size", "2", "--seed", str(seed)])
    pipe.flux.remat = pipe.controlnet.remat = True
    dataset = GlyphTextDataset(pipe, batch_size=args.batch_size, seed=args.seed)
    conds = [conditions_for(data, name, text, pos, size, font_size) for name, text, pos in reqs]
    # the texts drawn per sample are rendered by the fixture's two conditions
    dataset.conditions = lambda spec, step, index: conds[(step + index) % len(conds)][0]

    def checksums(module):
        sums = []
        for p in module.parameters():
            bits = p.detach().view(torch.int16).long()
            sums.append(torch.stack([bits.sum(), (bits * bits).sum()]))
        return torch.stack(sums).tolist()

    base_before = checksums(pipe.flux)
    counters = (fa.flash_attention_rope, fa.flash_attention, fa.flash_attention_backward,
                fa.flash_attention_streaming)
    per_step, fails = [], []
    clock = {"t": None}

    def on_event(kind, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if kind == "step":
            counts = [c.launches for c in counters]
            for c in counters:
                c.launches = 0
            per_step.append((info["step"], info["loss"], now - clock["t"], counts))
            if info["step"] == 1:
                cn = pipe.controlnet
                layers = list(cn.double_blocks) + list(cn.single_blocks)
                heads = all(bool(layer.proj.weight.abs().max() > 0) for layer in layers)
                zero = all(p.grad is not None and not bool(p.grad.any())
                           for layer in layers for p in layer.block.parameters())
                phase("train", f"after step 1: every proj head nonzero {heads}; every gradient "
                               f"inside the {len(layers)} ControlNet blocks exactly 0 {zero}")
                if not (heads and zero):
                    fails.append("warm-start structure after step 1")
        else:
            phase("train", f"[{kind}] {info} ({now - (clock['t'] or now):.3f} s)")
        clock["t"] = now

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.train(args, pipe, dataset=dataset, on_event=on_event)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, loss, sec, (n1, n2, n4, n3) in per_step:
        phase("train", f"step {step}: loss {loss:.6f}, {sec:.3f} s ({'cold' if step == 1 else 'warm'}"
                       f"), launches K1 {n1} (expected {TRAIN_K1}) K4 {n4} (expected {TRAIN_K4}) "
                       f"K2 {n2} K3 {n3} (expected 0 and 0)")
        if not (np.isfinite(loss) and (n1, n2, n4, n3) == (TRAIN_K1, 0, TRAIN_K4, 0)):
            fails.append(f"step {step}")
    same = checksums(pipe.flux) == base_before
    phase("train", f"3 steps at batch {args.batch_size}, {size}^2, lr {args.learning_rate}, "
                   f"weight decay {args.weight_decay}: {wall:.3f} s in all (restore points "
                   f"included); faults {len(trainer.faults)}; base parameters bit-identical "
                   f"{same} ({len(base_before)} tensors, int16 sum and sum-of-squares "
                   f"checksums); peak device memory {peak:.2f} GiB")
    if len(per_step) != 3 or trainer.faults or not same or fails:
        raise SystemExit(f"the training run failed its checks: {fails}")
    if profile:
        from reptext_tpu_torch.sampling.train_controlnet import (
            bind_frozen_base, make_controlnet_train_step,
        )

        step = bind_frozen_base(make_controlnet_train_step(
            pipe.controlnet, trainer.state["optimizer"], args.text_loss_weight), pipe.flux)
        batch = dataset.batch(len(per_step))

        def run():
            step(batch, torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()

        device_profile(f"one train step at batch {args.batch_size} (its batch built before)",
                       run, {fa.flash_attention_rope: TRAIN_K1,
                             fa.flash_attention_backward: TRAIN_K4, fa.flash_attention: 0})
    return {key: sum(s[3][i] for s in per_step) for i, key in enumerate(("K1", "K2", "K4", "K3"))}


def kernel_class(name):
    if "attn_fwd_kernel" in name or "rope_rotate_kernel" in name:
        return "attention kernel (attn_fwd_kernel + rope_rotate_kernel; K1, K2, K3)"
    if "attn_bwd_" in name:
        return ("attention backward kernel (attn_bwd_preprocess_kernel + attn_bwd_kernel + "
                "attn_bwd_epilogue_kernel; K4)")
    if any(tag in name.lower() for tag in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "GEMMs (cuBLAS kernels behind nn.Linear)"
    if "nccl" in name.lower():
        return "NCCL transfers and collectives (on their own stream, beside the compute)"
    if "multi_tensor_apply" in name:
        return "optimizer (AdamW's multi-tensor kernels)"
    return "elementwise, reductions, copies (norms, modulation, casts, cat, gelu)"


def device_profile(label, run, expect_launches):
    """torch.profiler over one ``run()``: device busy and idle share, device
    time by kernel class and the top kernels; ``expect_launches`` maps each
    counted kernel entry to its expected launches in the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    for entry in expect_launches:
        entry.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    wall_prof = time.perf_counter() - t0
    # device events only: host-side aten:: and runtime events are not device time,
    # and NCCL's "nccl:..." ranges repeat the kernels they span
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith("nccl:")]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:    # union of kernel intervals, in us
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    by_class, by_name = {}, {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name), 0.0) + dur
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dur)
    total = sum(by_class.values())
    counts = "; ".join(f"{entry.__name__} launches {entry.launches} (expected {n})"
                       for entry, n in expect_launches.items())
    phase("profile", f"{label}: {1e3 * wall:.1f} ms unprofiled, {1e3 * wall_prof:.1f} ms "
                     f"profiled; {len(kernels)} device events, busy {busy / 1e3:.1f} ms of a "
                     f"{window / 1e3:.1f} ms window (idle {100 * (1 - busy / window):.1f} %); "
                     f"{counts}")
    for cls, t in sorted(by_class.items(), key=lambda kv: -kv[1]):
        phase("profile", f"{cls}: {t / 1e3:.1f} ms, {100 * t / total:.1f} %")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        phase("profile", f"  {t / 1e3:.1f} ms in {n} calls [{kernel_class(name).split(' (')[0]}] "
                         f"{name[:110]}")


def profile_phase(dev, pipe, cond, seed):
    """Device time by kernel class over two ControlNet steps of the sampler."""
    import dataclasses

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.sampling.flow_match import build_schedule
    from reptext_tpu_torch.sampling.sampler import make_txt2img_sampler

    steps = 2
    cfg = dataclasses.replace(pipe.pipe_cfg, controlnet_conditioning_step=steps)
    clip_ids, t5_ids = cli.demo_token_ids("a street sign in city", pipe.clip.config,
                                          pipe.t5.config, cfg.max_sequence_length)
    with torch.inference_mode():
        emb, pooled = pipe.encode_prompt(clip_ids, t5_ids)
        g_lat, g_cond, g_glyph, _ = pipe.generators(seed)
        cond_tokens, token_masks = pipe.prepare_control_tokens(cond, g_cond)
        lat0 = pipe.prepare_latents(g_lat, 1, cond.glyph_canvas, g_glyph)
    schedule = build_schedule(steps, cfg.image_seq_len, cfg.base_image_seq_len,
                              cfg.max_image_seq_len, cfg.base_shift, cfg.max_shift,
                              cfg.use_dynamic_shifting)
    sampler = make_txt2img_sampler(pipe.flux, pipe.controlnet, schedule, cfg, pipe.compute_dtype)
    img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, dev)
    txt_ids = torch.zeros((emb.shape[1], 3), device=dev)
    guidance = (torch.full((1,), cfg.guidance_scale, dtype=torch.float32, device=dev)
                if pipe.flux.config.guidance_embeds else None)

    def run():
        with torch.inference_mode():
            sampler(lat0, cond_tokens, token_masks, emb, pooled, txt_ids, img_ids, guidance)
        torch.cuda.synchronize()

    device_profile(f"{steps} ControlNet steps at the op-point", run,
                   {fa.flash_attention_rope: steps * (DOUBLE_CALLS + SINGLE_CALLS)})


def inpaint_profile(dev, inp, cond, image, mask, seed):
    """Device time by kernel class over two inpaint steps with both ControlNets."""
    import dataclasses

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.pipelines.inpaint import DEFAULT_NEGATIVE_PROMPT
    from reptext_tpu_torch.sampling.flow_match import build_schedule
    from reptext_tpu_torch.sampling.sampler_inpaint import make_inpaint_sampler

    steps = 2
    cfg = dataclasses.replace(inp.pipe_cfg, controlnet_conditioning_step=steps,
                              true_guidance_scale=TRUE_GUIDANCE)
    with torch.inference_mode():
        neg, pos = (inp.encode_prompt(*cli.demo_token_ids(
            p, inp.clip.config, inp.t5.config, cfg.max_sequence_length))
            for p in (DEFAULT_NEGATIVE_PROMPT, "a street sign in city"))
        g_lat, g_cond, g_glyph, g_inp = inp.generators(seed)
        cond_tokens, token_masks = inp.prepare_control_tokens(cond, g_cond)
        inpaint_cond = inp.prepare_inpaint_cond(image, mask, g_inp)
        lat0 = inp.prepare_latents(g_lat, 1, cond.glyph_canvas, g_glyph)
    schedule = build_schedule(steps, cfg.image_seq_len, cfg.base_image_seq_len,
                              cfg.max_image_seq_len, cfg.base_shift, cfg.max_shift,
                              cfg.use_dynamic_shifting)
    sampler = make_inpaint_sampler(inp.flux, inp.controlnet, inp.inpaint_controlnet, schedule,
                                   cfg, inp.inpaint_conditioning_scale, inp.compute_dtype)
    img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, dev)
    txt_ids = torch.zeros((pos[0].shape[1], 3), device=dev)
    guidance = (torch.full((1,), cfg.guidance_scale, dtype=torch.float32, device=dev)
                if inp.flux.config.guidance_embeds else None)
    ctx, pooled = torch.cat([neg[0], pos[0]]), torch.cat([neg[1], pos[1]])

    def run():
        with torch.inference_mode():
            sampler(lat0, cond_tokens, token_masks, inpaint_cond, ctx, pooled, txt_ids, img_ids,
                    guidance)
        torch.cuda.synchronize()

    device_profile(f"{steps} inpaint steps at {cfg.width}x{cfg.height} (CFG batch 2, both "
                   f"ControlNets)", run,
                   {fa.flash_attention_streaming: steps * (DOUBLE_CALLS + 2 * SINGLE_CALLS),
                    fa.flash_attention_rope: 0, fa.flash_attention: 0})


def step_bound(b, h, sq, sk, d=128):
    """One ring step: both products, 4 B H Sq Sk D FLOP; q, k, v read once in
    bf16 and the fp32 state (acc, m, l) read and written once."""
    state = 4 * b * h * sq * (d + 2)
    return bound(4 * b * h * sq * sk * d, 2 * b * h * (sq + 2 * sk) * d + 2 * state)


def sharded_attention(dev, n, q, k, v, impl):
    """``sequence_sharded_attention`` over n thread ranks on the card, the
    shards' outputs put back together."""
    from reptext_tpu_torch.parallel.sequence import sequence_sharded_attention
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    return torch.cat(run_spmd(LocalSPGroup(n, dev), lambda g: sequence_sharded_attention(
        g.shard(q, 2), g.shard(k, 2), g.shard(v, 2), g, impl)), dim=2)


def check_out(label, got, want):
    err = (got.float() - want.float()).abs().max().item()
    out_max = want.float().abs().max().item()
    ok = err <= OUT_RTOL * out_max and bool(torch.isfinite(got.float()).all())
    phase("ring", f"{label}: out max_abs {err:.3e} (limit {OUT_RTOL * out_max:.3e} = 2^-6 x "
                  f"max|plain out| {out_max:.4f}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K5 disagrees with its plain version: {label}")
    return err


def ulysses_exact_check(dev, gen):
    """Ulysses' local attention is an exact softmax, as the reference's is:
    with logits planted beyond the clamp (row logits span [-80, 80], as in the
    kernels phase), ulysses over RING_RANKS thread ranks must agree with
    plain_attention within OUT_RTOL of max|out| and must not agree with the
    clamped kernel, which the one-card path keeps."""
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.attention import plain_attention

    s, d, h = 1024, 128, 2 * RING_RANKS
    q = torch.zeros(1, h, s, d, device=dev)
    k = torch.zeros(1, h, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, h, s, d, generator=gen, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    n2 = fa.flash_attention.launches
    got = sharded_attention(dev, RING_RANKS, q, k, v, "ulysses")
    n2 = fa.flash_attention.launches - n2
    want = plain_attention(q, k, v)
    clamped = fa.flash_attention(q, k, v, online=False)[0]
    out_max = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    off = (got.float() - clamped.float()).abs().max().item()
    ok = err <= OUT_RTOL * out_max < off and n2 == RING_RANKS
    phase("ring", f"ulysses over {RING_RANKS} thread ranks, (1,{h},{s},128) with logits planted up "
                  f"to 80: vs plain_attention (exact fp32 softmax) max_abs {err:.3e} (limit "
                  f"{OUT_RTOL * out_max:.3e} = 2^-6 x max|out| {out_max:.4f}); vs the clamped "
                  f"K2 max_abs {off:.3e} (must exceed the limit); K2 launches {n2} (one per "
                  f"rank, the running-max form) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ulysses' local attention is not the exact softmax")


def ring_kernel_phase(dev):
    """K5 alone: sequence_sharded_attention(impl="ring_kernel") over 4 thread
    ranks against the plain ring at the 1024^2 and the 2048^2 joint lengths;
    the three launches one rank of the 2048^2 SP request makes (text block,
    its own image block, the other rank's) against the plain steps; the step
    kernel, the whole ring and SDPA timed beside the bound."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator(device=dev).manual_seed(17)
    def rnd(*shape):
        return torch.randn(*shape, 128, generator=gen, device=dev).to(torch.bfloat16)

    err, by_shape = 0.0, {}
    h = HEADS
    for s in RING_LENGTHS:
        q, k, v = rnd(1, h, s), rnd(1, h, s), rnd(1, h, s)
        sq = s // RING_RANKS
        label = f"(1,{h},{s},128) over {RING_RANKS} ranks"
        err = max(err, check_out(f"ring_kernel {label}",
                                 sharded_attention(dev, RING_RANKS, q, k, v, "ring_kernel"),
                                 sharded_attention(dev, RING_RANKS, q, k, v, "ring")))
        q0, k0, v0 = (x[:, :, :sq] for x in (q, k, v))
        state = ra.ring_step(q0, k0, v0, None, True, False)
        plain_state = ra.ring_step_plain(q0, k0, v0, None, True, False)
        kern, pln, line = alternated_ms(
            lambda: ra.ring_step(q0, k0, v0, state, False, False),
            lambda: ra.ring_step_plain(q0, k0, v0, plain_state, False, False))
        ring = cuda_time_ms(lambda: sharded_attention(dev, RING_RANKS, q, k, v, "ring_kernel"),
                            repeats=5, warmup=1)
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q0, k, v))[0]
        b_ms, b_by = step_bound(1, h, sq, sq)
        by_shape[label] = {"ms": kern[0], "plain_ms": pln[0], "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib, "ring_ms": ring[0]}
        phase("ring", f"K5 middle step (1,{h},{sq},128) x (1,{h},{sq},128) time: {line}; bound "
                      f"{b_ms:.4f} ms ({b_by}); {rate(attention_flop(1, h, sq, sq), kern[0], b_ms)}; "
                      f"the whole ring over {RING_RANKS} thread ranks on "
                      f"one card {ring[0]:.3f} ms (median of 5, {RING_RANKS ** 2} launches);"
                      f" library (SDPA, the rank's {sq} queries over all {s} keys) {lib:.4f} ms")
        del q, k, v, q0, k0, v0, state, plain_state
        torch.cuda.empty_cache()

    # one rank of the 2048^2 SP request (SP_RANKS ranks): its queries [text;
    # image shard] against the text block, its own image block, the other's
    sq, sk = TXT_LEN + S_SP // SP_RANKS, S_SP // SP_RANKS
    q, (kt, vt), (k1, v1), (k2, v2) = rnd(1, h, sq), *[(rnd(1, h, n), rnd(1, h, n))
                                                        for n in (TXT_LEN, sk, sk)]
    blocks = ((kt, vt), (k1, v1), (k2, v2))

    def steps(fn):
        state = None
        for i, (k, v) in enumerate(blocks):
            state = fn(q, k, v, state, i == 0, i == len(blocks) - 1)
        return state

    label = (f"the {SP_SIZE}^2 SP rank's steps, q (1,{h},{sq},128) x k "
             f"(1,{h},{TXT_LEN}|{sk}|{sk},128)")
    err = max(err, check_out(label, steps(ra.ring_step), steps(ra.ring_step_plain)))
    state = ra.ring_step(q, kt, vt, None, True, False)
    plain_state = ra.ring_step_plain(q, kt, vt, None, True, False)
    kern, pln, line = alternated_ms(
        lambda: ra.ring_step(q, k1, v1, state, False, False),
        lambda: ra.ring_step_plain(q, k1, v1, plain_state, False, False))
    rank_steps = cuda_time_ms(lambda: steps(ra.ring_step))[0]
    k_all, v_all = torch.cat([kt, k1, k2], dim=2), torch.cat([vt, v1, v2], dim=2)
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k_all, v_all))[0]
    b_ms, b_by = step_bound(1, h, sq, sk)
    rank_bound = sum(step_bound(1, h, sq, n)[0] for n in (TXT_LEN, sk, sk))
    phase("ring", f"K5 image step (1,{h},{sq},128) x (1,{h},{sk},128) time: {line}; bound "
                  f"{b_ms:.4f} ms ({b_by}); {rate(attention_flop(1, h, sq, sk), kern[0], b_ms)}; "
                  f"the rank's {len(blocks)} steps {rank_steps:.4f} ms "
                  f"(bound {rank_bound:.4f} ms); library (SDPA over the {TXT_LEN + 2 * sk} keys) "
                  f"{lib:.4f} ms")
    del q, blocks, kt, vt, k1, v1, k2, v2, k_all, v_all, state, plain_state
    torch.cuda.empty_cache()
    ulysses_exact_check(dev, gen)
    return {"ms": kern[0], "plain_ms": pln[0], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "rank_steps_ms": rank_steps, "rank_steps_bound_ms": rank_bound,
            "library_note": "SDPA over the rank's queries and all keys: the output of the rank's "
                            "three steps (rank_steps_ms)",
            "max_abs_err": err, "by_shape": by_shape}


def nccl_worker(rank, world, port):
    """One process per card: the K5 ring over NCCL against the plain ring."""
    import torch.distributed as dist

    from reptext_tpu_torch.parallel.group import DistSPGroup
    from reptext_tpu_torch.parallel.sequence import sequence_sharded_attention

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    group = DistSPGroup(device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    q, k, v = (torch.randn(1, 24, 4608, 128, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    got, want = (sequence_sharded_attention(group.shard(q, 2), group.shard(k, 2),
                                            group.shard(v, 2), group, impl)
                 for impl in ("ring_kernel", "ring"))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= OUT_RTOL * want.float().abs().max().item()
    print(json.dumps({"rank": rank, "k5_ring_max_abs_err": err, "ok": ok}), flush=True)
    del q, k, v, got, want
    ok = dist_sp_run(dev, group) and ok
    dist.destroy_process_group()
    return 0 if ok else 1


def dist_sp_run(dev, group, seed=0, steps=2):
    """The SP request over the cards, as ``--shard spN`` runs it: this rank's
    process builds the full pipeline on its card, runs the request on its own
    (the reference, every rank alike), then shard_for_sp over the NCCL group
    with the ring and the Ulysses backends, each twice (the first call is cold:
    NCCL's and cuBLAS's first use at these shapes); a JSON line per run, then
    the transfers alone and a profile of one warm step of each backend."""
    from reptext_tpu_torch import cli

    pipe = cli.build_pipeline(cli.build_parser().parse_args(
        ["--random-weights", "--seed", str(seed)]))
    big, cond, _, kw = sp_request(pipe, dev, seed, steps)
    n, calls, ok, ref = group.size, DOUBLE_CALLS + SINGLE_CALLS, True, None
    for backend, call in ((b, c) for b in (None, "ring", "ulysses") for c in ("cold", "warm")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timings = {}
        run = big if backend is None else big.with_config(big.pipe_cfg).shard_for_sp(group, backend)
        lat = run(cond, timings=timings, **kw)
        torch.cuda.synchronize()
        got = read_launches()
        expect = {"K1": 0, "K2": 0, "K3": steps * calls, "K5": 0}
        if backend == "ring":
            expect.update(K3=0, K5=(n + 1) * steps * calls)
        ref = lat if backend is None else ref
        rel = (lat - ref).abs().max().item() / ref.abs().max().item()
        run_ok = got == expect and rel <= SP_RTOL and bool(torch.isfinite(lat).all())
        ok = ok and run_ok
        print(json.dumps({"rank": group.rank, "sp": backend or "one card", "call": call, "cards": n,
                          "ms_per_step": 1e3 * timings["sample"] / steps,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": got, "expected": expect, "max_abs_vs_one_card": rel,
                          "ok": run_ok}), flush=True)
    print(json.dumps({"rank": group.rank, "comm": comm_times(group, dev)}), flush=True)
    for backend in ("ring", "ulysses"):
        dist_sp_profile(big, cond, kw, group, dev, seed, backend)
    return ok


def comm_times(group, dev):
    """The SP request's transfers alone, CUDA-event medians of 10 on every
    rank in step: one ring slot (K and V of a rank's image block) around the
    ring, and one Ulysses all-to-all of a [1, 24, S/n, 128] tensor."""
    n = group.size
    slot = torch.randn(2, 1, HEADS, S_SP // n, 128, device=dev).to(torch.bfloat16)
    out = torch.empty_like(slot)
    x = slot[0].contiguous()
    ring = cuda_time_ms(lambda: group.ppermute_right(slot, out=out).wait(), repeats=10, warmup=2)[0]
    a2a = cuda_time_ms(lambda: group.all_to_all(x, 1, 2), repeats=10, warmup=2)[0]
    sent = x.numel() * 2 * (n - 1) / n   # bytes that leave the card in the all-to-all
    return {"ring_slot_mb": slot.numel() * 2 / 1e6, "ring_ms": ring,
            "ring_gb_per_s": slot.numel() * 2 / ring / 1e6, "all_to_all_mb": x.numel() * 2 / 1e6,
            "all_to_all_ms": a2a, "all_to_all_gb_per_s_sent": sent / a2a / 1e6}


def dist_sp_profile(big, cond, kw, group, dev, seed, backend):
    """torch.profiler over one SP sampler step (ControlNet on) over the cards."""
    from reptext_tpu_torch.ops import ring_attention as ra
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.sampling.flow_match import build_schedule
    from reptext_tpu_torch.sampling.sampler import make_sp_txt2img_sampler

    cfg = big.pipe_cfg
    with torch.inference_mode():
        emb, pooled = big.encode_prompt(kw["clip_ids"], kw["t5_ids"])
        cond_tokens, token_masks = big.prepare_control_tokens(cond, big.generators(seed)[1])
    schedule = build_schedule(1, cfg.image_seq_len, cfg.base_image_seq_len, cfg.max_image_seq_len,
                              cfg.base_shift, cfg.max_shift, cfg.use_dynamic_shifting)
    sampler = make_sp_txt2img_sampler(big.flux, big.controlnet, schedule, cfg, group,
                                      backend, big.compute_dtype)
    img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, dev)
    txt_ids = torch.zeros((emb.shape[1], 3), device=dev)
    guidance = torch.full((1,), cfg.guidance_scale, dtype=torch.float32, device=dev)

    def run():
        with torch.inference_mode():
            sampler(kw["latents"], cond_tokens, token_masks, emb, pooled, txt_ids, img_ids,
                    guidance)
        torch.cuda.synchronize()

    n, calls = group.size, DOUBLE_CALLS + SINGLE_CALLS
    device_profile(f"rank {group.rank}: one {backend} SP step at {SP_SIZE}^2 over {n} cards",
                   run, {ra.ring_step: (n + 1) * calls if backend == "ring" else 0})


def multi_card_phase():
    """With two or more cards, one process per card over NCCL: the K5 ring
    against the plain ring, then the SP request over the cards
    (``dist_sp_run``)."""
    import socket

    n = torch.cuda.device_count()
    if n < 2:
        phase("ring", f"{n} card: the K5 ring over NCCL across cards needs two or more and is "
                      "not run; every one-card check above and below runs")
        return
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nccl-worker",
                               str(r), str(n), str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise SystemExit("the NCCL ring timed out")
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")] or ["no result line"]
        phase("ring", f"NCCL rank {r} of {n} (K5 ring at (1,24,4608,128) vs the plain ring, "
                      f"then txt2img {SP_SIZE}^2 on one card, ring and ulysses over the cards, "
                      "the transfers alone): " + " | ".join(lines))
        for ln in out.splitlines():
            if ln.startswith("[profile]") and (r == 0 or "idle" in ln):
                print(ln, flush=True)
    if any(p.returncode != 0 for p in procs):
        raise SystemExit("the NCCL ring failed: " + "\n".join(outs))


def conditions_2048(data, name, text, pos, font_size):
    """The SP request's conditions (SP_SIZE^2, twice the fixture's size):
    build_conditions with the 1024^2 request's position and font size doubled
    when Pillow and a font are there, else the fixture arrays repeated 2 x 2."""
    try:
        from reptext_tpu_torch.conditioning import TextLine, build_conditions, default_font_path

        default_font_path()
    except (ImportError, FileNotFoundError) as e:
        up = lambda a: np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)   # noqa: E731
        line = types.SimpleNamespace(**{k: up(data[f"{name}.{k}"]) for k in
                                        ("canny_image", "position_mask", "region_mask")})
        cond = types.SimpleNamespace(lines=[line], glyph_canvas=up(data[f"{name}.glyph_canvas"]),
                                     num_lines=1)
        return cond, f"fixture {os.path.relpath(FIXTURE, ROOT)} repeated 2 x 2 ({type(e).__name__})"
    cond = build_conditions([TextLine(text, (2 * pos[0], 2 * pos[1]), font_size=2 * font_size)],
                            SP_SIZE, SP_SIZE, font_size=2 * font_size)
    return cond, "build_conditions"


def sp_request(pipe, dev, seed, steps):
    """The SP request: (the pipeline at SP_SIZE^2, its conditions and their
    source, the call's keywords: the first fixture line's prompt, seeded
    packed noise as ``latents=``, the ControlNet on every step)."""
    from reptext_tpu_torch import cli

    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    args = cli.build_parser().parse_args(
        ["--text", text, "--position", str(2 * pos[0]), str(2 * pos[1]), "--size", str(SP_SIZE),
         "--steps", str(steps), "--controlnet-step", str(steps), "--seed", str(seed),
         "--font-size", str(2 * font_size), "--random-weights"])
    cond, source = conditions_2048(data, name, text, pos, font_size)
    big = pipe.with_config(cli.pipeline_config(args, SP_SIZE, SP_SIZE))
    s_img = big.pipe_cfg.image_seq_len
    clip_ids, t5_ids = cli._prompt_ids(args, big, cli.build_prompt(args.prompt, args.text,
                                                                    cli.PROMPT_SUFFIX))
    noise = torch.randn((1, s_img, 64), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    kw = dict(clip_ids=clip_ids, t5_ids=t5_ids, seed=seed, latents=noise, output_type="latent",
              num_inference_steps=steps, guidance_scale=args.guidance_scale)
    return big, cond, source, kw


def sp_phase(dev, pipe, seed):
    """SP txt2img at 2048^2: the single-device pipeline (K3), then
    shard_for_sp over SP_RANKS thread ranks with the ring (K5) and Ulysses
    (K3 on 24 / SP_RANKS heads) backends, 2 steps with the ControlNet on both,
    from the same packed noise; latents against the single device's."""
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    steps = 2
    big, cond, source, kw = sp_request(pipe, dev, seed, steps)
    s_img = big.pipe_cfg.image_seq_len
    calls = DOUBLE_CALLS + SINGLE_CALLS
    runs, launches = {}, {}
    for label, backend in (("single", None), ("ring", "ring"), ("ulysses", "ulysses")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        if backend is None:
            timings = {}
            lat = big(cond, timings=timings, **kw)
            outs = [(lat, timings)]
        else:
            def rank(g):
                timings = {}
                return big.with_config(big.pipe_cfg).shard_for_sp(g, backend)(
                    cond, timings=timings, **kw), timings
            outs = run_spmd(LocalSPGroup(SP_RANKS, dev), rank)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        launches[f"sp_{label}" if backend else "txt2img_2048"] = got
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = 1 if backend is None else SP_RANKS
        expect = {"K1": 0, "K2": 0, "K3": n * steps * calls, "K5": 0}
        if backend == "ring":
            expect.update(K3=0, K5=n * (n + 1) * steps * calls)
        lat = outs[0][0]
        same = all(bool(torch.equal(o[0], lat)) for o in outs[1:])
        finite = bool(torch.isfinite(lat).all()) and tuple(lat.shape) == (1, s_img, 64)
        ms_step = 1e3 * statistics.median(o[1]["sample"] for o in outs) / steps
        runs[label] = lat
        line = (f"txt2img {SP_SIZE}x{SP_SIZE} (S = {TXT_LEN + s_img}, conditions: {source}), "
                + ("one device" if backend is None else f"{backend} over {n} thread ranks on one "
                   f"card") + f": {wall:.3f} s for {steps} steps with the ControlNet on both (the "
                f"first call at this size and backend); "
                f"sampler {ms_step:.1f} ms/step; peak device memory {peak:.2f} GiB; launches "
                + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                + (f" (K5 per rank per step {got['K5'] / (n * steps):.0f} = (n + 1) x {calls})"
                   if backend == "ring" else "")
                + f"; latents finite, shape ok {finite}; ranks equal {same}")
        if backend is not None:
            ref = runs["single"]
            err = (lat - ref).abs()
            rel_max = err.max().item() / ref.abs().max().item()
            rel_mean = err.mean().item() / ref.abs().mean().item()
            ok_tol = rel_max <= SP_RTOL
            line += (f"; vs one device: max_abs/max|ref| {rel_max:.3e} (tol {SP_RTOL}), "
                     f"mean_abs/mean|ref| {rel_mean:.3e} -> {'ok' if ok_tol else 'FAIL'}")
        else:
            ok_tol = True
        phase("sp", line)
        if not (finite and same and got == expect and ok_tol):
            raise SystemExit(f"the SP txt2img run ({label}) failed its checks")
    d = (runs["ring"] - runs["ulysses"]).abs().max().item() / runs["single"].abs().max().item()
    phase("sp", f"ring vs ulysses: max_abs/max|single| {d:.3e}")
    del runs, outs, lat
    torch.cuda.empty_cache()
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--controlnet-step", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl-worker", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="also profile two inpaint steps at 1536x1152, two ControlNet "
                         "steps at 1024^2 and one train step "
                         "(device time by kernel class)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, ROOT)
    from reptext_tpu_torch.ops import _build  # noqa: F401 (fails outside the repository)
    if args.nccl_worker:
        return nccl_worker(*args.nccl_worker)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                    f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    sass = build_phase()

    results = kernel_phase(dev)
    results["K3"] = streaming_kernel_phase(dev)
    results["K4"] = backward_kernel_phase(dev)
    results["K5"] = ring_kernel_phase(dev)
    multi_card_phase()
    variants, study_launches = variants_phase(dev, sass)
    library = library_yardsticks(dev)
    reference_phase(dev)
    txt2img, pipe, cond = e2e_phase(dev, args.steps, args.controlnet_step, args.seed)
    by_path = {"txt2img": txt2img}
    by_path.update(large_phase(dev, pipe, args.steps, args.controlnet_step, args.seed,
                               args.profile))
    if args.profile:
        profile_phase(dev, pipe, cond, args.seed)
    by_path["train"] = train_phase(dev, pipe, args.seed, args.profile)
    pipe.controlnet.requires_grad_(False).zero_grad(set_to_none=True)
    pipe.flux.remat = pipe.controlnet.remat = False
    by_path.update(sp_phase(dev, pipe, args.seed))
    del pipe

    by_path["attention_study"] = study_launches
    src = "reptext_tpu_torch/csrc/flash_attention.cu"
    entry = {
        "K1": {"name": "flash_attention_rope", "route": "cuda", "source": src,
               "replaces": "reptext_tpu/ops/flash_attention.py:191"},
        "K2": {"name": "flash_attention", "route": "cuda", "source": src,
               "replaces": "reptext_tpu/ops/flash_attention.py:166"},
        "K3": {"name": "flash_attention_streaming", "route": "cuda", "source": src,
               "replaces": "reptext_tpu/ops/flash_attention.py:224"},
        "K4": {"name": "flash_attention_backward", "route": "cuda",
               "source": "reptext_tpu_torch/csrc/flash_attention_bwd.cu",
               "replaces": "reptext_tpu/ops/flash_attention.py:577",
               "also_replaces": "reptext_tpu/ops/flash_attention.py:621"},
        "chunked": {"name": "chunked_attn", "route": "cuda", "source": src,
                    "replaces": "benchmarks/exp_softmax_overlap.py:80"},
        "bf16exp": {"name": "bf16exp_attn", "route": "cuda", "source": src,
                    "replaces": "benchmarks/exp_softmax_overlap.py:143"},
        "exp2": {"name": "exp2_attn", "route": "cuda", "source": src,
                 "replaces": "benchmarks/sweep_attention.py:67"},
        "K5": {"name": "ring_step", "route": "cuda", "source": src,
               "replaces": "reptext_tpu/ops/ring_attention.py:53"},
    }
    results.update(variants)
    k3_shapes = {"(2,24,7424,128)": (2, 24, 7424), "(1,24,9728,128)": (1, 24, 9728)}
    for key, (b_ms, b_by) in (("K1", forward_bound(1, 24, 4608, tables=True)),
                              ("K2", forward_bound(1, 24, 4608)),
                              ("K3", forward_bound(*k3_shapes["(2,24,7424,128)"])),
                              ("K4", backward_bound(1, 24, 4608))):
        results[key].update({"bound_ms": b_ms, "bound_by": b_by, "library_ms": library[key]})
    results["K4"]["library_ms"] = library["K4"]["(1,24,4608,128)"]
    results["K4"]["library_ms_by_shape"] = library["K4"]
    results["K4"]["bound_ms_by_shape"] = {f"({b},24,4608,128)": backward_bound(b, 24, 4608)[0]
                                          for b in (1, 2)}
    results["K1"]["library_note"] = "SDPA on q and k rotated beforehand: no single call fuses RoPE"
    results["K3"]["library_ms"] = library["K3"]["(2,24,7424,128)"]
    results["K3"]["library_ms_by_shape"] = library["K3"]
    results["K3"]["bound_ms_by_shape"] = {shape: forward_bound(*bhs)[0]
                                          for shape, bhs in k3_shapes.items()}
    for key in entry:
        paths = {path: counts.get(key, 0) for path, counts in by_path.items()}
        entry[key].update({"launches": sum(paths.values()), "launches_by_path": paths})
        entry[key].update(results[key])
    print(json.dumps({"kernels": list(entry.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
