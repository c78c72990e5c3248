#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (reptext_tpu_torch).

    python3 chip_smoke.py                 # 4 steps, ControlNet on for the first 2; 3 train steps
    python3 chip_smoke.py --steps 30 --controlnet-step 30   # the reference op-point
    python3 chip_smoke.py --profile       # adds device profiles of two inpaint steps at
                                          # 1536x1152, two ControlNet steps at 1024^2,
                                          # one train step and one OCR train step

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
   (dq, dk and dv must be bit-equal: dq's adds land in key order); K1 and K4
   at the union ControlNet's joint length 4609 and at 5121 (partial last
   tiles) against their plain versions, K4 bit-equal over two calls there;
   then K1-K4 at head dim 64 in bf16 and fp32 (the trained-weights demo's
   models): K2 and K4 at the demo's (16, 4, 69, 64) and (1, 4, 69, 64), K1 at
   (1, 24, 4608, 64), K4 there too and K3 at (1, 24, 9728, 64), each against
   its plain version (fp32: lse within 2^-6, the operands rounded to bf16),
   K4 bit-equal over two calls, times beside the bound and SDPA's; then K1-K5 at
   head dim 32 in bf16 and fp32 (the CLI's --tiny models: one 64-byte row under
   the 64-byte swizzle): K1 and K2 at (1, 4, 4608, 32), K3 at (1, 4, 9728, 32), K4
   at (2, 4, 4608, 32) and bit-equal over two calls, and K5 step by step at one
   rank of the sp2 ring at 1024^2 (q (1, 4, 2560, 32) against blocks of 512, 2048
   and 2048 keys), each against its plain version, times beside the bound and
   SDPA's; then K1 and K3
   at the head counts of a tensor-parallel rank (12 and 6: tp 2 and 4) at the 1024^2
   and 1536^2 lengths and K4 at (1, 12, 4608, 128), against their plain versions,
   times beside the bound and SDPA's;
   then K5, the ring step: sequence_sharded_attention(impl="ring_kernel") over
   4 thread ranks on the card against the plain ring at (1, 24, 4608, 128)
   and (1, 24, 16896, 128), and the three steps one rank of the 2048^2 SP
   request makes (q (1, 24, 8704, 128) against the text block and two image
   blocks of 8192 keys), and the three one rank of SP inpainting at 1536x1152
   makes at CFG batch 2 (q (2, 24, 3968, 128) against blocks of 512, 3456 and
   3456 keys), against the plain steps, within 2^-6 of max|plain
   out|; the step's, the whole ring's and SDPA's times beside the bound;
   K5 at head dim 64: the demo's joint 69 tokens over 2 thread ranks (the text
   block folded in first) and (1, 24, 4608, 64) over 4, against the plain ring;
   Ulysses over 4 thread ranks with logits planted beyond the clamp against
   plain_attention (its local attention is an exact softmax) and against the
   clamped K2, from which it must differ; with
   two or more cards, one process per card over NCCL: the K5 ring against the
   plain ring, then the 2048^2 request of phase 10 on each card alone and with
   shard_for_sp over the cards (ring and Ulysses, each called twice: cold,
   warm), the transfers alone, a profile of one warm step of each backend,
   then SP inpainting at 1536x1152 on each card alone and over the cards the
   same way, then ``--shard 1xN``: the 1024^2 request on each card alone and
   tensor-parallel over the cards (cold, warm), one block's all-reduce alone,
   and the cut-depth ControlNet train steps on one card and over the mesh (one
   card: a line says so);
4. variants: the attention A/B kernels of the study (chunked online softmax,
   exp2, bf16 exp; reptext_tpu_torch/ops/attention_variants.py) against their
   plain versions at (1, 24, 4608, 128), their times beside the plain
   version's, SDPA's and the bound, the MUFU instructions in their SASS; then
   the study's entry points (benchmarks.sweep_attention.run and
   benchmarks.exp_softmax_overlap.run: the JAX scripts' own fp32 check at
   (1, 2, 4608, 128) and their timings), which must launch every variant and
   K2; and library_ms for K1-K4 (torch's scaled_dot_product_attention, timed
   here only as the yardstick);
4a. norms: the norm kernels (csrc/norms.cu: modulate, the AdaLN LayerNorm with
   its modulation, and rms_norm, the per-head q/k RMSNorm) against their plain
   versions at the 1024^2 request's shapes in bf16 (every element within the
   card tests' limit, at least 99 % bit-equal), their times beside the bytes
   bound, the plain versions' and F.layer_norm's and F.rms_norm's (the library
   yardstick, which the port never calls); every path below counts their
   launches beside the attention kernels' and checks them against its blocks
   (norm_launches);
4b. joins: the blocks' copy-free joins at the main path's two shapes (1, 24,
   4608, 128) and (2, 24, 5312, 128), 512 text tokens, bf16: K1 on the
   (text, image) segments and K1 written through out= into a single block's
   [B, S, 15360] proj_out input, both bit-equal to K1 on the joint q, k and v;
   the GELU kernel (csrc/gelu.cu) into that buffer's MLP columns against
   F.gelu(approximate="tanh") (at least 99.99 % bit-equal, every element
   within one bf16 ulp); times of K1 joint and on segments, and of the GELU
   kernel beside its bytes bound and F.gelu; every path below counts the GELU
   kernel's launches with the norms' (norm_launches: once a single block on
   the K1 paths, none on K3, SP and training, whose blocks join by copies);
5. reference: a small FLUX + ControlNet forward, and one ControlNet train
   step (loss and every ControlNet gradient), on the card (bf16, kernels)
   against the same weights on the CPU (float32, plain attention);
5a. demo: the trained-weights demo (reptext_tpu_torch/examples/overfit_e2e.py,
   FLUX 2 + 4 and ControlNet 1 + 2 at 4 heads x 64, fp32, 128^2, the holdout
   set; its conditions from tests/fixtures/overfit_conditions_128.npz where no
   font is) at DEMO_STEPS: finite flow losses, the last below the first, K2 and
   K4 DEMO_BLOCKS per flow step and K2 DEMO_BLOCKS per sampled step, the
   --params-cache bit-equal to the trained modules; then gates:
   reptext_tpu_torch/benchmarks/trained_gates.py on that checkpoint with
   --allow-low-accuracy at GATES_STEPS: per variant (uncached, fixed and
   adaptive velocity cache, fp8 weights) the char accuracy, ms/step and
   launches, the fixed cache's launches as its schedule says, the adaptive
   cache's no more than uncached; every path checks first that the attention
   backend is the default, auto;
5b. checkpoint: a synthetic diffusers snapshot (FLUX.1-dev transformer, VAE,
   CLIP-L, T5-XXL, a RepText ControlNet, tokenizer files) at full width with
   the depth cut (CKPT_FLUX, CKPT_CN, CKPT_T5), bf16 from a seed, written by
   reptext_tpu_torch.io.synthetic, converted by io.convert_cli.main, loaded
   through cli.build_pipeline(--checkpoint-dir) and, from the converter's
   trees, through FluxRepTextPipeline.create(params=...): every parameter
   bit-equal, one 1024^2 request's latents bit-equal, its ids from the
   vendored tokenizers; seconds to write, convert and load, GB/s, host peak
   RSS, sizes;
6. end to end: two 1024x1024 txt2img requests (an Arabic line, then a Latin
   line) through the port's CLI path (reptext_tpu_torch.cli.build_pipeline /
   generate) at full FLUX.1-dev + RepText + T5-XXL + CLIP-L + VAE geometry,
   bf16, seeded random weights; checks the image shape, finite latents and
   that K1 ran steps * 57 + controlnet_steps * 14 times per image and K2 and
   K3 none;
6b. surface: on the same pipeline at 1024^2, img2img of a seeded source
   image at strength 0.6 through cli.generate (t0 = 1: K1 = 3 x 57 + 1 x 14 =
   185 at the defaults, the ControlNet gated by absolute step), the same
   request with a callback after every step against none (K1 256 each,
   latents bit-equal), a callback that returns False after step 2 (K1 142),
   custom sigmas and custom timesteps of length 3 through --sigmas and
   --timesteps (K1 199 each), and return_dict=True with output_type="pil";
   s/image, stage seconds, shapes, finiteness;
7. large: on the same modules, one 1536x1536 txt2img request through
   cli.generate (joint S = 9728: K3 = steps * 57 + controlnet_steps * 14, K1 =
   K2 = 0), then text inpainting through cli.generate_inpaint with one added
   inpaint ControlNet (seeded random weights): a 1280x960 request (S = 5312,
   the reference's op-point: K1 only) and a 1536x1152 one (S = 7424: K3
   only), each at true-CFG scale 3.5 with the default negative prompt, a
   seeded numpy source image and a box mask over the text line; per image
   steps * (57 + 14) + controlnet_steps * 14 launches of its kernel. Checks
   image shapes, uint8 and finite latents; prints s/image, stage seconds,
   sampler ms/step and peak memory;
7b. serve: a GenerationServer (reptext_tpu_torch.serving) on 127.0.0.1 over the
   same pipeline and, for mode=inpaint, the inpaint ControlNet at 1280x960,
   driven over HTTP by client threads: a burst of 4 compatible 1024^2
   requests (one batch of 4), the same 4 with max_batch 1, one 1536^2 request
   (K3), two requests with other guidance scales (two batches) and two
   inpaint requests (one batch of 2); /metrics' batch counts, launches per
   batch (steps x 57 + ControlNet steps x 14, whatever the batch), PNG shapes,
   the burst's latents against each request's alone within SERVE_RTOL (direct
   calls), each served PNG against the decode of those latents; seconds from
   first submit to last answer, images/s, p50/p95 latency, peak memory; then
   frees the inpaint ControlNet;
7c. union: a seeded union ControlNet (RepText geometry, UNION_MODES modes) at
   mode UNION_MODE: one 1024^2 request beside the plain one (plain, union,
   union, plain; ms/step), one 1280x960 inpaint request with it in the
   RepText slot; launches exact;
7d. multi: MultiControlNet([RepText, union]) on one step's full-width inputs,
   a region mask on one, a guidance window on the other, at a step outside
   and one inside the window: bit-equal to the sum of each net's own
   masked, gated, spread residuals;
7e. lora: a seeded rank-LORA_RANK LoRA on every attention projection of every
   FLUX block merged into the resident FLUX at scale 0 (image bit-equal to
   none) and 1 (different, finite), restored each time (checksums equal the
   originals'); merge seconds, the GiB of the kept originals;
7f. single_file: a synthetic BFL single file of FLUX (full width, depth cut
   to CKPT_FLUX) through convert_cli --flux-single-file, bit-equal to the
   diffusers path, then one 1024^2 request through it;
7g. ip: a seeded CLIP ViT-L/14 and IP-Adapter written as files, converted by
   convert_cli --ip-adapter --image-encoder-dir and attached from that
   directory: the image prompt's encode time; 1024^2 without the adapter, at
   IP_SCALE, at 0 (bit-equal to without); 1536^2 (K3); a served batch of one
   request with the image and one without over HTTP; SP txt2img at 2048^2
   over SP_RANKS thread ranks (ring) against one card; the adapter's
   projections are taken off FLUX after;
8. with --profile: torch.profiler over two inpaint steps at 1536x1152 (in the
   large phase) and over two ControlNet steps of the txt2img sampler at 1024^2,
   device (kernel) time by class, the device's idle share and the top kernels;
8b. union_train: 2 steps of cli.train --controlnet-mode UNION_MODE on the
   union ControlNet (before the RepText net trains): K1 = 141, K4 = 70 a
   step, the mode embedding's gradient in the mode's row alone;
9. train: on the same pipeline, the CLI's train path (reptext_tpu_torch.cli.
   train: warm start, AdamW at the CLI defaults, ElasticTrainer +
   PrefetchLoader) for 3 steps at batch 2, 1024^2, with remat; checks finite
   losses, nonzero heads and exactly-zero block gradients after step 1, a
   bit-identical base, and K1 = 141, K4 = 70, K2 = K3 = 0 launches per step;
   with --profile, then torch.profiler over one more train step;
9b. ocr: the OCR judge (reptext_tpu_torch/eval/ocr.py, benchmarks/ocr_judge.npz) on the
   card against the CPU on the fixture's two glyph-canvas crops, both polarities
   (cuDNN's TF32 convolutions as the card runs them, and with TF32 off for the
   contrast): logits within JUDGE_RTOL of max|CPU|, the same greedy strings;
   char_accuracy of the crops on the card and the CPU;
9c. train_ocr: the OCR text-perceptual term on the same pipeline: one loss +
   backward at batch 2 with the plain decode (its peak, or the out-of-memory error),
   the loss at weight 0 and 0.3 on one fixed batch and draw (their difference
   against 0.3 x the term, the heads' gradients apart), then the CLI's train path
   with --ocr-loss-weight 0.3 for 3 steps at batch 2, 1024^2, remat (the decoder's
   blocks recomputed), after the OCR loss and backward twice on one batch and
   draw through the step's own loss_and_backward (a gate: bit-equal losses and
   all OCR_GRADS ControlNet gradients, the cuDNN flags restored after; the ops
   that have no deterministic implementation are named when it fails), the
   labels those of the fixture's texts: per step the loss,
   the term's share, seconds cold and warm, K1 = 141, K4 = 70, K2 = K3 = 0; the
   base, the VAE and the judge bit-identical; peak memory; with --profile, one more
   OCR step's device time by class;
9d. train_corpus: the CLI's train path with --corpus-dir over CORPUS_SIZES seeded
   PNGs (annotations in each photo's pixels) and the OCR term, 2 steps: launches as
   in 9c, the sample specs used equal to a CPU dataset's over the same corpus;
9e. train_joint and train_base: make_joint_train_step (one AdamW over the base and
   the ControlNet) and make_train_step (the base alone) at full width, depth cut to
   FLUX CUT_FLUX and ControlNet CUT_CN, 2 steps each at batch 2: K1 twice and K4 once
   per block, the base's gradients finite and nonzero, its parameters changed;
9f. train_repeat: the joint step of 9e, 3 steps from one seed, twice, then
   with a NaN planted in step 2 and rolled back by the ElasticTrainer: the
   losses, the ControlNet's state_dict and the base's bit-equal;
10. sp: on the same modules, txt2img at 2048x2048 (S = 16896) for 2 steps with
   the ControlNet on both, from the same packed noise: the single-device
   pipeline (K3: 142 launches), then FluxRepTextPipeline.shard_for_sp over 2
   thread ranks on the card (parallel/testing.py) with the ring backend (K5:
   (n + 1) x 71 launches per rank and step) and the Ulysses backend (K3's
   running-max form on 12 heads per rank: 71 per rank and step); each
   gathered latent against the single device's within SP_RTOL, ranks equal;
   ms/step, peak memory. The sharded pipelines are with_config clones over the
   modules the single-device pipeline goes on using. Then SP inpainting at
   1536x1152 (S = 7424, CFG batch 2) through cli.generate_inpaint, 2 steps with
   both ControlNets on both, a seeded inpaint ControlNet: one device (K3 2 x 85
   = 170), ring over 2 thread ranks (K5 n (n + 1) x 2 x 85 = 1020) and Ulysses
   (K3 n x 2 x 85 = 340); and generate_batch of the two 1024^2 requests (seeds
   differ), 2 steps with the ControlNet on both: one device (K1 142) and ring
   over 2 thread ranks (K5 852); each against its one-device run within
   SP_RTOL, ranks equal;
10b. tiny: the JAX CLI's documented demo (--random-weights --tiny) on the card
   through the port's CLI functions, fp32 as the JAX CLI runs --tiny, once
   this process holds no full-geometry pipeline: txt2img at 1024^2 (K1) and
   1536^2 (K3), a 1280x960 inpaint request (cli.build_pipeline --mode inpaint),
   3 train steps at batch 2 through cli.train (K1, K4), one request over HTTP
   through cli.build_server, and the 1024^2 request over 2 thread ranks with
   the ring backend (K5) against its one-device run; launches against the
   blocks' counts, finite fp32 outputs, and no call of a plain attention
   version on any of these paths;
11. fp8, in a process of its own (``--fp8-worker``) once this one holds no
   pipeline: a full-geometry bf16 pipeline, one 1024^2 request with latents=
   given (cold, warm), quantize_weights() (the Linears quantized, the GiB
   freed, quantized_bytes), the same request in fp8 (ms/step, peak, the
   latents' max difference relative to bf16's); enable_vae_tiling() and the
   same latents decoded tiled and untiled at 1024^2, seeded ones at 2048^2
   (seconds, each decode's own peak, the pixels apart); the eager
   dequantization of the largest Linears timed (GB/s); a 1280x960 inpaint
   request through an inpaint pipeline made from the quantized one (K1 312);
   a full-width, depth-cut snapshot converted with --dtype fp8, its FLUX and
   ControlNet state bit-equal to quantize_weights() of the bf16 modules, one
   1024^2 request through it; the same snapshot with an IP-Adapter (attached to
   the fp8-stored stacks, then quantize_weights(), as the JAX CLI does) bit-equal
   in state and latents to its bf16 conversion with the adapter attached, then
   quantize_weights(); cli.build_pipeline(--random-weights
   --weight-dtype fp8) at full geometry (seconds, peak, no bf16 Linear left in
   the stacks) and one request through it. Every time and size with the
   card's name and power limit;
12. tp, in a process of its own (``--tp-worker``) after the fp8 one: tensor and
   data parallelism over a (dp, tp) mesh of thread ranks on the card
   (reptext_tpu_torch/parallel/mesh.py::LocalMesh): 2 ControlNet train steps at
   batch 2 under 2 x 2 at full width, depth cut to FLUX CUT_FLUX and ControlNet
   CUT_CN, against the one card (losses within REF_RTOL, step 1's gradients within
   the K4 limits; K1 2 and K4 1 per block, step and rank, FLUX's first block K1 once);
   then, with the prompts
   encoded once and T5 freed, txt2img 1024^2 under 1 x 2 and (2 images, split over
   dp) 2 x 2, 1536^2 under 1 x 2 (K3), inpainting at 1280x960 under 2 x 1 (the CFG
   halves split over dp) and 1 x 2, and a served pair (one batch of 2 through a
   GenerationServer's worker; the other ranks follow) under 1 x 2 and sp2, each
   against the one card's run on the same modules within TP_RTOL; per rank every
   attention call at 24 / tp heads, launches steps x 57 + ControlNet steps x 14
   (K1, K3 at 1536^2) on every rank; the meshes share one copy of each tp rank's
   slices.

Then a JSON line of the eleven kernels' results (launches per path, each
path's counts set to 0 just before it and read just after: the surface
phase's runs, the SP inpaint and batch runs and the four train paths of 9c-9e
and the demo and gates paths among them; times, the bound, SDPA's time;
K5 also at CFG batch 2 in its by_shape; K1-K4 at head dim 64 under "d64", K5's
under its "d64"; K1-K5 at head dim 32 under "d32"; K1, K3 and K4 at a tp rank's
heads under "tp_heads"; K1's segment route by shape under "segments"; the
tiny phase's paths, every launch at head dim 32),
the nvidia-smi line, and as the last line {"ok": true,
"device": {...}}. The text lines come from
tests/fixtures/conditions_1024.npz and conditions_large.npz, whose condition
arrays are used only where Pillow or a font is missing (the serve phase's
worker takes them through its ``conditions`` method, replaced on the instance).
"""

import argparse
import base64
import contextlib
import gc
import io
import json
import os
import shutil
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
# FLUX's and the ControlNet's (double, single) blocks, by which the norm
# kernels' launches are counted (norm_launches).
FLUX_DEPTH, CN_DEPTH = (19, 38), (4, 10)
# The ring phase: K5 alone over 4 thread ranks; SP txt2img at 2048^2 (512 T5
# tokens + a 128 x 128 token grid) over 2 thread ranks on one card.
RING_RANKS, SP_RANKS, HEADS = 4, 2, 24
RING_LENGTHS = (4608, 16896)
SP_SIZE, TXT_LEN = 2048, 512
S_SP = (SP_SIZE // 16) ** 2
# SP inpainting (LARGE_FIXTURE's 1536x1152 request: a 4:3 phone photo at the
# CLI's cap) at CFG batch 2 over SP_RANKS thread ranks, and SP batches at
# 1024^2; K5 at that batch in the ring phase.
SP_INPAINT, SP_INPAINT_HW = "inpaint_1536x1152", (1152, 1536)
S_SP_INPAINT = (SP_INPAINT_HW[0] // 16) * (SP_INPAINT_HW[1] // 16)
INPAINT_CALLS = DOUBLE_CALLS + 2 * SINGLE_CALLS   # FLUX + both ControlNets, every step
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


def norm_launches(flux=0, cn=0, flux_depth=FLUX_DEPTH, cn_depth=CN_DEPTH):
    """The norm kernels' launches of ``flux`` FLUX and ``cn`` ControlNet
    forwards: a double block calls modulate and rms_norm 4 times each, a
    single block once and twice, FLUX's norm_out modulate once; and the GELU
    kernel's (``gelu``), once a single block of each forward whose blocks join
    in place (``ops/attention.py::joins_in_place``): all of them on the K1
    paths, which these are, and none where none does (K3, SP: :func:`copied`)."""
    (fd, fs), (cd, cs) = flux_depth, cn_depth
    return {"modulate": flux * (4 * fd + fs + 1) + cn * (4 * cd + cs),
            "rms_norm": flux * (4 * fd + 2 * fs) + cn * (4 * cd + 2 * cs),
            "gelu": flux * fs + cn * cs}


def copied(expect):
    """``expect`` on a path whose blocks all join by copies (K3 past 6144
    joint tokens, the SP backends, training): no GELU kernel launch."""
    return dict(expect, gelu=0)


def train_norm_launches(flux_depth=FLUX_DEPTH, cn_depth=CN_DEPTH, base_trained=False):
    """The norm kernels' launches of one remat train step of FLUX and the
    ControlNet (``cn_depth`` None: FLUX alone): the forward, then the
    recompute of every block a gradient reaches, which is all of them but,
    where the base is frozen, FLUX's first double block; norm_out, outside
    the blocks, runs once."""
    fwd = norm_launches(1, int(cn_depth is not None), flux_depth, cn_depth or (0, 0))
    skip = 0 if base_trained else 4
    # the single blocks take gradients, so they join by copies: no GELU launch
    return {"modulate": 2 * fwd["modulate"] - 1 - skip, "rms_norm": 2 * fwd["rms_norm"] - skip,
            "gelu": 0}


def scaled(expect, n):
    return {k: n * v for k, v in expect.items()}


# A train step's launches on the full-geometry pipeline.
TRAIN_EXPECT = {"K1": TRAIN_K1, "K2": 0, "K3": 0, "K4": TRAIN_K4, **train_norm_launches()}
# The OCR term's weight in the OCR and corpus train phases (the RepText
# recipe's 0.3; the CLI's default is 0, the term off).
OCR_WEIGHT = 0.3
# The RepText ControlNet's parameter tensors, every one with a gradient in an
# OCR step: 4 double blocks of 34 (with their heads), 10 single of 16, and
# 18 of the embedders.
OCR_GRADS = 314
# The OCR judge on the card against the CPU, float32 logits on the same crops:
# cuDNN runs the card's float32 convolutions in TF32 (torch.backends.cudnn.
# allow_tf32, on by default, and left on: the pipeline's numbers must not
# move), whose products keep 10 mantissa bits against 23. Each rounding is a
# relative 2^-11; through six convolutions and two dense layers the logits
# move by well under 2^-7 of max|logits|, the limit; the greedy decode must be
# the same string.
JUDGE_RTOL = 2.0 ** -7
# The loss at weight 0.3 minus the loss at 0 on one batch and draw against 0.3
# x the OCR term of the same forward: the two forwards run the same kernels on
# the same inputs, so only the fp32 sum's rounding is left; limit 1e-3 of the loss.
OCR_EFFECT_RTOL = 1e-3
# The corpus phase's photos (h, w): a 4:3 phone photo, a smaller one, a
# square one and a portrait one, all resized to 1024^2 by the loader.
CORPUS_SIZES = ((1152, 1536), (600, 800), (1024, 1024), (960, 640))
# The checkpoint phase's synthetic snapshot: full widths, depth cut to (double,
# single) blocks of FLUX and the ControlNet and T5 layers, ~4.5 GB of bf16
# written and ~4.5 GB converted; written under SCRATCH (git-ignored), removed
# after the phase.
CKPT_FLUX, CKPT_CN, CKPT_T5 = (2, 2), (1, 1), 2
# A union ControlNet at RepText geometry (4 + 10) with the mode count of the
# public InstantX FLUX.1-dev-Controlnet-Union config, run at mode 2. Its joint
# sequence at 1024^2 is 4609 tokens (its mode token in front of 512 text and
# 4096 image tokens): K1 and K4 take their bounds-masked tails there, checked
# against their plain versions at 4609 and at 5121.
UNION_MODES, UNION_MODE = 10, 2
UNION_LENGTHS = (4609, 5121)
# The LoRA phase: rank 16 on every attention projection of every double and
# single block of FLUX (io/synthetic.py::lora_state), merged at scale 0 and 1.
LORA_RANK = 16
# The IP-Adapter phase: the published adapter's geometry (CLIP ViT-L/14 at
# 224^2, 4 tokens of 4096), an image prompt at this scale.
IP_SCALE = 0.8
# Joint and base-only training cut depth as the checkpoint phase does: at full
# depth the 12B base's bf16 parameters, gradients and AdamW moments (24 + 24 +
# 48 GB) do not fit one card. With remat, a step runs each block's attention
# twice (forward, recompute) and its backward once.
CUT_FLUX, CUT_CN = CKPT_FLUX, CKPT_CN
SCRATCH = ".chip_smoke"
# The fp8 child process's last line: this prefix, then its launches by path.
FP8_RESULT = "FP8_LAUNCHES "
# The serve phase: the worker lingers this long after a request arrives so
# that a burst sent by 4 client threads at once lands in one batch.
BATCH_WINDOW_S = 0.25
# A request's latents in a batch of 4 against the same request alone, after 4
# steps: max_abs within 5e-2 of max|alone|, the SP comparison's limit. Both are
# bf16 end to end; only the batch's GEMMs differ (cuBLAS picks its tiles and
# the split of each sum by M, 4 x 4608 rows against 4608), so an output may
# round one way in one and the other way in the other, and that moves through
# 57 + 14 blocks a step, as the SP ranks' sums in another order do.
SERVE_RTOL = SP_RTOL
# The burst's PNGs against the same requests' alone, in uint8 levels: the VAE
# decodes the batch's four latents in one call and cuDNN picks its convolution
# algorithms by the batch, so equal latents decode a rounding apart (bf16
# activations: 2^-8 of a value) compounded through the decoder's 30 convolutions
# and its group norms: each pixel within 8 levels, their mean within 0.5.
SERVE_PNG_MAX, SERVE_PNG_MEAN = 8, 0.5


def stage_seconds(timings: dict) -> str:
    """A request's stage seconds from ``timings``, without its spans (``trace``)."""
    return ", ".join(f"{k} {v:.3f} s" for k, v in timings.items() if k != "trace")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def forward_counters():
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops import gelu, norms
    from reptext_tpu_torch.ops import ring_attention as ra

    return {"K1": fa.flash_attention_rope, "K2": fa.flash_attention,
            "K3": fa.flash_attention_streaming, "K5": ra.ring_step,
            "modulate": norms.modulate, "rms_norm": norms.rms_norm,
            "gelu": gelu.gelu_tanh_into}


def check_attention_backend():
    """Every path runs the attention backend it would run for a user: the
    default, 'auto' (the kernels on the card), never the plain version
    unasked (``ops.attention.set_default_backend``)."""
    from reptext_tpu_torch.ops.attention import get_default_backend

    if get_default_backend() != "auto":
        raise SystemExit(f"the attention backend is {get_default_backend()!r}, not 'auto'")


def reset_launches():
    check_attention_backend()
    for entry in forward_counters().values():
        entry.launches = 0


def read_launches():
    return {key: entry.launches for key, entry in forward_counters().items()}


def cuda_time_ms(fn, repeats=20, warmup=3, queue_behind=0):
    """(median, least, most) ms between CUDA events around ``fn()``; with
    ``queue_behind``, a device sleep of that many cycles ahead of the first
    event, so that fn's launches queue behind it and the events bound device
    work alone even where the host launches slower than the device runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queue_behind:
            torch.cuda._sleep(queue_behind)
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


def rope_tables(txt_len, grid_h, grid_w, device, axes=(16, 56, 56)):
    """FLUX RoPE tables for [txt_len zeros; (0, row, col) grid] ids (``axes``:
    FLUX.1-dev's at head dim 128; the demo's (8, 28, 28) at 64)."""
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    ids = torch.cat([torch.zeros(txt_len, 3, device=device),
                     prepare_latent_image_ids(2 * grid_h, 2 * grid_w, device)])
    return rope_cos_sin_half(ids, axes, 10000)


def compare(name, got, want, lse_atol=LSE_ATOL):
    (o, l), (po, pl) = got, want
    out_err = (o.float() - po.float()).abs().max().item()
    lse_err = (l - pl).abs().max().item()
    out_max = po.float().abs().max().item()
    out_lim = OUT_RTOL * out_max
    lse_rel = lse_err / max(pl.abs().max().item(), 1e-30)
    ok = (out_err <= out_lim and lse_err <= lse_atol and bool(torch.isfinite(o.float()).all())
          and o.dtype == po.dtype)
    phase("kernels", f"{name}: out max_abs {out_err:.3e} (limit {out_lim:.3e} = 2^-6 x "
                     f"max|plain out| {out_max:.4f}); lse max_abs {lse_err:.3e} max_rel "
                     f"{lse_rel:.3e} (atol {lse_atol:.3g}) -> {'ok' if ok else 'FAIL'}")
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
    ok = all(x.dtype == y.dtype for x, y in zip(got, want))
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
    same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
    phase("kernels", f"K4 (2,24,4608,128) two calls on the same inputs: dq, dk, dv bit-equal "
                     f"{same} (max|dq1 - dq2| {dq_diff:.3e}; the dq adds of a query tile land "
                     f"in key order) -> {'ok' if all(same) else 'FAIL'}")
    if not all(same):
        raise SystemExit("the backward kernel does not repeat bit for bit")
    del q, k, v, keep, out, lse, do, first, second
    torch.cuda.empty_cache()

    # a union ControlNet's joint sequence at 1024^2 (its mode token in front of
    # 512 text and 4096 image tokens) and 5121: partial last tiles, K1's and
    # K4's bounds-masked tails; K1 against its plain version, K4 against its
    # plain version and bit-equal over two calls
    for s_tail in UNION_LENGTHS:
        q, k, v = qkv(1, 24, s_tail)
        cos, sin = rope_tables(s_tail - 4096, 64, 64, dev)
        n1 = fa.flash_attention_rope.launches
        got = fa.flash_attention_rope(q, k, v, cos, sin)
        if fa.flash_attention_rope.launches != n1 + 1:
            raise SystemExit(f"the RoPE entry did not take K1 at {s_tail} tokens")
        compare(f"K1 (1,24,{s_tail},128)", got, fa.flash_attention_rope_plain(q, k, v, cos, sin))
        args = inputs(q, k, v, cos, sin, None)
        first = fa.flash_attention_backward(*args)
        err = max(err, compare_grads(f"K4 (1,24,{s_tail},128)", first,
                                     plain_backward_by_heads(fa, args, None)))
        same = [bool(torch.equal(a, b)) for a, b in zip(first, fa.flash_attention_backward(*args))]
        phase("kernels", f"K4 (1,24,{s_tail},128) two calls: dq, dk, dv bit-equal {same} -> "
                         f"{'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise SystemExit(f"the backward kernel does not repeat bit for bit at {s_tail}")
        del q, k, v, args, first, got
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


def forward_bound(b, h, s, d=128, lse=True, tables=False, elem=2):
    """A forward: both products, 4 B H S^2 D FLOP at the bf16 rate (an fp32
    call's products are bf16 too); q, k, v read and out written once in their
    dtype (``elem`` bytes), the fp32 lse written, the fp32 [S, D] RoPE tables
    read."""
    return bound(4 * b * h * s * s * d,
                 4 * b * h * s * d * elem + (4 * b * h * s if lse else 0)
                 + (2 * s * d * 4 if tables else 0))


def backward_bound(b, h, s, d=128, elem=2):
    """The backward's least work: five S^2 D products (q k^T, dO v^T, dS k,
    dS^T q, P^T dO: the five K4 makes), 10 B H S^2 D FLOP at the bf16 rate; q,
    k, v, out, dO and the lse read, dq, dk, dv written, in their dtype
    (``elem`` bytes)."""
    return bound(10 * b * h * s * s * d, 8 * b * h * s * d * elem + 4 * b * h * s)


# The trained-weights demo's attention (examples/overfit_e2e.py: FLUX 2 + 4
# and its ControlNet at 4 heads x 64, 128^2, 64 image + 5 text tokens, fp32):
# K2 and K4 at (16, 4, 69, 64) in training (batch 16) and (1, 4, 69, 64) in
# sampling. An fp32 call's operands are rounded to bf16 where its plain
# version keeps fp32: out within 2^-6 of max|plain out| as in bf16, lse within
# D64_LSE_ATOL_FP32 (a weighted mean of logits that moved by about 2^-9 of
# |q||k| / sqrt(D)), gradients within the bf16 limits.
DEMO_SHAPES = ((16, 4, 69), (1, 4, 69))
D64_LSE_ATOL_FP32 = 2.0 ** -6
DEMO_ROPE_AXES = (8, 28, 28)


def d64_kernel_phase(dev):
    """K1-K4 at head dim 64, in bf16 and fp32: K2 and K4 at the demo's shapes,
    K1 at (1, 24, 4608, 64) and K3 at (1, 24, 9728, 64) (the 1024^2 and 1536^2
    joint lengths), each against its plain version; K4 bit-equal over two calls
    at (16, 4, 69, 64) and (1, 24, 4608, 64) (both warpgroups add a partial dq
    over the same channels there); times beside the bound and SDPA's on the
    same inputs. Returns {kernel: {"shape dtype": {...}}}."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    sdpa = F.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(17)
    res = {"K1": {}, "K2": {}, "K3": {}, "K4": {}}

    def tensors(b, h, s, dtype, n=4):
        return [torch.randn(b, h, s, 64, generator=gen, device=dev).to(dtype) for _ in range(n)]

    def timed(key, label, kern, plain, library, b_ms_by, flop, err):
        k_t, p_t, line = alternated_ms(kern, plain)
        lib = cuda_time_ms(library)[0]
        res[key][label] = {"ms": k_t[0], "plain_ms": p_t[0], "library_ms": lib,
                           "bound_ms": b_ms_by[0], "bound_by": b_ms_by[1], "max_abs_err": err}
        phase("kernels", f"{key} {label} time: {line}; SDPA {lib:.4f} ms; bound "
                         f"{b_ms_by[0]:.4f} ms ({b_ms_by[1]}); {rate(flop, k_t[0], b_ms_by[0])}")

    def sdpa_backward(q, k, v, do):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = sdpa(*leaves)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    def bit_equal(label, args):
        first, second = fa.flash_attention_backward(*args), fa.flash_attention_backward(*args)
        same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
        phase("kernels", f"K4 {label} two calls: dq, dk, dv bit-equal {same} -> "
                         f"{'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise SystemExit(f"the backward kernel does not repeat bit for bit at {label}")

    for dtype, tag, elem in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
        lse_atol = LSE_ATOL if dtype == torch.bfloat16 else D64_LSE_ATOL_FP32
        for b, h, s in DEMO_SHAPES:
            label = f"({b},{h},{s},64) {tag}"
            q, k, v, do = tensors(b, h, s, dtype)
            got = fa.flash_attention(q, k, v)
            err = compare(f"K2 {label}", got, fa.flash_attention_plain(q, k, v), lse_atol)
            timed("K2", label, lambda: fa.flash_attention(q, k, v),
                  lambda: fa.flash_attention_plain(q, k, v), lambda: sdpa(q, k, v),
                  forward_bound(b, h, s, 64, elem=elem), attention_flop(b, h, s, s, 64), err)
            args = (q, k, v, got[0], got[1], do)
            err = compare_grads(f"K4 {label}", fa.flash_attention_backward(*args),
                                fa.flash_attention_backward_plain(*args))
            timed("K4", label, lambda: fa.flash_attention_backward(*args),
                  lambda: fa.flash_attention_backward_plain(*args), sdpa_backward(q, k, v, do),
                  backward_bound(b, h, s, 64, elem=elem), 10 * b * h * s * s * 64, err)
            if b == 16:
                bit_equal(label, args)
            del q, k, v, do, got, args
        # K1 at the 1024^2 joint length (512 text tokens + a 64 x 64 grid)
        q, k, v = tensors(1, 24, 4608, dtype, 3)
        cos, sin = rope_tables(512, 64, 64, dev, DEMO_ROPE_AXES)
        label = f"(1,24,4608,64) {tag}"
        err = compare(f"K1 {label}", fa.flash_attention_rope(q, k, v, cos, sin),
                      fa.flash_attention_rope_plain(q, k, v, cos, sin), lse_atol)
        qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        timed("K1", label, lambda: fa.flash_attention_rope(q, k, v, cos, sin),
              lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), lambda: sdpa(qr, kr, v),
              forward_bound(1, 24, 4608, 64, tables=True, elem=elem),
              attention_flop(1, 24, 4608, 4608, 64), err)
        # K4 at the same length: more key tiles than CTAs in flight at once
        out, lse = fa.flash_attention(qr, kr, v)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        args = (qr, kr, v, out, lse, do)
        err = compare_grads(f"K4 {label}", fa.flash_attention_backward(*args),
                            plain_backward_by_heads(fa, args, None))
        timed("K4", label, lambda: fa.flash_attention_backward(*args),
              lambda: plain_backward_by_heads(fa, args, None), sdpa_backward(qr, kr, v, do),
              backward_bound(1, 24, 4608, 64, elem=elem), 10 * 24 * 4608 * 4608 * 64, err)
        bit_equal(label, args)
        del q, k, v, qr, kr, out, lse, do, args
        torch.cuda.empty_cache()
        # K3 at the 1536^2 joint length (512 + 96 x 96), q and k rotated first
        q, k, v = tensors(1, 24, 9728, dtype, 3)
        cos, sin = rope_tables(512, 96, 96, dev, DEMO_ROPE_AXES)
        q, k = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        label = f"(1,24,9728,64) {tag}"
        err = compare(f"K3 {label}", fa.flash_attention_streaming(q, k, v),
                      fa.flash_attention_streaming_plain(q, k, v), lse_atol)
        timed("K3", label, lambda: fa.flash_attention_streaming(q, k, v),
              lambda: fa.flash_attention_streaming_plain(q, k, v), lambda: sdpa(q, k, v),
              forward_bound(1, 24, 9728, 64, elem=elem), attention_flop(1, 24, 9728, 9728, 64),
              err)
        del q, k, v
        torch.cuda.empty_cache()
    return res


# The CLI's --tiny demo (FLUX 2 + 4 and its ControlNet at 4 heads x 32, fp32
# on the card as the JAX CLI runs it): K1 at the 1024^2 joint length (1, 4,
# 4608, 32), K2 there on rotated q and k, K3 at 1536^2's (1, 4, 9728, 32), K4 at
# a train step's batch 2 (2, 4, 4608, 32), and K5 at one rank of the sp2 ring at
# 1024^2: queries [512 text; 2048 image] against the text block and two image
# blocks of 2048 keys. Tolerances as at head dim 64 (fp32: lse within 2^-6).
TINY_ROPE_AXES = (8, 12, 12)
TINY_HEADS, TINY_D = 4, 32


def d32_kernel_phase(dev):
    """K1-K5 at head dim 32, in bf16 and fp32, at the shapes the tiny CLI
    gives them (above), each against its plain version; K4 bit-equal over
    two calls; K5 step by step (the state after each step but the last, then
    the output); times beside the bound and SDPA's on the same inputs.
    Returns {kernel: {"shape dtype": {...}}}."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops import ring_attention as ra
    from reptext_tpu_torch.ops.rope import apply_rope_half

    sdpa = F.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(23)
    res = {"K1": {}, "K2": {}, "K3": {}, "K4": {}, "K5": {}}
    h, d = TINY_HEADS, TINY_D

    def tensors(b, s, dtype, n=4):
        return [torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype) for _ in range(n)]

    def timed(key, label, kern, plain, library, b_ms_by, flop, err):
        k_t, p_t, line = alternated_ms(kern, plain)
        lib = cuda_time_ms(library)[0]
        res[key][label] = {"ms": k_t[0], "plain_ms": p_t[0], "library_ms": lib,
                           "bound_ms": b_ms_by[0], "bound_by": b_ms_by[1], "max_abs_err": err}
        phase("kernels", f"{key} at D = 32, {label} time: {line}; SDPA {lib:.4f} ms; bound "
                         f"{b_ms_by[0]:.4f} ms ({b_ms_by[1]}); {rate(flop, k_t[0], b_ms_by[0])}")

    def sdpa_backward(q, k, v, do):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = sdpa(*leaves)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    def steps(fn, q, blocks, upto=None):
        state = None
        for i, (k, v) in enumerate(blocks[:upto]):
            state = fn(q, k, v, state, i == 0, i == len(blocks) - 1)
        return state

    for dtype, tag, elem in ((torch.bfloat16, "bf16", 2), (torch.float32, "fp32", 4)):
        lse_atol = LSE_ATOL if dtype == torch.bfloat16 else D64_LSE_ATOL_FP32
        # K1 and K2 at the 1024^2 joint length (512 text tokens + a 64 x 64 grid)
        q, k, v = tensors(1, 4608, dtype, 3)
        cos, sin = rope_tables(512, 64, 64, dev, TINY_ROPE_AXES)
        label = f"(1,{h},4608,{d}) {tag}"
        err = compare(f"K1 at D = 32, {label}", fa.flash_attention_rope(q, k, v, cos, sin),
                      fa.flash_attention_rope_plain(q, k, v, cos, sin), lse_atol)
        qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        timed("K1", label, lambda: fa.flash_attention_rope(q, k, v, cos, sin),
              lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), lambda: sdpa(qr, kr, v),
              forward_bound(1, h, 4608, d, tables=True, elem=elem),
              attention_flop(1, h, 4608, 4608, d), err)
        err = compare(f"K2 at D = 32, {label}", fa.flash_attention(qr, kr, v),
                      fa.flash_attention_plain(qr, kr, v), lse_atol)
        timed("K2", label, lambda: fa.flash_attention(qr, kr, v),
              lambda: fa.flash_attention_plain(qr, kr, v), lambda: sdpa(qr, kr, v),
              forward_bound(1, h, 4608, d, elem=elem), attention_flop(1, h, 4608, 4608, d), err)
        del q, k, v, qr, kr
        # K4 at a train step's batch 2
        q, k, v, do = tensors(2, 4608, dtype)
        out, lse = fa.flash_attention(q, k, v)
        args = (q, k, v, out, lse, do)
        label = f"(2,{h},4608,{d}) {tag}"
        err = compare_grads(f"K4 at D = 32, {label}", fa.flash_attention_backward(*args),
                            plain_backward_by_heads(fa, args, None, heads=2))
        timed("K4", label, lambda: fa.flash_attention_backward(*args),
              lambda: plain_backward_by_heads(fa, args, None, heads=2),
              sdpa_backward(q, k, v, do), backward_bound(2, h, 4608, d, elem=elem),
              10 * 2 * h * 4608 * 4608 * d, err)
        first, second = fa.flash_attention_backward(*args), fa.flash_attention_backward(*args)
        same = [bool(torch.equal(a, b)) for a, b in zip(first, second)]
        phase("kernels", f"K4 at D = 32, {label} two calls: dq, dk, dv bit-equal {same} -> "
                         f"{'ok' if all(same) else 'FAIL'}")
        if not all(same):
            raise SystemExit(f"the backward kernel does not repeat bit for bit at D = 32 {label}")
        del q, k, v, do, out, lse, args, first, second
        torch.cuda.empty_cache()
        # K3 at the 1536^2 joint length (512 + 96 x 96), q and k rotated first
        q, k, v = tensors(1, 9728, dtype, 3)
        cos, sin = rope_tables(512, 96, 96, dev, TINY_ROPE_AXES)
        q, k = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        label = f"(1,{h},9728,{d}) {tag}"
        err = compare(f"K3 at D = 32, {label}", fa.flash_attention_streaming(q, k, v),
                      fa.flash_attention_streaming_plain(q, k, v), lse_atol)
        timed("K3", label, lambda: fa.flash_attention_streaming(q, k, v),
              lambda: fa.flash_attention_streaming_plain(q, k, v), lambda: sdpa(q, k, v),
              forward_bound(1, h, 9728, d, elem=elem), attention_flop(1, h, 9728, 9728, d), err)
        del q, k, v
        # K5: one rank of the sp2 ring at 1024^2, step by step
        sq, sk = TXT_LEN + 4096 // 2, 4096 // 2
        q = tensors(1, sq, dtype, 1)[0]
        blocks = [tuple(tensors(1, n, dtype, 2)) for n in (TXT_LEN, sk, sk)]
        err = 0.0
        for i in range(len(blocks)):
            got = steps(ra.ring_step, q, blocks, i + 1)
            want = steps(ra.ring_step_plain, q, blocks, i + 1)
            if i < len(blocks) - 1:
                # the running max: an fp32 call's q and k are rounded to bf16 (2^-9
                # relative each), so a logit, and the row's max, moves by up to 2^-8
                # |q| max|k| / sqrt(D) beyond the bf16 call's sum-order limit
                m_lim = torch.full_like(want[1], LSE_ATOL)
                if dtype == torch.float32:
                    k_norm = torch.stack([k.float().norm(dim=-1).amax(-1)
                                          for k, _ in blocks[:i + 1]]).amax(0)
                    m_lim += 2.0 ** -8 * q.float().norm(dim=-1) * k_norm[..., None] / d ** 0.5
                m_err = (got[1] - want[1]).abs()
                phase("ring", f"K5 at D = 32 {tag}, step {i}: running max max_abs "
                              f"{m_err.max().item():.3e}, worst share of its limit "
                              f"{(m_err / m_lim).max().item():.3f}")
                if bool((m_err > m_lim).any()):
                    raise SystemExit(f"K5 at D = 32 {tag}: step {i}'s running max is beyond "
                                     "its limit from the plain step's")
                got, want = got[0] / got[2][..., None], want[0] / want[2][..., None]
            elif got.dtype != dtype:
                raise SystemExit(f"K5 at D = 32 {tag}: the output is {got.dtype}")
            err = max(err, check_out(f"K5 at D = 32, the sp2 1024^2 rank's step {i} {tag} "
                                     f"(the state's acc / l, then the output)", got, want))
        (kt, vt), (k1, v1) = blocks[:2]
        state = ra.ring_step(q, kt, vt, None, True, False)
        plain_state = ra.ring_step_plain(q, kt, vt, None, True, False)
        k_all = torch.cat([x for x, _ in blocks], dim=2)
        v_all = torch.cat([x for _, x in blocks], dim=2)
        label = f"(1,{h},{sq},{d}) x (1,{h},{sk},{d}) {tag}"
        timed("K5", label, lambda: ra.ring_step(q, k1, v1, state, False, False),
              lambda: ra.ring_step_plain(q, k1, v1, plain_state, False, False),
              lambda: sdpa(q, k_all, v_all), step_bound(1, h, sq, sk, d, elem=elem),
              attention_flop(1, h, sq, sk, d), err)
        res["K5"][label]["library_note"] = (f"SDPA over the rank's {sq} queries and all "
                                            f"{TXT_LEN + 2 * sk} keys")
        del q, blocks, kt, vt, k1, v1, k_all, v_all, state, plain_state
        torch.cuda.empty_cache()
    return res


def variant_counters():
    from reptext_tpu_torch.ops import attention_variants as av
    from reptext_tpu_torch.ops import flash_attention as fa

    return {"chunked": av.chunked_attn, "bf16exp": av.bf16exp_attn, "exp2": av.exp2_attn,
            "K2": fa.flash_attention}


FWD_RE = r"attn_fwd_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d)ELb(\d)ELb(\d)ELb(\d)EE"
BWD_RE = r"attn_bwd_kernelILi(\d+)ELb(\d)ELb(\d)EE"


def width_label(d, f32):
    """' D128', ' D64 fp32', ...: an instantiation's head dim and output dtype."""
    return f" D{d}" + (" fp32" if int(f32) else "")


def kernel_label(mangled):
    """A readable name for a kernel of the library from its mangled one: the
    forward template's instantiations by their arguments (D, ROPE, ONLINE,
    EXP, CARRY, PIPELINED, OUT_F32), the backward's main kernel by its head
    dim, softmax and output dtype, the others by their function name and
    template arguments."""
    import re

    m = re.search(FWD_RE, mangled)
    if m is None:
        bwd = re.search(BWD_RE, mangled)
        if bwd:
            d, online, f32 = bwd.groups()
            return f"K4 main {'online' if int(online) else 'clamped'}{width_label(d, f32)}"
        other = re.search(r"(rope_rotate_kernel|attn_bwd_\w+?_kernel)(I\w*?EE)?", mangled)
        if other is None:
            return mangled[:60]
        args = re.findall(r"L[ib](\d+)E", other.group(2) or "")
        return other.group(1) + (f"<{','.join(args)}>" if args else "")
    d, rope, online, exp, carry, overlap, f32 = (int(g) for g in m.groups())
    if carry:
        name = "K5"
    elif rope:
        name = "K1"
    else:
        name = {0: "chunked (exp)",
                1: "K2/K3" + (" and exp2" if online and d == 128 and not f32 else ""),
                2: "bf16exp (ex2.approx.ftz.bf16x2)"}[exp]
    return (f"{name} {'online' if online else 'clamped'}{width_label(d, f32)} "
            f"[{'overlapped' if overlap else 'one product after the other'}]")


def attention_instantiations():
    """The labels (without the overlap tag) of every K1/K2/K3/K5 instantiation
    and of every backward main kernel: head dims 32, 64 and 128, bf16 and fp32
    out, clamped and online (K5: online)."""
    fwd, bwd = set(), set()
    for d in (32, 64, 128):
        for f32 in (0, 1):
            w = width_label(d, f32)
            fwd.add(f"K5 online{w}")
            for online in ("clamped", "online"):
                fwd.add(f"K1 {online}{w}")
                bwd.add(f"K4 main {online}{w}")
            fwd.add(f"K2/K3 clamped{w}")
            fwd.add("K2/K3 and exp2 online D128" if (d, f32) == (128, 0)
                    else f"K2/K3 online{w}")
    return fwd, bwd


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
    want_fwd, want_bwd = attention_instantiations()
    missing = want_fwd - served
    if bad or missing:
        raise SystemExit(f"the forward template is not on wgmma alone: {bad}; missing {missing}")
    backward = {fn: c for fn, c in ops.items() if fn.startswith("K4 main")}
    phase("build", "SASS tensor-core instructions of the backward's main kernel: "
                   + " | ".join(f"{fn}: HGMMA x{c.get('HGMMA', 0)}, HMMA x{c.get('HMMA', 0)}"
                                for fn, c in sorted(backward.items())))
    bad = [fn for fn, c in backward.items() if c.get("HMMA", 0) or not c.get("HGMMA", 0)]
    if bad or set(backward) != want_bwd:
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


# The norms phase: calls a timing, taken in turn over the copies of x.
NORM_CALLS = 60


def norm_departure(got, want, terms):
    """(the largest |got - want| over its limit, the bit-equal share) of a
    bf16 norm output against its plain version; ``terms``: the fp32 size of
    each element's largest term, rows along the last axis. The limit is the
    card tests' (tests/test_torch_norms_cuda.py): one bf16 ulp at the largest
    of the two values and the element's terms, plus 2^-18 of the row's
    largest term."""
    g, w = got.float(), want.float()
    m = torch.maximum(torch.maximum(g.abs(), w.abs()), terms)
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    limit = ulp + 2.0 ** -18 * terms.amax(dim=-1, keepdim=True)
    return ((g - w).abs() / limit).max().item(), (got == want).float().mean().item()


def norms_phase(dev):
    """modulate and rms_norm (csrc/norms.cu) at the main path's shapes, bf16:
    every element of the kernel's output within the card tests' limit of its
    plain version's (:func:`norm_departure`) and at least 99 % of them
    bit-equal; the device time of a call (NORM_CALLS calls queued behind a
    device sleep, in turn over three copies of x where one fits in the 50 MB
    L2, so that x comes from device memory; medians of 5) of the kernel, the
    plain version and PyTorch's F.layer_norm (no modulation) and F.rms_norm,
    the library yardstick, which the port never calls; and the bytes bound
    at 3.35 TB/s (x read and out written once, the parameters' rows once)."""
    import torch.nn.functional as F

    from reptext_tpu_torch.nn.blocks import split_heads
    from reptext_tpu_torch.ops import norms

    gen = torch.Generator(device=dev).manual_seed(17)

    def act(*shape):
        x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.25
        x[..., ::97] *= 100.0
        return x.to(torch.bfloat16)

    def adaln(b, chunks=6):
        emb = (torch.randn(b, chunks * 3072, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        return emb.chunk(chunks, dim=-1)[:2]

    def weight():
        return (torch.rand(128, generator=gen, device=dev) + 0.5).to(torch.bfloat16)

    def modulate_terms(x, shift, scale):
        a = norms.layer_norm_no_affine_f32(x) * (1.0 + scale.float()[:, None, :])
        return torch.maximum(a.abs(), shift.float()[:, None, :].abs())

    joints = [act(1, 4608, 3072) for _ in range(3)]
    cases = {
        "modulate": {
            "(1,4096,3072)": [(act(1, 4096, 3072), *adaln(1)) for _ in range(3)],
            "(1,512,3072)": [(act(1, 512, 3072), *adaln(1))],
            "(1,4608,3072)": [(j, *adaln(1, 3)) for j in joints],
            "joint[:, 512:]": [(j[:, 512:], *adaln(1, 2)) for j in joints],
            "(2,4608,3072)": [(act(2, 4608, 3072), *adaln(2)) for _ in range(2)],
        },
        "rms_norm": {
            "(1,24,4608,128)": [(split_heads(act(1, 4608, 3072), 24), weight())
                                for _ in range(3)],
            "(1,24,512,128)": [(split_heads(act(1, 512, 3072), 24), weight())],
        },
    }
    calls = {"modulate": (norms.modulate, norms.modulate_plain,
                          lambda x, sh, sc: F.layer_norm(x, x.shape[-1:], eps=norms.LN_EPS),
                          modulate_terms),
             "rms_norm": (lambda x, w: norms.rms_norm(x, w, 1e-6),
                          lambda x, w: norms.rms_norm_plain(x, w, 1e-6),
                          (lambda x, w: F.rms_norm(x, x.shape[-1:], w, 1e-6))
                          if hasattr(F, "rms_norm") else None,
                          lambda x, w: norms.rms_norm_plain(x, w, 1e-6).float().abs())}
    results = {}
    for key, by_shape in cases.items():
        kernel, plain, library, terms = calls[key]
        res = results[key] = {f"{name}_by_shape": {} for name in (
            "card_ms", "bound_ms", "plain_ms", "library_ms", "of_limit", "bit_equal")}
        for label, copies in by_shape.items():
            args = copies[0]
            worst, equal = norm_departure(kernel(*args), plain(*args), terms(*args))
            x = args[0]
            nbytes = 2 * x.numel() * x.element_size() + sum(
                t.numel() * t.element_size() for t in args[1:])
            bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S

            def per_call_ms(fn, copies=copies):
                return cuda_time_ms(lambda: [fn(*copies[i % len(copies)])
                                             for i in range(NORM_CALLS)],
                                    repeats=5, warmup=1, queue_behind=40_000_000)[0] / NORM_CALLS

            k_ms, p_ms = per_call_ms(kernel), per_call_ms(plain)
            lib_ms = per_call_ms(library) if library else None
            for name, value in (("card_ms", k_ms), ("bound_ms", bound_ms), ("plain_ms", p_ms),
                                ("library_ms", lib_ms), ("of_limit", worst),
                                ("bit_equal", equal)):
                res[f"{name}_by_shape"][label] = value
            phase("norms", f"{key} {label}: kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
                           f"({100 * bound_ms / k_ms:.1f} % of it, {nbytes / k_ms / 1e6:.0f} "
                           f"GB/s), plain {p_ms:.4f} ms, library "
                           + (f"{lib_ms:.4f} ms" if lib_ms is not None else "not in this torch")
                           + f" (device time a call, medians of 5 x {NORM_CALLS} queued calls); "
                           f"against the plain version: bit-equal {equal:.6f} (at least "
                           f"0.99), the largest departure {worst:.3f} of its limit (at most 1)")
            if worst > 1.0 or equal < 0.99:
                raise SystemExit(f"{key} {label}: an element outside the limit ({worst:.3f} of "
                                 f"it) or {equal:.6f} bit-equal to its plain version")
        first = next(iter(by_shape))
        for name in ("card_ms", "bound_ms", "plain_ms", "library_ms"):
            res[name] = res[f"{name}_by_shape"][first]
    del cases, joints
    torch.cuda.empty_cache()
    return results


# The joins phase: the main path's two shapes (txt2img 1024^2: batch 1, a
# 64 x 64 token grid; the inpainting cell's CFG batch 2 at 1280x960: 60 x 80),
# 512 text tokens; (batch, grid rows, grid columns) by K1's shape.
JOIN_SHAPES = {"(1,24,4608,128)": (1, 64, 64), "(2,24,5312,128)": (2, 60, 80)}
JOIN_CALLS = {"K1": 5, "gelu": 20}
GELU_BIT_EQUAL = 0.9999


def joins_phase(dev):
    """The blocks' copy-free joins (``ops/attention.py::joins_in_place``) at
    JOIN_SHAPES, bf16: K1 on (text, image) segments as the projections leave
    them, each stream's output dense, and K1 written through ``out=`` into the
    attention columns of a single block's [B, S, 15360] ``proj_out`` input,
    out and lse bit-equal to K1 on the joint q, k and v, which holds to its
    plain version (:func:`compare`); the GELU kernel (csrc/gelu.cu) writing
    the MLP columns of that buffer, one launch, against F.gelu(approximate=
    "tanh") on the same x: at least GELU_BIT_EQUAL of the elements bit-equal
    and every one within one bf16 ulp, the attention columns left as K1 wrote
    them. Device times a call (JOIN_CALLS calls queued behind a device sleep,
    medians of 5): K1 on the joint tensors and on the segments, beside K1's
    bound; the GELU kernel, its bytes bound at 3.35 TB/s (x read and the
    columns written once) and F.gelu on a dense output, the library
    yardstick. Returns {"gelu": the kernels line's results, "K1": the segment
    route's by shape}."""
    import torch.nn.functional as F

    from reptext_tpu_torch.nn.blocks import split_heads
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.gelu import gelu_tanh_into

    gen = torch.Generator(device=dev).manual_seed(23)
    heads, inner, width = 24, 24 * 128, 4 * 24 * 128
    tiny = torch.finfo(torch.bfloat16).tiny

    def per_call_ms(key, fn):
        n = JOIN_CALLS[key]
        return cuda_time_ms(lambda: [fn() for _ in range(n)], repeats=5, warmup=1,
                            queue_behind=40_000_000)[0] / n

    gelu = {f"{name}_by_shape": {} for name in (
        "card_ms", "bound_ms", "library_ms", "bit_equal", "of_ulp")}
    k1 = {}
    for label, (b, gh, gw) in JOIN_SHAPES.items():
        s = 512 + gh * gw
        cos, sin = rope_tables(512, gh, gw, dev)

        def stream(n):   # a projection's [B, n, H * D] output seen as [B, H, n, D]
            return split_heads((torch.randn(b, n, inner, generator=gen, device=dev) * 1.5)
                               .to(torch.bfloat16), heads)

        q, k, v = ((stream(512), stream(s - 512)) for _ in range(3))
        joint = [torch.cat(x, dim=2) for x in (q, k, v)]
        want, want_lse = fa.flash_attention_rope(*joint, cos, sin)
        compare(f"K1 joint {label}", (want, want_lse),
                fa.flash_attention_rope_plain(*joint, cos, sin))
        flat = want.transpose(1, 2).reshape(b, s, inner)
        got, lse = fa.flash_attention_rope(q, k, v, cos, sin)
        seg_ok = torch.equal(torch.cat(got, dim=2), want) and torch.equal(lse, want_lse)
        dense = all(g.transpose(1, 2).is_contiguous() for g in got)
        del got, lse
        buf = torch.full((b, s, inner + width), 7.0, dtype=torch.bfloat16, device=dev)
        _, out_lse = fa.flash_attention_rope(*joint, cos, sin,
                                             out=split_heads(buf[..., :inner], heads))
        out_ok = (torch.equal(buf[..., :inner], flat) and torch.equal(out_lse, want_lse)
                  and bool((buf[..., inner:] == 7.0).all()))

        x = (torch.randn(b, s, width, generator=gen, device=dev) * 3.0).to(torch.bfloat16)
        x[..., ::101] *= 40.0
        launches = gelu_tanh_into.launches
        gelu_tanh_into(x, buf[..., inner:])
        launched = gelu_tanh_into.launches - launches
        ref = F.gelu(x, approximate="tanh").float()
        got = buf[..., inner:].float()
        m = torch.maximum(got.abs(), ref.abs()).clamp_min(tiny)
        of_ulp = ((got - ref).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)).max().item()
        equal = (got == ref).float().mean().item()
        kept = torch.equal(buf[..., :inner], flat)
        del got, ref, m

        joint_ms = per_call_ms("K1", lambda: fa.flash_attention_rope(*joint, cos, sin))
        seg_ms = per_call_ms("K1", lambda: fa.flash_attention_rope(q, k, v, cos, sin))
        k1_bound = forward_bound(b, heads, s, tables=True)[0]
        k1[label] = {"joint_ms": joint_ms, "segments_ms": seg_ms, "bound_ms": k1_bound,
                     "bit_equal": seg_ok and out_ok}
        nbytes = 2 * x.numel() * x.element_size()
        g_bound = 1e3 * nbytes / PEAK_BYTES_PER_S
        g_ms = per_call_ms("gelu", lambda: gelu_tanh_into(x, buf[..., inner:]))
        lib_ms = per_call_ms("gelu", lambda: F.gelu(x, approximate="tanh"))
        for name, value in (("card_ms", g_ms), ("bound_ms", g_bound), ("library_ms", lib_ms),
                            ("bit_equal", equal), ("of_ulp", of_ulp)):
            gelu[f"{name}_by_shape"][label] = value
        phase("joins", f"K1 {label}, 512 text tokens: segments and out= bit-equal to the joint "
                       f"route {seg_ok} / {out_ok}, each stream's output dense {dense}; "
                       f"joint {joint_ms:.4f} ms, segments "
                       f"{seg_ms:.4f} ms, bound {k1_bound:.4f} ms (device time a call, "
                       f"medians of 5 x {JOIN_CALLS['K1']} queued calls)")
        phase("joins", f"GELU [{b},{s},{width}] into [{b},{s},{inner + width}]: {launched} launch, "
                       f"bit-equal to F.gelu {equal:.6f} (at least {GELU_BIT_EQUAL}), the "
                       f"largest departure {of_ulp:.3f} bf16 ulp (at most 1), attention columns "
                       f"kept {kept}; kernel {g_ms:.4f} ms, bound {g_bound:.4f} ms "
                       f"({100 * g_bound / g_ms:.1f} % of it, {nbytes / g_ms / 1e6:.0f} GB/s), "
                       f"F.gelu {lib_ms:.4f} ms (medians of 5 x {JOIN_CALLS['gelu']} queued "
                       f"calls)")
        if not (seg_ok and out_ok and dense and kept and launched == 1 and equal >= GELU_BIT_EQUAL
                and of_ulp <= 1.0):
            raise SystemExit(f"joins {label}: K1's segments or out= not the joint route's, or "
                             f"the GELU kernel off F.gelu ({equal:.6f} bit-equal, {of_ulp:.3f} "
                             f"ulp, {launched} launches)")
        del q, k, v, joint, want, want_lse, flat, buf, x
        torch.cuda.empty_cache()
    first = next(iter(JOIN_SHAPES))
    for name in ("card_ms", "bound_ms", "library_ms"):
        gelu[name] = gelu[f"{name}_by_shape"][first]
    return {"gelu": gelu, "K1": k1}


# The trained-weights demo at cut step counts (the protocol's full run is
# ``python -m reptext_tpu_torch.examples.overfit_e2e --holdout``): full demo
# width, fp32, the holdout set. Per model call FLUX 2 + 4 and the ControlNet
# 1 + 2 blocks make DEMO_BLOCKS attention calls, all K2 at 69 tokens (the
# route rotates outside at one chunk); a train step is one forward and one
# backward of both models, a sampled image one call per step (the ControlNet
# on every step).
DEMO_STEPS = {"vae": 200, "flux": 300, "sample": 4}
DEMO_BLOCKS = 2 + 4 + 1 + 2
DEMO_NORMS = copied(norm_launches(1, 1, (2, 4), (1, 2)))   # short text, K2: copies
GATES_STEPS = 8


def demo_phase(dev):
    """overfit_e2e at DEMO_STEPS with --holdout and a --params-cache under
    SCRATCH: finite flow losses, the last below the first; K2 and K4 per flow
    step and K2 per image as the route says, K1 = K3 = 0; the trained and the
    random char accuracy (not gated at cut steps); the cache bit-equal to the
    trained modules (save_pipeline_params, then load_pipeline_params), fp32.
    Returns ({path: launches}, the cache directory)."""
    from reptext_tpu_torch.examples import overfit_e2e as demo
    from reptext_tpu_torch.io.checkpoint import load_pipeline_params

    work = os.path.join(ROOT, SCRATCH, "demo")
    shutil.rmtree(work, ignore_errors=True)
    cache, out_json = os.path.join(work, "ckpt"), os.path.join(work, "overfit_e2e.json")
    args = demo.build_parser().parse_args(
        ["--steps-vae", str(DEMO_STEPS["vae"]), "--steps-flux", str(DEMO_STEPS["flux"]),
         "--steps-sample", str(DEMO_STEPS["sample"]), "--holdout", "--params-cache", cache,
         "--output", out_json])
    phase("demo", f"overfit_e2e --steps-vae {DEMO_STEPS['vae']} "
                  f"--steps-flux {DEMO_STEPS['flux']} --steps-sample {DEMO_STEPS['sample']} "
                  f"--holdout; conditions: {demo.conditions_source()}; fp32 with "
                  f"{demo.precision_settings()}, convolutions TF32 "
                  f"{torch.backends.cudnn.allow_tf32} (PyTorch's defaults)")
    reset_train_launches()
    t0 = time.perf_counter()
    out, pipe = demo.run(args)
    wall = time.perf_counter() - t0
    counts = {key: entry.launches for key, entry in train_launches().items()}
    timing = out["timing"]
    per_step = timing["flow_launches_per_step"]
    per_image = timing["attention_forward_launches_per_image"]
    n_images = timing["images_sampled"]
    steps = DEMO_STEPS["flux"]
    want_k2 = steps * DEMO_BLOCKS + n_images * DEMO_STEPS["sample"] * DEMO_BLOCKS
    # one forward of both models a flow step and a sampled step: the norms
    want_norms = scaled(DEMO_NORMS, steps + n_images * DEMO_STEPS["sample"])
    ok_launch = (per_step == {"K2": DEMO_BLOCKS, "K4": DEMO_BLOCKS}
                 and per_image == DEMO_STEPS["sample"] * DEMO_BLOCKS
                 and counts["K2"] == want_k2 and counts["K4"] == steps * DEMO_BLOCKS
                 and counts["K1"] == counts["K3"] == 0
                 and all(counts[k] == n for k, n in want_norms.items()))
    ok_loss = timing["flow_losses_finite"] and timing["flow_loss_last"] < timing["flow_loss_first"]
    phase("demo", f"{wall:.1f} s (stages {timing['stages_s']}); flow loss "
                  f"{timing['flow_loss_first']:.5f} -> {timing['flow_loss_last']:.5f}, all finite "
                  f"{timing['flow_losses_finite']}; {timing['flow_ms_per_step']:.2f} ms per flow "
                  f"step, sampler {timing['sample_ms_per_step_trained']:.2f} ms/step; VAE PSNR "
                  f"{out['vae_recon_psnr_db']} dB; char accuracy trained "
                  f"{out['char_accuracy_trained']}, random {out['char_accuracy_random']}, "
                  f"holdout {out['char_accuracy_holdout']} (not gated at cut steps); edge IoU "
                  f"trained {out['mean_edge_iou_trained']}, random {out['mean_edge_iou_random']}")
    phase("demo", f"launches: per flow step {per_step} (want K2 = K4 = {DEMO_BLOCKS}), per image "
                  f"{per_image} (want {DEMO_STEPS['sample'] * DEMO_BLOCKS}), in all {counts} "
                  f"(want K2 {want_k2}, K4 {steps * DEMO_BLOCKS}, K1 = K3 = 0, {want_norms}) -> "
                  f"{'ok' if ok_launch and ok_loss else 'FAIL'}")
    if not (ok_launch and ok_loss):
        raise SystemExit("the demo's losses or launches are not what they must be")
    # the cache holds the trained modules: load it and compare with a save of
    # the same modules now (the pipeline holds the random FLUX and ControlNet
    # again; its VAE is the trained one)
    saved = load_pipeline_params(cache, ("vae", "flux", "controlnet"))
    vae_state = pipe.vae.state_dict()
    same = (all(torch.equal(saved["vae"][k], v.cpu()) for k, v in vae_state.items())
            and all(t.dtype == torch.float32 for state in saved.values() for t in state.values())
            and set(saved["vae"]) == set(vae_state))
    for name in ("flux", "controlnet"):
        module = getattr(pipe, name)
        module.load_state_dict(saved[name])
        same = same and all(torch.equal(saved[name][k], v.cpu())
                            for k, v in module.state_dict().items())
    phase("demo", f"save_pipeline_params -> load_pipeline_params: the VAE, FLUX and the "
                  f"ControlNet bit-equal, fp32 -> {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit("the demo's checkpoint does not round-trip bit for bit")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return {"demo": counts}, cache


def fixed_cache_steps(steps):
    """Steps the fixed-interval cache computes at interval 2 and warmup
    steps // 3 (sampling/sampler.py::velocity_cache_select): the warmup, every
    second step after it, and the last."""
    warm = max(steps // 3, 1)
    return sum(1 for i in range(steps) if i < warm or i == steps - 1 or (i - warm) % 2 == 0)


def gates_phase(dev, cache):
    """trained_gates on the demo phase's checkpoint with --allow-low-accuracy
    at GATES_STEPS sample steps: per variant the accuracy, ms/step and forward
    launches; the fixed cache launches what its schedule says, the adaptive
    cache no more than the uncached run, fp8 as many."""
    from reptext_tpu_torch.benchmarks import trained_gates

    out_json = os.path.join(os.path.dirname(cache), "trained_gates.json")
    reset_train_launches()
    t0 = time.perf_counter()
    trained_gates.main(["--params-cache", cache, "--steps-sample", str(GATES_STEPS),
                        "--allow-low-accuracy", "--output", out_json])
    wall = time.perf_counter() - t0
    counts = {key: entry.launches for key, entry in train_launches().items()}
    with open(out_json) as f:
        out = json.load(f)
    per = out["attention_launches_per_image"]
    want = {"uncached": GATES_STEPS * DEMO_BLOCKS,
            "vc_fixed": fixed_cache_steps(GATES_STEPS) * DEMO_BLOCKS,
            "fp8w": GATES_STEPS * DEMO_BLOCKS}
    # every model call runs both models, so the norms follow K2 block for block
    norms_ok = all(counts[k] * DEMO_BLOCKS == counts["K2"] * n for k, n in DEMO_NORMS.items())
    ok = (all(per[k] == n for k, n in want.items()) and per["vc_adaptive"] <= per["uncached"]
          and counts["K4"] == counts["K1"] == counts["K3"] == 0 and norms_ok)
    phase("gates", f"{wall:.1f} s; " + "; ".join(
        f"{k}: char accuracy {out['char_accuracy_' + k]}, {out['sample_ms_per_step'][k]:.2f} "
        f"ms/step, {per[k]} launches per image" for k in per)
        + f"; want {want}, adaptive <= uncached; launches in all {counts}, the norms "
          f"K2 x {DEMO_NORMS} / {DEMO_BLOCKS}: {norms_ok} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the trained gates' launches are not what the cache schedules say")
    return {"gates": counts}


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
    expect = {"K1": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
              **norm_launches(steps, gate)}
    launches = dict.fromkeys(expect, 0)
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
                     + stage_seconds(timings)
                     + f"; sampler {1e3 * timings['sample'] / steps:.1f} ms/step; "
                     f"kernel launches K1 {got['K1']} (expected {expect['K1']}) K2 {got['K2']} "
                     f"K3 {got['K3']} K5 {got['K5']} (expected 0, 0 and 0: every block passes RoPE "
                     f"tables, S = 4608, one device), modulate {got['modulate']} rms_norm "
                     f"{got['rms_norm']} (expected {expect['modulate']} and {expect['rms_norm']}); "
                     f"image {images.shape} {images.dtype}, "
                     f"mean {images.mean():.2f}; latents finite {finite}")
        if not (finite and shape_ok and got == expect):
            raise SystemExit(f"end-to-end request {i + 1} failed its checks")
    phase("e2e", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                 f"(torch.cuda.max_memory_allocated)")
    return launches, pipe, cond


# The plain attention versions, module by module: the tiny phase counts their
# calls while it drives the CLI on the card, and every count must stay 0.
PLAIN_VERSIONS = (
    ("reptext_tpu_torch.ops.flash_attention",
     ("flash_attention_plain", "flash_attention_rope_plain", "flash_attention_streaming_plain",
      "flash_attention_backward_plain", "backward_preprocess_plain")),
    ("reptext_tpu_torch.ops.ring_attention", ("ring_step_plain",)),
    ("reptext_tpu_torch.ops.attention", ("plain_attention",)),
    ("reptext_tpu_torch.parallel.sequence", ("plain_attention", "ring_step_plain")),
)


@contextlib.contextmanager
def plain_calls():
    """{module.function: calls} of every plain attention version while open
    (each wrapped by a counter, put back on exit)."""
    import importlib

    calls, saved = {}, []
    for mod_name, names in PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        for name in names:
            fn, key = getattr(mod, name), f"{mod_name.rsplit('.', 1)[1]}.{name}"

            def counted(*a, _fn=fn, _key=key, **kw):
                calls[_key] = calls.get(_key, 0) + 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def tiny_phase(dev, steps, cn_steps, seed):
    """The JAX CLI's documented demo (``--random-weights --tiny``) on the card
    through the port's CLI functions, in fp32 as the JAX CLI runs --tiny: FLUX
    2 + 4 and the ControlNet at 4 heads x 32. txt2img at 1024^2 (K1) and
    1536^2 (K3), one 1280x960 inpaint request, 3 train steps at batch 2 (K1,
    K4), one request served over HTTP, and the 1024^2 request over 2 thread
    ranks with the ring backend (K5) against its one-device run. Every path:
    launch counts set to 0 just before and read just after, against the
    blocks' count; finite fp32 outputs; no call of a plain attention version
    (every launch on these paths is a head dim 32 instantiation). Returns the
    launches by path."""
    import http.client
    import threading

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    data, size, font_size, reqs = load_requests()
    large = np.load(LARGE_FIXTURE)
    name, text, pos = reqs[0]
    common = ["--steps", str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed),
              "--random-weights", "--tiny"]

    def parse(*flags):
        return cli.build_parser().parse_args([*flags, *common])

    args = parse("--text", text, "--position", *map(str, pos), "--size", str(size),
                 "--font-size", str(font_size))
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    torch.cuda.synchronize()
    flux_cfg, cn_cfg = pipe.flux.config, pipe.controlnet.config
    flux_n = flux_cfg.num_layers + flux_cfg.num_single_layers
    cn_n = cn_cfg.num_layers + cn_cfg.num_single_layers
    depth = {"flux_depth": (flux_cfg.num_layers, flux_cfg.num_single_layers),
             "cn_depth": (cn_cfg.num_layers, cn_cfg.num_single_layers)}
    dtypes = {str(next(m.parameters()).dtype) for m in (pipe.flux, pipe.controlnet, pipe.vae)}
    phase("tiny", f"cli.build_pipeline(--random-weights --tiny) on {dev} in "
                  f"{time.perf_counter() - t0:.2f} s: compute dtype {pipe.compute_dtype}, "
                  f"parameters {sorted(dtypes)}, FLUX {flux_cfg.num_layers} + "
                  f"{flux_cfg.num_single_layers} and ControlNet {cn_cfg.num_layers} + "
                  f"{cn_cfg.num_single_layers} blocks at {flux_cfg.num_attention_heads} heads x "
                  f"{flux_cfg.attention_head_dim}")
    if (pipe.compute_dtype != torch.float32 or dtypes != {"torch.float32"}
            or flux_cfg.attention_head_dim != TINY_D or cn_cfg.attention_head_dim != TINY_D):
        raise SystemExit("--tiny on the card is not the fp32, head dim 32 pipeline")
    gate = min(cn_steps, steps)
    zero = {"K1": 0, "K2": 0, "K3": 0, "K5": 0}
    launches, fails = {}, []

    def fp32_request(label, call, run_pipe, expect, shape):
        out = {}
        got = run_request(label, call, run_pipe, expect, shape, steps, tag="tiny", out=out)
        if out["latents"].dtype != torch.float32:
            fails.append(f"{label}: latents {out['latents'].dtype}")
        return got

    with plain_calls() as plain:
        cond, source = conditions_for(data, name, text, pos, size, font_size)
        launches["tiny_txt2img_1024"] = fp32_request(
            f"txt2img {size}^2 (S = {TXT_LEN + (size // 16) ** 2}, conditions: {source})",
            lambda timings: cli.generate(args, pipe, cond, timings=timings, output_type="latent"),
            pipe, dict(zero, K1=steps * flux_n + gate * cn_n,
                       **norm_launches(steps, gate, **depth)), (1, size, size, 3))

        lname = "txt2img_1536"
        width, height = (int(v) for v in large[f"{lname}.size"])
        largs = parse("--text", str(large[f"{lname}.text"]), "--position",
                      *(str(int(v)) for v in large[f"{lname}.position"]), "--size", str(width),
                      "--font-size", str(int(large["font_size"])))
        lcond, source = conditions_for(large, lname, str(large[f"{lname}.text"]),
                                       tuple(int(v) for v in large[f"{lname}.position"]),
                                       (width, height), int(large["font_size"]), LARGE_FIXTURE)
        big = pipe.with_config(cli.pipeline_config(largs, height, width))
        s = TXT_LEN + big.pipe_cfg.image_seq_len
        launches["tiny_txt2img_1536"] = fp32_request(
            f"txt2img {width}x{height} (S = {s}, conditions: {source})",
            lambda timings: cli.generate(largs, big, lcond, timings=timings,
                                         output_type="latent"),
            big, dict(zero, K3=steps * flux_n + gate * cn_n,
                      **copied(norm_launches(steps, gate, **depth))),
            (1, height, width, 3))
        del big

        iname = "inpaint_1280x960"
        width, height = (int(v) for v in large[f"{iname}.size"])
        itext, ipos = str(large[f"{iname}.text"]), tuple(int(v) for v in large[f"{iname}.position"])
        iargs = parse("--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE), "--text",
                      itext, "--position", *map(str, ipos), "--size", str(width),
                      "--font-size", str(int(large["font_size"])))
        inp = cli.build_pipeline(iargs, height, width)
        icond, source = conditions_for(large, iname, itext, ipos, (width, height),
                                       int(large["font_size"]), LARGE_FIXTURE)
        image, mask = source_image(seed, height, width), box_mask(icond)
        s = TXT_LEN + inp.pipe_cfg.image_seq_len
        icn = inp.inpaint_controlnet.config
        icn_n = icn.num_layers + icn.num_single_layers
        kernel = "K3" if fa.streams(s) else "K1"
        # FLUX and the RepText net as txt2img's, the inpaint ControlNet every step
        icn_norms = norm_launches(0, steps, cn_depth=(icn.num_layers, icn.num_single_layers))
        inorms = {k: v + icn_norms[k] for k, v in norm_launches(steps, gate, **depth).items()}
        if kernel == "K3":
            inorms = copied(inorms)
        launches["tiny_inpaint_1280x960"] = fp32_request(
            f"inpaint {width}x{height} (S = {s}, CFG batch 2, cli.build_pipeline(--mode inpaint "
            f"--tiny), conditions: {source})",
            lambda timings: cli.generate_inpaint(iargs, inp, icond, image, mask, timings=timings,
                                                 output_type="latent"),
            inp, dict(zero, **{kernel: steps * (flux_n + icn_n) + gate * cn_n}, **inorms),
            (1, height, width, 3))
        del inp

        # 3 train steps at batch 2 through cli.train (remat: every block's
        # attention twice, K4 on all but FLUX's first double block)
        targs = cli.build_parser().parse_args(
            ["--mode", "train", "--random-weights", "--tiny", "--size", str(size),
             "--train-steps", "3", "--batch-size", "2", "--seed", str(seed)])
        tpipe = cli.build_pipeline(targs)
        losses = []
        reset_train_launches()
        t0 = time.perf_counter()
        trainer = cli.train(targs, tpipe, dataset=fixture_dataset(tpipe, seed),
                            on_event=lambda kind, info: losses.append(info["loss"])
                            if kind == "step" else None)
        torch.cuda.synchronize()
        got = read_train_launches()
        fwd = flux_n + cn_n
        texpect = {"K1": 3 * (2 * fwd - 1), "K2": 0, "K3": 0, "K4": 3 * (fwd - 1),
                   **scaled(train_norm_launches(depth["flux_depth"], depth["cn_depth"]), 3)}
        ok = (len(losses) == 3 and all(np.isfinite(losses)) and not trainer.faults
              and got == texpect and tpipe.compute_dtype == torch.float32
              and all(p.dtype == torch.float32 for p in tpipe.controlnet.parameters()))
        launches["tiny_train"] = got
        phase("tiny", f"cli.train --tiny, 3 steps at batch 2, {size}^2: "
                      f"{time.perf_counter() - t0:.3f} s; losses {[f'{x:.6f}' for x in losses]}; "
                      f"launches " + ", ".join(f"{k} {got[k]} (expected {texpect[k]})"
                                               for k in sorted(texpect))
                      + f"; fp32 ControlNet {ok} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append("train")
        del trainer, tpipe

        # one request served over HTTP on 127.0.0.1 by cli.build_server
        sargs = cli.build_parser().parse_args(
            ["--mode", "serve", "--random-weights", "--tiny", "--size", str(size), "--steps",
             str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--port", "0"])
        server = cli.build_server(sargs)
        server.worker.conditions = lambda req, width, height: cond
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            reset_launches()
            host, port = server.address[:2]
            conn = http.client.HTTPConnection(host, port, timeout=600)
            conn.request("POST", "/generate", body=json.dumps({
                "prompt": cli.build_prompt("a street sign in city", [text], cli.PROMPT_SUFFIX),
                "lines": [{"text": text, "position": list(pos), "font_size": font_size}],
                "seed": seed}), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, body = resp.status, json.loads(resp.read())
            conn.close()
            got = read_launches()
        finally:
            server.shutdown()
            thread.join(timeout=60)
        is_png, served = png_array(body["image_png_base64"]) if status == 200 else (False, None)
        sexpect = dict(zero, K1=steps * flux_n + gate * cn_n, **norm_launches(steps, gate, **depth))
        ok = (status == 200 and is_png and served.shape == (size, size, 3) and got == sexpect
              and server.worker.pipeline.compute_dtype == torch.float32)
        launches["tiny_serve"] = got
        phase("tiny", f"cli.build_server --tiny: one request over HTTP, HTTP {status}, PNG "
                      f"{None if served is None else served.shape}; launches "
                      + ", ".join(f"{k} {got[k]} (expected {sexpect[k]})" for k in sorted(sexpect))
                      + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append("serve")
        del server

        # the 1024^2 request over 2 thread ranks with the ring backend (K5),
        # the ControlNet on every step, against its one-device run
        pargs = cli.build_parser().parse_args(
            ["--text", text, "--position", *map(str, pos), "--size", str(size), "--font-size",
             str(font_size), "--steps", str(steps), "--controlnet-step", str(steps), "--seed",
             str(seed), "--random-weights", "--tiny"])
        sp_pipe = pipe.with_config(cli.pipeline_config(pargs, size, size))
        clip_ids, t5_ids = cli._prompt_ids(pargs, sp_pipe, cli.build_prompt(
            pargs.prompt, pargs.text, cli.PROMPT_SUFFIX))
        s_img = sp_pipe.pipe_cfg.image_seq_len
        noise = torch.randn((1, s_img, 64), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(seed))
        kw = dict(clip_ids=clip_ids, t5_ids=t5_ids, seed=seed, latents=noise,
                  output_type="latent", num_inference_steps=steps,
                  guidance_scale=pargs.guidance_scale)
        runs = {}
        for label, backend in (("single", None), ("ring", "ring")):
            def call(g, backend=backend):
                timings = {}
                run = sp_pipe if g is None else sp_pipe.with_config(
                    sp_pipe.pipe_cfg).shard_for_sp(g, backend)
                return run(cond, timings=timings, **kw), timings

            runs[label], got, _ = sp_run(
                dev, f"tiny txt2img {size}^2 (S = {TXT_LEN + s_img}, fp32)", backend, call,
                sp_expect(backend, "K1", steps * (flux_n + cn_n),
                          norm_launches(steps, steps, **depth)), runs.get("single"), steps,
                (1, s_img, 64))
            if runs[label].dtype != torch.float32:
                fails.append(f"sp {label}: latents {runs[label].dtype}")
            if backend:
                launches["tiny_sp2_ring"] = got
        del runs, sp_pipe, pipe
    phase("tiny", f"plain attention versions called on these paths: {dict(plain) or 'none'} -> "
                  + ("ok" if not plain else "FAIL"))
    if plain or fails:
        raise SystemExit(f"the tiny phase failed its checks: {fails}; plain calls {plain}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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


def run_request(label, call, pipe, expect, shape, steps, tag="large", out=None):
    """One request (``call(timings)`` -> latents) with its launch counts set
    to 0 just before and read just after; checks and prints it under
    ``tag``; ``out`` (a dict), when given, receives the latents, the image
    and the sampler's ms/step."""
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
    phase(tag, f"{label}: {wall:.3f} s/image (cold for its size); stages "
                   + stage_seconds(timings)
                   + f"; sampler {1e3 * timings['sample'] / steps:.1f} ms/step; kernel launches "
                   + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                   + f"; image {images.shape} {images.dtype}, mean {images.mean():.2f}; latents "
                   f"finite {finite}; peak device memory {peak:.2f} GiB")
    if not (finite and shape_ok and got == expect):
        raise SystemExit(f"the {label} request failed its checks")
    if out is not None:
        out.update(latents=lat, image=images, ms_step=1e3 * timings["sample"] / steps, peak=peak)
    return got


def large_phase(dev, pipe, steps, cn_steps, seed, profile=False):
    """txt2img at 1536^2, then inpainting at 1280x960 and 1536x1152, on the
    e2e phase's modules plus one inpaint ControlNet; with ``profile``, a
    device profile of two inpaint steps at 1536x1152. Returns the launches
    and the inpaint pipeline (the serve phase's)."""
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
    expect = {"K1": 0, "K2": 0, "K3": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K5": 0,
              **copied(norm_launches(steps, gate))}
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
        expect = {"K1": 0, "K2": 0, "K3": 0, "K5": 0, **norm_launches(steps, steps + gate)}
        expect[kernel] = steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS
        if kernel == "K3":
            expect = copied(expect)
        launches[name] = run_request(
            f"inpaint {width}x{height} (S = {s}, CFG batch 2, true-CFG {TRUE_GUIDANCE}, "
            f"mask {int((mask > 0).sum())} px, conditions: {source})",
            lambda timings: cli.generate_inpaint(args, inp, cond, image, mask, timings=timings,
                                                 output_type="latent"),
            inp, expect, (1, height, width, 3), steps)
        if profile and kernel == "K3":
            inpaint_profile(dev, inp, cond, image, mask, seed)
    return launches, inp


def txt2img_expected(steps, cn_steps, run):
    """The launches of the 1024^2 txt2img steps ``run`` of a ``steps``-step
    schedule: FLUX a step (K1 57), the ControlNet (K1 14) where its gate (by
    absolute step) is on."""
    gate = min(cn_steps, steps)
    cn = sum(1 for i in run if i < gate)
    return {"K1": len(run) * DOUBLE_CALLS + cn * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
            **norm_launches(len(run), cn)}


def surface_phase(dev, pipe, steps, cn_steps, seed):
    """The pipelines' call surface on the e2e pipeline at 1024^2 (K1): img2img
    of a seeded source image at strength 0.6 through cli.generate; a callback
    on every step against the same call without one (bit-equal latents: the
    velocity cache is off); a callback that returns False after step 2;
    custom sigmas and custom timesteps of length 3 through the CLI's flags;
    return_dict=True with output_type="pil". Each run's launch counts are
    set to 0 just before it and read just after."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.pipelines.outputs import FluxPipelineOutput

    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    cond, source = conditions_for(data, name, text, pos, size, font_size)

    def parse(*extra):
        return cli.build_parser().parse_args(
            ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
             str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
             str(font_size), "--random-weights", *extra])

    args = parse()
    clip_ids, t5_ids = cli.request_ids(args, pipe)
    kw = dict(clip_ids=clip_ids, t5_ids=t5_ids, seed=seed, num_inference_steps=steps,
              guidance_scale=args.guidance_scale)
    launches, runs = {}, {}
    strength = 0.6
    t_start = min(int(steps * (1.0 - strength)), steps - 1)
    custom = [1.0, 0.66, 0.33]

    def run(key, label, call, expect):
        """``call(timings)`` -> latents or a FluxPipelineOutput of PIL images."""
        torch.cuda.synchronize()
        reset_launches()
        timings = {}
        t0 = time.perf_counter()
        out = call(timings)
        if isinstance(out, FluxPipelineOutput):
            images = np.stack([np.asarray(im) for im in out.images])
            finite = True
        else:
            images = pipe.decode(out)
            finite = bool(torch.isfinite(out).all())
            runs[key] = out
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        launches[f"surface_{key}"] = got
        shape_ok = images.shape == (1, size, size, 3) and images.dtype == np.uint8
        ok = finite and shape_ok and got == expect
        phase("surface", f"{label}: {wall:.3f} s/image; stages "
                         + stage_seconds(timings)
                         + "; kernel launches "
                         + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                         + f"; image {images.shape} {images.dtype}; finite {finite} -> "
                         f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the surface run {key} failed its checks")

    init = source_image(seed, size, size)[None]
    run("img2img", f"img2img {size}^2 (conditions: {source}) at strength {strength}: t0 = "
                   f"{t_start}, {steps - t_start} of {steps} steps",
        lambda t: cli.generate(parse("--strength", str(strength)), pipe, cond, timings=t,
                               output_type="latent", init_image=init),
        txt2img_expected(steps, cn_steps, range(t_start, steps)))
    run("no_callback", f"{steps} steps, no callback",
        lambda t: pipe(cond, output_type="latent", timings=t, **kw),
        txt2img_expected(steps, cn_steps, range(steps)))
    seen = []

    def record(i, latents):
        seen.append((i, bool(torch.isfinite(latents).all())))

    run("callback", f"{steps} steps, a callback after every step",
        lambda t: pipe(cond, output_type="latent", timings=t, callback=record, **kw),
        txt2img_expected(steps, cn_steps, range(steps)))
    same = bool(torch.equal(runs["callback"], runs["no_callback"]))
    ok = same and seen == [(i, True) for i in range(1, steps + 1)]
    phase("surface", f"callback steps {[i for i, _ in seen]}, latents finite at each; latents "
                     f"with the callback bit-equal to those without {same} -> "
                     f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the callback changed the result")
    run("callback_stop", "a callback that returns False after step 2",
        lambda t: pipe(cond, output_type="latent", timings=t, callback=lambda i, lat: i < 2,
                       **kw), txt2img_expected(steps, cn_steps, range(min(2, steps))))
    for flag in ("sigmas", "timesteps"):
        values = custom if flag == "sigmas" else [1000.0 * v for v in custom]
        run(flag, f"custom {flag} {values} through --{flag} (overrides --steps {steps})",
            lambda t, flag=flag, values=values: cli.generate(
                parse(f"--{flag}", ",".join(f"{v:g}" for v in values)), pipe, cond, timings=t,
                output_type="latent"),
            txt2img_expected(len(custom), cn_steps, range(len(custom))))
    run("pil", f"return_dict=True, output_type='pil', {steps} steps",
        lambda t: pipe(cond, output_type="pil", return_dict=True, timings=t, **kw),
        txt2img_expected(steps, cn_steps, range(steps)))
    return launches


def checkpoint_phase(dev, steps, cn_steps, seed):
    """A synthetic diffusers snapshot at full width (cut depth) written with the
    port's writer, converted by io.convert_cli, loaded through
    cli.build_pipeline(--checkpoint-dir) and, from the converter's trees,
    through FluxRepTextPipeline.create(params=...): every parameter bit-equal,
    one 1024^2 request's latents bit-equal, its ids from the vendored
    tokenizers. Returns the first pipeline's launches."""
    import dataclasses
    import resource
    import shutil

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig,
    )
    from reptext_tpu_torch.io import convert as C
    from reptext_tpu_torch.io import convert_cli, synthetic
    from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
    from reptext_tpu_torch.text import CLIPBPETokenizer

    flux_cfg = dataclasses.replace(FluxConfig(), num_layers=CKPT_FLUX[0],
                                   num_single_layers=CKPT_FLUX[1])
    cn_cfg = dataclasses.replace(ControlNetConfig(), num_layers=CKPT_CN[0],
                                 num_single_layers=CKPT_CN[1])
    t5_cfg = dataclasses.replace(T5Config(), num_layers=CKPT_T5)
    vae_cfg, clip_cfg = VAEConfig(), CLIPConfig()
    cut = (f"FLUX {CKPT_FLUX[0]} + {CKPT_FLUX[1]} blocks of 19 + 38, ControlNet {CKPT_CN[0]} + "
           f"{CKPT_CN[1]} of 4 + 10, T5-XXL {CKPT_T5} layers of 24; widths, CLIP-L and the VAE "
           "whole")
    work = os.path.join(ROOT, SCRATCH)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    snap, out = os.path.join(work, "snapshot"), os.path.join(work, "converted")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    try:
        free = shutil.disk_usage(work).free / 1e9
        t0 = time.perf_counter()
        written = synthetic.write_pipeline_snapshot(
            os.path.join(snap, "pipeline"), flux_cfg, vae_cfg, clip_cfg, t5_cfg, seed=seed,
            device=dev, dtype=torch.bfloat16)
        written += synthetic.write_controlnet_snapshot(
            os.path.join(snap, "controlnet"), cn_cfg, seed=seed + 1, device=dev,
            dtype=torch.bfloat16)
        synthetic.write_tokenizers(os.path.join(snap, "pipeline"))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = convert_cli.main(["--pipeline-dir", os.path.join(snap, "pipeline"),
                               "--controlnet-dir", os.path.join(snap, "controlnet"),
                               "--out", out])
        convert_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
        phase("checkpoint", f"synthetic diffusers snapshot, bf16, seeded ({cut}): "
                            f"{written / 1e9:.3f} GB written in {write_s:.1f} s ({free:.0f} GB "
                            f"free before); io.convert_cli exit {rc} in {convert_s:.3f} s, "
                            f"converted directory {size / 1e9:.3f} GB")

        data, req_size, font_size, reqs = load_requests()
        name, text, pos = reqs[0]
        args = cli.build_parser().parse_args(
            ["--checkpoint-dir", out, "--text", text, "--position", *map(str, pos), "--size",
             str(req_size), "--steps", str(steps), "--controlnet-step", str(cn_steps), "--seed",
             str(seed), "--font-size", str(font_size)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = cli.build_pipeline(args)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        modules = ("flux", "controlnet", "vae", "clip", "t5")
        nbytes = sum(p.numel() * p.element_size() for m in modules
                     for p in getattr(pipe, m).parameters())
        t0 = time.perf_counter()
        trees = {
            "flux": C.convert_flux_transformer(C.load_safetensors_state(
                os.path.join(snap, "pipeline", "transformer"), dtype=None), flux_cfg),
            "controlnet": C.convert_controlnet(C.load_safetensors_state(
                os.path.join(snap, "controlnet"), dtype=None), cn_cfg),
            "vae": C.convert_vae(C.load_safetensors_state(
                os.path.join(snap, "pipeline", "vae"), dtype=None), vae_cfg),
            "clip": C.convert_clip(C.load_safetensors_state(
                os.path.join(snap, "pipeline", "text_encoder"), dtype=None), clip_cfg),
            "t5": C.convert_t5(C.load_safetensors_state(
                os.path.join(snap, "pipeline", "text_encoder_2"), dtype=None), t5_cfg)}
        ref = FluxRepTextPipeline.create(flux_cfg, cn_cfg, vae_cfg, pipe.pipe_cfg, params=trees,
                                         clip_cfg=clip_cfg, t5_cfg=t5_cfg, device=dev)
        torch.cuda.synchronize()
        tree_s = time.perf_counter() - t0
        del trees
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        same = all(
            [n for n, _ in getattr(pipe, m).named_parameters()]
            == [n for n, _ in getattr(ref, m).named_parameters()]
            and all(a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
                    for a, b in zip(getattr(pipe, m).parameters(), getattr(ref, m).parameters()))
            for m in modules)
        phase("checkpoint", f"cli.build_pipeline(--checkpoint-dir) {load_s:.3f} s for "
                            f"{nbytes / 1e9:.3f} GB of parameters ({nbytes / 1e9 / load_s:.2f} "
                            f"GB/s, files mapped from the page cache onto the card); "
                            f"create(params=converter trees) {tree_s:.3f} s; every parameter of "
                            f"the five modules bit-equal {same}; host peak RSS {rss:.2f} GiB "
                            f"(ru_maxrss; {rss0:.2f} before the phase)")

        prompt = cli.build_prompt(args.prompt, args.text, cli.PROMPT_SUFFIX)
        clip_ids, t5_ids = cli._prompt_ids(args, pipe, prompt)
        demo = cli.demo_token_ids(prompt, pipe.clip.config, pipe.t5.config, 512)
        direct = CLIPBPETokenizer.from_dir(os.path.join(out, "tokenizer")).encode(prompt)
        vendored = (clip_ids[0].tolist() == direct and not np.array_equal(clip_ids, demo[0])
                    and not np.array_equal(t5_ids, demo[1]))
        cond, source = conditions_for(data, name, text, pos, req_size, font_size)
        gate = min(cn_steps, steps)
        expect = {"K1": steps * sum(CKPT_FLUX) + gate * sum(CKPT_CN), "K2": 0, "K3": 0, "K5": 0,
                  **norm_launches(steps, gate, CKPT_FLUX, CKPT_CN)}
        reset_launches()
        t0 = time.perf_counter()
        lat = cli.generate(args, pipe, cond, output_type="latent")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        lat_ref = cli.generate(args, ref, cond, output_type="latent")
        equal = bool(torch.equal(lat, lat_ref))
        finite = bool(torch.isfinite(lat).all())
        phase("checkpoint", f"1024^2 request ({name}, conditions: {source}) through both: "
                            f"{wall:.3f} s; ids from the vendored tokenizers {vendored} (CLIP "
                            f"{int((clip_ids[0] != clip_ids[0, -1]).sum())} tokens before its "
                            f"padding, T5 {int((t5_ids[0] > 1).sum())} + </s>); latents bit-equal "
                            f"{equal}, finite {finite}; launches "
                            + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect)))
        if not (rc == 0 and same and vendored and equal and finite and got == expect):
            raise SystemExit("the checkpoint phase failed its checks")
        del pipe, ref, lat, lat_ref
        torch.cuda.empty_cache()
        return got
    finally:
        shutil.rmtree(work, ignore_errors=True)


def png_array(b64):
    from PIL import Image

    raw = base64.b64decode(b64)
    return raw[:8] == b"\x89PNG\r\n\x1a\n", np.asarray(Image.open(io.BytesIO(raw)))


def serve_phase(dev, pipe, inp, steps, cn_steps, seed):
    """A GenerationServer over the e2e phase's pipeline and the large phase's
    inpaint ControlNet (--serve-inpaint), on 127.0.0.1, driven over HTTP by
    client threads: a burst of 4 compatible 1024^2 requests (one batch), the
    same 4 with max_batch 1, one 1536^2 request (K3), two requests whose
    signatures differ and two 1280x960 inpaint requests. The worker's
    conditions come from the fixtures (no font on the card)."""
    import dataclasses
    import http.client
    import threading

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.serving import GenerationServer, _pad_rows, _png_b64
    from reptext_tpu_torch.utils.metrics import Metrics

    data, size, font_size, reqs = load_requests()
    large = np.load(LARGE_FIXTURE)
    table, sources = {}, set()
    for name, text, pos in reqs:
        table[(text, size, size)], src = conditions_for(data, name, text, pos, size, font_size)
        sources.add(src)
    lines = {}
    for name in ("txt2img_1536", "inpaint_1280x960"):
        text = str(large[f"{name}.text"])
        pos = tuple(int(v) for v in large[f"{name}.position"])
        w, h = (int(v) for v in large[f"{name}.size"])
        table[(text, w, h)], src = conditions_for(large, name, text, pos, (w, h),
                                                  int(large["font_size"]), LARGE_FIXTURE)
        lines[name] = (text, pos, w, h)
        sources.add(src)

    def conditions(req, width, height):
        return table[(req.lines[0]["text"], width, height)]

    text, pos, w_inp, h_inp = lines["inpaint_1280x960"]
    inp_serve = inp.with_config(dataclasses.replace(inp.pipe_cfg, height=h_inp, width=w_inp))
    server = GenerationServer(pipe, host="127.0.0.1", port=0, max_batch=4,
                              batch_window_s=BATCH_WINDOW_S, inpaint_pipeline=inp_serve,
                              metrics=Metrics(), request_timeout_s=600)
    server.worker.conditions = conditions
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.address[:2]

    def http_call(method, path, payload=None):
        conn = http.client.HTTPConnection(host, port, timeout=600)
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"} if payload else {})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        return resp.status, body

    gate = min(cn_steps, steps)
    per_batch = steps * DOUBLE_CALLS + gate * SINGLE_CALLS
    per_inpaint_batch = steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS
    zero = {"K1": 0, "K2": 0, "K3": 0, "K5": 0}
    batch_norms = norm_launches(steps, gate)
    launches, fails = {}, []

    def scenario(label, payloads, max_batch, batches, expect, shape):
        server.worker.max_batch = max_batch
        # one at a time there is nothing to wait for
        server.worker.batch_window_s = BATCH_WINDOW_S if max_batch > 1 else 0.0
        server.worker.metrics = Metrics()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out = [None] * len(payloads)

        def client(i):
            t0 = time.perf_counter()
            status, body = http_call("POST", "/generate", payloads[i])
            out[i] = (status, body, t0, time.perf_counter())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        got = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[f"serve_{label}"] = got
        _, snap = http_call("GET", "/metrics")
        images, ok_png = [], True
        for status, body, _, _ in out:
            if status != 200:
                fails.append(f"{label}: HTTP {status} {body}")
                continue
            is_png, image = png_array(body["image_png_base64"])
            ok_png &= is_png and image.shape == shape and image.dtype == np.uint8
            images.append(image)
        lat = sorted(o[3] - o[2] for o in out)
        wall = max(o[3] for o in out) - min(o[2] for o in out)
        counted = snap["counters"].get("serving.batches", 0)
        sizes = snap["timings"].get("serving.batch_size", {})
        ok = (ok_png and len(images) == len(payloads) and counted == batches
              and got == expect and sizes.get("max_s") == len(payloads) / batches)
        phase("serve", f"{label}: {len(payloads)} request(s), max_batch {max_batch}: {wall:.3f} s "
                       f"from first submit to last answer, {len(payloads) / wall:.3f} images/s; "
                       f"latency p50 {np.percentile(lat, 50):.3f} s, p95 "
                       f"{np.percentile(lat, 95):.3f} s; /metrics: {counted} batch(es) (expected "
                       f"{batches}), batch size max {sizes.get('max_s')}; launches "
                       + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                       + f"; PNG {shape} uint8 {ok_png}; peak device memory {peak:.2f} GiB -> "
                       + ("ok" if ok else "FAIL"))
        if not ok:
            fails.append(label)
        return images

    def payload(i, name_text_pos, **extra):
        name, text, pos = name_text_pos
        return dict({"prompt": cli.build_prompt(f"a street sign in city {i}", [text],
                                                cli.PROMPT_SUFFIX),
                     "lines": [{"text": text, "position": list(pos), "font_size": font_size}],
                     "seed": seed + i}, **extra)

    try:
        burst = [payload(i, reqs[i % 2]) for i in range(4)]
        square = (size, size, 3)
        one = dict(zero, K1=per_batch, **batch_norms)
        batched = scenario("burst", burst, 4, 1, one, square)
        alone = scenario("one_at_a_time", burst, 1, 4, scaled(one, 4), square)

        # the same requests called directly: the batch's latents against each
        # request's alone (bf16, SERVE_RTOL), and each served PNG against the
        # decode of the direct call's latents (the same computation: the batch's
        # four latents decoded in one call, as the worker decodes them)
        worker = server.worker
        conds = [conditions(types.SimpleNamespace(lines=p["lines"]), size, size) for p in burst]
        ids = [worker._tokenize(p["prompt"]) for p in burst]
        seeds = [p["seed"] for p in burst]
        stages_b, stages_1 = {}, {}
        lat_b = pipe.generate_batch(conds, clip_ids=_pad_rows([c[0] for c, _ in ids]),
                                    t5_ids=_pad_rows([t[0] for _, t in ids]), seeds=seeds,
                                    output_type="latent", timings=stages_b)
        t0 = time.perf_counter()
        rel, decoded = [], [pipe.decode(lat_b)]
        torch.cuda.synchronize()
        stages_b["decode"] = time.perf_counter() - t0
        for i in range(4):
            lat_1 = pipe(conds[i], clip_ids=ids[i][0], t5_ids=ids[i][1], seed=seeds[i],
                         output_type="latent", timings=stages_1)
            rel.append(((lat_b[i] - lat_1[0]).abs().max() / lat_1.abs().max()).item())
            t0 = time.perf_counter()
            decoded.append(pipe.decode(lat_1))
            torch.cuda.synchronize()
            stages_1["decode"] = time.perf_counter() - t0
        served_diff = max(int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in
                          zip([*decoded[0], *(d[0] for d in decoded[1:])], batched + alone))
        pix = np.abs(np.stack(batched).astype(int) - np.stack(alone).astype(int))
        ok = (max(rel) <= SERVE_RTOL and served_diff == 0 and pix.max() <= SERVE_PNG_MAX
              and pix.mean() <= SERVE_PNG_MEAN)
        phase("serve", f"burst vs one at a time: latents max_abs/max|alone| per request "
                       + ", ".join(f"{r:.3e}" for r in rel) + f" (tol {SERVE_RTOL}); served PNGs "
                       f"against the decode of the same call's latents: max {served_diff} "
                       f"level(s) (must be 0); burst vs alone PNGs: max {pix.max()} levels (tol "
                       f"{SERVE_PNG_MAX}), mean {pix.mean():.3f} (tol {SERVE_PNG_MEAN}) -> "
                       f"{'ok' if ok else 'FAIL'}; called directly, the batch of 4 takes "
                       + stage_seconds(stages_b)
                       + f" (sampler {1e3 * stages_b['sample'] / steps:.1f} ms/step), one "
                       f"request alone (the last) "
                       + stage_seconds(stages_1)
                       + f" (sampler {1e3 * stages_1['sample'] / steps:.1f} ms/step)")
        if not ok:
            fails.append("burst vs one at a time")

        text, pos, w, h = lines["txt2img_1536"]
        scenario("1536", [payload(0, ("txt2img_1536", text, pos), width=w, height=h)], 4, 1,
                 dict(zero, K3=per_batch, **copied(batch_norms)), (h, w, 3))
        scenario("mismatched", [payload(0, reqs[0]), payload(1, reqs[1], guidance_scale=4.0)],
                 4, 2, scaled(one, 2), square)
        text, pos, w, h = lines["inpaint_1280x960"]
        cond = table[(text, w, h)]
        image, mask = source_image(seed, h, w), box_mask(cond)
        inpaint = [payload(i, ("inpaint_1280x960", text, pos), mode="inpaint",
                           image_png_base64=_png_b64(image), mask_png_base64=_png_b64(mask))
                   for i in range(2)]
        scenario("inpaint", inpaint, 4, 1,
                 dict(zero, K1=per_inpaint_batch, **norm_launches(steps, steps + gate)), (h, w, 3))
        phase("serve", f"launches per batch of B requests with N lines: K1 (K3 past 6144 joint "
                       f"tokens) = steps x 57 + ControlNet steps x 14 = {per_batch} whatever B and "
                       f"N (every block is one attention call over the batch's rows, the "
                       f"ControlNet's over N x B rows); inpainting steps x (57 + 14) + ControlNet "
                       f"steps x 14 = {per_inpaint_batch} (its rows: 2B); batch window "
                       f"{BATCH_WINDOW_S} s; conditions: {', '.join(sorted(sources))}")
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if fails or thread.is_alive():
        raise SystemExit(f"the serve phase failed its checks: {fails}")
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

    base_before = param_checksums(pipe.flux)
    per_step, fails = [], []
    clock = {"t": None}

    def on_event(kind, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if kind == "step":
            per_step.append((info["step"], info["loss"], now - clock["t"], read_train_launches()))
            reset_train_launches()
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

    reset_train_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = cli.train(args, pipe, dataset=dataset, on_event=on_event)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for step, loss, sec, counts in per_step:
        phase("train", f"step {step}: loss {loss:.6f}, {sec:.3f} s ({'cold' if step == 1 else 'warm'}"
                       f"), launches {train_launch_text(counts)}")
        if not (np.isfinite(loss) and counts == TRAIN_EXPECT):
            fails.append(f"step {step}")
    same = param_checksums(pipe.flux) == base_before
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
    return {key: sum(s[3][key] for s in per_step) for key in TRAIN_EXPECT}



def train_launches():
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops import gelu, norms

    return {"K1": fa.flash_attention_rope, "K2": fa.flash_attention,
            "K3": fa.flash_attention_streaming, "K4": fa.flash_attention_backward,
            "modulate": norms.modulate, "rms_norm": norms.rms_norm,
            "gelu": gelu.gelu_tanh_into}


def reset_train_launches():
    check_attention_backend()
    for entry in train_launches().values():
        entry.launches = 0


def read_train_launches():
    return {key: entry.launches for key, entry in train_launches().items()}


def train_launch_text(counts, expect=TRAIN_EXPECT):
    return ", ".join(f"{k} {counts[k]} (expected {expect[k]})" for k in expect)


def param_checksums(module):
    """Per parameter, the sum and sum of squares of its bits read as int16."""
    sums = []
    for p in module.parameters():
        bits = p.detach().contiguous().view(torch.int16).long()
        sums.append(torch.stack([bits.sum(), (bits * bits).sum()]))
    return torch.stack(sums).tolist()


def glyph_crops(data, reqs, margin=8):
    """The fixture's glyph canvases cut to their ink (a margin of ``margin``)."""
    from reptext_tpu_torch.sampling.ocr_loss import glyph_ink_bbox

    crops = []
    for name, _, _ in reqs:
        canvas = data[f"{name}.glyph_canvas"]
        y0, x0, y1, x1 = glyph_ink_bbox(canvas)
        crops.append(canvas[max(y0 - margin, 0):y1 + margin, max(x0 - margin, 0):x1 + margin])
    return crops


def ocr_phase(dev):
    """The OCR judge on the card against the CPU on the fixture's two glyph
    crops (TF32 convolutions, as the card runs them, and with TF32 off for
    the contrast); char_accuracy of the crops on both."""
    from reptext_tpu_torch.eval import ocr

    data, _, _, reqs = load_requests()
    crops = glyph_crops(data, reqs)
    texts = [text for _, text, _ in reqs]
    judge, judge_cpu = ocr.load_judge(device=dev), ocr.load_judge(device="cpu")
    x = np.stack([ocr.prepare_crop(c) for c in crops])
    x = np.concatenate([x, -x])   # both polarities, as char_accuracy reads them
    with torch.no_grad():
        want = judge_cpu(ocr.to_nchw(x)).numpy()
        got = judge(ocr.to_nchw(x, dev)).float().cpu().numpy()
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got_fp32 = judge(ocr.to_nchw(x, dev)).float().cpu().numpy()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    scale = float(np.abs(want).max())
    err, err_fp32 = float(np.abs(got - want).max()), float(np.abs(got_fp32 - want).max())
    same_text = ocr.decode_logits(got) == ocr.decode_logits(want)
    acc = ocr.char_accuracy(crops, texts, judge)
    acc_cpu = ocr.char_accuracy(crops, texts, judge_cpu)
    phase("ocr", f"judge logits [{x.shape[0]}, {ocr.FRAMES}, {len(ocr.CHARSET) + 1}] on the "
                 f"fixture's glyph crops {[c.shape[:2] for c in crops]} (both polarities): "
                 f"card (cuDNN TF32 {tf32}) vs CPU max_abs {err:.3e}, with TF32 off "
                 f"{err_fp32:.3e}; limit {JUDGE_RTOL * scale:.3e} ({JUDGE_RTOL:.3g} of "
                 f"max|CPU| {scale:.2f}); greedy decode equal {same_text} "
                 f"({ocr.decode_logits(got)[:2]}); char_accuracy card {acc:.4f}, CPU {acc_cpu:.4f}")
    if not (err <= JUDGE_RTOL * scale and same_text):
        raise SystemExit("the OCR judge on the card failed its checks")


def fixture_dataset(pipe, seed, batch_size=2):
    """A training dataset whose samples are the fixture's two requests: the
    card's machine has no font, so the conditions are the fixture's arrays
    and each sample's text (its OCR label and its prompt's quote) is the text
    those arrays render."""
    from reptext_tpu_torch.data import GlyphTextDataset

    data, size, font_size, reqs = load_requests()
    conds = [conditions_for(data, name, text, pos, size, font_size)[0]
             for name, text, pos in reqs]
    ds = GlyphTextDataset(pipe, batch_size=batch_size, seed=seed)
    real_spec = ds.sample_spec

    def sample_spec(step, index):
        spec = dict(real_spec(step, index))
        _, text, _ = reqs[(step + index) % len(reqs)]
        spec["prompt"] = spec["prompt"].replace(spec["text"], text)
        spec["text"] = text
        return spec

    ds.sample_spec = sample_spec
    ds.conditions = lambda spec, step, index: conds[(step + index) % len(conds)]
    return ds


def train_ocr_phase(dev, pipe, seed, profile=False):
    """The CLI's train path with the OCR term (--ocr-loss-weight 0.3) on the
    full-geometry pipeline, 3 steps at batch 2, after a probe of one OCR step
    with the plain (not recomputed) decode and the term's effect on one fixed
    batch; with ``profile``, a device profile of one more OCR step."""
    import gc

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.eval import ocr
    from reptext_tpu_torch.sampling import train_controlnet as ttrain

    _, size, _, _ = load_requests()
    args = cli.build_parser().parse_args(
        ["--mode", "train", "--random-weights", "--size", str(size), "--train-steps", "3",
         "--batch-size", "2", "--seed", str(seed), "--ocr-loss-weight", str(OCR_WEIGHT)])
    pipe.flux.remat = pipe.controlnet.remat = True
    pipe.controlnet.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    dataset = fixture_dataset(pipe, args.seed)
    judge = ocr.load_judge(device=dev)
    perceptual = {"decode": pipe.decode_images, "judge": judge, "weight": OCR_WEIGHT}
    terms = []
    real_term = ttrain.perceptual_term

    def recorded_term(*a, **kw):
        term = real_term(*a, **kw)
        terms.append(term.detach())
        return term

    ttrain.perceptual_term = recorded_term
    try:
        batch = dataset.batch(0)
        g = torch.Generator(device=dev).manual_seed(seed)
        t = torch.sigmoid(torch.randn((2,), generator=g, device=dev))
        noise = torch.randn(batch["x0"].shape, generator=g, device=dev)
        heads = [layer.proj.weight for layer in
                 list(pipe.controlnet.double_blocks) + list(pipe.controlnet.single_blocks)]

        def loss_and_heads(weight, remat=True):
            pipe.vae.decoder.remat = remat
            pipe.controlnet.zero_grad(set_to_none=True)
            loss = ttrain.controlnet_flow_match_loss(
                pipe.flux, pipe.controlnet, batch, t=t, noise=noise,
                perceptual=dict(perceptual, weight=weight))
            loss.backward()
            return float(loss.detach()), [h.grad.float().clone() for h in heads]

        # the plain decode keeps every decoder block's activations: measured, not trained
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            loss_and_heads(OCR_WEIGHT, remat=False)
            torch.cuda.synchronize()
            probe = (f"finished in {time.perf_counter() - t0:.3f} s, peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        except torch.OutOfMemoryError as e:
            probe = f"out of memory ({str(e).splitlines()[0][:160]})"
        pipe.vae.decoder.remat = True
        pipe.controlnet.zero_grad(set_to_none=True)
        terms.clear()
        gc.collect()
        torch.cuda.empty_cache()
        phase("train_ocr", f"one OCR loss + backward at batch 2 with the plain decode "
                           f"(decoder blocks not recomputed): {probe}")

        loss_0, g0 = loss_and_heads(0.0)
        loss_w, gw = loss_and_heads(OCR_WEIGHT)
        term = float(terms[-1])
        diff = float(torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(gw, g0))))
        norm = float(torch.sqrt(sum((b ** 2).sum() for b in g0)))
        effect_ok = (len(terms) == 1 and np.isfinite(term) and term > 0
                     and abs((loss_w - loss_0) - OCR_WEIGHT * term)
                     <= OCR_EFFECT_RTOL * abs(loss_w) and diff > 0)
        phase("train_ocr", f"one fixed batch and draw (t {[round(v, 4) for v in t.tolist()]}): "
                           f"loss at weight 0 {loss_0:.6f}, at {OCR_WEIGHT} {loss_w:.6f}; "
                           f"difference {loss_w - loss_0:.6f} against {OCR_WEIGHT} x the OCR "
                           f"term {term:.6f} = {OCR_WEIGHT * term:.6f} (limit "
                           f"{OCR_EFFECT_RTOL:.0e} of the loss); the 14 heads' gradients "
                           f"differ by {diff:.4e} (norm at weight 0 {norm:.4e})")
        pipe.controlnet.zero_grad(set_to_none=True)
        del batch, g0, gw
        terms.clear()
        gc.collect()
        torch.cuda.empty_cache()
        if not effect_ok:
            raise SystemExit("the OCR term's effect on the loss failed its checks")

        # the OCR step's loss and backward twice on one batch and draw, through
        # the train step's own loss_and_backward: losses and every ControlNet
        # gradient must be bit-equal (the CTC and the crop are fixed-order
        # sums, the convolutions run deterministic cuDNN algorithms)
        def ocr_grads():
            pipe.controlnet.zero_grad(set_to_none=True)
            loss = ttrain.loss_and_backward(pipe.flux, pipe.controlnet, batch, t=t, noise=noise,
                                            perceptual=perceptual)
            return loss, [p.grad.clone() for p in pipe.controlnet.parameters()]

        batch = dataset.batch(0)
        cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        (l1, g1), (l2, g2) = ocr_grads(), ocr_grads()
        differ = sum(not torch.equal(a, b) for a, b in zip(g1, g2))
        repeats = bool(torch.equal(l1, l2)) and differ == 0 and len(g1) == OCR_GRADS
        restored = cudnn_flags == (torch.backends.cudnn.deterministic,
                                   torch.backends.cudnn.benchmark)
        del g1, g2
        culprits = [] if repeats else nondeterministic_ops(ocr_grads)
        pipe.controlnet.zero_grad(set_to_none=True)
        phase("train_ocr", f"the OCR step (loss and backward) twice on one batch and draw: loss "
                           f"{float(l1):.9f} / {float(l2):.9f}, ControlNet gradients that differ "
                           f"{differ} of {len(list(pipe.controlnet.parameters()))} (expected "
                           f"{OCR_GRADS}): repeats bit for bit {repeats}; cuDNN flags restored "
                           f"after {restored}" + ("" if repeats else
                           f"; ops with no deterministic implementation in the step: {culprits}"))
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        if not (repeats and restored):
            raise SystemExit("the OCR train step does not repeat bit for bit")

        sums = {name: param_checksums(m) for name, m in
                (("base", pipe.flux), ("VAE", pipe.vae), ("judge", judge))}
        per_step, clock = [], {"t": None}

        def on_event(kind, info):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if kind == "step":
                counts = read_train_launches()
                reset_train_launches()
                per_step.append((info["step"], info["loss"], now - clock["t"], counts,
                                 float(terms[-1]) if terms else float("nan")))
                terms.clear()
            else:
                phase("train_ocr", f"[{kind}] {info} ({now - (clock['t'] or now):.3f} s)")
            clock["t"] = now

        loaded, real_load = [], ocr.load_judge

        def load_judge(*a, **kw):   # the judge the CLI loads, kept to check it after
            loaded.append(real_load(*a, **kw))
            return loaded[-1]

        reset_train_launches()
        torch.cuda.reset_peak_memory_stats()
        ocr.load_judge = load_judge
        try:
            t0 = time.perf_counter()
            trainer = cli.train(args, pipe, dataset=dataset, on_event=on_event)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ocr.load_judge = real_load
        peak = torch.cuda.max_memory_allocated() / 2**30
        fails = []
        for step, loss, sec, counts, term in per_step:
            phase("train_ocr", f"step {step}: loss {loss:.6f}, OCR term {term:.6f} (x "
                               f"{OCR_WEIGHT}: {100 * OCR_WEIGHT * term / loss:.1f} % of the "
                               f"loss), {sec:.3f} s ({'cold' if step == 1 else 'warm'}); "
                               f"launches {train_launch_text(counts)}")
            if not (np.isfinite(loss) and np.isfinite(term) and counts == TRAIN_EXPECT):
                fails.append(f"step {step}")
        same = {name: param_checksums(m) == before for name, m, before in
                (("base", pipe.flux, sums["base"]), ("VAE", pipe.vae, sums["VAE"]),
                 ("judge", loaded[0], sums["judge"]))}
        warm = [sec for step, _, sec, _, _ in per_step if step > 1]
        phase("train_ocr", f"warm s/step {[round(x, 3) for x in warm]} against 2.900-3.171 before "
                           "the deterministic CTC, crop and convolutions (PR 10's runs)")
        phase("train_ocr", f"3 steps at batch {args.batch_size}, {size}^2, OCR weight "
                           f"{OCR_WEIGHT}, decoder blocks recomputed: {wall:.3f} s in all "
                           f"(restore points included); faults {len(trainer.faults)}; "
                           f"bit-identical {same}; peak device memory {peak:.2f} GiB")
        if len(per_step) != 3 or trainer.faults or not all(same.values()) or fails:
            raise SystemExit(f"the OCR training run failed its checks: {fails}")
        if profile:
            from reptext_tpu_torch.ops import flash_attention as fa

            step = ttrain.bind_frozen_base(ttrain.make_controlnet_train_step(
                pipe.controlnet, trainer.state["optimizer"], args.text_loss_weight,
                perceptual=perceptual), pipe.flux, pipe.vae, judge)
            batch = dataset.batch(len(per_step))

            def run():
                step(batch, torch.Generator(device=dev).manual_seed(seed))
                torch.cuda.synchronize()

            device_profile(f"one OCR train step at batch {args.batch_size} (its batch built "
                           "before)", run, {fa.flash_attention_rope: TRAIN_K1,
                                            fa.flash_attention_backward: TRAIN_K4,
                                            fa.flash_attention: 0})
    finally:
        ttrain.perceptual_term = real_term
    return {key: sum(s[3][key] for s in per_step) for key in TRAIN_EXPECT}



def write_corpus(root, reqs, seed):
    """CORPUS_SIZES seeded numpy photos as PNGs and annotations.jsonl: the
    fixture's texts at its position and font size, rescaled to each photo's
    pixels; the last record has both lines."""
    from PIL import Image

    _, size, font_size, _ = load_requests()
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "annotations.jsonl"), "w", encoding="utf-8") as f:
        for i, (h, w) in enumerate(CORPUS_SIZES):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, "imgs", f"{i}.png"))
            picks = range(len(reqs)) if i == len(CORPUS_SIZES) - 1 else [i % len(reqs)]
            lines = [{"text": reqs[k][1], "font_size": font_size * h / size,
                      "position": [reqs[k][2][0] * w / size, reqs[k][2][1] * h / size]}
                     for k in picks]
            f.write(json.dumps({"image": f"imgs/{i}.png", "prompt": "a photo of a street sign",
                                "lines": lines}, ensure_ascii=False) + "\n")


def train_corpus_phase(dev, pipe, seed):
    """The CLI's train path on a photo corpus (--corpus-dir) with the OCR
    term: 2 steps at batch 2; the sample specs it used against a dataset over
    the same corpus on the CPU."""
    import gc
    import shutil

    from reptext_tpu_torch import cli
    from reptext_tpu_torch import data_disk

    data, size, font_size, reqs = load_requests()
    conds = {text: conditions_for(data, name, text, pos, size, font_size)[0]
             for name, text, pos in reqs}
    root = os.path.join(ROOT, SCRATCH, "corpus")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_corpus(root, reqs, seed)
    written = time.perf_counter() - t0
    args = cli.build_parser().parse_args(
        ["--mode", "train", "--random-weights", "--size", str(size), "--train-steps", "2",
         "--batch-size", "2", "--seed", str(seed), "--ocr-loss-weight", str(OCR_WEIGHT),
         "--corpus-dir", root])
    cls = data_disk.DiskImageTextDataset
    real_spec, specs, per_step, clock = cls.sample_spec, {}, [], {"t": None}

    def sample_spec(self, step, index):
        specs[(step, index)] = real_spec(self, step, index)
        return specs[(step, index)]

    def on_event(kind, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if kind == "step":
            per_step.append((info["step"], info["loss"], now - clock["t"], read_train_launches()))
            reset_train_launches()
        clock["t"] = now

    pipe.controlnet.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    reset_train_launches()
    torch.cuda.reset_peak_memory_stats()
    # no font on the card's machine: each line's conditions are the fixture's arrays of its text
    cls.sample_spec = sample_spec
    cls.conditions = lambda self, spec, step, index: conds[spec["text"]]
    try:
        t0 = time.perf_counter()
        trainer = cli.train(args, pipe, on_event=on_event)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = cls(types.SimpleNamespace(pipe_cfg=pipe.pipe_cfg), root, batch_size=2,
                  seed=args.seed, tokenize=lambda prompt: (None, None))
        same = all(cpu.sample_spec(*key) == spec for key, spec in specs.items())
    finally:
        cls.sample_spec = real_spec
        del cls.conditions
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fails = []
    for step, loss, sec, counts in per_step:
        phase("train_corpus", f"step {step}: loss {loss:.6f}, {sec:.3f} s; launches "
                              f"{train_launch_text(counts)}")
        if not (np.isfinite(loss) and counts == TRAIN_EXPECT):
            fails.append(f"step {step}")
    used = sorted({os.path.basename(s["image_path"]) for s in specs.values()})
    phase("train_corpus", f"a corpus of {len(CORPUS_SIZES)} seeded PNGs {CORPUS_SIZES} "
                          f"(written in {written:.2f} s), 2 steps at batch 2 with OCR weight "
                          f"{OCR_WEIGHT}: {wall:.3f} s in all; photos used {used}; "
                          f"{len(specs)} sample specs, equal to a CPU dataset's {same}; "
                          f"faults {len(trainer.faults)}; peak device memory {peak:.2f} GiB")
    if len(per_step) != 2 or trainer.faults or not same or fails:
        raise SystemExit(f"the corpus training run failed its checks: {fails}")
    return {key: sum(s[3][key] for s in per_step) for key in TRAIN_EXPECT}


def cut_train_phase(dev, pipe, seed, joint):
    """Joint (base + ControlNet, one AdamW) or base-only training at full width,
    depth cut to CUT_FLUX / CUT_CN (the whole 12B base with its gradients and
    moments does not fit one card), 2 steps at batch 2 through
    make_joint_train_step / make_train_step on the fixture's batches."""
    import dataclasses
    import gc

    from reptext_tpu_torch.models.controlnet import params_from_transformer
    from reptext_tpu_torch.pipelines.txt2img import MODULES, FluxRepTextPipeline, build_module
    from reptext_tpu_torch.sampling.elastic import step_generator
    from reptext_tpu_torch.sampling.train_controlnet import decay_param_groups, make_joint_train_step
    from reptext_tpu_torch.sampling.training import make_train_step

    label = "train_joint" if joint else "train_base"
    flux_cfg = dataclasses.replace(pipe.flux.config, num_layers=CUT_FLUX[0],
                                   num_single_layers=CUT_FLUX[1])
    cn_cfg = dataclasses.replace(pipe.controlnet.config, num_layers=CUT_CN[0],
                                 num_single_layers=CUT_CN[1])
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    flux = build_module(MODULES["flux"], flux_cfg, dev, pipe.compute_dtype, None, gen, remat=True)
    cn = (build_module(MODULES["controlnet"], cn_cfg, dev, pipe.compute_dtype, None, gen,
                       remat=True) if joint else None)
    cut = FluxRepTextPipeline(flux, cn if joint else pipe.controlnet, pipe.vae, pipe.pipe_cfg,
                              clip=pipe.clip, t5=pipe.t5, compute_dtype=pipe.compute_dtype)
    dataset = fixture_dataset(cut, seed)
    flux.requires_grad_(True)
    groups = decay_param_groups(flux, 0.01)
    if joint:
        params_from_transformer(flux, cn, *CUT_CN)
        cn.requires_grad_(True)
        groups += decay_param_groups(cn, 0.01)
    opt = torch.optim.AdamW(groups, lr=1e-5, betas=(0.9, 0.999), eps=1e-8)
    step = make_joint_train_step(flux, cn, opt) if joint else make_train_step(flux, opt)
    n_params = sum(p.numel() for g in groups for p in g["params"])
    fwd = sum(CUT_FLUX) + (sum(CUT_CN) if joint else 0)
    expect = {"K1": 2 * fwd, "K2": 0, "K3": 0, "K4": fwd,
              **train_norm_launches(CUT_FLUX, CUT_CN if joint else None, base_trained=True)}
    before = param_checksums(flux)
    torch.cuda.reset_peak_memory_stats()
    totals, fails = {key: 0 for key in expect}, []
    for s in range(2):
        batch = dataset.batch(s)
        torch.cuda.synchronize()
        reset_train_launches()
        t0 = time.perf_counter()
        loss = float(step(batch, step_generator(seed, s, dev)))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_train_launches()
        totals = {key: totals[key] + counts[key] for key in totals}
        grads = [p.grad for p in flux.parameters()]
        got_grad = sum(g is not None and bool(torch.isfinite(g).all()) and bool(g.any())
                       for g in grads)
        phase(label, f"step {s + 1}: loss {loss:.6f}, {sec:.3f} s ({'cold' if s == 0 else 'warm'})"
                     f"; launches {train_launch_text(counts, expect)}; base "
                     f"tensors with a finite nonzero gradient {got_grad} of {len(grads)}")
        if not (np.isfinite(loss) and counts == expect and got_grad > 0):
            fails.append(f"step {s + 1}")
    after = param_checksums(flux)
    changed = sum(a != b for a, b in zip(after, before))
    phase(label, f"FLUX {CUT_FLUX[0]} + {CUT_FLUX[1]}"
                 + (f", ControlNet {CUT_CN[0]} + {CUT_CN[1]}" if joint else "")
                 + f" at full width (depth cut: the 12B base, its gradients and AdamW "
                 f"moments do not fit one card), bf16, AdamW lr 1e-5 over {n_params / 1e9:.3f}B "
                 f"parameters, batch 2, {pipe.pipe_cfg.height}^2, remat: base tensors changed "
                 f"by the 2 steps {changed} of {len(after)}; peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del cut, dataset, flux, cn, opt, step, groups
    gc.collect()
    torch.cuda.empty_cache()
    if fails or changed == 0:
        raise SystemExit(f"the {label} run failed its checks: {fails}")
    return totals


def train_repeat_phase(dev, pipe, seed):
    """The cut-depth joint train step (train_joint's: FLUX CUT_FLUX, ControlNet
    CUT_CN, full width) 3 steps from one seed, twice, then a third time with
    a NaN planted in step 2's batch and rolled back by the ElasticTrainer:
    the losses, the ControlNet's state_dict and the base's must be bit-equal
    across the three runs (the JAX step repeats bit for bit; K4's dq adds in
    key order make the port's do)."""
    import dataclasses

    from reptext_tpu_torch.models.controlnet import params_from_transformer
    from reptext_tpu_torch.pipelines.txt2img import MODULES, FluxRepTextPipeline, build_module
    from reptext_tpu_torch.sampling.elastic import ElasticTrainer
    from reptext_tpu_torch.sampling.train_controlnet import decay_param_groups, make_joint_train_step

    flux_cfg = dataclasses.replace(pipe.flux.config, num_layers=CUT_FLUX[0],
                                   num_single_layers=CUT_FLUX[1])
    cn_cfg = dataclasses.replace(pipe.controlnet.config, num_layers=CUT_CN[0],
                                 num_single_layers=CUT_CN[1])

    def run(plant):
        gen = torch.Generator(device=dev).manual_seed(seed + 11)
        flux = build_module(MODULES["flux"], flux_cfg, dev, pipe.compute_dtype, None, gen,
                            remat=True)
        cn = build_module(MODULES["controlnet"], cn_cfg, dev, pipe.compute_dtype, None, gen,
                          remat=True)
        cut = FluxRepTextPipeline(flux, cn, pipe.vae, pipe.pipe_cfg, clip=pipe.clip, t5=pipe.t5,
                                  compute_dtype=pipe.compute_dtype)
        dataset = fixture_dataset(cut, seed)
        params_from_transformer(flux, cn, *CUT_CN)
        flux.requires_grad_(True)
        cn.requires_grad_(True)
        opt = torch.optim.AdamW(decay_param_groups(flux, 0.01) + decay_param_groups(cn, 0.01),
                                lr=1e-5, betas=(0.9, 0.999), eps=1e-8)
        planted = {"done": not plant}

        def batch_fn(step):
            batch = dataset.batch(step)
            if step == 1 and not planted["done"]:
                planted["done"] = True
                batch = dict(batch, x0=batch["x0"] * float("nan"))
            return batch

        trainer = ElasticTrainer(make_joint_train_step(flux, cn, opt), batch_fn,
                                 {"flux": flux, "controlnet": cn, "optimizer": opt},
                                 device=dev, checkpoint_every=3)
        t0 = time.perf_counter()
        losses = list(trainer.run(3, seed=seed))
        torch.cuda.synchronize()
        out = (losses, {k: v.clone() for k, v in cn.state_dict().items()},
               param_checksums(flux), len(trainer.faults), time.perf_counter() - t0)
        del cut, dataset, flux, cn, opt, trainer
        gc.collect()
        torch.cuda.empty_cache()
        return out

    runs = [run(False), run(False), run(True)]
    ref = runs[0]
    checks = []
    for i, (losses, cn_state, flux_sums, faults, sec) in enumerate(runs):
        same = (losses == ref[0] and flux_sums == ref[2]
                and all(torch.equal(cn_state[k], ref[1][k]) for k in ref[1]))
        checks.append(same and faults == (1 if i == 2 else 0) and all(np.isfinite(losses)))
        phase("train_repeat", f"run {i + 1}{' (NaN planted in step 2, rolled back)' if i == 2 else ''}"
                              f": losses {[float(x) for x in losses]} ({sec:.3f} s), faults "
                              f"{faults}; losses, the ControlNet's {len(cn_state)} tensors and the "
                              f"base's {len(flux_sums)} bit-equal to run 1: {same}")
    del runs, ref
    if not all(checks):
        raise SystemExit("the cut-depth train step does not repeat bit for bit")


def nondeterministic_ops(fn):
    """The ops with no deterministic implementation that ``fn()`` runs, by
    name: the warnings of torch.use_deterministic_algorithms(warn_only=True)."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was)
    names = []
    for w in caught:
        msg = str(w.message).split(" does not have a deterministic")[0]
        if "deterministic" in str(w.message) and msg not in names:
            names.append(msg)
    return names


def union_phase(dev, pipe, inp, steps, cn_steps, seed):
    """A seeded union ControlNet (UNION_MODES modes, RepText geometry) at mode
    UNION_MODE: a 1024^2 txt2img request beside the plain one (plain, union,
    union, plain), and a 1280x960 inpaint request with it in the RepText
    slot. Returns (launches by path, the union ControlNet)."""
    import dataclasses

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.pipelines.txt2img import MODULES, build_module

    cfg = dataclasses.replace(pipe.controlnet.config, num_mode=UNION_MODES)
    t0 = time.perf_counter()
    union = build_module(MODULES["controlnet"], cfg, dev, pipe.compute_dtype, None,
                         torch.Generator(device=dev).manual_seed(seed + 21))
    torch.cuda.synchronize()
    phase("union", f"union ControlNet built in {time.perf_counter() - t0:.1f} s: "
                   f"{cfg.num_layers} + {cfg.num_single_layers} blocks, {UNION_MODES} modes, "
                   f"{sum(p.numel() for p in union.parameters()) / 1e9:.2f}B parameters, seeded")
    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    base = ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
            str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
            str(font_size), "--random-weights"]
    args = cli.build_parser().parse_args(base)
    uargs = cli.build_parser().parse_args(base + ["--controlnet-mode", str(UNION_MODE)])
    cond, source = conditions_for(data, name, text, pos, size, font_size)
    upipe = pipe.with_config(cli.pipeline_config(uargs))
    upipe.controlnet = union
    gate = min(cn_steps, steps)
    expect = {"K1": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
              **norm_launches(steps, gate)}
    launches, ms = {}, {"plain": [], "union": []}
    for label in ("plain", "union", "union", "plain"):
        p, a = (pipe, args) if label == "plain" else (upipe, uargs)
        out = {}
        got = run_request(
            f"txt2img {size}^2 {label}" + (f" (mode {UNION_MODE}, the ControlNet's S = 4609)"
                                           if label == "union" else " (S = 4608)"),
            lambda timings: cli.generate(a, p, cond, timings=timings, output_type="latent"),
            p, expect, (1, size, size, 3), steps, tag="union", out=out)
        ms[label].append(out["ms_step"])
        if label == "union":
            launches["union_txt2img"] = got
    phase("union", f"sampler ms/step, union {ms['union']} against plain {ms['plain']} in this "
                   f"call (one more ControlNet token out of 4608)")

    large = np.load(LARGE_FIXTURE)
    name = "inpaint_1280x960"
    text, pos = str(large[f"{name}.text"]), tuple(int(v) for v in large[f"{name}.position"])
    width, height = (int(v) for v in large[f"{name}.size"])
    iargs = cli.build_parser().parse_args(
        ["--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE), "--text", text,
         "--position", *map(str, pos), "--size", str(width), "--steps", str(steps),
         "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
         str(int(large["font_size"])), "--random-weights", "--controlnet-mode", str(UNION_MODE)])
    icond, isource = conditions_for(large, name, text, pos, (width, height),
                                    int(large["font_size"]), LARGE_FIXTURE)
    uinp = inp.with_config(cli.pipeline_config(iargs, height, width))
    uinp.controlnet = union
    image, mask = source_image(seed, height, width), box_mask(icond)
    expect = {"K1": steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS, "K2": 0, "K3": 0,
              "K5": 0, **norm_launches(steps, steps + gate)}
    launches["union_inpaint"] = run_request(
        f"inpaint {width}x{height} with the union net in the RepText slot (mode {UNION_MODE}, "
        f"CFG batch 2, conditions: {isource})",
        lambda timings: cli.generate_inpaint(iargs, uinp, icond, image, mask, timings=timings,
                                             output_type="latent"),
        uinp, expect, (1, height, width, 3), steps, tag="union")
    return launches, union


def union_train_phase(dev, pipe, union, seed):
    """2 full-width train steps of cli.train --controlnet-mode UNION_MODE on
    the union ControlNet (warm-started from the base, as the CLI does), batch
    2 at 1024^2, remat: K1 TRAIN_K1 and K4 TRAIN_K4 a step, the mode
    embedding's gradient in row UNION_MODE alone."""
    from reptext_tpu_torch import cli

    _, size, _, _ = load_requests()
    args = cli.build_parser().parse_args(
        ["--mode", "train", "--random-weights", "--size", str(size), "--train-steps", "2",
         "--batch-size", "2", "--seed", str(seed), "--controlnet-mode", str(UNION_MODE)])
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    pipe.flux.remat = union.remat = True
    upipe = pipe.with_config(cli.pipeline_config(args))
    upipe.controlnet = union
    dataset = fixture_dataset(upipe, seed)
    per_step, clock = [], {"t": None}

    def on_event(kind, info):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if kind == "step":
            per_step.append((info["step"], info["loss"], now - clock["t"], read_train_launches()))
            reset_train_launches()
        clock["t"] = now

    reset_train_launches()
    torch.cuda.reset_peak_memory_stats()
    trainer = cli.train(args, upipe, dataset=dataset, on_event=on_event)
    peak = torch.cuda.max_memory_allocated() / 2**30
    grad = union.controlnet_mode_embedder.weight.grad
    rows = [] if grad is None else [i for i in range(UNION_MODES) if bool(grad[i].any())]
    fails = []
    for step, loss, sec, counts in per_step:
        phase("union_train", f"step {step}: loss {loss:.6f}, {sec:.3f} s; launches "
                             f"{train_launch_text(counts)}")
        if not (np.isfinite(loss) and counts == TRAIN_EXPECT):
            fails.append(f"step {step}")
    phase("union_train", f"2 steps at batch 2, {size}^2, mode {UNION_MODE}: faults "
                         f"{len(trainer.faults)}; mode-embedding rows with a gradient {rows} "
                         f"(expected [{UNION_MODE}]); peak device memory {peak:.2f} GiB "
                         f"({resident:.2f} GiB resident before the run: the pipeline, both "
                         f"ControlNets)")
    union.requires_grad_(False).zero_grad(set_to_none=True)
    union.remat = False
    if len(per_step) != 2 or trainer.faults or rows != [UNION_MODE] or fails:
        raise SystemExit(f"the union training run failed its checks: {fails}")
    return {key: sum(s[3][key] for s in per_step) for key in TRAIN_EXPECT}


@torch.inference_mode()
def multi_phase(dev, pipe, union, seed):
    """MultiControlNet([RepText, union]) on one step's full-width inputs, a
    region mask on the RepText net and a guidance window (0.5, 1.0) on the
    union net, at a step outside the window and one inside: bit-equal to the
    sum of each net's own masked, gated residuals spread to the base depth."""
    from reptext_tpu_torch.models.multi_controlnet import (
        ControlNetEntry, MultiControlNet, spread_residuals,
    )
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids

    g = torch.Generator(device=dev).manual_seed(seed + 31)
    cfg, dt = pipe.controlnet.config, pipe.compute_dtype

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    x = rnd(1, 4096, cfg.in_channels)
    cond = rnd(1, 4096, cfg.in_channels + cfg.extra_condition_channels)
    ctx, pooled = rnd(1, TXT_LEN, cfg.joint_attention_dim), rnd(1, cfg.pooled_projection_dim)
    t, guid = torch.full((1,), 0.75, dtype=dt, device=dev), torch.full((1,), 3.5, device=dev)
    img_ids, txt_ids = prepare_latent_image_ids(128, 128, dev), torch.zeros(TXT_LEN, 3, device=dev)
    mask = torch.zeros(4096, 1, device=dev)
    mask[:2048] = 1.0
    mode = torch.tensor([UNION_MODE], device=dev)
    layers = (pipe.flux.config.num_layers, pipe.flux.config.num_single_layers)
    multi = MultiControlNet([ControlNetEntry(pipe.controlnet, 1.0),
                             ControlNetEntry(union, 0.8, uses_mode=True, guidance_start=0.5,
                                             guidance_end=1.0)], *layers)
    expect = {"K1": 2 * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
              **norm_launches(cn=2)}
    launches, ok = dict.fromkeys(expect, 0), True
    for step in (1, 3):
        reset_launches()
        blocks, singles = multi(x, [cond, cond], ctx, pooled, t, img_ids, txt_ids, guid,
                                token_masks=[mask, None], modes=[None, mode], step_index=step,
                                num_steps=4)
        got = read_launches()
        launches = {k: launches[k] + got[k] for k in launches}
        b1, s1 = pipe.controlnet(x, cond, ctx, pooled, t, img_ids, txt_ids, guid, 1.0)
        b2, s2 = union(x, cond, ctx, pooled, t, img_ids, txt_ids, guid, 0.8, mode=mode)
        keep = float(step / 4 >= 0.5)
        want = [spread_residuals(a * mask.to(a.dtype), n) + spread_residuals(
                    b * torch.tensor(keep, dtype=b.dtype, device=dev), n)
                for a, b, n in ((b1, b2, layers[0]), (s1, s2, layers[1]))]
        same = bool(torch.equal(blocks, want[0])) and bool(torch.equal(singles, want[1]))
        ok &= same and got == expect
        phase("multi", f"step {step} of 4 (union window 0.5-1.0 {'on' if keep else 'off'}): "
                       f"block stacks {tuple(blocks.shape)}, single {tuple(singles.shape)}; "
                       f"bit-equal to each net's own masked, gated, spread residuals summed: "
                       f"{same}; launches "
                       + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in expect))
    if not ok:
        raise SystemExit("the multi-ControlNet composite failed its checks")
    return launches


def lora_phase(dev, pipe, steps, cn_steps, seed):
    """A seeded rank-LORA_RANK LoRA on every attention projection of every
    FLUX block merged into the resident FLUX: at scale 0 the image is
    bit-equal to the unmerged one, at scale 1 it differs and is finite; the
    touched weights restored after each, FLUX's checksums equal the
    originals'. Merge seconds and the GiB the kept originals cost."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.io import synthetic
    from reptext_tpu_torch.io.lora import apply_lora, restore_weights

    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    args = cli.build_parser().parse_args(
        ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps", str(steps),
         "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size", str(font_size),
         "--random-weights"])
    cond, source = conditions_for(data, name, text, pos, size, font_size)
    lora = synthetic.lora_state(pipe.flux.config, rank=LORA_RANK, seed=seed + 41, device=dev,
                                dtype=pipe.compute_dtype)
    head_dim = pipe.flux.config.attention_head_dim
    before = param_checksums(pipe.flux)
    gate = min(cn_steps, steps)
    expect = {"K1": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
              **norm_launches(steps, gate)}
    outs, launches = {}, {}

    def request(label):
        outs[label] = {}
        return run_request(f"txt2img {size}^2, {label}", lambda timings: cli.generate(
            args, pipe, cond, timings=timings, output_type="latent"), pipe, expect,
            (1, size, size, 3), steps, tag="lora", out=outs[label])

    request("no LoRA")
    fails = []
    for scale in (0.0, 1.0):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        kept = apply_lora(pipe.flux, lora, scale=scale, head_dim=head_dim, keep_originals=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        extra = (torch.cuda.memory_allocated() - mem0) / 2**30
        label = f"LoRA scale {scale:g}"
        launches["lora"] = request(label)
        restore_weights(pipe.flux, kept)
        del kept
        torch.cuda.empty_cache()
        lat, ref = outs[label]["latents"], outs["no LoRA"]["latents"]
        if scale == 0.0:
            ok = bool(torch.equal(lat, ref)) and np.array_equal(outs[label]["image"],
                                                                outs["no LoRA"]["image"])
            what = f"latents and image bit-equal to no LoRA: {ok}"
        else:
            d = (lat - ref).abs().max().item()
            ok = d > 0 and bool(torch.isfinite(lat).all())
            what = f"max|latents - no LoRA| {d:.4f} (must differ), finite"
        phase("lora", f"rank {LORA_RANK} on {len(lora) // 2} attention projections, merged at "
                      f"scale {scale:g} in {sec:.3f} s; the kept originals {extra:.2f} GiB; {what}")
        if not ok:
            fails.append(label)
    same = param_checksums(pipe.flux) == before
    phase("lora", f"FLUX restored: checksums equal the originals' {same}")
    if fails or not same:
        raise SystemExit(f"the LoRA phase failed its checks: {fails}")
    return launches


def single_file_phase(dev, pipe, steps, cn_steps, seed):
    """A synthetic BFL single file of FLUX at full width, depth cut to
    CKPT_FLUX, through convert_cli --flux-single-file: bit-equal to the same
    weights converted from diffusers naming, its inferred geometry the
    model's; then one 1024^2 request through it."""
    import dataclasses
    import shutil

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.io import checkpoint as ck
    from reptext_tpu_torch.io import convert as conv
    from reptext_tpu_torch.io import convert_cli, synthetic
    from reptext_tpu_torch.io.safetensors import load_file, save_file
    from reptext_tpu_torch.pipelines.txt2img import MODULES, build_module

    cfg = dataclasses.replace(pipe.flux.config, num_layers=CKPT_FLUX[0],
                              num_single_layers=CKPT_FLUX[1])
    root = os.path.join(ROOT, SCRATCH, "single_file")
    os.makedirs(root, exist_ok=True)
    try:
        t0 = time.perf_counter()
        state = synthetic.flux_state(cfg, seed=seed + 51, device=dev, dtype=pipe.compute_dtype)
        path = os.path.join(root, "flux1-dev.safetensors")
        written = save_file(synthetic.bfl_flux_state(state), path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        if convert_cli.main(["--flux-single-file", path, "--out", os.path.join(root, "out")]):
            raise SystemExit("convert_cli --flux-single-file failed")
        t_conv = time.perf_counter() - t0
        got = load_file(ck.component_path(os.path.join(root, "out"), "flux"))
        saved = ck.load_saved_configs(os.path.join(root, "out"))["flux"]
        want = convert_cli.module_state("flux", conv.convert_flux_transformer(state, cfg), cfg)
        same = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
        del state, want
        phase("single_file", f"BFL file, FLUX {cfg.num_layers} + {cfg.num_single_layers} at full "
                             f"width, {written / 1e9:.3f} GB written in {t_write:.1f} s, converted "
                             f"in {t_conv:.1f} s; bit-equal to the diffusers naming's conversion "
                             f"{same}; inferred geometry the model's {saved == cfg}")
        if not (same and saved == cfg):
            raise SystemExit("the single-file conversion failed its checks")
        flux = build_module(MODULES["flux"], saved, dev, pipe.compute_dtype, got)
        del got
        data, size, font_size, reqs = load_requests()
        name, text, pos = reqs[0]
        args = cli.build_parser().parse_args(
            ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
             str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed),
             "--font-size", str(font_size), "--random-weights"])
        cond, source = conditions_for(data, name, text, pos, size, font_size)
        spipe = pipe.with_config(pipe.pipe_cfg)
        spipe.flux = flux
        gate = min(cn_steps, steps)
        expect = {"K1": steps * sum(CKPT_FLUX) + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
                  **norm_launches(steps, gate, flux_depth=CKPT_FLUX)}
        got = run_request(f"txt2img {size}^2 through the converted single file (FLUX "
                          f"{cfg.num_layers} + {cfg.num_single_layers})",
                          lambda timings: cli.generate(args, spipe, cond, timings=timings,
                                                       output_type="latent"),
                          spipe, expect, (1, size, size, 3), steps, tag="single_file")
        del spipe, flux
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return got


def ip_phase(dev, pipe, steps, cn_steps, seed):
    """The IP-Adapter at the published geometry: a seeded CLIP ViT-L/14 and a
    seeded adapter (to_v_ip nonzero) written as files, converted by
    convert_cli --ip-adapter --image-encoder-dir and attached from that
    directory (cli --ip-adapter-dir) to a view of the pipeline; a 224^2 image
    prompt: its encode time; 1024^2 without the adapter, with the image at
    IP_SCALE, and at scale 0 (bit-equal to without); 1536^2 (K3); a served
    batch of one request with the image and one without over HTTP; SP
    txt2img at 2048^2 over SP_RANKS thread ranks (ring) against one card.
    The adapter's projections are taken off FLUX afterwards."""
    import http.client
    import shutil
    import threading

    from PIL import Image

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.configs import CLIPVisionConfig, IPAdapterConfig
    from reptext_tpu_torch.io import convert_cli, synthetic
    from reptext_tpu_torch.io.safetensors import save_file
    from reptext_tpu_torch.serving import GenerationServer
    from reptext_tpu_torch.utils.metrics import Metrics

    root = os.path.join(ROOT, SCRATCH, "ip")
    os.makedirs(root, exist_ok=True)
    launches, fails = {}, []
    gate = min(cn_steps, steps)
    per_request = steps * DOUBLE_CALLS + gate * SINGLE_CALLS
    try:
        vcfg, ipcfg = CLIPVisionConfig(), IPAdapterConfig()
        t0 = time.perf_counter()
        vdir = os.path.join(root, "image_encoder")
        synthetic.write_component(vdir, synthetic.clip_vision_state(
            vcfg, seed=seed + 61, device=dev, dtype=pipe.compute_dtype),
            synthetic.clip_vision_hf_config(vcfg))
        ip_path = os.path.join(root, "ip-adapter.safetensors")
        save_file(synthetic.ip_adapter_state(ipcfg, pipe.flux.config.num_layers,
                                             pipe.flux.config.inner_dim, seed=seed + 62,
                                             device=dev, dtype=pipe.compute_dtype), ip_path)
        if convert_cli.main(["--ip-adapter", ip_path, "--image-encoder-dir", vdir, "--out",
                             os.path.join(root, "out")]):
            raise SystemExit("convert_cli --ip-adapter failed")
        t_conv = time.perf_counter() - t0
        style = os.path.join(root, "style.png")
        Image.fromarray(np.random.default_rng(seed + 63).integers(
            0, 256, (224, 224, 3)).astype(np.uint8)).save(style)
        data, size, font_size, reqs = load_requests()
        name, text, pos = reqs[0]
        base = ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
                str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed),
                "--font-size", str(font_size), "--random-weights"]
        args = cli.build_parser().parse_args(
            base + ["--ip-adapter-image", style, "--ip-adapter-scale", str(IP_SCALE),
                    "--ip-adapter-dir", os.path.join(root, "out", "ip_adapter")])
        cond, source = conditions_for(data, name, text, pos, size, font_size)
        plain = pipe.with_config(pipe.pipe_cfg)
        ipipe = pipe.with_config(pipe.pipe_cfg)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cli.attach_ip_adapter(args, ipipe)
        torch.cuda.synchronize()
        t_attach, extra = time.perf_counter() - t0, (torch.cuda.memory_allocated() - mem0) / 2**30
        image = cli.load_ip_image(style)
        enc = cuda_time_ms(lambda: ipipe.encode_ip_image(image), repeats=5, warmup=2)
        phase("ip", f"CLIP ViT-L/14 ({vcfg.num_layers} x {vcfg.hidden_size}) and the adapter "
                    f"({ipcfg.num_tokens} tokens of {ipcfg.cross_attention_dim}, to_k_ip/to_v_ip "
                    f"on {pipe.flux.config.num_layers} double blocks) written and converted in "
                    f"{t_conv:.1f} s, attached from the converter's directory in {t_attach:.1f} s: "
                    f"+{extra:.2f} GiB on the card; a 224^2 image prompt encodes in {enc[0]:.3f} "
                    f"ms (median of 5)")
        expect = {"K1": per_request, "K2": 0, "K3": 0, "K5": 0, **norm_launches(steps, gate)}
        outs = {}

        def request(label, p, a):
            outs[label] = {}
            return run_request(label, lambda timings: cli.generate(
                a, p, cond, timings=timings, output_type="latent"), p, expect,
                (1, size, size, 3), steps, tag="ip", out=outs[label])

        request(f"txt2img {size}^2 without the adapter", plain,
                cli.build_parser().parse_args(base))
        launches["ip_txt2img"] = request(f"txt2img {size}^2, image prompt at {IP_SCALE}",
                                         ipipe, args)
        args.ip_adapter_scale = 0.0
        request(f"txt2img {size}^2, image prompt at 0", ipipe, args)
        args.ip_adapter_scale = IP_SCALE
        a, b = outs[f"txt2img {size}^2 without the adapter"], outs[f"txt2img {size}^2, image prompt at 0"]
        w = outs[f"txt2img {size}^2, image prompt at {IP_SCALE}"]
        zero_ok = bool(torch.equal(a["latents"], b["latents"])) and np.array_equal(a["image"],
                                                                                   b["image"])
        d = (w["latents"] - a["latents"]).abs().max().item()
        phase("ip", f"scale 0 bit-equal to no adapter: {zero_ok}; at {IP_SCALE} the latents move "
                    f"by max {d:.4f}; sampler ms/step with the prompt {w['ms_step']:.1f} against "
                    f"{a['ms_step']:.1f} without ({100 * (w['ms_step'] / a['ms_step'] - 1):+.2f} "
                    f"%); peak {w['peak']:.2f} GiB against {a['peak']:.2f}")
        if not (zero_ok and d > 0):
            fails.append("scale 0 / scale")

        large = np.load(LARGE_FIXTURE)
        lname = "txt2img_1536"
        ltext, lpos = str(large[f"{lname}.text"]), tuple(int(v) for v in large[f"{lname}.position"])
        lw, lh = (int(v) for v in large[f"{lname}.size"])
        largs = cli.build_parser().parse_args(
            ["--text", ltext, "--position", *map(str, lpos), "--size", str(lw), "--steps",
             str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
             str(int(large["font_size"])), "--random-weights", "--ip-adapter-image", style,
             "--ip-adapter-scale", str(IP_SCALE)])
        lcond, _ = conditions_for(large, lname, ltext, lpos, (lw, lh), int(large["font_size"]),
                                  LARGE_FIXTURE)
        big = ipipe.with_config(cli.pipeline_config(largs, lh, lw))
        launches["ip_txt2img_1536"] = run_request(
            f"txt2img {lw}x{lh}, image prompt at {IP_SCALE}",
            lambda timings: cli.generate(largs, big, lcond, timings=timings, output_type="latent"),
            big, dict(copied(expect), K1=0, K3=per_request), (1, lh, lw, 3), steps, tag="ip")
        del big

        server = GenerationServer(ipipe, host="127.0.0.1", port=0, max_batch=2,
                                  batch_window_s=BATCH_WINDOW_S, metrics=Metrics(),
                                  request_timeout_s=600)
        server.worker.conditions = lambda req, width, height: cond
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.address[:2]
        with open(style, "rb") as f:
            style_b64 = base64.b64encode(f.read()).decode()
        payloads = [{"prompt": "a street sign in city", "lines": [{"text": text, "position": list(pos)}],
                     "seed": seed, "num_steps": steps, "ip_image_png_base64": style_b64,
                     "ip_scale": IP_SCALE},
                    {"prompt": "a street sign in city", "lines": [{"text": text, "position": list(pos)}],
                     "seed": seed + 1, "num_steps": steps}]
        answers = [None, None]

        def client(i):
            conn = http.client.HTTPConnection(host, port, timeout=600)
            conn.request("POST", "/generate", body=json.dumps(payloads[i]),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers[i] = (resp.status, json.loads(resp.read()))
            conn.close()

        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        got = read_launches()
        launches["ip_serve"] = got
        batches = server.worker.metrics.snapshot()["counters"].get("serving.batches", 0)
        server.shutdown()
        thread.join(timeout=30)
        pngs = [png_array(ans[1]["image_png_base64"]) if ans and ans[0] == 200 else (False, None)
                for ans in answers]
        served_ok = (all(p[0] and p[1].shape == (size, size, 3) for p in pngs) and batches == 1
                     and got == expect)
        phase("ip", f"served over HTTP: a request with the image prompt and one without, "
                    f"{wall:.3f} s, {batches} batch (expected 1); launches "
                    + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                    + f"; PNGs {[None if p[1] is None else p[1].shape for p in pngs]} -> "
                    + ("ok" if served_ok else f"FAIL {answers if not served_ok else ''}"))
        if not served_ok:
            fails.append("serve")

        sp_steps = 2
        big, scond, ssource, kw = sp_request(ipipe, dev, seed, sp_steps)
        kw.update(ip_adapter_image=image, ip_adapter_scale=IP_SCALE)
        s_img = big.pipe_cfg.image_seq_len
        calls = DOUBLE_CALLS + SINGLE_CALLS
        ref = None
        for label, backend in (("single", None), ("ring", "ring")):
            def call(g, backend=backend):
                timings = {}
                run = big if g is None else big.with_config(big.pipe_cfg).shard_for_sp(g, backend)
                return run(scond, timings=timings, **kw), timings

            lat, got, _ = sp_run(dev, f"txt2img {SP_SIZE}x{SP_SIZE} with the image prompt at "
                                      f"{IP_SCALE} (ip tokens whole on every rank)", backend, call,
                                 sp_expect(backend, "K3", sp_steps * calls,
                                           norm_launches(sp_steps, sp_steps)), ref, sp_steps,
                                 (1, s_img, 64))
            launches["ip_sp_ring" if backend else "ip_txt2img_2048"] = got
            ref = lat if ref is None else ref
        del big, kw, ref, lat
    finally:
        for layer in pipe.flux.double_blocks:
            for attr in ("to_k_ip", "to_v_ip"):
                if hasattr(layer.block, attr):
                    delattr(layer.block, attr)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    if fails:
        raise SystemExit(f"the IP-Adapter phase failed its checks: {fails}")
    return launches


def kernel_class(name):
    if "attn_fwd_kernel" in name or "rope_rotate_kernel" in name:
        return "attention kernel (attn_fwd_kernel + rope_rotate_kernel; K1, K2, K3)"
    if "attn_bwd_" in name:
        return ("attention backward kernel (attn_bwd_preprocess_kernel + attn_bwd_kernel + "
                "attn_bwd_epilogue_kernel; K4)")
    if any(tag in name.lower() for tag in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolutions (cuDNN: the VAE decoder's and the OCR judge's, and their gradients)"
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


def step_bound(b, h, sq, sk, d=128, elem=2):
    """One ring step: both products, 4 B H Sq Sk D FLOP; q, k, v read once in
    their dtype (``elem`` bytes) and the fp32 state (acc, m, l) read and
    written once."""
    state = 4 * b * h * sq * (d + 2)
    return bound(4 * b * h * sq * sk * d, elem * b * h * (sq + 2 * sk) * d + 2 * state)


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

    def steps(fn, q, blocks):
        state = None
        for i, (k, v) in enumerate(blocks):
            state = fn(q, k, v, state, i == 0, i == len(blocks) - 1)
        return state

    label = (f"the {SP_SIZE}^2 SP rank's steps, q (1,{h},{sq},128) x k "
             f"(1,{h},{TXT_LEN}|{sk}|{sk},128)")
    err = max(err, check_out(label, steps(ra.ring_step, q, blocks),
                             steps(ra.ring_step_plain, q, blocks)))
    state = ra.ring_step(q, kt, vt, None, True, False)
    plain_state = ra.ring_step_plain(q, kt, vt, None, True, False)
    kern, pln, line = alternated_ms(
        lambda: ra.ring_step(q, k1, v1, state, False, False),
        lambda: ra.ring_step_plain(q, k1, v1, plain_state, False, False))
    rank_steps = cuda_time_ms(lambda: steps(ra.ring_step, q, blocks))[0]
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

    # one rank of SP inpainting at 1536x1152 over SP_RANKS ranks, CFG batch 2:
    # queries [text; image shard] against the text block and the two image blocks
    b2, sq2, sk2 = 2, TXT_LEN + S_SP_INPAINT // SP_RANKS, S_SP_INPAINT // SP_RANKS
    q2 = rnd(b2, h, sq2)
    blocks2 = [(rnd(b2, h, n), rnd(b2, h, n)) for n in (TXT_LEN, sk2, sk2)]
    label = (f"the {SP_INPAINT_HW[1]}x{SP_INPAINT_HW[0]} SP inpaint rank's steps at CFG batch "
             f"2, q (2,{h},{sq2},128) x k (2,{h},{TXT_LEN}|{sk2}|{sk2},128)")
    err2 = check_out(label, steps(ra.ring_step, q2, blocks2), steps(ra.ring_step_plain, q2, blocks2))
    err = max(err, err2)
    (kt, vt), (k1, v1) = blocks2[:2]
    state = ra.ring_step(q2, kt, vt, None, True, False)
    plain_state = ra.ring_step_plain(q2, kt, vt, None, True, False)
    kern2, pln2, line = alternated_ms(
        lambda: ra.ring_step(q2, k1, v1, state, False, False),
        lambda: ra.ring_step_plain(q2, k1, v1, plain_state, False, False))
    rank2 = cuda_time_ms(lambda: steps(ra.ring_step, q2, blocks2))[0]
    k_all = torch.cat([k for k, _ in blocks2], dim=2)
    v_all = torch.cat([v for _, v in blocks2], dim=2)
    lib2 = cuda_time_ms(lambda: F.scaled_dot_product_attention(q2, k_all, v_all))[0]
    b2_ms, b2_by = step_bound(b2, h, sq2, sk2)
    rank2_bound = sum(step_bound(b2, h, sq2, n)[0] for n in (TXT_LEN, sk2, sk2))
    by_shape[f"(2,{h},{sq2},128) x (2,{h},{sk2},128)"] = {
        "ms": kern2[0], "plain_ms": pln2[0], "bound_ms": b2_ms, "bound_by": b2_by,
        "library_ms": lib2, "rank_steps_ms": rank2, "rank_steps_bound_ms": rank2_bound,
        "max_abs_err": err2}
    phase("ring", f"K5 image step at CFG batch 2 (2,{h},{sq2},128) x (2,{h},{sk2},128) time: "
                  f"{line}; bound {b2_ms:.4f} ms ({b2_by}); "
                  f"{rate(attention_flop(b2, h, sq2, sk2), kern2[0], b2_ms)}; the rank's 3 steps "
                  f"{rank2:.4f} ms (bound {rank2_bound:.4f} ms); library (SDPA over the "
                  f"{TXT_LEN + 2 * sk2} keys) {lib2:.4f} ms")
    del q2, blocks2, kt, vt, k1, v1, k_all, v_all, state, plain_state
    torch.cuda.empty_cache()
    d64 = d64_ring_checks(dev, gen)
    err = max([err] + [x["max_abs_err"] for x in d64.values()])
    torch.cuda.empty_cache()
    ulysses_exact_check(dev, gen)
    return {"ms": kern[0], "plain_ms": pln[0], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "rank_steps_ms": rank_steps, "rank_steps_bound_ms": rank_bound,
            "library_note": "SDPA over the rank's queries and all keys: the output of the rank's "
                            "three steps (rank_steps_ms)",
            "max_abs_err": err, "by_shape": by_shape, "d64": d64}


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
    gc.collect()
    torch.cuda.empty_cache()
    ok = dist_tp_run(dev) and ok
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
        expect = {"K1": 0, "K2": 0, "K3": steps * calls, "K5": 0,
                  **copied(norm_launches(steps, steps))}
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
    del big, kw
    torch.cuda.empty_cache()
    return dist_sp_inpaint_run(dev, group, pipe, seed, steps) and ok


def dist_sp_inpaint_run(dev, group, pipe, seed, steps):
    """SP inpainting at 1536x1152 over the cards, as ``--mode inpaint --shard
    spN`` runs it: this rank's card alone (the reference), then shard_for_sp
    over the NCCL group with the ring and the Ulysses backends, each called
    twice (cold, warm); a JSON line per run."""
    from reptext_tpu_torch import cli

    args, inp, cond, _, image, mask = sp_inpaint_request(pipe, seed, steps)
    n, ok, ref = group.size, True, None
    for backend, call in ((b, c) for b in (None, "ring", "ulysses") for c in ("cold", "warm")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timings = {}
        run = inp if backend is None else inp.with_config(inp.pipe_cfg).shard_for_sp(group,
                                                                                     backend)
        lat = cli.generate_inpaint(args, run, cond, image, mask, timings=timings,
                                   output_type="latent")
        torch.cuda.synchronize()
        got = read_launches()
        expect = {"K1": 0, "K2": 0, "K3": steps * INPAINT_CALLS, "K5": 0,
                  **copied(norm_launches(steps, 2 * steps))}
        if backend == "ring":
            expect.update(K3=0, K5=(n + 1) * steps * INPAINT_CALLS)
        ref = lat if backend is None else ref
        rel = (lat - ref).abs().max().item() / ref.abs().max().item()
        run_ok = got == expect and rel <= SP_RTOL and bool(torch.isfinite(lat).all())
        ok = ok and run_ok
        print(json.dumps({"rank": group.rank, "sp_inpaint": backend or "one card", "call": call,
                          "cards": n, "ms_per_step": 1e3 * timings["sample"] / steps,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": got, "expected": expect, "max_abs_vs_one_card": rel,
                          "ok": run_ok}), flush=True)
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
            outs.append(proc.communicate(timeout=720)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise SystemExit("the NCCL ring timed out")
    for r, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")] or ["no result line"]
        phase("ring", f"NCCL rank {r} of {n} (K5 ring at (1,24,4608,128) vs the plain ring, "
                      f"then txt2img {SP_SIZE}^2 on one card, ring and ulysses over the cards, "
                      "the transfers alone, then inpainting at 1536x1152 the same way; then "
                      "--shard 1xN: txt2img 1024^2 on one card and tensor-parallel over the "
                      "cards, and the cut-depth ControlNet train steps the same way): "
                      + " | ".join(lines))
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


def sp_run(dev, label, backend, call, expect, ref, steps, shape):
    """One SP comparison run: ``call(group)`` -> (latents, timings) on the one
    device (``backend`` None, group None) or on each of SP_RANKS thread ranks
    on the card; launch counts set to 0 just before and read just after;
    ranks equal, finite latents of ``shape``, the launch counts, and (for a
    sharded run) the latents within SP_RTOL of ``ref``. Returns (latents,
    launches, ms/step)."""
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = [call(None)] if backend is None else run_spmd(LocalSPGroup(SP_RANKS, dev), call)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lat = outs[0][0]
    same = all(bool(torch.equal(o[0], lat)) for o in outs[1:])
    finite = bool(torch.isfinite(lat).all()) and tuple(lat.shape) == shape
    ms_step = 1e3 * statistics.median(o[1]["sample"] for o in outs) / steps
    n = 1 if backend is None else SP_RANKS
    line = (f"{label}, " + ("one device" if backend is None else f"{backend} over {n} thread "
                             f"ranks on one card")
            + f": {wall:.3f} s for {steps} steps (the first call at this size and backend); "
            f"sampler {ms_step:.1f} ms/step; peak device memory {peak:.2f} GiB; launches "
            + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
            + f"; latents finite, shape ok {finite}; ranks equal {same}")
    ok_tol = True
    if backend is not None:
        err = (lat - ref).abs()
        rel_max = err.max().item() / ref.abs().max().item()
        rel_mean = err.mean().item() / ref.abs().mean().item()
        ok_tol = rel_max <= SP_RTOL
        line += (f"; vs one device: max_abs/max|ref| {rel_max:.3e} (tol {SP_RTOL}), "
                 f"mean_abs/mean|ref| {rel_mean:.3e} -> {'ok' if ok_tol else 'FAIL'}")
    phase("sp", line)
    if not (finite and same and got == expect and ok_tol):
        raise SystemExit(f"the SP run ({label}, {backend or 'one device'}) failed its checks")
    return lat, got, ms_step


def sp_expect(backend, kernel, calls, norms):
    """Launches of a run of ``calls`` attention calls and ``norms`` norm
    kernel launches per rank: ``kernel`` on one device, or on each Ulysses
    rank (exact local softmax; K3 past 6144 joint tokens); the ring's n + 1 K5
    steps per call on each rank; every rank's norms (no GELU launch but with
    K1 on one device)."""
    n = 1 if backend is None else SP_RANKS
    if backend is not None or kernel != "K1":
        norms = copied(norms)
    expect = {"K1": 0, "K2": 0, "K3": 0, "K5": 0, **scaled(norms, n)}
    if backend == "ring":
        expect["K5"] = n * (n + 1) * calls
    else:
        expect[kernel] = n * calls
    return expect


def sp_phase(dev, pipe, seed):
    """SP txt2img at 2048^2: the single-device pipeline (K3), then
    shard_for_sp over SP_RANKS thread ranks with the ring (K5) and Ulysses
    (K3 on 24 / SP_RANKS heads) backends, 2 steps with the ControlNet on both,
    from the same packed noise; latents against the single device's. Then
    SP inpainting at 1536x1152 and an SP batch of two 1024^2 requests
    (:func:`sp_inpaint_runs`, :func:`sp_batch_runs`)."""
    steps = 2
    big, cond, source, kw = sp_request(pipe, dev, seed, steps)
    s_img = big.pipe_cfg.image_seq_len
    calls = DOUBLE_CALLS + SINGLE_CALLS
    runs, launches, ms = {}, {}, {}
    for label, backend in (("single", None), ("ring", "ring"), ("ulysses", "ulysses")):
        def call(g, backend=backend):
            timings = {}
            run = big if g is None else big.with_config(big.pipe_cfg).shard_for_sp(g, backend)
            return run(cond, timings=timings, **kw), timings

        runs[label], got, ms[label] = sp_run(
            dev, f"txt2img {SP_SIZE}x{SP_SIZE} (S = {TXT_LEN + s_img}, conditions: {source})",
            backend, call, sp_expect(backend, "K3", steps * calls, norm_launches(steps, steps)),
            runs.get("single"), steps,
            (1, s_img, 64))
        launches[f"sp_{label}" if backend else "txt2img_2048"] = got
        if backend == "ring":
            phase("sp", f"K5 per rank per step {got['K5'] / (SP_RANKS * steps):.0f} = (n + 1) x "
                        f"{calls}")
    d = (runs["ring"] - runs["ulysses"]).abs().max().item() / runs["single"].abs().max().item()
    phase("sp", f"ring vs ulysses: max_abs/max|single| {d:.3e}")
    del runs, kw
    torch.cuda.empty_cache()
    launches.update(sp_inpaint_runs(dev, pipe, seed))
    launches.update(sp_batch_runs(dev, pipe, seed))
    return launches


def sp_inpaint_request(pipe, seed, steps):
    """SP inpainting's request: the inpaint pipeline at 1536x1152 over
    ``pipe``'s modules plus a seeded inpaint ControlNet, the fixture's line,
    a seeded source image and a box mask, true CFG 3.5 with the default
    negative prompt, both ControlNets on every step; (args, pipeline,
    conditions, their source, image, mask)."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline

    data = np.load(LARGE_FIXTURE)
    font_size = int(data["font_size"])
    text = str(data[f"{SP_INPAINT}.text"])
    pos = tuple(int(v) for v in data[f"{SP_INPAINT}.position"])
    width, height = (int(v) for v in data[f"{SP_INPAINT}.size"])
    args = cli.build_parser().parse_args(
        ["--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE), "--text", text,
         "--position", *map(str, pos), "--steps", str(steps), "--controlnet-step", str(steps),
         "--seed", str(seed), "--font-size", str(font_size), "--random-weights"])
    cond, source = conditions_for(data, SP_INPAINT, text, pos, (width, height), font_size,
                                  LARGE_FIXTURE)
    inp = FluxRepTextInpaintPipeline.from_pipeline(
        pipe, seed=seed + 7, pipe_cfg=cli.pipeline_config(args, height, width))
    return args, inp, cond, source, source_image(seed, height, width), box_mask(cond)


def sp_inpaint_runs(dev, pipe, seed, steps=2):
    """SP inpainting at 1536x1152 (S = 7424, CFG batch 2) through
    cli.generate_inpaint: one device (K3), then shard_for_sp over SP_RANKS
    thread ranks, ring (K5 at batch 2) and Ulysses (K3 on 12 heads)."""
    from reptext_tpu_torch import cli

    args, inp, cond, source, image, mask = sp_inpaint_request(pipe, seed, steps)
    s_img = inp.pipe_cfg.image_seq_len
    runs, launches = {}, {}
    for label, backend in (("one_device", None), ("ring", "ring"), ("ulysses", "ulysses")):
        def call(g, backend=backend):
            timings = {}
            run = inp if g is None else inp.with_config(inp.pipe_cfg).shard_for_sp(g, backend)
            return cli.generate_inpaint(args, run, cond, image, mask, timings=timings,
                                        output_type="latent"), timings

        runs[label], launches[f"sp_inpaint_{label}"], _ = sp_run(
            dev, f"inpaint {SP_INPAINT_HW[1]}x{SP_INPAINT_HW[0]} (S = {TXT_LEN + s_img}, CFG "
                 f"batch 2, true-CFG {TRUE_GUIDANCE}, both ControlNets on every step, mask "
                 f"{int((mask > 0).sum())} px, conditions: {source})",
            backend, call,
            sp_expect(backend, "K3", steps * INPAINT_CALLS, norm_launches(steps, 2 * steps)),
            runs.get("one_device"), steps, (1, s_img, 64))
    d = (runs["ring"] - runs["ulysses"]).abs().max().item() / runs["one_device"].abs().max().item()
    phase("sp", f"inpaint ring vs ulysses: max_abs/max|one device| {d:.3e}")
    del runs, inp
    torch.cuda.empty_cache()
    return launches


def sp_batch_runs(dev, pipe, seed, steps=2):
    """generate_batch of the fixture's two 1024^2 requests (one line each,
    seeds seed and seed + 1), the ControlNet on both steps: one device (K1),
    then shard_for_sp over SP_RANKS thread ranks with the ring (K5)."""
    from reptext_tpu_torch import cli

    data, size, font_size, reqs = load_requests()
    conds, ids, sources = [], [], set()
    for name, text, pos in reqs:
        args = cli.build_parser().parse_args(
            ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
             str(steps), "--controlnet-step", str(steps), "--seed", str(seed), "--font-size",
             str(font_size), "--random-weights"])
        cond, source = conditions_for(data, name, text, pos, size, font_size)
        conds.append(cond)
        sources.add(source)
        ids.append(cli.request_ids(args, pipe))
    batch = pipe.with_config(cli.pipeline_config(args))
    kw = dict(clip_ids=np.concatenate([c for c, _ in ids]),
              t5_ids=np.concatenate([t for _, t in ids]), seeds=[seed, seed + 1],
              guidance_scale=args.guidance_scale, output_type="latent")
    s_img = batch.pipe_cfg.image_seq_len
    calls = steps * (DOUBLE_CALLS + SINGLE_CALLS)
    ref, launches = None, {}
    for label, backend in (("one_device", None), ("ring", "ring")):
        def call(g, backend=backend):
            timings = {}
            run = batch if g is None else batch.with_config(batch.pipe_cfg).shard_for_sp(
                g, backend)
            return run.generate_batch(conds, timings=timings, **kw), timings

        lat, launches[f"sp_batch_{label}"], _ = sp_run(
            dev, f"generate_batch of 2 requests at {size}^2 (S = {TXT_LEN + s_img}, conditions: "
                 f"{', '.join(sorted(sources))})",
            backend, call, sp_expect(backend, "K1", calls, norm_launches(steps, steps)), ref,
            steps, (2, s_img, 64))
        ref = lat if ref is None else ref
    return launches


# ---------------------------------------------------------------- tensor parallelism

TP_RESULT = "TP_LAUNCHES "
# the head counts a tp rank runs: 24 / tp at tp = 2 and 4
TP_HEADS = (12, 6)
TP_RTOL = SP_RTOL


def tp_kernel_phase(dev):
    """K1 and K3 at the head counts of a tp rank (12 at tp = 2, 6 at tp = 4)
    at the 1024^2 and 1536^2 joint lengths, and K4 at (1, 12, 4608, 128) (a
    2 x 2 train step's rank), against their plain versions; times beside the
    bound and SDPA's on the same inputs. Returns {kernel: {shape: {...}}}."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    sdpa = F.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(23)
    res = {"K1": {}, "K3": {}, "K4": {}}

    def qkv(h, s):
        return [torch.randn(1, h, s, 128, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    def timed(key, label, kern, plain, library, b_ms_by, flop, err):
        k_t, p_t, line = alternated_ms(kern, plain)
        lib = cuda_time_ms(library)[0]
        res[key][label] = {"ms": k_t[0], "plain_ms": p_t[0], "library_ms": lib,
                           "bound_ms": b_ms_by[0], "bound_by": b_ms_by[1], "max_abs_err": err}
        phase("kernels", f"{key} {label} (a tp rank's heads) time: {line}; SDPA {lib:.4f} ms; "
                         f"bound {b_ms_by[0]:.4f} ms ({b_ms_by[1]}); "
                         f"{rate(flop, k_t[0], b_ms_by[0])}")

    for h in TP_HEADS:
        q, k, v = qkv(h, 4608)
        cos, sin = rope_tables(512, 64, 64, dev)
        label = f"(1,{h},4608,128)"
        err = compare(f"K1 {label}", fa.flash_attention_rope(q, k, v, cos, sin),
                      fa.flash_attention_rope_plain(q, k, v, cos, sin))
        qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        timed("K1", label, lambda: fa.flash_attention_rope(q, k, v, cos, sin),
              lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), lambda: sdpa(qr, kr, v),
              forward_bound(1, h, 4608, tables=True), attention_flop(1, h, 4608, 4608), err)
        if h == TP_HEADS[0]:
            out, lse = fa.flash_attention(qr, kr, v)
            do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
            args = (qr, kr, v, out, lse, do)
            err = compare_grads(f"K4 {label}", fa.flash_attention_backward(*args),
                                plain_backward_by_heads(fa, args, None))
            leaves = [x.detach().clone().requires_grad_(True) for x in (qr, kr, v)]
            lib_out = sdpa(*leaves)
            timed("K4", label, lambda: fa.flash_attention_backward(*args),
                  lambda: plain_backward_by_heads(fa, args, None),
                  lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
                  backward_bound(1, h, 4608), 10 * h * 4608 * 4608 * 128, err)
            del out, lse, do, args, leaves, lib_out
        del q, k, v, qr, kr
        q, k, v = qkv(h, 9728)
        cos, sin = rope_tables(512, 96, 96, dev)
        q, k = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
        label = f"(1,{h},9728,128)"
        err = compare(f"K3 {label}", fa.flash_attention_streaming(q, k, v),
                      fa.flash_attention_streaming_plain(q, k, v))
        timed("K3", label, lambda: fa.flash_attention_streaming(q, k, v),
              lambda: fa.flash_attention_streaming_plain(q, k, v), lambda: sdpa(q, k, v),
              forward_bound(1, h, 9728), attention_flop(1, h, 9728, 9728), err)
        del q, k, v
        torch.cuda.empty_cache()
    return res


def d64_ring_checks(dev, gen):
    """K5 at head dim 64: the demo's joint 69 tokens (5 text on every rank, 64
    image over 2 thread ranks, the text block folded in first) and (1, 24,
    4608, 64) over 4 thread ranks, each against the plain ring; one middle
    step timed beside the bound and SDPA."""
    import torch.nn.functional as F

    from reptext_tpu_torch.ops import ring_attention as ra
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    def rnd(*shape):
        return torch.randn(*shape, 64, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = rnd(1, 4, 69), rnd(1, 4, 69), rnd(1, 4, 69)

    def joint(step):
        def rank(g):
            return ra.ring_loop(torch.cat([q[:, :, :5], g.shard(q[:, :, 5:], 2)], 2),
                                g.shard(k[:, :, 5:], 2), g.shard(v[:, :, 5:], 2), g, step,
                                prefix=(k[:, :, :5], v[:, :, :5]))
        return run_spmd(LocalSPGroup(2, dev), rank)

    err = max(check_out(f"K5 at D = 64, the demo's joint (1,4,69,64) over 2 ranks: rank {r}",
                        a, b) for r, (a, b) in enumerate(zip(joint(ra.ring_step),
                                                             joint(ra.ring_step_plain))))
    q, k, v = rnd(1, HEADS, 4608), rnd(1, HEADS, 4608), rnd(1, HEADS, 4608)
    err = max(err, check_out(f"K5 at D = 64, (1,{HEADS},4608,64) over {RING_RANKS} ranks",
                             sharded_attention(dev, RING_RANKS, q, k, v, "ring_kernel"),
                             sharded_attention(dev, RING_RANKS, q, k, v, "ring")))
    sq = 4608 // RING_RANKS
    q0, k0, v0 = (x[:, :, :sq] for x in (q, k, v))
    state = ra.ring_step(q0, k0, v0, None, True, False)
    plain_state = ra.ring_step_plain(q0, k0, v0, None, True, False)
    kern, pln, line = alternated_ms(
        lambda: ra.ring_step(q0, k0, v0, state, False, False),
        lambda: ra.ring_step_plain(q0, k0, v0, plain_state, False, False))
    lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(q0, k, v))[0]
    b_ms, b_by = step_bound(1, HEADS, sq, sq, d=64)
    phase("ring", f"K5 middle step at D = 64 (1,{HEADS},{sq},64) x (1,{HEADS},{sq},64) time: "
                  f"{line}; bound {b_ms:.4f} ms ({b_by}); "
                  f"{rate(attention_flop(1, HEADS, sq, sq, 64), kern[0], b_ms)}; library (SDPA, "
                  f"the rank's {sq} queries over all 4608 keys) {lib:.4f} ms")
    return {f"(1,{HEADS},{sq},64) x (1,{HEADS},{sq},64)": {
        "ms": kern[0], "plain_ms": pln[0], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "max_abs_err": err}}


@contextlib.contextmanager
def heads_seen():
    """The head counts the blocks' attention calls get while inside (a tp
    rank's: num_heads / tp)."""
    from reptext_tpu_torch.nn import blocks

    seen, real = set(), blocks.attention

    def recorded(q, *a, **kw):
        seen.add((q[0] if isinstance(q, tuple) else q).shape[1])   # the segment route's pair
        return real(q, *a, **kw)

    blocks.attention = recorded
    try:
        yield seen
    finally:
        blocks.attention = real


def tp_run(dev, label, grid, call, expect, ref, steps, shape, slices, heads=None):
    """One sharded comparison run: ``call(rank)`` -> (latents, timings) on the
    one card (``grid`` None, rank None) or on every rank of a (dp, tp) thread
    mesh on the card (``grid``; the meshes share ``slices``, one copy of each
    tp rank's weights); launches set to 0 just before and read just after;
    ranks equal, finite latents of ``shape``, the launches, the heads the
    blocks' attention got (``heads``), and for a sharded run the latents
    within TP_RTOL of ``ref``. Returns (latents, launches)."""
    from reptext_tpu_torch.parallel.mesh import LocalMesh
    from reptext_tpu_torch.parallel.testing import run_spmd

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with heads_seen() as seen:
        outs = ([call(None)] if grid is None
                else run_spmd(LocalMesh(*grid, dev, slices=slices), call))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lat = outs[0][0]
    same = all(bool(torch.equal(o[0], lat)) for o in outs[1:])
    finite = bool(torch.isfinite(lat).all()) and tuple(lat.shape) == shape
    heads_ok = heads is None or seen == {heads}
    ms_step = 1e3 * statistics.median(o[1]["sample"] for o in outs) / steps
    line = (f"{label}, " + ("one card" if grid is None else
                           f"{grid[0]} x {grid[1]} (dp x tp) thread ranks on one card")
            + f": {wall:.3f} s for {steps} steps; sampler {ms_step:.1f} ms/step; peak device "
            f"memory {peak:.2f} GiB; launches "
            + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
            + f"; attention heads per call {sorted(seen)} (expected {heads}); latents finite, "
            f"shape ok {finite}; ranks equal {same}")
    ok_tol = True
    if grid is not None:
        err = (lat - ref).abs()
        rel_max = err.max().item() / ref.abs().max().item()
        ok_tol = rel_max <= TP_RTOL
        line += (f"; vs one card: max_abs/max|ref| {rel_max:.3e} (tol {TP_RTOL}), mean_abs/"
                 f"mean|ref| {err.mean().item() / ref.abs().mean().item():.3e} -> "
                 f"{'ok' if ok_tol else 'FAIL'}")
    phase("tp", line)
    if not (finite and same and got == expect and ok_tol and heads_ok):
        raise SystemExit(f"the tensor-parallel run ({label}, {grid or 'one card'}) failed its "
                         "checks")
    return lat, got


def tp_expect(kernel, calls, norms, ranks=1):
    """``calls`` attention calls of ``kernel`` and ``norms`` norm kernel
    launches on each of ``ranks`` ranks (no GELU launch but with K1)."""
    norms = norms if kernel == "K1" else copied(norms)
    expect = {"K1": 0, "K2": 0, "K3": 0, "K5": 0, **scaled(norms, ranks)}
    expect[kernel] = ranks * calls
    return expect


def cut_models(dev, pipe, seed):
    """FLUX CUT_FLUX and a ControlNet CUT_CN at full width, seeded, remat on:
    the models of the sharded train steps."""
    import dataclasses

    from reptext_tpu_torch.pipelines.txt2img import MODULES, build_module

    flux_cfg = dataclasses.replace(pipe.flux.config, num_layers=CUT_FLUX[0],
                                   num_single_layers=CUT_FLUX[1])
    cn_cfg = dataclasses.replace(pipe.controlnet.config, num_layers=CUT_CN[0],
                                 num_single_layers=CUT_CN[1])
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    flux = build_module(MODULES["flux"], flux_cfg, dev, pipe.compute_dtype, None, gen, remat=True)
    cn = build_module(MODULES["controlnet"], cn_cfg, dev, pipe.compute_dtype, None, gen,
                      remat=True)
    return flux, cn


def tp_train_check(dev, pipe, seed, run_ranks, label, ranks):
    """2 ControlNet train steps at batch 2 (the fixture's batches), FLUX
    CUT_FLUX and ControlNet CUT_CN at full width, AdamW lr 1e-5, remat: on the
    one card, then on every rank of ``run_ranks`` (``ranks`` of them, each
    warm-starting, sharding and stepping its copy under ``mesh=``); each
    step's loss within REF_RTOL of the one card's, step 1's ControlNet
    gradients (gathered over tp) within the K4 limits of the one card's per
    tensor, launches K1 2 and K4 1 per block and step on every rank but FLUX's
    first block's (K1 once, no K4). Returns the sharded run's launches."""
    from reptext_tpu_torch.parallel.partition import ShardedState, shard_module
    from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
    from reptext_tpu_torch.sampling.elastic import step_generator
    from reptext_tpu_torch.sampling.train_controlnet import (
        init_controlnet_training, make_controlnet_train_step,
    )

    flux, cn = cut_models(dev, pipe, seed)
    cut = FluxRepTextPipeline(flux, cn, pipe.vae, pipe.pipe_cfg, clip=pipe.clip, t5=pipe.t5,
                              compute_dtype=pipe.compute_dtype)
    dataset = fixture_dataset(cut, seed)
    batches = [dataset.batch(s) for s in range(2)]
    state0 = {k: v.clone() for k, v in cn.state_dict().items()}
    blocks = sum(CUT_FLUX) + sum(CUT_CN)

    def run(mesh):
        net = cn
        if mesh is not None:          # each rank starts from the same fresh ControlNet
            net = type(cn)(cn.config, device="meta", dtype=pipe.compute_dtype, remat=True)
            net.load_state_dict(state0, assign=True)
            net.to(dev)
        net, opt = init_controlnet_training(flux, net, *CUT_CN, learning_rate=1e-5,
                                            weight_decay=0.01, mesh=mesh)
        base = flux if mesh is None else shard_module(flux, mesh)
        step = make_controlnet_train_step(net, opt, mesh=mesh)
        losses, grads = [], None
        for s, batch in enumerate(batches):
            losses.append(float(step(base, batch, step_generator(seed, s, dev))))
            if s == 0:
                view = None if mesh is None else ShardedState(net, mesh)
                grads = {n: (p.grad if view is None else view.whole(n, p.grad)).float().clone()
                         for n, p in net.named_parameters() if p.grad is not None}
        return losses, grads

    torch.cuda.synchronize()
    reset_train_launches()
    one_losses, one_grads = run(None)
    one_counts = read_train_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    t0 = time.perf_counter()
    outs = run_ranks(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_train_launches()
    # FLUX's first block takes no gradient (nothing trained is upstream of it):
    # it is neither recomputed nor run backward, as in the train phase's 141 and 70
    per_step = {"K1": 2 * blocks - 1, "K2": 0, "K3": 0, "K4": blocks - 1,
                **train_norm_launches(CUT_FLUX, CUT_CN)}
    expect = {k: 2 * ranks * v for k, v in per_step.items()}
    losses, grads = outs[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    worst, fails = 0.0, []
    for name, ref in one_grads.items():
        if not bool(ref.any()):
            continue
        err = (grads[name] - ref).abs()
        rel = err.max().item() / ref.abs().max().item()
        worst = max(worst, rel)
        if rel > GRAD_MAX_RTOL or err.mean().item() > GRAD_MEAN_RTOL * ref.abs().mean().item():
            fails.append(name)
    same = all(o[0] == losses for o in outs[1:])
    ok = (loss_rel <= REF_RTOL and not fails and counts == expect and same
          and one_counts == {k: 2 * v for k, v in per_step.items()})
    phase("tp", f"{label}: 2 ControlNet train steps at batch 2, FLUX {CUT_FLUX[0]} + "
                f"{CUT_FLUX[1]}, ControlNet {CUT_CN[0]} + {CUT_CN[1]}, full width, remat, AdamW "
                f"lr 1e-5: losses {[round(x, 6) for x in losses]} against the one card's "
                f"{[round(x, 6) for x in one_losses]} (max rel {loss_rel:.3e}, tol {REF_RTOL}); "
                f"step 1's nonzero ControlNet gradients, max_abs/max|one card| worst {worst:.3e} "
                f"(limits {GRAD_MAX_RTOL:.4g} max, {GRAD_MEAN_RTOL:.4g} mean; failing {fails}); "
                f"ranks equal {same}; launches "
                + ", ".join(f"{k} {counts[k]} (expected {expect[k]})" for k in sorted(expect))
                + f"; {wall:.3f} s; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB -> {'ok' if ok else 'FAIL'}")
    del cut, dataset, batches, flux, cn
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"the sharded train steps ({label}) failed their checks")
    return counts


def tp_serve_pair(dev, pipe, conds, reqs, emb, pooled, seed, steps, grid, sp, expect, ref,
                  slices):
    """Two 1024^2 requests (pre-encoded prompts: T5 is gone by now) through a
    GenerationServer's worker over the card: one rank, or rank 0 of a thread
    mesh (``grid``) or SP group (``sp`` ranks, ring) whose other ranks follow
    (``serving.follow``); one coalesced batch. Returns (latents, launches)."""
    import threading

    from reptext_tpu_torch.parallel.mesh import LocalMesh
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd
    from reptext_tpu_torch.serving import GenerationRequest, GenerationServer, follow

    table = {r[1]: c for r, c in zip(reqs, conds)}
    captured = {}

    def rank(member):
        view = pipe.with_config(pipe.pipe_cfg)
        group = None
        if sp is not None:
            view.shard_for_sp(member, "ring")
            group = member
        elif grid is not None:
            view.shard_for_inference(member)
            group = member.world
        if group is not None and group.rank != 0:
            follow(group, view)
            return None, None
        real = view.generate_batch

        def generate_batch(*a, **kw):          # the latents, and the sampler's seconds
            timings = {}
            out = real(*a, **dict(kw, output_type="latent", timings=timings))
            captured["latents"], captured["sample"] = out, timings["sample"]
            return view.decode(out)

        view.generate_batch = generate_batch
        server = GenerationServer(view, host="127.0.0.1", port=0, max_batch=2,
                                  batch_window_s=BATCH_WINDOW_S, group=group)
        server.worker.conditions = lambda req, w, h: table[req.lines[0]["text"]]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            sent = [server.worker.submit(GenerationRequest(
                prompt="", lines=[{"text": text, "position": list(pos)}], seed=seed + i,
                num_steps=steps, prompt_embeds=emb[0].float().cpu().numpy(),
                pooled_embeds=pooled[0].float().cpu().numpy()))
                for i, (_, text, pos) in enumerate(reqs)]
            for req in sent:
                req._done.wait(600)
                if req._error:
                    raise SystemExit(f"a served request failed: {req._error}")
            if server.worker.batches != 1:
                raise SystemExit(f"the pair ran as {server.worker.batches} batches, not one")
        finally:
            server.shutdown()
        return captured["latents"], {"sample": captured["sample"]}

    label = "served pair of 1024^2 requests (one batch of 2)"
    if sp is not None:
        ranks = LocalSPGroup(sp, dev)
        label += f", sp{sp} ring"
    elif grid is not None:
        ranks = LocalMesh(*grid, dev, slices=slices)
    if grid is None and sp is None:
        return tp_run(dev, label, None, rank, expect, ref, steps,
                      (2, pipe.pipe_cfg.image_seq_len, 64), None)
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    outs = run_spmd(ranks, rank)
    torch.cuda.synchronize()
    got = read_launches()
    lat = outs[0][0]
    rel = (lat - ref).abs().max().item() / ref.abs().max().item()
    ok = got == expect and rel <= TP_RTOL and bool(torch.isfinite(lat).all())
    phase("tp", f"{label}{'' if grid is None else f', {grid[0]} x {grid[1]} thread ranks'}: "
                f"{time.perf_counter() - t0:.3f} s; launches "
                + ", ".join(f"{k} {got[k]} (expected {expect[k]})" for k in sorted(expect))
                + f"; latents vs one rank's server: max_abs/max|ref| {rel:.3e} (tol {TP_RTOL}) "
                f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the sharded served pair ({label}) failed its checks")
    return lat, got


def tp_phase(dev, steps, cn_steps, seed):
    """Tensor and data parallelism at full width, thread ranks on one card
    (``parallel/mesh.py::LocalMesh``), in a process of its own: the 2 x 2
    ControlNet train steps at cut depth against the one card; then, with the
    prompts encoded once and T5 freed, txt2img 1024^2 under 1 x 2 and (2
    images, one a dp rank) 2 x 2, 1536^2 under 1 x 2 (K3), inpainting at
    1280x960 under 2 x 1 (the CFG halves split over dp) and 1 x 2, and a
    served pair under 1 x 2 and sp2, each against the one card's run on the
    same modules. Returns launches by path."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.parallel.mesh import LocalMesh, SliceCache
    from reptext_tpu_torch.pipelines.inpaint import (
        DEFAULT_NEGATIVE_PROMPT, FluxRepTextInpaintPipeline,
    )
    from reptext_tpu_torch.parallel.testing import run_spmd
    from reptext_tpu_torch.text import pad_to_common_length

    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    args = cli.build_parser().parse_args(
        ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
         str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
         str(font_size), "--random-weights"])
    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    phase("tp", f"pipeline built in {time.perf_counter() - t0:.1f} s (full FLUX.1-dev + RepText "
                f"+ T5-XXL + CLIP-L + VAE, bf16, seeded)")
    launches = {}
    launches["tp_train_2x2"] = tp_train_check(
        dev, pipe, seed, lambda fn: run_spmd(LocalMesh(2, 2, dev), fn), "2 x 2 thread ranks", 4)

    # the prompts encoded once; T5 (9.4 GB) freed for the sharded copies
    clip_ids, t5_ids = cli.request_ids(args, pipe)
    neg_clip, neg_t5 = cli._prompt_ids(args, pipe, DEFAULT_NEGATIVE_PROMPT)
    t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
    clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
    emb, pooled = pipe.encode_prompt(clip_ids, t5_ids)
    neg_emb, neg_pooled = pipe.encode_prompt(neg_clip, neg_t5)
    pipe.t5 = None
    gc.collect()
    torch.cuda.empty_cache()

    gate = min(cn_steps, steps)
    calls = steps * DOUBLE_CALLS + gate * SINGLE_CALLS
    inpaint_calls = steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS
    norms, inpaint_norms = norm_launches(steps, gate), norm_launches(steps, steps + gate)
    slices = SliceCache()                       # one copy of each tp rank's slices
    cond, source = conditions_for(data, name, text, pos, size, font_size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_img = pipe.pipe_cfg.image_seq_len

    def txt2img(run_pipe, images, noise):
        kw = dict(prompt_embeds=emb, pooled_embeds=pooled, seed=seed, num_images=images,
                  latents=noise, output_type="latent", num_inference_steps=steps,
                  guidance_scale=args.guidance_scale)

        def call(mesh):
            timings = {}
            run = run_pipe if mesh is None else run_pipe.with_config(
                run_pipe.pipe_cfg).shard_for_inference(mesh)
            return run(cond_of[run_pipe.pipe_cfg.height], timings=timings, **kw), timings
        return call

    large = np.load(LARGE_FIXTURE)
    cond_of = {size: cond}
    l_text = str(large["txt2img_1536.text"])
    l_pos = tuple(int(v) for v in large["txt2img_1536.position"])
    cond_of[1536], l_source = conditions_for(large, "txt2img_1536", l_text, l_pos, (1536, 1536),
                                             int(large["font_size"]), LARGE_FIXTURE)
    runs = [("txt2img 1024^2", pipe, 1, [(1, 2)], "K1"),
            ("txt2img 1024^2, 2 images", pipe, 2, [(2, 2)], "K1"),
            ("txt2img 1536^2 (S = 9728: K3)",
             pipe.with_config(cli.pipeline_config(args, 1536, 1536)), 1, [(1, 2)], "K3")]
    for label, run_pipe, images, grids, kernel in runs:
        s = run_pipe.pipe_cfg.image_seq_len
        noise = torch.randn((images, s, 64), generator=gen, device=dev)
        call = txt2img(run_pipe, images, noise)
        label = f"{label} (conditions: {source if s == s_img else l_source})"
        ref, launches[f"tp_one_card_{kernel}_{images}x{s}"] = tp_run(
            dev, label, None, call, tp_expect(kernel, calls, norms), None, steps, (images, s, 64),
            slices, HEADS)
        for grid in grids:
            _, launches[f"tp_{grid[0]}x{grid[1]}_{kernel}_{images}x{s}"] = tp_run(
                dev, label, grid, call, tp_expect(kernel, calls, norms, grid[0] * grid[1]), ref,
                steps,
                (images, s, 64), slices, HEADS // grid[1])
        del ref, noise
    # inpainting at 1280x960 (S = 5312: K1) with a seeded inpaint ControlNet
    i_name = "inpaint_1280x960"
    i_text = str(large[f"{i_name}.text"])
    i_pos = tuple(int(v) for v in large[f"{i_name}.position"])
    w, h = (int(v) for v in large[f"{i_name}.size"])
    i_cond, i_source = conditions_for(large, i_name, i_text, i_pos, (w, h),
                                      int(large["font_size"]), LARGE_FIXTURE)
    i_args = cli.build_parser().parse_args(
        ["--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE), "--text", i_text,
         "--position", *map(str, i_pos), "--steps", str(steps), "--controlnet-step",
         str(cn_steps), "--seed", str(seed), "--random-weights"])
    inp = FluxRepTextInpaintPipeline.from_pipeline(
        pipe, seed=seed + 7, pipe_cfg=cli.pipeline_config(i_args, h, w))
    image, mask = source_image(seed, h, w), box_mask(i_cond)
    i_noise = torch.randn((1, inp.pipe_cfg.image_seq_len, 64), generator=gen, device=dev)

    def inpaint_call(mesh):
        timings = {}
        run = inp if mesh is None else inp.with_config(inp.pipe_cfg).shard_for_inference(mesh)
        return run(i_cond, image=image, mask=mask, prompt_embeds=emb, pooled_embeds=pooled,
                   negative_prompt_embeds=neg_emb, negative_pooled_embeds=neg_pooled, seed=seed,
                   latents=i_noise, true_guidance_scale=TRUE_GUIDANCE, num_inference_steps=steps,
                   guidance_scale=i_args.guidance_scale, output_type="latent",
                   timings=timings), timings

    label = (f"inpaint {w}x{h} (S = {TXT_LEN + inp.pipe_cfg.image_seq_len}, CFG batch 2, "
             f"true CFG {TRUE_GUIDANCE}, conditions: {i_source})")
    shape = (1, inp.pipe_cfg.image_seq_len, 64)
    ref, launches["tp_one_card_inpaint"] = tp_run(
        dev, label, None, inpaint_call, tp_expect("K1", inpaint_calls, inpaint_norms), None,
        steps, shape,
        slices, HEADS)
    for grid in ((2, 1), (1, 2)):
        _, launches[f"tp_{grid[0]}x{grid[1]}_inpaint"] = tp_run(
            dev, label, grid, inpaint_call,
            tp_expect("K1", inpaint_calls, inpaint_norms, grid[0] * grid[1]),
            ref, steps, shape, slices, HEADS // grid[1])
    del inp, ref
    torch.cuda.empty_cache()
    # a served pair: one rank, 1 x 2 and sp2
    conds = [conditions_for(data, n_, t_, p_, size, font_size)[0] for n_, t_, p_ in reqs]
    ref, launches["tp_serve_one_rank"] = tp_serve_pair(
        dev, pipe, conds, reqs, emb, pooled, seed, steps, None, None,
        tp_expect("K1", calls, norms), None, slices)
    _, launches["tp_serve_1x2"] = tp_serve_pair(
        dev, pipe, conds, reqs, emb, pooled, seed, steps, (1, 2), None,
        tp_expect("K1", calls, norms, 2), ref, slices)
    sp_exp = {"K1": 0, "K2": 0, "K3": 0, "K5": SP_RANKS * (SP_RANKS + 1) * calls,
              **scaled(copied(norms), SP_RANKS)}
    _, launches["tp_serve_sp2"] = tp_serve_pair(
        dev, pipe, conds, reqs, emb, pooled, seed, steps, None, SP_RANKS, sp_exp, ref, slices)
    return launches


def tp_child(args):
    """tp_phase in a child process of its own (``--tp-worker``), its lines
    passed through; returns its launches by path."""
    cmd = [sys.executable, os.path.abspath(__file__), "--tp-worker", "--steps", str(args.steps),
           "--controlnet-step", str(args.controlnet_step), "--seed", str(args.seed)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    launches = None
    for line in proc.stdout:
        if line.startswith(TP_RESULT):
            launches = json.loads(line[len(TP_RESULT):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or launches is None:
        raise SystemExit(f"the tp phase failed (exit {proc.returncode})")
    return launches


def dist_tp_run(dev, seed=0, steps=2):
    """Tensor parallelism over the cards, one process per card (NCCL), as
    ``--shard 1xN`` runs it: the full pipeline on this card, the 1024^2
    request on this card alone, then shard_for_inference over a 1 x N mesh of
    the cards (cold, warm); then the cut-depth ControlNet train steps on this
    card and over the mesh. A JSON line per run; returns whether all passed."""
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, None, device="cuda")
    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    args = cli.build_parser().parse_args(
        ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
         str(steps), "--controlnet-step", str(steps), "--seed", str(seed), "--font-size",
         str(font_size), "--random-weights"])
    pipe = cli.build_pipeline(args)
    cond, _ = conditions_for(data, name, text, pos, size, font_size)
    clip_ids, t5_ids = cli.request_ids(args, pipe)
    noise = torch.randn((1, pipe.pipe_cfg.image_seq_len, 64),
                        generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    kw = dict(clip_ids=clip_ids, t5_ids=t5_ids, seed=seed, latents=noise, output_type="latent",
              num_inference_steps=steps, guidance_scale=args.guidance_scale)
    calls, ok, ref = steps * (DOUBLE_CALLS + SINGLE_CALLS), True, None
    for sharded, call in ((False, "cold"), (True, "cold"), (True, "warm")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        timings = {}
        run = pipe.with_config(pipe.pipe_cfg).shard_for_inference(mesh) if sharded else pipe
        lat = run(cond, timings=timings, **kw)
        torch.cuda.synchronize()
        got = read_launches()
        ref = lat if not sharded else ref
        rel = (lat - ref).abs().max().item() / ref.abs().max().item()
        run_ok = (got == tp_expect("K1", calls, norm_launches(steps, steps)) and rel <= TP_RTOL
                  and bool(torch.isfinite(lat).all()))
        ok = ok and run_ok
        print(json.dumps({"rank": mesh.rank, "tp": f"1x{mesh.tp}" if sharded else "one card",
                          "call": call, "ms_per_step": 1e3 * timings["sample"] / steps,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": got, "max_abs_vs_one_card": rel, "ok": run_ok}),
              flush=True)
    del run
    # one block's all-reduce alone: [1, 4608, 3072] bf16 over the tp group
    x = torch.randn(1, TXT_LEN + pipe.pipe_cfg.image_seq_len, 3072, device=dev).to(torch.bfloat16)
    ar_ms = cuda_time_ms(lambda: mesh.tp_group.all_reduce_sum(x), repeats=10, warmup=2)[0]
    print(json.dumps({"rank": mesh.rank, "tp_all_reduce_mb": x.numel() * 2 / 1e6,
                      "tp_all_reduce_ms": ar_ms, "calls_per_step": 2 * 19 + 38 + 2 * 4 + 10}),
          flush=True)
    del x
    try:
        counts = tp_train_check(dev, pipe, seed, lambda fn: [fn(mesh)], f"1 x {mesh.tp} cards",
                                1)
        print(json.dumps({"rank": mesh.rank, "tp_train": f"1x{mesh.tp}", "launches": counts,
                          "ok": True}), flush=True)
    except SystemExit as e:
        print(json.dumps({"rank": mesh.rank, "tp_train": f"1x{mesh.tp}", "error": str(e),
                          "ok": False}), flush=True)
        ok = False
    return ok


def fp8_phase(dev, steps, cn_steps, seed):
    """fp8 weight-only storage and the tiled VAE at full width and depth, in
    its own process (``--fp8-worker``), so that its peak memory is its own:
    one 1024^2 request in bf16 (twice: cold, warm), then quantize_weights()
    on the same pipeline and the same request with the same latents= (twice);
    the latents' difference against bf16; enable_vae_tiling() and the same
    latents decoded tiled and untiled at 1024^2, and seeded latents at 2048^2;
    one 1280x960 inpaint request through an inpaint pipeline made from the
    quantized one; a full-width, depth-cut synthetic snapshot converted with
    --dtype fp8, its loaded state bit-equal to quantize_weights() of the bf16
    modules, one 1024^2 request through it; cli.build_pipeline(--random-weights
    --weight-dtype fp8) at full geometry. Returns the launches by path."""
    import dataclasses
    import shutil

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig,
    )
    from reptext_tpu_torch.io import convert as C
    from reptext_tpu_torch.io import convert_cli, synthetic
    from reptext_tpu_torch.io.quantize import quantized_bytes
    from reptext_tpu_torch.models.flux import quantized_copy
    from reptext_tpu_torch.nn.layers import QuantLinear
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
    from reptext_tpu_torch.pipelines.txt2img import MODULES, build_module

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    data, size, font_size, reqs = load_requests()
    name, text, pos = reqs[0]
    base = ["--text", text, "--position", *map(str, pos), "--size", str(size), "--steps",
            str(steps), "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
            str(font_size)]
    args = cli.build_parser().parse_args([*base, "--random-weights"])
    gate = min(cn_steps, steps)
    expect = {"K1": steps * DOUBLE_CALLS + gate * SINGLE_CALLS, "K2": 0, "K3": 0, "K5": 0,
              **norm_launches(steps, gate)}
    launches = {}
    cond, source = conditions_for(data, name, text, pos, size, font_size)
    GiB = 2 ** 30

    t0 = time.perf_counter()
    pipe = cli.build_pipeline(args)
    torch.cuda.synchronize()
    phase("fp8", f"bf16 pipeline built in {time.perf_counter() - t0:.1f} s (FLUX 19 + 38, "
                 f"ControlNet 4 + 10, T5-XXL, CLIP-L, VAE; seeded random weights) [{card}]")
    noise = torch.randn((1, pipe.pipe_cfg.image_seq_len, 64),
                        generator=torch.Generator(device=dev).manual_seed(seed + 5), device=dev)

    def request(label, p, key):
        outs = []
        for run in ("cold", "warm"):
            out = {}
            launches[key] = run_request(
                f"{label} 1024^2, {run} ({name}, conditions: {source}; latents= given)",
                lambda timings: p(cond, clip_ids=ids[0], t5_ids=ids[1], latents=noise,
                                  num_inference_steps=steps, timings=timings,
                                  output_type="latent"),
                p, expect, (1, size, size, 3), steps, tag="fp8", out=out)
            outs.append(out)
        return outs[-1]

    ids = cli.request_ids(args, pipe)
    bf16 = request("bf16", pipe, "fp8_bf16_request")
    before = torch.cuda.memory_allocated()
    dense_bytes = sum(p.numel() * p.element_size() for m in (pipe.flux, pipe.controlnet)
                      for p in m.parameters())
    t0 = time.perf_counter()
    pipe.quantize_weights()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    freed = before - torch.cuda.memory_allocated()
    stored = sum(quantized_bytes(m)[0] for m in (pipe.flux, pipe.controlnet))
    n_quant = sum(isinstance(m, QuantLinear) for mod in (pipe.flux, pipe.controlnet)
                  for m in mod.modules())
    phase("fp8", f"quantize_weights() in {quant_s:.3f} s: {n_quant} Linears of the block stacks "
                 f"to fp8; FLUX + ControlNet {dense_bytes / GiB:.2f} GiB in bf16 -> {stored / GiB:.2f} "
                 f"GiB stored (quantized_bytes); {freed / GiB:.2f} GiB of device memory freed "
                 f"[{card}]")
    fp8 = request("fp8", pipe, "fp8_request")
    rel = float((fp8["latents"] - bf16["latents"]).abs().max()
                / bf16["latents"].abs().max())
    phase("fp8", f"fp8 against bf16, warm: {fp8['ms_step']:.1f} against {bf16['ms_step']:.1f} "
                 f"ms/step ({100 * (fp8['ms_step'] / bf16['ms_step'] - 1):+.1f} %), peak "
                 f"{fp8['peak']:.2f} against {bf16['peak']:.2f} GiB; max|dlatents| / max|latents| "
                 f"{rel:.4f}; image mean {fp8['image'].mean():.2f} against "
                 f"{bf16['image'].mean():.2f} [{card}]")
    if not (n_quant == 494 + 130 and freed > 0 and stored < dense_bytes):
        raise SystemExit("quantize_weights() failed its checks")

    # the tiled VAE: the same latents tiled and untiled at 1024^2, seeded ones at 2048^2
    pipe.enable_vae_tiling()
    ok = True
    for res, packed in ((size, fp8["latents"]), (2 * size, None)):
        tiled = pipe.with_resolution(res, res)
        if packed is None:
            packed = torch.randn((1, tiled.pipe_cfg.image_seq_len, 64), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(seed + 6))
        plain = tiled.with_config(tiled.pipe_cfg)
        plain.vae_tiling = None
        got = {}
        for label, view in (("untiled", plain), ("tiled", tiled), ("untiled", plain),
                            ("tiled", tiled)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            img = view.decode(packed)
            torch.cuda.synchronize()
            got[label] = (img, time.perf_counter() - t0,
                          (torch.cuda.max_memory_allocated() - base_mem) / GiB)
        d = np.abs(got["tiled"][0].astype(int) - got["untiled"][0].astype(int))
        grid = tiled.pipe_cfg.latent_height
        n_tiles = len(range(0, grid - 72, 56)) + 1 if grid > 72 else 1
        phase("fp8", f"VAE decode {res}^2 ({n_tiles} x {n_tiles} tiles of 72 latents, overlap 16): "
                     f"tiled {got['tiled'][1]:.3f} s, its own peak {got['tiled'][2]:.2f} GiB; "
                     f"untiled {got['untiled'][1]:.3f} s, {got['untiled'][2]:.2f} GiB (warm "
                     f"calls); max |tiled - untiled| {d.max()} levels, mean {d.mean():.3f} "
                     f"[{card}]")
        ok = ok and got["tiled"][0].shape == (1, res, res, 3) and d.mean() < 24.0
        del tiled, plain, view, got, img
    if not ok:
        raise SystemExit("the tiled decode failed its checks")

    # the eager dequantization alone, at the block stacks' largest Linear shapes
    rates = []
    for shape in ((12288, 3072), (3072, 15360)):
        layer = next(m for m in pipe.flux.modules() if isinstance(m, QuantLinear)
                     and tuple(m.kernel_q8.shape) == shape)
        ms = cuda_time_ms(layer.dequantized)[0]
        nbytes = shape[0] * shape[1] * 3 + shape[0] * 2      # codes in, bf16 out, scales
        rates.append(shape[0] * shape[1] / ms)
        phase("fp8", f"dequantize one {shape[0]} x {shape[1]} Linear (q.to(bf16) * scale, two "
                     f"kernels): {ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s of its codes in and "
                     f"bf16 out, against {nbytes / 3.35e9:.4f} ms at 3.35 TB/s [{card}]")
    n_flux = sum(m.kernel_q8.numel() for m in pipe.flux.modules() if isinstance(m, QuantLinear))
    n_cn = sum(m.kernel_q8.numel() for m in pipe.controlnet.modules()
               if isinstance(m, QuantLinear))
    per_step = (n_flux + n_cn) / min(rates)
    phase("fp8", f"{n_flux / 1e9:.2f}B + {n_cn / 1e9:.2f}B fp8 weights (FLUX, ControlNet): their "
                 f"dequantization alone is {per_step:.1f} ms of a ControlNet step at the slower "
                 f"rate above, against the {fp8['ms_step'] - bf16['ms_step']:.1f} ms measured")

    # an inpaint request through an inpaint pipeline made from the quantized one
    ldata = np.load(LARGE_FIXTURE)
    iname = "inpaint_1280x960"
    itext, ipos = str(ldata[f"{iname}.text"]), tuple(int(v) for v in ldata[f"{iname}.position"])
    width, height = (int(v) for v in ldata[f"{iname}.size"])
    iargs = cli.build_parser().parse_args(
        ["--mode", "inpaint", "--true-guidance-scale", str(TRUE_GUIDANCE), "--text", itext,
         "--position", *map(str, ipos), "--size", str(width), "--steps", str(steps),
         "--controlnet-step", str(cn_steps), "--seed", str(seed), "--font-size",
         str(int(ldata["font_size"])), "--random-weights"])
    icond, isource = conditions_for(ldata, iname, itext, ipos, (width, height),
                                    int(ldata["font_size"]), LARGE_FIXTURE)
    inp = FluxRepTextInpaintPipeline.from_pipeline(
        pipe, seed=seed + 7, pipe_cfg=cli.pipeline_config(iargs, height, width)).quantize_weights()
    shared = inp.flux is pipe.flux and inp.controlnet is pipe.controlnet
    image, mask = source_image(seed, height, width), box_mask(icond)
    iexpect = dict(expect, K1=steps * (DOUBLE_CALLS + SINGLE_CALLS) + gate * SINGLE_CALLS,
                   **norm_launches(steps, steps + gate))
    launches["fp8_inpaint"] = run_request(
        f"fp8 inpaint {width}x{height} (inpaint ControlNet quantized, FLUX and the RepText net "
        f"shared: {shared}; tiled VAE; conditions: {isource})",
        lambda timings: cli.generate_inpaint(iargs, inp, icond, image, mask, timings=timings,
                                             output_type="latent"),
        inp, iexpect, (1, height, width, 3), steps, tag="fp8")
    if not (shared and inp.inpaint_controlnet.weight_quant):
        raise SystemExit("the fp8 inpaint pipeline does not share the quantized modules")
    del pipe, inp, bf16, fp8, noise
    gc.collect()
    torch.cuda.empty_cache()

    # a full-width, depth-cut snapshot converted with --dtype fp8
    flux_cfg = dataclasses.replace(FluxConfig(), num_layers=CKPT_FLUX[0],
                                   num_single_layers=CKPT_FLUX[1])
    cn_cfg = dataclasses.replace(ControlNetConfig(), num_layers=CKPT_CN[0],
                                 num_single_layers=CKPT_CN[1])
    t5_cfg = dataclasses.replace(T5Config(), num_layers=CKPT_T5)
    work = os.path.join(ROOT, SCRATCH, "fp8")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    snap, out = os.path.join(work, "snapshot"), os.path.join(work, "converted")
    try:
        t0 = time.perf_counter()
        synthetic.write_pipeline_snapshot(os.path.join(snap, "pipeline"), flux_cfg, VAEConfig(),
                                          CLIPConfig(), t5_cfg, seed=seed, device=dev,
                                          dtype=torch.bfloat16)
        synthetic.write_controlnet_snapshot(os.path.join(snap, "controlnet"), cn_cfg,
                                            seed=seed + 1, device=dev, dtype=torch.bfloat16)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = convert_cli.main(["--pipeline-dir", os.path.join(snap, "pipeline"),
                               "--controlnet-dir", os.path.join(snap, "controlnet"),
                               "--dtype", "fp8", "--out", out])
        convert_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
        cargs = cli.build_parser().parse_args([*base, "--checkpoint-dir", out])
        t0 = time.perf_counter()
        cpipe = cli.build_pipeline(cargs)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = True
        for key, ctor_cfg, conv, src in (
                ("flux", flux_cfg, C.convert_flux_transformer, ("pipeline", "transformer")),
                ("controlnet", cn_cfg, C.convert_controlnet, ("controlnet",))):
            tree = conv(C.load_safetensors_state(os.path.join(snap, *src), dtype=None), ctor_cfg)
            dense = build_module(MODULES[key], ctor_cfg, dev, torch.bfloat16, tree)
            want = quantized_copy(dense).state_dict()
            got_state = getattr(cpipe, key).state_dict()
            same = same and sorted(want) == sorted(got_state) and all(
                want[k].dtype == got_state[k].dtype
                and torch.equal(want[k].view(torch.uint8), got_state[k].view(torch.uint8))
                for k in want)
            del tree, dense, want
        cexpect = dict(expect, K1=steps * sum(CKPT_FLUX) + gate * sum(CKPT_CN),
                       **norm_launches(steps, gate, CKPT_FLUX, CKPT_CN))
        launches["fp8_checkpoint"] = run_request(
            f"1024^2 through the fp8 checkpoint (auto-detected: {cpipe.flux.weight_quant}; VAE "
            f"tiling auto: {cpipe.vae_tiling})",
            lambda timings: cli.generate(cargs, cpipe, cond, timings=timings,
                                         output_type="latent"),
            cpipe, cexpect, (1, size, size, 3), steps, tag="fp8")
        phase("fp8", f"synthetic snapshot (FLUX {CKPT_FLUX}, ControlNet {CKPT_CN}, T5-XXL "
                     f"{CKPT_T5} layers, full widths) written in {write_s:.1f} s, converted with "
                     f"--dtype fp8 in {convert_s:.3f} s (exit {rc}, {nbytes / 1e9:.3f} GB), "
                     f"loaded in {load_s:.3f} s; FLUX and ControlNet state bit-equal to "
                     f"quantize_weights() of the bf16 load: {same} [{card}]")
        if not (rc == 0 and same and cpipe.flux.weight_quant and cpipe.vae_tiling):
            raise SystemExit("the fp8 checkpoint failed its checks")
        del cpipe
        gc.collect()
        torch.cuda.empty_cache()
        launches["fp8_checkpoint_ip"] = fp8_checkpoint_ip(
            dev, work, snap, out, flux_cfg, base, cond, cexpect, size, steps, seed, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # --random-weights --weight-dtype fp8 at full geometry: drawn in fp8 storage
    # the build's peak is its own only when nothing of the pipelines above is left
    held = torch.cuda.memory_allocated() / GiB
    if held > 1.0:
        live = {}
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                key = (tuple(obj.shape), str(obj.dtype))
                live[key] = live.get(key, 0) + obj.numel() * obj.element_size()
        top = sorted(live.items(), key=lambda kv: -kv[1])[:6]
        raise SystemExit(f"{held:.2f} GiB still allocated before the fp8 build; largest live "
                         "tensors: " + ", ".join(f"{k} {v / GiB:.2f} GiB" for k, v in top))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rpipe = cli.build_pipeline(cli.build_parser().parse_args(
        [*base, "--random-weights", "--weight-dtype", "fp8"]))
    torch.cuda.synchronize()
    build_s, build_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / GiB
    dense = [n for m in (rpipe.flux, rpipe.controlnet) for n, p in m.named_parameters()
             if n.startswith(("double_blocks", "single_blocks")) and n.endswith(".weight")
             and p.ndim == 2]
    launches["fp8_random"] = run_request(
        "1024^2 through --random-weights --weight-dtype fp8",
        lambda timings: cli.generate(args, rpipe, cond, timings=timings, output_type="latent"),
        rpipe, expect, (1, size, size, 3), steps, tag="fp8")
    phase("fp8", f"cli.build_pipeline(--random-weights --weight-dtype fp8) at full geometry in "
                 f"{build_s:.1f} s, peak {build_peak:.2f} GiB while building ({held:.2f} GiB held "
                 f"before); bf16 Linear weights "
                 f"in the block stacks: {len(dense)}; VAE tiling auto: {rpipe.vae_tiling} [{card}]")
    if dense or not (rpipe.flux.weight_quant and rpipe.controlnet.weight_quant
                     and rpipe.vae_tiling == (72, 16)):
        raise SystemExit("the fp8 random-weights build failed its checks")
    return launches


def fp8_checkpoint_ip(dev, work, snap, out, flux_cfg, base, cond, expect, size, steps, seed,
                      card):
    """The --dtype fp8 snapshot with the IP-Adapter, as the JAX CLI takes one:
    the adapter (published geometry, seeded, converted by convert_cli's
    writer for the cut-depth FLUX) attached to the stored fp8 stacks, then
    quantize_weights() (cli.build_pipeline with --ip-adapter-image and
    --ip-adapter-dir). Its FLUX and ControlNet state bit-equal to the same
    snapshot converted to bf16 with the adapter attached, then
    quantize_weights(); one 1024^2 request through each, latents bit-equal.
    Returns the fp8 request's launches."""
    from PIL import Image

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.configs import CLIPVisionConfig, IPAdapterConfig
    from reptext_tpu_torch.io import convert_cli, synthetic
    from reptext_tpu_torch.io.safetensors import save_file
    from reptext_tpu_torch.nn.layers import QuantLinear

    vcfg, ipcfg = CLIPVisionConfig(), IPAdapterConfig()
    vdir = os.path.join(work, "image_encoder")
    synthetic.write_component(vdir, synthetic.clip_vision_state(
        vcfg, seed=seed + 61, device=dev, dtype=torch.bfloat16),
        synthetic.clip_vision_hf_config(vcfg))
    ip_path = os.path.join(work, "ip-adapter.safetensors")
    save_file(synthetic.ip_adapter_state(ipcfg, flux_cfg.num_layers, flux_cfg.inner_dim,
                                         seed=seed + 62, device=dev, dtype=torch.bfloat16),
              ip_path)
    convert_cli.write_ip_adapter(out, ip_path, flux_cfg.num_layers, flux_cfg.attention_head_dim,
                                 vdir)
    dense_out = os.path.join(work, "converted_bf16")
    rc = convert_cli.main(["--pipeline-dir", os.path.join(snap, "pipeline"), "--controlnet-dir",
                           os.path.join(snap, "controlnet"), "--dtype", "bf16", "--out",
                           dense_out])
    style = os.path.join(work, "style.png")
    Image.fromarray(np.random.default_rng(seed + 63).integers(
        0, 256, (224, 224, 3)).astype(np.uint8)).save(style)
    # the VAE tiled on both (the fp8 deployment's default), so that the condition
    # images encode the same way
    ip_flags = ["--ip-adapter-image", style, "--ip-adapter-scale", str(IP_SCALE),
                "--ip-adapter-dir", os.path.join(out, "ip_adapter"), "--vae-tiling", "on"]
    iargs = cli.build_parser().parse_args([*base, "--checkpoint-dir", out, *ip_flags])
    t0 = time.perf_counter()
    ipipe = cli.build_pipeline(iargs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dargs = cli.build_parser().parse_args([*base, "--checkpoint-dir", dense_out, *ip_flags])
    dense = cli.build_pipeline(dargs)
    stored = dense.flux.weight_quant
    dense.quantize_weights()
    same = True
    for a, b in ((ipipe.flux, dense.flux), (ipipe.controlnet, dense.controlnet)):
        sa, sb = a.state_dict(), b.state_dict()
        same = same and sorted(sa) == sorted(sb) and all(
            sa[k].dtype == sb[k].dtype and torch.equal(sa[k].view(torch.uint8),
                                                       sb[k].view(torch.uint8)) for k in sa)
    adapter_q8 = isinstance(ipipe.flux.double_blocks[0].block.to_k_ip, QuantLinear)
    res = {}
    got = run_request(
        f"1024^2 through the fp8 checkpoint with the IP-Adapter (scale {IP_SCALE})",
        lambda timings: cli.generate(iargs, ipipe, cond, timings=timings, output_type="latent"),
        ipipe, expect, (1, size, size, 3), steps, tag="fp8", out=res)
    want = cli.generate(dargs, dense, cond, output_type="latent")
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(res["latents"], want))
    phase("fp8", f"the fp8 checkpoint with the IP-Adapter (convert_cli's adapter directory for "
                 f"FLUX {CKPT_FLUX}): built in {build_s:.3f} s, the adapter's to_k_ip stored "
                 f"in fp8 {adapter_q8}; FLUX and ControlNet state bit-equal to the bf16 "
                 f"conversion (dense before: {not stored}) with the adapter attached, then "
                 f"quantize_weights(): {same}; the request's latents bit-equal: {bit_equal} "
                 f"[{card}]")
    if not (rc == 0 and same and bit_equal and adapter_q8 and ipipe.flux.ip_adapter
            and not stored):
        raise SystemExit("the fp8 checkpoint with the IP-Adapter failed its checks")
    return got


def fp8_child(args):
    """fp8_phase in a child process of its own (``--fp8-worker``), its lines
    passed through; returns its launches by path."""
    cmd = [sys.executable, os.path.abspath(__file__), "--fp8-worker", "--steps", str(args.steps),
           "--controlnet-step", str(args.controlnet_step), "--seed", str(args.seed)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    launches = None
    for line in proc.stdout:
        if line.startswith(FP8_RESULT):
            launches = json.loads(line[len(FP8_RESULT):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or launches is None:
        raise SystemExit(f"the fp8 phase failed (exit {proc.returncode})")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--controlnet-step", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl-worker", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--fp8-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tp-worker", action="store_true", help=argparse.SUPPRESS)
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
    if args.fp8_worker:
        _build.build()
        launches = fp8_phase(torch.device("cuda", 0), args.steps, args.controlnet_step, args.seed)
        print(FP8_RESULT + json.dumps(launches), flush=True)
        return 0
    if args.tp_worker:
        _build.build()
        launches = tp_phase(torch.device("cuda", 0), args.steps, args.controlnet_step, args.seed)
        print(TP_RESULT + json.dumps(launches), flush=True)
        return 0

    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                    f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    sass = build_phase()

    results = kernel_phase(dev)
    results["K3"] = streaming_kernel_phase(dev)
    results["K4"] = backward_kernel_phase(dev)
    d64 = d64_kernel_phase(dev)
    d32 = d32_kernel_phase(dev)
    tp_heads = tp_kernel_phase(dev)
    results["K5"] = ring_kernel_phase(dev)
    multi_card_phase()
    variants, study_launches = variants_phase(dev, sass)
    library = library_yardsticks(dev)
    results.update(norms_phase(dev))
    joins = joins_phase(dev)
    reference_phase(dev)
    by_path, demo_cache = demo_phase(dev)
    by_path.update(gates_phase(dev, demo_cache))
    shutil.rmtree(os.path.dirname(demo_cache), ignore_errors=True)
    txt2img, pipe, cond = e2e_phase(dev, args.steps, args.controlnet_step, args.seed)
    by_path["txt2img"] = txt2img
    # after e2e, so that e2e's first request is still the process's first
    by_path["checkpoint"] = checkpoint_phase(dev, args.steps, args.controlnet_step, args.seed)
    by_path.update(surface_phase(dev, pipe, args.steps, args.controlnet_step, args.seed))
    large, inp = large_phase(dev, pipe, args.steps, args.controlnet_step, args.seed,
                             args.profile)
    by_path.update(large)
    by_path.update(serve_phase(dev, pipe, inp, args.steps, args.controlnet_step, args.seed))
    union_paths, union = union_phase(dev, pipe, inp, args.steps, args.controlnet_step, args.seed)
    by_path.update(union_paths)
    by_path["multi"] = multi_phase(dev, pipe, union, args.seed)
    del inp
    torch.cuda.empty_cache()
    by_path.update(lora_phase(dev, pipe, args.steps, args.controlnet_step, args.seed))
    by_path["single_file"] = single_file_phase(dev, pipe, args.steps, args.controlnet_step,
                                               args.seed)
    by_path.update(ip_phase(dev, pipe, args.steps, args.controlnet_step, args.seed))
    if args.profile:
        profile_phase(dev, pipe, cond, args.seed)
    # the union net trains first, while the RepText net holds no gradients
    by_path["union_train"] = union_train_phase(dev, pipe, union, args.seed)
    del union
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = train_phase(dev, pipe, args.seed, args.profile)
    ocr_phase(dev)
    by_path["train_ocr"] = train_ocr_phase(dev, pipe, args.seed, args.profile)
    by_path["train_corpus"] = train_corpus_phase(dev, pipe, args.seed)
    by_path["train_joint"] = cut_train_phase(dev, pipe, args.seed, joint=True)
    by_path["train_base"] = cut_train_phase(dev, pipe, args.seed, joint=False)
    train_repeat_phase(dev, pipe, args.seed)
    pipe.controlnet.requires_grad_(False).zero_grad(set_to_none=True)
    pipe.flux.remat = pipe.controlnet.remat = pipe.vae.decoder.remat = False
    by_path.update(sp_phase(dev, pipe, args.seed))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(tiny_phase(dev, args.steps, args.controlnet_step, args.seed))
    # in processes of their own, once this one holds no pipeline
    by_path.update(fp8_child(args))
    by_path.update(tp_child(args))

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
    for key, by_shape in d64.items():
        results[key]["d64"] = by_shape
    for key, by_shape in d32.items():
        results[key]["d32"] = by_shape
    for key, by_shape in tp_heads.items():
        results[key]["tp_heads"] = by_shape
    norm_src = "reptext_tpu_torch/csrc/norms.cu"
    entry["modulate"] = {"name": "modulate", "route": "cuda", "source": norm_src,
                         "replaces": "none: XLA fused reptext_tpu/nn/layers.py::modulate"}
    entry["rms_norm"] = {"name": "rms_norm", "route": "cuda", "source": norm_src,
                         "replaces": "none: XLA fused reptext_tpu/nn/layers.py::RMSNorm"}
    entry["gelu"] = {"name": "gelu_tanh_into", "route": "cuda",
                     "source": "reptext_tpu_torch/csrc/gelu.cu",
                     "replaces": "none: XLA fused reptext_tpu/nn/layers.py::gelu_tanh"}
    results["gelu"] = joins["gelu"]
    results["K1"]["segments"] = joins["K1"]
    for key in entry:
        paths = {path: counts.get(key, 0) for path, counts in by_path.items()}
        entry[key].update({"launches": sum(paths.values()), "launches_by_path": paths})
        entry[key].update(results[key])
    phase("done", f"every phase passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": list(entry.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
