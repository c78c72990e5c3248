"""Command-line txt2img driver of the PyTorch port.

Usage (random weights; no checkpoints exist in the repository):
    python -m reptext_tpu_torch.cli --text "مرحبا" --position 370 200 \
        --prompt "a street sign in city" --size 1024 --steps 30 \
        --random-weights --output results/result.png

``--tiny`` builds the tiny test geometry in float32 (runs on the CPU); the
full geometry runs in bf16 and needs a CUDA device. The flags keep the JAX
CLI's names (``reptext_tpu/cli.py``). Prompts become deterministic demo token
ids (a stable CRC32 hash per word; T5 ids padded to the 512-token budget),
since no tokenizer files are in the repository. :func:`build_pipeline` and
:func:`generate` are the two halves of :func:`main`, for in-process callers.
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib
from typing import Tuple

import numpy as np

# the JAX CLI's default --prompt-suffix (the reference driver's prompt style)
PROMPT_SUFFIX = ", filmfotos, film grain, reversal film photography"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RepText txt2img, PyTorch + CUDA port")
    p.add_argument("--text", action="append", required=True,
                   help="text line to render (repeatable)")
    p.add_argument("--position", action="append", nargs=2, type=int, required=True,
                   metavar=("X", "Y"), help="top-left position per text line (repeatable)")
    p.add_argument("--prompt", default="a street sign in city")
    p.add_argument("--size", type=int, default=1024, help="square image size")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--guidance-scale", type=float, default=3.5)
    p.add_argument("--controlnet-scale", type=float, default=1.0)
    p.add_argument("--controlnet-step", type=int, default=30,
                   help="ControlNet active for the first N steps")
    p.add_argument("--font", default=None, help="TTF font path")
    p.add_argument("--font-size", type=int, default=80)
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (the only weights this port loads yet)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model geometry in float32 on the CPU (demo and tests)")
    p.add_argument("--output", default="results/result.png")
    return p


def make_configs(args):
    """(flux, controlnet, vae, clip, t5, pipeline) configs for the flags."""
    from reptext_tpu.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
    )

    cfgs = [FluxConfig(), ControlNetConfig(), VAEConfig(), CLIPConfig(), T5Config()]
    if args.tiny:
        cfgs = [c.tiny() for c in cfgs]
    pipe_cfg = PipelineConfig(
        height=args.size, width=args.size, num_inference_steps=args.steps,
        guidance_scale=args.guidance_scale,
        controlnet_conditioning_scale=args.controlnet_scale,
        controlnet_conditioning_step=args.controlnet_step,
    )
    return (*cfgs, pipe_cfg)


def build_pipeline(args):
    """The pipeline the flags describe, with seeded random weights: the full
    geometry in bf16 on the CUDA device, or ``--tiny`` in float32 on the CPU
    (its head dim of 32 is not one the attention kernel takes)."""
    import torch

    from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

    if not args.random_weights:
        raise SystemExit("pass --random-weights (no checkpoint loading in this port yet)")
    device = "cpu" if args.tiny else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the full geometry needs a CUDA device; torch.cuda.is_available() "
                         "is False (use --tiny on the CPU)")
    flux_cfg, cn_cfg, vae_cfg, clip_cfg, t5_cfg, pipe_cfg = make_configs(args)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    return FluxRepTextPipeline.create(
        flux_cfg, cn_cfg, vae_cfg, pipe_cfg, clip_cfg=clip_cfg, t5_cfg=t5_cfg,
        seed=args.seed, device=device, dtype=dtype)


def demo_token_ids(prompt: str, clip_cfg, t5_cfg, t5_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic demo ids: CRC32 per word, CLIP ids ending in EOS, T5 ids
    ending in </s> (1) and padded with 0 to ``t5_length``."""
    words = prompt.split()[:16]
    crc = [zlib.crc32(w.encode("utf-8")) for w in words]
    clip = [h % (clip_cfg.vocab_size - 2) + 1 for h in crc] + [clip_cfg.eos_token_id]
    clip = clip[:clip_cfg.max_position_embeddings]
    clip += [0] * (min(16, clip_cfg.max_position_embeddings) - len(clip))
    t5 = [h % (t5_cfg.vocab_size - 2) + 2 for h in crc] + [1]
    t5 += [0] * (t5_length - len(t5))
    return np.asarray([clip], np.int64), np.asarray([t5], np.int64)


def generate(args, pipeline, conditions, timings=None, output_type: str = "np"):
    """One txt2img request: uint8 images [1, H, W, 3] (or ``output_type``)."""
    from reptext_tpu.cli import build_prompt

    prompt = build_prompt(args.prompt, args.text, PROMPT_SUFFIX)
    clip_ids, t5_ids = demo_token_ids(prompt, pipeline.clip.config, pipeline.t5.config,
                                      pipeline.pipe_cfg.max_sequence_length)
    return pipeline(conditions, clip_ids=clip_ids, t5_ids=t5_ids, seed=args.seed,
                    num_inference_steps=args.steps, guidance_scale=args.guidance_scale,
                    output_type=output_type, timings=timings)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if len(args.text) != len(args.position):
        parser.error("--text and --position counts must match")

    from reptext_tpu.conditioning import TextLine, build_conditions

    pipeline = build_pipeline(args)
    lines = [TextLine(t, tuple(p), font_size=args.font_size)
             for t, p in zip(args.text, args.position)]
    conditions = build_conditions(lines, args.size, args.size, font_path=args.font,
                                  font_size=args.font_size)
    images = generate(args, pipeline, conditions)

    from PIL import Image

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    Image.fromarray(images[0]).save(args.output)
    print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
