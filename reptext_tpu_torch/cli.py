"""Command line of the PyTorch port: txt2img and ControlNet training.

Usage (random weights; no checkpoints exist in the repository):
    python -m reptext_tpu_torch.cli --text "مرحبا" --position 370 200 \
        --prompt "a street sign in city" --size 1024 --steps 30 \
        --random-weights --output results/result.png
    python -m reptext_tpu_torch.cli --mode train --random-weights --tiny \
        --size 64 --train-steps 3 --batch-size 2

``--tiny`` builds the tiny test geometry in float32 (runs on the CPU); the
full geometry runs in bf16 and needs a CUDA device. The flags keep the JAX
CLI's names and defaults (``reptext_tpu/cli.py``). Prompts become
deterministic demo token ids (a stable CRC32 hash per word; T5 ids padded to
the 512-token budget), since no tokenizer files are in the repository.
:func:`build_pipeline`, :func:`generate` and :func:`train` are the parts of
:func:`main`, for in-process callers. Training checkpoints every block
(``remat``), which the JAX CLI does not: the full geometry needs it to fit
one card.
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
    p = argparse.ArgumentParser(description="RepText txt2img and training, PyTorch + CUDA port")
    p.add_argument("--mode", choices=["txt2img", "inpaint", "serve", "train"],
                   default="txt2img", help="inpaint and serve are not ported yet")
    p.add_argument("--text", action="append",
                   help="txt2img: text line to render (repeatable, required)")
    p.add_argument("--position", action="append", nargs=2, type=int,
                   metavar=("X", "Y"), help="txt2img: top-left position per text line")
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
    p.add_argument("--train-steps", type=int, default=100, help="train: optimization steps")
    p.add_argument("--batch-size", type=int, default=2, help="train: samples per step")
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--text-loss-weight", type=float, default=2.0,
                   help="train: extra loss weight inside text-region tokens")
    p.add_argument("--ocr-loss-weight", type=float, default=0.0,
                   help="train: OCR text-perceptual loss weight (not ported yet; 0 only)")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="train: steps between restore points")
    p.add_argument("--train-dir", default=None,
                   help="train: directory for restore points and controlnet_final.pt "
                        "(omit for in-memory restore points)")
    p.add_argument("--corpus-dir", default=None, help="train on a photo corpus (not ported yet)")
    p.add_argument("--shard", default=None, help="sharded training (not ported yet)")
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
        seed=args.seed, device=device, dtype=dtype, remat=args.mode == "train")


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


def train(args, pipeline, dataset=None, on_event=None):
    """ControlNet training (``--mode train``): warm start from the base, AdamW,
    ``GlyphTextDataset`` batches (or ``dataset``) through a ``PrefetchLoader``
    and the ``ElasticTrainer``. Returns the trainer (its ``losses``)."""
    import torch

    from reptext_tpu_torch.data import GlyphTextDataset, PrefetchLoader
    from reptext_tpu_torch.sampling.elastic import ElasticTrainer
    from reptext_tpu_torch.sampling.train_controlnet import (
        bind_frozen_base, init_controlnet_training, make_controlnet_train_step,
    )

    cn_cfg = pipeline.controlnet.config
    controlnet, optimizer = init_controlnet_training(
        pipeline.flux, pipeline.controlnet, cn_cfg.num_layers, cn_cfg.num_single_layers,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay)
    if dataset is None:
        dataset = GlyphTextDataset(pipeline, batch_size=args.batch_size, font_path=args.font,
                                   seed=args.seed)
    step = make_controlnet_train_step(controlnet, optimizer,
                                      text_loss_weight=args.text_loss_weight)
    loader = PrefetchLoader(dataset.batch, depth=2)  # host build overlaps the device step
    trainer = ElasticTrainer(
        bind_frozen_base(step, pipeline.flux), loader,
        state={"controlnet": controlnet, "optimizer": optimizer}, device=pipeline.device,
        checkpoint_dir=args.train_dir, checkpoint_every=args.checkpoint_every,
        on_event=on_event or (lambda kind, info: print(f"[{kind}] {info}", flush=True)))
    try:
        losses = trainer.run(args.train_steps, seed=args.seed)
    finally:
        loader.close()
    k = max(1, min(10, len(losses) // 4))
    print(f"trained {args.train_steps} steps: loss(first {k} mean)={np.mean(losses[:k]):.4f} "
          f"-> loss(last {k} mean)={np.mean(losses[-k:]):.4f}", flush=True)
    if args.train_dir:
        out = os.path.join(args.train_dir, "controlnet_final.pt")
        torch.save(controlnet.state_dict(), out)
        print(f"saved the trained ControlNet to {out}")
    return trainer


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode in ("inpaint", "serve"):
        raise SystemExit(f"--mode {args.mode} is not ported yet")
    if args.mode == "train":
        for flag, unported in (("--corpus-dir", args.corpus_dir), ("--shard", args.shard),
                               ("--ocr-loss-weight > 0", args.ocr_loss_weight > 0.0)):
            if unported:
                raise SystemExit(f"{flag} is not ported yet")
        train(args, build_pipeline(args))
        return 0
    if not args.text or not args.position:
        parser.error("txt2img needs --text and --position")
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
