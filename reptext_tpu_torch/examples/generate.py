"""One-call generation on the port: the notebook's ``predict()``.

Counterpart of ``examples/generate.py``: build the pipeline once, call
:func:`predict` many times. The pipeline lives on the card unless
``device="cpu"`` is given (the tiny geometry's head dim of 32 is not one the
attention kernels take, so ``tiny`` goes with the CPU).

Run (seeded random weights, tiny geometry on the CPU):
    python -m reptext_tpu_torch.examples.generate --tiny --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from reptext_tpu_torch.conditioning import TextLine, build_conditions
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.pipelines import FluxRepTextPipeline


def build_pipeline(size: int = 512, steps: int = 20, tiny: bool = False,
                   checkpoint_dir: Optional[str] = None, device: str = "cuda"
                   ) -> FluxRepTextPipeline:
    """The pipeline at ``size``² and ``steps`` steps (the ControlNet on every
    step): the converted checkpoint of ``checkpoint_dir``, or seeded random
    weights; on ``device``."""
    pipe_cfg = PipelineConfig(height=size, width=size, num_inference_steps=steps,
                              controlnet_conditioning_step=steps)
    cfgs = [FluxConfig(), ControlNetConfig(), VAEConfig(), CLIPConfig(), T5Config()]
    if tiny:
        cfgs = [c.tiny() for c in cfgs]
    params = None
    if checkpoint_dir:
        from reptext_tpu_torch.io.checkpoint import load_pipeline_params, load_saved_configs

        params = load_pipeline_params(checkpoint_dir, ("flux", "controlnet", "vae", "clip", "t5"))
        if not tiny:
            saved = load_saved_configs(checkpoint_dir)
            cfgs = [saved.get(name, c) for name, c in
                    zip(("flux", "controlnet", "vae", "clip", "t5"), cfgs)]
    flux_cfg, cn_cfg, vae_cfg, clip_cfg, t5_cfg = cfgs
    return FluxRepTextPipeline.create(flux_cfg, cn_cfg, vae_cfg, pipe_cfg, params=params,
                                      clip_cfg=clip_cfg, t5_cfg=t5_cfg, device=device)


def predict(pipe: FluxRepTextPipeline, text: str, prompt: str, position=(100, 200),
            font_size: int = 60, seed: int = 42) -> np.ndarray:
    """Render ``text`` into a generated image described by ``prompt``: uint8
    [H, W, 3]. Prompts become the CLI's demo token ids (its tokenizers are
    read from a checkpoint directory: use the CLI for those)."""
    from reptext_tpu_torch.cli import _tokenize

    size = pipe.pipe_cfg.width
    conds = build_conditions([TextLine(text, position, font_size=font_size)], size, size)
    clip_ids, t5_ids = _tokenize(f"{prompt}, '{text}'", pipe.clip.config, pipe.t5.config, None,
                                 pipe.pipe_cfg.max_sequence_length)
    return pipe(conds, clip_ids=clip_ids, t5_ids=t5_ids, seed=seed)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="predict() on the port")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--output", default="results/example.png")
    args = ap.parse_args(argv)
    from PIL import Image

    pipe = build_pipeline(size=args.size, steps=args.steps, tiny=args.tiny, device=args.device)
    img = predict(pipe, "مرحبا", "a neon sign on a night street",
                  position=(args.size // 4, int(args.size * 0.4)))
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(out)
    print(f"saved {out} ({img.shape})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
