"""Text inpainting on the port: the flow of the reference's ``infer_inpaint.py``.

Counterpart of ``examples/inpaint.py``: take a photo and a region mask, render
replacement text into the region with the RepText ControlNet while the
inpaint ControlNet keeps the rest of the photo, under true CFG with the
default negative prompt. The pipeline lives on the card unless
``device="cpu"`` is given (``tiny`` goes with the CPU).

Run (seeded random weights, tiny geometry, a synthetic photo):
    python -m reptext_tpu_torch.examples.inpaint --tiny --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np

from reptext_tpu_torch.conditioning import TextLine, build_conditions
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.pipelines import DEFAULT_NEGATIVE_PROMPT, FluxRepTextInpaintPipeline
from reptext_tpu_torch.utils.image import resize_to_multiple


def build_inpaint_pipeline(size: int = 256, steps: int = 4, tiny: bool = False,
                           device: str = "cuda") -> FluxRepTextInpaintPipeline:
    """Both ControlNets and FLUX at ``size``², seeded random weights, on ``device``."""
    mk = (lambda c: c.tiny()) if tiny else (lambda c: c)
    return FluxRepTextInpaintPipeline.create_inpaint(
        # 16-channel masked-image latent + 1-channel mask: 68 packed features
        inpaint_cn_cfg=dataclasses.replace(mk(ControlNetConfig()), extra_condition_channels=4),
        flux_cfg=mk(FluxConfig()), cn_cfg=mk(ControlNetConfig()), vae_cfg=mk(VAEConfig()),
        pipe_cfg=PipelineConfig(height=size, width=size, num_inference_steps=steps,
                                controlnet_conditioning_step=steps),
        clip_cfg=mk(CLIPConfig()), t5_cfg=mk(T5Config()), device=device)


def inpaint_text(pipe: FluxRepTextInpaintPipeline, image: np.ndarray, mask: np.ndarray,
                 text: str, prompt: str, position=(60, 100), font_size: int = 48,
                 seed: int = 42, negative_prompt: str = DEFAULT_NEGATIVE_PROMPT) -> np.ndarray:
    """``text`` edited into ``image`` (uint8 [H, W, 3]) under ``mask`` (uint8
    [H, W], 255 = the region to replace), both resized to the pipeline's
    size: uint8 [H, W, 3]."""
    from PIL import Image

    from reptext_tpu_torch.cli import _tokenize
    from reptext_tpu_torch.text import pad_to_common_length

    h, w = pipe.pipe_cfg.height, pipe.pipe_cfg.width
    image = np.asarray(Image.fromarray(image).resize((w, h)), np.uint8)
    mask = np.asarray(Image.fromarray(mask).resize((w, h)), np.uint8)
    conds = build_conditions([TextLine(text, position, font_size=font_size)], w, h)
    t5_len = pipe.pipe_cfg.max_sequence_length
    clip_ids, t5_ids = _tokenize(f"{prompt}, '{text}'", pipe.clip.config, pipe.t5.config, None,
                                 t5_len)
    neg_clip, neg_t5 = _tokenize(negative_prompt, pipe.clip.config, pipe.t5.config, None, t5_len)
    t5_ids, neg_t5 = pad_to_common_length(t5_ids, neg_t5)
    clip_ids, neg_clip = pad_to_common_length(clip_ids, neg_clip)
    return pipe(conds, image=image, mask=mask, clip_ids=clip_ids, t5_ids=t5_ids,
                negative_clip_ids=neg_clip, negative_t5_ids=neg_t5, seed=seed)[0]


def synthetic_photo(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """A gradient 'photo' with a board, and a mask over the board."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size))
    d = ImageDraw.Draw(img)
    for y in range(size):
        d.line([(0, y), (size, y)], fill=(40 + y // 3, 70 + y // 4, 110))
    board = (size // 5, size // 3, 4 * size // 5, 2 * size // 3)
    d.rectangle(board, fill=(200, 195, 180))
    mask = Image.new("L", (size, size), 0)
    ImageDraw.Draw(mask).rectangle(board, fill=255)
    return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="inpaint_text() on the port")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--output", default="results/example_inpaint.png")
    args = ap.parse_args(argv)
    from PIL import Image

    size = args.size
    photo, mask = synthetic_photo(size)
    # the reference script rounds the sides to multiples of 64
    photo = resize_to_multiple(photo, 64, max_side=size, min_side=64)
    mask = resize_to_multiple(mask, 64, max_side=size, min_side=64)
    pipe = build_inpaint_pipeline(size=size, steps=args.steps, tiny=args.tiny, device=args.device)
    img = inpaint_text(pipe, photo, mask, "مرحبا", "a wooden sign in a park",
                       position=(size // 4, int(size * 0.42)))
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img).save(out)
    print(f"saved {out} ({img.shape})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
