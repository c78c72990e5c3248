"""The OCR term's backward on the card: which part of it repeats bit for bit.

The OCR training term (``sampling/ocr_loss.py``) runs packed latents through
the VAE decoder (full FLUX geometry, bf16, blocks recomputed), the bilinear
crop (``ops/crop.py``), the judge's convolutions (``eval/ocr.py``) and the
CTC loss. This script runs that chain at 1024^2 and batch 2 on seeded
weights and inputs, forward and backward, twice, and says at each boundary
whether the two runs' gradients are bit-equal: at the judge's logits (the
CTC backward), at its input crops (the judge's), at the decoded images (the
crop's) and at the latents (the decoder's). Then the same with cuDNN held to
deterministic algorithms around both runs (``sampling/ocr_loss.py::
deterministic_convolutions``, as the train step holds it). The first boundary that differs
names the part at fault. Times are CUDA-event medians of one forward and
backward. One JSON line per setting, with the card's name:

    python -m reptext_tpu_torch.benchmarks.ocr_repeat
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess

import torch

BOUNDARIES = ("logits", "crops", "images", "latents")


def build(device, seed: int, size: int = 1024, batch: int = 2):
    """(vae, judge, latents, boxes, labels, paddings) on ``device``."""
    import numpy as np

    from reptext_tpu_torch.configs import VAEConfig
    from reptext_tpu_torch.eval import ocr
    from reptext_tpu_torch.nn.vae import AutoencoderKL
    from reptext_tpu_torch.pipelines.txt2img import build_module
    from reptext_tpu_torch.sampling.ocr_loss import aspect_box

    gen = torch.Generator(device=device).manual_seed(seed)
    vae = build_module(AutoencoderKL, VAEConfig(), device, torch.bfloat16, None, gen, remat=True)
    judge = ocr.load_judge(device=device)
    h = size // 8
    latents = torch.randn((batch, (h // 2) ** 2, 64), generator=gen, device=device)
    boxes = torch.from_numpy(np.stack([aspect_box((300 + 40 * i, 200, 380 + 40 * i, 700),
                                                  size, size) for i in range(batch)]))
    labels = np.zeros((batch, ocr.MAX_LABEL), np.int64)
    paddings = np.ones((batch, ocr.MAX_LABEL), np.float32)
    for i, word in enumerate(["مرحبا", "HELLO"][:batch]):
        ids = ocr.label_ids(word)
        labels[i, :len(ids)] = ids
        paddings[i, :len(ids)] = 0.0
    return (vae, judge, latents, boxes.to(device), torch.from_numpy(labels).to(device),
            torch.from_numpy(paddings).to(device))


def term_grads(vae, judge, latents, boxes, labels, paddings):
    """The OCR term's forward and backward: {boundary: its gradient}."""
    from reptext_tpu_torch.eval.ocr import IMG_H, IMG_W, ctc_losses
    from reptext_tpu_torch.ops.crop import crop_and_resize
    from reptext_tpu_torch.ops.latents import unpack_latents
    from reptext_tpu_torch.sampling.ocr_loss import standardize_crops

    h = int(round((latents.shape[1]) ** 0.5)) * 2
    lat = latents.detach().clone().requires_grad_(True)
    cfg = vae.config
    images = vae.decode(unpack_latents(lat, h, h) / cfg.scaling_factor + cfg.shift_factor)
    images.retain_grad()
    crops = standardize_crops(crop_and_resize(images.float().mean(dim=1, keepdim=True), boxes,
                                              IMG_H, IMG_W))
    crops.retain_grad()
    logits = judge(crops)
    logits.retain_grad()
    nchar = (1.0 - paddings).sum(dim=-1)
    loss = (ctc_losses(logits, labels, paddings) / nchar).mean()
    loss.backward()
    return {"logits": logits.grad, "crops": crops.grad, "images": images.grad,
            "latents": lat.grad}, loss.detach()


def median_ms(fn, repeats: int = 5) -> float:
    fn()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run(seed: int = 0, device="cuda") -> list:
    from reptext_tpu_torch.sampling.ocr_loss import deterministic_convolutions

    inputs = build(torch.device(device), seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    out = []
    for det in (False, True):
        with deterministic_convolutions() if det else contextlib.nullcontext():
            (g1, l1), (g2, l2) = term_grads(*inputs), term_grads(*inputs)
            ms = median_ms(lambda: term_grads(*inputs))
        row = {"deterministic_convolutions": det, "loss_equal": bool(torch.equal(l1, l2)),
               "bit_equal": {k: bool(torch.equal(g1[k], g2[k])) for k in BOUNDARIES},
               "max_abs_diff": {k: float((g1[k].float() - g2[k].float()).abs().max())
                                for k in BOUNDARIES},
               "first_differing": next((k for k in BOUNDARIES
                                        if not torch.equal(g1[k], g2[k])), None),
               "ms": ms, "card": card[0] if card else None}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    run(ap.parse_args(argv).seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
