"""ControlNet training walkthrough on the port: the RepText training recipe end to end.

Counterpart of ``examples/train_controlnet.py``, at small scale:

1. warm-start the ControlNet from the base transformer (weight surgery,
   ``init_controlnet_training``: AdamW, weight decay on the Linear weights);
2. a deterministic step-indexed batch of packed condition tokens and text
   region masks, as the glyph-conditioning path makes them (render the text,
   canny and position images, VAE-encode, pack: ``pipelines/txt2img.py::
   prepare_control_tokens``);
3. train with the region-weighted flow-matching loss (frozen base, the
   ControlNet's blocks recomputed in the backward) under the
   ``ElasticTrainer`` (restore points, NaN rollback).

The geometry is the tests' tiny FLUX (2 + 4 blocks) and ControlNet (1 + 2)
at head dim 64, the trained-weights demo's (``examples/overfit_e2e.py``),
which the card's attention kernels take as they take the JAX example's
``tiny()`` head dim of 32. Draws come from torch generators: the JAX
example's numbers are not reproduced, its protocol is.

Run: python -m reptext_tpu_torch.examples.train_controlnet [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import torch

from reptext_tpu_torch.examples.overfit_e2e import demo_cn_cfg, demo_flux_cfg
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.nn.init import random_init_
from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
from reptext_tpu_torch.sampling.elastic import ElasticTrainer
from reptext_tpu_torch.sampling.train_controlnet import (
    bind_frozen_base, init_controlnet_training, make_controlnet_train_step,
)

FLUX_CFG = demo_flux_cfg()
CN_CFG = demo_cn_cfg()
B, S_TXT, S_IMG = 2, 4, 16  # an 8 x 8 latent grid, 2 x 2 packed


def synthetic_batch(step: int, device="cpu") -> Dict[str, torch.Tensor]:
    """A deterministic step-indexed batch (the ElasticTrainer replays by step):
    packed latents, condition tokens, a text region over the first half of
    the tokens, prompt embeddings."""
    g = torch.Generator().manual_seed(1000 + step)
    cond_feat = CN_CFG.in_channels + CN_CFG.extra_condition_channels
    mask = torch.zeros(B, S_IMG, 1)
    mask[:, :S_IMG // 2] = 1.0
    batch = {
        "x0": torch.randn(B, S_IMG, FLUX_CFG.in_channels, generator=g),
        "cond_tokens": torch.randn(B, S_IMG, cond_feat, generator=g),
        "token_mask": mask,
        "prompt_embeds": torch.randn(B, S_TXT, FLUX_CFG.joint_attention_dim, generator=g),
        "pooled": torch.randn(B, FLUX_CFG.pooled_projection_dim, generator=g),
        "img_ids": prepare_latent_image_ids(8, 8),
        "txt_ids": torch.zeros(S_TXT, 3),
        "guidance": torch.full((B,), 3.5),
    }
    return {k: v.to(device) for k, v in batch.items()}


def main(num_steps: int = 20, device: str = "cuda") -> List[float]:
    """Train ``num_steps`` steps; returns the losses (the last below the first)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is "
                           "False; pass --device cpu to train on the CPU")
    gen = torch.Generator(device=device).manual_seed(0)
    flux = random_init_(FluxTransformer2D(FLUX_CFG, device=device), gen)
    # remat: gradient checkpointing; the weight surgery below overwrites what
    # the base has, the rest keeps this seeded draw
    cn = random_init_(RepTextControlNet(CN_CFG, device=device, remat=True), gen)
    cn, optimizer = init_controlnet_training(flux, cn, CN_CFG.num_layers,
                                             CN_CFG.num_single_layers, learning_rate=1e-3,
                                             weight_decay=0.01)
    step = make_controlnet_train_step(cn, optimizer, text_loss_weight=2.0)
    trainer = ElasticTrainer(
        bind_frozen_base(step, flux), batch_fn=lambda s: synthetic_batch(s, device),
        state={"controlnet": cn, "optimizer": optimizer}, device=device, checkpoint_every=10,
        on_event=lambda kind, info: print(f"  [{kind}] {info}"))
    losses = trainer.run(num_steps, seed=1)
    print(f"trained {num_steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args()
    main(a.steps, a.device)
    sys.exit(0)
