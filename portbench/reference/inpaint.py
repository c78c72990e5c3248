"""One inpainting request of the cell, end to end, in plain PyTorch.

RepText's ``infer_inpaint.py`` as published: the prompt and the negative
prompt through T5 and CLIP; the RepText conditions (``pipeline.py``); the
photo with the pixels under the mask set to -1, VAE-encoded, beside 1 - mask
resized to the latent grid (nearest): 17 channels, 68 features a token; the
glyph-latent init. Each step runs both ControlNets and FLUX under true
classifier-free guidance over [negative; positive] at batch 2: the RepText
net's residuals times the line's region mask, the inpainting net's as they
are, summed per block as a multi-ControlNet sums them, into FLUX; then
``uncond + s (cond - uncond)`` in float32 and one Euler step. The first
step's velocity is zero (the published inpainting pipeline's first step), so
the latents stay as drawn there. Then the VAE decode.

``weights`` maps flux, controlnet, inpaint_controlnet, vae, clip and t5 to
their flat state dicts in the served dtype, in which each net computes
(``nets.py``); the latents and the guidance are float32. The noise and the
posterior samples come from the request seed's four generators, the
inpainting posterior from the fourth.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import host, nets, pipeline


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output sample of a nearest resize: the sample's
    centre, (i + 0.5) n_in / n_out, floored (float32, as ``jax.image.resize``)."""
    centres = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(centres / np.float32(n_out)).astype(np.int64)


def inpaint_tokens(weights, cfg, image: np.ndarray, mask: np.ndarray, gen, noise_dtype,
                   h: int, w: int, device) -> torch.Tensor:
    """The inpainting net's condition [1, S, 68]: the masked photo's scaled
    posterior sample and 1 - mask on the latent grid, packed."""
    m = np.asarray(mask, np.float32)
    if m.max() > 1.0:
        m = m / 255.0
    m = (m > 0.5).astype(np.float32)
    unit = host.to_unit(np.asarray(image)[None], device)              # [1, 3, H, W]
    masked = torch.where(torch.from_numpy(m).to(device)[None, None] > 0.5,
                         torch.full_like(unit, -1.0), unit)
    lat = pipeline.encode_scaled(weights, cfg, masked, gen, noise_dtype)
    keep = 1.0 - m[nearest_indices(m.shape[0], h)][:, nearest_indices(m.shape[1], w)]
    keep = torch.from_numpy(np.ascontiguousarray(keep)).to(device)[None, None]
    return host.pack(torch.cat([lat, keep.to(lat.dtype)], 1))


def common_length(a: np.ndarray, b: np.ndarray):
    """Two [1, S] id arrays right-padded with 0 to the longer one's length."""
    n = max(a.shape[1], b.shape[1])
    return [np.pad(x, ((0, 0), (0, n - x.shape[1]))) for x in (a, b)]


def summed(a: List[torch.Tensor], b: List[torch.Tensor]) -> List[torch.Tensor]:
    """Two nets' residuals added block by block, in their dtype."""
    if len(a) != len(b):
        raise ValueError(f"the two ControlNets' stacks differ in depth: {len(a)} and {len(b)}")
    return [x + y for x, y in zip(a, b)]


@torch.no_grad()
def generate(weights: Dict[str, dict], cfg: dict, request: dict, device) -> np.ndarray:
    """The request's uint8 image [1, H, W, 3]."""
    p = cfg["pipeline"]
    served = getattr(torch, cfg["dtype"])
    height, width = request["height"], request["width"]
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = height // f, width // f
    prompt = host.quoted_prompt(request["prompt"], [request["text"]])
    neg, pos = (pipeline.prompt_ids(cfg, text) for text in (request["negative_prompt"], prompt))
    # true CFG stacks [negative; positive]: each kind of ids right-padded with 0 to one length
    clip, t5 = (common_length(a, b) for a, b in zip(neg, pos))
    embeds = [pipeline.embed(weights, cfg, clip[k], t5[k], device) for k in range(2)]
    ctx = torch.cat([e[0] for e in embeds])
    pooled = torch.cat([e[1] for e in embeds])
    sigmas, timesteps = host.schedule(request["steps"], (h // 2) * (w // 2),
                                      p["base_image_seq_len"], p["max_image_seq_len"],
                                      p["base_shift"], p["max_shift"])
    g_lat, g_cond, g_glyph, g_inp = host.generators(request["seed"], device)
    cond = request["conditions"]
    cond_tokens, token_mask = pipeline.control_tokens(weights, cfg, cond, g_cond, served, device)
    inp_tokens = inpaint_tokens(weights, cfg, request["image"], request["mask"], g_inp, served,
                                h, w, device)
    lat = pipeline.initial_latents(weights, cfg, cond, g_lat, g_glyph, served, h, w, device)
    img_ids = host.image_ids(h, w, device)
    txt_ids = torch.zeros((ctx.shape[1], 3), device=device)
    guidance = torch.full((2,), float(request["guidance"]), device=device)
    cond2, inp2 = cond_tokens.repeat(2, 1, 1), inp_tokens.repeat(2, 1, 1)
    scale = float(request["true_guidance"])
    for i in range(1, request["steps"]):        # step 0 moves nothing: its velocity is zero
        dt = float(np.float32(sigmas[i + 1]) - np.float32(sigmas[i]))
        t = torch.full((2,), float(np.float32(timesteps[i]) / np.float32(1000.0)),
                       device=device, dtype=served)
        x2 = lat.repeat(2, 1, 1)
        d, s = nets.controlnet(weights["inpaint_controlnet"], cfg["inpaint_controlnet"], x2,
                               inp2, ctx, pooled, t, img_ids, txt_ids, guidance,
                               request["inpaint_scale"])
        if i < request["controlnet_steps"]:
            rd, rs = nets.controlnet(weights["controlnet"], cfg["controlnet"], x2, cond2, ctx,
                                     pooled, t, img_ids, txt_ids, guidance,
                                     p["controlnet_conditioning_scale"])
            d = summed(pipeline.masked_sum(rd, token_mask), d)
            s = summed(pipeline.masked_sum(rs, token_mask), s)
        v2 = nets.flux(weights["flux"], cfg["flux"], x2, ctx, pooled, t, img_ids, txt_ids,
                       guidance, [d], [s]).float()
        v = v2[:1] + scale * (v2[1:] - v2[:1])
        lat = lat + dt * v
    return pipeline.decode(weights, cfg, lat, h, w)
