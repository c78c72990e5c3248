"""One request of the cell, end to end, in plain PyTorch.

From the token ids on: the T5 and CLIP encodings, the VAE encodes of the
canny and position conditions, the glyph-latent init, the RepText ControlNet
with its region masks, FLUX with the residuals injected, the Euler steps and
the VAE decode. The noise and the posterior samples are drawn from the
request seed as the deployment draws them: the same generators on the same
device, in the dtype the configuration serves, then widened to float32.

``weights`` maps each component (flux, controlnet, vae, clip, t5) to its
flat state dict, in the served dtype, in which each net computes
(``nets.py``); the latents and the Euler steps are float32. ``cfg`` is the
configuration file's dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import host, nets


def prompt_ids(cfg, prompt: str):
    """(CLIP ids, T5 ids) of a prompt, each [1, S]."""
    c, t = cfg["clip"], cfg["t5"]
    clip_ids, t5_ids = host.token_ids(prompt, c["vocab_size"], c["eos_token_id"],
                                      c["max_position_embeddings"], t["vocab_size"],
                                      cfg["pipeline"]["max_sequence_length"])
    return clip_ids, t5_ids


def embed(weights, cfg, clip_ids: np.ndarray, t5_ids: np.ndarray, device):
    """(T5 embeds [1, S, d_model], pooled CLIP [1, D]) of the ids."""
    ids = torch.from_numpy(t5_ids).to(device)
    return (nets.t5(weights["t5"], cfg["t5"], ids),
            nets.clip_pooled(weights["clip"], cfg["clip"], torch.from_numpy(clip_ids).to(device)))


def encode_scaled(weights, cfg, images: torch.Tensor, gen: torch.Generator,
                  noise_dtype: torch.dtype) -> torch.Tensor:
    """A posterior sample of the VAE, shifted and scaled: (z - shift) * scale."""
    v = cfg["vae"]
    mean, logvar = nets.vae_moments(weights["vae"], v, images)
    noise = torch.randn(mean.shape, generator=gen, device=mean.device, dtype=noise_dtype)
    z = mean + torch.exp(0.5 * logvar) * noise.float()
    return (z - v["shift_factor"]) * v["scaling_factor"]


def control_tokens(weights, cfg, cond, gen, noise_dtype, device):
    """RepText's conditions: canny and position latents channel-concatenated
    and packed [1, S, 128]; the region mask resized to the token grid [S, 1]."""
    canny = cond["canny_image"][None]
    pos = np.repeat(cond["position_mask"][:, :, None], 3, axis=2)[None]
    both = encode_scaled(weights, cfg, host.to_unit(np.concatenate([canny, pos]), device),
                         gen, noise_dtype)
    tokens = host.pack(torch.cat([both[:1], both[1:]], 1))
    h2, w2 = both.shape[2] // 2, both.shape[3] // 2
    region = torch.from_numpy(cond["region_mask"].astype(np.float32) / 255.0).to(device)
    return tokens, host.resize_linear(region, h2, w2).reshape(h2 * w2, 1)


def initial_latents(weights, cfg, cond, g_lat, g_glyph, noise_dtype, h, w, device):
    """Packed noise with the glyph-latent init inside the glyph's ink."""
    p = cfg["pipeline"]
    noise = torch.randn((1, cfg["vae"]["latent_channels"], h, w), generator=g_lat,
                        device=device, dtype=torch.float32)
    glyph = encode_scaled(weights, cfg, host.to_unit(cond["glyph_canvas"][None], device),
                          g_glyph, noise_dtype)
    ink = torch.from_numpy(host.ink_mask(cond["glyph_canvas"], h, w)).to(device)[None, None]
    noise = torch.where(ink > 0.5, p["glyph_latent_scale"] * glyph + noise, noise)
    return host.pack(noise)


def decode(weights, cfg, lat: torch.Tensor, h: int, w: int) -> np.ndarray:
    v = cfg["vae"]
    z = host.unpack(lat, h, w) / v["scaling_factor"] + v["shift_factor"]
    return host.to_uint8(nets.vae_decode(weights["vae"], v, z))


def masked_sum(res, mask: torch.Tensor):
    """One text line: each residual times the line's token mask [S, 1], in
    float32, in the residual's dtype."""
    return [(r * mask[None]).to(r.dtype) for r in res]


@torch.no_grad()
def generate(weights: Dict[str, dict], cfg: dict, request: dict, device) -> np.ndarray:
    """The request's uint8 image [1, H, W, 3].

    The served dtype (``cfg["dtype"]``) is also the one in which the
    deployment draws its posterior noise and hands the models their
    timestep, t and then 1000 t (diffusers' FLUX pipelines cast it to the
    latents' dtype); everything else is float32."""
    p = cfg["pipeline"]
    served = getattr(torch, cfg["dtype"])
    height, width = request["height"], request["width"]
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = height // f, width // f
    prompt = host.quoted_prompt(request["prompt"], [request["text"]])
    ctx, pooled = embed(weights, cfg, *prompt_ids(cfg, prompt), device)
    sigmas, timesteps = host.schedule(request["steps"], (h // 2) * (w // 2),
                                      p["base_image_seq_len"], p["max_image_seq_len"],
                                      p["base_shift"], p["max_shift"])
    g_lat, g_cond, g_glyph, _ = host.generators(request["seed"], device)
    cond = request["conditions"]
    cond_tokens, token_mask = control_tokens(weights, cfg, cond, g_cond, served, device)
    lat = initial_latents(weights, cfg, cond, g_lat, g_glyph, served, h, w, device)
    img_ids = host.image_ids(h, w, device)
    txt_ids = torch.zeros((ctx.shape[1], 3), device=device)
    guidance = torch.full((1,), float(request["guidance"]), device=device)
    for i in range(request["steps"]):
        dt = float(np.float32(sigmas[i + 1]) - np.float32(sigmas[i]))
        t = torch.full((1,), float(np.float32(timesteps[i]) / np.float32(1000.0)),
                       device=device, dtype=served)
        doubles, singles = [], []
        if i < request["controlnet_steps"]:
            d, s = nets.controlnet(weights["controlnet"], cfg["controlnet"], lat, cond_tokens,
                                   ctx, pooled, t, img_ids, txt_ids, guidance,
                                   p["controlnet_conditioning_scale"])
            doubles.append(masked_sum(d, token_mask))
            singles.append(masked_sum(s, token_mask))
        v = nets.flux(weights["flux"], cfg["flux"], lat, ctx, pooled, t, img_ids, txt_ids,
                      guidance, doubles, singles)
        lat = lat + dt * v
    return decode(weights, cfg, lat, h, w)
