"""RepText txt2img denoising loop (PyTorch).

Counterpart of ``reptext_tpu/sampling/sampler.py::make_txt2img_sampler``. The
JAX ``lax.scan`` becomes a Python loop over the FlowMatch Euler steps; each
step:

- runs the ControlNet on the text lines stacked on the batch axis
  (line-major: line j, image i at index j * B + i), only on steps where
  :func:`cn_active_mask` allows it (the step gate intersected with the
  ``control_guidance_start/end`` window); gated-off steps skip it entirely;
- multiplies each line's residuals by its regional token mask and sums over
  lines;
- runs the FLUX base with the residuals injected index-on-read;
- advances the float32 latents by one Euler update.

The timestep is built in the compute dtype, so it is rounded to bf16 before
the embedding, as in the JAX sampler. The velocity cache is not ported yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from reptext_tpu.configs import PipelineConfig
from reptext_tpu_torch.sampling.flow_match import FlowMatchSchedule


def cn_active_mask(pipe_cfg: PipelineConfig, num_steps: int, gate_step: int) -> List[bool]:
    """Per-step ControlNet on/off: i < gate_step and i/T >= start and (i+1)/T <= end."""
    idx = np.arange(num_steps)
    keep = ((idx / num_steps >= pipe_cfg.control_guidance_start)
            & ((idx + 1) / num_steps <= pipe_cfg.control_guidance_end))
    return [bool(x) for x in (idx < gate_step) & keep]


def _velocity_cache_enabled(pipe_cfg: PipelineConfig) -> bool:
    return (pipe_cfg.velocity_cache_interval > 1
            or pipe_cfg.velocity_cache_mode in ("adaptive", "adaptive-linear"))


def make_txt2img_sampler(flux: torch.nn.Module, controlnet: torch.nn.Module,
                         schedule: FlowMatchSchedule, pipe_cfg: PipelineConfig,
                         compute_dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``sample(latents, cond_tokens, token_masks, prompt_embeds,
    pooled_embeds, txt_ids, img_ids, guidance) -> latents``.

    latents: [B, S, C] packed (float32 out); cond_tokens [N, S, F] and
    token_masks [N, S, 1] are shared by the B images.
    """
    if _velocity_cache_enabled(pipe_cfg):
        raise NotImplementedError("the velocity cache is not ported yet")
    num_steps = schedule.num_steps
    gate_step = min(pipe_cfg.controlnet_conditioning_step, num_steps)
    cn_active = cn_active_mask(pipe_cfg, num_steps, gate_step)
    cond_scale = pipe_cfg.controlnet_conditioning_scale

    def sample(latents: torch.Tensor, cond_tokens: torch.Tensor, token_masks: torch.Tensor,
               prompt_embeds: torch.Tensor, pooled_embeds: torch.Tensor,
               txt_ids: torch.Tensor, img_ids: torch.Tensor,
               guidance: Optional[torch.Tensor]) -> torch.Tensor:
        b = latents.shape[0]
        n_lines = cond_tokens.shape[0]
        ctx = prompt_embeds.to(compute_dtype)
        pooled = pooled_embeds.to(compute_dtype)
        cond = cond_tokens.repeat_interleave(b, dim=0).to(compute_dtype)
        masks = token_masks[:, None, :, :]                      # [N, 1, S, 1]
        ctx_nb = ctx.repeat(n_lines, 1, 1)
        pooled_nb = pooled.repeat(n_lines, 1)
        guidance_nb = None if guidance is None else guidance.repeat(n_lines)

        def mask_and_sum(res: torch.Tensor) -> torch.Tensor:
            l, _, s, d = res.shape
            res = res.reshape(l, n_lines, b, s, d)
            return (res * masks.to(res.dtype)).sum(dim=1)

        lat = latents.float()
        for i in range(num_steps):
            t_i = float(np.float32(schedule.timesteps[i]) / np.float32(1000.0))
            t_b = torch.full((b,), t_i, dtype=compute_dtype, device=lat.device)
            x_model = lat.to(compute_dtype)
            block_res = single_res = None
            if cn_active[i]:
                block, single = controlnet(
                    x_model.repeat(n_lines, 1, 1), cond, ctx_nb, pooled_nb,
                    t_b.repeat(n_lines), img_ids, txt_ids, guidance_nb, cond_scale)
                block_res, single_res = mask_and_sum(block), mask_and_sum(single)
            velocity = flux(x_model, ctx, pooled, t_b, img_ids, txt_ids, guidance,
                            controlnet_block_samples=block_res,
                            controlnet_single_block_samples=single_res)
            lat = schedule.step(lat, velocity, i)
        return lat

    return sample
