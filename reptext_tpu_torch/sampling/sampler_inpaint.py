"""Inpaint denoising loop: dual ControlNet + true CFG (PyTorch).

Counterpart of ``reptext_tpu/sampling/sampler_inpaint.py::make_inpaint_sampler``.
The JAX ``lax.scan`` becomes a Python loop; each step:

- duplicates the latents for true classifier-free guidance, with embeds
  ``[negative; positive]`` (batch 2B);
- runs the RepText ControlNet (with ``PipelineConfig.control_mode`` when it
  is a union net) on the text lines stacked line-major on the
  batch axis, only where :func:`cn_active_mask` allows, multiplies its
  residuals by each line's region mask and sums over lines;
- runs the inpaint ControlNet on every step, unmasked, at its own scale;
- hands both raw residual stacks to FLUX as a tuple (on a gated-off step the
  inpaint stack alone, where the JAX scan adds a stack of zeros);
- combines ``uncond + s * (cond - uncond)`` in float32;
- through the velocity cache when it is on (``sampler.velocity_cache_select``);
- zeroes the velocity of step 0 after the cache, so a skipped later step
  never reuses the zeroed value;
- advances the float32 latents by one Euler update.

Under a request's span recorder each step is a ``step`` span holding
``controlnet``, ``controlnet_inpaint`` and ``flux`` spans, as in
``sampler.make_txt2img_sampler``.

:func:`make_sp_inpaint_sampler` runs the same loop with the image tokens
sharded over an SP group (the JAX ``shard_map`` over the scan), as
``make_sp_txt2img_sampler`` does for txt2img.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from reptext_tpu_torch.configs import PipelineConfig
from reptext_tpu_torch.parallel.group import SPGroup
from reptext_tpu_torch.parallel.sequence import JOINT_SP_ATTENTION, sp_context
from reptext_tpu_torch.sampling.flow_match import FlowMatchSchedule
from reptext_tpu_torch.sampling.sampler import (
    cn_active_mask, controlnet_mode, empty_cache_regs, shard_tokens, velocity_cache_select,
    velocity_cache_settings,
)
from reptext_tpu_torch.utils.profiling import active_recorder, span


def make_inpaint_sampler(flux: torch.nn.Module, reptext_controlnet: torch.nn.Module,
                         inpaint_controlnet: torch.nn.Module, schedule: FlowMatchSchedule,
                         pipe_cfg: PipelineConfig, inpaint_conditioning_scale: float = 1.0,
                         compute_dtype: torch.dtype = torch.float32,
                         signal_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                         decide: Optional[Callable[[Callable[[], bool]], bool]] = None
                         ) -> Callable:
    """Build ``sample(latents, cond_tokens, token_masks, inpaint_cond,
    prompt_embeds_cfg, pooled_embeds_cfg, txt_ids, img_ids, guidance) -> latents``.

    latents [B, S, C] packed (float32 out); cond_tokens [N, S, F] shared by
    the B images or [N, B, S, F] per image, token_masks [N, S, 1] or
    [N, B, S, 1] to match; inpaint_cond [B, S, F_inpaint]; the embeds [2B, ...]
    ordered [negative; positive]; guidance [B] or None. ``signal_mean`` (the
    JAX ``signal_axis``) and ``decide``: see ``sampler.velocity_cache_select``.
    """
    vc = velocity_cache_settings(pipe_cfg)
    vc_enabled = vc.pop("enabled")
    vc.update(signal_mean=signal_mean, decide=decide)
    num_steps = schedule.num_steps
    cn_active = cn_active_mask(pipe_cfg, num_steps,
                               min(pipe_cfg.controlnet_conditioning_step, num_steps))
    cond_scale = pipe_cfg.controlnet_conditioning_scale
    true_scale = pipe_cfg.true_guidance_scale

    def sample(latents: torch.Tensor, cond_tokens: torch.Tensor, token_masks: torch.Tensor,
               inpaint_cond: torch.Tensor, prompt_embeds_cfg: torch.Tensor,
               pooled_embeds_cfg: torch.Tensor, txt_ids: torch.Tensor, img_ids: torch.Tensor,
               guidance: Optional[torch.Tensor]) -> torch.Tensor:
        b = latents.shape[0]
        n_lines = cond_tokens.shape[0]
        b2 = 2 * b
        ctx = prompt_embeds_cfg.to(compute_dtype)
        pooled = pooled_embeds_cfg.to(compute_dtype)
        guidance2 = None if guidance is None else guidance.repeat(2)
        mode_kw = controlnet_mode(reptext_controlnet, pipe_cfg, n_lines * b2, latents.device)
        if cond_tokens.ndim == 4:
            # per-image conditions, repeated per CFG half in the [lat; lat] order
            cond_rt = cond_tokens.repeat(1, 2, 1, 1).reshape(
                n_lines * b2, *cond_tokens.shape[2:]).to(compute_dtype)
            masks = token_masks.repeat(1, 2, 1, 1)                # [N, 2B, S, 1]
        else:
            cond_rt = cond_tokens.repeat_interleave(b2, dim=0).to(compute_dtype)
            masks = token_masks[:, None]                          # [N, 1, S, 1]
        ctx_n = ctx.repeat(n_lines, 1, 1)
        pooled_n = pooled.repeat(n_lines, 1)
        guidance_n = None if guidance2 is None else guidance2.repeat(n_lines)
        cond_inp = inpaint_cond.repeat(2, 1, 1).to(compute_dtype)

        def mask_and_sum(res: torch.Tensor) -> torch.Tensor:
            l, _, s, d = res.shape
            res = res.reshape(l, n_lines, b2, s, d)
            return (res * masks.to(res.dtype)).sum(dim=1)

        lat = latents.float()
        regs = empty_cache_regs()
        rec = active_recorder()
        for i in range(num_steps):
            with span(rec, "step"):
                t_i = float(np.float32(schedule.timesteps[i]) / np.float32(1000.0))
                t2 = torch.full((b2,), t_i, dtype=compute_dtype, device=lat.device)
                x2 = lat.repeat(2, 1, 1).to(compute_dtype)

                def compute_v_cfg() -> torch.Tensor:
                    blocks, singles = (), ()
                    if cn_active[i]:
                        with span(rec, "controlnet"):
                            block, single = reptext_controlnet(
                                x2.repeat(n_lines, 1, 1), cond_rt, ctx_n, pooled_n,
                                t2.repeat(n_lines), img_ids, txt_ids, guidance_n, cond_scale,
                                **mode_kw)
                        blocks, singles = (mask_and_sum(block),), (mask_and_sum(single),)
                    with span(rec, "controlnet_inpaint"):
                        blk_i, sgl_i = inpaint_controlnet(x2, cond_inp, ctx, pooled, t2, img_ids,
                                                          txt_ids, guidance2,
                                                          inpaint_conditioning_scale)
                    blocks += (blk_i.to(compute_dtype),)
                    singles += (sgl_i.to(compute_dtype),)
                    with span(rec, "flux"):
                        velocity2 = flux(x2, ctx, pooled, t2, img_ids, txt_ids, guidance2,
                                         controlnet_block_samples=blocks,
                                         controlnet_single_block_samples=singles)
                    velocity2 = velocity2.float()
                    v_uncond, v_text = velocity2[:b], velocity2[b:]
                    return v_uncond + true_scale * (v_text - v_uncond)

                if vc_enabled:
                    always = i < vc["vc_warmup"] or i >= num_steps - 1
                    v_cfg, regs = velocity_cache_select(
                        compute_v_cfg, regs, lat, schedule.sigmas[i], i, always, **vc)
                else:
                    v_cfg = compute_v_cfg()
                # step 0: zero velocity (the reference's first step), outside the cache
                v = v_cfg if i > 0 else torch.zeros_like(v_cfg)
                lat = schedule.step(lat, v, i)
        return lat

    return sample


def make_sp_inpaint_sampler(flux: torch.nn.Module, reptext_controlnet: torch.nn.Module,
                            inpaint_controlnet: torch.nn.Module, schedule: FlowMatchSchedule,
                            pipe_cfg: PipelineConfig, group: SPGroup, backend: str,
                            inpaint_conditioning_scale: float = 1.0,
                            compute_dtype: torch.dtype = torch.float32) -> Callable:
    """The inpaint loop with the image tokens sharded over ``group``.

    ``sample`` takes the same global tensors as :func:`make_inpaint_sampler`'s
    on every rank, runs the dual-ControlNet true-CFG loop on the rank's shard
    of the latents, ``inpaint_cond``, the conditions and masks (rank 3 on dim
    1, rank 4 on dim 2, before the loop repeats them per CFG half) and
    ``img_ids`` under the group's SP context with ``backend`` ('ring' |
    'ulysses'), the adaptive cache's drift taken over the group, and returns
    the gathered latents on every rank.
    """
    if backend not in JOINT_SP_ATTENTION:
        raise ValueError(f"the SP sampler needs the backend ring|ulysses, got {backend!r}")
    base = make_inpaint_sampler(flux, reptext_controlnet, inpaint_controlnet, schedule,
                                pipe_cfg, inpaint_conditioning_scale, compute_dtype,
                                signal_mean=group.all_reduce_mean)

    def sample(latents: torch.Tensor, cond_tokens: torch.Tensor, token_masks: torch.Tensor,
               inpaint_cond: torch.Tensor, prompt_embeds_cfg: torch.Tensor,
               pooled_embeds_cfg: torch.Tensor, txt_ids: torch.Tensor, img_ids: torch.Tensor,
               guidance: Optional[torch.Tensor]) -> torch.Tensor:
        with sp_context(group, backend):
            lat = base(group.shard(latents, 1), shard_tokens(group, cond_tokens),
                       shard_tokens(group, token_masks), group.shard(inpaint_cond, 1),
                       prompt_embeds_cfg, pooled_embeds_cfg, txt_ids, group.shard(img_ids, 0),
                       guidance)
        return group.all_gather(lat, 1)

    return sample
