"""RepText text inpainting pipeline: dual ControlNet + true CFG, PyTorch.

Counterpart of ``reptext_tpu/pipelines/inpaint.py::FluxRepTextInpaintPipeline``:
edits text into an existing image with the RepText ControlNet (glyph
conditions, step-gated, regionally masked) plus an inpainting ControlNet
(masked image + mask, every step), under true classifier-free guidance over a
negative prompt (``sampling/sampler_inpaint.py``). As in the JAX package:

- the masked image sets the pixels under the mask to -1 before the VAE encode;
- the inpaint conditioning is the 16-channel masked-image latent concatenated
  with (1 - mask) nearest-resized to the latent grid: 17 channels, packed to
  68 features a token;
- the embeds are [negative; positive]; the glyph-latent init is on.

:meth:`FluxRepTextInpaintPipeline.from_pipeline` shares FLUX, the RepText
ControlNet, the VAE, CLIP and T5 of a built pipeline and adds only the inpaint
ControlNet (the JAX CLI's tree sharing), so one card holds one FLUX.
:meth:`FluxRepTextInpaintPipeline.generate_batch` runs several requests, each
with its own image, mask, conditions, prompts and seed, in one true-CFG
sampler call (serving's coalesced inpaint batches). ``__call__`` takes custom
``timesteps``/``sigmas`` and ``return_dict`` as the JAX one does (no
img2img or callbacks: the JAX inpaint pipeline has none).
:meth:`~FluxRepTextPipeline.shard_for_sp`, inherited, runs the loop
sequence-parallel (``make_sp_inpaint_sampler``): it writes only this
pipeline's ``sp_group`` and ``sp_backend``, never the modules it shares with
the base, whose inpaint ControlNet reads the thread's SP context as the
other two models do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from reptext_tpu_torch.configs import ControlNetConfig, PipelineConfig
from reptext_tpu_torch.utils.image import preprocess_images
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.ops.latents import pack_latents, prepare_latent_image_ids, resize_nearest
from reptext_tpu_torch.pipelines.txt2img import (
    FluxRepTextPipeline,
    _normalize_custom_schedule,
    _StageClock,
    build_module,
)
from reptext_tpu_torch.sampling.flow_match import FlowMatchSchedule
from reptext_tpu_torch.sampling.sampler_inpaint import (
    make_inpaint_sampler,
    make_sp_inpaint_sampler,
)

# the reference's default negative prompt (reptext_tpu/pipelines/inpaint.py)
DEFAULT_NEGATIVE_PROMPT = (
    "bad quality, worst quality, text, signature, watermark, extra words"
)


def default_inpaint_controlnet_config(base: Optional[ControlNetConfig] = None) -> ControlNetConfig:
    """The FLUX inpainting ControlNet's geometry: ``base`` (default the
    RepText ControlNet's) with 17-channel conditioning, 68 packed features =
    in_channels + 4 extra, and no mode embedding: the inpainting net is never
    a union net, and the samplers give it no mode (the JAX CLI's
    ``replace(cn_cfg, extra_condition_channels=4)`` keeps a union base's
    ``num_mode``, and that net then refuses its mode-less call)."""
    return dataclasses.replace(base or ControlNetConfig(), extra_condition_channels=4,
                               num_mode=None)


class FluxRepTextInpaintPipeline(FluxRepTextPipeline):
    """Text inpainting with the RepText and inpaint ControlNets."""

    def __init__(self, *args, inpaint_controlnet: Optional[RepTextControlNet] = None,
                 inpaint_conditioning_scale: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.inpaint_controlnet = inpaint_controlnet
        self.inpaint_conditioning_scale = inpaint_conditioning_scale

    # ---------------------------------------------------------------- build

    @classmethod
    def from_pipeline(cls, base: FluxRepTextPipeline,
                      inpaint_cn_cfg: Optional[ControlNetConfig] = None,
                      params: Optional[Dict[str, Any]] = None, seed: int = 7,
                      pipe_cfg: Optional[PipelineConfig] = None) -> "FluxRepTextInpaintPipeline":
        """An inpaint pipeline on ``base``'s modules (shared, not copied) plus
        a new inpaint ControlNet: ``params`` (its Flax tree or module state,
        fp8 storage included) or weights drawn on the device from a generator
        seeded with ``seed``. It takes ``base``'s VAE tiling; a quantized base
        gives it quantized FLUX and RepText nets, and its ``quantize_weights``
        then quantizes the inpaint ControlNet alone."""
        cfg = inpaint_cn_cfg or default_inpaint_controlnet_config(base.controlnet.config)
        generator = None if params is not None else torch.Generator(
            device=base.device).manual_seed(seed)
        inpaint_cn = build_module(RepTextControlNet, cfg, base.device, base.compute_dtype,
                                  params, generator)
        pipe = cls(base.flux, base.controlnet, base.vae, pipe_cfg or base.pipe_cfg,
                   clip=base.clip, t5=base.t5, compute_dtype=base.compute_dtype,
                   inpaint_controlnet=inpaint_cn)
        pipe.vae_tiling = base.vae_tiling
        return pipe

    @classmethod
    def create_inpaint(cls, inpaint_cn_cfg: Optional[ControlNetConfig] = None,
                       **kwargs) -> "FluxRepTextInpaintPipeline":
        """``FluxRepTextPipeline.create(**kwargs)`` (on the card unless
        ``device="cpu"``) plus the inpaint ControlNet on the same device
        (``params["inpaint_controlnet"]`` when the trees are given)."""
        base = FluxRepTextPipeline.create(**kwargs)
        params = kwargs.get("params") or {}
        return cls.from_pipeline(base, inpaint_cn_cfg, params.get("inpaint_controlnet"),
                                 seed=kwargs.get("seed", 0) + 7)

    # ------------------------------------------------------------ cond prep

    @torch.inference_mode()
    def prepare_inpaint_cond(self, image: np.ndarray, mask: np.ndarray,
                             generator: Optional[torch.Generator]) -> torch.Tensor:
        """(image uint8 [H, W, 3], mask uint8/float [H, W]) -> packed [1, S, 68]."""
        cfg = self.pipe_cfg
        img = preprocess_images(image)                        # [1, H, W, 3] in [-1, 1]
        m = np.asarray(mask, np.float32)
        if m.max() > 1.0:
            m = m / 255.0
        m = (m > 0.5).astype(np.float32)                      # binarize
        masked = np.where(m[None, :, :, None] > 0.5, np.float32(-1.0), img)
        lat = self._encode_scaled(torch.from_numpy(masked).to(self.device).permute(0, 3, 1, 2),
                                  generator)                  # [1, 16, h, w]
        mlat = 1.0 - resize_nearest(torch.from_numpy(m).to(self.device),
                                    cfg.latent_height, cfg.latent_width)
        cond = torch.cat([lat, mlat.to(lat.dtype).expand(1, 1, *mlat.shape)], dim=1)
        return pack_latents(cond)                             # 17 channels -> 68

    # --------------------------------------------------------------- call

    @torch.inference_mode()
    def __call__(self, conditions, image: Optional[np.ndarray] = None,
                 mask: Optional[np.ndarray] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 pooled_embeds: Optional[torch.Tensor] = None,
                 negative_prompt_embeds: Optional[torch.Tensor] = None,
                 negative_pooled_embeds: Optional[torch.Tensor] = None,
                 clip_ids=None, t5_ids=None, negative_clip_ids=None, negative_t5_ids=None,
                 seed: int = 42, num_images: int = 1, guidance_scale: Optional[float] = None,
                 true_guidance_scale: Optional[float] = None,
                 num_inference_steps: Optional[int] = None, output_type: str = "np",
                 latents: Optional[torch.Tensor] = None,
                 timings: Optional[Dict[str, float]] = None, timesteps=None, sigmas=None,
                 return_dict: bool = False):
        """Edit the text lines of ``conditions`` into ``image`` under ``mask``.

        Either embeddings or token ids for both the prompt and the negative
        prompt (:data:`DEFAULT_NEGATIVE_PROMPT` is the reference's); the two
        must have one sequence length. ``output_type``, ``latents``,
        ``timings``, ``timesteps``/``sigmas`` and ``return_dict`` as in
        :class:`FluxRepTextPipeline`.
        """
        if image is None or mask is None:
            raise ValueError("the inpaint pipeline needs `image` and `mask`")
        cfg = self.pipe_cfg
        custom = _normalize_custom_schedule(timesteps, sigmas)
        steps = len(custom[1]) if custom is not None else (
            num_inference_steps or cfg.num_inference_steps)
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        tscale = cfg.true_guidance_scale if true_guidance_scale is None else true_guidance_scale
        clock = _StageClock(timings, self.device)

        if prompt_embeds is None:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        if negative_prompt_embeds is None:
            if negative_clip_ids is None:
                raise ValueError("provide negative embeddings or negative token ids (the "
                                 f"reference's default negative prompt: "
                                 f"{DEFAULT_NEGATIVE_PROMPT!r})")
            negative_prompt_embeds, negative_pooled_embeds = self.encode_prompt(
                negative_clip_ids, negative_t5_ids)
        embeds = [x.to(self.device) for x in (negative_prompt_embeds, prompt_embeds,
                                              negative_pooled_embeds, pooled_embeds)]
        if num_images > 1 and embeds[1].shape[0] == 1:
            # one prompt, several images: both CFG halves tiled to the batch
            embeds = [x.repeat_interleave(num_images, dim=0) for x in embeds]
        ctx_cfg = torch.cat(embeds[:2])
        pooled_cfg = torch.cat(embeds[2:])
        clock.mark("encode_prompt")

        g_lat, g_cond, g_glyph, g_inp = self.generators(seed)
        cond_tokens, token_masks = self.prepare_control_tokens(conditions, g_cond)
        inpaint_cond = self.prepare_inpaint_cond(image, mask, g_inp)
        if num_images > 1:
            inpaint_cond = inpaint_cond.repeat(num_images, 1, 1)
        if latents is not None:
            latents = self.check_latents(latents, num_images)
        else:
            latents = self.prepare_latents(g_lat, num_images, conditions.glyph_canvas, g_glyph)
        clock.mark("prepare")
        latents = self._sample_inpaint(latents, cond_tokens, token_masks, inpaint_cond, ctx_cfg,
                                       pooled_cfg, self.schedule(steps, custom), gscale, tscale)
        clock.mark("sample")
        return self.finish(latents, output_type, clock, return_dict)

    def _sample_inpaint(self, latents, cond_tokens, token_masks, inpaint_cond, ctx_cfg,
                        pooled_cfg, schedule: FlowMatchSchedule, gscale: float,
                        tscale: float) -> torch.Tensor:
        """The dual-ControlNet true-CFG loop over ``schedule`` (sequence-parallel
        after ``shard_for_sp``)."""
        cfg = dataclasses.replace(self.pipe_cfg, true_guidance_scale=tscale)
        models = (self.flux, self.controlnet, self.inpaint_controlnet, schedule, cfg)
        if self.sp_group is None:
            sampler = make_inpaint_sampler(*models, self.inpaint_conditioning_scale,
                                           self.compute_dtype)
        else:
            sampler = make_sp_inpaint_sampler(*models, self.sp_group, self.sp_backend,
                                              self.inpaint_conditioning_scale,
                                              self.compute_dtype)
        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, self.device)
        txt_ids = torch.zeros((ctx_cfg.shape[1], 3), device=self.device)
        guidance = (torch.full((latents.shape[0],), gscale, dtype=torch.float32,
                               device=self.device)
                    if self.flux.config.guidance_embeds else None)
        return sampler(latents, cond_tokens, token_masks, inpaint_cond, ctx_cfg, pooled_cfg,
                       txt_ids, img_ids, guidance)

    # ------------------------------------------------------- batched serving

    @torch.inference_mode()
    def generate_batch(self, conditions_list: Sequence, images: Sequence[np.ndarray],
                       masks: Sequence[np.ndarray], clip_ids, t5_ids, negative_clip_ids,
                       negative_t5_ids, seeds: Sequence[int],
                       guidance_scale: Optional[float] = None,
                       true_guidance_scale: Optional[float] = None,
                       num_inference_steps: Optional[int] = None, output_type: str = "np",
                       timings: Optional[Dict[str, float]] = None):
        """B inpaint requests in one dual-ControlNet true-CFG sampler call.

        Row i has its own conditions, image, mask, prompt and negative prompt
        ids and seed; its draws come from ``self.generators(seeds[i])`` as in
        ``__call__``. The CFG embeds are [negatives (B); positives (B)] and
        the conditions ride the sampler as [N, B, S, F]; all requests must
        share the number of text lines, the steps and the true-CFG scale.
        Under ``shard_for_sp`` the batch's tokens are sharded as
        ``__call__``'s are.
        """
        cfg = self.pipe_cfg
        n_lines = {c.num_lines for c in conditions_list}
        if len(n_lines) != 1:
            raise ValueError(f"batch requests must share num_lines, got {n_lines}")
        b = len(conditions_list)
        if not (b == len(images) == len(masks) == len(seeds) == np.asarray(clip_ids).shape[0]
                == np.asarray(t5_ids).shape[0]):
            raise ValueError("batch inputs have mismatched lengths")
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        tscale = cfg.true_guidance_scale if true_guidance_scale is None else true_guidance_scale
        clock = _StageClock(timings, self.device)

        prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        neg_embeds, neg_pooled = self.encode_prompt(negative_clip_ids, negative_t5_ids)
        ctx_cfg = torch.cat([neg_embeds, prompt_embeds])
        pooled_cfg = torch.cat([neg_pooled, pooled_embeds])
        clock.mark("encode_prompt")

        cond_l, mask_l, lat_l, inp_l = [], [], [], []
        for conds, image, mask, seed in zip(conditions_list, images, masks, seeds):
            g_lat, g_cond, g_glyph, g_inp = self.generators(int(seed))
            ct, tm = self.prepare_control_tokens(conds, g_cond)
            cond_l.append(ct)
            mask_l.append(tm)
            inp_l.append(self.prepare_inpaint_cond(image, mask, g_inp))
            lat_l.append(self.prepare_latents(g_lat, 1, conds.glyph_canvas, g_glyph))
        clock.mark("prepare")
        latents = self._sample_inpaint(
            torch.cat(lat_l), torch.stack(cond_l, dim=1), torch.stack(mask_l, dim=1),
            torch.cat(inp_l), ctx_cfg, pooled_cfg, self.schedule(steps), gscale, tscale)
        clock.mark("sample")
        return self.finish(latents, output_type, clock)
