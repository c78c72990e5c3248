"""RepText text-to-image pipeline (FLUX + ControlNet), PyTorch.

Counterpart of ``reptext_tpu/pipelines/txt2img.py::FluxRepTextPipeline`` on
the path the slice runs: per-line canny / position / region conditioning
encoded through the VAE, CLIP + T5 prompt encoding, the glyph-latent init,
the step-gated, regionally masked ControlNet loop (``sampling/sampler.py``,
with the velocity cache), and the VAE decode, at any size the
``PipelineConfig`` gives (multiples of 16); its encoders also feed the
training data path
(``reptext_tpu_torch/data.py``). Randomness comes from ``torch.Generator``s
derived from ``seed``; there is no global RNG. The JAX package's residency and fp8
staging code exists for a 16 GB chip and has no counterpart here.
:meth:`FluxRepTextPipeline.shard_for_sp` runs the denoise loop
sequence-parallel over an SP group (``parallel/``).
:meth:`FluxRepTextPipeline.generate_batch` puts several requests, each with
its own conditions, prompt and seed, on the batch axis of one sampler call
(serving's coalesced batches, ``serving.py``); :meth:`with_resolution` is a
view at another size over the same modules (serving's resolution buckets).
Weights come from seeded random draws, from Flax-named trees
(``io/convert.py``, the JAX package's trees) or from the port's converted
checkpoint files (``io/checkpoint.py``). ``__call__`` takes the JAX
package's whole call surface but the IP-Adapter: img2img (``init_image``,
``strength``), ``callback``/``callback_steps`` (sampling in chunks, stopped
when the callback returns False), custom ``timesteps``/``sigmas`` and
``return_dict`` (:class:`~reptext_tpu_torch.pipelines.outputs.FluxPipelineOutput`).
The IP-Adapter and tensor parallelism (``shard_for_inference``) are not
ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from reptext_tpu_torch.configs import (
    CLIPConfig,
    ControlNetConfig,
    FluxConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
)
from reptext_tpu_torch.utils.image import postprocess_images, preprocess_images
from reptext_tpu_torch.io.from_jax import load_jax_params
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.nn.clip import CLIPTextEncoder
from reptext_tpu_torch.nn.init import random_init_
from reptext_tpu_torch.nn.t5 import T5Encoder
from reptext_tpu_torch.nn.vae import AutoencoderKL
from reptext_tpu_torch.ops.latents import (
    downsample_region_mask,
    glyph_ink_mask_to_latent,
    glyph_latent_blend,
    pack_latents,
    prepare_latent_image_ids,
    unpack_latents,
)
from reptext_tpu_torch.parallel.group import decide_on_rank0
from reptext_tpu_torch.pipelines.outputs import FluxPipelineOutput, to_pil_images
from reptext_tpu_torch.sampling.flow_match import FlowMatchSchedule, build_schedule
from reptext_tpu_torch.sampling.sampler import make_sp_txt2img_sampler, make_txt2img_sampler


def _as_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long).to(device)


def _normalize_custom_schedule(timesteps, sigmas):
    """Caller timesteps/sigmas -> ("timesteps"|"sigmas", tuple of floats), or
    None; both at once raise as ``build_schedule`` does."""
    if timesteps is None and sigmas is None:
        return None
    if timesteps is not None and sigmas is not None:
        raise ValueError("Only one of `timesteps` or `sigmas` can be passed. "
                         "Please choose one to set custom values")
    if timesteps is not None:
        return ("timesteps", tuple(float(t) for t in np.asarray(timesteps).ravel()))
    return ("sigmas", tuple(float(s) for s in np.asarray(sigmas).ravel()))


# the module class of each pipeline component (and of each converted file)
MODULES = {"flux": FluxTransformer2D, "controlnet": RepTextControlNet,
           "inpaint_controlnet": RepTextControlNet, "vae": AutoencoderKL,
           "clip": CLIPTextEncoder, "t5": T5Encoder}


def is_state_dict(params) -> bool:
    """True for a flat {parameter name: tensor} state dict (the port's
    checkpoint files), False for a nested Flax tree."""
    return (isinstance(params, Mapping) and len(params) > 0
            and all(isinstance(v, torch.Tensor) for v in params.values()))


def build_module(ctor, cfg, device: torch.device, dtype: torch.dtype, params=None,
                 generator: Optional[torch.Generator] = None, **kw) -> torch.nn.Module:
    """``ctor(cfg)`` built on the meta device, then materialised on ``device``
    in ``dtype``: from ``params``, a module state dict (taken over with
    ``load_state_dict(assign=True)``, then moved and cast) or a Flax tree, or
    drawn from ``generator``; frozen."""
    module = ctor(cfg, device="meta", dtype=dtype, **kw)
    if params is not None and is_state_dict(params):
        module.load_state_dict(params, strict=True, assign=True)
        module.to(device=device, dtype=dtype)
    else:
        module.to_empty(device=device)
        if params is None:
            random_init_(module, generator)
        else:
            load_jax_params(module, params)
    return module.eval().requires_grad_(False)


class FluxRepTextPipeline:
    """Holds the modules and exposes the generation entry point."""

    def __init__(self, flux: FluxTransformer2D, controlnet: RepTextControlNet,
                 vae: AutoencoderKL, pipe_cfg: PipelineConfig,
                 clip: Optional[CLIPTextEncoder] = None, t5: Optional[T5Encoder] = None,
                 compute_dtype: torch.dtype = torch.float32):
        self.flux, self.controlnet, self.vae = flux, controlnet, vae
        self.clip, self.t5 = clip, t5
        self.pipe_cfg = pipe_cfg
        self.compute_dtype = compute_dtype
        self.device = next(flux.parameters()).device
        self.sp_group = self.sp_backend = None

    # ---------------------------------------------------------------- build

    @classmethod
    def create(cls, flux_cfg: FluxConfig, cn_cfg: ControlNetConfig, vae_cfg: VAEConfig,
               pipe_cfg: PipelineConfig, params: Optional[Dict[str, Any]] = None,
               clip_cfg: Optional[CLIPConfig] = None, t5_cfg: Optional[T5Config] = None,
               seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
               remat: bool = False) -> "FluxRepTextPipeline":
        """Build the modules on ``device`` in ``dtype``, every one frozen.

        The card unless the caller asks for the CPU (``device="cpu"``); a CUDA
        device on a host without one raises, it never falls back. ``dtype``
        defaults to bf16 on the card and float32 on the CPU.

        With ``params`` (keyed flux / controlnet / vae / clip / t5: Flax trees
        of numpy arrays or torch tensors, carried over by ``load_jax_params``,
        or module state dicts from ``io.checkpoint.load_pipeline_params``,
        taken over as they are) the weights come from there; without, they
        are drawn on the device from one generator seeded with ``seed``.
        Modules are first built on the meta device, so no extra host copy of
        the weights is made. ``remat`` checkpoints the blocks of FLUX,
        the ControlNet and the VAE decoder for training; a training caller
        makes the ControlNet trainable (``init_controlnet_training``).
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is "
                               "False; pass device='cpu' to build on the CPU")
        if dtype is None:
            dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
        cfgs = {"flux": flux_cfg, "controlnet": cn_cfg, "vae": vae_cfg, "clip": clip_cfg,
                 "t5": t5_cfg}
        generator = torch.Generator(device=device).manual_seed(seed) if params is None else None
        built: Dict[str, Optional[torch.nn.Module]] = {}
        for name, cfg in cfgs.items():
            kw = {"remat": remat} if name in ("flux", "controlnet", "vae") else {}
            built[name] = None if cfg is None else build_module(
                MODULES[name], cfg, device, dtype, None if params is None else params[name],
                generator, **kw)
        return cls(built["flux"], built["controlnet"], built["vae"], pipe_cfg,
                   clip=built["clip"], t5=built["t5"], compute_dtype=dtype)

    def with_config(self, pipe_cfg: PipelineConfig) -> "FluxRepTextPipeline":
        """The same pipeline (the same modules, nothing copied) for another
        ``PipelineConfig``, e.g. another image size."""
        clone = copy.copy(self)
        clone.pipe_cfg = pipe_cfg
        return clone

    def with_resolution(self, height: int, width: int) -> "FluxRepTextPipeline":
        """A view at ``height`` x ``width`` over the same modules (serving's
        resolution buckets); both must be multiples of 16 (VAE f=8, 2x2
        packing)."""
        if height % 16 or width % 16:
            raise ValueError(f"height/width must be x16 (VAE f=8, 2x2 packing), "
                             f"got {height}x{width}")
        if (height, width) == (self.pipe_cfg.height, self.pipe_cfg.width):
            return self
        return self.with_config(dataclasses.replace(self.pipe_cfg, height=height, width=width))

    def shard_for_sp(self, group, backend: str = "ring") -> "FluxRepTextPipeline":
        """Sequence-parallel sampling over ``group`` (an ``SPGroup``): the
        image tokens of the denoise loop are sharded over its ranks, and the
        joint attention of every block runs as the K/V ring ('ring') or the
        all-to-all head swap ('ulysses', which needs heads % n == 0).

        Checks what the JAX ``shard_for_sp`` checks, then makes ``__call__``
        use the SP sampler with this backend. The backend belongs to this
        pipeline, as the JAX package gives it to the sharded pipeline's module
        clones: nothing is written into ``self.flux`` or ``self.controlnet``,
        which other pipelines (``with_config`` clones, an inpaint pipeline)
        share and go on using unsharded. Every rank calls the pipeline with
        the same inputs and gets the whole result. Returns self.
        """
        n = group.size
        s_img = self.pipe_cfg.image_seq_len
        if s_img % n:
            raise ValueError(f"image sequence ({s_img} tokens) must divide the sp group ({n})")
        if backend not in ("ring", "ulysses"):
            raise ValueError(f"sp backend must be ring|ulysses, got {backend!r}")
        if backend == "ulysses" and self.flux.config.num_attention_heads % n:
            raise ValueError(f"ulysses needs heads % sp == 0 "
                             f"({self.flux.config.num_attention_heads} % {n})")
        self.sp_group, self.sp_backend = group, backend
        return self

    def generators(self, seed: int) -> Tuple[torch.Generator, ...]:
        """(latent noise, condition posterior, glyph posterior, inpaint
        posterior) generators for ``seed``, the four keys the JAX pipelines
        split; txt2img uses the first three."""
        seeds = np.random.SeedSequence(seed).generate_state(4)
        return tuple(torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds)

    def check_latents(self, latents: torch.Tensor, num_images: int) -> torch.Tensor:
        """Given packed noise, checked against [num_images, S, 4*C], as float32."""
        expect = (num_images, self.pipe_cfg.image_seq_len, 4 * self.vae.config.latent_channels)
        if tuple(latents.shape) != expect:
            raise ValueError(f"latents must be PACKED noise of shape {expect}; "
                             f"got {tuple(latents.shape)}")
        return latents.to(self.device, torch.float32)

    # ------------------------------------------------------------- encoders

    @torch.inference_mode()
    def encode_prompt(self, clip_ids, t5_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """(clip ids [B, <=77], t5 ids [B, <=512]) -> (prompt_embeds, pooled)."""
        if self.clip is None or self.t5 is None:
            raise ValueError("pipeline built without text encoders; pass embeddings directly")
        t5_ids = _as_ids(t5_ids, self.device)
        if t5_ids.shape[1] > self.pipe_cfg.max_sequence_length:
            raise ValueError(f"T5 sequence {t5_ids.shape[1]} exceeds max "
                             f"{self.pipe_cfg.max_sequence_length}")
        _, pooled = self.clip(_as_ids(clip_ids, self.device))
        return self.t5(t5_ids), pooled

    def _encode_scaled(self, images_nchw: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """VAE-encode and apply (x - shift) * scale, in the compute dtype."""
        vcfg = self.vae.config
        lat = self.vae.encode(images_nchw.to(self.compute_dtype), generator)
        return (lat - vcfg.shift_factor) * vcfg.scaling_factor

    def _images(self, nhwc: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(preprocess_images(nhwc)).to(self.device).permute(0, 3, 1, 2)

    @torch.inference_mode()
    def prepare_control_tokens(self, conditions, generator: Optional[torch.Generator]
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conditions -> (cond_tokens [N, S, 2*4*C], token_masks [N, S, 1]).

        Canny and position images of all lines ride one VAE encode; the
        latents are channel-concatenated and 2x2-packed. Region masks are
        resized to the token grid.
        """
        cfg = self.pipe_cfg
        n = conditions.num_lines
        canny = np.stack([lc.canny_image for lc in conditions.lines])
        pos = np.stack([np.repeat(lc.position_mask[:, :, None], 3, axis=2)
                        for lc in conditions.lines])
        both = self._encode_scaled(self._images(np.concatenate([canny, pos])), generator)
        cond_tokens = pack_latents(torch.cat([both[:n], both[n:]], dim=1))
        masks = torch.from_numpy(
            np.stack([lc.region_mask for lc in conditions.lines]).astype(np.float32) / 255.0
        ).to(self.device)
        token_masks = torch.stack([downsample_region_mask(m, cfg.latent_height, cfg.latent_width)
                                   for m in masks])
        return cond_tokens, token_masks

    @torch.inference_mode()
    def prepare_latents(self, generator: Optional[torch.Generator], batch_size: int,
                        glyph_canvas: Optional[np.ndarray] = None,
                        glyph_generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Initial packed latents [B, S, 4*C] with the optional glyph-latent init.

        Inside the glyph ink mask: scale * VAE(glyph canvas) + noise.
        ``noise`` [B, C, h, w] replaces the generator's draw.
        """
        cfg = self.pipe_cfg
        c, h, w = self.vae.config.latent_channels, cfg.latent_height, cfg.latent_width
        if noise is None:
            noise = torch.randn((batch_size, c, h, w), generator=generator,
                                device=self.device, dtype=torch.float32)
        noise = noise.to(self.device, torch.float32)
        if glyph_canvas is not None and cfg.glyph_latent_init:
            glyph_lat = self._encode_scaled(self._images(glyph_canvas), glyph_generator)
            mask = torch.from_numpy(glyph_ink_mask_to_latent(glyph_canvas, h, w)).to(self.device)
            noise = glyph_latent_blend(noise, glyph_lat.expand(noise.shape), mask[None, None],
                                       cfg.glyph_latent_scale)
        return pack_latents(noise)

    def decode_images(self, packed_latents: torch.Tensor) -> torch.Tensor:
        """Packed latents [B, S, 4*C] -> images [B, 3, H, W] in about [-1, 1],
        in the VAE's dtype, differentiable (the OCR training term's decode):
        unpack, undo the latent scaling and shift, decode."""
        cfg, vcfg = self.pipe_cfg, self.vae.config
        lat = unpack_latents(packed_latents, cfg.latent_height, cfg.latent_width)
        return self.vae.decode(lat / vcfg.scaling_factor + vcfg.shift_factor)

    @torch.inference_mode()
    def decode(self, packed_latents: torch.Tensor) -> np.ndarray:
        """Packed latents -> uint8 images [B, H, W, 3]."""
        cfg, vcfg = self.pipe_cfg, self.vae.config
        lat = unpack_latents(packed_latents.to(self.compute_dtype),
                             cfg.latent_height, cfg.latent_width)
        pixels = self.vae.decode(lat / vcfg.scaling_factor + vcfg.shift_factor)
        return postprocess_images(pixels.permute(0, 2, 3, 1).float().cpu().numpy())

    # --------------------------------------------------------------- call

    @torch.inference_mode()
    def __call__(self, conditions, prompt_embeds: Optional[torch.Tensor] = None,
                 pooled_embeds: Optional[torch.Tensor] = None, clip_ids=None, t5_ids=None,
                 seed: int = 42, num_images: int = 1, guidance_scale: Optional[float] = None,
                 num_inference_steps: Optional[int] = None, output_type: str = "np",
                 latents: Optional[torch.Tensor] = None,
                 timings: Optional[Dict[str, float]] = None,
                 init_image: Optional[np.ndarray] = None, strength: float = 1.0,
                 callback: Optional[Callable] = None, callback_steps: int = 1,
                 timesteps=None, sigmas=None, return_dict: bool = False):
        """Generate images; either embeddings or token ids must be given.

        ``output_type``: "np" (uint8 [B, H, W, 3]), "pil" (list of PIL
        images) or "latent" (packed float32 latents); ``return_dict`` wraps
        it in :class:`FluxPipelineOutput`. ``latents``: packed noise
        [num_images, S, 4*C] that replaces the seeded noise and the
        glyph-latent init. ``timings``, when given, receives the seconds of
        each stage (the device is synchronised at stage boundaries).

        ``timesteps``/``sigmas`` (at most one) replace the linspace schedule
        (``build_schedule``); ``num_inference_steps`` then yields to their
        length. ``init_image`` (uint8 [H, W, 3] or [1, H, W, 3]) with
        ``strength`` < 1 is img2img: the image's latent, encoded with the
        glyph generator, is noised to ``sigmas[t0]``, t0 = min(int(steps *
        (1 - strength)), steps - 1), and sampling starts at step t0 from
        there. ``callback(step, latents)`` runs after every ``callback_steps``
        steps with the packed latents (under ``shard_for_sp`` on rank 0 only,
        with the gathered latents); returning False stops sampling there.
        """
        cfg = self.pipe_cfg
        custom = _normalize_custom_schedule(timesteps, sigmas)
        steps = len(custom[1]) if custom is not None else (
            num_inference_steps or cfg.num_inference_steps)
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        if callback is not None and callback_steps < 1:
            raise ValueError(f"callback_steps must be >= 1, got {callback_steps}")
        clock = _StageClock(timings, self.device)

        if prompt_embeds is None:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        prompt_embeds = prompt_embeds.to(self.device)
        pooled_embeds = pooled_embeds.to(self.device)
        if num_images > 1 and prompt_embeds.shape[0] == 1:
            prompt_embeds = prompt_embeds.repeat_interleave(num_images, dim=0)
            pooled_embeds = pooled_embeds.repeat_interleave(num_images, dim=0)
        clock.mark("encode_prompt")

        schedule = self.schedule(steps, custom)
        g_lat, g_cond, g_glyph, _ = self.generators(seed)
        cond_tokens, token_masks = self.prepare_control_tokens(conditions, g_cond)
        if latents is not None:
            latents = self.check_latents(latents, num_images)
        t_start = 0
        if init_image is not None and strength < 1.0:
            t_start = min(int(steps * (1.0 - strength)), steps - 1)
            noise = latents if latents is not None else self.prepare_latents(g_lat, num_images)
            img_lat = self._encode_scaled(self._images(init_image), g_glyph)
            img_packed = pack_latents(img_lat.expand(num_images, *img_lat.shape[1:]))
            latents = schedule.scale_noise(img_packed, noise, t_start)
        elif latents is None:
            latents = self.prepare_latents(g_lat, num_images, conditions.glyph_canvas, g_glyph)
        clock.mark("prepare")
        sample = self._sampler(schedule, cond_tokens, token_masks, prompt_embeds,
                               pooled_embeds, gscale, latents.shape[0])
        if callback is None:
            latents = sample(latents, t_start)
        else:
            i = t_start
            while i < steps:
                k = min(callback_steps, steps - i)
                latents = sample(latents, i, k)
                i += k
                if self._callback_stops(callback, i, latents):
                    break
        clock.mark("sample")
        return self.finish(latents, output_type, clock, return_dict)

    def schedule(self, steps: int, custom=None) -> FlowMatchSchedule:
        """This pipeline's schedule of ``steps`` steps, or of the custom one
        (:func:`_normalize_custom_schedule`'s form)."""
        cfg = self.pipe_cfg
        kw = {} if custom is None else {custom[0]: list(custom[1])}
        return build_schedule(steps, cfg.image_seq_len, cfg.base_image_seq_len,
                              cfg.max_image_seq_len, cfg.base_shift, cfg.max_shift,
                              cfg.use_dynamic_shifting, **kw)

    def _sampler(self, schedule: FlowMatchSchedule, cond_tokens: torch.Tensor,
                 token_masks: torch.Tensor, prompt_embeds: torch.Tensor,
                 pooled_embeds: torch.Tensor, gscale: float, batch: int) -> Callable:
        """``sample(latents, start_step=0, num_steps=None)``: the denoise loop
        over a chunk of ``schedule`` with these conditions and embeds
        (sequence-parallel after ``shard_for_sp``)."""
        cfg = self.pipe_cfg
        if self.sp_group is None:
            sampler = make_txt2img_sampler(self.flux, self.controlnet, schedule, cfg,
                                           self.compute_dtype)
        else:
            sampler = make_sp_txt2img_sampler(self.flux, self.controlnet, schedule, cfg,
                                              self.sp_group, self.sp_backend,
                                              self.compute_dtype)
        img_ids = prepare_latent_image_ids(cfg.latent_height, cfg.latent_width, self.device)
        txt_ids = torch.zeros((prompt_embeds.shape[1], 3), device=self.device)
        guidance = (torch.full((batch,), gscale, dtype=torch.float32, device=self.device)
                    if self.flux.config.guidance_embeds else None)

        def sample(latents: torch.Tensor, start_step: int = 0,
                   num_steps: Optional[int] = None) -> torch.Tensor:
            return sampler(latents, cond_tokens, token_masks, prompt_embeds, pooled_embeds,
                           txt_ids, img_ids, guidance, start_step, num_steps)

        return sample

    def _callback_stops(self, callback: Callable, step: int, latents: torch.Tensor) -> bool:
        """Whether ``callback(step, latents)`` returned False. Under
        ``shard_for_sp`` rank 0 alone calls it (the JAX controller's one call,
        on the gathered latents every rank holds) and every rank takes its
        answer, so all stop at the same step."""
        if self.sp_group is None:
            return callback(step, latents) is False
        return decide_on_rank0(self.sp_group, lambda: callback(step, latents) is False)

    # ------------------------------------------------------- batched serving

    @torch.inference_mode()
    def generate_batch(self, conditions_list: Sequence, clip_ids=None, t5_ids=None,
                       seeds: Sequence[int] = (), guidance_scale: Optional[float] = None,
                       num_inference_steps: Optional[int] = None, output_type: str = "np",
                       ip_adapter_images=None, ip_adapter_scales=None,
                       prompt_embeds: Optional[torch.Tensor] = None,
                       pooled_embeds: Optional[torch.Tensor] = None,
                       timings: Optional[Dict[str, float]] = None):
        """One image per request, B requests in one sampler call.

        Row i has its own conditions, prompt (ids [B, ...] or embeds
        [B, S_txt, D] with pooled [B, D]) and seed; its noise, condition and
        glyph posteriors come from ``self.generators(seeds[i])`` exactly as
        ``__call__`` draws them for that seed, so a request gives the same
        image alone and in a batch (up to the rounding of the batched
        products). The conditions ride the sampler as [N, B, S, F]; all
        requests must share the number of text lines. ``ip_adapter_images``
        with any image fails: no IP-Adapter is ported. Under ``shard_for_sp``
        the batch's tokens are sharded as ``__call__``'s are.
        """
        cfg = self.pipe_cfg
        if ip_adapter_images is not None and any(im is not None for im in ip_adapter_images):
            raise ValueError("ip_adapter_images given but no adapter attached")
        n_lines = {c.num_lines for c in conditions_list}
        if len(n_lines) != 1:
            raise ValueError(f"batch requests must share num_lines, got {n_lines}")
        if (prompt_embeds is None) != (pooled_embeds is None):
            raise ValueError("prompt_embeds and pooled_embeds must be given together")
        pre_encoded = prompt_embeds is not None
        leads = ((prompt_embeds, pooled_embeds) if pre_encoded
                 else (np.asarray(clip_ids), np.asarray(t5_ids)))
        if not len(conditions_list) == len(seeds) == leads[0].shape[0] == leads[1].shape[0]:
            raise ValueError("conditions_list, seeds, and prompt inputs lengths differ")
        steps = num_inference_steps or cfg.num_inference_steps
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        clock = _StageClock(timings, self.device)

        if not pre_encoded:
            prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
        prompt_embeds = prompt_embeds.to(self.device)
        pooled_embeds = pooled_embeds.to(self.device)
        clock.mark("encode_prompt")

        cond_l, mask_l, lat_l = [], [], []
        for conds, seed in zip(conditions_list, seeds):
            g_lat, g_cond, g_glyph, _ = self.generators(int(seed))
            ct, tm = self.prepare_control_tokens(conds, g_cond)
            cond_l.append(ct)
            mask_l.append(tm)
            lat_l.append(self.prepare_latents(g_lat, 1, conds.glyph_canvas, g_glyph))
        cond_tokens = torch.stack(cond_l, dim=1)      # [N, B, S, F] per-image conditions
        token_masks = torch.stack(mask_l, dim=1)      # [N, B, S, 1]
        latents = torch.cat(lat_l, dim=0)             # [B, S, C]
        clock.mark("prepare")
        latents = self._sampler(self.schedule(steps), cond_tokens, token_masks, prompt_embeds,
                                pooled_embeds, gscale, latents.shape[0])(latents)
        clock.mark("sample")
        return self.finish(latents, output_type, clock)

    def finish(self, latents: torch.Tensor, output_type: str, clock: "_StageClock",
               return_dict: bool = False):
        """Sampled latents -> the requested ``output_type``, wrapped in
        :class:`FluxPipelineOutput` with ``return_dict``."""
        if output_type == "latent":
            out = latents
        else:
            out = self.decode(latents)
            clock.mark("decode")
            if output_type == "pil":
                out = to_pil_images(out)
        return FluxPipelineOutput(images=out) if return_dict else out


class _StageClock:
    """Seconds per pipeline stage into ``timings`` (no-op when it is None)."""

    def __init__(self, timings: Optional[Dict[str, float]], device: torch.device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = now - self.t
        self.t = now
