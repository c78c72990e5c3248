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
staging code exists for a 16 GB chip and has no counterpart here; its fp8
weight-only storage (:meth:`FluxRepTextPipeline.quantize_weights`,
``io/quantize.py``) and tiled VAE (:meth:`FluxRepTextPipeline.enable_vae_tiling`,
``ops/vae_tiling.py``) do.
:meth:`FluxRepTextPipeline.shard_for_sp` runs the denoise loop
sequence-parallel over an SP group (``parallel/``).
:meth:`FluxRepTextPipeline.generate_batch` puts several requests, each with
its own conditions, prompt and seed, on the batch axis of one sampler call
(serving's coalesced batches, ``serving.py``); :meth:`with_resolution` is a
view at another size over the same modules (serving's resolution buckets).
Weights come from seeded random draws, from Flax-named trees
(``io/convert.py``, the JAX package's trees) or from the port's converted
checkpoint files (``io/checkpoint.py``). ``__call__`` takes the JAX
package's whole call surface: img2img (``init_image``,
``strength``), ``callback``/``callback_steps`` (sampling in chunks, stopped
when the callback returns False), custom ``timesteps``/``sigmas``,
``return_dict`` (:class:`~reptext_tpu_torch.pipelines.outputs.FluxPipelineOutput`)
and, after :meth:`FluxRepTextPipeline.attach_ip_adapter`, an image prompt
(``ip_adapter_image``, ``ip_adapter_scale``). A union ControlNet takes
``PipelineConfig.control_mode`` (the samplers pass it).
:meth:`FluxRepTextPipeline.shard_for_inference` runs FLUX and the
ControlNet(s) tensor-parallel over a (dp, tp) mesh (``parallel/mesh.py``,
``parallel/partition.py``), their batch rows split over dp.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from reptext_tpu_torch.configs import (
    CLIPConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    FluxConfig,
    IPAdapterConfig,
    PipelineConfig,
    T5Config,
    VAEConfig,
)
from reptext_tpu_torch.utils.image import postprocess_images, preprocess_images
from reptext_tpu_torch.utils.profiling import SpanRecorder, request_trace, stage
from reptext_tpu_torch.io.from_jax import flatten_jax_params, load_jax_params
from reptext_tpu_torch.io.quantize import is_quantized
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D, quantized_copy
from reptext_tpu_torch.models.ip_adapter import ImageProjection, IPAdapterEncoder
from reptext_tpu_torch.nn.clip_vision import CLIPVisionEncoder
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
from reptext_tpu_torch.ops.vae_tiling import tiled_apply
from reptext_tpu_torch.parallel.group import decide_on_rank0
from reptext_tpu_torch.parallel.partition import (
    CONTROLNET_ROW_ARGS, FLUX_ROW_ARGS, DPRows, shard_module,
)
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
    drawn from ``generator``; frozen. ``params`` in fp8 storage (``kernel_q8``
    leaves, ``io/quantize.py``) build the module with ``weight_quant``
    first, but without its ``quantized_by_call`` flag unless the caller asked
    for ``weight_quant``: dense layers (an IP-Adapter's) may still join such
    stacks, and ``quantize_weights()`` quantizes them."""
    stored_fp8 = (params is not None and is_quantized(params)
                  and not kw.get("weight_quant", False))
    if stored_fp8:
        kw = dict(kw, weight_quant=True)
    module = ctor(cfg, device="meta", dtype=dtype, **kw)
    if stored_fp8:
        module.quantized_by_call = False
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
        self.mesh = None            # this rank's (dp, tp) mesh after shard_for_inference
        self.ip_encoder: Optional[IPAdapterEncoder] = None
        # (tile, overlap) in latent units after enable_vae_tiling, else None
        self.vae_tiling: Optional[Tuple[int, int]] = None

    # ---------------------------------------------------------------- build

    @classmethod
    def create(cls, flux_cfg: FluxConfig, cn_cfg: ControlNetConfig, vae_cfg: VAEConfig,
               pipe_cfg: PipelineConfig, params: Optional[Dict[str, Any]] = None,
               clip_cfg: Optional[CLIPConfig] = None, t5_cfg: Optional[T5Config] = None,
               seed: int = 0, device="cuda", dtype: Optional[torch.dtype] = None,
               remat: bool = False, weight_quant: bool = False) -> "FluxRepTextPipeline":
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
        ``weight_quant`` builds FLUX's and the ControlNet's block stacks in fp8
        storage, drawn directly in it when no ``params`` are given (no bf16
        copy of them is made); ``params`` in fp8 storage build them so anyway.
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
            if weight_quant and name in ("flux", "controlnet"):
                kw["weight_quant"] = True
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
        if self.mesh is not None:
            raise ValueError("this pipeline is sharded over a (dp, tp) mesh already: "
                             "shard one way")
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

    def shard_for_inference(self, mesh=None) -> "FluxRepTextPipeline":
        """Tensor and data parallelism over a (dp, tp) mesh: the counterpart
        of the JAX ``shard_for_inference``.

        ``mesh`` is this rank's ``parallel/mesh.py::Mesh`` (default
        ``make_mesh()``: every rank of the job on tp). FLUX, the ControlNet
        and the inpaint ControlNet become this rank's tensor-parallel copies
        (``parallel/partition.py::shard_module``: its heads and features,
        the partial sums reduced over tp in every block); the VAE, CLIP, T5
        and the IP-Adapter's encoder stay whole. The copies are new modules:
        every other pipeline over the old ones (``with_config`` views made
        before, an inpaint pipeline) runs as before, and views made after
        share the copies. Every rank calls the pipeline with the same inputs
        and gets the whole result. The rows of each model call (images x CFG
        halves, x text lines for the ControlNet) split over dp where dp
        divides them, else every dp rank runs them all; the callback and the
        adaptive velocity cache take rank 0's answer. Quantize and attach an
        IP-Adapter first. Returns self."""
        from reptext_tpu_torch.parallel.mesh import make_mesh

        if self.sp_group is not None:
            raise ValueError("this pipeline is sequence-parallel already: shard one way")
        if mesh is None:
            mesh = make_mesh(device=self.device.type)
        self.mesh = mesh
        self.flux = shard_module(self.flux, mesh)
        self.controlnet = shard_module(self.controlnet, mesh)
        if getattr(self, "inpaint_controlnet", None) is not None:
            self.inpaint_controlnet = shard_module(self.inpaint_controlnet, mesh)
        return self

    def _decision_group(self):
        """The ranks that must take one branch together (SP or mesh), or None."""
        return self.sp_group if self.mesh is None else self.mesh.world

    def _decide(self) -> Optional[Callable]:
        """The samplers' ``decide``: rank 0's answer on every rank of a mesh."""
        group = self._decision_group()
        return None if group is None else functools.partial(decide_on_rank0, group)

    def _dp_rows(self, model, row_args):
        """``model``'s calls with their rows split over the mesh's dp group."""
        return model if self.mesh is None else DPRows(model, self.mesh.dp_group, row_args)

    # ------------------------------------------------- fp8 storage, tiled VAE

    def quantize_weights(self) -> "FluxRepTextPipeline":
        """fp8 weight-only storage for this pipeline's FLUX and ControlNet(s)
        (``io/quantize.py``): every Linear of their block stacks keeps e4m3
        codes and per-channel bf16 scales, half the bytes, and dequantizes
        its own weight in its forward; embedders, heads, the VAE and the text
        encoders stay bf16. The quantized modules are new ones
        (``models/flux.py::quantized_copy``): every pipeline that shares the
        bf16 modules (``with_config``/``with_resolution`` views and inpaint
        pipelines made before, a server's views) keeps them, and a pipeline
        derived after this call shares the quantized ones, as the JAX method
        gives this pipeline a new params dict. A model this method made is
        kept. Stacks stored in fp8 (a ``--dtype fp8`` checkpoint) keep their
        codes and scales; only what is still dense there (an IP-Adapter
        attached to them) is quantized, as the JAX ``quantize_params`` is
        idempotent. Attach an IP-Adapter first, and shard after. In place;
        returns self."""
        if self.mesh is not None:
            raise ValueError("quantize_weights() must run BEFORE shard_for_inference()")
        self.flux = quantized_copy(self.flux)
        self.controlnet = quantized_copy(self.controlnet)
        if getattr(self, "inpaint_controlnet", None) is not None:
            self.inpaint_controlnet = quantized_copy(self.inpaint_controlnet)
        return self

    def enable_vae_tiling(self, tile_latent: int = 72,
                          overlap_latent: int = 16) -> "FluxRepTextPipeline":
        """Run VAE encodes and decodes in overlapping tiles
        (``ops/vae_tiling.py``), capping the VAE's activation memory at a
        tile's. ``tile_latent``/``overlap_latent`` are in latent units (x8
        in pixels); an input no larger than a tile takes the untiled path.
        The default 72/16 tiles a 1024^2 image (128^2 latents) 2 x 2. In
        place; returns self."""
        if overlap_latent >= tile_latent:
            raise ValueError(f"overlap ({overlap_latent}) must be < tile ({tile_latent})")
        self.vae_tiling = (int(tile_latent), int(overlap_latent))
        return self

    # ----------------------------------------------------------- ip-adapter

    @torch.no_grad()
    def attach_ip_adapter(self, vision_cfg: Optional[CLIPVisionConfig] = None,
                          ip_cfg: Optional[IPAdapterConfig] = None,
                          params: Optional[Dict[str, Any]] = None,
                          seed: int = 0) -> "FluxRepTextPipeline":
        """Image prompts (the FLUX IP-Adapter) on this pipeline.

        Installs the CLIP vision encoder and the ``ImageProjection`` and gives
        every double block of ``self.flux`` its ``to_k_ip``/``to_v_ip``
        (``nn/blocks.py``), as the JAX method does. ``params`` may carry
        "vision" and "proj" (Flax trees from ``io/convert.py`` or module state
        dicts), and "blocks" (the converter's stacked ``to_k_ip``/``to_v_ip``
        tree, or the ``blocks.safetensors`` state that ``convert_cli`` writes)
        or "flux" (the whole transformer with them). What is missing is
        drawn from ``seed``, with ``to_v_ip`` zero, so an adapter without
        weights is an exact no-op. The FLUX module is shared with the
        pipelines over it (``with_config`` views, an inpaint pipeline), which
        run as before: a block given no ip tokens skips the path.
        """
        if self.mesh is not None:
            raise ValueError("attach_ip_adapter() must run BEFORE shard_for_inference()")
        if self.flux.quantized_by_call:
            # built with weight_quant or quantize_weights() ran: dense adapter
            # kernels would stay dense (stacks stored in fp8 from a checkpoint
            # take them, and quantize_weights() quantizes them after)
            raise ValueError("attach_ip_adapter() must run BEFORE quantize_weights(); attach "
                             "first, then quantize (the adapter kernels are then quantized "
                             "with the rest of the double-block stack)")
        if vision_cfg is None:
            vision_cfg = CLIPVisionConfig()
        if ip_cfg is None:
            ip_cfg = IPAdapterConfig(image_embed_dim=vision_cfg.projection_dim,
                                     cross_attention_dim=self.flux.config.joint_attention_dim)
        params = params or {}
        dtype = self.flux.x_embedder.weight.dtype
        gen = torch.Generator(device=self.device).manual_seed(seed)
        encoder = IPAdapterEncoder(vision_cfg, ip_cfg, device="meta", dtype=dtype)
        encoder.vision = build_module(CLIPVisionEncoder, vision_cfg, self.device, dtype,
                                      params.get("vision"), gen)
        encoder.proj = build_module(ImageProjection, ip_cfg, self.device, dtype,
                                    params.get("proj"), gen)
        if not self.flux.ip_adapter:
            self.flux.add_ip_adapter(ip_cfg.cross_attention_dim)
        weights = dict(self.flux.named_parameters())
        if "flux" in params:
            flux = params["flux"]
            if is_state_dict(flux):
                self.flux.load_state_dict(flux, strict=True)
            else:
                load_jax_params(self.flux, flux)
        else:
            blocks = params.get("blocks")
            if blocks is None:
                # random to_k_ip, zero to_v_ip: the untrained adapter adds 0
                blocks = {}
                for name, p in weights.items():
                    if ".to_k_ip.weight" in name:
                        blocks[name] = torch.randn(p.shape, generator=gen, device=self.device,
                                                   dtype=torch.float32) * p.shape[1] ** -0.5
                    elif "_ip." in name:
                        blocks[name] = torch.zeros(p.shape, device=self.device)
            elif not is_state_dict(blocks):
                blocks = flatten_jax_params(
                    {"double_blocks": {"block": blocks.get("params", blocks)}})
            for name, value in blocks.items():
                if name not in weights or "_ip." not in name:
                    raise KeyError(f"{name} is no IP-Adapter parameter of the transformer")
                if not isinstance(value, torch.Tensor):      # a numpy leaf
                    value = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
                weights[name].copy_(value)
        self.flux.requires_grad_(False)
        self.ip_encoder = encoder.eval().requires_grad_(False)
        return self

    @torch.inference_mode()
    def encode_ip_image(self, image: np.ndarray) -> torch.Tensor:
        """uint8 image [H, W, 3] (or a batch) -> ip tokens [B, N, cross_dim]
        through the attached adapter, in the compute dtype."""
        if self.ip_encoder is None:
            raise ValueError("call attach_ip_adapter() first")
        return self.ip_encoder(image).to(self.compute_dtype)

    def _ip_extra(self, images: Optional[Sequence], scales: Sequence[float]
                  ) -> Optional[Dict[str, torch.Tensor]]:
        """The samplers' ``flux_extra`` for one image prompt per row (None
        where a row has none: zero tokens at scale 0, as the JAX pipeline
        passes with the adapter attached); None without an adapter, which
        refuses a prompt."""
        given = images is not None and any(im is not None for im in images)
        if self.ip_encoder is None:
            if given:
                raise ValueError("ip_adapter_image given but no adapter attached "
                                 "(call attach_ip_adapter() first)")
            return None
        ipc = self.ip_encoder.ip_cfg
        zeros = torch.zeros((1, ipc.num_tokens, ipc.cross_attention_dim),
                            dtype=self.compute_dtype, device=self.device)
        images = images if images is not None else [None] * len(scales)
        tokens = [zeros if im is None else self.encode_ip_image(im) for im in images]
        scale = [0.0 if im is None else float(s) for im, s in zip(images, scales)]
        # one row: a scalar scale, as ``__call__``'s; a batch: one scale per row
        return {"ip_tokens": torch.cat(tokens, dim=0),
                "ip_scale": torch.tensor(scale if len(scale) > 1 else scale[0],
                                         dtype=torch.float32, device=self.device)}

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
        """VAE-encode and apply (x - shift) * scale, in the compute dtype;
        after :meth:`enable_vae_tiling`, an image larger than a tile is
        encoded in tiles (float32, as the JAX pipeline's), 4 images at a time,
        ``generator`` drawing once per tile in tile order."""
        vcfg = self.vae.config
        images = images_nchw.to(self.compute_dtype)
        tiling, f = self.vae_tiling, vcfg.scale_factor
        if tiling is not None and max(images.shape[2:]) > f * tiling[0]:
            def tile_fn(tile, _index):
                return self.vae.encode(tile, generator)

            lat = torch.cat([tiled_apply(tile_fn, images[i:i + 4], f * tiling[0], f * tiling[1],
                                         1, f, vcfg.latent_channels)
                             for i in range(0, images.shape[0], 4)])
        else:
            lat = self.vae.encode(images, generator)
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

    def _decode_unpacked(self, lat: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, C, h, w] -> pixels [B, 3, H, W]: undo the
        latent scaling and shift, decode; after :meth:`enable_vae_tiling`, a
        grid larger than a tile is decoded in tiles (float32; a failed tile
        raises, nothing is retried untiled)."""
        vcfg = self.vae.config

        def run(z, _index=0):
            return self.vae.decode(z / vcfg.scaling_factor + vcfg.shift_factor)

        tiling = self.vae_tiling
        if tiling is not None and max(lat.shape[2:]) > tiling[0]:
            return tiled_apply(run, lat, tiling[0], tiling[1], vcfg.scale_factor, 1,
                               vcfg.out_channels)
        return run(lat)

    def decode_images(self, packed_latents: torch.Tensor) -> torch.Tensor:
        """Packed latents [B, S, 4*C] -> images [B, 3, H, W] in about [-1, 1],
        in the VAE's dtype (float32 when tiled), differentiable (the OCR
        training term's decode, tiled or not): unpack, undo the latent scaling
        and shift, decode."""
        cfg = self.pipe_cfg
        return self._decode_unpacked(
            unpack_latents(packed_latents, cfg.latent_height, cfg.latent_width))

    @torch.inference_mode()
    def decode(self, packed_latents: torch.Tensor) -> np.ndarray:
        """Packed latents -> uint8 images [B, H, W, 3]."""
        cfg = self.pipe_cfg
        pixels = self._decode_unpacked(unpack_latents(packed_latents.to(self.compute_dtype),
                                                      cfg.latent_height, cfg.latent_width))
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
                 timesteps=None, sigmas=None, return_dict: bool = False,
                 ip_adapter_image: Optional[np.ndarray] = None,
                 ip_adapter_scale: float = 1.0):
        """Generate images; either embeddings or token ids must be given.

        ``output_type``: "np" (uint8 [B, H, W, 3]), "pil" (list of PIL
        images) or "latent" (packed float32 latents); ``return_dict`` wraps
        it in :class:`FluxPipelineOutput`. ``latents``: packed noise
        [num_images, S, 4*C] that replaces the seeded noise and the
        glyph-latent init. ``timings``, when given, receives the seconds of
        each stage (the device is synchronised at stage boundaries) and the
        request's spans under ``"trace"`` (``utils/profiling.py``).

        ``timesteps``/``sigmas`` (at most one) replace the linspace schedule
        (``build_schedule``); ``num_inference_steps`` then yields to their
        length. ``init_image`` (uint8 [H, W, 3] or [1, H, W, 3]) with
        ``strength`` < 1 is img2img: the image's latent, encoded with the
        glyph generator, is noised to ``sigmas[t0]``, t0 = min(int(steps *
        (1 - strength)), steps - 1), and sampling starts at step t0 from
        there. ``callback(step, latents)`` runs after every ``callback_steps``
        steps with the packed latents (under ``shard_for_sp`` on rank 0 only,
        with the gathered latents); returning False stops sampling there.
        ``ip_adapter_image`` (uint8 [H, W, 3]) is an image prompt at
        ``ip_adapter_scale`` through the attached IP-Adapter; with the
        adapter attached and no image, zero tokens at scale 0 go in.
        """
        cfg = self.pipe_cfg
        custom = _normalize_custom_schedule(timesteps, sigmas)
        steps = len(custom[1]) if custom is not None else (
            num_inference_steps or cfg.num_inference_steps)
        gscale = cfg.guidance_scale if guidance_scale is None else guidance_scale
        if callback is not None and callback_steps < 1:
            raise ValueError(f"callback_steps must be >= 1, got {callback_steps}")
        with request_trace(timings, self.device) as rec:
            with stage(rec, "encode_prompt"):
                if prompt_embeds is None:
                    prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
                prompt_embeds = prompt_embeds.to(self.device)
                pooled_embeds = pooled_embeds.to(self.device)
                if num_images > 1 and prompt_embeds.shape[0] == 1:
                    prompt_embeds = prompt_embeds.repeat_interleave(num_images, dim=0)
                    pooled_embeds = pooled_embeds.repeat_interleave(num_images, dim=0)

            with stage(rec, "prepare"):
                schedule = self.schedule(steps, custom)
                g_lat, g_cond, g_glyph, _ = self.generators(seed)
                cond_tokens, token_masks = self.prepare_control_tokens(conditions, g_cond)
                if latents is not None:
                    latents = self.check_latents(latents, num_images)
                t_start = 0
                if init_image is not None and strength < 1.0:
                    t_start = min(int(steps * (1.0 - strength)), steps - 1)
                    noise = (latents if latents is not None
                             else self.prepare_latents(g_lat, num_images))
                    img_lat = self._encode_scaled(self._images(init_image), g_glyph)
                    img_packed = pack_latents(img_lat.expand(num_images, *img_lat.shape[1:]))
                    latents = schedule.scale_noise(img_packed, noise, t_start)
                elif latents is None:
                    latents = self.prepare_latents(g_lat, num_images, conditions.glyph_canvas,
                                                   g_glyph)
                flux_extra = self._ip_extra([ip_adapter_image], [ip_adapter_scale])
            with stage(rec, "sample"):
                sample = self._sampler(schedule, cond_tokens, token_masks, prompt_embeds,
                                       pooled_embeds, gscale, latents.shape[0], flux_extra)
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
            return self.finish(latents, output_type, rec, return_dict)

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
                 pooled_embeds: torch.Tensor, gscale: float, batch: int,
                 flux_extra: Optional[Dict[str, torch.Tensor]] = None) -> Callable:
        """``sample(latents, start_step=0, num_steps=None)``: the denoise loop
        over a chunk of ``schedule`` with these conditions and embeds, and
        the IP-Adapter's ``flux_extra`` (sequence-parallel after
        ``shard_for_sp``)."""
        cfg = self.pipe_cfg
        if self.sp_group is None:
            sampler = make_txt2img_sampler(
                self._dp_rows(self.flux, FLUX_ROW_ARGS),
                self._dp_rows(self.controlnet, CONTROLNET_ROW_ARGS), schedule, cfg,
                self.compute_dtype, decide=self._decide())
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
                           txt_ids, img_ids, guidance, start_step, num_steps, flux_extra)

        return sample

    def _callback_stops(self, callback: Callable, step: int, latents: torch.Tensor) -> bool:
        """Whether ``callback(step, latents)`` returned False. Under
        ``shard_for_sp`` or ``shard_for_inference`` rank 0 alone calls it (the
        JAX controller's one call, on the whole latents every rank holds) and
        every rank takes its answer, so all stop at the same step."""
        group = self._decision_group()
        if group is None:
            return callback(step, latents) is False
        return decide_on_rank0(group, lambda: callback(step, latents) is False)

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
        (one per row, None for none) with ``ip_adapter_scales`` (default 1.0
        each) are the rows' image prompts through the attached IP-Adapter
        ([B, N, D] tokens and [B] scales; a row without one gets zero tokens
        at scale 0); an image without an adapter raises. Under
        ``shard_for_sp`` the batch's tokens are sharded as ``__call__``'s are.
        """
        cfg = self.pipe_cfg
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
        with request_trace(timings, self.device) as rec:
            with stage(rec, "encode_prompt"):
                if not pre_encoded:
                    prompt_embeds, pooled_embeds = self.encode_prompt(clip_ids, t5_ids)
                prompt_embeds = prompt_embeds.to(self.device)
                pooled_embeds = pooled_embeds.to(self.device)

            with stage(rec, "prepare"):
                cond_l, mask_l, lat_l = [], [], []
                for conds, seed in zip(conditions_list, seeds):
                    g_lat, g_cond, g_glyph, _ = self.generators(int(seed))
                    ct, tm = self.prepare_control_tokens(conds, g_cond)
                    cond_l.append(ct)
                    mask_l.append(tm)
                    lat_l.append(self.prepare_latents(g_lat, 1, conds.glyph_canvas, g_glyph))
                cond_tokens = torch.stack(cond_l, dim=1)   # [N, B, S, F] per-image conditions
                token_masks = torch.stack(mask_l, dim=1)   # [N, B, S, 1]
                latents = torch.cat(lat_l, dim=0)          # [B, S, C]
                b = latents.shape[0]
                scales = [1.0] * b if ip_adapter_scales is None else list(ip_adapter_scales)
                flux_extra = self._ip_extra(ip_adapter_images, scales)
            with stage(rec, "sample"):
                latents = self._sampler(self.schedule(steps), cond_tokens, token_masks,
                                        prompt_embeds, pooled_embeds, gscale, b,
                                        flux_extra)(latents)
            return self.finish(latents, output_type, rec)

    def finish(self, latents: torch.Tensor, output_type: str, rec: Optional[SpanRecorder],
               return_dict: bool = False):
        """Sampled latents -> the requested ``output_type``, wrapped in
        :class:`FluxPipelineOutput` with ``return_dict``; the decode is the
        request's ``decode`` stage under ``rec``."""
        if output_type == "latent":
            out = latents
        else:
            with stage(rec, "decode"):
                out = self.decode(latents)
            if output_type == "pil":
                out = to_pil_images(out)
        return FluxPipelineOutput(images=out) if return_dict else out
