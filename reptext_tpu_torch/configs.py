"""Model/pipeline configuration dataclasses.

The port's own copy of ``reptext_tpu/configs.py`` (fields, defaults and
``tiny()`` presets unchanged; ``tests/test_torch_host.py`` holds them equal),
so that the port never imports the JAX package. ``CLIPVisionConfig`` and
``IPAdapterConfig`` wait for the adapters.

The reference configures models through diffusers' ``register_to_config`` kwargs
(reference: RepText/controlnet_flux.py:44-59) and hardcoded script variables
(RepText/infer.py:36-62). Here every component is configured by an explicit frozen
dataclass so configs are hashable and self-documenting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """FLUX.1 MMDiT transformer geometry.

    Defaults mirror FLUX.1-dev (reference geometry facts: SURVEY.md §2.2;
    RepText/controlnet_flux.py:47-59): 19 double-stream + 38 single-stream blocks,
    24 heads x 128 head-dim (inner 3072), T5 context width 4096, CLIP pooled width
    768, 3-axis RoPE with dims (16, 56, 56) and theta 10000.
    """

    in_channels: int = 64                 # packed latent features per token (16ch x 2x2 patch)
    num_layers: int = 19                  # double-stream (joint text+image) blocks
    num_single_layers: int = 38           # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096       # T5 encoder width
    pooled_projection_dim: int = 768      # CLIP pooled width
    guidance_embeds: bool = True          # FLUX.1-dev embeds guidance scale
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: int = 10000
    mlp_ratio: float = 4.0
    time_embed_dim: int = 256             # sinusoidal timestep embedding width

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def out_channels(self) -> int:
        return self.in_channels

    def tiny(self) -> "FluxConfig":
        """A small-geometry variant for tests (2 double + 4 single blocks)."""
        return dataclasses.replace(
            self,
            num_layers=2,
            num_single_layers=4,
            attention_head_dim=32,
            num_attention_heads=4,
            joint_attention_dim=32,   # == T5Config.tiny().d_model
            pooled_projection_dim=32,  # == CLIPConfig.tiny().hidden_size
            axes_dims_rope=(8, 12, 12),
            time_embed_dim=32,
        )


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """RepText FLUX ControlNet geometry.

    The ControlNet reuses the base transformer block definitions and adds
    zero-initialised per-block residual projections plus a zero-initialised
    conditioning embedder of width ``in_channels + extra_condition_channels``
    (reference: RepText/controlnet_flux.py:98-116). The published
    Shakker-Labs/RepText checkpoint is trimmed from the base transformer
    (``from_transformer`` default: 4 double + 10 single blocks,
    RepText/controlnet_flux.py:182-214).
    """

    in_channels: int = 64
    num_layers: int = 4
    num_single_layers: int = 10
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: int = 10000
    mlp_ratio: float = 4.0
    time_embed_dim: int = 256
    # RepText: canny latent (64) + position-mask latent (64) = 128 packed features/token,
    # consumed as in_channels + extra (reference: RepText/pipeline_flux_controlnet.py:704-726).
    extra_condition_channels: int = 64
    # union mode: n conditioning modes via a learned mode-token embedding
    # (reference: RepText/controlnet_flux.py:108-110,294-301).
    num_mode: Optional[int] = None

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def union(self) -> bool:
        return self.num_mode is not None

    def tiny(self) -> "ControlNetConfig":
        return dataclasses.replace(
            self,
            num_layers=1,
            num_single_layers=2,
            attention_head_dim=32,
            num_attention_heads=4,
            joint_attention_dim=32,
            pooled_projection_dim=32,
            axes_dims_rope=(8, 12, 12),
            time_embed_dim=32,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """FLUX AutoencoderKL geometry (f=8, 16 latent channels).

    Reference facts: VAE scale factor 8 and 16 latent channels
    (SURVEY.md §2.2; RepText/pipeline_flux_controlnet.py:219-221,945);
    scaling/shift factors follow the published FLUX.1-dev VAE config.
    """

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def scale_factor(self) -> int:
        """Spatial downsampling factor (2^(n_blocks-1))."""
        return 2 ** (len(self.block_out_channels) - 1)

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(
            self,
            block_out_channels=(8, 16, 16, 16),
            layers_per_block=1,
            norm_num_groups=4,
        )


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP-L/14 text encoder (pooled prompt embedding source)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # CLIP uses quick-gelu
    eos_token_id: int = 49407

    def tiny(self) -> "CLIPConfig":
        return dataclasses.replace(
            self, vocab_size=256, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_position_embeddings=16, eos_token_id=255,
        )


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5-XXL encoder (sequence prompt embedding source)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    def tiny(self) -> "T5Config":
        return dataclasses.replace(
            self, vocab_size=256, d_model=32, d_kv=8, d_ff=64,
            num_layers=2, num_heads=4,
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Sampling-time knobs, mirroring the reference __call__ surface
    (RepText/pipeline_flux_controlnet.py:751-780) as a static config."""

    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    controlnet_conditioning_scale: float = 1.0
    # ControlNet runs only for the first N steps
    # (reference: RepText/pipeline_flux_controlnet.py:1042-1058).
    controlnet_conditioning_step: int = 25
    # Step-fraction window during which the ControlNet is applied, matching
    # the diffusers `control_guidance_start/end` kwargs the reference exposes
    # (RepText/pipeline_flux_controlnet.py:760-761,999-1005: keep[i] = 1 iff
    # i/T >= start and (i+1)/T <= end). Combined with the step gate above —
    # a step's ControlNet runs only when BOTH allow it. Unlike the reference
    # (which scales residuals), gated-off steps skip the ControlNet forward
    # entirely via lax.cond on a precomputed per-step mask.
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    # Union-mode conditioning-type index, required when the loaded ControlNet
    # is union (ControlNetConfig.num_mode is not None); the mode-token row
    # selected from controlnet_mode_embedder
    # (reference: RepText/pipeline_flux_controlnet.py:763,1046 control_mode).
    control_mode: Optional[int] = None
    max_sequence_length: int = 512        # T5 token budget (hard cap in reference)
    # Glyph-latent initialization: in-mask latent = glyph_scale*VAE(glyph) + noise
    # (reference: RepText/pipeline_flux_controlnet_inpaint.py:635-649). The reference
    # txt2img pipeline computes-but-drops this blend (upstream bug, SURVEY.md §2.1);
    # here it is a flag, default ON.
    glyph_latent_init: bool = True
    glyph_latent_scale: float = 0.10
    # FlowMatch Euler dynamic shift parameters
    # (reference: RepText/pipeline_flux_controlnet.py:78-88,948-967).
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.16
    use_dynamic_shifting: bool = True
    # Inpaint-only: true CFG scale (reference: infer_inpaint.py:143 uses 1.0;
    # pipeline default 3.5, pipeline_flux_controlnet_inpaint.py:866).
    true_guidance_scale: float = 1.0
    # Training-free velocity caching (FORA/TeaCache-style step skipping for
    # rectified flow; absent in the reference — acceleration beyond the bf16
    # roofline). interval=1 disables (default: every step runs the model).
    # With interval=k, after `velocity_cache_warmup` full steps the
    # transformer+ControlNet run only every k-th step; skipped steps reuse the
    # last computed velocity in the Euler update. The final step always runs.
    velocity_cache_interval: int = 1
    velocity_cache_warmup: int = 8
    # "reuse": skipped steps repeat the last computed velocity (FORA-style).
    # "linear": first-order extrapolation from the last two computed
    # velocities over sigma (better fidelity at the same skip rate).
    # "adaptive" / "adaptive-linear" (TeaCache-family): the fixed interval is
    # replaced by an in-graph trigger — a step is skipped only while the
    # latents' relative L1 drift since the last computed step stays below
    # `velocity_cache_threshold` (and at most `velocity_cache_max_skip`
    # consecutive skips); velocity_cache_interval is ignored. Skipped steps
    # reuse ("adaptive") or extrapolate ("adaptive-linear") exactly as above.
    # Both fused samplers support all four modes (the inpaint sampler's
    # registers hold CFG-combined velocities).
    velocity_cache_mode: str = "reuse"
    # Adaptive trigger: skip while mean|x - x_ref|/mean|x_ref| < threshold
    # (x_ref = latents at the last computed step; max over the batch, so a
    # coalesced batch never skips past any member's drift).
    velocity_cache_threshold: float = 0.05
    velocity_cache_max_skip: int = 3

    @property
    def vae_scale_factor(self) -> int:
        return 8

    @property
    def latent_height(self) -> int:
        return self.height // self.vae_scale_factor

    @property
    def latent_width(self) -> int:
        return self.width // self.vae_scale_factor

    @property
    def image_seq_len(self) -> int:
        return (self.latent_height // 2) * (self.latent_width // 2)
