"""FLUX IP-Adapter (PyTorch): image-prompt conditioning by decoupled attention.

Counterpart of ``reptext_tpu/models/ip_adapter.py``, after diffusers' FLUX
IP-Adapter: the CLIP vision tower (``nn/clip_vision.py``) gives the image
embedding, :class:`ImageProjection` maps it to ``num_tokens`` pseudo-text
tokens of the T5 joint width, and every double block of FLUX attends to them
through its own ``to_k_ip``/``to_v_ip`` (``nn/blocks.py``), which live in the
transformer as diffusers stores them after ``load_ip_adapter``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from reptext_tpu_torch.configs import CLIPVisionConfig, IPAdapterConfig
from reptext_tpu_torch.nn.clip_vision import CLIPVisionEncoder, preprocess_clip_image


class ImageProjection(nn.Module):
    """[B, image_embed_dim] -> [B, N, cross_dim]: diffusers ``ImageProjection``
    (one linear to N x cross_dim, reshape, LayerNorm over the token features
    in float32 with Flax's epsilon, cast back)."""

    def __init__(self, config: IPAdapterConfig, device=None, dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.proj = nn.Linear(cfg.image_embed_dim, cfg.num_tokens * cfg.cross_attention_dim,
                              device=device, dtype=dtype)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim, eps=1e-6, device=device, dtype=dtype)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        x = x.reshape(x.shape[0], cfg.num_tokens, cfg.cross_attention_dim)
        return F.layer_norm(x.float(), self.norm.normalized_shape, self.norm.weight.float(),
                            self.norm.bias.float(), self.norm.eps).to(x.dtype)


class IPAdapterEncoder(nn.Module):
    """The vision tower and the projection: uint8 image(s) -> ip tokens."""

    def __init__(self, vision_cfg: CLIPVisionConfig, ip_cfg: IPAdapterConfig, device=None,
                 dtype=None):
        super().__init__()
        self.vision_cfg, self.ip_cfg = vision_cfg, ip_cfg
        self.vision = CLIPVisionEncoder(vision_cfg, device=device, dtype=dtype)
        self.proj = ImageProjection(ip_cfg, device=device, dtype=dtype)

    def forward(self, image: np.ndarray) -> torch.Tensor:
        """uint8 [H, W, 3] (or [B, H, W, 3]) -> ip tokens [B, N, cross_dim]."""
        device = self.proj.proj.weight.device
        pixels = torch.from_numpy(preprocess_clip_image(image, self.vision_cfg.image_size))
        _, image_embeds = self.vision(pixels.to(device))
        return self.proj(image_embeds)
