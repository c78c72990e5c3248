"""CLIP ViT vision encoder (PyTorch): the IP-Adapter's image-prompt encoder.

Counterpart of ``reptext_tpu/nn/clip_vision.py`` (diffusers drives the
published FLUX IP-Adapter through a ``CLIPVisionModelWithProjection``,
openai/clip-vit-large-patch14): a patchify convolution without bias, the
class token and learned position embeddings, ``pre_layrnorm`` (the
checkpoint's spelling), the text tower's pre-LN layer without a causal mask,
the post-LayerNorm on the CLS state and the visual projection. LayerNorms run
in float32. :func:`preprocess_clip_image` is the JAX package's numpy/PIL host
code, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from reptext_tpu_torch.configs import CLIPConfig, CLIPVisionConfig
from reptext_tpu_torch.nn.clip import CLIPEncoderLayer, layer_norm_f32

# OpenAI CLIP preprocessing constants (transformers CLIPImageProcessor).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip_image(image: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] (or [B, H, W, 3]) -> float32 NHWC, CLIP-normalized.

    Bicubic resize to ``image_size`` square (the CLIPImageProcessor default
    shortest-edge resize + center crop collapses to a plain resize for the
    square inputs this pipeline feeds), then (x/255 - mean) / std.
    """
    from PIL import Image

    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    out = np.empty((arr.shape[0], image_size, image_size, 3), np.float32)
    for i, img in enumerate(arr):
        h, w = img.shape[:2]
        if (h, w) != (image_size, image_size):
            short = min(h, w)
            y0, x0 = (h - short) // 2, (w - short) // 2
            img = img[y0:y0 + short, x0:x0 + short]
            img = np.asarray(
                Image.fromarray(img.astype(np.uint8)).resize(
                    (image_size, image_size), Image.BICUBIC
                )
            )
        out[i] = img.astype(np.float32) / 255.0
    mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
    std = np.asarray(CLIP_IMAGE_STD, np.float32)
    return (out - mean) / std


class CLIPVisionEncoder(nn.Module):
    """pixel_values [B, H, W, 3] (NHWC, as the JAX module takes them) ->
    (last_hidden_state [B, 1 + P, hidden], image_embeds [B, projection_dim])."""

    def __init__(self, config: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, cfg.patch_size,
                                         bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, **kw))
        self.position_embedding = nn.Embedding(1 + cfg.num_patches, cfg.hidden_size, **kw)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        layer_cfg = CLIPConfig(hidden_size=cfg.hidden_size,
                               intermediate_size=cfg.intermediate_size,
                               num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                               layer_norm_eps=cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(layer_cfg, **kw))
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        dtype = self.patch_embedding.weight.dtype
        b = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(dtype))
        patches = patches.flatten(2).transpose(1, 2)               # [B, P, hidden], row-major
        cls = self.class_embedding.to(patches.dtype)[None, None].expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = layer_norm_f32(self.pre_layrnorm, x)
        full = torch.ones(x.shape[1], x.shape[1], dtype=torch.bool, device=x.device)[None, None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, full)
        pooled = layer_norm_f32(self.post_layernorm, x[:, 0])
        return x, self.visual_projection(pooled)
