"""Timestep / guidance / pooled-text embeddings for FLUX conditioning (PyTorch).

Counterpart of ``reptext_tpu/nn/embeddings.py``: cos-first sinusoidal
features of t * 1000 through a two-layer silu MLP, likewise for the guidance
scale, plus the projected pooled CLIP embedding, summed into one vector.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[B] -> [B, dim] float32, cos-first (flip_sin_to_cos=True)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class MLPEmbedder(nn.Module):
    """in -> hidden (silu) -> hidden."""

    def __init__(self, in_dim: int, hidden_dim: int, device=None, dtype=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden_dim, device=device, dtype=dtype)
        self.linear_2 = nn.Linear(hidden_dim, hidden_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class CombinedTimestepTextEmbed(nn.Module):
    """temb = MLP(sin(t*1000)) [+ MLP(sin(g*1000))] + MLP(pooled_text)."""

    def __init__(self, inner_dim: int, pooled_dim: int, time_embed_dim: int = 256,
                 guidance_embeds: bool = True, device=None, dtype=None):
        super().__init__()
        self.time_embed_dim = time_embed_dim
        self.timestep_embedder = MLPEmbedder(time_embed_dim, inner_dim, device, dtype)
        self.guidance_embedder = (MLPEmbedder(time_embed_dim, inner_dim, device, dtype)
                                  if guidance_embeds else None)
        self.text_embedder = MLPEmbedder(pooled_dim, inner_dim, device, dtype)

    def forward(self, timestep: torch.Tensor, pooled_text: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.timestep_embedder.linear_1.weight.dtype
        # t * 1000 in t's own dtype, as the JAX package computes it
        temb = self.timestep_embedder(
            timestep_embedding(timestep * 1000.0, self.time_embed_dim).to(dtype))
        if self.guidance_embedder is not None:
            if guidance is None:
                raise ValueError("config.guidance_embeds=True requires a guidance tensor")
            temb = temb + self.guidance_embedder(
                timestep_embedding(guidance * 1000.0, self.time_embed_dim).to(dtype))
        return temb + self.text_embedder(pooled_text.to(dtype))
