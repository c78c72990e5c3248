"""Normalisation, modulation and MLP building blocks (PyTorch).

Counterpart of ``reptext_tpu/nn/layers.py``. Parameter names follow the Flax
tree (``linear``, ``in_proj``/``out_proj``, ``weight``) so that
``io/from_jax.py`` maps them mechanically. Norms and the AdaLN modulation run
in float32 and cast back to the activation dtype; projections run in the
parameters' dtype (bf16 on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F


class RMSNorm(nn.Module):
    """RMS normalisation with a learned scale (per-head q/k norm)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def layer_norm_no_affine_f32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters; returns float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def layer_norm_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return layer_norm_no_affine_f32(x, eps).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, in float32, cast to x's dtype.

    shift/scale are [B, dim] and broadcast over the token axis.
    """
    normed = layer_norm_no_affine_f32(x)
    out = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """temb -> (modulated x, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        emb = self.linear(F.silu(temb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        return modulate(x, shift_msa, scale_msa), gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """temb -> (modulated x, gate)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        shift, scale, gate = self.linear(F.silu(temb)).chunk(3, dim=-1)
        return modulate(x, shift, scale), gate


class AdaLayerNormContinuous(nn.Module):
    """Output norm: temb -> (scale, shift); x -> LN(x) * (1 + scale) + shift."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return modulate(x, shift, scale)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class FeedForward(nn.Module):
    """dim -> mult * dim -> dim with gelu-tanh (FLUX feedforward)."""

    def __init__(self, dim: int, mult: float = 4.0, device=None, dtype=None):
        super().__init__()
        inner = int(dim * mult)
        self.in_proj = nn.Linear(dim, inner, device=device, dtype=dtype)
        self.out_proj = nn.Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(gelu_tanh(self.in_proj(x)))
