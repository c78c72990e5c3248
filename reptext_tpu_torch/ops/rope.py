"""3-axis rotary position embeddings, half-split layout (PyTorch).

Counterpart of ``reptext_tpu/ops/rope.py`` for the layout the port uses: the
interleaved-pair permutation is folded into the q/k projection weights at
conversion (``reptext_tpu.io.convert._lin_rope``), so rotate-half is a
contiguous half swap ``(x_lo, x_hi) -> (-x_hi, x_lo)`` and the attention
kernel can rotate whole 8-channel chunks. Angles are computed in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_cos_sin_half(ids: torch.Tensor, axes_dim: Sequence[int],
                      theta: int = 10000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split cos/sin tables [S, D] from position ids [S, n_axes].

    Column j and column j + D/2 hold the angle of pair j, per axis a with
    frequencies 1 / theta^(2i / d_a).
    """
    ids = ids.float()
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dim):
        exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        freqs = 1.0 / (theta ** exponent)
        angles = ids[:, axis:axis + 1] * freqs[None, :]  # [S, dim/2]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    cos_p = torch.cat(cos_parts, dim=-1)
    sin_p = torch.cat(sin_parts, dim=-1)
    return torch.cat([cos_p, cos_p], dim=-1), torch.cat([sin_p, sin_p], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, D] (half-split order) by [S, D] tables; fp32 math, cast back."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)
