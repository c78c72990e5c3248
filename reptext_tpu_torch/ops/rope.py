"""3-axis rotary position embeddings (PyTorch), half-split and interleaved.

Counterpart of ``reptext_tpu/ops/rope.py``. The port's models use the
half-split layout: the interleaved-pair permutation (:func:`deinterleave_perm`)
is folded into the q/k projection weights at conversion
(``io/convert.py::_lin_rope``), so rotate-half is a contiguous half swap
``(x_lo, x_hi) -> (-x_hi, x_lo)`` and the attention kernel can rotate whole
8-channel chunks. The interleaved form of the reference (diffusers'
``apply_rotary_emb`` with ``use_real_unbind_dim=-1``: adjacent pairs (x0, x1)
-> (x0 c - x1 s, x1 c + x0 s)), :func:`rope_cos_sin` and :func:`apply_rope`,
is kept for callers with checkpoints in that order; it is plain PyTorch and
no kernel uses it. Angles are computed in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _axis_angles(ids: torch.Tensor, axes_dim: Sequence[int], theta: int) -> torch.Tensor:
    """[S, D/2] float32 angles: per axis a, position times 1 / theta^(2i / d_a)."""
    ids = ids.float()
    parts = []
    for axis, dim in enumerate(axes_dim):
        exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        freqs = 1.0 / (theta ** exponent)
        parts.append(ids[:, axis:axis + 1] * freqs[None, :])
    return torch.cat(parts, dim=-1)


def rope_cos_sin(ids: torch.Tensor, axes_dim: Sequence[int],
                 theta: int = 10000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleaved cos/sin tables [S, D] from position ids [S, n_axes]: every
    pair's value repeated twice consecutively (torch ``repeat_interleave(2,
    -1)``), the axes concatenated."""
    angles = _axis_angles(ids, axes_dim, theta)
    return (torch.repeat_interleave(torch.cos(angles), 2, dim=-1),
            torch.repeat_interleave(torch.sin(angles), 2, dim=-1))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, D] (interleaved pairs) by [S, D] tables from
    :func:`rope_cos_sin`: (x0, x1) -> (x0 c - x1 s, x1 c + x0 s); fp32 math,
    cast back."""
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], xf.shape[-1] // 2, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


def deinterleave_perm(d: int) -> torch.Tensor:
    """The channel permutation from the interleaved pair layout to the
    half-split one: even channels first, odd second (pair (2j, 2j + 1) ->
    (j, j + D/2)), int64 [d]."""
    return torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)])


def rope_cos_sin_half(ids: torch.Tensor, axes_dim: Sequence[int],
                      theta: int = 10000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split cos/sin tables [S, D] from position ids [S, n_axes].

    Column j and column j + D/2 hold the angle of pair j, per axis a with
    frequencies 1 / theta^(2i / d_a).
    """
    angles = _axis_angles(ids, axes_dim, theta)
    cos_p, sin_p = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos_p, cos_p], dim=-1), torch.cat([sin_p, sin_p], dim=-1)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., S, D] (half-split order) by [S, D] tables; fp32 math, cast back."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    rot = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)
