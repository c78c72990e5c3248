"""Latent patchification and token-grid utilities (PyTorch).

Counterpart of ``reptext_tpu/ops/latents.py``: FLUX packs 16-channel f=8 VAE
latents into 64-feature tokens by 2x2 patches, and the token grid carries a
3-axis position id (const, row, col) for RoPE.

``jax.image.resize(..., "linear")``, which the JAX package uses for every
mask resize, is antialiased when it shrinks: each output sample is a
normalised triangle filter whose width grows with the shrink factor. That is
not ``F.interpolate(align_corners=False)`` without antialiasing. The port
computes the same triangle weights on the host (:func:`linear_resize_matrix`)
and applies them as two small matrix products. Its "nearest" method samples
at half-pixel centres, ``floor((i + 0.5) * in / out)`` in float32, where
``F.interpolate(mode="nearest")`` takes ``floor(i * in / out)``:
:func:`resize_nearest` gathers the JAX package's indices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/2)*(W/2), C*4], feature order (c, dy, dx)."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, H/2, W/2, C, 2, 2]
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(latents: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, S, C*4] -> [B, C, height, width] (height/width in latent pixels)."""
    b, _, cf = latents.shape
    c = cf // 4
    x = latents.reshape(b, height // 2, width // 2, c, 2, 2)
    x = x.permute(0, 3, 1, 4, 2, 5)  # [B, C, H/2, 2, W/2, 2]
    return x.reshape(b, c, height, width)


def prepare_latent_image_ids(height: int, width: int, device=None,
                             dtype=torch.float32) -> torch.Tensor:
    """Token position ids [(height/2)*(width/2), 3]: (0, row, col)."""
    h2, w2 = height // 2, width // 2
    row = torch.arange(h2, dtype=dtype, device=device)[:, None].expand(h2, w2)
    col = torch.arange(w2, dtype=dtype, device=device)[None, :].expand(h2, w2)
    ids = torch.stack([torch.zeros_like(row), row, col], dim=-1)
    return ids.reshape(h2 * w2, 3)


@functools.lru_cache(maxsize=32)
def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize's 'linear' method.

    Half-pixel sample centres, a triangle kernel widened by the shrink factor
    when downsampling (antialias), weights normalised to sum to one.
    """
    inv = n_in / n_out
    kernel_scale = max(inv, 1.0)
    centres = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(centres[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    w /= w.sum(axis=1, keepdims=True)
    w.setflags(write=False)
    return w


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W] like ``jax.image.resize(img, ..., "linear")`` (fp32)."""
    h, w = img.shape[-2:]
    wh = torch.from_numpy(linear_resize_matrix(h, out_h).astype(np.float32)).to(img.device)
    ww = torch.from_numpy(linear_resize_matrix(w, out_w).astype(np.float32)).to(img.device)
    return torch.matmul(torch.matmul(wh, img.float()), ww.T)


@functools.lru_cache(maxsize=32)
def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output sample of jax.image.resize's 'nearest'
    method, computed in float32 as it does. (XLA on the CPU divides through a
    reciprocal, so where (i + 0.5) * in / out is an exact integer, which a
    whole shrink factor such as the VAE's 8 never gives, it may take the
    index below.)"""
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    idx = np.floor(offsets / np.float32(n_out)).astype(np.int64)
    idx.setflags(write=False)
    return idx


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize [..., H, W] like ``jax.image.resize(img, ..., "nearest")``."""
    h, w = img.shape[-2:]
    rows = torch.from_numpy(nearest_indices(h, out_h).copy()).to(img.device)
    cols = torch.from_numpy(nearest_indices(w, out_w).copy()).to(img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def downsample_region_mask(mask: torch.Tensor, latent_height: int,
                           latent_width: int) -> torch.Tensor:
    """Pixel-space region mask [H, W] (0..1) -> per-token mask [S, 1]."""
    h2, w2 = latent_height // 2, latent_width // 2
    return resize_linear(mask, h2, w2).reshape(h2 * w2, 1)


def glyph_latent_blend(noise: torch.Tensor, glyph_latents: torch.Tensor,
                       glyph_mask: torch.Tensor, scale: float = 0.10) -> torch.Tensor:
    """Glyph-latent init: ``where(mask, scale * glyph_latents + noise, noise)``.

    noise and glyph_latents [B, C, H, W], glyph_mask [B, 1, H, W] on the
    latent grid (binarised); ``scale`` is the reference's 0.10.
    """
    blended = scale * glyph_latents + noise
    return torch.where(glyph_mask > 0.5, blended, noise)


def binarize_glyph_mask_to_latent(glyph_pixels: torch.Tensor, latent_height: int,
                                  latent_width: int) -> torch.Tensor:
    """Glyph canvas pixels [H, W] (any > 0 is ink) -> {0, 1} mask [1, h, w]:
    the ink mask, linear resize to the latent grid, then ``> 0``."""
    m = resize_linear((glyph_pixels > 0).float(), latent_height, latent_width)
    return (m > 0).float()[None]


def glyph_ink_mask_to_latent(glyph_canvas: np.ndarray, latent_height: int,
                             latent_width: int) -> np.ndarray:
    """Glyph canvas uint8 [H, W, 3] -> {0, 1} latent-grid mask [h, w] (host).

    Ink (any channel > 0), linear resize to the latent grid, then ``> 0``:
    a latent pixel is set when any ink pixel falls under its triangle filter.
    Computed in float64 on the host, where the sign of each weighted sum is
    exact, so the thresholded mask equals the JAX package's.
    """
    ink = (np.asarray(glyph_canvas) > 0).any(axis=-1).astype(np.float64)
    h, w = ink.shape
    m = linear_resize_matrix(h, latent_height) @ ink @ linear_resize_matrix(w, latent_width).T
    return (m > 0).astype(np.float32)
