"""Tiled VAE encode/decode: image <-> latent maps with bounded activation memory.

The port's own copy of ``reptext_tpu/ops/vae_tiling.py`` (which has no JAX
in it, but the port imports nothing of the JAX package). A full VAE decode
at 2048^2 keeps several GiB of convolution activations; decoding in
overlapping tiles caps them at a tile's. The same tiles, ramps and
normalisation as the JAX function, on NCHW tensors:

- clamped full-size tiles over the input grid (every tile has one shape);
- each output tile times a separable window, 1 inside and a linear ramp
  (k + 1) / (overlap + 1) over the borders that have a neighbour, added into
  a float32 canvas on the input's device, then divided by the summed window
  (which never reaches 0, so every pixel, the image border included, is
  normalised);
- every tile is dispatched before any is added in, as the JAX function
  dispatches every tile before it reads one back.

Convolutions see a truncated receptive field at tile borders and the group
norms take per-tile statistics, so a tiled pass is close to, not equal to,
the full one (``tests/test_torch_vae_tiling.py`` pins how close). Unlike the
JAX function, a side no longer than the tile is not tiled: the tile is
clamped per axis to the input's extent, so an input with one side at most
the tile and the other larger (a 1024 x 512 image on a tiling deployment)
runs, where ``reptext_tpu/ops/vae_tiling.py:98-129`` fails. The canvas adds
are recorded by autograd, so a tiled decode carries gradients.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

__all__ = ["tile_positions", "blend_weights_1d", "tiled_apply"]


def tile_positions(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets of full-size tiles covering [0, size), the last clamped
    to ``size - tile`` so that every tile has the same shape."""
    if tile >= size:
        return [0]
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return pos


def blend_weights_1d(tile: int, overlap: int, pos: int, size: int) -> np.ndarray:
    """Blending weights along one axis for a tile at ``pos`` in a ``size``
    grid: 1.0 inside, a ramp (k + 1) / (overlap + 1) over the first or last
    ``overlap`` samples where a neighbouring tile overlaps; strictly positive."""
    w = np.ones(tile, np.float32)
    if overlap <= 0:
        return w
    ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
    if pos > 0:
        w[:overlap] = np.minimum(w[:overlap], ramp)
    if pos + tile < size:
        w[-overlap:] = np.minimum(w[-overlap:], ramp[::-1])
    return w


def tiled_apply(tile_fn: Callable, x: torch.Tensor, tile: int, overlap: int, out_num: int,
                out_den: int, out_channels: int) -> torch.Tensor:
    """Apply an NCHW spatial map tile by tile with blended overlaps.

    ``tile_fn(x_tile, tile_index)`` maps [B, C_in, th, tw] to [B, C_out,
    th * out_num / out_den, tw * out_num / out_den] (a VAE decode: 8/1;
    encode: 1/8); ``tile_index`` counts the tiles in row-major order, so a
    sampling encoder draws once per tile in a fixed order. ``tile`` and
    ``overlap`` are in input units; ``tile`` is clamped to each axis's
    extent. Returns a float32 [B, out_channels, H * out_num / out_den,
    W * out_num / out_den] tensor on ``x``'s device.
    """
    b, _, h, w = x.shape
    th, tw = min(tile, h), min(tile, w)
    for t in (th, tw, overlap):
        if (t * out_num) % out_den:
            raise ValueError(f"tile ({th} x {tw}) and overlap ({overlap}) must map to whole "
                             f"output samples under x{out_num}/{out_den}")
    ys = tile_positions(h, th, th - overlap)
    xs = tile_positions(w, tw, tw - overlap)

    def to_out(v: int) -> int:
        return v * out_num // out_den

    oh, ow, oth, otw, o_overlap = to_out(h), to_out(w), to_out(th), to_out(tw), to_out(overlap)
    pending = []
    for y in ys:
        for xp in xs:
            pending.append((y, xp, tile_fn(x[:, :, y:y + th, xp:xp + tw], len(pending))))
    accum = torch.zeros((b, out_channels, oh, ow), dtype=torch.float32, device=x.device)
    weight = torch.zeros((oh, ow), dtype=torch.float32, device=x.device)
    for y, xp, out in pending:
        wy = blend_weights_1d(oth, o_overlap, to_out(y), oh)
        wx = blend_weights_1d(otw, o_overlap, to_out(xp), ow)
        w2d = torch.from_numpy(wy[:, None] * wx[None, :]).to(x.device)
        oy, ox = to_out(y), to_out(xp)
        accum[:, :, oy:oy + oth, ox:ox + otw] += out.float() * w2d
        weight[oy:oy + oth, ox:ox + otw] += w2d
    return accum / weight
