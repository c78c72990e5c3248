"""Differentiable box crop-and-resize (bilinear) for in-graph region losses (PyTorch).

Counterpart of ``reptext_tpu/ops/crop.py``: the OCR text-perceptual loss
(``sampling/ocr_loss.py``) crops each sample's text region out of the decoded
image inside the training step, with gradients flowing back through the crop
into the image and the box. The port's images are NCHW. The crop is two
per-sample interpolation-matrix products, ``Wy[B, oh, H] @ img @ Wx[B, ow, W]^T``
(the idiom of ``ops/latents.py::linear_resize_matrix``): their backward is
matrix products too, where an indexed gather's would add into the image with
atomics on the card, in no fixed order.
"""

from __future__ import annotations

import torch


def _interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """[B, n] sample positions, clamped to [0, size - 1] -> [B, n, size]
    linear interpolation weights: 1 - frac at the floor index, frac at the
    next one (the same index at the last row or column)."""
    floor = coords.floor()
    frac = coords - floor
    i0 = floor.long()
    i1 = (i0 + 1).clamp(max=size - 1)
    grid = torch.arange(size, device=coords.device)
    return ((i0[..., None] == grid).to(coords.dtype) * (1 - frac)[..., None]
            + (i1[..., None] == grid).to(coords.dtype) * frac[..., None])


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Bilinear crop of per-sample boxes to a fixed output size.

    Args:
      images: [B, C, H, W] float.
      boxes:  [B, 4] normalised (y0, x0, y1, x1) in [0, 1] image coordinates
              (fractions of H / W); gradients flow to ``images`` and ``boxes``.
      out_h/out_w: the output size.

    Returns [B, C, out_h, out_w]. The output grid's pixel centres sample the
    box interior (the align_corners=False convention); coordinates are clamped
    at the image border (edge padding).
    """
    _, _, h, w = images.shape
    boxes = boxes.to(torch.float32)
    y0, x0, y1, x1 = boxes.unbind(dim=1)
    dev = images.device
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    ys = (y0[:, None] + gy[None] * (y1 - y0)[:, None]) * h - 0.5      # [B, oh]
    xs = (x0[:, None] + gx[None] * (x1 - x0)[:, None]) * w - 0.5      # [B, ow]
    wy = _interp_matrix(ys.clamp(0.0, h - 1.0), h).to(images.dtype)   # [B, oh, H]
    wx = _interp_matrix(xs.clamp(0.0, w - 1.0), w).to(images.dtype)   # [B, ow, W]
    return torch.matmul(torch.matmul(wy[:, None], images), wx[:, None].transpose(-1, -2))
