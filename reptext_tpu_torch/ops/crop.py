"""Differentiable box crop-and-resize (bilinear) for in-graph region losses (PyTorch).

Counterpart of ``reptext_tpu/ops/crop.py``: the OCR text-perceptual loss
(``sampling/ocr_loss.py``) crops each sample's text region out of the decoded
image inside the training step, with gradients flowing back through the crop
into the image and the box. The port's images are NCHW.
"""

from __future__ import annotations

import torch


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
    at the image border (edge padding). One batched gather per corner.
    """
    b, _, h, w = images.shape
    boxes = boxes.to(torch.float32)
    y0, x0, y1, x1 = boxes.unbind(dim=1)
    dev = images.device
    gy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    gx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    ys = (y0[:, None] + gy[None] * (y1 - y0)[:, None]) * h - 0.5      # [B, oh]
    xs = (x0[:, None] + gx[None] * (x1 - x0)[:, None]) * w - 0.5      # [B, ow]
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    yf, xf = ys.floor(), xs.floor()
    wy = (ys - yf)[:, None, :, None]                                   # [B, 1, oh, 1]
    wx = (xs - xf)[:, None, None, :]                                   # [B, 1, 1, ow]
    yi0, xi0 = yf.long(), xf.long()
    yi1 = (yi0 + 1).clamp(max=h - 1)
    xi1 = (xi0 + 1).clamp(max=w - 1)
    nhwc = images.permute(0, 2, 3, 1)
    bi = torch.arange(b, device=dev)[:, None, None]

    def at(yi, xi):   # [B, C, oh, ow]
        return nhwc[bi, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    top = at(yi0, xi0) * (1 - wx) + at(yi0, xi1) * wx
    bot = at(yi1, xi0) * (1 - wx) + at(yi1, xi1) * wx
    return top * (1 - wy) + bot * wy
