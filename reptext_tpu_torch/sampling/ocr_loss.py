"""Differentiable OCR text-perceptual loss (the RepText paper's term), PyTorch.

Counterpart of ``reptext_tpu/sampling/ocr_loss.py``:

    x0_pred = x_t - t * v_pred              (rectified-flow identity)
    image   = VAE.decode(x0_pred)           (frozen decoder, differentiable)
    crop    = crop_and_resize(image, box)   (ops/crop.py, known text boxes)
    loss    = CTC(OCRJudge(crop), label)    (frozen judge, eval/ocr.py)

The training data knows each sample's text box, so the dataset computes the
judge's crop window on the host (:func:`aspect_box`: a margin around the
glyph bbox, widened or heightened to the judge's 4:1 aspect) and the step
does crop -> grayscale -> per-crop standardisation, which matches
``prepare_crop`` on exact-box crops. Images are NCHW here (the port's VAE
layout), [B, 3, H, W]; crops [B, 1, 48, 256].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from reptext_tpu_torch.eval.ocr import IMG_H, IMG_W, OCRJudge, ctc_losses
from reptext_tpu_torch.ops.crop import crop_and_resize

# judge input aspect (W/H = 4): boxes are extended to it before cropping
_ASPECT = IMG_W / IMG_H


def aspect_box(ink_bbox: Tuple[int, int, int, int], height: int, width: int,
               pad_frac: float = 0.18) -> np.ndarray:
    """Ground-truth glyph bbox -> normalised judge crop window [y0, x0, y1, x1].

    A margin of ``pad_frac`` of the ink height, then a symmetric extension to
    the judge's 4:1 aspect, so that one bilinear resize keeps the aspect. May
    reach past the image edge; ``crop_and_resize`` clamps.
    """
    y0, x0, y1, x1 = (float(v) for v in ink_bbox)
    pad = max(2.0, pad_frac * max(y1 - y0, 1.0))
    y0, x0, y1, x1 = y0 - pad, x0 - pad, y1 + pad, x1 + pad
    bh, bw = y1 - y0, x1 - x0
    if bw < _ASPECT * bh:                      # too narrow: widen
        extra = (_ASPECT * bh - bw) / 2.0
        x0, x1 = x0 - extra, x1 + extra
    else:                                      # too wide: heighten
        extra = (bw / _ASPECT - bh) / 2.0
        y0, y1 = y0 - extra, y1 + extra
    return np.asarray([y0 / height, x0 / width, y1 / height, x1 / width], np.float32)


def glyph_ink_bbox(canvas: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(y0, x0, y1, x1) of rendered ink in an RGB glyph canvas; None if blank."""
    ink = (np.asarray(canvas) > 0).any(axis=-1)
    rows = np.flatnonzero(ink.any(axis=1))
    cols = np.flatnonzero(ink.any(axis=0))
    if rows.size == 0 or cols.size == 0:
        return None
    return int(rows[0]), int(cols[0]), int(rows[-1]) + 1, int(cols[-1]) + 1


def standardize_crops(crops: torch.Tensor) -> torch.Tensor:
    """Per-crop mean 0, std 1 (the population std, as ``jnp.std``)."""
    m = crops.mean(dim=(1, 2, 3), keepdim=True)
    s = crops.std(dim=(1, 2, 3), keepdim=True, correction=0)
    return (crops - m) / (s + 1e-5)


def ocr_logits_from_images(images: torch.Tensor, boxes: torch.Tensor,
                           judge: OCRJudge) -> torch.Tensor:
    """[B, 3, H, W] images (any affine range) + [B, 4] boxes -> CTC logits [B, T, K]."""
    g = images.float().mean(dim=1, keepdim=True)
    crops = standardize_crops(crop_and_resize(g, boxes, IMG_H, IMG_W))
    return judge(crops)


def ocr_ctc_loss(images: torch.Tensor, boxes: torch.Tensor, labels: torch.Tensor,
                 label_paddings: torch.Tensor, judge: OCRJudge,
                 sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-character-normalised CTC loss of the text regions against their labels.

    labels [B, L] int (``eval.ocr.CHAR_TO_ID``, 0-padded), label_paddings
    [B, L] float (1.0 = pad); ``sample_weights`` [B] scales each sample (the
    (1 - t) ramp). A sample whose label is empty (no character of the charset)
    is left out: CTC against an empty label rewards erasing its text.
    """
    logits = ocr_logits_from_images(images, boxes, judge)
    per = ctc_losses(logits, labels, label_paddings)
    nchar = (1.0 - label_paddings.float()).sum(dim=-1)
    valid = (nchar > 0).to(per.dtype)
    per = per / nchar.clamp(min=1.0)
    weights = valid if sample_weights is None else sample_weights.to(per.dtype) * valid
    # where() keeps an excluded sample's term out of the gradient as well
    per = torch.where(valid > 0, per, torch.zeros_like(per))
    return (per * weights).sum() / weights.sum().clamp(min=1e-6)
