"""OCR-free glyph fidelity of generated text regions.

The port's copy of ``benchmarks/glyph_fidelity.py::_dilate, edge_iou,
edge_f1, ink_correlation, score_region`` (numpy and scipy, on the port's
numpy canny, ``conditioning/canny.py``): the generated region's edges and
contrast against the conditioning ground truth, the target the ControlNet
is trained to reproduce.

- edge-IoU: canny edges of the region vs the condition's canny edges, each
  dilated by a tolerance band;
- edge-F1: strict edge precision (generated edges exactly on target
  strokes) against band recall;
- ink correlation: normalised cross-correlation of the glyph mask and the
  region's intensity.
"""

from __future__ import annotations

import numpy as np

from reptext_tpu_torch.conditioning.canny import canny_edges


def _dilate(mask: np.ndarray, it: int = 1) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_dilation(mask, iterations=it)


def edge_iou(generated: np.ndarray, target_edges: np.ndarray, tol: int = 2) -> float:
    """IoU between generated-region edges and target edges, each dilated by
    ``tol`` px so 1-px localization error doesn't zero the score."""
    gen_e = canny_edges(generated) > 0
    tgt_e = target_edges > 0
    if not tgt_e.any():
        return 1.0 if not gen_e.any() else 0.0
    gen_d, tgt_d = _dilate(gen_e, tol), _dilate(tgt_e, tol)
    inter = (gen_e & tgt_d).sum() + (tgt_e & gen_d).sum()
    union = gen_e.sum() + tgt_e.sum()
    return float(inter / max(union, 1))


def edge_f1(generated: np.ndarray, target_edges: np.ndarray, tol: int = 2) -> float:
    """Harmonic mean of strict edge precision and +-tol-band recall.

    Precision counts generated edge pixels that land exactly on target
    strokes (no dilation): in a glyph-dense crop a tolerance band covers most
    of the box, and noise would score well. Recall keeps the band."""
    gen_e = canny_edges(generated) > 0
    tgt_e = target_edges > 0
    if not tgt_e.any():
        return 1.0 if not gen_e.any() else 0.0
    if not gen_e.any():
        return 0.0
    gen_d = _dilate(gen_e, tol)
    precision = (gen_e & tgt_e).sum() / gen_e.sum()
    recall = (tgt_e & gen_d).sum() / tgt_e.sum()
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def ink_correlation(generated: np.ndarray, glyph_mask: np.ndarray) -> float:
    """Normalized cross-correlation between the glyph ink mask and the
    generated region's intensity deviation."""
    g = generated.astype(np.float32).mean(axis=-1) if generated.ndim == 3 else generated
    m = (glyph_mask > 0).astype(np.float32)
    if m.sum() == 0:
        return 1.0
    g = g - g.mean()
    m = m - m.mean()
    denom = np.sqrt((g * g).sum() * (m * m).sum())
    if denom == 0:
        return 0.0
    return float(abs((g * m).sum()) / denom)


def score_region(generated_region, cond_line) -> dict:
    """Score one generated text region against its LineCondition (or any
    object with ``bbox``, ``canny_image`` and ``glyph_image``)."""
    x0, y0, x1, y1 = cond_line.bbox
    tgt_edges = 255 - cond_line.canny_image[y0:y1, x0:x1, 0]  # back to edges-on-black
    glyph = cond_line.glyph_image[y0:y1, x0:x1].mean(axis=-1)
    return {
        "edge_iou": edge_iou(generated_region, tgt_edges),
        "edge_f1": edge_f1(generated_region, tgt_edges),
        "ink_corr": ink_correlation(generated_region, glyph),
    }
