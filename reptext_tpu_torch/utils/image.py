"""Image array conversion (the VaeImageProcessor equivalent, numpy-only).

Reference counterpart: diffusers ``VaeImageProcessor`` built at
RepText/pipeline_flux_controlnet.py:222 (preprocess: resize + scale to [-1,1];
postprocess: clamp, [0,1], uint8). The port's own copy of
``reptext_tpu/utils/image.py``.
"""

from __future__ import annotations

import numpy as np


def preprocess_images(images: np.ndarray) -> np.ndarray:
    """uint8 [B?, H, W, 3] (or [H, W, 3]) -> float32 NHWC in [-1, 1]."""
    arr = np.asarray(images)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32) * 2.0 - 1.0
    return arr


def postprocess_images(images) -> np.ndarray:
    """float NHWC in [-1, 1] -> uint8 [B, H, W, 3]."""
    arr = np.asarray(images, dtype=np.float32)
    arr = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
    return (arr * 255.0).round().astype(np.uint8)


def resize_to_multiple(
    image: np.ndarray,
    multiple: int = 64,
    max_side: int = 1536,
    min_side: int = 768,
    mode: str = "lanczos",
) -> np.ndarray:
    """Resize so the long side fits [min_side, max_side] and both dims are
    multiples of ``multiple``.

    Reference counterpart: the reference inpaint script's resize_img, which rounds
    working dims to x64 before masking/encoding (RepText/infer_inpaint.py:
    25-46). uint8 [H, W, 3] in, uint8 out.
    """
    from PIL import Image

    h, w = image.shape[:2]
    long_side = max(h, w)
    scale = 1.0
    if long_side > max_side:
        scale = max_side / long_side
    elif long_side < min_side:
        scale = min_side / long_side
    nh, nw = int(round(h * scale)), int(round(w * scale))
    nh = max(multiple, round(nh / multiple) * multiple)
    nw = max(multiple, round(nw / multiple) * multiple)
    resample = Image.LANCZOS if mode == "lanczos" else Image.BILINEAR
    return np.asarray(
        Image.fromarray(image).resize((nw, nh), resample), dtype=np.uint8
    )
