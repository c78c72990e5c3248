"""Glyph rendering + mask construction (CPU, deterministic).

Per text line, the RepText conditioning consists of (reference:
RepText/infer.py:71-103):
  - a glyph image: the text rendered in its color on a black canvas;
  - a position mask: the text bbox filled white;
  - a regional mask: the bbox dilated by 5px, gating ControlNet residuals;
  - an inverted canny edge image of the glyph image;
and a glyph canvas accumulating all lines' glyphs (used for latent init).

This frontend adds proper Arabic shaping/bidi (the reference draws raw logical
order, producing disconnected glyphs) and returns plain numpy arrays so the
device pipeline stays free of PIL objects.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from reptext_tpu_torch.conditioning.arabic import prepare_display_text
from reptext_tpu_torch.conditioning.canny import inverted_canny_rgb

_DEFAULT_FONT_CANDIDATES = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
)


def default_font_path() -> str:
    for p in _DEFAULT_FONT_CANDIDATES:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        "No default TTF font found; pass font_path explicitly "
        f"(searched {_DEFAULT_FONT_CANDIDATES})"
    )


@dataclasses.dataclass(frozen=True)
class TextLine:
    """One line of text to render into the image."""

    text: str
    position: Tuple[int, int]                  # top-left anchor in pixels
    color: Tuple[int, int, int] = (255, 255, 255)
    font_size: Optional[int] = None            # overrides the frontend default


@dataclasses.dataclass
class LineCondition:
    """Per-line conditioning arrays (all uint8, HxW[x3])."""

    glyph_image: np.ndarray      # [H, W, 3] text on black
    canny_image: np.ndarray      # [H, W, 3] inverted canny of glyph
    position_mask: np.ndarray    # [H, W]   bbox filled 255
    region_mask: np.ndarray      # [H, W]   bbox +5px filled 255
    bbox: Tuple[int, int, int, int]


@dataclasses.dataclass
class Conditions:
    """Full conditioning set for one generation."""

    lines: List[LineCondition]
    glyph_canvas: np.ndarray     # [H, W, 3] all lines' glyphs accumulated
    width: int
    height: int

    @property
    def num_lines(self) -> int:
        return len(self.lines)


def render_glyph_line(
    text: str,
    position: Tuple[int, int],
    color: Tuple[int, int, int],
    font: ImageFont.FreeTypeFont,
    width: int,
    height: int,
    shape_text: bool = True,
) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Render one line on a black canvas; return (array, bbox).

    ``shape_text`` applies Arabic contextual shaping + bidi reordering before
    drawing (set False to reproduce the reference's raw behavior).
    """
    display = prepare_display_text(text) if shape_text else text
    img = Image.new("RGB", (width, height), (0, 0, 0))
    draw = ImageDraw.Draw(img)
    draw.text(position, display, font=font, fill=tuple(color))
    bbox = draw.textbbox(position, display, font=font)
    x0, y0, x1, y1 = (int(v) for v in bbox)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, width), min(y1, height)
    return np.asarray(img, dtype=np.uint8), (x0, y0, x1, y1)


def build_line_condition(
    line: TextLine,
    font: ImageFont.FreeTypeFont,
    width: int,
    height: int,
    shape_text: bool = True,
    region_dilation: int = 5,
) -> LineCondition:
    glyph, bbox = render_glyph_line(
        line.text, line.position, line.color, font, width, height, shape_text
    )
    x0, y0, x1, y1 = bbox

    position_mask = np.zeros((height, width), dtype=np.uint8)
    position_mask[y0:y1, x0:x1] = 255

    region_mask = np.zeros((height, width), dtype=np.uint8)
    ry0, rx0 = max(y0 - region_dilation, 0), max(x0 - region_dilation, 0)
    ry1, rx1 = min(y1 + region_dilation, height), min(x1 + region_dilation, width)
    region_mask[ry0:ry1, rx0:rx1] = 255

    canny_image = inverted_canny_rgb(glyph)

    return LineCondition(
        glyph_image=glyph,
        canny_image=canny_image,
        position_mask=position_mask,
        region_mask=region_mask,
        bbox=bbox,
    )


def build_conditions(
    lines: Sequence[TextLine],
    width: int,
    height: int,
    font_path: Optional[str] = None,
    font_size: int = 80,
    shape_text: bool = True,
    region_dilation: int = 5,
) -> Conditions:
    """Build the full conditioning set for a list of text lines.

    The glyph canvas accumulates with uint8 wrap-around addition, matching the
    reference accumulation (RepText/infer.py:95-97); overlapping lines should be
    avoided by the caller just as in the reference.
    """
    if font_path is None:
        font_path = default_font_path()
    base_font = ImageFont.truetype(font_path, font_size)
    fonts = {font_size: base_font}

    conds: List[LineCondition] = []
    canvas = np.zeros((height, width, 3), dtype=np.uint8)
    for line in lines:
        size = line.font_size or font_size
        if size not in fonts:
            fonts[size] = ImageFont.truetype(font_path, size)
        lc = build_line_condition(
            line, fonts[size], width, height, shape_text, region_dilation
        )
        conds.append(lc)
        canvas += lc.glyph_image  # uint8 accumulate, reference semantics

    return Conditions(lines=conds, glyph_canvas=canvas, width=width, height=height)
