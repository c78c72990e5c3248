"""Structured pipeline output (the reference's public return contract).

Counterpart of ``reptext_tpu/pipelines/outputs.py``: the reference returns
``FluxPipelineOutput(images=...)``, a list of PIL images for
``output_type="pil"`` or an array otherwise. The pipelines return uint8 numpy
(``output_type="np"``, ``return_dict=False``) unless asked.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class FluxPipelineOutput:
    """``images``: list[PIL.Image.Image] | np.ndarray | packed latents."""

    images: Any

    def __iter__(self):
        # unpacks as the reference's ``(images,)`` tuple: ``images, = out``
        yield self.images

    def __getitem__(self, i):
        return (self.images,)[i]


def to_pil_images(images_uint8) -> list:
    """uint8 [B, H, W, 3] -> list of PIL images."""
    from PIL import Image

    return [Image.fromarray(im) for im in images_uint8]
