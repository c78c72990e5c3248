"""The model FLOPs of the inpainting ControlNet in one step of an inpainting
request: a FLUX-shaped net over the same rows and tokens as FLUX whose
condition embedder takes its 68 features (``extra_condition_channels`` 4).
True CFG runs every net at twice the images' rows. The rest of the step,
FLUX and the RepText ControlNet, is ``step.step_flop``."""

from __future__ import annotations

from portbench.counts import step


def controlnet_flop(group: dict, rows: int, s_img: int, s_txt: int) -> float:
    """One forward of the inpainting ControlNet of geometry ``group`` (the
    configuration's ``inpaint_controlnet`` group, or the port's
    ``ControlNetConfig`` as a dict) over ``rows`` rows."""
    return step.model_flop(group, rows, s_img, s_txt, control=True)
