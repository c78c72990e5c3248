"""The numbers that decide ``correct``: the checked request's uint8 image
from the timed path against the plain reference's image of the same request
(``reference/TOLERANCES.md`` says why each limit is where it is)."""

from __future__ import annotations

from typing import Dict

import numpy as np


# how far a pixel value may lie from the reference's and still count as near:
# bf16 rounding through 30 steps and the bf16 VAE decode puts the program's
# values 0-3 levels off; a coarser step spreads them wide (TOLERANCES.md)
NEAR_LEVELS = 4


def numbers(got, want) -> Dict[str, float]:
    """``off4_pct``: the share (%) of the image's values (every pixel and
    channel, 8-bit levels) more than NEAR_LEVELS from the reference's; and,
    for the log, ``image_mad``, the mean |got - want| in levels. An image
    missing or of another shape is off everywhere."""
    if got is None or want is None or got.shape != want.shape:
        return {"off4_pct": 100.0, "image_mad": float("inf")}
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"off4_pct": float(100.0 * (diff > NEAR_LEVELS).mean()),
            "image_mad": float(diff.mean())}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number at or under its limit (a missing number fails,
    and so does a cell with no limit set)."""
    return bool(limits) and all(values.get(k, float("inf")) <= v for k, v in limits.items())
