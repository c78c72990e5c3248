"""Record the conditions of chip_smoke.py's requests.

Run manually: ``python tests/record_conditions_fixture.py [FILE ...]`` writes
the named fixtures under ``tests/fixtures/`` (default: both):

- ``conditions_1024.npz``: the two 1024x1024 txt2img requests (``arabic``,
  ``latin``), with ``size`` and ``font_size``;
- ``conditions_large.npz``: one line each for the inpaint requests at
  1536x1152 and 1280x960 and the txt2img request at 1536x1536, each with its
  ``<name>.size`` (width, height), and ``font_size``.

For each request the file holds the text line, its position and the arrays
``build_conditions`` makes from them: the line's canny image, position mask
and region mask, and the glyph canvas. ``chip_smoke.py`` reads the requests
from these files, and uses their arrays only where the conditioning frontend
cannot run (no Pillow, or no font). ``tests/test_torch_pipeline.py`` and
``tests/test_torch_inpaint.py`` check the files against ``build_conditions``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = 1024
FONT_SIZE = 80
REQUESTS = {
    "arabic": ("مرحبا بالعالم", (300, 460)),
    "latin": ("Hello World", (300, 460)),
}
# name: (text, position, (width, height))
LARGE_REQUESTS = {
    "inpaint_1536x1152": ("مرحبا بالعالم", (520, 560), (1536, 1152)),
    "inpaint_1280x960": ("مرحبا بالعالم", (420, 460), (1280, 960)),
    "txt2img_1536": ("مرحبا بالعالم", (520, 720), (1536, 1536)),
}
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PATH = os.path.join(FIXTURES, "conditions_1024.npz")
LARGE_PATH = os.path.join(FIXTURES, "conditions_large.npz")
ARRAYS = ("canny_image", "position_mask", "region_mask")


def _line_arrays(out, name, text, pos, width, height):
    from reptext_tpu.conditioning import TextLine, build_conditions

    cond = build_conditions([TextLine(text, pos, font_size=FONT_SIZE)], width, height,
                            font_size=FONT_SIZE)
    line = cond.lines[0]
    out[f"{name}.text"] = np.asarray(text)
    out[f"{name}.position"] = np.asarray(pos, np.int32)
    for key in ARRAYS:
        out[f"{name}.{key}"] = getattr(line, key)
    out[f"{name}.glyph_canvas"] = cond.glyph_canvas


def conditions_arrays():
    out = {"size": np.asarray(SIZE), "font_size": np.asarray(FONT_SIZE)}
    for name, (text, pos) in REQUESTS.items():
        _line_arrays(out, name, text, pos, SIZE, SIZE)
    return out


def large_conditions_arrays():
    out = {"font_size": np.asarray(FONT_SIZE)}
    for name, (text, pos, (width, height)) in LARGE_REQUESTS.items():
        out[f"{name}.size"] = np.asarray((width, height), np.int32)
        _line_arrays(out, name, text, pos, width, height)
    return out


if __name__ == "__main__":
    makers = {PATH: conditions_arrays, LARGE_PATH: large_conditions_arrays}
    names = sys.argv[1:] or [os.path.basename(p) for p in makers]
    for path, make in makers.items():
        if os.path.basename(path) in names:
            np.savez_compressed(path, **make())
            print(f"wrote {path} ({os.path.getsize(path)} bytes)")
