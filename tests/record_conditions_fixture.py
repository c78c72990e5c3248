"""Record the conditions of chip_smoke.py's two requests at 1024x1024.

Run manually: ``python tests/record_conditions_fixture.py`` writes
``tests/fixtures/conditions_1024.npz``. For each request (``arabic``,
``latin``) it holds the text line, its position and font size, and the
arrays ``build_conditions`` makes from them: the line's canny image,
position mask and region mask, and the glyph canvas. ``chip_smoke.py`` reads
the requests from this file, and uses its arrays only where the conditioning
frontend cannot run (no Pillow, or no font). ``tests/test_torch_pipeline.py``
checks the file against ``build_conditions``.
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
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "conditions_1024.npz")
ARRAYS = ("canny_image", "position_mask", "region_mask")


def conditions_arrays():
    from reptext_tpu.conditioning import TextLine, build_conditions

    out = {"size": np.asarray(SIZE), "font_size": np.asarray(FONT_SIZE)}
    for name, (text, pos) in REQUESTS.items():
        cond = build_conditions([TextLine(text, pos, font_size=FONT_SIZE)], SIZE, SIZE,
                                font_size=FONT_SIZE)
        line = cond.lines[0]
        out[f"{name}.text"] = np.asarray(text)
        out[f"{name}.position"] = np.asarray(pos, np.int32)
        for key in ARRAYS:
            out[f"{name}.{key}"] = getattr(line, key)
        out[f"{name}.glyph_canvas"] = cond.glyph_canvas
    return out


if __name__ == "__main__":
    np.savez_compressed(PATH, **conditions_arrays())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
