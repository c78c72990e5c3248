"""Record the conditions of chip_smoke.py's requests.

Run manually: ``python tests/record_conditions_fixture.py [FILE ...]`` writes
the named fixtures under ``tests/fixtures/`` (default: all three):

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

- ``overfit_conditions_128.npz``: the trained-weights demo's samples at 128^2
  (``reptext_tpu_torch/examples/overfit_e2e.py``), rendered with the port's
  ``conditioning/`` exactly as its ``build_overfit_set`` draws them: the 16
  ``TRAIN_WORDS`` at seed 7 (``train``), the 8 ``HOLDOUT_WORDS`` at seed 23
  (``holdout``), and the corpus-scaling pool ``synth_corpus(96)``: its 32
  holdout words at seed 23 (``corpus_holdout``) and the next 64 at seed 7
  (``corpus_train``, so that ``--corpus-scale`` up to 64 runs without a
  font). Per set ``<set>.words``, ``.seed``, ``.size``; per sample
  ``<set>.<i>.<array>`` for the line's glyph image, canny image, position and
  region masks, the glyph canvas, its bbox, colour, background, font size
  and position. The demo derives the target image from the canvas and the
  background; ``tests/test_torch_overfit.py`` checks the file against the
  port's renders.
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
OVERFIT_PATH = os.path.join(FIXTURES, "overfit_conditions_128.npz")
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


def overfit_sets():
    """{set name: (words, seed)} of the demo's fixture."""
    from reptext_tpu_torch.examples import overfit_e2e as demo

    pool = demo.synth_corpus(demo.CORPUS_MAX + demo.CORPUS_HOLDOUT)
    return {"train": (demo.TRAIN_WORDS, demo.TRAIN_SEED),
            "holdout": (demo.HOLDOUT_WORDS, demo.HOLDOUT_SEED),
            "corpus_holdout": (pool[:demo.CORPUS_HOLDOUT], demo.HOLDOUT_SEED),
            "corpus_train": (pool[demo.CORPUS_HOLDOUT:], demo.TRAIN_SEED)}


def overfit_conditions_arrays():
    from reptext_tpu_torch.examples import overfit_e2e as demo

    out = {}
    for name, (words, seed) in overfit_sets().items():
        out[f"{name}.words"] = np.asarray(words)
        out[f"{name}.seed"] = np.asarray(seed)
        out[f"{name}.size"] = np.asarray(demo.SIZE)
        samples = demo.render_overfit_set(demo.SIZE, words, seed)
        for i, (s, (font_size, pos, color, bg)) in enumerate(
                zip(samples, demo._placements(words, demo.SIZE, seed))):
            line = s["conds"].lines[0]
            for key in demo.LINE_ARRAYS:
                out[f"{name}.{i}.{key}"] = getattr(line, key)
            out[f"{name}.{i}.glyph_canvas"] = s["conds"].glyph_canvas
            out[f"{name}.{i}.bbox"] = np.asarray(line.bbox, np.int32)
            out[f"{name}.{i}.color"] = np.asarray(color, np.int32)
            out[f"{name}.{i}.bg"] = np.asarray(bg, np.int32)
            out[f"{name}.{i}.font_size"] = np.asarray(font_size)
            out[f"{name}.{i}.position"] = np.asarray(pos, np.int32)
    return out


if __name__ == "__main__":
    makers = {PATH: conditions_arrays, LARGE_PATH: large_conditions_arrays,
              OVERFIT_PATH: overfit_conditions_arrays}
    names = sys.argv[1:] or [os.path.basename(p) for p in makers]
    for path, make in makers.items():
        if os.path.basename(path) in names:
            np.savez_compressed(path, **make())
            print(f"wrote {path} ({os.path.getsize(path)} bytes)")
