"""The port's own copies of the JAX package's host code, held equal to the originals.

The port keeps its copies of ``configs.py``, ``conditioning/``,
``utils/image.py``, ``text.pad_to_common_length`` and the CLI's
``build_prompt`` so that it never imports the JAX package. Each is compared
here with the original on the same inputs: conditions bit for bit (DejaVu
font), the bidi pass on every recorded FriBidi case, every config's fields,
defaults and ``tiny()`` preset, and the image and token helpers exactly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import reptext_tpu.cli as jcli
import reptext_tpu.configs as jconfigs
import reptext_tpu.conditioning as jcond
from reptext_tpu.text import pad_to_common_length as j_pad
from reptext_tpu.utils import image as jimage
from reptext_tpu_torch import cli as tcli
from reptext_tpu_torch import conditioning as tcond
from reptext_tpu_torch import configs as tconfigs
from reptext_tpu_torch.text import pad_to_common_length as t_pad
from reptext_tpu_torch.utils import image as timage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIDI_CASES = json.load(open(os.path.join(ROOT, "tests", "fixtures", "bidi_cases.json"),
                            encoding="utf-8"))
CONFIGS = ["FluxConfig", "ControlNetConfig", "VAEConfig", "CLIPConfig", "CLIPVisionConfig",
           "IPAdapterConfig", "T5Config",
           "PipelineConfig"]

REQUESTS = {
    "arabic": ([("مرحبا بالعالم", (40, 60))], 256, 192, 40),
    "latin": ([("Hello, world", (16, 100))], 192, 256, 32),
    "multi_line": ([("سوق الذهب", (20, 30)), ("Gold Market 24", (10, 120)),
                    ("مفتوح ٢٤ ساعة", (30, 190))], 256, 256, 28),
}


def _font():
    try:
        return jcond.default_font_path()
    except FileNotFoundError:
        pytest.skip("no DejaVu font on this host")


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_build_conditions_is_bit_identical(name):
    font = _font()
    lines, width, height, font_size = REQUESTS[name]
    assert tcond.default_font_path() == font
    want = jcond.build_conditions([jcond.TextLine(t, p, font_size=font_size) for t, p in lines],
                                  width, height, font_path=font, font_size=font_size)
    got = tcond.build_conditions([tcond.TextLine(t, p, font_size=font_size) for t, p in lines],
                                 width, height, font_path=font, font_size=font_size)
    assert got.num_lines == want.num_lines == len(lines)
    np.testing.assert_array_equal(got.glyph_canvas, want.glyph_canvas)
    for g, w in zip(got.lines, want.lines):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name


def test_canny_is_identical():
    img = np.random.default_rng(0).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcond.inverted_canny_rgb(img), jcond.inverted_canny_rgb(img))
    np.testing.assert_array_equal(tcond.canny_edges(img[..., 0]), jcond.canny_edges(img[..., 0]))


@pytest.mark.parametrize("case", range(len(BIDI_CASES)))
def test_bidi_pass_matches_the_original(case):
    text = BIDI_CASES[case]["logical"]
    assert tcond.prepare_display_text(text) == jcond.prepare_display_text(text)
    assert tcond.bidi_reorder(text) == jcond.bidi_reorder(text)
    assert tcond.shape_arabic(text) == jcond.shape_arabic(text)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_defaults_and_tiny_are_equal(name):
    jcls, tcls = getattr(jconfigs, name), getattr(tconfigs, name)
    assert [(f.name, f.default, f.type) for f in dataclasses.fields(tcls)] == \
        [(f.name, f.default, f.type) for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    if hasattr(jcls, "tiny"):
        assert dataclasses.asdict(tcls().tiny()) == dataclasses.asdict(jcls().tiny())
    props = [p for p in dir(jcls) if isinstance(getattr(jcls, p), property)]
    assert props == [p for p in dir(tcls) if isinstance(getattr(tcls, p), property)]
    for p in props:
        assert getattr(tcls(), p) == getattr(jcls(), p)


def test_image_helpers_are_identical():
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.preprocess_images(img), jimage.preprocess_images(img))
    np.testing.assert_array_equal(timage.preprocess_images(img[0]),
                                  jimage.preprocess_images(img[0]))
    x = r.uniform(-1.3, 1.3, (2, 24, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.postprocess_images(x), jimage.postprocess_images(x))
    for shape, kw in (((300, 500, 3), {}), ((2000, 1500, 3), {}),
                      ((900, 700, 3), {"mode": "bilinear", "multiple": 16})):
        photo = r.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(timage.resize_to_multiple(photo, **kw),
                                      jimage.resize_to_multiple(photo, **kw))


def test_token_and_prompt_helpers_are_identical():
    a, b = np.arange(6).reshape(2, 3), np.arange(10).reshape(2, 5)
    for x, y in ((a, b), (b, a), (a, a)):
        for got, want in zip(t_pad(x, y, pad_id=7), j_pad(x, y, pad_id=7)):
            np.testing.assert_array_equal(got, want)
    for texts in (["مرحبا"], ["Hello", "你好"], []):
        assert tcli.build_prompt("a sign", texts, tcli.PROMPT_SUFFIX) == \
            jcli.build_prompt("a sign", texts, tcli.PROMPT_SUFFIX)
        assert [tcli.contains_cjk(t) for t in texts] == [jcli.contains_cjk(t) for t in texts]
