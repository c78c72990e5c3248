"""The port's OCR judge, crop and OCR loss against the JAX package's, on the CPU.

- the judge (``eval/ocr.py``) on the committed ``benchmarks/ocr_judge.npz``
  against ``OCRJudge().apply`` on seeded inputs, its greedy decode, and
  ``char_accuracy`` on DejaVu renders; ``save_judge``/``load_judge``, the
  charset check, one ``train_judge`` step against the optax step it ports;
- the host copies (rendering, canonicalisation, batches, the label boxes,
  ``utils/text_span.py``) equal to the originals;
- ``crop_and_resize`` (values and gradients to the images and the boxes),
  ``standardize_crops`` (population std) and ``ocr_ctc_loss`` (value and
  gradient w.r.t. the images, an empty label, non-uniform sample weights)
  against ``jax.grad`` and ``optax.ctc_loss``.

Tolerance: rtol = atol = 5e-4 (TOL) unless a test says why not. The port is
NCHW where the JAX package is NHWC; inputs are permuted once at the boundary.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reptext_tpu.eval import ocr as jocr
from reptext_tpu.ops.crop import crop_and_resize as j_crop
from reptext_tpu.sampling import ocr_loss as jloss
from reptext_tpu.utils import text_span as jspan
from reptext_tpu_torch.eval import ocr as tocr
from reptext_tpu_torch.ops.crop import crop_and_resize as t_crop
from reptext_tpu_torch.sampling import ocr_loss as tloss
from reptext_tpu_torch.utils import text_span as tspan

from torch_port_util import TOL

WORDS = ["مرحبا", "HELLO", "2026", "Cafe"]


def _has_font():
    try:
        from reptext_tpu_torch.conditioning import default_font_path

        return os.path.isfile(default_font_path())
    except (ImportError, FileNotFoundError):
        return False


needs_font = pytest.mark.skipif(not _has_font(), reason="no DejaVu font on this host")


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jocr.load_judge()


@functools.lru_cache(maxsize=None)
def _judge():
    return tocr.load_judge(device="cpu")


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def _inputs(seed=0, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, tocr.IMG_H, tocr.IMG_W, 1)).astype(np.float32)


# ------------------------------------------------------------------ the judge


def test_judge_on_the_committed_weights_matches_jax():
    x = _inputs()
    want = np.asarray(jocr.OCRJudge().apply(_jax_params(), jnp.asarray(x)))
    got = _judge()(tocr.to_nchw(x)).detach().numpy()
    assert got.shape == (4, tocr.FRAMES, len(tocr.CHARSET) + 1)
    np.testing.assert_allclose(got, want, **TOL)
    assert tocr.decode_logits(got) == jocr.decode_logits(want)
    # the loaded judge is frozen and float32
    assert all(not p.requires_grad and p.dtype == torch.float32
               for p in _judge().parameters())


def test_same_padding_is_the_xla_rule():
    """SAME pads a stride-2 3x3 kernel (0, 1) on an even axis, (1, 1) at stride 1."""
    assert tocr.same_pads(48, 3, 2) == (0, 1)
    assert tocr.same_pads(256, 3, 2) == (0, 1)
    assert tocr.same_pads(64, 3, 1) == (1, 1)
    assert tocr.same_pads(64, 5, 1) == (2, 2)
    assert tocr.same_pads(7, 3, 2) == (1, 1)


def test_judge_flax_names_map_to_the_module():
    flat = np.load(tocr.DEFAULT_WEIGHTS)
    leaves = {k for k in flat.files if k != "__charset__"}
    mods = {n.rsplit(".", 1)[0] for n, _ in _judge().named_parameters()}
    assert mods == {k.split("/")[1] for k in leaves}
    assert mods == {f"Conv_{i}" for i in range(6)} | {"Dense_0", "Dense_1"}


def test_save_and_load_round_trip_and_the_charset_check(tmp_path):
    path = str(tmp_path / "judge.npz")
    tocr.save_judge(_judge(), path)
    with np.load(path) as a, np.load(tocr.DEFAULT_WEIGHTS) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the JAX loader reads what the port wrote
    x = _inputs(1, 2)
    np.testing.assert_allclose(
        np.asarray(jocr.OCRJudge().apply(jocr.load_judge(path), jnp.asarray(x))),
        np.asarray(jocr.OCRJudge().apply(_jax_params(), jnp.asarray(x))), rtol=0, atol=0)
    # weights trained for another charset are refused
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    flat["__charset__"] = flat["__charset__"][:-1]
    bad = str(tmp_path / "other_charset.npz")
    np.savez(bad, **flat)
    with pytest.raises(ValueError, match="different charset"):
        tocr.load_judge(bad, device="cpu")
    with pytest.raises(ValueError, match="different charset"):
        jocr.load_judge(bad)
    assert len(tocr.load_judge_ensemble(device="cpu")) == len(jocr.load_judge_ensemble())


def test_load_judge_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tocr.load_judge()


@needs_font
def test_char_accuracy_on_renders_matches_jax():
    clean = [tocr.render_word(w, font_size=40) for w in WORDS]
    rng = np.random.default_rng(0)
    noisy = [np.clip(c + rng.normal(0, 0.35, c.shape), 0, 1).astype(np.float32)
             for c in clean]
    for regions in (clean, noisy, [1.0 - c for c in clean]):
        got = tocr.char_accuracy(regions, WORDS, _judge())
        want = jocr.char_accuracy(regions, WORDS, _jax_params())
        assert got == pytest.approx(want, abs=1e-6)
    assert tocr.char_accuracy(clean, WORDS, _judge()) > 0.9
    # an ensemble of one averages to the same value
    assert tocr.char_accuracy(clean, WORDS, [_judge()]) == pytest.approx(
        jocr.char_accuracy(clean, WORDS, [_jax_params()]), abs=1e-6)


def test_decode_and_edit_distance_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, tocr.FRAMES, len(tocr.CHARSET) + 1)).astype(np.float32)
    logits[:, ::2, 0] += 4.0   # blanks between frames
    assert tocr.decode_logits(logits) == jocr.decode_logits(logits)
    assert tocr.decode_logits(torch.from_numpy(logits)) == jocr.decode_logits(logits)
    for a, b in (("", "abc"), ("kitten", "sitting"), ("مرحبا", "مرحب"), ("abc", "")):
        assert tocr._edit_distance(a, b) == jocr._edit_distance(a, b)


def test_train_judge_step_matches_the_optax_step():
    """One Adam step (cosine decay, alpha 0.05) and the EMA from the same
    parameters and batch: the loss, the gradients (per leaf within 5e-4 of
    max|JAX grad|), and the updated parameters and EMA. Adam's first step is
    lr * g / (|g| + eps), which jumps by up to 2 lr where g is near 0 and its
    fp32 sums round to another sign, so the update is held within 2e-6
    where |g| is above 1e-3 of the leaf's max|g|, and within 2 lr elsewhere."""
    steps, lr = 10, 1e-3
    rng = np.random.default_rng(5)
    images = _inputs(6, 3)
    labels = np.zeros((3, tocr.MAX_LABEL), np.int32)
    paddings = np.ones((3, tocr.MAX_LABEL), np.float32)
    for i, w in enumerate(["AB", "مرحبا", "2026"]):
        ids = tocr.label_ids(w)
        labels[i, : len(ids)] = ids
        paddings[i, : len(ids)] = 0.0
    params = jax.tree_util.tree_map(lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(
        np.float32), jax.tree_util.tree_map(np.asarray, _jax_params()))
    model = jocr.OCRJudge()
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(images))
        return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), jnp.asarray(labels),
                              jnp.asarray(paddings)).mean()

    loss_j, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params))
    new_j = optax.apply_updates(params, updates)
    ema_j = jax.tree_util.tree_map(lambda e, q: 0.999 * e + 0.001 * q, params, new_j)

    from reptext_tpu_torch.io.from_jax import flatten_jax_params, load_jax_params

    judge = load_jax_params(tocr.OCRJudge(), params)
    step, ema = tocr.make_judge_train_step(judge, steps, lr)
    grads_t = {}
    for n, p in judge.named_parameters():
        p.register_hook(functools.partial(grads_t.__setitem__, n))
    loss_t = step(tocr.to_nchw(images), torch.from_numpy(labels), torch.from_numpy(paddings))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    g_j = flatten_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    for tree, module, mix in ((new_j, judge, 1.0), (ema_j, ema, 0.001)):
        want = flatten_jax_params(jax.tree_util.tree_map(np.asarray, tree))
        for n, p in module.named_parameters():
            g, got = g_j[n], p.detach().numpy()
            scale = float(np.abs(g).max())
            assert float(np.abs(grads_t[n].numpy() - g).max()) <= 5e-4 * scale, n
            big = np.abs(g) > 1e-3 * scale
            np.testing.assert_allclose(got[big], want[n][big], rtol=0, atol=2e-6, err_msg=n)
            np.testing.assert_allclose(got, want[n], rtol=0, atol=2 * lr * mix + 2e-6,
                                       err_msg=n)


# ------------------------------------------------------------------ host copies


@needs_font
def test_render_word_and_crop_host_code_equal_the_originals():
    for w, size in (("مرحبا بالعالم", 40), ("Hello World", 32), ("2026", 24)):
        r_t, r_j = tocr.render_word(w, font_size=size), jocr.render_word(w, font_size=size)
        np.testing.assert_array_equal(r_t, r_j)
        np.testing.assert_array_equal(tocr._canonicalize(r_t), jocr._canonicalize(r_j))
        np.testing.assert_array_equal(tocr._resize_box(r_t), jocr._resize_box(r_j))
        np.testing.assert_array_equal(tocr.prepare_crop(r_t), jocr.prepare_crop(r_j))
        rgb = np.stack([r_t * 200, r_t * 100, r_t * 50], axis=-1).astype(np.uint8)
        np.testing.assert_array_equal(tocr.prepare_crop(rgb), jocr.prepare_crop(rgb))


def test_host_crop_code_on_arrays_equals_the_originals():
    rng = np.random.default_rng(8)
    flat = np.full((20, 30), 0.4, np.float32)
    tiny = rng.random((3, 3)).astype(np.float32)
    noise = rng.random((40, 90)).astype(np.float32)
    dark = np.zeros((30, 80), np.float32)
    dark[10:20, 15:60] = 0.9
    for g in (flat, tiny, noise, dark, dark * 255.0, np.zeros((0, 5), np.float32)):
        np.testing.assert_array_equal(tocr._canonicalize(g), jocr._canonicalize(g))
        np.testing.assert_array_equal(tocr._resize_box(g), jocr._resize_box(g))
    np.testing.assert_array_equal(tocr._standardize(noise), jocr._standardize(noise))
    for s in range(3):
        a, b = np.random.default_rng(s), np.random.default_rng(s)
        assert tocr.random_word(a) == jocr.random_word(b)
        assert tocr.confusion_word(a) == jocr.confusion_word(b)
        img = rng.random((tocr.IMG_H, tocr.IMG_W)).astype(np.float32)
        np.testing.assert_array_equal(tocr._augment(img, a, harsh=bool(s % 2)),
                                      jocr._augment(img, b, harsh=bool(s % 2)))
    assert (tocr.CHARSET, tocr.CHAR_TO_ID, tocr.IMG_H, tocr.IMG_W, tocr.FRAMES,
            tocr.MAX_LABEL, tocr.CONFUSION_GROUPS) == (
        jocr.CHARSET, jocr.CHAR_TO_ID, jocr.IMG_H, jocr.IMG_W, jocr.FRAMES, jocr.MAX_LABEL,
        jocr.CONFUSION_GROUPS)


@needs_font
def test_make_batch_and_render_cache_equal_the_originals():
    """Same rng -> the same arrays and texts, from a render cache and without."""
    cache_t = tocr.RenderCache(6, np.random.default_rng(1))
    cache_j = jocr.RenderCache(6, np.random.default_rng(1))
    assert cache_t.texts == cache_j.texts
    for a, b in zip(cache_t.images, cache_j.images):
        np.testing.assert_array_equal(a, b)
    for kw_t, kw_j in (({"cache": cache_t, "harsh_frac": 0.5},
                        {"cache": cache_j, "harsh_frac": 0.5}),
                       ({"words": WORDS}, {"words": WORDS})):
        got = tocr.make_batch(np.random.default_rng(2), 3, **kw_t)
        want = jocr.make_batch(np.random.default_rng(2), 3, **kw_j)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


def test_label_boxes_equal_the_originals():
    canvas = np.zeros((64, 96, 3), np.uint8)
    assert tloss.glyph_ink_bbox(canvas) is None and jloss.glyph_ink_bbox(canvas) is None
    canvas[10:20, 5:70, 1] = 200
    assert tloss.glyph_ink_bbox(canvas) == jloss.glyph_ink_bbox(canvas) == (10, 5, 20, 70)
    for bbox, hw in (((10, 5, 20, 70), (64, 96)), ((0, 0, 40, 20), (64, 96)),
                     ((3, 3, 4, 4), (32, 32)), ((100, 200, 180, 900), (1024, 1024))):
        np.testing.assert_array_equal(tloss.aspect_box(bbox, *hw), jloss.aspect_box(bbox, *hw))


def test_text_span_equals_the_original():
    prompt = [5, 9, 12, 7, 12, 7, 3, 1, 0, 0]
    lines = [[12, 7, 1], [3], [8, 8], [], [0, 1]]
    assert tspan.find_token_span(prompt, [12, 7]) == jspan.find_token_span(prompt, [12, 7])
    assert tspan.find_token_span(prompt, list(range(20))) is None
    assert tspan.render_text_spans(prompt, lines) == jspan.render_text_spans(prompt, lines)
    for span in ((2, 4), None):
        np.testing.assert_array_equal(tspan.span_mask(10, span), jspan.span_mask(10, span))


# ---------------------------------------------------------- crop and the loss


def _boxes():
    # one inside, two reaching past the image edge (the clamp), one flat row span
    return np.asarray([[0.21, 0.13, 0.67, 0.88],
                       [-0.3, 0.52, 0.43, 1.37],
                       [0.05, -0.41, 1.22, 0.61],
                       [0.33, 0.07, 0.58, 0.93]], np.float32)


def test_crop_and_resize_values_and_gradients_match_jax():
    rng = np.random.default_rng(11)
    imgs = rng.standard_normal((4, 2, 24, 40)).astype(np.float32)
    boxes = _boxes()
    cot = rng.standard_normal((4, 2, 6, 20)).astype(np.float32)

    def jf(i, b):
        return jnp.sum(j_crop(i, b, 6, 20) * jnp.asarray(cot).transpose(0, 2, 3, 1))

    want = np.asarray(j_crop(jnp.asarray(_nhwc(imgs)), jnp.asarray(boxes), 6, 20))
    g_img, g_box = jax.grad(jf, argnums=(0, 1))(jnp.asarray(_nhwc(imgs)), jnp.asarray(boxes))
    ti = torch.tensor(imgs, requires_grad=True)
    tb = torch.tensor(boxes, requires_grad=True)
    out = t_crop(ti, tb, 6, 20)
    np.testing.assert_allclose(_nhwc(out.detach()), want, **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(ti.grad), np.asarray(g_img), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(g_box), **TOL)
    assert np.abs(tb.grad.numpy()).max() > 0


def test_crop_linear_ramp_is_exact():
    h, w = 32, 64
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = torch.from_numpy((2.0 * ys + 3.0 * xs)[None, None])
    box = np.asarray([[0.25, 0.125, 0.75, 0.625]], np.float32)
    out = t_crop(img, torch.from_numpy(box), 8, 16)[0, 0].numpy()
    y0, x0, y1, x1 = box[0]
    ey = (y0 + (np.arange(8) + 0.5) / 8 * (y1 - y0)) * h - 0.5
    ex = (x0 + (np.arange(16) + 0.5) / 16 * (x1 - x0)) * w - 0.5
    np.testing.assert_allclose(out, 2.0 * ey[:, None] + 3.0 * ex[None, :], rtol=1e-5)


def test_standardize_crops_uses_the_population_std():
    x = np.random.default_rng(12).standard_normal((3, 1, 8, 16)).astype(np.float32) * 3 + 1
    got = tloss.standardize_crops(torch.from_numpy(x)).numpy()
    want = np.asarray(jloss.standardize_crops(jnp.asarray(_nhwc(x))))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    # the sample std (correction 1) would be off by sqrt(n / (n - 1))
    np.testing.assert_allclose(got.std(axis=(1, 2, 3)), 1.0, rtol=1e-4)


def _label_batch():
    labels = np.zeros((4, tocr.MAX_LABEL), np.int32)
    paddings = np.ones((4, tocr.MAX_LABEL), np.float32)
    # an empty label (no character of the charset) and a repeated character
    for i, w in enumerate(["HELLO", "#!", "مرحبا", "2026 AAB"]):
        ids = tocr.label_ids(w)
        labels[i, : len(ids)] = ids
        paddings[i, : len(ids)] = 0.0
    return labels, paddings


@pytest.mark.parametrize("weighted", [False, True])
def test_ocr_ctc_loss_value_and_gradient_match_optax(weighted):
    rng = np.random.default_rng(13)
    imgs = (0.5 * rng.standard_normal((4, 3, 64, 96))).astype(np.float32)
    boxes = _boxes()
    labels, paddings = _label_batch()
    sw = np.asarray([0.9, 0.5, 0.2, 0.7], np.float32) if weighted else None
    params = _jax_params()

    def jf(i):
        return jloss.ocr_ctc_loss(i, jnp.asarray(boxes), jnp.asarray(labels),
                                  jnp.asarray(paddings), params,
                                  sample_weights=None if sw is None else jnp.asarray(sw))

    loss_j, g_j = jax.value_and_grad(jf)(jnp.asarray(_nhwc(imgs)))
    ti = torch.tensor(imgs, requires_grad=True)
    loss_t = tloss.ocr_ctc_loss(ti, torch.from_numpy(boxes), torch.from_numpy(labels),
                                torch.from_numpy(paddings), _judge(),
                                None if sw is None else torch.from_numpy(sw))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    g_j = np.asarray(g_j)
    assert np.isfinite(ti.grad.numpy()).all()
    # per element within 5e-4 of max|JAX grad| (fp32 through the judge and CTC)
    scale = float(np.abs(g_j).max())
    assert float(np.abs(_nhwc(ti.grad) - g_j).max()) <= 5e-4 * scale
    # the empty label's sample gives nothing: its image gets no gradient
    assert not ti.grad[1].any()


def test_per_sample_ctc_matches_optax():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((4, tocr.FRAMES, len(tocr.CHARSET) + 1)).astype(np.float32)
    labels, paddings = _label_batch()
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.zeros((4, tocr.FRAMES)),
                                     jnp.asarray(labels), jnp.asarray(paddings)))
    got = tocr.ctc_losses(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(paddings)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
