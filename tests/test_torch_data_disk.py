"""The port's photo-corpus loader and the batches' OCR fields against the JAX
package's, on the CPU, and the train CLI with the OCR term and a corpus.

- ``DiskImageTextDataset``: sample specs equal to the JAX dataset's, key for
  key, over two epochs of a corpus of seeded PNGs of several sizes (the
  permutation, the line picked per visit, the rescaled positions and font
  sizes), sharding, the validation errors, the image resize and cache, and
  the batch contract through the tiny port pipeline;
- ``data.py``'s ``ocr_boxes``, ``ocr_labels`` and ``ocr_paddings`` equal to
  what the JAX ``GlyphTextDataset.batch`` makes for the same specs (its
  encoders stubbed: the fields come from the specs and the rendered glyph
  canvas alone);
- ``--mode train --ocr-loss-weight 0.3 --corpus-dir``: two steps, a finite
  loss; a judge trained for another charset and a corpus without ``lines``
  are refused.
"""

import json
import math
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from reptext_tpu import configs as jconfigs
from reptext_tpu import data as jdata
from reptext_tpu import data_disk as jdisk
from reptext_tpu_torch import cli
from reptext_tpu_torch import data_disk as tdisk
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.data import GlyphTextDataset
from reptext_tpu_torch.eval import ocr as tocr
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

H = W = 64
WORDS = ["CAFE", "Stop!", "سوق", "نور", "2026", "قهوة مرة"]


def write_corpus(root, n=5, sizes=((96, 80), (120, 200), (64, 64))):
    """Seeded numpy 'photos' of several sizes (h, w) and annotations.jsonl;
    records with one, two or three lines, some without font size or color."""
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    rng = np.random.default_rng(3)
    with open(os.path.join(root, "annotations.jsonl"), "w", encoding="utf-8") as f:
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, f"imgs/{i}.png"))
            lines = [{"text": WORDS[(i + j) % len(WORDS)], "position": [4 + 3 * j, 10 + 20 * j],
                      "font_size": 20 - j, "color": [255, 255 - 40 * j, 255]}
                     for j in range(1 + i % 3)]
            if i % 2:
                del lines[0]["font_size"], lines[0]["color"]
            f.write(json.dumps({"image": f"imgs/{i}.png", "prompt": f"a sign number {i}",
                                "lines": lines}, ensure_ascii=False) + "\n")
            if i == 1:
                f.write("\n")   # blank lines are skipped
    return str(root)


def _stub(cfg):
    return types.SimpleNamespace(pipe_cfg=cfg)


def _tok(prompt):
    return np.zeros((1, 4), np.int64), np.zeros((1, 8), np.int64)


def _pair(corpus, seed=5, batch_size=2, shard=(0, 1)):
    jds = jdisk.DiskImageTextDataset(_stub(jconfigs.PipelineConfig(height=H, width=W)),
                                     corpus, batch_size=batch_size, tokenize=_tok, seed=seed,
                                     shard=shard)
    tds = tdisk.DiskImageTextDataset(_stub(PipelineConfig(height=H, width=W)), corpus,
                                     batch_size=batch_size, tokenize=_tok, seed=seed,
                                     shard=shard)
    return jds, tds


@pytest.mark.parametrize("seed,batch_size", [(5, 2), (0, 3)])
def test_specs_equal_the_jax_datasets_over_two_epochs(tmp_path, seed, batch_size):
    corpus = write_corpus(tmp_path, n=5)
    jds, tds = _pair(corpus, seed, batch_size)
    n = len(tds.records)
    steps = -(-2 * n // batch_size) + 1          # past the second epoch's end
    for step in range(steps):
        for i in range(batch_size):
            want = jds.sample_spec(step, i)
            got = tds.sample_spec(step, i)
            assert got == want, (step, i)
    # an epoch visits every record once
    paths = {tds.sample_spec(k // batch_size, k % batch_size)["image_path"] for k in range(n)}
    assert len(paths) == n
    # every line of a multi-line record is picked in some visit
    texts = {tds.sample_spec(k // batch_size, k % batch_size)["text"] for k in range(40 * n)}
    assert texts == {ln["text"] for r in tds.records for ln in r["lines"]}


def test_specs_rescale_to_the_training_size(tmp_path):
    corpus = write_corpus(tmp_path, n=3)
    _, tds = _pair(corpus, batch_size=1)
    for k in range(6):
        spec = tds.sample_spec(k, 0)
        rec = next(r for r in tds.records if spec["image_path"].endswith(r["image"]))
        h, w = np.asarray(Image.open(spec["image_path"])).shape[:2]
        sx, sy = W / w, H / h
        entry = next(ln for ln in rec["lines"] if ln["text"] == spec["text"])
        x, y = entry["position"]
        assert spec["position"] == (int(round(x * sx)), int(round(y * sy)))
        fs = float(entry.get("font_size", max(16, int(h / 8))))
        assert spec["font_size"] == max(8, int(round(fs * (sx + sy) / 2)))
        assert spec["color"] == tuple(entry.get("color", (255, 255, 255)))
        assert spec["prompt"] == rec["prompt"]


def test_sharding_interleaves_disjoint_records(tmp_path):
    corpus = write_corpus(tmp_path, n=6)
    shards = [_pair(corpus, batch_size=1, shard=(i, 3)) for i in range(3)]
    images = [[r["image"] for r in tds.records] for _, tds in shards]
    assert images == [[r["image"] for r in jds.records] for jds, _ in shards]
    assert images == [[f"imgs/{i}.png", f"imgs/{i + 3}.png"] for i in range(3)]
    for jds, tds in shards:
        assert [tds.sample_spec(k, 0) for k in range(4)] == [jds.sample_spec(k, 0)
                                                             for k in range(4)]
    with pytest.raises(ValueError, match="bad shard"):
        _pair(corpus, shard=(3, 3))
    with pytest.raises(ValueError, match="is empty"):
        _pair(write_corpus(tmp_path / "one", n=1), shard=(1, 2))


@pytest.mark.parametrize("record,match", [
    ({"image": "x.png", "lines": []}, "non-empty 'lines'"),
    ({"image": "x.png"}, "non-empty 'lines'"),                   # lacks lines
    ({"lines": [{"text": "a", "position": [0, 0]}]}, "needs 'image'"),
    ({"image": "x.png", "lines": [{"text": "a"}]}, "needs 'text' and 'position'"),
    (None, "empty corpus"),
])
def test_validation_errors_match_jax(tmp_path, record, match):
    with open(tmp_path / "annotations.jsonl", "w") as f:
        if record is not None:
            f.write(json.dumps(record) + "\n")
    for load in (tdisk.load_annotations, jdisk.load_annotations):
        with pytest.raises(ValueError, match=match):
            load(str(tmp_path))


def test_images_resize_bilinear_and_cache(tmp_path):
    corpus = write_corpus(tmp_path, n=3)
    _, tds = _pair(corpus)
    path = os.path.join(corpus, "imgs/1.png")
    img = tds._load_image(path)
    want = np.asarray(Image.open(path).convert("RGB").resize((W, H), Image.BILINEAR))
    np.testing.assert_array_equal(img, want)
    assert tds._load_image(path) is img                     # cached
    tds._cache_limit = 1
    tds._load_image(os.path.join(corpus, "imgs/2.png"))
    assert list(tds._image_cache) == [os.path.join(corpus, "imgs/2.png")]
    assert tds._image_size(path) == (200, 120)


@pytest.fixture(scope="module")
def pipe():
    return FluxRepTextPipeline.create(
        FluxConfig().tiny(), ControlNetConfig().tiny(), VAEConfig().tiny(),
        PipelineConfig(height=H, width=W, num_inference_steps=2, controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(), seed=0, device="cpu")


def test_disk_batch_contract(pipe, tmp_path):
    corpus = write_corpus(tmp_path, n=4)
    ds = tdisk.DiskImageTextDataset(pipe, corpus, batch_size=2, seed=5)
    b, ref = ds.batch(0), GlyphTextDataset(pipe, batch_size=2, seed=5).batch(0)
    assert set(b) == set(ref)
    for key, v in ref.items():
        assert (b[key] is None) == (v is None), key
        if v is not None:
            assert b[key].shape == v.shape and b[key].dtype == v.dtype, key
    # the target is the photo, encoded as the pipeline encodes
    spec = ds.sample_spec(0, 1)
    _, g_img = ds.generators(0, 1)
    from reptext_tpu_torch.ops.latents import pack_latents

    with torch.no_grad():
        want = pack_latents(pipe._encode_scaled(
            pipe._images(ds._load_image(spec["image_path"])[None]), g_img))[0]
    torch.testing.assert_close(b["x0"][1], want, rtol=0, atol=0)
    assert ds.batch(0)["ocr_labels"].tolist() == b["ocr_labels"].tolist()


def _jax_stub_pipeline(cfg):
    """The JAX dataset's pipeline, with the encoders replaced by zeros: its
    OCR fields come from the specs and the glyph canvas alone."""
    def prepare_control_tokens(conds, rng):
        return jnp.zeros((1, 16, 8)), jnp.zeros((1, 16, 1))

    return types.SimpleNamespace(
        pipe_cfg=cfg, prepare_control_tokens=prepare_control_tokens,
        _encode_scaled=lambda img, rng: jnp.zeros((1, 8, 8, 16)),
        encode_prompt=lambda c, t5: (jnp.zeros((c.shape[0], 8, 32)),
                                     jnp.zeros((c.shape[0], 32))),
        flux=types.SimpleNamespace(config=types.SimpleNamespace(guidance_embeds=False)))


def test_ocr_fields_equal_the_jax_datasets(pipe):
    words = ["مرحبا", "OPEN", "Cafe 24", "سوق!", "#?"]   # the last has no charset character
    tds = GlyphTextDataset(pipe, batch_size=3, words=words, seed=11)
    jds = jdata.GlyphTextDataset(_jax_stub_pipeline(jconfigs.PipelineConfig(height=H, width=W)),
                                 batch_size=3, words=words, tokenize=_tok, seed=11)
    seen = set()
    for step in range(4):
        for i in range(3):
            spec = tds.sample_spec(step, i)
            assert spec == jds.sample_spec(step, i)
            seen.add(spec["text"])
        got, want = tds.batch(step), jds.batch(step)
        np.testing.assert_array_equal(got["ocr_boxes"].numpy(), np.asarray(want["ocr_boxes"]))
        np.testing.assert_array_equal(got["ocr_labels"].numpy(), np.asarray(want["ocr_labels"]))
        np.testing.assert_array_equal(got["ocr_paddings"].numpy(),
                                      np.asarray(want["ocr_paddings"]))
        assert got["ocr_labels"].shape == (3, tocr.MAX_LABEL)
    assert len(seen) >= 4


def test_ocr_fields_of_a_blank_canvas_and_case(pipe, monkeypatch):
    """A blank glyph canvas gives the whole image as the box; labels keep case
    and drop characters outside the charset."""
    ds = GlyphTextDataset(pipe, batch_size=2, words=["Ab c!"], seed=0)
    real = ds.conditions

    def blank(spec, step, index):
        conds = real(spec, step, index)
        if index == 1:
            conds.glyph_canvas = np.zeros_like(conds.glyph_canvas)
        return conds

    monkeypatch.setattr(ds, "conditions", blank)
    b = ds.batch(0)
    np.testing.assert_array_equal(b["ocr_boxes"][1].numpy(), [0, 0, 1, 1])
    assert not np.array_equal(b["ocr_boxes"][0].numpy(), [0, 0, 1, 1])
    ids = [tocr.CHAR_TO_ID[c] for c in "Abc"]
    assert b["ocr_labels"][0, :4].tolist() == ids + [0]
    assert b["ocr_paddings"][0, :4].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_train_cli_with_the_ocr_term_and_a_corpus(tmp_path, capsys):
    corpus = write_corpus(tmp_path / "corpus", n=4)
    assert cli.main(["--mode", "train", "--tiny", "--device", "cpu", "--random-weights",
                     "--size", "64", "--train-steps", "2", "--batch-size", "2",
                     "--ocr-loss-weight", "0.3", "--corpus-dir", corpus]) == 0
    out = capsys.readouterr().out
    assert out.count("[step]") == 2
    losses = [float(v) for v in re.findall(r"'loss': ([-\d.naif]+)", out)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), out


def test_train_cli_refuses_a_judge_of_another_charset(tmp_path):
    with np.load(tocr.DEFAULT_WEIGHTS) as z:
        flat = {k: z[k] for k in z.files}
    flat["__charset__"] = flat["__charset__"][::-1]
    bad = str(tmp_path / "judge.npz")
    np.savez(bad, **flat)
    with pytest.raises(ValueError, match="different charset"):
        cli.main(["--mode", "train", "--tiny", "--device", "cpu", "--random-weights",
                  "--size", "64", "--train-steps", "1", "--ocr-loss-weight", "0.3",
                  "--ocr-judge", bad])


def test_train_cli_refuses_a_corpus_without_lines(tmp_path):
    with open(tmp_path / "annotations.jsonl", "w") as f:
        f.write(json.dumps({"image": "imgs/0.png", "prompt": "a sign"}) + "\n")
    with pytest.raises(ValueError, match="non-empty 'lines'"):
        cli.main(["--mode", "train", "--tiny", "--device", "cpu", "--random-weights",
                  "--size", "64", "--train-steps", "1", "--corpus-dir", str(tmp_path)])
