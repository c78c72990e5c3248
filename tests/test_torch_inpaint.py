"""The port's text inpainting slice against the JAX package, at tiny geometry
on the CPU in float32, with shared random weights: the nearest resize of the
mask, ``prepare_inpaint_cond``, the dual-ControlNet true-CFG sampler (3 steps,
2 lines, both condition shapes), and the inpaint pipeline end to end at
128x96 with the same packed noise as ``latents=``; also non-square txt2img,
the default negative prompt, the second conditions fixture, the chunked VAE
attention and the tiny ``--mode inpaint`` CLI.

JAX and PyTorch draw different posterior noise, so in the shared weights the
log-variance half of the VAE encoder's ``conv_out`` is zero with bias -30
(std = e^-15: the draw drops out on both sides). Tolerances: TOL (5e-4) on
latents and conditioning; the uint8 image within 2 levels.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.conditioning import TextLine, build_conditions
from reptext_tpu.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.nn.clip import CLIPTextEncoder as JCLIP
from reptext_tpu.nn.t5 import T5Encoder as JT5
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.ops.latents import prepare_latent_image_ids as j_img_ids
from reptext_tpu.pipelines import FluxRepTextInpaintPipeline as JInpaint
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu.utils.image import postprocess_images
from reptext_tpu_torch.ops.latents import prepare_latent_image_ids, resize_nearest
from reptext_tpu_torch.pipelines.inpaint import (
    DEFAULT_NEGATIVE_PROMPT, FluxRepTextInpaintPipeline, default_inpaint_controlnet_config,
)
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling.flow_match import build_schedule
from reptext_tpu_torch.sampling.sampler_inpaint import make_inpaint_sampler

from torch_port_util import TOL, port_config, port_configs_of, random_tree, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
CN_CFG = ControlNetConfig().tiny()
INP_CFG = dataclasses.replace(CN_CFG, extra_condition_channels=4)
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=CN_CFG, vae_cfg=VAEConfig().tiny(),
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=H, width=W, num_inference_steps=3,
                          controlnet_conditioning_step=2, guidance_scale=3.5,
                          true_guidance_scale=3.0)
# the same configs as the port's own classes, for the port's side
T_INP_CFG = default_inpaint_controlnet_config(port_config(CN_CFG))
T_CFGS = port_configs_of(CFGS)
T_PIPE_CFG = port_config(PIPE_CFG)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32)
NEG_CLIP = np.array([[4, 8, 9, 255, 0, 0, 0, 0]], np.int32)
NEG_T5 = np.array([[6, 2, 1, 0, 0, 0, 0, 0]], np.int32)


def _params():
    f, c, v = CFGS["flux_cfg"], CN_CFG, CFGS["vae_cfg"]
    s_img, z = PIPE_CFG.image_seq_len, jnp.zeros
    img_ids, txt_ids, g = z((s_img, 3)), z((4, 3)), jnp.ones((1,))

    def cn_tree(cfg, seed):
        return random_tree(JControlNet(cfg), z((1, s_img, cfg.in_channels)),
                           z((1, s_img, cfg.in_channels + cfg.extra_condition_channels)),
                           z((1, 4, cfg.joint_attention_dim)), z((1, cfg.pooled_projection_dim)),
                           z((1,)), img_ids, txt_ids, g, seed=seed)

    params = {
        "flux": random_tree(JFlux(f), z((1, s_img, f.in_channels)),
                            z((1, 4, f.joint_attention_dim)), z((1, f.pooled_projection_dim)),
                            z((1,)), img_ids, txt_ids, g, seed=11),
        "controlnet": cn_tree(c, 12),
        "inpaint_controlnet": cn_tree(INP_CFG, 13),
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=14),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=15),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=16),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0
    conv_out["bias"][v.latent_channels:] = -30.0
    return params


def _image_and_mask():
    r = np.random.default_rng(5)
    image = r.integers(0, 256, (H, W, 3), dtype=np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[30:70, 12:100] = 255
    return image, mask


@pytest.fixture(scope="module")
def pipes():
    params = _params()
    jpipe = JInpaint.create_inpaint(inpaint_cn_cfg=INP_CFG, pipe_cfg=PIPE_CFG, params=params,
                                    **CFGS)
    tpipe = FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=T_INP_CFG, pipe_cfg=T_PIPE_CFG, params=params, device="cpu", **T_CFGS)
    cond = build_conditions([TextLine("مرحبا", (20, 36), font_size=30)], W, H, font_size=30)
    return jpipe, tpipe, cond


def test_default_negative_prompt_is_the_reference_one():
    from reptext_tpu.pipelines.inpaint import DEFAULT_NEGATIVE_PROMPT as JAX_DEFAULT

    assert DEFAULT_NEGATIVE_PROMPT == JAX_DEFAULT
    assert T_INP_CFG == port_config(INP_CFG) and T_INP_CFG.extra_condition_channels == 4
    assert 4 * (T_INP_CFG.in_channels // 4 + 1) == T_INP_CFG.in_channels + 4 == 68


@pytest.mark.parametrize("src,dst", [((96, 128), (12, 16)), ((1152, 1536), (144, 192)),
                                     ((100, 77), (13, 9)), ((960, 1280), (120, 160))])
def test_resize_nearest_matches_jax(src, dst):
    """Half-pixel centres on non-square shrinks (F.interpolate's nearest differs)."""
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "nearest"))
    np.testing.assert_array_equal(resize_nearest(t(x), *dst).numpy(), want)
    if src[0] % dst[0]:
        legacy = torch.nn.functional.interpolate(t(x)[None, None], size=dst, mode="nearest")
        assert not np.array_equal(legacy[0, 0].numpy(), want)


def test_prepare_inpaint_cond_matches_jax(pipes):
    jpipe, tpipe, _ = pipes
    image, mask = _image_and_mask()
    want = jax.jit(lambda r: jpipe.prepare_inpaint_cond(image, mask, r))(jax.random.PRNGKey(2))
    got = tpipe.prepare_inpaint_cond(image, mask, torch.Generator().manual_seed(2))
    assert got.shape == (1, PIPE_CFG.image_seq_len, 68)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the last packed channel block is (1 - mask) on the latent grid
    assert set(np.unique(got[0, :, -4:].numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("per_image", [False, True], ids=["shared-conds", "per-image-conds"])
def test_inpaint_sampler_matches_jax(pipes, per_image):
    """3 steps, true CFG 3.0, 2 lines, RepText ControlNet gated to 2 steps."""
    jpipe, tpipe, _ = pipes
    b, n, s = 2, 2, PIPE_CFG.image_seq_len
    r = np.random.default_rng(21 + per_image)

    def rand(*shape):
        return r.standard_normal(shape).astype(np.float32)

    lat, inp = rand(b, s, 64), rand(b, s, 68)
    cond_shape, mask_shape = ((n, b, s, 128), (n, b, s, 1)) if per_image else \
        ((n, s, 128), (n, s, 1))
    cond, masks = rand(*cond_shape), r.uniform(0, 1, mask_shape).astype(np.float32)
    ctx, pooled, guidance = rand(2 * b, 6, 32), rand(2 * b, 32), np.full((b,), 3.5, np.float32)
    txt_ids = np.zeros((6, 3), np.float32)
    sampler = jpipe._get_inpaint_sampler(3, 3.0)
    want = sampler(jpipe.params["flux"], jpipe.params["controlnet"],
                   jpipe.params["inpaint_controlnet"], *map(jnp.asarray, (
                       lat, cond, masks, inp, ctx, pooled, txt_ids,
                       j_img_ids(PIPE_CFG.latent_height, PIPE_CFG.latent_width), guidance)))
    schedule = build_schedule(3, s)
    tsample = make_inpaint_sampler(tpipe.flux, tpipe.controlnet, tpipe.inpaint_controlnet,
                                   schedule, T_PIPE_CFG)
    with torch.inference_mode():
        got = tsample(*map(t, (lat, cond, masks, inp, ctx, pooled, txt_ids)),
                      prepare_latent_image_ids(PIPE_CFG.latent_height, PIPE_CFG.latent_width),
                      t(guidance))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_inpaint_pipeline_end_to_end_matches_jax(pipes):
    jpipe, tpipe, cond = pipes
    image, mask = _image_and_mask()
    noise = np.random.default_rng(7).standard_normal(
        (1, PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    ids = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, negative_clip_ids=NEG_CLIP,
               negative_t5_ids=NEG_T5)
    jlat = jpipe(cond, image=image, mask=mask, latents=jnp.asarray(noise), output_type="latent",
                 **{k: jnp.asarray(v) for k, v in ids.items()})
    jimg = postprocess_images(jpipe._decode(jlat))
    timings = {}
    tlat = tpipe(cond, image=image, mask=mask, latents=t(noise), output_type="latent",
                 timings=timings, **ids)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    timg = tpipe.decode(tlat)
    assert timg.shape == jimg.shape == (1, H, W, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 2
    assert set(timings) == {"encode_prompt", "prepare", "sample"}


def test_inpaint_num_images_matches_single_images(pipes):
    """Two images in one call equal the two made one at a time."""
    _, tpipe, cond = pipes
    image, mask = _image_and_mask()
    noise = np.random.default_rng(8).standard_normal(
        (2, PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    ids = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, negative_clip_ids=NEG_CLIP,
               negative_t5_ids=NEG_T5)
    both = tpipe(cond, image=image, mask=mask, num_images=2, latents=t(noise),
                 output_type="latent", **ids)
    for i in range(2):
        one = tpipe(cond, image=image, mask=mask, latents=t(noise[i:i + 1]),
                    output_type="latent", **ids)
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), rtol=1e-5, atol=1e-5)
    images = tpipe(cond, image=image, mask=mask, num_images=2, **ids)
    assert images.shape == (2, H, W, 3) and images.dtype == np.uint8


def test_inpaint_pipeline_checks_its_inputs(pipes):
    _, tpipe, cond = pipes
    image, mask = _image_and_mask()
    with pytest.raises(ValueError, match="image"):
        tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS)
    with pytest.raises(ValueError, match="negative"):
        tpipe(cond, image=image, mask=mask, clip_ids=CLIP_IDS, t5_ids=T5_IDS)


def test_from_pipeline_shares_the_modules(pipes):
    _, tpipe, _ = pipes
    base = FluxRepTextPipeline(tpipe.flux, tpipe.controlnet, tpipe.vae, T_PIPE_CFG,
                               clip=tpipe.clip, t5=tpipe.t5)
    other = dataclasses.replace(T_PIPE_CFG, height=64, width=64)
    inp = FluxRepTextInpaintPipeline.from_pipeline(base, T_INP_CFG, pipe_cfg=other)
    assert inp.flux is base.flux and inp.controlnet is base.controlnet and inp.vae is base.vae
    assert inp.t5 is base.t5 and inp.clip is base.clip and inp.pipe_cfg is other
    assert inp.inpaint_controlnet.controlnet_x_embedder.in_features == 68
    assert base.with_config(other).flux is base.flux
    assert len(base.generators(0)) == 4


def test_txt2img_non_square_matches_jax(pipes):
    """txt2img at 128x96 (width x height) through both packages' pipelines."""
    params = _params()
    cfg = dataclasses.replace(PIPE_CFG, num_inference_steps=2, controlnet_conditioning_step=1)
    jpipe = JPipeline.create(pipe_cfg=cfg, params={k: v for k, v in params.items()
                                                   if k != "inpaint_controlnet"}, **CFGS)
    _, tpipe, cond = pipes
    tpipe = FluxRepTextPipeline(tpipe.flux, tpipe.controlnet, tpipe.vae, port_config(cfg),
                                clip=tpipe.clip,
                                t5=tpipe.t5)
    noise = np.random.default_rng(9).standard_normal(
        (1, cfg.image_seq_len, 64)).astype(np.float32)
    jlat = jpipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                 latents=jnp.asarray(noise), output_type="latent")
    tlat = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise), output_type="latent")
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    img = tpipe.decode(tlat)
    assert img.shape == (1, H, W, 3)
    jimg = postprocess_images(jpipe._decode(jlat))
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 2


def test_vae_attention_query_chunks_change_nothing(pipes):
    _, tpipe, _ = pipes
    attn = tpipe.vae.decoder.mid_attn if hasattr(tpipe.vae.decoder, "mid_attn") else \
        tpipe.vae.encoder.mid_attn
    x = t(np.random.default_rng(4).standard_normal((2, 16, 6, 10)))
    with torch.no_grad():
        whole = attn(x)
        attn.query_chunk = 7
        try:
            chunked = attn(x)
        finally:
            del attn.query_chunk
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)


def test_conditions_fixture_large_matches_build_conditions():
    """tests/fixtures/conditions_large.npz (chip_smoke.py's 1536x1152,
    1280x960 and 1536^2 requests) is what build_conditions makes."""
    data = np.load(os.path.join(ROOT, "tests", "fixtures", "conditions_large.npz"))
    font_size = int(data["font_size"])
    for name in ("inpaint_1536x1152", "inpaint_1280x960", "txt2img_1536"):
        w, h = (int(v) for v in data[f"{name}.size"])
        pos = tuple(int(v) for v in data[f"{name}.position"])
        cond = build_conditions([TextLine(str(data[f"{name}.text"]), pos, font_size=font_size)],
                                w, h, font_size=font_size)
        line = cond.lines[0]
        for key in ("canny_image", "position_mask", "region_mask"):
            np.testing.assert_array_equal(data[f"{name}.{key}"], getattr(line, key))
        np.testing.assert_array_equal(data[f"{name}.glyph_canvas"], cond.glyph_canvas)
        assert cond.glyph_canvas.shape == (h, w, 3)


def test_tiny_cli_inpaint_writes_an_image(tmp_path):
    from PIL import Image

    from reptext_tpu_torch import cli

    image, mask = _image_and_mask()
    Image.fromarray(image).save(tmp_path / "photo.png")
    Image.fromarray(mask).save(tmp_path / "mask.png")
    out = tmp_path / "edited.png"
    assert cli.main(["--mode", "inpaint", "--image", str(tmp_path / "photo.png"),
                     "--mask", str(tmp_path / "mask.png"), "--text", "مرحبا", "--position",
                     "40", "200", "--steps", "1", "--random-weights", "--tiny",
                     "--device", "cpu", "--font-size", "48", "--true-guidance-scale", "3.5",
                     "--output", str(out)]) == 0
    # resize_to_multiple: the long side 128 -> 768, both sides multiples of 64
    assert Image.open(out).size == (768, 576)
    with pytest.raises(SystemExit):
        cli.main(["--mode", "inpaint", "--text", "a", "--position", "0", "0",
                  "--random-weights", "--tiny"])
