"""The port's txt2img slice end to end against the JAX pipeline, at tiny
geometry on the CPU in float32: conditions -> CLIP/T5 -> VAE condition
encode -> 2 sampler steps (ControlNet on for step 0) -> VAE decode, with
shared random weights and the same packed noise passed as ``latents=``.

JAX and PyTorch draw different posterior noise, so in the shared weights the
log-variance half of the VAE encoder's ``conv_out`` is zero with bias -30:
std = e^-15 and the draw drops out on both sides with no change to either.
Tolerances: packed latents TOL (5e-4); the uint8 image within 2 levels.

Also: the glyph-latent init with given noise, the conditions fixture of
chip_smoke.py, the tiny CLI, and that the port never loads jax.
"""

import ast
import importlib.util
import os
import subprocess
import sys

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
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu.utils.image import postprocess_images
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

from torch_port_util import TOL, port_config, port_configs_of, random_tree, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
            vae_cfg=VAEConfig().tiny(), clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                          controlnet_conditioning_step=1, guidance_scale=3.5)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32)


def _shared_params():
    f, c, v = CFGS["flux_cfg"], CFGS["cn_cfg"], CFGS["vae_cfg"]
    s_img, z = PIPE_CFG.image_seq_len, jnp.zeros
    img_ids, txt_ids, g = z((s_img, 3)), z((4, 3)), jnp.ones((1,))
    params = {
        "flux": random_tree(JFlux(f), z((1, s_img, f.in_channels)), z((1, 4, f.joint_attention_dim)),
                            z((1, f.pooled_projection_dim)), z((1,)), img_ids, txt_ids, g, seed=1),
        "controlnet": random_tree(JControlNet(c), z((1, s_img, c.in_channels)),
                                  z((1, s_img, c.in_channels + c.extra_condition_channels)),
                                  z((1, 4, c.joint_attention_dim)), z((1, c.pooled_projection_dim)),
                                  z((1,)), img_ids, txt_ids, g, seed=2),
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=3),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=4),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=5),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    c_lat = v.latent_channels
    conv_out["kernel"][..., c_lat:] = 0.0
    conv_out["bias"][c_lat:] = -30.0
    return params


@pytest.fixture(scope="module")
def pipes():
    params = _shared_params()
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=params, **CFGS)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=params,
                                       device="cpu", **port_configs_of(CFGS))
    cond = build_conditions([TextLine("مرحبا", (20, 40), font_size=36)], SIZE, SIZE,
                            font_size=36)
    return jpipe, tpipe, cond


def test_slice_end_to_end_matches_jax(pipes):
    jpipe, tpipe, cond = pipes
    c = CFGS["vae_cfg"].latent_channels
    noise = np.random.default_rng(7).standard_normal(
        (1, PIPE_CFG.image_seq_len, 4 * c)).astype(np.float32)
    jlat = jpipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                 latents=jnp.asarray(noise), output_type="latent")
    jimg = postprocess_images(jpipe._decode(jlat))
    tlat = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise), output_type="latent")
    timg = tpipe.decode(tlat)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    assert timg.shape == jimg.shape == (1, SIZE, SIZE, 3) and timg.dtype == np.uint8
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 2
    # the default output is the same image
    np.testing.assert_array_equal(
        tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise)), timg)


def test_encode_prompt_and_control_tokens_match_jax(pipes):
    jpipe, tpipe, cond = pipes
    jseq, jpooled = jpipe.encode_prompt(jnp.asarray(CLIP_IDS), jnp.asarray(T5_IDS))
    tseq, tpooled = tpipe.encode_prompt(CLIP_IDS, T5_IDS)
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq), **TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled), **TOL)
    jtok, jmask = jpipe.prepare_control_tokens(cond, jax.random.PRNGKey(1))
    ttok, tmask = tpipe.prepare_control_tokens(cond, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), **TOL)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), rtol=0, atol=1e-6)


def test_glyph_latent_init_with_given_noise(pipes):
    jpipe, tpipe, cond = pipes
    rng, c = jax.random.PRNGKey(3), CFGS["vae_cfg"].latent_channels
    h = w = SIZE // 8
    # jitted whole: the same reference in half the time of its eager dispatch
    want = jax.jit(lambda r, g: jpipe.prepare_latents(r, 1, cond.glyph_canvas, g))(
        rng, jax.random.PRNGKey(4))
    noise = jax.random.normal(rng, (1, c, h, w), jnp.float32)  # the draw inside prepare_latents
    got = tpipe.prepare_latents(None, 1, cond.glyph_canvas, torch.Generator().manual_seed(4),
                                noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tpipe.prepare_latents(None, 1, None, noise=t(noise))
    assert (got != plain).any() and (got == plain).any()   # the blend is local to the ink


def test_num_images_batch_matches_single_images(pipes):
    """Two images in one call (the prompt repeated on the batch axis, the
    conditions shared) equal the two images made one at a time."""
    _, tpipe, cond = pipes
    c = CFGS["vae_cfg"].latent_channels
    noise = np.random.default_rng(8).standard_normal(
        (2, PIPE_CFG.image_seq_len, 4 * c)).astype(np.float32)
    both = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, num_images=2, latents=t(noise),
                 output_type="latent")
    for i in range(2):
        one = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise[i:i + 1]),
                    output_type="latent")
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_latents_argument_is_checked(pipes):
    _, tpipe, cond = pipes
    with pytest.raises(ValueError, match="PACKED"):
        tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=torch.zeros(1, 3, 64))


def test_conditions_fixture_matches_build_conditions():
    """tests/fixtures/conditions_1024.npz (chip_smoke.py's two requests) is
    what build_conditions makes from its texts and positions."""
    data = np.load(os.path.join(ROOT, "tests", "fixtures", "conditions_1024.npz"))
    size, font_size = int(data["size"]), int(data["font_size"])
    for name in ("arabic", "latin"):
        pos = tuple(int(v) for v in data[f"{name}.position"])
        cond = build_conditions([TextLine(str(data[f"{name}.text"]), pos, font_size=font_size)],
                                size, size, font_size=font_size)
        line = cond.lines[0]
        for key in ("canny_image", "position_mask", "region_mask"):
            np.testing.assert_array_equal(data[f"{name}.{key}"], getattr(line, key))
        np.testing.assert_array_equal(data[f"{name}.glyph_canvas"], cond.glyph_canvas)


def test_tiny_cli_writes_an_image(tmp_path):
    from reptext_tpu_torch import cli

    out = tmp_path / "r.png"
    assert cli.main(["--text", "مرحبا", "--position", "8", "16", "--size", "64", "--steps", "2",
                     "--controlnet-step", "1", "--random-weights", "--tiny", "--device", "cpu",
                     "--font-size", "24", "--output", str(out)]) == 0
    from PIL import Image

    assert Image.open(out).size == (64, 64)


def test_demo_token_ids_are_stable_and_padded():
    from reptext_tpu_torch.cli import demo_token_ids

    clip_cfg, t5_cfg = port_config(CFGS["clip_cfg"]), port_config(T5Config())
    a = demo_token_ids("a sign, 'Hello'", clip_cfg, t5_cfg, 512)
    b = demo_token_ids("a sign, 'Hello'", clip_cfg, t5_cfg, 512)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].shape == (1, 512) and a[1][0, 3] == 1 and a[0][0, 3] == 255


def _env(jax_platforms):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    if jax_platforms is not None:
        env["JAX_PLATFORMS"] = jax_platforms
    return env


@pytest.mark.parametrize("jax_platforms", [None, "cpu"])
def test_port_never_imports_jax(jax_platforms):
    """Every module of the port, imported in a fresh process with
    ``JAX_PLATFORMS`` unset and set as the tests set it, loads neither jax nor
    any module of the JAX package."""
    code = ("import importlib, pkgutil, sys, reptext_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(reptext_tpu_torch.__path__, "
            "'reptext_tpu_torch.')]\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'reptext_tpu' or m.startswith('reptext_tpu.'))\n"
            "assert not bad, bad\n"
            "assert len(mods) > 30, mods\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(jax_platforms),
                   check=True, timeout=120)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_port_imports_the_jax_package():
    """An AST walk over every module of the port and chip_smoke.py: no import
    of jax or of reptext_tpu, at any depth of the code (function bodies too)."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "reptext_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = [(os.path.relpath(p, ROOT), m) for p in paths for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "reptext_tpu")]
    assert not bad
    assert len(paths) > 30


def test_pipeline_defaults_to_the_card():
    """create() without a device builds on CUDA: on a host without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device the default build succeeds")
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline

    cfgs = port_configs_of(CFGS)
    with pytest.raises(RuntimeError, match="cuda"):
        FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), **cfgs)
    with pytest.raises(RuntimeError, match="cuda"):
        FluxRepTextInpaintPipeline.create_inpaint(pipe_cfg=port_config(PIPE_CFG), **cfgs)


def test_cli_defaults_to_the_card():
    """Without --device cpu the CLI builds on CUDA (--tiny too, in float32)
    and raises on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device the CLI runs on it")
    from reptext_tpu_torch import cli

    assert cli.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--text", "x", "--position", "8", "16", "--size", "64", "--steps", "1",
                  "--random-weights", "--tiny", "--output", "unused.png"])


def test_port_uses_no_library_attention_or_compile():
    pkg = os.path.join(ROOT, "reptext_tpu_torch")
    banned = ("scaled_dot_product_attention", "torch.compile", "cudnn", "import jax", "from jax")
    # the OCR train step holds cuDNN's convolutions to deterministic algorithms
    # (sampling/ocr_loss.py): those two flags are the only cuDNN names allowed
    conv_flags = ("torch.backends.cudnn.deterministic", "torch.backends.cudnn.benchmark")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                text = open(os.path.join(dirpath, f), encoding="utf-8").read()
                for flag in conv_flags:
                    text = text.replace(flag, "")
                assert not [b for b in banned if b in text], f


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, capsys, alone):
    """chip_smoke.py exits non-zero and prints no result without a CUDA
    device: in this process from the repository (it fails before it loads
    anything of the port) and as the only file of a directory."""
    src = os.path.join(ROOT, "chip_smoke.py")
    if not alone:
        if torch.cuda.is_available():
            pytest.skip("with a CUDA device chip_smoke.py runs the whole smoke test")
        spec = importlib.util.spec_from_file_location("chip_smoke", src)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        with pytest.raises(SystemExit) as exit_info:
            smoke.main([])
        assert exit_info.value.code not in (0, None)
        assert '"ok"' not in capsys.readouterr().out
        return
    (tmp_path / "chip_smoke.py").write_text(open(src, encoding="utf-8").read())
    proc = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path),
                          capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
