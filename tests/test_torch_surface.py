"""The pipelines' call surface on the port against the JAX package, on the CPU
in float32 at tiny geometry: custom schedules (``build_schedule`` with
``timesteps``/``sigmas``, ``_normalize_custom_schedule``), ``scale_noise``,
the glyph-latent helpers, ``FluxPipelineOutput``, the chunked sampler against
the JAX ``sample.chunked`` (stub models), and through both pipelines img2img,
callbacks (with and without the velocity cache), interruption,
``return_dict`` and custom schedules.

The shared weights pin the VAE posterior std to e^-15 (as
tests/test_torch_inpaint.py does), so the two RNGs' draws drop out, and both
sides get the same packed noise through ``latents=``. Tolerance: rtol = atol
= 5e-4 (TOL) on latents; the stub sampler 1e-5, as
tests/test_torch_velocity_cache.py.
"""

import dataclasses

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
from reptext_tpu.ops import latents as jlatents
from reptext_tpu.pipelines import FluxRepTextInpaintPipeline as JInpaint
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu.pipelines import outputs as joutputs
from reptext_tpu.pipelines import txt2img as jtxt2img
from reptext_tpu.sampling import flow_match as jfm
from reptext_tpu.sampling.sampler import make_txt2img_sampler as j_txt2img_sampler
from reptext_tpu_torch.ops import latents as tlatents
from reptext_tpu_torch.pipelines import outputs as toutputs
from reptext_tpu_torch.pipelines import txt2img as ttxt2img
from reptext_tpu_torch.pipelines.inpaint import (
    FluxRepTextInpaintPipeline, default_inpaint_controlnet_config,
)
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling import flow_match as tfm
from reptext_tpu_torch.sampling.sampler import make_txt2img_sampler

from torch_port_util import TOL, port_config, port_configs_of, random_tree, t

STUB_TOL = dict(rtol=1e-5, atol=1e-5)

# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("dyn", [True, False], ids=["dynamic", "static"])
@pytest.mark.parametrize("kind,values", [
    ("timesteps", [1000.0, 750.0, 500.0, 250.0]),
    ("timesteps", [980.0, 411.5, 37.0]),
    ("sigmas", [1.0, 0.8, 0.55, 0.3, 0.1]),
    ("sigmas", [0.9, 0.25]),
])
def test_custom_schedules_match_jax(kind, values, dyn):
    """Custom sigmas are shifted into the ladder; custom timesteps are kept as
    the model-facing grid while their t/1000 are shifted into the sigmas."""
    kw = {kind: values}
    got = tfm.build_schedule(99, 1024, use_dynamic_shifting=dyn, **kw)
    want = jfm.build_schedule(99, 1024, use_dynamic_shifting=dyn, **kw)
    assert got.num_steps == len(values)
    np.testing.assert_array_equal(got.sigmas, np.asarray(want.sigmas))
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    if kind == "timesteps":
        np.testing.assert_array_equal(got.timesteps, np.float32(values))


@pytest.mark.parametrize("kw,match", [
    (dict(timesteps=[500.0], sigmas=[0.5]), "Only one of"),
    (dict(timesteps=[]), "non-empty"),
    (dict(timesteps=[0.0, 500.0]), r"\(0, 1000\]"),
    (dict(sigmas=[[0.5]]), "non-empty"),
    (dict(sigmas=[1.5, 0.5]), r"\(0, 1\]"),
])
def test_build_schedule_refuses_what_jax_refuses(kw, match):
    for build in (tfm.build_schedule, jfm.build_schedule):
        with pytest.raises(ValueError, match=match):
            build(4, 256, **kw)


@pytest.mark.parametrize("timesteps,sigmas", [
    (None, None), ([900, 500.5, 20], None), (None, np.array([[0.9], [0.4]])),
])
def test_normalize_custom_schedule_matches_jax(timesteps, sigmas):
    assert (ttxt2img._normalize_custom_schedule(timesteps, sigmas)
            == jtxt2img._normalize_custom_schedule(timesteps, sigmas))
    with pytest.raises(ValueError, match="Only one of"):
        ttxt2img._normalize_custom_schedule([1.0], [0.5])


def test_scale_noise_matches_jax():
    r = np.random.default_rng(3)
    sample, noise = (r.standard_normal((2, 16, 8)).astype(np.float32) for _ in range(2))
    tsched, jsched = tfm.build_schedule(6, 512), jfm.build_schedule(6, 512)
    for i in (0, 2, 5):
        np.testing.assert_allclose(tsched.scale_noise(t(sample), t(noise), i).numpy(),
                                   np.asarray(jsched.scale_noise(jnp.asarray(sample),
                                                                 jnp.asarray(noise), i)),
                                   rtol=1e-6, atol=1e-6)


def test_glyph_latent_helpers_match_jax():
    r = np.random.default_rng(4)
    canvas = np.zeros((40, 56), np.uint8)
    canvas[9:17, 5:31] = r.integers(0, 255, (8, 26), dtype=np.uint8)
    canvas[30, 50] = 200                       # one ink pixel far from the rest
    want_mask = np.asarray(jlatents.binarize_glyph_mask_to_latent(jnp.asarray(canvas), 5, 7))
    got_mask = tlatents.binarize_glyph_mask_to_latent(torch.from_numpy(canvas), 5, 7).numpy()
    assert got_mask.shape == want_mask.shape == (1, 5, 7) and got_mask.max() == 1.0
    np.testing.assert_array_equal(got_mask, want_mask)
    noise, glyph = (r.standard_normal((2, 4, 5, 7)).astype(np.float32) for _ in range(2))
    mask = np.broadcast_to(want_mask[None], (2, 1, 5, 7))
    for scale in (0.1, 0.35):
        want = jlatents.glyph_latent_blend(jnp.asarray(noise), jnp.asarray(glyph),
                                           jnp.asarray(mask), scale)
        got = tlatents.glyph_latent_blend(t(noise), t(glyph), t(mask), scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pipeline_output_unpacks_as_jax_does():
    images = np.zeros((2, 4, 4, 3), np.uint8)
    for mod in (toutputs, joutputs):
        out = mod.FluxPipelineOutput(images=images)
        first, = out
        assert first is images and out[0] is images and out.images is images
        with pytest.raises(IndexError):
            out[1]
        pils = mod.to_pil_images(images)
        assert len(pils) == 2 and pils[0].size == (4, 4)


# ------------------------------------------ the chunked sampler (stub models)

B, S, C, S_TXT, INNER = 2, 16, 8, 4, 8


def _stub_flux(x, ctx, pooled, t, img_ids, txt_ids, guidance,
               controlnet_block_samples=None, controlnet_single_block_samples=None, xp=torch):
    out = -0.3 * x + 0.1 * xp.sin(t)[:, None, None] + 0.05 * ctx.mean(axis=(1, 2))[:, None, None]
    out = out + 0.2 * xp.tanh(x * x)
    for stack in (controlnet_block_samples, controlnet_single_block_samples):
        if stack is not None:
            out = out + 0.01 * stack.sum(axis=0)[..., :C]
    return out


def _stub_cn(hidden, cond, ctx, pooled, t, img_ids, txt_ids, guidance, scale, xp=torch):
    r = (cond[..., :INNER] + 0.5 * hidden[..., :INNER]) * scale
    return xp.stack([r, 2 * r]), xp.stack([-r, -2 * r, 3 * r])


def _stub_args():
    r = np.random.default_rng(11)
    return dict(latents=r.standard_normal((B, S, C)).astype(np.float32),
                cond=r.standard_normal((2, S, 12)).astype(np.float32),
                masks=(r.random((2, S, 1)) > 0.4).astype(np.float32),
                ctx=r.standard_normal((B, S_TXT, 6)).astype(np.float32),
                pooled=r.standard_normal((B, 5)).astype(np.float32),
                txt_ids=np.zeros((S_TXT, 3), np.float32), img_ids=np.zeros((S, 3), np.float32))


VC = {"off": {}, "interval2": dict(velocity_cache_interval=2, velocity_cache_warmup=1),
      "adaptive-linear": dict(velocity_cache_mode="adaptive-linear", velocity_cache_warmup=1,
                              velocity_cache_threshold=0.3, velocity_cache_max_skip=2)}


@pytest.mark.parametrize("vc", sorted(VC))
@pytest.mark.parametrize("chunks", [[(0, 6)], [(0, 2), (2, 2), (4, 2)], [(1, 1), (2, 3), (5, 1)],
                                    [(3, 3)]], ids=["whole", "by2", "ragged", "from3"])
def test_chunked_sampler_matches_jax(vc, chunks):
    """Chunks of the schedule, each from the last one's latents, against the
    JAX ``sample.chunked``: the ControlNet gate (on for steps 0-2) by absolute
    step, the cache's first step of every chunk forced, its registers empty."""
    cfg = PipelineConfig(height=32, width=32, num_inference_steps=6,
                         controlnet_conditioning_step=3, **VC[vc])
    a = _stub_args()
    jsched = jfm.build_schedule(6, cfg.image_seq_len)
    jflux = lambda p, *x: _stub_flux(*x, xp=jnp)          # noqa: E731
    jcn = lambda p, *x: _stub_cn(*x, xp=jnp)              # noqa: E731
    jsample = j_txt2img_sampler(jflux, jcn, jsched, cfg)
    sample = make_txt2img_sampler(_stub_flux, _stub_cn, tfm.build_schedule(6, cfg.image_seq_len),
                                  port_config(cfg))
    j = {k: jnp.asarray(v) for k, v in a.items()}
    tt = {k: t(v) for k, v in a.items()}
    want, got = j["latents"], tt["latents"]
    for start, n in chunks:
        want = jax.jit(lambda lat, s, n=n: jsample.chunked(
            None, None, lat, j["cond"], j["masks"], j["ctx"], j["pooled"], j["txt_ids"],
            j["img_ids"], None, s, n))(want, start)
        got = sample(got, tt["cond"], tt["masks"], tt["ctx"], tt["pooled"], tt["txt_ids"],
                     tt["img_ids"], None, start, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STUB_TOL)


def test_chunk_bounds_are_checked():
    cfg = port_config(PipelineConfig(height=32, width=32, num_inference_steps=4))
    sample = make_txt2img_sampler(_stub_flux, _stub_cn, tfm.build_schedule(4, 16), cfg)
    tt = {k: t(v) for k, v in _stub_args().items()}
    args = (tt["latents"], tt["cond"], tt["masks"], tt["ctx"], tt["pooled"], tt["txt_ids"],
            tt["img_ids"], None)
    for start, n in ((4, None), (2, 3), (-1, 1), (1, 0)):
        with pytest.raises(ValueError, match="not inside"):
            sample(*args, start, n)


# ---------------------------------------------------------- the pipelines

SIZE = 64
CN_CFG = ControlNetConfig().tiny()
INP_CFG = dataclasses.replace(CN_CFG, extra_condition_channels=4)
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=CN_CFG, vae_cfg=VAEConfig().tiny(),
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=4,
                          controlnet_conditioning_step=2, true_guidance_scale=2.5)
VC_CFG = dataclasses.replace(PIPE_CFG, velocity_cache_interval=2, velocity_cache_warmup=1)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 1, 0, 0, 0]], np.int32)
NEG_CLIP = np.array([[4, 8, 9, 255, 0, 0, 0, 0]], np.int32)
NEG_T5 = np.array([[6, 2, 1, 0, 0, 0]], np.int32)


def _params():
    f, v = CFGS["flux_cfg"], CFGS["vae_cfg"]
    s_img, z = PIPE_CFG.image_seq_len, jnp.zeros
    img_ids, txt_ids, g = z((s_img, 3)), z((6, 3)), jnp.ones((1,))

    def cn_tree(cfg, seed):
        return random_tree(JControlNet(cfg), z((1, s_img, cfg.in_channels)),
                           z((1, s_img, cfg.in_channels + cfg.extra_condition_channels)),
                           z((1, 6, cfg.joint_attention_dim)), z((1, cfg.pooled_projection_dim)),
                           z((1,)), img_ids, txt_ids, g, seed=seed)

    params = {
        "flux": random_tree(JFlux(f), z((1, s_img, f.in_channels)), z((1, 6, f.joint_attention_dim)),
                            z((1, f.pooled_projection_dim)), z((1,)), img_ids, txt_ids, g, seed=31),
        "controlnet": cn_tree(CN_CFG, 32),
        "inpaint_controlnet": cn_tree(INP_CFG, 33),
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=34),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=35),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=36),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0
    conv_out["bias"][v.latent_channels:] = -30.0
    return params


@pytest.fixture(scope="module")
def pipes():
    params = _params()
    base = {k: v for k, v in params.items() if k != "inpaint_controlnet"}
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=base, **CFGS)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=base,
                                       device="cpu", **port_configs_of(CFGS))
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE)
    r = np.random.default_rng(7)
    noise = r.standard_normal((1, PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    image = r.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    return dict(params=params, jpipe=jpipe, tpipe=tpipe, cond=cond, noise=noise, image=image)


def _jax(pipe, cond, noise, **kw):
    return np.asarray(pipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                           latents=jnp.asarray(noise), output_type="latent", **kw))


def _port(pipe, cond, noise, **kw):
    return pipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise), output_type="latent",
                **kw).numpy()


@pytest.mark.parametrize("strength", [0.5, 0.75])
def test_img2img_matches_jax(pipes, strength):
    """init_image at ``strength``: t0 = int(4 (1 - strength)), the image's
    latent noised to sigmas[t0], then steps t0..3 with the ControlNet gated
    by absolute step (on at 0 and 1)."""
    p = pipes
    want = _jax(p["jpipe"], p["cond"], p["noise"], init_image=p["image"], strength=strength)
    got = _port(p["tpipe"], p["cond"], p["noise"], init_image=p["image"], strength=strength)
    np.testing.assert_allclose(got, want, **TOL)
    plain = _port(p["tpipe"], p["cond"], p["noise"])
    assert np.abs(got - plain).max() > 1e-2     # the image took part


@pytest.mark.parametrize("vc", ["off", "interval2"])
@pytest.mark.parametrize("callback_steps", [1, 2])
def test_callbacks_match_jax(pipes, vc, callback_steps):
    """The callback runs after every ``callback_steps`` steps with the step
    reached and the latents; the chunked run matches the JAX one. With the
    velocity cache at interval 2 (warmup 1) every chunk's first step runs
    the model, so the chunked run differs from the one without a callback:
    a sampler that carried the cache's registers across chunks would not."""
    p = pipes
    cfg = PIPE_CFG if vc == "off" else VC_CFG
    jpipe = dataclasses.replace(p["jpipe"], pipe_cfg=cfg)
    tpipe = p["tpipe"].with_config(port_config(cfg))
    seen = {"jax": [], "port": []}

    def record(key):
        def callback(i, latents):
            seen[key].append((i, np.asarray(latents).copy()))
        return callback

    want = _jax(jpipe, p["cond"], p["noise"], callback=record("jax"),
                callback_steps=callback_steps)
    got = _port(tpipe, p["cond"], p["noise"], callback=record("port"),
                callback_steps=callback_steps)
    np.testing.assert_allclose(got, want, **TOL)
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["jax"]] == \
        list(range(callback_steps, 5, callback_steps))
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        np.testing.assert_allclose(a, b, **TOL)
    whole = _port(tpipe, p["cond"], p["noise"])
    if vc == "off":
        np.testing.assert_array_equal(got, whole)
    else:
        assert np.abs(got - whole).max() > 1e-4


def test_callback_interrupts_as_jax_does(pipes):
    """A callback that returns False after step 2 stops sampling there."""
    p = pipes
    calls = []

    def stop_at_2(i, latents):
        calls.append(i)
        return i < 2

    want = _jax(p["jpipe"], p["cond"], p["noise"], callback=stop_at_2)
    got = _port(p["tpipe"], p["cond"], p["noise"], callback=stop_at_2)
    np.testing.assert_allclose(got, want, **TOL)
    assert calls == [1, 2, 1, 2]
    with pytest.raises(ValueError, match="callback_steps"):
        _port(p["tpipe"], p["cond"], p["noise"], callback=stop_at_2, callback_steps=0)


def test_return_dict(pipes):
    p = pipes
    out = p["tpipe"](p["cond"], clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]),
                     output_type="pil", return_dict=True)
    assert isinstance(out, toutputs.FluxPipelineOutput)
    images, = out
    assert len(images) == 1 and images[0].size == (SIZE, SIZE)
    arr = p["tpipe"](p["cond"], clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]),
                     return_dict=True)[0]
    np.testing.assert_array_equal(np.asarray(images[0]), arr[0])
    lat = p["tpipe"](p["cond"], clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]),
                     output_type="latent", return_dict=True).images
    assert isinstance(lat, torch.Tensor) and lat.shape == p["noise"].shape


CUSTOM = [dict(timesteps=[1000.0, 600.0, 250.0]), dict(sigmas=[1.0, 0.55, 0.2])]


@pytest.mark.parametrize("custom", CUSTOM, ids=["timesteps", "sigmas"])
def test_txt2img_custom_schedule_matches_jax(pipes, custom):
    """A custom schedule of 3 steps overrides num_inference_steps=4."""
    p = pipes
    want = _jax(p["jpipe"], p["cond"], p["noise"], num_inference_steps=4, **custom)
    got = _port(p["tpipe"], p["cond"], p["noise"], num_inference_steps=4, **custom)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - _port(p["tpipe"], p["cond"], p["noise"])).max() > 1e-3


@pytest.fixture(scope="module")
def inpaint_pipes(pipes):
    jinp = JInpaint.create_inpaint(inpaint_cn_cfg=INP_CFG, pipe_cfg=PIPE_CFG,
                                   params=pipes["params"], **CFGS)
    tinp = FluxRepTextInpaintPipeline.from_pipeline(
        pipes["tpipe"], default_inpaint_controlnet_config(port_config(CN_CFG)),
        params=pipes["params"]["inpaint_controlnet"])
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[8:40, 4:60] = 255
    return jinp, tinp, mask


@pytest.mark.parametrize("custom", CUSTOM, ids=["timesteps", "sigmas"])
def test_inpaint_custom_schedule_matches_jax(pipes, inpaint_pipes, custom):
    jinp, tinp, mask = inpaint_pipes
    p = pipes
    ids = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, negative_clip_ids=NEG_CLIP,
               negative_t5_ids=NEG_T5)
    want = jinp(p["cond"], image=p["image"], mask=mask, latents=jnp.asarray(p["noise"]),
                output_type="latent", **{k: jnp.asarray(v) for k, v in ids.items()}, **custom)
    out = tinp(p["cond"], image=p["image"], mask=mask, latents=t(p["noise"]),
               output_type="latent", return_dict=True, **ids, **custom)
    assert isinstance(out, toutputs.FluxPipelineOutput)
    np.testing.assert_allclose(out.images.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- CLI

class _Recorder:
    """A pipeline stand-in that records the keywords of its call."""

    def __init__(self):
        from reptext_tpu_torch.configs import CLIPConfig as TCLIP, PipelineConfig as TPipe
        from reptext_tpu_torch.configs import T5Config as TT5

        self.clip = type("M", (), {"config": TCLIP().tiny()})()
        self.t5 = type("M", (), {"config": TT5().tiny()})()
        self.pipe_cfg = TPipe(max_sequence_length=16)
        self.calls = []

    def __call__(self, conditions, **kw):
        self.calls.append(kw)
        return np.zeros((1, 8, 8, 3), np.uint8)


def test_cli_flags_reach_the_pipeline(tmp_path):
    from PIL import Image

    from reptext_tpu_torch import cli

    Image.fromarray(np.full((32, 48, 3), 90, np.uint8)).save(tmp_path / "init.png")
    args = cli.build_parser().parse_args([
        "--text", "Hi", "--position", "1", "2", "--prompt", "a sign", "--prompt-2", "a board",
        "--prompt-suffix", ", film", "--sigmas", "1.0,0.5,0.25", "--strength", "0.4",
        "--control-guidance-start", "0.25", "--control-guidance-end", "0.75"])
    cfg = cli.pipeline_config(args)
    assert (cfg.control_guidance_start, cfg.control_guidance_end) == (0.25, 0.75)
    pipe = _Recorder()
    init = cli.load_init_image(str(tmp_path / "init.png"), 64, 40)
    assert init.shape == (1, 40, 64, 3) and init.dtype == np.uint8
    cli.generate(args, pipe, None, init_image=init)
    kw = pipe.calls[-1]
    assert kw["sigmas"] == [1.0, 0.5, 0.25] and "timesteps" not in kw
    assert kw["init_image"] is init and kw["strength"] == 0.4
    clip_cfg, t5_cfg = pipe.clip.config, pipe.t5.config
    want_clip, _ = cli.demo_token_ids("a sign, 'Hi', film", clip_cfg, t5_cfg, 16)
    _, want_t5 = cli.demo_token_ids("a board, 'Hi', film", clip_cfg, t5_cfg, 16)
    np.testing.assert_array_equal(kw["clip_ids"], want_clip)
    np.testing.assert_array_equal(kw["t5_ids"], want_t5)
    args.sigmas, args.timesteps = None, "900,100"
    cli.generate_inpaint(args, pipe, None, np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8)))
    assert pipe.calls[-1]["timesteps"] == [900.0, 100.0] and "sigmas" not in pipe.calls[-1]


def test_cli_colors_and_shaping_reach_the_conditions(monkeypatch, tmp_path):
    """--color and --no-shape reach build_conditions; the run writes its image
    with a custom timestep grid."""
    from reptext_tpu_torch import cli, conditioning

    seen = {}
    real = conditioning.build_conditions

    def spy(lines, *a, **kw):
        seen.update(colors=[line.color for line in lines], shape_text=kw["shape_text"])
        return real(lines, *a, **kw)

    monkeypatch.setattr(conditioning, "build_conditions", spy)
    out = tmp_path / "out.png"
    assert cli.main(["--text", "Hi", "--position", "8", "16", "--text", "Yo", "--position",
                     "8", "40", "--color", "255", "0", "0", "--color", "0", "0", "255",
                     "--no-shape", "--size", "64", "--timesteps", "1000,500", "--random-weights",
                     "--tiny", "--device", "cpu", "--font-size", "20",
                     "--output", str(out)]) == 0
    assert seen == {"colors": [(255, 0, 0), (0, 0, 255)], "shape_text": False}
    assert out.exists()


@pytest.mark.parametrize("argv,match", [
    (["--sigmas", "1.0", "--timesteps", "500"], "mutually exclusive"),
    (["--init-image", "x.png"], "strength 1.0"),
    (["--color", "1", "2", "3", "--color", "4", "5", "6"], "--color count"),
])
def test_cli_refuses_bad_surface_flags(argv, match, capsys):
    from reptext_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["--text", "Hi", "--position", "1", "2", "--tiny", "--random-weights",
                  "--device", "cpu", *argv])
    assert match in capsys.readouterr().err


def test_cli_shard_takes_inpaint(monkeypatch):
    """--mode inpaint --shard sp2 asks for its ranks, and so do serving under
    sp2 and DPxTP (dp x tp must be the job's ranks); auto over one rank is
    1 x 1; training refuses spN with the JAX message."""
    from reptext_tpu_torch import cli

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)

    def ranks(*argv):
        return cli.shard_ranks(cli.build_parser().parse_args([*argv, "--device", "cpu"]))

    for mode in ("inpaint", "serve"):
        with pytest.raises(ValueError, match="need 2 ranks, have 1"):
            ranks("--mode", mode, "--shard", "sp2")
    with pytest.raises(ValueError, match="dp\\*tp=8 != device count 1"):
        ranks("--mode", "inpaint", "--shard", "2x4")
    sp, mesh = ranks("--mode", "txt2img", "--shard", "auto")
    assert sp is None and (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
    with pytest.raises(SystemExit, match="inference mode"):
        ranks("--mode", "train", "--shard", "sp2")
