"""Sequence-parallel inpainting, rank-4 conditions, batches and callbacks under
SP on the port, against the JAX package and against the port's one-device
runs, on the CPU in float32 at tiny geometry.

JAX runs on the in-process 8-device CPU mesh (tests/conftest.py); the port
runs its ranks as threads of one process (``parallel/testing.py``) or, for the
CLI, as two gloo processes under ``torchrun``. Tolerances are those of
tests/test_torch_parallel.py (the JAX package's own SP parity limits,
``tests/mesh_scenarios.py``): rtol = atol = 2e-4 on latents; every rank's
latents are equal.
"""

import dataclasses
import functools
import os
import socket
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
from reptext_tpu.ops.latents import prepare_latent_image_ids as j_img_ids
from reptext_tpu.parallel import make_sp_mesh
from reptext_tpu.pipelines import FluxRepTextInpaintPipeline as JInpaint
from reptext_tpu.sampling.flow_match import build_schedule as j_build_schedule
from reptext_tpu.sampling.sampler import make_sp_txt2img_sampler as j_sp_txt2img
from reptext_tpu.sampling.sampler_inpaint import make_sp_inpaint_sampler as j_sp_inpaint
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.parallel.group import decide_on_rank0
from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd
from reptext_tpu_torch.pipelines.inpaint import (
    FluxRepTextInpaintPipeline, default_inpaint_controlnet_config,
)
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling.flow_match import build_schedule
from reptext_tpu_torch.sampling.sampler import make_sp_txt2img_sampler, make_txt2img_sampler
from reptext_tpu_torch.sampling.sampler_inpaint import (
    make_inpaint_sampler, make_sp_inpaint_sampler,
)

from torch_port_util import carried, port_config, port_configs_of, random_tree, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FluxConfig().tiny()            # 4 heads: ulysses over 4 ranks at most
CN_CFG = ControlNetConfig().tiny()
INP_CFG = dataclasses.replace(CN_CFG, extra_condition_channels=4)
LAT_TOL = dict(rtol=2e-4, atol=2e-4)
S_IMG, S_TXT, B, N_LINES = 16, 4, 2, 2


@pytest.fixture
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("requires 8 virtual devices")


# ------------------------------------------------------------------ samplers

def _model_inputs(b=1):
    z = jnp.zeros
    return (z((b, S_IMG, CFG.in_channels)), z((b, S_TXT, CFG.joint_attention_dim)),
            z((b, CFG.pooled_projection_dim)), z((b,)), j_img_ids(8, 8), z((S_TXT, 3)), z((b,)))


@functools.lru_cache(maxsize=None)
def _trees():
    x, ctx, pooled, ts, img_ids, txt_ids, g = _model_inputs()

    def cn_tree(cfg, seed):
        cond = jnp.zeros((1, S_IMG, cfg.in_channels + cfg.extra_condition_channels))
        return random_tree(JControlNet(cfg), x, cond, ctx, pooled, ts, img_ids, txt_ids, g,
                           seed=seed)

    return (random_tree(JFlux(CFG), x, ctx, pooled, ts, img_ids, txt_ids, g, seed=1),
            cn_tree(CN_CFG, 2), cn_tree(INP_CFG, 3))


@functools.lru_cache(maxsize=None)
def _port_models():
    flux_tree, cn_tree, inp_tree = _trees()
    return (carried(FluxTransformer2D(port_config(CFG)), flux_tree),
            carried(RepTextControlNet(port_config(CN_CFG)), cn_tree),
            carried(RepTextControlNet(port_config(INP_CFG)), inp_tree))


def _sampler_args(rank4, cfg_halves):
    """Seeded inputs of the samplers: latents [B, S, 64]; conditions and
    masks [N, S, .] or, ``rank4``, [N, B, S, .]; inpaint conditions; the
    embeds of 2B rows ([negative; positive]) with ``cfg_halves``, else B."""
    r = np.random.default_rng(17 + rank4)

    def rand(*shape):
        return r.standard_normal(shape).astype(np.float32)

    lead = (N_LINES, B) if rank4 else (N_LINES,)
    rows = 2 * B if cfg_halves else B
    return dict(
        latents=rand(B, S_IMG, CFG.in_channels),
        cond=rand(*lead, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels),
        masks=(r.random((*lead, S_IMG, 1)) > 0.3).astype(np.float32),
        inpaint_cond=rand(B, S_IMG, INP_CFG.in_channels + 4),
        ctx=rand(rows, S_TXT, CFG.joint_attention_dim),
        pooled=rand(rows, CFG.pooled_projection_dim),
        txt_ids=np.zeros((S_TXT, 3), np.float32), img_ids=np.asarray(j_img_ids(8, 8), np.float32),
        guidance=np.full((B,), 3.5, np.float32))


def _cfg(cache, steps=4):
    kw = dict(num_inference_steps=steps, controlnet_conditioning_step=2,
              controlnet_conditioning_scale=0.8, true_guidance_scale=2.5)
    if cache == "adaptive":
        # with these weights the inpaint loop's relative drift is 0 at step 1
        # (step 0's velocity is zeroed), 0.33-0.34 at step 2 and 0.39-0.40 at
        # step 3: a threshold of 0.3 skips step 1 alone, where the never-skip
        # and the always-skip trajectories differ
        # (test_adaptive_inpaint_case_is_discriminative)
        kw.update(velocity_cache_mode="adaptive", velocity_cache_warmup=1,
                  velocity_cache_threshold=0.3, velocity_cache_max_skip=2, num_inference_steps=5,
                  controlnet_conditioning_step=3)
    return PipelineConfig(**kw)


INPAINT_KEYS = ("latents", "cond", "masks", "inpaint_cond", "ctx", "pooled", "txt_ids",
                "img_ids", "guidance")
TXT2IMG_KEYS = ("latents", "cond", "masks", "ctx", "pooled", "txt_ids", "img_ids", "guidance")


def _port_inpaint(cfg, backend, n, rank4):
    """The port's inpaint sampler on one device (``backend`` None) or over n
    thread ranks; every rank's latents equal."""
    flux, cn, inp = _port_models()
    args = [t(_sampler_args(rank4, True)[k]) for k in INPAINT_KEYS]
    schedule = build_schedule(cfg.num_inference_steps, S_IMG)
    with torch.no_grad():
        if backend is None:
            return make_inpaint_sampler(flux, cn, inp, schedule, port_config(cfg))(*args).numpy()
        outs = run_spmd(LocalSPGroup(n), lambda g: make_sp_inpaint_sampler(
            flux, cn, inp, schedule, port_config(cfg), g, backend)(*args))
    for out in outs[1:]:
        np.testing.assert_array_equal(out.numpy(), outs[0].numpy())
    return outs[0].numpy()


SP_CASES = [("ring", 2), ("ring", 4), ("ulysses", 2), ("ulysses", 4)]


@pytest.mark.parametrize("cache", ["off", "adaptive"])
@pytest.mark.parametrize("rank4", [False, True], ids=["rank3", "rank4"])
@pytest.mark.parametrize("backend,n", SP_CASES)
def test_sp_inpaint_sampler_matches_one_device(backend, n, rank4, cache):
    cfg = _cfg(cache)
    np.testing.assert_allclose(_port_inpaint(cfg, backend, n, rank4),
                               _port_inpaint(cfg, None, 1, rank4), **LAT_TOL)


@pytest.mark.parametrize("backend,n,rank4,cache", [
    ("ring", 2, False, "off"), ("ring", 4, True, "adaptive"),
    ("ulysses", 2, True, "off"), ("ulysses", 4, False, "adaptive"),
])
def test_sp_inpaint_sampler_matches_jax(eight_devices, backend, n, rank4, cache):
    """Against the JAX ``make_sp_inpaint_sampler`` (all three models on the
    SP backend) on an n-device mesh, the same trees and inputs."""
    cfg = _cfg(cache)
    steps = cfg.num_inference_steps
    flux = JFlux(CFG, attention_backend=backend)
    cn, inp = (JControlNet(c, attention_backend=backend) for c in (CN_CFG, INP_CFG))
    sample = j_sp_inpaint(functools.partial(flux.apply), functools.partial(cn.apply),
                          functools.partial(inp.apply), j_build_schedule(steps, S_IMG), cfg,
                          CFG.num_layers, CFG.num_single_layers, make_sp_mesh(n))
    a = _sampler_args(rank4, True)
    want = np.asarray(jax.jit(sample)(*_trees(), *(jnp.asarray(a[k]) for k in INPAINT_KEYS)))
    np.testing.assert_allclose(_port_inpaint(cfg, backend, n, rank4), want, **LAT_TOL)


def test_adaptive_inpaint_case_is_discriminative():
    """The adaptive case's decisions are mixed: its latents differ from the
    never-skip and the always-skip trajectories (one device)."""
    mid = _cfg("adaptive")
    got = _port_inpaint(mid, None, 1, False)
    never = _port_inpaint(dataclasses.replace(mid, velocity_cache_mode="reuse",
                                              velocity_cache_interval=1), None, 1, False)
    always = _port_inpaint(dataclasses.replace(mid, velocity_cache_threshold=1e9), None, 1,
                           False)
    assert np.abs(got - never).max() > 1e-4 and np.abs(got - always).max() > 1e-4


def _port_txt2img(cfg, backend, n, rank4):
    flux, cn, _ = _port_models()
    args = [t(_sampler_args(rank4, False)[k]) for k in TXT2IMG_KEYS]
    schedule = build_schedule(cfg.num_inference_steps, S_IMG)
    with torch.no_grad():
        if backend is None:
            return make_txt2img_sampler(flux, cn, schedule, port_config(cfg))(*args).numpy()
        outs = run_spmd(LocalSPGroup(n), lambda g: make_sp_txt2img_sampler(
            flux, cn, schedule, port_config(cfg), g, backend)(*args))
    for out in outs[1:]:
        np.testing.assert_array_equal(out.numpy(), outs[0].numpy())
    return outs[0].numpy()


@pytest.mark.parametrize("backend,n", [("ring", 4), ("ulysses", 2)])
def test_sp_txt2img_sampler_rank4_conditions(eight_devices, backend, n):
    """Per-image [N, B, S, F] conditions and masks under SP, sharded on their
    token axis, against the JAX SP sampler (``_specs``) and one device."""
    cfg = _cfg("off")
    flux, cn = JFlux(CFG, attention_backend=backend), JControlNet(CN_CFG,
                                                                  attention_backend=backend)
    sample = j_sp_txt2img(functools.partial(flux.apply), functools.partial(cn.apply),
                          j_build_schedule(cfg.num_inference_steps, S_IMG), cfg, make_sp_mesh(n))
    a = _sampler_args(True, False)
    want = np.asarray(jax.jit(sample)(*_trees()[:2], *(jnp.asarray(a[k]) for k in TXT2IMG_KEYS)))
    got = _port_txt2img(cfg, backend, n, True)
    np.testing.assert_allclose(got, want, **LAT_TOL)
    np.testing.assert_allclose(got, _port_txt2img(cfg, None, 1, True), **LAT_TOL)


def test_sp_txt2img_sampler_runs_chunks():
    """Chunks of the SP sampler, one after the other, give the whole run."""
    flux, cn, _ = _port_models()
    cfg = port_config(_cfg("off"))
    a = {k: t(v) for k, v in _sampler_args(False, False).items()}
    args = [a[k] for k in TXT2IMG_KEYS[1:]]
    schedule = build_schedule(cfg.num_inference_steps, S_IMG)

    def rank(g):
        sample = make_sp_txt2img_sampler(flux, cn, schedule, cfg, g, "ring")
        lat = sample(a["latents"], *args, 0, 1)
        lat = sample(lat, *args, 1, 2)
        return sample(lat, *args, 3, 1), sample(a["latents"], *args)

    with torch.no_grad():
        for chunked, whole in run_spmd(LocalSPGroup(2), rank):
            np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


def test_decide_on_rank0():
    """Rank 0 alone decides; every rank gets its answer."""
    calls = []

    def rank(g):
        return decide_on_rank0(g, lambda: calls.append(g.rank) or True)

    assert run_spmd(LocalSPGroup(3), rank) == [True, True, True] and calls == [0]
    assert run_spmd(LocalSPGroup(2), lambda g: decide_on_rank0(g, lambda: False)) == [False] * 2


# ---------------------------------------------------------------- pipelines

SIZE = 64
CFGS = dict(flux_cfg=CFG, cn_cfg=CN_CFG, vae_cfg=VAEConfig().tiny(),
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=3,
                          controlnet_conditioning_step=2, true_guidance_scale=2.5)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 1, 0, 0, 0]], np.int32)
NEG_CLIP = np.array([[4, 8, 9, 255, 0, 0, 0, 0]], np.int32)
NEG_T5 = np.array([[6, 2, 1, 0, 0, 0]], np.int32)
IDS = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, negative_clip_ids=NEG_CLIP, negative_t5_ids=NEG_T5)


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
                            z((1, f.pooled_projection_dim)), z((1,)), img_ids, txt_ids, g, seed=41),
        "controlnet": cn_tree(CN_CFG, 42),
        "inpaint_controlnet": cn_tree(INP_CFG, 43),
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=44),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=45),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=46),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0
    conv_out["bias"][v.latent_channels:] = -30.0
    return params


@pytest.fixture(scope="module")
def pipes():
    params = _params()
    tpipe = FluxRepTextPipeline.create(
        pipe_cfg=port_config(PIPE_CFG), device="cpu", **port_configs_of(CFGS),
        params={k: v for k, v in params.items() if k != "inpaint_controlnet"})
    tinp = FluxRepTextInpaintPipeline.from_pipeline(
        tpipe, default_inpaint_controlnet_config(port_config(CN_CFG)),
        params=params["inpaint_controlnet"])
    r = np.random.default_rng(9)
    image = r.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[8:40, 4:60] = 255
    noise = r.standard_normal((1, PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    conds = [build_conditions([TextLine(text, pos, font_size=24)], SIZE, SIZE)
             for text, pos in (("Hi", (8, 16)), ("Yo", (20, 30)))]
    return dict(params=params, tpipe=tpipe, tinp=tinp, image=image, mask=mask, noise=noise,
                conds=conds)


def _sharded(pipe, n, backend, call):
    """``call(pipe.with_config(...).shard_for_sp(rank, backend))`` on every
    rank of n threads; the ranks' results equal; rank 0's."""
    outs = run_spmd(LocalSPGroup(n), lambda g: call(
        pipe.with_config(pipe.pipe_cfg).shard_for_sp(g, backend)))
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    return outs[0]


def _inpaint(pipe, p, **kw):
    return pipe(p["conds"][0], image=p["image"], mask=p["mask"], latents=t(p["noise"]),
                output_type="latent", **IDS, **kw)


@pytest.mark.parametrize("backend,n", SP_CASES)
def test_inpaint_shard_for_sp_matches_one_device(pipes, backend, n):
    p = pipes
    want = _inpaint(p["tinp"], p).numpy()
    got = _sharded(p["tinp"], n, backend, lambda pipe: _inpaint(pipe, p)).numpy()
    np.testing.assert_allclose(got, want, **LAT_TOL)


def test_inpaint_shard_for_sp_matches_jax(eight_devices, pipes):
    """Ring over 4 ranks against the JAX inpaint pipeline's ``shard_for_sp``
    on a 4-device mesh, with a custom sigma ladder, from the same noise."""
    p = pipes
    jinp = JInpaint.create_inpaint(inpaint_cn_cfg=INP_CFG, pipe_cfg=PIPE_CFG,
                                   params=p["params"], **CFGS).shard_for_sp(make_sp_mesh(4))
    sigmas = [1.0, 0.6, 0.3]
    want = jinp(p["conds"][0], image=p["image"], mask=p["mask"], latents=jnp.asarray(p["noise"]),
                output_type="latent", sigmas=sigmas,
                **{k: jnp.asarray(v) for k, v in IDS.items()})
    got = _sharded(p["tinp"], 4, "ring", lambda pipe: _inpaint(pipe, p, sigmas=sigmas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAT_TOL)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_inpaint_shard_for_sp_leaves_the_shared_modules_alone(pipes, backend):
    """Sharding an inpaint pipeline's clone writes nothing into the modules
    it shares with the base and the one-device inpaint pipeline, which go on
    giving the outputs they gave before, with no reset."""
    p = pipes
    base_kw = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]), output_type="latent")
    base_before = p["tpipe"](p["conds"][0], **base_kw)
    inp_before = _inpaint(p["tinp"], p)
    group = LocalSPGroup(2)
    sharded = [p["tinp"].with_config(p["tinp"].pipe_cfg).shard_for_sp(group.member(r), backend)
               for r in range(2)]
    modules = (p["tinp"].flux, p["tinp"].controlnet, p["tinp"].inpaint_controlnet)
    assert not any(hasattr(m, "attention_backend") for m in modules)
    assert p["tinp"].sp_group is None and p["tpipe"].sp_group is None
    assert all(s.sp_backend == backend and s.inpaint_controlnet is modules[2] for s in sharded)
    torch.testing.assert_close(_inpaint(p["tinp"], p), inp_before, rtol=0, atol=0)
    torch.testing.assert_close(p["tpipe"](p["conds"][0], **base_kw), base_before, rtol=0, atol=0)
    outs = run_spmd(group, lambda g: _inpaint(sharded[g.rank], p))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), inp_before.numpy(), **LAT_TOL)
    torch.testing.assert_close(_inpaint(p["tinp"], p), inp_before, rtol=0, atol=0)


@pytest.mark.parametrize("backend,n", [("ring", 2), ("ulysses", 4)])
def test_generate_batch_under_sp_matches_one_device(pipes, backend, n):
    """Two requests with their own conditions and seeds, txt2img and
    inpainting, sharded against the one-device batch."""
    p = pipes
    seeds = [3, 4]
    batch = dict(clip_ids=np.repeat(CLIP_IDS, 2, 0), t5_ids=np.repeat(T5_IDS, 2, 0), seeds=seeds,
                 output_type="latent")
    inp_batch = dict(images=[p["image"]] * 2, masks=[p["mask"]] * 2,
                     negative_clip_ids=np.repeat(NEG_CLIP, 2, 0),
                     negative_t5_ids=np.repeat(NEG_T5, 2, 0), **batch)
    for pipe, kw in ((p["tpipe"], batch), (p["tinp"], inp_batch)):
        want = pipe.generate_batch(p["conds"], **kw)
        got = _sharded(pipe, n, backend, lambda s: s.generate_batch(p["conds"], **kw))
        assert got.shape == (2, PIPE_CFG.image_seq_len, 64)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LAT_TOL)


def test_callback_under_sp_runs_once_on_rank0(pipes):
    """Under SP the callback runs on rank 0 alone, once per chunk, with the
    gathered latents; when it returns False every rank stops at that step,
    with the one-device run's latents."""
    p = pipes
    calls = []

    def stop_at_2(i, latents):
        calls.append((i, tuple(latents.shape)))
        return i < 2

    kw = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]), output_type="latent",
              callback=stop_at_2)
    want = p["tpipe"](p["conds"][0], **kw)
    assert calls == [(1, (1, 16, 64)), (2, (1, 16, 64))]
    calls.clear()
    got = _sharded(p["tpipe"], 2, "ring", lambda s: s(p["conds"][0], **kw))
    assert calls == [(1, (1, 16, 64)), (2, (1, 16, 64))]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LAT_TOL)
    img2img = _sharded(p["tpipe"], 2, "ulysses", lambda s: s(
        p["conds"][0], init_image=p["image"], strength=0.5, **dict(kw, callback=None)))
    np.testing.assert_allclose(img2img.numpy(), p["tpipe"](
        p["conds"][0], init_image=p["image"], strength=0.5,
        **dict(kw, callback=None)).numpy(), **LAT_TOL)


# ------------------------------------------------------------------- CLI

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_inpaint_shard_sp2_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 -m reptext_tpu_torch.cli --mode inpaint
    --shard sp2`` (gloo on the CPU) writes the image one process writes,
    within 2 levels; only rank 0 writes. torchrun starts its ranks with
    OMP_NUM_THREADS=1, so the one process runs on one thread too: the tiny
    random inpaint model under true CFG 3.5 carries the other summation order
    of 8 threads to 22 levels in 2553 of the 1.3M values."""
    from PIL import Image

    from reptext_tpu_torch import cli

    r = np.random.default_rng(5)
    Image.fromarray(r.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(tmp_path / "photo.png")
    mask = np.zeros((96, 128), np.uint8)
    mask[30:70, 12:100] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    argv = ["--mode", "inpaint", "--image", str(tmp_path / "photo.png"), "--mask",
            str(tmp_path / "mask.png"), "--text", "Hi", "--position", "40", "200", "--steps", "2",
            "--controlnet-step", "1", "--random-weights", "--tiny", "--device", "cpu",
            "--font-size", "48", "--true-guidance-scale", "3.5"]
    one, two = tmp_path / "one.png", tmp_path / "two.png"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main([*argv, "--output", str(one)]) == 0
    finally:
        torch.set_num_threads(threads)
    env = dict({k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK",
                                                                 "LOCAL_RANK")}, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(_free_port()),
         "-m", "reptext_tpu_torch.cli", "--shard", "sp2", "--sp-backend", "ulysses", *argv,
         "--output", str(two)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("saved ") == 1
    a = np.asarray(Image.open(one), np.int32)
    b = np.asarray(Image.open(two), np.int32)
    assert a.shape == b.shape == (576, 768, 3) and np.abs(a - b).max() <= 2
