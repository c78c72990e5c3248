"""Union-mode ControlNet in the port against the JAX package, on the CPU.

A union ControlNet (``ControlNetConfig.num_mode`` set; 10 modes, as the public
InstantX FLUX.1-dev-Controlnet-Union config) embeds its conditioning-type
index into one token in front of the context, with ``txt_ids[:1]`` in front
of the text ids. Tiny geometry, float32, one random Flax tree carried into
both sides. Checks: the ControlNet's residuals with a mode per row; the
missing-mode error on both sides; txt2img and inpaint pipelines with
``PipelineConfig.control_mode`` and the same ``latents=``; the union training
loss and its gradients with the mode; ``--controlnet-mode`` in the CLI
(generation and training, and training refused without it). Tolerance TOL
(5e-4) for residuals, latents and losses; gradients within 5e-4 of each
leaf's max|JAX grad|, as in tests/test_torch_train.py.
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
from reptext_tpu.pipelines import FluxRepTextInpaintPipeline as JInpaint
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu.sampling import train_controlnet as jtrain
from reptext_tpu_torch.io.from_jax import flatten_jax_params
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling import train_controlnet as ttrain

from test_torch_train import B, FLUX_CFG, _batch, _jax_draws
from torch_port_util import TOL, carried, np_tree, port_config, port_configs_of, random_tree, t

NUM_MODE = 10
UNION_CFG = dataclasses.replace(ControlNetConfig().tiny(), num_mode=NUM_MODE)
INP_CFG = dataclasses.replace(ControlNetConfig().tiny(), extra_condition_channels=4)
SIZE = 64
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=UNION_CFG, vae_cfg=VAEConfig().tiny(),
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                          controlnet_conditioning_step=2, guidance_scale=3.5, control_mode=2,
                          true_guidance_scale=3.0)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32)
NEG_CLIP = np.array([[4, 8, 9, 255, 0, 0, 0, 0]], np.int32)
NEG_T5 = np.array([[6, 2, 1, 0, 0, 0, 0, 0]], np.int32)
S_IMG = (SIZE // 16) ** 2


def _union_tree(cfg=UNION_CFG, s_img=S_IMG, seed=2):
    z = jnp.zeros
    return random_tree(JControlNet(cfg), z((1, s_img, cfg.in_channels)),
                       z((1, s_img, cfg.in_channels + cfg.extra_condition_channels)),
                       z((1, 4, cfg.joint_attention_dim)), z((1, cfg.pooled_projection_dim)),
                       z((1,)), z((s_img, 3)), z((4, 3)), jnp.ones((1,)),
                       mode=jnp.zeros((1,), jnp.int32), seed=seed)


def _pipeline_params():
    f, v = CFGS["flux_cfg"], CFGS["vae_cfg"]
    z = jnp.zeros
    img_ids, txt_ids, g = z((S_IMG, 3)), z((4, 3)), jnp.ones((1,))
    inp = random_tree(JControlNet(INP_CFG), z((1, S_IMG, INP_CFG.in_channels)),
                      z((1, S_IMG, INP_CFG.in_channels + 4)), z((1, 4, f.joint_attention_dim)),
                      z((1, f.pooled_projection_dim)), z((1,)), img_ids, txt_ids, g, seed=13)
    params = {
        "flux": random_tree(JFlux(f), z((1, S_IMG, f.in_channels)),
                            z((1, 4, f.joint_attention_dim)), z((1, f.pooled_projection_dim)),
                            z((1,)), img_ids, txt_ids, g, seed=1),
        "controlnet": _union_tree(),
        "inpaint_controlnet": inp,
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=3),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=4),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=5),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0   # the posterior draw drops out
    conv_out["bias"][v.latent_channels:] = -30.0
    return params


@pytest.fixture(scope="module")
def params():
    return _pipeline_params()


@pytest.fixture(scope="module")
def cond():
    return build_conditions([TextLine("مرحبا", (8, 20), font_size=24)], SIZE, SIZE,
                            font_size=24)


def _inputs(seed=0, b=2):
    r = np.random.default_rng(seed)
    c = UNION_CFG
    return dict(
        hidden_states=r.standard_normal((b, S_IMG, c.in_channels)).astype(np.float32),
        controlnet_cond=r.standard_normal(
            (b, S_IMG, c.in_channels + c.extra_condition_channels)).astype(np.float32),
        encoder_hidden_states=r.standard_normal((b, 4, c.joint_attention_dim)).astype(np.float32),
        pooled_projections=r.standard_normal((b, c.pooled_projection_dim)).astype(np.float32),
        timestep=np.full((b,), 0.4, np.float32),
        img_ids=np.stack([np.zeros(S_IMG), np.arange(S_IMG) // 4, np.arange(S_IMG) % 4],
                         -1).astype(np.float32),
        txt_ids=np.zeros((4, 3), np.float32),
        guidance=np.full((b,), 3.5, np.float32),
    )


def test_union_controlnet_matches_jax():
    tree = _union_tree()
    inp = _inputs()
    modes = np.array([2, 7], np.int32)
    jb, js = JControlNet(UNION_CFG).apply(tree, *(jnp.asarray(v) for v in inp.values()),
                                          conditioning_scale=0.7, mode=jnp.asarray(modes))
    model = carried(RepTextControlNet(port_config(UNION_CFG)), tree)
    tb, ts = model(*(t(v) for v in inp.values()), conditioning_scale=0.7,
                   mode=torch.from_numpy(modes).long())
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **TOL)
    # the mode token reaches the residuals: another mode, another result
    tb2, _ = model(*(t(v) for v in inp.values()), conditioning_scale=0.7,
                   mode=torch.tensor([3, 7]))
    assert not torch.allclose(tb2[:, 0], tb[:, 0]) and torch.allclose(tb2[:, 1], tb[:, 1])
    assert model.controlnet_mode_embedder.weight.shape == (NUM_MODE, UNION_CFG.inner_dim)


def test_union_controlnet_without_a_mode_raises_as_jax():
    tree = _union_tree()
    inp = _inputs(b=1)
    with pytest.raises(ValueError, match="requires a `mode`"):
        JControlNet(UNION_CFG).apply(tree, *(jnp.asarray(v) for v in inp.values()))
    model = carried(RepTextControlNet(port_config(UNION_CFG)), tree)
    with pytest.raises(ValueError, match="requires a `mode`"):
        model(*(t(v) for v in inp.values()))


def test_union_txt2img_pipeline_matches_jax(params, cond):
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=params, **CFGS)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=params,
                                       device="cpu", **port_configs_of(CFGS))
    noise = np.random.default_rng(7).standard_normal((1, S_IMG, 64)).astype(np.float32)
    jlat = jpipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                 latents=jnp.asarray(noise), output_type="latent")
    tlat = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise), output_type="latent")
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    # the pipeline without a mode refuses, as the JAX one does
    bare = tpipe.with_config(dataclasses.replace(tpipe.pipe_cfg, control_mode=None))
    with pytest.raises(ValueError, match="control_mode"):
        bare(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(noise), output_type="latent")


def test_union_inpaint_pipeline_matches_jax(params, cond):
    jpipe = JInpaint.create_inpaint(inpaint_cn_cfg=INP_CFG, pipe_cfg=PIPE_CFG, params=params,
                                    **CFGS)
    tpipe = FluxRepTextInpaintPipeline.create_inpaint(
        inpaint_cn_cfg=port_config(INP_CFG), pipe_cfg=port_config(PIPE_CFG), params=params,
        device="cpu", **port_configs_of(CFGS))
    r = np.random.default_rng(5)
    image = r.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[10:40, 4:60] = 255
    noise = np.random.default_rng(8).standard_normal((1, S_IMG, 64)).astype(np.float32)
    ids = dict(clip_ids=CLIP_IDS, t5_ids=T5_IDS, negative_clip_ids=NEG_CLIP,
               negative_t5_ids=NEG_T5)
    jlat = jpipe(cond, image=image, mask=mask, latents=jnp.asarray(noise), output_type="latent",
                 **{k: jnp.asarray(v) for k, v in ids.items()})
    tlat = tpipe(cond, image=image, mask=mask, latents=t(noise), output_type="latent", **ids)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)


def test_default_inpaint_controlnet_of_a_union_base_is_not_union():
    from reptext_tpu_torch.pipelines.inpaint import default_inpaint_controlnet_config

    cfg = default_inpaint_controlnet_config(port_config(UNION_CFG))
    assert cfg.num_mode is None and cfg.extra_condition_channels == 4


def _union_train_trees():
    b = _batch()
    z = jnp.zeros((B,))
    flux = random_tree(JFlux(FLUX_CFG), b["x0"], b["prompt_embeds"], b["pooled"], z,
                       b["img_ids"], b["txt_ids"], b["guidance"], seed=1)
    cn = random_tree(JControlNet(UNION_CFG), b["x0"], b["cond_tokens"], b["prompt_embeds"],
                     b["pooled"], z, b["img_ids"], b["txt_ids"], b["guidance"],
                     mode=jnp.zeros((B,), jnp.int32), seed=2)
    return flux, cn


def test_union_train_loss_and_grads_match_jax():
    """The JAX CLI's union cn_apply (mode on every row) against the port's
    loss with ``control_mode``."""
    flux_tree, cn_tree = _union_train_trees()
    jflux, jcn = JFlux(FLUX_CFG), JControlNet(UNION_CFG)

    def flux_apply(p, x, ctx, pooled, tt, iid, tid, g, br, sr):
        return jflux.apply(p, x, ctx, pooled, tt, iid, tid, g,
                           controlnet_block_samples=br, controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, scale):
        return jcn.apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, conditioning_scale=scale,
                         mode=jnp.full((x.shape[0],), 4, jnp.int32))

    batch = _batch()
    rng = jax.random.PRNGKey(3)
    jloss, jgrads = jax.value_and_grad(
        lambda cp: jtrain.controlnet_flow_match_loss(flux_apply, cn_apply, cp, flux_tree,
                                                     batch, rng))(cn_tree)
    draws = _jax_draws(rng, batch["x0"])
    flux = carried(FluxTransformer2D(port_config(FLUX_CFG)), flux_tree).requires_grad_(False)
    cn = carried(RepTextControlNet(port_config(UNION_CFG)), cn_tree)
    loss = ttrain.controlnet_flow_match_loss(flux, cn, {k: t(v) for k, v in batch.items()},
                                             t=t(draws[0]), noise=t(draws[1]), control_mode=4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = flatten_jax_params(np_tree(jgrads))
    for name, p in cn.named_parameters():
        lim = 5e-4 * max(float(np.abs(want[name]).max()), 1e-12)
        assert np.abs(p.grad.numpy() - want[name]).max() <= lim, name
    assert float(np.abs(want["controlnet_mode_embedder.weight"][4]).max()) > 0
    with pytest.raises(ValueError, match="control mode"):
        ttrain.controlnet_flow_match_loss(flux, cn, {k: t(v) for k, v in batch.items()},
                                          t=t(draws[0]), noise=t(draws[1]))


def _cli_union_pipeline(argv):
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.pipelines.txt2img import build_module

    args = cli.build_parser().parse_args(argv)
    pipe = cli.build_pipeline(args)
    pipe.controlnet = build_module(RepTextControlNet, port_config(UNION_CFG), pipe.device,
                                   torch.float32, None, torch.Generator().manual_seed(9),
                                   remat=args.mode == "train")
    return cli, args, pipe


def test_controlnet_mode_flag_reaches_generation(cond):
    base = ["--tiny", "--device", "cpu", "--random-weights", "--size", "64", "--steps", "2",
            "--controlnet-step", "2", "--text", "hi", "--position", "8", "8"]
    cli, args, pipe = _cli_union_pipeline(base + ["--controlnet-mode", "3"])
    assert pipe.pipe_cfg.control_mode == 3
    out = cli.generate(args, pipe, cond, output_type="latent")
    assert out.shape == (1, S_IMG, 64) and torch.isfinite(out).all()
    cli2, args2, pipe2 = _cli_union_pipeline(base)
    assert pipe2.pipe_cfg.control_mode is None
    with pytest.raises(ValueError, match="--controlnet-mode"):
        cli2.generate(args2, pipe2, cond, output_type="latent")


def test_controlnet_mode_flag_trains_a_union_net():
    argv = ["--mode", "train", "--tiny", "--device", "cpu", "--random-weights", "--size", "64",
            "--train-steps", "2", "--batch-size", "2", "--controlnet-mode", "5"]
    cli, args, pipe = _cli_union_pipeline(argv)
    trainer = cli.train(args, pipe, on_event=lambda kind, info: None)
    assert len(trainer.losses) == 2 and all(np.isfinite(trainer.losses))
    emb = pipe.controlnet.controlnet_mode_embedder.weight
    assert emb.requires_grad
    cli2, args2, pipe2 = _cli_union_pipeline(argv[:-2])
    with pytest.raises(SystemExit, match="--controlnet-mode"):
        cli2.train(args2, pipe2)
