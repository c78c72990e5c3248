"""The port's layers, embeddings, blocks, FLUX, ControlNet and sampler against
the JAX package at tiny geometry: random weights in the Flax trees' shapes
(non-zero ControlNet heads, so the residuals carry signal) carried over by
``load_jax_params``, the same numpy inputs, float32 on the CPU, JAX on its
``xla`` attention backend. Tolerance rtol = atol = 5e-4 (TOL).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import ControlNetConfig, FluxConfig, PipelineConfig
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.nn import blocks as jblocks
from reptext_tpu.nn import embeddings as jemb
from reptext_tpu.nn import layers as jlayers
from reptext_tpu.ops.latents import prepare_latent_image_ids as jids
from reptext_tpu.ops.rope import rope_cos_sin_half
from reptext_tpu.sampling.flow_match import build_schedule as jbuild_schedule
from reptext_tpu.sampling.sampler import make_txt2img_sampler as jmake_sampler
from reptext_tpu_torch.io.from_jax import load_jax_params
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.nn import blocks as tblocks
from reptext_tpu_torch.nn import embeddings as temb
from reptext_tpu_torch.nn import layers as tlayers
from reptext_tpu_torch.sampling.flow_match import build_schedule
from reptext_tpu_torch.sampling.sampler import make_txt2img_sampler

from torch_port_util import TOL, carried, port_config, random_tree, t

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()          # 1 double + 2 single vs the base's 2 + 4
DIM = FLUX_CFG.inner_dim
S_TXT, LAT = 6, 8                           # 8x8 latent -> 16 image tokens
S_IMG = (LAT // 2) ** 2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("name", ["rmsnorm", "adaln_zero", "adaln_single", "adaln_continuous",
                                  "feedforward"])
def test_layer_parity(name):
    x, c = _rand((2, 5, DIM), 1), _rand((2, DIM), 2)
    jmod, tmod, args = {
        "rmsnorm": (jlayers.RMSNorm(DIM), tlayers.RMSNorm(DIM), (x,)),
        "adaln_zero": (jlayers.AdaLayerNormZero(DIM), tlayers.AdaLayerNormZero(DIM), (x, c)),
        "adaln_single": (jlayers.AdaLayerNormZeroSingle(DIM),
                         tlayers.AdaLayerNormZeroSingle(DIM), (x, c)),
        "adaln_continuous": (jlayers.AdaLayerNormContinuous(DIM),
                             tlayers.AdaLayerNormContinuous(DIM), (x, c)),
        "feedforward": (jlayers.FeedForward(DIM, 4.0), tlayers.FeedForward(DIM, 4.0), (x,)),
    }[name]
    tree = random_tree(jmod, *map(jnp.asarray, args), seed=3)
    want = jax.jit(jmod.apply)(tree, *map(jnp.asarray, args))
    with torch.no_grad():
        got = carried(tmod, tree)(*map(t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_norm_and_activation_functions():
    x = _rand((3, 7, 16), 4) * 3.0
    np.testing.assert_allclose(tlayers.layer_norm_no_affine(t(x)).numpy(),
                               np.asarray(jlayers.layer_norm_no_affine(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tlayers.gelu_tanh(t(x)).numpy(),
                               np.asarray(jlayers.gelu_tanh(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_timestep_embedding_matches_jax():
    # at t ~ 1000 a one-ulp difference in a frequency (torch's and XLA's exp)
    # moves the angle by ~3e-5, hence TOL rather than float32 epsilon
    ts = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    for dim in (32, 256, 33):
        np.testing.assert_allclose(temb.timestep_embedding(t(ts), dim).numpy(),
                                   np.asarray(jemb.timestep_embedding(jnp.asarray(ts), dim)),
                                   **TOL)


def test_combined_timestep_text_embed_with_guidance():
    tt, pooled, g = np.array([0.73, 0.2], np.float32), _rand((2, 32), 5), np.array([3.5, 1.0],
                                                                                  np.float32)
    jmod = jemb.CombinedTimestepTextEmbed(DIM, time_embed_dim=32, guidance_embeds=True)
    tree = random_tree(jmod, *map(jnp.asarray, (tt, pooled, g)), seed=6)
    want = jmod.apply(tree, *map(jnp.asarray, (tt, pooled, g)))
    tmod = carried(temb.CombinedTimestepTextEmbed(DIM, 32, 32, True), tree)
    with torch.no_grad():
        got = tmod(t(tt), t(pooled), t(g))
        with pytest.raises(ValueError, match="guidance"):
            tmod(t(tt), t(pooled), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ blocks


def _ids():
    txt = np.zeros((S_TXT, 3), np.float32)
    return txt, np.asarray(jids(LAT, LAT))


def _tables():
    txt, img = _ids()
    return rope_cos_sin_half(jnp.asarray(np.concatenate([txt, img])), FLUX_CFG.axes_dims_rope)


def test_joint_block_parity():
    heads, hd = FLUX_CFG.num_attention_heads, FLUX_CFG.attention_head_dim
    x, ctx, c = _rand((2, S_IMG, DIM), 7), _rand((2, S_TXT, DIM), 8), _rand((2, DIM), 9)
    cos, sin = _tables()
    jmod = jblocks.JointTransformerBlock(DIM, heads, hd, attention_backend="xla")
    args = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(c), cos, sin)
    tree = random_tree(jmod, *args, seed=10)
    want_ctx, want_x = jax.jit(jmod.apply)(tree, *args)
    with torch.no_grad():
        got_ctx, got_x = carried(tblocks.JointTransformerBlock(DIM, heads, hd), tree)(
            t(x), t(ctx), t(c), t(cos), t(sin))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)


def test_single_block_parity():
    heads, hd = FLUX_CFG.num_attention_heads, FLUX_CFG.attention_head_dim
    x, c = _rand((2, S_TXT + S_IMG, DIM), 11), _rand((2, DIM), 12)
    cos, sin = _tables()
    jmod = jblocks.SingleTransformerBlock(DIM, heads, hd, attention_backend="xla")
    args = (jnp.asarray(x), jnp.asarray(c), cos, sin)
    tree = random_tree(jmod, *args, seed=13)
    want = jax.jit(jmod.apply)(tree, *args)
    with torch.no_grad():
        got = carried(tblocks.SingleTransformerBlock(DIM, heads, hd), tree)(
            t(x), t(c), t(cos), t(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------- FLUX / ControlNet


def _inputs(seed, b=2):
    r = np.random.default_rng(seed)
    return {
        "hidden": r.standard_normal((b, S_IMG, FLUX_CFG.in_channels)).astype(np.float32),
        "cond": r.standard_normal((b, S_IMG, 2 * CN_CFG.in_channels)).astype(np.float32),
        "ctx": r.standard_normal((b, S_TXT, FLUX_CFG.joint_attention_dim)).astype(np.float32),
        "pooled": r.standard_normal((b, FLUX_CFG.pooled_projection_dim)).astype(np.float32),
        "t": np.array([0.73, 0.41][:b], np.float32),
        "guidance": np.full((b,), 3.5, np.float32),
    }


@pytest.fixture(scope="module")
def models():
    x = _inputs(0)
    txt, img = _ids()
    common = (jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(x["t"]),
              jnp.asarray(img), jnp.asarray(txt), jnp.asarray(x["guidance"]))
    jflux = JFlux(FLUX_CFG, attention_backend="xla")
    jcn = JControlNet(CN_CFG, attention_backend="xla")
    ftree = random_tree(jflux, jnp.asarray(x["hidden"]), *common, seed=20)
    ctree = random_tree(jcn, jnp.asarray(x["hidden"]), jnp.asarray(x["cond"]), *common, seed=21)
    tflux = carried(FluxTransformer2D(port_config(FLUX_CFG)), ftree)
    tcn = carried(RepTextControlNet(port_config(CN_CFG)), ctree)
    return jflux, jcn, ftree, ctree, tflux, tcn


@pytest.fixture(scope="module")
def jitted(models):
    """One jit of each JAX apply for the module, so equal shapes compile once."""
    return jax.jit(models[0].apply), jax.jit(models[1].apply)


def _run_both(models, jitted, x, scale=0.7, stacks="single", flux=True):
    _, _, ftree, ctree, tflux, tcn = models
    jflux_apply, jcn_apply = jitted
    txt, img = _ids()
    jc = [jnp.asarray(x[k]) for k in ("ctx", "pooled", "t")] + [jnp.asarray(img), jnp.asarray(txt)]
    tc = [t(x[k]) for k in ("ctx", "pooled", "t")] + [t(img), t(txt)]
    jb, js = jcn_apply(ctree, jnp.asarray(x["hidden"]), jnp.asarray(x["cond"]), *jc,
                       jnp.asarray(x["guidance"]), conditioning_scale=scale)
    with torch.no_grad():
        tb, ts = tcn(t(x["hidden"]), t(x["cond"]), *tc, t(x["guidance"]), scale)
    if not flux:
        return (tb, ts), (jb, js), None, None
    if stacks == "tuple":   # two differently deep stacks, summed index-on-read
        jb, js = (jb, jb[:1] * 0.5), (js, js[:1] * 0.5)
        tb, ts = (tb, tb[:1] * 0.5), (ts, ts[:1] * 0.5)
    want = jflux_apply(ftree, jnp.asarray(x["hidden"]), *jc, jnp.asarray(x["guidance"]),
                       controlnet_block_samples=jb, controlnet_single_block_samples=js)
    with torch.no_grad():
        got = tflux(t(x["hidden"]), *tc, t(x["guidance"]), tb, ts)
    return (tb, ts), (jb, js), got, want


def test_controlnet_parity(models, jitted):
    (tb, ts), (jb, js), _, _ = _run_both(models, jitted, _inputs(1), flux=False)
    assert tb.shape == (CN_CFG.num_layers, 2, S_IMG, DIM)
    assert ts.shape == (CN_CFG.num_single_layers, 2, S_IMG, DIM)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert np.abs(ts.numpy()).max() > 1e-3   # the heads carry signal


@pytest.mark.parametrize("stacks", ["single", "tuple"])
def test_flux_with_depth_mismatched_controlnet(models, jitted, stacks):
    """1 double residual over 2 base blocks, 2 single residuals over 4: pins
    the ceil-interval index and the after-block injection point."""
    _, _, got, want = _run_both(models, jitted, _inputs(2), stacks=stacks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flux_without_residuals(models, jitted):
    _, _, ftree, _, tflux, _ = models
    x = _inputs(3)
    txt, img = _ids()
    want = jitted[0](
        ftree, *(jnp.asarray(x[k]) for k in ("hidden", "ctx", "pooled", "t")),
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(x["guidance"]))
    with torch.no_grad():
        got = tflux(*(t(x[k]) for k in ("hidden", "ctx", "pooled", "t")), t(img), t(txt),
                    t(x["guidance"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sampler_two_steps_two_lines(models):
    """Two Euler steps, two text lines on the batch axis, ControlNet gated on
    for step 0 only: lines stacking, regional masks, gating, t/1000, Euler."""
    jflux, jcn, ftree, ctree, tflux, tcn = models
    steps = 2
    pipe_cfg = PipelineConfig(height=8 * LAT, width=8 * LAT, num_inference_steps=steps,
                              controlnet_conditioning_step=1, controlnet_conditioning_scale=0.9)
    x = _inputs(4, b=1)
    r = np.random.default_rng(44)
    cond = r.standard_normal((2, S_IMG, 2 * CN_CFG.in_channels)).astype(np.float32)
    masks = (r.random((2, S_IMG, 1)) > 0.4).astype(np.float32)
    txt, img = _ids()
    jsample = jmake_sampler(functools.partial(jflux.apply), functools.partial(jcn.apply),
                            jbuild_schedule(steps, S_IMG), pipe_cfg)
    want = jax.jit(jsample)(
        ftree, ctree, jnp.asarray(x["hidden"]), jnp.asarray(cond), jnp.asarray(masks),
        jnp.asarray(x["ctx"]), jnp.asarray(x["pooled"]), jnp.asarray(txt), jnp.asarray(img),
        jnp.asarray(x["guidance"]))
    tsample = make_txt2img_sampler(tflux, tcn, build_schedule(steps, S_IMG),
                                   port_config(pipe_cfg))
    with torch.no_grad():
        got = tsample(t(x["hidden"]), t(cond), t(masks), t(x["ctx"]), t(x["pooled"]), t(txt),
                      t(img), t(x["guidance"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sampler_refuses_the_velocity_cache(models):
    """The velocity cache is ported (tests/test_torch_velocity_cache.py); the
    sampler refuses only a cache mode it does not know."""
    cfg = port_config(PipelineConfig(velocity_cache_interval=2, velocity_cache_mode="quadratic"))
    with pytest.raises(ValueError, match="velocity cache"):
        make_txt2img_sampler(models[4], models[5], build_schedule(2, S_IMG), cfg)
    make_txt2img_sampler(models[4], models[5], build_schedule(2, S_IMG),
                         port_config(PipelineConfig(velocity_cache_interval=2)))


def test_load_jax_params_checks_names_and_shapes(models):
    ftree = models[2]
    tree = jax.tree_util.tree_map(lambda a: a, ftree)
    del tree["params"]["proj_out"]["bias"]
    with pytest.raises(KeyError, match="proj_out.bias"):
        load_jax_params(FluxTransformer2D(port_config(FLUX_CFG)), tree)
    tree = jax.tree_util.tree_map(lambda a: a, ftree)
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra.weight"):
        load_jax_params(FluxTransformer2D(port_config(FLUX_CFG)), tree)
    small = port_config(dataclasses.replace(FLUX_CFG, in_channels=32))
    with pytest.raises(ValueError, match="x_embedder.weight"):
        load_jax_params(FluxTransformer2D(small), ftree)
