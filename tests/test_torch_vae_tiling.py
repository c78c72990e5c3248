"""The port's tiled VAE (``ops/vae_tiling.py``, ``enable_vae_tiling``) against
the JAX package's, on the CPU.

- ``tile_positions`` and ``blend_weights_1d`` equal to the JAX functions;
- ``tiled_apply`` against the JAX one: identity and x8 nearest maps (exact,
  as tests/test_vae_tiling.py pins), the tiny VAE's decode and encode (the
  mode) on the same weights within TOL (5e-4); the tiled decode against the
  untiled one within tests/test_vae_tiling.py's limits (mean < 0.1, 99th
  percentile < 0.4, max < 1.5 of the decode's std), also for a rectangular
  input with one side at most the tile and the other larger, which the JAX
  function fails on;
- the pipeline with tiling against the JAX pipeline with tiling through
  ``latents=`` (latents within TOL, images within 2 levels), a tiled decode
  with gradients, and ``enable_vae_tiling``'s validation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import VAEConfig
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.ops import vae_tiling as jt
from reptext_tpu_torch.nn.vae import AutoencoderKL
from reptext_tpu_torch.ops import vae_tiling as tt
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

from torch_port_util import TOL, carried, port_config, random_tree


@pytest.mark.parametrize("size,tile,stride", [(128, 64, 48), (128, 48, 32), (100, 64, 48),
                                              (64, 64, 48), (40, 64, 48), (130, 64, 48)])
def test_tile_positions_and_blend_weights_equal_jax(size, tile, stride):
    pos = tt.tile_positions(size, tile, stride)
    assert pos == jt.tile_positions(size, tile, stride)
    t = min(tile, size)
    for p in pos:
        for overlap in (0, 8, 16):
            np.testing.assert_array_equal(tt.blend_weights_1d(t, overlap, p, size),
                                          jt.blend_weights_1d(t, overlap, p, size))
    with pytest.raises(ValueError):
        tt.tile_positions(size + tile, tile, 0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


def test_tiled_identity_and_scaled_maps_are_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 80, 112, 3)).astype(np.float32)
    out = tt.tiled_apply(lambda t, i: t, _nchw(x), 48, 16, 1, 1, 3)
    np.testing.assert_allclose(_nhwc(out), x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _nhwc(out), jt.tiled_apply(lambda t, i: t, x, 48, 16, 1, 1, 3), rtol=0, atol=1e-6)
    y = rng.standard_normal((1, 24, 24, 2)).astype(np.float32)
    up = tt.tiled_apply(lambda t, i: t.repeat_interleave(8, 2).repeat_interleave(8, 3),
                        _nchw(y), 16, 8, 8, 1, 2)
    np.testing.assert_allclose(_nhwc(up), np.repeat(np.repeat(y, 8, axis=1), 8, axis=2),
                               atol=1e-5)
    # tiles in row-major order, each once
    seen = []
    tt.tiled_apply(lambda t, i: seen.append(i) or t, _nchw(x), 48, 16, 1, 1, 3)
    assert seen == list(range(len(seen))) and len(seen) == 2 * 3


@pytest.fixture(scope="module")
def vaes():
    cfg = VAEConfig().tiny()
    jvae = JVAE(cfg)
    params = random_tree(jvae, jnp.zeros((1, 8 * cfg.scale_factor, 8 * cfg.scale_factor, 3)))
    tvae = carried(AutoencoderKL(port_config(cfg)), params)
    return cfg, jvae, params, tvae


def _close_to_full(tiled, full):
    """tests/test_vae_tiling.py's limits, relative to the decode's std."""
    d = np.abs(tiled - full)
    std = full.std()
    assert d.mean() < 0.1 * std and np.percentile(d, 99) < 0.4 * std and d.max() < 1.5 * std


def test_tiled_decode_matches_jax_and_the_full_decode(vaes):
    cfg, jvae, params, tvae = vaes
    lat = np.random.default_rng(2).standard_normal((1, 48, 48, cfg.latent_channels)).astype(
        np.float32)
    jfn = lambda t, i: jvae.apply(params, jnp.asarray(t), method="decode")  # noqa: E731
    want = jt.tiled_apply(jfn, lat, 32, 8, cfg.scale_factor, 1, cfg.out_channels)
    with torch.no_grad():
        got = tt.tiled_apply(lambda t, i: tvae.decode(t), _nchw(lat), 32, 8, cfg.scale_factor,
                             1, cfg.out_channels)
        full = tvae.decode(_nchw(lat))
    assert got.dtype == torch.float32 and got.shape == full.shape
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    _close_to_full(got.numpy(), full.numpy())


def test_tiled_encode_mode_matches_jax(vaes):
    cfg, jvae, params, tvae = vaes
    f = cfg.scale_factor
    img = np.random.default_rng(3).uniform(-1, 1, (1, 24 * f, 24 * f, 3)).astype(np.float32)
    jfn = lambda t, i: jvae.apply(params, jnp.asarray(t), None, method="encode")  # noqa: E731
    want = jt.tiled_apply(jfn, img, 16 * f, 8 * f, 1, f, cfg.latent_channels)
    with torch.no_grad():
        got = tt.tiled_apply(lambda t, i: tvae.encode(t), _nchw(img), 16 * f, 8 * f, 1, f,
                             cfg.latent_channels)
        full = tvae.encode(_nchw(img))
    np.testing.assert_allclose(_nhwc(got), want, **TOL)
    assert np.abs(got.numpy() - full.numpy()).mean() < 0.2


def test_rectangular_input_runs_where_the_jax_function_fails(vaes):
    """One side at most the tile, the other larger (a 1024 x 512 request on a
    tiling deployment): the JAX function's tiles and its canvas disagree; the
    port clamps the tile per axis."""
    cfg, jvae, params, tvae = vaes
    lat = np.random.default_rng(4).standard_normal((1, 24, 56, cfg.latent_channels)).astype(
        np.float32)
    jfn = lambda t, i: jvae.apply(params, jnp.asarray(t), method="decode")  # noqa: E731
    with pytest.raises(Exception):
        jt.tiled_apply(jfn, lat, 32, 8, cfg.scale_factor, 1, cfg.out_channels)
    with torch.no_grad():
        got = tt.tiled_apply(lambda t, i: tvae.decode(t), _nchw(lat), 32, 8, cfg.scale_factor,
                             1, cfg.out_channels)
        full = tvae.decode(_nchw(lat))
    assert got.shape == full.shape == (1, 3, 24 * 8, 56 * 8)
    _close_to_full(got.numpy(), full.numpy())
    # the tall side's tiles are the JAX function's on the transposed problem's columns
    jcols = jt.tiled_apply(lambda t, i: t, lat[:, :, :, :2], 24, 8, 1, 1, 2)
    np.testing.assert_allclose(
        _nhwc(tt.tiled_apply(lambda t, i: t, _nchw(lat[:, :, :, :2]), 32, 8, 1, 1, 2)), jcols,
        rtol=0, atol=1e-6)


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipes():
    from test_torch_quantize import CFGS, PIPE_CFG, _shared_params

    from reptext_tpu.conditioning import TextLine, build_conditions
    from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
    from torch_port_util import port_configs_of

    params = _shared_params()
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=params, **CFGS)
    jpipe.enable_vae_tiling(tile_latent=4, overlap_latent=2)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=params,
                                       device="cpu", **port_configs_of(CFGS))
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], PIPE_CFG.width,
                            PIPE_CFG.height, font_size=24)
    noise = np.random.default_rng(7).standard_normal(
        (1, PIPE_CFG.image_seq_len, 4 * CFGS["vae_cfg"].latent_channels)).astype(np.float32)
    return jpipe, tpipe, cond, noise


def test_tiled_pipeline_matches_jax(pipes):
    from test_torch_quantize import CLIP_IDS, T5_IDS

    from reptext_tpu.utils.image import postprocess_images

    jpipe, tpipe, cond, noise = pipes
    tiled = tpipe.with_config(tpipe.pipe_cfg).enable_vae_tiling(tile_latent=4, overlap_latent=2)
    assert tpipe.vae_tiling is None and tiled.vae_tiling == (4, 2)
    jlat = jpipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                 latents=jnp.asarray(noise), output_type="latent")
    tlat = tiled(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=torch.from_numpy(noise),
                 output_type="latent")
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    jimg, timg = postprocess_images(jpipe._decode(jlat)), tiled.decode(tlat)
    assert timg.shape == jimg.shape and np.abs(timg.astype(int) - jimg.astype(int)).max() <= 2
    # the condition tokens went through the tiled encode: they differ from untiled
    g = torch.Generator().manual_seed(1)
    tok_tiled = tiled.prepare_control_tokens(cond, g)[0]
    tok_full = tpipe.prepare_control_tokens(cond, torch.Generator().manual_seed(1))[0]
    assert tok_tiled.dtype == torch.float32 and not torch.equal(tok_tiled, tok_full)


def test_tiled_decode_carries_gradients(pipes):
    _, tpipe, _, noise = pipes
    tiled = tpipe.with_config(tpipe.pipe_cfg).enable_vae_tiling(tile_latent=4, overlap_latent=2)
    lat = torch.tensor(noise, requires_grad=True)
    images = tiled.decode_images(lat)
    assert images.shape == (1, 3, tpipe.pipe_cfg.height, tpipe.pipe_cfg.width)
    images.square().mean().backward()
    assert torch.isfinite(lat.grad).all() and lat.grad.abs().sum() > 0
    with torch.no_grad():
        assert torch.equal(tiled.decode_images(lat.detach()), images.detach())
        assert not torch.equal(tpipe.decode_images(lat.detach()), images.detach())


def test_enable_vae_tiling_validates(pipes):
    _, tpipe, _, _ = pipes
    view = tpipe.with_config(tpipe.pipe_cfg)
    for tile, overlap in ((8, 8), (8, 9)):
        with pytest.raises(ValueError, match="overlap"):
            view.enable_vae_tiling(tile, overlap)
    assert view.vae_tiling is None
    assert view.enable_vae_tiling() is view and view.vae_tiling == (72, 16)
