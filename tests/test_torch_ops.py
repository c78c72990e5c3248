"""The PyTorch port's core math against the JAX package: latents, half-split
RoPE, the FlowMatch schedule, and the mask resizes (same numpy inputs, fp32).

Tolerances: exact where both sides only move data (pack/unpack/ids); 1e-6 for
fp32 elementwise math (RoPE, schedule); 1e-6 absolute for the antialiased
resize, whose weights the port computes in float64 and JAX in float32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.ops import latents as jlat
from reptext_tpu.ops import rope as jrope
from reptext_tpu.sampling import flow_match as jfm
from reptext_tpu_torch.ops import latents as tlat
from reptext_tpu_torch.ops import rope as trope
from reptext_tpu_torch.sampling import flow_match as tfm

from test_latents import reference_pack


def test_pack_matches_loop_reference_and_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 8)).astype(np.float32)
    got = tlat.pack_latents(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, reference_pack(x))
    np.testing.assert_array_equal(got, np.asarray(jlat.pack_latents(jnp.asarray(x))))


def test_unpack_roundtrip_and_jax():
    x = np.random.default_rng(1).standard_normal((1, 16, 64, 64)).astype(np.float32)
    packed = tlat.pack_latents(torch.from_numpy(x))
    assert packed.shape == (1, 32 * 32, 64)
    np.testing.assert_array_equal(tlat.unpack_latents(packed, 64, 64).numpy(), x)
    jpacked = jlat.pack_latents(jnp.asarray(x))
    np.testing.assert_array_equal(tlat.unpack_latents(packed, 64, 64).numpy(),
                                  np.asarray(jlat.unpack_latents(jpacked, 64, 64)))


def test_latent_image_ids_golden_and_jax():
    ids = tlat.prepare_latent_image_ids(8, 12).numpy()
    assert ids.shape == (24, 3)
    assert ids[0].tolist() == [0, 0, 0] and ids[5].tolist() == [0, 0, 5]
    assert ids[6].tolist() == [0, 1, 0] and ids[23].tolist() == [0, 3, 5]
    np.testing.assert_array_equal(ids, np.asarray(jlat.prepare_latent_image_ids(8, 12)))


@pytest.mark.parametrize("shape,lat", [((64, 64), (4, 4)), ((128, 96), (16, 12)),
                                       ((1024, 1024), (128, 128))])
def test_region_mask_downsample_matches_jax(shape, lat):
    r = np.random.default_rng(2)
    mask = np.zeros(shape, np.float32)
    y0, x0 = r.integers(0, shape[0] // 2), r.integers(0, shape[1] // 2)
    mask[y0:y0 + shape[0] // 3, x0:x0 + shape[1] // 4] = 1.0
    got = tlat.downsample_region_mask(torch.from_numpy(mask), *lat).numpy()
    want = np.asarray(jlat.downsample_region_mask(jnp.asarray(mask), *lat))
    assert got.shape == want.shape == ((lat[0] // 2) * (lat[1] // 2), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_full_region_mask_stays_one():
    full = tlat.downsample_region_mask(torch.ones(32, 32), 8, 8).numpy()
    np.testing.assert_allclose(full, 1.0, rtol=0, atol=1e-6)


def test_resize_is_antialiased_not_plain_bilinear():
    """jax.image.resize('linear') filters when it shrinks: a single ink pixel
    reaches output samples that plain bilinear sampling never reads."""
    img = np.zeros((64, 64), np.float32)
    img[3, 3] = 1.0
    got = tlat.resize_linear(torch.from_numpy(img), 4, 4).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), (4, 4), "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = torch.nn.functional.interpolate(torch.from_numpy(img)[None, None], size=(4, 4),
                                            mode="bilinear", align_corners=False)[0, 0]
    assert got[0, 0] > 0 and float(plain[0, 0]) == 0.0


def test_rope_half_tables_and_rotation_match_jax():
    r = np.random.default_rng(3)
    ids = r.integers(0, 40, size=(24, 3)).astype(np.float32)
    axes = (8, 12, 12)
    x = r.standard_normal((2, 3, 24, 32)).astype(np.float32)
    tc, ts = trope.rope_cos_sin_half(torch.from_numpy(ids), axes)
    jc, js = jrope.rope_cos_sin_half(jnp.asarray(ids), axes)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    got = trope.apply_rope_half(torch.from_numpy(x), tc, ts).numpy()
    want = np.asarray(jrope.apply_rope_half(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rope_half_equals_interleaved_under_permutation():
    """The identity io/convert.py::_lin_rope relies on, checked on the port."""
    from test_rope import reference_rope

    r = np.random.default_rng(4)
    ids = r.integers(0, 32, size=(12, 3)).astype(np.float32)
    axes = (4, 6, 6)
    x = r.standard_normal((2, 3, 12, 16)).astype(np.float32)
    perm = np.concatenate([np.arange(0, 16, 2), np.arange(1, 16, 2)])
    cos, sin = trope.rope_cos_sin_half(torch.from_numpy(ids), axes)
    got = trope.apply_rope_half(torch.from_numpy(x[..., perm]), cos, sin).numpy()
    np.testing.assert_allclose(got, reference_rope(ids, axes, 10000, x)[..., perm],
                               rtol=1e-5, atol=1e-5)


def test_rope_zero_ids_identity():
    cos, sin = trope.rope_cos_sin_half(torch.zeros(10, 3), (16, 56, 56))
    assert cos.shape == sin.shape == (10, 128)
    np.testing.assert_allclose(cos.numpy(), 1.0)
    np.testing.assert_allclose(sin.numpy(), 0.0)


def test_calculate_shift_golden():
    assert math.isclose(tfm.calculate_shift(256), 0.5)
    assert math.isclose(tfm.calculate_shift(4096), 1.16)
    for n in (1024, 4096, 5632):
        assert math.isclose(tfm.calculate_shift(n), jfm.calculate_shift(n))


@pytest.mark.parametrize("steps,seq,dyn", [(30, 4096, True), (10, 1024, True), (4, 0, False)])
def test_schedule_matches_jax(steps, seq, dyn):
    t = tfm.build_schedule(steps, seq, use_dynamic_shifting=dyn, shift=3.0)
    j = jfm.build_schedule(steps, seq, use_dynamic_shifting=dyn, shift=3.0)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert t.num_steps == steps and t.sigmas[-1] == 0.0
    assert math.isclose(float(t.sigmas[0]), 1.0, abs_tol=1e-6) or not dyn


def test_dynamic_shift_formula():
    mu = tfm.calculate_shift(1024)
    sched = tfm.build_schedule(10, 1024)
    raw = np.linspace(1.0, 0.1, 10)
    np.testing.assert_allclose(sched.sigmas[:-1], np.exp(mu) / (np.exp(mu) + (1 / raw - 1)),
                               rtol=1e-5)


def test_euler_step_matches_jax():
    sched = tfm.build_schedule(5, 256)
    jsched = jfm.build_schedule(5, 256)
    r = np.random.default_rng(5)
    x = r.standard_normal((1, 8, 4)).astype(np.float32)
    v = r.standard_normal((1, 8, 4)).astype(np.float32)
    for i in range(5):
        got = sched.step(torch.from_numpy(x), torch.from_numpy(v).to(torch.bfloat16), i)
        want = jsched.step(jnp.asarray(x), jnp.asarray(v, jnp.bfloat16), i)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_glyph_ink_mask_matches_jax_on_a_real_canvas():
    """The glyph-latent init mask: ink > 0, linear resize, > 0 (the JAX
    pipeline's prepare_latents), on a rendered Arabic canvas."""
    from reptext_tpu.conditioning import TextLine, build_conditions

    cond = build_conditions([TextLine("مرحبا بالعالم", (20, 40), font_size=40)], 256, 256,
                            font_size=40)
    canvas = cond.glyph_canvas
    got = tlat.glyph_ink_mask_to_latent(canvas, 32, 32)
    ink = (jnp.asarray(canvas).astype(jnp.float32) > 0).any(axis=-1)
    want = np.asarray((jax.image.resize(ink.astype(jnp.float32), (32, 32), "linear") > 0)
                      .astype(jnp.float32))
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)
