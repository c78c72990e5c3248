"""The port's VAE, CLIP and T5 against the JAX package at tiny geometry
(random weights in the Flax trees' shapes, carried by ``load_jax_params``;
same numpy inputs; float32 on the CPU; tolerance TOL = 5e-4). The JAX VAE is
NHWC, the port's NCHW: inputs and outputs are transposed at the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import CLIPConfig, T5Config, VAEConfig
from reptext_tpu.nn.clip import CLIPTextEncoder as JCLIP
from reptext_tpu.nn.t5 import T5Encoder as JT5
from reptext_tpu.nn.t5 import relative_position_bucket as jbucket
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu_torch.nn.clip import CLIPTextEncoder
from reptext_tpu_torch.nn.t5 import T5Encoder, relative_position_bucket
from reptext_tpu_torch.nn.vae import AutoencoderKL

from torch_port_util import TOL, carried, port_config, random_tree, t

VAE_CFG = VAEConfig().tiny()


@pytest.fixture(scope="module")
def vae():
    img = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jvae = JVAE(VAE_CFG)
    tree = random_tree(jvae, jnp.asarray(img), seed=1)
    return jvae, tree, carried(AutoencoderKL(port_config(VAE_CFG)), tree), img


def test_vae_encode_moments(vae):
    jvae, tree, tvae, img = vae
    want_m, want_lv = jax.jit(lambda p, x: jvae.apply(p, x, method="encode_moments"))(
        tree, jnp.asarray(img))
    with torch.no_grad():
        got_m, got_lv = tvae.encode_moments(t(img).permute(0, 3, 1, 2))
    assert got_m.shape == (2, VAE_CFG.latent_channels, 4, 4)
    np.testing.assert_allclose(got_m.permute(0, 2, 3, 1).numpy(), np.asarray(want_m), **TOL)
    np.testing.assert_allclose(got_lv.permute(0, 2, 3, 1).numpy(), np.asarray(want_lv), **TOL)


def test_vae_encode_sample(vae):
    """encode() is the posterior mean without a generator, and mean + std *
    the generator's normal draw with one."""
    _, _, tvae, img = vae
    x = t(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        mean, logvar = tvae.encode_moments(x)
        np.testing.assert_array_equal(tvae.encode(x).numpy(), mean.numpy())
        got = tvae.encode(x, torch.Generator().manual_seed(5))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(got.numpy(), (mean + torch.exp(0.5 * logvar) * noise).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_vae_decode(vae):
    jvae, tree, tvae, _ = vae
    lat = np.random.default_rng(2).standard_normal((2, 4, 4, VAE_CFG.latent_channels))
    lat = lat.astype(np.float32)
    want = jax.jit(lambda p, z: jvae.apply(p, z, method="decode"))(tree, jnp.asarray(lat))
    with torch.no_grad():
        got = tvae.decode(t(lat).permute(0, 3, 1, 2))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_clip_text_encoder():
    cfg = CLIPConfig().tiny()
    ids = np.array([[3, 7, 9, 255, 0, 0, 0, 0, 0, 0],
                    [5, 255, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    jclip = JCLIP(cfg)
    tree = random_tree(jclip, jnp.asarray(ids), seed=3)
    want_x, want_pooled = jax.jit(jclip.apply)(tree, jnp.asarray(ids))
    tclip = carried(CLIPTextEncoder(port_config(cfg)), tree)
    with torch.no_grad():
        got_x, got_pooled = tclip(torch.from_numpy(ids).long())
        with pytest.raises(ValueError, match="max_position_embeddings"):
            tclip(torch.zeros(1, cfg.max_position_embeddings + 1, dtype=torch.long))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(want_pooled), **TOL)


def test_t5_relative_position_bucket():
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        got = relative_position_bucket(torch.from_numpy(rel), buckets, dist).numpy()
        np.testing.assert_array_equal(got, np.asarray(jbucket(jnp.asarray(rel), buckets, dist)))


def test_t5_encoder():
    cfg = T5Config().tiny()
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jt5 = JT5(cfg)
    tree = random_tree(jt5, jnp.asarray(ids), seed=5)
    want = jax.jit(jt5.apply)(tree, jnp.asarray(ids))
    with torch.no_grad():
        got = carried(T5Encoder(port_config(cfg)), tree)(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
