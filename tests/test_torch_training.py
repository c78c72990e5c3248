"""The port's training steps with the OCR term, the joint step and the base-only
step against the JAX package's, on the CPU.

Tiny FLUX + ControlNet (``tests/test_torch_train.py``'s trees and batch), a
tiny VAE decoder from a random Flax tree and the committed OCR judge, float32,
JAX's own t and noise passed to the port. Checks:

- ``controlnet_flow_match_loss`` with ``perceptual`` (the JAX test's stand-in
  decoder, and the real tiny VAE decoder through the pipeline's
  ``decode_images``): the loss and every ControlNet gradient;
- ``make_controlnet_train_step`` with the term: frozen modules refused, the
  VAE and judge bit-identical after a step;
- ``make_joint_train_step``: the loss and the gradients of both trees and the
  SGD update, against JAX's step;
- ``flow_match_loss`` / ``make_train_step`` (``sampling/training.py``);
- the recomputed (remat) decode's gradient equal to the plain decode's.

Tolerances: TOL (5e-4) for losses; gradients within 5e-4 of each leaf's
max|JAX grad| (fp32 through the blocks, the decoder and the judge, sums in
another order), as in ``tests/test_torch_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reptext_tpu.configs import VAEConfig
from reptext_tpu.eval import ocr as jocr
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.ops.latents import unpack_latents as j_unpack
from reptext_tpu.sampling import train_controlnet as jtrain
from reptext_tpu.sampling import training as jtraining
from reptext_tpu_torch.configs import PipelineConfig
from reptext_tpu_torch.eval import ocr as tocr
from reptext_tpu_torch.io.from_jax import flatten_jax_params
from reptext_tpu_torch.nn.vae import AutoencoderKL
from reptext_tpu_torch.ops.latents import unpack_latents
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling import train_controlnet as ttrain
from reptext_tpu_torch.sampling import training as ttraining
from reptext_tpu_torch.sampling.ocr_loss import aspect_box

from test_torch_train import (
    B, FLUX_CFG, _apply_fns, _batch, _jax_draws, _port_models, _trees,
)
from torch_port_util import TOL, carried, np_tree, port_config, random_tree, t

VAE_CFG = VAEConfig().tiny()
LAT = 8                      # latent 8 x 8: the batch's 16 packed tokens
HW = LAT * 8                 # a 64 x 64 image
WEIGHT = 0.3


def _ocr_batch():
    b = _batch()
    labels = np.zeros((B, tocr.MAX_LABEL), np.int32)
    paddings = np.ones((B, tocr.MAX_LABEL), np.float32)
    for i, w in enumerate(["HI", "مرحبا"]):
        ids = tocr.label_ids(w)
        labels[i, : len(ids)] = ids
        paddings[i, : len(ids)] = 0.0
    b["ocr_boxes"] = np.stack([aspect_box((20, 8, 34, 50), HW, HW),
                               aspect_box((2, 30, 12, 70), HW, HW)])
    b["ocr_labels"], b["ocr_paddings"] = labels, paddings
    return b


def _port_batch(batch):
    out = {k: t(v) for k, v in batch.items()}
    if "ocr_labels" in batch:
        out["ocr_labels"] = torch.from_numpy(batch["ocr_labels"]).long()
    return out


@functools.lru_cache(maxsize=None)
def _vae_tree():
    img = np.zeros((1, HW, HW, 3), np.float32)
    return random_tree(JVAE(VAE_CFG), jnp.asarray(img), seed=3)


@functools.lru_cache(maxsize=None)
def _judge_params():
    return jocr.load_judge()


def _judge():
    return tocr.load_judge(device="cpu")


def _jax_decode(kind):
    if kind == "standin":
        # tests/test_ocr_loss.py's stand-in: unpack, widen the first 3 channels
        def decode_apply(vae_params, x0_packed):
            lat = j_unpack(x0_packed, LAT, LAT)
            img = jnp.repeat(jnp.repeat(lat[:, :3], 8, axis=2), 8, axis=3)
            return img.transpose(0, 2, 3, 1)
    else:
        vae = JVAE(VAE_CFG)

        def decode_apply(vae_params, x0_packed):
            lat = j_unpack(x0_packed, LAT, LAT)
            lat = lat / VAE_CFG.scaling_factor + VAE_CFG.shift_factor
            return vae.apply(vae_params, lat.transpose(0, 2, 3, 1), method="decode")
    return decode_apply


def _port_vae(remat=False):
    return carried(AutoencoderKL(port_config(VAE_CFG), remat=remat),
                   _vae_tree()).requires_grad_(False)


def _port_decode(kind, flux, cn, vae=None):
    if kind == "standin":
        def decode(x0_packed):
            lat = unpack_latents(x0_packed, LAT, LAT)
            return lat[:, :3].repeat_interleave(8, dim=2).repeat_interleave(8, dim=3)
        return decode
    pipe = FluxRepTextPipeline(flux, cn, vae if vae is not None else _port_vae(),
                               PipelineConfig(height=HW, width=HW))
    return pipe.decode_images


@functools.lru_cache(maxsize=None)
def _jax_ocr_value_and_grad(kind):
    flux_apply, cn_apply = _apply_fns()
    perceptual = {"decode_apply": _jax_decode(kind), "judge_apply": None, "weight": WEIGHT}

    def loss(cn_params, flux_params, batch, rng, vae_params, judge_params):
        return jtrain.controlnet_flow_match_loss(
            flux_apply, cn_apply, cn_params, flux_params, batch, rng, text_loss_weight=2.0,
            perceptual=perceptual, vae_params=vae_params, judge_params=judge_params)

    return jax.jit(jax.value_and_grad(loss))


def _assert_grads(got, want_tree):
    want = flatten_jax_params(np_tree(want_tree))
    assert set(got) == set(want)
    for n, g in got.items():
        scale = max(float(np.abs(want[n]).max()), 1e-12)
        assert float(np.abs(g - want[n]).max()) <= 5e-4 * scale, n


@pytest.mark.parametrize("kind", ["standin", "vae"])
def test_perceptual_loss_and_grads_match_jax(kind):
    flux_tree, cn_tree = _trees()
    batch = _ocr_batch()
    rng = jax.random.PRNGKey(7)
    vae_params = _vae_tree() if kind == "vae" else None
    loss_j, grads_j = _jax_ocr_value_and_grad(kind)(cn_tree, flux_tree, batch, rng,
                                                    vae_params, _judge_params())
    flux, cn = _port_models()
    tt, noise = _jax_draws(rng, batch["x0"])
    perceptual = {"decode": _port_decode(kind, flux, cn), "judge": _judge(), "weight": WEIGHT}
    loss_t = ttrain.controlnet_flow_match_loss(flux, cn, _port_batch(batch), t=t(tt),
                                               noise=t(noise), perceptual=perceptual)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    _assert_grads({n: p.grad.numpy() for n, p in cn.named_parameters()}, grads_j)
    # the term is there: the loss at weight 0 is smaller by WEIGHT x the term
    with torch.no_grad():
        base = ttrain.controlnet_flow_match_loss(flux, cn, _port_batch(batch), t=t(tt),
                                                 noise=t(noise))
    assert loss_t.item() > base.item()


def test_train_step_with_the_ocr_term_keeps_the_frozen_modules():
    """One step through the real tiny decoder: finite loss, ControlNet updated,
    the base, the VAE and the judge bit-identical with no gradients; a
    judge or VAE that requires gradients is refused."""
    flux, cn = _port_models()
    vae, judge = _port_vae(), _judge()
    frozen = {m: {n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (flux, vae, judge)}
    before = {n: p.detach().clone() for n, p in cn.named_parameters()}
    perceptual = {"decode": _port_decode("vae", flux, cn, vae), "judge": judge,
                  "weight": WEIGHT}
    opt = torch.optim.Adam(cn.parameters(), lr=1e-3)
    step = ttrain.bind_frozen_base(
        ttrain.make_controlnet_train_step(cn, opt, perceptual=perceptual), flux, vae, judge)
    loss = step(_port_batch(_ocr_batch()), torch.Generator().manual_seed(1))
    assert np.isfinite(loss.item())
    assert any(not torch.equal(p, before[n]) for n, p in cn.named_parameters())
    for m, params in frozen.items():
        for n, p in m.named_parameters():
            assert p.grad is None and torch.equal(p, params[n]), n
    judge.Dense_1.weight.requires_grad_(True)
    with pytest.raises(ValueError, match="OCRJudge must be frozen"):
        step(_port_batch(_ocr_batch()), torch.Generator().manual_seed(1))
    judge.Dense_1.weight.requires_grad_(False)
    vae.decoder.conv_out.weight.requires_grad_(True)
    with pytest.raises(ValueError, match="AutoencoderKL must be frozen"):
        step(_port_batch(_ocr_batch()), torch.Generator().manual_seed(1))


def _use_draws(monkeypatch, module, name, draws):
    """Make ``module.name`` (a loss the step calls) take JAX's t and noise."""
    real = getattr(module, name)
    tt, noise = draws
    monkeypatch.setattr(module, name, functools.partial(real, t=t(tt), noise=t(noise)))


@pytest.mark.parametrize("ocr", [False, True])
def test_joint_train_step_matches_jax(monkeypatch, ocr):
    """make_joint_train_step: one SGD step over both trees; the loss, every
    base and ControlNet gradient, and the updated parameters."""
    lr = 1e-2
    flux_tree, cn_tree = _trees()
    batch = _ocr_batch() if ocr else _batch()
    rng = jax.random.PRNGKey(9)
    flux_apply, cn_apply = _apply_fns()
    perceptual_j = ({"decode_apply": _jax_decode("vae"), "judge_apply": None,
                     "weight": WEIGHT} if ocr else None)
    step_j = jax.jit(jtrain.make_joint_train_step(flux_apply, cn_apply, optax.sgd(lr),
                                                  perceptual=perceptual_j))
    params = {"flux": flux_tree, "controlnet": cn_tree}
    frozen_j = (_vae_tree(), _judge_params()) if ocr else ()
    new_j, _, loss_j = step_j(params, optax.sgd(lr).init(params), batch, rng, *frozen_j)
    grads_j = jax.jit(jax.grad(lambda p, *fz: jtrain.controlnet_flow_match_loss(
        flux_apply, cn_apply, p["controlnet"], p["flux"], batch, rng,
        perceptual=perceptual_j, vae_params=fz[0] if fz else None,
        judge_params=fz[1] if fz else None)))(params, *frozen_j)

    flux, cn = _port_models()
    flux.requires_grad_(True)
    vae, judge = _port_vae(), _judge()
    perceptual = ({"decode": _port_decode("vae", flux, cn, vae), "judge": judge,
                   "weight": WEIGHT} if ocr else None)
    _use_draws(monkeypatch, ttrain, "controlnet_flow_match_loss",
               _jax_draws(rng, batch["x0"]))
    opt = torch.optim.SGD(list(flux.parameters()) + list(cn.parameters()), lr=lr)
    step = ttrain.make_joint_train_step(flux, cn, opt, perceptual=perceptual)
    loss_t = step(_port_batch(batch), None, *((vae, judge) if ocr else ()))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    for module, key in ((flux, "flux"), (cn, "controlnet")):
        _assert_grads({n: p.grad.numpy() for n, p in module.named_parameters()}, grads_j[key])
        want = flatten_jax_params(np_tree(new_j[key]))
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-5,
                                       err_msg=n)
    # the base received gradient, as the ControlNet did
    assert any(float(p.grad.abs().max()) > 0 for p in flux.parameters())
    if ocr:
        vae.decoder.conv_out.weight.requires_grad_(True)
        with pytest.raises(ValueError, match="frozen"):
            step(_port_batch(batch), None, vae, judge)


@functools.lru_cache(maxsize=None)
def _jax_base_step(lr):
    flux = JFlux(FLUX_CFG)

    def apply_fn(p, x, ctx, pooled, tt, iid, tid, g):
        return flux.apply(p, x, ctx, pooled, tt, iid, tid, g)

    loss = jax.jit(jax.value_and_grad(
        lambda p, b, r: jtraining.flow_match_loss(apply_fn, p, b, r)))
    step = jax.jit(jtraining.make_train_step(apply_fn, optax.sgd(lr)))
    return loss, step


def test_base_only_loss_step_and_grads_match_jax(monkeypatch):
    lr = 1e-2
    flux_tree, _ = _trees()
    batch = _batch()
    rng = jax.random.PRNGKey(11)
    loss_fn, step_fn = _jax_base_step(lr)
    loss_j, grads_j = loss_fn(flux_tree, batch, rng)
    new_j, _, loss_step_j = step_fn(flux_tree, optax.sgd(lr).init(flux_tree), batch, rng)
    np.testing.assert_allclose(float(loss_step_j), float(loss_j), rtol=1e-6)

    flux, _ = _port_models()
    flux.requires_grad_(True)
    draws = _jax_draws(rng, batch["x0"])
    loss_t = ttraining.flow_match_loss(flux, _port_batch(batch), t=t(draws[0]),
                                       noise=t(draws[1]))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)

    _use_draws(monkeypatch, ttraining, "flow_match_loss", draws)
    step = ttraining.make_train_step(flux, torch.optim.SGD(flux.parameters(), lr=lr))
    loss_s = step(_port_batch(batch), None)
    np.testing.assert_allclose(loss_s.item(), float(loss_j), **TOL)
    _assert_grads({n: p.grad.numpy() for n, p in flux.named_parameters()}, grads_j)
    want = flatten_jax_params(np_tree(new_j))
    for n, p in flux.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-5, err_msg=n)


def test_base_only_step_draws_from_the_generator():
    """Without t and noise the step draws them from its generator: the same
    seed gives the same loss, another seed another."""
    def loss_of(seed):
        flux, _ = _port_models()
        flux.requires_grad_(True)
        step = ttraining.make_train_step(flux, torch.optim.SGD(flux.parameters(), lr=0.0))
        return step(_port_batch(_batch()), torch.Generator().manual_seed(seed)).item()

    assert loss_of(3) == loss_of(3) != loss_of(4)


def test_recomputed_decode_gives_the_plain_gradient():
    """The decoder under remat (each resnet and attention block recomputed in
    backward) against the plain decoder: the same images and the same
    gradient w.r.t. the latents, to the bit on the CPU; the VAE's parameters
    get no gradient."""
    r = np.random.default_rng(21)
    z = r.standard_normal((2, VAE_CFG.latent_channels, LAT, LAT)).astype(np.float32)
    cot = r.standard_normal((2, 3, HW, HW)).astype(np.float32)
    outs = []
    for remat in (False, True):
        vae = _port_vae(remat)
        zt = torch.tensor(z, requires_grad=True)
        img = vae.decode(zt)
        (img * torch.from_numpy(cot)).sum().backward()
        outs.append((img.detach(), zt.grad))
        assert all(p.grad is None for p in vae.parameters())
    np.testing.assert_array_equal(outs[1][0].numpy(), outs[0][0].numpy())
    np.testing.assert_array_equal(outs[1][1].numpy(), outs[0][1].numpy())
    assert float(outs[0][1].abs().max()) > 0


def test_perceptual_loss_with_the_recomputed_decode_is_unchanged():
    flux, cn = _port_models()
    batch = _port_batch(_ocr_batch())
    draws = _jax_draws(jax.random.PRNGKey(12), _ocr_batch()["x0"])
    grads = []
    for remat in (False, True):
        cn.zero_grad(set_to_none=True)
        perceptual = {"decode": _port_decode("vae", flux, cn, _port_vae(remat)),
                      "judge": _judge(), "weight": WEIGHT}
        loss = ttrain.controlnet_flow_match_loss(flux, cn, batch, t=t(draws[0]),
                                                 noise=t(draws[1]), perceptual=perceptual)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in cn.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][n], g, rtol=1e-6, atol=1e-9)
