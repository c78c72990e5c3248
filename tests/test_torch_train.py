"""The port's ControlNet training recipe against the JAX package's, on the CPU.

Tiny FLUX + ControlNet geometry in float32, weights from one random Flax tree
(nonzero heads, so every gradient carries information) carried into both
sides, and JAX's own t and noise draws passed to the port. Checks the warm
start, the region-weighted flow-matching loss, the ControlNet gradients per
leaf, remat, the frozen base, one AdamW update on shared gradients, and the
weight-decay mask. Tolerances: TOL (5e-4) for the loss; gradients within 5e-4
of each leaf's max|JAX grad| (fp32 through 9 blocks, sums in another order);
the AdamW update within 1e-6 (the same fp32 formula).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reptext_tpu.configs import ControlNetConfig, FluxConfig
from reptext_tpu.models import controlnet as jcontrolnet
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.ops.latents import prepare_latent_image_ids
from reptext_tpu.sampling import train_controlnet as jtrain
from reptext_tpu_torch.io.from_jax import flatten_jax_params, flax_leaf_kinds
from reptext_tpu_torch.models.controlnet import RepTextControlNet, params_from_transformer
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.nn.init import random_init_
from reptext_tpu_torch.sampling import train_controlnet as ttrain

from torch_port_util import TOL, carried, np_tree, port_config, random_tree, t

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()
B, S_TXT, S_IMG = 2, 4, 16


def _batch(mask="half", seed=0):
    r = np.random.default_rng(seed)
    cond_feat = CN_CFG.in_channels + CN_CFG.extra_condition_channels
    m = np.ones((B, S_IMG, 1), np.float32)
    if mask == "half":   # text region = the first half of the tokens
        m[:, S_IMG // 2:] = 0.0
    return {
        "x0": r.standard_normal((B, S_IMG, FLUX_CFG.in_channels)).astype(np.float32),
        "cond_tokens": r.standard_normal((B, S_IMG, cond_feat)).astype(np.float32),
        "token_mask": m,
        "prompt_embeds": r.standard_normal((B, S_TXT, FLUX_CFG.joint_attention_dim)).astype(np.float32),
        "pooled": r.standard_normal((B, FLUX_CFG.pooled_projection_dim)).astype(np.float32),
        "img_ids": np.asarray(prepare_latent_image_ids(8, 8)),
        "txt_ids": np.zeros((S_TXT, 3), np.float32),
        "guidance": np.full((B,), 3.5, np.float32),
    }


@functools.lru_cache(maxsize=None)
def _trees():
    """(flux tree, ControlNet tree): random, nonzero heads."""
    b = _batch()
    z = jnp.zeros((B,))
    flux = random_tree(JFlux(FLUX_CFG), b["x0"], b["prompt_embeds"], b["pooled"], z,
                       b["img_ids"], b["txt_ids"], b["guidance"], seed=1)
    cn = random_tree(JControlNet(CN_CFG), b["x0"], b["cond_tokens"], b["prompt_embeds"],
                     b["pooled"], z, b["img_ids"], b["txt_ids"], b["guidance"], seed=2)
    return flux, cn


def _apply_fns():
    flux, cn = JFlux(FLUX_CFG), JControlNet(CN_CFG)

    def flux_apply(p, x, ctx, pooled, tt, iid, tid, g, br, sr):
        return flux.apply(p, x, ctx, pooled, tt, iid, tid, g,
                          controlnet_block_samples=br, controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, scale):
        return cn.apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, conditioning_scale=scale)

    return flux_apply, cn_apply


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    flux_apply, cn_apply = _apply_fns()

    def loss(cn_params, flux_params, batch, rng, weight):
        return jtrain.controlnet_flow_match_loss(flux_apply, cn_apply, cn_params, flux_params,
                                                 batch, rng, text_loss_weight=weight)

    return jax.jit(jax.value_and_grad(loss))


def _jax_draws(rng, x0):
    """JAX's t and noise for ``rng``, drawn as controlnet_flow_match_loss draws them."""
    rng_t, rng_n = jax.random.split(rng)
    tt = jax.nn.sigmoid(jax.random.normal(rng_t, (x0.shape[0],)))
    return tt, jax.random.normal(rng_n, x0.shape, jnp.float32)


_KINDS = ("kernel", "scale", "bias", "embedding")


def _jax_leaf_kinds(tree):
    """{port parameter name: the Flax leaf kind it was carried from}; the RMS
    norms name their scale ``weight``."""
    codes = {k: i for i, k in enumerate(_KINDS)} | {"weight": _KINDS.index("scale")}
    coded = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), codes[path[-1].key], np.float32), tree)
    names = dict(enumerate(_KINDS))
    return {n: names[int(a.flat[0])] for n, a in flatten_jax_params(coded).items()}


def _port_models(remat=False):
    flux_tree, cn_tree = _trees()
    flux = carried(FluxTransformer2D(port_config(FLUX_CFG), remat=remat),
                   flux_tree).requires_grad_(False)
    cn = carried(RepTextControlNet(port_config(CN_CFG), remat=remat), cn_tree)
    return flux, cn


def _port_loss_and_grads(flux, cn, batch, draws, weight):
    tt, noise = draws
    cn.zero_grad(set_to_none=True)
    loss = ttrain.controlnet_flow_match_loss(
        flux, cn, {k: t(v) for k, v in batch.items()}, t=t(tt), noise=t(noise),
        text_loss_weight=weight)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in cn.named_parameters()}


def test_params_from_transformer_matches_jax():
    flux_tree, cn_tree = _trees()
    want = flatten_jax_params(np_tree(jcontrolnet.params_from_transformer(
        flux_tree, cn_tree, CN_CFG.num_layers, CN_CFG.num_single_layers)))
    flux, cn = _port_models()
    params_from_transformer(flux, cn, CN_CFG.num_layers, CN_CFG.num_single_layers)
    got = {n: p.detach().numpy() for n, p in cn.named_parameters()}
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    # the heads are the ControlNet's own, not copies
    assert np.abs(got["double_blocks.0.proj.weight"]).max() > 0


def test_params_from_transformer_rejects_bad_depths():
    flux, cn = _port_models()
    with pytest.raises(ValueError, match="exceeds base"):
        params_from_transformer(flux, cn, FLUX_CFG.num_layers + 1, 1)
    with pytest.raises(ValueError, match="differs"):
        params_from_transformer(flux, cn, CN_CFG.num_layers, CN_CFG.num_single_layers - 1)


@pytest.mark.parametrize("weight,mask", [(2.0, "half"), (0.0, "half"), (5.0, "ones")])
def test_loss_and_grads_match_jax(weight, mask):
    """The loss at the default text weight, at 0 (the plain mean) and with an
    all-ones mask (where the normalised weighting makes the weight irrelevant),
    and every ControlNet gradient, per leaf, against jax.value_and_grad."""
    flux_tree, cn_tree = _trees()
    batch = _batch(mask)
    rng = jax.random.PRNGKey(4)
    loss_j, grads_j = _jax_value_and_grad()(cn_tree, flux_tree, batch, rng, weight)
    flux, cn = _port_models()
    loss_t, grads_t = _port_loss_and_grads(flux, cn, batch, _jax_draws(rng, batch["x0"]), weight)
    np.testing.assert_allclose(loss_t, float(loss_j), **TOL)
    want = flatten_jax_params(np_tree(grads_j))
    assert flax_leaf_kinds(cn) == _jax_leaf_kinds(cn_tree)
    assert set(grads_t) == set(want)
    for n, g in grads_t.items():
        scale = max(float(np.abs(want[n]).max()), 1e-12)
        assert float(np.abs(g - want[n]).max()) <= 5e-4 * scale, n
    if mask == "ones":
        loss_0, _ = _port_loss_and_grads(flux, cn, batch, _jax_draws(rng, batch["x0"]), 0.0)
        np.testing.assert_allclose(loss_0, loss_t, rtol=1e-6)


def test_warm_start_zero_head_gradient_structure():
    """From a warm start with the ControlNet's zero heads: the heads get
    gradient, the blocks they gate get exactly none, the loss is finite."""
    flux, _ = _port_models()
    cn = random_init_(RepTextControlNet(port_config(CN_CFG)), torch.Generator().manual_seed(0))
    cn, _ = ttrain.init_controlnet_training(flux, cn, CN_CFG.num_layers, CN_CFG.num_single_layers)
    np.testing.assert_array_equal(cn.double_blocks[0].block.to_q.weight.detach().numpy(),
                                  flux.double_blocks[0].block.to_q.weight.detach().numpy())
    batch = _batch()
    loss, grads = _port_loss_and_grads(flux, cn, batch, _jax_draws(jax.random.PRNGKey(2),
                                                                   batch["x0"]), 2.0)
    assert np.isfinite(loss)
    assert np.abs(grads["double_blocks.0.proj.weight"]).max() > 0
    assert np.abs(grads["single_blocks.0.proj.weight"]).max() > 0
    blocks = [g for n, g in grads.items() if ".block." in n]
    assert blocks and all(not g.any() for g in blocks)


def test_remat_gives_the_same_loss_and_gradients():
    batch = _batch()
    draws = _jax_draws(jax.random.PRNGKey(6), batch["x0"])
    loss_a, grads_a = _port_loss_and_grads(*_port_models(remat=False), batch, draws, 2.0)
    loss_b, grads_b = _port_loss_and_grads(*_port_models(remat=True), batch, draws, 2.0)
    assert loss_a == pytest.approx(loss_b, rel=1e-6)
    for n in grads_a:
        np.testing.assert_allclose(grads_b[n], grads_a[n], rtol=1e-5, atol=1e-7, err_msg=n)


def test_train_step_freezes_the_base_and_reduces_the_loss():
    """Three Adam steps on one batch and one draw reduce the loss; the base
    gets no gradient and stays bit-identical; a base that requires gradients
    is refused."""
    flux, cn = _port_models()
    base = {n: p.detach().clone() for n, p in flux.named_parameters()}
    opt = torch.optim.Adam(cn.parameters(), lr=1e-3)
    step = ttrain.bind_frozen_base(ttrain.make_controlnet_train_step(cn, opt), flux)
    batch = {k: t(v) for k, v in _batch().items()}
    losses = [step(batch, torch.Generator().manual_seed(3)).item() for _ in range(3)]
    assert losses[-1] < losses[0], losses
    for n, p in flux.named_parameters():
        assert p.grad is None and torch.equal(p, base[n]), n
    flux.x_embedder.weight.requires_grad_(True)
    with pytest.raises(ValueError, match="frozen"):
        step(batch, torch.Generator().manual_seed(3))


@functools.lru_cache(maxsize=None)
def _jax_adamw_update(weight_decay):
    flux_tree, cn_tree = _trees()
    params, opt, state = jtrain.init_controlnet_training(
        flux_tree, cn_tree, CN_CFG.num_layers, CN_CFG.num_single_layers,
        learning_rate=1e-3, weight_decay=weight_decay)
    grads = random_tree(JControlNet(CN_CFG), *_init_args(), seed=9)
    updates, _ = opt.update(grads, state, params)
    return np_tree(params), grads, np_tree(optax.apply_updates(params, updates))


def _init_args():
    b = _batch()
    return (b["x0"], b["cond_tokens"], b["prompt_embeds"], b["pooled"], jnp.zeros((B,)),
            b["img_ids"], b["txt_ids"], b["guidance"])


def test_one_adamw_update_matches_optax():
    """init_controlnet_training(weight_decay=0.1): the port's AdamW step on
    the same gradients as the optax optimizer (decay on kernels only)."""
    start, grads, want = _jax_adamw_update(0.1)
    flux, cn = _port_models()
    cn, opt = ttrain.init_controlnet_training(flux, cn, CN_CFG.num_layers,
                                              CN_CFG.num_single_layers,
                                              learning_rate=1e-3, weight_decay=0.1)
    start, grads, want = (flatten_jax_params(x) for x in (start, np_tree(grads), want))
    for n, p in cn.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), start[n], err_msg=n)
        p.grad = t(grads[n])
    opt.step()
    for n, p in cn.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)


def test_decay_mask_equals_the_jax_mask():
    flux, cn = _port_models()
    _, opt = ttrain.init_controlnet_training(flux, cn, CN_CFG.num_layers,
                                             CN_CFG.num_single_layers, weight_decay=0.1)
    names = {id(p): n for n, p in cn.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    want = {n for n, kind in _jax_leaf_kinds(_trees()[1]).items() if kind == "kernel"}
    assert decayed == want and len(want) < len(names)


def test_zero_weight_decay_means_no_decay():
    """Unlike the JAX package (optax.adamw's default 1e-4 on every leaf),
    weight_decay=0 decays nothing: zero gradients leave every parameter as it was."""
    flux, cn = _port_models()
    cn, opt = ttrain.init_controlnet_training(flux, cn, CN_CFG.num_layers,
                                              CN_CFG.num_single_layers, learning_rate=1e-3)
    assert all(g["weight_decay"] == 0.0 for g in opt.param_groups)
    before = {n: p.detach().clone() for n, p in cn.named_parameters()}
    for p in cn.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for n, p in cn.named_parameters():
        assert torch.equal(p, before[n]), n

