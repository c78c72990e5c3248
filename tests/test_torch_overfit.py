"""The port's trained-weights demo (``reptext_tpu_torch/examples/overfit_e2e.py``),
its gates (``reptext_tpu_torch/benchmarks/trained_gates.py``), the glyph
fidelity metrics (``eval/glyph_fidelity.py``) and ``save_pipeline_params``
against the JAX package's ``examples/overfit_e2e.py``,
``benchmarks/trained_gates.py`` and ``benchmarks/glyph_fidelity.py``, on the
CPU, float32, inputs and noise made with numpy and handed to both sides.

Tolerances: TOL (5e-4) for losses, activations and latents; gradients
within 5e-4 of each leaf's max|JAX grad| (fp32 through the VAE or the blocks,
sums in another order); the optimizer within 1e-6 (the same fp32 Adam
arithmetic); parameters after two train_flow updates: 99.99 % of all
elements within 2e-5 and every element within twice the two updates'
learning rate (Adam's first update is lr * g / |g|: where a gradient is
rounding noise, its sign, and so the update, is a coin toss on both sides;
one element in 10^5 was such at the tests' geometry); word lists, fixture
arrays and edge metrics exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples import overfit_e2e as jdemo
from benchmarks import glyph_fidelity as jfid
from reptext_tpu.configs import PipelineConfig as JPipelineConfig, VAEConfig as JVAEConfig
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu_torch.benchmarks import trained_gates
from reptext_tpu_torch.eval import glyph_fidelity as tfid
from reptext_tpu_torch.examples import overfit_e2e as tdemo
from reptext_tpu_torch.io.checkpoint import (
    LAYOUT_VERSION, checkpoint_layout_version, load_pipeline_params, save_pipeline_params,
)
from reptext_tpu_torch.io.from_jax import flatten_jax_params
from reptext_tpu_torch.nn.vae import AutoencoderKL
from reptext_tpu_torch.pipelines import FluxRepTextPipeline
from reptext_tpu_torch.sampling import train_controlnet as ttrain

from test_torch_pipeline import CFGS, _shared_params
from test_torch_train import _apply_fns, _batch, _jax_draws, _port_models, _trees
from torch_port_util import TOL, carried, np_tree, port_config, port_configs_of, random_tree, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run tiny models as thousands of small
    ops, which the test tier's workers, sharing the host's cores, slow by two
    orders of magnitude with a pool of threads each; the thread count is put
    back after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _has_font():
    try:
        from reptext_tpu_torch.conditioning import default_font_path

        default_font_path()
        return True
    except (ImportError, FileNotFoundError):
        return False


def _need_font():
    if not _has_font():
        pytest.skip("needs Pillow and the DejaVu font to render")


# ------------------------------------------------------------------ words


@pytest.mark.parametrize("n,seed", [(40, 5), (96, 5), (12, 9)])
def test_synth_corpus_matches_jax(n, seed):
    assert tdemo.synth_corpus(n, seed) == jdemo.synth_corpus(n, seed)


def test_word_lists_and_configs_match_jax():
    assert (tdemo.WORDS, tdemo.TRAIN_WORDS, tdemo.HOLDOUT_WORDS, tdemo.PROMPT) == (
        jdemo.WORDS, jdemo.TRAIN_WORDS, jdemo.HOLDOUT_WORDS, jdemo.PROMPT)
    for port, ref in ((tdemo.demo_flux_cfg(), jdemo.demo_flux_cfg()),
                      (tdemo.demo_cn_cfg(), jdemo.demo_cn_cfg()),
                      (tdemo.demo_vae_cfg(), jdemo.demo_vae_cfg())):
        assert port == port_config(ref)
    assert tdemo.demo_flux_cfg().attention_head_dim == 64


# ---------------------------------------------------------------- the data


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["target"], w["target"])
        np.testing.assert_array_equal(g["conds"].glyph_canvas, w["conds"].glyph_canvas)
        gl, wl = g["conds"].lines[0], w["conds"].lines[0]
        assert tuple(gl.bbox) == tuple(wl.bbox)
        for key in tdemo.LINE_ARRAYS:
            np.testing.assert_array_equal(getattr(gl, key), getattr(wl, key), err_msg=key)


def test_the_port_renders_the_jax_demo_set():
    _need_font()
    _assert_samples_equal(tdemo.render_overfit_set(128, tdemo.WORDS[:4], 7),
                          jdemo.build_overfit_set(128, words=tdemo.WORDS[:4], seed=7))


@pytest.mark.parametrize("which", ["train", "holdout", "corpus_holdout", "corpus_train"])
def test_the_fixture_is_what_the_port_renders(which):
    """The committed fixture against this host's renders: every set the demo
    draws where no font is (the card's machine)."""
    _need_font()
    from record_conditions_fixture import overfit_sets

    words, seed = overfit_sets()[which]
    got = tdemo.fixture_overfit_set(128, words, seed)
    _assert_samples_equal(got, tdemo.render_overfit_set(128, words, seed))
    # a prefix of a set is the set of the prefix (WORDS, smaller corpora)
    _assert_samples_equal(tdemo.fixture_overfit_set(128, words[:3], seed), got[:3])


def test_the_fixture_refuses_a_set_it_does_not_hold():
    with pytest.raises(FileNotFoundError, match="no set"):
        tdemo.fixture_overfit_set(128, ["ZZZ"], 7)


# ------------------------------------------------------- VAE loss, optimizer


def test_vae_loss_and_gradients_match_the_jax_formula():
    """examples/overfit_e2e.py:168-177 (mse + 1e-6 kl on a posterior sample)
    on the same parameters, images and noise, and its gradient."""
    cfg = JVAEConfig().tiny()
    r = np.random.default_rng(0)
    imgs = r.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    noise = r.standard_normal((2, 8, 8, cfg.latent_channels)).astype(np.float32)
    vae = JVAE(cfg)
    tree = random_tree(vae, jnp.asarray(imgs[:1]), seed=3)

    def loss_fn(p):
        mean, logvar = vae.apply(p, imgs, method="encode_moments")
        z = mean + jnp.exp(0.5 * logvar) * noise
        rec = vae.apply(p, z, method="decode")
        mse = jnp.mean((rec - imgs) ** 2)
        kl = -0.5 * jnp.mean(1 + logvar - mean ** 2 - jnp.exp(logvar))
        return mse + 1e-6 * kl, mse

    (loss_j, mse_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    tvae = carried(AutoencoderKL(port_config(cfg)), tree)
    loss_t, mse_t = tdemo.vae_loss(tvae, t(imgs).permute(0, 3, 1, 2),
                                   t(noise).permute(0, 3, 1, 2))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(mse_t.item(), float(mse_j), **TOL)
    want = flatten_jax_params(np_tree(grads_j))
    # the attention's key bias gets no gradient in exact arithmetic (a shift
    # of every logit of a row): both sides hold rounding noise there, held by
    # a floor of 1e-7 of the largest gradient
    floor = 1e-7 * max(np.abs(np.asarray(g)).max() for g in want.values())
    for name, p in tvae.named_parameters():
        ref = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 5e-4 * np.abs(ref).max() + floor, name


@pytest.mark.parametrize("alpha", [0.1, 0.05])
def test_adam_cosine_matches_optax_over_three_updates(alpha):
    """adam_cosine against optax.adam(optax.cosine_decay_schedule(lr, steps,
    alpha)) on the same gradients: the schedule at the update's count from 0."""
    r = np.random.default_rng(1)
    p0 = r.standard_normal(64).astype(np.float32)
    grads = [r.standard_normal(64).astype(np.float32) for _ in range(3)]
    lr, steps = 2e-3, 3
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=alpha))
    pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(t(p0))
    opt, sched = tdemo.adam_cosine([pt], lr, steps, alpha)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state)
        pj = optax.apply_updates(pj, upd)
        pt.grad = t(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0, atol=1e-6)


# ------------------------------------------------------- the training batch

SIZE = 64


def _params():
    """test_torch_pipeline's random trees of the tiny geometry (its VAE's
    posterior made wide again: log-variance -1, so that the noise matters)."""
    params = _shared_params()
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    c_lat = CFGS["vae_cfg"].latent_channels
    conv_out["kernel"][..., c_lat:] = 0.05 * np.random.default_rng(8).standard_normal(
        conv_out["kernel"][..., c_lat:].shape)
    conv_out["bias"][c_lat:] = -1.0
    return params


def _noise_for(shape):
    """The same posterior noise on both sides: drawn from the shape (NHWC),
    so that the JAX encode's jit cache, which keeps one draw per shape, and
    the port's calls agree."""
    seed = int(np.prod(shape)) + 7 * len(shape)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pipelines(monkeypatch):
    """A tiny JAX pipeline at SIZE^2 and the port's on its weights, both
    drawing the posterior noise of :func:`_noise_for`, the JAX CLI's ids
    replaced by the port's (its fallback hashes with Python's salted hash)."""
    import reptext_tpu.cli as jcli

    pipe_cfg = JPipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                               controlnet_conditioning_step=2)
    params = _params()
    jpipe = JPipeline.create(pipe_cfg=pipe_cfg, params=params, **CFGS)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(pipe_cfg), params=params,
                                       device="cpu", **port_configs_of(CFGS))
    ids = tdemo.prompt_ids(tpipe)
    monkeypatch.setattr(jcli, "_tokenize", lambda *a, **k: tuple(jnp.asarray(x) for x in ids))
    real_normal = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4:
            return jnp.asarray(_noise_for(tuple(shape)), dtype)
        return real_normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)

    def encode(self, images, generator=None):
        mean, logvar = self.encode_moments(images)
        nhwc = (mean.shape[0], mean.shape[2], mean.shape[3], mean.shape[1])
        return mean + torch.exp(0.5 * logvar) * t(_noise_for(nhwc)).permute(0, 3, 1, 2)

    monkeypatch.setattr(AutoencoderKL, "encode", encode)
    return jpipe, tpipe


def test_precompute_batch_matches_jax(monkeypatch):
    """Every array of the training batch (latents, condition tokens, masks,
    OCR fields, embeddings, ids) against the JAX function's, the same
    posterior noise and prompt ids given to both."""
    _need_font()
    jpipe, tpipe = _pipelines(monkeypatch)
    words = tdemo.WORDS[:2]
    want = jdemo.precompute_batch(jpipe, jdemo.build_overfit_set(SIZE, words=words))
    got = tdemo.precompute_batch(tpipe, tdemo.build_overfit_set(SIZE, words=words))
    assert got["t5_ids"].shape == (1, 5) and got["clip_ids"].shape == (1, 16)
    for key in ("x0", "cond_tokens", "token_mask", "prompt_embeds", "pooled", "img_ids",
                "txt_ids", "guidance", "ocr_boxes", "ocr_paddings"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    np.testing.assert_array_equal(got["ocr_labels"].numpy(), np.asarray(want["ocr_labels"]))


LR = 2e-3


def test_two_train_flow_updates_match_the_jax_step(monkeypatch):
    """train_flow at the tests' tiny geometry: two joint Adam updates (the
    cosine schedule over 2 steps, alpha 0.05) with JAX's own t and noise of
    each step, against the JAX train_flow: the losses and every parameter."""
    flux_tree, cn_tree = _trees()
    batch = _batch()
    flux_apply, cn_apply = _apply_fns()
    from reptext_tpu.models.controlnet import RepTextControlNet as JCN
    from reptext_tpu.models.flux import FluxTransformer2D as JFlux
    from test_torch_train import CN_CFG, FLUX_CFG

    jpipe = type("P", (), {"flux": JFlux(FLUX_CFG), "controlnet": JCN(CN_CFG),
                           "params": {"flux": flux_tree, "controlnet": cn_tree}})()
    new = jdemo.train_flow(jpipe, {**batch, "clip_ids": None, "t5_ids": None}, 2, lr=LR, seed=1)
    rng, draws = jax.random.PRNGKey(1), []
    for _ in range(2):
        rng, r = jax.random.split(rng)
        draws.append(_jax_draws(r, batch["x0"]))

    real = ttrain.controlnet_flow_match_loss

    def with_jax_draws(*a, **kw):
        tt, noise = draws.pop(0)
        return real(*a, **dict(kw, t=t(tt), noise=t(noise)))

    monkeypatch.setattr(ttrain, "controlnet_flow_match_loss", with_jax_draws)
    flux, cn = _port_models()
    tpipe = type("P", (), {"flux": flux, "controlnet": cn, "device": torch.device("cpu")})()
    losses = tdemo.train_flow(tpipe, {k: t(v) for k, v in batch.items()}, 2, lr=LR, seed=1)
    assert len(losses) == 2 and not draws
    errs = []
    for module, key in ((flux, "flux"), (cn, "controlnet")):
        assert not any(p.requires_grad for p in module.parameters())
        want = flatten_jax_params(np_tree(new[key]))
        for n, p in module.named_parameters():
            errs.append(np.abs(p.detach().numpy() - want[n]).ravel())
            assert errs[-1].max() <= 2 * 2 * LR, n
    errs = np.concatenate(errs)
    assert (errs <= 2e-5).mean() >= 0.9999, (errs > 2e-5).sum()


# ------------------------------------------------------- glyph fidelity


def test_glyph_fidelity_matches_jax():
    """edge_iou, edge_f1, ink_correlation and score_region on a rendered line,
    its own glyph, a noise region and a flat one: equal to the JAX harness."""
    _need_font()
    samples = tdemo.render_overfit_set(128, ["CAFE", "مرحبا"], 7)
    r = np.random.default_rng(0)
    for s in samples:
        lc = s["conds"].lines[0]
        x0, y0, x1, y1 = lc.bbox
        shape = (y1 - y0, x1 - x0, 3)
        for region in (s["target"][y0:y1, x0:x1], lc.glyph_image[y0:y1, x0:x1],
                       r.integers(0, 256, shape, dtype=np.uint8), np.zeros(shape, np.uint8)):
            assert tfid.score_region(region, lc) == jfid.score_region(region, lc)
            edges = 255 - lc.canny_image[y0:y1, x0:x1, 0]
            assert tfid.edge_iou(region, edges, 1) == jfid.edge_iou(region, edges, 1)
            assert tfid.edge_f1(region, edges, 3) == jfid.edge_f1(region, edges, 3)
            glyph = lc.glyph_image[y0:y1, x0:x1].mean(axis=-1)
            assert tfid.ink_correlation(region, glyph) == jfid.ink_correlation(region, glyph)


# ------------------------------------------------ checkpoints, end to end


def test_save_pipeline_params_round_trip(tmp_path):
    """Modules and state dicts saved, loaded back bit for bit in fp32, with
    the layout version, and taken over by a pipeline's modules."""
    pipe = tdemo.build_pipeline(64, 2, "cpu")
    save_pipeline_params({"vae": pipe.vae, "flux": pipe.flux.state_dict(),
                          "controlnet": pipe.controlnet}, str(tmp_path))
    assert checkpoint_layout_version(str(tmp_path)) == LAYOUT_VERSION
    saved = load_pipeline_params(str(tmp_path))
    assert set(saved) == {"vae", "flux", "controlnet"}
    for name in saved:
        state = getattr(pipe, name).state_dict()
        assert set(saved[name]) == set(state)
        for k, v in state.items():
            assert saved[name][k].dtype == torch.float32 and torch.equal(saved[name][k], v), k
    other = tdemo.build_pipeline(64, 2, "cpu")
    torch.manual_seed(0)
    for p in other.flux.parameters():
        p.data.normal_()
    other.flux.load_state_dict(saved["flux"])
    assert all(torch.equal(a, b) for a, b in zip(other.flux.state_dict().values(),
                                                 pipe.flux.state_dict().values()))


def _keys(path):
    with open(path) as f:
        return set(json.load(f))


def test_main_on_the_cpu_then_the_gates_on_its_cache(tmp_path):
    """The demo's main at 2 VAE, 2 flow and 1 sample step, 64^2, writing a
    JSON with the JAX file's keys (and the device's), then trained_gates on
    its --params-cache with --allow-low-accuracy; the second main reuses the
    cache."""
    out, cache = str(tmp_path / "overfit.json"), str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--steps-vae", "2", "--steps-flux", "2", "--steps-sample", "1",
            "--size", "64", "--output", out, "--params-cache", cache]
    assert tdemo.main(argv) == 0
    got = _keys(out)
    want = _keys(os.path.join(ROOT, "benchmarks", "overfit_e2e.json")) - {
        "char_accuracy_holdout", "mean_edge_iou_holdout", "holdout_words"}
    assert want | {"device", "power_limit"} <= got
    first = json.load(open(out))
    assert first["device"] == "cpu" and first["words"] == tdemo.WORDS
    assert os.path.isfile(os.path.join(cache, "flux.safetensors"))
    assert tdemo.main(argv) == 0    # reuses the cache, keeps the PSNR
    assert json.load(open(out))["vae_recon_psnr_db"] == first["vae_recon_psnr_db"]
    gates = str(tmp_path / "gates.json")
    assert trained_gates.main(["--device", "cpu", "--params-cache", cache, "--size", "64",
                               "--steps-sample", "1", "--allow-low-accuracy",
                               "--output", gates]) == 0
    assert _keys(os.path.join(ROOT, "benchmarks", "trained_gates.json")) | {
        "device", "sample_ms_per_step", "attention_launches_per_image"} <= _keys(gates)


def test_the_gates_refuse_a_low_base_accuracy(tmp_path, monkeypatch):
    """Without --allow-low-accuracy a base accuracy under 0.9 fails the run
    (the samples stubbed: the gate's logic, not the sampler, is under test)."""
    cache = str(tmp_path / "ckpt")
    pipe = tdemo.build_pipeline(64, 1, "cpu")
    save_pipeline_params({"vae": pipe.vae, "flux": pipe.flux, "controlnet": pipe.controlnet},
                         cache)
    res = {"char_accuracy": 0.85, "mean_edge_iou": 0.5, "images": [],
           "sample_ms_per_step": 1.0, "attention_launches": 0}
    real = tdemo.build_overfit_set
    monkeypatch.setattr(tdemo, "build_overfit_set", lambda *a, **k: real(64, words=tdemo.WORDS[:1]))
    monkeypatch.setattr(tdemo, "sample_and_score", lambda *a, **k: dict(res))
    argv = ["--device", "cpu", "--params-cache", cache, "--size", "64", "--steps-sample", "1",
            "--output", str(tmp_path / "g.json")]
    with pytest.raises(AssertionError, match="base_accuracy_acceptable"):
        trained_gates.main(argv)
    assert json.load(open(tmp_path / "g.json"))["vc_fixed_acceptable"] is True
    res["char_accuracy"] = 0.9
    assert trained_gates.main(argv) == 0
