"""Velocity cache (training-free step skipping) of the port's two samplers.

Twins of ``tests/test_velocity_cache.py``, each run through the txt2img and
the inpaint sampler: with stub models, the sampler must match a plain Python
Euler loop that recomputes the velocity only on schedule steps (warmup, every
k-th, the last; in the adaptive modes while the latents' relative drift
reaches the threshold, at most ``max_skip`` skips) and reuses or linearly
extrapolates the last computed velocities otherwise. The inpaint loop runs
true CFG over [negative; positive] and zeroes the velocity of step 0 after
the cache. Two anchors hold the port's samplers against the JAX samplers
with the same stubs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import PipelineConfig
from reptext_tpu.sampling.sampler import make_txt2img_sampler as j_txt2img_sampler
from reptext_tpu.sampling.sampler_inpaint import make_inpaint_sampler as j_inpaint_sampler
from reptext_tpu_torch.sampling.flow_match import build_schedule
from reptext_tpu_torch.sampling.sampler import make_txt2img_sampler
from reptext_tpu_torch.sampling.sampler_inpaint import make_inpaint_sampler

from torch_port_util import port_config

B, S, C, S_TXT, INNER = 1, 16, 8, 4, 8
L_CN, LS_CN = 2, 3          # RepText stub depths
L_INP, LS_INP = 1, 2        # inpaint stub depths
TRUE_SCALE = 2.5
KINDS = ["txt2img", "inpaint"]


def _stub_flux(x, ctx, pooled, t, img_ids, txt_ids, guidance,
               controlnet_block_samples=None, controlnet_single_block_samples=None, xp=torch):
    """Deterministic, state-dependent velocity; reads the residual stacks (a
    tensor or a tuple of them) and the prompt embeds, so the gate and CFG show."""
    out = -0.3 * x + 0.1 * xp.sin(t)[:, None, None] + 0.05 * ctx.mean(axis=(1, 2))[:, None, None]
    for stacks in (controlnet_block_samples, controlnet_single_block_samples):
        stacks = () if stacks is None else stacks if isinstance(stacks, tuple) else (stacks,)
        for stack in stacks:
            out = out + 0.01 * stack.sum(axis=0)[..., :C]
    return out


def _stub_cn(layers, hidden, cond, ctx, pooled, t, img_ids, txt_ids, guidance, scale,
             xp=torch):
    nb = hidden.shape[0]
    base = cond.mean() + hidden.mean()
    return (xp.ones((layers[0], nb, S, INNER)) * base * scale,
            xp.ones((layers[1], nb, S, INNER)) * base * 0.5 * scale)


def _cfg(num_steps, interval, warmup=2, gate=10**9, mode="reuse", threshold=0.05, max_skip=3):
    return PipelineConfig(
        height=32, width=32, num_inference_steps=num_steps,
        controlnet_conditioning_step=min(gate, num_steps), true_guidance_scale=TRUE_SCALE,
        velocity_cache_interval=interval, velocity_cache_warmup=warmup,
        velocity_cache_mode=mode, velocity_cache_threshold=threshold,
        velocity_cache_max_skip=max_skip)


def _args():
    r = np.random.default_rng(0)
    return dict(
        latents=r.standard_normal((B, S, C)).astype(np.float32),
        cond_tokens=r.standard_normal((1, S, 12)).astype(np.float32),
        token_masks=np.ones((1, S, 1), np.float32),
        inpaint_cond=r.standard_normal((B, S, 12)).astype(np.float32),
        ctx=r.standard_normal((2 * B, S_TXT, 6)).astype(np.float32),   # [neg; pos]
        pooled=r.standard_normal((2 * B, 5)).astype(np.float32),
        txt_ids=np.zeros((S_TXT, 3), np.float32), img_ids=np.zeros((S, 3), np.float32))


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _run(kind, cfg):
    """The port's sampler of ``kind`` over the stub models; (latents, flux calls)."""
    cfg = port_config(cfg)
    a = {k: torch.from_numpy(v) for k, v in _args().items()}
    schedule = build_schedule(cfg.num_inference_steps, cfg.image_seq_len)
    flux = _Counted(_stub_flux)
    rt = lambda *x: _stub_cn((L_CN, LS_CN), *x)           # noqa: E731
    if kind == "txt2img":
        sample = make_txt2img_sampler(flux, rt, schedule, cfg)
        out = sample(a["latents"], a["cond_tokens"], a["token_masks"], a["ctx"][B:],
                     a["pooled"][B:], a["txt_ids"], a["img_ids"], None)
    else:
        inp = lambda *x: _stub_cn((L_INP, LS_INP), *x)    # noqa: E731
        sample = make_inpaint_sampler(flux, rt, inp, schedule, cfg)
        out = sample(a["latents"], a["cond_tokens"], a["token_masks"], a["inpaint_cond"],
                     a["ctx"], a["pooled"], a["txt_ids"], a["img_ids"], None)
    return out.numpy(), flux.calls


def _reference_loop(kind, cfg):
    """Plain Python Euler loop with explicit velocity caching."""
    a = {k: torch.from_numpy(v).double() for k, v in _args().items()}
    schedule = build_schedule(cfg.num_inference_steps, cfg.image_seq_len)
    sig = schedule.sigmas.astype(np.float64)
    num_steps = schedule.num_steps
    linear = cfg.velocity_cache_mode in ("linear", "adaptive-linear")
    adaptive = cfg.velocity_cache_mode in ("adaptive", "adaptive-linear")
    warmup, interval = cfg.velocity_cache_warmup, cfg.velocity_cache_interval
    lat = a["latents"]
    computed, lat_ref, skips = [], torch.zeros_like(lat), 0

    def model(i, x):
        t = torch.full((B,), float(schedule.timesteps[i]) / 1000.0, dtype=torch.float64)
        gate = i < cfg.controlnet_conditioning_step
        if kind == "txt2img":
            res = _stub_cn((L_CN, LS_CN), x, a["cond_tokens"], None, None, t, None, None, None,
                           1.0) if gate else (None, None)
            return _stub_flux(x, a["ctx"][B:], None, t, None, None, None, *res)
        x2, t2 = torch.cat([x, x]), torch.cat([t, t])
        blocks, singles = (), ()
        if gate:
            b, s = _stub_cn((L_CN, LS_CN), x2, a["cond_tokens"], None, None, t2, None, None,
                            None, 1.0)
            blocks, singles = (b,), (s,)
        b, s = _stub_cn((L_INP, LS_INP), x2, a["inpaint_cond"], None, None, t2, None, None,
                        None, 1.0)
        v2 = _stub_flux(x2, a["ctx"], None, t2, None, None, None, blocks + (b,), singles + (s,))
        return v2[:B] + TRUE_SCALE * (v2[B:] - v2[:B])

    for i in range(num_steps):
        first = i == 0 if kind == "txt2img" else False
        if adaptive:
            drift = (lat - lat_ref).abs().mean(dim=(1, 2))
            rel = float((drift / (lat_ref.abs().mean(dim=(1, 2)) + 1e-8)).max())
            run = (i < warmup or i >= num_steps - 1 or first
                   or rel >= cfg.velocity_cache_threshold
                   or skips >= cfg.velocity_cache_max_skip)
        else:
            run = (interval == 1 or i < warmup or (i - warmup) % interval == 0
                   or i >= num_steps - 1 or first)
        if run:
            lat_ref, skips = lat, 0
            v = model(i, lat)
            computed.append((sig[i], v))
        else:
            skips += 1
            if linear and len(computed) >= 2:
                (s1, v1), (s2, v2) = computed[-1], computed[-2]
                v = v1 + (v1 - v2) * ((sig[i] - s1) / (s1 - s2))
            else:
                v = computed[-1][1]
        if kind == "inpaint" and i == 0:
            v = torch.zeros_like(v)
        lat = lat + (sig[i + 1] - sig[i]) * v
    return lat.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("interval,warmup,mode", [
    (1, 2, "reuse"), (2, 2, "reuse"), (3, 1, "reuse"), (2, 2, "linear"), (3, 1, "linear"),
])
def test_sampler_matches_reference_loop(kind, interval, warmup, mode):
    cfg = _cfg(8, interval, warmup, gate=5, mode=mode)
    got, _ = _run(kind, cfg)
    np.testing.assert_allclose(got, _reference_loop(kind, cfg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode,threshold,max_skip", [
    ("adaptive", 0.05, 3),
    ("adaptive", 1e9, 2),          # drift never triggers: pure max-skip cadence
    ("adaptive-linear", 0.05, 3),
    ("adaptive-linear", 0.02, 4),
])
def test_adaptive_matches_reference_loop(kind, mode, threshold, max_skip):
    cfg = _cfg(10, 1, warmup=2, mode=mode, threshold=threshold, max_skip=max_skip)
    got, _ = _run(kind, cfg)
    np.testing.assert_allclose(got, _reference_loop(kind, cfg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_adaptive_zero_threshold_is_uncached(kind):
    """threshold 0: the drift trigger always fires, bit-identical to uncached."""
    a, calls_a = _run(kind, _cfg(10, 1))
    b, calls_b = _run(kind, _cfg(10, 1, mode="adaptive", threshold=0.0))
    np.testing.assert_array_equal(a, b)
    assert calls_a == calls_b == 10


@pytest.mark.parametrize("kind", KINDS)
def test_adaptive_skips_and_stays_close(kind):
    """A high threshold skips (the result differs) while max_skip bounds the drift."""
    a, _ = _run(kind, _cfg(12, 1, warmup=4))
    b, calls = _run(kind, _cfg(12, 1, warmup=4, mode="adaptive", threshold=1e9, max_skip=2))
    diff = np.abs(a - b).max()
    assert 0 < diff < 0.2 * np.abs(a).max()
    assert calls < 12


@pytest.mark.parametrize("kind", KINDS)
def test_cache_changes_result_but_stays_close(kind):
    a, _ = _run(kind, _cfg(12, 1, warmup=4))
    b, _ = _run(kind, _cfg(12, 2, warmup=4))
    diff = np.abs(a - b).max()
    assert 0 < diff < 0.2 * np.abs(a).max()


@pytest.mark.parametrize("kind", KINDS)
def test_model_runs_on_schedule_steps_only(kind):
    """The registers start empty, so step 0 always runs the model; then the
    schedule: warmup 1, interval 4 over 8 steps runs steps 0, 1, 5 and 7."""
    _, calls = _run(kind, _cfg(8, 4, warmup=1))
    assert calls == 4
    out, calls = _run(kind, _cfg(8, 1))
    assert calls == 8 and np.isfinite(out).all()


@pytest.mark.parametrize("kind", KINDS)
def test_matches_the_jax_sampler(kind):
    """Anchor: the port's sampler == the JAX sampler over the same stubs."""
    cfg = _cfg(8, 2, warmup=2, gate=5, mode="adaptive-linear", threshold=0.02, max_skip=2)
    a = _args()
    schedule = build_schedule(8, cfg.image_seq_len)
    from reptext_tpu.sampling.flow_match import build_schedule as j_build_schedule

    jsched = j_build_schedule(8, cfg.image_seq_len)
    np.testing.assert_array_equal(np.asarray(jsched.sigmas, np.float32), schedule.sigmas)

    def jflux(p, x, ctx, pooled, t, iid, tid, g, br, sr):
        return _stub_flux(x, ctx, pooled, t, iid, tid, g, br, sr, xp=jnp)

    def jcn(layers):
        return lambda p, *x: _stub_cn(layers, *x, xp=jnp)

    j = {k: jnp.asarray(v) for k, v in a.items()}
    if kind == "txt2img":
        want = jax.jit(j_txt2img_sampler(jflux, jcn((L_CN, LS_CN)), jsched, cfg))(
            None, None, j["latents"], j["cond_tokens"], j["token_masks"], j["ctx"][B:],
            j["pooled"][B:], j["txt_ids"], j["img_ids"], None)
    else:
        sample = j_inpaint_sampler(jflux, jcn((L_CN, LS_CN)), jcn((L_INP, LS_INP)), jsched, cfg,
                                   4, 4)
        want = jax.jit(sample)(None, None, None, j["latents"], j["cond_tokens"],
                               j["token_masks"], j["inpaint_cond"], j["ctx"], j["pooled"],
                               j["txt_ids"], j["img_ids"], None)
    got, _ = _run(kind, cfg)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
