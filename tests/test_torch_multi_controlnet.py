"""``models/multi_controlnet.py`` in the port against the JAX package's, on the CPU.

Nets of different depths (the RepText ControlNet 1 + 1 at tiny geometry, a
deeper 2 + 3 net with 4 extra condition channels, a union net), each carried
from one random Flax tree into both sides, composed by ``MultiControlNet``:
the summed residuals spread to the base depth, per-net token masks and
conditioning scales, per-net guidance windows (inside and outside), and a
union entry with its mode. Tolerance TOL (5e-4); the gates and masks are exact
0/1 multiplies, so a gated-off or masked-out net adds exactly 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import ControlNetConfig, FluxConfig
from reptext_tpu.models import ControlNetEntry as JEntry
from reptext_tpu.models import MultiControlNet as JMulti
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import _spread_residuals
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.multi_controlnet import (
    ControlNetEntry, MultiControlNet, spread_residuals,
)

from torch_port_util import TOL, carried, port_config, random_tree, t

FLUX_CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()
DEEP_CFG = dataclasses.replace(CN_CFG, num_layers=2, num_single_layers=3,
                               extra_condition_channels=4)
UNION_CFG = dataclasses.replace(CN_CFG, num_mode=10)
B, S_TXT, S_IMG = 2, 3, 16


def _feat(cfg):
    return cfg.in_channels + cfg.extra_condition_channels


def _net(cfg, seed):
    z = jnp.zeros
    kw = {"mode": jnp.zeros((1,), jnp.int32)} if cfg.union else {}
    tree = random_tree(JControlNet(cfg), z((1, S_IMG, cfg.in_channels)),
                       z((1, S_IMG, _feat(cfg))), z((1, S_TXT, cfg.joint_attention_dim)),
                       z((1, cfg.pooled_projection_dim)), z((1,)), z((S_IMG, 3)),
                       z((S_TXT, 3)), jnp.ones((1,)), seed=seed, **kw)
    return JControlNet(cfg), tree, carried(RepTextControlNet(port_config(cfg)), tree)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    ids = np.stack([np.zeros(S_IMG), np.arange(S_IMG) // 4, np.arange(S_IMG) % 4], -1)
    return dict(
        hidden_states=r.standard_normal((B, S_IMG, CN_CFG.in_channels)).astype(np.float32),
        encoder_hidden_states=r.standard_normal(
            (B, S_TXT, CN_CFG.joint_attention_dim)).astype(np.float32),
        pooled_projections=r.standard_normal((B, CN_CFG.pooled_projection_dim)).astype(np.float32),
        timestep=np.full((B,), 0.5, np.float32),
        img_ids=ids.astype(np.float32),
        txt_ids=np.zeros((S_TXT, 3), np.float32),
        guidance=np.full((B,), 3.5, np.float32),
    )


def _conds(cfgs, seed=1):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S_IMG, _feat(c))).astype(np.float32) for c in cfgs]


def _run(entries, nets, conds, inp, **kw):
    """(JAX block, single), (port block, single) for the same composite."""
    jmulti = JMulti([JEntry(j, **e) for (j, _, _), e in zip(nets, entries)],
                    FLUX_CFG.num_layers, FLUX_CFG.num_single_layers)
    tmulti = MultiControlNet([ControlNetEntry(m, **e) for (_, _, m), e in zip(nets, entries)],
                             FLUX_CFG.num_layers, FLUX_CFG.num_single_layers)
    jkw = {k: ([None if x is None else jnp.asarray(x) for x in v] if isinstance(v, list)
               else (jnp.asarray(v) if k == "step_index" else v)) for k, v in kw.items()}
    tkw = {k: ([None if x is None else torch.as_tensor(x) for x in v] if isinstance(v, list)
               else v) for k, v in kw.items()}
    jout = jmulti([tree for _, tree, _ in nets], jnp.asarray(inp["hidden_states"]),
                  [jnp.asarray(c) for c in conds],
                  *(jnp.asarray(inp[k]) for k in list(inp)[1:]), **jkw)
    tout = tmulti(t(inp["hidden_states"]), [t(c) for c in conds],
                  *(t(inp[k]) for k in list(inp)[1:]), **tkw)
    return [np.asarray(x) for x in jout], [x.detach().numpy() for x in tout]


@pytest.fixture(scope="module")
def nets():
    return {"rt": _net(CN_CFG, 2), "deep": _net(DEEP_CFG, 3), "union": _net(UNION_CFG, 4)}


def test_nets_of_different_depths_sum_at_the_base_depth(nets):
    inp = _inputs()
    conds = _conds([CN_CFG, DEEP_CFG])
    (jb, js), (tb, ts) = _run([dict(conditioning_scale=1.0), dict(conditioning_scale=0.5)],
                              [nets["rt"], nets["deep"]], conds, inp)
    assert tb.shape[0] == FLUX_CFG.num_layers and ts.shape[0] == FLUX_CFG.num_single_layers
    np.testing.assert_allclose(tb, jb, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    # the sum is each net's own residuals, spread first
    args = [t(inp[k]) for k in list(inp)[1:]]
    b1, _ = nets["rt"][2](t(inp["hidden_states"]), t(conds[0]), *args, conditioning_scale=1.0)
    b2, _ = nets["deep"][2](t(inp["hidden_states"]), t(conds[1]), *args, conditioning_scale=0.5)
    want = spread_residuals(b1, FLUX_CFG.num_layers) + spread_residuals(b2, FLUX_CFG.num_layers)
    np.testing.assert_array_equal(tb, want.detach().numpy())


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_spread_residuals_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((n, 2, 3)).astype(np.float32)
    for layers in (n, 4, 7):
        if layers >= n:
            np.testing.assert_array_equal(spread_residuals(t(x), layers).numpy(),
                                          np.asarray(_spread_residuals(jnp.asarray(x), layers)))


def test_token_masks_are_per_net(nets):
    inp = _inputs(2)
    conds = _conds([CN_CFG, DEEP_CFG], seed=3)
    mask = np.zeros((S_IMG, 1), np.float32)
    mask[: S_IMG // 2] = 1.0
    (jb, js), (tb, ts) = _run([{}, {}], [nets["rt"], nets["deep"]], conds, inp,
                              token_masks=[mask, None])
    np.testing.assert_allclose(tb, jb, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    (_, _), (ob, _) = _run([{}], [nets["rt"]], conds[:1], inp, token_masks=[np.zeros_like(mask)])
    np.testing.assert_array_equal(ob, 0.0)


@pytest.mark.parametrize("step", [2, 7])
def test_guidance_window_is_a_gate(nets, step):
    inp = _inputs(4)
    conds = _conds([CN_CFG, DEEP_CFG], seed=5)
    entries = [dict(guidance_start=0.0, guidance_end=0.5), {}]
    (jb, js), (tb, ts) = _run(entries, [nets["rt"], nets["deep"]], conds, inp,
                              step_index=step, num_steps=10)
    np.testing.assert_allclose(tb, jb, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    (_, _), (alone, _) = _run([{}], [nets["deep"]], conds[1:], inp)
    if step >= 5:     # outside the first net's window: the second net alone
        np.testing.assert_array_equal(tb, alone)
    else:
        assert not np.array_equal(tb, alone)


def test_union_entry_takes_its_mode(nets):
    inp = _inputs(6)
    conds = _conds([CN_CFG, UNION_CFG], seed=7)
    entries = [dict(conditioning_scale=0.8), dict(uses_mode=True, conditioning_scale=1.2)]
    modes = [None, np.array([1, 6], np.int32)]
    (jb, js), (tb, ts) = _run(entries, [nets["rt"], nets["union"]], conds, inp, modes=modes,
                              token_masks=[np.ones((S_IMG, 1), np.float32), None])
    np.testing.assert_allclose(tb, jb, **TOL)
    np.testing.assert_allclose(ts, js, **TOL)
    with pytest.raises(ValueError, match="requires a `mode`"):
        _run([{}, dict(uses_mode=True)], [nets["rt"], nets["union"]], conds, inp)


def test_an_empty_composite_and_a_count_mismatch_raise(nets):
    with pytest.raises(ValueError, match="at least one"):
        MultiControlNet([], FLUX_CFG.num_layers, FLUX_CFG.num_single_layers)
    multi = MultiControlNet([ControlNetEntry(nets["rt"][2])], FLUX_CFG.num_layers,
                            FLUX_CFG.num_single_layers)
    inp = _inputs()
    with pytest.raises(ValueError, match="count"):
        multi(t(inp["hidden_states"]), [], *(t(inp[k]) for k in list(inp)[1:]))
