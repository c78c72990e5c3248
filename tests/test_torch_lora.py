"""``io/lora.py`` in the port against the JAX package's, on the CPU.

A seeded LoRA in diffusers naming (``io/synthetic.py::lora_state``: rank 4 on
every attention projection of every double and single block of the tiny
FLUX, plus ``proj_out`` and a block's ``norm1.linear`` for the other
patterns) is merged into the same converted FLUX both ways: the JAX
``apply_lora`` on the Flax tree (kernel [in, out]) and the port's on the
module's weights ([out, in]). Checks: fp32 weights within 1e-6 (the same
fp32 delta, summed in another order), bf16 weights within one bf16 ulp of the
larger of the weight and the delta (JAX rounds the delta to bf16 before the
add, the port adds in fp32 and rounds once); the RoPE-permuted q/k leaves against a merge made before the
conversion (fails if the permutation is dropped), and a FLUX forward through
them; the grouping of ``parse_lora_state`` against JAX's; unknown-module and
incomplete-pair errors; the CLI's ``--lora``/``--lora-scale`` (and their
errors) and ``convert_cli --lora`` baking.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from reptext_tpu.io import convert as JC
from reptext_tpu.io import lora as jlora
from reptext_tpu_torch.io import checkpoint as tck
from reptext_tpu_torch.io import convert as TC
from reptext_tpu_torch.io import convert_cli as tcc
from reptext_tpu_torch.io import lora as tlora
from reptext_tpu_torch.io import safetensors as tst
from reptext_tpu_torch.io import synthetic
from reptext_tpu_torch.io.from_jax import flatten_jax_params
from reptext_tpu_torch.models.flux import FluxTransformer2D

from test_torch_checkpoint import FLUX, _args, converted  # noqa: F401  (the fixture)
from torch_port_util import TOL, carried, np_tree, port_config, t

RANK = 4
SCALE = 0.75


def _lora(cfg=FLUX, seed=5, std_b=0.5):
    state = synthetic.lora_state(port_config(cfg), rank=RANK, seed=seed, std_b=std_b)
    d = synthetic._Draw(seed + 1, "cpu", torch.float32)
    inner = cfg.inner_dim
    for module, i, o in (("proj_out", inner, cfg.out_channels),
                         ("transformer_blocks.0.norm1.linear", inner, 6 * inner),
                         ("single_transformer_blocks.0.proj_mlp", inner, 4 * inner)):
        d.normal(f"transformer.{module}.lora_A.weight", (RANK, i), i ** -0.5)
        d.normal(f"transformer.{module}.lora_B.weight", (o, RANK), std_b)
    state.update(d.state)
    return state


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


def _flux_state(cfg=FLUX, seed=0):
    return synthetic.flux_state(port_config(cfg), seed=seed)


def test_parse_groups_as_jax():
    lora = _lora()
    want = jlora.parse_lora_state(_np(lora))
    got = tlora.parse_lora_state(lora)
    assert sorted(got) == sorted(want)
    for path in want:
        assert sorted(got[path]) == sorted(want[path])
        for layer, (a, b) in want[path].items():
            np.testing.assert_array_equal(got[path][layer][0].numpy(), a)
            np.testing.assert_array_equal(got[path][layer][1].numpy(), b)


def test_apply_lora_matches_jax_in_fp32():
    state = _flux_state()
    tree = JC.convert_flux_transformer(_np(state), FLUX)
    lora = _lora()
    want = flatten_jax_params(np_tree(jlora.apply_lora(tree, _np(lora), scale=SCALE,
                                                       head_dim=FLUX.attention_head_dim)))
    model = carried(FluxTransformer2D(port_config(FLUX)), tree)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kept = tlora.apply_lora(model, lora, scale=SCALE, head_dim=FLUX.attention_head_dim,
                            keep_originals=True)
    touched = {tlora.weight_name(path, layer) for path, layers in
               tlora.parse_lora_state(lora).items() for layer in layers}
    assert set(kept) == touched
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-6)
        assert torch.equal(p, before[name]) == (name not in touched), name
    tlora.restore_weights(model, kept)
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_apply_lora_matches_jax_within_one_bf16_ulp():
    state = {k: v.to(torch.bfloat16) for k, v in _flux_state().items()}
    lora = {k: v.to(torch.bfloat16) for k, v in _lora().items()}
    tree = JC.convert_flux_transformer({k: v.float().numpy().astype(ml_dtypes.bfloat16)
                                        for k, v in state.items()}, FLUX)
    jtree = jlora.apply_lora(tree, {k: v.float().numpy().astype(ml_dtypes.bfloat16)
                                    for k, v in lora.items()},
                             scale=SCALE, head_dim=FLUX.attention_head_dim)
    want = flatten_jax_params(jtree)
    flat = tcc.module_state("flux", TC.convert_flux_transformer(state, port_config(FLUX)),
                            port_config(FLUX))
    before = dict(flat)
    tlora.apply_lora(flat, lora, scale=SCALE, head_dim=FLUX.attention_head_dim)
    for name, got in flat.items():
        assert got.dtype == torch.bfloat16
        w = np.asarray(want[name]).astype(np.float32)
        w0 = before[name].float().numpy()
        # a bf16 ulp (2^-7 of the magnitude) of the larger of the weight and the delta
        ulp = 2.0 ** -7 * np.maximum(np.maximum(np.abs(w), np.abs(w0)), np.abs(w - w0))
        assert (np.abs(got.float().numpy() - w) <= ulp).all(), name


def test_rope_permuted_leaves_match_a_merge_before_conversion():
    """Merging into the diffusers weights (W += s B A, interleaved channels)
    and then converting gives the port's merge into the converted weights,
    leaf for leaf, and the same FLUX output. Without the permutation the q/k
    weights of every block differ."""
    state = _flux_state()
    lora = _lora()
    pre = dict(state)
    for key in lora:
        if key.endswith(".lora_A.weight"):
            module = key[len("transformer."):-len(".lora_A.weight")]
            b_up = lora[key.replace("lora_A", "lora_B")]
            pre[f"{module}.weight"] = state[f"{module}.weight"] + SCALE * (b_up @ lora[key])
    cfg = port_config(FLUX)
    want = tcc.module_state("flux", TC.convert_flux_transformer(pre, cfg), cfg)
    got = tcc.module_state("flux", TC.convert_flux_transformer(state, cfg), cfg)
    tlora.apply_lora(got, lora, scale=SCALE, head_dim=FLUX.attention_head_dim)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=1e-5)
    # the leaves that take the permutation: without it they would not match
    q = "double_blocks.0.block.to_q.weight"
    a, b = lora["transformer.transformer_blocks.0.attn.to_q.lora_A.weight"], \
        lora["transformer.transformer_blocks.0.attn.to_q.lora_B.weight"]
    unpermuted = tcc.module_state("flux", TC.convert_flux_transformer(state, cfg), cfg)[q] \
        + SCALE * (b @ a)
    assert (unpermuted - want[q]).abs().max() > 1e-2
    # and the model through them
    r = np.random.default_rng(0)
    x = t(r.standard_normal((1, 16, FLUX.in_channels)))
    ctx = t(r.standard_normal((1, 4, FLUX.joint_attention_dim)))
    pooled = t(r.standard_normal((1, FLUX.pooled_projection_dim)))
    ids = t(np.stack([np.zeros(16), np.arange(16) // 4, np.arange(16) % 4], -1))
    args = (x, ctx, pooled, torch.tensor([0.5]), ids, torch.zeros(4, 3), torch.tensor([3.5]))
    outs = []
    for sd in (want, got):
        m = FluxTransformer2D(cfg)
        m.load_state_dict(sd)
        outs.append(m(*args).detach())
    torch.testing.assert_close(outs[0], outs[1], **TOL)


def test_unknown_modules_and_incomplete_pairs_raise_as_jax():
    lora = _lora()
    bad = dict(lora)
    bad["transformer.transformer_blocks.0.attn.to_gate.lora_A.weight"] = torch.zeros(RANK, 8)
    for fn, arg in ((jlora.parse_lora_state, _np(bad)), (tlora.parse_lora_state, bad)):
        with pytest.raises(KeyError, match="unrecognized LoRA module"):
            fn(arg)
    half = {k: v for k, v in lora.items() if "transformer_blocks.1.attn.to_v.lora_B" not in k}
    for fn, arg in ((jlora.parse_lora_state, _np(half)), (tlora.parse_lora_state, half)):
        with pytest.raises(ValueError, match="incomplete"):
            fn(arg)
    # keys without the prefix or not a LoRA weight are ignored by both
    extra = dict(lora, **{"text_encoder.x.lora_A.weight": torch.zeros(1),
                          "transformer.x_embedder.alpha": torch.zeros(1)})
    assert sorted(tlora.parse_lora_state(extra)) == sorted(jlora.parse_lora_state(_np(extra)))


def _write_lora(path, lora):
    tst.save_file({k: v.contiguous() for k, v in lora.items()}, str(path))
    return str(path)


def test_cli_lora_merges_into_the_checkpoint(converted, tmp_path):  # noqa: F811
    from reptext_tpu_torch import cli

    lora1, lora2 = _lora(seed=5), _lora(seed=9)
    p1, p2 = _write_lora(tmp_path / "a.safetensors", lora1), _write_lora(
        tmp_path / "b.safetensors", lora2)
    pipe = cli.build_pipeline(_args(converted["out"], "--lora", p1, "--lora", p2,
                                    "--lora-scale", "0.5"))
    want = tck.load_pipeline_params(converted["out"], ("flux",))["flux"]
    want = {k: v.clone() for k, v in want.items()}
    tlora.apply_lora(want, lora1, scale=0.5, head_dim=FLUX.attention_head_dim)
    tlora.apply_lora(want, lora2, scale=1.0, head_dim=FLUX.attention_head_dim)
    for name, p in pipe.flux.named_parameters():
        assert torch.equal(p, want[name]), name
    with pytest.raises(SystemExit, match="more --lora-scale"):
        cli.build_pipeline(_args(converted["out"], "--lora", p1, "--lora-scale", "1",
                                 "--lora-scale", "2"))
    args = _args(converted["out"], "--lora", p1)
    args.checkpoint_dir, args.random_weights = None, True
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        cli.build_pipeline(args)


def test_convert_cli_bakes_the_lora(converted, tmp_path):  # noqa: F811
    lora = _lora(seed=11)
    path = _write_lora(tmp_path / "l.safetensors", lora)
    pipe_dir = str(converted["root"] / "pipeline")
    out = tmp_path / "baked"
    assert tcc.main(["--pipeline-dir", pipe_dir, "--lora", path, "--lora-scale", "0.25",
                     "--out", str(out)]) == 0
    got = tst.load_file(tck.component_path(str(out), "flux"))
    want = {k: v.clone() for k, v in
            tck.load_pipeline_params(converted["out"], ("flux",))["flux"].items()}
    tlora.apply_lora(want, lora, scale=0.25, head_dim=FLUX.attention_head_dim)
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    # the JAX converter's errors
    with pytest.raises(SystemExit):
        tcc.main(["--controlnet-dir", str(converted["root"] / "cn"), "--lora", path,
                  "--out", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        tcc.main(["--pipeline-dir", pipe_dir, "--lora", path, "--lora-scale", "1",
                  "--lora-scale", "2", "--out", str(tmp_path / "y")])


def test_a_lora_for_a_module_the_model_lacks_raises():
    lora = _lora(cfg=dataclasses.replace(FLUX, num_layers=3))
    model = FluxTransformer2D(port_config(FLUX))
    with pytest.raises(KeyError, match="no weight"):
        tlora.apply_lora(model, lora, head_dim=FLUX.attention_head_dim)

