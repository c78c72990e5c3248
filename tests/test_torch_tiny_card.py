"""What lets the JAX CLI's ``--tiny`` demo run on the card, and the last
functions of the JAX package that had no counterpart in the port, on the CPU.

- ``cli.compute_dtype``: float32 for ``--tiny`` on ``cuda`` and ``cpu`` (the
  JAX CLI's rule), float32 for a full-geometry ``cpu`` run (the port's
  deviation, which the parity tests rest on), bf16 for a full-geometry card
  run; the tiny CLI builds its pipeline in float32 at head dim 32;
- ``check_head_dim`` of both kernel modules (K1-K4 and K5) takes 32, 64 and
  128 and refuses 48;
- ``io/checkpoint.py::convert_and_cache`` against the JAX function on the
  same synthetic snapshot (its converted trees leaf for leaf; the JAX side's
  orbax write is replaced by a recorder: the two store different formats by
  design), the port's directory read back by ``load_pipeline_params`` and
  ``load_saved_configs``;
- the interleaved RoPE (``rope_cos_sin``, ``apply_rope``,
  ``deinterleave_perm``) against the JAX functions, and the identity that
  lets the port use the half-split form: the interleaved rotation, permuted,
  is the half-split rotation of the permuted input.

Tolerances: the converters move tensors without arithmetic (bit-equal); the
RoPE tables and rotations are float32 transcendental functions computed by
two libraries, within 1e-6 (bf16 inputs: one bf16 ulp, 2^-7 relative).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig
from reptext_tpu.io import checkpoint as jck
from reptext_tpu.ops import rope as jrope
from reptext_tpu_torch import cli
from reptext_tpu_torch.io import checkpoint as tck
from reptext_tpu_torch.io.convert_cli import module_state
from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.ops import ring_attention as ra
from reptext_tpu_torch.ops import rope as trope
from tests import synth_checkpoints as synth

from torch_port_util import port_configs_of

TED = FluxConfig().time_embed_dim   # HF configs do not record it: the default
CFGS = {"flux": dataclasses.replace(FluxConfig().tiny(), time_embed_dim=TED),
        "controlnet": dataclasses.replace(ControlNetConfig().tiny(), time_embed_dim=TED),
        "vae": VAEConfig().tiny(), "clip": CLIPConfig().tiny(), "t5": T5Config().tiny()}


# ------------------------------------------------------- --tiny in float32


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_compute_dtype_follows_the_jax_cli_for_tiny(device, tiny):
    args = cli.build_parser().parse_args(["--device", device] + (["--tiny"] if tiny else []))
    want = torch.bfloat16 if device == "cuda" and not tiny else torch.float32
    assert cli.compute_dtype(args) == want


def test_tiny_cli_builds_float32_at_a_head_dim_the_kernels_take():
    args = cli.build_parser().parse_args(["--random-weights", "--tiny", "--device", "cpu",
                                          "--size", "64"])
    pipe = cli.build_pipeline(args)
    assert pipe.compute_dtype == torch.float32
    for model in (pipe.flux, pipe.controlnet):
        assert next(model.parameters()).dtype == torch.float32
        d = model.config.attention_head_dim
        assert d == 32
        fa.check_head_dim(d)
        fa.check_head_dim(d, ra._SUPPORTED_HEAD_DIMS)


@pytest.mark.parametrize("module", [fa, ra], ids=["flash_attention", "ring_attention"])
@pytest.mark.parametrize("d", [32, 64, 128, 48])
def test_check_head_dim_takes_32_64_128_and_refuses_48(module, d):
    if d == 48:
        with pytest.raises(ValueError, match="head dim 48"):
            fa.check_head_dim(d, module._SUPPORTED_HEAD_DIMS)
    else:
        fa.check_head_dim(d, module._SUPPORTED_HEAD_DIMS)


# ------------------------------------------------------- convert_and_cache


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap")
    synth.write_flux_pipeline_snapshot(str(root), CFGS["flux"], CFGS["vae"], CFGS["clip"],
                                       CFGS["t5"])
    synth.write_controlnet_snapshot(str(root / "cn"), CFGS["controlnet"])
    dirs = {"flux": "transformer", "vae": "vae", "clip": "text_encoder", "t5": "text_encoder_2",
            "controlnet": "cn"}
    return {name: str(root / sub) for name, sub in dirs.items()}


def test_convert_and_cache_matches_the_jax_function(snapshot, tmp_path, monkeypatch):
    from reptext_tpu_torch.io.from_jax import flatten_jax_params

    cached = {}
    monkeypatch.setattr(jck, "save_pipeline_params",
                        lambda params, directory: cached.update(params=params, dir=directory))
    want = jck.convert_and_cache(snapshot, CFGS, str(tmp_path / "jax"))
    assert cached["params"] is want and cached["dir"] == str(tmp_path / "jax")
    cfgs = port_configs_of(CFGS)
    out = str(tmp_path / "port")
    got = tck.convert_and_cache(snapshot, cfgs, out)
    assert sorted(got) == sorted(want) == sorted(snapshot)
    loaded = tck.load_pipeline_params(out)
    assert sorted(loaded) == sorted(snapshot)
    assert tck.load_saved_configs(out) == cfgs
    for name in snapshot:
        g, w = flatten_jax_params(got[name]), flatten_jax_params(want[name])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k], np.float32),
                                          err_msg=f"{name}: {k}")
        # the file is the module state of that tree
        state = module_state(name, got[name], cfgs[name])
        assert sorted(loaded[name]) == sorted(state)
        for k, v in state.items():
            assert torch.equal(loaded[name][k], v), f"{name}: {k}"


def test_convert_and_cache_adds_to_a_directory(snapshot, tmp_path):
    """Components converted by two calls share one directory and configs.json."""
    cfgs = port_configs_of(CFGS)
    out = str(tmp_path / "port")
    tck.convert_and_cache({"vae": snapshot["vae"]}, cfgs, out)
    tck.convert_and_cache({"clip": snapshot["clip"]}, cfgs, out)
    assert sorted(tck.load_pipeline_params(out)) == ["clip", "vae"]
    assert tck.load_saved_configs(out) == {"vae": cfgs["vae"], "clip": cfgs["clip"]}


# ------------------------------------------------------- interleaved RoPE


def _ids(s, seed):
    r = np.random.default_rng(seed)
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1], ids[:, 2] = r.integers(0, 64, s), r.integers(0, 64, s)
    return ids


@pytest.mark.parametrize("axes", [(8, 12, 12), (16, 56, 56)], ids=["d32", "d128"])
def test_interleaved_rope_tables_match_jax(axes):
    ids = _ids(37, seed=sum(axes))
    got = trope.rope_cos_sin(torch.from_numpy(ids), axes)
    want = jrope.rope_cos_sin(jnp.asarray(ids), axes)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (37, sum(axes))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("axes", [(8, 12, 12), (16, 56, 56)], ids=["d32", "d128"])
def test_apply_rope_matches_jax(axes, dtype):
    d, s = sum(axes), 19
    ids = _ids(s, seed=d)
    x = np.random.default_rng(d).standard_normal((2, 3, s, d)).astype(np.float32)
    cos, sin = jrope.rope_cos_sin(jnp.asarray(ids), axes)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jdtype), cos, sin).astype(jnp.float32))
    xt = torch.from_numpy(x).to(dtype)
    got = trope.apply_rope(xt, torch.from_numpy(np.array(cos)),
                           torch.from_numpy(np.array(sin)))
    assert got.dtype == dtype and got.shape == xt.shape
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_deinterleave_perm_matches_jax_and_maps_interleaved_to_half_split(d):
    perm = trope.deinterleave_perm(d)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jrope.deinterleave_perm(d)))
    axes = {32: (8, 12, 12), 64: (8, 28, 28), 128: (16, 56, 56)}[d]
    ids = torch.from_numpy(_ids(11, seed=d))
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((2, 11, d)).astype(np.float32))
    inter = trope.apply_rope(x, *trope.rope_cos_sin(ids, axes))
    half = trope.apply_rope_half(x[..., perm], *trope.rope_cos_sin_half(ids, axes))
    np.testing.assert_allclose(inter[..., perm].numpy(), half.numpy(), rtol=1e-6, atol=1e-6)
