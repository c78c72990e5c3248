"""``io/single_file.py`` (BFL single-file FLUX) in the port against the JAX package's, on the CPU.

The BFL-layout state comes from a seeded diffusers FLUX state through the
port's writer (``io/synthetic.py::bfl_flux_state``), held equal to the JAX
test's own inverse map (``tests/test_single_file.py::_diffusers_to_bfl``).
Checks: ``bfl_flux_to_diffusers`` key for key and bit for bit against JAX's
(fp32 and bf16), back to the diffusers state it came from; the wrapper
prefixes; ``flux_config_from_state`` against JAX's (dev and schnell-like);
``load_flux_single_file``; and ``convert_cli --flux-single-file``, whose
converted transformer must be bit-equal to the diffusers snapshot's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from reptext_tpu.configs import FluxConfig
from reptext_tpu.io import single_file as jsf
from reptext_tpu_torch.io import checkpoint as tck
from reptext_tpu_torch.io import convert as TC
from reptext_tpu_torch.io import convert_cli as tcc
from reptext_tpu_torch.io import safetensors as tst
from reptext_tpu_torch.io import single_file as tsf
from reptext_tpu_torch.io import synthetic
from reptext_tpu_torch.io.from_jax import flatten_jax_params

from test_single_file import _diffusers_to_bfl
from test_torch_checkpoint import FLUX
from torch_port_util import port_config

SCHNELL = dataclasses.replace(FLUX, guidance_embeds=False)


def _state(cfg=FLUX, dtype=torch.float32):
    return synthetic.flux_state(port_config(cfg), seed=3, dtype=dtype)


def _np(state):
    return {k: v.float().numpy() for k, v in state.items()}


@pytest.mark.parametrize("cfg", [FLUX, SCHNELL], ids=["dev", "schnell"])
def test_bfl_writer_matches_the_jax_tests_inverse(cfg):
    state = _state(cfg)
    got = synthetic.bfl_flux_state(state)
    want = _diffusers_to_bfl(_np(state), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bfl_to_diffusers_matches_jax_bit_for_bit(dtype):
    state = _state(dtype=dtype)
    bfl = synthetic.bfl_flux_state(state)
    assert tsf.is_bfl_flux(bfl) and not tsf.is_bfl_flux(state)
    got = tsf.bfl_flux_to_diffusers(bfl)
    want = jsf.bfl_flux_to_diffusers(_np(bfl))
    assert sorted(got) == sorted(want) == sorted(state)
    for k in want:
        assert got[k].dtype == dtype and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].float().numpy(), want[k])
        assert torch.equal(got[k], state[k]), k


def test_wrapper_prefixes_are_stripped_as_jax():
    bfl = synthetic.bfl_flux_state(_state())
    wrapped = {f"model.diffusion_model.{k}": v for k, v in bfl.items()}
    wrapped["module.extra"] = torch.zeros(1)
    got = tsf.strip_wrapper_prefixes(wrapped)
    want = jsf.strip_wrapper_prefixes(_np(wrapped))
    assert sorted(got) == sorted(want)
    assert tsf.is_bfl_flux(got)


@pytest.mark.parametrize("cfg", [FLUX, SCHNELL], ids=["dev", "schnell"])
def test_flux_config_from_state_matches_jax(cfg):
    state = _state(cfg)
    got = tsf.flux_config_from_state(state)
    want = jsf.flux_config_from_state(_np(state))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_layers == cfg.num_layers and got.guidance_embeds == cfg.guidance_embeds


# every published FLUX.1 has head dim 128, which flux_config_from_state
# assumes: a small geometry at that head dim (the JAX CLI test's)
HD128 = dataclasses.replace(FluxConfig(), num_layers=1, num_single_layers=2,
                            num_attention_heads=1, joint_attention_dim=48,
                            pooled_projection_dim=40)


def test_load_flux_single_file(tmp_path):
    state = _state()
    path = str(tmp_path / "flux1-tiny.safetensors")
    tst.save_file({f"model.diffusion_model.{k}": v.contiguous()
                   for k, v in synthetic.bfl_flux_state(state).items()}, path)
    tree, cfg = tsf.load_flux_single_file(path, port_config(FLUX))
    want = TC.convert_flux_transformer(state, port_config(FLUX))
    got, ref = flatten_jax_params(tree), flatten_jax_params(want)
    assert sorted(got) == sorted(ref) and cfg == port_config(FLUX)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    jtree = jsf.load_flux_single_file(path, FLUX)
    for k, v in flatten_jax_params(jtree).items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    # without a config the geometry is inferred
    state = _state(HD128)
    tst.save_file(synthetic.bfl_flux_state(state), path)
    _, cfg = tsf.load_flux_single_file(path)
    assert cfg == port_config(HD128)


def test_convert_cli_flux_single_file(tmp_path):
    """A BFL file through convert_cli --flux-single-file equals the same
    weights' diffusers snapshot through --flux-dir, bit for bit, and records
    the inferred geometry."""
    cfg = port_config(HD128)
    state = synthetic.flux_state(cfg, seed=5, dtype=torch.bfloat16)
    snap = tmp_path / "transformer"
    synthetic.write_component(str(snap), state, synthetic.hf_config(cfg))
    path = str(tmp_path / "flux1-dev.safetensors")
    tst.save_file({k: v.contiguous() for k, v in synthetic.bfl_flux_state(state).items()}, path)
    outs = {}
    for name, argv in (("dir", ["--flux-dir", str(snap)]),
                       ("bfl", ["--flux-single-file", path])):
        outs[name] = str(tmp_path / name)
        assert tcc.main(argv + ["--out", outs[name]]) == 0
    want = tst.load_file(tck.component_path(outs["dir"], "flux"))
    got = tst.load_file(tck.component_path(outs["bfl"], "flux"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k]), k
    saved = tck.load_saved_configs(outs["bfl"])["flux"]
    assert saved == tsf.flux_config_from_state(state) == cfg
    assert dataclasses.asdict(saved) == dataclasses.asdict(
        jsf.flux_config_from_state(_np(state)))
    # a diffusers-named single file takes the same path
    path2 = str(tmp_path / "diffusers.safetensors")
    tst.save_file(state, path2)
    assert tcc.main(["--flux-single-file", path2, "--out", str(tmp_path / "d2")]) == 0
    got2 = tst.load_file(tck.component_path(str(tmp_path / "d2"), "flux"))
    assert all(torch.equal(got2[k], want[k]) for k in want)
