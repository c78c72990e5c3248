"""Converted checkpoints in the port: the safetensors reader and writer, the
converters, the converter's command line, the checkpoint directory and the
CLI's ``--checkpoint-dir``, against the ``safetensors`` package and the JAX
package, at tiny geometry on the CPU.

Converters and loaded parameters must equal the JAX package's exactly (the
same transposes, permutation and stacks of the same values). The pipeline
built from a converted directory runs against the JAX pipeline built with
``create(params=...)`` from the JAX converters' trees of the same snapshot,
with the same packed noise: latents within TOL (5e-4), images within 2
levels, as in tests/test_torch_pipeline.py. JAX and PyTorch draw different
VAE posterior noise, so the snapshot's VAE encoder has a log-variance half of
zeros with bias -30 (std e^-15), which leaves both sides unchanged.
"""

import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu.io import convert as JC
from reptext_tpu.io import convert_cli as jcc
from reptext_tpu.io.checkpoint import load_saved_configs as j_load_saved_configs
from reptext_tpu_torch.io import checkpoint as tck
from reptext_tpu_torch.io import convert as TC
from reptext_tpu_torch.io import convert_cli as tcc
from reptext_tpu_torch.io import safetensors as tst
from reptext_tpu_torch.io import synthetic
from reptext_tpu_torch.io.from_jax import load_jax_params
from reptext_tpu_torch.pipelines.txt2img import MODULES, build_module
from tests import synth_checkpoints as synth

from torch_port_util import TOL, port_config, write_tokenizer_dirs

SIZE = 64
TED = FluxConfig().time_embed_dim   # HF configs do not record it: the default
FLUX = dataclasses.replace(FluxConfig().tiny(), time_embed_dim=TED)
CN = dataclasses.replace(ControlNetConfig().tiny(), time_embed_dim=TED)
INPAINT_CN = dataclasses.replace(CN, extra_condition_channels=4)
VAE = VAEConfig().tiny()
# the synthetic CLIP vocabulary's ids: its <|endoftext|> is the largest
CLIP = dataclasses.replace(CLIPConfig().tiny(), vocab_size=len(synthetic.clip_vocab()),
                          eos_token_id=len(synthetic.clip_vocab()) - 1)
T5 = T5Config().tiny()
JCFGS = {"flux": FLUX, "controlnet": CN, "inpaint_controlnet": INPAINT_CN, "vae": VAE,
         "clip": CLIP, "t5": T5}
STATES = {"flux": synth.flux_state, "controlnet": synth.controlnet_state,
          "inpaint_controlnet": synth.controlnet_state, "vae": synth.vae_state,
          "clip": synth.clip_state, "t5": synth.t5_state}
CONVERTERS = {"flux": "convert_flux_transformer", "controlnet": "convert_controlnet",
              "inpaint_controlnet": "convert_controlnet", "vae": "convert_vae",
              "clip": "convert_clip", "t5": "convert_t5"}
PROMPT = "a sign that says 'hello world'"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _vae_state():
    """synth's VAE with the posterior's log-variance half at e^-30."""
    state = synth.vae_state(VAE)
    c = VAE.latent_channels
    state["encoder.conv_out.weight"][c:] = 0.0
    state["encoder.conv_out.bias"][c:] = -30.0
    return state


# ------------------------------------------------------------ safetensors


DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "I64": torch.int64, "I32": torch.int32}


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    x = {"a": torch.randn(3, 5, generator=g), "b.c": torch.randn(7, generator=g),
         "scalar": torch.randn((), generator=g), "empty": torch.zeros(0, 4)}
    if dtype.is_floating_point:
        return {k: v.to(dtype) for k, v in x.items()}
    return {k: (v * 1000).to(dtype) for k, v in x.items()}


@pytest.mark.parametrize("code", sorted(DTYPES))
def test_reader_and_writer_match_the_safetensors_package(tmp_path, code):
    st = pytest.importorskip("safetensors.torch")
    tensors = _tensors(DTYPES[code])
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    st.save_file(tensors, theirs, metadata={"format": "pt"})
    tst.save_file(tensors, ours, metadata={"format": "pt"})
    for got in (tst.load_file(theirs), st.load_file(ours), tst.load_file(ours)):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert torch.equal(got[k], v), k
    assert tst.read_metadata(ours) == {"format": "pt"} == tst.read_metadata(theirs)


def test_mixed_dtypes_are_aligned_and_cast_on_request(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = {f"{code}.x": _tensors(dt)["a"] for code, dt in DTYPES.items()}
    path = str(tmp_path / "m.safetensors")
    tst.save_file(tensors, path)
    back = st.load_file(path)
    assert all(torch.equal(back[k], v) for k, v in tensors.items())
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert n % 8 == 0
    for k, v in tensors.items():
        assert header[k]["data_offsets"][0] % v.element_size() == 0
    up = tst.load_file(path, dtype=torch.float32)
    assert up["BF16.x"].dtype == torch.float32 and up["I64.x"].dtype == torch.int64
    assert torch.equal(up["BF16.x"], tensors["BF16.x"].float())


def test_fp8_is_refused_by_name(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "f8.safetensors")
    st.save_file({"w": torch.zeros(4, 4, dtype=torch.float8_e4m3fn)}, path)
    with pytest.raises(ValueError, match="F8_E4M3"):
        tst.load_file(path)


def test_sharded_directory_matches_the_jax_loader(tmp_path):
    synth._write_component(str(tmp_path), synth.flux_state(FLUX), {}, shards=3)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".safetensors")]) == 3
    want = JC.load_safetensors_state(str(tmp_path))
    got = TC.load_safetensors_state(str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    shard = sorted(f for f in os.listdir(tmp_path) if f.endswith(".safetensors"))[0]
    one = TC.load_safetensors_state(os.path.join(tmp_path, shard))
    assert 0 < len(one) < len(got)


# ------------------------------------------------------------ converters


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax_leaf_for_leaf(name):
    cfg = JCFGS[name]
    state = _vae_state() if name == "vae" else STATES[name](cfg)
    want = dict(_flat(getattr(JC, CONVERTERS[name])(state, cfg)))
    got = dict(_flat(getattr(TC, CONVERTERS[name])(
        {k: torch.from_numpy(v) for k, v in state.items()}, port_config(cfg))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=str(k))


def test_bf16_survives_conversion_without_copies():
    """A bf16 state stays bf16 through the converter and into the module
    state dict; Linear transposes are views of the loaded tensors."""
    state = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in synth.flux_state(FLUX).items()}
    tree = TC.convert_flux_transformer(state, port_config(FLUX))
    kernel = tree["params"]["x_embedder"]["kernel"]
    assert kernel.dtype == torch.bfloat16
    assert kernel.data_ptr() == state["x_embedder.weight"].data_ptr()
    flat = tcc.module_state("flux", tree, port_config(FLUX))
    assert all(v.dtype == torch.bfloat16 for v in flat.values())
    assert flat["x_embedder.weight"].data_ptr() == state["x_embedder.weight"].data_ptr()
    want = JC.convert_flux_transformer(
        {k: v.float().numpy() for k, v in state.items()}, FLUX)["params"]
    np.testing.assert_array_equal(
        tree["params"]["double_blocks"]["block"]["to_q"]["kernel"].float().numpy(),
        want["double_blocks"]["block"]["to_q"]["kernel"])


HF_CONFIGS = {
    "flux": (FLUX, jcc.flux_config_from_hf, tcc.flux_config_from_hf),
    "controlnet": (dataclasses.replace(CN, num_mode=10), jcc.controlnet_config_from_hf,
                   tcc.controlnet_config_from_hf),
    "vae": (VAE, jcc.vae_config_from_hf, tcc.vae_config_from_hf),
    "clip": (CLIP, jcc.clip_config_from_hf, tcc.clip_config_from_hf),
    "t5": (T5, jcc.t5_config_from_hf, tcc.t5_config_from_hf),
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(name):
    cfg, j_fn, t_fn = HF_CONFIGS[name]
    hf = synthetic.hf_config(port_config(cfg))
    if name == "controlnet":
        hf["num_mode"] = cfg.num_mode
    hf["unknown_key"] = 1
    for d in (hf, {}):
        assert dataclasses.asdict(t_fn(d)) == dataclasses.asdict(j_fn(d))
    assert dataclasses.asdict(t_fn(hf)) == dataclasses.asdict(cfg)


def test_saved_configs_are_read_across_packages(tmp_path):
    """configs.json in the JAX converter's exact format: each package reads
    the other's."""
    meta = {name: dataclasses.asdict(cfg) for name, cfg in JCFGS.items()}
    meta["clip_vision"] = {"image_size": 224}
    (tmp_path / "configs.json").write_text(json.dumps(meta, indent=1, sort_keys=True))
    got, want = tck.load_saved_configs(str(tmp_path)), j_load_saved_configs(str(tmp_path))
    assert sorted(got) == sorted(JCFGS)
    for name in JCFGS:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
    assert tck.load_saved_configs(str(tmp_path / "missing")) == {}


def test_synthetic_snapshot_has_the_published_names(tmp_path):
    """io/synthetic.py (the card's snapshot writer) makes tests/synth_checkpoints.py's
    keys and shapes, and its config.json reads back to the same geometry."""
    for name in ("flux", "controlnet", "vae", "clip", "t5"):
        cfg = JCFGS[name]
        want = STATES[name](cfg)
        got = getattr(synthetic, f"{'controlnet' if name == 'controlnet' else name}_state")(
            port_config(cfg))
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    n = synthetic.write_pipeline_snapshot(str(tmp_path), *(port_config(JCFGS[k]) for k in
                                                            ("flux", "vae", "clip", "t5")))
    assert n == sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp_path)
                    for f in fs if f.endswith(".safetensors"))
    for sub, fn in (("transformer", tcc.flux_config_from_hf), ("vae", tcc.vae_config_from_hf),
                    ("text_encoder", tcc.clip_config_from_hf),
                    ("text_encoder_2", tcc.t5_config_from_hf)):
        cfg = fn(tcc._read_config(str(tmp_path / sub)))
        assert cfg == port_config({"transformer": FLUX, "vae": VAE, "text_encoder": CLIP,
                                   "text_encoder_2": T5}[sub])


# ------------------------------------------- converted directory, end to end


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A tiny snapshot (tests/synth_checkpoints.py, with the vendored
    tokenizers' files) through the port's convert_cli, and the JAX
    converters' trees of the same states."""
    root = tmp_path_factory.mktemp("snap")
    pipe_dir, out = root / "pipeline", root / "out"
    synth.write_flux_pipeline_snapshot(str(pipe_dir), FLUX, VAE, CLIP, T5)
    synth._write_component(str(pipe_dir / "vae"), _vae_state(),
                           json.loads((pipe_dir / "vae" / "config.json").read_text()))
    write_tokenizer_dirs(pipe_dir)
    synth.write_controlnet_snapshot(str(root / "cn"), CN)
    synth.write_controlnet_snapshot(str(root / "inpaint_cn"), INPAINT_CN)
    assert tcc.main(["--pipeline-dir", str(pipe_dir), "--controlnet-dir", str(root / "cn"),
                     "--inpaint-controlnet-dir", str(root / "inpaint_cn"),
                     "--out", str(out)]) == 0
    sources = {"flux": pipe_dir / "transformer", "vae": pipe_dir / "vae",
               "clip": pipe_dir / "text_encoder", "t5": pipe_dir / "text_encoder_2",
               "controlnet": root / "cn", "inpaint_controlnet": root / "inpaint_cn"}
    trees = {name: getattr(JC, CONVERTERS[name])(JC.load_safetensors_state(str(src)),
                                                  JCFGS[name])
             for name, src in sources.items()}
    return dict(out=str(out), root=root, trees=trees)


def test_converted_directory_layout(converted):
    out = converted["out"]
    assert tck.checkpoint_layout_version(out) == tck.LAYOUT_VERSION == 2
    for f in ("tokenizer/vocab.json", "tokenizer/merges.txt", "tokenizer_2/spiece.model"):
        assert os.path.isfile(os.path.join(out, f))
    # configs.json is byte for byte what the JAX converter writes
    want = json.dumps({n: dataclasses.asdict(c) for n, c in JCFGS.items()}, indent=1,
                      sort_keys=True)
    assert open(os.path.join(out, "configs.json")).read() == want
    for name in tck.COMPONENTS:
        meta = tst.read_metadata(tck.component_path(out, name))
        assert meta == {"format": "pt", "component": name, "layout_version": "2"}


def test_loaded_parameters_equal_the_jax_trees(converted):
    """load_pipeline_params' state dicts, taken over by modules built on the
    meta device, equal the JAX converters' trees carried by load_jax_params."""
    params = tck.load_pipeline_params(converted["out"])
    assert sorted(params) == sorted(tck.COMPONENTS)
    for name, state in params.items():
        cfg = port_config(JCFGS[name])
        assert all(v.dtype == torch.float32 for v in state.values())
        a = build_module(MODULES[name], cfg, torch.device("cpu"), torch.float32, state)
        b = MODULES[name](cfg)
        load_jax_params(b, converted["trees"][name])
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (name, k)


def _args(out, *extra):
    from reptext_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["--checkpoint-dir", out, "--device", "cpu", "--size", str(SIZE), "--steps", "2",
         "--controlnet-step", "1", "--text", "Hi", "--position", "8", "16", "--font-size",
         "24", *extra])


def test_pipeline_from_checkpoint_matches_jax(converted):
    """--checkpoint-dir (configs.json geometry, vendored tokenizers) against
    the JAX pipeline on the JAX converters' trees: the same ids, latents
    within TOL, images within 2 levels."""
    from reptext_tpu.cli import _tokenize as j_tokenize
    from reptext_tpu.conditioning import TextLine, build_conditions
    from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
    from reptext_tpu.utils.image import postprocess_images
    from reptext_tpu_torch import cli

    args = _args(converted["out"])
    pipe = cli.build_pipeline(args)
    assert pipe.flux.config == port_config(FLUX) and pipe.clip.config == port_config(CLIP)
    clip_ids, t5_ids = cli._prompt_ids(args, pipe, PROMPT)
    jclip, jt5 = j_tokenize(PROMPT, CLIP, T5, converted["out"])
    np.testing.assert_array_equal(clip_ids, np.asarray(jclip))
    np.testing.assert_array_equal(t5_ids, np.asarray(jt5))
    demo = cli.demo_token_ids(PROMPT, pipe.clip.config, pipe.t5.config, 512)
    assert not np.array_equal(t5_ids, demo[1])

    pipe_cfg = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                              controlnet_conditioning_step=1)
    jpipe = JPipeline.create(flux_cfg=FLUX, cn_cfg=CN, vae_cfg=VAE, pipe_cfg=pipe_cfg,
                             clip_cfg=CLIP, t5_cfg=T5, params=converted["trees"])
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE, font_size=24)
    noise = np.random.default_rng(5).standard_normal(
        (1, pipe_cfg.image_seq_len, 4 * VAE.latent_channels)).astype(np.float32)
    jlat = jpipe(cond, clip_ids=jnp.asarray(jclip), t5_ids=jnp.asarray(jt5),
                 latents=jnp.asarray(noise), output_type="latent")
    tlat = pipe(cond, clip_ids=clip_ids, t5_ids=t5_ids, latents=torch.from_numpy(noise),
                output_type="latent")
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), **TOL)
    jimg, timg = postprocess_images(jpipe._decode(jlat)), pipe.decode(tlat)
    assert timg.shape == jimg.shape == (1, SIZE, SIZE, 3)
    assert np.abs(timg.astype(int) - jimg.astype(int)).max() <= 2


def test_cli_writes_an_image_from_the_checkpoint(converted, tmp_path):
    from PIL import Image

    from reptext_tpu_torch import cli

    out = tmp_path / "r.png"
    assert cli.main(["--checkpoint-dir", converted["out"], "--device", "cpu", "--size", "64",
                     "--steps", "1", "--controlnet-step", "1", "--text", "Hi", "--position",
                     "8", "16", "--font-size", "24", "--output", str(out)]) == 0
    assert Image.open(out).size == (64, 64)


def test_inpaint_takes_the_checkpoint_controlnet(converted, tmp_path):
    """--mode inpaint adds the directory's inpaint ControlNet, and the seeded
    one when the directory has none."""
    from reptext_tpu_torch import cli

    want = tst.load_file(tck.component_path(converted["out"], "inpaint_controlnet"))
    pipe = cli.build_pipeline(_args(converted["out"], "--mode", "inpaint"))
    got = dict(pipe.inpaint_controlnet.named_parameters())
    assert pipe.inpaint_controlnet.config.extra_condition_channels == 4
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    bare = tmp_path / "bare"
    shutil.copytree(converted["out"], bare)
    os.remove(tck.component_path(str(bare), "inpaint_controlnet"))
    seeded = cli.build_pipeline(_args(str(bare), "--mode", "inpaint")).inpaint_controlnet
    assert seeded.config.extra_condition_channels == 4
    w = dict(seeded.named_parameters())["x_embedder.weight"]
    assert not torch.equal(w, want["x_embedder.weight"])


def test_converter_dtype_and_what_it_refuses(converted, tmp_path):
    cn = str(converted["root"] / "cn")
    assert tcc.main(["--controlnet-dir", cn, "--out", str(tmp_path / "b"), "--dtype",
                     "bf16"]) == 0
    state = tst.load_file(tck.component_path(str(tmp_path / "b"), "controlnet"))
    assert all(v.dtype == torch.bfloat16 for v in state.values())
    for bad in (["--lora", "x.safetensors"], ["--ip-adapter", "x"], ["--dtype", "fp8"],
                ["--flux-single-file", "x"], []):
        with pytest.raises(SystemExit):
            tcc.main(([] if bad == [] else ["--controlnet-dir", cn]) + bad
                     + ["--out", str(tmp_path / "c")])


def test_load_refuses_other_layouts_and_orbax(tmp_path, converted):
    old = tmp_path / "v1"
    shutil.copytree(converted["out"], old)
    os.remove(old / "LAYOUT_VERSION")
    with pytest.raises(ValueError, match="layout v1"):
        tck.load_pipeline_params(str(old))
    orbax = tmp_path / "orbax"
    (orbax / "flux").mkdir(parents=True)
    (orbax / "LAYOUT_VERSION").write_text("2\n")
    with pytest.raises(ValueError, match="reptext_tpu_torch.io.convert_cli"):
        tck.load_pipeline_params(str(orbax))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "LAYOUT_VERSION").write_text("2\n")
    with pytest.raises(FileNotFoundError):
        tck.load_pipeline_params(str(empty))
    from reptext_tpu_torch import cli

    with pytest.raises(SystemExit, match="lacks"):
        partial = tmp_path / "partial"
        shutil.copytree(converted["out"], partial)
        os.remove(tck.component_path(str(partial), "t5"))
        cli.build_pipeline(_args(str(partial)))
