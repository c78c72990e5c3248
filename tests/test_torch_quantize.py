"""fp8 weight-only storage in the port (``io/quantize.py``, ``QuantLinear``,
the models' ``weight_quant``, the pipelines' ``quantize_weights``, the
converter's ``--dtype fp8`` and the CLI's ``--weight-dtype``) against the
JAX package's, on the CPU.

- ``quantize_kernel``/``dequantize_kernel`` bit for bit against
  ``reptext_tpu.io.quantize`` (a zero column, a stacked layer axis, a column
  whose scale rounds down so that a code reaches 448), in the Flax and the
  torch layout; ``quantize_params``, ``dequantize_collection``,
  ``is_quantized`` and ``quantized_bytes`` against the JAX functions;
  ``random_params_like``'s structure;
- tiny FLUX and ControlNet built with ``weight_quant`` and given JAX's
  quantized tree through ``load_jax_params``, against the JAX models with
  ``weight_quant=True`` on the same tree, float32 compute: TOL (5e-4);
- the quantized pipeline against JAX's ``quantize_weights()`` through
  ``latents=`` (TOL); the pipelines that share the bf16 modules keep them;
- ``convert_cli --dtype fp8``, ``--checkpoint-dir`` and the CLI's refusals.

JAX and PyTorch draw different posterior noise: the shared VAE's encoder has
a log-variance half of zeros with bias -30, as in tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from reptext_tpu.conditioning import TextLine, build_conditions
from reptext_tpu.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu.io import quantize as jq
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.nn.clip import CLIPTextEncoder as JCLIP
from reptext_tpu.nn.t5 import T5Encoder as JT5
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu_torch.io import quantize as tq
from reptext_tpu_torch.io.from_jax import load_jax_params
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D, quantized_copy
from reptext_tpu_torch.nn.init import random_init_
from reptext_tpu_torch.nn.layers import QuantLinear
from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

from torch_port_util import TOL, port_config, port_configs_of, random_tree

SIZE = 64
CFGS = dict(flux_cfg=FluxConfig().tiny(), cn_cfg=ControlNetConfig().tiny(),
            vae_cfg=VAEConfig().tiny(), clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                          controlnet_conditioning_step=1, guidance_scale=3.5)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32)
S_TXT = 4


def _bits(x):
    """The raw bits of a JAX/ml_dtypes array or a torch tensor, as numpy
    (4-byte elements as pairs of 16-bit words)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8 if x.element_size() == 1 else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype.itemsize == 1 else np.int16)


def _bf16_kernel(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return w.astype(ml_dtypes.bfloat16).astype(np.float32)


# ------------------------------------------------------------ the format


@pytest.mark.parametrize("case", ["zero_column", "stacked", "scale_rounds_down"])
def test_quantize_kernel_is_bit_equal_to_jax(case):
    if case == "stacked":
        w = _bf16_kernel((3, 48, 40), 1)
    else:
        w = _bf16_kernel((96, 64), 2)
    if case == "zero_column":
        w[:, 7] = 0.0
    if case == "scale_rounds_down":
        # an amax whose amax / 448 rounds down in bf16: w / scale > 448 -> code 448
        amax = next(a for a in np.linspace(1.0, 2.0, 4097, dtype=np.float32)
                    if float(np.float32(a / 448).astype(ml_dtypes.bfloat16)) < a / 448
                    and float(np.float32(a).astype(ml_dtypes.bfloat16)) == a)
        w[3, 5] = amax
        w[:, 5] = np.clip(w[:, 5], -amax, amax)
    qj, sj = jq.quantize_kernel(jnp.asarray(w, jnp.bfloat16))
    qt, st = tq.quantize_kernel(torch.from_numpy(w).bfloat16(), in_axis=-2)
    assert qt.dtype == torch.float8_e4m3fn and st.dtype == torch.bfloat16
    assert st.shape == w.shape[:-2] + (1, w.shape[-1])
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    dj, dt = jq.dequantize_kernel(qj, sj), tq.dequantize_kernel(qt, st)
    np.testing.assert_array_equal(_bits(dt), _bits(dj))
    # the torch layout [out, in] gives the same codes, transposed
    qt2, st2 = tq.quantize_kernel(torch.from_numpy(np.swapaxes(w, -1, -2)).bfloat16())
    np.testing.assert_array_equal(_bits(qt2), np.swapaxes(_bits(qt), -1, -2))
    np.testing.assert_array_equal(_bits(st2), np.swapaxes(_bits(st), -1, -2))
    if case == "zero_column":
        assert not qt[:, 7].float().any() and float(st[0, 7]) == pytest.approx(1e-12, rel=1e-2)
    if case == "scale_rounds_down":
        assert float(qt[:, 5].float().abs().max()) == 448.0


def _flux_tree(seed=1):
    f = CFGS["flux_cfg"]
    s_img = PIPE_CFG.image_seq_len
    z = jnp.zeros
    return random_tree(JFlux(f), z((1, s_img, f.in_channels)), z((1, S_TXT, f.joint_attention_dim)),
                       z((1, f.pooled_projection_dim)), z((1,)), z((s_img, 3)), z((S_TXT, 3)),
                       jnp.ones((1,)), seed=seed)


def _cn_tree(seed=2):
    c = CFGS["cn_cfg"]
    s_img = PIPE_CFG.image_seq_len
    z = jnp.zeros
    return random_tree(JControlNet(c), z((1, s_img, c.in_channels)),
                       z((1, s_img, c.in_channels + c.extra_condition_channels)),
                       z((1, S_TXT, c.joint_attention_dim)), z((1, c.pooled_projection_dim)),
                       z((1,)), z((s_img, 3)), z((S_TXT, 3)), jnp.ones((1,)), seed=seed)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _paths(dict(v), prefix + (k,))
        else:
            yield prefix + (k,), v


def test_quantize_params_matches_jax_and_is_idempotent():
    tree = _flux_tree()
    jtree = jq.quantize_params(tree["params"])
    ttree = tq.quantize_params(tree)
    assert set(ttree) == {"params"}
    got, want = dict(_paths(ttree["params"])), dict(_paths(jtree))
    assert sorted(got) == sorted(want)
    n_q = 0
    for path, leaf in want.items():
        if path[-1] in (tq.QUANT_KEY, tq.SCALE_KEY):
            n_q += 1
            np.testing.assert_array_equal(_bits(got[path]), _bits(leaf), err_msg=str(path))
            assert path[0] in tq.DEFAULT_SUBTREES
        else:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    # one stacked leaf per Linear of a block: 14 in a double block, 6 in a single
    assert n_q == 2 * (14 + 6)
    again = dict(_paths(tq.quantize_params(ttree)["params"]))
    assert all(again[p] is got[p] for p in got)
    # dequantize_collection: bf16 kernels equal to the JAX function's
    dj = dict(_paths(jq.dequantize_collection(jtree)))
    dt = dict(_paths(tq.dequantize_collection(ttree["params"])))
    assert sorted(dj) == sorted(dt) == sorted(dict(_paths(tree["params"])))
    for path in dj:
        if path[0] in tq.DEFAULT_SUBTREES and path[-1] == "kernel":
            np.testing.assert_array_equal(_bits(dt[path]), _bits(dj[path]))
    assert tq.is_quantized(ttree) and not tq.is_quantized(tree)
    assert jq.quantized_bytes(jtree) == tq.quantized_bytes(ttree)


def test_random_params_like_has_the_quantized_structure():
    tree = _flux_tree()
    shapes = jax.eval_shape(lambda: tree)
    gen = torch.Generator().manual_seed(0)
    rand = dict(_paths(tq.random_params_like(shapes, gen, "cpu")["params"]))
    want = dict(_paths(tq.quantize_params(tree)["params"]))
    assert sorted(rand) == sorted(want)
    for path, leaf in want.items():
        assert tuple(rand[path].shape) == tuple(leaf.shape), path
        if path[-1] == tq.QUANT_KEY:
            assert rand[path].dtype == torch.float8_e4m3fn
            assert torch.isfinite(rand[path].float()).all()
            fan_in = leaf.shape[-2]
            scale = rand[path[:-1] + (tq.SCALE_KEY,)]
            assert scale.dtype == torch.bfloat16
            assert torch.all(scale == torch.tensor(1.0 / (448.0 * np.sqrt(fan_in)),
                                                   dtype=torch.bfloat16))
        elif path[-1] == "bias":
            assert not rand[path].any()
    # every byte pattern but the two NaNs can appear
    codes = torch.cat([v.view(torch.uint8).flatten() for p, v in rand.items()
                       if p[-1] == tq.QUANT_KEY])
    assert not ((codes & 0x7F) == 0x7F).any() and len(torch.unique(codes)) == 254


# ------------------------------------------------------- models vs JAX


def _ids(s_img, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, 8, (s_img, 3)).astype(np.float32),
            np.zeros((S_TXT, 3), np.float32))


def _model_inputs(cfg, seed, cond_ch=None):
    r = np.random.default_rng(seed)
    s_img = PIPE_CFG.image_seq_len
    x = r.standard_normal((2, s_img, cfg.in_channels)).astype(np.float32)
    ctx = r.standard_normal((2, S_TXT, cfg.joint_attention_dim)).astype(np.float32)
    pooled = r.standard_normal((2, cfg.pooled_projection_dim)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    img_ids, txt_ids = _ids(s_img, seed + 1)
    g = np.asarray([3.5, 3.5], np.float32)
    cond = (None if cond_ch is None
            else r.standard_normal((2, s_img, cond_ch)).astype(np.float32))
    return x, cond, ctx, pooled, t, img_ids, txt_ids, g


def test_quantized_flux_matches_jax_weight_quant():
    cfg = CFGS["flux_cfg"]
    qtree = jq.quantize_params(_flux_tree()["params"])
    x, _, ctx, pooled, t, img_ids, txt_ids, g = _model_inputs(cfg, 3)
    want = JFlux(cfg, weight_quant=True).apply({"params": qtree}, *map(jnp.asarray, (
        x, ctx, pooled, t, img_ids, txt_ids, g)))
    model = load_jax_params(FluxTransformer2D(port_config(cfg), weight_quant=True),
                            {"params": qtree}).eval()
    assert model.weight_quant and sum(isinstance(m, QuantLinear) for m in model.modules()) == 52
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x, ctx, pooled, t, img_ids, txt_ids, g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantized_controlnet_matches_jax_and_zero_heads_stay_zero():
    cfg = CFGS["cn_cfg"]
    qtree = jq.quantize_params(_cn_tree()["params"])
    x, cond, ctx, pooled, t, img_ids, txt_ids, g = _model_inputs(
        cfg, 4, cfg.in_channels + cfg.extra_condition_channels)
    jb, js = JControlNet(cfg, weight_quant=True).apply({"params": qtree}, *map(jnp.asarray, (
        x, cond, ctx, pooled, t, img_ids, txt_ids, g)))
    model = load_jax_params(RepTextControlNet(port_config(cfg), weight_quant=True),
                            {"params": qtree}).eval()
    args = tuple(map(torch.from_numpy, (x, cond, ctx, pooled, t, img_ids, txt_ids, g)))
    with torch.no_grad():
        tb, ts = model(*args)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # a fresh (zero-headed) ControlNet stays a no-op in fp8: drawn quantized,
    # and quantized from bf16
    fresh = RepTextControlNet(port_config(cfg))
    random_init_(fresh, torch.Generator().manual_seed(0))
    drawn = RepTextControlNet(port_config(cfg), weight_quant=True)
    random_init_(drawn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for net in (quantized_copy(fresh), drawn):
            assert net.weight_quant
            b, s = net(*args)
            assert not b.any() and not s.any()


# ------------------------------------------------------------ pipelines


def _shared_params():
    f, c, v = CFGS["flux_cfg"], CFGS["cn_cfg"], CFGS["vae_cfg"]
    params = {"flux": _flux_tree(), "controlnet": _cn_tree(),
              "vae": random_tree(JVAE(v), jnp.zeros((1, 64, 64, 3)), seed=3),
              "clip": random_tree(JCLIP(CFGS["clip_cfg"]), jnp.zeros((1, 16), jnp.int32), seed=4),
              "t5": random_tree(JT5(CFGS["t5_cfg"]), jnp.zeros((1, 16), jnp.int32), seed=5)}
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0
    conv_out["bias"][v.latent_channels:] = -30.0
    return params


@pytest.fixture(scope="module")
def pipes():
    params = _shared_params()
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=params, **CFGS)
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=params,
                                       device="cpu", **port_configs_of(CFGS))
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE, font_size=24)
    noise = np.random.default_rng(7).standard_normal(
        (1, PIPE_CFG.image_seq_len, 4 * CFGS["vae_cfg"].latent_channels)).astype(np.float32)
    return jpipe, tpipe, cond, noise


def _latents(pipe, cond, noise, jax_side=False):
    if jax_side:
        return np.asarray(pipe(cond, clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                               latents=jnp.asarray(noise), output_type="latent"))
    return pipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=torch.from_numpy(noise),
                output_type="latent")


def test_quantized_pipeline_matches_jax_and_leaves_sharing_pipelines_alone(pipes):
    jpipe, tpipe, cond, noise = pipes
    # pipelines over the bf16 modules, made before quantize_weights
    view = tpipe.with_config(dataclasses.replace(tpipe.pipe_cfg, guidance_scale=3.5))
    inpaint = FluxRepTextInpaintPipeline.from_pipeline(tpipe, seed=3)
    before = _latents(view, cond, noise)
    flux_bf16 = tpipe.flux
    q = FluxRepTextPipeline.quantize_weights(tpipe.with_config(tpipe.pipe_cfg))
    jq_pipe = dataclasses.replace(jpipe)
    jq_pipe.quantize_weights()
    np.testing.assert_allclose(_latents(q, cond, noise).numpy(),
                               _latents(jq_pipe, cond, noise, jax_side=True), **TOL)
    assert q.flux.weight_quant and q.controlnet.weight_quant
    assert q.vae is tpipe.vae and q.flux.x_embedder is flux_bf16.x_embedder
    # the earlier pipelines keep the bf16 modules and their outputs bit for bit
    for p in (tpipe, view, inpaint):
        assert p.flux is flux_bf16 and not p.flux.weight_quant
        assert not p.controlnet.weight_quant
    assert not any(isinstance(m, QuantLinear) for m in flux_bf16.modules())
    assert torch.equal(_latents(view, cond, noise), before)
    # a pipeline derived after shares the quantized modules; quantizing again is a no-op
    later = FluxRepTextInpaintPipeline.from_pipeline(q, seed=3)
    assert later.flux is q.flux and later.controlnet is q.controlnet
    assert not later.inpaint_controlnet.weight_quant
    later.quantize_weights()
    assert later.flux is q.flux and later.controlnet is q.controlnet
    assert later.inpaint_controlnet.weight_quant and not inpaint.inpaint_controlnet.weight_quant
    with pytest.raises(ValueError, match="BEFORE quantize_weights"):
        q.attach_ip_adapter()
    with pytest.raises(ValueError, match="BEFORE quantize_weights"):
        q.flux.add_ip_adapter(32)


@pytest.mark.parametrize("built", ["module", "pipeline"])
def test_a_model_built_with_weight_quant_refuses_the_adapter(pipes, built):
    """``weight_quant=True`` at build sets the JAX models' flag, so the
    adapter is refused as the JAX method refuses a ``weight_quant`` FLUX;
    only stacks that came from fp8 storage take it."""
    jpipe = dataclasses.replace(pipes[0])
    jpipe.flux = jpipe.flux.clone(weight_quant=True)
    with pytest.raises(ValueError, match="BEFORE quantize_weights"):
        jpipe.attach_ip_adapter()
    if built == "module":
        flux = FluxTransformer2D(port_config(CFGS["flux_cfg"]), device="cpu", weight_quant=True)
        assert flux.quantized_by_call and quantized_copy(flux) is flux
        with pytest.raises(ValueError, match="BEFORE quantize_weights"):
            flux.add_ip_adapter(32)
    else:
        pipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), device="cpu",
                                          weight_quant=True, **port_configs_of(CFGS))
        assert pipe.flux.quantized_by_call and pipe.controlnet.quantized_by_call
        with pytest.raises(ValueError, match="BEFORE quantize_weights"):
            pipe.attach_ip_adapter()
        stored = FluxRepTextPipeline.create(
            pipe_cfg=port_config(PIPE_CFG), device="cpu", **port_configs_of(CFGS),
            params={k: v if k not in ("flux", "controlnet")
                    else {"params": jq.quantize_params(v["params"])}
                    for k, v in _shared_params().items()})
        assert stored.flux.weight_quant and not stored.flux.quantized_by_call
        assert stored.controlnet.weight_quant and not stored.controlnet.quantized_by_call


def test_quantized_bytes_of_the_models(pipes):
    _, tpipe, _, _ = pipes
    q = quantized_copy(tpipe.flux)
    stored, as_bf16 = tq.quantized_bytes(q)
    n_block = sum(p.numel() for n, p in q.named_parameters() if n.endswith("kernel_q8"))
    assert as_bf16 == 2 * sum(p.numel() for p in q.parameters())
    # codes 1 byte, scales 2 bytes, everything else float32 on the CPU
    assert stored == sum(p.numel() * p.element_size() for p in q.parameters())
    assert n_block > 0.9 * sum(p.numel() for p in q.parameters())
    assert tq.is_quantized(q) and not tq.is_quantized(tpipe.flux)
    # a module-wide cast moves the codes and scales and casts the rest only
    half = quantized_copy(tpipe.controlnet).to(torch.bfloat16)
    kinds = {n.rsplit(".", 1)[-1]: p.dtype for n, p in half.named_parameters()}
    assert kinds["kernel_q8"] == torch.float8_e4m3fn and kinds["kernel_scale"] == torch.bfloat16
    assert kinds["bias"] == torch.bfloat16


# ------------------------------------------------------- convert and CLI


@pytest.fixture(scope="module")
def converted_fp8(tmp_path_factory):
    """The checkpoint tests' tiny snapshot converted with --dtype bf16 and
    with --dtype fp8 (and --lora on both)."""
    from test_torch_checkpoint import CN, CLIP, FLUX, INPAINT_CN, T5, VAE, _vae_state
    from reptext_tpu_torch.io import convert_cli as tcc
    from reptext_tpu_torch.io import synthetic
    from tests import synth_checkpoints as synth
    from torch_port_util import write_tokenizer_dirs

    import json

    root = tmp_path_factory.mktemp("fp8")
    pipe_dir = root / "pipeline"
    synth.write_flux_pipeline_snapshot(str(pipe_dir), FLUX, VAE, CLIP, T5)
    synth._write_component(str(pipe_dir / "vae"), _vae_state(),
                           json.loads((pipe_dir / "vae" / "config.json").read_text()))
    write_tokenizer_dirs(pipe_dir)
    synth.write_controlnet_snapshot(str(root / "cn"), CN)
    synth.write_controlnet_snapshot(str(root / "inpaint_cn"), INPAINT_CN)
    lora = root / "lora.safetensors"
    from reptext_tpu_torch.io.safetensors import save_file

    save_file(synthetic.lora_state(port_config(FLUX), rank=2, seed=3), str(lora))
    outs = {"lora": str(lora)}
    for dtype in ("bf16", "fp8"):
        outs[dtype] = str(root / dtype)
        assert tcc.main(["--pipeline-dir", str(pipe_dir), "--controlnet-dir", str(root / "cn"),
                         "--inpaint-controlnet-dir", str(root / "inpaint_cn"), "--lora",
                         str(lora), "--dtype", dtype, "--out", outs[dtype]]) == 0
    return outs


def _cli_args(out, *extra):
    from reptext_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["--checkpoint-dir", out, "--device", "cpu", "--size", str(SIZE), "--steps", "2",
         "--controlnet-step", "1", "--text", "Hi", "--position", "8", "16", "--font-size",
         "24", *extra])


def test_fp8_checkpoint_equals_quantize_at_load(converted_fp8):
    from reptext_tpu_torch import cli
    from reptext_tpu_torch.io import checkpoint as tck
    from reptext_tpu_torch.io import safetensors as tst

    st = pytest.importorskip("safetensors.torch")
    for name in ("flux", "controlnet", "inpaint_controlnet", "vae"):
        path = tck.component_path(converted_fp8["fp8"], name)
        ours, theirs = tst.load_file(path), st.load_file(path)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            assert np.array_equal(_bits(ours[k]), _bits(theirs[k])), k
        kinds = {v.dtype for v in ours.values()}
        assert kinds == ({torch.float8_e4m3fn, torch.bfloat16} if name != "vae"
                         else {torch.bfloat16})
    fp8 = cli.build_pipeline(_cli_args(converted_fp8["fp8"], "--mode", "inpaint"))
    dense = cli.build_pipeline(_cli_args(converted_fp8["bf16"], "--mode", "inpaint"))
    assert not dense.flux.weight_quant
    dense.quantize_weights()
    # --vae-tiling auto: on for fp8 without --tiny (as the JAX CLI), off for bf16
    assert fp8.vae_tiling == (72, 16) and dense.vae_tiling is None
    for a, b in ((fp8.flux, dense.flux), (fp8.controlnet, dense.controlnet),
                 (fp8.inpaint_controlnet, dense.inpaint_controlnet)):
        assert a.weight_quant
        pa, pb = a.state_dict(), b.state_dict()
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype and np.array_equal(_bits(pa[k]), _bits(pb[k])), k
    # one request runs through the fp8 checkpoint, tiled
    pipe = cli.build_pipeline(_cli_args(converted_fp8["fp8"], "--vae-tiling", "on"))
    assert pipe.flux.weight_quant and pipe.vae_tiling == (72, 16)
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE, font_size=24)
    images = cli.generate(_cli_args(converted_fp8["fp8"]), pipe, cond)
    assert images.shape == (1, SIZE, SIZE, 3) and images.dtype == np.uint8


def test_fp8_checkpoint_with_ip_adapter_equals_dense_attach_then_quantize(converted_fp8,
                                                                          tmp_path):
    """``--ip-adapter-image`` with the converter's adapter directory on the
    ``--dtype fp8`` checkpoint: module state and image bit-equal to the bf16
    checkpoint's pipeline with the adapter attached, then quantize_weights()."""
    from PIL import Image

    from reptext_tpu_torch import cli
    from reptext_tpu_torch.io.convert_cli import write_ip_adapter
    from test_torch_checkpoint import FLUX
    from test_torch_ip_adapter import _image, _write_adapter_files

    vdir, ip_path = _write_adapter_files(tmp_path)
    write_ip_adapter(str(tmp_path), ip_path, FLUX.num_layers, FLUX.attention_head_dim, vdir)
    style = tmp_path / "style.png"
    Image.fromarray(_image(16)).save(style)
    extra = ("--ip-adapter-image", str(style), "--ip-adapter-dir", str(tmp_path / "ip_adapter"),
             "--ip-adapter-scale", "0.7", "--vae-tiling", "off")
    fp8 = cli.build_pipeline(_cli_args(converted_fp8["fp8"], *extra))
    dense = cli.build_pipeline(_cli_args(converted_fp8["bf16"], *extra))
    assert fp8.flux.weight_quant and not dense.flux.weight_quant and dense.flux.ip_adapter
    dense.quantize_weights()
    for a, b in ((fp8.flux, dense.flux), (fp8.controlnet, dense.controlnet)):
        pa, pb = a.state_dict(), b.state_dict()
        assert sorted(pa) == sorted(pb)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype and np.array_equal(_bits(pa[k]), _bits(pb[k])), k
    assert isinstance(fp8.flux.double_blocks[0].block.to_v_ip, QuantLinear)
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE, font_size=24)
    args = _cli_args(converted_fp8["fp8"], *extra)
    got = cli.generate(args, fp8, cond)
    assert np.array_equal(got, cli.generate(args, dense, cond))
    assert got.shape == (1, SIZE, SIZE, 3) and got.dtype == np.uint8
    # the adapter acts on the fp8 pipeline
    args.ip_adapter_scale = 0.0
    assert not torch.equal(cli.generate(args, fp8, cond, output_type="latent"),
                           cli.generate(_cli_args(converted_fp8["fp8"], *extra), fp8, cond,
                                        output_type="latent"))


def test_cli_weight_dtype_and_its_refusals(converted_fp8):
    from reptext_tpu_torch import cli

    lora = converted_fp8["lora"]
    with pytest.raises(SystemExit, match="--lora cannot merge into an fp8-stored checkpoint"):
        cli.build_pipeline(_cli_args(converted_fp8["fp8"], "--lora", lora))
    with pytest.raises(SystemExit, match="training needs dense weights"):
        cli.build_pipeline(_cli_args(converted_fp8["fp8"], "--mode", "train"))
    with pytest.raises(SystemExit, match="training needs dense weights"):
        cli.build_pipeline(_cli_args(converted_fp8["bf16"], "--mode", "train", "--weight-dtype",
                                     "fp8"))
    # an fp8-stored checkpoint takes the IP-Adapter: attached dense, then
    # quantized by quantize_weights() with the stored stacks kept (the JAX
    # CLI's order; the image itself is read at generation only)
    pipe = cli.build_pipeline(_cli_args(converted_fp8["fp8"], "--ip-adapter-image", lora))
    assert pipe.flux.ip_adapter and pipe.flux.weight_quant
    assert isinstance(pipe.flux.double_blocks[0].block.to_k_ip, QuantLinear)
    # random weights drawn in fp8 storage; the IP-Adapter attaches before quantizing
    rand = cli.build_parser().parse_args(["--random-weights", "--tiny", "--device", "cpu",
                                          "--size", str(SIZE), "--weight-dtype", "fp8"])
    pipe = cli.build_pipeline(rand)
    assert pipe.flux.weight_quant and pipe.controlnet.weight_quant and pipe.vae_tiling is None
    ip = cli.build_parser().parse_args(["--random-weights", "--tiny", "--device", "cpu",
                                        "--size", str(SIZE), "--weight-dtype", "fp8",
                                        "--ip-adapter-image", lora, "--vae-tiling", "on"])
    pipe = cli.build_pipeline(ip)
    assert pipe.flux.ip_adapter and pipe.flux.weight_quant and pipe.vae_tiling == (72, 16)
    assert isinstance(pipe.flux.double_blocks[0].block.to_k_ip, QuantLinear)
