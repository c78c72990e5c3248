"""The FLUX IP-Adapter in the port against the JAX package's, on the CPU.

Tiny geometry (FLUX 2 + 4, CLIP vision 2 x 32 at 28², 2 ip tokens), float32,
random Flax trees carried into both sides (``to_v_ip`` nonzero, so the
adapter acts). Checks:

- ``preprocess_clip_image`` (the host code, copied) equal to JAX's;
- ``CLIPVisionEncoder``, ``ImageProjection`` and the whole image -> tokens
  path against JAX's;
- the double block's ip path (RoPE-free post-q-norm queries over the ip
  tokens, added after the FF residual) with a scalar and a per-request
  scale, and FLUX with ip tokens, against JAX's;
- the converters (``convert_clip_vision``, ``convert_ip_adapter``,
  ``merge_ip_adapter_into_flux``) leaf for leaf on the synthetic files;
- the pipeline with an image and without one (zero tokens at scale 0)
  against the JAX pipeline from the same ``latents=``; an untrained adapter
  is a no-op; the "blocks" layout equals the merged "flux" one;
- ``generate_batch`` with a request with and one without an image, each row
  against its own ``__call__``; SP over 2 thread ranks (ring and Ulysses)
  against one device;
- the server: an image request and a plain one coalesce and each equals its
  request alone;
- the CLI's ``--ip-adapter-image``/``--ip-adapter-scale``/``--ip-adapter-dir``
  and ``convert_cli --ip-adapter``/``--image-encoder-dir``.

Tolerances: TOL (5e-4) against JAX; a batch row or an SP result against its
one-device call within 2e-4 (sums in another order; the SP tests'); images
within 2 uint8 levels.
"""

import base64
import dataclasses
import io
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.conditioning import TextLine, build_conditions
from reptext_tpu.configs import (
    CLIPConfig, CLIPVisionConfig, ControlNetConfig, FluxConfig, IPAdapterConfig,
    PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu.io import convert as JC
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.models.ip_adapter import ImageProjection as JProj
from reptext_tpu.models.ip_adapter import IPAdapterEncoder as JEncoder
from reptext_tpu.nn.blocks import JointTransformerBlock as JBlock
from reptext_tpu.nn.clip import CLIPTextEncoder as JCLIP
from reptext_tpu.nn.clip_vision import CLIPVisionEncoder as JVision
from reptext_tpu.nn.clip_vision import preprocess_clip_image as j_preprocess
from reptext_tpu.nn.t5 import T5Encoder as JT5
from reptext_tpu.nn.vae import AutoencoderKL as JVAE
from reptext_tpu.ops.rope import rope_cos_sin_half as j_rope
from reptext_tpu.pipelines import FluxRepTextPipeline as JPipeline
from reptext_tpu_torch.io import checkpoint as tck
from reptext_tpu_torch.io import convert as TC
from reptext_tpu_torch.io import convert_cli as tcc
from reptext_tpu_torch.io import safetensors as tst
from reptext_tpu_torch.io import synthetic
from reptext_tpu_torch.io.from_jax import flatten_jax_params
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.models.ip_adapter import ImageProjection
from reptext_tpu_torch.nn.blocks import JointTransformerBlock
from reptext_tpu_torch.nn.clip_vision import CLIPVisionEncoder, preprocess_clip_image
from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

from torch_port_util import TOL, carried, np_tree, port_config, port_configs_of, random_tree, t

FLUX_CFG = FluxConfig().tiny()
VCFG = CLIPVisionConfig().tiny()
IPCFG = dataclasses.replace(IPAdapterConfig().tiny(), image_embed_dim=VCFG.projection_dim,
                            cross_attention_dim=FLUX_CFG.joint_attention_dim)
SIZE = 64
S_IMG = (SIZE // 16) ** 2
CFGS = dict(flux_cfg=FLUX_CFG, cn_cfg=ControlNetConfig().tiny(), vae_cfg=VAEConfig().tiny(),
            clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny())
PIPE_CFG = PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                          controlnet_conditioning_step=1, guidance_scale=3.5)
CLIP_IDS = np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32)
T5_IDS = np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32)
ROW_TOL = dict(rtol=2e-4, atol=2e-4)


def _image(seed=0, hw=(40, 52)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3)).astype(np.uint8)


def _vision_tree(seed=21):
    return random_tree(JVision(VCFG), jnp.zeros((1, VCFG.image_size, VCFG.image_size, 3)),
                       seed=seed)


def _proj_tree(seed=22):
    return random_tree(JProj(IPCFG), jnp.zeros((1, IPCFG.image_embed_dim)), seed=seed)


def _flux_inputs(b=2, seed=0, s_txt=4):
    r = np.random.default_rng(seed)
    ids = np.stack([np.zeros(S_IMG), np.arange(S_IMG) // 4, np.arange(S_IMG) % 4], -1)
    return dict(
        hidden_states=r.standard_normal((b, S_IMG, FLUX_CFG.in_channels)).astype(np.float32),
        encoder_hidden_states=r.standard_normal(
            (b, s_txt, FLUX_CFG.joint_attention_dim)).astype(np.float32),
        pooled_projections=r.standard_normal((b, FLUX_CFG.pooled_projection_dim)).astype(
            np.float32),
        timestep=np.full((b,), 0.5, np.float32),
        img_ids=ids.astype(np.float32),
        txt_ids=np.zeros((s_txt, 3), np.float32),
        guidance=np.full((b,), 3.5, np.float32),
    )


def _ip_flux_tree(seed=1):
    inp = _flux_inputs(b=1)
    return random_tree(JFlux(FLUX_CFG, ip_adapter=True), *(jnp.asarray(v) for v in inp.values()),
                       ip_tokens=jnp.zeros((1, IPCFG.num_tokens, IPCFG.cross_attention_dim)),
                       seed=seed)


# ------------------------------------------------------------- the modules


@pytest.mark.parametrize("hw", [(28, 28), (40, 52), (224, 224)])
def test_preprocess_clip_image_equals_jax(hw):
    img = _image(1, hw)
    np.testing.assert_array_equal(preprocess_clip_image(img, VCFG.image_size),
                                  j_preprocess(img, VCFG.image_size))
    batch = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(preprocess_clip_image(batch, 224), j_preprocess(batch, 224))


def test_clip_vision_encoder_matches_jax():
    tree = _vision_tree()
    pixels = j_preprocess(np.stack([_image(2), _image(3)]), VCFG.image_size)
    jx, jemb = JVision(VCFG).apply(tree, jnp.asarray(pixels))
    model = carried(CLIPVisionEncoder(port_config(VCFG)), tree)
    with torch.no_grad():
        tx, temb = model(torch.from_numpy(pixels))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **TOL)


def test_image_projection_and_encoder_match_jax():
    ptree, vtree = _proj_tree(), _vision_tree()
    emb = np.random.default_rng(4).standard_normal((3, IPCFG.image_embed_dim)).astype(np.float32)
    want = JProj(IPCFG).apply(ptree, jnp.asarray(emb))
    proj = carried(ImageProjection(port_config(IPCFG)), ptree)
    with torch.no_grad():
        np.testing.assert_allclose(proj(t(emb)).numpy(), np.asarray(want), **TOL)
    jenc = JEncoder(VCFG, IPCFG)
    want = jenc({"vision": vtree, "proj": ptree}, _image(5))
    from reptext_tpu_torch.models.ip_adapter import IPAdapterEncoder

    enc = IPAdapterEncoder(port_config(VCFG), port_config(IPCFG))
    carried(enc.vision, vtree)
    carried(enc.proj, ptree)
    with torch.no_grad():
        got = enc(_image(5))
    assert got.shape == (1, IPCFG.num_tokens, IPCFG.cross_attention_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [0.7, [0.3, 1.2]], ids=["scalar", "per-request"])
def test_double_block_ip_path_matches_jax(scale):
    dim, heads, head_dim, cross, b = 32, 2, 16, 24, 2
    r = np.random.default_rng(6)
    img = r.standard_normal((b, 8, dim)).astype(np.float32)
    txt = r.standard_normal((b, 3, dim)).astype(np.float32)
    temb = r.standard_normal((b, dim)).astype(np.float32)
    ipt = r.standard_normal((b, 2, cross)).astype(np.float32)
    ids = np.concatenate([np.zeros((3, 3)), np.stack([np.zeros(8), np.arange(8) // 4,
                                                      np.arange(8) % 4], -1)]).astype(np.float32)
    cos, sin = j_rope(jnp.asarray(ids), (4, 6, 6), 10000)
    jblock = JBlock(dim=dim, num_heads=heads, head_dim=head_dim, ip_adapter=True)
    tree = random_tree(jblock, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(temb), cos, sin,
                       jnp.asarray(ipt), jnp.asarray(0.5), seed=7)
    jt, ji = jblock.apply(tree, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(temb), cos, sin,
                          jnp.asarray(ipt), jnp.asarray(scale, jnp.float32))
    block = JointTransformerBlock(dim, heads, head_dim)
    block.add_ip_adapter(cross)
    block = carried(block, tree)
    with torch.no_grad():
        tt, ti = block(t(img), t(txt), t(temb), t(cos), t(sin), ip_tokens=t(ipt),
                       ip_scale=torch.tensor(scale))
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        # the text stream and a block given no tokens never see the adapter
        t0, i0 = block(t(img), t(txt), t(temb), t(cos), t(sin))
        np.testing.assert_array_equal(t0.numpy(), tt.numpy())
        assert not np.allclose(i0.numpy(), ti.numpy())


def test_flux_with_ip_tokens_matches_jax():
    tree = _ip_flux_tree()
    inp = _flux_inputs()
    ipt = np.random.default_rng(8).standard_normal(
        (2, IPCFG.num_tokens, IPCFG.cross_attention_dim)).astype(np.float32)
    scale = np.array([0.8, 0.0], np.float32)
    want = JFlux(FLUX_CFG, ip_adapter=True).apply(tree, *(jnp.asarray(v) for v in inp.values()),
                                                   ip_tokens=jnp.asarray(ipt),
                                                   ip_scale=jnp.asarray(scale))
    model = carried(FluxTransformer2D(port_config(FLUX_CFG)).add_ip_adapter(
        IPCFG.cross_attention_dim), tree)
    assert model.ip_adapter
    with torch.no_grad():
        got = model(*(t(v) for v in inp.values()), ip_tokens=t(ipt), ip_scale=t(scale))
        plain = model(*(t(v) for v in inp.values()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a request at scale 0 is the model without tokens, bit for bit
    np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())
    with pytest.raises(ValueError, match="without the IP-Adapter"):
        FluxTransformer2D(port_config(FLUX_CFG))(*(t(v) for v in inp.values()),
                                                  ip_tokens=t(ipt))


# -------------------------------------------------------------- converters


def _ip_state():
    return synthetic.ip_adapter_state(port_config(IPCFG), FLUX_CFG.num_layers, FLUX_CFG.inner_dim)


def _np(state):
    return {k: v.numpy() for k, v in state.items()}


def _assert_trees_equal(got, want):
    g, w = flatten_jax_params(got), flatten_jax_params(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_converters_match_jax_leaf_for_leaf():
    vstate = synthetic.clip_vision_state(port_config(VCFG))
    _assert_trees_equal(TC.convert_clip_vision(vstate, port_config(VCFG)),
                        JC.convert_clip_vision(_np(vstate), VCFG))
    ipstate = _ip_state()
    got = TC.convert_ip_adapter(ipstate, FLUX_CFG.num_layers, FLUX_CFG.attention_head_dim)
    want = JC.convert_ip_adapter(_np(ipstate), FLUX_CFG.num_layers, FLUX_CFG.attention_head_dim)
    _assert_trees_equal(got["proj"], want["proj"])
    _assert_trees_equal({"params": {"double_blocks": {"block": got["blocks"]}}},
                        {"params": {"double_blocks": {"block": want["blocks"]}}})
    fstate = synthetic.flux_state(port_config(FLUX_CFG))
    tflux = TC.convert_flux_transformer(fstate, port_config(FLUX_CFG))
    jflux = JC.convert_flux_transformer(_np(fstate), FLUX_CFG)
    merged = TC.merge_ip_adapter_into_flux(tflux, got["blocks"])
    _assert_trees_equal(merged, JC.merge_ip_adapter_into_flux(jflux, want["blocks"]))
    assert "to_k_ip" not in tflux["params"]["double_blocks"]["block"]   # only paths copied
    model = carried(FluxTransformer2D(port_config(FLUX_CFG)).add_ip_adapter(
        IPCFG.cross_attention_dim), merged)
    assert model.ip_adapter


# ---------------------------------------------------------------- pipeline


def _pipeline_params():
    f, v = FLUX_CFG, CFGS["vae_cfg"]
    z = jnp.zeros
    img_ids, txt_ids, g = z((S_IMG, 3)), z((4, 3)), jnp.ones((1,))
    cn = CFGS["cn_cfg"]
    params = {
        "flux": random_tree(JFlux(f), z((1, S_IMG, f.in_channels)),
                            z((1, 4, f.joint_attention_dim)), z((1, f.pooled_projection_dim)),
                            z((1,)), img_ids, txt_ids, g, seed=1),
        "controlnet": random_tree(JControlNet(cn), z((1, S_IMG, cn.in_channels)),
                                  z((1, S_IMG, cn.in_channels + cn.extra_condition_channels)),
                                  z((1, 4, cn.joint_attention_dim)),
                                  z((1, cn.pooled_projection_dim)), z((1,)), img_ids, txt_ids, g,
                                  seed=2),
        "vae": random_tree(JVAE(v), z((1, 64, 64, 3)), seed=3),
        "clip": random_tree(JCLIP(CFGS["clip_cfg"]), z((1, 16), jnp.int32), seed=4),
        "t5": random_tree(JT5(CFGS["t5_cfg"]), z((1, 16), jnp.int32), seed=5),
    }
    conv_out = params["vae"]["params"]["encoder"]["conv_out"]
    conv_out["kernel"][..., v.latent_channels:] = 0.0     # the posterior draw drops out
    conv_out["bias"][v.latent_channels:] = -30.0
    # the adapter: the base's weights plus random to_k_ip / to_v_ip
    ip_flux = np_tree(_ip_flux_tree(seed=9))
    base = ip_flux["params"]["double_blocks"]["block"]
    ip_blocks = {k: base[k] for k in ("to_k_ip", "to_v_ip")}
    params["ip"] = {"vision": _vision_tree(), "proj": _proj_tree(),
                    "flux": JC.merge_ip_adapter_into_flux(params["flux"], ip_blocks),
                    "blocks": ip_blocks}
    return params


@pytest.fixture(scope="module")
def pipes():
    params = _pipeline_params()
    base = {k: v for k, v in params.items() if k != "ip"}
    ip = params["ip"]
    # (a copy: the JAX attach replaces the dict's "flux" entry)
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=dict(base), **CFGS)
    jpipe.attach_ip_adapter(VCFG, IPCFG, params={k: ip[k] for k in ("vision", "proj", "flux")})
    tpipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=base,
                                       device="cpu", **port_configs_of(CFGS))
    plain = tpipe.with_config(tpipe.pipe_cfg)        # made before the adapter: none
    tpipe.attach_ip_adapter(port_config(VCFG), port_config(IPCFG),
                            params={k: ip[k] for k in ("vision", "proj", "flux")})
    cond = build_conditions([TextLine("مرحبا", (8, 20), font_size=24)], SIZE, SIZE,
                            font_size=24)
    noise = np.random.default_rng(7).standard_normal((1, S_IMG, 64)).astype(np.float32)
    return dict(jpipe=jpipe, tpipe=tpipe, plain=plain, cond=cond, noise=noise, params=params)


def _call(pipe, p, **kw):
    return pipe(p["cond"], clip_ids=CLIP_IDS, t5_ids=T5_IDS, latents=t(p["noise"]),
                output_type="latent", **kw)


def _jcall(p, **kw):
    return np.asarray(p["jpipe"](p["cond"], clip_ids=jnp.asarray(CLIP_IDS),
                                 t5_ids=jnp.asarray(T5_IDS), latents=jnp.asarray(p["noise"]),
                                 output_type="latent", **kw))


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "no-image"])
def test_pipeline_matches_jax(pipes, with_image):
    kw = dict(ip_adapter_image=_image(11), ip_adapter_scale=0.8) if with_image else {}
    got = _call(pipes["tpipe"], pipes, **kw)
    np.testing.assert_allclose(got.numpy(), _jcall(pipes, **kw), **TOL)
    plain = _call(pipes["plain"], pipes)
    # no image: zero tokens at scale 0 give the pipeline without the adapter
    assert torch.equal(got, plain) != with_image
    with pytest.raises(ValueError, match="no adapter attached"):
        _call(pipes["plain"], pipes, ip_adapter_image=_image(11))


def test_fp8_stored_stacks_take_the_adapter_as_the_jax_pipeline_does(pipes):
    """Stacks stored in fp8 (``quantize_params`` trees, as a ``--dtype fp8``
    checkpoint holds them), then the adapter's dense kernels attached, then
    ``quantize_weights()``: the JAX pipeline's order, whose quantize_params
    quantizes only what is still dense. Against the JAX pipeline (TOL), and
    bit-equal to the dense stacks with the adapter attached, then quantized."""
    from reptext_tpu.io.quantize import quantize_params

    p = pipes
    base = {k: v for k, v in p["params"].items() if k != "ip"}
    stored = dict(base, **{n: {"params": quantize_params(base[n]["params"])}
                           for n in ("flux", "controlnet")})
    adapter = {k: p["params"]["ip"][k] for k in ("vision", "proj", "blocks")}
    jpipe = JPipeline.create(pipe_cfg=PIPE_CFG, params=dict(stored), **CFGS)
    jpipe.attach_ip_adapter(VCFG, IPCFG, params=dict(adapter))
    jpipe.quantize_weights()
    pipes_t = {}
    for name, params in (("stored", stored), ("dense", base)):
        pipe = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=params,
                                          device="cpu", **port_configs_of(CFGS))
        assert pipe.flux.weight_quant == (name == "stored")
        pipe.attach_ip_adapter(port_config(VCFG), port_config(IPCFG), params=dict(adapter))
        pipes_t[name] = pipe.quantize_weights()
    stored_t, dense_t = pipes_t["stored"], pipes_t["dense"]
    block = stored_t.flux.double_blocks[0].block
    assert type(block.to_k_ip).__name__ == "QuantLinear"
    for a, b in ((stored_t.flux, dense_t.flux), (stored_t.controlnet, dense_t.controlnet)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(
                sa[k].view(torch.uint8) if sa[k].element_size() == 1 else sa[k],
                sb[k].view(torch.uint8) if sb[k].element_size() == 1 else sb[k]), k
    kw = dict(ip_adapter_image=_image(11), ip_adapter_scale=0.8)
    got = _call(stored_t, p, **kw)
    assert torch.equal(got, _call(dense_t, p, **kw))
    want = np.asarray(jpipe(p["cond"], clip_ids=jnp.asarray(CLIP_IDS), t5_ids=jnp.asarray(T5_IDS),
                            latents=jnp.asarray(p["noise"]), output_type="latent", **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the adapter acts: scale 0 gives another result
    assert not torch.equal(got, _call(stored_t, p, ip_adapter_image=_image(11),
                                      ip_adapter_scale=0.0))
    # after quantize_weights() the stacks take no dense layer, as in JAX
    with pytest.raises(ValueError, match="BEFORE quantize_weights"):
        stored_t.attach_ip_adapter(port_config(VCFG), port_config(IPCFG))
    with pytest.raises(ValueError, match="BEFORE quantize_weights"):
        jpipe.attach_ip_adapter(VCFG, IPCFG)


def test_untrained_adapter_is_a_no_op_and_the_blocks_layout_is_the_flux_one(pipes):
    p = pipes
    base = {k: v for k, v in p["params"].items() if k != "ip"}
    fresh = FluxRepTextPipeline.create(pipe_cfg=port_config(PIPE_CFG), params=base,
                                       device="cpu", **port_configs_of(CFGS))
    want = _call(fresh, p)
    fresh.attach_ip_adapter(port_config(VCFG), port_config(IPCFG), seed=3)
    assert all(not bool(prm.any()) for n, prm in fresh.flux.named_parameters() if "to_v_ip" in n)
    assert torch.equal(_call(fresh, p, ip_adapter_image=_image(12), ip_adapter_scale=1.0), want)
    # the converter's standalone stacked blocks merged into the resident FLUX
    fresh.attach_ip_adapter(port_config(VCFG), port_config(IPCFG),
                            params={k: p["params"]["ip"][k] for k in ("vision", "proj", "blocks")})
    torch.testing.assert_close(_call(fresh, p, ip_adapter_image=_image(11), ip_adapter_scale=0.8),
                               _call(p["tpipe"], p, ip_adapter_image=_image(11),
                                     ip_adapter_scale=0.8), rtol=0, atol=0)


def test_generate_batch_mixed_requests_match_their_calls(pipes):
    tpipe, cond = pipes["tpipe"], pipes["cond"]
    ids = dict(clip_ids=np.concatenate([CLIP_IDS, CLIP_IDS]),
               t5_ids=np.concatenate([T5_IDS, T5_IDS]))
    img = _image(13)
    rows = tpipe.generate_batch([cond, cond], seeds=[4, 5], output_type="latent",
                                ip_adapter_images=[img, None], ip_adapter_scales=[0.6, 0.9],
                                **ids)
    one = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, seed=4, output_type="latent",
                ip_adapter_image=img, ip_adapter_scale=0.6)
    two = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, seed=5, output_type="latent")
    np.testing.assert_allclose(rows[0:1].numpy(), one.numpy(), **ROW_TOL)
    np.testing.assert_allclose(rows[1:2].numpy(), two.numpy(), **ROW_TOL)
    with pytest.raises(ValueError, match="no adapter attached"):
        pipes["plain"].generate_batch([cond], seeds=[4], output_type="latent",
                                      ip_adapter_images=[img], clip_ids=CLIP_IDS,
                                      t5_ids=T5_IDS)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_sp_with_ip_tokens_matches_one_device(pipes, backend):
    tpipe = pipes["tpipe"]
    kw = dict(ip_adapter_image=_image(14), ip_adapter_scale=0.7)
    want = _call(tpipe, pipes, **kw)
    outs = run_spmd(LocalSPGroup(2), lambda g: _call(
        tpipe.with_config(tpipe.pipe_cfg).shard_for_sp(g, backend), pipes, **kw))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), **ROW_TOL)


# ------------------------------------------------------------ server, CLI


def _png_b64(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_server_coalesces_image_prompts_with_plain_requests(pipes):
    from reptext_tpu_torch.serving import GenerationRequest, GenerationWorker
    from reptext_tpu_torch.utils.metrics import Metrics

    tpipe = pipes["tpipe"]
    lines = [{"text": "مرحبا", "position": [8, 20], "font_size": 24}]

    def tok(prompt):
        return CLIP_IDS, T5_IDS

    worker = GenerationWorker(tpipe, tokenizer=tok, max_batch=4, metrics=Metrics())
    img = _image(15, (32, 32))
    r1 = GenerationRequest(prompt="a", lines=lines, seed=3, num_steps=2,
                           ip_image_b64=_png_b64(img), ip_scale=0.8)
    r2 = GenerationRequest(prompt="b", lines=lines, seed=9, num_steps=2)
    worker.submit(r1)
    worker.submit(r2)
    assert worker._process_once() == 2
    assert not r1._error and not r2._error, (r1._error, r2._error)
    cond = build_conditions([TextLine("مرحبا", (8, 20), font_size=24)], SIZE, SIZE)
    alone1 = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, seed=3, num_inference_steps=2,
                   ip_adapter_image=img, ip_adapter_scale=0.8)[0]
    alone2 = tpipe(cond, clip_ids=CLIP_IDS, t5_ids=T5_IDS, seed=9, num_inference_steps=2)[0]
    assert np.abs(r1._result.astype(int) - alone1.astype(int)).max() <= 2
    assert np.abs(r2._result.astype(int) - alone2.astype(int)).max() <= 2
    r3 = GenerationRequest(prompt="c", lines=lines, seed=3, num_steps=2,
                           ip_image_b64=_png_b64(img), ip_scale=0.8)
    worker.submit(r3)
    assert worker._process_once() == 1 and not r3._error
    np.testing.assert_array_equal(r3._result, alone1)


def _write_adapter_files(root):
    """A tiny CLIP vision snapshot and an IP-Adapter file for the tiny FLUX."""
    vdir = root / "image_encoder"
    synthetic.write_component(str(vdir), synthetic.clip_vision_state(port_config(VCFG)),
                              synthetic.clip_vision_hf_config(port_config(VCFG)))
    ip_path = str(root / "ip-adapter.safetensors")
    tst.save_file(_ip_state(), ip_path)
    return str(vdir), ip_path


def _write_flux_snapshot(path):
    """The tiny FLUX as a transformer snapshot (its config.json records no
    time_embed_dim: the converter takes the default)."""
    cfg = port_config(dataclasses.replace(FLUX_CFG, time_embed_dim=FluxConfig().time_embed_dim))
    synthetic.write_component(str(path), synthetic.flux_state(cfg), synthetic.hf_config(cfg))


def test_convert_cli_writes_the_adapter_directory(tmp_path):
    vdir, ip_path = _write_adapter_files(tmp_path)
    flux_dir = tmp_path / "transformer"
    _write_flux_snapshot(flux_dir)
    out = tmp_path / "out"
    assert tcc.main(["--flux-dir", str(flux_dir), "--ip-adapter", ip_path,
                     "--image-encoder-dir", vdir, "--out", str(out)]) == 0
    ip_dir = out / "ip_adapter"
    saved = tck.load_saved_configs(str(ip_dir))
    assert saved["clip_vision"] == port_config(VCFG)
    assert saved["ip_adapter"] == port_config(IPCFG)
    files = tck.load_pipeline_params(str(ip_dir), ("vision", "proj", "blocks"))
    want = JC.convert_ip_adapter(_np(_ip_state()), FLUX_CFG.num_layers,
                                 FLUX_CFG.attention_head_dim)
    for name, tree in (("proj", want["proj"]),
                       ("blocks", {"double_blocks": {"block": want["blocks"]}}),
                       ("vision", JC.convert_clip_vision(
                           _np(synthetic.clip_vision_state(port_config(VCFG))), VCFG))):
        flat = flatten_jax_params(tree)
        assert sorted(files[name]) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(files[name][k].numpy(), np.asarray(flat[k]), err_msg=k)


def test_cli_ip_adapter_flags(tmp_path):
    from PIL import Image

    from reptext_tpu_torch import cli

    style = tmp_path / "style.png"
    Image.fromarray(_image(16)).save(style)
    base = ["--text", "Hi", "--position", "8", "16", "--size", "64", "--steps", "2",
            "--controlnet-step", "1", "--random-weights", "--tiny", "--device", "cpu",
            "--font-size", "24"]
    outs = {}
    for name, extra in (("plain", []), ("untrained", ["--ip-adapter-image", str(style)])):
        outs[name] = tmp_path / f"{name}.png"
        assert cli.main(base + extra + ["--output", str(outs[name])]) == 0
    # an untrained adapter (zero to_v_ip) adds nothing
    np.testing.assert_array_equal(np.asarray(Image.open(outs["plain"])),
                                  np.asarray(Image.open(outs["untrained"])))
    # --ip-adapter-dir: the converter's directory, weights and geometry
    vdir, ip_path = _write_adapter_files(tmp_path)
    flux_dir = tmp_path / "transformer"
    _write_flux_snapshot(flux_dir)
    assert tcc.main(["--flux-dir", str(flux_dir), "--ip-adapter", ip_path,
                     "--image-encoder-dir", vdir, "--out", str(tmp_path / "conv")]) == 0
    ip_dir = str(tmp_path / "conv" / "ip_adapter")
    args = cli.build_parser().parse_args(base + ["--ip-adapter-image", str(style),
                                                 "--ip-adapter-dir", ip_dir,
                                                 "--ip-adapter-scale", "0.5"])
    pipe = cli.build_pipeline(args)
    files = tck.load_pipeline_params(ip_dir, ("vision", "proj", "blocks"))
    weights = dict(pipe.flux.named_parameters())
    assert all(torch.equal(weights[k], v) for k, v in files["blocks"].items())
    venc = dict(pipe.ip_encoder.vision.named_parameters())
    assert all(torch.equal(venc[k], v) for k, v in files["vision"].items())
    assert pipe.ip_encoder.ip_cfg == port_config(IPCFG)
    cond = build_conditions([TextLine("Hi", (8, 16), font_size=24)], SIZE, SIZE, font_size=24)
    a = cli.generate(args, pipe, cond, output_type="latent")
    args.ip_adapter_scale = 0.0
    b = cli.generate(args, pipe, cond, output_type="latent")
    assert not torch.equal(a, b) and torch.isfinite(a).all()
    # the server is built with the adapter when --ip-adapter-dir is given
    serve = cli.build_parser().parse_args(base[:-2] + ["--mode", "serve", "--ip-adapter-dir",
                                                       ip_dir, "--port", "0"])
    server = cli.build_server(serve)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert server.worker.pipeline.ip_encoder is not None
    finally:
        server.shutdown()
        thread.join(timeout=30)
