"""The port's tensor and data parallelism (``parallel/mesh.py``,
``parallel/partition.py``) against the JAX package, on the CPU in float32 at
tiny geometry (4 heads, inner 128, MLP 512).

The port's ranks run as threads of one process (``make_mesh(threads=n)``,
``parallel/testing.py::run_spmd``), or as gloo processes under torchrun for
the CLI; JAX runs unsharded (its sharded results equal those, as
``tests/mesh_scenarios.py`` checks). The same numpy weights reach both sides
through ``load_jax_params``. Tolerances: the port's parity limit TOL (5e-4)
for the modules, the JAX ``check_pipeline_tp_inference``'s 2e-4 for the
pipelines' latents, and ``check_sharded_cn_train_step``'s (loss rtol 2e-5,
every parameter within 2e-5 after one SGD 1e-3 step) for training.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reptext_tpu.configs import ControlNetConfig, FluxConfig
from reptext_tpu.models.controlnet import RepTextControlNet as JControlNet
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.ops.latents import prepare_latent_image_ids as j_img_ids
from reptext_tpu.parallel.mesh import make_mesh as j_make_mesh
from reptext_tpu.parallel.partition import _spec_for_kernel
from reptext_tpu.pipelines import FluxRepTextInpaintPipeline as JInpaint
from reptext_tpu.sampling import train_controlnet as jtrain
from reptext_tpu_torch import cli
from reptext_tpu_torch.io.from_jax import flatten_jax_params, flax_leaf_kinds
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.models.multi_controlnet import ControlNetEntry, MultiControlNet
from reptext_tpu_torch.nn import blocks as tblocks
from reptext_tpu_torch.parallel.mesh import make_mesh
from reptext_tpu_torch.parallel.partition import (
    ColumnParallelLinear, QuantColumnParallelLinear, QuantRowParallelLinear, RowParallelLinear,
    ShardedOptimizerState, ShardedState, param_shardings, shard_batch, shard_module,
)
from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd
from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
from reptext_tpu_torch.sampling import train_controlnet as ttrain
from reptext_tpu_torch.sampling.elastic import ElasticTrainer
from reptext_tpu_torch.serving import GenerationServer, follow

import test_torch_parallel as tpar
import test_torch_sp_surface as sps
from test_torch_ip_adapter import IPCFG, _flux_inputs, _ip_flux_tree
from torch_port_util import TOL, carried, np_tree, port_config, port_configs_of, random_tree, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FluxConfig().tiny()
CN_CFG = ControlNetConfig().tiny()
UNION_CFG = dataclasses.replace(CN_CFG, num_mode=4)
MESHES = [(1, 2), (1, 4), (2, 2)]
LAT_TOL = dict(rtol=2e-4, atol=2e-4)
S_IMG, S_TXT = 16, 4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (each thread rank computes on its own): the tiny
    models run as thousands of small ops, which the test tier's workers,
    sharing the host's cores, slow by orders of magnitude with a pool of
    threads each; the thread count is put back after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_ids(meshes=MESHES):
    return [f"{dp}x{tp}" for dp, tp in meshes]


def on_mesh(dp, tp, fn):
    """``fn(mesh)`` on every rank of a dp x tp thread mesh; rank 0's result,
    after checking every rank's equals it."""
    outs = run_spmd(make_mesh(dp, tp, device="cpu", threads=dp * tp), fn)
    for out in outs[1:]:
        if isinstance(out, torch.Tensor):
            torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    return outs[0]


# ------------------------------------------------------------------ the rules

def _meta(kind):
    cfg, ccfg, ucfg = port_config(CFG), port_config(CN_CFG), port_config(UNION_CFG)
    build = {
        "flux": lambda: FluxTransformer2D(cfg, device="meta"),
        "controlnet": lambda: RepTextControlNet(ccfg, device="meta"),
        "union": lambda: RepTextControlNet(ucfg, device="meta"),
        "flux_fp8": lambda: FluxTransformer2D(cfg, device="meta", weight_quant=True),
        "controlnet_fp8": lambda: RepTextControlNet(ccfg, device="meta", weight_quant=True),
        "flux_ip": lambda: FluxTransformer2D(cfg, device="meta").add_ip_adapter(32),
    }
    return build[kind]()


def _jax_dim(path, ndim):
    """The torch dim of a kernel that the JAX rule marks "tp" ([.., in, out]
    -> [out, in]), or None."""
    spec = tuple(_spec_for_kernel(path, ndim))
    if "tp" not in spec:
        return None
    return {ndim - 1: 0, ndim - 2: 1}[spec.index("tp")]


@pytest.mark.parametrize("kind", ["flux", "controlnet", "union", "flux_fp8", "controlnet_fp8",
                                  "flux_ip"])
def test_split_dims_are_the_jax_rules(kind):
    """Every parameter of the tiny trees: the port's split dim is what
    ``_spec_for_kernel`` marks "tp" on its Flax path, through the kernel
    transpose. fp8 leaves (which JAX replicates: its rules match ``kernel``
    alone) split as the dense kernel they store; the scales with a column
    layer's rows. ``to_k_ip``/``to_v_ip`` stay whole."""
    model = _meta(kind)
    dims = param_shardings(model)
    kinds = flax_leaf_kinds(model)
    assert set(dims) == {n for n, _ in model.named_parameters()}
    split = 0
    for name, p in model.named_parameters():
        parts = [x for x in name.split(".") if not x.isdigit()]
        leaf = parts[-1]
        stacked = parts[0] in ("double_blocks", "single_blocks")
        ndim = p.ndim + stacked
        flax_leaf = {"weight": kinds[name]}.get(leaf, leaf)
        path = "/params/" + "/".join(parts[:-1] + [flax_leaf])
        if leaf in ("kernel_q8", "kernel_scale"):
            assert tuple(_spec_for_kernel(path, ndim)) == (), path
            dense = _jax_dim("/params/" + "/".join(parts[:-1] + ["kernel"]), ndim)
            want = dense if leaf == "kernel_q8" else (0 if dense == 0 else None)
        else:
            want = _jax_dim(path, ndim)
        assert dims[name] == want, (name, path)
        split += want is not None
        if "_ip" in name:
            assert want is None
    # dense: q/k/v, add_q/k/v, to_out, to_add_out and both FFs' two a double
    # block, q/k/v, proj_mlp and proj_out a single one; fp8 adds the scales
    # of the column layers (8 and 4)
    d, s = len(model.double_blocks), len(model.single_blocks)
    assert split == 12 * d + 5 * s + (8 * d + 4 * s if "fp8" in kind else 0)


# ------------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n,dp,tp", [(8, None, None), (8, 2, None), (8, None, 4), (8, 2, 4),
                                     (4, 1, 4), (4, 4, 1), (8, 3, None), (8, None, 3),
                                     (8, 2, 2), (4, 8, None)])
def test_make_mesh_factors_as_jax(n, dp, tp):
    """make_mesh's defaults, filled-in factor, errors and layout: those of
    the JAX make_mesh over n devices."""
    try:
        jmesh = j_make_mesh(dp, tp, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("*", "\\*")):
            make_mesh(dp, tp, device="cpu", threads=n)
        return
    local = make_mesh(dp, tp, device="cpu", threads=n)
    assert (local.dp, local.tp) == jmesh.devices.shape
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(n):
        m = local.member(r)
        assert tuple(np.argwhere(ids == jax.devices()[r].id)[0]) == (m.dp_rank, m.tp_rank)
        assert (m.tp_group.size, m.dp_group.size, m.world.size) == (local.tp, local.dp, n)
        assert (m.tp_group.rank, m.dp_group.rank, m.world.rank) == (m.tp_rank, m.dp_rank, r)


def test_group_collectives_sum_and_broadcast():
    """all_reduce_sum is a true sum, equal on every rank; broadcast_object
    gives rank 0's object."""
    def rank(g):
        x = torch.full((3,), 0.1) * (g.rank + 1)
        return g.all_reduce_sum(x), g.broadcast_object({"from": g.rank})

    outs = run_spmd(LocalSPGroup(3), rank)
    for total, obj in outs:
        torch.testing.assert_close(total, torch.full((3,), 0.1) + 0.2 + 0.3, rtol=0, atol=0)
        assert obj == {"from": 0}


# ------------------------------------------------------------------ the models

def _union_tree():
    i = tpar._inputs(1)
    cond = np.zeros((1, S_IMG, UNION_CFG.in_channels + UNION_CFG.extra_condition_channels),
                    np.float32)
    return random_tree(JControlNet(UNION_CFG), i["hidden_states"], cond,
                       i["encoder_hidden_states"], i["pooled_projections"], i["timestep"],
                       i["img_ids"], i["txt_ids"], i["guidance"], mode=jnp.zeros((1,), jnp.int32),
                       seed=4)


@functools.lru_cache(maxsize=None)
def _jax_outputs(kind):
    i = tpar._inputs()
    j = {k: jnp.asarray(v) for k, v in i.items()}
    if kind == "flux":
        blocks, singles = (jnp.asarray(s) for s in tpar._stacks())
        out = JFlux(CFG).apply(tpar._flux_tree(), **j, controlnet_block_samples=blocks,
                               controlnet_single_block_samples=singles)
        return (np.asarray(out),)
    cfg, tree = (CN_CFG, tpar._cn_tree()) if kind == "controlnet" else (UNION_CFG, _union_tree())
    kw = {"mode": jnp.asarray([1, 3])} if kind == "union" else {}
    out = JControlNet(cfg).apply(tree, j["hidden_states"], _cond(cfg), j["encoder_hidden_states"],
                                 j["pooled_projections"], j["timestep"], j["img_ids"],
                                 j["txt_ids"], j["guidance"], conditioning_scale=0.7, **kw)
    return tuple(np.asarray(o) for o in out)


def _cond(cfg):
    return np.random.default_rng(5).standard_normal(
        (2, S_IMG, cfg.in_channels + cfg.extra_condition_channels)).astype(np.float32)


def _port_model(kind):
    if kind == "flux":
        return tpar._port(FluxTransformer2D, CFG, tpar._flux_tree())
    if kind == "controlnet":
        return tpar._port(RepTextControlNet, CN_CFG, tpar._cn_tree())
    return carried(RepTextControlNet(port_config(UNION_CFG)), _union_tree())


def _call(kind, model):
    i = {k: t(v) for k, v in tpar._inputs().items()}
    if kind == "flux":
        blocks, singles = (t(s) for s in tpar._stacks())
        return (model(**i, controlnet_block_samples=blocks,
                      controlnet_single_block_samples=singles),)
    cfg = CN_CFG if kind == "controlnet" else UNION_CFG
    kw = {"mode": torch.tensor([1, 3])} if kind == "union" else {}
    return model(i["hidden_states"], t(_cond(cfg)), i["encoder_hidden_states"],
                 i["pooled_projections"], i["timestep"], i["img_ids"], i["txt_ids"],
                 i["guidance"], 0.7, **kw)


@pytest.mark.parametrize("dp,tp", MESHES, ids=_mesh_ids())
@pytest.mark.parametrize("kind", ["flux", "controlnet", "union"])
def test_tensor_parallel_models_match_jax(kind, dp, tp):
    """FLUX (with ControlNet residual stacks), the ControlNet and a union
    ControlNet (a mode per row) as each rank's shard_module copy: every rank
    returns the whole output, the unsharded JAX module's."""
    model = _port_model(kind)

    def rank(mesh):
        with torch.no_grad():
            return _call(kind, shard_module(model, mesh))

    outs = run_spmd(make_mesh(dp, tp, device="cpu", threads=dp * tp), rank)
    want = _jax_outputs(kind)
    for got in outs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_single_block_proj_out_takes_two_row_slices():
    """Rank r's proj_out rows are its heads' attention rows and its MLP
    rows: two slices of the input features, not one."""
    model = _port_model("flux")
    inner, mlp = CFG.num_attention_heads * CFG.attention_head_dim, int(CFG.inner_dim * 4)
    w = model.single_blocks[1].block.proj_out.weight

    def rank(mesh):
        block = shard_module(model, mesh).single_blocks[1].block
        return block.num_heads, type(block.proj_out), block.proj_out.weight, block.proj_mlp.weight

    for r, (heads, cls, got, mlp_w) in enumerate(run_spmd(
            make_mesh(1, 2, device="cpu", threads=2), rank)):
        assert heads == CFG.num_attention_heads // 2 and cls is RowParallelLinear
        want = torch.cat([w[:, r * inner // 2:(r + 1) * inner // 2],
                          w[:, inner + r * mlp // 2:inner + (r + 1) * mlp // 2]], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            mlp_w, model.single_blocks[1].block.proj_mlp.weight[r * mlp // 2:(r + 1) * mlp // 2],
            rtol=0, atol=0)


def test_ip_path_at_tp2_matches_jax():
    """The IP-Adapter's path at tp = 2: k_ip/v_ip (whole projections) cut to
    the rank's heads, the output gathered over tp; per-request scales."""
    tree = _ip_flux_tree()
    inp = _flux_inputs()
    ipt = np.random.default_rng(8).standard_normal(
        (2, IPCFG.num_tokens, IPCFG.cross_attention_dim)).astype(np.float32)
    scale = np.array([0.8, 0.3], np.float32)
    want = JFlux(CFG, ip_adapter=True).apply(tree, *(jnp.asarray(v) for v in inp.values()),
                                             ip_tokens=jnp.asarray(ipt),
                                             ip_scale=jnp.asarray(scale))
    model = carried(FluxTransformer2D(port_config(CFG)).add_ip_adapter(
        IPCFG.cross_attention_dim), tree)

    def rank(mesh):
        sharded = shard_module(model, mesh)
        ip = sharded.double_blocks[0].block.to_k_ip
        assert ip.weight is model.double_blocks[0].block.to_k_ip.weight   # whole, shared
        with torch.no_grad():
            return sharded(*(t(v) for v in inp.values()), ip_tokens=t(ipt), ip_scale=t(scale))

    got = on_mesh(1, 2, rank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layers", "fp8_layers"])
def test_shard_module_layers_and_refusals(quant):
    """The copy's layer types (fp8 ones too) and its biases, whole; the
    original untouched; a MultiControlNet shards each net; tp = 3 on 4 heads
    is refused."""
    model = _port_model("flux")
    if quant:
        from reptext_tpu_torch.models.flux import quantized_copy
        model = quantized_copy(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    col, row = ((QuantColumnParallelLinear, QuantRowParallelLinear) if quant
                else (ColumnParallelLinear, RowParallelLinear))

    def rank(mesh):
        sharded = shard_module(model, mesh)
        block = sharded.double_blocks[0].block
        assert type(block.to_q) is col and type(block.ff.out_proj) is row
        assert block.to_q.bias.shape == model.double_blocks[0].block.to_q.bias.shape
        assert sharded.x_embedder.weight is model.x_embedder.weight
        assert sharded.norm_out.linear.weight is model.norm_out.linear.weight
        assert shard_module(sharded, mesh) is sharded
        return sharded

    run_spmd(make_mesh(1, 2, device="cpu", threads=2), rank)
    assert model.double_blocks[0].block.num_heads == CFG.num_attention_heads
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="tp=3"):
        shard_module(model, make_mesh(1, 3, device="cpu", threads=3).member(0))
    cn = _port_model("controlnet")
    multi = MultiControlNet([ControlNetEntry(cn), ControlNetEntry(cn, 0.5)], CFG.num_layers,
                            CFG.num_single_layers)
    nets = run_spmd(make_mesh(1, 2, device="cpu", threads=2),
                    lambda mesh: shard_module(multi, mesh).entries)
    assert all(e.model.tp_sharded == (r, 2) for r, es in enumerate(nets) for e in es)


# ------------------------------------------------------------------ pipelines

@pytest.fixture(scope="module")
def txt2img():
    params = tpar._pipeline_params()
    return tpar.JPipeline.create(pipe_cfg=tpar.PIPE_CFG, params=params, **tpar.CFGS), \
        tpar.FluxRepTextPipeline.create(pipe_cfg=port_config(tpar.PIPE_CFG), params=params,
                                        device="cpu", **port_configs_of(tpar.CFGS))


def _txt2img_kw(noise, jax_side=False):
    kw = dict(clip_ids=tpar.CLIP_IDS, t5_ids=tpar.T5_IDS, latents=noise, output_type="latent")
    if jax_side:
        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return kw


@pytest.mark.parametrize("images", [1, 2])
@pytest.mark.parametrize("dp,tp", MESHES, ids=_mesh_ids())
def test_txt2img_shard_for_inference_matches_jax(txt2img, dp, tp, images):
    """64^2, 2 steps (check_pipeline_tp_inference's setup), 1 and 2 images
    (at dp = 2 the 2 images split over dp), from the same packed noise,
    against the JAX pipeline."""
    jpipe, tpipe = txt2img
    cond = tpar.build_conditions([tpar.TextLine("Hi", (8, 16), font_size=24)], 64, 64)
    noise = np.random.default_rng(7).standard_normal(
        (images, tpar.PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    want = np.asarray(jpipe(cond, num_images=images, **_txt2img_kw(jnp.asarray(noise), True)))
    got = on_mesh(dp, tp, lambda mesh: tpipe.with_config(tpipe.pipe_cfg).shard_for_inference(
        mesh)(cond, num_images=images, **_txt2img_kw(t(noise))))
    np.testing.assert_allclose(got.numpy(), want, **LAT_TOL)


@pytest.fixture(scope="module")
def inpaint():
    params = sps._params()
    tpipe = tpar.FluxRepTextPipeline.create(
        pipe_cfg=port_config(sps.PIPE_CFG), device="cpu", **port_configs_of(sps.CFGS),
        params={k: v for k, v in params.items() if k != "inpaint_controlnet"})
    tinp = FluxRepTextInpaintPipeline.from_pipeline(
        tpipe, port_config(sps.INP_CFG), params=params["inpaint_controlnet"])
    jinp = JInpaint.create_inpaint(inpaint_cn_cfg=sps.INP_CFG, pipe_cfg=sps.PIPE_CFG,
                                   params=params, **sps.CFGS)
    r = np.random.default_rng(9)
    image = r.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[8:40, 4:60] = 255
    noise = r.standard_normal((1, sps.PIPE_CFG.image_seq_len, 64)).astype(np.float32)
    cond = sps.build_conditions([sps.TextLine("Hi", (8, 16), font_size=24)], 64, 64)
    return dict(jinp=jinp, tinp=tinp, image=image, mask=mask, noise=noise, cond=cond)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)], ids=_mesh_ids([(2, 1), (1, 2),
                                                                          (2, 2)]))
def test_inpaint_shard_for_inference_matches_jax(inpaint, dp, tp):
    """The dual-ControlNet true-CFG pipeline: at dp = 2 the CFG batch of 2
    splits into its halves; at tp = 2 all three models are sharded."""
    p = inpaint
    want = np.asarray(p["jinp"](p["cond"], image=p["image"], mask=p["mask"],
                                latents=jnp.asarray(p["noise"]), output_type="latent",
                                **{k: jnp.asarray(v) for k, v in sps.IDS.items()}))
    got = on_mesh(dp, tp, lambda mesh: p["tinp"].with_config(p["tinp"].pipe_cfg)
                  .shard_for_inference(mesh)(p["cond"], image=p["image"], mask=p["mask"],
                                             latents=t(p["noise"]), output_type="latent",
                                             **sps.IDS))
    np.testing.assert_allclose(got.numpy(), want, **LAT_TOL)


def test_shard_for_inference_leaves_the_shared_modules_alone(txt2img):
    """After with_config(...).shard_for_inference(rank) the base pipeline and
    an inpaint pipeline over its modules run unsharded, bit-equal to before;
    an inpaint pipeline made from a sharded one shares its copies; the
    sharded pipeline refuses quantize_weights, the IP-Adapter and SP."""
    _, base = txt2img
    cond = tpar.build_conditions([tpar.TextLine("Hi", (8, 16), font_size=24)], 64, 64)
    noise = t(np.random.default_rng(7).standard_normal((1, 16, 64)).astype(np.float32))
    kw = _txt2img_kw(noise)
    inp = FluxRepTextInpaintPipeline.from_pipeline(base, seed=3)
    flux, cn = base.flux, base.controlnet
    before = base(cond, **kw)
    mesh = make_mesh(1, 2, device="cpu", threads=2)
    sharded = [base.with_config(base.pipe_cfg).shard_for_inference(mesh.member(r))
               for r in range(2)]
    assert base.flux is flux and base.controlnet is cn and base.mesh is None
    assert inp.flux is flux and flux.double_blocks[0].block.num_heads == CFG.num_attention_heads
    assert all(s.flux is not flux and s.flux.tp_sharded == (r, 2) for r, s in enumerate(sharded))
    torch.testing.assert_close(base(cond, **kw), before, rtol=0, atol=0)
    derived = FluxRepTextInpaintPipeline.from_pipeline(sharded[0], seed=3)
    assert derived.flux is sharded[0].flux and derived.inpaint_controlnet.tp_sharded == (0, 2)
    outs = run_spmd(mesh, lambda m: sharded[m.rank](cond, **kw))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), before.numpy(), **LAT_TOL)
    for refused in (sharded[0].quantize_weights, sharded[0].attach_ip_adapter,
                    lambda: sharded[0].shard_for_sp(LocalSPGroup(2).member(0))):
        with pytest.raises(ValueError, match="shard"):
            refused()


def test_callback_and_adaptive_cache_take_rank0s_answer(txt2img):
    """Under the mesh the callback runs on rank 0 alone and every rank stops
    where it says; the adaptive velocity cache gives the unsharded latents."""
    _, base = txt2img
    cond = tpar.build_conditions([tpar.TextLine("Hi", (8, 16), font_size=24)], 64, 64)
    noise = t(np.random.default_rng(7).standard_normal((1, 16, 64)).astype(np.float32))
    calls = []

    def stop_at_1(i, latents):
        calls.append(i)
        return False

    cfg = dataclasses.replace(base.pipe_cfg, num_inference_steps=4,
                              velocity_cache_mode="adaptive", velocity_cache_threshold=0.2)
    kw = dict(_txt2img_kw(noise), callback=stop_at_1)
    want = base.with_config(cfg)(cond, **kw)
    assert calls == [1]
    calls.clear()
    got = on_mesh(1, 2, lambda m: base.with_config(cfg).shard_for_inference(m)(cond, **kw))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LAT_TOL)
    kw.pop("callback")
    got = on_mesh(2, 2, lambda m: base.with_config(cfg).shard_for_inference(m)(cond, **kw))
    np.testing.assert_allclose(got.numpy(), base.with_config(cfg)(cond, **kw).numpy(), **LAT_TOL)


# -------------------------------------------------------------------- training

TRAIN_B = 4


def _train_batch():
    """check_sharded_cn_train_step's batch (4 rows), with the text mask on a
    different share of each row's tokens."""
    r = np.random.default_rng(3)
    mask = np.zeros((TRAIN_B, S_IMG, 1), np.float32)
    for i in range(TRAIN_B):
        mask[i, :4 * (i + 1)] = 1.0
    return {
        "x0": r.standard_normal((TRAIN_B, S_IMG, CFG.in_channels)).astype(np.float32),
        "cond_tokens": r.standard_normal(
            (TRAIN_B, S_IMG, CN_CFG.in_channels + CN_CFG.extra_condition_channels)).astype(
                np.float32),
        "token_mask": mask,
        "prompt_embeds": r.standard_normal((TRAIN_B, S_TXT, CFG.joint_attention_dim)).astype(
            np.float32),
        "pooled": r.standard_normal((TRAIN_B, CFG.pooled_projection_dim)).astype(np.float32),
        "img_ids": np.asarray(j_img_ids(8, 8), np.float32),
        "txt_ids": np.zeros((S_TXT, 3), np.float32),
        "guidance": np.full((TRAIN_B,), 3.5, np.float32),
    }


def _apply_fns():
    flux, cn = JFlux(CFG), JControlNet(CN_CFG)

    def flux_apply(p, x, ctx, pooled, tt, iid, tid, g, br, sr):
        return flux.apply(p, x, ctx, pooled, tt, iid, tid, g,
                          controlnet_block_samples=br, controlnet_single_block_samples=sr)

    def cn_apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, scale):
        return cn.apply(p, x, cnd, ctx, pooled, tt, iid, tid, g, conditioning_scale=scale)

    return flux_apply, cn_apply


RNG_STEP = 7


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """JAX's one-device ControlNet step (SGD 1e-3): new params, loss, grads."""
    batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    flux_apply, cn_apply = _apply_fns()
    rng = jax.random.PRNGKey(RNG_STEP)
    cn_tree, flux_tree = tpar._cn_tree(), tpar._flux_tree()
    new, _, loss = jax.jit(jtrain.make_controlnet_train_step(
        flux_apply, cn_apply, optax.sgd(1e-3)))(cn_tree, optax.sgd(1e-3).init(cn_tree),
                                                flux_tree, batch, rng)
    grads = jax.grad(lambda p: jtrain.controlnet_flow_match_loss(
        flux_apply, cn_apply, p, flux_tree, batch, rng))(cn_tree)
    rng_t, rng_n = jax.random.split(rng)
    draws = (np.asarray(jax.nn.sigmoid(jax.random.normal(rng_t, (TRAIN_B,)))),
             np.asarray(jax.random.normal(rng_n, batch["x0"].shape, jnp.float32)))
    return (flatten_jax_params(np_tree(new)), float(loss), flatten_jax_params(np_tree(grads)),
            draws)


def _train_on_mesh(monkeypatch, dp, tp, lr=1e-3):
    """One port ControlNet step (SGD ``lr``) on every rank, JAX's t and noise
    drawn for the whole batch; per rank: (loss, whole state after the step,
    whole gradients)."""
    *_, draws = _jax_train_step()
    monkeypatch.setattr(ttrain, "draw_t_noise", lambda x0, gen: (t(draws[0]), t(draws[1])))
    flux = _port_model("flux").requires_grad_(False)
    cn = _port_model("controlnet")
    batch = {k: t(v) for k, v in _train_batch().items()}

    def rank(mesh):
        net = shard_module(cn, mesh, trainable=True).requires_grad_(True)
        opt = torch.optim.SGD(net.parameters(), lr=lr)
        step = ttrain.make_controlnet_train_step(net, opt, mesh=mesh)
        loss = step(shard_module(flux, mesh), batch, None)
        view = ShardedState(net, mesh)
        grads = {n: view.whole(n, p.grad) for n, p in net.named_parameters()}
        return loss.item(), view.state_dict(), grads

    return run_spmd(make_mesh(dp, tp, device="cpu", threads=dp * tp), rank)


def test_controlnet_train_step_2x2_matches_jax(monkeypatch):
    """The ControlNet step under dp = 2 x tp = 2 against JAX's one-device
    step: the loss (rtol 2e-5) and every parameter after one SGD 1e-3 step
    (within 2e-5), on every rank."""
    want, loss_j, _, _ = _jax_train_step()
    for loss, state, _ in _train_on_mesh(monkeypatch, 2, 2):
        np.testing.assert_allclose(loss, loss_j, rtol=2e-5)
        assert set(state) == set(want)
        for name, value in state.items():
            np.testing.assert_allclose(value.numpy(), want[name], rtol=0, atol=2e-5,
                                       err_msg=name)


REPLICATED = ("time_text_embed", "x_embedder", "controlnet_x_embedder", "context_embedder",
              "norm1.linear", "norm1_context.linear", "norm.linear", "norm_q", "norm_added_k")


def _replicated_grad_errors(grads, want):
    return {n: float(np.abs(g.numpy() - want[n]).max() / np.abs(want[n]).max())
            for n, g in grads.items() if any(k in n for k in REPLICATED)}


def test_f_operator_makes_the_replicated_gradients(monkeypatch):
    """At tp = 2, the gradients of the replicated AdaLN linears, embedders
    and per-head norms are the unsharded ones (within TOL of max|grad|)
    only through Megatron's f (copy_to_tp) before each column-parallel
    group: with f made the identity they are wrong, though the loss is not."""
    _, loss_j, grads_j, _ = _jax_train_step()
    loss, _, grads = _train_on_mesh(monkeypatch, 1, 2, lr=0.0)[0]
    np.testing.assert_allclose(loss, loss_j, rtol=2e-5)
    errors = _replicated_grad_errors(grads, grads_j)
    assert len(errors) > 10 and max(errors.values()) < TOL["rtol"], errors
    monkeypatch.setattr(tblocks, "copy_to_tp", lambda x, group: x)
    loss, _, grads = _train_on_mesh(monkeypatch, 1, 2, lr=0.0)[0]
    np.testing.assert_allclose(loss, loss_j, rtol=2e-5)
    errors = _replicated_grad_errors(grads, grads_j)
    assert max(errors.values()) > 0.05, errors


def test_shard_batch_splits_rows_over_dp():
    batch = {k: t(v) for k, v in _train_batch().items()}
    mesh = make_mesh(2, 1, device="cpu", threads=2)
    for r in range(2):
        part = shard_batch(batch, mesh.member(r))
        for k, v in batch.items():
            if k in ("img_ids", "txt_ids"):
                assert part[k] is v
            else:
                torch.testing.assert_close(part[k], v[2 * r:2 * r + 2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        shard_batch(batch, make_mesh(3, 1, device="cpu", threads=3).member(0))


def test_elastic_checkpoint_saved_under_1x2_resumes_under_1x1(tmp_path):
    """Restore points under the mesh hold whole tensors, written by rank 0
    alone: a run saved under (1, 2) resumes unsharded (1, 1) where the
    unsharded run stands, and a NaN under the mesh rolls every rank back."""
    flux = _port_model("flux").requires_grad_(False)
    cn = _port_model("controlnet")
    batch = {k: t(v) for k, v in _train_batch().items()}

    def trainer(mesh, ckpt, plant=None):
        net = shard_module(cn, mesh, trainable=True).requires_grad_(True)
        opt = torch.optim.AdamW(net.parameters(), lr=1e-3)
        step = ttrain.make_controlnet_train_step(net, opt, mesh=mesh)
        calls = []

        def train_step(b, gen):
            calls.append(1)
            loss = step(shard_module(flux, mesh), b, gen)
            return loss * float("nan") if plant is not None and len(calls) == plant else loss

        state = {"controlnet": ShardedState(net, mesh),
                 "optimizer": ShardedOptimizerState(opt, net, mesh)}
        return ElasticTrainer(train_step, lambda s: batch, state,
                              checkpoint_dir=ckpt if mesh.rank == 0 else None,
                              checkpoint_every=2), state

    def run(mesh, steps, ckpt=None, plant=None):
        tr, state = trainer(mesh, ckpt, plant)
        return tr.run(steps, seed=3), state["controlnet"].state_dict(), tr.faults

    saved = tmp_path / "tp"
    outs = run_spmd(make_mesh(1, 2, device="cpu", threads=2),
                    lambda m: run(m, 2, str(saved), plant=2))
    assert sorted(p.name for p in saved.iterdir()) == ["step_0.pt", "step_2.pt"]
    assert all(len(o[2]) == 1 for o in outs)           # the NaN, rolled back on both
    one = make_mesh(1, 1, device="cpu", threads=1).member(0)
    losses_1x1, state_1x1, _ = run(one, 3)
    np.testing.assert_allclose(outs[0][0], losses_1x1[:2], rtol=2e-5)
    restore = torch.load(saved / "step_2.pt")
    tr, state = trainer(one, None)
    for k, v in state.items():
        v.load_state_dict(restore["state"][k])
    for name, value in state["controlnet"].state_dict().items():
        np.testing.assert_allclose(value.numpy(), outs[0][1][name].numpy(), rtol=0, atol=0)
    resumed = tr.train_step(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(resumed.item())


# --------------------------------------------------------------------- serving

def _serve_pair(pipe, ranks, shard_rank, group_of):
    """Two requests served by a sharded server (rank 0 answers HTTP, the
    others follow), and the same two by an unsharded one; the PNGs."""
    payloads = [{"prompt": "a sign", "lines": [{"text": "Hi", "position": [8, 16],
                                                "font_size": 24}], "seed": s, "num_steps": 2}
                for s in (1, 2)]

    def ask(server):
        threading.Thread(target=server.serve_forever, daemon=True).start()
        host, port = server.address[:2]
        out = [None, None]

        def post(i):
            req = urllib.request.Request(f"http://{host}:{port}/generate",
                                         data=json.dumps(payloads[i]).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out[i] = json.loads(resp.read())["image_png_base64"]

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        return out

    def serve(rank):
        mine = shard_rank(pipe.with_config(pipe.pipe_cfg), rank)
        group = group_of(rank)
        if group.rank != 0:
            return follow(group, mine)
        server = GenerationServer(mine, port=0, max_batch=2, batch_window_s=0.3, group=group)
        try:
            return ask(server)
        finally:
            server.shutdown()

    got = run_spmd(ranks, serve)
    alone = GenerationServer(pipe, port=0, max_batch=2, batch_window_s=0.3)
    try:
        want = ask(alone)
    finally:
        alone.shutdown()
    return got, want


@pytest.mark.parametrize("how", ["1x2", "sp2"])
def test_served_pair_under_sharding_equals_one_rank(txt2img, how):
    """A coalesced pair of requests over HTTP under thread-rank TP (1 x 2)
    and under sp2: each image within 2 levels of the unsharded server's; the
    followers made the one generate_batch call."""
    import base64
    import io

    from PIL import Image

    _, base = txt2img
    if how == "sp2":
        ranks = LocalSPGroup(2)
        got, want = _serve_pair(base, ranks, lambda p, g: p.shard_for_sp(g, "ring"), lambda g: g)
    else:
        ranks = make_mesh(1, 2, device="cpu", threads=2)
        got, want = _serve_pair(base, ranks, lambda p, m: p.shard_for_inference(m),
                                lambda m: m.world)
    assert got[1] in (1, 2)                   # the follower's calls: one batch, or two

    def png(b64):
        return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))), np.int32)

    for a, b in zip(got[0], want):
        assert np.abs(png(a) - png(b)).max() <= 2


# ------------------------------------------------------------------------ CLI

def _torchrun(argv, n=2, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
         "--master-addr", "localhost", "--master-port", str(tpar._free_port()),
         "-m", "reptext_tpu_torch.cli", *argv], cwd=ROOT, env=tpar._env(),
        capture_output=True, text=True, timeout=timeout)


def test_cli_shard_1x2_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 -m reptext_tpu_torch.cli --shard 1x2
    --device cpu`` (gloo) writes the image one process writes, within 2
    levels; only rank 0 writes."""
    from PIL import Image

    one, two = tmp_path / "one.png", tmp_path / "two.png"
    assert cli.main([*tpar.TINY_CLI, "--output", str(one)]) == 0
    proc = _torchrun(["--shard", "1x2", *tpar.TINY_CLI, "--output", str(two)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("saved ") == 1
    a, b = (np.asarray(Image.open(p), np.int32) for p in (one, two))
    assert a.shape == b.shape == (64, 64, 3) and np.abs(a - b).max() <= 2


TRAIN_CLI = ["--mode", "train", "--tiny", "--device", "cpu", "--random-weights", "--size", "64",
             "--train-steps", "2", "--batch-size", "2", "--checkpoint-every", "2"]


def test_cli_train_shard_2x1_under_torchrun_matches_one_process(tmp_path, capsys):
    """``--mode train --shard 2x1`` under torchrun (gloo, each rank a row of
    the batch) ends where one process ends, written once: the two steps'
    losses within 1e-5, and controlnet_final.pt within the two AdamW steps'
    reach (2 lr, lr 1e-5: Adam's normalised update moves an element whose
    gradient is near zero by about lr when the other summation order flips
    its sign) and, but for 1e-3 of the elements, within lr / 10.
    --batch-size 3 over dp = 2 is refused."""
    import re

    def losses(text):
        return [float(x) for x in re.findall(r"'loss': ([0-9.e-]+)", text)]

    one, two = tmp_path / "one", tmp_path / "two"
    assert cli.main([*TRAIN_CLI, "--train-dir", str(one)]) == 0
    want = losses(capsys.readouterr().out)
    proc = _torchrun(["--shard", "2x1", *TRAIN_CLI, "--train-dir", str(two)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("saved the trained ControlNet") == 1
    assert len(want) == 2
    np.testing.assert_allclose(losses(proc.stdout), want, rtol=1e-5)
    a, b = (torch.load(d / "controlnet_final.pt") for d in (one, two))
    assert set(a) == set(b)
    lr, far, total = 1e-5, 0, 0
    for k in a:
        diff = np.abs(b[k].numpy() - a[k].numpy())
        assert diff.max() <= 2 * lr, k
        far, total = far + int((diff > lr / 10).sum()), total + diff.size
    assert far <= 1e-3 * total, (far, total)
    with pytest.raises(SystemExit, match="not divisible by dp=2"):
        cli.train(cli.build_parser().parse_args([*TRAIN_CLI, "--batch-size", "3"]), None,
                  mesh=make_mesh(2, 1, device="cpu", threads=2).member(0))
