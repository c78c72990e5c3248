"""The blocks' norm entries (``reptext_tpu_torch/ops/norms.py``) on the CPU.

On the CPU ``modulate`` and the RMSNorm take their plain versions, which must
stay bit-equal to the composition the port had before the CUDA kernels (a
frozen copy below), so the JAX parity tests' path does not move; a CPU tensor
never reaches a kernel wrapper, with or without gradients; the kernels'
names sort into the benchmark's ``elementwise`` class and leave the attention
kernels' classes as they were; and the recorder's ``norm`` counter counts the
entries' calls under a request and nothing without one. The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_norms_cuda.py``.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

from portbench.kernels import kernel_class
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.nn import layers
from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock, split_heads
from reptext_tpu_torch.ops import norms
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "reptext_tpu_torch", "csrc")


# The composition of nn/layers.py before the kernels, frozen.
def frozen_rms_norm(x, w, eps):
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def frozen_modulate(x, shift, scale):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + 1e-6)
    out = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


def _modulate_case(case, dtype, gen):
    """(x, shift, scale) as the blocks pass them: the chunk views of an AdaLN
    projection, at batch 1 or 2, and norm_out's slice of the joint stream."""
    b = 2 if case == "batch2" else 1
    x = torch.randn(b, 40, 96, generator=gen) * 3 + 0.5
    if case == "slice":
        x = x[:, 9:]
    emb = torch.randn(b, 6 * 96, generator=gen)
    shift, scale = emb.to(dtype).chunk(6, dim=-1)[:2]
    return x.to(dtype), shift, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["main", "batch2", "slice"])
def test_plain_versions_equal_the_frozen_composition(case, dtype):
    gen = torch.Generator().manual_seed(0)
    x, shift, scale = _modulate_case(case, dtype, gen)
    want = frozen_modulate(x, shift, scale)
    assert torch.equal(layers.modulate(x, shift, scale), want)
    assert torch.equal(norms.modulate_plain(x, shift, scale), want)
    ada = layers.AdaLayerNormZero(96, dtype=dtype)
    temb = torch.randn(x.shape[0], 96, generator=gen).to(dtype)
    emb = ada.linear(torch.nn.functional.silu(temb))
    sh, sc = emb.chunk(6, dim=-1)[:2]
    assert torch.equal(ada(x, temb)[0], frozen_modulate(x, sh, sc))

    q = split_heads((torch.randn(x.shape[0], 33, 4 * 32, generator=gen) * 4).to(dtype), 4)
    norm = layers.RMSNorm(32, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(32, generator=gen) + 0.5)
    assert torch.equal(norm(q), frozen_rms_norm(q, norm.weight, 1e-6))
    w = torch.rand(32, generator=gen).to(dtype)
    assert torch.equal(norm(q, w), frozen_rms_norm(q, w, 1e-6))
    assert torch.equal(norms.rms_norm_plain(q, w, 1e-6), frozen_rms_norm(q, w, 1e-6))


def _refuse(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a norm kernel wrapper")


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """Both blocks, forward and backward (so also the autograd route), on the
    CPU: no kernel wrapper is called and no launch is counted."""
    monkeypatch.setattr(norms, "_launch_modulate", _refuse)
    monkeypatch.setattr(norms, "_launch_rms_norm", _refuse)
    launches = (norms.modulate.launches, norms.rms_norm.launches)
    torch.manual_seed(0)
    joint, single = JointTransformerBlock(64, 2, 32), SingleTransformerBlock(64, 2, 32)
    img = torch.randn(1, 16, 64, requires_grad=True)
    txt = torch.randn(1, 8, 64, requires_grad=True)
    temb = torch.randn(1, 64)
    cos, sin = torch.ones(24, 32), torch.zeros(24, 32)
    ctx, x = joint(img, txt, temb, cos, sin)
    out = single(torch.cat([ctx, x], dim=1), temb, cos, sin)
    out.square().sum().backward()
    assert img.grad is not None and txt.grad is not None
    assert joint.norm_q.weight.grad.abs().sum() > 0
    assert joint.norm1.linear.weight.grad.abs().sum() > 0
    assert single.norm_k.weight.grad.abs().sum() > 0
    assert (norms.modulate.launches, norms.rms_norm.launches) == launches


FORBIDDEN = ("conv", "fprop", "dgrad", "wgrad", "gemm", "nvjet", "cutlass", "xmma", "cublas",
             "nccl", "attn_fwd_kernel", "rope_rotate_kernel", "multi_tensor_apply")


def _code(path):
    """A CUDA source without its comments."""
    with open(path) as f:
        src = f.read()
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def _kernels(path):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", _code(path))


def test_norm_kernels_classify_as_elementwise():
    """Every ``__global__`` of csrc/norms.cu, as the profiler names each
    instantiation, is ``elementwise``; no identifier of its code carries a tag
    that ``kernel_class`` reads; the attention kernels' classes stand."""
    names = _kernels(os.path.join(CSRC, "norms.cu"))
    assert sorted(names) == ["modulate_ln_kernel", "rms_norm_kernel"]
    types_ = ("__nv_bfloat16", "float")
    for name in names:
        for t in types_:
            for m in types_:
                for vpt in (1, 2, 4, 8):
                    full = f"void (anonymous namespace)::{name}<{t}, {m}, {vpt}>" \
                           "((anonymous namespace)::NormArgs)"
                    assert kernel_class(full) == "elementwise", full
    words = set(re.findall(r"\w+", _code(os.path.join(CSRC, "norms.cu")).lower()))
    assert not [w for w in words if any(tag in w for tag in FORBIDDEN)]

    attention = {name: kernel_class(f"void {name}<128, true>(Params)")
                 for src in ("flash_attention.cu", "flash_attention_bwd.cu")
                 for name in _kernels(os.path.join(CSRC, src))}
    assert attention == {"rope_rotate_kernel": "attention", "attn_fwd_kernel": "attention",
                         "attn_bwd_preprocess_kernel": "attention_backward",
                         "attn_bwd_epilogue_kernel": "attention_backward",
                         "attn_bwd_kernel": "attention_backward"}


def test_norm_counter_counts_calls_under_a_recorder_only():
    x = torch.randn(1, 5, 32)
    shift, scale = torch.randn(1, 32), torch.randn(1, 32)
    norm = layers.RMSNorm(32)
    layers.modulate(x, shift, scale)         # no recorder: counted nowhere
    norm(x)
    assert profiling.active_recorder() is None
    timings = {}
    with profiling.request_trace(timings, "cpu"):
        for _ in range(2):
            layers.modulate(x, shift, scale)
        for _ in range(3):
            norm(x)
    assert timings["trace"]["counters"]["norm"] == {"modulate": 2, "rms_norm": 3}
    timings = {}
    with profiling.request_trace(timings, "cpu"):
        pass
    assert timings["trace"]["counters"]["norm"] == {}


def test_norm_counter_over_a_request():
    """A tiny txt2img request: each sampled step calls ``modulate`` 4 times a
    double block, once a single block and once in FLUX's norm_out, and the
    RMSNorm 4 times a double block and twice a single block, FLUX on every
    step and the ControlNet on its steps; nothing outside the sampler."""
    steps, cn_steps, size = 3, 2, 64
    torch.manual_seed(0)
    flux, cn = FluxConfig().tiny(), ControlNetConfig().tiny()
    pipe = FluxRepTextPipeline.create(
        flux, cn, VAEConfig().tiny(),
        PipelineConfig(height=size, width=size, num_inference_steps=steps,
                       controlnet_conditioning_step=cn_steps),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(), device="cpu", seed=0)
    glyph = np.zeros((size, size, 3), np.uint8)
    glyph[20:32, 16:48] = 255
    pos = np.zeros((size, size), np.uint8)
    pos[18:34, 14:50] = 255
    line = types.SimpleNamespace(canny_image=glyph, position_mask=pos, region_mask=pos.copy())
    cond = types.SimpleNamespace(lines=[line], glyph_canvas=glyph, num_lines=1)
    timings = {}
    pipe(cond, timings=timings, clip_ids=np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32),
         t5_ids=np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32))
    counters = timings["trace"]["counters"]
    assert counters["controlnet_steps"] == cn_steps
    assert counters["norm"] == {
        "modulate": steps * (4 * flux.num_layers + flux.num_single_layers + 1)
        + cn_steps * (4 * cn.num_layers + cn.num_single_layers),
        "rms_norm": steps * (4 * flux.num_layers + 2 * flux.num_single_layers)
        + cn_steps * (4 * cn.num_layers + 2 * cn.num_single_layers)}


@pytest.mark.parametrize("d,dtype,want", [
    (128, torch.bfloat16, (16, 1, 16)),     # a head row: 16 lanes, 16 rows a CTA
    (32, torch.bfloat16, (4, 1, 4)),        # --tiny's head dim
    (64, torch.float32, (16, 1, 16)),       # the demo's, fp32
    (256, torch.float32, (64, 1, 64)),      # the demo's hidden width: one row a CTA
    (3072, torch.bfloat16, (384, 4, 96)),   # FLUX: 3 warps, 64 bytes a thread
    (3072, torch.float32, (768, 4, 192)),  # fp32 at FLUX's width: 6 warps
    (12, torch.float32, (3, 1, 4)),         # a ragged last lane group
])
def test_plan_holds_a_row_in_registers(d, dtype, want):
    """(vectors a row, vectors a thread, threads a row): a power of two up to
    32 threads, else whole warps, at most 128 threads where 4 vectors a thread
    allow."""
    assert norms.plan(d, dtype) == want
    nv, vpt, group = want
    assert group * vpt >= nv and (group <= 32 and group & (group - 1) == 0 or group % 32 == 0)


@pytest.mark.parametrize("d,dtype,match", [(100, torch.bfloat16, "16-byte vectors"),
                                           (6, torch.float32, "16-byte vectors"),
                                           (3080, torch.bfloat16, "exceeds"),
                                           (3076, torch.float32, "exceeds")])
def test_plan_refuses_rows_it_cannot_hold(d, dtype, match):
    with pytest.raises(ValueError, match=match):
        norms.plan(d, dtype)
