"""The blocks' joins (``nn/blocks.py``, ``ops/attention.py::joins_in_place``)
on the CPU.

A double block joins its text and image streams into one sequence for
attention, a single block its attention and MLP branches for ``proj_out``.
Where the join rule holds (K1 runs at the joint length, no SP backend,
autograd records nothing on the joined tensors, and for the double block's
text and image segments a text of whole 128-key tiles) they do it by where
producers write instead of by ``torch.cat``. Held here: both blocks on both routes against a frozen copy of
the composition the port had before (bit for bit, but for the one rounding
point the double block's batch-2 route moves: its out-projections now read a
contiguous input, so the bias is added in the GEMM, as at batch 1); the rule
as a table; the request's ``joins`` counter; a train step's gradients; the entries'
plain paths and what they refuse; the GELU kernel's class in the benchmark's breakdown. The
kernels themselves are held against these routes on the card by
``tests/test_torch_joins_cuda.py``.
"""

import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.kernels import kernel_class
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.models.controlnet import RepTextControlNet
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.nn.blocks import (
    JointTransformerBlock, SingleTransformerBlock, merge_heads, split_heads,
)
from reptext_tpu_torch.nn.layers import gelu_tanh, modulate
from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.ops.attention import attention, joins_in_place
from reptext_tpu_torch.ops.gelu import gelu_tanh_into
from reptext_tpu_torch.ops.rope import rope_cos_sin_half
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.utils import profiling

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "reptext_tpu_torch", "csrc")

# The tiny geometry (FluxConfig().tiny(): 4 heads of 32) at a joint length K1
# takes: 128 text tokens, 640 image tokens.
DIM, HEADS, HEAD_DIM = 128, 4, 32
S_TXT, S_IMG = 128, 640


# ------------------------------------------------ the composition before, frozen


def frozen_joint(block, hidden_states, encoder_hidden_states, temb, rope_cos, rope_sin,
                 contiguous_out=False):
    """``JointTransformerBlock.forward`` as it was (no SP, no IP-Adapter, no
    tp); ``contiguous_out``: the out-projections read contiguous inputs."""
    h = block.num_heads
    s_txt = encoder_hidden_states.shape[1]
    norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = block.norm1(hidden_states, temb)
    norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = block.norm1_context(
        encoder_hidden_states, temb)
    q_i = block.norm_q(split_heads(block.to_q(norm_img), h))
    k_i = block.norm_k(split_heads(block.to_k(norm_img), h))
    v_i = split_heads(block.to_v(norm_img), h)
    q_t = block.norm_added_q(split_heads(block.add_q_proj(norm_txt), h))
    k_t = block.norm_added_k(split_heads(block.add_k_proj(norm_txt), h))
    v_t = split_heads(block.add_v_proj(norm_txt), h)
    q = torch.cat([q_t, q_i], dim=2)
    k = torch.cat([k_t, k_i], dim=2)
    v = torch.cat([v_t, v_i], dim=2)
    attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
    txt_attn, img_attn = attn[:, :s_txt], attn[:, s_txt:]
    if contiguous_out:
        txt_attn, img_attn = txt_attn.contiguous(), img_attn.contiguous()
    hidden_states = hidden_states + gate_msa[:, None, :] * block.to_out(img_attn)
    ff_out = block.ff(modulate(hidden_states, shift_mlp, scale_mlp))
    hidden_states = hidden_states + gate_mlp[:, None, :] * ff_out
    encoder_hidden_states = (encoder_hidden_states
                             + c_gate_msa[:, None, :] * block.to_add_out(txt_attn))
    ff_c = block.ff_context(modulate(encoder_hidden_states, c_shift_mlp, c_scale_mlp))
    encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None, :] * ff_c
    return encoder_hidden_states, hidden_states


def frozen_single(block, hidden_states, temb, rope_cos, rope_sin):
    """``SingleTransformerBlock.forward`` as it was (no SP, no tp)."""
    h = block.num_heads
    normed, gate = block.norm(hidden_states, temb)
    mlp = gelu_tanh(block.proj_mlp(normed))
    q = block.norm_q(split_heads(block.to_q(normed), h))
    k = block.norm_k(split_heads(block.to_k(normed), h))
    v = split_heads(block.to_v(normed), h)
    attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
    out = block.proj_out(torch.cat([attn, mlp], dim=-1))
    return hidden_states + gate[:, None, :] * out


def _randomize(module, gen, scale=0.05):
    """Every parameter drawn anew (zero-initialised heads included)."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * scale + (1.0 if p.dim() == 1 and
                                                                   p.shape[0] == HEAD_DIM
                                                                   else 0.0))
    return module


def _block_inputs(b, dtype, gen, s_txt=S_TXT):
    img = torch.randn(b, S_IMG, DIM, generator=gen).to(dtype)
    txt = torch.randn(b, s_txt, DIM, generator=gen).to(dtype)
    temb = torch.randn(b, DIM, generator=gen).to(dtype)
    ids = torch.zeros(s_txt + S_IMG, 3)
    ids[s_txt:, 1] = torch.arange(S_IMG) // 32
    ids[s_txt:, 2] = torch.arange(S_IMG) % 32
    cos, sin = rope_cos_sin_half(ids, (8, 12, 12), 10000)
    return img, txt, temb, cos, sin


def _blocks(dtype, gen):
    joint = _randomize(JointTransformerBlock(DIM, HEADS, HEAD_DIM), gen).to(dtype)
    single = _randomize(SingleTransformerBlock(DIM, HEADS, HEAD_DIM), gen).to(dtype)
    return joint, single


def _trace(fn):
    timings = {}
    with profiling.request_trace(timings, "cpu"):
        result = fn()
    return result, timings["trace"]["counters"]["joins"]


# ------------------------------------------------------------------ the routes


@pytest.mark.parametrize("route", ["in_place", "copied"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocks_equal_the_frozen_composition(dtype, batch, route):
    """Both blocks at the tiny geometry on both routes. The copied route is
    the frozen composition bit for bit; so is the in-place route, but at
    batch 2 in bf16, where the double block's out-projections read a
    contiguous input (their bias added in the GEMM, rounded once): there it
    is the frozen composition with contiguous out-projection inputs, bit for
    bit, and within one bf16 rounding of the bias add of it as it was."""
    gen = torch.Generator().manual_seed(batch)
    joint, single = _blocks(dtype, gen)
    img, txt, temb, cos, sin = _block_inputs(batch, dtype, gen)
    if route == "copied":       # autograd records on the joined tensors
        img.requires_grad_(True)
    grad = torch.enable_grad() if route == "copied" else torch.no_grad()
    with grad:
        (ctx, x), joins = _trace(lambda: joint(img, txt, temb, cos, sin))
        seq = torch.cat([ctx, x], dim=1)
        out, single_joins = _trace(lambda: single(seq, temb, cos, sin, None, S_TXT))
    n = (route == "in_place")
    assert joins == single_joins == {"inplace": int(n), "copied": int(not n)}
    with torch.no_grad():
        want_ctx, want_x = frozen_joint(joint, img, txt, temb, cos, sin)
        want_out = frozen_single(single, seq.detach(), temb, cos, sin)
        moved = n and batch == 2 and dtype == torch.bfloat16
        if moved:
            c_ctx, c_x = frozen_joint(joint, img, txt, temb, cos, sin, contiguous_out=True)
            assert torch.equal(ctx, c_ctx) and torch.equal(x, c_x)
            for got, want in ((ctx, want_ctx), (x, want_x)):
                ulp = torch.finfo(dtype).eps * want.float().abs().clamp_min(1.0)
                assert ((got.float() - want.float()).abs() <= 2 * ulp).all()
        else:
            assert torch.equal(ctx, want_ctx) and torch.equal(x, want_x)
        assert torch.equal(out, want_out)


@pytest.mark.parametrize("txt_len", [None, "given"])
@pytest.mark.parametrize("s_txt", [S_TXT, S_TXT + 1])
def test_the_single_block_joins_in_place_at_any_text_length(s_txt, txt_len):
    """The single block's join splits no keys: it is in place with or
    without ``txt_len`` and at a text of part of a tile (a union net's mode
    token), where the double block copies; both equal the frozen
    composition."""
    gen = torch.Generator().manual_seed(3)
    joint, single = _blocks(torch.float32, gen)
    img, txt, temb, cos, sin = _block_inputs(1, torch.float32, gen, s_txt)
    with torch.no_grad():
        (ctx, x), joins = _trace(lambda: joint(img, txt, temb, cos, sin))
        whole = s_txt % fa.SEGMENT_ALIGN == 0
        assert joins == {"inplace": int(whole), "copied": int(not whole)}
        want_ctx, want_x = frozen_joint(joint, img, txt, temb, cos, sin)
        assert torch.equal(ctx, want_ctx) and torch.equal(x, want_x)
        seq = torch.cat([txt, img], dim=1)
        length = s_txt if txt_len else None
        out, joins = _trace(lambda: single(seq, temb, cos, sin, None, length))
        assert joins == {"inplace": 1, "copied": 0}
        assert torch.equal(out, frozen_single(single, seq, temb, cos, sin))


# ------------------------------------------------------------------ the rule


@pytest.mark.parametrize("s,s_txt,sp,grad,requires,kernel,want", [
    (4608, 512, None, False, False, "K1", True),        # txt2img 1024^2
    (5312, 512, None, False, False, "K1", True),        # inpainting 1280x960
    (768, 128, None, False, False, "K1", True),         # the tests' tiny K1 length
    (7424, 512, None, False, False, "K3", False),       # 1536x1152: streaming
    (9728, 512, None, False, False, "K3", False),       # 1536^2
    (144, 128, None, False, False, "K2", False),        # one chunk: rotated, then K2
    (4609, 513, None, False, False, "K1", False),       # a union net's mode token
    (4104, 8, None, False, False, "K1", False),         # a short prompt
    (4608, 512, "ring", False, False, "K1", False),
    (4608, 512, "ulysses", False, False, "K1", False),
    (4608, 512, None, True, True, "K1", False),         # training
    (4608, 512, None, True, False, "K1", True),         # grad on, nothing requires it
    (4608, 512, None, False, True, "K1", True),         # no_grad over trained leaves
    # the single block's join splits no keys (s_txt None)
    (4608, None, None, False, False, "K1", True),       # txt2img 1024^2
    (4609, None, None, False, False, "K1", True),       # a union net's mode token
    (4104, None, None, False, False, "K1", True),       # a short prompt
    (9728, None, None, False, False, "K3", False),      # 1536^2
    (144, None, None, False, False, "K2", False),       # one chunk
    (4608, None, "ulysses", False, False, "K1", False),
    (4608, None, None, True, True, "K1", False),        # training
])
def test_the_join_rule(s, s_txt, sp, grad, requires, kernel, want):
    assert {True: "K3"}.get(fa.streams(s), "K1" if fa.rope_fused(s) else "K2") == kernel
    t = torch.zeros(2, requires_grad=requires)
    with torch.set_grad_enabled(grad):
        got, joins = _trace(lambda: joins_in_place(s, sp, t, s_txt=s_txt))
    assert got is want
    assert joins == {"inplace": int(want), "copied": int(not want)}


def test_the_rule_counts_nothing_without_a_recorder():
    assert profiling.active_recorder() is None
    assert joins_in_place(4608, None, s_txt=512) is True


# ------------------------------------------------------------- the counters


def _tiny_request(steps, cn_steps, height, width, t5_len):
    torch.manual_seed(0)
    flux, cn = FluxConfig().tiny(), ControlNetConfig().tiny()
    pipe = FluxRepTextPipeline.create(
        flux, cn, VAEConfig().tiny(),
        PipelineConfig(height=height, width=width, num_inference_steps=steps,
                       controlnet_conditioning_step=cn_steps),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(), device="cpu", seed=0)
    glyph = np.zeros((height, width, 3), np.uint8)
    glyph[20:32, 16:48] = 255
    pos = np.zeros((height, width), np.uint8)
    pos[18:34, 14:50] = 255
    line = types.SimpleNamespace(canny_image=glyph, position_mask=pos, region_mask=pos.copy())
    cond = types.SimpleNamespace(lines=[line], glyph_canvas=glyph, num_lines=1)
    t5_ids = np.zeros((1, t5_len), np.int32)
    t5_ids[0, :3] = (5, 9, 11)
    timings = {}
    pipe(cond, timings=timings, clip_ids=np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32),
         t5_ids=t5_ids)
    return timings["trace"]["counters"], flux, cn


@pytest.mark.parametrize("height,width,t5_len,in_place", [
    (64, 64, 8, False),       # --tiny's short text: every block copies
    (320, 512, 128, True),    # 128 text + 640 image tokens: K1, whole tiles
])
def test_joins_counter_over_a_two_step_request(height, width, t5_len, in_place):
    """A two-step tiny request: each block of FLUX on every step and of the
    ControlNet on its steps counts one join, in place or copied by the rule."""
    steps, cn_steps = 2, 1
    counters, flux, cn = _tiny_request(steps, cn_steps, height, width, t5_len)
    blocks_run = (steps * (flux.num_layers + flux.num_single_layers)
                  + cn_steps * (cn.num_layers + cn.num_single_layers))
    assert counters["controlnet_steps"] == cn_steps
    assert counters["joins"] == {"inplace": blocks_run * in_place,
                                 "copied": blocks_run * (not in_place)}


# ---------------------------------------------------------------- a train step


def _models(gen, batch):
    flux_cfg, cn_cfg = FluxConfig().tiny(), ControlNetConfig().tiny()
    flux = _randomize(FluxTransformer2D(flux_cfg), gen).requires_grad_(False)
    cn = _randomize(RepTextControlNet(cn_cfg), gen)
    lat = torch.randn(batch, S_IMG, flux_cfg.in_channels, generator=gen)
    cond = torch.randn(batch, S_IMG, cn.controlnet_x_embedder.in_features, generator=gen)
    txt = torch.randn(batch, S_TXT, flux_cfg.joint_attention_dim, generator=gen)
    pooled = torch.randn(batch, flux_cfg.pooled_projection_dim, generator=gen)
    t = torch.full((batch,), 0.5)
    guidance = torch.full((batch,), 3.5)
    txt_ids = torch.zeros(S_TXT, 3)
    img_ids = torch.zeros(S_IMG, 3)
    img_ids[:, 1] = torch.arange(S_IMG) // 32
    img_ids[:, 2] = torch.arange(S_IMG) % 32
    return flux, cn, (lat, cond, txt, pooled, t, img_ids, txt_ids, guidance)


def _loss(flux, cn, lat, cond, txt, pooled, t, img_ids, txt_ids, guidance):
    cb, cs = cn(lat, cond, txt, pooled, t, img_ids, txt_ids, guidance)
    pred = flux(lat, txt, pooled, t, img_ids, txt_ids, guidance, cb, cs)
    return pred.float().square().mean()


def test_a_train_steps_gradients_are_unchanged(monkeypatch):
    """A ControlNet train step over the frozen base at a K1 length with
    whole text tiles, batch 2: the ControlNet's gradients equal the frozen
    composition's bit for bit. Its blocks and FLUX's take the copied route
    (the joined tensors carry gradients) but FLUX's first double block,
    whose inputs and weights carry none."""
    gen = torch.Generator().manual_seed(7)
    flux, cn, inputs = _models(gen, 2)
    loss, joins = _trace(lambda: _loss(flux, cn, *inputs))
    loss.backward()
    got = {n: p.grad.clone() for n, p in cn.named_parameters()}
    n_flux = flux.config.num_layers + flux.config.num_single_layers
    n_cn = cn.config.num_layers + cn.config.num_single_layers
    assert joins == {"inplace": 1, "copied": n_flux + n_cn - 1}
    cn.zero_grad(set_to_none=True)
    monkeypatch.setattr(JointTransformerBlock, "forward",
                        lambda self, x, c, temb, cos, sin, *rest: frozen_joint(
                            self, x, c, temb, cos, sin))
    monkeypatch.setattr(SingleTransformerBlock, "forward",
                        lambda self, x, temb, cos, sin, *rest: frozen_single(
                            self, x, temb, cos, sin))
    want_loss = _loss(flux, cn, *inputs)
    want_loss.backward()
    assert torch.equal(loss, want_loss)
    for n, p in cn.named_parameters():
        assert torch.equal(got[n], p.grad), n


# ------------------------------------------------------- the entries themselves


@pytest.mark.parametrize("s_txt", [128, 5])
def test_attention_segments_on_the_plain_paths(s_txt):
    """``attention`` (the plain path) and ``flash_attention_rope`` (K1's plain
    version) take (text, image) segments and give each segment's output, or
    write one sequence's output into ``out``: the joint result either way."""
    gen = torch.Generator().manual_seed(s_txt)
    b, h, d, s = 2, 2, 32, 768
    q, k, v = (torch.randn(b, h, s, d, generator=gen) for _ in range(3))
    ids = torch.zeros(s, 3)
    ids[:, 2] = torch.arange(s)
    cos, sin = rope_cos_sin_half(ids, (8, 12, 12), 10000)

    def pair(x):
        return x[:, :, :s_txt].contiguous(), x[:, :, s_txt:].contiguous()

    for fn in (attention, lambda *a, **kw: fa.flash_attention_rope(*a, **kw)[0]):
        want = fn(q, k, v, cos, sin)
        got = fn(pair(q), pair(k), pair(v), cos, sin)
        assert len(got) == 2 and torch.equal(torch.cat(got, dim=2), want)
        buf = torch.zeros(b, s, h * d + 40)
        assert fn(q, k, v, cos, sin, out=split_heads(buf[..., :h * d], h)).data_ptr() == \
            buf.data_ptr()
        assert torch.equal(buf[..., :h * d], merge_heads(want))
        assert not buf[..., h * d:].any()


def test_what_the_in_place_entries_refuse():
    q = torch.randn(1, 2, 768, 32, requires_grad=True)
    cos, sin = torch.ones(768, 32), torch.zeros(768, 32)
    with pytest.raises(ValueError, match="no gradient"):
        fa.flash_attention_rope((q[:, :, :128], q[:, :, 128:]), (q[:, :, :128], q[:, :, 128:]),
                                (q[:, :, :128], q[:, :, 128:]), cos, sin)
    with pytest.raises(ValueError, match="no gradient"):
        gelu_tanh_into(q, torch.empty_like(q))
    with pytest.raises(ValueError, match="shape"):
        gelu_tanh_into(torch.randn(2, 8), torch.empty(2, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_into_a_buffer_is_the_plain_gelu(dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 9, 96, generator=gen) * 4).to(dtype)
    buf = torch.zeros(2, 9, 32 + 96, dtype=dtype)
    assert gelu_tanh_into(x, buf[..., 32:]).data_ptr() == buf[..., 32:].data_ptr()
    assert torch.equal(buf[..., 32:], F.gelu(x, approximate="tanh"))
    assert not buf[..., :32].any()


def test_the_gelu_kernel_classifies_as_elementwise():
    """The benchmark's breakdown puts the new kernel with the elementwise
    tail (``elementwise_ms_per_step``), as it put the ``F.gelu`` it replaces."""
    with open(os.path.join(CSRC, "gelu.cu")) as f:
        src = f.read()
    assert "gelu_tanh_kernel" in src
    for t in ("__nv_bfloat16", "float"):
        name = f"void (anonymous namespace)::gelu_tanh_kernel<{t}>((anonymous namespace)::GeluArgs)"
        assert kernel_class(name) == "elementwise"
