"""The blocks' copy-free joins on the card: K1's segment route and ``out=``
(``csrc/flash_attention.cu`` behind ``ops/flash_attention.py``), the GELU
kernel (``csrc/gelu.cu`` behind ``ops/gelu.py``) and both blocks on the
route. Everything here needs a CUDA device and skips
without one.

Run on the card (this file imports neither jax nor the tests' conftest):
    python -m pytest tests/test_torch_joins_cuda.py --noconftest -m cuda -q

The limits. K1's segment route changes no arithmetic: out and lse equal the
joint route's bit for bit, at the main path's shapes (1, 24, 4608, 128) and
(2, 24, 5312, 128) with 512 text tokens, as is K1's output written into a
single block's [B, S, 15360] ``proj_out`` input. The GELU kernel does ATen's fp32 arithmetic
in the same order: on every finite bf16 input (all 65536 bit patterns) it
gives ``F.gelu(x, approximate="tanh")``'s bits; at the main path's shapes,
written into ``proj_out``'s input, at least 99.99 % of the elements must be
bit-equal and every one within one bf16 ulp (a limit that a
toolchain whose ``tanhf`` differs from PyTorch's build could reach). A block
on the route is its frozen composition (``tests/test_torch_blocks_joins.py``)
bit for bit where only K1 acts (the double block, with contiguous
out-projection inputs at batch 2), and the single block within the GELU's
ulp carried through ``proj_out``.
"""

import pytest
import torch
import torch.nn.functional as F

from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock, split_heads
from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.ops.gelu import gelu_tanh_into
from reptext_tpu_torch.ops.rope import rope_cos_sin_half
from reptext_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

HEADS, D, TXT = 24, 128, 512
GELU_BIT_EQUAL = 0.9999


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tables(s, dev, d=D):
    ids = torch.zeros(s, 3, device=dev)
    n = s - TXT
    side = int(n ** 0.5)
    ids[TXT:, 1] = torch.arange(n, device=dev) // side
    ids[TXT:, 2] = torch.arange(n, device=dev) % side
    axes = {128: (16, 56, 56), 64: (16, 24, 24), 32: (8, 12, 12)}[d]
    return rope_cos_sin_half(ids, axes, 10000)


def _stream(b, n, dev, gen, h=HEADS, d=D, dtype=torch.bfloat16):
    """A projection's output [B, n, H * D] seen as [B, H, n, D], as the blocks
    hand q, k and v over."""
    return split_heads((torch.randn(b, n, h * d, generator=gen, device=dev) * 1.5).to(dtype), h)


@pytest.mark.parametrize("b,s", [(1, 4608), (2, 5312)])
def test_k1_segments_equal_the_joint_route(dev, b, s):
    gen = torch.Generator(device=dev).manual_seed(s)
    cos, sin = _tables(s, dev)
    q, k, v = ([_stream(b, TXT, dev, gen), _stream(b, s - TXT, dev, gen)] for _ in range(3))
    joint = [torch.cat(x, dim=2) for x in (q, k, v)]
    want, want_lse = fa.flash_attention_rope(*joint, cos, sin)
    launches = fa.flash_attention_rope.launches
    got, lse = fa.flash_attention_rope(tuple(q), tuple(k), tuple(v), cos, sin)
    assert fa.flash_attention_rope.launches == launches + 1
    # each stream's output dense, [B, S_seg, H, D] memory: the head merge is free
    assert all(g.transpose(1, 2).is_contiguous() for g in got)
    assert torch.equal(torch.cat(got, dim=2), want)
    assert torch.equal(lse, want_lse)
    # a single block's proj_out input: the attention columns of [B, S, 15360]
    buf = torch.full((b, s, HEADS * D + 4 * HEADS * D), 7.0, dtype=torch.bfloat16, device=dev)
    fa.flash_attention_rope(*joint, cos, sin, out=split_heads(buf[..., :HEADS * D], HEADS))
    assert torch.equal(buf[..., :HEADS * D], want.transpose(1, 2).reshape(b, s, HEADS * D))
    assert bool((buf[..., HEADS * D:] == 7.0).all())


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (32, torch.float32)])
def test_k1_segments_at_other_head_dims_and_fp32(dev, d, dtype):
    b, s, h = 2, 640 + TXT, 4
    gen = torch.Generator(device=dev).manual_seed(d)
    cos, sin = _tables(s, dev, d)
    q, k, v = ([_stream(b, TXT, dev, gen, h, d, dtype), _stream(b, s - TXT, dev, gen, h, d, dtype)]
               for _ in range(3))
    want, want_lse = fa.flash_attention_rope(*(torch.cat(x, dim=2) for x in (q, k, v)), cos, sin)
    got, lse = fa.flash_attention_rope(tuple(q), tuple(k), tuple(v), cos, sin)
    assert all(g.dtype == dtype for g in got)
    assert torch.equal(torch.cat(got, dim=2), want)
    assert torch.equal(lse, want_lse)


def test_what_the_segment_route_refuses(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    s = 4608
    cos, sin = _tables(s, dev)
    parts = [_stream(1, 500, dev, gen), _stream(1, s - 500, dev, gen)]
    with pytest.raises(ValueError, match="whole"):
        fa.flash_attention_rope(tuple(parts), tuple(parts), tuple(parts), cos, sin)
    joint = torch.cat(parts, dim=2)
    with pytest.raises(ValueError, match="no out"):
        fa.flash_attention_rope(*(3 * [(joint[:, :, :512], joint[:, :, 512:])]), cos, sin,
                                out=torch.empty_like(joint))
    with pytest.raises(TypeError, match="out"):
        fa.flash_attention_rope(joint, joint, joint, cos, sin,
                                out=torch.empty(1, HEADS, s, D, device=dev))   # fp32 out


def _ulp_bf16(m):
    return torch.exp2(torch.floor(torch.log2(m.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)))
                      - 7)


@pytest.mark.parametrize("b,s", [(1, 4608), (2, 5312)])
def test_gelu_kernel_against_aten(dev, b, s):
    gen = torch.Generator(device=dev).manual_seed(b)
    x = (torch.randn(b, s, 12288, generator=gen, device=dev) * 3.0).to(torch.bfloat16)
    x[..., ::101] *= 40.0
    want = F.gelu(x, approximate="tanh")
    buf = torch.full((b, s, 3072 + 12288), 7.0, dtype=torch.bfloat16, device=dev)
    launches = gelu_tanh_into.launches
    gelu_tanh_into(x, buf[..., 3072:])
    assert gelu_tanh_into.launches == launches + 1
    got = buf[..., 3072:]
    diff = (got.float() - want.float()).abs()
    m = torch.maximum(got.float().abs(), want.float().abs())
    assert bool((diff <= _ulp_bf16(m)).all())
    assert (got == want).float().mean().item() >= GELU_BIT_EQUAL
    assert bool((buf[..., :3072] == 7.0).all())


def test_gelu_kernel_on_every_bf16_input(dev):
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).to(dev).reshape(256, 256)
    out = torch.empty_like(x)
    gelu_tanh_into(x, out)
    want = F.gelu(x, approximate="tanh")
    finite = torch.isfinite(x)
    assert torch.equal(out.view(torch.int16)[finite], want.view(torch.int16)[finite])


def test_gelu_kernel_in_fp32_and_contiguous(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(3, 100, 256, generator=gen, device=dev) * 4
    out = torch.empty_like(x)
    gelu_tanh_into(x, out)
    want = F.gelu(x, approximate="tanh")
    assert torch.allclose(out, want, rtol=2e-6, atol=1e-7)


def _randomize(module, gen, scale=0.02):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * scale
                    + (1.0 if p.dim() == 1 and p.shape[0] == D else 0.0))
    return module


@pytest.mark.parametrize("b", [1, 2])
def test_blocks_on_the_route_against_the_frozen_composition(dev, b):
    from test_torch_blocks_joins import frozen_joint, frozen_single

    gen = torch.Generator(device=dev).manual_seed(b)
    s_img = 4096
    dim = HEADS * D
    joint = _randomize(JointTransformerBlock(dim, HEADS, D, device=dev), gen).to(torch.bfloat16)
    single = _randomize(SingleTransformerBlock(dim, HEADS, D, device=dev), gen).to(torch.bfloat16)
    img = torch.randn(b, s_img, dim, generator=gen, device=dev).to(torch.bfloat16)
    txt = torch.randn(b, TXT, dim, generator=gen, device=dev).to(torch.bfloat16)
    temb = torch.randn(b, dim, generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = _tables(TXT + s_img, dev)
    timings = {}
    with torch.inference_mode():
        with profiling.request_trace(timings, dev):
            ctx, x = joint(img, txt, temb, cos, sin)
            seq = torch.cat([ctx, x], dim=1)
            out = single(seq, temb, cos, sin, None, TXT)
            torch.cuda.synchronize()   # the spans' events, read when the request ends
        assert timings["trace"]["counters"]["joins"] == {"inplace": 2, "copied": 0}
        want_ctx, want_x = frozen_joint(joint, img, txt, temb, cos, sin, contiguous_out=b == 2)
        assert torch.equal(ctx, want_ctx) and torch.equal(x, want_x)
        want = frozen_single(single, seq, temb, cos, sin)
    rel = ((out.float() - want.float()).abs().max() / want.float().abs().max()).item()
    assert rel <= 2.0 ** -7, rel
