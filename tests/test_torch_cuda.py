"""The port's CUDA flash-attention kernels (forward K1/K2/K3, backward K4
with its preprocess pass, the attention A/B variants, K5's ring step) against
their plain PyTorch versions, on the card, the RoPE entry's route (K1, or the fp32 rotation then K2 at one chunk or
K3 past 6144 tokens), and gradients through a transformer block. Everything
here needs a CUDA device and skips without one.

Run on the card (this file imports neither jax nor the tests' conftest):
    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances as chip_smoke.py states them: out within 2^-6 of max|plain out|
(two bf16 ulps at the top of the output's range; the sums are reordered, so an
element may land one ulp away), lse 1e-3; dq, dk, dv within 2^-5 of
max|plain| (max-abs) and 2^-7 of mean|plain| (mean-abs): the kernel and its
plain version round p and ds to bf16 at the same points but sum thousands of
products in another order. The variants as chip_smoke.py states them: out
within 2^-6 of max|plain out| (chunked, exp2) and 2^-5 (bf16 exp, whose kernel
rounds the exponential's argument at another point than its plain version).
K5's step: its normalised output (acc / l) within 2^-6 of max|plain| (p is
rounded to bf16 for PV where the plain version keeps fp32), the running max
within 1e-3 and the row sums within 1e-3 relative (both from fp32 logits of
the same bf16 inputs, summed in another order).

The kernel against its emulation (tests/torch_port_util.py::emulated_key_loop,
the key loop in plain PyTorch, tile by tile, which the CPU tests hold against
the plain versions): both round p to bf16 against the same running max, so
they differ only in the order of fp32 sums and in ex2.approx's last bits. With
the running max the kernel must lie at least four times closer to the
emulation than to its plain version (mean-abs; clamped, the softmax is
max-free, the tiles' order drops out and the two are one function), lse and the ring state's m within 5e-5, l within 5e-5
relative, and the fp32 state's acc within 2^-9 of max|acc| (one p that rounds
to the neighbouring bf16 moves an element by up to 2^-8 p |v|).

The backward against its emulation (torch_port_util.emulated_backward_loop:
128 keys owned, 64-query tiles streamed, exp2 on log2 units, bf16 p and ds):
both round p and ds at the same points from the same log2-unit logits, so
they differ in the order of fp32 sums, in ex2.approx's last bits and, for dq,
in the order its partial sums land: every gradient within 2^-7 of max|emulated|
(one bf16 step at the top of its range) and 2^-10 of mean|emulated| (mean-abs),
eight times closer than the limit against the plain version. dq, dk and dv are
bit-equal across calls: dq's partial sums land in key order.

A union ControlNet's joint sequence ends in a partial tile (its mode token in
front of the text): the net through K1 at S = 5121 against the same net
through the plain attention, within 5e-2 of max|plain| (bf16 through two
blocks, the small-model reference's limit in chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

from reptext_tpu_torch.ops import attention_variants as av
from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.ops import ring_attention as ra
from reptext_tpu_torch.ops.attention import attention, plain_attention
from reptext_tpu_torch.ops.rope import apply_rope_half, rope_cos_sin_half
from torch_port_util import LOG2E, emulated_backward_loop, emulated_key_loop

pytestmark = pytest.mark.cuda


def _out_err_ok(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err <= 2.0 ** -6 * want.float().abs().max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, b, h, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, 128, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    r = np.random.default_rng(seed)
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1], ids[:, 2] = np.arange(s) % 37, r.integers(0, 29, s)
    cos, sin = rope_cos_sin_half(torch.from_numpy(ids).to(dev), (16, 56, 56))
    return q, k, v, cos, sin


def _counts():
    return (fa.flash_attention_rope.launches, fa.flash_attention.launches,
            fa.flash_attention_streaming.launches)


def _rope_plain(q, k, v, cos, sin, online=None):
    """The plain version of the RoPE entry's route at q's length, and the
    (K1, K2, K3) launches the route makes."""
    s = q.shape[2]
    if fa.rope_fused(s):
        return fa.flash_attention_rope_plain(q, k, v, cos, sin, online), (1, 0, 0)
    qr, kr = apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin)
    if fa.streams(s):
        return fa.flash_attention_streaming_plain(qr, kr, v, online), (0, 0, 1)
    return fa.flash_attention_plain(qr, kr, v, online), (0, 1, 0)


@pytest.mark.parametrize("b,h,s", [(1, 4, 4608), (2, 2, 1001), (1, 1, 5)])
@pytest.mark.parametrize("online", [False, True])
def test_kernel_matches_plain(dev, b, h, s, online):
    q, k, v, cos, sin = _inputs(dev, b, h, s)
    before = _counts()
    want_rope, route = _rope_plain(q, k, v, cos, sin, online)
    pairs = ((fa.flash_attention_rope(q, k, v, cos, sin, online), want_rope),
             (fa.flash_attention(q, k, v, online), fa.flash_attention_plain(q, k, v, online)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got[0].shape == (b, h, s, 128) and got[1].shape == (b, h, s)
        assert _out_err_ok(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 1e-3
    n1, n2, n3 = (a - b for a, b in zip(_counts(), before))
    assert (n1, n2, n3) == (route[0], route[1] + 1, route[2])


@pytest.mark.parametrize("b,h,s", [(1, 2, 6500), (2, 1, 7424), (1, 1, 100)])
@pytest.mark.parametrize("online", [False, True])
def test_streaming_kernel_matches_plain(dev, b, h, s, online):
    """K3 on pre-rotated q and k, at unaligned and aligned lengths and, through
    its direct entry, below the threshold; the RoPE entry past 6144 tokens
    launches K3 once and neither K1 nor K2."""
    q, k, v, cos, sin = _inputs(dev, b, h, s, seed=s)
    before = _counts()
    got = fa.flash_attention_streaming(q, k, v, online)
    want = fa.flash_attention_streaming_plain(q, k, v, online)
    torch.cuda.synchronize()
    assert got[0].shape == (b, h, s, 128) and got[0].dtype == torch.bfloat16
    assert _out_err_ok(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 1)
    if fa.streams(s):
        before = _counts()
        got = fa.flash_attention_rope(q, k, v, cos, sin, online)
        want, route = _rope_plain(q, k, v, cos, sin, online)
        assert route == (0, 0, 1)
        assert tuple(a - b for a, b in zip(_counts(), before)) == route
        assert _out_err_ok(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 1e-3


def test_streaming_kernel_beyond_the_clamp(dev):
    """Planted logits up to 80 (the scale folds back onto the fp32 logits)."""
    s, d = 1000, 128
    q = torch.zeros(1, 2, s, d, device=dev)
    k = torch.zeros(1, 2, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, 2, s, d, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention_streaming(q, k, v, online=False)
    want = fa.flash_attention_streaming_plain(q, k, v, online=False)
    assert _out_err_ok(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert fa.flash_attention_streaming_plain(q, k, v, online=True)[1].max() > fa.LOGIT_CLAMP


def test_gradients_through_the_streaming_route(dev):
    """Past 6144 tokens the RoPE entry's backward is K4 with K3's lse."""
    q, k, v, cos, sin = _inputs(dev, 1, 1, 6200, seed=6)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    n3, n4 = fa.flash_attention_streaming.launches, fa.flash_attention_backward.launches
    out, lse = fa.flash_attention_rope(q, k, v, cos, sin)
    g = torch.randn_like(out)
    out.backward(g)
    assert (fa.flash_attention_streaming.launches, fa.flash_attention_backward.launches) == (
        n3 + 1, n4 + 1)
    qr, kr = apply_rope_half(q.detach(), cos, sin), apply_rope_half(k.detach(), cos, sin)
    want = fa.flash_attention_backward_plain(qr, kr, v.detach(), out.detach(), lse, g)
    got = (apply_rope_half(want[0], cos, -sin), apply_rope_half(want[1], cos, -sin), want[2])
    for x, y in zip((q.grad, k.grad, v.grad), got):
        assert _grad_ok(x, y)


def test_strided_inputs_and_attention_entry(dev):
    """q/k/v as [B, S, H, D] buffers viewed [B, H, S, D], as the blocks make them;
    attention() on CUDA tensors goes to the kernel."""
    for s in (300, 1001, 6200):      # one chunk (K2), fused (K1), streaming (K3)
        q, k, v, cos, sin = _inputs(dev, 1, 4, s, seed=1)
        qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        before = _counts()
        got = attention(qs, ks, vs, cos, sin)
        want, route = _rope_plain(q, k, v, cos, sin)
        assert tuple(a - b for a, b in zip(_counts(), before)) == route
        assert _out_err_ok(got, want[0])


@pytest.mark.parametrize("s", [128, 127, 64, 1])
@pytest.mark.parametrize("online", [False, True])
def test_one_cta_of_queries_and_less(dev, s, online):
    """Sq of one 128-row CTA and less: the second consumer warpgroup's rows,
    or all but one row, lie past the end; one key tile, partly masked."""
    q, k, v, _, _ = _inputs(dev, 2, 3, s, seed=s)
    for entry, plain in ((fa.flash_attention, fa.flash_attention_plain),
                         (fa.flash_attention_streaming, fa.flash_attention_streaming_plain)):
        got, want = entry(q, k, v, online), plain(q, k, v, online)
        torch.cuda.synchronize()
        assert got[0].shape == (2, 3, s, 128) and bool(torch.isfinite(got[0].float()).all())
        assert _out_err_ok(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 1e-3


def _mean_err(got, want):
    return (got.float() - want.float()).abs().mean().item()


@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_kernel_matches_its_emulated_key_loop(dev, kernel, online):
    """1001 keys (eight 128-key tiles, the last one partly masked): the kernel
    is the loop that ``emulated_key_loop`` spells out, far closer to it than
    to the plain version's single softmax over all keys."""
    q, k, v, cos, sin = _inputs(dev, 2, 2, 1001, seed=21)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if kernel == "K1":
        assert fa.rope_fused(1001)
        got = fa.flash_attention_rope(q, k, v, cos, sin, online)
        plain = fa.flash_attention_rope_plain(q, k, v, cos, sin, online)
        cos_b, sin_b = (x.to(torch.bfloat16).float() for x in (cos, sin))
        qp = (apply_rope_half(q.float(), cos_b, sin_b) * scale).to(q.dtype)
        emu = emulated_key_loop(qp, apply_rope_half(k, cos_b, sin_b), v, LOG2E, online)
    elif kernel == "K2":
        got = fa.flash_attention(q, k, v, online)
        plain = fa.flash_attention_plain(q, k, v, online)
        emu = emulated_key_loop((q.float() * scale).to(q.dtype), k, v, LOG2E, online)
    else:
        got = fa.flash_attention_streaming(q, k, v, online)
        plain = fa.flash_attention_streaming_plain(q, k, v, online)
        emu = emulated_key_loop(q, k, v, scale * LOG2E, online)
    torch.cuda.synchronize()
    to_emu, to_plain = _mean_err(got[0], emu[0]), _mean_err(got[0], plain[0])
    lse_err = (got[1] - emu[1]).abs().max().item()
    report = f"out mean-abs to emulation {to_emu:.3e}, to plain {to_plain:.3e}; lse {lse_err:.3e}"
    if online:   # clamped, p is rounded against no maximum: plain and emulation agree
        assert 4 * to_emu <= to_plain, report
    # an element lands at most one bf16 step from the emulation's
    assert (got[0].float() - emu[0].float()).abs().max().item() <= (
        2.0 ** -7 * emu[0].float().abs().max().item()), report
    assert lse_err <= 5e-5, report


def test_ring_step_matches_its_emulated_key_loop(dev):
    """K5's fp32 state after every step over unequal blocks, both sides
    carrying their own state (m through natural units and back)."""
    sks = (512, 333, 8, 700)
    q, blocks = _ring_inputs(dev, 1, 2, 200, sks, seed=23)
    mul = LOG2E / math.sqrt(q.shape[-1])
    got = emu = plain = None
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(sks) - 1
        got = ra.ring_step(q, k, v, got, first, last)
        emu = emulated_key_loop(q, k, v, mul, True, state=emu, first=first, last=last, carry=True)
        plain = ra.ring_step_plain(q, k, v, plain, first, last)
        torch.cuda.synchronize()
        if last:
            assert (got.float() - emu.float()).abs().max().item() <= (
                2.0 ** -7 * emu.float().abs().max().item())
            break
        to_emu, to_plain = _mean_err(got[0], emu[0]), _mean_err(got[0], plain[0])
        acc_err = (got[0] - emu[0]).abs().max().item() / emu[0].abs().max().item()
        m_err = (got[1] - emu[1]).abs().max().item()
        l_err = ((got[2] - emu[2]).abs() / emu[2]).max().item()
        report = (f"step {i}: acc mean-abs to emulation {to_emu:.3e}, to plain {to_plain:.3e}; "
                  f"acc max-abs/max|acc| {acc_err:.3e}; m {m_err:.3e}; l rel {l_err:.3e}")
        assert 4 * to_emu <= to_plain, report
        assert acc_err <= 2.0 ** -9 and m_err <= 5e-5 and l_err <= 5e-5, report


def test_layouts_a_tensor_map_takes(dev):
    """K and V reach shared memory through TMA tensor maps over the caller's
    strides: a window of a longer sequence (a shifted, 16-byte-aligned base),
    heads taken from a wider buffer, and a batch of one viewed from a
    [S, H, D] buffer all go to the kernel as they are."""
    big_q, big_k, big_v, _, _ = _inputs(dev, 2, 6, 700, seed=11)
    window = tuple(x[:, 1:5, 37:637] for x in (big_q, big_k, big_v))
    shd = tuple(x[0].transpose(0, 1).contiguous().transpose(0, 1)[None] for x in window)
    for q, k, v in (window, shd):
        assert not q.is_contiguous()
        n = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous())
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == n + 1
        assert _out_err_ok(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 1e-3


def test_layouts_no_tensor_map_takes_are_refused(dev):
    """A stride that is not a multiple of 16 bytes, a broadcast (zero) stride
    and a base off the 16-byte grid are refused by the wrapper, before any
    launch."""
    q, k, v, _, _ = _inputs(dev, 2, 2, 64, seed=12)
    n = fa.flash_attention.launches
    wide = torch.zeros(2, 2, 64, 132, dtype=torch.bfloat16, device=dev)
    odd_rows = wide[..., :128]                      # row stride 132 elements
    broadcast = k[:1].expand(2, -1, -1, -1)         # batch stride 0
    flat = torch.zeros(k.numel() + 8, dtype=torch.bfloat16, device=dev)
    shifted = flat[4:4 + k.numel()].view(k.shape)   # base 8 bytes off the grid
    for bad in (odd_rows, broadcast, shifted):
        with pytest.raises(ValueError, match="strides"):
            fa.flash_attention(q, bad, v)
        with pytest.raises(ValueError, match="strides"):
            ra.ring_step(q, k, bad, None, True, True)
    assert fa.flash_attention.launches == n


def test_ulysses_local_attention_is_exact(dev):
    """With logits planted beyond the clamp, Ulysses over thread ranks is the
    exact softmax (the running-max kernel), as the reference's is, and not the
    clamped kernel the one-card path keeps."""
    from reptext_tpu_torch.parallel.sequence import sequence_sharded_attention
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    s, d = 1024, 128
    q = torch.zeros(1, 4, s, d, device=dev)
    k = torch.zeros(1, 4, s, d, device=dev)
    q[..., 0] = 80.0 * d ** 0.5
    k[..., 0] = torch.linspace(-1.0, 1.0, s, device=dev)
    v = torch.randn(1, 4, s, d, device=dev)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    n = fa.flash_attention.launches
    got = torch.cat(run_spmd(LocalSPGroup(2, dev), lambda g: sequence_sharded_attention(
        g.shard(q, 2), g.shard(k, 2), g.shard(v, 2), g, "ulysses")), dim=2)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 2
    want = plain_attention(q, k, v)
    assert _out_err_ok(got, want)
    assert not _out_err_ok(got, fa.flash_attention(q, k, v, online=False)[0])
    assert not _out_err_ok(attention(q, k, v), want)   # the one-card path stays clamped


def test_kernel_rejects_what_it_does_not_take(dev):
    """fp16 and fp64, mixed dtypes and a head dim of none of the
    instantiations (48) are refused; fp32 and head dims 64 and 32 are taken
    (the cases below)."""
    q, k, v, cos, sin = _inputs(dev, 1, 2, 64, seed=2)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="q torch.float32"):
        fa.flash_attention(q.float(), k, v.float())
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    # at 1001 keys the route fuses the rotation into K1, which takes fp32 tables only
    q, k, v, cos, sin = _inputs(dev, 1, 2, 1001, seed=2)
    with pytest.raises(ValueError, match="rope_cos"):
        fa.flash_attention_rope(q, k, v, cos.to(torch.bfloat16), sin)


def _bwd_inputs(dev, b, h, s, online, seed=0):
    """Rotated q/k, v, K1's out and lse, and dO in the layout merge_heads'
    gradient arrives in (a [B, S, H, D] buffer viewed [B, H, S, D])."""
    q, k, v, cos, sin = _inputs(dev, b, h, s, seed)
    out, lse = fa.flash_attention_rope(q, k, v, cos, sin, online)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(b, s, h, 128, generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    return apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v, out, lse, do


def _grad_ok(got, want):
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    return (err.max().item() <= 2.0 ** -5 * ref.max().item()
            and err.mean().item() <= 2.0 ** -7 * ref.mean().item())


@pytest.mark.parametrize("b,h,s", [(1, 2, 1000), (2, 24, 4106)])
@pytest.mark.parametrize("online", [False, True])
def test_backward_kernel_matches_plain(dev, b, h, s, online):
    args = _bwd_inputs(dev, b, h, s, online)
    n = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(*args, online=online)
    want = fa.flash_attention_backward_plain(*args, online=online)
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n + 1
    for x, y in zip(got, want):
        assert x.shape == (b, h, s, 128) and x.dtype == torch.bfloat16
        assert bool(torch.isfinite(x.float()).all())
        assert _grad_ok(x, y)


def _near_emulation(got, want):
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    return (err.max().item() <= 2.0 ** -7 * ref.max().item()
            and err.mean().item() <= 2.0 ** -10 * ref.mean().item())


@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
@pytest.mark.parametrize("b,h,s", [(2, 2, 1000), (1, 2, 4106), (1, 3, 128), (2, 1, 64)])
def test_backward_kernel_matches_its_emulated_loop(dev, b, h, s, online):
    """Batch 2 with ragged last tiles (1000 = 7 x 128 + 104 keys, 15 x 64 + 40
    queries), 4106, one key block, one query tile."""
    args = _bwd_inputs(dev, b, h, s, online, seed=s)
    got = fa.flash_attention_backward(*args, online=online)
    emu = emulated_backward_loop(*args, online=online)
    torch.cuda.synchronize()
    for x, y in zip(got, emu):
        assert x.shape == (b, h, s, 128) and x.dtype == torch.bfloat16
        assert _near_emulation(x, y)


@pytest.mark.parametrize("s", [1, 17, 63])
@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
def test_backward_under_one_query_tile(dev, s, online):
    """S of less than one 64-query tile: the maps zero-fill, the kernel masks."""
    q, k, v, _, _ = _inputs(dev, 2, 3, s, seed=s)
    out, lse = fa.flash_attention(q, k, v, online)
    do = torch.randn_like(out)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, online=online)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do, online=online)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    if s == 1:
        # one key: ds = p (dp - delta) is 0 but for the forward's bf16 rounding of
        # p (clamped) or for rounding noise alone (online, where p = 1: |dp| ~ 10
        # at a relative 1e-6, times k / sqrt(D)), so dq and dk get an absolute
        # floor beside the relative limit
        for x, y in zip(got[:2], want[:2]):
            err = (x.float() - y.float()).abs().max().item()
            assert err <= 2.0 ** -5 * y.float().abs().max().item() + 1e-5
        got, want = got[2:], want[2:]
    for x, y in zip(got, want):
        assert _grad_ok(x, y)


def test_backward_on_the_streaming_kernels_lse(dev):
    """Past 6144 tokens the forward is K3; K4 recomputes p from its lse."""
    q, k, v, _, _ = _inputs(dev, 1, 2, 6200, seed=8)
    out, lse = fa.flash_attention_streaming(q, k, v)
    do = torch.randn_like(out)
    got = fa.flash_attention_backward(q, k, v, out, lse, do)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do)
    for x, y in zip(got, want):
        assert _grad_ok(x, y)


def test_backward_preprocess_matches_plain(dev):
    """delta = sum(dO * O) within 2^-20 of max|plain| (fp32 sums of 128
    products in another order), lse * log2(e) to the last bit or one, zeros in
    the padding to a multiple of 64 rows; out and dO strided as they arrive."""
    _, _, _, out, lse, do = _bwd_inputs(dev, 2, 3, 1000, online=False, seed=13)
    delta, lse2 = fa.backward_preprocess(out, lse, do)
    p_delta, p_lse2 = fa.backward_preprocess_plain(out, lse, do)
    torch.cuda.synchronize()
    assert delta.shape == lse2.shape == p_delta.shape == (2, 3, 1024)
    assert (delta - p_delta).abs().max().item() <= 2.0 ** -20 * p_delta.abs().max().item()
    assert (lse2 - p_lse2).abs().max().item() <= 1e-5
    assert not bool(delta[..., 1000:].any()) and not bool(lse2[..., 1000:].any())


def test_backward_twice_dk_dv_bit_equal_and_copied_layouts(dev):
    """Two calls on the same inputs: dq, dk and dv to the bit (dq's partial
    sums land in key order). A dO no tensor map takes (an expanded sum()
    gradient: zero strides) is copied."""
    args = _bwd_inputs(dev, 2, 4, 1000, online=False, seed=17)
    first = fa.flash_attention_backward(*args)
    second = fa.flash_attention_backward(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    q, k, v, out, lse, _ = args
    ones = torch.ones((), dtype=torch.bfloat16, device=dev).expand(q.shape)
    assert not fa._kernel_strides(ones)
    n = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, out, lse, ones)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, ones)
    assert fa.flash_attention_backward.launches == n + 1
    for x, y in zip(got, want):
        assert _grad_ok(x, y)


def test_gradients_flow_through_the_kernels(dev, monkeypatch):
    """A loss through one JointTransformerBlock on the card reaches the q
    projection through K1 and K4, and agrees with the same block run with plain
    attention (autograd through the softmax) within 5e-2 of max|plain grad|."""
    from reptext_tpu_torch.nn import blocks
    from reptext_tpu_torch.nn.init import random_init_

    gen = torch.Generator().manual_seed(0)
    block = random_init_(blocks.JointTransformerBlock(256, 2, 128), gen)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    block = block.to(dev, torch.bfloat16)
    s_txt, s_img = 56, 200
    img = torch.randn(1, s_img, 256, generator=gen).to(dev, torch.bfloat16)
    txt = torch.randn(1, s_txt, 256, generator=gen).to(dev, torch.bfloat16)
    temb = torch.randn(1, 256, generator=gen).to(dev, torch.bfloat16)
    w_img = torch.randn(1, s_img, 256, generator=gen).to(dev)
    w_txt = torch.randn(1, s_txt, 256, generator=gen).to(dev)
    _, _, _, cos, sin = _inputs(dev, 1, 1, s_txt + s_img, seed=3)

    def q_grad():
        block.zero_grad(set_to_none=True)
        ctx, x = block(img, txt, temb, cos, sin)
        ((x.float() * w_img).sum() + (ctx.float() * w_txt).sum()).backward()
        return block.to_q.weight.grad.float().clone()

    before, n4 = _counts(), fa.flash_attention_backward.launches
    got = q_grad()
    # 256 joint tokens: one chunk, so the fp32 rotation and K2 (then K4)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 1, 0)
    assert fa.flash_attention_backward.launches == n4 + 1
    monkeypatch.setattr(blocks, "attention", lambda q, k, v, c, s: plain_attention(
        apply_rope_half(q, c, s), apply_rope_half(k, c, s), v))
    want = q_grad()
    assert got.abs().max().item() > 0
    assert (got - want).abs().max().item() <= 5e-2 * want.abs().max().item()


@pytest.mark.parametrize("s", [4608, 5121])
def test_backward_dq_is_bit_equal_over_calls(dev, s):
    """Three calls at an aligned length and at one that ends in a partial
    tile: dq, dk, dv bit-equal, and dq within the kernel's tolerance of its
    plain version."""
    args = _bwd_inputs(dev, 1, 4, s, online=False, seed=23)
    runs = [fa.flash_attention_backward(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    assert _grad_ok(runs[0][0], fa.flash_attention_backward_plain(*args)[0])


def test_union_controlnet_takes_k1_at_5121(dev, monkeypatch):
    """A union ControlNet (1 + 1 blocks, 2 heads of 128) over 1024 text
    tokens, its mode token and 4096 image tokens: K1 at S = 5121 (one launch
    per block), against the same net through the plain attention."""
    from reptext_tpu_torch.configs import ControlNetConfig
    from reptext_tpu_torch.models.controlnet import RepTextControlNet
    from reptext_tpu_torch.nn import blocks
    from reptext_tpu_torch.nn.init import random_init_
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids

    cfg = ControlNetConfig(num_layers=1, num_single_layers=1, num_attention_heads=2,
                           joint_attention_dim=64, pooled_projection_dim=32, num_mode=10)
    gen = torch.Generator().manual_seed(1)
    net = random_init_(RepTextControlNet(cfg), gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    net = net.to(dev, torch.bfloat16)
    s_txt = 1024

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    args = (rnd(1, 4096, cfg.in_channels),
            rnd(1, 4096, cfg.in_channels + cfg.extra_condition_channels),
            rnd(1, s_txt, cfg.joint_attention_dim), rnd(1, cfg.pooled_projection_dim),
            torch.full((1,), 0.5, device=dev), prepare_latent_image_ids(128, 128, dev),
            torch.zeros(s_txt, 3, device=dev), torch.full((1,), 3.5, device=dev))
    mode = torch.tensor([2], device=dev)
    before = _counts()
    with torch.no_grad():
        got = net(*args, mode=mode)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (2, 0, 0)
    assert fa.rope_fused(s_txt + 1 + 4096)

    def plain(q, k, v, c, s, out=None):   # the single block writes through out=
        o = plain_attention(apply_rope_half(q, c, s), apply_rope_half(k, c, s), v)
        return o if out is None else out.copy_(o)

    monkeypatch.setattr(blocks, "attention", plain)
    with torch.no_grad():
        want = net(*args, mode=mode)
    for g, w in zip(got, want):
        assert g.float().abs().max().item() > 0
        assert (g.float() - w.float()).abs().max().item() <= 5e-2 * w.float().abs().max().item()


def test_backward_rejects_what_it_does_not_take(dev):
    args = _bwd_inputs(dev, 1, 2, 64, online=False, seed=4)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention_backward(*(x.half() if x.dtype == torch.bfloat16 else x for x in args))
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_backward(*(x[..., :48] if x.dim() == 4 else x for x in args))


# ---------------------------------------------- head dim 64, fp32 (the overfit demo)
#
# The trained-weights demo (examples/overfit_e2e.py) runs FLUX 2 + 4 and its
# ControlNet at head dim 64 in fp32: 64 image + 5 text tokens, so S = 69, one
# partial 128-key tile and two 64-query tiles; K2 forward (the route rotates
# outside at one chunk) and K4 behind it. In bf16 the kernel and its plain
# version round at the same points: the limits above. An fp32 call rounds q,
# k, v and dO to bf16 for the products, where the plain version keeps fp32:
# out within 2^-6 of max|plain out| (each logit moves by about 2^-9 of
# |q||k| / sqrt(D), each p and v by 2^-9), lse within 2^-6 absolute (a
# weighted mean of the logits' errors), gradients within the limits above.
D64_RTOL_LSE_FP32 = 2.0 ** -6


def _inputs64(dev, b, h, s, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, 64, generator=g, device=dev).to(dtype) for _ in range(4))
    r = np.random.default_rng(seed)
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1], ids[:, 2] = np.arange(s) % 8, r.integers(0, 8, s)
    cos, sin = rope_cos_sin_half(torch.from_numpy(ids).to(dev), (8, 28, 28))
    return q, k, v, do, cos, sin


def _fwd_ok(got, want, dtype):
    lse_lim = 1e-3 if dtype == torch.bfloat16 else D64_RTOL_LSE_FP32
    return (got[0].dtype == dtype and got[1].dtype == torch.float32
            and bool(torch.isfinite(got[0]).all()) and _out_err_ok(got[0], want[0])
            and (got[1] - want[1]).abs().max().item() <= lse_lim)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,s", [(16, 4, 69), (1, 4, 69), (2, 3, 1), (2, 3, 129)])
def test_d64_k2_and_k4_at_the_demo_shapes(dev, dtype, b, h, s):
    """K2 and K4 at the demo's training (16, 4, 69, 64) and sampling (1, 4, 69,
    64) shapes, and at S = 1 and 129 (one key, one query tile past a CTA)."""
    q, k, v, do, _, _ = _inputs64(dev, b, h, s, dtype, seed=s + b)
    n2, n4 = fa.flash_attention.launches, fa.flash_attention_backward.launches
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got[0].shape == (b, h, s, 64) and _fwd_ok(got, want, dtype)
    grads = fa.flash_attention_backward(q, k, v, got[0], got[1], do)
    plain = fa.flash_attention_backward_plain(q, k, v, got[0], got[1], do)
    if s == 1:
        # one key: out is v, so dq and dk are rounding noise (see the S = 1
        # test above); in fp32 the plain version's dp = dO v and delta = dO out
        # would differ by the kernel's bf16 rounding of v (2^-9 |dO| |v|), so
        # it takes the kernel's bf16 operands there
        ops = [x.to(torch.bfloat16).to(dtype) for x in (q, k, v, do)]
        plain = fa.flash_attention_backward_plain(*ops[:3], got[0], got[1], ops[3])
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - n2, fa.flash_attention_backward.launches - n4) == (1, 1)
    for x, y in zip(grads, plain):
        assert x.shape == (b, h, s, 64) and x.dtype == dtype
        assert bool(torch.isfinite(x).all())
        if s == 1:
            err = (x.float() - y.float()).abs().max().item()
            assert err <= 2.0 ** -5 * y.float().abs().max().item() + 1e-5
        else:
            assert _grad_ok(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_d64_route_and_autograd_through_attention(dev, dtype):
    """The block's entry at the demo's length: the RoPE route rotates in fp32
    and takes K2 (one chunk), the gradients come back through K4, in the
    input's dtype, against autograd through the plain route."""
    q, k, v, do, cos, sin = _inputs64(dev, 2, 4, 69, dtype, seed=3)
    assert not fa.rope_fused(69)
    before = _counts()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention(*leaves, cos, sin)
    out.backward(do)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 1, 0)
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = fa.flash_attention_plain(apply_rope_half(ref[0], cos, sin),
                                    apply_rope_half(ref[1], cos, sin), ref[2])[0]
    want.backward(do)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _out_err_ok(out, want)
    for x, y in zip(leaves, ref):
        assert x.grad.dtype == dtype and _grad_ok(x.grad, y.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_d64_k1_and_k3(dev, dtype):
    """K1 (RoPE fused, 1001 tokens: more than one chunk) and K3 at D = 64."""
    q, k, v, _, cos, sin = _inputs64(dev, 1, 4, 1001, dtype, seed=5)
    assert fa.rope_fused(1001)
    n1, n3 = fa.flash_attention_rope.launches, fa.flash_attention_streaming.launches
    got1 = fa.flash_attention_rope(q, k, v, cos, sin)
    got3 = fa.flash_attention_streaming(q, k, v)
    torch.cuda.synchronize()
    assert (fa.flash_attention_rope.launches - n1, fa.flash_attention_streaming.launches - n3) \
        == (1, 1)
    assert _fwd_ok(got1, fa.flash_attention_rope_plain(q, k, v, cos, sin), dtype)
    assert _fwd_ok(got3, fa.flash_attention_streaming_plain(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_d64_backward_is_bit_equal_over_calls(dev, dtype):
    """At D = 64 both consumer warpgroups add a partial dq over the same
    channels; the counter orders them behind the key tiles: bit-equal."""
    q, k, v, do, _, _ = _inputs64(dev, 2, 4, 1000, dtype, seed=7)
    out, lse = fa.flash_attention(q, k, v)
    first = fa.flash_attention_backward(q, k, v, out, lse, do)
    second = fa.flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for x, y in zip(first, fa.flash_attention_backward_plain(q, k, v, out, lse, do)):
        assert _grad_ok(x, y)


# ---------------------------------------------- head dim 32 (the --tiny demo)
#
# The CLI's --tiny runs FLUX 2 + 4 and the ControlNet at 4 heads x 32 in fp32
# on the card, as the JAX CLI runs it: K1 at 1024^2 (S = 4096 + 512), K2 at
# one chunk, K3 at 1536^2 (S = 9728), K4 behind them (train at batch 2) and
# K5 over two ranks. At D = 32 a row is 64 bytes under the 64-byte swizzle
# (the tensor maps, the q' tile and every wgmma descriptor, K-major and
# MN-major), so these cases hold that layout against the plain versions, at
# the limits of the D = 64 cases above; K5's running max in fp32 within 1e-3
# plus what rounding q and k to bf16 moves a logit by (2^-8 |q| max|k| / sqrt(D)).


def _inputs32(dev, b, h, s, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, 32, generator=g, device=dev).to(dtype) for _ in range(4))
    r = np.random.default_rng(seed)
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1], ids[:, 2] = np.arange(s) % 64, r.integers(0, 64, s)
    cos, sin = rope_cos_sin_half(torch.from_numpy(ids).to(dev), (8, 12, 12))
    return q, k, v, do, cos, sin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,s", [(1, 4, 4608), (2, 4, 1), (2, 4, 129)])
def test_d32_k1_and_k2_at_the_tiny_shapes(dev, dtype, b, h, s):
    """K2 at the 1024^2 request's (1, 4, 4608, 32), at S = 1 and 129; K1
    where the route fuses the rotation (4608 tokens)."""
    q, k, v, _, cos, sin = _inputs32(dev, b, h, s, dtype, seed=s + b)
    before = _counts()
    got2 = fa.flash_attention(q, k, v)
    got1 = fa.flash_attention_rope(q, k, v, cos, sin) if fa.rope_fused(s) else None
    torch.cuda.synchronize()
    assert got2[0].shape == (b, h, s, 32)
    assert _fwd_ok(got2, fa.flash_attention_plain(q, k, v), dtype)
    if got1 is not None:
        assert _fwd_ok(got1, fa.flash_attention_rope_plain(q, k, v, cos, sin), dtype)
    n1, n2, n3 = (a - c for a, c in zip(_counts(), before))
    assert (n1, n2, n3) == (int(got1 is not None), 1, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
def test_d32_k3_at_the_1536_shape(dev, dtype, online):
    """K3 at the 1536^2 request's (1, 4, 9728, 32), and the RoPE route there
    (the fp32 rotation, then K3)."""
    q, k, v, _, cos, sin = _inputs32(dev, 1, 4, 9728, dtype, seed=9)
    assert fa.streams(9728)
    before = _counts()
    got = fa.flash_attention_streaming(q, k, v, online)
    routed = fa.flash_attention_rope(q, k, v, cos, sin, online)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_counts(), before)) == (0, 0, 2)
    assert _fwd_ok(got, fa.flash_attention_streaming_plain(q, k, v, online), dtype)
    want, _ = _rope_plain(q, k, v, cos, sin, online)
    assert _fwd_ok(routed, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,s", [(2, 4, 4608), (2, 3, 1), (2, 3, 129)])
def test_d32_k4_at_the_tiny_shapes(dev, dtype, b, h, s):
    """K4 at a tiny train step's (2, 4, 4608, 32), at S = 1 and 129."""
    q, k, v, do, _, _ = _inputs32(dev, b, h, s, dtype, seed=s + 3)
    out, lse = fa.flash_attention(q, k, v)
    n4 = fa.flash_attention_backward.launches
    grads = fa.flash_attention_backward(q, k, v, out, lse, do)
    plain = fa.flash_attention_backward_plain(q, k, v, out, lse, do)
    if s == 1:   # as at D = 64: the plain version on the kernel's bf16 operands
        ops = [x.to(torch.bfloat16).to(dtype) for x in (q, k, v, do)]
        plain = fa.flash_attention_backward_plain(*ops[:3], out, lse, ops[3])
    torch.cuda.synchronize()
    assert fa.flash_attention_backward.launches == n4 + 1
    for x, y in zip(grads, plain):
        assert x.shape == (b, h, s, 32) and x.dtype == dtype and bool(torch.isfinite(x).all())
        if s == 1:
            err = (x.float() - y.float()).abs().max().item()
            assert err <= 2.0 ** -5 * y.float().abs().max().item() + 1e-5
        else:
            assert _grad_ok(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_d32_backward_is_bit_equal_over_calls(dev, dtype):
    """At D = 32 both consumer warpgroups add a partial dq over the same 32
    channels, one 128-byte fp32 box each, behind the counter: bit-equal."""
    q, k, v, do, _, _ = _inputs32(dev, 2, 4, 1000, dtype, seed=7)
    out, lse = fa.flash_attention(q, k, v)
    first = fa.flash_attention_backward(q, k, v, out, lse, do)
    second = fa.flash_attention_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for x, y in zip(first, fa.flash_attention_backward_plain(q, k, v, out, lse, do)):
        assert _grad_ok(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("s", [4608, 69])
def test_d32_route_and_autograd_through_attention(dev, dtype, s):
    """The block's entry at the tiny 1024^2 length (K1, then K4) and at one
    chunk (the fp32 rotation, K2, K4), against autograd through the plain
    route, in the input's dtype."""
    q, k, v, do, cos, sin = _inputs32(dev, 2, 4, s, dtype, seed=s)
    before, n4 = _counts(), fa.flash_attention_backward.launches
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention(*leaves, cos, sin)
    out.backward(do)
    fused = fa.rope_fused(s)
    assert tuple(a - c for a, c in zip(_counts(), before)) == (int(fused), int(not fused), 0)
    assert fa.flash_attention_backward.launches == n4 + 1
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if fused:
        want = fa.flash_attention_rope_plain(ref[0], ref[1], ref[2], cos, sin)[0]
    else:
        want = fa.flash_attention_plain(apply_rope_half(ref[0], cos, sin),
                                        apply_rope_half(ref[1], cos, sin), ref[2])[0]
    want.backward(do)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _out_err_ok(out, want)
    for x, y in zip(leaves, ref):
        assert x.grad.dtype == dtype and _grad_ok(x.grad, y.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sq,sks", [(2560, (512, 2048, 2048)), (69, (5, 32, 32)), (1, (5, 130))])
def test_d32_ring_step_matches_plain_at_every_step(dev, dtype, sq, sks):
    """K5 at head dim 32: one rank of the tiny 1024^2 request over 2 ranks
    (512 text + 2048 image queries against the text block and two image
    blocks), short and one-query cases, step by step against the plain
    steps; an fp32 call's last step writes fp32."""
    g = torch.Generator(device=dev).manual_seed(sq)
    q = torch.randn(1, 4, sq, 32, generator=g, device=dev).to(dtype)
    blocks = [tuple(torch.randn(1, 4, sk, 32, generator=g, device=dev).to(dtype)
                    for _ in range(2)) for sk in sks]
    got = want = None
    k_norm = torch.zeros(1, 4, device=dev)
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(blocks) - 1
        plain_in = None if first else tuple(x.clone() for x in want)
        n = ra.ring_step.launches
        got = ra.ring_step(q, k, v, got, first, last)
        torch.cuda.synchronize()
        want = ra.ring_step_plain(q, k, v, plain_in, first, last)
        assert ra.ring_step.launches == n + 1
        if not last:
            assert _out_err_ok(got[0] / got[2][..., None], want[0] / want[2][..., None])
            # the running max within 1e-3; in fp32 q and k are rounded to bf16
            # (2^-9 relative each): a logit moves by up to 2^-8 |q| max|k| / sqrt(D)
            k_norm = torch.maximum(k_norm, k.float().norm(dim=-1).amax(-1))
            m_lim = 1e-3 + (0.0 if dtype == torch.bfloat16 else
                            2.0 ** -8 * q.float().norm(dim=-1) * k_norm[..., None] / 32 ** 0.5)
            assert bool(((got[1] - want[1]).abs() <= m_lim).all())
    assert got.shape == q.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all()) and _out_err_ok(got, want)


VARIANTS = {"chunked": (av.chunked_attn, av.chunked_attn_plain, 2.0 ** -6),
            "exp2": (av.exp2_attn, av.exp2_attn_plain, 2.0 ** -6),
            "bf16exp": (av.bf16exp_attn, av.bf16exp_attn_plain, 2.0 ** -5)}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("b,h,s", [(1, 4, 4608), (2, 2, 1280)])
def test_variant_kernel_matches_plain(dev, name, b, h, s):
    entry, plain, rtol = VARIANTS[name]
    q, k, v, _, _ = _inputs(dev, b, h, s, seed=s + 8)
    n = entry.launches
    got = entry(q, k, v)
    torch.cuda.synchronize()
    want = plain(q, k, v)
    assert entry.launches == n + 1
    assert got.shape == (b, h, s, 128) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_kernel_rejects_what_it_does_not_take(dev, name):
    entry = VARIANTS[name][0]
    q, k, v, _, _ = _inputs(dev, 1, 2, 320, seed=9)
    n = entry.launches
    with pytest.raises(ValueError, match="block_q"):
        entry(q, k, v, 256)
    with pytest.raises(TypeError, match="bfloat16"):
        entry(q.half(), k.half(), v.half(), 64)
    assert entry.launches == n


def _ring_inputs(dev, b, h, sq, sks, seed, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    def rnd(s):
        return torch.randn(b, h, s, d, generator=g, device=dev).to(torch.bfloat16)

    return rnd(sq), [(rnd(sk), rnd(sk)) for sk in sks]


@pytest.mark.parametrize("sq,sks", [(1152, (1152, 1152, 1152)), (200, (512, 333, 8)),
                                    (8704, (512, 8192)), (64, (1, 127, 129)), (1, (5, 130))])
def test_ring_step_matches_plain_at_every_step(dev, sq, sks):
    """The first, middle and last steps one at a time, each from the same
    state on both sides: the state after every step but the last, then the
    output; key blocks of unaligned lengths (333, 8) are masked as K3 masks."""
    q, blocks = _ring_inputs(dev, 1, 2, sq, sks, seed=sq)
    state = None
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(blocks) - 1
        plain_in = None if first else tuple(x.clone() for x in state)
        n = ra.ring_step.launches
        got = ra.ring_step(q, k, v, state, first, last)
        torch.cuda.synchronize()
        want = ra.ring_step_plain(q, k, v, plain_in, first, last)
        assert ra.ring_step.launches == n + 1
        if last:
            assert got.shape == q.shape and got.dtype == torch.bfloat16
            assert bool(torch.isfinite(got.float()).all()) and _out_err_ok(got, want)
            break
        (acc, m, l), (p_acc, p_m, p_l) = got, want
        assert (m - p_m).abs().max().item() <= 1e-3
        assert ((l - p_l).abs() / p_l).max().item() <= 1e-3
        assert _out_err_ok(acc / l[..., None], p_acc / p_l[..., None])
        state = got


@pytest.mark.parametrize("h,sq,sks", [(4, 69, (5, 32, 32)), (24, 1152, (512, 1152, 1152))])
def test_d64_ring_step_matches_plain_at_every_step(dev, h, sq, sks):
    """K5 at head dim 64: the demo's 69 tokens over 2 ranks (the text block,
    then two 32-token image blocks) and one of 4 ranks at 4608 image tokens,
    step by step against the plain steps."""
    q, blocks = _ring_inputs(dev, 1, h, sq, sks, seed=sq, d=64)
    got = want = None
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(blocks) - 1
        plain_in = None if first else tuple(x.clone() for x in want)
        got = ra.ring_step(q, k, v, got, first, last)
        torch.cuda.synchronize()
        want = ra.ring_step_plain(q, k, v, plain_in, first, last)
        if not last:
            assert _out_err_ok(got[0] / got[2][..., None], want[0] / want[2][..., None])
            assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert got.shape == q.shape and got.dtype == torch.bfloat16 and _out_err_ok(got, want)


def test_ring_step_at_cfg_batch_2(dev):
    """One rank of SP inpainting at 1536x1152 over 2 ranks (true CFG: batch
    2): queries [512 text; 3456 image] against the text block and two image
    blocks, step by step against the plain steps; then the second image's
    output against its rows run at batch 1, bit for bit (no B = 1 assumption
    in the grid or the tensor maps)."""
    q, blocks = _ring_inputs(dev, 2, 24, 3968, (512, 3456, 3456), seed=29)
    got = want = None
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(blocks) - 1
        plain_in = None if first else tuple(x.clone() for x in want)
        got = ra.ring_step(q, k, v, got, first, last)
        torch.cuda.synchronize()
        want = ra.ring_step_plain(q, k, v, plain_in, first, last)
        if not last:
            assert _out_err_ok(got[0] / got[2][..., None], want[0] / want[2][..., None])
            assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert got.shape == q.shape and _out_err_ok(got, want)
    one = None
    for i, (k, v) in enumerate(blocks):
        one = ra.ring_step(q[1:], k[1:], v[1:], one, i == 0, i == len(blocks) - 1)
    torch.cuda.synchronize()
    assert torch.equal(one, got[1:])


def test_ring_step_in_one_launch_is_attention(dev):
    """first and last together: one softmax over the block, no state."""
    q, [(k, v)] = _ring_inputs(dev, 2, 2, 300, (1000,), seed=3)
    got = ra.ring_step(q, k, v, None, True, True)
    torch.cuda.synchronize()
    assert _out_err_ok(got, ra.ring_step_plain(q, k, v, None, True, True))


def test_ring_kernel_over_thread_ranks_matches_the_plain_ring(dev):
    from reptext_tpu_torch.parallel.sequence import sequence_sharded_attention
    from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

    q, [(k, v)] = _ring_inputs(dev, 1, 4, 1024, (1024,), seed=5)

    def sharded(impl):
        return torch.cat(run_spmd(LocalSPGroup(4, dev), lambda g: sequence_sharded_attention(
            g.shard(q, 2), g.shard(k, 2), g.shard(v, 2), g, impl)), dim=2)

    n = ra.ring_step.launches
    got = sharded("ring_kernel")
    torch.cuda.synchronize()
    assert ra.ring_step.launches == n + 16     # 4 ranks x 4 steps, counted under threads
    assert _out_err_ok(got, sharded("ring"))


def test_ring_step_rejects_what_it_does_not_take(dev):
    q, [(k, v)] = _ring_inputs(dev, 1, 2, 128, (128,), seed=7)
    n = ra.ring_step.launches
    with pytest.raises(TypeError, match="float16"):
        ra.ring_step(q.half(), k.half(), v.half(), None, True, True)
    with pytest.raises(ValueError, match="q torch.float32"):
        ra.ring_step(q.float(), k, v, None, True, True)
    with pytest.raises(ValueError, match="head dim 48"):
        ra.ring_step(q[..., :48], k[..., :48], v[..., :48], None, True, True)
    state = ra.ring_step(q, k, v, None, True, False)
    with pytest.raises(ValueError, match="state acc"):
        ra.ring_step(q, k, v, (state[0].half(), state[1], state[2]), False, True)
    with pytest.raises(ValueError, match="k_blk has shape"):
        ra.ring_step(q, k[:, :1], v, state, False, True)
    assert ra.ring_step.launches == n + 1


# ---------------------------------------- fp8 storage and the OCR term on the card


def test_quant_linear_is_f_linear_on_the_dequantized_weight(dev):
    """QuantLinear in bf16 is F.linear on io.quantize.dequantize_kernel of its
    storage, bit for bit, at a FLUX block's width."""
    from reptext_tpu_torch.io.quantize import dequantize_kernel
    from reptext_tpu_torch.nn.layers import QuantLinear

    g = torch.Generator(device=dev).manual_seed(0)
    lin = torch.nn.Linear(3072, 12288, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(lin.weight.shape, generator=g, device=dev) * 0.02)
    q = QuantLinear.from_linear(lin)
    x = torch.randn(2, 512, 3072, generator=g, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        want = torch.nn.functional.linear(x, dequantize_kernel(q.kernel_q8, q.kernel_scale),
                                          lin.bias)
        got = q(x)
    assert q.kernel_q8.dtype == torch.float8_e4m3fn and torch.equal(got, want)
    # the card's quantization is the CPU's, bit for bit
    qc, sc = QuantLinear.from_linear(lin.cpu()).kernel_q8, QuantLinear.from_linear(
        lin.cpu()).kernel_scale
    assert torch.equal(q.kernel_q8.cpu().view(torch.uint8), qc.view(torch.uint8))
    assert torch.equal(q.kernel_scale.cpu(), sc)


def test_crop_and_ctc_gradients_repeat_bit_for_bit(dev):
    """The OCR term's crop (interpolation-matrix products) and CTC (the alpha
    recursion) give bit-equal gradients over two calls on the card."""
    from reptext_tpu_torch.eval.ocr import ctc_losses
    from reptext_tpu_torch.ops.crop import crop_and_resize

    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(2, 1, 1024, 1024, generator=g, device=dev)
    boxes = torch.tensor([[0.3, 0.2, 0.42, 0.7], [-0.05, 0.6, 0.1, 1.1]], device=dev)
    logits = torch.randn(2, 64, 99, generator=g, device=dev)
    labels = torch.tensor([[5, 7, 7, 9] + [0] * 20, [3] + [0] * 23], device=dev)
    paddings = (labels == 0).float()

    def run():
        im, bx, lg = (x.clone().requires_grad_(True) for x in (images, boxes, logits))
        crops = crop_and_resize(im, bx, 48, 256)
        loss = (crops * torch.linspace(-1, 1, 256, device=dev)).sum() + ctc_losses(
            lg, labels, paddings).sum()
        loss.backward()
        return loss.detach(), im.grad, bx.grad, lg.grad

    first, second = run(), run()
    assert all(torch.isfinite(a).all() for a in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
