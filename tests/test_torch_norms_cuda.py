"""The norm kernels (``csrc/norms.cu`` behind ``ops/norms.py``) against their
plain PyTorch versions, on the card: ``modulate`` (the AdaLN LayerNorm with
its modulation) and ``rms_norm`` (the per-head q/k RMSNorm), at the main
path's shapes, at batch 2 with a shift and scale row per request, on the
``joint[:, txt_len:]`` slice, at head dims 32 and 64, in bf16 and fp32; the
gradients through the autograd Functions; the output's strides; what the
wrappers refuse (among it parameters in another dtype than x's). Everything
here needs a CUDA device and skips without one.

Run on the card (this file imports neither jax nor the tests' conftest):
    python -m pytest tests/test_torch_norms_cuda.py --noconftest -m cuda -q

The limit. The kernel and the plain version do the same fp32 arithmetic with
the same rounding points and differ only in the order of the row sums, so
the row's statistics (mean, variance, mean square) may differ in their last
fp32 bits. An element may then differ by one ulp of the activation dtype,
taken at the size of the largest of its terms (the output itself and, for
modulate, LN(x) * (1 + scale) and shift: a final add that cancels leaves a
result much smaller than its terms, whose own ulp is finer than the error of
the terms), plus 2^-18 of the row's largest term (32 fp32 ulps there: the
statistics' own departure, which a bf16 result rounds away and an fp32 result
shows). In bf16 at least 99 % of the elements must be bit-equal; fp32 keeps
every bit of the statistics' departure, so there the per-element limit is
the test. The gradients are the plain version's, recomputed from the saved
inputs: bit-equal.
"""

import pytest
import torch

from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock, split_heads
from reptext_tpu_torch.ops import norms

pytestmark = pytest.mark.cuda

BF16_BIT_EQUAL = 0.99


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _ulp(m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at |m| (fp32 tensor), normal range."""
    mant = 7 if dtype == torch.bfloat16 else 23
    tiny = torch.finfo(dtype).tiny
    return torch.exp2(torch.floor(torch.log2(m.abs().clamp_min(tiny))) - mant)


def _within(got, want, terms, dtype):
    """(every element within the limit, bit-equal share); ``terms`` the
    fp32 magnitudes of each element's terms, rows along the last axis."""
    g, w = got.float(), want.float()
    m = torch.maximum(torch.maximum(g.abs(), w.abs()), terms)
    limit = _ulp(m, dtype) + 2.0 ** -18 * terms.amax(dim=-1, keepdim=True)
    return bool(((g - w).abs() <= limit).all()), (got == want).float().mean().item()


def _activations(shape, dtype, dev, seed):
    """FLUX-like activations: a spread of scales, an offset, and outliers
    a hundred times the rest in a few channels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 2.0 + 0.25
    x[..., ::97] *= 100.0
    return x.to(dtype)


def _adaln(b, d, dtype, dev, seed, chunks=6):
    """shift and scale as the blocks pass them: ``chunk`` views of one
    [B, chunks * d] projection, a row per request."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    emb = (torch.randn(b, chunks * d, generator=g, device=dev) * 0.5).to(dtype)
    return emb.chunk(chunks, dim=-1)[:2]


def _check_modulate(x, shift, scale):
    dtype = x.dtype
    got = norms.modulate(x, shift, scale)
    want = norms.modulate_plain(x, shift, scale)
    a = norms.layer_norm_no_affine_f32(x) * (1.0 + scale.float()[:, None, :])
    ok, equal = _within(got, want, torch.maximum(a.abs(), shift.float()[:, None, :].abs()), dtype)
    assert got.dtype == dtype and got.is_contiguous() and got.shape == x.shape
    assert ok, f"outside the limit; bit-equal {equal:.6f}"
    if dtype == torch.bfloat16:
        assert equal >= BF16_BIT_EQUAL, equal


def _check_rms(x, w, eps=1e-6):
    got = norms.rms_norm(x, w, eps)
    want = norms.rms_norm_plain(x, w, eps)
    assert got.dtype == x.dtype and got.stride() == x.stride() and got.shape == x.shape
    ok, equal = _within(got, want, want.float().abs(), x.dtype)
    assert ok, f"outside the limit; bit-equal {equal:.6f}"
    if x.dtype == torch.bfloat16:
        assert equal >= BF16_BIT_EQUAL, equal


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 4608, 3072), (1, 4096, 3072), (1, 512, 3072),
                                   (2, 512, 3072), (1, 64, 128), (16, 69, 256)])
def test_modulate_against_plain(dev, shape, dtype):
    """FLUX's widths at 1024^2 (image, text, joint), batch 2 with different
    rows, the --tiny width (128) and the trained-weights demo's (256)."""
    x = _activations(shape, dtype, dev, 0)
    shift, scale = _adaln(shape[0], shape[2], dtype, dev, 0)
    if shape[0] == 2:
        assert not torch.equal(shift[0], shift[1])
    before = norms.modulate.launches
    _check_modulate(x, shift, scale)
    assert norms.modulate.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_modulate_on_the_joint_slice(dev, dtype):
    """norm_out's ``joint[:, txt_len:]``: a token stride and a base offset."""
    joint = _activations((1, 4608, 3072), dtype, dev, 1)
    x = joint[:, 512:]
    shift, scale = _adaln(1, 3072, dtype, dev, 1, chunks=2)
    _check_modulate(x, shift, scale)
    # and batch 2: each request reads its own rows
    joint = _activations((2, 1024, 3072), dtype, dev, 2)
    shift, scale = _adaln(2, 3072, dtype, dev, 2)
    _check_modulate(joint[:, 512:], shift, scale)
    got = norms.modulate(joint[:, 512:], shift, scale)
    one = norms.modulate(joint[1:, 512:], shift[1:], scale[1:])
    assert torch.equal(got[1:], one)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_modulate_takes_one_row_for_the_batch(dev, dtype):
    """A [1, D] shift and scale over batch 2."""
    x = _activations((2, 256, 3072), dtype, dev, 3)
    _check_modulate(x, *_adaln(1, 3072, dtype, dev, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,s,d", [(1, 24, 4608, 128), (2, 24, 512, 128), (1, 4, 4608, 32),
                                     (16, 4, 69, 64), (1, 12, 4608, 128)])
def test_rms_norm_against_plain(dev, b, h, s, d, dtype):
    """The ``split_heads`` view of [B, S, H*D]: FLUX at 1024^2, its text
    stream at batch 2, --tiny (32), the demo (64), a tensor-parallel rank."""
    x = split_heads(_activations((b, s, h * d), dtype, dev, 5), h)
    g = torch.Generator(device=dev).manual_seed(6)
    w = (torch.rand(d, generator=g, device=dev) + 0.5).to(dtype)
    before = norms.rms_norm.launches
    _check_rms(x, w)
    assert norms.rms_norm.launches == before + 1
    _check_rms(x.contiguous(), w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gradients_equal_the_plain_versions(dev, dtype):
    x0 = _activations((2, 256, 3072), dtype, dev, 8)
    emb = (torch.randn(2, 6 * 3072, device=dev) * 0.5).to(dtype)
    gy = torch.randn(2, 256, 3072, device=dev).to(dtype)
    grads = []
    for fn in (norms.modulate, norms.modulate_plain):
        x, e = x0.clone().requires_grad_(), emb.clone().requires_grad_()
        shift, scale = e.chunk(6, dim=-1)[:2]
        torch.autograd.backward(fn(x, shift, scale), gy)
        grads.append((x.grad, e.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))

    q0 = _activations((2, 512, 24 * 128), dtype, dev, 9)
    w0 = (torch.rand(128, device=dev) + 0.5).to(dtype)
    gq = torch.randn(2, 24, 512, 128, device=dev).to(dtype)
    grads = []
    for fn in (norms.rms_norm, norms.rms_norm_plain):
        q, w = q0.clone().requires_grad_(), w0.clone().requires_grad_()
        torch.autograd.backward(fn(split_heads(q, 24), w, 1e-6), gq)
        grads.append((q.grad, w.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_blocks_launch_the_kernels(dev):
    """A double block calls modulate 4 times and the RMSNorm 4 times, a
    single block each once and twice: every call is a kernel launch."""
    torch.manual_seed(0)
    joint = JointTransformerBlock(256, 4, 64, device=dev, dtype=torch.bfloat16)
    single = SingleTransformerBlock(256, 4, 64, device=dev, dtype=torch.bfloat16)
    img = torch.randn(1, 256, 256, device=dev, dtype=torch.bfloat16)
    txt = torch.randn(1, 64, 256, device=dev, dtype=torch.bfloat16)
    temb = torch.randn(1, 256, device=dev, dtype=torch.bfloat16)
    cos, sin = torch.ones(320, 64, device=dev), torch.zeros(320, 64, device=dev)
    before = (norms.modulate.launches, norms.rms_norm.launches)
    with torch.no_grad():
        ctx, x = joint(img, txt, temb, cos, sin)
        out = single(torch.cat([ctx, x], dim=1), temb, cos, sin)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert (norms.modulate.launches - before[0], norms.rms_norm.launches - before[1]) == (5, 6)


def test_what_the_kernels_refuse(dev):
    x = torch.randn(1, 64, 3072, device=dev, dtype=torch.bfloat16)
    shift, scale = _adaln(1, 3072, torch.bfloat16, dev, 10)
    with pytest.raises(ValueError, match="unit last stride"):
        norms.modulate(x.transpose(1, 2).contiguous().transpose(1, 2), shift, scale)
    with pytest.raises(ValueError, match="exceeds"):
        norms.modulate(torch.randn(1, 4, 3080, device=dev, dtype=torch.bfloat16),
                       *_adaln(1, 3080, torch.bfloat16, dev, 10))
    with pytest.raises(TypeError, match="one dtype"):
        norms.modulate(x, shift.float(), scale.float())
    with pytest.raises(ValueError, match="16-byte vectors"):
        norms.modulate(x[..., :100], shift[:, :100], scale[:, :100])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        norms.modulate(x.half(), shift.half(), scale.half())
    with pytest.raises(ValueError, match=r"\[1, 3072\]"):
        norms.modulate(x, shift.expand(2, 3072), scale)
    q = split_heads(torch.randn(1, 64, 4 * 128, device=dev, dtype=torch.bfloat16), 4)
    w = torch.ones(128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dense"):
        norms.rms_norm(q[:, :2], w, 1e-6)      # two heads of four: rows with gaps
    with pytest.raises(ValueError, match="unit last stride"):
        norms.rms_norm(q.transpose(-1, -2), torch.ones(64, device=dev, dtype=torch.bfloat16),
                       1e-6)
    with pytest.raises(ValueError, match=r"weight must be \[128\]"):
        norms.rms_norm(q, w[:64], 1e-6)
    with pytest.raises(TypeError, match="one dtype"):
        norms.rms_norm(q, w.float(), 1e-6)
