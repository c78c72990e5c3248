"""The port's CUDA flash-attention kernel against its plain PyTorch version,
on the card. Everything here needs a CUDA device and skips without one.

Run on the card (this file imports neither jax nor the tests' conftest):
    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

Tolerances as chip_smoke.py states them: out within 2^-6 of max|plain out|
(two bf16 ulps at the top of the output's range; the sums are reordered, so an
element may land one ulp away), lse 1e-3.
"""

import numpy as np
import pytest
import torch

from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.ops.attention import attention
from reptext_tpu_torch.ops.rope import rope_cos_sin_half

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


@pytest.mark.parametrize("b,h,s", [(1, 4, 4608), (2, 2, 1001), (1, 1, 5)])
@pytest.mark.parametrize("online", [False, True])
def test_kernel_matches_plain(dev, b, h, s, online):
    q, k, v, cos, sin = _inputs(dev, b, h, s)
    n1, n2 = fa.flash_attention_rope.launches, fa.flash_attention.launches
    pairs = ((fa.flash_attention_rope(q, k, v, cos, sin, online),
              fa.flash_attention_rope_plain(q, k, v, cos, sin, online)),
             (fa.flash_attention(q, k, v, online), fa.flash_attention_plain(q, k, v, online)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got[0].shape == (b, h, s, 128) and got[1].shape == (b, h, s)
        assert _out_err_ok(got[0], want[0])
        assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert (fa.flash_attention_rope.launches, fa.flash_attention.launches) == (n1 + 1, n2 + 1)


def test_strided_inputs_and_attention_entry(dev):
    """q/k/v as [B, S, H, D] buffers viewed [B, H, S, D], as the blocks make them;
    attention() on CUDA tensors goes to the kernel."""
    q, k, v, cos, sin = _inputs(dev, 1, 4, 300, seed=1)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    n = fa.flash_attention_rope.launches
    got = attention(qs, ks, vs, cos, sin)
    want = fa.flash_attention_rope_plain(q, k, v, cos, sin)[0]
    assert fa.flash_attention_rope.launches == n + 1
    assert _out_err_ok(got, want)


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v, cos, sin = _inputs(dev, 1, 2, 64, seed=2)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="rope_cos"):
        fa.flash_attention_rope(q, k, v, cos.to(torch.bfloat16), sin)
