"""K3's plain version and the attention route of the port against the JAX package.

``flash_attention_streaming_plain`` is held against the Pallas streaming kernel
``_streaming_flash`` run in interpret mode (aligned and unaligned S, clamped and
online softmax, bf16, lse). The RoPE entry's route is held against JAX
``_flash_attention_rope_impl`` / ``flash_attention_rope`` in interpret mode:
past ``_SINGLE_PASS_MAX_SEQ`` (patched to 256 on both sides, as
``tests/test_attention.py`` does) the JAX package rotates q and k with the
fp32 tables and takes K3, which multiplies the fp32 logits by the scale; at a
single chunk it rotates and takes K2. The lse (fp32) tells those routes apart
from the fused K1 route, whose bf16 tables and scale folded into q move it by
~1e-3; the tolerances below are far under that.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reptext_tpu.ops.flash_attention as jfa
from reptext_tpu.ops.rope import rope_cos_sin_half as j_rope_tables
from reptext_tpu_torch.ops import flash_attention as fa

from torch_port_util import t

D = 32
AXES = (8, 12, 12)
# bf16 outputs: both sides round p and out to bf16 at the same points but sum
# the fp32 logits in another order, so an element may land one bf16 ulp
# (2^-8 relative) away; lse is fp32: ordering error ~1e-6 on values ~5.
OUT_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
LSE_TOL = dict(rtol=0, atol=2e-5)


def _qkv(b, h, s, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, h, s, D)).astype(np.float32) for _ in range(3)]


def _tables(s, seed):
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1] = np.arange(s) % 23
    ids[:, 2] = (np.arange(s) * 7 + seed) % 17
    cos, sin = j_rope_tables(jnp.asarray(ids), AXES)
    return np.asarray(cos), np.asarray(sin)


def _bf16(xs):
    return [jnp.asarray(x, jnp.bfloat16) for x in xs], [t(x).to(torch.bfloat16) for x in xs]


def _f32(x):
    if isinstance(x, jax.Array):
        return np.asarray(jnp.asarray(x, jnp.float32))
    return x.float().numpy()


@pytest.mark.parametrize("s", [256, 200])
@pytest.mark.parametrize("online", [False, True])
def test_streaming_plain_matches_pallas_streaming_kernel(monkeypatch, s, online):
    monkeypatch.setenv("REPTEXT_SOFTMAX", "online" if online else "clamped")
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(2, 2, s, seed=s + online))
    jout, jlse = jfa._streaming_flash(jq, jk, jv, block_q=128, block_kv=128, interpret=True)
    tout, tlse = fa.flash_attention_streaming_plain(tq, tk, tv, online=online)
    assert tout.dtype == torch.bfloat16 and tout.shape == (2, 2, s, D)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **LSE_TOL)
    # the public K3 entry takes the same plain version on the CPU
    out2, lse2 = fa.flash_attention_streaming(tq, tk, tv, online=online)
    torch.testing.assert_close(out2, tout, rtol=0, atol=0)
    torch.testing.assert_close(lse2, tlse, rtol=0, atol=0)


def test_streaming_plain_beyond_the_clamp():
    """Planted logits up to 80: clamped saturates at 43 like the kernel; online does not."""
    s = 64
    q = np.zeros((1, 1, s, D), np.float32)
    k = np.zeros((1, 1, s, D), np.float32)
    q[..., 0] = 80.0 * np.sqrt(D)
    k[..., 0] = np.linspace(-1.0, 1.0, s)
    v = np.random.default_rng(3).standard_normal((1, 1, s, D)).astype(np.float32)
    _, lse_c = fa.flash_attention_streaming_plain(t(q), t(k), t(v), online=False)
    _, lse_o = fa.flash_attention_streaming_plain(t(q), t(k), t(v), online=True)
    assert float(lse_o.max()) > fa.LOGIT_CLAMP + 30
    assert float(lse_c.max()) < fa.LOGIT_CLAMP + np.log(s) + 1e-3


@pytest.mark.parametrize("s,patched", [(320, True), (300, True), (100, False)],
                         ids=["streaming-aligned", "streaming-unaligned", "one-chunk"])
def test_rope_route_matches_jax(s, patched):
    """bf16 RoPE attention: the port's route == the JAX package's, out and lse."""
    threshold = 256 if patched else jfa._SINGLE_PASS_MAX_SEQ
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(1, 2, s, seed=s))
    cos, sin = _tables(s, seed=s)
    with mock.patch.object(jfa, "_SINGLE_PASS_MAX_SEQ", threshold), \
            mock.patch.object(fa, "_SINGLE_PASS_MAX_SEQ", threshold):
        assert not fa.rope_fused(s)
        assert fa.streams(s) == patched
        jout, jlse = jfa._flash_attention_rope_impl(jq, jk, jv, jnp.asarray(cos),
                                                    jnp.asarray(sin), 512, True)
        tout, tlse = fa.flash_attention_rope(tq, tk, tv, t(cos), t(sin))
    np.testing.assert_allclose(_f32(tout), _f32(jout), **OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **LSE_TOL)


def test_fused_route_matches_jax():
    """At 640 keys (two chunks) both sides fuse the rotation (K1)."""
    s = 640
    assert fa.rope_fused(s)
    (jq, jk, jv), (tq, tk, tv) = _bf16(_qkv(1, 1, s, seed=4))
    cos, sin = _tables(s, seed=4)
    jout, jlse = jfa._flash_attention_rope_impl(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin),
                                                512, True)
    tout, tlse = fa.flash_attention_rope(tq, tk, tv, t(cos), t(sin))
    np.testing.assert_allclose(_f32(tout), _f32(jout), **OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **LSE_TOL)


def test_route_decision_matches_pick_chunks():
    """``_single_chunk`` is ``_flash_attention_rope_impl``'s test, for every
    length up to 6400 and the full-geometry joint lengths."""
    def jax_single(s):
        s_pad = jfa._round_up(s, 128)
        block_q = min(256 if s_pad > 4608 else 512, s_pad)
        return jfa._pick_chunks(jfa._round_up(s_pad, block_q), block_q)[0] == 1

    for s in list(range(1, 6400, 37)) + [4608, 5312, 7424, 9728]:
        assert fa._single_chunk(s) == jax_single(s), s
    assert fa._SINGLE_PASS_MAX_SEQ == jfa._SINGLE_PASS_MAX_SEQ
    # 1024^2 and the 1280x960 inpaint request fuse; 1536x1152 and 1536^2 stream
    assert fa.rope_fused(4608) and fa.rope_fused(5312)
    assert fa.streams(7424) and fa.streams(9728) and not fa.rope_fused(7424)


@pytest.mark.parametrize("s,patched", [(320, True), (100, False)],
                         ids=["streaming", "one-chunk"])
def test_rope_route_gradients_match_jax(s, patched):
    """fp32 gradients through the rotated route (K3 or K2 forward, K4's plain
    version behind it) == jax.grad through the Pallas forward and backward."""
    threshold = 256 if patched else jfa._SINGLE_PASS_MAX_SEQ
    q, k, v = _qkv(1, 2, s, seed=7 + s)
    cos, sin = _tables(s, seed=1)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attention_rope(q, k, v, jnp.asarray(cos), jnp.asarray(sin), 512, True)
        return jnp.sum(out * g)

    with mock.patch.object(jfa, "_SINGLE_PASS_MAX_SEQ", threshold), \
            mock.patch.object(fa, "_SINGLE_PASS_MAX_SEQ", threshold):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
        out, _ = fa.flash_attention_rope(tq, tk, tv, t(cos), t(sin))
        (out * t(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
