"""The port's attention backward against the JAX package's, on the CPU.

K4's plain version (``flash_attention_backward_plain``) against the Pallas
backward kernels ``_dq_kernel``/``_dkv_kernel`` run in interpret mode, as
tests/test_attention.py runs them, and against the fp32 einsum oracle; the two
autograd Functions (K1 + K4 and K2 + K4) against ``jax.grad`` through the JAX
``custom_vjp``s. The kernel itself is checked on the card by
tests/test_torch_cuda.py; its loops are spelled out in plain PyTorch by
``torch_port_util.emulated_backward_loop`` (128 keys owned at a time, 64-query
tiles streamed, exp2 on log2 units, bf16 p and ds, dq summed over the key
blocks), which is held here against the plain version at the card's
tolerances (bf16 inputs: max-abs within 2^-5 of max|plain|, mean-abs within
2^-7 of mean|plain|, as chip_smoke.py states them) and against the interpreted
Pallas backward (fp32 inputs, rtol = atol = 1e-4: exp2 of an fp32 argument of
size ~30 differs from exp by a few 1e-6 relative); and the preprocess pass's
plain version against ``jnp.sum(g * out)``.

fp32 inputs throughout; tolerance rtol = atol = 1e-4: both sides compute the
same fp32 products and differ only in summation order (the Pallas kernels sum
over 128-wide blocks, the port in one matmul) and, through the forward, in the
bf16-rounded RoPE tables both use.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.ops import flash_attention as jfa
from reptext_tpu.ops.rope import rope_cos_sin_half as jrope_tables
from reptext_tpu_torch.ops import flash_attention as tfa
from reptext_tpu_torch.ops.attention import attention, plain_attention
from torch_port_util import LOG2E, emulated_backward_loop

TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(shape, n, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@functools.lru_cache(maxsize=None)
def _jax_backward(block_q):
    """jit once per block size: the interpreted Pallas forward and backward
    and the einsum oracle on the same inputs."""

    def run(q, k, v, g):
        out, lse = jfa._flash_attention_impl(q, k, v, block_q, True)
        pallas = jfa._flash_backward_pallas(q, k, v, out, lse, g, block_q, True)
        return out, lse, pallas, jfa._flash_backward_einsum(q, k, v, g)

    return jax.jit(run)


@pytest.mark.parametrize("shape", [(2, 2, 200, 32), (1, 1, 1152, 32)])
def test_plain_backward_matches_pallas_and_einsum(shape):
    """200 pads to 256 inside the Pallas kernels and masks the tail; 1152 is
    aligned and streams 9 x 9 blocks."""
    q, k, v, g = _arrays(shape, 4, seed=shape[2])
    out, lse, pallas, einsum = _jax_backward(128)(*map(jnp.asarray, (q, k, v, g)))
    got = tfa.flash_attention_backward_plain(*_t(q, k, v, out, lse, g), online=False)
    for x, want_p, want_e in zip(got, pallas, einsum):
        assert x.shape == shape and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(want_p), **TOL)
        np.testing.assert_allclose(x.numpy(), np.asarray(want_e), **TOL)


def _planted(peak=80.0, s=256, d=32):
    """tests/test_attention.py's planted logits: every row spans [-peak, peak]."""
    q = np.zeros((1, 1, s, d), np.float32)
    k = np.zeros((1, 1, s, d), np.float32)
    q[0, 0, :, 0] = peak * np.sqrt(d)
    k[0, 0, :, 0] = np.linspace(-1.0, 1.0, s)
    v, g = _arrays((1, 1, s, d), 2, seed=3)
    return q, k, v, g


def test_beyond_the_clamp_is_straight_through():
    """Clamped mode: p comes from the clipped logits and the gradient passes
    straight through the clip, as in the Pallas kernels; it is not the exact
    softmax gradient (or the test would be vacuous)."""
    q, k, v, g = _planted()
    out, lse, pallas, einsum = _jax_backward(128)(*map(jnp.asarray, (q, k, v, g)))
    got = tfa.flash_attention_backward_plain(*_t(q, k, v, out, lse, g), online=False)
    for x, want in zip(got, pallas):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), **TOL)
    assert max(float(np.abs(x.numpy() - np.asarray(e)).max()) for x, e in zip(got, einsum)) > 1e-2


def test_online_backward_is_the_exact_gradient():
    """Online mode (passed explicitly: the mode is read once per process)
    has no clip: with its own forward's lse, the planted case gives the exact
    softmax gradient of the fp32 oracle."""
    q, k, v, g = _t(*_planted())
    out, lse = tfa.flash_attention_plain(q, k, v, online=True)
    got = tfa.flash_attention_backward_plain(q, k, v, out, lse, g, online=True)
    for x, want in zip(got, tfa.flash_attention_backward_einsum(q, k, v, g)):
        np.testing.assert_allclose(x.numpy(), want.numpy(), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_rope_grad():
    def loss(q, k, v, cos, sin):
        return jnp.sum(jfa.flash_attention_rope(q, k, v, cos, sin, 384, True, "pallas") ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def test_rope_function_matches_jax_grad():
    """The K1 + K4 Function on the CPU against jax.grad of the fused-RoPE
    custom_vjp with the Pallas backward (tests/test_attention.py:198)."""
    s, d = 1152, 32
    q, k, v = _arrays((1, 1, s, d), 3, seed=11)
    ids = np.asarray(np.random.default_rng(11).integers(0, 31, (s, 3)), np.float32)
    cos, sin = jrope_tables(jnp.asarray(ids), (8, 12, 12))
    want = _jax_rope_grad()(*map(jnp.asarray, (q, k, v)), cos, sin)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tcos, tsin = _t(cos, sin)
    out, _ = tfa.flash_attention_rope(tq, tk, tv, tcos, tsin)
    (out ** 2).sum().backward()
    for x, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_plain_function_matches_jax_grad():
    """The K2 + K4 Function against jax.grad of flash_attention (unaligned S)."""
    q, k, v, w = _arrays((2, 2, 200, 32), 4, seed=23)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, 128, True, "pallas") * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out, lse = tfa.flash_attention(tq, tk, tv)
    assert not lse.requires_grad
    (out * torch.from_numpy(w)).sum().backward()
    for x, g in zip((tq, tk, tv), want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), **TOL)


def test_cpu_functions_launch_nothing_and_leave_tables_alone():
    q, k, v = (x.requires_grad_() for x in _t(*_arrays((1, 2, 40, 32), 3, seed=5)))
    cos, sin = (torch.rand(40, 32).requires_grad_() for _ in range(2))
    before = (tfa.flash_attention_rope.launches, tfa.flash_attention_backward.launches)
    tfa.flash_attention_rope(q, k, v, cos, sin)[0].sum().backward()
    assert (tfa.flash_attention_rope.launches, tfa.flash_attention_backward.launches) == before
    assert cos.grad is None and sin.grad is None
    assert all(x.grad is not None for x in (q, k, v))


def test_attention_entry_on_the_cpu_is_plain_attention():
    q, k, v = _t(*_arrays((1, 2, 30, 32), 3, seed=6))
    torch.testing.assert_close(attention(q, k, v), plain_attention(q, k, v), rtol=0, atol=0)


GRAD_MAX_RTOL, GRAD_MEAN_RTOL = 2.0 ** -5, 2.0 ** -7   # chip_smoke.py's, kernel vs plain


def _assert_grads_close(got, want):
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        err, ref = (x.float() - y.float()).abs(), y.float().abs()
        assert err.max().item() <= GRAD_MAX_RTOL * ref.max().item(), name
        assert err.mean().item() <= GRAD_MEAN_RTOL * ref.mean().item(), name


def _bf16_case(shape, online, seed):
    q, k, v, g = (x.to(torch.bfloat16) for x in _t(*_arrays(shape, 4, seed=seed)))
    out, lse = tfa.flash_attention_plain(q, k, v, online)   # what the Function saves
    return q, k, v, out, lse, g


@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 128), (2, 2, 300, 128), (1, 2, 40, 128),
                                   (1, 1, 128, 128)],
                         ids=["aligned", "unaligned", "under-a-tile", "one-tile"])
def test_emulated_backward_loop_matches_plain(shape, online):
    """bf16 inputs, the card's tolerances: two key blocks by four query tiles;
    300 = 2 x 128 + 44 keys and 4 x 64 + 44 queries (ragged last tiles); 40 and
    128 rows in one block."""
    args = _bf16_case(shape, online, seed=shape[2] + online)
    got = emulated_backward_loop(*args, online=online)
    _assert_grads_close(got, tfa.flash_attention_backward_plain(*args, online=online))


@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
def test_emulated_backward_loop_beyond_the_clamp(online):
    """Planted logits up to 80: clamped, p comes from logits clipped at +/-43
    log2(e) in log2 units and the gradient passes straight through; online,
    no clip."""
    q, k, v, g = (x.to(torch.bfloat16) for x in _t(*_planted(d=128)))
    out, lse = tfa.flash_attention_streaming_plain(q, k, v, online)   # scale on the logits
    args = (q, k, v, out, lse, g)
    if not online:
        assert tfa.flash_attention_streaming_plain(q, k, v, True)[1].max() > tfa.LOGIT_CLAMP
    got = emulated_backward_loop(*args, online=online)
    _assert_grads_close(got, tfa.flash_attention_backward_plain(*args, online=online))


@pytest.mark.parametrize("shape", [(2, 2, 200, 32), (1, 1, 1152, 32)])
def test_emulated_backward_loop_matches_pallas(shape):
    """fp32 inputs (no bf16 rounding of p and ds on either side): the loop
    against the interpreted Pallas _dq_kernel/_dkv_kernel."""
    q, k, v, g = _arrays(shape, 4, seed=shape[2])
    out, lse, pallas, _ = _jax_backward(128)(*map(jnp.asarray, (q, k, v, g)))
    got = emulated_backward_loop(*_t(q, k, v, out, lse, g), online=False)
    for x, want in zip(got, pallas):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), **TOL)


def test_emulated_backward_loop_matches_pallas_beyond_the_clamp():
    q, k, v, g = _planted()
    out, lse, pallas, _ = _jax_backward(128)(*map(jnp.asarray, (q, k, v, g)))
    got = emulated_backward_loop(*_t(q, k, v, out, lse, g), online=False)
    for x, want in zip(got, pallas):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [200, 64, 1])
def test_preprocess_plain_matches_jnp_sum(s):
    """delta against jnp.sum(g * out) (``_flash_backward_pallas``), lse2 =
    lse * log2(e), both padded with zeros to a multiple of 64 rows; the CPU
    wrapper is the plain version."""
    out, g = _arrays((2, 3, s, 32), 2, seed=s)
    lse = _arrays((2, 3, s), 1, seed=s + 1)[0]
    want = np.asarray(jnp.sum(jnp.asarray(g) * jnp.asarray(out), axis=-1))
    s_pad = -(-s // 64) * 64
    for fn in (tfa.backward_preprocess_plain, tfa.backward_preprocess):
        delta, lse2 = fn(*_t(out, lse, g))
        assert delta.shape == lse2.shape == (2, 3, s_pad) and delta.dtype == torch.float32
        np.testing.assert_allclose(delta[..., :s].numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse2[..., :s].numpy(), lse * np.float32(LOG2E), rtol=1e-6)
        assert not bool(delta[..., s:].any()) and not bool(lse2[..., s:].any())
