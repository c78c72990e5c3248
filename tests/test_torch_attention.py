"""The port's flash attention (K1 RoPE-fused, K2) against the JAX Pallas
kernels, run in interpret mode on the CPU as tests/test_attention.py runs
them, and the kernel build line. The kernel itself is checked on the card by
tests/test_torch_cuda.py.

On the CPU the port's entries take their plain PyTorch versions. Tolerances:
fp32 inputs 2e-5 (the same bf16 tables and rounding points on both sides;
only the fp32 summation order differs: JAX sums 3 chunks, the port one
pass); lse 5e-5; bf16 inputs one bf16 ulp of the output (1e-2 at |out| < 2).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.ops import flash_attention as jfa
from reptext_tpu.ops.attention import attention as jattention
from reptext_tpu.ops.rope import rope_cos_sin_half as jrope_tables
from reptext_tpu_torch.ops import _build
from reptext_tpu_torch.ops import flash_attention as tfa
from reptext_tpu_torch.ops import ring_attention as tra
from reptext_tpu_torch.ops.attention import attention, plain_attention
from reptext_tpu_torch.ops.rope import apply_rope_half
from torch_port_util import LOG2E, emulated_key_loop

TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=5e-5, atol=5e-5)


def _qkv(b=1, h=2, s=128, d=32, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def _ids(s, seed=0):
    r = np.random.default_rng(seed)
    ids = np.zeros((s, 3), np.float32)
    ids[:, 1] = np.arange(s) % 37
    ids[:, 2] = r.integers(0, 29, s)
    return ids


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("s", [1152, 1100])
def test_k1_plain_matches_pallas_rope_kernel(s):
    """1152 is the smallest length the fused RoPE kernel runs chunked
    (aligned); 1100 pads to 1536 inside it and masks the tail."""
    q, k, v = _qkv(s=s, d=64, seed=s)
    cos, sin = jrope_tables(jnp.asarray(_ids(s)), (16, 24, 24))
    want_o, want_l = jfa._flash_attention_rope_impl(
        *map(jnp.asarray, (q, k, v)), cos, sin, block_q=512, interpret=True)
    got_o, got_l = tfa.flash_attention_rope(*_t(q, k, v, cos, sin))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LSE_TOL)


@pytest.mark.parametrize("s", [256, 200])
def test_k2_plain_matches_pallas_kernel(s):
    q, k, v = _qkv(b=2, s=s, seed=s)
    want_o, want_l = jfa._flash_attention_impl(*map(jnp.asarray, (q, k, v)), block_q=128,
                                               interpret=True)
    got_o, got_l = tfa.flash_attention(*_t(q, k, v))
    assert got_o.shape == (2, 2, s, 32) and got_l.shape == (2, 2, s)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LSE_TOL)


def test_lse_is_the_row_logsumexp():
    q, k, v = _qkv(s=200, seed=17)
    _, lse = tfa.flash_attention(*_t(q, k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(32)
    want = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=5e-5, atol=2e-4)


def test_bf16_matches_pallas_kernel():
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(s=128, seed=9)))
    want_o, want_l = jfa._flash_attention_impl(q, k, v, block_q=128, interpret=True)
    got_o, got_l = tfa.flash_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                                         .to(torch.bfloat16) for x in (q, k, v)))
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LSE_TOL)


def _planted(peak, s=256, d=32):
    from test_attention import _planted_logit_qkv

    return [np.asarray(x) for x in _planted_logit_qkv(peak, s, d)]


def _softmax_out(logits, v):
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def test_clamped_exact_inside_bound():
    q, k, v = _planted(40.0)
    got, _ = tfa.flash_attention(*_t(q, k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(32)
    np.testing.assert_allclose(got.numpy(), _softmax_out(logits, v), **TOL)
    want = jfa._flash_attention_impl(*map(jnp.asarray, (q, k, v)), block_q=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), **TOL)


def test_clamped_beyond_bound_is_clipped_softmax():
    q, k, v = _planted(80.0)
    got, lse = tfa.flash_attention(*_t(q, k, v))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(32)
    clipped = np.clip(logits, -tfa.LOGIT_CLAMP, tfa.LOGIT_CLAMP)
    np.testing.assert_allclose(got.numpy(), _softmax_out(clipped, v), **TOL)
    assert np.abs(_softmax_out(logits, v) - got.numpy()).max() > 1e-3
    want_o, want_l = jfa._flash_attention_impl(*map(jnp.asarray, (q, k, v)), block_q=128,
                                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_l), **LSE_TOL)


def test_online_equals_clamped():
    q, k, v = _qkv(s=200, seed=31)
    cos, sin = jrope_tables(jnp.asarray(_ids(200)), (8, 12, 12))
    args = _t(q, k, v, cos, sin)
    for fn, a in ((tfa.flash_attention_rope, args), (tfa.flash_attention, args[:3])):
        oc, lc = fn(*a, online=False)
        oo, lo = fn(*a, online=True)
        np.testing.assert_allclose(oc.numpy(), oo.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lc.numpy(), lo.numpy(), rtol=1e-5, atol=1e-5)


def test_online_matches_pallas_online_kernel(monkeypatch):
    q, k, v = _qkv(s=200, seed=33)
    monkeypatch.setenv("REPTEXT_SOFTMAX", "online")
    want_o, want_l = jfa._flash_attention_impl(*map(jnp.asarray, (q, k, v)), block_q=128,
                                               interpret=True)
    got_o, got_l = tfa.flash_attention(*_t(q, k, v), online=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **LSE_TOL)


# ----------------------------------------- the kernel's key loop, emulated
#
# The card's kernel streams 128-key tiles, keeps its logits in log2 units
# (one multiply after the product, the clamp at 43 log2(e), exp2), rounds p to
# bf16 for PV and converts lse and the ring step's m back to natural units.
# tests/torch_port_util.py::emulated_key_loop is that loop in plain PyTorch;
# here it is held against the plain versions at the card's tolerances
# (chip_smoke.py: out within 2^-6 of max|plain out|, lse within 1e-3; the ring
# state: m within 1e-3, l within 1e-3 relative), on bf16 inputs as the kernel
# takes them, at an aligned and an unaligned length.

OUT_RTOL, LSE_ATOL = 2.0 ** -6, 1e-3


def _bf16_qkv(b, h, s, d, seed):
    return [x.to(torch.bfloat16) for x in _t(*_qkv(b, h, s, d, seed))]


def _assert_out(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= OUT_RTOL * want.float().abs().max().item()


@pytest.mark.parametrize("s", [256, 300])
@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_emulated_key_loop_matches_plain(kernel, online, s):
    d = 64
    q, k, v = _bf16_qkv(2, 2, s, d, seed=s + online)
    scale = 1.0 / math.sqrt(d)
    if kernel == "K1":
        cos, sin = _t(*jrope_tables(jnp.asarray(_ids(s)), (16, 24, 24)))
        want = tfa.flash_attention_rope_plain(q, k, v, cos, sin, online)
        cos, sin = (x.to(torch.bfloat16).float() for x in (cos, sin))
        qp = (apply_rope_half(q.float(), cos, sin) * scale).to(q.dtype)
        got = emulated_key_loop(qp, apply_rope_half(k, cos, sin), v, LOG2E, online)
    elif kernel == "K2":
        want = tfa.flash_attention_plain(q, k, v, online)
        got = emulated_key_loop((q.float() * scale).to(q.dtype), k, v, LOG2E, online)
    else:
        want = tfa.flash_attention_streaming_plain(q, k, v, online)
        got = emulated_key_loop(q, k, v, scale * LOG2E, online)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    _assert_out(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= LSE_ATOL


@pytest.mark.parametrize("online", [False, True], ids=["clamped", "online"])
def test_emulated_key_loop_beyond_the_clamp(online):
    """Planted logits up to 80: clamped, both clip at 43 (43 log2(e) in log2
    units); online, neither does, and the two modes differ."""
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_planted(80.0)))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = tfa.flash_attention_streaming_plain(q, k, v, online)
    got = emulated_key_loop(q, k, v, scale * LOG2E, online)
    _assert_out(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= LSE_ATOL
    other = emulated_key_loop(q, k, v, scale * LOG2E, not online)
    assert (got[0].float() - other[0].float()).abs().max().item() > 1e-2


@pytest.mark.parametrize("sq,sks", [(200, (512, 333, 8)), (128, (128, 256))])
def test_emulated_ring_steps_match_plain(sq, sks):
    """K5's carried state over unequal K/V blocks, held against
    ``ring_step_plain`` after every step: m goes through natural units in
    the state and back to log2 units at the next step."""
    d = 64
    q = _bf16_qkv(1, 2, sq, d, seed=sq)[0]
    mul = LOG2E / math.sqrt(d)
    state = want = None
    for i, sk in enumerate(sks):
        k, v = _bf16_qkv(1, 2, sk, d, seed=sk + i)[:2]
        first, last = i == 0, i == len(sks) - 1
        want = tra.ring_step_plain(q, k, v, want, first, last)
        state = emulated_key_loop(q, k, v, mul, True, state=state, first=first, last=last,
                                  carry=True)
        if last:
            _assert_out(state, want)
        else:
            _assert_out(state[0] / state[2][..., None], want[0] / want[2][..., None])
            assert (state[1] - want[1]).abs().max().item() <= 1e-3
            assert ((state[2] - want[2]).abs() / want[2]).max().item() <= 1e-3


def test_softmax_mode_is_read_once(monkeypatch):
    tfa.softmax_mode.cache_clear()
    try:
        monkeypatch.setenv("REPTEXT_SOFTMAX", "online")
        assert tfa.softmax_mode() == "online"
        monkeypatch.setenv("REPTEXT_SOFTMAX", "clamped")
        assert tfa.softmax_mode() == "online"
    finally:
        tfa.softmax_mode.cache_clear()


def test_attention_cpu_matches_jax_xla_backend():
    """A CPU tensor takes the plain path: the twin of the JAX xla backend
    (fp32 tables, rotation outside the softmax), with and without RoPE."""
    q, k, v = _qkv(b=2, s=40, seed=3)
    cos, sin = jrope_tables(jnp.asarray(_ids(40)), (8, 12, 12))
    got = attention(*_t(q, k, v, cos, sin)).numpy()
    want = np.asarray(jattention(*map(jnp.asarray, (q, k, v)), backend="xla",
                                 rope_cos=cos, rope_sin=sin))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attention(*_t(q, k, v)).numpy(),
                               np.asarray(jattention(*map(jnp.asarray, (q, k, v)), backend="xla")),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain_attention(*_t(q, k, v)).numpy(),
                               attention(*_t(q, k, v)).numpy())


def test_cpu_calls_do_not_count_launches():
    before = (tfa.flash_attention_rope.launches, tfa.flash_attention.launches)
    q, k, v = _qkv(s=16, seed=4)
    cos, sin = jrope_tables(jnp.asarray(_ids(16)), (8, 12, 12))
    tfa.flash_attention_rope(*_t(q, k, v, cos, sin))
    tfa.flash_attention(*_t(q, k, v))
    assert (tfa.flash_attention_rope.launches, tfa.flash_attention.launches) == before


def test_wrapper_rejects_non_cuda_tensors():
    x = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._check("q", x, x.shape)


def test_build_line_targets_sm90a():
    cmd = _build.nvcc_command("nvcc", "a.cu", "a.o")
    link = _build.link_command("nvcc", ["a.o", "b.o"], "out.so")
    for line in (cmd, link):
        assert "arch=compute_90a,code=sm_90a" in line
        assert line[line.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    for flag in ("-std=c++17", "-O3", "-c", "-fPIC"):
        assert flag in cmd
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
    names = [os.path.basename(s) for s in _build.sources()]
    assert "flash_attention.cu" in names and "flash_attention_bwd.cu" in names


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
