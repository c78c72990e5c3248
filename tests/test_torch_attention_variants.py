"""The attention A/B variants' plain versions against the Pallas kernel bodies.

``reptext_tpu_torch/ops/attention_variants.py`` ports the three kernels of the
JAX package's attention study: ``benchmarks/exp_softmax_overlap.py``'s
``_chunked_kernel`` and ``_bf16exp_kernel`` and ``benchmarks/
sweep_attention.py``'s ``_exp2_kernel``. Their wrappers in those scripts ask
for TPU memory spaces, which the CPU backend refuses, so each body runs here in
a ``pl.pallas_call(..., interpret=True)`` built with the scripts' own grid
(b, h, s // block_q) and block shapes. ``_chunked_kernel`` and
``_bf16exp_kernel`` are loaded from their file; ``_exp2_kernel`` is nested in
``main()`` and cannot be imported, so :func:`_exp2_kernel` below carries a copy
of ``benchmarks/sweep_attention.py:67-80``.

Inputs: bf16 q, k, v at (1, 2, 512, 128) from a numpy seed. Tolerance: both
sides round p and the output to bf16 at the same points and sum fp32 products
in another order, so an output element may land one bf16 ulp (2^-8 relative)
away: rtol = atol = 2^-7, as for the port's other attention kernels.
"""

import functools as ft
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from reptext_tpu_torch.ops import attention_variants as av

ROOT = Path(__file__).resolve().parent.parent
B, H, S, D = 1, 2, 512, 128
OUT_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_study_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OVERLAP = _load("exp_softmax_overlap")


def _exp2_kernel(q_ref, k_ref, v_ref, o_ref, *, scale):
    """benchmarks/sweep_attention.py:67-80, verbatim."""
    q, k, v = q_ref[0, 0], k_ref[0, 0], v_ref[0, 0]
    logits = jax.lax.dot_general(
        q, k, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) * (scale * 1.4426950408889634)
    m = jnp.max(logits, axis=-1, keepdims=True)
    e = jnp.exp2(logits - m)
    denom = jnp.sum(e, axis=-1, keepdims=True)
    o = jax.lax.dot_general(
        e.astype(v.dtype), v, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    o_ref[0, 0] = (o / denom).astype(o_ref.dtype)


def _interpret(body, q, k, v, block_q):
    """The scripts' pallas_call (grid, block shapes) in interpret mode."""
    b, h, s, d = q.shape
    q_spec = pl.BlockSpec((1, 1, block_q, d), lambda bi, hi, qi: (bi, hi, qi, 0))
    kv_spec = pl.BlockSpec((1, 1, s, d), lambda bi, hi, qi: (bi, hi, 0, 0))
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((b, h, s, d), q.dtype), grid=(b, h, s // block_q),
        in_specs=[q_spec, kv_spec, kv_spec], out_specs=q_spec, interpret=True)(q, k, v)


def _inputs(seed, s=S, d=D):
    r = np.random.default_rng(seed)
    xs = [r.standard_normal((B, H, s, d)).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(x, jnp.bfloat16) for x in xs],
            [torch.from_numpy(x).to(torch.bfloat16) for x in xs])


def _f32(x):
    if isinstance(x, jax.Array):
        return np.asarray(jnp.asarray(x, jnp.float32))
    return x.float().numpy()


SCALE = 1.0 / math.sqrt(D)


@pytest.mark.parametrize("block_q", [128, 256])
@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunked_plain_matches_pallas_body(block_q, n_chunks):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=block_q + n_chunks)
    body = ft.partial(OVERLAP._chunked_kernel, scale=SCALE, n_chunks=n_chunks)
    want = _interpret(body, jq, jk, jv, block_q)
    got = av.chunked_attn_plain(tq, tk, tv, block_q, n_chunks)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, D)
    np.testing.assert_allclose(_f32(got), _f32(want), **OUT_TOL)


@pytest.mark.parametrize("block_q", [128, 256])
def test_bf16exp_plain_matches_pallas_body(block_q):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=block_q + 10)
    want = _interpret(ft.partial(OVERLAP._bf16exp_kernel, scale=SCALE), jq, jk, jv, block_q)
    got = av.bf16exp_attn_plain(tq, tk, tv, block_q)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, D)
    np.testing.assert_allclose(_f32(got), _f32(want), **OUT_TOL)


@pytest.mark.parametrize("block_q", [128, 256])
def test_exp2_plain_matches_pallas_body(block_q):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=block_q + 20)
    want = _interpret(ft.partial(_exp2_kernel, scale=SCALE), jq, jk, jv, block_q)
    got = av.exp2_attn_plain(tq, tk, tv, block_q)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, D)
    np.testing.assert_allclose(_f32(got), _f32(want), **OUT_TOL)


def test_variants_agree_with_an_fp32_softmax():
    """The study's own check (``check_correct``: atol 2e-2, 4e-2 for bf16-exp),
    here at S = 512 on the plain versions."""
    _, (q, k, v) = _inputs(seed=3)
    ref = torch.softmax(q.float() @ k.float().transpose(-1, -2) * SCALE, dim=-1) @ v.float()
    for fn, atol in ((av.chunked_attn_plain, 2e-2), (av.exp2_attn_plain, 2e-2),
                     (av.bf16exp_attn_plain, 4e-2)):
        assert (fn(q, k, v).float() - ref).abs().max().item() < atol


ENTRIES = {"chunked": (av.chunked_attn, av.chunked_attn_plain),
           "bf16exp": (av.bf16exp_attn, av.bf16exp_attn_plain),
           "exp2": (av.exp2_attn, av.exp2_attn_plain)}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_cpu_wrapper_takes_the_plain_version(name):
    entry, plain = ENTRIES[name]
    _, (q, k, v) = _inputs(seed=4, s=256)
    before = entry.launches
    torch.testing.assert_close(entry(q, k, v, 128), plain(q, k, v, 128), rtol=0, atol=0)
    assert entry.launches == before       # the count is of kernel launches only


@pytest.mark.parametrize("name", sorted(ENTRIES))
@pytest.mark.parametrize("case", ["ragged_s", "fp16", "head_dim", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(name, case):
    entry, _ = ENTRIES[name]
    _, (q, k, v) = _inputs(seed=5, s=320, d=128 if case != "head_dim" else 64)
    if case == "fp16":
        q, k, v = (x.half() for x in (q, k, v))
    if case == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    error = TypeError if case == "fp16" else ValueError
    with pytest.raises(error):
        entry(q, k, v, 128 if case == "ragged_s" else 64)


def test_chunked_rejects_a_ragged_chunk_count():
    _, (q, k, v) = _inputs(seed=6, s=256)
    with pytest.raises(ValueError, match="n_chunks"):
        av.chunked_attn(q, k, v, 128, 3)
