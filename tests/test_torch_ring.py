"""The port's sequence-parallel attention and K5's plain ring step against the
JAX package, on the CPU.

JAX runs on the in-process 8-device CPU mesh (tests/conftest.py), the Pallas
ring kernel (``impl="ring_pallas"``) in interpret mode; the port runs its
ranks as threads of one process (``parallel/testing.py``) on the same numpy
inputs, each rank on its shard, and the shards' outputs are put back together.
Tolerance: rtol = atol = 1e-5 in float32, as ``tests/mesh_scenarios.py``
holds the JAX implementations to single-device attention; the bf16 ring
within 0.05 of the float32 result, as there.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from reptext_tpu.parallel import make_sp_mesh, sequence_sharded_attention as j_sharded
from reptext_tpu.parallel.sequence import (
    _online_softmax_block as j_block,
    joint_ring_attention_local as j_joint_ring,
    joint_ulysses_attention_local as j_joint_ulysses,
)
from reptext_tpu_torch.ops._build import count_launch
from reptext_tpu_torch.ops.ring_attention import ring_step, ring_step_plain
from reptext_tpu_torch.parallel.sequence import (
    joint_ring_attention_local,
    joint_ulysses_attention_local,
    sequence_sharded_attention,
)
from reptext_tpu_torch.parallel.testing import LocalSPGroup, run_spmd

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (2, 4, 64, 16)


@pytest.fixture
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("requires 8 virtual devices")


def _qkv(shape=SHAPE, seed=7):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _port_sharded(q, k, v, n, impl, dtype=torch.float32):
    """The port's ``impl`` over n thread ranks, shards put back together."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))

    def rank(g):
        return sequence_sharded_attention(g.shard(tq, 2), g.shard(tk, 2), g.shard(tv, 2), g, impl)

    return torch.cat(run_spmd(LocalSPGroup(n), rank), dim=2).float().numpy()


@pytest.mark.parametrize("impl,j_impl,n", [
    ("ring_kernel", "ring_pallas", 8),    # K5's plain ring vs the interpreted Pallas kernel
    ("ring", "ring", 8),
    ("allgather", "allgather", 8),
    ("ulysses", "ulysses", 4),            # heads % n == 0: 4 heads
])
def test_sequence_sharded_attention_matches_jax(eight_devices, impl, j_impl, n):
    q, k, v = _qkv()
    mesh = make_sp_mesh(n)
    want = np.asarray(jax.jit(lambda a, b, c: j_sharded(a, b, c, mesh, impl=j_impl))(q, k, v))
    np.testing.assert_allclose(_port_sharded(q, k, v, n, impl), want, **TOL)


@pytest.mark.parametrize("impl", ["ring", "ring_kernel"])
def test_bf16_ring_stays_near_fp32(impl):
    q, k, v = _qkv()
    want = _port_sharded(q, k, v, 8, impl)
    got = _port_sharded(q, k, v, 8, impl, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_ulysses_refuses_heads_not_divisible():
    q, k, v = _qkv((2, 3, 64, 16))
    with pytest.raises(ValueError, match="heads % sp"):
        _port_sharded(q, k, v, 4, "ulysses")


def test_unknown_impl_is_refused():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="unknown sp attention impl"):
        _port_sharded(q, k, v, 2, "ring_pallas")


def test_thread_ranks_lose_no_update():
    """More thread ranks than cores, a switch interval of a microsecond: the
    launch counter loses no increment and every collective sees every rank."""
    class Entry:
        launches = 0

    n, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def rank(g):
            for _ in range(per):
                count_launch(Entry)
            return (g.all_reduce_mean(torch.full((3,), float(g.rank))),
                    g.all_gather(torch.tensor([g.rank]), 0))
        outs = run_spmd(LocalSPGroup(n), rank)
    finally:
        sys.setswitchinterval(old)
    assert Entry.launches == n * per
    for mean, gathered in outs:
        assert torch.equal(mean, torch.full((3,), (n - 1) / 2))
        assert torch.equal(gathered, torch.arange(n))


def test_a_failing_rank_stops_every_rank():
    def rank(g):
        if g.rank == 1:
            raise KeyError("rank 1 fails")
        return g.all_gather(torch.zeros(2), 0)

    with pytest.raises(KeyError, match="rank 1 fails"):
        run_spmd(LocalSPGroup(3), rank)


@pytest.mark.parametrize("backend,n", [("ring", 8), ("ulysses", 4)])
def test_joint_attention_locals_match_jax(eight_devices, backend, n):
    """Text [B, H, 5, D] on every rank, image [B, H, 64, D] sharded: the text
    output (every rank's) and the image shards against the JAX locals under
    shard_map."""
    r = np.random.default_rng(3)
    txt = [r.standard_normal((2, 4, 5, 16)).astype(np.float32) for _ in range(3)]
    img = [r.standard_normal((2, 4, 64, 16)).astype(np.float32) for _ in range(3)]
    j_fn = j_joint_ring if backend == "ring" else j_joint_ulysses
    rep, tok = P(), P(None, None, "sp", None)
    want_t, want_i = jax.jit(jax.shard_map(
        lambda *a: j_fn(*a, axis_name="sp"), mesh=make_sp_mesh(n),
        in_specs=(rep,) * 3 + (tok,) * 3, out_specs=(rep, tok), check_vma=False))(*txt, *img)
    fn = joint_ring_attention_local if backend == "ring" else joint_ulysses_attention_local
    tt = [torch.from_numpy(x) for x in txt]
    ti = [torch.from_numpy(x) for x in img]
    outs = run_spmd(LocalSPGroup(n), lambda g: fn(*tt, *(g.shard(x, 2) for x in ti), group=g))
    for attn_t, _ in outs:
        np.testing.assert_allclose(attn_t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(torch.cat([o[1] for o in outs], dim=2).numpy(),
                               np.asarray(want_i), **TOL)


def _state_np(state):
    return [np.asarray(x, np.float32) for x in state]


def test_ring_step_plain_first_middle_and_last_steps():
    """Three K/V blocks of different lengths through the first, a middle and
    the last step: each state against ``_online_softmax_block`` (whose first
    call starts from m = -inf where the Pallas kernel starts from -1e30: the
    same state after one block), and the output against one softmax over all
    keys."""
    r = np.random.default_rng(11)
    q = r.standard_normal((2, 3, 24, 16)).astype(np.float32)
    blocks = [(r.standard_normal((2, 3, sk, 16)).astype(np.float32),
               r.standard_normal((2, 3, sk, 16)).astype(np.float32)) for sk in (8, 40, 17)]
    scale = 1.0 / 4.0
    j_state = (jnp.zeros(q.shape), jnp.full(q.shape[:-1], -jnp.inf), jnp.zeros(q.shape[:-1]))
    # the first step starts the state itself: what it is given is ignored
    state = tuple(torch.full(s, float("nan")) for s in (q.shape, q.shape[:-1], q.shape[:-1]))
    for i, (k, v) in enumerate(blocks):
        first, last = i == 0, i == len(blocks) - 1
        j_state = jax.jit(j_block, static_argnums=6)(q, k, v, *j_state, scale)
        got = ring_step_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              state, first, last)
        if last:
            acc, _, l = _state_np(j_state)
            np.testing.assert_allclose(got.numpy(), acc / l[..., None], **TOL)
        else:
            for mine, theirs in zip(got, _state_np(j_state)):
                np.testing.assert_allclose(mine.numpy(), theirs, **TOL)
            state = got
    k_all = np.concatenate([b[0] for b in blocks], axis=2)
    v_all = np.concatenate([b[1] for b in blocks], axis=2)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k_all) * scale
    p = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v_all)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_step_on_the_cpu_is_its_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 16, 16)))
    before = ring_step.launches
    np.testing.assert_array_equal(ring_step(q, k, v, None, True, True).numpy(),
                                  ring_step_plain(q, k, v, None, True, True).numpy())
    assert ring_step.launches == before
