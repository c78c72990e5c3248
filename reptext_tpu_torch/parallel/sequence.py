"""Sequence parallelism: the image tokens sharded over an SP group.

Counterpart of ``reptext_tpu/parallel/sequence.py``. Where the JAX package
writes each function as a ``shard_map`` over the ``sp`` mesh axis, here the
rank's part runs on every rank (one process per card, or one thread per rank
in ``parallel/testing.py``) and exchanges through its :class:`SPGroup`. The
attention functions take and return this rank's [B, H, S/n, D] shards;
:func:`sequence_parallel_forward` and the SP sampler are the ``shard_map``
boundary: they take global tensors on every rank, run the rank's shard and
gather the result.

- ``ring``: K/V blocks rotate around the group with the fp32 online softmax
  of ``_online_softmax_block`` (:func:`ring_step_plain`), the collective
  ring; ``ring_kernel`` is the same ring with each step on K5 (the JAX
  package's ``ring_pallas``, ``ops/ring_attention.py``);
- ``allgather``: K/V gathered once, one softmax over all keys (one K5 step
  with the state started and finished in one launch on the card);
- ``ulysses``: an all-to-all trades the rank's token slice of every head for
  every token of ``H/n`` heads, one exact softmax over all keys
  (:func:`exact_attention`: the running-max form of K2, or of K3 past 6144
  tokens, on the card; the JAX package's Ulysses is an fp32 softmax too, with
  no clamp on the logits), and back.

The model's blocks reach :func:`joint_ring_attention_local` or
:func:`joint_ulysses_attention_local` through the thread's SP context
(:func:`sp_context`), which the SP forward and sampler set. It carries the
group and the backend, and it is their only carrier: several pipelines,
sharded or not, share one set of module instances (``with_config``,
``from_pipeline``, the thread ranks), so neither is ever written into a
module. A model reads its backend with :func:`active_backend`.
On the card every step of the joint ring runs on K5, since it computes the
same function as ``_online_softmax_block``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from reptext_tpu_torch.ops.attention import plain_attention
from reptext_tpu_torch.ops.flash_attention import flash_attention
from reptext_tpu_torch.ops.ring_attention import (
    ring_flash_attention,
    ring_loop,
    ring_step,
    ring_step_plain,
)
from reptext_tpu_torch.parallel.group import SPGroup

_context = threading.local()


@contextlib.contextmanager
def sp_context(group: SPGroup, backend: str):
    """Make ``group`` the SP group, and ``backend`` ('ring' | 'ulysses') the
    attention backend, of this thread's blocks while inside."""
    prev = getattr(_context, "group", None), getattr(_context, "backend", None)
    _context.group, _context.backend = group, backend
    try:
        yield group
    finally:
        _context.group, _context.backend = prev


def current_group() -> SPGroup:
    group = getattr(_context, "group", None)
    if group is None:
        raise RuntimeError("a sequence-parallel attention backend runs only inside "
                           "sequence_parallel_forward or the SP sampler (no SP group is set)")
    return group


def active_backend() -> Optional[str]:
    """The attention backend of a model's blocks: the thread's SP context's,
    None outside any (the one-device attention)."""
    return getattr(_context, "backend", None)


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One exact softmax over all keys of [B, H, S, D] q, k, v already
    rotated: the running-max form of K2 (K3 past 6144 tokens) on the card,
    whatever ``REPTEXT_SOFTMAX`` says, and :func:`plain_attention` on the CPU."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, online=True)[0]
    return plain_attention(q, k, v)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: SPGroup) -> torch.Tensor:
    """The collective ring with plain fp32 steps; shards in, shard out."""
    return ring_loop(q, k, v, group, ring_step_plain)


def allgather_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group: SPGroup) -> torch.Tensor:
    """K/V gathered once, then one softmax over every key."""
    k_full, v_full = group.all_gather(k, 2), group.all_gather(v, 2)
    return ring_step(q, k_full, v_full, None, first=True, last=True)


def _check_heads(h: int, n: int) -> None:
    if h % n:
        raise ValueError(f"ulysses needs heads % sp == 0, got {h} % {n}")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: SPGroup) -> torch.Tensor:
    """All-to-all head swap: [B, H, S/n, D] -> [B, H/n, S, D], attention, back."""
    _check_heads(q.shape[1], group.size)
    swap = lambda x: group.all_to_all(x, 1, 2)   # noqa: E731
    return group.all_to_all(exact_attention(swap(q), swap(k), swap(v)), 2, 1)


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               group: SPGroup, impl: str = "ring") -> torch.Tensor:
    """Dispatch: ``impl`` in {'ring', 'ring_kernel', 'allgather', 'ulysses'}."""
    fn = {"ring": ring_attention, "ring_kernel": ring_flash_attention,
          "allgather": allgather_attention, "ulysses": ulysses_attention}.get(impl)
    if fn is None:
        raise ValueError(f"unknown sp attention impl {impl!r}")
    return fn(q, k, v, group)


def joint_ring_attention_local(q_t, k_t, v_t, q_i, k_i, v_i,
                               group: Optional[SPGroup] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MMDiT joint attention with the text tokens [B, H, S_txt, D] on every
    rank and the image tokens [B, H, S_img/n, D] sharded: the text K/V block
    is folded in once, then the rank's own image block and the rotated ones.
    Text and image queries share each step's launch (their rows are
    independent). Returns (text output, image output shard)."""
    group = group or current_group()
    s_txt = q_t.shape[2]
    out = ring_loop(torch.cat([q_t, q_i], dim=2), k_i, v_i, group, ring_step,
                    prefix=(k_t, v_t))
    return out[:, :, :s_txt], out[:, :, s_txt:]


def joint_ulysses_attention_local(q_t, k_t, v_t, q_i, k_i, v_i,
                                  group: Optional[SPGroup] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MMDiT joint attention by the all-to-all head swap: the rank's head
    group of the text tensors joins every image token of those heads, one
    exact softmax over the joint sequence, then image tokens go back to the
    token shards and the text output is gathered over head groups."""
    group = group or current_group()
    n, h, s_txt = group.size, q_t.shape[1], q_t.shape[2]
    _check_heads(h, n)
    hn = h // n
    heads = lambda x: x[:, group.rank * hn:(group.rank + 1) * hn]   # noqa: E731
    a2a_in = lambda x: group.all_to_all(x, 1, 2)                     # noqa: E731
    q = torch.cat([heads(q_t), a2a_in(q_i)], dim=2)
    k = torch.cat([heads(k_t), a2a_in(k_i)], dim=2)
    v = torch.cat([heads(v_t), a2a_in(v_i)], dim=2)
    o = exact_attention(q, k, v)
    attn_i = group.all_to_all(o[:, :, s_txt:], 2, 1)
    attn_t = group.all_gather(o[:, :, :s_txt], 1)
    return attn_t, attn_i


JOINT_SP_ATTENTION = {"ring": joint_ring_attention_local,
                      "ulysses": joint_ulysses_attention_local}


def _shard_stacks(stacks, group: SPGroup):
    if stacks is None:
        return None
    if isinstance(stacks, (tuple, list)):
        return tuple(group.shard(s, 2) for s in stacks)
    return group.shard(stacks, 2)


def sequence_parallel_forward(model, hidden_states, encoder_hidden_states, pooled_projections,
                              timestep, img_ids, txt_ids, guidance=None, *,
                              group: SPGroup, backend: str,
                              controlnet_block_samples=None,
                              controlnet_single_block_samples=None) -> torch.Tensor:
    """A FLUX forward with the image sequence sharded over ``group``.

    ``backend`` is 'ring' or 'ulysses' (the JAX function's
    ``clone(attention_backend=...)``): the SP attention of ``model``'s blocks
    for this call. Every rank
    passes the global tensors; the packed latents [B, S_img, C], the image
    RoPE ids [S_img, 3] and the ControlNet residual stacks [L, B, S_img, D]
    (a tensor or a tuple) are sharded over the tokens (the injection is per
    token), the rest is replicated. Returns the global velocity on every rank.
    """
    if backend not in JOINT_SP_ATTENTION:
        raise ValueError(f"sequence_parallel_forward needs the backend ring|ulysses, "
                         f"got {backend!r}")
    with sp_context(group, backend):
        out = model(group.shard(hidden_states, 1), encoder_hidden_states, pooled_projections,
                    timestep, group.shard(img_ids, 0), txt_ids, guidance,
                    controlnet_block_samples=_shard_stacks(controlnet_block_samples, group),
                    controlnet_single_block_samples=_shard_stacks(
                        controlnet_single_block_samples, group))
    return group.all_gather(out, 1)
