"""K5, the ring attention step: a hand-written Hopper kernel and its plain twin.

Counterpart of ``reptext_tpu/ops/ring_attention.py``. The Pallas kernel
``_ring_kernel`` is one program per device: it holds the device's Q shard,
rotates K/V blocks to the right neighbour by in-kernel RDMA into a
double-buffered slot (a capacity-semaphore handshake guards each slot) and
folds every block into an fp32 online-softmax state, dividing once at the
end. On Hopper the transfer is a collective outside the kernel (NCCL between
cards), so one launch of the kernel is one ring step (``csrc/flash_attention.cu``,
``reptext_ring_attention_step``) and no kernel waits on another rank; the state
``(acc [B, H, Sq, D], m [B, H, Sq], l [B, H, Sq])``, all fp32, is carried in
device memory from one step to the next.

:func:`ring_step` launches the kernel on CUDA tensors and counts it in
``ring_step.launches``; on CPU tensors it is :func:`ring_step_plain`, the fp32
``_online_softmax_block`` of ``reptext_tpu/parallel/sequence.py`` with the
state started as the Pallas kernel starts it (m = -1e30). The kernel rounds
p to bf16 for PV, as K1-K3 do, where the plain version multiplies fp32 p by
fp32 V. :func:`ring_loop` runs the n steps of one rank over an SP group
(``parallel/group.py``); :func:`ring_flash_attention` is the loop on the
kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from reptext_tpu_torch.ops import _build
from reptext_tpu_torch.ops.flash_attention import _bf16, _check, check_head_dim

# the ring step is instantiated at FLUX.1-dev's 128, the demo models' 64 and the
# tiny configs' 32, in bf16 and fp32 (as K1-K3: an fp32 call's q, k and v are
# rounded to bf16 on their way in, and the last step writes its output in fp32)
_SUPPORTED_HEAD_DIMS = (32, 64, 128)

NEG_INF = -1e30
RingState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # acc, m, l
StepResult = Union[RingState, torch.Tensor]


def ring_step_plain(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                    state: Optional[RingState], first: bool, last: bool) -> StepResult:
    """One online-softmax update of q [B, H, Sq, D] against a K/V block
    [B, H, Sk, D], in fp32: ``first`` starts the state (``state`` unused);
    ``last`` returns acc / l in q's dtype, else the new state."""
    if first:
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    else:
        acc, m, l = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k_blk.float().transpose(-1, -2)) * scale
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.matmul(p, v_blk.float())
    if last:
        return (acc / l[..., None]).to(q.dtype)
    return acc, m_new, l


def _launch(q, k_blk, v_blk, state, first: bool, last: bool) -> StepResult:
    b, h, sq, d = q.shape
    sk = k_blk.shape[2]
    check_head_dim(d, _SUPPORTED_HEAD_DIMS)
    for name, x, shape in (("q", q, (b, h, sq, d)), ("k_blk", k_blk, (b, h, sk, d)),
                           ("v_blk", v_blk, (b, h, sk, d))):
        _check(name, x, shape)
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q {q.dtype} on {q.device}")
    if first:
        state = None if last else (
            torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device),
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device),
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device))
    else:
        for name, x, shape in zip(("acc", "m", "l"), state,
                                  ((b, h, sq, d), (b, h, sq), (b, h, sq))):
            if (x.device != q.device or x.dtype != torch.float32 or tuple(x.shape) != shape
                    or not x.is_contiguous()):
                raise ValueError(f"state {name} must be a contiguous float32 {list(shape)} "
                                 f"tensor on {q.device}")
    # out is laid out [B, Sq, H, D] and returned as a [B, H, Sq, D] view, so
    # the caller's head merge is a free reshape (as K1-K3 lay it out)
    out = (torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
           if last else None)
    acc, m, l = state if state is not None else (None, None, None)
    out_f32 = int(q.dtype == torch.float32)
    q, k_blk, v_blk = _bf16(q), _bf16(k_blk), _bf16(v_blk)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    o_strides = out.stride()[:3] if last else (0, 0, 0)
    err = lib.reptext_ring_attention_step(
        q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), ptr(out), ptr(acc), ptr(m), ptr(l),
        b, h, sq, sk, d, *q.stride()[:3], *k_blk.stride()[:3], *v_blk.stride()[:3], *o_strides,
        1.0 / math.sqrt(d), int(first), int(last), out_f32, stream)
    if err != 0:
        raise RuntimeError(f"ring attention step kernel launch failed: cudaError {err}")
    return out if last else state


def ring_step(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
              state: Optional[RingState], first: bool, last: bool) -> StepResult:
    """K5's step: see :func:`ring_step_plain` for what it computes. On CUDA
    the state is updated in place (each thread of the kernel reads and writes
    its own elements) and the first step allocates it."""
    if q.device.type == "cpu":
        return ring_step_plain(q, k_blk, v_blk, state, first, last)
    result = _launch(q, k_blk, v_blk, state, first, last)
    _build.count_launch(ring_step)
    return result


Step = Callable[..., StepResult]


def ring_loop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, step: Step,
              prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One rank's ring: q, k, v are its [B, H, S/n, D] shards; returns its
    output shard. ``prefix`` (k, v), a block every rank holds (the replicated
    text tokens), is folded in first.

    Step s sends the block in slot s % 2 to the right neighbour and receives
    the left one's into the other slot, runs ``step`` on its own slot, then
    waits for the transfer. The receive into a slot is queued after the step
    that last read it: a group's transfer is issued on the stream that ran
    that step (NCCL's stream waits on it; the thread group has only one), so
    the event order on the stream does what the Pallas kernel's capacity
    semaphores do, without a kernel waiting on another rank.
    """
    n = group.size
    state, first = None, True
    if prefix is not None:
        state, first = step(q, prefix[0], prefix[1], None, first=True, last=False), False
    comm = torch.empty((2, 2, *k.shape), dtype=k.dtype, device=k.device)
    comm[0, 0].copy_(k)
    comm[0, 1].copy_(v)
    for s in range(n):
        slot, nxt = s % 2, (s + 1) % 2
        pending = group.ppermute_right(comm[slot], out=comm[nxt]) if s < n - 1 else None
        state = step(q, comm[slot, 0], comm[slot, 1], state, first=first and s == 0,
                     last=s == n - 1)
        if pending is not None:
            pending.wait()
    return state


def ring_flash_attention(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                         group) -> torch.Tensor:
    """Full (non-causal) attention of this rank's query shard over the whole
    sequence, K/V rotating around ``group``'s ring, each step on K5."""
    return ring_loop(q_l, k_l, v_l, group, ring_step)


ring_step.launches = 0
