"""Attention entry point of the port's transformer blocks.

Counterpart of ``reptext_tpu/ops/attention.py::attention`` and its
process-wide backend switch, with the JAX names so that scripts carry over
(:func:`set_default_backend`, the CLI's ``--attention-backend``):

- ``auto`` (the default): a CUDA tensor goes to the hand-written kernels
  (``ops/flash_attention.py``, which routes between K1, K2 and the streaming
  K3 as the JAX package does and raises if they cannot launch; the forward
  kernel with the backward kernel behind it, so gradients reach q, k and v),
  a CPU tensor to :func:`plain_attention`, the twin of ``xla_attention``,
  differentiated by autograd; as the JAX ``auto`` takes Pallas on the TPU and
  XLA elsewhere;
- ``xla``: :func:`plain_attention` on any device;
- ``pallas``: the hand-written kernels; a CPU tensor raises.

This is an explicit switch, never a fallback: ``auto`` does not retry the
plain version when a kernel refuses its inputs. Under a request's span
recorder a call of :func:`plain_attention` is an ``attention`` span, as a
call of a kernel entry is. Tensors are [B, H, S, D];
with RoPE tables, q/k arrive unrotated in half-split channel order.

The blocks' joins. A double block's joint sequence is [text; image] and a
single block's ``proj_out`` reads [attention; MLP]. :func:`joins_in_place` is
the one rule that decides whether a block makes them by copies (``torch.cat``,
the route the JAX package's blocks describe) or by where producers write:
q, k and v handed to :func:`attention` as (text, image) segments, each
stream's output coming back dense, or its output written into the caller's
``out`` (the attention columns of ``proj_out``'s input). It holds when K1 runs at the
joint length (``rope_fused``), no SP backend is set and autograd records
nothing on the joined tensors; where the join splits K1's keys into a text
and an image segment (the double block), the text has to be a whole number
of K1's key tiles besides. Each block's answer is counted in the request's
``joins`` counter. On the card K1 reads and writes the segments; the plain
path joins them itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from reptext_tpu_torch.ops.flash_attention import (
    SEGMENT_ALIGN, Operand, flash_attention, flash_attention_rope, joint_operand, like_segments,
    rope_fused, segments,
)
from reptext_tpu_torch.ops.rope import apply_rope_half
from reptext_tpu_torch.utils.profiling import count_join, span_calls

BACKENDS = ("auto", "xla", "pallas")
_DEFAULT_BACKEND = "auto"


def set_default_backend(name: str) -> None:
    """Set the process-wide attention backend: 'auto' | 'xla' | 'pallas'."""
    global _DEFAULT_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"unknown attention backend {name!r}")
    _DEFAULT_BACKEND = name


def get_default_backend() -> str:
    return _DEFAULT_BACKEND


def _kernels(q: torch.Tensor, backend: Optional[str]) -> bool:
    """Whether this call takes the hand-written kernels."""
    b = backend or _DEFAULT_BACKEND
    if b not in BACKENDS:
        raise ValueError(f"unknown attention backend {b!r}")
    if b == "pallas" and q.device.type != "cuda":
        raise ValueError(f"the 'pallas' attention backend runs the hand-written kernels, which "
                         f"take CUDA tensors; got a {q.device.type} tensor")
    return b == "pallas" or (b == "auto" and q.device.type == "cuda")


@span_calls("attention")
def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 logits and softmax, probabilities cast to v's dtype for PV."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def joins_in_place(s: int, sp_backend: Optional[str], *joined: torch.Tensor,
                   s_txt: Optional[int] = None) -> bool:
    """Whether a block over ``s`` joint tokens, under the SP backend
    ``sp_backend``, joins its streams or branches in place rather than by
    copies; ``joined``: the tensors the join would concatenate; ``s_txt``: the
    text tokens where the join hands K1 (text, image) segments, which it reads
    in whole key tiles (None: a join that splits nothing, the single block's).
    Counted in the request's ``joins`` counter."""
    in_place = (sp_backend is None and rope_fused(s)
                and (s_txt is None or s_txt % SEGMENT_ALIGN == 0)
                and not (torch.is_grad_enabled() and any(t.requires_grad for t in joined)))
    count_join(in_place)
    return in_place


def attention(q: Operand, k: Operand, v: Operand,
              rope_cos: Optional[torch.Tensor] = None,
              rope_sin: Optional[torch.Tensor] = None,
              backend: Optional[str] = None, out: Optional[torch.Tensor] = None) -> Operand:
    """Full (non-causal) multi-head attention over [B, H, S, D]; ``backend``
    overrides the process-wide default for this call. With RoPE tables, q, k
    and v may each come as (text, image) segments, and then so does the
    result, or the result of one sequence may be written into ``out``: see
    :func:`flash_attention_rope`; the plain path joins the segments, and cuts
    its result as q is or copies it into ``out``."""
    if _kernels(segments(q)[0], backend):
        if rope_cos is not None:
            return flash_attention_rope(q, k, v, rope_cos, rope_sin, out=out)[0]
        return flash_attention(q, k, v)[0]
    like = q
    q, k, v = (joint_operand(x) for x in (q, k, v))
    if rope_cos is not None:
        q = apply_rope_half(q, rope_cos, rope_sin)
        k = apply_rope_half(k, rope_cos, rope_sin)
    result = plain_attention(q, k, v)
    return like_segments(result, like) if out is None else out.copy_(result)
