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
"""

from __future__ import annotations

from typing import Optional

import torch

from reptext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_rope
from reptext_tpu_torch.ops.rope import apply_rope_half
from reptext_tpu_torch.utils.profiling import span_calls

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rope_cos: Optional[torch.Tensor] = None,
              rope_sin: Optional[torch.Tensor] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Full (non-causal) multi-head attention over [B, H, S, D]; ``backend``
    overrides the process-wide default for this call."""
    if _kernels(q, backend):
        if rope_cos is not None:
            return flash_attention_rope(q, k, v, rope_cos, rope_sin)[0]
        return flash_attention(q, k, v)[0]
    if rope_cos is not None:
        q = apply_rope_half(q, rope_cos, rope_sin)
        k = apply_rope_half(k, rope_cos, rope_sin)
    return plain_attention(q, k, v)
