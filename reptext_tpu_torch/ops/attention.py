"""Attention entry point of the port's transformer blocks.

Counterpart of ``reptext_tpu/ops/attention.py::attention``, with the device
taking the place of the JAX backend switch: the JAX package runs its Pallas
kernels on the TPU and ``xla_attention`` elsewhere; here a CUDA tensor always
goes to the hand-written kernels (``ops/flash_attention.py``, which routes
between K1, K2 and the streaming K3 as the JAX package does and raises if they
cannot launch; the forward kernel with the backward kernel behind it, so
gradients reach q, k and v) and a CPU tensor to :func:`plain_attention`, the
twin of ``xla_attention``, differentiated by autograd. Tensors are
[B, H, S, D]; with RoPE tables, q/k arrive unrotated in half-split channel order.
"""

from __future__ import annotations

from typing import Optional

import torch

from reptext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_rope
from reptext_tpu_torch.ops.rope import apply_rope_half


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 logits and softmax, probabilities cast to v's dtype for PV."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rope_cos: Optional[torch.Tensor] = None,
              rope_sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (non-causal) multi-head attention over [B, H, S, D]."""
    if q.device.type == "cuda":
        if rope_cos is not None:
            return flash_attention_rope(q, k, v, rope_cos, rope_sin)[0]
        return flash_attention(q, k, v)[0]
    if rope_cos is not None:
        q = apply_rope_half(q, rope_cos, rope_sin)
        k = apply_rope_half(k, rope_cos, rope_sin)
    return plain_attention(q, k, v)
