"""Seeded random initialisation of the port's modules, on their own device.

Mirrors the Flax initialisers the JAX package's random-weights mode uses:
lecun-normal kernels (std 1/sqrt(fan_in); the truncation is left out), zero
biases, ones for norm scales, normal(1/sqrt(dim)) embeddings, and zeros for
the parameters a module lists in ``zero_init`` (the ControlNet's conditioning
embedder and residual heads). One ``torch.Generator`` on the modules' device
draws every value, so a 12B model is initialised where it lives.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    zero_suffixes = tuple(getattr(module, "zero_init", ()))
    for name, p in module.named_parameters():
        if zero_suffixes and name.endswith(zero_suffixes):
            p.zero_()
        elif name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:                       # norm scales
            p.fill_(1.0)
        else:
            # Linear [out, in], Conv2d [out, in, kh, kw]: fan_in = in * kh * kw;
            # Embedding [vocab, dim]: 1/sqrt(dim)
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
    return module
