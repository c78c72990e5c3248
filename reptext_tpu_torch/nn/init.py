"""Seeded random initialisation of the port's modules, on their own device.

Mirrors the Flax initialisers the JAX package's random-weights mode uses:
lecun-normal kernels (std 1/sqrt(fan_in); the truncation is left out), zero
biases, ones for norm scales, normal(1/sqrt(dim)) embeddings, and zeros for
the parameters a module lists in ``zero_init`` (the ControlNet's conditioning
embedder and residual heads). A ``QuantLinear`` (fp8 storage) draws its codes
and scales directly (``QuantLinear.random_init_``), zero where its weight is
listed in ``zero_init``. One ``torch.Generator`` on the modules' device
draws every value, so a 12B model is initialised where it lives.
"""

from __future__ import annotations

import torch
from torch import nn

from reptext_tpu_torch.nn.layers import QuantLinear


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    zero_suffixes = tuple(getattr(module, "zero_init", ()))
    quant = set()
    for mod_name, mod in module.named_modules():
        if isinstance(mod, QuantLinear):
            mod.random_init_(generator, zero=bool(zero_suffixes)
                             and f"{mod_name}.weight".endswith(zero_suffixes))
            quant.update(f"{mod_name}.{leaf}" for leaf, _ in mod.named_parameters())
    for name, p in module.named_parameters():
        if name in quant:
            continue
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
