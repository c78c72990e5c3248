"""Seeded weights for every component, drawn on the device in a few large calls.

The benchmark owns its weights: the program and the reference get the same
tensors, drawn from ``--seed`` by this module alone. A component is a list of
``(name, shape)`` pairs (the program's parameter names, read from its modules
built on the meta device). Its rule follows the random-weights convention of
FLUX-style code: matrices and convolution kernels normal with std
1/sqrt(fan_in), biases 0, one-dimensional scales 1, embeddings normal with
std 1/sqrt(dim). A trained ControlNet's residual heads and condition
embedder are no longer zero, so the names the configuration lists under
``scaled_init`` are drawn the same way times its factor. Every matrix of a
component comes from one ``torch.randn`` over one buffer, in the dtype the
configuration serves; the parameters are views of it.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...]]]


def generator(seed: int, component: int, device) -> torch.Generator:
    """The component's generator: a SeedSequence of (seed, component)."""
    state = np.random.SeedSequence([int(seed), component]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


@torch.no_grad()
def draw(spec: Spec, seed: int, component: int, device, dtype: torch.dtype,
         scaled: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for one component. ``scaled`` maps name suffixes to
    factors on their std (the configuration's ``scaled_init``)."""
    scaled = scaled or {}
    mats = [(n, s) for n, s in spec if len(s) >= 2]
    flat = torch.randn(sum(int(np.prod(s)) for _, s in mats), generator=generator(
        seed, component, device), device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in mats:
        size = int(np.prod(shape))
        view = flat[at:at + size].view(shape)
        at += size
        std = float(np.prod(shape[1:])) ** -0.5
        for suffix, factor in scaled.items():
            if name.endswith(suffix):
                std *= factor
        out[name] = view.mul_(std)
    for name, shape in spec:
        if len(shape) < 2:
            fill = 0.0 if name.endswith("bias") else 1.0
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
    return {name: out[name] for name, _ in spec}


def draw_all(specs: Dict[str, Spec], seed: int, device, dtype: torch.dtype,
             scaled: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every component's weights; a component's draw depends only on the seed
    and its own name, not on which other components the cell has."""
    return {name: draw(specs[name], seed, zlib.crc32(name.encode()), device, dtype,
                       scaled.get(name)) for name in specs}


def spec_of(state: Iterable[Tuple[str, torch.Tensor]]) -> Spec:
    return [(name, tuple(t.shape)) for name, t in state]
