"""Carry Flax parameter trees (numpy arrays or torch tensors) into the port's modules.

The port names its parameters after the Flax tree, so the mapping is
mechanical:

- ``{"params": ...}`` is unwrapped;
- a Dense ``kernel`` [in, out] becomes ``Linear.weight`` [out, in], and an
  fp8 pair (``io/quantize.py``) ``kernel_q8`` [in, out] / ``kernel_scale``
  [1, out] becomes ``QuantLinear.kernel_q8`` [out, in] / ``.kernel_scale``
  [out, 1];
- a Conv ``kernel`` HWIO becomes ``Conv2d.weight`` OIHW, and a 1-D Conv
  ``kernel`` (k, I, O) becomes ``Conv1d.weight`` (O, I, k);
- LayerNorm/GroupNorm ``scale`` and Embed ``embedding`` become ``weight``;
- ``nn.scan`` stacks under ``double_blocks``/``single_blocks`` are sliced
  along their leading layer axis into the matching ``ModuleList`` entries.

Any module parameter without a leaf, any leaf without a parameter, and any
shape mismatch raises. Leaves may be numpy arrays (a JAX tree) or CPU torch
tensors (``io/convert.py``'s trees, bf16 kept); a torch leaf's transposes are
views. This is also the real-checkpoint route: diffusers safetensors ->
``io.convert.convert_*`` -> :func:`load_jax_params`, or -> :func:`flatten_jax_params`
-> the port's checkpoint files (``io/convert_cli.py``).

Since ``kernel`` and ``scale`` both become ``weight``, the name alone cannot
say which Flax leaf a parameter was; :func:`flax_leaf_kinds` tells it from
the owning module's type.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from reptext_tpu_torch.io.quantize import QUANT_KEY, SCALE_KEY

_STACKED = ("double_blocks", "single_blocks")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


Leaf = Union[np.ndarray, torch.Tensor]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Leaf]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val if isinstance(val, torch.Tensor) else np.asarray(val)


def _to_torch_layout(leaf: str, arr: Leaf) -> Leaf:
    if leaf in (QUANT_KEY, SCALE_KEY):
        return arr.T
    if leaf == "kernel":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 3:
            return (arr.permute if isinstance(arr, torch.Tensor) else arr.transpose)(2, 1, 0)
        if arr.ndim == 4:
            return (arr.permute if isinstance(arr, torch.Tensor) else arr.transpose)(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    return arr


def flax_leaf_kinds(module: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: the Flax leaf it carries: kernel, scale, bias or embedding}.

    Linear, Conv1d and Conv2d weights are ``kernel``s, Embedding weights
    ``embedding``s, other weights (LayerNorm, GroupNorm, and the RMS norms,
    whose Flax leaf is named ``weight``) ``scale``s, and biases ``bias``.
    """
    kinds: Dict[str, str] = {}
    for mod_name, mod in module.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            if leaf == "bias":
                kind = "bias"
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d)):
                kind = "kernel"
            elif isinstance(mod, torch.nn.Embedding):
                kind = "embedding"
            else:
                kind = "scale"
            kinds[f"{mod_name}.{leaf}" if mod_name else leaf] = kind
    return kinds


def flatten_jax_params(tree: Mapping[str, Any]) -> Dict[str, Leaf]:
    """Flax variables tree -> {torch parameter name: leaf in torch layout}."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, Leaf] = {}
    for path, arr in _leaves(tree):
        leaf = path[-1]
        name = list(path[:-1]) + [_RENAME.get(leaf, leaf)]
        if path[0] in _STACKED:
            for i in range(arr.shape[0]):
                full = ".".join([path[0], str(i)] + name[1:])
                out[full] = _to_torch_layout(leaf, arr[i])
        else:
            out[".".join(name)] = _to_torch_layout(leaf, arr)
    return out


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Fill ``module``'s parameters from a Flax tree, in place.

    Values are cast to each parameter's dtype and copied to its device; numpy
    leaves go through float32, torch leaves are cast directly.
    """
    flat = flatten_jax_params(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    unused = sorted(set(flat) - set(params))
    if missing or unused:
        raise KeyError(f"parameter mismatch: missing from the tree {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}; unused leaves {unused[:8]}"
                       f"{'...' if len(unused) > 8 else ''}")
    for name, p in params.items():
        arr = flat[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {tuple(arr.shape)} != parameter "
                             f"shape {tuple(p.shape)}")
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        p.copy_(arr)
    return module
