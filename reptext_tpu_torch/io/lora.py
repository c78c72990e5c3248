"""LoRA loading and merging for the port's FLUX transformer and ControlNet.

Counterpart of ``reptext_tpu/io/lora.py`` (the reference takes LoRA from
diffusers' ``FluxLoraLoaderMixin``): a LoRA file in diffusers naming
(``transformer.<module>.lora_A.weight`` [r, in] / ``lora_B.weight`` [out, r])
is merged ahead of time into the dense weights, so sampling runs no LoRA
code. The port merges into module state, ``nn.Linear`` weights [out, in], so
the delta is ``scale * B @ A`` (the JAX package's kernels [in, out] take its
transpose). It is formed in float32 and added to the float32 weight with one
rounding to the weight's dtype. The deltas of ``to_q``, ``to_k``,
``add_q_proj`` and ``add_k_proj`` take the RoPE half-split permutation that
the converter folds into those weights (``io/convert.py::_lin_rope``): left
out, q and k would rotate wrongly with no error.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple, Union

import torch

# torch module path (diffusers FLUX naming) -> (the Flax tree path, stacked layer axis)
_BLOCK_PATTERNS = [
    # double blocks
    (re.compile(r"transformer_blocks\.(\d+)\.attn\.(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|to_add_out)$"),
     lambda m: ("double_blocks", "block", m.group(2))),
    (re.compile(r"transformer_blocks\.(\d+)\.attn\.to_out\.0$"),
     lambda m: ("double_blocks", "block", "to_out")),
    (re.compile(r"transformer_blocks\.(\d+)\.norm1\.linear$"),
     lambda m: ("double_blocks", "block", "norm1", "linear")),
    (re.compile(r"transformer_blocks\.(\d+)\.norm1_context\.linear$"),
     lambda m: ("double_blocks", "block", "norm1_context", "linear")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff\.net\.0\.proj$"),
     lambda m: ("double_blocks", "block", "ff", "in_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff\.net\.2$"),
     lambda m: ("double_blocks", "block", "ff", "out_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff_context\.net\.0\.proj$"),
     lambda m: ("double_blocks", "block", "ff_context", "in_proj")),
    (re.compile(r"transformer_blocks\.(\d+)\.ff_context\.net\.2$"),
     lambda m: ("double_blocks", "block", "ff_context", "out_proj")),
    # single blocks
    (re.compile(r"single_transformer_blocks\.(\d+)\.attn\.(to_q|to_k|to_v)$"),
     lambda m: ("single_blocks", "block", m.group(2))),
    (re.compile(r"single_transformer_blocks\.(\d+)\.(proj_mlp|proj_out)$"),
     lambda m: ("single_blocks", "block", m.group(2))),
    (re.compile(r"single_transformer_blocks\.(\d+)\.norm\.linear$"),
     lambda m: ("single_blocks", "block", "norm", "linear")),
]

# non-stacked (top-level) modules
_TOP_PATTERNS = [
    (re.compile(r"^(x_embedder|context_embedder|proj_out)$"), lambda m: (m.group(1),)),
    (re.compile(r"^norm_out\.linear$"), lambda m: ("norm_out", "linear")),
]

# q/k projections whose converted weights carry the RoPE half-split channel
# permutation (io/convert.py::_lin_rope): LoRA deltas on them are permuted alike
_ROPE_PERMUTED_LEAVES = frozenset({"to_q", "to_k", "add_q_proj", "add_k_proj"})

Pairs = Dict[Tuple[str, ...], Dict[int, Tuple[torch.Tensor, torch.Tensor]]]


def parse_lora_state(state: Mapping[str, torch.Tensor], prefix: str = "transformer.") -> Pairs:
    """Group a flat LoRA state dict into {module path: {layer index: (A, B)}},
    the JAX function's grouping: the path is the Flax tree's, the layer
    index -1 for a module outside the block stacks; A [r, in], B [out, r].
    Keys without ``prefix`` or not a ``lora_A``/``lora_B`` weight are
    ignored; an unknown module raises ``KeyError``, a lone half of a pair
    ``ValueError``."""
    grouped: Dict[Tuple[str, ...], Dict[int, list]] = {}
    for key, arr in state.items():
        if not key.startswith(prefix):
            continue
        m = re.match(r"(.+)\.(lora_A|lora_B)\.weight$", key[len(prefix):])
        if not m:
            continue
        module, which = m.group(1), m.group(2)
        layer, path = -1, None
        for pat, fn in _BLOCK_PATTERNS:
            mm = pat.match(module)
            if mm:
                layer, path = int(mm.group(1)), fn(mm)
                break
        if path is None:
            for pat, fn in _TOP_PATTERNS:
                mm = pat.match(module)
                if mm:
                    path = fn(mm)
                    break
        if path is None:
            raise KeyError(f"unrecognized LoRA module {module!r}")
        slot = grouped.setdefault(path, {}).setdefault(layer, [None, None])
        slot[0 if which == "lora_A" else 1] = arr
    out: Pairs = {}
    for path, layers in grouped.items():
        out[path] = {}
        for layer, (a, b) in layers.items():
            if a is None or b is None:
                raise ValueError(f"LoRA pair incomplete for {path} layer {layer}")
            out[path][layer] = (a, b)
    return out


def weight_name(path: Tuple[str, ...], layer: int) -> str:
    """The port's parameter name of a Flax module path (layer index -1: not stacked)."""
    if path[0] in ("double_blocks", "single_blocks"):
        if layer < 0:
            raise ValueError(f"stacked module {path} needs a layer index")
        return ".".join((path[0], str(layer)) + path[1:] + ("weight",))
    return ".".join(path + ("weight",))


def lora_delta(a: torch.Tensor, b: torch.Tensor, scale: float, leaf: str,
               head_dim: int) -> torch.Tensor:
    """``scale * B @ A`` [out, in] in float32, its output channels permuted
    per head for the RoPE-permuted q/k leaves."""
    delta = (b.float() @ a.float()) * scale
    if leaf in _ROPE_PERMUTED_LEAVES:
        perm = torch.cat([torch.arange(0, head_dim, 2), torch.arange(1, head_dim, 2)])
        out_dim, in_dim = delta.shape
        delta = delta.reshape(out_dim // head_dim, head_dim, in_dim)[:, perm.to(delta.device)]
        delta = delta.reshape(out_dim, in_dim)
    return delta


Target = Union[torch.nn.Module, Dict[str, torch.Tensor]]


@torch.no_grad()
def apply_lora(target: Target, lora_state: Mapping[str, torch.Tensor], scale: float = 1.0,
               prefix: str = "transformer.", head_dim: int = 128,
               keep_originals: bool = False) -> Dict[str, torch.Tensor]:
    """Merge a LoRA into ``target``, a module (FLUX or a ControlNet) or its
    state dict {name: tensor}, in place: W <- dtype(float32(W) + scale * B @ A).

    Returns {parameter name: its tensor before the merge} of the touched
    weights when ``keep_originals`` (copies, to restore them with
    :func:`restore_weights`), else an empty dict. A module in the LoRA that
    ``target`` lacks raises ``KeyError``.
    """
    weights = dict(target.named_parameters()) if isinstance(target, torch.nn.Module) else target
    kept: Dict[str, torch.Tensor] = {}
    for path, layers in parse_lora_state(lora_state, prefix).items():
        for layer, (a, b) in layers.items():
            name = weight_name(path, layer)
            if name not in weights:
                raise KeyError(f"LoRA module {path} layer {layer}: no weight {name!r}")
            w = weights[name]
            delta = lora_delta(a.to(w.device), b.to(w.device), scale, path[-1], head_dim)
            if tuple(delta.shape) != tuple(w.shape):
                raise ValueError(f"{name}: LoRA delta {tuple(delta.shape)} != weight "
                                 f"{tuple(w.shape)}")
            if keep_originals and name not in kept:
                kept[name] = w.detach().clone()
            merged = (w.float() + delta).to(w.dtype)
            if isinstance(target, torch.nn.Module):
                w.copy_(merged)
            else:
                target[name] = merged
    return kept


@torch.no_grad()
def restore_weights(target: Target, originals: Mapping[str, torch.Tensor]) -> None:
    """Put back the tensors :func:`apply_lora` kept."""
    weights = dict(target.named_parameters()) if isinstance(target, torch.nn.Module) else target
    for name, w in originals.items():
        if isinstance(target, torch.nn.Module):
            weights[name].copy_(w)
        else:
            target[name] = w
